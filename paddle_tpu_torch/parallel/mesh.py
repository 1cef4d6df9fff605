"""Device meshes over ``torch.distributed`` — the port of
``paddle_tpu/parallel/mesh.py``.

The JAX package runs one process that drives every device, and GSPMD
inserts the collectives. The port runs one process per rank: every
rank runs the same user script, and the collectives are explicit
(parallel/comm.py). A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the initialized process group whose dimensions carry
the JAX axis names:

  dp — data parallel (batch dim)          <- trainer_count
  mp — model/tensor parallel (features)   <- parallel_nn device placement
  sp — sequence/context parallel (time)
  pp — pipeline stages                    <- ParallelNeuralNetwork pinning
  ep — expert parallel (MoE expert dim)

The backend rule, one rule, logged when a mesh is made: NCCL where each
rank has a card of its own; gloo on the CPU, or where several ranks
share one card (NCCL refuses two ranks on one device). The rule reads
every rank's place — its host, the cards that host shows, and its card
— so a world of many hosts with a card a rank is NCCL however large it
is. A rank's card is the one its launcher names (``local_device_ids``,
or ``LOCAL_RANK``), else its position among the ranks of its host,
modulo the host's cards. ``init_distributed`` exchanges the places
through the rendezvous store before the group exists (the backend
depends on them); over a group formed elsewhere ``create_mesh``
all-gathers them. Gloo carries card tensors through pinned host memory
(comm.py counts the bytes). A backend is never swapped after a
failure: a group whose backend disagrees with the rule makes
``create_mesh`` raise.

A mesh's axes must multiply to the world size: no rank is left out and
no mode runs unsharded on a rank the mesh does not hold. A sharding is
a placement on named axes: :class:`PartitionSpec` (one axis name or
None per dimension, as ``jax.sharding.PartitionSpec``) paired with its
mesh in :class:`NamedSharding`.
"""

from __future__ import annotations

import logging
import os
import socket
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DP_AXIS = "dp"
MP_AXIS = "mp"
SP_AXIS = "sp"
PP_AXIS = "pp"
EP_AXIS = "ep"

log = logging.getLogger("paddle_tpu_torch.parallel")


class PartitionSpec(tuple):
    """One mesh axis name (or None, a tuple of names) per dimension;
    ``PartitionSpec()`` is replicated. Equal to the JAX spec with the
    same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A placement: ``spec`` over the axes of ``mesh``."""
    mesh: object
    spec: PartitionSpec


class RankPlace(NamedTuple):
    """Where a rank computes: its host's name, the CUDA cards the host
    shows, and its card (-1: none named; its local position decides)."""
    host: str
    cards: int
    card: int


def this_place(card: Optional[int] = None) -> RankPlace:
    """This process's place, its card ``card``, else ``LOCAL_RANK``'s,
    else -1."""
    if card is None:
        card = int(os.environ.get("LOCAL_RANK", -1))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return RankPlace(socket.gethostname(), cards, int(card))


def resolve_places(places: Sequence[RankPlace]) -> List[RankPlace]:
    """Every rank's place with its card chosen: a named card modulo its
    host's cards; else the rank's position among its host's ranks (in
    rank order) modulo them."""
    seen = {}
    out = []
    for p in places:
        local = seen.get(p.host, 0)
        seen[p.host] = local + 1
        card = p.card if p.card >= 0 else local
        out.append(RankPlace(p.host, p.cards,
                             card % p.cards if p.cards else 0))
    return out


def backend_rule(device_type: str, places: Sequence[RankPlace]) -> str:
    """The backend rule: "nccl" when the ranks compute on CUDA cards and
    no two ranks share a card (of one host), else "gloo"."""
    if device_type != "cuda" or any(p.cards == 0 for p in places):
        return "gloo"
    used = {(p.host, p.card) for p in places}
    return "nccl" if len(used) == len(places) else "gloo"


# (a weak reference to the default group, its ranks' resolved places):
# a strong one kept the group — and gloo's loop and worker threads —
# alive past destroy_process_group() until interpreter exit
_PLACES = None


def record_places(places: Sequence[RankPlace]) -> None:
    """Keep the initialized default group's resolved places."""
    global _PLACES
    _PLACES = (weakref.ref(dist.group.WORLD), list(places))


def group_places() -> List[RankPlace]:
    """The default group's resolved places: those recorded when it was
    formed, else all-gathered over it (a collective: every rank calls
    it)."""
    kept = _PLACES[0]() if _PLACES is not None else None
    if kept is not None and kept is dist.group.WORLD:
        return _PLACES[1]
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, this_place())
    record_places(resolve_places(got))
    return _PLACES[1]


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return torch.device(device_type).type
    from paddle_tpu_torch.device import resolve_device
    return resolve_device(None).type


def rank_device(device_type: str, place: RankPlace) -> torch.device:
    """The compute device of a rank at ``place``: its card, or the
    CPU."""
    if device_type == "cuda":
        return torch.device("cuda", place.card)
    return torch.device(device_type)


def _ensure_group(device_type: str, total: int) -> None:
    """A mesh of one over no initialized group gets a private world of
    one (an in-memory store, nothing on disk or network) on the current
    card."""
    if dist.is_initialized():
        return
    if total != 1:
        raise RuntimeError(
            f"a mesh of {total} ranks needs an initialized process group: "
            "call parallel.init_distributed(...) on every rank first")
    cuda = device_type == "cuda" and torch.cuda.is_available()
    places = resolve_places(
        [this_place(torch.cuda.current_device() if cuda else 0)])
    backend = backend_rule(device_type, places)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device_type, places[0]))
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    record_places(places)


def create_mesh(shape: Sequence[Tuple[str, int]], devices=None,
                device_type: Optional[str] = None):
    """create_mesh([("dp", 2), ("mp", 2)]) over the process group's
    ranks (``devices``: the global ranks in mesh order, default all).
    ``device_type`` picks where the ranks compute: None is the process's
    device (the card unless ``init(use_gpu=False)``), "cpu" the CPU."""
    names = tuple(n for n, _ in shape)
    dims = [int(d) for _, d in shape]
    total = 1
    for d in dims:
        total *= d
    dt = _device_type(device_type)
    _ensure_group(dt, total)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else \
        [int(r) for r in devices]
    if total != world or len(ranks) != world:
        raise ValueError(
            f"mesh {dict(zip(names, dims))} needs {total} ranks; the "
            f"process group has {world} (every rank must be on the mesh)")
    backend = dist.get_backend()
    place = None
    if dt == "cuda":
        places = group_places()
        want = backend_rule(dt, places)
        place = places[dist.get_rank()]
    else:
        want = backend_rule(dt, ())
    if backend != want:
        raise ValueError(
            f"the process group runs {backend!r}, the backend rule gives "
            f"{want!r} for {world} rank(s) computing on {dt} "
            "(init_distributed applies the rule)")
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                      torch.tensor(ranks).reshape(dims),
                      mesh_dim_names=names)
    mesh._pt_device = rank_device(dt, place)
    log.info("mesh %s: backend %s, %d rank(s) computing on %s%s",
             dict(zip(names, dims)), backend, world, mesh._pt_device,
             " (collectives staged through pinned host memory)"
             if backend == "gloo" and dt == "cuda" else "")
    return mesh


def data_parallel_mesh(n: Optional[int] = None, devices=None,
                       device_type: Optional[str] = None):
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return create_mesh([(DP_AXIS, n)], devices, device_type)


def batch_sharding(mesh) -> NamedSharding:
    """Shard the leading (batch) dim over dp."""
    return NamedSharding(mesh, P(DP_AXIS) if DP_AXIS in axis_names(mesh)
                         else P())


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ------------------------------------------------------------ mesh queries

def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict:
    """{axis name: size}, the JAX ``mesh.shape``."""
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 when the mesh lacks it or is None)."""
    if mesh is None or axis not in axis_names(mesh):
        return 1
    return int(mesh.mesh.shape[axis_names(mesh).index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 when the mesh lacks it)."""
    if mesh is None or axis not in axis_names(mesh):
        return 0
    return int(mesh.get_coordinate()[axis_names(mesh).index(axis)])


def axis_ranks(mesh, axis: str) -> List[int]:
    """The global ranks of this rank's group along ``axis``, in axis
    order."""
    coord = list(mesh.get_coordinate())
    coord[axis_names(mesh).index(axis)] = slice(None)
    return [int(r) for r in mesh.mesh[tuple(coord)].reshape(-1).tolist()]


def live(mesh, axis: str) -> bool:
    """True when ``axis`` exists with size > 1: its code path engages."""
    return axis_size(mesh, axis) > 1


def compute_device(mesh) -> torch.device:
    return mesh._pt_device
