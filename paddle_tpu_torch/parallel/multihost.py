"""Multi-process runtime glue — the port of
``paddle_tpu/parallel/multihost.py``: the cluster entry point.

The JAX package forms its process group with
``jax.distributed.initialize`` and then runs one program over every
host's devices. The port runs one process per rank: every rank runs the
same user script, calls :func:`init_distributed` first, and then the
mesh modes of ``paddle_tpu_torch.parallel`` run unchanged over the
group. Each rank still reads the GLOBAL batch the trainer shards over
dp; :func:`process_reader` and :func:`global_batch` serve scripts whose
ranks each read their own share instead.
"""

from __future__ import annotations

import datetime
import json
import os
import time
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch import config as config_mod
from paddle_tpu_torch.parallel import mesh as mesh_mod


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    return f"tcp://{address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     connect_attempts: int = 3,
                     connect_backoff_s: float = 2.0,
                     device_type: Optional[str] = None,
                     timeout_s: float = 300.0, **kw) -> Tuple[int, int]:
    """Join (or form) the process group; returns (rank, world size) and
    records them in the global config.

    ``coordinator_address`` ("host:port", "tcp://host:port" or
    "file:///path") plays the pserver-endpoint role of ``paddle train
    --trainer_id=i --num_gradient_servers=n``; ``num_processes`` and
    ``process_id`` are the world size and this rank. With no arguments
    the launcher's environment decides (``torchrun``'s MASTER_ADDR /
    WORLD_SIZE / RANK), and with none of it the call is a no-op: a
    world of one. The backend follows the rule of parallel/mesh.py
    (``device_type``: where the ranks compute, default the process's
    device), read from every rank's place, which the ranks exchange
    through the rendezvous store first. A coordinator that is not up
    yet is retried ``connect_attempts`` times with
    ``connect_backoff_s * 2^i`` waits;
    then the error propagates — never a silent single-rank run.
    ``local_device_ids``: this rank's card (its first entry; else
    ``LOCAL_RANK``, else its position among its host's ranks)."""
    g = config_mod.global_config()
    if dist.is_initialized():
        g.process_index, g.process_count = dist.get_rank(), \
            dist.get_world_size()
        return g.process_index, g.process_count
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and "MASTER_ADDR" not in os.environ:
        g.process_index, g.process_count = 0, 1
        return 0, 1
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    dt = mesh_mod._device_type(device_type)
    timeout = datetime.timedelta(seconds=timeout_s)
    init = _init_method(coordinator_address) if coordinator_address \
        else "env://"
    mine = mesh_mod.this_place(local_device_ids[0] if local_device_ids
                               else None)
    for attempt in range(max(connect_attempts, 1)):
        try:
            store, _, _ = next(dist.rendezvous(init, rank, world,
                                               timeout=timeout))
            places = _exchange_places(store, rank, world, mine)
            backend = mesh_mod.backend_rule(dt, places)
            if dt == "cuda":
                torch.cuda.set_device(mesh_mod.rank_device(dt, places[rank]))
            dist.init_process_group(backend, store=store, world_size=world,
                                    rank=rank, timeout=timeout, **kw)
            break
        except (RuntimeError, ConnectionError, TimeoutError) as e:
            if attempt + 1 >= max(connect_attempts, 1):
                raise
            wait = connect_backoff_s * (2.0 ** attempt)
            warnings.warn(
                f"init_process_group failed ({e}); retry "
                f"{attempt + 1}/{connect_attempts} in {wait:.1f}s")
            time.sleep(wait)
    mesh_mod.record_places(places)
    g.process_index, g.process_count = dist.get_rank(), dist.get_world_size()
    return g.process_index, g.process_count


def _exchange_places(store, rank: int, world: int, mine) -> list:
    """Every rank's resolved place (parallel/mesh.py), read through the
    rendezvous store before the group exists: each rank writes its own
    and waits for the others'."""
    store.set(f"paddle_tpu_torch/place/{rank}", json.dumps(list(mine)))
    return mesh_mod.resolve_places([
        mesh_mod.RankPlace(*json.loads(
            store.get(f"paddle_tpu_torch/place/{r}")))
        for r in range(world)])


def process_reader(reader: Callable, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> Callable:
    """Deal a global reader's samples round-robin to this process: it
    keeps the samples with ``i % process_count == process_index`` (the
    per-trainer file-list split of cluster_train)."""
    g = config_mod.global_config()
    pi = g.process_index if process_index is None else process_index
    pc = g.process_count if process_count is None else process_count

    def sharded():
        for i, sample in enumerate(reader()):
            if i % pc == pi:
                yield sample

    return sharded


def global_batch(local_batch, mesh, spec=None) -> torch.Tensor:
    """The global batch from each rank's local rows: the dp ranks'
    blocks concatenated in rank order (every rank of a dp group must
    pass the same number of rows), on the mesh's compute device. A
    world of one returns its rows. ``spec``, the JAX argument, must put
    the rows on dp (or be None)."""
    from paddle_tpu_torch.parallel import comm
    if spec is not None and tuple(getattr(spec, "spec", spec))[:1] not in \
            ((mesh_mod.DP_AXIS,), ()):
        raise ValueError(f"global_batch gathers rows over dp; got {spec}")
    t = torch.as_tensor(np.asarray(local_batch))
    if mesh is None:
        return t
    t = t.to(mesh_mod.compute_device(mesh))
    return comm.all_gather(t, mesh, mesh_mod.DP_AXIS, 0)


def is_coordinator() -> bool:
    """True on the rank that writes checkpoints and logs (the
    reference's trainer_id == 0 convention)."""
    return not dist.is_initialized() or dist.get_rank() == 0
