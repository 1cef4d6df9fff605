"""The mesh's collectives as differentiable functions — the port's
stand-in for the JAX package's ``shard_map`` shim (``parallel/
_compat.py``) and the ``lax`` collectives the JAX modules call inside
it, which have no torch counterpart.

Each collective acts on one named axis of a mesh (parallel/mesh.py)
and is a ``torch.autograd.Function`` whose backward is its SPMD
transpose:

- :func:`all_reduce` (``lax.psum``): sum over the axis; backward the
  same sum of the cotangents.
- :func:`all_gather` (tiled ``lax.all_gather``): concatenate the
  ranks' blocks along a dim; backward ``reduce_scatter`` — the
  cotangents summed over the axis, each rank keeping its block.
- :func:`all_to_all` (tiled ``lax.all_to_all``): split one dim into
  the axis's ranks and concatenate what arrives along another;
  backward the inverse exchange.
- :func:`ppermute` (``lax.ppermute``): (source, destination) pairs of
  axis indices; each rank sends to its destination and receives from
  its source (zeros when no one sends to it); backward the inverse
  permutation. Each hop is ONE ``batch_isend_irecv``, so every rank
  issues its point-to-point calls in one order.

An axis of size 1 is the identity and touches no process group. On a
gloo group a card tensor is copied into pinned host memory, exchanged,
and copied back; the bytes of both copies are counted in
``parallel/host_staged_bytes`` (utils/stats, exported by
obs/metrics). On NCCL nothing is staged.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.utils.stats import global_counters

Axes = Union[str, Sequence[str]]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` can carry: ``t`` itself, or
    a pinned host copy on a gloo group."""
    t = t.contiguous()
    if not _staged(t, group):
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    global_counters.bump("parallel/host_staged_bytes",
                         t.numel() * t.element_size())
    return h


def _from_wire(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    if h.device == device:
        return h
    global_counters.bump("parallel/host_staged_bytes",
                         h.numel() * h.element_size())
    return h.to(device)


def staged_bytes() -> int:
    return global_counters.value("parallel/host_staged_bytes")


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    w = _to_wire(t, group)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, group=group)
    return _from_wire(w, t.device)


def _gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    w = _to_wire(t, group)
    outs = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(outs, w, group=group)
    return _from_wire(torch.cat(outs, dim=dim), t.device)


def _scatter_sum(t: torch.Tensor, dim: int, group, n: int,
                 me: int) -> torch.Tensor:
    """Sum over the group, keep this rank's block of ``dim``."""
    if dist.get_backend(group) == "nccl":
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out.movedim(0, dim)
    # gloo has no reduce-scatter: the sum, then this rank's block
    return _sum(t, group).chunk(n, dim=dim)[me]


def _exchange(t: torch.Tensor, split_dim: int, concat_dim: int, group,
              n: int) -> torch.Tensor:
    w = _to_wire(torch.stack(t.chunk(n, dim=split_dim)), group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return torch.cat(_from_wire(out, t.device).unbind(0), dim=concat_dim)


def _hop(t, like: torch.Tensor, send_to, recv_from):
    """One point-to-point hop over the default group (global ranks), one
    ``batch_isend_irecv``: send ``t`` to ``send_to`` and receive a tensor
    like ``like`` from ``recv_from`` (None: no send / nothing received,
    returned as None)."""
    if send_to is not None and send_to == recv_from == dist.get_rank():
        return t.clone()
    group = dist.group.WORLD
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, _to_wire(t, group), send_to))
    buf = None
    if recv_from is not None:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if _staged(like, group)
                          else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, recv_from))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if buf is None else _from_wire(buf, like.device)


def _moved(t: torch.Tensor, send_to, recv_from) -> torch.Tensor:
    """``ppermute``'s hop: what arrives, or zeros when nothing does."""
    got = _hop(t, t, send_to, recv_from)
    return torch.zeros_like(t) if got is None else got


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, me):
        ctx.args = (dim, group, n, me)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, me = ctx.args
        return _scatter_sum(g, dim, group, n, me), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n):
        ctx.args = (split_dim, concat_dim, group, n)
        return _exchange(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group, n = ctx.args
        return _exchange(g, concat_dim, split_dim, group, n), None, None, \
            None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_to, recv_from):
        ctx.peers = (send_to, recv_from)
        return _moved(x, send_to, recv_from)

    @staticmethod
    def backward(ctx, g):
        send_to, recv_from = ctx.peers
        return _moved(g, recv_from, send_to), None, None


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of each axis in ``axes`` (one name or
    several: the sum over their product)."""
    for a in _axes(axes):
        if mesh_mod.live(mesh, a):
            x = _AllReduce.apply(x, mesh.get_group(a))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' blocks of ``axis`` concatenated along ``dim``, in axis
    order."""
    n = mesh_mod.axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, dim, mesh.get_group(axis), n,
                            mesh_mod.axis_index(mesh, axis))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    n = mesh_mod.axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, mesh.get_group(axis), n)


def _peers(mesh, axis: str, perm: Sequence[Tuple[int, int]]):
    """(global rank this rank sends to, global rank it receives from)
    under ``perm`` (None where it has none)."""
    ranks = mesh_mod.axis_ranks(mesh, axis)
    me = mesh_mod.axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    return (ranks[dst[0]] if dst else None, ranks[src[0]] if src else None)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` moved along ``axis`` by ``perm``'s (source, destination)
    axis-index pairs; a rank no pair sends to gets zeros."""
    if mesh_mod.axis_size(mesh, axis) == 1:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    send_to, recv_from = _peers(mesh, axis, perm)
    return _PPermute.apply(x, send_to, recv_from)


def send_recv(x, mesh, axis: str, send_to_index, recv_from_index,
              like: torch.Tensor):
    """One hop outside autograd (the pipeline schedules): send ``x`` (or
    nothing, None) to axis index ``send_to_index`` and receive a tensor
    like ``like`` from ``recv_from_index`` (None: nothing). Returns the
    received tensor or None."""
    ranks = mesh_mod.axis_ranks(mesh, axis)
    return _hop(None if x is None else x.detach(), like,
                None if send_to_index is None else ranks[send_to_index],
                None if recv_from_index is None else ranks[recv_from_index])


def sum_over_world(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank of the process group (not
    differentiable)."""
    return _sum(t, dist.group.WORLD)
