"""Sequence/context parallelism — the port of
``paddle_tpu/parallel/sequence_parallel.py``: ring attention and
Ulysses attention over the mesh's ``sp`` axis.

The feed is not split over sp: every rank of an sp group holds the
whole sequence, and only attention slices the time axis, as the JAX
functions do inside their ``shard_map``. :func:`ring_attention` takes
this rank's time block of q/k/v, keeps its Q block while the K/V blocks
rotate around the sp ring (``comm.ppermute``, one hop a step, none
after the last), merges the blocks by an online softmax (running row
max and normalizer) so the [T, T] score matrix never exists, and
all-gathers the output along time with a differentiable gather. The
backward is autograd through the ring: each ``ppermute``'s backward
sends its cotangent back the way the block came, the mirror ring of
JAX's reversed scan. The per-block products are plain torch products,
as they are plain einsums in JAX.

:func:`ulysses_attention` reshards [b, T/n, h, d] to [b, T, h/n, d] by
one all-to-all, runs full attention on a head slice, and reshards back.
Padded query rows of both come out zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.mesh import SP_AXIS, axis_index, axis_size

_NEG = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Plain scaled-dot-product attention, the single-rank reference.
    q: [b, Tq, h, d]; k, v: [b, Tk, h, d]; mask: [b, Tq, Tk] bool
    (True = attend). Returns [b, Tq, h, d]."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, :, :], logits,
                             torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _ring_attention_local(q, k, v, q_valid, kv_valid, mesh, axis_name,
                          causal, q_offset, scale):
    """The per-rank body. q: [b, Tq, h, d] (this rank's block); k/v:
    [b, Tk, h, d] (this rank's block, rotating); *_valid: [b, T*] bool.
    q_offset is the global start of the Q block (causal masking); a
    K/V block's positions follow from the rank it came from."""
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    acc = torch.zeros((b, tq, h, d), dtype=torch.float32, device=dev)
    row_max = torch.full((b, h, tq), _NEG, dtype=torch.float32, device=dev)
    row_sum = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    q32 = q.float() * scale
    q_pos = q_offset + torch.arange(tq, device=dev)
    k_blk, v_blk = k, v
    valid_blk = kv_valid.to(q.dtype)          # rides the ring as floats
    for i in range(n):
        src = (me + i) % n                     # blocks rotate backwards
        kv_pos = src * tk + torch.arange(tk, device=dev)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
        valid = (valid_blk > 0)[:, None, None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= kv_pos[None, :])[None, None]
        logits = torch.where(valid, logits, torch.full_like(logits, _NEG))
        new_max = torch.maximum(row_max, logits.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(logits - new_max[..., None])
        p = torch.where(valid, p, torch.zeros_like(p))
        row_sum = row_sum * correction + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
        acc = acc * correction.transpose(1, 2)[..., None] + pv
        row_max = new_max
        if i < n - 1:
            # the last step's blocks are never read: no hop after it
            perm = [(j, (j - 1) % n) for j in range(n)]
            k_blk = comm.ppermute(k_blk, mesh, axis_name, perm)
            v_blk = comm.ppermute(v_blk, mesh, axis_name, perm)
            valid_blk = comm.ppermute(valid_blk, mesh, axis_name, perm)
    norm = torch.clamp(row_sum, min=1e-30).transpose(1, 2)[..., None]
    out = acc / norm
    out = torch.where(q_valid[:, :, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _valid(lengths, b, t, device):
    if lengths is None:
        return torch.ones((b, t), dtype=torch.bool, device=device)
    return torch.arange(t, device=device)[None, :] < \
        lengths.to(device)[:, None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, lengths: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: Optional[float] = None,
                   axis_name: str = SP_AXIS) -> torch.Tensor:
    """Context-parallel attention, the time axis split over
    ``axis_name``. q/k/v: [b, T, h, d], the whole sequence (every rank
    of the sp group holds it); lengths: [b] valid lengths. The sp size
    must divide T. Returns the whole [b, T, h, d] output on every rank;
    differentiable."""
    n = axis_size(mesh, axis_name)
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"sp={n} must divide the sequence length {t}")
    tb = t // n
    me = axis_index(mesh, axis_name)
    valid = _valid(lengths, b, t, q.device)
    sl = slice(me * tb, (me + 1) * tb)
    out = _ring_attention_local(q[:, sl], k[:, sl], v[:, sl], valid[:, sl],
                                valid[:, sl], mesh, axis_name, causal,
                                me * tb, scale)
    return comm.all_gather(out, mesh, axis_name, dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, lengths: Optional[torch.Tensor] = None,
                      causal: bool = False,
                      axis_name: str = SP_AXIS) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): this rank's
    time block [b, T/n, h, d] -> [b, T, h/n, d] by one all-to-all, full
    attention on the head slice, and back. The sp size must divide T
    and h. Returns the whole [b, T, h, d] output on every rank."""
    n = axis_size(mesh, axis_name)
    b, t, h, d = q.shape
    if t % n or h % n:
        raise ValueError(f"sp={n} must divide the sequence length {t} "
                         f"and the heads {h}")
    tb = t // n
    me = axis_index(mesh, axis_name)
    valid = _valid(lengths, b, t, q.device)
    sl = slice(me * tb, (me + 1) * tb)

    def reshard(x):
        return comm.all_to_all(x[:, sl], mesh, axis_name, split_dim=2,
                               concat_dim=1)

    mask = valid[:, None, :].expand(b, t, t)
    if causal:
        tri = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                    device=q.device))
        mask = mask & tri[None]
    out = attention(reshard(q), reshard(k), reshard(v), mask)
    out = torch.where(valid[:, :, None, None], out, torch.zeros_like(out))
    out = comm.all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=2)
    return comm.all_gather(out, mesh, axis_name, dim=1)
