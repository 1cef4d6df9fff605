"""Sequence ops over padded + masked SequenceBatch — the port of
``paddle_tpu/ops/sequence_ops.py``: pooling and instance selection,
expand, concat, slice, reverse, the context window projection, and the
nested-sequence ops (sub-sequence pooling and the dense per-subsequence
view the nested recurrent group walks)."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch

_NEG = -1e30


def seq_pool(seq: SequenceBatch, pool_type: str = "average") -> torch.Tensor:
    """Pool over time -> [batch, d]. pool_type:
    average|sum|max|sqrt|last|first."""
    x = seq.data
    m = seq.mask(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    if pool_type in ("average", "avg"):
        s = torch.sum(x * m, dim=1)
        return s / torch.clamp(torch.sum(m, dim=1), min=1.0)
    if pool_type == "sum":
        return torch.sum(x * m, dim=1)
    if pool_type == "sqrt":
        s = torch.sum(x * m, dim=1)
        return s / torch.sqrt(torch.clamp(torch.sum(m, dim=1), min=1.0))
    if pool_type == "max":
        return torch.amax(torch.where(m > 0, x, torch.full_like(x, _NEG)),
                          dim=1)
    if pool_type == "last":
        return last_instance(seq)
    if pool_type == "first":
        return first_instance(seq)
    raise ValueError(f"unknown pool_type {pool_type!r}")


def take_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[r, idx[r, j]] along axis 1 for every row r: idx [b, n] ->
    [b, n, *x.shape[2:]]."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.long().reshape(shape).expand(
        idx.shape + x.shape[2:]))


def _bcast(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (like.dim() - m.dim()))


def last_instance(seq: SequenceBatch) -> torch.Tensor:
    """SequenceLastInstanceLayer: x[i, len_i - 1]."""
    idx = torch.clamp(seq.lengths.long() - 1, min=0)
    return take_time(seq.data, idx[:, None])[:, 0]


def first_instance(seq: SequenceBatch) -> torch.Tensor:
    return seq.data[:, 0]


def expand_to_sequence(x: torch.Tensor, like: SequenceBatch) -> SequenceBatch:
    """ExpandLayer: broadcast per-sample [b, d] to every timestep of
    ``like``."""
    data = x[:, None].expand((x.shape[0], like.max_len) + x.shape[1:])
    return like.with_data(data)


def seq_concat(a: SequenceBatch, b: SequenceBatch) -> SequenceBatch:
    """SequenceConcatLayer: a_i ++ b_i along time per sample, in a
    max_a + max_b wide buffer (b gathered after a's valid prefix)."""
    la = a.lengths.long()
    total = a.max_len + b.max_len
    t = torch.arange(total, device=la.device)[None, :]
    in_a = t < la[:, None]
    ga = take_time(a.data, torch.clamp(t, 0, a.max_len - 1).expand(
        la.shape[0], total))
    gb = take_time(b.data, torch.clamp(t - la[:, None], 0, b.max_len - 1))
    return SequenceBatch(torch.where(_bcast(in_a, ga), ga, gb),
                         a.lengths + b.lengths)


def seq_slice(seq: SequenceBatch, starts: torch.Tensor,
              ends: torch.Tensor) -> SequenceBatch:
    """SequenceSliceLayer: per-sample [start, end) window, re-packed at
    t = 0."""
    T = seq.max_len
    t = torch.arange(T, device=seq.lengths.device)[None, :]
    src = torch.clamp(t + starts.long()[:, None], 0, T - 1)
    new_len = torch.clamp(torch.minimum(ends, seq.lengths) - starts, 0, T)
    return SequenceBatch(take_time(seq.data, src), new_len.to(torch.int32))


def seq_reverse(seq: SequenceBatch) -> SequenceBatch:
    """Reverse each sequence within its valid length; padding zeroed."""
    T = seq.max_len
    t = torch.arange(T, device=seq.lengths.device)[None, :]
    src = torch.clamp(seq.lengths.long()[:, None] - 1 - t, 0, T - 1)
    out = SequenceBatch(take_time(seq.data, src), seq.lengths)
    return out.with_data(out.masked_data())


def context_projection(seq: SequenceBatch, context_len: int,
                       context_start: int,
                       pad_weights: Optional[torch.Tensor] = None
                       ) -> SequenceBatch:
    """ContextProjection: the window of neighbours of each timestep
    concatenated, [b, T, d] -> [b, T, d * context_len]. Positions out of
    range read zeros, or the trainable pad rows ``pad_weights``
    [pad_rows, d] (left rows first)."""
    x = seq.masked_data()
    T = x.shape[1]
    lens = seq.lengths.long()[:, None]
    t = torch.arange(T, device=x.device)[None, :]
    n_left = max(0, -context_start)
    outs = []
    for i in range(context_len):
        off = context_start + i
        sh = torch.roll(x, -off, dims=1)
        pos = t + off
        valid = (pos >= 0) & (pos < lens)
        part = sh * valid.to(x.dtype)[..., None]
        if pad_weights is not None:
            if off < 0:
                part = part + (pos < 0).to(x.dtype)[..., None] * \
                    pad_weights[i]
            elif off > 0:
                row = pad_weights[n_left + context_len - 1 - i] if \
                    pad_weights.shape[0] > n_left else pad_weights[i]
                oob = (pos >= lens) & (t < lens)
                part = part + oob.to(x.dtype)[..., None] * row
        outs.append(part)
    return seq.with_data(torch.cat(outs, dim=-1))


def sub_seq_pool(seq: SequenceBatch, pool_type: str = "average",
                 max_segments: Optional[int] = None) -> SequenceBatch:
    """Pool each inner sequence of a nested batch -> a sequence of pooled
    vectors [b, max_segments, d] (max_segments defaults to max_len)."""
    assert seq.is_nested, "sub_seq_pool needs a nested SequenceBatch"
    x = seq.data
    b, T = x.shape[0], x.shape[1]
    xs = x.reshape(b, T, -1)
    seg = seq.segment_ids.long()
    S = max_segments if max_segments is not None else T
    s_ids = torch.arange(S, device=x.device)
    onehot = (seg[..., None] == s_ids[None, None, :]).to(xs.dtype)
    sums = torch.einsum("btd,bts->bsd", xs, onehot)
    counts = torch.sum(onehot, dim=1)[..., None]
    tidx = torch.arange(T, device=x.device)[None, :, None]
    if pool_type in ("average", "avg"):
        pooled = sums / torch.clamp(counts, min=1.0)
    elif pool_type == "sum":
        pooled = sums
    elif pool_type == "max":
        big = torch.where(onehot[..., None] > 0, xs[:, :, None, :],
                          torch.full((), _NEG, dtype=xs.dtype,
                                     device=x.device))
        pooled = torch.amax(big, dim=1)
    elif pool_type == "last":
        last_t = torch.amax(torch.where(onehot > 0, tidx, -1), dim=1)
        pooled = take_time(xs, torch.clamp(last_t, min=0))
    elif pool_type == "first":
        first_t = torch.amin(torch.where(onehot > 0, tidx, T + 1), dim=1)
        pooled = take_time(xs, torch.clamp(first_t, 0, T - 1))
    else:
        raise ValueError(pool_type)
    return SequenceBatch(pooled, seq.num_segments)


def _scatter_rows(values: torch.Tensor, pos: torch.Tensor, n: int,
                  fill=0) -> torch.Tensor:
    """Per row r: out[r, pos[r, j]] = values[r, j] into an [b, n, ...]
    buffer of ``fill``; positions outside [0, n) are dropped (the JAX
    package's ``.at[].set(mode="drop")``)."""
    b = pos.shape[0]
    keep = (pos >= 0) & (pos < n)
    row0 = torch.arange(b, device=pos.device)[:, None] * (n + 1)
    flat = row0 + torch.where(keep, pos.long(), n)     # slot n: dropped
    feat = values.shape[pos.dim():]
    buf = torch.full((b * (n + 1),) + feat, fill, dtype=values.dtype,
                     device=values.device)
    buf = buf.index_put((flat.reshape(-1),),
                        values.reshape((-1,) + feat))
    return buf.reshape((b, n + 1) + feat)[:, :n]


def nested_to_padded(seq: SequenceBatch, max_segments=None,
                     max_sub_len=None):
    """Nested layout -> dense per-subsequence view: [b, T, ...] +
    segment_ids -> (data [b, S, L, ...], inner_len [b, S]); S and L
    default to T. Positions past the [S, L] view are dropped and the
    lengths agree with what is kept."""
    assert seq.is_nested, "nested_to_padded needs segment_ids"
    T = seq.max_len
    S = int(max_segments or T)
    Lm = int(max_sub_len or T)
    b = seq.batch_size
    segs = seq.segment_ids.long()
    dev = segs.device
    t_idx = torch.arange(T, device=dev)[None, :]
    valid = (segs >= 0) & (segs < S)
    seg_safe = torch.clamp(segs, 0, S - 1)
    eq = (seg_safe[:, None, :] == torch.arange(S, device=dev)[None, :, None]
          ) & valid[:, None, :]                                   # [b, S, T]
    first = torch.argmax(eq.to(torch.int32), dim=2)               # [b, S]
    inner_len = torch.clamp(eq.sum(dim=2), max=Lm).to(torch.int32)
    rank = t_idx - torch.gather(first, 1, seg_safe)
    flat_pos = torch.where(valid & (rank < Lm), seg_safe * Lm + rank,
                           S * Lm)
    buf = _scatter_rows(seq.data, flat_pos, S * Lm)
    return buf.reshape((b, S, Lm) + tuple(seq.data.shape[2:])), inner_len


def padded_to_nested(data: torch.Tensor, inner_len: torch.Tensor,
                     n_segments: torch.Tensor, out_len: int
                     ) -> SequenceBatch:
    """Inverse of nested_to_padded: [b, S, L, ...] + [b, S] -> a nested
    SequenceBatch of max_len ``out_len``."""
    b, S, Lm = data.shape[:3]
    dev = data.device
    s_ids = torch.arange(S, device=dev)[None, :]
    live = s_ids < n_segments.long()[:, None]                     # [b, S]
    ilen = torch.where(live, inner_len.long(), 0)
    offset = torch.cumsum(ilen, dim=1) - ilen
    l_idx = torch.arange(Lm, device=dev)[None, None, :]
    pos = offset[..., None] + l_idx                               # [b, S, L]
    keep = (l_idx < ilen[..., None]) & live[..., None]
    pos = torch.where(keep, pos, out_len).reshape(b, S * Lm)
    out = _scatter_rows(data.reshape((b, S * Lm) + tuple(data.shape[3:])),
                        pos, out_len)
    segs = _scatter_rows(s_ids.expand(b, S)[..., None].expand(b, S, Lm)
                         .reshape(b, S * Lm).to(torch.int32), pos, out_len,
                         fill=-1)
    return SequenceBatch(out, ilen.sum(dim=1).to(torch.int32), segs,
                         n_segments)
