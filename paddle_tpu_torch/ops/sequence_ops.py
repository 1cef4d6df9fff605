"""Sequence ops over padded + masked SequenceBatch — the port of the
pooling and instance-selection part of ``paddle_tpu/ops/sequence_ops.py``
(nested-sequence and context-projection ops wait)."""

from __future__ import annotations

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


def last_instance(seq: SequenceBatch) -> torch.Tensor:
    """SequenceLastInstanceLayer: x[i, len_i - 1]."""
    x = seq.data
    idx = torch.clamp(seq.lengths.long() - 1, min=0)
    idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def first_instance(seq: SequenceBatch) -> torch.Tensor:
    return seq.data[:, 0]
