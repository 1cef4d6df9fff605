"""Ragged and nested sequence batches — the port of
``paddle_tpu/core/sequence.py``.

A batch of variable-length sequences is a dense padded tensor plus
per-row lengths; masking replaces re-packing, as in the JAX package.
Nested (sub-)sequences carry a per-position ``segment_ids`` plane that
maps each timestep to its inner sequence (-1 on padding) and the count
of inner sequences per row, ``num_segments``.
"""

from __future__ import annotations

from typing import Optional, Sequence as PySequence

import numpy as np
import torch


class SequenceBatch:
    """A batch of padded variable-length sequences.

    data:         [batch, max_len, *feature_dims] (or [batch, max_len] for ids)
    lengths:      [batch] int32 — valid timesteps per row
    segment_ids:  optional [batch, max_len] int32 — inner-sequence index
                  per position (nested sequences); -1 on padding
    num_segments: optional [batch] int32 — inner sequences per row
    """

    def __init__(self, data: torch.Tensor, lengths: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None,
                 num_segments: Optional[torch.Tensor] = None):
        self.data = data
        self.lengths = lengths
        self.segment_ids = segment_ids
        self.num_segments = num_segments

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    @property
    def is_nested(self) -> bool:
        return self.segment_ids is not None

    def bool_mask(self) -> torch.Tensor:
        t = torch.arange(self.max_len, device=self.lengths.device)
        return t[None, :] < self.lengths[:, None]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """[batch, max_len] 1.0 on valid positions, 0.0 on padding."""
        return self.bool_mask().to(dtype)

    def masked_data(self) -> torch.Tensor:
        """The data with padding positions zeroed."""
        m = self.mask(self.data.dtype)
        return self.data * m.reshape(m.shape + (1,) * (self.data.dim() - 2))

    def with_data(self, data: torch.Tensor) -> "SequenceBatch":
        return SequenceBatch(data, self.lengths, self.segment_ids,
                             self.num_segments)

    def total_tokens(self) -> torch.Tensor:
        return torch.sum(self.lengths)

    def __repr__(self):
        return (f"SequenceBatch(data={tuple(self.data.shape)}, "
                f"lengths={tuple(self.lengths.shape)}, "
                f"nested={self.is_nested})")


def pack_sequences(rows: PySequence[np.ndarray], max_len: Optional[int] = None,
                   pad_value=0, dtype=None, device=None) -> SequenceBatch:
    """Pack per-sample [len, ...] arrays into a padded SequenceBatch on
    ``device`` (the CPU when None)."""
    rows = [np.asarray(r) for r in rows]
    lengths = np.asarray([r.shape[0] for r in rows], dtype=np.int32)
    ml = int(max_len if max_len is not None
             else (lengths.max() if len(rows) else 0))
    ml = max(ml, 1)
    feat = rows[0].shape[1:] if rows else ()
    if dtype is None:
        dtype = rows[0].dtype if rows else np.float32
    out = np.full((len(rows), ml) + feat, pad_value, dtype=dtype)
    for i, r in enumerate(rows):
        n = min(r.shape[0], ml)
        out[i, :n] = r[:n]
    return SequenceBatch(torch.from_numpy(out).to(device),
                         torch.from_numpy(np.minimum(lengths, ml)).to(device))


def pack_nested_sequences(rows: PySequence[PySequence[np.ndarray]],
                          pad_value=0, dtype=None,
                          device=None) -> SequenceBatch:
    """Pack per-sample lists of [sub_len, ...] arrays (nested sequences):
    each sample's subsequences are flattened along time, and
    ``segment_ids`` marks which subsequence each position belongs to."""
    flat_rows, seg_rows, num_segs = [], [], []
    for sample in rows:
        parts = [np.asarray(p) for p in sample]
        flat_rows.append(np.concatenate(parts, axis=0) if parts
                         else np.zeros((0,), dtype=np.float32))
        seg_rows.append(np.concatenate(
            [np.full(p.shape[0], i, dtype=np.int32)
             for i, p in enumerate(parts)]) if parts
            else np.zeros((0,), dtype=np.int32))
        num_segs.append(len(parts))
    packed = pack_sequences(flat_rows, pad_value=pad_value, dtype=dtype,
                            device=device)
    ml = packed.max_len
    seg_arr = np.full((len(rows), ml), -1, dtype=np.int32)
    for i, s in enumerate(seg_rows):
        seg_arr[i, :min(len(s), ml)] = s[:ml]
    return SequenceBatch(packed.data, packed.lengths,
                         torch.from_numpy(seg_arr).to(device),
                         torch.from_numpy(np.asarray(num_segs, np.int32))
                         .to(device))


def bucket_length(n: int, buckets: PySequence[int] = (16, 32, 64, 128, 256,
                                                      512, 1024)) -> int:
    """Round a max length up to a bucket (the JAX package's buckets, so
    both packages pad a batch to the same width)."""
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])
