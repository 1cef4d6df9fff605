"""Ragged sequence batches — the port of ``paddle_tpu/core/sequence.py``.

A batch of variable-length sequences is a dense padded tensor plus
per-row lengths; masking replaces re-packing, as in the JAX package.
Nested (sub-)sequences are not in this slice.
"""

from __future__ import annotations

from typing import Optional, Sequence as PySequence

import numpy as np
import torch


class SequenceBatch:
    """A batch of padded variable-length sequences.

    data:    [batch, max_len, *feature_dims] (or [batch, max_len] for ids)
    lengths: [batch] int32 — valid timesteps per row
    """

    def __init__(self, data: torch.Tensor, lengths: torch.Tensor):
        self.data = data
        self.lengths = lengths

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    def bool_mask(self) -> torch.Tensor:
        t = torch.arange(self.max_len, device=self.lengths.device)
        return t[None, :] < self.lengths[:, None]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """[batch, max_len] 1.0 on valid positions, 0.0 on padding."""
        return self.bool_mask().to(dtype)

    def with_data(self, data: torch.Tensor) -> "SequenceBatch":
        return SequenceBatch(data, self.lengths)

    def __repr__(self):
        return (f"SequenceBatch(data={tuple(self.data.shape)}, "
                f"lengths={tuple(self.lengths.shape)})")


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


def bucket_length(n: int, buckets: PySequence[int] = (16, 32, 64, 128, 256,
                                                      512, 1024)) -> int:
    """Round a max length up to a bucket (the JAX package's buckets, so
    both packages pad a batch to the same width)."""
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])
