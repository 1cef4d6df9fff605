"""DataFeeder — per-sample Python/numpy rows to device feeds; the port
of ``paddle_tpu/trainer/data_feeder.py`` (integer, dense and sparse
columns, integer, dense and sparse binary sequences, and nested
sequences).

A sparse column (``sparse_binary`` rows are index lists,
``sparse_float`` rows ``(indices, values)``) becomes the same dense
``[b, dim]`` float32 tensor the JAX feeder builds in numpy, but built
on the device: the indices (and values) are copied over and scattered
into zeros there, so no ``[b, dim]`` host buffer exists.

Sequences are padded to the same length buckets as in the JAX
package, so both packages see the same feed shapes; a nested column
(a list of subsequences per sample) pads to its longest row, as the
JAX package's does. Every batch
carries ``__batch_size__``, its count of real rows. With
``fixed_batch_size`` a short batch pads to that many rows, as the JAX
feeder pads it: zero rows for a flat column, a one-step zero filler of
length 0 for a sequence column (a nested column is not padded).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.data_type import InputType, SeqType
from paddle_tpu_torch.core.sequence import (SequenceBatch, bucket_length,
                                            pack_nested_sequences,
                                            pack_sequences)
from paddle_tpu_torch.device import DeviceLike, resolve_device


class DataFeeder:
    def __init__(self, data_types, feeding=None,
                 fixed_batch_size: Optional[int] = None,
                 bucket_lengths: Sequence[int] = (16, 32, 64, 128, 256, 512,
                                                  1024),
                 device: DeviceLike = None):
        """data_types: [(name, InputType)] in feed order (from
        Topology.data_type()); feeding: name -> column index, a list of
        names, or None for positional order."""
        self.data_types = list(data_types)
        if feeding is None:
            self.feeding = {name: i for i, (name, _) in
                            enumerate(self.data_types)}
        elif isinstance(feeding, dict):
            self.feeding = feeding
        else:
            self.feeding = {name: i for i, name in enumerate(feeding)}
        self.fixed_batch_size = fixed_batch_size
        self.bucket_lengths = bucket_lengths
        self.device = resolve_device(device)

    def __call__(self, batch: Sequence[Sequence[Any]]) -> Dict[str, Any]:
        return self.convert(batch)

    def convert(self, batch) -> Dict[str, Any]:
        feed: Dict[str, Any] = {}
        for name, itype in self.data_types:
            col = self.feeding[name]
            try:
                rows = [sample[col] for sample in batch]
            except (IndexError, KeyError, TypeError) as e:
                raise ValueError(f"batch has no column {col} for data layer "
                                 f"{name!r} (feeding={self.feeding}): "
                                 f"{e}") from e
            feed[name] = self._convert_column(rows, itype)
        feed["__batch_size__"] = len(batch)
        return feed

    def _pad_count(self, n: int) -> int:
        if self.fixed_batch_size and n < self.fixed_batch_size:
            return self.fixed_batch_size - n
        return 0

    def _convert_column(self, rows: List[Any], itype: InputType):
        pad = self._pad_count(len(rows))
        if itype.seq_type == SeqType.SEQUENCE and pad:
            # one-step zero fillers, given length 0 once packed
            filler = [[]] if itype.kind == "sparse_binary" else \
                np.zeros((1,) if itype.kind == "integer"
                         else (1, itype.dim), np.float32
                         if itype.kind == "dense" else np.int32)
            out = self._convert_unpadded(list(rows) + [filler] * pad, itype)
            lengths = out.lengths.clone()
            lengths[len(rows):] = 0
            return SequenceBatch(out.data, lengths)
        if itype.seq_type == SeqType.NO_SEQUENCE and pad:
            out = self._convert_unpadded(rows, itype)
            return torch.cat([out, out.new_zeros((pad,) + out.shape[1:])])
        return self._convert_unpadded(rows, itype)

    def _convert_unpadded(self, rows: List[Any], itype: InputType):
        if itype.seq_type == SeqType.NO_SEQUENCE:
            if itype.kind == "dense":
                arr = np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)
            elif itype.kind == "integer":
                arr = np.asarray(rows, dtype=np.int32).reshape(len(rows))
            elif itype.kind == "sparse_binary":
                return self._scatter_dense(
                    (len(rows), itype.dim),
                    [(i, r, None) for i, r in enumerate(rows)])
            elif itype.kind == "sparse_float":
                return self._scatter_dense(
                    (len(rows), itype.dim),
                    [(i, idx, vals) for i, (idx, vals) in enumerate(rows)])
            else:
                raise ValueError(f"unsupported input kind {itype.kind}")
            return torch.from_numpy(arr).to(self.device)
        if itype.seq_type == SeqType.SEQUENCE:
            if itype.kind == "integer":
                np_rows = [np.asarray(r, np.int32) for r in rows]
            elif itype.kind == "dense":
                np_rows = [np.asarray(r, np.float32).reshape(-1, itype.dim)
                           for r in rows]
            elif itype.kind == "sparse_binary":
                max_len = bucket_length(max(len(r) for r in rows),
                                        self.bucket_lengths)
                data = self._scatter_dense(
                    (len(rows), max_len, itype.dim),
                    [((i, t), idxs, None) for i, r in enumerate(rows)
                     for t, idxs in enumerate(r[:max_len])])
                lengths = np.minimum([len(r) for r in rows], max_len)
                return SequenceBatch(data, torch.from_numpy(
                    lengths.astype(np.int32)).to(self.device))
            else:
                raise ValueError(f"unsupported sequence kind {itype.kind}")
            max_len = bucket_length(max(r.shape[0] for r in np_rows),
                                    self.bucket_lengths)
            return pack_sequences(np_rows, max_len=max_len,
                                  device=self.device)
        if itype.kind not in ("integer", "dense"):
            raise ValueError(f"unsupported nested kind {itype.kind}")
        conv = []
        for sample in rows:
            if itype.kind == "integer":
                conv.append([np.asarray(s, np.int32) for s in sample])
            else:
                conv.append([np.asarray(s, np.float32).reshape(-1, itype.dim)
                             for s in sample])
        return pack_nested_sequences(conv, device=self.device)

    def _scatter_dense(self, shape, entries) -> torch.Tensor:
        """A float32 tensor of ``shape``, zero but at the given entries:
        ``(leading index, indices, values or None for 1.0)`` each, the
        indices along the last axis. numpy's assignment semantics, which
        the JAX feeder's ``dense[i, idx] = vals`` has: a negative index
        counts from the end, an out-of-range one raises IndexError, and
        of repeated positions the last value wins (kept on the host, so
        the device scatter writes each position once)."""
        dim = shape[-1]
        lead = int(np.prod(shape[:-1]))
        pos, vals = [], []
        for at, idx, v in entries:
            idx = np.asarray(idx, np.int64).reshape(-1)
            bad = (idx < -dim) | (idx >= dim)
            if bad.any():
                raise IndexError(f"index {int(idx[bad][0])} is out of "
                                 f"bounds for a sparse input of dim {dim}")
            row = np.ravel_multi_index(at, shape[:-1]) if \
                isinstance(at, tuple) else at
            pos.append(row * dim + np.where(idx < 0, idx + dim, idx))
            vals.append(np.ones(idx.shape, np.float32) if v is None
                        else np.asarray(v, np.float32).reshape(idx.shape))
        pos = np.concatenate(pos) if pos else np.zeros(0, np.int64)
        vals = np.concatenate(vals) if vals else np.zeros(0, np.float32)
        if any(v is not None for _, _, v in entries):
            # the last write of a repeated position wins
            _, last = np.unique(pos[::-1], return_index=True)
            keep = len(pos) - 1 - last
            pos, vals = pos[keep], vals[keep]
        out = torch.zeros(lead * dim, dtype=torch.float32, device=self.device)
        out[torch.from_numpy(pos).to(self.device)] = \
            torch.from_numpy(vals).to(self.device)
        return out.reshape(shape)
