"""DataFeeder — per-sample Python/numpy rows to device feeds; the port
of ``paddle_tpu/trainer/data_feeder.py`` (integer and dense columns,
integer and dense sequences and nested sequences).

Sequences are padded to the same length buckets as in the JAX
package, so both packages see the same feed shapes; a nested column
(a list of subsequences per sample) pads to its longest row, as the
JAX package's does. Every batch
carries ``__batch_size__``, its count of real rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.data_type import InputType, SeqType
from paddle_tpu_torch.core.sequence import (bucket_length,
                                            pack_nested_sequences,
                                            pack_sequences)
from paddle_tpu_torch.device import DeviceLike, resolve_device


class DataFeeder:
    def __init__(self, data_types, feeding=None,
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

    def _convert_column(self, rows: List[Any], itype: InputType):
        if itype.seq_type == SeqType.NO_SEQUENCE:
            if itype.kind == "dense":
                arr = np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)
            elif itype.kind == "integer":
                arr = np.asarray(rows, dtype=np.int32).reshape(len(rows))
            else:
                raise NotImplementedError(
                    f"{itype.kind} inputs are not ported yet")
            return torch.from_numpy(arr).to(self.device)
        if itype.seq_type == SeqType.SEQUENCE:
            if itype.kind == "integer":
                np_rows = [np.asarray(r, np.int32) for r in rows]
            elif itype.kind == "dense":
                np_rows = [np.asarray(r, np.float32).reshape(-1, itype.dim)
                           for r in rows]
            else:
                raise NotImplementedError(
                    f"{itype.kind} sequences are not ported yet")
            max_len = bucket_length(max(r.shape[0] for r in np_rows),
                                    self.bucket_lengths)
            return pack_sequences(np_rows, max_len=max_len,
                                  device=self.device)
        conv = []
        for sample in rows:
            if itype.kind == "integer":
                conv.append([np.asarray(s, np.int32) for s in sample])
            else:
                conv.append([np.asarray(s, np.float32).reshape(-1, itype.dim)
                             for s in sample])
        return pack_nested_sequences(conv, device=self.device)
