"""Embedding table lookup — the port of the dense path of
``paddle_tpu/ops/embedding.py`` (the row-sparse prefetch path waits
for the slice that ports ``sparse_sub``)."""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     pad_id: int = -1) -> torch.Tensor:
    """table: [vocab, d]; ids: [...] int -> [..., d]. ids == pad_id
    yields 0; out-of-range ids clamp to the table, as in the JAX
    package. The gradient accumulates into the table rows (autograd's
    index backward), both uses of a tied table summing."""
    safe = ids.clamp(0, table.shape[0] - 1).long()
    out = table[safe]
    if pad_id is not None:
        out = out * (ids != pad_id)[..., None].to(out.dtype)
    return out
