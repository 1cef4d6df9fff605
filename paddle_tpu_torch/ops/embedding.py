"""Embedding / table lookup ops — the port of
``paddle_tpu/ops/embedding.py``: the dense lookup and the row-sparse
path.

The row-sparse path: the train step prefetches the batch's touched
rows (``touched_rows``), the forward looks ids up inside that small row
block (``row_sub_lookup``), so autograd yields gradients for the
``[k, emb]`` block only and never a dense ``[vocab, emb]`` one, and the
optimizer writes just those rows and their slots back
(``Optimizer.sparse_prefetch`` / ``update(sparse_rows=)``).
"""

from __future__ import annotations

from typing import Optional

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


def touched_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The batch's unique ids, static-shaped: ``[k = ids.numel()]``
    int64, sorted, padded with the out-of-range sentinel ``vocab`` —
    ``jnp.unique(size=, fill_value=)``'s result, element for element.
    This is the prefetch contract ``row_sub_lookup``'s binary search
    relies on. Built without a host sync: sort, mark the first of each
    run, cumsum the marks into each unique id's slot and scatter the
    ids there (a run's repeats write the same value to its slot)."""
    flat = ids.reshape(-1).clamp(0, vocab - 1).long()
    srt = torch.sort(flat).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    slot = torch.cumsum(first, 0) - 1
    return torch.full_like(srt, vocab).scatter_(0, slot, srt)


def touched_rows(table: torch.Tensor, ids: torch.Tensor):
    """Prefetch: (uids, rows) for the unique ids of a batch."""
    vocab = table.shape[0]
    uids = touched_ids(ids, vocab)
    return uids, table[uids.clamp(0, vocab - 1)]


def row_sub_lookup(uids: torch.Tensor, rows: torch.Tensor,
                   ids: torch.Tensor, vocab: int,
                   pad_id: Optional[int] = -1) -> torch.Tensor:
    """Lookup through a prefetched row block: every (valid) id of the
    batch is in ``uids`` (it came from the same batch), found by binary
    search since uids is sorted. The gradient of ``rows`` is [k, emb];
    repeated ids sum on their one row."""
    safe = ids.clamp(0, vocab - 1).long()
    pos = torch.searchsorted(uids.long(), safe)
    pos = pos.clamp(max=rows.shape[0] - 1)
    out = rows[pos]
    if pad_id is not None:
        out = out * (ids != pad_id)[..., None].to(out.dtype)
    return out


def one_hot(ids: torch.Tensor, depth: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (ids[..., None] == torch.arange(
        depth, dtype=torch.int32, device=ids.device)).to(dtype)


def sparse_dot(table: torch.Tensor, ids: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of table rows selected by ids (sparse_binary_vector x matrix
    — the SelectiveFC / sparse input FC pattern). ids: [b, k] padded
    with -1."""
    rows = embedding_lookup(table, ids)                    # [b, k, d]
    if weights is not None:
        rows = rows * weights[..., None]
    return torch.sum(rows, dim=-2)
