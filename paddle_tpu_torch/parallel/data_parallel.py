"""Data-parallel feed sharding — the port of
``paddle_tpu/parallel/data_parallel.py``.

The JAX package wraps its train step in one jit whose feed is
dp-sharded (``shard_train_step``); XLA all-reduces the gradients of the
replicated parameters. In the port every rank runs the trainer's step
on its own dp block of the GLOBAL batch, which every rank's reader
yields, and the trainer makes the collectives explicit
(trainer/trainer.py): the loss is each rank's masked cost over its
rows with their global indices, divided by the GLOBAL real-row count,
so the ranks' losses and gradients sum to the one global program's;
the evaluators' inputs come back gathered over dp
(:func:`gather_rows`), so every rank's host evaluators see the whole
batch.

Over ``mp``, ``sp``, ``ep`` and ``pp`` the feed is not split: every
rank of such a group sees the same rows. A batch whose rows dp does not
divide raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.mesh import (DP_AXIS, NamedSharding, P,
                                            axis_index, axis_names,
                                            axis_size)


def dp_block(mesh, rows: int) -> Tuple[int, int]:
    """(first global row, row count) of this rank's dp block of a batch
    of ``rows`` rows."""
    n = axis_size(mesh, DP_AXIS)
    if rows % n:
        raise ValueError(f"dp={n} must divide the batch's {rows} rows")
    local = rows // n
    return axis_index(mesh, DP_AXIS) * local, local


def shard_feed(feed: Dict, mesh) -> Dict:
    """This rank's dp block of every feed entry (the whole feed on a
    mesh without dp)."""
    if axis_size(mesh, DP_AXIS) == 1 or not feed:
        return feed
    from paddle_tpu_torch.trainer.memory import _leading_rows, _rows
    row0, local = dp_block(mesh, _leading_rows(feed))
    return {k: _rows(v, row0, row0 + local) for k, v in feed.items()}


def microbatch_shardings(parts: List[Dict], mesh) -> List[Dict]:
    """The placement of a feed split into k microbatches (the gradient
    accumulation of trainer/memory.py): the accumulation axis is time,
    every rank runs all k; each microbatch's ROW axis keeps the dp
    split."""
    spec = P(None, DP_AXIS) if DP_AXIS in axis_names(mesh) else P()
    return [{k: NamedSharding(mesh, spec) for k in part} for part in parts]


def shard_microbatched_feed(parts: List[Dict], mesh) -> List[Dict]:
    """Each microbatch's dp block of rows — never a share of the k
    microbatches, which would serialize the accumulation across
    ranks."""
    return [shard_feed(part, mesh) for part in parts]


def gather_rows(v, mesh):
    """A per-row value (tensor or SequenceBatch) gathered over dp in
    rank order: the global batch's rows (not differentiable)."""
    if axis_size(mesh, DP_AXIS) == 1:
        return v
    with torch.no_grad():
        if isinstance(v, SequenceBatch):
            cut = [None if t is None else comm.all_gather(t, mesh, DP_AXIS)
                   for t in (v.segment_ids, v.num_segments)]
            return SequenceBatch(comm.all_gather(v.data, mesh, DP_AXIS),
                                 comm.all_gather(v.lengths, mesh, DP_AXIS),
                                 *cut)
        return comm.all_gather(v, mesh, DP_AXIS)
