"""RemoteLookup — route `layers.embedding(remote=True)` through the store.

The transparency contract: a model config that says
``layers.embedding(input=ids, size=64, remote=True)`` keeps its exact
layer graph, but the `[vocab, 64]` table never materializes on the
device. Before each forward, :class:`RemoteLookup` reads the batch's
ids HOST-side from the feed, gathers just the touched rows from the
sharded store through an :class:`EmbeddingClient` (bounded-staleness
cache and failover included), and hands them to the forward as the
same ``sparse_sub={param: (uids, rows)}`` row blocks the local
row-sparse trainer path already consumes (``ops.embedding.
row_sub_lookup``), as tensors on the model's device. The layer cannot
tell a remote table from a prefetched local one.

Every remote table of one lookup reads through ONE client, so the
tables share one key space: id 7 of two tables is one row of the store
(the JAX package's contract, kept). Tables that must not share rows
take clients of their own stores.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["RemoteLookup"]


class RemoteLookup:
    """Per-batch sparse_sub builder for every remote table in a topology.

    topology: a core.topology.Topology (or anything with
    ``remote_tables() -> {param_name: ids_layer_name}``).
    client: the :class:`EmbeddingClient` all tables share.
    device: where the row blocks go (default: the process's device,
    ``device.resolve_device``).
    """

    def __init__(self, topology, client, device=None):
        from paddle_tpu_torch.device import resolve_device
        self.client = client
        self.tables: Dict[str, str] = topology.remote_tables()
        self.device = resolve_device(device)
        self.gathered_batches = 0

    def sparse_sub(self, feed: Dict[str, Any],
                   max_stale_s: Optional[float] = None) -> Dict[str, Any]:
        """Gather the row blocks this batch touches.

        feed: the feeder's name->array dict (ids may be [b] or [b, T];
        pad id -1 is skipped — `row_sub_lookup` maps it to a zero row).
        Returns {param_name: (uids [k] int64, rows [k, dim] float32)}
        as tensors on the lookup's device, ready for
        ``Topology.forward(sparse_sub=...)``."""
        sub: Dict[str, Any] = {}
        for pname, src in sorted(self.tables.items()):
            ids = self._ids(feed[src])
            if isinstance(ids, torch.Tensor):
                ids = ids.detach().cpu().numpy()
            ids = np.asarray(ids).reshape(-1)
            uids = np.unique(ids[ids >= 0]).astype(np.int64)
            rows = self.client.gather(uids, max_stale_s=max_stale_s)
            sub[pname] = (torch.from_numpy(uids).to(self.device),
                          torch.from_numpy(rows).to(self.device))
        self.gathered_batches += 1
        return sub

    @staticmethod
    def _ids(value):
        # feeds may carry SequenceBatch-like wrappers; ids are the payload
        return getattr(value, "data", value)

    def push_grads(self, sub: Dict[str, Any], grads: Dict[str, Any],
                   lr: Optional[float] = None):
        """Push the row-block gradients a training step produced back to
        the store: ``grads[param]`` is d(loss)/d(rows) aligned with the
        ``sub[param]`` uids (a tensor or an array) — the async-SGD
        write half of the loop."""
        for pname, g in grads.items():
            uids, _ = sub[pname]
            if isinstance(uids, torch.Tensor):
                uids = uids.detach().cpu().numpy()
            if isinstance(g, torch.Tensor):
                g = g.detach().float().cpu().numpy()
            self.client.push(uids, np.asarray(g), lr=lr)
