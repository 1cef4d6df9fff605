"""paddle_tpu_torch.embed — hash-partitioned embedding/parameter store
(the port of ``paddle_tpu/embed/``: the same wire, the same WAL and
snapshot frames, so shards, clients and snapshot stores of the two
packages mix).

The 2017 `paddle/pserver/` pair (ParameterServer2/ParameterClient2,
the sharded KV store for sparse parameters behind production CTR
ranking), rebuilt on the port's elastic plane:

- :mod:`shard` — :class:`EmbeddingShard` (row-sparse slice, WAL +
  snapshot durability, exactly-once applied ledger) and its XML-RPC
  server; splitmix64 ``shard_of`` routing.
- :mod:`client` — :class:`EmbeddingClient`: consistent-hash routing,
  batched gather with a bounded-staleness cache (violations journaled),
  async-SGD sparse pushes with reconcile-guard semantics.
- :mod:`service` — membership-plane registration (leases + failover
  directory) and the in-process multi-shard harness.
- :mod:`lookup` — :class:`RemoteLookup`: `layers.embedding(remote=True)`
  routes through the store via the existing ``sparse_sub`` seam, the
  row blocks as tensors on the model's device.
- :mod:`online` — continuous training: serving journal -> self-healing
  reader pipeline -> live sparse updates while lookups continue.
- :mod:`obs` — ``paddle_tpu_embed_*`` gauges + flight-bundle provider.

Chaos family (o) in :mod:`paddle_tpu_torch.testing.faults` drives
SIGKILL'd shards, stale reads and slow shards against all of it.
"""

from paddle_tpu_torch.embed.client import EmbeddingClient, EmbedUnavailable
from paddle_tpu_torch.embed.lookup import RemoteLookup
from paddle_tpu_torch.embed.online import (OnlineTrainer, journal_sample_reader,
                                     log_sample, run_online,
                                     serving_sample_log)
from paddle_tpu_torch.embed.service import EmbedService, ShardRegistration
from paddle_tpu_torch.embed.shard import (EmbeddingShard, EmbeddingShardServer,
                                    ShardKilled, shard_of, stable_hash64)

__all__ = [
    "EmbeddingClient", "EmbedUnavailable", "RemoteLookup",
    "OnlineTrainer", "journal_sample_reader", "log_sample", "run_online",
    "serving_sample_log", "EmbedService", "ShardRegistration",
    "EmbeddingShard", "EmbeddingShardServer", "ShardKilled", "shard_of",
    "stable_hash64",
]
