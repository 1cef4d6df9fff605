"""Observability wiring for the sharded embedding service.

Same pattern as the coordinator's collector: live shards/clients are
tracked by WEAKREF — the scrape reads whatever is alive at scrape time,
nothing pushes gauges on the hot path, and a dead object silently drops
out of the catalog. The flight recorder gets an ``embed`` state
provider so a postmortem bundle dumped for ANY reason carries the
shard/client counters of the moment.

Gauge catalog (``paddle_tpu_embed_*``): the JAX package's, name for
name (obs/catalog.py declares the prefixes).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict

from paddle_tpu_torch.analysis.lockdep import named_lock

_lock = named_lock("embed.obs")
_SHARDS: "weakref.WeakSet" = weakref.WeakSet()   # ptlint: guarded-by(embed.obs)
_CLIENTS: "weakref.WeakSet" = weakref.WeakSet()  # ptlint: guarded-by(embed.obs)


def track_shard(shard) -> None:
    """Register a live shard for scraping (called at construction)."""
    _install()
    with _lock:
        _SHARDS.add(shard)


def track_client(client) -> None:
    _install()
    with _lock:
        _CLIENTS.add(client)


def _live():
    with _lock:
        return list(_SHARDS), list(_CLIENTS)


_SHARD_GAUGES = (
    ("rows", "materialized (updated) rows held by the shard"),
    ("gathers", "row-gather RPCs served"),
    ("gathered_rows", "rows returned by gathers"),
    ("applied_updates", "scatter-update batches applied exactly once"),
    ("updated_rows", "rows mutated by applied updates"),
    ("dup_updates", "retried batches deduped by the applied-seq ledger"),
    ("replayed_wal", "WAL entries replayed at the last restore"),
    ("wal_seq", "write-ahead-log horizon"),
)

_CLIENT_GAUGES = (
    ("cached_rows", "rows in the bounded-staleness read cache"),
    ("gathers", "gather RPCs issued"),
    ("cache_hits", "rows served from cache within the staleness bound"),
    ("stale_serves", "rows served PAST the bound (journaled violations)"),
    ("pushes", "sparse update batches acked"),
    ("pushed_rows", "gradient rows acked"),
    ("dup_acks", "acks answered 'dup' (exactly-once retries absorbed)"),
    ("push_failures", "update batches lost past the retry deadline"),
    ("failovers", "transport failures that triggered re-resolution"),
)


def _embed_collector():
    from paddle_tpu_torch.obs.metrics import SampleFamily
    shards, clients = _live()
    if not shards and not clients:
        return []
    out = []
    shard_stats = [s.stats() for s in shards]
    client_stats = [c.stats() for c in clients]
    for key, help_ in _SHARD_GAUGES:
        fam = SampleFamily(f"paddle_tpu_embed_shard_{key}", "gauge",
                           help_)
        for st in shard_stats:
            fam.add({"shard": str(st["shard_id"])}, float(st[key]))
        out.append(fam)
    for key, help_ in _CLIENT_GAUGES:
        fam = SampleFamily(f"paddle_tpu_embed_client_{key}", "gauge",
                           help_)
        for st in client_stats:
            fam.add({"client": st["client_id"]}, float(st[key]))
        out.append(fam)
    return out


def _flight_state() -> Dict[str, Any]:
    shards, clients = _live()
    return {"shards": [s.stats() for s in shards],
            "clients": [c.stats() for c in clients]}


def _install():
    """(Re-)install the registry collector + flight provider. Called on
    every track_* — both calls are idempotent dict/set writes, and the
    flight registration MUST repeat because between-tests hygiene
    (obs.reset_all -> FLIGHT.reset) clears all state providers; a
    once-per-process latch would leave later EmbedServices invisible
    to postmortem bundles."""
    try:
        from paddle_tpu_torch.obs.flight import FLIGHT
        from paddle_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.register_collector(_embed_collector)
        FLIGHT.register_state_provider("embed", _flight_state)
    except Exception:  # noqa: BLE001 — obs must not break construction
        pass
