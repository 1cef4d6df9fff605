"""Fleet observability: the ``paddle_tpu_fleet_*`` exposition + flight
state — the port of ``paddle_tpu/fleet/obs.py`` (the family names are
the JAX package's).

Same pattern as serving/http.py: the router's ``stats()`` dict is
flattened into Prometheus families at scrape time through
obs.metrics.stats_families — cumulative leaves keep counter semantics,
everything else is a gauge — and the global REGISTRY rides along so
one scrape of the router sees the whole process. The flight recorder
gets a live state provider (in-flight trace_ids by replica, drain
marks) so a postmortem bundle shows what the router was doing when a
fault fired.
"""

from __future__ import annotations

import weakref

from paddle_tpu_torch.obs.flight import FLIGHT
from paddle_tpu_torch.obs.metrics import REGISTRY, stats_families

__all__ = ["prometheus_text", "register_flight_provider",
           "_COUNTER_KEYS"]

#: router stats() leaf keys with cumulative (counter) semantics; every
#: other numeric leaf is a gauge. Flattened names
#: (paddle_tpu_fleet_routed, paddle_tpu_fleet_failovers,
#: paddle_tpu_fleet_rejected_kv_capacity ...) are test-pinned.
_COUNTER_KEYS = {
    "routed", "affinity_hits", "failovers", "reroutes",
    "rejected_kv_capacity", "rejected_queue_full",
    "rejected_no_replica", "drains", "rejoins", "settled",
    "settled_failover", "queued", "scrape_errors",
}

#: Autopilot stats() leaves with counter semantics — the rest
#: (replicas_live, shed_rate, headroom_frac, headroom_trend_per_s,
#: min/max_replicas, last_decision_age_s) export as gauges. Flattened
#: names (paddle_tpu_autopilot_scale_ups, paddle_tpu_autopilot_ticks,
#: paddle_tpu_autopilot_deploys_paused ...) are obs/catalog.py's
#: ``paddle_tpu_autopilot_`` family.
_AUTOPILOT_COUNTER_KEYS = {
    "ticks", "scale_ups", "scale_downs", "spawn_failures",
    "slo_breaches_seen", "deploys", "deploys_paused",
}


def prometheus_text(router, prefix: str = "paddle_tpu_fleet",
                    autopilot=None) -> str:
    """Render ``router.stats()`` (plus ``autopilot.stats()`` as
    ``paddle_tpu_autopilot_*`` when one is attached) PLUS the global
    metrics registry as Prometheus text exposition 0.0.4 — the
    router's GET /metrics."""
    extra = stats_families(prefix, router.stats(), _COUNTER_KEYS)
    if autopilot is not None:
        extra = extra + stats_families("paddle_tpu_autopilot",
                                       autopilot.stats(),
                                       _AUTOPILOT_COUNTER_KEYS)
    return REGISTRY.exposition(extra=extra)


def register_flight_provider(router) -> None:
    """Weakref'd live-state provider: what was in flight (trace_ids by
    replica) and which replicas were draining when a bundle dumped."""
    ref = weakref.ref(router)

    def _state():
        rt = ref()
        if rt is None:
            return None
        return rt.flight_state()

    FLIGHT.register_state_provider(f"fleet-router-{id(router):x}",
                                   _state)
