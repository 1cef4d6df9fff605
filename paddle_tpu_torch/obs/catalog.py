"""The declared observability contract — the port's copy of
``paddle_tpu/obs/catalog.py``, data for data (``catalog_as_dict()``
equals the JAX package's; tests/test_torch_obs_plane.py holds them
JSON-equal).

- **JOURNALS** — every legal journal ``(domain, kind)`` with its
  required/optional field names (``cli.py obs catalog`` dumps it for
  external scrapers).
- **METRICS / METRIC_PREFIXES** — every ``paddle_tpu_*`` metric family
  (name, type, label set) plus the dynamic stats-flattened prefixes.
- **PROTOCOLS** — correlation-keyed state machines for the orderings
  the system enforces (hop start->settle|torn|error, route->
  [failover*]->exactly-one settle, page spill->restore|integrity, ...):
  obs/protocol.py's ProtocolWitness advances them at runtime.

The artifact plane (artifacts/) and the embedding service (embed/)
emit their declared records; declarations of planes the port has not
yet (fleet, autopilot, soak) stay: the contract is the system's, and
the two packages' journals must mean the same thing.

Import-light (dataclasses only — no torch, no obs runtime).

Machine semantics (shared by the witness and the audits):

- a record matching a protocol's ``start`` opens a machine for its
  correlation key; a second start while open SUPERSEDES the previous
  instance (or EXTENDS it, ``on_restart="extend"``);
- ``intermediates`` append to the open machine's chain; unmatched
  intermediates are ignored;
- a ``Terminal`` closes the machine.  A terminal whose
  ``orphan_violates`` is True arriving for a key with NO open machine
  is a violation — the exactly-once property (a second settle for a
  settled trace, a hop settle with no hop start);
- machines still open are NOT live violations (a killed process
  legitimately never settles its hop); ``ProtocolWitness.finalize()``
  reports them on demand.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = [
    "JournalKind", "MetricFamilyDecl", "EventMatch", "Terminal",
    "Protocol", "FaultChainSpec", "JOURNALS", "METRICS",
    "METRIC_PREFIXES", "PROTOCOLS", "FAULT_FAMILIES",
    "journal_entry", "protocol_for_start", "catalog_as_dict",
]


# --------------------------------------------------------------------- journal
@dataclass(frozen=True)
class JournalKind:
    """One legal (domain, kind): which fields every emit site must
    pass (``required``) and which it may (``optional``).  ``dynamic``
    marks kinds whose emit goes through a non-literal dispatch
    (``emit_event`` on trainer-event objects) — R11's stale-entry
    check exempts them because no literal site exists to count."""
    domain: str
    kind: str
    required: Tuple[str, ...] = ()
    optional: Tuple[str, ...] = ()
    dynamic: bool = False
    description: str = ""

    @property
    def key(self) -> Tuple[str, str]:
        return (self.domain, self.kind)


def _j(domain, kind, required=(), optional=(), dynamic=False, desc=""):
    return JournalKind(domain, kind, tuple(required), tuple(optional),
                       dynamic, desc)


_JOURNAL_DECLS = (
    # -- artifacts (warm-start plane)
    _j("artifacts", "load", ("name", "digest", "source"),
       desc="AOT executable served from the artifact store"),
    _j("artifacts", "build", ("name", "digest", "build_ms",
                              "payload_bytes"),
       desc="cold compile persisted into the store"),
    _j("artifacts", "build_failed", ("name", "digest", "detail"),
       desc="built in-process but could not be persisted"),
    _j("artifacts", "fallback", ("name", "path", "reason", "detail"),
       desc="stored artifact unusable; degraded to JIT"),
    _j("artifacts", "verify_failed", ("name", "path", "detail"),
       desc="store verify pass found a bad frame"),
    # -- autopilot (fleet controller)
    _j("autopilot", "scale_up", ("replica", "endpoint", "reason",
                                 "evidence"),
       desc="autoscaler spawned a replica; evidence is the journaled "
            "signal that justified it"),
    _j("autopilot", "scale_down", ("replica", "reason", "evidence"),
       desc="autoscaler drained+stopped a replica"),
    _j("autopilot", "spawn_failed", ("replica", "error", "reason")),
    _j("autopilot", "stop_failed", ("replica", "error")),
    _j("autopilot", "deploy_start", ("replicas", "force"),
       desc="rolling deploy began (protocol: autopilot_deploy)"),
    _j("autopilot", "deploy_step", ("replica", "ready"),
       ("drain_settled", "endpoint", "step_s")),
    _j("autopilot", "deploy_done", ("replicas", "wall_s")),
    _j("autopilot", "deploy_paused", ("replica", "breaches",
                                      "remaining"),
       ("completed", "reason")),
    _j("autopilot", "deploy_compile_budget_breach",
       ("compiles", "budget"), ("per_function",)),
    # -- checkpoint
    _j("checkpoint", "save", ("step", "path", "background")),
    _j("checkpoint", "restore", ("step", "path")),
    # -- coordinator (membership plane)
    _j("coordinator", "join", ("worker_id", "rejoin", "generation",
                               "workers")),
    _j("coordinator", "leave", ("worker_id", "generation", "workers")),
    _j("coordinator", "lease_expired", ("worker_id", "workers")),
    _j("coordinator", "generation", ("generation", "reason")),
    _j("coordinator", "reshard", ("reason", "generation", "todo",
                                  "pending", "workers")),
    _j("coordinator", "stale_grant", ("rpc", "task_id",
                                      "grant_generation",
                                      "current_generation")),
    _j("coordinator", "clock_sync", ("offset_s", "rtt_s", "samples")),
    # -- data pipeline (literal quarantine site + DataFaultEvent kinds)
    _j("data", "quarantine", ("count", "where"), ("error",)),
    _j("data", "data_budget", ("count", "where"), ("error",),
       dynamic=True, desc="ErrorBudget exhausted (DataFaultEvent)"),
    _j("data", "source_stall", ("count", "where"), ("error",),
       dynamic=True),
    _j("data", "worker_restart", ("count", "where"), ("error",),
       dynamic=True),
    # -- embed (sharded parameter service)
    _j("embed", "update", ("shard_id", "rows", "seq", "dup"),
       desc="WAL-durable sparse update applied (ack follows append)"),
    _j("embed", "gather", ("shard_id", "rows")),
    _j("embed", "snapshot", ("shard_id", "rows", "wal_upto")),
    _j("embed", "restore", ("shard_id", "from_snapshot", "replayed")),
    _j("embed", "shard_killed", ("shard_id",)),
    _j("embed", "shard_replaced", ("shard_id", "replayed",
                                   "endpoint")),
    _j("embed", "stale_read", ("shard_id", "rows", "age_s", "bound_s"),
       ("trace_id",)),
    _j("embed", "push_failed", (), ("error", "shard_id", "rows", "seq",
                                    "trace_id")),
    _j("embed", "sample", (), ("ids", "label"),
       desc="online-training sample journaled from the serving path"),
    _j("embed", "online_pass", ("batches", "samples"), ("loss_last",)),
    # -- engine (decode)
    _j("engine", "preemption", ("generated", "evictions",
                                "free_pages"), ("trace_id",)),
    _j("engine", "prefix_evict", ("pages", "free_pages",
                                  "engine_step")),
    _j("engine", "cow_copy_failure", ("error",), ("trace_id",)),
    _j("engine", "draft_failure", ("error", "engine_step")),
    _j("engine", "step_failure", ("error", "engine_step"),
       ("trace_ids", "waiting_trace_ids")),
    # -- engine two-tier KV plane
    _j("engine", "page_spill", ("page", "key_pages", "spilled_now",
                                "free_pages", "engine_step"),
       desc="cold trie page spilled device->host instead of freed "
            "(protocol: kv_page_spill)"),
    _j("engine", "page_restore", ("page", "key_pages", "spilled_now",
                                  "engine_step"),
       desc="spilled page restored host->device on a prefix match, "
            "before prefill was charged"),
    _j("engine", "spill_integrity", ("reason", "engine_step"),
       ("error", "page", "key_pages"),
       desc="spill entry dropped (crc_mismatch / read_failed / "
            "restore_write_failed) — degrades to a prefix miss, "
            "never restores a torn page"),
    _j("engine", "dequant_fallback", ("reason", "kv_quant"),
       desc="int8 KV requested but the fused dequant kernel is "
            "unsupported here; decode uses the exact-einsum path"),
    # -- fleet (router plane)
    _j("fleet", "join", ("replica", "endpoint")),
    _j("fleet", "rejoin", ("replica", "endpoint")),
    _j("fleet", "lease_lapse", ("replica",)),
    _j("fleet", "route", ("trace_id", "replica", "hop",
                          "affinity_pages", "prompt_len", "max_new"),
       desc="request placed on a replica (protocol: fleet_request)"),
    _j("fleet", "reroute", ("trace_id", "replica", "reason")),
    _j("fleet", "failover", ("trace_id", "victim", "hop", "why",
                             "streamed")),
    _j("fleet", "settle", ("trace_id", "replica", "hops", "tokens"),
       desc="exactly-once terminal of fleet_request"),
    _j("fleet", "reject", ("trace_id", "reason"), ("total_tokens",)),
    _j("fleet", "drain", ("replica", "settled")),
    _j("fleet", "undrain", ("replica",)),
    _j("fleet", "stale_view", ("error", "replicas", "max_stale_s")),
    _j("fleet", "stale_view_expired", ("stale_s", "dropped")),
    _j("fleet", "view_recovered", ("stale_s", "replicas")),
    # -- lockdep / obs / profile
    _j("lockdep", "inversion", (), (),
       desc="lock-order inversion with both stacks (fields are the "
            "witness's cycle payload)"),
    _j("obs", "selfcheck", ("probe",)),
    _j("profile", "window", ("dir",)),
    # -- protocol (ptproto runtime witness — obs/protocol.py)
    _j("protocol", "violation", ("protocol", "key", "reason"),
       ("chain", "record", "state"),
       desc="a declared machine saw an illegal record; chain is the "
            "offending record refs (domain/kind/seq)"),
    # -- serving (single-replica front)
    _j("serving", "hop", ("trace_id", "phase"),
       ("tokens", "streamed", "reason"),
       desc="replica-side stream lifecycle (protocol: serving_hop); "
            "phase in start|settle|torn|error"),
    _j("serving", "drain", ("action",)),
    _j("serving", "shed", ("reason",),
       ("trace_id", "where", "rows", "limit", "estimated_bytes",
        "budget", "queue_depth", "retry_after", "new_batch_limit")),
    _j("serving", "breaker", ("state",),
       ("probe_failed", "trips", "failure_rate")),
    # -- slo watchdog
    _j("slo", "breach", (), (),
       desc="burn-rate breach (payload is the watchdog's evidence)"),
    _j("slo", "step_regression", ("step_kind", "step_ms", "median_ms",
                                  "factor", "threshold", "streak",
                                  "phase")),
    # -- soak (loadgen)
    _j("soak", "run_start", ("seed", "duration_s", "workload",
                             "families", "chat_requests",
                             "ctr_requests")),
    _j("soak", "run_end", ("stopped_early",)),
    _j("soak", "request", ("workload", "trace_id", "outcome"),
       ("tokens", "ttft_ms", "tok_ms", "total_ms", "sched_lag_ms",
        "gather_ms", "score", "label")),
    _j("soak", "fault_injected", ("family", "action", "target",
                                  "at_s"),
       ("fired", "replica", "shard", "probe_trace", "rejoins",
        "killed_at", "routers", "outage_s", "spilled", "restored")),
    _j("soak", "replica_final", ("replica", "kv_pages_leaked",
                                 "active_slots", "kv_pages_used")),
    _j("soak", "online_step", ("batches", "samples", "loss")),
    _j("soak", "ctr_error", ("trace_id", "error")),
    # -- trainer (literal sites + FaultEvent/OOMEvent kinds)
    _j("trainer", "run_start", ("job", "config")),
    _j("trainer", "run_end", ("job",)),
    _j("trainer", "oom", ("microbatch", "accum_steps"),
       ("error", "batch_rows", "pass_id", "batch_id")),
    _j("trainer", "nonfinite", ("pass_id", "batch_id", "bad_streak"),
       ("restored_step",), dynamic=True),
    _j("trainer", "rollback", ("pass_id", "batch_id", "bad_streak"),
       ("restored_step",), dynamic=True),
    _j("trainer", "reshape", ("generation", "worker_id")),
    _j("trainer", "plan_adopted", ("provenance", "microbatch",
                                   "accum_steps")),
)

JOURNALS: Dict[Tuple[str, str], JournalKind] = {
    d.key: d for d in _JOURNAL_DECLS}


def journal_entry(domain: str, kind: str) -> Optional[JournalKind]:
    return JOURNALS.get((str(domain), str(kind)))


# --------------------------------------------------------------------- metrics
@dataclass(frozen=True)
class MetricFamilyDecl:
    """One fixed-name ``paddle_tpu_*`` family: its type and label
    set.  ``collector`` marks families produced by a scrape-time
    SampleFamily bridge rather than a REGISTRY.counter/gauge/histogram
    registration (labels ride on .add(), not on labelnames)."""
    name: str
    type: str                       # counter | gauge | histogram
    labels: Tuple[str, ...] = ()
    collector: bool = False
    description: str = ""


def _m(name, type_, labels=(), collector=False, desc=""):
    return MetricFamilyDecl(name, type_, tuple(labels), collector, desc)


_METRIC_DECLS = (
    # artifacts store gauges (artifacts/store.py)
    _m("paddle_tpu_artifacts_hits", "gauge"),
    _m("paddle_tpu_artifacts_misses", "gauge"),
    _m("paddle_tpu_artifacts_fallbacks", "gauge"),
    _m("paddle_tpu_artifacts_build_ms", "gauge"),
    # decode-engine prefix cache + speculation (serving/engine.py)
    _m("paddle_tpu_prefix_hit_pages", "counter"),
    _m("paddle_tpu_prefix_miss_pages", "counter"),
    _m("paddle_tpu_prefix_cow_copies", "counter"),
    _m("paddle_tpu_prefix_shared_pages", "gauge"),
    _m("paddle_tpu_spec_proposed_tokens_total", "counter"),
    _m("paddle_tpu_spec_accepted_tokens_total", "counter"),
    # two-tier KV plane (serving/engine.py + serving/spill.py)
    _m("paddle_tpu_kv_pages_spilled_total", "counter"),
    _m("paddle_tpu_kv_pages_restored_total", "counter"),
    _m("paddle_tpu_kv_spill_integrity_drops_total", "counter"),
    _m("paddle_tpu_kv_pages_spilled_now", "gauge"),
    # continuous profiler (obs/profile.py)
    _m("paddle_tpu_profile_step_ms", "gauge", ("kind",)),
    _m("paddle_tpu_profile_mfu", "gauge", ("kind",)),
    _m("paddle_tpu_profile_roofline_frac", "gauge", ("kind",)),
    _m("paddle_tpu_profile_phase_ms", "gauge", ("kind", "phase")),
    _m("paddle_tpu_profile_page_pool_occupancy", "gauge", ("pool",)),
    _m("paddle_tpu_profile_page_pool_occupancy_trend", "gauge",
       ("pool",)),
    _m("paddle_tpu_profile_device_bytes_in_use", "gauge"),
    _m("paddle_tpu_profile_hbm_watermark_bytes", "gauge"),
    # tracing (obs/trace.py)
    _m("paddle_tpu_trace_dropped_total", "counter"),
    # utils/stats scrape bridge (obs/metrics.py _stats_bridge)
    _m("paddle_tpu_counter_total", "counter", ("name",),
       collector=True),
    _m("paddle_tpu_timer_count", "counter", ("name",), collector=True),
    _m("paddle_tpu_timer_seconds_total", "counter", ("name",),
       collector=True),
    _m("paddle_tpu_timer_max_seconds", "gauge", ("name",),
       collector=True),
    # lockdep witness bridge (obs/metrics.py _lockdep_bridge)
    _m("paddle_tpu_lockdep_edges", "gauge", (), collector=True),
    _m("paddle_tpu_lockdep_inversions_total", "counter", (),
       collector=True),
    _m("paddle_tpu_lockdep_contentions_total", "counter", ("name",),
       collector=True),
    _m("paddle_tpu_lockdep_hold_time_ms", "gauge", ("name",),
       collector=True),
    _m("paddle_tpu_lockdep_acquisitions_total", "counter", ("name",),
       collector=True),
    # protocol witness bridge (obs/protocol.py)
    _m("paddle_tpu_protocol_tracked", "gauge", ("protocol",),
       collector=True, desc="machines currently open"),
    _m("paddle_tpu_protocol_completed", "gauge", ("protocol",),
       collector=True, desc="machines closed by a terminal"),
    _m("paddle_tpu_protocol_violations_total", "counter",
       ("protocol",), collector=True),
)

METRICS: Dict[str, MetricFamilyDecl] = {m.name: m for m in _METRIC_DECLS}

# Dynamic families: flattened from a stats() dict or formatted with a
# runtime key — declared as prefixes because their member names are
# not statically enumerable.  R12 requires every f-string registration
# head to match one of these, and docs tokens under a prefix are legal.
METRIC_PREFIXES: Dict[str, str] = {
    "paddle_tpu_serving_": "InferenceServer.stats() flattened "
                           "(serving/http.py prometheus_text)",
    "paddle_tpu_fleet_": "FleetRouter.stats() flattened "
                         "(fleet/obs.py)",
    "paddle_tpu_autopilot_": "Autoscaler.stats() flattened "
                             "(fleet/obs.py)",
    "paddle_tpu_coord_": "coordinator task-plane gauges "
                         "(trainer/coordinator.py)",
    "paddle_tpu_embed_shard_": "per-shard embed-service gauges "
                               "(embed/obs.py)",
    "paddle_tpu_embed_client_": "per-client embed gauges "
                                "(embed/obs.py)",
}


# ------------------------------------------------------------------- protocols
@dataclass(frozen=True)
class EventMatch:
    """Match one journal record: domain + kind, plus optional literal
    field constraints (``where``) — e.g. serving/hop phase=start."""
    domain: str
    kind: str
    where: Tuple[Tuple[str, object], ...] = ()

    def matches(self, rec: dict) -> bool:
        if rec.get("domain") != self.domain \
                or rec.get("kind") != self.kind:
            return False
        return all(rec.get(k) == v for k, v in self.where)


@dataclass(frozen=True)
class Terminal:
    match: EventMatch
    orphan_violates: bool = False


@dataclass(frozen=True)
class Protocol:
    """One correlation-keyed machine.  ``key`` is the record field
    carrying the correlation key (None = a single global machine).
    ``check_paths`` opts the protocol into ptlint R13's static
    exit-path proof — only meaningful where start and terminals are
    emitted by the same function (cross-process protocols are the
    runtime witness's job alone)."""
    name: str
    key: Optional[str]
    start: EventMatch
    intermediates: Tuple[EventMatch, ...] = ()
    terminals: Tuple[Terminal, ...] = ()
    check_paths: bool = False
    on_restart: str = "supersede"   # or "extend": re-start continues
    description: str = ""

    def terminal(self, kind: str) -> Terminal:
        for t in self.terminals:
            if t.match.kind == kind:
                return t
        raise KeyError(f"{self.name}: no terminal kind {kind!r}")

    def intermediate(self, kind: str) -> EventMatch:
        for m in self.intermediates:
            if m.kind == kind:
                return m
        raise KeyError(f"{self.name}: no intermediate kind {kind!r}")


_PROTOCOL_DECLS = (
    Protocol(
        "serving_hop", "trace_id",
        start=EventMatch("serving", "hop", (("phase", "start"),)),
        terminals=(
            Terminal(EventMatch("serving", "hop",
                                (("phase", "settle"),)), True),
            Terminal(EventMatch("serving", "hop",
                                (("phase", "torn"),)), True),
            Terminal(EventMatch("serving", "hop",
                                (("phase", "error"),)), True),
        ),
        check_paths=True,
        description="replica-side stream: every hop that starts "
                    "settles, tears, or errors — a start with no "
                    "terminal is a process lost mid-stream"),
    Protocol(
        "fleet_request", "trace_id",
        start=EventMatch("fleet", "route"),
        intermediates=(EventMatch("fleet", "failover"),
                       EventMatch("fleet", "reroute")),
        terminals=(
            Terminal(EventMatch("fleet", "settle"), True),
            Terminal(EventMatch("fleet", "reject"), False),
        ),
        check_paths=True,
        on_restart="extend",        # a post-failover re-route is the
        description="router-side request: route -> [failover|reroute]* "
                    "-> exactly-one settle (or a reject); a settle "
                    "for an unrouted/settled trace violates "
                    "exactly-once"),
    Protocol(
        "embed_shard_failover", "shard_id",
        start=EventMatch("embed", "shard_killed"),
        intermediates=(EventMatch("embed", "shard_replaced"),),
        terminals=(Terminal(EventMatch("embed", "restore"), False),),
        description="WAL exactly-once failover: a killed shard is "
                    "replaced and replays its WAL (append-before-ack "
                    "means no acked update is lost)"),
    Protocol(
        "artifacts_degrade", "name",
        start=EventMatch("artifacts", "fallback"),
        terminals=(
            Terminal(EventMatch("artifacts", "build"), False),
            Terminal(EventMatch("artifacts", "build_failed"), False),
            Terminal(EventMatch("artifacts", "load"), False),
        ),
        description="a fallback (stored artifact unusable) must be "
                    "followed by a backfill build / build_failed for "
                    "the same name — degrade is never silent"),
    Protocol(
        "fleet_lease", "replica",
        start=EventMatch("fleet", "lease_lapse"),
        terminals=(Terminal(EventMatch("fleet", "rejoin"), False),),
        description="a lapsed lease heals by rejoin (or the replica "
                    "stays dead — unterminated is legal, audited by "
                    "the soak verdict per injected fault)"),
    Protocol(
        "fleet_registry_view", None,
        start=EventMatch("fleet", "stale_view"),
        terminals=(
            Terminal(EventMatch("fleet", "view_recovered"), False),
            Terminal(EventMatch("fleet", "stale_view_expired"),
                     False),
        ),
        description="bounded-staleness registry outage: a stale view "
                    "either recovers or expires"),
    Protocol(
        "kv_page_spill", None,
        start=EventMatch("engine", "page_spill"),
        terminals=(
            Terminal(EventMatch("engine", "page_restore"), False),
            Terminal(EventMatch("engine", "spill_integrity"), False),
        ),
        description="two-tier KV lifecycle: a spilled page is later "
                    "restored or dropped with journaled integrity "
                    "evidence; still-spilled is legal (capacity "
                    "headroom, audited by page_accounting) — spill "
                    "and restore are emitted by different engine "
                    "paths, so this is runtime/verdict-only, not "
                    "check_paths"),
    Protocol(
        "autopilot_deploy", None,
        start=EventMatch("autopilot", "deploy_start"),
        intermediates=(
            EventMatch("autopilot", "deploy_step"),
            EventMatch("autopilot", "deploy_compile_budget_breach"),
        ),
        terminals=(
            Terminal(EventMatch("autopilot", "deploy_done"), False),
            Terminal(EventMatch("autopilot", "deploy_paused"), False),
        ),
        check_paths=True,
        description="a rolling deploy always lands on done or "
                    "paused-with-evidence, even through exceptions"),
)

PROTOCOLS: Dict[str, Protocol] = {p.name: p for p in _PROTOCOL_DECLS}


@dataclass(frozen=True)
class FaultChainSpec:
    """How the soak verdict maps one injected-fault family onto a
    protocol: which field of the ``soak/fault_injected`` record
    carries the machine's correlation key.  loadgen/verdict.py
    reconstructs the evidence chain from the referenced protocol's
    matchers — the same objects the runtime witness advances."""
    family: str
    protocol: str
    fault_key: Optional[str]        # field on the fault record


FAULT_FAMILIES: Dict[str, FaultChainSpec] = {
    "p": FaultChainSpec("p", "fleet_request", "probe_trace"),
    "o": FaultChainSpec("o", "embed_shard_failover", "shard"),
    "k": FaultChainSpec("k", "fleet_lease", "replica"),
    "q": FaultChainSpec("q", "fleet_registry_view", None),
    "s": FaultChainSpec("s", "kv_page_spill", None),
}


def protocol_for_start(rec_or_match) -> Optional[Protocol]:
    """The protocol whose start matcher matches ``rec_or_match`` (a
    journal record dict), or None."""
    for p in PROTOCOLS.values():
        if p.start.matches(rec_or_match):
            return p
    return None


# ------------------------------------------------------------------ CLI export
def catalog_as_dict() -> dict:
    """The whole contract as plain JSON-able data — ``paddle_tpu obs
    catalog`` dumps this for external scrapers and dashboards."""
    return {
        "v": 1,
        "journals": [
            {"domain": d.domain, "kind": d.kind,
             "required": list(d.required),
             "optional": list(d.optional),
             "dynamic": d.dynamic,
             "description": d.description}
            for d in sorted(JOURNALS.values(),
                            key=lambda d: d.key)],
        "metrics": [
            {"name": m.name, "type": m.type,
             "labels": list(m.labels), "collector": m.collector,
             "description": m.description}
            for m in sorted(METRICS.values(), key=lambda m: m.name)],
        "metric_prefixes": dict(sorted(METRIC_PREFIXES.items())),
        "protocols": [
            {"name": p.name, "key": p.key,
             "start": {"domain": p.start.domain, "kind": p.start.kind,
                       "where": dict(p.start.where)},
             "intermediates": [
                 {"domain": m.domain, "kind": m.kind,
                  "where": dict(m.where)} for m in p.intermediates],
             "terminals": [
                 {"domain": t.match.domain, "kind": t.match.kind,
                  "where": dict(t.match.where),
                  "orphan_violates": t.orphan_violates}
                 for t in p.terminals],
             "check_paths": p.check_paths,
             "description": p.description}
            for p in sorted(PROTOCOLS.values(),
                            key=lambda p: p.name)],
        "fault_families": {
            f: {"protocol": s.protocol, "fault_key": s.fault_key}
            for f, s in sorted(FAULT_FAMILIES.items())},
    }
