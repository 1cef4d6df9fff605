"""paddle_tpu_torch.obs — the port's observability layer
(``paddle_tpu/obs/``): one place the serving plane reports through.

- :mod:`paddle_tpu_torch.obs.metrics` — thread-safe metrics registry
  (counters / gauges / histograms with labels) with ONE Prometheus
  text exposition path; absorbs ``utils/stats`` and the serving
  ``stats()`` plumbing.
- :mod:`paddle_tpu_torch.obs.events` — versioned-schema structured
  event journal (JSONL file + in-memory ring): sheds, breaker flips,
  drains, preemptions, step failures — every record stamped with
  run_id/host and, when bound, trace_id/step.
- :mod:`paddle_tpu_torch.obs.context` — the correlation-ID plane:
  per-run ``run_id``, per-request ``trace_id`` (minted at the HTTP
  front), per-iteration ``step``.
- :mod:`paddle_tpu_torch.obs.trace` — host-side step tracing (bounded
  span rings) with Chrome trace export.
- :mod:`paddle_tpu_torch.obs.flight` — the always-on flight recorder:
  a bounded ring of recent spans + events, auto-dumped as a postmortem
  bundle on breaker-open, step failure, SIGTERM and on demand.
- :mod:`paddle_tpu_torch.obs.profile` — continuous step profiler
  (per-phase breakdown, live MFU/roofline gauges, device-memory
  telemetry on the ``pt-obs-profiler`` thread, ``torch.profiler``
  windows).
- :mod:`paddle_tpu_torch.obs.slo` — SLO watchdog: declarative
  objectives over rolling windows + step-regression detection.
- :mod:`paddle_tpu_torch.obs.merge` — cross-process fusion of N
  journals + chrome traces into one timeline (``cli.py trace merge``).
- :mod:`paddle_tpu_torch.obs.httpd` — standalone /metrics + /events +
  /flight + /profile + /health endpoint for trainer and coordinator
  processes (``cli.py train --metrics_port``).
- :mod:`paddle_tpu_torch.obs.catalog` — the declared contract: journal
  kinds, metric families, protocol machines (``cli.py obs catalog``).
- :mod:`paddle_tpu_torch.obs.protocol` — the protocol witness, armed at
  import on the journal's observer seam: a record that breaks a
  declared machine journals ``protocol/violation`` (a flight auto-dump
  trigger).
"""

from paddle_tpu_torch.obs import context  # noqa: F401
from paddle_tpu_torch.obs.context import (bind, current_fields,  # noqa: F401
                                          new_trace_id)
from paddle_tpu_torch.obs.events import (JOURNAL, EventJournal,  # noqa: F401
                                         emit, emit_event,
                                         journal_segments, read_journal,
                                         tail, validate)
from paddle_tpu_torch.obs.flight import FLIGHT, FlightRecorder  # noqa: F401
from paddle_tpu_torch.obs.httpd import (build_obs_http_server,  # noqa: F401
                                        start_obs_server)
from paddle_tpu_torch.obs.metrics import (REGISTRY,  # noqa: F401
                                          MetricsRegistry, stats_families)
from paddle_tpu_torch.obs.profile import PROFILER, StepProfiler  # noqa: F401
from paddle_tpu_torch.obs.protocol import (WITNESS,  # noqa: F401
                                           ProtocolWitness)
from paddle_tpu_torch.obs.slo import (WATCHDOG, Objective,  # noqa: F401
                                      SLOWatchdog, parse_objective)
from paddle_tpu_torch.obs.trace import TRACER, Tracer, span  # noqa: F401

__all__ = [
    "REGISTRY", "MetricsRegistry", "stats_families",
    "JOURNAL", "EventJournal", "emit", "emit_event", "tail",
    "read_journal", "journal_segments", "validate",
    "TRACER", "Tracer", "span",
    "FLIGHT", "FlightRecorder",
    "PROFILER", "StepProfiler",
    "WITNESS", "ProtocolWitness",
    "WATCHDOG", "SLOWatchdog", "Objective", "parse_objective",
    "context", "bind", "current_fields", "new_trace_id",
    "build_obs_http_server", "start_obs_server",
    "reset_all",
]

# the flight recorder mirrors every journal record into its ring and
# auto-dumps on the trigger kinds — wired once at import so any entry
# point into the obs package arms it
JOURNAL.add_observer(FLIGHT.observe_journal)

# the protocol witness rides the same observer seam: every record
# advances the catalog-declared machines, and a violation's own
# protocol/violation emission is a flight auto-dump trigger
JOURNAL.add_observer(WITNESS.observe_journal)
from paddle_tpu_torch.obs.protocol import _install_collector as \
    _install_protocol_collector  # noqa: E402

_install_protocol_collector()


def reset_all() -> None:
    """Zero every observability surface (registry values, journal ring
    + sink, tracer, flight recorder, profiler, watchdog, trace context,
    utils/stats counters/timers, the lock-order graph, the protocol
    witness)."""
    from paddle_tpu_torch.analysis.lockdep import LOCKDEP
    from paddle_tpu_torch.utils.stats import global_counters, global_stat
    REGISTRY.reset()
    JOURNAL.reset()
    TRACER.reset()
    FLIGHT.reset()
    PROFILER.reset()
    WATCHDOG.reset()
    context.reset()
    global_counters.reset()
    global_stat.reset()
    LOCKDEP.reset()
    WITNESS.reset()
