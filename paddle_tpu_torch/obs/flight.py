"""Flight recorder — the port of ``paddle_tpu/obs/flight.py``: an
always-on bounded ring of recent spans and events, dumped as a
postmortem bundle when something dies.

The step tracer (obs/trace.py) is a *window* tool: you arm it, capture,
export. A production incident never arms anything — the fault fires
first. This is the black box that is always writing: a fixed-size ring
(``capacity`` small dicts; one dict build and deque append a record)
fed by

- every ``stat_timer``/``Tracer.span`` scope (obs/trace.py pushes a
  compact span record here even when no trace window is armed),
- every journal record (obs/events.py observer — sheds, breaker flips,
  preemptions, step failures land in the ring automatically),
- explicit :func:`record` calls on hot-path seams (the decode engine's
  per-slot step records, serving/engine.py, keep a request's "each
  decode step" chain reconstructable by trace_id).

``dump()`` writes the postmortem bundle: the ring, a metrics-registry
snapshot, the journal's last seq + recent tail, and every registered
live-state provider (queued requests, the engine's slots). Auto-dump
fires on journal trigger kinds (engine step_failure, breaker open,
a lock-order inversion), on a fatal uncaught exception
(``install_excepthook``), and on SIGTERM or ``POST /admin/quit``
(cli.py); ``GET /flight`` serves a bundle on demand. Rate-limited per
reason so an event storm produces one bundle, not a disk full.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.utils.logging import get_logger

__all__ = ["FlightRecorder", "FLIGHT", "record", "install_excepthook",
           "BUNDLE_VERSION", "AUTO_DUMP_TRIGGERS"]

BUNDLE_VERSION = 1

#: (domain, kind) journal records that auto-dump a bundle. ``serving/
#: breaker`` additionally requires state == "open" (closing a breaker
#: is a recovery, not an incident).
AUTO_DUMP_TRIGGERS = {
    ("trainer", "nonfinite"),   # FaultEvent streak live
    ("trainer", "rollback"),    # streak hit the policy limit
    ("trainer", "oom"),
    ("engine", "step_failure"),
    ("serving", "breaker"),
    ("lockdep", "inversion"),   # would-be deadlock witnessed
    ("protocol", "violation"),  # declared machine broken
}


class FlightRecorder:
    """See module doc. Thread-safe; every mutator takes the one lock,
    and ``dump()`` only reads snapshots."""

    def __init__(self, capacity: int = 4096,
                 min_dump_interval: float = 30.0):
        self._lock = named_lock("obs.flight")
        self._ring: deque = deque(maxlen=int(capacity))
        self.enabled = True
        self._dump_dir: Optional[str] = None
        self._min_dump_interval = float(min_dump_interval)
        # rate limit is PER REASON: an SLO-breach dump must not be
        # suppressed because an unrelated breaker-open dumped seconds
        # ago — each distinct reason gets its own interval clock
        self._last_dump_t: Dict[str, float] = {}
        self._providers: Dict[str, Callable[[], Optional[dict]]] = {}
        self._dumps = 0
        self._dump_errors = 0

    # ------------------------------------------------------------ config
    def configure(self, dump_dir: Optional[str] = None,
                  capacity: Optional[int] = None,
                  enabled: Optional[bool] = None,
                  min_dump_interval: Optional[float] = None) -> None:
        """``dump_dir`` arms auto-dump (None leaves it as-is; auto-dump
        is off until a dir is configured — manual ``dump()`` always
        works). ``capacity`` resizes the ring (contents kept, newest
        last)."""
        with self._lock:
            if dump_dir is not None:
                os.makedirs(dump_dir, exist_ok=True)
                self._dump_dir = dump_dir
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=int(capacity))
            if enabled is not None:
                self.enabled = bool(enabled)
            if min_dump_interval is not None:
                self._min_dump_interval = float(min_dump_interval)

    @property
    def dump_dir(self) -> Optional[str]:
        with self._lock:
            return self._dump_dir

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    # ---------------------------------------------------------- recording
    def record(self, kind: str, name: str, **fields) -> None:
        """One ring record; ``kind`` groups it (span | event | mark |
        the caller's own vocabulary). Context IDs (trace_id, step) are
        stamped from the calling thread unless passed explicitly."""
        if not self.enabled:
            return
        ctx = obs_context.current()
        rec = {"t": time.time(), "kind": str(kind), "name": str(name)}
        if ctx.trace_id is not None and "trace_id" not in fields:
            rec["trace_id"] = ctx.trace_id
        if ctx.step is not None and "step" not in fields:
            rec["step"] = ctx.step
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)

    def record_raw(self, rec: dict) -> None:
        """Append a pre-built record (the tracer's compact span shape,
        the journal observer's event records) without re-stamping."""
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # ------------------------------------------------------- live state
    def register_state_provider(
            self, name: str,
            fn: Callable[[], Optional[dict]]) -> None:
        """``fn()`` is called at dump time and returns a JSON-able dict
        of live state (active requests, slot table, queue depths) or
        None to be skipped (dead weakref). A provider must never
        raise into a dump — failures are recorded in the bundle."""
        with self._lock:
            self._providers[name] = fn

    def unregister_state_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # --------------------------------------------------------------- dump
    def bundle(self, reason: str = "manual") -> dict:
        """The postmortem bundle: ring, metrics snapshot, journal
        cursor + tail, live state."""
        from paddle_tpu_torch.obs.events import JOURNAL
        from paddle_tpu_torch.obs.metrics import REGISTRY
        with self._lock:
            providers = dict(self._providers)
        state: Dict[str, object] = {}
        for name, fn in sorted(providers.items()):
            try:
                st = fn()
            # a dump must survive any one sick subsystem: the point of
            # the bundle is the OTHER evidence
            except Exception as e:  # noqa: BLE001
                st = {"error": repr(e)[:200]}
            if st is not None:
                state[name] = st
        try:
            metrics_text = REGISTRY.exposition()
        except Exception as e:  # noqa: BLE001 — same survival contract
            metrics_text = f"# metrics scrape failed: {e!r}"
        return {
            "v": BUNDLE_VERSION,
            "reason": str(reason),
            "ts": time.time(),
            "run_id": obs_context.ensure_run_id(),
            "host": obs_context.get_host(),
            "pid": os.getpid(),
            "ring": self.snapshot(),
            "metrics": metrics_text,
            "journal": {"last_seq": JOURNAL.last_seq,
                        "path": JOURNAL.path,
                        "tail": JOURNAL.tail(200)},
            "state": state,
        }

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> str:
        """Write one bundle. With no ``path``: the configured dump_dir,
        else the system temp dir (an unconfigured process can still be
        asked for a postmortem)."""
        b = self.bundle(reason)
        if path is None:
            with self._lock:
                base = self._dump_dir or tempfile.gettempdir()
                n = self._dumps
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in str(reason))[:40]
            path = os.path.join(
                base, f"flight-{os.getpid()}-{n:03d}-{safe}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(b, f)
        with self._lock:
            self._dumps += 1
            self._last_dump_t[str(reason)] = time.monotonic()
        return path

    def maybe_autodump(self, reason: str) -> Optional[str]:
        """Rate-limited dump into the configured dump_dir; a no-op
        (returns None) when auto-dump is unarmed, the recorder is off,
        or a bundle was written for this SAME ``reason`` within
        ``min_dump_interval`` (distinct reasons never suppress each
        other — a storm of one incident kind produces one bundle
        without hiding a different concurrent incident). Never raises
        — the recorder must not take down the path that triggered
        it."""
        with self._lock:
            if not self.enabled or self._dump_dir is None:
                return None
            last = self._last_dump_t.get(str(reason))
            if last is not None and \
                    time.monotonic() - last < self._min_dump_interval:
                return None
        try:
            path = self.dump(reason)
        except Exception as e:  # noqa: BLE001 — survival contract
            with self._lock:
                self._dump_errors += 1
                first = self._dump_errors == 1
            if first:
                get_logger().warning(
                    "flight recorder auto-dump failed (%r); further "
                    "failures counted silently", e)
            return None
        get_logger().warning("flight recorder: dumped postmortem "
                             "bundle to %s (reason=%s)", path, reason)
        return path

    # ------------------------------------------------------- journal hook
    def observe_journal(self, rec: dict) -> None:
        """obs/events.py observer: mirror every journal record into the
        ring and auto-dump on the trigger kinds."""
        if not self.enabled:
            return
        compact = {"t": rec.get("ts"), "kind": "event",
                   "name": f"{rec.get('domain')}/{rec.get('kind')}"}
        for k in ("trace_id", "step", "seq"):
            if k in rec:
                compact[k] = rec[k]
        # carry the small diagnostic fields; big blobs stay in the
        # journal (the bundle includes its tail anyway)
        for k, v in rec.items():
            if k in compact or k in ("v", "ts", "pid", "domain",
                                     "kind", "run_id", "host"):
                continue
            if isinstance(v, (bool, int, float)) or \
                    (isinstance(v, str) and len(v) <= 200):
                compact[k] = v
            elif isinstance(v, (list, tuple)) and len(v) <= 64 and \
                    all(isinstance(x, (bool, int, float, str))
                        for x in v):
                # short scalar lists (a step_failure's trace_ids) are
                # exactly what chain reconstruction needs
                compact[k] = list(v)
        self.record_raw(compact)
        key = (rec.get("domain"), rec.get("kind"))
        if key in AUTO_DUMP_TRIGGERS:
            if key == ("serving", "breaker") and \
                    rec.get("state") != "open":
                return
            self.maybe_autodump(f"{key[0]}_{rec.get('kind')}")

    def reset(self) -> None:
        """Clear the ring, the providers (they hold closures over
        their owners), the dump dir and rate-limit state (obs.reset_all);
        the recorder stays enabled (it is always-on by contract)."""
        with self._lock:
            self._ring.clear()
            self._providers.clear()
            self._dump_dir = None
            self._last_dump_t.clear()
            self._dumps = 0
            self._dump_errors = 0
            self.enabled = True


#: the process-global recorder (always on; obs/__init__.py wires it as
#: a journal observer and obs/trace.py feeds it spans)
FLIGHT = FlightRecorder()


def record(kind: str, name: str, **fields) -> None:
    FLIGHT.record(kind, name, **fields)


_prev_excepthook = None


def install_excepthook() -> None:
    """Dump a postmortem bundle on a fatal uncaught exception, then
    defer to the previous hook. Idempotent."""
    import sys
    global _prev_excepthook
    if _prev_excepthook is not None:
        return
    _prev_excepthook = sys.excepthook

    def hook(exc_type, exc, tb):
        FLIGHT.record("mark", "fatal_exception",
                      error=repr(exc)[:400])
        FLIGHT.maybe_autodump("fatal_exception")
        _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = hook
