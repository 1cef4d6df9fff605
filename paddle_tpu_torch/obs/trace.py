"""Step tracing — the port of ``paddle_tpu/obs/trace.py``: nested
host-side spans exportable as Chrome trace JSON, with correlation IDs
stamped.

``torch.profiler`` shows the device timeline (obs/profile.py's deep
windows); what it cannot show is the HOST schedule a decode engine or
a serving front lives or dies by — where a request waits, how long a
forward holds its worker. This tracer records exactly that:

- ``span(name)`` context managers build a per-thread stack (spans know
  their parent), recording wall-clock start/duration;
- every ``utils.stats.stat_timer`` scope automatically becomes a span
  while a trace is active — ``serving/forward`` and
  ``serving/decode_step`` show up with zero per-site wiring;
- every span carries the calling thread's bound ``trace_id`` / ``step``
  (obs/context.py), and the chrome export stamps ``run_id``/``host``/
  ``pid`` metadata;
- ``chrome_trace()`` / ``save(path)`` emit the ``traceEvents`` JSON
  chrome://tracing and Perfetto load directly.

The JAX package also records XLA compiles as instant events (its
``start(capture_compiles=True)`` turns on ``jax_log_compiles``). Eager
PyTorch compiles nothing per shape, so the port records no compile
instants: ``capture_compiles`` is accepted and does nothing.

Memory is BOUNDED: spans/instants live in rings of ``max_spans`` /
``max_instants`` and overflow increments the
``paddle_tpu_trace_dropped_total`` counter on the metrics registry.

Two capture modes compose: the explicit trace WINDOW
(``start()``/``stop()``) fills the exportable span ring, and the
always-on FLIGHT feed — when the flight recorder (obs/flight.py) is
enabled, as it is by default, every closed span also lands as a
compact record in its postmortem ring.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.metrics import REGISTRY

__all__ = ["Tracer", "TRACER", "span", "instant"]

#: default span-ring bound — generous (a 1 ms/step trainer fills it in
#: ~a minute of tracing) but FIXED: trace memory can't run away
DEFAULT_MAX_SPANS = 65536

_DROPPED = REGISTRY.counter(
    "paddle_tpu_trace_dropped_total",
    "spans/instants dropped by the tracer's bounded ring "
    "(obs/trace.py max_spans)")


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._tracer._push(self.name)
        return self

    def __exit__(self, *exc):
        self._tracer._pop(self.name, self._t0,
                          time.perf_counter(), self.args)
        return False


class Tracer:
    """See module doc. start()/stop() bound a trace window; span() and
    instant() still feed the flight recorder outside one."""

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS,
                 max_instants: int = 8192):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.enabled = False
        self._spans: deque = deque(maxlen=int(max_spans))
        self._instants: deque = deque(maxlen=int(max_instants))
        self.dropped = 0
        self._flight = None           # lazy obs.flight.FLIGHT handle
        # wall-clock anchor for perf_counter timestamps: exported ts
        # become unix-epoch microseconds, so two hosts' traces share a
        # time base (modulo clock skew)
        self._epoch_wall = time.time()
        self._epoch_pc = time.perf_counter()

    def _flight_recorder(self):
        f = self._flight
        if f is None:
            from paddle_tpu_torch.obs.flight import FLIGHT
            self._flight = f = FLIGHT
        return f

    def configure(self, max_spans: Optional[int] = None,
                  max_instants: Optional[int] = None) -> None:
        """Resize the rings (contents kept, newest last)."""
        with self._lock:
            if max_spans is not None:
                self._spans = deque(self._spans, maxlen=int(max_spans))
            if max_instants is not None:
                self._instants = deque(self._instants,
                                       maxlen=int(max_instants))

    # ------------------------------------------------------------ lifecycle
    def start(self, capture_compiles: bool = True) -> "Tracer":
        """Open a trace window. ``capture_compiles`` is accepted for
        the JAX package's signature and records nothing (module doc)."""
        with self._lock:
            if self.enabled:
                return self
            self._spans.clear()
            self._instants.clear()
            self._epoch_wall = time.time()
            self._epoch_pc = time.perf_counter()
            self.enabled = True
        return self

    def stop(self) -> "Tracer":
        with self._lock:
            self.enabled = False
        return self

    def reset(self) -> None:
        self.stop()
        with self._lock:
            self._spans.clear()
            self._instants.clear()
            self.dropped = 0
        self._flight = None

    # ------------------------------------------------------------ recording
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _push(self, name: str) -> None:
        self._stack().append(name)

    def _ring_append(self, ring: deque, rec: dict) -> None:
        # deque(maxlen) drops silently; count it so the loss is visible
        # as paddle_tpu_trace_dropped_total
        if ring.maxlen is not None and len(ring) == ring.maxlen:
            self.dropped += 1
            _DROPPED.inc()
        ring.append(rec)

    def _pop(self, name: str, t0: float, t1: float, args: dict) -> None:
        st = self._stack()
        if st and st[-1] == name:
            st.pop()
        parent = st[-1] if st else None
        ctx = obs_context.current()
        rec = {"name": name, "t0": t0, "t1": t1, "parent": parent,
               "tid": threading.get_ident(),
               "thread": threading.current_thread().name}
        if ctx.trace_id is not None:
            rec["trace_id"] = ctx.trace_id
        if ctx.step is not None:
            rec["step"] = ctx.step
        if args:
            rec["args"] = args
        with self._lock:
            if self.enabled:
                self._ring_append(self._spans, rec)
        flight = self._flight_recorder()
        if flight.enabled:
            frec = {"t": time.time() - (t1 - t0), "kind": "span",
                    "name": name, "dur_s": t1 - t0,
                    "thread": rec["thread"]}
            if ctx.trace_id is not None:
                frec["trace_id"] = ctx.trace_id
            if ctx.step is not None:
                frec["step"] = ctx.step
            flight.record_raw(frec)

    def span(self, name: str, **args):
        """Context manager; a shared no-op object when neither a trace
        window nor the flight recorder wants spans (the hot-path cost
        of a fully-off tracer is this one check)."""
        if not self.enabled and not self._flight_recorder().enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, args)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        st = self._stack()
        ctx = obs_context.current()
        rec = {"name": name, "t": time.perf_counter(),
               "parent": st[-1] if st else None,
               "tid": threading.get_ident(),
               "thread": threading.current_thread().name}
        if ctx.trace_id is not None:
            rec["trace_id"] = ctx.trace_id
        if ctx.step is not None:
            rec["step"] = ctx.step
        if args:
            rec["args"] = args
        with self._lock:
            if self.enabled:
                self._ring_append(self._instants, rec)

    # -------------------------------------------------------------- export
    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def instants(self) -> List[dict]:
        with self._lock:
            return list(self._instants)

    def chrome_trace(self) -> Dict[str, object]:
        """The chrome://tracing / Perfetto ``traceEvents`` format:
        complete events (ph "X") for spans, instants (ph "i"),
        microsecond timestamps, plus process metadata
        (``run_id``/``host``/``pid``) keying a cross-process merge."""
        pid = os.getpid()
        host = obs_context.get_host()
        run_id = obs_context.ensure_run_id()
        with self._lock:
            wall0, pc0 = self._epoch_wall, self._epoch_pc

        def wall_us(t_pc: float) -> float:
            return (wall0 + (t_pc - pc0)) * 1e6

        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": f"{host} pid={pid}"}}]
        timed: List[dict] = []
        for s in self.spans():
            ev = {"ph": "X", "name": s["name"], "pid": pid,
                  "tid": s["tid"], "ts": wall_us(s["t0"]),
                  "dur": (s["t1"] - s["t0"]) * 1e6,
                  "args": {**s.get("args", {}),
                           "parent": s["parent"],
                           "thread": s["thread"]}}
            for k in ("trace_id", "step"):
                if k in s:
                    ev["args"][k] = s[k]
            timed.append(ev)
        for i in self.instants():
            ev = {"ph": "i", "s": "t", "name": i["name"],
                  "pid": pid, "tid": i["tid"],
                  "ts": wall_us(i["t"]),
                  "args": {**i.get("args", {}),
                           "parent": i["parent"]}}
            for k in ("trace_id", "step"):
                if k in i:
                    ev["args"][k] = i[k]
            timed.append(ev)
        timed.sort(key=lambda e: e["ts"])
        events.extend(timed)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "metadata": {"run_id": run_id, "host": host,
                             "pid": pid,
                             "dropped": self.dropped}}

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
        return path


#: the process-global tracer utils.stats.stat_timer reports through
TRACER = Tracer()


def span(name: str, **args):
    return TRACER.span(name, **args)


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)
