"""Trace context — the port of ``paddle_tpu/obs/context.py``: the
correlation IDs that turn per-process telemetry into an end-to-end
story.

- **run_id** — one id per training/serving run, process-global. Set it
  explicitly (CLI ``--run_id``), or it is generated lazily on first use
  (``PADDLE_TPU_RUN_ID`` overrides) so every journal record of a
  process shares one.
- **host** — ``socket.gethostname()``, overridable via the
  ``PADDLE_TPU_HOST`` env var or :func:`set_host`.
- **trace_id** — one id per serving request, minted at the HTTP front
  (or on ``submit()`` when a caller bypasses it) and carried through
  admission, queue wait, the engine slot, every decode step and the
  settle or shed. ``bind(trace_id=...)`` scopes it to the current
  thread; cross-thread hops (the serving worker pool, the engine loop)
  carry it on the request object and re-bind.
- **step** — the trainer's global step, stamped via :func:`set_step`.

``current_fields()`` is what the journal (obs/events.py), the tracer
(obs/trace.py) and the flight recorder (obs/flight.py) merge into
their records. Host-side bookkeeping only.
"""

from __future__ import annotations

import os
import socket
import threading
import uuid
from typing import Dict, Optional

__all__ = ["TraceContext", "bind", "current", "current_fields",
           "new_trace_id", "ensure_run_id", "get_run_id", "set_run_id",
           "get_host", "set_host", "set_step", "reset"]


class TraceContext:
    """One immutable-ish frame of correlation IDs. ``bind()`` pushes a
    derived frame onto the calling thread's stack; fields that are
    ``None`` fall through to the process scope (run_id/host)."""

    __slots__ = ("trace_id", "span_id", "step", "extra")

    def __init__(self, trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 step: Optional[int] = None, **extra):
        self.trace_id = trace_id
        self.span_id = span_id
        self.step = step
        self.extra = extra

    @property
    def run_id(self) -> str:
        return ensure_run_id()

    @property
    def host(self) -> str:
        return get_host()

    def fields(self) -> Dict[str, object]:
        out: Dict[str, object] = {"run_id": self.run_id,
                                  "host": self.host}
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.span_id is not None:
            out["span_id"] = self.span_id
        if self.step is not None:
            out["step"] = self.step
        out.update(self.extra)
        return out

    def __repr__(self):
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"step={self.step!r})")


# ----------------------------------------------------------- process scope
_lock = threading.Lock()
_run_id: Optional[str] = None
_host: Optional[str] = None
_tls = threading.local()


def new_trace_id() -> str:
    """A fresh 16-hex-char request id (collision-safe at serving
    scale; short enough to grep a journal by hand)."""
    return uuid.uuid4().hex[:16]


def set_run_id(run_id: Optional[str]) -> None:
    global _run_id
    with _lock:
        _run_id = run_id


def get_run_id() -> Optional[str]:
    with _lock:
        return _run_id


def ensure_run_id() -> str:
    """The process run_id, generated once on first use so every record
    a process emits shares one id even when nobody set it."""
    global _run_id
    with _lock:
        if _run_id is None:
            _run_id = os.environ.get("PADDLE_TPU_RUN_ID") \
                or "run-" + uuid.uuid4().hex[:12]
        return _run_id


def set_host(host: Optional[str]) -> None:
    global _host
    with _lock:
        _host = host


def get_host() -> str:
    global _host
    with _lock:
        if _host is None:
            _host = os.environ.get("PADDLE_TPU_HOST") \
                or socket.gethostname()
        return _host


# ------------------------------------------------------------ thread scope
def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = [TraceContext()]
        _tls.stack = st
    return st


def current() -> TraceContext:
    """The calling thread's innermost context (every thread has a
    default frame carrying just the process run_id/host)."""
    return _stack()[-1]


def current_fields() -> Dict[str, object]:
    """What the journal/tracer/flight-recorder stamp onto a record."""
    return current().fields()


class _Bound:
    __slots__ = ("_ctx",)

    def __init__(self, ctx: TraceContext):
        self._ctx = ctx

    def __enter__(self) -> TraceContext:
        _stack().append(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        st = _stack()
        if len(st) > 1 and st[-1] is self._ctx:
            st.pop()
        return False


def bind(trace_id: Optional[str] = None, span_id: Optional[str] = None,
         step: Optional[int] = None, **extra) -> _Bound:
    """Context manager: push a derived context for the current thread.
    ``None`` fields inherit from the innermost frame, so nesting
    ``bind(step=3)`` inside ``bind(trace_id=t)`` keeps the trace_id."""
    cur = current()
    ctx = TraceContext(
        trace_id=trace_id if trace_id is not None else cur.trace_id,
        span_id=span_id if span_id is not None else cur.span_id,
        step=step if step is not None else cur.step,
        **{**cur.extra, **extra})
    return _Bound(ctx)


def set_step(step: Optional[int]) -> None:
    """Stamp the trainer's global step on the calling thread's current
    frame — a one-liner per iteration instead of re-indenting the whole
    step body under a ``with`` (trainer/trainer.py's loop)."""
    current().step = step


def reset() -> None:
    """Between-tests hygiene (obs.reset_all): drop the process run_id /
    host override and the calling thread's bind stack."""
    set_run_id(None)
    set_host(None)
    _tls.stack = [TraceContext()]
