"""InferenceServer — the engine-backed generation front of the port
(``paddle_tpu/serving/server.py``).

This slice ports the generate path: ``submit_generate`` /
``generate`` route a request into the continuous-batching decode
engine (serving/engine.py), whose wait queue is BOUNDED (a full queue
rejects at once with a retry-after hint — ``Rejected``, reason
``queue_full``) and whose admission is by free KV pages; per-request
DEADLINES settle late requests with ``Expired``; ``shutdown`` drains;
``health()`` / ``stats()`` give snapshots. The ``/infer`` artifact
path (merged-model forward workers, circuit breaker, memory-pressure
shedding) waits for a later slice.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional


_LATENCY_WINDOW = 256          # latencies kept for the percentiles


def percentile(vals: List[float], q: float) -> float:
    """Nearest-rank ``q`` quantile of ``vals`` (0.0 when empty)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


class ServingError(RuntimeError):
    """Base of every typed serving failure."""


class Rejected(ServingError):
    """Shed at admission. ``retry_after`` (seconds) is the client hint;
    ``reason`` is 'queue_full' or 'kv_capacity'."""

    def __init__(self, msg: str, retry_after: float, reason: str):
        super().__init__(msg)
        self.retry_after = float(retry_after)
        self.reason = reason


class Expired(ServingError):
    """The request's deadline passed (queued too long, or generation
    ran past it)."""


class ServerClosed(ServingError):
    """Submitted to a draining or stopped server."""


class InferenceServer:
    """Generation serving facade over a ``DecodeEngine``.

    ``default_deadline`` (seconds) applies when a request passes none.
    ``start()`` runs the engine's loop thread; ``shutdown()`` stops
    admission and drains (or, with ``drain=False``, settles everything
    in flight with ``ServerClosed``)."""

    def __init__(self, engine, *,
                 default_deadline: Optional[float] = None):
        if engine is None:
            raise ServingError(
                "this slice of the port serves generation only: "
                "construct the server with a DecodeEngine")
        self.engine = engine
        self.default_deadline = default_deadline
        self._lock = threading.Lock()
        self._running = False
        self._started_at: Optional[float] = None
        self._latencies: List[float] = []
        self._counters = {"served": 0, "rejected_full": 0,
                          "rejected_capacity": 0, "expired": 0,
                          "failed": 0, "closed": 0}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceServer":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._started_at = time.monotonic()
        self.engine.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop accepting. With ``drain`` the admitted requests
        complete first; without it they fail with ServerClosed."""
        self.engine.shutdown(drain=drain, timeout=timeout)
        with self._lock:
            self._running = False

    # --------------------------------------------------------- generation
    def submit_generate(self, prompt, max_new_tokens: int, *,
                        eos_id: Optional[int] = None,
                        deadline: Optional[float] = None,
                        trace_id: Optional[str] = None):
        """Admit one generation request into the decode engine.
        Raises ``Rejected`` (``queue_full`` / ``kv_capacity``) or
        ``ServerClosed`` at admission; returns the engine's future-like
        GenRequest (``.get()`` / ``.cancel()``)."""
        if deadline is None:
            deadline = self.default_deadline
        try:
            return self.engine.submit(prompt, max_new_tokens,
                                      eos_id=eos_id, deadline=deadline,
                                      trace_id=trace_id)
        except Rejected as e:
            key = "rejected_full" if e.reason == "queue_full" \
                else "rejected_capacity"
            with self._lock:
                self._counters[key] += 1
            raise
        except ServerClosed:
            with self._lock:
                self._counters["closed"] += 1
            raise

    def generate(self, prompt, max_new_tokens: int, *,
                 eos_id: Optional[int] = None,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None) -> List[int]:
        """Synchronous submit_generate + wait -> generated token ids."""
        t0 = time.perf_counter()
        req = self.submit_generate(prompt, max_new_tokens, eos_id=eos_id,
                                   deadline=deadline, trace_id=trace_id)
        return self.wait(req, t0)

    def wait(self, req, t0: float) -> List[int]:
        """Wait for ``req`` (submitted at ``time.perf_counter()`` t0)
        and count its outcome."""
        try:
            toks = req.get()
        except Expired:
            with self._lock:
                self._counters["expired"] += 1
            raise
        except ServerClosed:
            with self._lock:
                self._counters["closed"] += 1
            raise
        except ServingError:
            with self._lock:
                self._counters["failed"] += 1
            raise
        with self._lock:
            self._counters["served"] += 1
            self._latencies.append(time.perf_counter() - t0)
            del self._latencies[:-_LATENCY_WINDOW]
        return toks

    # ------------------------------------------------------------ snapshots
    def health(self) -> dict:
        with self._lock:
            running = self._running
        est = self.engine.stats()
        accepting = running and self.engine.accepting
        status = "ok" if accepting else ("draining" if running
                                         else "stopped")
        return {"status": status, "accepting": accepting,
                "queue_depth": est["waiting"],
                "active_slots": est["active_slots"]}

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            lats = list(self._latencies)
            uptime = (time.monotonic() - self._started_at) \
                if self._started_at is not None else 0.0
        out.update({
            "p50_ms": round(percentile(lats, 0.50) * 1e3, 3),
            "p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
            "uptime_s": round(uptime, 3),
            "engine": self.engine.stats(),
        })
        return out
