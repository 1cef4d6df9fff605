"""Sliding-window failure-rate circuit breaker for the serving path —
the port of ``paddle_tpu/serving/breaker.py``.

When the model itself is sick (poisoned weights, a hung device, an
artifact that faults every forward), queue backpressure is the wrong
tool: every admitted request burns a worker slot on a doomed forward.
The breaker watches the outcome of the last ``window`` forwards and,
when the failure fraction crosses ``failure_threshold`` (with at least
``min_requests`` observed), OPENS: every request is shed instantly with
a retry-after hint. After ``cooldown`` seconds it HALF-OPENS and admits
``half_open_probes`` probe requests; all probes succeeding CLOSES the
breaker (window cleared), any probe failing re-opens it for another
cooldown. Deterministic under test via the injectable ``clock``;
every state flip is journaled (``serving/breaker``), after the
breaker's lock is released (``_journal``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Tuple

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs.events import emit as journal_emit

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, window: int = 64, failure_threshold: float = 0.5,
                 min_requests: int = 8, cooldown: float = 2.0,
                 half_open_probes: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        if not (0.0 < failure_threshold <= 1.0):
            raise ValueError("failure_threshold must be in (0, 1]")
        self.window = int(window)
        self.failure_threshold = float(failure_threshold)
        self.min_requests = max(1, int(min_requests))
        self.cooldown = float(cooldown)
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = named_lock("serving.breaker")
        self._outcomes: deque = deque(maxlen=self.window)  # True = ok
        self._state = CLOSED
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_successes = 0
        self.trips = 0              # total closed->open transitions

    @property
    def state(self) -> str:
        with self._lock:
            flips = self._maybe_half_open()
            state = self._state
        self._journal(flips)
        return state

    def _maybe_half_open(self) -> list:
        """Open -> half-open once the cooldown passed; returns the flip
        records to journal (the caller journals them after releasing
        the lock)."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown:
            self._state = HALF_OPEN
            self._probes_in_flight = 0
            self._probe_successes = 0
            return [{"state": HALF_OPEN}]
        return []

    @staticmethod
    def _journal(flips) -> None:
        """Journal state flips OUTSIDE the breaker lock: an open flip
        auto-dumps a flight bundle whose providers take the server's
        lock, which ``InferenceServer.submit`` holds while it asks the
        breaker — journaling under the lock would order the two locks
        both ways."""
        for rec in flips:
            journal_emit("serving", "breaker", **rec)

    def allow(self) -> Tuple[bool, float]:
        """(admit?, retry_after_seconds). retry_after is 0 when admitted
        and the remaining cooldown (or a probe-slot wait) when shed."""
        with self._lock:
            flips = self._maybe_half_open()
            if self._state == CLOSED:
                out = True, 0.0
            elif self._state == OPEN:
                remaining = self.cooldown - (self._clock() -
                                             self._opened_at)
                out = False, max(remaining, 0.0)
            elif self._probes_in_flight < self.half_open_probes:
                # HALF_OPEN: admit only the probe budget
                self._probes_in_flight += 1
                out = True, 0.0
            else:
                out = False, max(self.cooldown / 4.0, 0.01)
        self._journal(flips)
        return out

    def record(self, ok: bool) -> None:
        """Outcome of an admitted request's forward."""
        with self._lock:
            flips = self._record_locked(bool(ok))
        self._journal(flips)

    def _record_locked(self, ok: bool) -> list:
        if self._state == HALF_OPEN:
            self._probes_in_flight = max(0, self._probes_in_flight - 1)
            if not ok:
                self._state = OPEN
                self._opened_at = self._clock()
                return [{"state": OPEN, "probe_failed": True}]
            self._probe_successes += 1
            if self._probe_successes >= self.half_open_probes:
                self._state = CLOSED
                self._outcomes.clear()
                return [{"state": CLOSED}]
            return []
        if self._state == OPEN:
            return []           # stragglers admitted before the trip
        self._outcomes.append(ok)
        if len(self._outcomes) < self.min_requests:
            return []
        failures = self._outcomes.count(False)
        if failures / len(self._outcomes) >= self.failure_threshold:
            self._state = OPEN
            self._opened_at = self._clock()
            self.trips += 1
            return [{"state": OPEN, "trips": self.trips,
                     "failure_rate": failures / len(self._outcomes)}]
        return []

    def snapshot(self) -> dict:
        with self._lock:
            flips = self._maybe_half_open()
            n = len(self._outcomes)
            failures = self._outcomes.count(False)
            out = {
                "state": self._state,
                "window": n,
                "failure_rate": (failures / n) if n else 0.0,
                "trips": self.trips,
                "cooldown": self.cooldown,
            }
        self._journal(flips)
        return out
