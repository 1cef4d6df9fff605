"""Scoped wall-clock stat timers — the port of
``paddle_tpu/utils/stats.py`` (paddle/utils/Stat.h: ``REGISTER_TIMER``
scopes aggregated into ``globalStat``).

A process-global registry of named timers with count/total/max/min, a
``stat_timer(name)`` context manager, named event counters and
``print_all_status()`` — plus a ``torch.profiler.record_function``
range per scope, so the same scopes show up in a ``torch.profiler``
trace (obs/profile.py's deep windows), and a span on the host tracer
(obs/trace.py).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from paddle_tpu_torch.analysis.lockdep import named_lock


class StatItem:
    # add() is a read-modify-write reached concurrently from the
    # pt-serve worker pool (serving/forward): the per-item lock keeps
    # count/total consistent under contention
    __slots__ = ("count", "total", "max", "min", "_lock")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")
        self._lock = named_lock("stats.item")

    def add(self, dt: float):
        with self._lock:
            self.count += 1
            self.total += dt
            self.max = max(self.max, dt)
            self.min = min(self.min, dt)

    def snapshot(self):
        """(count, total, max) read atomically: the obs metrics bridge
        scrapes this (obs/metrics.py)."""
        with self._lock:
            return self.count, self.total, self.max

    def __str__(self):
        avg = self.total / self.count if self.count else 0.0
        return (f"count={self.count} total={self.total * 1e3:.2f}ms "
                f"avg={avg * 1e3:.3f}ms max={self.max * 1e3:.3f}ms "
                f"min={(self.min if self.count else 0.0) * 1e3:.3f}ms")


class StatSet:
    def __init__(self):
        self._lock = named_lock("stats.statset")
        self._stats: Dict[str, StatItem] = {}
        self.enabled = True

    def get(self, name: str) -> StatItem:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = StatItem()
            return self._stats[name]

    def reset(self):
        with self._lock:
            self._stats.clear()

    def items(self):
        with self._lock:
            return dict(self._stats)

    def print_all_status(self):
        for name, item in sorted(self.items().items()):
            print(f"Stat={name:<30} {item}")


class CounterSet:
    """Process-global named event counters (the counter half of Stat.h's
    globalStat). Timers measure durations; counters count occurrences
    (the serving forward's OOM sheds, the decode engine's settles and
    preemptions), so a test can diff exact counts around a run."""

    def __init__(self):
        self._lock = named_lock("stats.counters")
        self._counts: Dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> int:
        with self._lock:
            v = self._counts.get(name, 0) + n
            self._counts[name] = v
            return v

    def value(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def reset(self):
        with self._lock:
            self._counts.clear()

    def items(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def print_all_status(self):
        for name, v in sorted(self.items().items()):
            print(f"Counter={name:<30} {v}")


global_stat = StatSet()
global_counters = CounterSet()


_TRACER = None


def _tracer():
    """Lazy obs.trace handle (import-cycle-free: obs imports this
    module; the first stat_timer call happens long after both are
    loaded)."""
    global _TRACER
    if _TRACER is None:
        from paddle_tpu_torch.obs.trace import TRACER
        _TRACER = TRACER
    return _TRACER


@contextlib.contextmanager
def stat_timer(name: str):
    """REGISTER_TIMER parity; also a ``torch.profiler.record_function``
    range and — while a host trace or the flight recorder wants spans
    (obs/trace.py) — a span, so every timed scope (serving/forward,
    serving/decode_step) lands in both traces for free."""
    if not global_stat.enabled:
        yield
        return
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        with _tracer().span(name):
            yield
    global_stat.get(name).add(time.perf_counter() - t0)


def timed(name: str):
    def deco(fn):
        def wrapper(*a, **kw):
            with stat_timer(name):
                return fn(*a, **kw)
        return wrapper
    return deco
