"""SLO watchdog — the port of ``paddle_tpu/obs/slo.py``: declarative
objectives + step-regression detection with per-phase attribution.

Two complementary detectors share one watchdog:

- **Objectives** (``Objective``): declarative bounds over rolling
  windows of stats-derived metrics — step-time p99, TTFT, tokens/s,
  shed rate, anything a registered source's ``stats()`` dict exposes.
  When the out-of-bound fraction of the window (the *burn rate*)
  crosses ``burn_threshold``, the watchdog journals an ``slo/breach``
  record. Sources are polled by ``evaluate()`` — driven off-thread by
  the profiler's ``pt-obs-profiler`` sampler (obs/profile.py), or
  inline.
- **Step regression / stall**: every observed step's wall time is
  compared to the rolling median of *healthy* samples;
  ``> regression_factor x median`` for ``regression_steps``
  consecutive steps journals ``slo/step_regression`` — carrying the
  *attributed phase*, the per-phase breakdown entry that grew most
  over its own rolling median — and auto-dumps a flight bundle whose
  reason names that phase.

Anomalous samples are NOT folded into the rolling medians, so a
sustained stall is measured against the pre-stall baseline. Breach
emission is cooled down per detector key. Everything here is
advisory: the watchdog never raises into a hot path and never
throttles the workload itself. Breach listeners subscribe with
:meth:`SLOWatchdog.add_breach_listener`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from statistics import median
from typing import Callable, Dict, List, Optional

__all__ = ["Objective", "parse_objective", "SLOWatchdog", "WATCHDOG"]


@dataclass(frozen=True)
class Objective:
    """One declarative service-level objective.

    ``metric`` names a key in some registered source's stats dict
    (e.g. ``ttft_p50_ms``, ``p99_ms``, ``shed_rate``,
    ``tokens_per_s``). ``kind`` is the healthy direction: ``upper``
    means values must stay <= target (latencies, shed rate),
    ``lower`` means >= target (throughput)."""
    name: str
    metric: str
    target: float
    kind: str = "upper"          # upper: v <= target | lower: v >= target
    window: int = 32             # rolling samples per evaluation window
    burn_threshold: float = 0.5  # out-of-bound fraction that breaches

    def violated(self, value: float) -> bool:
        if self.kind == "lower":
            return value < self.target
        return value > self.target


def parse_objective(spec: str) -> Objective:
    """``"metric<=target"`` / ``"metric>=target"`` (CLI ``--slo``),
    optionally ``@window`` — e.g. ``ttft_p50_ms<=50`` or
    ``tokens_per_s>=100@64``."""
    window = 32
    body = spec.strip()
    if "@" in body:
        body, w = body.rsplit("@", 1)
        window = max(2, int(w))
    for op, kind in (("<=", "upper"), (">=", "lower")):
        if op in body:
            metric, target = body.split(op, 1)
            metric = metric.strip()
            return Objective(name=metric, metric=metric,
                             target=float(target), kind=kind,
                             window=window)
    raise ValueError(f"objective spec {spec!r}: expected "
                     f"'metric<=target' or 'metric>=target'")


class SLOWatchdog:
    """Process-global watchdog (module doc). Thread-safe; journal and
    flight-dump calls happen outside the internal lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._objectives: List[Objective] = []
        self._sources: Dict[str, Callable[[], Optional[dict]]] = {}
        self._windows: Dict[str, deque] = {}
        self._regression_factor = 3.0
        self._regression_steps = 3
        self._median_window = 64
        self._min_samples = 8
        self._cooldown_s = 30.0
        self._step_hist: Dict[str, deque] = {}
        self._phase_hist: Dict[str, Dict[str, deque]] = {}
        self._last_phases: Dict[str, Dict[str, float]] = {}
        self._streak: Dict[str, int] = {}
        self._last_breach_t: Dict[str, float] = {}
        self._breaches = 0
        self._listeners: List[Callable[[dict], None]] = []

    # ------------------------------------------------------------ config
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def breaches(self) -> int:
        with self._lock:
            return self._breaches

    def configure(self, objectives: Optional[List[Objective]] = None,
                  regression_factor: Optional[float] = None,
                  regression_steps: Optional[int] = None,
                  median_window: Optional[int] = None,
                  min_samples: Optional[int] = None,
                  cooldown_s: Optional[float] = None,
                  enabled: bool = True) -> None:
        with self._lock:
            if objectives is not None:
                self._objectives = list(objectives)
                self._windows.clear()
            if regression_factor is not None:
                self._regression_factor = float(regression_factor)
            if regression_steps is not None:
                self._regression_steps = max(1, int(regression_steps))
            if median_window is not None:
                self._median_window = max(4, int(median_window))
            if min_samples is not None:
                self._min_samples = max(2, int(min_samples))
            if cooldown_s is not None:
                self._cooldown_s = max(0.0, float(cooldown_s))
            self._enabled = bool(enabled)

    def add_source(self, name: str,
                   fn: Callable[[], Optional[dict]]) -> None:
        """``fn()`` returns a flat-ish stats dict (or None once its
        owner is gone — the source is then dropped). The engine,
        server, and profiler each register one."""
        with self._lock:
            self._sources[name] = fn

    def add_breach_listener(self,
                            fn: Callable[[dict], None]) -> None:
        """Subscribe to breach records — ``fn(record)`` is called for
        every ``slo/breach`` and ``slo/step_regression`` the watchdog
        emits, from the emitting thread, OUTSIDE the watchdog lock and
        after the journal record; a raising listener is isolated (the
        watchdog never lets a subscriber break detection)."""
        with self._lock:
            self._listeners.append(fn)

    def remove_breach_listener(self,
                               fn: Callable[[dict], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _notify(self, record: dict) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(dict(record))
            except Exception:  # noqa: BLE001 — advisory subscribers
                pass           # must never break breach detection

    # --------------------------------------------------- step regression
    def observe_step(self, kind: str, dt_ms: float,
                     phases: Optional[Dict[str, float]] = None) -> None:
        """One observed step of wall time ``dt_ms``; ``phases`` is the
        profiler's latest per-phase ms breakdown when this step was
        sampled (None in between — the last seen one attributes)."""
        if not self._enabled:
            return
        breach = None
        with self._lock:
            hist = self._step_hist.setdefault(
                kind, deque(maxlen=self._median_window))
            med = median(hist) if len(hist) >= self._min_samples else None
            if phases:
                self._last_phases[kind] = dict(phases)
            anomalous = med is not None \
                and dt_ms > self._regression_factor * med
            if anomalous:
                self._streak[kind] = self._streak.get(kind, 0) + 1
                if self._streak[kind] >= self._regression_steps:
                    self._streak[kind] = 0
                    key = f"step_regression/{kind}"
                    if self._cooled_locked(key):
                        phase = self._attribute_locked(kind)
                        self._breaches += 1
                        breach = {"kind_": kind,
                                  "step_ms": round(dt_ms, 3),
                                  "median_ms": round(med, 3),
                                  "factor": round(dt_ms / med, 2),
                                  "threshold": self._regression_factor,
                                  "streak": self._regression_steps,
                                  "phase": phase}
            else:
                self._streak[kind] = 0
                hist.append(dt_ms)
                if phases:
                    ph_hist = self._phase_hist.setdefault(kind, {})
                    for p, v in phases.items():
                        ph_hist.setdefault(
                            p, deque(maxlen=self._median_window)
                        ).append(v)
        if breach is not None:
            from paddle_tpu_torch.obs.events import emit
            from paddle_tpu_torch.obs.flight import FLIGHT
            emit("slo", "step_regression", step_kind=breach["kind_"],
                 step_ms=breach["step_ms"],
                 median_ms=breach["median_ms"],
                 factor=breach["factor"], threshold=breach["threshold"],
                 streak=breach["streak"], phase=breach["phase"])
            FLIGHT.maybe_autodump(
                f"slo_step_regression_{breach['phase']}")
            self._notify({"detector": "step_regression", **breach})

    def _attribute_locked(self, kind: str) -> str:
        """The phase whose latest sampled value grew the most over its
        own healthy median — 'which phase ate the regression'."""
        latest = self._last_phases.get(kind) or {}
        hists = self._phase_hist.get(kind) or {}
        best_phase, best_growth = None, 0.0
        for phase, val in latest.items():
            h = hists.get(phase)
            base = median(h) if h else 0.0
            growth = val - base
            if growth > best_growth:
                best_phase, best_growth = phase, growth
        return best_phase or "unattributed"

    def _cooled_locked(self, key: str) -> bool:
        now = time.monotonic()
        last = self._last_breach_t.get(key)
        if last is not None and now - last < self._cooldown_s:
            return False
        self._last_breach_t[key] = now
        return True

    # ------------------------------------------------------- objectives
    def evaluate(self) -> List[dict]:
        """Poll every source, fold metric values into the per-objective
        rolling windows, and journal ``slo/breach`` for any objective
        whose burn rate crossed its threshold. Returns the breach
        records emitted (for tests/CLI)."""
        if not self._enabled:
            return []
        with self._lock:
            sources = list(self._sources.items())
            objectives = list(self._objectives)
        if not objectives:
            return []
        stats: Dict[str, float] = {}
        dead: List[str] = []
        for name, fn in sources:
            try:
                s = fn()
            except Exception:  # noqa: BLE001 — a dying source is dropped
                s = None
            if s is None:
                dead.append(name)
                continue
            for k, v in s.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                stats.setdefault(k, float(v))
        if dead:
            with self._lock:
                for name in dead:
                    self._sources.pop(name, None)
        breaches: List[dict] = []
        for obj in objectives:
            if obj.metric not in stats:
                continue
            value = stats[obj.metric]
            with self._lock:
                w = self._windows.setdefault(
                    obj.name, deque(maxlen=obj.window))
                w.append(value)
                if len(w) < max(2, obj.window // 2):
                    continue
                burn = sum(1 for x in w if obj.violated(x)) / len(w)
                if burn < obj.burn_threshold:
                    continue
                if not self._cooled_locked(f"breach/{obj.name}"):
                    continue
                self._breaches += 1
            breaches.append({
                "objective": obj.name, "metric": obj.metric,
                "value": round(value, 4), "target": obj.target,
                "bound": obj.kind, "burn_rate": round(burn, 3),
                "window": len(w)})
        if breaches:
            from paddle_tpu_torch.obs.events import emit
            from paddle_tpu_torch.obs.flight import FLIGHT
            for b in breaches:
                emit("slo", "breach", **b)
                FLIGHT.maybe_autodump(f"slo_breach_{b['objective']}")
                self._notify({"detector": "objective", **b})
        return breaches

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self._enabled,
                "objectives": [asdict(o) for o in self._objectives],
                "sources": sorted(self._sources),
                "breaches": self._breaches,
                "regression": {
                    "factor": self._regression_factor,
                    "steps": self._regression_steps,
                    "median_window": self._median_window,
                    "min_samples": self._min_samples,
                },
            }

    def reset(self) -> None:
        """Back to the initial state (obs.reset_all)."""
        with self._lock:
            self._enabled = False
            self._objectives = []
            self._sources.clear()
            self._windows.clear()
            self._regression_factor = 3.0
            self._regression_steps = 3
            self._median_window = 64
            self._min_samples = 8
            self._cooldown_s = 30.0
            self._step_hist.clear()
            self._phase_hist.clear()
            self._last_phases.clear()
            self._streak.clear()
            self._last_breach_t.clear()
            self._breaches = 0
            self._listeners.clear()


#: the process-global watchdog (profiler-driven; CLI --slo wires it)
WATCHDOG = SLOWatchdog()
