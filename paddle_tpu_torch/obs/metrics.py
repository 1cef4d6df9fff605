"""Metrics registry — the port of ``paddle_tpu/obs/metrics.py``: one
exposition path for the whole port.

A process-global registry of named counters / gauges / histograms
(with labels) rendered as Prometheus text exposition format 0.0.4,
scraped from the serving front (serving/http.py ``GET /metrics``).

Three sources feed one exposition:

- families registered directly on :data:`REGISTRY`
  (``counter()``/``gauge()``/``histogram()``);
- the ``utils/stats`` bridge collector: every ``global_counters`` name
  becomes a ``paddle_tpu_counter_total{name="..."}`` series and every
  ``global_stat`` timer a ``paddle_tpu_timer_seconds_*{name="..."}``
  family;
- per-scrape ``extra`` families: serving/http.py flattens
  ``InferenceServer.stats()`` through :func:`stats_families` into the
  ``paddle_tpu_serving_*`` names.

The family names are the JAX package's, so one scraper reads either
package's replicas. Thread-safe throughout.
"""

from __future__ import annotations

import math
import re
import threading

from paddle_tpu_torch.analysis.lockdep import named_lock
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "MetricFamily", "SampleFamily", "REGISTRY",
           "stats_families", "escape_label_value", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def escape_label_value(v) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(h: str) -> str:
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Histogram:
    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bs)
        self._counts = [0] * len(bs)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative per-bucket counts excluding +Inf, sum, count).
        Bucket counts are cumulative at record time (observe adds to
        every bucket >= v), so monotonicity holds by construction."""
        with self._lock:
            return list(self._counts), self._sum, self._count


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class MetricFamily:
    """One named metric with a fixed label schema and per-labelset
    children. With no ``labelnames`` the family IS its single child:
    ``fam.inc()`` / ``fam.set()`` / ``fam.observe()`` work directly."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {sorted(_KINDS)}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets if buckets is not None
                              else DEFAULT_BUCKETS)
        self._lock = named_lock("obs.metrics.family")
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return _Histogram(self._buckets)
        return _KINDS[self.kind]()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    # ----- label-less convenience (the family is its own child)
    def _default(self):
        return self.labels(**{})

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def value(self, **kv) -> float:
        return self.labels(**kv).value

    def reset(self) -> None:
        with self._lock:
            self._children.clear()

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """[(sample name, labels, value)] — histograms expand into
        ``_bucket{le=}`` / ``_sum`` / ``_count`` series."""
        with self._lock:
            children = dict(self._children)
        out: List[Tuple[str, Dict[str, str], float]] = []
        for key, child in sorted(children.items()):
            labels = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                counts, total, count = child.snapshot()
                for b, c in zip(child.buckets, counts):
                    out.append((f"{self.name}_bucket",
                                {**labels, "le": _fmt_value(b)}, c))
                out.append((f"{self.name}_bucket",
                            {**labels, "le": "+Inf"}, count))
                out.append((f"{self.name}_sum", labels, total))
                out.append((f"{self.name}_count", labels, count))
            else:
                out.append((self.name, labels, child.value))
        return out


class SampleFamily:
    """A pre-computed family (one scrape's worth of samples): the
    shape collectors and the stats()-flattening path produce."""

    def __init__(self, name: str, kind: str, help: str = "",
                 samples: Optional[List[Tuple[str, Dict[str, str],
                                              float]]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self._samples = list(samples or [])

    def add(self, labels: Dict[str, str], value: float,
            suffix: str = "") -> "SampleFamily":
        self._samples.append((self.name + suffix, labels, value))
        return self

    def samples(self):
        return list(self._samples)


class MetricsRegistry:
    """Process-global family registry + pluggable collectors.

    ``reset()`` clears every family's children (registrations and
    collectors survive: the shape is static, the values are not).
    """

    def __init__(self):
        self._lock = named_lock("obs.metrics.registry")
        self._families: Dict[str, MetricFamily] = {}
        self._collectors: List[Callable[[], Iterable]] = []

    # ------------------------------------------------------------ creation
    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, cannot re-register "
                        f"as {kind}{tuple(labelnames)}")
                return fam
            fam = MetricFamily(name, kind, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None
                  ) -> MetricFamily:
        return self._family(name, "histogram", help, labelnames, buckets)

    # ----------------------------------------------------------- collectors
    def register_collector(self, fn: Callable[[], Iterable]) -> None:
        """``fn()`` is called at scrape time and returns an iterable of
        family-like objects (``.name``/``.kind``/``.help``/
        ``.samples()``)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # ------------------------------------------------------------- scraping
    def collect(self, extra: Iterable = ()) -> List:
        with self._lock:
            fams = list(self._families.values())
            collectors = list(self._collectors)
        for c in collectors:
            fams.extend(c())
        fams.extend(extra)
        return sorted(fams, key=lambda f: f.name)

    def exposition(self, extra: Iterable = ()) -> str:
        """Prometheus text exposition 0.0.4. One HELP/TYPE pair per
        family name (first registration wins on a collision)."""
        out: List[str] = []
        seen: Dict[str, str] = {}
        for fam in self.collect(extra):
            if fam.name not in seen:
                seen[fam.name] = fam.kind
                if fam.help:
                    out.append(f"# HELP {fam.name} "
                               f"{_escape_help(fam.help)}")
                out.append(f"# TYPE {fam.name} {fam.kind}")
            for name, labels, value in fam.samples():
                out.append(f"{name}{_fmt_labels(labels)} "
                           f"{_fmt_value(value)}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Zero every family (keep registrations + collectors)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            fam.reset()

    def clear(self) -> None:
        """Drop families AND collectors (full teardown; rarely what a
        test wants — the stats bridge would be lost too)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()


#: the process-global registry every subsystem reports through
REGISTRY = MetricsRegistry()


# ----------------------------------------------------- stats() flattening
def stats_families(prefix: str, stats: dict,
                   counter_keys: Iterable[str] = ()) -> List[SampleFamily]:
    """Flatten a nested ``stats()`` dict into exposition families:
    leaf keys in ``counter_keys`` keep their cumulative (counter)
    semantics, every other numeric leaf is a gauge, nested dicts
    recurse with an underscored prefix, non-numeric leaves are
    skipped. The names (``paddle_tpu_serving_engine_finished``, ...)
    are the JAX package's: keep this flattening."""
    counter_keys = set(counter_keys)
    fams: List[SampleFamily] = []

    def walk(pfx: str, d: dict) -> None:
        for key in sorted(d):
            val = d[key]
            name = f"{pfx}_{key}"
            if isinstance(val, dict):
                walk(name, val)
                continue
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            kind = "counter" if key in counter_keys else "gauge"
            fams.append(SampleFamily(
                name, kind, f"{pfx} stats() field {key!r}",
                [(name, {}, float(val))]))

    walk(prefix, stats)
    return fams


# ------------------------------------------------------ utils/stats bridge
def _stats_bridge() -> List[SampleFamily]:
    """Scrape-time view of utils/stats: every domain that counts
    through ``global_counters`` / ``global_stat`` (the serving forward,
    the decode engine) is scrapeable without per-site plumbing."""
    from paddle_tpu_torch.utils.stats import global_counters, global_stat
    fams: List[SampleFamily] = []
    counters = global_counters.items()
    if counters:
        fams.append(SampleFamily(
            "paddle_tpu_counter_total", "counter",
            "utils.stats global_counters; the counter name "
            "(domain/what) rides in the 'name' label",
            [("paddle_tpu_counter_total", {"name": k}, float(v))
             for k, v in sorted(counters.items())]))
    timers = global_stat.items()
    if timers:
        count = SampleFamily(
            "paddle_tpu_timer_count", "counter",
            "utils.stats stat_timer scopes entered, per timer name")
        total = SampleFamily(
            "paddle_tpu_timer_seconds_total", "counter",
            "utils.stats stat_timer cumulative seconds, per timer name")
        mx = SampleFamily(
            "paddle_tpu_timer_max_seconds", "gauge",
            "utils.stats stat_timer worst single scope, per timer name")
        for k, item in sorted(timers.items()):
            c, t, m = item.snapshot()
            count.add({"name": k}, c)
            total.add({"name": k}, t)
            mx.add({"name": k}, m)
        fams.extend([count, total, mx])
    return fams


REGISTRY.register_collector(_stats_bridge)


def _lockdep_bridge() -> List[SampleFamily]:
    """Scrape-time view of the lock-order witness
    (analysis/lockdep.py): order-graph size, inversions, and per-name
    contention / hold-time telemetry. Imported lazily: lockdep is the
    module the obs plane builds its own locks from."""
    from paddle_tpu_torch.analysis.lockdep import LOCKDEP
    snap = LOCKDEP.metrics_snapshot()
    fams: List[SampleFamily] = [
        SampleFamily(
            "paddle_tpu_lockdep_edges", "gauge",
            "distinct acquisition-order edges in the lockdep graph",
            [("paddle_tpu_lockdep_edges", {}, float(snap["edges"]))]),
        SampleFamily(
            "paddle_tpu_lockdep_inversions_total", "counter",
            "lock-order inversions witnessed since reset",
            [("paddle_tpu_lockdep_inversions_total", {},
              float(snap["inversions"]))]),
    ]
    if snap["contentions"]:
        fams.append(SampleFamily(
            "paddle_tpu_lockdep_contentions_total", "counter",
            "acquires that found the named lock already held",
            [("paddle_tpu_lockdep_contentions_total", {"name": k},
              float(v))
             for k, v in sorted(snap["contentions"].items())]))
    if snap["hold_ms"]:
        fams.append(SampleFamily(
            "paddle_tpu_lockdep_hold_time_ms", "gauge",
            "cumulative milliseconds the named lock was held",
            [("paddle_tpu_lockdep_hold_time_ms", {"name": k}, float(v))
             for k, v in sorted(snap["hold_ms"].items())]))
    if snap["acquisitions"]:
        fams.append(SampleFamily(
            "paddle_tpu_lockdep_acquisitions_total", "counter",
            "acquisitions of the named lock since reset",
            [("paddle_tpu_lockdep_acquisitions_total", {"name": k},
              float(v))
             for k, v in sorted(snap["acquisitions"].items())]))
    return fams


REGISTRY.register_collector(_lockdep_bridge)
