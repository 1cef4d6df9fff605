"""Continuous step profiler + device-memory telemetry — the port of
``paddle_tpu/obs/profile.py``.

Three always-cheap surfaces answer "where is the time and memory going
RIGHT NOW" in a live run:

- **Continuous profiler** — the decode engine calls
  ``PROFILER.on_step(kind)`` once per step (a no-op attribute read
  when disabled). Every ``sample_every``-th step the profiler diffs
  the ``stat_timer`` accumulators into a per-phase breakdown (decode:
  decode_step; train: data_wait / h2d / compute / settle), pulls
  FLOPs (and, where the source gives them, bytes) from a lazily
  invoked cost source, and exports live ``paddle_tpu_profile_mfu`` /
  ``paddle_tpu_profile_roofline_frac`` gauges. The JAX package reads
  its costs from XLA's cost analysis of the compiled step; eager
  PyTorch has no compiled step, so :func:`cost_of` counts one call
  under ``torch.utils.flop_counter.FlopCounterMode``.
- **Device-memory telemetry** — a ``pt-obs-profiler`` daemon thread
  samples ``torch.cuda.memory_stats`` (the caching allocator's live
  bytes and its peak) and ``torch.cuda.mem_get_info`` (the card's
  used and total bytes), plus registered page-pool accounting
  (occupancy level + trend), off the hot path, and drives the SLO
  watchdog's objective evaluation (obs/slo.py).
- **Deep windows** — ``arm_window(steps)`` captures a
  ``torch.profiler.profile`` window over the next N observed steps
  (``GET /profile?deep_steps=N`` on the serving front) and writes its
  Chrome trace (``trace.json``) into the window's directory. The
  directory rides in the profiler's flight-bundle state.

Peaks are an H100's, looked up by the name ``nvidia-smi`` gives the
card (``PEAK_FLOPS``, ``PEAK_HBM_GBPS``), by the step's dtype: bf16
steps against the tensor cores' dense bf16 rate, float32 steps
against the float32 rate outside the tensor cores (TF32's when
``torch.backends.cuda.matmul.allow_tf32`` is set). A live MFU, or a
roofline share (bound / measured, ``1 / roofline_frac``), above 1.0
is a bug: a FLOP count or a peak is wrong.

Every sampled step is also fed to ``obs.slo.WATCHDOG`` so step-time
regressions are detected with per-phase attribution. The profiler is
OFF by default; ``enable()`` is wired by the CLI
(``serve --profile_every``). ``reset()`` (via ``obs.reset_all``) stops
the sampler thread.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from statistics import median
from typing import Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs.metrics import REGISTRY

__all__ = [
    "PEAK_FLOPS", "PEAK_HBM_GBPS", "device_lookup", "device_peak_flops",
    "device_hbm_gbps", "cost_of", "roofline",
    "StepProfiler", "PROFILER",
]


# --------------------------------------------------------------- roofline
# Dense peak FLOP/s of one card by dtype, by a substring of its name as
# nvidia-smi (and torch.cuda.get_device_name) gives it: NVIDIA's data
# sheets, dense rates without sparsity, at the full power limit.
PEAK_FLOPS = [
    ("h100 80gb hbm3", {"bfloat16": 989e12, "tf32": 494.7e12,
                        "float32": 67e12}),          # SXM
    ("h100 sxm", {"bfloat16": 989e12, "tf32": 494.7e12,
                  "float32": 67e12}),
    ("h100 nvl", {"bfloat16": 835e12, "tf32": 417.5e12,
                  "float32": 60e12}),
    ("h100 pcie", {"bfloat16": 756e12, "tf32": 378e12,
                   "float32": 51e12}),
]

# Peak HBM GB/s by the same name substrings.
PEAK_HBM_GBPS = [
    ("h100 80gb hbm3", 3350.0),
    ("h100 sxm", 3350.0),
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
]


def _device_name(dev) -> str:
    if isinstance(dev, str) and not dev.startswith(("cuda", "cpu")):
        return dev
    import torch
    d = torch.device(dev) if dev is not None else None
    if d is not None and d.type != "cuda":
        return ""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(d)


def device_lookup(dev, table):
    """The row of ``table`` for device ``dev`` (a torch device, a
    device string, or a card name), or None off an H100."""
    name = _device_name(dev).lower()
    for key, val in table:
        if key in name:
            return val
    return None


def _rate_key(dtype: str) -> str:
    if dtype == "bfloat16":
        return "bfloat16"
    import torch
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "float32"


def device_peak_flops(dev, dtype: str = "float32") -> Optional[float]:
    row = device_lookup(dev, PEAK_FLOPS)
    return None if row is None else row[_rate_key(dtype)]


def device_hbm_gbps(dev) -> Optional[float]:
    return device_lookup(dev, PEAK_HBM_GBPS)


def cost_of(fn, *args, **kwargs) -> Tuple[Optional[float], Optional[float]]:
    """(flops, bytes) of one call of ``fn`` at concrete args: the FLOPs
    ``torch.utils.flop_counter.FlopCounterMode`` counts (the matmuls,
    convolutions and attention calls PyTorch knows; a custom kernel
    counts nothing, so the count is a lower bound), and no byte count
    (eager PyTorch has no compiled step to read one from; the roofline
    then binds on the FLOPs). This RUNS the call — invoke it once per
    cost source, never per step."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    flops = float(fc.get_total_flops())
    return (flops if flops > 0 else None), None


def roofline(ms: float, flops: Optional[float] = None,
             bytes_acc: Optional[float] = None,
             peak_flops: Optional[float] = None,
             hbm_gbps: Optional[float] = None,
             mxu: bool = True) -> dict:
    """A step cannot beat its memory traffic at peak bandwidth NOR its
    FLOPs at the peak rate, so the BINDING bound (max of the two) is a
    hard floor; ``roofline_frac`` = measured / binding bound (>= 1) and
    ``mfu`` = achieved FLOP/s over peak (<= 1). ``mxu`` False drops the
    FLOP bound (the JAX package's switch for a step off the matrix
    units); the port passes True."""
    out: dict = {}
    if not ms or ms <= 0:
        return out
    if flops and peak_flops:
        out["mfu"] = flops / (ms * 1e-3) / peak_flops
    bounds = {}
    if bytes_acc and hbm_gbps:
        bounds["hbm"] = bytes_acc / (hbm_gbps * 1e9) * 1e3
    if flops and peak_flops and mxu:
        bounds["mxu"] = flops / peak_flops * 1e3
    if bounds:
        binding = max(bounds, key=bounds.get)
        out["roofline_ms"] = bounds[binding]
        out["roofline_bound"] = binding
        out["roofline_frac"] = ms / bounds[binding]
    return out


# ------------------------------------------------------------- gauges
# Registered at import so the families (HELP/TYPE) are always present in
# the exposition; REGISTRY.reset() zeroes values but keeps registrations.
# Names and HELP texts are the JAX package's, word for word: one scraper
# reads either package's replicas, and the expositions compare equal.
_G_STEP = REGISTRY.gauge(
    "paddle_tpu_profile_step_ms",
    "continuous profiler: mean wall ms/step over the last sample window,"
    " per step kind (train/decode)", ("kind",))
_G_PHASE = REGISTRY.gauge(
    "paddle_tpu_profile_phase_ms",
    "continuous profiler: per-phase ms/step from stat_timer deltas "
    "(train: data_wait/h2d/compute/settle; decode: decode_step)",
    ("kind", "phase"))
_G_MFU = REGISTRY.gauge(
    "paddle_tpu_profile_mfu",
    "live model-FLOPs utilization: cost_analysis flops / step wall time "
    "/ device peak — same computation as bench.py rows", ("kind",))
_G_ROOF = REGISTRY.gauge(
    "paddle_tpu_profile_roofline_frac",
    "live measured-ms / binding roofline bound (hbm vs mxu), same "
    "computation as bench.py rows", ("kind",))
_G_MEM = REGISTRY.gauge(
    "paddle_tpu_profile_device_bytes_in_use",
    "live device memory in use, summed over local devices "
    "(device.memory_stats; 0 where the backend reports none)")
_G_WATERMARK = REGISTRY.gauge(
    "paddle_tpu_profile_hbm_watermark_bytes",
    "high-water device memory: max(peak_bytes_in_use, observed "
    "bytes_in_use) since enable/reset")
_G_POOL = REGISTRY.gauge(
    "paddle_tpu_profile_page_pool_occupancy",
    "KV page-pool occupancy fraction (allocated / total_usable), per "
    "registered pool", ("pool",))
_G_POOL_TREND = REGISTRY.gauge(
    "paddle_tpu_profile_page_pool_occupancy_trend",
    "KV page-pool occupancy slope in fraction/second over the sampler's "
    "rolling window (positive = filling up)", ("pool",))


#: phase name -> stat_timer name, per step kind (the JAX package's
#: names: "compute" is the step's scope, data_wait/h2d run in the feed
#: pipeline, settle is the one device->host sync).
PHASE_TIMERS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "train": (("data_wait", "train/data_wait"),
              ("h2d", "train/h2d"),
              ("compute", "train_step"),
              ("settle", "train/settle")),
    "decode": (("decode_step", "serving/decode_step"),),
}


class _KindState:
    __slots__ = ("steps", "t_last", "dt_sum", "dt_n", "baseline",
                 "phase_ms", "step_ms", "last_sample_step")

    def __init__(self):
        self.steps = 0
        self.t_last: Optional[float] = None
        self.dt_sum = 0.0           # wall ms accumulated since last sample
        self.dt_n = 0
        self.baseline: Dict[str, float] = {}   # timer name -> total seconds
        self.phase_ms: Dict[str, float] = {}   # latest per-phase ms/step
        self.step_ms: deque = deque(maxlen=256)
        self.last_sample_step = 0


class StepProfiler:
    """Process-global continuous profiler (module doc). All public
    methods are thread-safe; ``on_step`` is the per-step hot hook and
    returns after one attribute read when disabled."""

    def __init__(self):
        self._lock = named_lock("obs.profile")
        self._enabled = False
        self._sample_every = 8
        self._kinds: Dict[str, _KindState] = {}
        # cost sources: kind -> zero-arg callable returning
        # (flops, bytes); invoked lazily ONCE per enable (it runs a
        # step under the FLOP counter).
        self._cost_src: Dict[str, Callable[[], tuple]] = {}
        self._cost: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
        self._cost_failed: Dict[str, bool] = {}
        # CPU escape hatch: force peaks instead of the card's lookup
        self._peak_flops_override: Optional[float] = None
        self._hbm_gbps_override: Optional[float] = None
        self._assume_mxu: Optional[bool] = None
        # memory sampler
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._mem_interval = 0.5
        self._watermark = 0.0
        self._mem_bytes = 0.0
        self._pools: Dict[str, Callable[[], Optional[dict]]] = {}
        self._pool_hist: Dict[str, deque] = {}
        self._pool_stats: Dict[str, dict] = {}
        # deep profile window
        self._window_remaining = 0
        self._window_dir: Optional[str] = None
        self._window_started = False
        self._window_prof = None
        self._last_trace_dir: Optional[str] = None
        self._mem_device_used = 0.0
        self._mem_device_total = 0.0

    # ------------------------------------------------------------ config
    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, sample_every: Optional[int] = None,
                  peak_flops: Optional[float] = None,
                  hbm_gbps: Optional[float] = None,
                  assume_mxu: Optional[bool] = None) -> None:
        with self._lock:
            if sample_every is not None:
                self._sample_every = max(1, int(sample_every))
            if peak_flops is not None:
                self._peak_flops_override = float(peak_flops)
            if hbm_gbps is not None:
                self._hbm_gbps_override = float(hbm_gbps)
            if assume_mxu is not None:
                self._assume_mxu = bool(assume_mxu)

    def enable(self, sample_every: Optional[int] = None,
               memory_interval: Optional[float] = None) -> None:
        """Turn sampling on; with ``memory_interval`` also start the
        off-thread device-memory sampler (``pt-obs-profiler``)."""
        self.configure(sample_every=sample_every)
        with self._lock:
            self._enabled = True
        # postmortem bundles carry the live breakdown + trace link
        from paddle_tpu_torch.obs.flight import FLIGHT
        FLIGHT.register_state_provider("profiler", self.snapshot)
        from paddle_tpu_torch.obs.slo import WATCHDOG
        WATCHDOG.add_source("profiler", self._slo_source)
        if memory_interval is not None:
            self.start_memory_sampler(memory_interval)

    def disable(self) -> None:
        with self._lock:
            self._enabled = False
        self.stop_memory_sampler()

    # ---------------------------------------------------------- per-step
    def set_cost_source(self, kind: str, fn: Callable[[], tuple]) -> None:
        """Register the lazy (flops, bytes) provider for a step kind —
        the decode engine wires a closure that counts one step
        (``cost_of``). Invoked at most once per enable, off the first
        sampled step, on the stepping thread."""
        with self._lock:
            self._cost_src[kind] = fn
            self._cost.pop(kind, None)
            self._cost_failed.pop(kind, None)

    def on_step(self, kind: str = "train") -> None:
        """Once per step. Fast path (disabled): one attr read."""
        if not self._enabled:
            return
        now = time.perf_counter()
        dt_ms: Optional[float] = None
        phases: Optional[Dict[str, float]] = None
        need_cost = False
        window_action = None
        with self._lock:
            st = self._kinds.get(kind)
            if st is None:
                st = self._kinds[kind] = _KindState()
            st.steps += 1
            if st.t_last is not None:
                dt_ms = (now - st.t_last) * 1e3
                st.dt_sum += dt_ms
                st.dt_n += 1
                st.step_ms.append(dt_ms)
            st.t_last = now
            sample = st.steps % self._sample_every == 0
            if sample:
                phases = self._sample_phases_locked(kind, st)
                if kind not in self._cost and kind in self._cost_src \
                        and not self._cost_failed.get(kind):
                    need_cost = True
            if self._window_remaining > 0:
                if not self._window_started:
                    self._window_started = True
                    window_action = ("start", self._window_dir)
                self._window_remaining -= 1
                if self._window_remaining == 0:
                    window_action = ("stop", self._window_dir)
        # everything below runs OUTSIDE the lock: cost_of runs a step,
        # the watchdog journals (whose flight auto-dump snapshots us).
        if window_action is not None:
            self._drive_window(window_action)
        if need_cost:
            self._resolve_cost(kind)
        if phases is not None:
            self._publish(kind)
        if dt_ms is not None:
            from paddle_tpu_torch.obs.slo import WATCHDOG
            WATCHDOG.observe_step(kind, dt_ms, phases)

    def _sample_phases_locked(self, kind: str,
                              st: _KindState) -> Dict[str, float]:
        from paddle_tpu_torch.utils.stats import global_stat
        steps = max(1, st.steps - st.last_sample_step)
        st.last_sample_step = st.steps
        timers = global_stat.items()
        out: Dict[str, float] = {}
        for phase, timer in PHASE_TIMERS.get(kind, ()):
            item = timers.get(timer)
            total = item.snapshot()[1] if item is not None else 0.0
            delta = total - st.baseline.get(timer, 0.0)
            st.baseline[timer] = total
            out[phase] = max(0.0, delta) * 1e3 / steps
        st.phase_ms = out
        return out

    def resolve_cost(self, kind: str) -> None:
        """Count ``kind``'s step cost now, if profiling is on and it is
        not counted yet: the first ``FlopCounterMode`` of a process
        takes seconds, which a warmup pays instead of the first
        sampled step (and the requests riding it)."""
        with self._lock:
            pending = self._enabled and kind in self._cost_src \
                and kind not in self._cost \
                and not self._cost_failed.get(kind)
        if pending:
            self._resolve_cost(kind)

    def _resolve_cost(self, kind: str) -> None:
        src = self._cost_src.get(kind)
        if src is None:
            return
        try:
            flops, nbytes = src()
        except Exception:  # noqa: BLE001 — profiling never takes down a run
            flops = nbytes = None
        with self._lock:
            if flops is None and nbytes is None:
                self._cost_failed[kind] = True
            else:
                self._cost[kind] = (flops, nbytes)

    def _dtype(self) -> str:
        if self._assume_mxu is not None:
            return "bfloat16" if self._assume_mxu else "float32"
        try:
            from paddle_tpu_torch.config import global_config
            return global_config().compute_dtype
        except Exception:  # noqa: BLE001 — config optional at import time
            return "float32"

    def _peaks(self):
        if self._peak_flops_override is not None \
                or self._hbm_gbps_override is not None:
            return self._peak_flops_override, self._hbm_gbps_override
        import torch
        if not torch.cuda.is_available():
            return None, None
        dev = torch.cuda.current_device()
        return device_peak_flops(dev, self._dtype()), device_hbm_gbps(dev)

    def _publish(self, kind: str) -> None:
        """Refresh the gauges for one kind after a sampled step."""
        with self._lock:
            st = self._kinds.get(kind)
            if st is None:
                return
            mean_ms = st.dt_sum / st.dt_n if st.dt_n else None
            st.dt_sum, st.dt_n = 0.0, 0
            phases = dict(st.phase_ms)
            cost = self._cost.get(kind)
        for phase, ms in phases.items():
            _G_PHASE.labels(kind=kind, phase=phase).set(round(ms, 4))
        if mean_ms is None:
            return
        _G_STEP.labels(kind=kind).set(round(mean_ms, 4))
        if cost is None:
            return
        peak_flops, hbm_gbps = self._peaks()
        rf = roofline(mean_ms, flops=cost[0], bytes_acc=cost[1],
                      peak_flops=peak_flops, hbm_gbps=hbm_gbps)
        if "mfu" in rf:
            _G_MFU.labels(kind=kind).set(round(rf["mfu"], 6))
        if "roofline_frac" in rf:
            _G_ROOF.labels(kind=kind).set(round(rf["roofline_frac"], 4))

    # -------------------------------------------------------- deep window
    def arm_window(self, steps: int, out_dir: Optional[str] = None) -> str:
        """Capture a ``torch.profiler`` window over the next ``steps``
        observed steps. Returns the artifact directory; the window's
        Chrome trace lands there as ``trace.json``."""
        import tempfile
        out_dir = out_dir or tempfile.mkdtemp(prefix="pt-profile-trace-")
        with self._lock:
            self._window_remaining = max(1, int(steps))
            self._window_dir = out_dir
            self._window_started = False
        return out_dir

    def _drive_window(self, action) -> None:
        what, out_dir = action
        try:
            import torch
            if what == "start":
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                with self._lock:
                    self._window_prof = prof
                return
            with self._lock:
                prof, self._window_prof = self._window_prof, None
            if prof is None:
                raise RuntimeError("no profiler window running")
            prof.stop()
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except Exception:  # noqa: BLE001 — tracing is best-effort
            with self._lock:
                self._window_remaining = 0
                self._window_started = False
            return
        with self._lock:
            self._last_trace_dir = out_dir
            self._window_started = False
        from paddle_tpu_torch.obs.events import emit
        emit("profile", "window", dir=out_dir)

    def finish_window(self) -> Optional[str]:
        """Force-close an armed/started window (CLI teardown). Returns
        the trace dir if a capture was stopped."""
        with self._lock:
            started = self._window_started
            out_dir = self._window_dir
            self._window_remaining = 0
        if started:
            self._drive_window(("stop", out_dir))
            return out_dir
        return None

    # ----------------------------------------------------- memory sampler
    def register_pool(self, name: str,
                      fn: Callable[[], Optional[dict]]) -> None:
        """``fn()`` returns a PagePool ``accounting()`` dict, or None
        once the owner is gone (weakref closure) — the pool is then
        dropped."""
        with self._lock:
            self._pools[name] = fn

    def start_memory_sampler(self, interval: float = 0.5) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._mem_interval = max(0.05, float(interval))
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._mem_loop, name="pt-obs-profiler", daemon=True)
            self._thread.start()

    def stop_memory_sampler(self) -> None:
        with self._lock:
            th, self._thread = self._thread, None
        self._stop.set()
        if th is not None and th.is_alive():
            th.join(timeout=5.0)

    def _mem_loop(self) -> None:
        stop = self._stop
        while not stop.wait(self._mem_interval):
            self.sample_memory()
            from paddle_tpu_torch.obs.slo import WATCHDOG
            WATCHDOG.evaluate()

    def sample_memory(self) -> dict:
        """One device-memory + pool-occupancy sample (the thread body;
        also callable inline from tests/CLI)."""
        in_use = peak = used = total = 0.0
        try:
            import torch
            if torch.cuda.is_available():
                for d in range(torch.cuda.device_count()):
                    ms = torch.cuda.memory_stats(d)
                    in_use += float(ms.get("allocated_bytes.all.current",
                                           0) or 0)
                    peak += float(ms.get("allocated_bytes.all.peak", 0)
                                  or 0)
                    free, tot = torch.cuda.mem_get_info(d)
                    used += float(tot - free)
                    total += float(tot)
        except Exception:  # noqa: BLE001 — a CPU process reports nothing
            pass
        now = time.monotonic()
        with self._lock:
            self._mem_bytes = in_use
            self._mem_device_used = used
            self._mem_device_total = total
            self._watermark = max(self._watermark, peak, in_use)
            watermark = self._watermark
            pools = list(self._pools.items())
        _G_MEM.set(in_use)
        _G_WATERMARK.set(watermark)
        dead: List[str] = []
        for name, fn in pools:
            try:
                acct = fn()
            except Exception:  # noqa: BLE001 — a dying engine is not fatal
                acct = None
            if acct is None:
                dead.append(name)
                continue
            total = float(acct.get("total_usable", 0) or 0)
            occ = float(acct.get("allocated", 0) or 0) / total \
                if total > 0 else 0.0
            with self._lock:
                hist = self._pool_hist.setdefault(name, deque(maxlen=64))
                hist.append((now, occ))
                trend = 0.0
                if len(hist) >= 2 and hist[-1][0] > hist[0][0]:
                    trend = (hist[-1][1] - hist[0][1]) \
                        / (hist[-1][0] - hist[0][0])
                self._pool_stats[name] = {
                    "occupancy": round(occ, 4),
                    "trend_per_s": round(trend, 6),
                }
            _G_POOL.labels(pool=name).set(round(occ, 4))
            _G_POOL_TREND.labels(pool=name).set(round(trend, 6))
        if dead:
            with self._lock:
                for name in dead:
                    self._pools.pop(name, None)
                    self._pool_hist.pop(name, None)
                    self._pool_stats.pop(name, None)
        return {"bytes_in_use": in_use, "watermark": watermark}

    # ---------------------------------------------------------- read side
    def _slo_source(self) -> dict:
        """Rolling step-time stats for the watchdog's declarative
        objectives (metric keys: step_time_ms / step_time_p99_ms, and
        decode_* for the decode kind)."""
        out: Dict[str, float] = {}
        with self._lock:
            for kind, st in self._kinds.items():
                if not st.step_ms:
                    continue
                xs = sorted(st.step_ms)
                p99 = xs[min(len(xs) - 1, int(0.99 * (len(xs) - 1)))]
                pfx = "" if kind == "train" else f"{kind}_"
                out[f"{pfx}step_time_ms"] = xs[len(xs) // 2]
                out[f"{pfx}step_time_p99_ms"] = p99
        return out

    def snapshot(self) -> dict:
        """One JSON-able view of everything live — served on
        ``GET /profile`` and embedded in flight bundles as the
        ``profiler`` state."""
        with self._lock:
            kinds = {}
            for kind, st in self._kinds.items():
                ms = list(st.step_ms)
                kinds[kind] = {
                    "steps": st.steps,
                    "step_ms": round(ms[-1], 4) if ms else None,
                    "step_ms_median":
                        round(median(ms), 4) if ms else None,
                    "phases": {p: round(v, 4)
                               for p, v in st.phase_ms.items()},
                }
            cost = {k: {"flops": v[0], "bytes": v[1]}
                    for k, v in self._cost.items()}
            out = {
                "enabled": self._enabled,
                "sample_every": self._sample_every,
                "kinds": kinds,
                "cost": cost,
                "memory": {
                    "bytes_in_use": self._mem_bytes,
                    "watermark_bytes": self._watermark,
                    # the card's view (mem_get_info): every process's
                    # bytes and the caching allocator's reserve
                    "device_used_bytes": self._mem_device_used,
                    "device_total_bytes": self._mem_device_total,
                },
                "pools": {k: dict(v)
                          for k, v in self._pool_stats.items()},
                "window": {
                    "remaining": self._window_remaining,
                    "last_trace_dir": self._last_trace_dir,
                },
            }
        gauges = {}
        for fam, key in ((_G_MFU, "mfu"), (_G_ROOF, "roofline_frac")):
            for _, labels, value in fam.samples():
                gauges.setdefault(key, {})[labels.get("kind", "")] = value
        out.update(gauges)
        return out

    def reset(self) -> None:
        """Stop the sampler thread, drop state, and disable
        (obs.reset_all)."""
        self.stop_memory_sampler()
        self.finish_window()
        with self._lock:
            self._enabled = False
            self._sample_every = 8
            self._kinds.clear()
            self._cost_src.clear()
            self._cost.clear()
            self._cost_failed.clear()
            self._peak_flops_override = None
            self._hbm_gbps_override = None
            self._assume_mxu = None
            self._watermark = 0.0
            self._mem_bytes = 0.0
            self._mem_device_used = 0.0
            self._mem_device_total = 0.0
            self._pools.clear()
            self._pool_hist.clear()
            self._pool_stats.clear()
            self._window_remaining = 0
            self._window_dir = None
            self._window_started = False
            self._last_trace_dir = None


#: the process-global profiler every hot loop reports through
PROFILER = StepProfiler()
