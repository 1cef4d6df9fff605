"""InferenceServer — admission-controlled serving over a merged model,
the port of ``paddle_tpu/serving/server.py``.

The reference C API existed so a fleet of C threads could serve a
shared model; what it never had was admission control — overload
meant unbounded queues and timeouts meant dead clients. This wraps
``load_inference_model`` (POST /infer) and, with ``engine=``, the
continuous-batching decode engine (POST /generate) with:

- a BOUNDED request queue with backpressure: a full queue rejects
  instantly with a retry-after hint instead of buffering unboundedly
  (``Rejected``, reason ``queue_full``);
- per-request DEADLINES enforced around the forward: a request that
  expires while queued is never run; one whose forward finishes past
  its deadline is counted ``expired`` and its result discarded;
- a sliding-window failure-rate CIRCUIT BREAKER (serving/breaker.py)
  that sheds load while the model is sick and half-opens on a cooldown
  (``Rejected``, reason ``breaker_open``);
- memory-pressure shedding: a forward that dies with
  ``torch.cuda.OutOfMemoryError`` (trainer/memory.py) is a CAPACITY
  fault, not a model fault — the request is shed with ``Rejected``
  (reason ``resource_exhausted``, retry-after hint), the adaptive
  max-batch-rows limit halves so the next oversized request is
  rejected at ADMISSION instead of wasting a device call, and the
  circuit breaker is NOT fed (the model isn't poisoned — the batch was
  too big). ``max_batch_memory`` adds a static admission budget: the
  request's estimated bytes must fit it;
- DRAIN and RESUME (``POST /admin/drain`` / ``/admin/resume``) and a
  graceful drain on shutdown: no new admissions, queued work
  completes;
- ``health()`` / ``stats()`` snapshots — queue depth, p50/p99 latency,
  served/rejected/expired/failed counters, the breaker and, with an
  engine, its stats — with every forward timed through
  ``utils/stats.py`` (``serving/forward`` in global_stat);
- a flight-recorder state provider (what was queued, by trace_id, when
  a postmortem fired) and an SLO-watchdog source (``stats()`` plus a
  derived ``shed_rate``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Union

import numpy as np

from paddle_tpu_torch.analysis.lockdep import named_condition
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.obs.flight import FLIGHT
from paddle_tpu_torch.serving.breaker import CircuitBreaker
from paddle_tpu_torch.utils.stats import global_counters, stat_timer


def percentile(vals: List[float], q: float) -> float:
    """Nearest-rank ``q`` quantile of ``vals`` (0.0 when empty)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def _estimate_nbytes(samples) -> int:
    """Rough device footprint of a request: the summed nbytes of its
    sample fields (activation memory scales with it). Estimation only —
    the authoritative signal stays the allocator's OutOfMemoryError."""
    total = 0
    for sample in samples:
        fields = sample if isinstance(sample, (tuple, list)) else (sample,)
        for f in fields:
            arr = np.asarray(f)
            total += arr.nbytes if arr.dtype != object else 8 * arr.size
    return total


class ServingError(RuntimeError):
    """Base of every typed serving failure."""


class Rejected(ServingError):
    """Shed at admission. ``retry_after`` (seconds) is the client hint;
    ``reason`` is 'queue_full', 'breaker_open', 'resource_exhausted'
    or (from the decode engine) 'kv_capacity'."""

    def __init__(self, msg: str, retry_after: float, reason: str):
        super().__init__(msg)
        self.retry_after = float(retry_after)
        self.reason = reason


class Expired(ServingError):
    """The request's deadline passed (queued too long, or the forward
    ran past it)."""


class ServerClosed(ServingError):
    """Submitted to a draining or stopped server."""


class _Request:
    __slots__ = ("samples", "deadline", "done", "result", "error",
                 "enqueued_at", "trace_id", "_settled")

    def __init__(self, samples, deadline: Optional[float], now: float,
                 trace_id: Optional[str] = None):
        self.samples = samples
        self.deadline = deadline
        self.done = threading.Event()
        self.result = None
        self.error: Optional[ServingError] = None
        self.enqueued_at = now
        # one id end-to-end: admission -> queue wait -> forward ->
        # settle all stamp it (obs/context.py)
        self.trace_id = trace_id or obs_context.new_trace_id()
        self._settled = False

    def get(self, timeout: Optional[float] = None):
        """Block for the result; raises the typed error on failure. With
        a deadline, waits only slightly past it — a hung forward cannot
        hang the CLIENT, only the worker slot (the breaker then opens)."""
        if timeout is None and self.deadline is not None:
            timeout = max(self.deadline - time.monotonic(), 0.0) + 0.25
        if not self.done.wait(timeout):
            raise Expired("request still in flight past its deadline")
        if self.error is not None:
            raise self.error
        return self.result


class InferenceServer:
    """Admission-controlled, breaker-protected serving facade.

    ``model`` is a merged-artifact path (``load_inference_model``, on
    the card unless ``init(use_gpu=False)`` asked for the CPU), a ready
    ``Inference``, or None for a generate-only server. ``workers``
    threads pull from the bounded queue; ``default_deadline``
    (seconds) applies when submit() passes none. ``breaker=None``
    installs a default CircuitBreaker; pass an instance to tune it, or
    ``breaker=False`` to disable shedding. ``engine`` (a
    serving/engine.DecodeEngine) serves generate; ``sample_log`` is
    called with each served batch's samples after a successful
    forward; ``clock`` times admission and uptime."""

    def __init__(self, model=None, *, max_queue: int = 64,
                 workers: int = 1,
                 default_deadline: Optional[float] = None,
                 breaker: Union[CircuitBreaker, None, bool] = None,
                 latency_window: int = 256,
                 max_batch_memory: Optional[int] = None,
                 engine=None,
                 sample_log: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        if isinstance(model, (str, bytes)):
            from paddle_tpu_torch.trainer.inference import \
                load_inference_model
            model = load_inference_model(model)
        self._inf = model
        # feedback seam: called with each served batch's samples from
        # the worker thread, after a successful forward
        self._sample_log = sample_log
        # optional continuous-batching decode engine
        # (serving/engine.DecodeEngine): generate() routes through its
        # page-aware admission — requests are scheduled by FREE KV
        # PAGES, not queue depth — and stats()/metrics export its
        # KV-page/slot gauges. start()/shutdown() manage its loop
        # thread alongside the forward workers.
        self.engine = engine
        self.max_queue = int(max_queue)
        self.num_workers = max(1, int(workers))
        self.default_deadline = default_deadline
        if breaker is None:
            breaker = CircuitBreaker()
        self.breaker: Optional[CircuitBreaker] = breaker or None
        # memory-pressure admission: a static bytes budget per
        # request, plus an adaptive row limit that HALVES each time a
        # forward dies with an OutOfMemoryError — oversized requests
        # then shed at admission instead of wasting a device call
        self.max_batch_memory = (int(max_batch_memory)
                                 if max_batch_memory else None)
        self._batch_limit: Optional[int] = None
        self._clock = clock
        self._cv = named_condition("serving.server")
        self._queue: deque = deque()
        self._threads: List[threading.Thread] = []
        self._accepting = False
        self._stopping = False
        self._inflight = 0
        self._latencies: deque = deque(maxlen=int(latency_window))
        self._started_at = None
        self._counters = {"served": 0, "rejected_full": 0,
                          "rejected_breaker": 0, "rejected_oom": 0,
                          "oom_events": 0, "expired": 0,
                          "failed": 0, "closed": 0}
        # live-state provider for postmortem bundles: what was queued
        # (by trace_id) when the dump fired. Weakref'd so an abandoned
        # server never pins itself in the recorder.
        import weakref
        ref = weakref.ref(self)

        def _flight_state():
            srv = ref()
            if srv is None:
                return None
            with srv._cv:
                return {"queued_trace_ids":
                        [r.trace_id for r in srv._queue],
                        "inflight": srv._inflight,
                        "accepting": srv._accepting,
                        "batch_limit": srv._batch_limit}

        FLIGHT.register_state_provider(f"serving-{id(self):x}",
                                       _flight_state)

        # SLO-watchdog source (obs/slo.py): the server's stats() plus a
        # derived shed_rate, so declarative objectives like
        # "shed_rate<=0.05" or "p99_ms<=250" evaluate over live numbers
        def _slo_stats():
            srv = ref()
            if srv is None:
                return None
            s = srv.stats()
            shed = (s.get("rejected_full", 0)
                    + s.get("rejected_breaker", 0)
                    + s.get("rejected_oom", 0))
            total = shed + s.get("served", 0)
            s["shed_rate"] = shed / total if total else 0.0
            return s

        from paddle_tpu_torch.obs.slo import WATCHDOG
        WATCHDOG.add_source(f"serving-{id(self):x}", _slo_stats)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceServer":
        with self._cv:
            if self._threads:
                return self
            self._accepting = True
            self._stopping = False
            self._started_at = self._clock()
            for i in range(self.num_workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"pt-serve-worker-{i}",
                                     daemon=True)
                t.start()
                self._threads.append(t)
        if self.engine is not None:
            self.engine.start()
        return self

    def drain(self) -> dict:
        """Deploy-drain: stop ADMITTING — submit/submit_generate raise
        ServerClosed, the HTTP front answers 503 reason "draining" —
        while workers and the engine keep settling everything already
        admitted and the transport stays up (``POST /admin/drain``).
        Reversible via :meth:`resume`, unlike :meth:`shutdown`."""
        with self._cv:
            self._accepting = False
        if self.engine is not None:
            self.engine.drain_admission()
        journal_emit("serving", "drain", action="drain")
        return self.health()

    def resume(self) -> dict:
        """Re-open admission after :meth:`drain` (re-admit on deploy
        completion / rejoin). No-op on a stopped server."""
        with self._cv:
            if self._threads and not self._stopping:
                self._accepting = True
        if self.engine is not None:
            self.engine.resume_admission()
        journal_emit("serving", "drain", action="resume")
        return self.health()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop accepting. With ``drain`` the queued requests complete
        first; without it they fail with ServerClosed immediately."""
        if self.engine is not None:
            self.engine.shutdown(drain=drain, timeout=timeout)
        with self._cv:
            self._accepting = False
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._settle(req, error=ServerClosed(
                        "server shut down before this request ran"))
                    self._counters["closed"] += 1
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout)
        with self._cv:
            self._threads = []

    # ------------------------------------------------------------ admission
    def submit(self, samples, deadline: Optional[float] = None,
               trace_id: Optional[str] = None) -> _Request:
        """Admit one request (a list of sample tuples, as
        Inference.infer takes). Returns a future-like _Request. Raises
        Rejected/ServerClosed at admission; the request itself settles
        with a result or a typed error. ``trace_id`` correlates the
        request end-to-end (minted here when the transport passed
        none); every shed/settle record carries it."""
        now = self._clock()
        trace_id = trace_id or obs_context.current().trace_id \
            or obs_context.new_trace_id()
        if deadline is None:
            deadline = self.default_deadline
        abs_deadline = (time.monotonic() + deadline) \
            if deadline is not None else None
        with self._cv:
            if not self._accepting:
                raise ServerClosed("server is draining or stopped")
            rows = len(samples) if hasattr(samples, "__len__") else None
            if rows is not None:
                if self._batch_limit is not None and \
                        rows > self._batch_limit:
                    self._counters["rejected_oom"] += 1
                    journal_emit("serving", "shed",
                                 reason="resource_exhausted",
                                 where="admission_rows", rows=rows,
                                 limit=self._batch_limit,
                                 trace_id=trace_id)
                    raise Rejected(
                        f"batch of {rows} rows exceeds the adaptive "
                        f"limit of {self._batch_limit} (a previous "
                        "forward ran out of device memory at that "
                        "size); "
                        "split the request",
                        retry_after=self._retry_hint(),
                        reason="resource_exhausted")
                if self.max_batch_memory is not None:
                    est = _estimate_nbytes(samples)
                    if est > self.max_batch_memory:
                        self._counters["rejected_oom"] += 1
                        journal_emit("serving", "shed",
                                     reason="resource_exhausted",
                                     where="admission_bytes",
                                     estimated_bytes=est,
                                     budget=self.max_batch_memory,
                                     trace_id=trace_id)
                        raise Rejected(
                            f"request estimated at {est} bytes exceeds "
                            f"max_batch_memory={self.max_batch_memory}; "
                            "split the request",
                            retry_after=self._retry_hint(),
                            reason="resource_exhausted")
            if self.breaker is not None:
                ok, retry = self.breaker.allow()
                if not ok:
                    self._counters["rejected_breaker"] += 1
                    journal_emit("serving", "shed",
                                 reason="breaker_open",
                                 retry_after=retry,
                                 trace_id=trace_id)
                    raise Rejected(
                        f"circuit breaker open; retry in {retry:.2f}s",
                        retry_after=retry, reason="breaker_open")
            if len(self._queue) >= self.max_queue:
                self._counters["rejected_full"] += 1
                retry = self._retry_hint()
                journal_emit("serving", "shed", reason="queue_full",
                             queue_depth=len(self._queue),
                             retry_after=retry, trace_id=trace_id)
                raise Rejected(
                    f"queue full ({self.max_queue}); retry in "
                    f"{retry:.2f}s", retry_after=retry,
                    reason="queue_full")
            req = _Request(samples, abs_deadline, now,
                           trace_id=trace_id)
            depth = len(self._queue)
            self._queue.append(req)
            self._cv.notify()
        FLIGHT.record("mark", "serving/admit", trace_id=trace_id,
                      queue_depth=depth)
        return req

    def infer(self, samples, deadline: Optional[float] = None,
              trace_id: Optional[str] = None):
        """Synchronous submit + wait."""
        return self.submit(samples, deadline, trace_id=trace_id).get()

    # --------------------------------------------------------- generation
    def submit_generate(self, prompt, max_new_tokens: int, *,
                        eos_id: Optional[int] = None,
                        deadline: Optional[float] = None,
                        trace_id: Optional[str] = None):
        """Admit one generation request into the continuous-batching
        decode engine (requires ``engine=``). Admission is the ENGINE's
        — scheduled by free KV pages, with the same typed errors as
        ``submit`` (``Rejected`` reasons ``kv_capacity``/``queue_full``,
        ``ServerClosed`` when draining). Returns the engine's
        future-like GenRequest (``.get()`` / ``.cancel()``)."""
        if self.engine is None:
            raise ServingError(
                "no decode engine attached — construct the server "
                "with engine=DecodeEngine(...)")
        if deadline is None:
            deadline = self.default_deadline
        return self.engine.submit(prompt, max_new_tokens,
                                  eos_id=eos_id, deadline=deadline,
                                  trace_id=trace_id)

    def generate(self, prompt, max_new_tokens: int, *,
                 eos_id: Optional[int] = None,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None):
        """Synchronous submit_generate + wait -> generated token ids."""
        return self.submit_generate(prompt, max_new_tokens,
                                    eos_id=eos_id,
                                    deadline=deadline,
                                    trace_id=trace_id).get()

    def _retry_hint(self) -> float:
        lats = list(self._latencies)
        per = (sum(lats) / len(lats)) if lats else 0.05
        return max(per * (len(self._queue) + 1) / self.num_workers, 0.01)

    # ------------------------------------------------------------- workers
    def _settle(self, req: _Request, result=None,
                error: Optional[ServingError] = None) -> bool:
        """Deliver exactly once (caller may have timed out and gone)."""
        if req._settled:
            return False
        req._settled = True
        req.result = result
        req.error = error
        req.done.set()
        return True

    def _worker_loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait(0.2)
                if not self._queue:
                    if self._stopping:
                        return
                    continue
                req = self._queue.popleft()
                self._inflight += 1
            try:
                self._serve_one(req)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _serve_one(self, req: _Request):
        now = time.monotonic()
        # the queue wait is part of the request's trace: how long
        # admission-to-dequeue took, by trace_id
        FLIGHT.record("mark", "serving/queue_wait",
                      trace_id=req.trace_id,
                      wait_s=round(now - req.enqueued_at, 6))
        if req.deadline is not None and now > req.deadline:
            # expired while queued: never runs. Pure overload — handled
            # by backpressure, so it does NOT feed the breaker.
            with self._cv:
                self._counters["expired"] += 1
            FLIGHT.record("mark", "serving/settle",
                          trace_id=req.trace_id, outcome="expired",
                          where="queued")
            self._settle(req, error=Expired(
                "deadline passed while queued"))
            return
        t0 = time.perf_counter()
        try:
            # the worker thread re-binds the request's trace context so
            # the forward span (and anything it journals) carries the id
            with obs_context.bind(trace_id=req.trace_id):
                with stat_timer("serving/forward"):
                    result = self._forward(req.samples)
        except Exception as e:
            from paddle_tpu_torch.trainer.memory import \
                is_resource_exhausted
            if is_resource_exhausted(e):
                # capacity fault, not a model fault: shed with a retry
                # hint, shrink the admission limit so the next oversized
                # request never reaches the device, and do NOT feed the
                # breaker (the model isn't poisoned — the batch was too
                # big for device memory)
                rows = len(req.samples) \
                    if hasattr(req.samples, "__len__") else 2
                with self._cv:
                    self._counters["oom_events"] += 1
                    cap = max(1, rows // 2)
                    self._batch_limit = cap if self._batch_limit is None \
                        else min(self._batch_limit, cap)
                    retry = self._retry_hint()
                global_counters.bump("serving/oom_events")
                journal_emit("serving", "shed",
                             reason="resource_exhausted",
                             where="forward", rows=rows,
                             new_batch_limit=cap,
                             trace_id=req.trace_id)
                self._settle(req, error=Rejected(
                    f"forward ran out of device memory on {rows} rows; "
                    f"max batch shrunk to {cap} — split the request "
                    f"and retry in {retry:.2f}s",
                    retry_after=retry, reason="resource_exhausted"))
                return
            with self._cv:
                self._counters["failed"] += 1
            if self.breaker is not None:
                self.breaker.record(False)
            FLIGHT.record("mark", "serving/settle",
                          trace_id=req.trace_id, outcome="failed",
                          error=repr(e)[:200])
            self._settle(req, error=ServingError(f"forward failed: {e}"))
            return
        dt = time.perf_counter() - t0
        with self._cv:
            self._latencies.append(dt)
        if req.deadline is not None and time.monotonic() > req.deadline:
            # ran, but too slowly: the deadline is enforced AROUND the
            # forward. A slow/hung model is a model fault — it feeds
            # the breaker so sustained hangs shed load.
            with self._cv:
                self._counters["expired"] += 1
            if self.breaker is not None:
                self.breaker.record(False)
            self._settle(req, error=Expired(
                f"forward took {dt * 1e3:.0f}ms, past the deadline"))
            return
        if self.breaker is not None:
            self.breaker.record(True)
        FLIGHT.record("mark", "serving/settle",
                      trace_id=req.trace_id, outcome="served",
                      forward_ms=round(dt * 1e3, 3))
        self._settle(req, result=result)
        with self._cv:
            self._counters["served"] += 1

    def _forward(self, samples):
        out = self._inf.forward_batch(samples)
        if self._sample_log is not None:
            try:
                self._sample_log(samples)
            except Exception:  # noqa: BLE001 — a feedback-journal bug
                pass           # must never fail the serving request
        return out[0] if len(out) == 1 else out

    # ------------------------------------------------------------ snapshots
    def health(self) -> dict:
        with self._cv:
            running = bool(self._threads)
            accepting = self._accepting
            depth = len(self._queue)
        bstate = self.breaker.state if self.breaker is not None \
            else "disabled"
        if not running:
            status = "stopped"
        elif not accepting:
            status = "draining"
        elif bstate == "open":
            status = "shedding"
        else:
            status = "ok"
        return {"status": status, "accepting": accepting,
                "queue_depth": depth, "workers": self.num_workers,
                "breaker": bstate}

    def stats(self) -> dict:
        with self._cv:
            counters = dict(self._counters)
            depth = len(self._queue)
            inflight = self._inflight
            lats = list(self._latencies)
            uptime = (self._clock() - self._started_at) \
                if self._started_at is not None else 0.0
        out = dict(counters)
        out.update({
            "queue_depth": depth,
            "inflight": inflight,
            "batch_limit": self._batch_limit,
            "p50_ms": round(percentile(lats, 0.50) * 1e3, 3),
            "p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
            "uptime_s": round(uptime, 3),
            "breaker": self.breaker.snapshot()
            if self.breaker is not None else None,
        })
        if self.engine is not None:
            out["engine"] = self.engine.stats()
        return out

    # convenience for HTTP clients sending raw dense rows
    def infer_rows(self, rows, deadline: Optional[float] = None,
                   trace_id: Optional[str] = None):
        samples = [(np.asarray(r, np.float32),) for r in rows]
        out = self.infer(samples, deadline, trace_id=trace_id)
        return np.asarray(out)
