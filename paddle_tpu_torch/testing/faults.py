"""Deterministic fault injection for chaos-testing training and
serving — the port of ``paddle_tpu/testing/faults.py``.

A seedable :class:`FaultPlan` drives faults against the port's real
loops through the seams they expose, one family per target:

- (a) checkpoints: ``checkpoint_write_failure`` (ENOSPC, torn writes at
  a chosen save and byte, through ``trainer/checkpoint._savez``),
  ``corrupt_newest_checkpoint``;
- (b) coordinator RPCs: ``flaky_coordinator`` (:class:`FlakyCoordinator`
  drops or delays chosen calls);
- (c) training batches: ``poison_batches`` (NaN/Inf at exact steps);
- (i) memory: ``oom_at`` and ``memory_pressure`` raise the port's
  ``resource_exhausted_error`` (a ``torch.OutOfMemoryError``) through
  ``SGD._step_interceptor``;
- (e) serving forwards: ``flaky_forward`` (fail, delay or hang chosen
  ``Inference.forward_batch`` calls);
- (g) bursts: ``burst`` (a thread pool of calls), ``bursty_trace`` (the
  seeded quiet→spike→quiet request-count shape);
- (j) the decode engine: ``decode_script`` (join/cancel/evict/shutdown
  at exact engine steps, over ``DecodeEngine._step_interceptor``),
  ``disconnect_after`` (a client cancels after n streamed tokens);
- (n) prefix cache and speculation: ``divergent_twins`` (prompts that
  diverge inside a KV page — copy-on-write), ``prefix_evict_storm``,
  ``cancel_mid_verify``;
- (s) the two-tier KV plane: ``spill_storm``, ``corrupt_spilled_page``,
  ``kill_during_spill`` (over ``DecodeEngine._spill_interceptor`` at the
  "read" or "commit" stage);
- (l) stragglers: ``slow_step`` (a stall inside the step's
  ``train_step`` timer, the profiler's "compute" phase), ``slow_phase``
  (an engine phase slowed under its timer);
- (m) locks: ``hold_lock`` (hold a named lockdep lock from a step seam);
- (k) membership: ``membership_script`` (join/leave/kill at exact task
  grants, over ``Coordinator._grant_interceptor``);
- (h) the data pipeline: ``hung_reader``, ``raising_mapper``,
  ``crashing_mapper`` (:class:`WorkerCrash`), ``corrupt_records``;
- (d) processes: ``kill_at_marker`` (SIGKILL at a printed step marker);
- (p) the serving fleet: ``kill_replica`` (the replica's kill — a
  subprocess SIGKILL or the in-process ``httpd.kill()`` — mid-stream
  or before dispatch, over the router's ``_stream_interceptor`` /
  ``_route_interceptor``), ``lease_lapse`` (a replica's heartbeats
  paused without a leave), ``drain_during_burst`` (an admin drain
  after n dispatches);
- (q) the control plane: ``kill_router`` (the router itself killed
  mid-stream: its clients see a torn NDJSON stream and retry on a
  sibling router) and ``coordinator_outage`` (every RPC of an
  object's ``coordinator`` raises ``OSError`` for the context).

- (o) the sharded embedding service: ``kill_shard`` (the SIGKILL twin
  at a scatter-update's torn ``commit`` window or at an ``rpc``),
  ``stale_read`` (cached rows aged past the staleness bound),
  ``slow_shard`` (chosen RPCs stall);
- (r) the warm-start artifacts: ``corrupt_artifact`` (``payload``,
  ``torn``, ``magic``), ``stale_fingerprint`` (an intact frame built
  for another torch), ``cache_race`` (N writers of one artifact).

The families whose target the port has not yet — the C ABI's
(``poison_bytes``, ``destroy_during``) — come with that plane.

The invariants the chaos tests hold the port to: KV pages always
return to the pool (``page_accounting()["leaked"] == 0``), surviving
requests stay token-exact, and no protocol machine of obs/catalog.py
sees a live violation. Everything is deterministic given the seed and
the schedule, so a chaos test that fails replays exactly.
"""

from __future__ import annotations

import contextlib
import errno
import os
import random
import re
import signal
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Set

import numpy as np

__all__ = ["FaultPlan", "FlakyCoordinator", "WorkerCrash"]


class WorkerCrash(BaseException):
    """A simulated worker-thread death (segfaulting native op, stack
    overflow, interpreter teardown). Deliberately NOT an Exception: the
    supervised pipeline quarantines mapper ``Exception``s as bad
    samples, but a BaseException means the WORKER died — its in-flight
    sample is requeued and the worker restarted (reader/pipeline.py)."""


class FlakyCoordinator:
    """Proxy over a coordinator (in-process or RPC) that injects
    transport faults on chosen calls.

    drop: {method: iterable of 0-based call indices} — those calls raise
        ConnectionError WITHOUT reaching the target (the request is
        lost on the wire).
    delay: {method: {call index: seconds}} — those calls sleep first,
        then go through (a slow network / GC-paused server).
    drop_rate: additionally drop each call with this seeded probability.

    Counters are per method name. Attributes that aren't callable (an
    in-process Coordinator's `epoch` property) pass straight through."""

    def __init__(self, target, drop: Optional[Dict[str, Iterable[int]]] = None,
                 delay: Optional[Dict[str, Dict[int, float]]] = None,
                 drop_rate: float = 0.0, seed: int = 0):
        self._target = target
        self._drop = {m: set(v) for m, v in (drop or {}).items()}
        self._delay = {m: dict(v) for m, v in (delay or {}).items()}
        self._drop_rate = drop_rate
        self._rng = random.Random(seed)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.faults_injected = 0

    def __getattr__(self, name):
        val = getattr(self._target, name)
        if not callable(val):
            return val

        def call(*args, **kw):
            with self._lock:
                i = self._counts.get(name, 0)
                self._counts[name] = i + 1
                dropped = i in self._drop.get(name, ()) or (
                    self._drop_rate and
                    self._rng.random() < self._drop_rate)
                wait = self._delay.get(name, {}).get(i, 0.0)
                if dropped or wait:
                    self.faults_injected += 1
            if wait:
                time.sleep(wait)
            if dropped:
                raise ConnectionError(
                    f"injected drop: {name}() call #{i}")
            return val(*args, **kw)
        return call


class FaultPlan:
    """A seedable schedule of faults to drive against the real loop."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)

    # ------------------------------------------------- (a) checkpoint IO
    @contextlib.contextmanager
    def checkpoint_write_failure(self, at_save: int = 0,
                                 at_byte: Optional[int] = None,
                                 errnum: int = errno.ENOSPC):
        """Within the context, the ``at_save``-th checkpoint state write
        (0-based, counting every CheckpointManager.save in the process)
        raises OSError(errnum). With ``at_byte``, that many bytes are
        written FIRST — the torn artifact stays in the .tmp directory,
        exactly what a crash mid-write leaves; the atomic-rename design
        must keep the previous checkpoint as the newest intact one."""
        from paddle_tpu_torch.trainer import checkpoint as ck
        real = ck._savez
        count = [0]

        def savez(path, flat):
            i = count[0]
            count[0] += 1
            if i != at_save:
                return real(path, flat)
            if at_byte is None:
                raise OSError(errnum, os.strerror(errnum))
            # serialize fully in memory, land only the first at_byte
            # bytes on disk — the torn artifact a crash mid-write leaves
            import io
            buf = io.BytesIO()
            np.savez(buf, **flat)
            with open(path, "wb") as f:
                f.write(buf.getvalue()[:at_byte])
            raise OSError(errnum, os.strerror(errnum))

        ck._savez = savez
        try:
            yield count
        finally:
            ck._savez = real

    @staticmethod
    def corrupt_newest_checkpoint(directory: str,
                                  payload: bytes = b"garbage") -> int:
        """Overwrite the newest checkpoint's state file (bit-rot / a
        torn copy), returning its step — restore must fall back to the
        one before it via the md5 check."""
        from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
        mgr = CheckpointManager(directory)
        steps = mgr.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        newest = steps[-1]
        with open(os.path.join(directory, f"ckpt-{newest:010d}",
                               "state.npz"), "wb") as f:
            f.write(payload)
        return newest

    # -------------------------------------------------- (b) RPC faults
    def flaky_coordinator(self, target,
                          drop: Optional[Dict[str, Iterable[int]]] = None,
                          delay: Optional[Dict[str, Dict[int, float]]] = None,
                          drop_rate: float = 0.0) -> FlakyCoordinator:
        """Wrap a coordinator (in-process or connect() proxy) so chosen
        RPCs are dropped (ConnectionError) or delayed — see
        FlakyCoordinator. Randomized drops use this plan's seed."""
        return FlakyCoordinator(target, drop=drop, delay=delay,
                                drop_rate=drop_rate, seed=self.seed)

    # ------------------------------------------------ (c) NaN injection
    def poison_batches(self, reader: Callable, steps: Sequence[int],
                       value: float = float("nan"),
                       column: int = 0) -> Callable:
        """Wrap a BATCH reader (yields lists of sample tuples): at the
        given 0-based batch indices, the ``column``-th field of every
        sample is replaced with ``value`` (NaN or Inf) — the loss and
        gradients of that step go non-finite, which is what the guarded
        train step must absorb. Other batches pass through untouched, so
        a comparison run that simply skips the poisoned indices defines
        the expected parameters bit-for-bit."""
        bad: Set[int] = set(int(s) for s in steps)

        def poisoned():
            for i, batch in enumerate(reader()):
                if i in bad:
                    batch = [
                        tuple(np.full_like(
                            np.asarray(f, np.float32), value)
                            if j == column else f
                            for j, f in enumerate(sample))
                        for sample in batch]
                yield batch
        return poisoned

    # --------------------------------------------- (i) memory pressure
    @staticmethod
    @contextlib.contextmanager
    def oom_at(trainer, step: int, n: int = 1, nbytes: int = 2 << 30):
        """Within the context, the trainer's train step raises the
        port's out-of-memory error (``resource_exhausted_error``, a
        ``torch.OutOfMemoryError``) on its first
        ``n`` dispatch attempts of optimizer step ``step`` (0-based,
        ``trainer._step_count`` at dispatch time) — the adaptive
        microbatcher must bisect ``n`` times and then complete the SAME
        batch with zero lost samples (trainer/memory.py). Yields a stats
        dict (``injected``). Uses the trainer's ``_step_interceptor``
        seam, so the exception comes from exactly where a real device
        allocator failure would: the step dispatch."""
        from paddle_tpu_torch.trainer.memory import resource_exhausted_error
        stats = {"injected": 0}
        remaining = [int(n)]
        prev = trainer._step_interceptor

        def intercept(k, mb):
            if prev is not None:
                prev(k, mb)
            if trainer._step_count == step and remaining[0] > 0:
                remaining[0] -= 1
                stats["injected"] += 1
                raise resource_exhausted_error(
                    nbytes, where=f"oom_at(step={step})")

        trainer._step_interceptor = intercept
        try:
            yield stats
        finally:
            trainer._step_interceptor = prev

    @staticmethod
    @contextlib.contextmanager
    def memory_pressure(trainer, max_rows: int, nbytes: int = 2 << 30):
        """Model a device whose memory fits at most ``max_rows``
        microbatch rows: within the context, EVERY dispatch (train step
        or warmup-probe trial) whose per-microbatch row count exceeds
        ``max_rows`` raises the out-of-memory error. Deterministic
        allocation pressure — the OOM probe's binary search and the
        runtime bisect must both converge to a microbatch <= max_rows.
        Yields a stats dict (``injected``)."""
        from paddle_tpu_torch.trainer.memory import resource_exhausted_error
        stats = {"injected": 0}
        prev = trainer._step_interceptor

        def intercept(k, mb):
            if prev is not None:
                prev(k, mb)
            if mb > max_rows:
                stats["injected"] += 1
                raise resource_exhausted_error(
                    nbytes,
                    where=f"memory_pressure(max_rows={max_rows}), "
                          f"microbatch={mb}")

        trainer._step_interceptor = intercept
        try:
            yield stats
        finally:
            trainer._step_interceptor = prev

    # ------------------------------------------- (e) serving: forward
    @contextlib.contextmanager
    def flaky_forward(self, inference, fail: Iterable[int] = (),
                      delay: Optional[Dict[int, float]] = None,
                      hang: Optional[Dict[int, threading.Event]] = None,
                      fail_rate: float = 0.0):
        """Within the context, the target Inference's forward
        (``forward_batch``, the port's one forward entry) is wrapped so
        chosen 0-based call indices

          - raise RuntimeError (a poisoned request / kernel abort)
            — ``fail`` indices, plus ``fail_rate`` seeded-random drops;
          - sleep ``delay[i]`` seconds first (a slow device);
          - block on ``hang[i]`` (an Event) until the TEST releases it
            — a deterministic hung forward, the case deadlines +
            the circuit breaker must absorb.

        Yields a stats dict (``injected``, ``calls``). Thread-safe:
        serving workers may call concurrently."""
        real = inference.forward_batch
        fail_set: Set[int] = set(int(i) for i in fail)
        delays = dict(delay or {})
        hangs = dict(hang or {})
        rng = random.Random(self.seed)
        lock = threading.Lock()
        count = [0]
        stats = {"injected": 0, "calls": 0}

        def fwd(*args, **kw):
            with lock:
                i = count[0]
                count[0] += 1
                stats["calls"] += 1
                bad = i in fail_set or (
                    fail_rate and rng.random() < fail_rate)
                wait = delays.get(i, 0.0)
                ev = hangs.get(i)
                if bad or wait or ev is not None:
                    stats["injected"] += 1
            if ev is not None:
                ev.wait()
            if wait:
                time.sleep(wait)
            if bad:
                raise RuntimeError(f"injected forward fault: call #{i}")
            return real(*args, **kw)

        inference.forward_batch = fwd
        try:
            yield stats
        finally:
            del inference.forward_batch

    # ------------------------------------------ (g) serving: bursts
    @staticmethod
    def burst(fn: Callable[[int], object], n: int, threads: int = 8,
              timeout: float = 60.0):
        """Fire ``fn(i)`` for i in range(n) from a pool of ``threads`` —
        the burst-overload fault. Returns (results, errors): per-index
        return values and caught exceptions (None where the other
        applies). Raises TimeoutError if the burst doesn't settle —
        i.e. a deadlock in the system under test."""
        from concurrent.futures import ThreadPoolExecutor
        from concurrent.futures import TimeoutError as _FutTimeout
        results = [None] * n
        errors: list = [None] * n

        def run(i):
            try:
                results[i] = fn(i)
            except Exception as e:       # typed errors are the data
                errors[i] = e

        pool = ThreadPoolExecutor(max_workers=threads)
        futs = [pool.submit(run, i) for i in range(n)]
        try:
            for f in futs:
                try:
                    f.result(timeout=timeout)
                except _FutTimeout:
                    # don't wait on the wedged worker — that would turn
                    # a detected deadlock into a hung test
                    pool.shutdown(wait=False, cancel_futures=True)
                    raise TimeoutError(
                        f"burst did not settle within {timeout}s "
                        f"(deadlock in the system under test?)")
        finally:
            pool.shutdown(wait=False)
        return results, errors

    # ------------------------------------------ (j) decode engine
    @staticmethod
    @contextlib.contextmanager
    def decode_script(engine, at: Dict[int, Callable]):
        """Within the context, run ``at[i]()`` immediately BEFORE the
        engine's ``i``-th step dispatches (0-based, counted from
        entering the context — a warmed engine replays the same script
        at the same offsets) — the deterministic twin of a client
        submitting/cancelling mid-decode or an operator forcing an
        eviction. Actions run on the engine's stepping thread via the
        ``_step_interceptor`` seam, so they interleave with the device
        step exactly like real scheduler events: between dispatches,
        never during one. Yields a stats dict (``fired``: indices that
        ran)."""
        actions = {int(i): fn for i, fn in at.items()}
        stats = {"fired": []}
        prev = engine._step_interceptor
        base = engine._steps

        def intercept(step):
            if prev is not None:
                prev(step)
            fn = actions.get(step - base)
            if fn is not None:
                stats["fired"].append(step - base)
                fn()

        engine._step_interceptor = intercept
        try:
            yield stats
        finally:
            engine._step_interceptor = prev

    @staticmethod
    def disconnect_after(request, n_tokens: int,
                         poll_s: float = 0.002,
                         timeout: float = 60.0) -> threading.Thread:
        """Cancel ``request`` from another thread once it has streamed
        ``n_tokens`` generated tokens — a client that consumed part of
        the stream and disconnected mid-generation. The engine must
        observe the cancellation at its next step, return every page to
        the pool, and leave the other in-flight sequences token-exact.
        Returns the (started) thread; join it."""
        def run():
            deadline = time.time() + timeout
            while (request.num_generated < n_tokens
                   and not request.done.is_set()
                   and time.time() < deadline):
                time.sleep(poll_s)
            request.cancel()

        t = threading.Thread(target=run, daemon=True,
                             name="pt-fault-disconnect")
        t.start()
        return t

    # ------------------------------------- (n) prefix-cache / CoW chaos
    def divergent_twins(self, engine, *, diverge_at: Optional[int] = None,
                        tail: int = 3, max_new: int = 4,
                        pairs: int = 2, vocab: int = 32):
        """Submit ``pairs`` request pairs sharing a ``diverge_at``-token
        prompt prefix that splits INSIDE a KV page (default: mid-page
        of the engine's second page) — every admission after the first
        walks the radix index and exercises the copy-on-write path.
        Returns ``[(request, prompt), ...]``; drive the engine, then
        assert each settled output token-exact vs the dense reference
        and ``page_accounting()`` zero leaks / zero underflows."""
        rng = np.random.RandomState(self.seed)
        ps = engine.page_size
        if diverge_at is None:
            diverge_at = ps + max(1, ps // 2)   # mid-page, page 1
        shared = [int(t) for t in rng.randint(0, vocab, diverge_at)]
        out = []
        for _ in range(2 * pairs):
            prompt = shared + [int(t)
                               for t in rng.randint(0, vocab, tail)]
            out.append((engine.submit(prompt, max_new), prompt))
        return out

    def prefix_evict_storm(self, engine, *, waves: int = 4,
                           per_wave: int = 2, gap: int = 3,
                           prompt_len: int = 8, max_new: int = 3,
                           vocab: int = 32):
        """Join ``per_wave`` requests with DISTINCT prompts every
        ``gap`` engine steps: finished requests stack their pages into
        the radix index until admission must reclaim LRU trie leaves
        (journaled ``engine/prefix_evict``) before any slot preemption.
        The first wave submits immediately (so ``run()`` has work);
        later waves are a decode_script schedule. Returns
        ``(schedule, submitted)`` — ``submitted`` fills with
        ``(request, prompt)`` as waves fire; run the engine under
        ``decode_script(engine, schedule)``."""
        rng = np.random.RandomState(self.seed + 1)
        submitted: list = []

        def fire():
            for _ in range(per_wave):
                prompt = [int(t)
                          for t in rng.randint(0, vocab, prompt_len)]
                submitted.append((engine.submit(prompt, max_new),
                                  prompt))

        schedule: Dict[int, Callable] = {
            w * gap: fire for w in range(1, waves)}
        fire()
        return schedule, submitted

    # ------------------------------------- (s) two-tier KV spill chaos
    def spill_storm(self, engine, *, waves: int = 5, per_wave: int = 2,
                    gap: int = 4, prompt_len: int = 8, max_new: int = 3,
                    vocab: int = 32, revisit_from: int = 2):
        """``prefix_evict_storm``'s two-tier twin: join ``per_wave``
        DISTINCT-prefix requests every ``gap`` engine steps so pool
        pressure spills cold trie leaves to the host store
        (``engine/page_spill``) — and, from wave ``revisit_from`` on,
        each wave ALSO re-submits one of the earliest prompts, whose
        pages are by then the coldest and most likely spilled: the
        revisit's admission walks the same token path and must restore
        them (``engine/page_restore``) before prefill is charged.
        Returns ``(schedule, submitted)`` in the evict-storm shape —
        run the engine under ``decode_script(engine, schedule)``, then
        assert both-tier balance and token identity."""
        rng = np.random.RandomState(self.seed + 2)
        prompts = [[int(t) for t in rng.randint(0, vocab, prompt_len)]
                   for _ in range(waves * per_wave)]
        submitted: list = []
        wave_no = [0]

        def fire():
            w = wave_no[0]
            wave_no[0] += 1
            for j in range(per_wave):
                prompt = prompts[(w * per_wave + j) % len(prompts)]
                submitted.append((engine.submit(prompt, max_new),
                                  prompt))
            if w >= revisit_from:
                prompt = prompts[w % revisit_from]
                submitted.append((engine.submit(prompt, max_new),
                                  prompt))

        schedule: Dict[int, Callable] = {
            w * gap: fire for w in range(1, waves)}
        fire()
        return schedule, submitted

    def corrupt_spilled_page(self, engine,
                             mode: str = "bitflip") -> Optional[tuple]:
        """Corrupt ONE entry in the engine's spill store in place —
        ``mode="bitflip"`` (seeded single-byte flip: bit-rot) or
        ``"truncate"`` (zero the tail: a torn write) — WITHOUT
        touching its recorded CRC. The next restore of that key must
        fail verification, journal ``engine/spill_integrity``
        (``reason="crc_mismatch"``), drop the entry, and degrade to a
        prefix miss: the request recomputes and stays token-exact.
        Returns the corrupted key (a token path), or None if the
        store is empty. Use as a decode_script action to land the
        corruption between two exact steps."""
        if engine.spill is None:
            raise ValueError("engine has no spill store "
                             "(kv_spill_pages=0)")
        return engine.spill.corrupt_one(mode, rng=self._rng)

    @staticmethod
    @contextlib.contextmanager
    def kill_during_spill(engine, at: int = 0, stage: str = "commit"):
        """Within the context, raise :class:`WorkerCrash` from the
        engine's ``_spill_interceptor`` seam at the ``at``-th firing
        of the named ``stage`` — the SIGKILL-mid-spill twin, landing
        at an exact point of the crash-safety ordering
        (serving/spill.py):

        - ``stage="read"``: before the device page is read — nothing
          has changed; the trie still owns the page and the store has
          no entry;
        - ``stage="commit"``: after the trie node is evicted and the
          device page freed, before ``put()`` commits — the page is
          simply free and the store has no entry (cache contents
          lost, accounting intact).

        Either way the ordering contract guarantees no page is both
        device-owned and host-stored, and ``page_accounting()`` on
        the survivor stays balanced across both tiers. Yields a stats
        dict (``fired``, ``stage``, ``path``)."""
        if stage not in ("read", "commit"):
            raise ValueError(f"unknown spill stage {stage!r}")
        stats = {"fired": 0, "stage": stage, "path": None}
        count = [0]
        prev = engine._spill_interceptor

        def seam(point, path, page):
            if prev is not None:
                prev(point, path, page)
            if point != stage:
                return
            i = count[0]
            count[0] += 1
            if i == at:
                stats["fired"] += 1
                stats["path"] = path
                raise WorkerCrash(
                    f"kill_during_spill: {stage} #{i} page={page}")

        engine._spill_interceptor = seam
        try:
            yield stats
        finally:
            engine._spill_interceptor = prev

    @staticmethod
    def cancel_mid_verify(request, at: int = 2) -> Dict[int, Callable]:
        """A decode_script fragment cancelling ``request`` immediately
        before engine step ``at`` dispatches — with speculation on, the
        cancel lands BETWEEN a draft proposal round and the target's
        verify of those proposals: the engine must reap it before the
        next dispatch, return every page (and shared-prefix ref) to
        the pool, and leave the other slots' outputs token-exact.
        Merge into a larger schedule or pass straight to
        ``decode_script``."""
        return {int(at): request.cancel}

    # ------------------------------------- (l) performance stragglers
    @staticmethod
    @contextlib.contextmanager
    def slow_step(trainer, step: int, factor: float = 5.0, n: int = 4):
        """Within the context, optimizer steps [step, step+n) run
        ~``factor``x slower: a sleep of (factor-1)x the measured
        per-step baseline is injected through the trainer's
        ``_step_interceptor`` seam, INSIDE the step's ``train_step`` timer —
        so the continuous profiler books the stall under its "compute"
        phase and the SLO watchdog's regression detector must both fire
        AND attribute it there (the deterministic twin of a straggling
        device / thermal throttling). The baseline is the median
        inter-dispatch gap over the healthy steps before ``step``
        (fallback 20 ms when the stall lands first). The seam fires on
        the microbatcher path — train with ``microbatch=`` set (e.g.
        "auto"). Yields a stats dict (``injected``, ``baseline_ms``,
        ``slept_ms``)."""
        stats = {"injected": 0, "baseline_ms": None, "slept_ms": 0.0}
        dts: list = []
        t_last = [None]
        prev = trainer._step_interceptor

        def intercept(k, mb):
            if prev is not None:
                prev(k, mb)
            now = time.perf_counter()
            sc = trainer._step_count
            if step <= sc < step + n:
                base = sorted(dts)[len(dts) // 2] if dts else 0.020
                stats["baseline_ms"] = round(base * 1e3, 3)
                pause = max(factor - 1.0, 0.0) * base
                stats["injected"] += 1
                stats["slept_ms"] += pause * 1e3
                time.sleep(pause)
                t_last[0] = None     # stalled gaps are not baseline
                return
            if t_last[0] is not None:
                dts.append(now - t_last[0])
            t_last[0] = now

        trainer._step_interceptor = intercept
        try:
            yield stats
        finally:
            trainer._step_interceptor = prev

    @staticmethod
    @contextlib.contextmanager
    def slow_phase(engine, phase: str = "decode_step", ms: float = 50.0,
                   at: int = 0, n: Optional[int] = None):
        """Within the context, the engine's ``phase`` runs ``ms``
        milliseconds slow from its ``at``-th step after entry (0-based,
        the decode_script convention) for ``n`` steps (None: until
        exit). ``decode_step`` — the device dispatch — is slowed INSIDE
        the ``serving/decode_step`` timer by a sleeping proxy over
        ``engine.paged``, so the profiler's per-phase breakdown books
        the stall there and the watchdog's attribution must name it;
        any other name sleeps under a ``serving/<phase>`` timer via the
        ``_step_interceptor`` seam. Yields a stats dict
        (``injected``)."""
        stats = {"injected": 0}
        base = engine._steps
        lo = base + int(at)
        hi = lo + (int(n) if n is not None else (1 << 62))
        pause = ms / 1e3

        if phase == "decode_step":
            real = engine.paged

            class _SlowPaged:
                def __getattr__(self, name):
                    return getattr(real, name)

                def step(self, *a, **kw):
                    if lo <= engine._steps < hi:
                        stats["injected"] += 1
                        time.sleep(pause)
                    return real.step(*a, **kw)

            engine.paged = _SlowPaged()
            try:
                yield stats
            finally:
                engine.paged = real
            return

        from paddle_tpu_torch.utils.stats import stat_timer
        prev = engine._step_interceptor

        def intercept(step_idx):
            if prev is not None:
                prev(step_idx)
            if lo <= step_idx < hi:
                stats["injected"] += 1
                with stat_timer(f"serving/{phase}"):
                    time.sleep(pause)

        engine._step_interceptor = intercept
        try:
            yield stats
        finally:
            engine._step_interceptor = prev

    # --------------------------------------------- (m) lock discipline
    @staticmethod
    @contextlib.contextmanager
    def hold_lock(target, name: str, at: int = 0, ms: float = 50.0,
                  n: int = 1):
        """Within the context, grab the named instrumented lock (e.g.
        ``"coord.state"``, ``"obs.flight"`` — any live
        :func:`paddle_tpu_torch.analysis.lockdep.named_lock`) from inside
        ``target``'s ``_step_interceptor`` seam and HOLD it for ``ms``
        milliseconds, starting at the ``at``-th firing after entry
        (0-based) for ``n`` firings. The deterministic twin of a
        background thread squatting on a hot shared lock: every other
        thread contending on it stalls for the full hold, which the
        lockdep witness books as contention + hold-time telemetry
        (``paddle_tpu_lockdep_contentions_total`` /
        ``_hold_time_ms``) and, when the step path itself holds
        another lock, as an order-graph edge. The lock must already
        exist (``find_lock`` raises KeyError otherwise, so a typo'd
        name fails loudly instead of silently holding nothing). Yields
        a stats dict (``injected``, ``held_ms``)."""
        from paddle_tpu_torch.analysis.lockdep import find_lock
        lock = find_lock(name)
        if lock is None:
            raise KeyError(f"no live instrumented lock named {name!r}")
        stats = {"injected": 0, "held_ms": 0.0}
        fired = [0]
        pause = ms / 1e3
        prev = target._step_interceptor

        def intercept(*args, **kw):
            if prev is not None:
                prev(*args, **kw)
            idx = fired[0]
            fired[0] += 1
            if at <= idx < at + n:
                t0 = time.perf_counter()
                with lock:
                    # ptlint: disable=R9(deliberate: this fault injector EXISTS to stall a hot lock on demand)
                    time.sleep(pause)
                stats["injected"] += 1
                stats["held_ms"] += (time.perf_counter() - t0) * 1e3

        target._step_interceptor = intercept
        try:
            yield stats
        finally:
            target._step_interceptor = prev

    # ----------------------------------------- (k) elastic membership
    @staticmethod
    @contextlib.contextmanager
    def membership_script(coordinator, at: Dict[int, Callable]):
        """Within the context, run ``at[i]()`` immediately AFTER the
        coordinator's ``i``-th task grant commits (0-based, counted
        from entering the context) — the deterministic twin of a worker
        joining, leaving, or dying at an exact point in the dispatch
        schedule. Actions run on the granting thread via the
        coordinator's ``_grant_interceptor`` seam, OUTSIDE its lock, so
        an action may itself call ``join()``/``leave()`` (or SIGKILL a
        subprocess) without deadlocking — and the grant the action
        follows was already stamped with the PRE-action generation,
        which is exactly the stale-grant race the elastic tests must
        provoke on demand. Yields a stats dict (``fired``: indices that
        ran)."""
        actions = {int(i): fn for i, fn in at.items()}
        stats = {"fired": []}
        prev = coordinator._grant_interceptor
        base = coordinator._grants

        def intercept(idx, grant):
            if prev is not None:
                prev(idx, grant)
            fn = actions.get(idx - base)
            if fn is not None:
                stats["fired"].append(idx - base)
                fn()

        coordinator._grant_interceptor = intercept
        try:
            yield stats
        finally:
            coordinator._grant_interceptor = prev

    # --------------------------------------------- (h) data pipeline
    @staticmethod
    def hung_reader(reader: Callable, hang: Optional[Dict[int, float]] = None,
                    release: Optional[Dict[int, threading.Event]] = None
                    ) -> Callable:
        """Wrap a sample Reader so chosen 0-based sample indices HANG
        before being yielded: ``hang[i]`` seconds (a finite hang — a
        stuck disk/NFS read that eventually completes), or until the
        test sets ``release[i]`` (a deterministic indefinite hang). The
        supervised pipeline's watchdog must detect the stall; no sample
        is lost — delivery is late, not absent. Indices reset per
        epoch (per ``reader()`` call), so a resumed/second pass replays
        the same schedule."""
        hangs = dict(hang or {})
        events = dict(release or {})

        def rdr():
            for i, s in enumerate(reader()):
                if i in events:
                    events[i].wait()
                if i in hangs:
                    time.sleep(hangs[i])
                yield s
        return rdr

    def raising_mapper(self, mapper: Callable, at: Iterable[int],
                       exc_type=ValueError) -> Callable:
        """Wrap a mapper so the given 0-based CALL indices raise
        ``exc_type`` — the per-sample fault the quarantine lane must
        absorb. The call counter is shared across worker threads
        (lock-protected), so exactly len(at) calls fail."""
        bad = set(int(i) for i in at)
        lock = threading.Lock()
        count = [0]

        def m(sample):
            with lock:
                i = count[0]
                count[0] += 1
            if i in bad:
                raise exc_type(f"injected mapper fault: call #{i}")
            return mapper(sample)
        return m

    def crashing_mapper(self, mapper: Callable,
                        at: Iterable[int]) -> Callable:
        """Wrap a mapper so the given 0-based call indices raise
        :class:`WorkerCrash` (a BaseException): the worker THREAD dies
        mid-sample. The pipeline must requeue the in-flight sample and
        restart the worker — zero records lost. Call counter shared
        across threads, so the requeued retry (a later call index)
        succeeds."""
        bad = set(int(i) for i in at)
        lock = threading.Lock()
        count = [0]

        def m(sample):
            with lock:
                i = count[0]
                count[0] += 1
            if i in bad:
                raise WorkerCrash(f"injected worker crash: call #{i}")
            return mapper(sample)
        return m

    def corrupt_records(self, records: Iterable[bytes],
                        at: Iterable[int]) -> Iterable[bytes]:
        """Yield ``records`` with the chosen 0-based indices replaced by
        garbage that can NEVER unpickle (leading 0xFF is no pickle
        opcode) — per-record corruption inside an otherwise crc-valid
        chunk. Feed the result to recordio.write_records to build a
        shard with exactly len(at) bad records."""
        bad = set(int(i) for i in at)
        for i, rec in enumerate(records):
            if i in bad:
                filler = bytes(self._rng.randrange(256)
                               for _ in range(max(len(rec) - 1, 4)))
                yield b"\xff" + filler
            else:
                yield rec

    # --------------------------------------------- (d) process murder
    @staticmethod
    def kill_at_marker(proc, step: int, pattern: str = r"STEP (\d+)",
                       timeout: float = 120.0,
                       sig: int = signal.SIGKILL) -> int:
        """Read ``proc.stdout`` lines until the marker regex reports a
        step >= ``step``, then deliver ``sig`` (SIGKILL: the TPU
        preemption / OOM-killer case — no cleanup handlers run). The
        worker prints markers like 'STEP 7'. Returns the step it died
        at; raises TimeoutError if the marker never appears (after
        killing the process so no orphan survives the test)."""
        rx = re.compile(pattern)
        deadline = time.time() + timeout
        try:
            for line in proc.stdout:
                if isinstance(line, bytes):
                    line = line.decode("utf-8", "replace")
                m = rx.search(line)
                if m and int(m.group(1)) >= step:
                    proc.send_signal(sig)
                    proc.wait(timeout=30)
                    return int(m.group(1))
                if time.time() > deadline:
                    break
        except ValueError:            # stream closed under us
            pass
        proc.kill()
        proc.wait(timeout=30)
        raise TimeoutError(
            f"marker {pattern!r} never reached step {step} "
            f"within {timeout}s")

    # --------------------------------------------- (p) fleet chaos
    @staticmethod
    @contextlib.contextmanager
    def kill_replica(router, replica_id: str, kill: Callable[[], None],
                     at: int = 2, mid_stream: bool = True):
        """Arm a one-shot replica kill on the router's chaos seams:
        with ``mid_stream`` the caller's ``kill()`` fires the moment
        the router has relayed ``at`` tokens of any request streaming
        off ``replica_id`` (the SIGKILL-mid-generation fault — the
        victim connection tears before its terminal record, which is
        the router's failover trigger); without it, ``kill()`` fires
        right before the router's next dispatch TO that replica (the
        request dies on connect and fails over with zero streamed
        tokens). ``kill`` is a subprocess SIGKILL or the in-process
        ``httpd.kill()`` tear — the seam doesn't care. Yields a stats
        dict (``fired``: kill count, ``at_tokens``: stream position
        it fired at, ``victim_traces``: trace_ids that were streaming
        off the victim when it died)."""
        stats = {"fired": 0, "at_tokens": None, "victim_traces": []}
        lock = threading.Lock()
        prev_stream = router._stream_interceptor
        prev_route = router._route_interceptor

        def fire(trace_id, n):
            with lock:
                if stats["fired"]:
                    return
                stats["fired"] = 1
                stats["at_tokens"] = n
            if trace_id is not None:
                stats["victim_traces"].append(trace_id)
            kill()

        def stream_seam(trace_id, rid, n):
            if prev_stream is not None:
                prev_stream(trace_id, rid, n)
            if mid_stream and rid == replica_id and n >= at:
                fire(trace_id, n)

        def route_seam(trace_id, rid, hop):
            if prev_route is not None:
                prev_route(trace_id, rid, hop)
            if not mid_stream and rid == replica_id:
                fire(trace_id, 0)

        router._stream_interceptor = stream_seam
        router._route_interceptor = route_seam
        try:
            yield stats
        finally:
            router._stream_interceptor = prev_stream
            router._route_interceptor = prev_route

    @staticmethod
    @contextlib.contextmanager
    def lease_lapse(registration, wait_s: Optional[float] = None):
        """Pause a replica's membership heartbeats WITHOUT leaving —
        the long-GC-pause / wedged-process fault. The lease expires
        (``worker_info`` goes None: the router treats it as an
        implicit drain and stops routing there) while the replica
        keeps serving whatever it already holds. On exit the
        heartbeats resume; the next tick re-joins (the registration's
        ``rejoins`` counter bumps) and the router re-admits. With
        ``wait_s`` the context sleeps that long after pausing so the
        lapse is guaranteed by the time the body runs."""
        registration.pause()
        if wait_s:
            time.sleep(wait_s)
        try:
            yield registration
        finally:
            registration.unpause()

    @staticmethod
    @contextlib.contextmanager
    def drain_during_burst(router, replica_id: str, after: int = 3,
                           timeout: Optional[float] = None):
        """Arm a drain-under-load: once the router has dispatched
        ``after`` requests (any replica), a side thread calls
        ``router.drain(replica_id)`` — new admissions shift to
        siblings while the drained replica's in-flight requests
        settle. Yields a stats dict (``drained``: the drain() result,
        set once it completes; ``dispatches``: dispatch count seen).
        Join happens on exit."""
        stats = {"drained": None, "dispatches": 0}
        fired = threading.Event()
        prev_route = router._route_interceptor

        def do_drain():
            stats["drained"] = router.drain(replica_id,
                                            timeout=timeout)

        thread = threading.Thread(target=do_drain, daemon=True,
                                  name="pt-fault-drain")

        def route_seam(trace_id, rid, hop):
            if prev_route is not None:
                prev_route(trace_id, rid, hop)
            stats["dispatches"] += 1
            if stats["dispatches"] >= after and not fired.is_set():
                fired.set()
                thread.start()

        router._route_interceptor = route_seam
        try:
            yield stats
        finally:
            router._route_interceptor = prev_route
            if fired.is_set():
                thread.join(timeout=30)

    # ------------------------------------------- (q) control-plane chaos
    @staticmethod
    @contextlib.contextmanager
    def kill_router(router, kill: Callable[[], None], at: int = 2,
                    mid_stream: bool = True):
        """Arm a one-shot kill of the ROUTER ITSELF — family (p)'s
        ``kill_replica`` one level up the plane. With ``mid_stream``
        the caller's ``kill()`` (the in-process router
        ``httpd.kill()`` tear, or a subprocess SIGKILL) fires the
        moment this router has relayed ``at`` tokens of ANY stream;
        without it, right before its next dispatch. Streaming clients
        see a torn NDJSON stream (no terminal record) and retry the
        same trace_id on a sibling router — the replica-side hop
        journal dedupes fleet-wide. Yields the same stats dict shape
        as ``kill_replica`` (``fired``, ``at_tokens``,
        ``victim_traces``)."""
        stats = {"fired": 0, "at_tokens": None, "victim_traces": []}
        lock = threading.Lock()
        prev_stream = router._stream_interceptor
        prev_route = router._route_interceptor

        def fire(trace_id, n):
            with lock:
                if stats["fired"]:
                    return
                stats["fired"] = 1
                stats["at_tokens"] = n
            if trace_id is not None:
                stats["victim_traces"].append(trace_id)
            kill()

        def stream_seam(trace_id, rid, n):
            if prev_stream is not None:
                prev_stream(trace_id, rid, n)
            if mid_stream and n >= at:
                fire(trace_id, n)

        def route_seam(trace_id, rid, hop):
            if prev_route is not None:
                prev_route(trace_id, rid, hop)
            if not mid_stream:
                fire(trace_id, 0)

        router._stream_interceptor = stream_seam
        router._route_interceptor = route_seam
        try:
            yield stats
        finally:
            router._stream_interceptor = prev_stream
            router._route_interceptor = prev_route

    @staticmethod
    @contextlib.contextmanager
    def coordinator_outage(target, for_s: Optional[float] = None):
        """Take the coordinator away WITHOUT touching its clients'
        work — every RPC through ``target.coordinator`` (or
        ``target.registry.coordinator``) raises ``OSError`` until the
        context exits: the outage a client must ride out on its
        last-known view instead of a mass leave. With ``for_s`` the
        context sleeps that long after cutting the wire so at least
        one poll has failed by the time the body runs. Yields the
        object whose coordinator was cut."""
        registry = getattr(target, "registry", target)
        if registry.coordinator is None:
            raise ValueError("no coordinator to take down")

        class _DownCoordinator:
            def __getattr__(self, name):
                def _down(*args, **kwargs):
                    raise OSError(
                        f"coordinator outage (injected): {name}")
                return _down

        real = registry.coordinator
        registry.coordinator = _DownCoordinator()
        if for_s:
            time.sleep(for_s)
        try:
            yield registry
        finally:
            registry.coordinator = real

    # ------------------------------------------ (o) sharded embeddings
    @staticmethod
    @contextlib.contextmanager
    def kill_shard(server, at: int = 0, window: str = "commit"):
        """Within the context, SIGKILL-twin an embedding shard at a
        chosen point (:meth:`EmbeddingShardServer.kill`: every in-flight
        and future RPC tears its connection with NO response; new
        connections are refused; no snapshot, no leave — the membership
        lease just lapses).

        window="commit": die inside the ``at``-th scatter-update's TORN
        WINDOW — after the WAL append is durable, before the table
        mutates or the ack is sent (the shard's ``_commit_interceptor``
        seam). This is the worst-case kill for exactly-once accounting:
        the replacement must REPLAY the entry and the client's retry of
        the same seq must come back ``dup``.

        window="rpc": die at the ``at``-th RPC of any kind (the
        server's ``_rpc_interceptor`` seam) — the request dies BEFORE
        any side effect; the retry applies cleanly on the replacement.

        Yields a stats dict (``killed_at``: the index it fired on, or
        None if never reached)."""
        from paddle_tpu_torch.embed.shard import ShardKilled
        stats = {"killed_at": None}
        if window == "commit":
            shard = server.shard
            prev = shard._commit_interceptor
            count = [0]

            def commit_seam(wal_seq):
                if prev is not None:
                    prev(wal_seq)
                i = count[0]
                count[0] += 1
                if i == at:
                    stats["killed_at"] = i
                    server.kill()
                    raise ShardKilled(
                        f"kill_shard: commit #{i} (WAL {wal_seq} "
                        "durable, ack never sent)")

            shard._commit_interceptor = commit_seam
            try:
                yield stats
            finally:
                shard._commit_interceptor = prev
        elif window == "rpc":
            prev = server._rpc_interceptor

            def rpc_seam(method, idx):
                if prev is not None:
                    prev(method, idx)
                if idx == at:
                    stats["killed_at"] = idx
                    server.kill()
                    raise ShardKilled(
                        f"kill_shard: rpc #{idx} ({method})")

            server._rpc_interceptor = rpc_seam
            try:
                yield stats
            finally:
                server._rpc_interceptor = prev
        else:
            raise ValueError(f"unknown kill window {window!r}")

    @staticmethod
    @contextlib.contextmanager
    def stale_read(client, age_s: float):
        """Within the context, every row in the client's bounded-
        staleness cache (present now or fetched later) reads as
        ``age_s`` seconds OLDER than it is — rows age past the bound
        deterministically instead of waiting wall-clock time. Against a
        LIVE shard this forces refetches (the bound doing its job);
        against a killed shard it forces stale SERVES, which must be
        journaled as ``embed/stale_read`` violations. Yields a stats
        dict (``aged``: entries rewritten so far)."""
        stats = {"aged": 0}
        lock = client._lock
        real_gather = client.gather

        def age_now():
            with lock:
                for k, (row, ts) in list(client._cache.items()):
                    client._cache[k] = (row, ts - age_s)
                    stats["aged"] += 1

        def gather(keys, max_stale_s=None):
            out = real_gather(keys, max_stale_s=max_stale_s)
            age_now()            # rows fetched by THIS call age too
            return out

        age_now()
        client.gather = gather
        try:
            yield stats
        finally:
            client.gather = real_gather

    @staticmethod
    @contextlib.contextmanager
    def slow_shard(server, ms: float, at: Iterable[int] = (),
                   every: bool = False):
        """Within the context, the shard's RPCs STALL ``ms``
        milliseconds before handling — chosen 0-based RPC indices, or
        every RPC (``every=True``): the deterministic straggler/hot-
        shard twin for tail-latency and timeout tests. Yields a stats
        dict (``slowed``: indices that stalled)."""
        indices = set(int(i) for i in at)
        stats = {"slowed": []}
        prev = server._rpc_interceptor

        def seam(method, idx):
            if prev is not None:
                prev(method, idx)
            if every or idx in indices:
                stats["slowed"].append(idx)
                time.sleep(ms / 1000.0)

        server._rpc_interceptor = seam
        try:
            yield stats
        finally:
            server._rpc_interceptor = prev

    # -------------------------------------------- (r) warm-start artifacts
    @staticmethod
    @contextlib.contextmanager
    def corrupt_artifact(store, name: Optional[str] = None,
                         mode: str = "payload"):
        """Damage one on-disk artifact — the torn-write / bit-rot /
        partial-copy fault the warm-start plane must DETECT and
        degrade past, never crash on. ``name`` picks the artifact (default:
        the newest); ``mode``:

        - ``payload``: flip one payload byte (crc catches it),
        - ``torn``: truncate mid-payload (a writer died without the
          atomic rename discipline — or the volume did),
        - ``magic``: clobber the frame magic (not an artifact at all).

        The contract under this fault: ``store.get`` returns None,
        counts a fallback, journals ``artifacts/fallback`` with
        ``reason="corrupt"`` — and the caller rebuilds the library
        (compile cache or ``nvcc``) and serves token-identically. Yields ``{"path", "mode"}``; the original
        bytes are restored on exit."""
        paths = [r["path"] for r in store.entries()
                 if name is None or r["name"] == f"{name}.ptaf"]
        if name is None and paths:
            paths = [max(paths, key=os.path.getmtime)]
        if not paths:
            raise ValueError(f"no artifact to corrupt "
                             f"(name={name!r}) in {store.root}")
        path = paths[0]
        with open(path, "rb") as f:
            original = f.read()
        if mode == "payload":
            blob = original[:-5] + bytes([original[-5] ^ 0xFF]) + \
                original[-4:]
        elif mode == "torn":
            blob = original[:max(9, len(original) // 2)]
        elif mode == "magic":
            blob = b"XXXX" + original[4:]
        else:
            raise ValueError(f"unknown mode {mode!r}")
        with open(path, "wb") as f:
            f.write(blob)
        try:
            yield {"path": path, "mode": mode}
        finally:
            with open(path, "wb") as f:
                f.write(original)

    @staticmethod
    @contextlib.contextmanager
    def stale_fingerprint(store, name: Optional[str] = None):
        """Rewrite one artifact as an INTERNALLY-CONSISTENT frame
        built for a different environment — the stale-artifact fault
        (the store survived a torch or CUDA upgrade; every byte is
        intact, the library is just for the wrong world: the JAX
        package doctors ``env["jax"]``, the port ``env["torch"]``). The
        frame passes magic/crc/digest re-derivation, so only the
        fingerprint comparison can catch it: ``store.get`` must
        return None with ``reason="stale"`` in the
        ``artifacts/fallback`` journal record. Yields ``{"path",
        "doctored_digest"}``; restored on exit."""
        import json as _json
        import struct as _struct
        import zlib as _zlib

        from paddle_tpu_torch.artifacts.fingerprint import Fingerprint
        from paddle_tpu_torch.artifacts.store import MAGIC

        paths = [r["path"] for r in store.entries()
                 if name is None or r["name"] == f"{name}.ptaf"]
        if name is None and paths:
            paths = [max(paths, key=os.path.getmtime)]
        if not paths:
            raise ValueError(f"no artifact to doctor "
                             f"(name={name!r}) in {store.root}")
        path = paths[0]
        with open(path, "rb") as f:
            original = f.read()
        (hlen,) = _struct.unpack("<I", original[4:8])
        header = _json.loads(original[8:8 + hlen])
        payload = original[8 + hlen:]
        fields = dict(header["fingerprint"])
        env = dict(fields.get("env") or {})
        env["torch"] = "0.0.0-doctored"
        fields["env"] = env
        doctored = Fingerprint(fields)
        header["fingerprint"] = doctored.fields
        header["digest"] = doctored.digest
        hbytes = _json.dumps(header, sort_keys=True).encode()
        blob = MAGIC + _struct.pack("<I", len(hbytes)) + hbytes + \
            payload
        assert _zlib.crc32(payload) & 0xFFFFFFFF == \
            header["payload_crc"]
        with open(path, "wb") as f:
            f.write(blob)
        try:
            yield {"path": path, "doctored_digest": doctored.digest}
        finally:
            with open(path, "wb") as f:
                f.write(original)

    @staticmethod
    def cache_race(store, name: str, fp, payloads, threads: int = 8,
                   timeout: float = 60.0) -> dict:
        """N writers publish the SAME artifact name concurrently — the
        fleet-cold-start thundering herd (every replica of a fresh
        rollout finishes its build at once and races to backfill).
        The atomic tmp+rename discipline must leave exactly one
        COMPLETE frame under the final name — readers never observe a
        partial file — and no writer may raise. Returns ``{"writes",
        "errors", "winner"}`` where ``winner`` is the surviving
        frame's inspect() row (``winner["ok"]`` is the assertion)."""
        results, errors = FaultPlan.burst(
            lambda i: store.put(name, fp, payloads[i % len(payloads)],
                                meta={"writer": i}),
            len(payloads), threads=threads, timeout=timeout)
        return {"writes": sum(1 for r in results if r is not None),
                "errors": [e for e in errors if e is not None],
                "winner": store.inspect(store.path(name))}

    @staticmethod
    def bursty_trace(seed: int = 0, ticks: int = 30, base: int = 1,
                     peak: int = 12, burst_start: int = 8,
                     burst_len: int = 8) -> list:
        """The canonical autoscaler chaos load shape: a per-tick
        request-count list — quiet (``base``±1), a hard spike to
        ``peak``±2 for ``burst_len`` ticks starting at
        ``burst_start``, then quiet again (the scale-DOWN window).
        Seeded jitter keeps it deterministic: same seed, same trace,
        same scaling decisions."""
        rng = random.Random(seed)
        out = []
        for t in range(int(ticks)):
            if burst_start <= t < burst_start + burst_len:
                lo, hi = max(1, peak - 2), peak + 2
            else:
                lo, hi = max(0, base - 1), base + 1
            out.append(rng.randint(lo, hi))
        return out
