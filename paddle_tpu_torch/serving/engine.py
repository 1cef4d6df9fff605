"""Continuous-batching decode engine over a paged KV cache — the port of
``paddle_tpu/serving/engine.py``.

- ``PagePool``: a host-side REFCOUNTED free-list over the preallocated
  device page pools ([L, n_pages, page_size, g, dh] —
  models/decode.PagedDecoder). Admission is a pages-free check, not a
  worst-case-length reservation. A page may be owned by several slots
  AND the prefix trie at once; it returns to the free list only at
  refcount zero.
- ``DecodeEngine``: a persistent decode loop over a FIXED slot batch.
  Each iteration feeds every active slot its next token (prompt tokens
  teacher-forced first — prefill interleaves with other slots'
  decoding), runs ONE paged step on the device, and does the host
  bookkeeping: requests join free slots mid-flight, finished /
  cancelled / expired requests free their pages immediately, and
  page-pool exhaustion first reclaims cold prefix-cache pages, then
  PREEMPTS the youngest request (pages back to the pool, request
  re-queued; greedy decode replays prompt + generated tokens, so its
  final output is unchanged).
- Admission control by FREE KV PAGES: a request the pool could never
  hold is rejected outright (``kv_capacity``); the queue head only
  takes a slot when enough NOVEL pages are free to reach its first new
  token (shared-prefix pages are free to attach); the wait queue
  itself is bounded (``queue_full``).
- Shared-prefix KV reuse (serving/prefix.py) with copy-on-write on
  divergence inside a page.
- Speculative decoding (``draft=``, ``spec_k``): a small draft
  (models/decode.DraftDecoder) proposes up to k tokens per slot; the
  target verifies them in the same [S, W] paged step it uses for
  prefill chunks (W = spec_k + 1 fixed at construction). Greedy token
  identity is the acceptance rule, so output is token-exact against
  the dense decoder; rejected rows are dead weight the kv_len mask
  never reads and the next feed overwrites.
- The two-tier KV plane: ``kv_quant="int8"`` pools (the dequant path of
  the window kernel) and ``kv_spill_pages``, a host-RAM store
  (serving/spill.py) that cold trie pages spill to instead of being
  freed and restore from on the next prefix match.

``stats()`` exports KV-page occupancy, slot utilization, per-token
latency percentiles, prefix-hit, speculation and spill accounting and
the scheduling counters; serving/http.py re-exports them as Prometheus
gauges on GET /metrics, alongside the ``paddle_tpu_prefix_*`` /
``paddle_tpu_spec_*`` / ``paddle_tpu_kv_*`` families registered here.

The engine reports through the obs plane (obs/) under the JAX
engine's names: flight-recorder marks for a request's whole chain
(``engine/submit``, ``engine/admit``, ``engine/prefix_attach``, one
``engine/slot_step`` a slot-step, ``engine/settle``), journal events
(``engine`` domain: preemption, prefix_evict, page_spill,
page_restore, spill_integrity, cow_copy_failure, draft_failure,
step_failure), a flight state provider (its slots and wait queue by
trace_id), its page pool on the profiler's memory sampler, each step
on ``PROFILER.on_step("decode")`` with a FLOP-counted cost source, and
an SLO-watchdog source (``stats()`` plus a derived ``tokens_per_s``).
``drain_admission()`` / ``resume_admission()`` stop and re-open
admission while in-flight requests keep stepping.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.analysis.lockdep import named_condition, named_lock
from paddle_tpu_torch.artifacts import EXECUTABLES
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.obs.flight import FLIGHT
from paddle_tpu_torch.obs.metrics import REGISTRY as _METRICS
from paddle_tpu_torch.obs.profile import PROFILER, cost_of
from paddle_tpu_torch.serving.prefix import PrefixIndex
from paddle_tpu_torch.serving.spill import SpillEntry, SpillStore
from paddle_tpu_torch.serving.server import (Expired, Rejected,
                                             ServerClosed, ServingError,
                                             percentile)
from paddle_tpu_torch.utils.stats import global_counters, stat_timer

log = logging.getLogger(__name__)

# /metrics families of the prefix cache, speculation and the two-tier
# KV plane — the JAX engine's names and help texts (idempotent: the
# registry returns the existing family on re-registration)
_PREFIX_HIT = _METRICS.counter(
    "paddle_tpu_prefix_hit_pages",
    "KV pages attached from the shared-prefix index instead of "
    "recomputed")
_PREFIX_MISS = _METRICS.counter(
    "paddle_tpu_prefix_miss_pages",
    "prompt pages admitted with no shared-prefix match")
_PREFIX_COW = _METRICS.counter(
    "paddle_tpu_prefix_cow_copies",
    "copy-on-write page copies on intra-page prefix divergence")
_PREFIX_SHARED = _METRICS.gauge(
    "paddle_tpu_prefix_shared_pages",
    "physical pages currently referenced by more than one owner")
_SPEC_PROPOSED = _METRICS.counter(
    "paddle_tpu_spec_proposed_tokens_total",
    "draft-model tokens proposed for target verification")
_SPEC_ACCEPTED = _METRICS.counter(
    "paddle_tpu_spec_accepted_tokens_total",
    "draft proposals the target model accepted (greedy token match)")
_SPILL_PAGES = _METRICS.counter(
    "paddle_tpu_kv_pages_spilled_total",
    "cold prefix-cache pages spilled device->host instead of freed")
_SPILL_RESTORED = _METRICS.counter(
    "paddle_tpu_kv_pages_restored_total",
    "spilled pages restored host->device on a prefix match, before "
    "prefill was charged")
_SPILL_INTEGRITY = _METRICS.counter(
    "paddle_tpu_kv_spill_integrity_drops_total",
    "spill entries dropped on checksum mismatch or transfer failure "
    "— a torn page degrades to a prefix miss, never a restore")
_SPILLED_NOW = _METRICS.gauge(
    "paddle_tpu_kv_pages_spilled_now",
    "pages currently resident in the host-RAM spill tier")


class PagePool:
    """Host-side refcounted allocator over the device page pools.

    Physical page 0 is RESERVED as the null page (inactive slots write
    there; unassigned page-table entries point there) and is never
    handed out. ``alloc()`` hands a page out at refcount 1; the prefix
    trie and additional slots take further refs with ``ref()``;
    ``free()`` decrements and only returns the page to the free list
    at zero. Freeing a page that holds no refs raises — refcount
    UNDERFLOWS are as loud as double frees."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need the null page + one real, got "
                             f"{num_pages}")
        self.num_pages = int(num_pages)
        self.usable = self.num_pages - 1
        self._lock = named_lock("serving.pagepool")
        # pop() hands out page 1 first — deterministic layouts in tests
        self._free_list = list(range(self.num_pages - 1, 0, -1))
        self._allocated: set = set()
        self._refs: Dict[int, int] = {}
        self.high_water = 0

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free_list)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return len(self._allocated)

    @property
    def shared_pages(self) -> int:
        with self._lock:
            return sum(1 for c in self._refs.values() if c > 1)

    def alloc(self) -> Optional[int]:
        with self._lock:
            if not self._free_list:
                return None
            p = self._free_list.pop()
            self._allocated.add(p)
            self._refs[p] = 1
            self.high_water = max(self.high_water, len(self._allocated))
            return p

    def ref(self, page: int) -> None:
        """Take one more reference on an allocated page (a slot
        attaching a shared prefix page, the trie indexing a slot's
        page, a CoW-source pin)."""
        with self._lock:
            if page not in self._allocated:
                raise ValueError(
                    f"page {page} ref'd but not allocated — the "
                    "refcount plumbing lost track of it")
            self._refs[page] += 1

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def refcount_histogram(self) -> Dict[int, int]:
        """{refcount: page count} over the allocated pages — the flight
        bundle's picture of the sharing."""
        with self._lock:
            hist: Dict[int, int] = {}
            for c in self._refs.values():
                hist[c] = hist.get(c, 0) + 1
            return hist

    def free(self, pages) -> None:
        with self._lock:
            for p in pages:
                if p not in self._allocated:
                    raise ValueError(
                        f"page {p} returned to the pool but not "
                        "allocated — double free, refcount underflow "
                        "or foreign page id")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._allocated.discard(p)
                    self._free_list.append(p)

    def accounting(self) -> dict:
        with self._lock:
            return {"total_usable": self.usable,
                    "free": len(self._free_list),
                    "allocated": len(self._allocated),
                    "leaked": self.usable - len(self._free_list)
                    - len(self._allocated),
                    "refs_total": sum(self._refs.values()),
                    "shared": sum(1 for c in self._refs.values()
                                  if c > 1),
                    "high_water": self.high_water}


class GenRequest:
    """Future-like handle for one generation request.

    ``get()`` blocks for completion and returns the generated token ids
    (including the eos token when one stopped it). A CANCELLED request
    settles with the tokens generated so far. Deadline expiry / server
    shutdown settle with the typed serving errors. ``cancel()`` is safe
    from any thread at any time; the engine observes it at the next
    iteration and returns the request's pages to the pool."""

    def __init__(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int], deadline: Optional[float],
                 now: float, trace_id: Optional[str] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline = deadline          # absolute time.monotonic()
        self.trace_id = trace_id or obs_context.new_trace_id()
        self.tokens: List[int] = []
        self.state = "waiting"  # waiting|running|done|cancelled|failed
        self.error: Optional[ServingError] = None
        self.done = threading.Event()
        self.submitted_at = now
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.evictions = 0
        self.prefix_hit_pages = 0
        self.accepted_tokens = 0
        self._cancelled = False

    @property
    def num_generated(self) -> int:
        return len(self.tokens)

    def cancel(self) -> None:
        self._cancelled = True

    def get(self, timeout: Optional[float] = None) -> List[int]:
        if timeout is None and self.deadline is not None:
            timeout = max(self.deadline - time.monotonic(), 0.0) + 0.25
        if not self.done.wait(timeout):
            raise Expired("generation still in flight past its "
                          "deadline/timeout")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class _Slot:
    """Host bookkeeping for one occupied decode slot."""

    __slots__ = ("req", "replay", "pos", "pages", "arrival", "last_tok",
                 "last_token_t", "draft_pos")

    def __init__(self, req: GenRequest, arrival: int):
        self.req = req
        # prompt + already-generated tokens: teacher-forced back through
        # the step on (re-)admission, so an evicted request's greedy
        # continuation is exactly what it would have produced unevicted
        self.replay = req.prompt + req.tokens
        self.pos = 0                     # next position to feed
        self.pages: List[int] = []
        self.arrival = arrival
        self.last_tok = 0
        self.last_token_t: Optional[float] = None
        # committed tokens already teacher-forced through the DRAFT
        # cache lane (speculative decoding); rolled back past rejected
        # proposals every verify
        self.draft_pos = 0

    def next_input(self) -> int:
        if self.pos < len(self.replay):
            return self.replay[self.pos]
        return self.last_tok


class DecodeEngine:
    """Persistent continuous-batching decode loop (see module doc).

    ``decoder`` is a models.TransformerDecoder (the dense reference
    path); the engine builds its PagedDecoder twin over the same
    parameter table, on the decoder's device. ``num_pages`` defaults
    to full capacity (every slot can reach ``max_seq_len``) — size it
    SMALLER to serve more slots than worst-case memory would allow and
    let preemption absorb the tail. ``prefix_cache`` toggles
    shared-prefix KV reuse. ``draft``/``spec_k`` turn on speculative
    decoding (a second, smaller TransformerDecoder on the same device
    proposing ``spec_k`` tokens per step — greedy only).
    ``kv_quant="int8"`` stores the pages in int8 with per-row scales;
    ``kv_spill_pages`` > 0 attaches a host-RAM spill store of that many
    pages behind the prefix cache. ``generator`` (a
    ``torch.Generator`` on the decoder's device) drives sampling when
    ``temperature`` is set. ``warm_start`` (default on) resolves the
    decoders' kernel libraries through the artifact plane's warm
    ladder (paddle_tpu_torch/artifacts: in-process cache, artifact
    store, then the compile cache or ``nvcc``); off, the store is not
    read and the compile cache alone serves.

    Drive it synchronously (``step()`` / ``run()`` — deterministic, the
    test/bench mode) or as a background thread (``start()`` /
    ``shutdown()`` — the serving mode; InferenceServer wires this)."""

    def __init__(self, decoder, *, num_slots: int = 4,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 max_waiting: int = 64,
                 temperature: Optional[float] = None,
                 latency_window: int = 2048,
                 draft=None, spec_k: int = 0,
                 prefix_cache: bool = True,
                 kv_quant: Optional[str] = None,
                 kv_spill_pages: int = 0,
                 generator=None,
                 warm_start: bool = True):
        pos_rows = decoder.p[f"_{decoder.name}_pos_emb.w0"].shape[0]
        if max_seq_len is None:
            max_seq_len = pos_rows
        self.max_seq_len = min(int(max_seq_len), pos_rows)
        self.page_size = int(page_size)
        self.num_slots = int(num_slots)
        self.spec_k = max(int(spec_k), 0) if draft is not None else 0
        if self.spec_k and temperature is not None:
            raise ValueError(
                "speculative decoding is greedy-only: the acceptance "
                "rule is token identity, which sampling breaks")
        # W = spec_k + 1: one pending token + k proposals per step,
        # fixed at construction
        self.window = 1 + self.spec_k
        pages_per_slot = -(-self.max_seq_len // self.page_size)
        if num_pages is None:
            num_pages = self.num_slots * pages_per_slot + 1
        self.kv_quant = kv_quant
        self.warm_start = bool(warm_start)
        self.paged = decoder.paged(
            num_slots=self.num_slots, page_size=self.page_size,
            num_pages=int(num_pages), max_pages_per_slot=pages_per_slot,
            temperature=temperature, window=self.window,
            kv_quant=kv_quant, warm_start=self.warm_start)
        self.pool = PagePool(int(num_pages))
        self.k_pool, self.v_pool = self.paged.init_pools()
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(self.pool, self.page_size) if prefix_cache
            else None)
        if kv_spill_pages and not prefix_cache:
            raise ValueError(
                "kv_spill_pages needs the prefix cache: spilled pages "
                "are keyed and restored by their trie token path")
        self.spill: Optional[SpillStore] = (
            SpillStore(int(kv_spill_pages)) if kv_spill_pages else None)
        # test seam: called at the "read" and "commit" stages of every
        # spill with (stage, token path, page), so a test can crash a
        # spill between its stages and check the ordering contract
        self._spill_interceptor: Optional[
            Callable[[str, tuple, int], None]] = None
        self.draft = None
        if draft is not None and self.spec_k > 0:
            from paddle_tpu_torch.models.decode import DraftDecoder
            self.draft = DraftDecoder(
                draft, num_slots=self.num_slots,
                max_seq_len=self.max_seq_len, window=self.window,
                warm_start=self.warm_start)
            self._draft_kc, self._draft_vc = self.draft.init_caches()
        self.max_waiting = int(max_waiting)
        self.temperature = temperature
        self.generator = generator
        S, P, W = self.num_slots, pages_per_slot, self.window
        self.slots: List[Optional[_Slot]] = [None] * S
        self._tokens = np.zeros((S, W), np.int32)
        self._positions = np.zeros((S, W), np.int32)
        self._tables = np.zeros((S, P), np.int32)
        self._active = np.zeros((S, W), np.bool_)
        self._waiting: deque = deque()
        self._cv = named_condition("serving.engine")
        self._accepting = True
        self._stopping = False
        self._close_now = False
        self._thread: Optional[threading.Thread] = None
        # test seam: called with the step index at the top of every
        # step(), before reap and admit — where a concurrent client's
        # submit or cancel would land (testing/faults.py decode_script)
        self._step_interceptor: Optional[Callable[[int], None]] = None
        self._steps = 0
        self._arrival_seq = 0
        self._active_steps_sum = 0
        self._cache_tokens_read = 0
        self._lat: deque = deque(maxlen=int(latency_window))
        self._ttft: deque = deque(maxlen=256)
        self.last_step_error: Optional[str] = None
        self._counters = {"submitted": 0, "finished": 0, "cancelled": 0,
                          "expired": 0, "preemptions": 0,
                          "rejected_queue": 0, "rejected_capacity": 0,
                          "closed": 0, "step_failures": 0,
                          "tokens_out": 0, "prefill_tokens": 0,
                          "spec_proposed_tokens": 0,
                          "spec_accepted_tokens": 0,
                          "draft_failures": 0,
                          "kv_pages_spilled": 0,
                          "kv_pages_restored": 0,
                          "kv_spill_integrity_drops": 0,
                          "kv_spill_cleared": 0}
        self._register_obs()

    def _register_obs(self) -> None:
        """Wire the engine into the obs plane: a flight-bundle state
        provider (the slot table and wait queue by trace_id), its page
        pool on the profiler's memory sampler, a FLOP-counted cost
        source for the decode step, and an SLO-watchdog source. Every
        closure holds the engine by weakref, so a dead engine never
        pins itself in the process-global recorders."""
        ref = weakref.ref(self)
        tag = f"engine-{id(self):x}"

        def _flight_state():
            eng = ref()
            if eng is None:
                return None
            slots = [
                None if sl is None else
                {"trace_id": sl.req.trace_id, "pos": sl.pos,
                 "generated": sl.req.num_generated,
                 "pages": len(sl.pages)}
                for sl in list(eng.slots)]
            with eng._cv:
                waiting = [r.trace_id for r in eng._waiting]
                steps = eng._steps
            # prefix summary AFTER _cv release: lock order is
            # engine -> prefix -> pagepool, never held together here
            prefix = eng.prefix.summary() \
                if eng.prefix is not None else None
            return {"slots": slots, "waiting_trace_ids": waiting,
                    "steps": steps,
                    "pages": eng.pool.accounting(),
                    "prefix": prefix}

        FLIGHT.register_state_provider(tag, _flight_state)

        def _pool_accounting():
            eng = ref()
            return None if eng is None else eng.pool.accounting()

        PROFILER.register_pool(tag, _pool_accounting)

        def _decode_cost():
            eng = ref()
            return (None, None) if eng is None else eng.decode_cost()

        PROFILER.set_cost_source("decode", _decode_cost)

        rate_state = {"t": None, "tokens": 0}

        def _slo_stats():
            eng = ref()
            if eng is None:
                return None
            s = eng.stats()
            now = time.monotonic()
            t0, tok0 = rate_state["t"], rate_state["tokens"]
            tokens = s.get("tokens_out", 0)
            rate_state["t"], rate_state["tokens"] = now, tokens
            if t0 is not None and now > t0:
                s["tokens_per_s"] = (tokens - tok0) / (now - t0)
            return s

        from paddle_tpu_torch.obs.slo import WATCHDOG
        WATCHDOG.add_source(tag, _slo_stats)

    def decode_cost(self):
        """(FLOPs, None) of one target step, counted under
        ``FlopCounterMode`` on an all-inactive step (inactive slots
        write only the reserved null page, so the pools are untouched;
        the step's products are as wide as any step's). The hand kernel
        counts nothing, so the count is a lower bound. Runs on the
        stepping thread (the profiler calls it from ``on_step``)."""
        S, W = self.num_slots, self.window
        z = np.zeros((S, W), np.int32)
        inactive = np.zeros((S, W), np.bool_)

        def one():
            _, self.k_pool, self.v_pool = self.paged.step(
                self.k_pool, self.v_pool, z, z, self._tables, inactive)

        return cost_of(one)

    # ------------------------------------------------------------ admission
    def _pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def _retry_hint(self) -> float:
        lats = list(self._lat)
        per_tok = (sum(lats) / len(lats)) if lats else 0.005
        return max(per_tok * self.page_size, 0.01)

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None,
               trace_id: Optional[str] = None) -> GenRequest:
        """Admit one generation request. Raises the serving-typed
        errors at admission (``Rejected`` reasons: ``kv_capacity`` for
        a request the pool could NEVER hold, ``queue_full`` for a
        saturated wait queue; ``ServerClosed`` when draining); the
        request itself settles with tokens or a typed error.
        ``deadline`` is relative, in seconds. ``trace_id`` correlates
        the request through admission, slot, every decode step and
        settle (minted here when the front passed none)."""
        now = time.monotonic()
        trace_id = trace_id or obs_context.current().trace_id \
            or obs_context.new_trace_id()
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt or int(max_new_tokens) < 1:
            raise ValueError("need a non-empty prompt and "
                             "max_new_tokens >= 1")
        total = len(prompt) + int(max_new_tokens)
        abs_deadline = (time.monotonic() + deadline) \
            if deadline is not None else None
        with self._cv:
            if not self._accepting:
                raise ServerClosed("decode engine is draining or "
                                   "stopped")
            if total > self.max_seq_len or \
                    self._pages_for(total) > self.pool.usable:
                self._counters["rejected_capacity"] += 1
                FLIGHT.record("mark", "engine/reject",
                              trace_id=trace_id, reason="kv_capacity")
                raise Rejected(
                    f"request needs {total} positions "
                    f"({self._pages_for(total)} KV pages) but the "
                    f"engine serves at most {self.max_seq_len} "
                    f"positions / {self.pool.usable} pages — it can "
                    "never be scheduled; shorten it",
                    retry_after=0.0, reason="kv_capacity")
            if len(self._waiting) >= self.max_waiting:
                self._counters["rejected_queue"] += 1
                retry = self._retry_hint()
                FLIGHT.record("mark", "engine/reject",
                              trace_id=trace_id, reason="queue_full")
                raise Rejected(
                    f"generation queue full ({self.max_waiting}); "
                    f"retry in {retry:.2f}s", retry_after=retry,
                    reason="queue_full")
            req = GenRequest(prompt, max_new_tokens, eos_id,
                             abs_deadline, now, trace_id=trace_id)
            self._counters["submitted"] += 1
            self._waiting.append(req)
            self._cv.notify_all()
        FLIGHT.record("mark", "engine/submit", trace_id=trace_id,
                      prompt_len=len(prompt),
                      max_new=int(max_new_tokens))
        return req

    # ------------------------------------------------------------ scheduling
    def _settle(self, req: GenRequest, state: str,
                error: Optional[ServingError] = None) -> None:
        req.state = state
        req.error = error
        req.finished_at = time.monotonic()
        req.done.set()

    def _index_slot_pages(self, slot: _Slot) -> None:
        """Leave the slot's COMPLETE teacher-forced pages behind in the
        prefix index (finish AND evict paths). Only rows the slot has
        actually FED are covered — ``seq[:pos]`` excludes the
        not-yet-fed pending token."""
        if self.prefix is None or not slot.pages:
            return
        seq = slot.req.prompt + slot.req.tokens
        self.prefix.insert(seq[:slot.pos], slot.pages)

    def _clear_slot(self, s: int) -> None:
        self._tables[s, :] = 0
        self._active[s, :] = False
        self._tokens[s, :] = 0
        self._positions[s, :] = 0
        self.slots[s] = None

    def _finish(self, s: int, state: str,
                error: Optional[ServingError] = None) -> None:
        """Release slot ``s``: pages to the prefix index then back to
        the pool FIRST (the no-leak invariant), then settle the
        request."""
        slot = self.slots[s]
        if state in ("done", "cancelled"):
            # failed/closed slots may hold garbage KV (step failure) —
            # never index those pages
            self._index_slot_pages(slot)
        self.pool.free(slot.pages)
        slot.pages = []
        self._clear_slot(s)
        counter = {"done": "finished", "cancelled": "cancelled",
                   "failed": "failed", "closed": "closed"}.get(state)
        with self._cv:
            if state == "done":
                self._counters["finished"] += 1
            elif state == "cancelled":
                self._counters["cancelled"] += 1
            elif isinstance(error, Expired):
                self._counters["expired"] += 1
            elif isinstance(error, ServerClosed):
                self._counters["closed"] += 1
        if counter:
            global_counters.bump(f"serving/decode_{counter}")
        FLIGHT.record("mark", "engine/settle",
                      trace_id=slot.req.trace_id, state=state,
                      slot=s, generated=slot.req.num_generated,
                      error=repr(error)[:200] if error else None)
        self._settle(slot.req, state, error)
        with self._cv:
            self._cv.notify_all()

    def _evict(self, s: int) -> None:
        """Preempt slot ``s``: complete pages into the prefix index
        (re-admission walks them right back), refs to the pool, request
        back to the FRONT of the wait queue (it keeps its generated
        tokens and replays them on re-admission — greedy output is
        unchanged)."""
        slot = self.slots[s]
        self._index_slot_pages(slot)
        self.pool.free(slot.pages)
        slot.pages = []
        self._clear_slot(s)
        req = slot.req
        req.state = "waiting"
        req.evictions += 1
        with self._cv:
            self._counters["preemptions"] += 1
        global_counters.bump("serving/decode_preemptions")
        journal_emit("engine", "preemption",
                     generated=req.num_generated,
                     evictions=req.evictions,
                     free_pages=self.pool.free_pages,
                     trace_id=req.trace_id)
        with self._cv:
            self._waiting.appendleft(req)

    def _reap(self, now: float) -> None:
        """Settle cancellations and deadline expiries — running slots
        and waiting requests both."""
        for s in range(self.num_slots):
            slot = self.slots[s]
            if slot is None:
                continue
            if slot.req._cancelled:
                self._finish(s, "cancelled")
            elif slot.req.deadline is not None and \
                    now > slot.req.deadline:
                self._finish(s, "failed", Expired(
                    f"deadline passed after {slot.req.num_generated} "
                    "generated tokens"))
        with self._cv:
            keep = deque()
            for req in self._waiting:
                if req._cancelled:
                    self._counters["cancelled"] += 1
                    FLIGHT.record("mark", "engine/settle",
                                  trace_id=req.trace_id,
                                  state="cancelled", where="waiting")
                    self._settle(req, "cancelled")
                elif req.deadline is not None and now > req.deadline:
                    self._counters["expired"] += 1
                    FLIGHT.record("mark", "engine/settle",
                                  trace_id=req.trace_id,
                                  state="expired", where="waiting")
                    self._settle(req, "failed", Expired(
                        "deadline passed while queued for a slot"))
                else:
                    keep.append(req)
            self._waiting = keep

    def _alloc_page(self) -> Optional[int]:
        """One page from the pool, reclaiming cold prefix-cache leaves
        (LRU, trie-only refcount) when the free list is dry — the trie
        gives pages back BEFORE any running request is preempted. With
        a spill store attached, cold pages go device->host
        (:meth:`_spill_cold_pages`) instead of being destroyed; the
        lossy ``evict_lru`` path stays the fallback when spilling frees
        nothing (no candidates, or a failed device read)."""
        page = self.pool.alloc()
        while page is None and self.prefix is not None:
            if self.spill is not None and self._spill_cold_pages(1):
                page = self.pool.alloc()
                continue
            freed = self.prefix.evict_lru(1)
            if not freed:
                return None
            journal_emit("engine", "prefix_evict", pages=freed,
                         free_pages=self.pool.free_pages,
                         engine_step=self._steps)
            page = self.pool.alloc()
        return page

    # ------------------------------------------------------------- spill
    @staticmethod
    def _flatten_page(tag: str, tree, out: dict) -> None:
        """Pool page -> named host arrays (float pools are bare
        tensors; int8 pools are {"q", "s"} dicts). bfloat16 has no
        numpy type, so its bits travel as int16."""
        def host(t):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return t.numpy()

        if isinstance(tree, dict):
            for kk in sorted(tree):
                out[f"{tag}.{kk}"] = host(tree[kk])
        else:
            out[tag] = host(tree)

    @staticmethod
    def _unflatten_page(tag: str, like, payload: dict):
        """Inverse of :meth:`_flatten_page`, shaped like the pool
        ``like`` (host tensors; ``write_page`` moves them)."""
        def dev(arr, leaf):
            return torch.from_numpy(np.ascontiguousarray(arr)) \
                .view(leaf.dtype)

        if isinstance(like, dict):
            return {kk: dev(payload[f"{tag}.{kk}"], like[kk])
                    for kk in like}
        return dev(payload[tag], like)

    def _spill_cold_pages(self, n: int, avoid=None) -> int:
        """Spill up to ``n`` cold trie-only pages to the host store,
        in the crash-safety order of serving/spill.py: read +
        checksum first (no state changed), THEN evict the node and
        free the device page, THEN commit the entry — a crash at any
        point leaves the accounting balanced and never leaves a page
        both device-owned and host-stored.

        ``avoid`` (a token tuple) skips candidates on that path — the
        restore path passes the replay it is extending, so making room
        never spills the very match it restores into."""
        freed = 0
        cands = self.prefix.spill_candidates(
            n if avoid is None else n + 8)
        for path, page in cands:
            if freed >= n:
                break
            if avoid is not None and avoid[:len(path)] == path:
                continue
            hook = self._spill_interceptor
            if hook is not None:
                hook("read", path, page)
            try:
                payload: dict = {}
                k_page, v_page = self.paged.read_page(
                    self.k_pool, self.v_pool, page)
                self._flatten_page("k", k_page, payload)
                self._flatten_page("v", v_page, payload)
                entry = SpillEntry(payload)
            # a failed device read falls back to the lossy evict path:
            # the serving loop must not die for a cache optimization
            except Exception as e:  # noqa: BLE001
                log.exception("KV page spill read failed")
                self._counters["kv_spill_integrity_drops"] += 1
                _SPILL_INTEGRITY.inc()
                journal_emit("engine", "spill_integrity",
                             reason="read_failed",
                             error=repr(e)[:200], page=page,
                             engine_step=self._steps)
                return freed
            if self.prefix.evict_exact(path) is None:
                continue               # node changed under us — skip
            if hook is not None:
                hook("commit", path, page)
            self.spill.put(path, entry)
            freed += 1
            self._counters["kv_pages_spilled"] += 1
            _SPILL_PAGES.inc()
            journal_emit("engine", "page_spill", page=page,
                         key_pages=len(path) // self.page_size,
                         spilled_now=len(self.spill),
                         free_pages=self.pool.free_pages,
                         engine_step=self._steps)
        return freed

    def _restore_spilled(self, replay) -> int:
        """Walk ``replay``'s token path past the trie match and restore
        consecutive spilled pages host->device BEFORE admission charges
        prefill. Each restore allocates a device page (which may
        cascade-spill colder pages), verifies the entry's checksum,
        uploads, and re-inserts the trie node; a torn entry is dropped
        so the lookup degrades to a prefix miss."""
        ps = self.page_size
        limit = len(replay) - 1
        restored = 0
        avoid = tuple(int(t) for t in replay)
        while True:
            match = self.prefix.match(replay)
            nxt = match.matched + ps
            if nxt > limit:
                break
            key = avoid[:nxt]
            if not self.spill.has(key):
                break
            # make room by spilling colder OTHER branches only — never
            # the lossy evict path (destroying cache to restore cache)
            # and never this replay's own match (the ``avoid`` guard)
            page = self.pool.alloc()
            while page is None:
                if not self._spill_cold_pages(1, avoid=avoid):
                    break
                page = self.pool.alloc()
            if page is None:
                break                  # pool truly full — stay spilled
            entry = self.spill.pop(key)
            if entry is None:
                self.pool.free([page])
                break
            if not entry.verify():
                self.pool.free([page])
                self.spill.dropped_integrity += 1
                self._counters["kv_spill_integrity_drops"] += 1
                _SPILL_INTEGRITY.inc()
                journal_emit("engine", "spill_integrity",
                             reason="crc_mismatch",
                             key_pages=nxt // ps,
                             engine_step=self._steps)
                break
            try:
                k_page = self._unflatten_page("k", self.k_pool,
                                              entry.payload)
                v_page = self._unflatten_page("v", self.v_pool,
                                              entry.payload)
                self.k_pool, self.v_pool = self.paged.write_page(
                    self.k_pool, self.v_pool, k_page, v_page, page)
            # a failed upload degrades to a prefix miss — it never
            # kills admission
            except Exception as e:  # noqa: BLE001
                log.exception("KV page restore failed")
                self.pool.free([page])
                self.spill.dropped_integrity += 1
                self._counters["kv_spill_integrity_drops"] += 1
                _SPILL_INTEGRITY.inc()
                journal_emit("engine", "spill_integrity",
                             reason="restore_write_failed",
                             error=repr(e)[:200], page=page,
                             engine_step=self._steps)
                break
            # the trie takes the page over: insert refs it (2), dropping
            # our alloc ref leaves it trie-only (1) — exactly the state
            # it was spilled from
            self.prefix.insert(key, match.pages + [page])
            self.pool.free([page])
            self.spill.restored_count += 1
            restored += 1
            self._counters["kv_pages_restored"] += 1
            _SPILL_RESTORED.inc()
            journal_emit("engine", "page_restore", page=page,
                         key_pages=nxt // ps,
                         spilled_now=len(self.spill),
                         engine_step=self._steps)
        return restored

    def _attach_prefix(self, s: int, slot: _Slot, match) -> None:
        """Wire a PrefixMatch into slot ``s``: one slot ref per shared
        page, copy-on-write for an intra-page divergence, and the
        slot's feed position jumps past every matched token."""
        req = slot.req
        for p in match.pages:
            self.pool.ref(p)
            slot.pages.append(p)
        matched = match.matched
        if match.cow is not None:
            src, rows = match.cow
            # pin the source: the dst alloc below may reclaim trie
            # leaves, and the source IS a refcount-1 leaf right now
            self.pool.ref(src)
            dst = self._alloc_page()
            if dst is not None:
                try:
                    self.k_pool, self.v_pool = self.paged.copy_page(
                        self.k_pool, self.v_pool, src, dst)
                # a failed copy degrades to recomputing the tail rows
                except Exception as e:  # noqa: BLE001
                    self.pool.free([dst])
                    journal_emit("engine", "cow_copy_failure",
                                 error=repr(e)[:200],
                                 trace_id=req.trace_id)
                else:
                    slot.pages.append(dst)
                    matched += rows
                    _PREFIX_COW.inc()
                    self.prefix.cow_hits += 1
            self.pool.free([src])       # unpin
        for j, p in enumerate(slot.pages):
            self._tables[s, j] = p
        slot.pos = matched
        hit = len(match.pages)
        miss = self._pages_for(len(slot.replay)) - hit
        if hit:
            _PREFIX_HIT.inc(hit)
        if miss > 0:
            _PREFIX_MISS.inc(miss)
        self.prefix.hit_pages += hit
        self.prefix.miss_pages += max(miss, 0)
        req.prefix_hit_pages = hit
        if matched:
            FLIGHT.record("mark", "engine/prefix_attach",
                          trace_id=req.trace_id, slot=s,
                          shared_pages=hit, matched_tokens=matched,
                          cow=match.cow is not None)

    def _admit(self) -> None:
        """Waiting -> free slots, gated on FREE PAGES: the queue head
        takes a slot only when the pool can carry its NOVEL pages to
        its first new token — shared-prefix pages cost nothing, and
        reclaimable trie leaves count as free (minus the pages this
        very match would pin)."""
        with self._cv:
            for s in range(self.num_slots):
                if self.slots[s] is not None or not self._waiting:
                    continue
                req = self._waiting[0]
                replay = req.prompt + req.tokens
                if self.spill is not None and len(self.spill):
                    # spill-hit path: restored pages join the match
                    # below, so admission charges only what is novel
                    # beyond both tiers
                    self._restore_spilled(replay)
                match = self.prefix.match(replay) \
                    if self.prefix is not None else None
                shared = len(match.pages) if match is not None else 0
                need_now = self._pages_for(len(replay) + 1) - shared
                avail = self.pool.free_pages
                if self.prefix is not None:
                    avail += max(
                        0, self.prefix.reclaimable_pages() - shared)
                if need_now > avail:
                    break              # page-aware: head waits for pages
                self._waiting.popleft()
                req.state = "running"
                self._arrival_seq += 1
                slot = _Slot(req, self._arrival_seq)
                self.slots[s] = slot
                if match is not None and \
                        (match.pages or match.cow is not None):
                    self._attach_prefix(s, slot, match)
                FLIGHT.record("mark", "engine/admit",
                              trace_id=req.trace_id, slot=s,
                              replay=len(replay),
                              prefix_tokens=slot.pos)

    def _ensure_pages(self, plan: Dict[int, List[int]]) -> None:
        """Allocate each planned slot's pages through the LAST position
        its window will write; on pool exhaustion reclaim trie leaves
        first, then preempt the YOUNGEST slot (LIFO — oldest requests
        keep their progress) until the allocation succeeds."""
        for s in sorted(
                (i for i in range(self.num_slots)
                 if self.slots[i] is not None and i in plan),
                key=lambda i: self.slots[i].arrival):
            slot = self.slots[s]
            if slot is None:           # evicted by an earlier iteration
                continue
            last = slot.pos + len(plan[s]) - 1
            while len(slot.pages) * self.page_size <= last:
                page = self._alloc_page()
                if page is None:
                    victims = sorted(
                        (i for i in range(self.num_slots)
                         if self.slots[i] is not None),
                        key=lambda i: -self.slots[i].arrival)
                    self._evict(victims[0])
                    if self.slots[s] is None:
                        break          # evicted ourselves
                    continue
                slot.pages.append(page)
                self._tables[s, len(slot.pages) - 1] = page

    # ----------------------------------------------------------- speculation
    def _draft_propose(self, active_idx: List[int]) -> Dict[int, List[int]]:
        """Run the draft model for up to spec_k proposals per caught-up
        slot: bounded rounds of the draft's own [S, W] step, each round
        teacher-forcing committed tokens the draft has not seen (up to
        W per round) or chaining one proposal. Slots still prefilling
        the TARGET are skipped — their draft lanes catch up across
        later steps, W tokens a round."""
        if self.draft is None:
            return {}
        S, W = self.num_slots, self.window
        props: Dict[int, List[int]] = {}
        want: Dict[int, int] = {}
        for s in active_idx:
            slot = self.slots[s]
            if slot.pos < len(slot.replay) - 1:
                continue               # target still prefilling
            req = slot.req
            seq_len = len(req.prompt) + len(req.tokens)
            k_eff = min(self.spec_k,
                        req.max_new - req.num_generated - 1,
                        self.max_seq_len - 1 - slot.pos,
                        self.max_seq_len + 1 - seq_len)
            if k_eff > 0:
                props[s] = []
                want[s] = k_eff
        if not props:
            return {}
        toks = np.zeros((S, W), np.int32)
        poss = np.zeros((S, W), np.int32)
        act = np.zeros((S, W), np.bool_)
        for _ in range(self.spec_k + 2):
            toks[:, :] = 0
            poss[:, :] = 0
            act[:, :] = False
            fed: Dict[int, int] = {}   # slot -> tokens fed this round
            for s, got in props.items():
                slot = self.slots[s]
                if len(got) >= want[s]:
                    continue
                seq = slot.req.prompt + slot.req.tokens
                dp = slot.draft_pos
                if dp < len(seq):      # catch-up: feed a committed chunk
                    c = min(W, len(seq) - dp)
                    toks[s, :c] = seq[dp:dp + c]
                else:                  # chain: feed the last proposal
                    c = 1
                    toks[s, 0] = got[-1]
                poss[s, :c] = np.arange(dp, dp + c)
                act[s, :c] = True
                fed[s] = c
            if not fed:
                break
            try:
                out, self._draft_kc, self._draft_vc = self.draft.step(
                    self._draft_kc, self._draft_vc, toks, poss, act)
            # a draft failure must not kill the serving loop: the target
            # path continues unassisted
            except Exception as e:  # noqa: BLE001
                log.exception("draft step failed")
                self._counters["draft_failures"] += 1
                journal_emit("engine", "draft_failure",
                             error=repr(e)[:400],
                             engine_step=self._steps)
                self._draft_kc, self._draft_vc = self.draft.init_caches()
                for s in props:
                    if self.slots[s] is not None:
                        self.slots[s].draft_pos = 0
                return {}
            for s, c in fed.items():
                slot = self.slots[s]
                seq_len = len(slot.req.prompt) + len(slot.req.tokens)
                slot.draft_pos += c
                if slot.draft_pos >= seq_len:
                    # the last fed row predicts the next token: the
                    # first/next proposal of the chain
                    props[s].append(int(out[s, c - 1]))
        return {s: p for s, p in props.items() if p}

    # ------------------------------------------------------------- the loop
    def step(self) -> bool:
        """One engine iteration: reap, admit, draft-propose, window-
        plan, page-ensure, ONE device step, bookkeep. Returns True iff
        a device step ran. Single-threaded by contract: the engine
        thread in serving mode, the caller in sync mode."""
        interceptor = self._step_interceptor
        if interceptor is not None:
            interceptor(self._steps)
        self._reap(time.monotonic())
        self._admit()
        active_idx = [s for s in range(self.num_slots)
                      if self.slots[s] is not None]
        if not active_idx:
            return False
        props = self._draft_propose(active_idx)
        # window plan: a replay chunk (multi-token prefill) or the
        # pending token + the draft's proposals (speculative verify)
        W = self.window
        plan: Dict[int, List[int]] = {}
        for s in active_idx:
            slot = self.slots[s]
            if slot.pos < len(slot.replay) - 1:
                wlen = min(W, len(slot.replay) - slot.pos)
                plan[s] = slot.replay[slot.pos:slot.pos + wlen]
            else:
                p_s = props.get(s, [])[:W - 1]
                room = self.max_seq_len - 1 - slot.pos
                plan[s] = [slot.next_input()] + p_s[:max(room, 0)]
        self._ensure_pages(plan)
        live = [s for s in active_idx
                if self.slots[s] is not None and s in plan]
        if not live:
            return False
        self._active[:, :] = False
        self._tokens[:, :] = 0
        self._positions[:, :] = 0
        for s in live:
            slot = self.slots[s]
            w = len(plan[s])
            self._tokens[s, :w] = plan[s]
            self._positions[s, :w] = np.arange(slot.pos, slot.pos + w)
            self._active[s, :w] = True
        try:
            with stat_timer("serving/decode_step"):
                nxt, self.k_pool, self.v_pool = self.paged.step(
                    self.k_pool, self.v_pool, self._tokens,
                    self._positions, self._tables, self._active,
                    generator=self.generator)
        # serving boundary: in-flight requests settle typed and the pools
        # rebuild; the engine thread must never die
        except Exception as e:  # noqa: BLE001
            log.exception("decode step failed")
            self._recover_from_step_failure(e)
            return False
        t_after = time.monotonic()
        with self._cv:
            self._steps += 1
            self._active_steps_sum += len(live)
        if PROFILER.enabled:
            PROFILER.on_step("decode")
        for s in live:
            slot = self.slots[s]
            toks = plan[s]
            w = len(toks)
            fed = slot.pos
            req = slot.req
            # one compact flight record per slot-step: the "each decode
            # step" link of the request's trace chain — a postmortem
            # bundle reconstructs the request's schedule by trace_id
            FLIGHT.record("mark", "engine/slot_step",
                          trace_id=req.trace_id,
                          engine_step=self._steps, slot=s, pos=fed,
                          width=w)
            with self._cv:
                self._cache_tokens_read += sum(
                    fed + j + 1 for j in range(w))
            if fed < len(slot.replay) - 1:
                # replay chunk: all rows teacher-forced; the last row
                # commits one token iff it reached the replay tail
                commits: List[int] = []
                n_prefill = min(w, len(slot.replay) - 1 - fed)
                with self._cv:
                    self._counters["prefill_tokens"] += n_prefill
                slot.pos = fed + w
                if fed + w == len(slot.replay):
                    commits = [int(nxt[s, w - 1])]
            else:
                # speculative verify: outs[j] is the target's choice
                # after feeding tokens 0..j. Proposal j (toks[j+1]) is
                # accepted iff it IS that choice; the first rejection
                # ends the run and its row becomes dead weight the
                # kv_len mask never reads.
                m = w - 1
                outs = [int(nxt[s, j]) for j in range(w)]
                commits = [outs[0]]
                a = 0
                while a < m and toks[a + 1] == commits[-1]:
                    commits.append(outs[a + 1])
                    a += 1
                if m:
                    with self._cv:
                        self._counters["spec_proposed_tokens"] += m
                        self._counters["spec_accepted_tokens"] += a
                    _SPEC_PROPOSED.inc(m)
                    if a:
                        _SPEC_ACCEPTED.inc(a)
                    req.accepted_tokens += a
                seq_before = len(req.prompt) + len(req.tokens)
                slot.draft_pos = min(slot.draft_pos, seq_before + a)
            if not commits:
                continue
            done = False
            n_commit = 0
            with self._cv:
                if req.first_token_at is None:
                    req.first_token_at = t_after
                    self._ttft.append(t_after - req.submitted_at)
                dt = (t_after - slot.last_token_t) \
                    if slot.last_token_t is not None else None
                slot.last_token_t = t_after
                for tok in commits:
                    req.tokens.append(tok)
                    slot.last_tok = tok
                    n_commit += 1
                    self._counters["tokens_out"] += 1
                    if (req.eos_id is not None and tok == req.eos_id) \
                            or req.num_generated >= req.max_new:
                        done = True
                        break
                if dt is not None:
                    for _ in range(n_commit):
                        self._lat.append(dt / n_commit)
            global_counters.bump("serving/decode_tokens", n_commit)
            if fed >= len(slot.replay) - 1:
                # keep only the fed rows that match the committed
                # sequence: pending token + (n_commit - 1) accepted
                slot.pos = fed + n_commit
                slot.draft_pos = min(slot.draft_pos, fed + n_commit)
            if done:
                self._finish(s, "done")
        return True

    def _recover_from_step_failure(self, exc: Exception) -> None:
        """A failed step may have left the pools half-written: settle
        everything in flight with a typed error, then rebuild pools +
        free-list + prefix index + spill store + draft caches so fresh
        traffic can still be served."""
        in_flight = [self.slots[s].req.trace_id
                     for s in range(self.num_slots)
                     if self.slots[s] is not None]
        with self._cv:
            self._counters["step_failures"] += 1
            waiting_ids = [r.trace_id for r in self._waiting]
        self.last_step_error = repr(exc)
        err = ServingError(f"decode step failed: {exc}")
        for s in range(self.num_slots):
            if self.slots[s] is not None:
                self._finish(s, "failed", err)
        with self._cv:
            while self._waiting:
                req = self._waiting.popleft()
                FLIGHT.record("mark", "engine/settle",
                              trace_id=req.trace_id, state="failed",
                              where="waiting")
                self._settle(req, "failed", err)
        self.k_pool, self.v_pool = self.paged.init_pools()
        self.pool = PagePool(self.pool.num_pages)
        if self.prefix is not None:
            # the trie indexed pages of the DEAD pool: forget them all
            # and repoint at the rebuilt allocator
            self.prefix.reset()
            self.prefix.pool = self.pool
        if self.spill is not None:
            # host entries were carved from the dead trie — never
            # restore across a rebuild
            self._counters["kv_spill_cleared"] += self.spill.clear()
        if self.draft is not None:
            self._draft_kc, self._draft_vc = self.draft.init_caches()
        self._tables[:, :] = 0
        self._active[:, :] = False
        # journaled AFTER the typed settles so the auto-dumped bundle
        # (obs/flight.py trigger) holds each victim's whole chain —
        # submit, admit, every slot_step, settle(failed) — plus this
        # record naming the in-flight trace ids at fault time
        journal_emit("engine", "step_failure", error=repr(exc)[:400],
                     trace_ids=in_flight, waiting_trace_ids=waiting_ids,
                     engine_step=self._steps)

    def _has_work(self) -> bool:
        return any(s is not None for s in self.slots) or \
            bool(self._waiting)

    def run(self, timeout: float = 120.0) -> None:
        """Synchronous drive: step until every submitted request has
        settled (the deterministic test/bench mode)."""
        deadline = time.monotonic() + timeout
        while self._has_work():
            self.step()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"engine did not drain within {timeout}s "
                    f"({self.stats()})")

    # ------------------------------------------------------------ lifecycle
    @property
    def accepting(self) -> bool:
        with self._cv:
            return self._accepting

    def warmup(self) -> dict:
        """Resolve the decoders' kernel libraries NOW, before any
        request is admitted — the artifact plane's engine hook — then
        one all-inactive step (target, and draft when speculating):
        inactive slots write only the reserved null page / null row, so
        the pools are semantically untouched, and the first request
        never pays the one-time costs (kernel build or store load,
        cuBLAS handles, the allocator's first blocks, and with the
        profiler on its step count under ``FlopCounterMode``). With a
        warm artifact store the call runs no ``nvcc``. Returns the
        in-process cache's stats and ``warm_start``."""
        self.paged.load_kernels()
        if self.draft is not None:
            self.draft.load_kernels()
        S, W = self.num_slots, self.window
        z = np.zeros((S, W), np.int32)
        inactive = np.zeros((S, W), np.bool_)
        _, self.k_pool, self.v_pool = self.paged.step(
            self.k_pool, self.v_pool, z, z, self._tables, inactive)
        if self.draft is not None:
            _, self._draft_kc, self._draft_vc = self.draft.step(
                self._draft_kc, self._draft_vc, z, z, inactive)
        PROFILER.resolve_cost("decode")
        return dict(EXECUTABLES.stats(), warm_start=self.warm_start)

    def start(self) -> "DecodeEngine":
        with self._cv:
            if self._thread is not None:
                return self
            self._stopping = False
            self._accepting = True
            t = threading.Thread(target=self._loop,
                                 name="pt-serve-decode", daemon=True)
            self._thread = t
            t.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._close_now:
                    break
                if not self._has_work():
                    if self._stopping:
                        return
                    self._cv.wait(0.05)
                    continue
            self.step()
        self._close_all()

    def _close_all(self) -> None:
        """Settle everything in flight with ServerClosed and return
        every page — runs on the STEPPING thread, so it never races a
        step."""
        for s in range(self.num_slots):
            if self.slots[s] is not None:
                self._finish(s, "failed", ServerClosed(
                    "engine shut down mid-generation"))
        with self._cv:
            while self._waiting:
                req = self._waiting.popleft()
                self._counters["closed"] += 1
                self._settle(req, "failed", ServerClosed(
                    "engine shut down before this request ran"))

    def drain_admission(self) -> None:
        """Deploy-drain: stop ADMITTING (submit raises ServerClosed)
        while the loop keeps stepping everything already in flight —
        the engine's leg of ``POST /admin/drain``. Reversible via
        :meth:`resume_admission`; a full stop stays :meth:`shutdown`."""
        with self._cv:
            self._accepting = False

    def resume_admission(self) -> None:
        """Re-open admission after :meth:`drain_admission` (no-op on a
        stopping engine)."""
        with self._cv:
            if not self._stopping:
                self._accepting = True
                self._cv.notify_all()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 30.0) -> None:
        """Stop accepting. With ``drain`` in-flight generation
        completes; without it everything settles ServerClosed and the
        pages return to the pool immediately."""
        with self._cv:
            self._accepting = False
            self._close_now = self._close_now or not drain
            self._stopping = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
            with self._cv:
                self._thread = None
        elif drain:
            self.run(timeout=timeout if timeout is not None else 120.0)
        else:
            self._close_all()

    # ------------------------------------------------------------ snapshots
    def page_accounting(self) -> dict:
        """Pool truth vs slot + trie holdings: ``leaked`` is 0 always,
        and ``refs_total`` == ``held_by_slots`` + ``held_by_trie``
        (zero refcount underflows). With a spill store the dict grows
        the host tier (``spilled``, ``spill_capacity``, ``spill_puts``
        ...), whose invariant is conservation: puts == restores +
        integrity drops + LRU drops + recovery clears + superseded
        entries + still-resident entries."""
        acc = self.pool.accounting()
        acc["held_by_slots"] = sum(
            len(s.pages) for s in self.slots if s is not None)
        acc["held_by_trie"] = self.prefix.page_count() \
            if self.prefix is not None else 0
        if self.spill is not None:
            acc.update(self.spill.accounting())
            acc["spill_cleared"] = self._counters["kv_spill_cleared"]
        else:
            acc["spilled"] = 0
            acc["spill_capacity"] = 0
        return acc

    def stats(self) -> dict:
        with self._cv:
            counters = dict(self._counters)
            lat = list(self._lat)
            ttft = list(self._ttft)
            waiting = len(self._waiting)
            steps = self._steps
            active_sum = self._active_steps_sum
            cache_read = self._cache_tokens_read
        active = sum(1 for s in self.slots if s is not None)
        util = (active_sum / (steps * self.num_slots)) if steps else 0.0
        shared = self.pool.shared_pages
        _PREFIX_SHARED.set(shared)
        spilled_now = len(self.spill) if self.spill is not None else 0
        spill_cap = self.spill.capacity if self.spill is not None else 0
        _SPILLED_NOW.set(spilled_now)
        out = dict(counters)
        px = self.prefix
        out.update({
            # the trie owns the cumulative prefix accounting; the
            # engine's evictions are the lossy LRU ones (spills count
            # under kv_pages_spilled)
            "prefix_hit_pages": px.hit_pages if px is not None else 0,
            "prefix_miss_pages": px.miss_pages if px is not None else 0,
            "prefix_cow_copies": px.cow_hits if px is not None else 0,
            "prefix_evicted_pages":
                px.evicted_lru_pages if px is not None else 0,
            "slots": self.num_slots,
            "active_slots": active,
            "waiting": waiting,
            "slot_utilization": round(util, 4),
            "kv_pages_total": self.pool.usable,
            "kv_pages_free": self.pool.free_pages,
            "kv_pages_used": self.pool.used_pages,
            "kv_pages_shared": shared,
            "kv_pages_leaked": self.pool.accounting()["leaked"],
            "kv_pages_reclaimable": self.prefix.reclaimable_pages()
            if self.prefix is not None else 0,
            "kv_page_high_water": self.pool.high_water,
            "kv_pages_spilled_now": spilled_now,
            "kv_spill_capacity": spill_cap,
            "kv_spill_headroom": max(0, spill_cap - spilled_now),
            "kv_quant": self.kv_quant or "none",
            "kv_quant_bits": 8 if self.kv_quant == "int8" else
            torch.empty((), dtype=self.paged.dtype).element_size() * 8,
            "page_size": self.page_size,
            "window": self.window,
            "spec_k": self.spec_k,
            "prefix_nodes": self.prefix.page_count()
            if self.prefix is not None else 0,
            "steps": steps,
            "active_slot_steps": active_sum,
            "cache_tokens_read": cache_read,
            "token_latency_p50_ms":
                round(percentile(lat, 0.50) * 1e3, 3),
            "token_latency_p99_ms":
                round(percentile(lat, 0.99) * 1e3, 3),
            "ttft_p50_ms": round(percentile(ttft, 0.50) * 1e3, 3),
        })
        return out
