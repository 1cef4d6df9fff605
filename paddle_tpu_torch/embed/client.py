"""EmbeddingClient — consistent-hash routing, bounded-staleness reads,
async-SGD sparse pushes.

The `ParameterClient2` side of the pserver pair: trainers (and the
serving path) talk to the sharded table through this one object.

- **Routing**: `shard_of(key)` — the same splitmix64 partition the
  shards use. Endpoints come either from a static list or from the
  coordinator MEMBERSHIP PLANE (`worker_info("embed/<sid>")`): a shard
  published its endpoint at join, a replacement re-publishes at rejoin,
  and the client re-resolves after any transport failure — failover is
  just "ask the directory again".
- **Bounded-staleness reads**: a row cache serves entries younger than
  `staleness_s` locally; older entries refetch. When a shard is DOWN
  past the retry deadline, a cached-but-stale row is served anyway —
  availability over freshness — and that VIOLATION is journaled
  (``embed/stale_read``) and counted: the 2017 pserver's
  `max_async_count` staleness bound, made observable.
- **Async push**: `push()` enqueues sparse (keys, grads); a worker
  thread (``pt-embed-push``) coalesces batches per shard and sends
  `scatter_update` with a per-shard monotonic ``seq``. The guard
  semantics of :meth:`AsyncSGDIsland.reconcile` apply row-wise at the
  source (`filter_finite_rows`); exactly-once lands at the shard: a
  transport failure retries the SAME seq against the re-resolved
  endpoint, and the shard's applied-seq ledger dedupes a batch whose
  WAL survived the kill.
"""

from __future__ import annotations

import threading
import time
import uuid
from http.client import HTTPException
from queue import Empty, Queue
from xmlrpc.client import ProtocolError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.parallel.async_sgd import filter_finite_rows
from paddle_tpu_torch.utils.stats import global_counters

from paddle_tpu_torch.embed.shard import _emit_embed, shard_of

__all__ = ["EmbeddingClient", "EmbedUnavailable"]


class EmbedUnavailable(RuntimeError):
    """A shard stayed unreachable past the retry deadline and no cached
    row could stand in."""


class EmbeddingClient:
    """Client for a hash-partitioned embedding store.

    num_shards/dim: table geometry (must match the shards').
    endpoints:     static ``{shard_id: "host:port"}`` map, or None to
                   resolve through ``coordinator``.
    coordinator:   a Coordinator (in-process) or CoordinatorServer proxy
                   (``connect(host, port)``) whose membership plane the
                   shards registered in.
    staleness_s:   the bounded-staleness read window — cached rows
                   younger than this serve locally; a DOWN shard makes
                   older rows serve anyway, journaled as violations.
    retry_deadline: seconds an RPC keeps retrying (with endpoint
                   re-resolution between attempts) before giving up.
    """

    def __init__(self, num_shards: int, dim: int, *,
                 endpoints: Optional[Dict[int, str]] = None,
                 coordinator: Any = None,
                 client_id: Optional[str] = None,
                 staleness_s: float = 30.0,
                 cache_capacity: int = 65536,
                 lr: float = 0.1,
                 retry_deadline: float = 10.0,
                 push_queue: int = 256):
        assert endpoints is not None or coordinator is not None, \
            "need a static endpoint map or a coordinator to resolve from"
        self.num_shards = int(num_shards)
        self.dim = int(dim)
        self.client_id = client_id or f"embc-{uuid.uuid4().hex[:8]}"
        self.staleness_s = float(staleness_s)
        self.cache_capacity = int(cache_capacity)
        self.lr = float(lr)
        self.retry_deadline = float(retry_deadline)
        self._coordinator = coordinator
        self._lock = named_lock("embed.client")
        self._endpoints: Dict[int, str] = dict(endpoints or {})  # ptlint: guarded-by(embed.client)
        self._cache: Dict[int, Tuple[np.ndarray, float]] = {}    # ptlint: guarded-by(embed.client)
        self._seq: Dict[int, int] = {}                           # ptlint: guarded-by(embed.client)
        self._inflight = 0                                       # ptlint: guarded-by(embed.client)
        self._gathers = 0                                        # ptlint: guarded-by(embed.client)
        self._gathered_rows = 0                                  # ptlint: guarded-by(embed.client)
        self._cache_hits = 0                                     # ptlint: guarded-by(embed.client)
        self._stale_serves = 0                                   # ptlint: guarded-by(embed.client)
        self._pushes = 0                                         # ptlint: guarded-by(embed.client)
        self._pushed_rows = 0                                    # ptlint: guarded-by(embed.client)
        self._dup_acks = 0                                       # ptlint: guarded-by(embed.client)
        self._push_failures = 0                                  # ptlint: guarded-by(embed.client)
        self._failovers = 0                                      # ptlint: guarded-by(embed.client)
        self._tls = threading.local()        # per-thread ServerProxy map
        from paddle_tpu_torch.embed.obs import track_client
        track_client(self)       # weakref: /metrics + flight bundles
        self._queue: Queue = Queue(maxsize=int(push_queue))
        self._stop = threading.Event()
        self._push_thread = threading.Thread(
            target=self._push_loop, daemon=True, name="pt-embed-push")
        self._push_thread.start()

    # ------------------------------------------------------------ transport
    def _resolve(self, shard_id: int, refresh: bool = False) -> str:
        with self._lock:
            ep = None if refresh else self._endpoints.get(shard_id)
        if ep is not None:
            return ep
        if self._coordinator is None:
            with self._lock:      # static map: nothing to re-resolve
                ep = self._endpoints.get(shard_id)
            if ep is None:
                raise EmbedUnavailable(
                    f"no endpoint for shard {shard_id}")
            return ep
        info = self._coordinator.worker_info(f"embed/{shard_id}")
        ep = (info or {}).get("endpoint")
        if not ep:
            raise LookupError(
                f"shard {shard_id} has no live membership lease")
        with self._lock:
            self._endpoints[shard_id] = ep
        return ep

    def _proxy(self, endpoint: str):
        from xmlrpc.client import ServerProxy
        cache = getattr(self._tls, "conns", None)
        if cache is None:
            cache = self._tls.conns = {}
        proxy = cache.get(endpoint)
        if proxy is None:
            proxy = cache[endpoint] = ServerProxy(
                f"http://{endpoint}", allow_none=True)
        return proxy

    def _drop_proxy(self, endpoint: str):
        cache = getattr(self._tls, "conns", None)
        if cache is not None:
            cache.pop(endpoint, None)

    def _call(self, shard_id: int, method: str, *args):
        """One RPC with transport-failure retry + endpoint re-resolution
        (failover): an unreachable/torn shard is retried — the SAME
        arguments, so a retried ``scatter_update`` carries the SAME seq
        and the shard's ledger dedupes it — until ``retry_deadline``."""
        deadline = time.monotonic() + self.retry_deadline
        delay = 0.05
        refresh = False
        while True:
            endpoint = None
            try:
                endpoint = self._resolve(shard_id, refresh=refresh)
                return getattr(self._proxy(endpoint), method)(*args)
            except (OSError, HTTPException, ProtocolError,
                    LookupError) as err:
                # OSError: refused/reset; HTTPException (incl.
                # ProtocolError/BadStatusLine): connection torn with no
                # response — the killed-mid-commit shape. LookupError:
                # the lease lapsed and no replacement joined yet.
                if endpoint is not None:
                    self._drop_proxy(endpoint)
                with self._lock:
                    self._failovers += 1
                refresh = True
                if time.monotonic() + delay > deadline:
                    raise EmbedUnavailable(
                        f"shard {shard_id} unreachable past "
                        f"{self.retry_deadline}s: {err!r}") from err
                time.sleep(delay)
                delay = min(delay * 2.0, 1.0)

    def _trace_id(self) -> str:
        from paddle_tpu_torch.obs import context as obs_context
        return obs_context.current().trace_id or obs_context.new_trace_id()

    # --------------------------------------------------------------- reads
    def gather(self, keys: Sequence[int],
               max_stale_s: Optional[float] = None) -> np.ndarray:
        """Batched row gather with the bounded-staleness cache.

        Returns [n, dim] f32 in key order. Rows cached within the
        staleness bound serve locally; the rest group into ONE RPC per
        owning shard. A shard down past the retry deadline serves from
        stale cache where possible (journaled violation, domain
        ``embed``), and raises :class:`EmbedUnavailable` only for keys
        with no cached row at all."""
        bound = self.staleness_s if max_stale_s is None else float(max_stale_s)
        keys = np.asarray(keys, np.int64)
        out = np.empty((len(keys), self.dim), np.float32)
        now = time.time()
        need: Dict[int, List[Tuple[int, int]]] = {}
        with self._lock:
            for i, k in enumerate(keys.tolist()):
                ent = self._cache.get(k)
                if ent is not None and now - ent[1] <= bound:
                    out[i] = ent[0]
                    self._cache_hits += 1
                else:
                    need.setdefault(
                        shard_of(k, self.num_shards), []).append((i, k))
        trace_id = self._trace_id()
        from xmlrpc.client import Binary
        for sid, items in sorted(need.items()):
            blob = Binary(np.array([k for _, k in items],
                                   "<i8").tobytes())
            try:
                resp = self._call(sid, "gather", blob, trace_id)
            except EmbedUnavailable:
                self._serve_stale(sid, items, out, bound, trace_id)
                continue
            rows = np.frombuffer(resp["rows"].data, "<f4").reshape(
                len(items), self.dim)
            fetched = time.time()
            with self._lock:
                for (i, k), row in zip(items, rows):
                    out[i] = row
                    self._cache[k] = (row.copy(), fetched)
                self._gathers += 1
                self._gathered_rows += len(items)
                self._evict_locked()
        return out

    def _serve_stale(self, shard_id: int, items, out, bound: float,
                     trace_id: str):
        """Availability over freshness: the shard is down — serve the
        stale cached rows we do have, journal the staleness-bound
        violation, and raise only for rows nobody ever cached."""
        now = time.time()
        ages: List[float] = []
        missing: List[int] = []
        with self._lock:
            for i, k in items:
                ent = self._cache.get(k)
                if ent is None:
                    missing.append(k)
                else:
                    out[i] = ent[0]
                    ages.append(now - ent[1])
            self._stale_serves += len(ages)
        if ages:
            global_counters.bump("embed/stale_serves", len(ages))
            _emit_embed("stale_read", shard_id=shard_id,
                        rows=len(ages), age_s=round(max(ages), 3),
                        bound_s=bound, trace_id=trace_id)
        if missing:
            raise EmbedUnavailable(
                f"shard {shard_id} is down and {len(missing)} row(s) "
                f"(e.g. key {missing[0]}) have no cached value")

    def _evict_locked(self):
        if len(self._cache) <= self.cache_capacity:
            return
        # drop the oldest ~12% by fetch time — cheap clock sweep
        n_drop = max(1, len(self._cache) // 8)
        for k in sorted(self._cache, key=lambda k: self._cache[k][1])[:n_drop]:
            del self._cache[k]

    # -------------------------------------------------------------- writes
    def push(self, keys: Sequence[int], grads: np.ndarray,
             lr: Optional[float] = None):
        """Queue one sparse gradient batch for async apply. Non-finite
        rows are dropped at the source (reconcile guard); cached copies
        of the pushed keys are invalidated so the next gather observes
        the update."""
        keys = np.asarray(keys, np.int64)
        grads = np.asarray(grads, np.float32).reshape(len(keys), self.dim)
        keys, grads = filter_finite_rows(
            keys, grads, counter="embed/poisoned_rows")
        lr = self.lr if lr is None else float(lr)
        with self._lock:
            for k in keys.tolist():
                self._cache.pop(k, None)
            self._inflight += 1
        self._queue.put((keys, grads, lr))

    def _push_loop(self):
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except Empty:
                continue
            batch = [item]
            while len(batch) < 32:           # coalesce what's already queued
                try:
                    batch.append(self._queue.get_nowait())
                except Empty:
                    break
            try:
                self._send_batch(batch)
            except Exception as err:  # noqa: BLE001 — a server Fault
                # (protocol bug, geometry mismatch) must not kill the
                # push worker; it is counted + journaled and the worker
                # lives on for the next batch
                with self._lock:
                    self._push_failures += 1
                global_counters.bump("embed/push_failures")
                _emit_embed("push_failed", error=repr(err)[:200])

    def _send_batch(self, batch):
        from xmlrpc.client import Binary
        # group rows by (owning shard, lr); concatenation preserves
        # duplicate keys — the shard applies row-by-row, so dup keys
        # accumulate exactly as separate pushes would
        groups: Dict[Tuple[int, float], List[Tuple[np.ndarray, np.ndarray]]] = {}
        for keys, grads, lr in batch:
            sids = np.array([shard_of(k, self.num_shards)
                             for k in keys.tolist()])
            for sid in np.unique(sids):
                m = sids == sid
                groups.setdefault((int(sid), lr), []).append(
                    (keys[m], grads[m]))
        trace_id = self._trace_id()
        try:
            for (sid, lr), parts in sorted(groups.items()):
                keys = np.concatenate([k for k, _ in parts])
                grads = np.concatenate([g for _, g in parts])
                with self._lock:
                    seq = self._seq.get(sid, 0) + 1
                try:
                    res = self._call(
                        sid, "scatter_update", self.client_id, int(seq),
                        Binary(keys.astype("<i8").tobytes()),
                        Binary(grads.astype("<f4").tobytes()),
                        float(lr), trace_id)
                except EmbedUnavailable:
                    with self._lock:
                        self._push_failures += 1
                    global_counters.bump("embed/push_failures")
                    _emit_embed("push_failed", shard_id=sid,
                                rows=int(len(keys)), seq=int(seq),
                                trace_id=trace_id)
                    continue
                with self._lock:
                    self._seq[sid] = seq
                    self._pushes += 1
                    self._pushed_rows += len(keys)
                    if res.get("dup"):
                        # the first attempt's WAL survived a kill; the
                        # retry deduped — exactly-once held
                        self._dup_acks += 1
        finally:
            with self._lock:
                self._inflight -= len(batch)

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued push has been acked (or failed
        terminally). True when drained."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                drained = self._inflight == 0
            if drained and self._queue.empty():
                return True
            time.sleep(0.01)
        return False

    # ------------------------------------------------------------ lifecycle
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"client_id": self.client_id,
                    "num_shards": self.num_shards,
                    "cached_rows": len(self._cache),
                    "gathers": self._gathers,
                    "gathered_rows": self._gathered_rows,
                    "cache_hits": self._cache_hits,
                    "stale_serves": self._stale_serves,
                    "pushes": self._pushes,
                    "pushed_rows": self._pushed_rows,
                    "dup_acks": self._dup_acks,
                    "push_failures": self._push_failures,
                    "failovers": self._failovers,
                    "inflight": self._inflight}

    def close(self, timeout: float = 5.0):
        """Drain and stop the push worker (R5 lifecycle)."""
        self.flush(timeout=timeout)
        self._stop.set()
        self._push_thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
