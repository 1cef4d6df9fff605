"""Fleet placement: KV-headroom accounting + prefix-affinity index —
the port of ``paddle_tpu/fleet/balance.py`` (pure host code: the same
keys and the same choices on the same scrapes).

Two decisions live here, both pure data structures the Router drives:

- **Admission by aggregate KV-page headroom.** Every replica's decode
  engine already exports its page-pool occupancy
  (``paddle_tpu_serving_engine_kv_pages_total`` / ``_free`` on GET
  /metrics); the router scrapes those gauges into
  :class:`ReplicaState` and admits by FLEET capacity: a request whose
  page count exceeds every replica's ``kv_pages_total`` can NEVER be
  scheduled anywhere and is rejected typed
  (``Rejected(reason="fleet_kv_capacity")``); one that merely finds
  every pool momentarily full is queueable — the router waits and
  re-scrapes instead of bouncing the client.

- **Prefix-affinity placement.** The per-replica prefix cache
  (serving/prefix.py) only pays off if requests sharing a
  system-prompt/few-shot prefix LAND on the replica whose trie already
  holds those pages. :class:`AffinityIndex` is the router-side radix
  twin: keyed by hashes of page-aligned token tuples (exactly
  serving/prefix.py's node keying — ``tuple(toks[i:i+page_size])``
  runs starting at position 0, capped at ``len(toks)-1`` so the match
  can never cover the final query token), it remembers which replica
  last served each prefix path and steers the next request with the
  deepest match there. Replica choice falls back to
  least-loaded-by-KV-headroom (most free pages) when no prefix is
  known — and the index is ADVICE only: a dead/draining/full replica
  is never chosen just because it is affine.

Only hashes of token runs are kept (not the tokens), bounded by an LRU
over nodes — the router's memory stays O(distinct hot prefixes), not
O(traffic).
"""

from __future__ import annotations

import hashlib
import struct
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from paddle_tpu_torch.analysis.lockdep import named_lock

__all__ = ["AffinityIndex", "FleetBalancer", "ReplicaState",
           "rendezvous_choose", "stable_prefix_key"]


def stable_prefix_key(tokens: Sequence[int],
                      page_size: int) -> Optional[bytes]:
    """The consistent-hashing key for a prompt: a digest of its FIRST
    page-aligned token run (capped at len-1, like AffinityIndex._keys
    — the final token is always a query). Deterministic across
    processes (blake2b over the raw token values — no PYTHONHASHSEED
    exposure), so N independent routers cut the IDENTICAL key from the
    same prompt. One page is the right granularity: every request
    sharing at least a page of prefix (same system prompt / few-shot
    header) maps to the same key and therefore the same home replica.
    None when the prompt has no complete page to key on."""
    ps = max(1, int(page_size))
    if ps > len(tokens) - 1:
        return None
    h = hashlib.blake2b(digest_size=8)
    for t in tokens[:ps]:
        h.update(struct.pack("<q", int(t)))
    return h.digest()


def rendezvous_choose(key: bytes,
                      replica_ids: Iterable[str]) -> Optional[str]:
    """Highest-random-weight (rendezvous) hash: every router ranks
    (key, replica) pairs identically, so the same prompt routes to the
    same replica on EVERY router with no shared state — and when the
    winner dies only its keys move (minimal disruption), unlike a
    mod-N ring. Ties are impossible in practice (64-bit digests) but
    break deterministically by replica id."""
    best_rid, best_rank = None, None
    for rid in replica_ids:
        rank = hashlib.blake2b(key + str(rid).encode("utf-8"),
                               digest_size=8).digest()
        if best_rank is None or (rank, str(rid)) > best_rank:
            best_rank = (rank, str(rid))
            best_rid = rid
    return best_rid


class ReplicaState:
    """One replica's scrape-derived placement state (router-side)."""

    __slots__ = ("replica_id", "endpoint", "live", "draining",
                 "kv_pages_total", "kv_pages_free", "page_size",
                 "kv_pages_reclaimable", "kv_spill_headroom",
                 "kv_pages_spilled_now",
                 "inflight", "last_scrape", "scrape_failures")

    def __init__(self, replica_id: str, endpoint: str):
        self.replica_id = replica_id
        self.endpoint = endpoint
        self.live = True
        self.draining = False
        self.kv_pages_total = 0      # 0 until the first scrape lands
        self.kv_pages_free = 0
        self.page_size = 0
        # the two-tier spill gauges (0 on single-tier replicas):
        # reclaimable trie pages, spill slots left, host-resident pages
        self.kv_pages_reclaimable = 0
        self.kv_spill_headroom = 0
        self.kv_pages_spilled_now = 0
        self.inflight = 0            # router-dispatched, not yet settled
        self.last_scrape = 0.0
        self.scrape_failures = 0

    def routable(self) -> bool:
        return self.live and not self.draining

    def lossless_headroom(self) -> int:
        """Pages this replica can yield WITHOUT destroying cache: the
        raw free list plus the reclaimable trie pages its spill store
        still has room for (those route host-ward and restore on the
        next prefix match, instead of being evicted lossily).
        ``kv_pages_free`` already includes ALL reclaimable pages — the
        admission headroom — so this subtracts the part the spill
        store could not catch."""
        losable = max(0, self.kv_pages_reclaimable
                      - self.kv_spill_headroom)
        return max(0, self.kv_pages_free - losable)

    def as_dict(self) -> dict:
        return {"replica_id": self.replica_id, "endpoint": self.endpoint,
                "live": self.live, "draining": self.draining,
                "kv_pages_total": self.kv_pages_total,
                "kv_pages_free": self.kv_pages_free,
                "kv_pages_reclaimable": self.kv_pages_reclaimable,
                "kv_spill_headroom": self.kv_spill_headroom,
                "kv_pages_spilled_now": self.kv_pages_spilled_now,
                "page_size": self.page_size, "inflight": self.inflight,
                "scrape_failures": self.scrape_failures}


class AffinityIndex:
    """Radix index of prompt prefixes -> last replica to serve them.

    Nodes are hashes of the chain of page-aligned token tuples — the
    same page-granularity walk serving/prefix.py performs, so a depth-k
    match here predicts (>=) k pages of prefix-cache hit on the affine
    replica. Bounded by ``max_nodes`` with LRU eviction."""

    def __init__(self, page_size: int = 16, max_nodes: int = 65536):
        self.page_size = int(page_size)
        self.max_nodes = int(max_nodes)
        self._lock = named_lock("fleet.affinity")
        # key -> (replica_id, lru_seq)   # ptlint: guarded-by(fleet.affinity)
        self._nodes: Dict[int, Tuple[str, int]] = {}
        self._seq = 0                  # ptlint: guarded-by(fleet.affinity)

    def _keys(self, tokens: Sequence[int]) -> List[int]:
        """The hash chain of page-aligned runs — node i covers tokens
        [0, (i+1)*page_size), capped at len-1 like PrefixIndex.match
        (the final token is always a query, never a cached row)."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1
        keys: List[int] = []
        h = 0
        i = 0
        while i + ps <= limit:
            h = hash((h, tuple(toks[i:i + ps])))
            keys.append(h)
            i += ps
        return keys

    def observe(self, tokens: Sequence[int], replica_id: str) -> int:
        """Record that ``replica_id`` served (and therefore now caches)
        this token path; returns the node count touched."""
        keys = self._keys(tokens)
        with self._lock:
            for k in keys:
                self._seq += 1
                self._nodes[k] = (replica_id, self._seq)
            if len(self._nodes) > self.max_nodes:
                drop = sorted(self._nodes.items(),
                              key=lambda kv: kv[1][1])
                for k, _ in drop[:len(self._nodes) - self.max_nodes]:
                    del self._nodes[k]
        return len(keys)

    def match(self, tokens: Sequence[int]) -> Tuple[Optional[str], int]:
        """Deepest known prefix walk -> (replica_id, depth_pages);
        (None, 0) when even the first page is unknown."""
        keys = self._keys(tokens)
        best: Optional[str] = None
        depth = 0
        with self._lock:
            for i, k in enumerate(keys):
                hit = self._nodes.get(k)
                if hit is None:
                    break
                self._seq += 1
                self._nodes[k] = (hit[0], self._seq)
                best, depth = hit[0], i + 1
        return best, depth

    def forget(self, replica_id: str) -> int:
        """Drop every node pointing at ``replica_id`` (its cache died
        with it); returns how many were dropped."""
        with self._lock:
            dead = [k for k, (rid, _) in self._nodes.items()
                    if rid == replica_id]
            for k in dead:
                del self._nodes[k]
        return len(dead)

    def stats(self) -> dict:
        with self._lock:
            return {"nodes": len(self._nodes),
                    "page_size": self.page_size}


class FleetBalancer:
    """Replica table + placement policy (see module doc).

    ``affinity`` is ``"prefix"`` (radix-index steering, the default)
    or ``"load"`` (pure least-loaded-by-KV-headroom). All state is
    guarded by the named ``fleet.balance`` lock; the Router mutates it
    from its dispatch threads and the scrape loop."""

    def __init__(self, affinity: str = "prefix", page_size: int = 16,
                 clock=time.monotonic):
        if affinity not in ("prefix", "load"):
            raise ValueError(f"affinity must be 'prefix' or 'load', "
                             f"got {affinity!r}")
        self.affinity = affinity
        self.index = AffinityIndex(page_size=page_size)
        self._clock = clock
        self._lock = named_lock("fleet.balance")
        # replica_id -> ReplicaState   # ptlint: guarded-by(fleet.balance)
        self._replicas: Dict[str, ReplicaState] = {}

    # ------------------------------------------------------------ table
    def upsert(self, replica_id: str, endpoint: str) -> ReplicaState:
        with self._lock:
            st = self._replicas.get(replica_id)
            if st is None or st.endpoint != endpoint:
                keep_draining = st.draining if st is not None else False
                st = ReplicaState(replica_id, endpoint)
                st.draining = keep_draining
                self._replicas[replica_id] = st
            st.live = True
            return st

    def mark_dead(self, replica_id: str) -> None:
        with self._lock:
            st = self._replicas.get(replica_id)
            if st is not None:
                st.live = False
                st.kv_pages_free = 0
        if self.affinity == "prefix":
            self.index.forget(replica_id)

    def mark_draining(self, replica_id: str, draining: bool) -> None:
        with self._lock:
            st = self._replicas.get(replica_id)
            if st is not None:
                st.draining = bool(draining)

    def remove(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(replica_id, None)
        if self.affinity == "prefix":
            self.index.forget(replica_id)

    def get(self, replica_id: str) -> Optional[ReplicaState]:
        with self._lock:
            return self._replicas.get(replica_id)

    def replicas(self) -> Dict[str, ReplicaState]:
        with self._lock:
            return dict(self._replicas)

    def record_scrape(self, replica_id: str, *, kv_pages_total: int,
                      kv_pages_free: int, page_size: int,
                      kv_pages_reclaimable: int = 0,
                      kv_spill_headroom: int = 0,
                      kv_pages_spilled_now: int = 0) -> None:
        with self._lock:
            st = self._replicas.get(replica_id)
            if st is None:
                return
            st.kv_pages_total = int(kv_pages_total)
            st.kv_pages_free = int(kv_pages_free)
            st.page_size = int(page_size)
            st.kv_pages_reclaimable = int(kv_pages_reclaimable)
            st.kv_spill_headroom = int(kv_spill_headroom)
            st.kv_pages_spilled_now = int(kv_pages_spilled_now)
            st.last_scrape = self._clock()
            st.scrape_failures = 0
            # adopt the fleet's ACTUAL page granularity: affinity keys
            # only predict prefix-cache hits when they are cut at the
            # ENGINES' page size, and the operator's --page_size default
            # rarely matches a tuned fleet. When every live replica's
            # scraped gauge agrees on a different size, re-key the
            # index — entries learned at the wrong granularity could
            # never match, so dropping them loses nothing.
            sizes = {s.page_size for s in self._replicas.values()
                     if s.live and s.page_size > 0}
            if len(sizes) == 1:
                ps = sizes.pop()
                if ps != self.index.page_size:
                    self.index = AffinityIndex(
                        page_size=ps, max_nodes=self.index.max_nodes)

    def record_scrape_failure(self, replica_id: str) -> int:
        with self._lock:
            st = self._replicas.get(replica_id)
            if st is None:
                return 0
            st.scrape_failures += 1
            return st.scrape_failures

    def adjust_inflight(self, replica_id: str, delta: int) -> None:
        with self._lock:
            st = self._replicas.get(replica_id)
            if st is not None:
                st.inflight = max(0, st.inflight + delta)

    # ----------------------------------------------------------- placement
    def pages_for(self, n_tokens: int, page_size: int) -> int:
        ps = max(1, int(page_size))
        return -(-int(n_tokens) // ps)

    def feasible_anywhere(self, total_tokens: int) -> bool:
        """Could ANY known replica ever hold this request? (The
        fleet_kv_capacity rejection gate — draining replicas count:
        they come back. Dead ones do not: their stale pool sizes must
        not keep an only-ever-feasible-there request queueing.)"""
        with self._lock:
            live = [st for st in self._replicas.values() if st.live]
            for st in live:
                if st.kv_pages_total <= 0:
                    continue          # not scraped yet: unknown, hope
                if self.pages_for(total_tokens,
                                  st.page_size) <= st.kv_pages_total:
                    return True
            # nothing scraped yet -> can't prove infeasibility
            return not any(st.kv_pages_total > 0 for st in live)

    def choose(self, tokens: Sequence[int], total_tokens: int,
               exclude: Iterable[str] = ()) -> Tuple[Optional[str], int]:
        """Pick a replica for this request -> (replica_id,
        affinity_depth_pages); (None, 0) when no routable replica has
        the free headroom RIGHT NOW (the caller queues + retries).
        ``exclude`` removes failed-over victims from consideration."""
        excluded = set(exclude)
        with self._lock:
            cands = [st for st in self._replicas.values()
                     if st.routable() and st.replica_id not in excluded]
        if not cands:
            return None, 0

        def headroom_ok(st: ReplicaState) -> bool:
            if st.kv_pages_total <= 0:
                return True           # unscraped: let the replica decide
            return self.pages_for(
                total_tokens, st.page_size) <= st.kv_pages_free

        fits = [st for st in cands if headroom_ok(st)]
        if not fits:
            return None, 0
        if self.affinity == "prefix":
            rid, depth = self.index.match(tokens)
            if rid is not None and depth > 0:
                for st in fits:
                    if st.replica_id == rid:
                        return rid, depth
            # no learned match: consistent-hash the prompt's first
            # page to its HOME replica. Rendezvous over the fit set is
            # a pure function of (prompt, live membership), so N
            # independent routers cut the identical key and agree on
            # the home with no shared state — the HA-plane property
            # (two routers never split one hot prefix across replicas).
            # The learned index still wins above it: after a failover
            # or a headroom detour THIS router knows where the pages
            # actually are, which the hash cannot.
            key = stable_prefix_key(tokens, self.index.page_size)
            if key is not None:
                home = rendezvous_choose(
                    key, (st.replica_id for st in fits))
                if home is not None:
                    return home, 0
        # least-loaded, tier-aware: prefer the replica that can absorb
        # this request WITHOUT lossily evicting cached pages (its spill
        # store catches reclaimed trie pages), then most free KV pages,
        # ties by fewest inflight. On a single-tier fleet the first key
        # degenerates to kv_pages_free minus reclaimable — still a
        # sensible "don't trash the hottest cache" ordering.
        best = max(fits, key=lambda st: (st.lossless_headroom(),
                                         st.kv_pages_free,
                                         -st.inflight))
        return best.replica_id, 0

    def observe_served(self, tokens: Sequence[int],
                       replica_id: str) -> None:
        """Post-settle affinity update: the replica's trie now holds
        this token path's pages (finish-path insert in the engine)."""
        if self.affinity == "prefix":
            self.index.observe(tokens, replica_id)

    def stats(self) -> dict:
        with self._lock:
            reps = {rid: st.as_dict()
                    for rid, st in self._replicas.items()}
        live = sum(1 for r in reps.values() if r["live"])
        draining = sum(1 for r in reps.values()
                       if r["draining"] and r["live"])
        return {"affinity": self.affinity,
                "replicas": len(reps),
                "replicas_live": live,
                "replicas_draining": draining,
                "kv_pages_total": sum(r["kv_pages_total"]
                                      for r in reps.values()
                                      if r["live"]),
                "kv_pages_free": sum(r["kv_pages_free"]
                                     for r in reps.values()
                                     if r["live"] and not r["draining"]),
                "kv_pages_spilled_now": sum(r["kv_pages_spilled_now"]
                                            for r in reps.values()
                                            if r["live"]),
                "kv_spill_headroom": sum(r["kv_spill_headroom"]
                                         for r in reps.values()
                                         if r["live"]
                                         and not r["draining"]),
                "index": self.index.stats(),
                "per_replica": reps}
