"""Shared-prefix KV reuse: a page-granularity radix index over the
paged pool — the port of ``paddle_tpu/serving/prefix.py`` (host-only
logic, copied; plain ``threading`` locks in place of the reference's
instrumented ones).

Every request that finishes (or is evicted) leaves its COMPLETE KV
pages behind in a trie keyed by page-size token runs: node
``(t_0..t_{ps-1}) -> (t_ps..)`` holds the physical page whose rows are
the teacher-forced K/V of exactly those tokens at exactly those
positions. A later request whose prompt walks the same token path
ATTACHES those pages instead of recomputing them — admission charges
only the *novel* pages, and the attached prefill steps disappear.

Correctness leans on two invariants:

- KV is a pure function of (token run, positions): pages are only
  inserted for fully teacher-forced token runs starting at position 0,
  so an attached page holds what the slot would have written itself.
- Attached pages are never written: a slot admitted with ``matched``
  tokens starts scattering at position ``matched``, which lands in its
  first PRIVATE page. Divergence INSIDE a page is handled by
  copy-on-write: the shared page is device-copied into a fresh page
  (``PagedDecoder.copy_page``) and the match extends to the common
  rows of the copy.

Ownership is reference counting in the engine's ``PagePool``: the trie
holds ONE ref per indexed page, every slot using it holds another;
``free()`` only returns a page to the free list at refcount zero, and
``page_accounting()`` extends the zero-leak invariant to
``refs_total == held_by_slots + held_by_trie``.

Under pool pressure the engine reclaims least-recently-used LEAF nodes
(refcount 1 — trie-only) BEFORE preempting a running slot. Trie state
is guarded by this index's lock: mutation happens on the engine's
stepping thread, but stats() reads from arbitrary threads. Lock order
is engine -> prefix -> pagepool (never the reverse).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["PrefixIndex", "PrefixMatch"]


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent):
        self.key = key                   # page_size token tuple
        self.page = page                 # physical page id (None: root)
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = 0


class PrefixMatch:
    """One lookup's result: ``pages`` are fully-shared physical pages
    (in logical order), ``matched`` counts their tokens, and ``cow``
    (when set) is ``(physical_page, rows)`` — the best partially-
    matching child page whose first ``rows`` tokens agree, a
    copy-on-write candidate."""

    __slots__ = ("pages", "matched", "cow")

    def __init__(self, pages: List[int], matched: int,
                 cow: Optional[Tuple[int, int]]):
        self.pages = pages
        self.matched = matched
        self.cow = cow


class PrefixIndex:
    """Radix/trie index of shared KV pages (see module doc). All
    public methods take the index's lock; the engine
    calls the mutators from its stepping thread only."""

    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # the radix trie + LRU clock
        self._root = _Node(None, None, None)
        self._seq = 0
        self._nodes = 0
        # cumulative accounting (``summary()`` and the engine's
        # stats); the engine adds the hits, misses and copy-on-write
        # copies of each admission. Evictions are counted apart: the
        # lossy LRU ones and the exact ones of the spill path.
        self.hit_pages = 0
        self.miss_pages = 0
        self.cow_hits = 0
        self.inserted_pages = 0
        self.evicted_lru_pages = 0
        self.evicted_exact_pages = 0

    # --------------------------------------------------------------- lookup
    def match(self, tokens) -> PrefixMatch:
        """Longest shared-page walk for ``tokens`` (prompt + replayed
        generation). The match is capped at ``len(tokens) - 1`` so the
        slot always has at least one token left to feed — the step
        needs a query to produce the next token."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1
        pages: List[int] = []
        cow = None
        with self._lock:
            node = self._root
            i = 0
            while i + ps <= limit:
                child = node.children.get(tuple(toks[i:i + ps]))
                if child is None:
                    break
                self._seq += 1
                child.last_used = self._seq
                pages.append(child.page)
                node = child
                i += ps
            # partial-page (copy-on-write) candidate: the child sharing
            # the longest leading token run inside the next page
            best = 0
            best_child = None
            remaining = toks[i:]
            for key, child in node.children.items():
                j = 0
                cap = min(ps, limit - i)
                while j < cap and key[j] == remaining[j]:
                    j += 1
                if j > best:
                    best = j
                    best_child = child
                    cow = (child.page, j)
            if best_child is not None:
                self._seq += 1
                best_child.last_used = self._seq
        return PrefixMatch(pages, i, cow)

    # -------------------------------------------------------------- insert
    def insert(self, tokens, pages: List[int]) -> int:
        """Register the COMPLETE pages of a finished/evicted slot's
        teacher-forced token run. ``pages`` is the slot's physical page
        list (logical order). Existing nodes are touched, novel ones
        take one pool ref each. Returns the number of new nodes."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        new = 0
        with self._lock:
            node = self._root
            i = 0
            while i + ps <= len(toks) and i // ps < len(pages):
                key = tuple(toks[i:i + ps])
                child = node.children.get(key)
                if child is None:
                    page = pages[i // ps]
                    self.pool.ref(page)
                    child = _Node(key, page, node)
                    node.children[key] = child
                    self._nodes += 1
                    new += 1
                self._seq += 1
                child.last_used = self._seq
                node = child
                i += ps
            self.inserted_pages += new
        return new

    # ------------------------------------------------------------ eviction
    def evict_lru(self, n: int = 1) -> List[int]:
        """Free up to ``n`` least-recently-used LEAF pages whose only
        owner is the trie (pool refcount 1). Returns the freed physical
        pages — inner nodes become leaves as their children go, so a
        caller looping this reclaims whole cold branches."""
        freed: List[int] = []
        with self._lock:
            while len(freed) < n:
                victim = None
                stack = [self._root]
                while stack:
                    nd = stack.pop()
                    if nd.page is not None and not nd.children and \
                            self.pool.refcount(nd.page) == 1:
                        if victim is None or \
                                nd.last_used < victim.last_used:
                            victim = nd
                    stack.extend(nd.children.values())
                if victim is None:
                    break
                del victim.parent.children[victim.key]
                self._nodes -= 1
                self.pool.free([victim.page])
                freed.append(victim.page)
            self.evicted_lru_pages += len(freed)
        return freed

    # --------------------------------------------------------------- spill
    @staticmethod
    def _path_of(node: _Node) -> tuple:
        """Full token path from the root through ``node`` — the spill
        store's key (serving/spill.py): restores look the SAME token
        run back up, so the key is reconstructable from a request's
        replay alone."""
        keys = []
        while node.key is not None:
            keys.append(node.key)
            node = node.parent
        out: List[int] = []
        for key in reversed(keys):
            out.extend(key)
        return tuple(out)

    def spill_candidates(self, n: int = 1) -> List[Tuple[tuple, int]]:
        """Up to ``n`` least-recently-used LEAF pages whose only owner
        is the trie, as ``(token_path, physical_page)`` — NO mutation.
        The engine spills these device->host and then calls
        :meth:`evict_exact` per page, keeping the crash-safety ordering
        (read, evict+free, commit) under ITS control."""
        with self._lock:
            leaves = []
            stack = [self._root]
            while stack:
                nd = stack.pop()
                if nd.page is not None and not nd.children and \
                        self.pool.refcount(nd.page) == 1:
                    leaves.append(nd)
                stack.extend(nd.children.values())
            leaves.sort(key=lambda nd: nd.last_used)
            return [(self._path_of(nd), nd.page) for nd in leaves[:n]]

    def evict_exact(self, path: tuple) -> Optional[int]:
        """Remove the node at exactly ``path`` (a full token path) and
        free its page — the evict+free step of the spill ordering. The
        node must still be a trie-only (refcount 1) childless leaf;
        returns the freed page, or None if the node changed since
        :meth:`spill_candidates` picked it (grew children, gained a
        slot ref, vanished) — the caller then skips the spill."""
        ps = self.page_size
        path = tuple(int(t) for t in path)
        if not path or len(path) % ps != 0:
            return None
        with self._lock:
            node = self._root
            for i in range(0, len(path), ps):
                node = node.children.get(path[i:i + ps])
                if node is None:
                    return None
            if node.children or self.pool.refcount(node.page) != 1:
                return None
            page = node.page
            del node.parent.children[node.key]
            self._nodes -= 1
            self.pool.free([page])
            self.evicted_exact_pages += 1
            return page

    def reclaimable_pages(self) -> int:
        """Pages an eviction loop could eventually return to the free
        list: trie pages no slot is also holding (refcount 1)."""
        with self._lock:
            count = 0
            stack = [self._root]
            while stack:
                nd = stack.pop()
                if nd.page is not None and \
                        self.pool.refcount(nd.page) == 1:
                    count += 1
                stack.extend(nd.children.values())
            return count

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> int:
        """Drop the whole index, returning every trie ref to the pool
        (shared pages stay allocated for the slots still holding them).
        Returns the number of dropped nodes."""
        with self._lock:
            stack = [self._root]
            while stack:
                nd = stack.pop()
                if nd.page is not None:
                    self.pool.free([nd.page])
                stack.extend(nd.children.values())
            n = self._nodes
            self._root = _Node(None, None, None)
            self._nodes = 0
        return n

    def reset(self) -> None:
        """Forget every node WITHOUT touching the pool — the step-
        failure recovery path, where the engine has already rebuilt the
        PagePool from scratch."""
        with self._lock:
            self._root = _Node(None, None, None)
            self._nodes = 0

    # ------------------------------------------------------------ snapshots
    def page_count(self) -> int:
        with self._lock:
            return self._nodes

    def summary(self) -> dict:
        """The flight bundle's view: the trie's shape, the cumulative
        hit accounting and the pool's refcount histogram (the JAX
        package's keys)."""
        with self._lock:
            depth = 0
            stack = [(self._root, 0)]
            while stack:
                nd, d = stack.pop()
                depth = max(depth, d)
                stack.extend((c, d + 1) for c in nd.children.values())
            return {
                "nodes": self._nodes,
                "pages": self._nodes,
                "max_depth_pages": depth,
                "hit_pages": self.hit_pages,
                "miss_pages": self.miss_pages,
                "cow_copies": self.cow_hits,
                "inserted_pages": self.inserted_pages,
                "evicted_pages":
                    self.evicted_lru_pages + self.evicted_exact_pages,
                "refcount_histogram": self.pool.refcount_histogram(),
            }
