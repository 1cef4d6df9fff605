"""Lock-order witness — the runtime of ``paddle_tpu/analysis/lockdep.py``
(the JAX package's static lock rules are not ported).

``InstrumentedLock`` is a named, drop-in ``threading.Lock`` /
``threading.RLock`` wrapper. Every first (non-reentrant) acquisition
records *acquisition-order edges*: for each lock the acquiring thread
already holds, an edge ``held.name -> new.name`` goes into a global
directed graph keyed by lock NAME (many ``StatItem`` locks share one
name and one graph node). A new edge whose reverse path already exists
is a *would-be inversion*: two code paths take the same pair of locks
in opposite orders, a deadlock waiting for the right interleaving.
Seeing both orders is enough; the deadlock need not happen.

On inversion the witness journals ``lockdep/inversion`` with BOTH
stacks — the current one and the one recorded when the reverse edge
was first seen — and (obs/flight.py ``AUTO_DUMP_TRIGGERS``) auto-dumps
a flight bundle. ``configure(on_inversion="raise")`` upgrades that to
a ``LockOrderInversion`` exception.

Telemetry rides the obs registry through a scrape-time collector
(obs/metrics.py ``_lockdep_bridge``): order edges, inversions, and per
name contentions, cumulative hold time and acquisitions.

This module imports nothing of the port at module level — utils/stats.py
and the whole obs plane build their locks from it, so the journal is
resolved lazily.
"""
from __future__ import annotations

import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "InstrumentedLock", "LockOrderInversion", "LOCKDEP",
    "named_lock", "named_rlock", "named_condition", "find_lock",
]

_STACK_LIMIT = 16           # frames kept per recorded stack


class LockOrderInversion(RuntimeError):
    """Raised (in ``on_inversion='raise'`` mode) when an acquisition
    would close a cycle in the global lock-order graph."""


def _stack(skip: int = 2) -> str:
    """The current stack, formatted, minus ``skip`` innermost frames
    (lockdep's own bookkeeping)."""
    frames = traceback.format_stack(limit=_STACK_LIMIT + skip)
    return "".join(frames[:-skip] if skip else frames)


class _Held:
    """One entry in a thread's held-lock stack."""
    __slots__ = ("lock", "name", "t0")

    def __init__(self, lock: "InstrumentedLock", name: str, t0: float):
        self.lock = lock
        self.name = name
        self.t0 = t0


class _Lockdep:
    """Process-global witness state: the acquisition-order graph plus
    per-name contention/hold telemetry.  One instance (``LOCKDEP``)."""

    def __init__(self):
        self._glock = threading.Lock()      # plain: guards graph mutation
        self._tls = threading.local()
        # edge (a, b) -> {"count", "stack", "thread"}; reads are
        # GIL-safe dict lookups, writes go through _glock.
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.adj: Dict[str, Set[str]] = {}
        self.contentions: Dict[str, int] = {}
        self.hold_ms: Dict[str, float] = {}
        self.acquisitions: Dict[str, int] = {}
        self.inversions: List[dict] = []
        self.on_inversion = "journal"       # or "raise"
        self._reported: Set[Tuple[str, str]] = set()
        self._instances: Dict[str, List[weakref.ref]] = {}

    # -------------------------------------------------- configuration
    def configure(self, on_inversion: Optional[str] = None) -> None:
        if on_inversion is not None:
            if on_inversion not in ("journal", "raise"):
                raise ValueError("on_inversion must be 'journal' or "
                                 f"'raise', got {on_inversion!r}")
            self.on_inversion = on_inversion

    def reset(self) -> None:
        """Clear the order graph and telemetry (NOT per-thread held
        stacks — live threads keep their entries so release timing
        stays coherent across the conftest per-test reset)."""
        with self._glock:
            self.edges.clear()
            self.adj.clear()
            self.contentions.clear()
            self.hold_ms.clear()
            self.acquisitions.clear()
            self.inversions.clear()
            self._reported.clear()

    # -------------------------------------------------- held tracking
    def _held(self) -> List[_Held]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_names(self) -> Tuple[str, ...]:
        """The current thread's held-lock names, outermost first."""
        return tuple(h.name for h in self._held())

    def note_acquired(self, lock: "InstrumentedLock", name: str) -> None:
        held = self._held()
        inversion = None
        if held:
            for h in held:
                if h.name == name:
                    continue    # same-name nesting is one graph node
                key = (h.name, name)
                info = self.edges.get(key)      # GIL-safe fast path
                if info is not None:
                    info["count"] += 1
                elif inversion is None:
                    inversion = self._add_edge(h.name, name)
                else:
                    self._add_edge(h.name, name)
        held.append(_Held(lock, name, time.perf_counter()))
        self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
        if inversion is not None:
            self._report_inversion(inversion)

    def note_released(self, lock: "InstrumentedLock", name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                entry = held.pop(i)
                dt = (time.perf_counter() - entry.t0) * 1000.0
                self.hold_ms[name] = self.hold_ms.get(name, 0.0) + dt
                return
        # no entry: released by a thread that never recorded the
        # acquire (cross-thread release of a plain Lock): tolerated

    def record_contention(self, name: str) -> None:
        self.contentions[name] = self.contentions.get(name, 0) + 1

    # -------------------------------------------------- graph
    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """BFS path src -> ... -> dst over adj, or None.  Caller holds
        _glock."""
        if src not in self.adj:
            return None
        parent: Dict[str, str] = {src: src}
        frontier = [src]
        while frontier:
            nxt: List[str] = []
            for node in frontier:
                for succ in self.adj.get(node, ()):
                    if succ in parent:
                        continue
                    parent[succ] = node
                    if succ == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(parent[path[-1]])
                        path.reverse()
                        return path
                    nxt.append(succ)
            frontier = nxt
        return None

    def _add_edge(self, a: str, b: str) -> Optional[dict]:
        """Record edge a->b.  Returns an inversion record (not yet
        journaled) when the edge would close a cycle."""
        me = threading.current_thread().name
        stack = _stack(skip=4)
        with self._glock:
            info = self.edges.get((a, b))
            if info is not None:
                info["count"] += 1
                return None
            if (a, b) in self._reported:    # don't re-journal per hit
                return None
            path = self._find_path(b, a)
            if path is None:
                self.edges[(a, b)] = {"count": 1, "stack": stack,
                                      "thread": me}
                self.adj.setdefault(a, set()).add(b)
                return None
            self._reported.add((a, b))
            other = self.edges.get((path[0], path[1]), {})
            rec = {
                "acquiring": b,
                "while_holding": a,
                "cycle": " -> ".join([a, b] + path[1:]),
                "this_thread": me,
                "this_stack": stack,
                "other_thread": other.get("thread", "?"),
                "other_stack": other.get("stack", ""),
            }
            self.inversions.append(rec)
            return rec

    def _report_inversion(self, rec: dict) -> None:
        """Journal (never raises into the hot path) and, in raise
        mode, raise.  Runs OUTSIDE _glock: the journal's own lock is
        instrumented and must be free to record its edges."""
        try:
            from paddle_tpu_torch.obs.events import JOURNAL
            JOURNAL.emit("lockdep", "inversion", **rec)
        except Exception:   # noqa: BLE001 — witness never kills the app
            pass
        if self.on_inversion == "raise":
            raise LockOrderInversion(
                "lock-order inversion: acquiring "
                f"'{rec['acquiring']}' while holding "
                f"'{rec['while_holding']}' closes the cycle "
                f"{rec['cycle']} (reverse order first seen on thread "
                f"{rec['other_thread']})")

    # -------------------------------------------------- introspection
    @property
    def inversion_count(self) -> int:
        return len(self.inversions)

    def register_instance(self, name: str, lock: "InstrumentedLock"):
        with self._glock:
            refs = self._instances.setdefault(name, [])
            refs[:] = [r for r in refs if r() is not None]
            refs.append(weakref.ref(lock))

    def find_lock(self, name: str) -> Optional["InstrumentedLock"]:
        """The most recently constructed live lock with this name."""
        with self._glock:
            for ref in reversed(self._instances.get(name, [])):
                lk = ref()
                if lk is not None:
                    return lk
        return None

    def metrics_snapshot(self) -> dict:
        """A consistent-enough copy for the obs collector (values are
        telemetry; exactness under races is not required)."""
        with self._glock:
            return {
                "edges": len(self.edges),
                "inversions": len(self.inversions),
                "contentions": dict(self.contentions),
                "hold_ms": dict(self.hold_ms),
                "acquisitions": dict(self.acquisitions),
            }

    def snapshot_edges(self) -> List[Tuple[str, str, int]]:
        with self._glock:
            return sorted((a, b, info["count"])
                          for (a, b), info in self.edges.items())

    def format_text(self) -> str:
        lines = ["lockdep order graph "
                 f"({len(self.edges)} edges, "
                 f"{len(self.inversions)} inversions):"]
        for a, b, count in self.snapshot_edges():
            lines.append(f"  {a} -> {b}  (x{count})")
        return "\n".join(lines)

    def to_dot(self) -> str:
        lines = ["digraph lockdep {"]
        for a, b, count in self.snapshot_edges():
            lines.append(f'  "{a}" -> "{b}" [label="x{count}"];')
        lines.append("}")
        return "\n".join(lines)


LOCKDEP = _Lockdep()


def find_lock(name: str) -> Optional["InstrumentedLock"]:
    return LOCKDEP.find_lock(name)


class InstrumentedLock:
    """Named drop-in for ``threading.Lock`` (``reentrant=True`` for
    ``threading.RLock``) wired into the LOCKDEP witness.

    Implements the full lock protocol ``threading.Condition`` probes
    for (``_is_owned`` / ``_release_save`` / ``_acquire_restore``), so
    ``named_condition`` is a drop-in ``threading.Condition``.
    """

    __slots__ = ("_name", "_reentrant", "_inner", "_owner", "_count",
                 "__weakref__")

    def __init__(self, name: str, reentrant: bool = False):
        self._name = str(name)
        self._reentrant = bool(reentrant)
        # inner is always a plain Lock: reentrancy is tracked here so
        # the witness sees exactly one acquire per outermost entry.
        self._inner = threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0
        LOCKDEP.register_instance(self._name, self)

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._count += 1
            return True
        got = self._inner.acquire(False)
        if not got:
            LOCKDEP.record_contention(self._name)
            if not blocking:
                return False
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        self._owner = me
        self._count = 1
        LOCKDEP.note_acquired(self, self._name)
        return True

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner == me and self._count > 1:
            self._count -= 1
            return
        # clear ownership BEFORE the inner release: the next owner
        # must not see stale owner state.
        self._owner = None
        self._count = 0
        LOCKDEP.note_released(self, self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        state = "locked" if self._inner.locked() else "unlocked"
        return f"<InstrumentedLock({kind}) {self._name!r} {state}>"

    # ---------------------------------------- Condition lock protocol
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        count = self._count
        self._count = 1         # force the real release below
        self.release()
        return count

    def _acquire_restore(self, state) -> None:
        self.acquire()
        self._count = state


def named_lock(name: str) -> InstrumentedLock:
    """A named, witness-instrumented ``threading.Lock``."""
    return InstrumentedLock(name, reentrant=False)


def named_rlock(name: str) -> InstrumentedLock:
    """A named, witness-instrumented ``threading.RLock``."""
    return InstrumentedLock(name, reentrant=True)


def named_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` whose underlying lock is a named
    instrumented lock — ``wait()`` releases/reacquires through the
    witness, so held-set accounting stays exact across waits."""
    return threading.Condition(lock=InstrumentedLock(name))
