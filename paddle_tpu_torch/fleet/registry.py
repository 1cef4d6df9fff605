"""Replica membership for the serving fleet — the port of
``paddle_tpu/fleet/registry.py``. The directory IS the failover
mechanism (the elastic coordinator's membership plane, re-used for
serving).

A serving replica is a WORKER of the elastic coordinator: it joins as
``serve/<replica_id>`` publishing its HTTP endpoint (plus a per-process
``boot_id``) in the join info, renews its lease from a heartbeat thread
(``pt-fleet-hb-*``), and leaves gracefully on stop. A SIGKILL'd replica
simply stops heartbeating — its lease lapses, ``worker_info`` starts
returning None, and the router's next :meth:`ReplicaRegistry.poll`
sees it gone: **lease expiry is an implicit drain**. When the replica
(or its replacement) comes back it re-joins under the same worker id
with a fresh ``boot_id``; the registry reports that transition as a
rejoin so the router can clear any draining mark and re-admit it.

The same :class:`Registration` keeps the ROUTER's own lease
(``fleet/router``), so ``cli.py trace merge`` and the membership
journal see every fleet process through one directory.
"""

from __future__ import annotations

import http.client
import threading
import time
import uuid
import xmlrpc.client
from typing import Any, Callable, Dict, Optional

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.events import emit as journal_emit

__all__ = ["Registration", "ReplicaRegistration", "ReplicaRegistry",
           "ReplicaView"]

#: transport-level failures that mean the COORDINATOR is unreachable —
#: categorically different from a lease expiry (the coordinator
#: answering "that worker is gone"). xmlrpc.client.Fault is NOT here
#: on purpose: a Fault is the coordinator answering.
_RPC_ERRORS = (OSError, http.client.HTTPException,
               xmlrpc.client.ProtocolError)


class Registration:
    """Keep one fleet process's membership lease alive.

    coordinator: a Coordinator (in-process) or a CoordinatorServer
    proxy — both expose join/worker_heartbeat/leave. The heartbeat
    thread re-JOINS when the coordinator answers -1 (our lease lapsed,
    e.g. a long GC pause or a coordinator restart): the endpoint gets
    re-published, so directory-based routers recover on their own.
    ``pause()`` stops renewals WITHOUT leaving — the chaos suite's
    lease-lapse fault (testing/faults.py family (p)) — and
    ``unpause()`` restarts them (the next tick re-joins)."""

    def __init__(self, coordinator: Any, worker_id: str,
                 info: Dict[str, Any], heartbeat_s: float = 1.0):
        self.coordinator = coordinator
        self.worker_id = worker_id
        self.info = dict(info)
        # one id per PROCESS START: a rejoin under the same worker_id
        # with a new boot_id is a restart, not a lease blip
        self.info.setdefault("boot_id", uuid.uuid4().hex[:12])
        self.heartbeat_s = float(heartbeat_s)
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.generation: Optional[int] = None
        self.rejoins = 0

    def _info(self) -> Dict[str, Any]:
        return dict(self.info)

    def join(self) -> "Registration":
        grant = self.coordinator.join(self.worker_id, self._info())
        self.generation = grant["generation"]
        self._thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"pt-fleet-hb-{self.worker_id.replace('/', '-')}")
        self._thread.start()
        return self

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_s):
            if self._paused.is_set():
                continue               # lease-lapse fault: let it expire
            try:
                gen = self.coordinator.worker_heartbeat(self.worker_id)
                if gen == -1:          # lease lapsed: re-join, re-publish
                    grant = self.coordinator.join(self.worker_id,
                                                  self._info())
                    gen = grant["generation"]
                    self.rejoins += 1
                self.generation = gen
            except Exception:  # noqa: BLE001 — a coordinator blip must
                pass           # not kill the lease keeper; next tick retries

    def pause(self) -> None:
        """Stop renewing (without leaving) — the lease will lapse."""
        self._paused.set()

    def unpause(self) -> None:
        """Resume renewals; the next heartbeat tick re-joins."""
        self._paused.clear()

    def stop(self, leave: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if leave:
            try:
                self.coordinator.leave(self.worker_id)
            except Exception:  # noqa: BLE001 — best-effort goodbye
                pass


class ReplicaRegistration(Registration):
    """One serving replica's lease: ``serve/<replica_id>`` publishing
    its HTTP endpoint (the address the router dispatches to)."""

    def __init__(self, coordinator: Any, replica_id: str, endpoint: str,
                 heartbeat_s: float = 1.0):
        super().__init__(
            coordinator, f"serve/{replica_id}",
            {"role": "serve_replica", "replica_id": str(replica_id),
             "endpoint": endpoint,
             "run_id": obs_context.ensure_run_id(),
             "host": obs_context.get_host()},
            heartbeat_s=heartbeat_s)
        self.replica_id = str(replica_id)
        self.endpoint = endpoint


class ReplicaView:
    """The router's picture of one replica, as of the last poll."""

    __slots__ = ("replica_id", "endpoint", "boot_id", "live")

    def __init__(self, replica_id: str, endpoint: str,
                 boot_id: Optional[str], live: bool = True):
        self.replica_id = replica_id
        self.endpoint = endpoint
        self.boot_id = boot_id
        self.live = live

    def as_dict(self) -> Dict[str, Any]:
        return {"replica_id": self.replica_id, "endpoint": self.endpoint,
                "boot_id": self.boot_id, "live": self.live}


class ReplicaRegistry:
    """Router-side replica discovery.

    Backed by the coordinator directory when one is given (``poll()``
    lists ``serve/*`` workers whose lease is live); a static
    ``endpoints`` map ({replica_id: endpoint}) otherwise — the
    in-process test/bench mode. ``on_join`` / ``on_leave`` /
    ``on_rejoin`` callbacks fire from inside ``poll()`` (the caller's
    thread) on membership transitions; a rejoin is the same worker id
    coming back after a lapse, or a boot_id change (a restart).

    **Coordinator outage is not a mass leave.** A transport failure
    talking to the directory says nothing about the replicas — they
    are still serving; only the ROUTER went blind. ``poll()``
    therefore keeps serving the last successful scan as a STALE view
    (no leave callbacks fire), journals ``fleet/stale_view`` when the
    outage starts, and tracks its age — exported as the
    ``paddle_tpu_fleet_registry_stale_s`` gauge via Router.stats().
    The staleness is bounded: past ``max_stale_s`` the view is too old
    to trust (replicas may have died unobserved) and poll() reports it
    empty, which IS the mass-leave — but deliberately, hundreds of
    poll intervals after the outage began, not on the first blip."""

    def __init__(self, coordinator: Any = None,
                 endpoints: Optional[Dict[str, str]] = None,
                 on_join: Optional[Callable[[ReplicaView], None]] = None,
                 on_leave: Optional[Callable[[str], None]] = None,
                 on_rejoin: Optional[Callable[[ReplicaView], None]] = None,
                 max_stale_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        if coordinator is None and not endpoints:
            raise ValueError("need a coordinator or a static "
                             "endpoints map")
        self.coordinator = coordinator
        self.max_stale_s = float(max_stale_s)
        # the staleness clock (tests drive the bound on a fake one)
        self._clock = clock
        self._static = dict(endpoints or {})
        self._lock = named_lock("fleet.registry")
        # xmlrpc ServerProxy reuses ONE HTTPConnection and is not
        # thread-safe: the router polls from both its background
        # refresh loop and the caller thread of generate(), so the
        # directory RPCs must be serialized or http.client's state
        # machine tears (CannotSendRequest / ResponseNotReady)
        self._rpc_lock = threading.Lock()
        # last poll's view + ids seen EVER  # ptlint: guarded-by(fleet.registry)
        self._view: Dict[str, ReplicaView] = {}
        self._ever: Dict[str, Optional[str]] = {}  # id -> last boot_id
        # coordinator-outage state  # ptlint: guarded-by(fleet.registry)
        self._stale_since: Optional[float] = None
        self.stale_polls = 0           # ptlint: guarded-by(fleet.registry)
        self.on_join = on_join
        self.on_leave = on_leave
        self.on_rejoin = on_rejoin

    def _scan(self) -> Dict[str, ReplicaView]:
        if self.coordinator is None:
            with self._lock:
                static = dict(self._static)
            return {rid: ReplicaView(rid, ep, None)
                    for rid, ep in static.items()}
        out: Dict[str, ReplicaView] = {}
        with self._rpc_lock:
            for wid in list(self.coordinator.workers()):
                if not str(wid).startswith("serve/"):
                    continue
                info = self.coordinator.worker_info(wid)
                if not info or not info.get("endpoint"):
                    continue          # lease lapsed = implicit drain
                rid = str(info.get("replica_id") or wid.split("/", 1)[1])
                out[rid] = ReplicaView(rid, info["endpoint"],
                                       info.get("boot_id"))
        return out

    def poll(self) -> Dict[str, ReplicaView]:
        """Refresh the membership view; fire transition callbacks.

        A coordinator-unreachable scan does NOT clear the view (see
        class doc): the last-known replicas keep routing, marked stale,
        until ``max_stale_s`` bounds the lie."""
        try:
            fresh = self._scan()
        except _RPC_ERRORS as e:
            return self._poll_stale(e)
        recovered_age = None
        with self._lock:
            if self._stale_since is not None:
                recovered_age = self._clock() - self._stale_since
                self._stale_since = None
        if recovered_age is not None:
            journal_emit("fleet", "view_recovered",
                         stale_s=round(recovered_age, 3),
                         replicas=len(fresh))
        joined, rejoined, left = [], [], []
        with self._lock:
            for rid, view in fresh.items():
                if rid not in self._view:
                    if rid in self._ever:
                        rejoined.append(view)   # back after a lapse
                    else:
                        joined.append(view)
                elif (view.boot_id is not None
                      and self._view[rid].boot_id is not None
                      and view.boot_id != self._view[rid].boot_id):
                    rejoined.append(view)       # restarted in place
                elif view.endpoint != self._view[rid].endpoint:
                    # a static entry relocated (restart on a new port:
                    # the deploy leg without a directory) — same
                    # re-admit semantics as a boot_id change
                    rejoined.append(view)
                self._ever[rid] = view.boot_id
            for rid in self._view:
                if rid not in fresh:
                    left.append(rid)
            self._view = dict(fresh)
        for view in joined:
            if self.on_join:
                self.on_join(view)
        for view in rejoined:
            if self.on_rejoin:
                self.on_rejoin(view)
        for rid in left:
            if self.on_leave:
                self.on_leave(rid)
        return dict(fresh)

    def _poll_stale(self, err: Exception) -> Dict[str, ReplicaView]:
        """One unreachable-coordinator poll: keep (and return) the
        last view, journal the outage once on entry, expire the view
        past ``max_stale_s``. Leave callbacks only fire on expiry —
        an outage is the ROUTER blind, not the replicas dead."""
        now = self._clock()
        expired_ids = []
        with self._lock:
            first = self._stale_since is None
            if first:
                self._stale_since = now
            self.stale_polls += 1
            age = now - self._stale_since
            if age > self.max_stale_s and self._view:
                expired_ids = list(self._view)
                self._view = {}
            view = dict(self._view)
        if first:
            journal_emit("fleet", "stale_view", error=repr(err),
                         replicas=len(view),
                         max_stale_s=self.max_stale_s)
        if expired_ids:
            journal_emit("fleet", "stale_view_expired",
                         stale_s=round(age, 3), dropped=expired_ids)
            for rid in expired_ids:
                if self.on_leave:
                    self.on_leave(rid)
        return view

    def set_static(self, replica_id: str, endpoint: str) -> None:
        """Add/update a static-mode entry — the provisioner's join leg
        when no coordinator directory exists (tests/bench/CPU fleets).
        The next poll() reports it as a join (or a rejoin when the
        endpoint moved — a restart relocates the replica)."""
        with self._lock:
            self._static[str(replica_id)] = endpoint

    def drop_static(self, replica_id: str) -> None:
        """Remove a static-mode entry; the next poll() reports the
        leave."""
        with self._lock:
            self._static.pop(str(replica_id), None)

    def staleness(self) -> float:
        """Seconds the current view has been served without a
        successful coordinator scan (0.0 when fresh / static)."""
        with self._lock:
            if self._stale_since is None:
                return 0.0
            return self._clock() - self._stale_since

    def view(self) -> Dict[str, ReplicaView]:
        with self._lock:
            return dict(self._view)
