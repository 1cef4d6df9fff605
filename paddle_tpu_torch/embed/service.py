"""Shard registration on the membership plane + an in-process harness.

A shard is a WORKER of the elastic coordinator: it joins as
``embed/<shard_id>`` publishing its RPC endpoint in the join info, renews
its lease from a heartbeat thread (``pt-embed-hb-*``), and leaves
gracefully on stop. A SIGKILL'd shard simply stops heartbeating — its
lease lapses, `worker_info` starts returning None, and the REPLACEMENT
that restores the key range from snapshot+WAL re-joins under the same
worker id with a new endpoint. Clients that re-resolve through the
membership plane fail over with no configuration change: the directory
IS the failover mechanism, and every membership transition rides the
coordinator's existing generation stamps and journal.

:class:`EmbedService` is the multi-shard harness the tests, bench rows,
chaos suite and the CLI demo use: N shards + servers (+ registrations
when a coordinator is given) over one shared snapshot store, with
`kill()` / `replace()` to drive the failover story in-process.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.trainer.coordinator import InMemStore, KVStore

from paddle_tpu_torch.embed.client import EmbeddingClient
from paddle_tpu_torch.embed.shard import (EmbeddingShard, EmbeddingShardServer,
                                    _emit_embed)

__all__ = ["ShardRegistration", "EmbedService"]


class ShardRegistration:
    """Keep one shard's membership lease alive.

    coordinator: a Coordinator (in-process) or a CoordinatorServer
    proxy — both expose join/worker_heartbeat/leave. The heartbeat
    thread re-JOINS when the coordinator answers -1 (our lease lapsed,
    e.g. a long GC pause or a coordinator restart): the endpoint gets
    re-published, so directory-based clients recover on their own."""

    def __init__(self, coordinator: Any, shard: EmbeddingShard,
                 endpoint: str, heartbeat_s: float = 1.0):
        self.coordinator = coordinator
        self.shard = shard
        self.endpoint = endpoint
        self.worker_id = f"embed/{shard.shard_id}"
        self.heartbeat_s = float(heartbeat_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.generation: Optional[int] = None
        self.rejoins = 0

    def _info(self) -> Dict[str, Any]:
        return {"role": "embed_shard", "endpoint": self.endpoint,
                "shard_id": self.shard.shard_id,
                "num_shards": self.shard.num_shards,
                "dim": self.shard.dim}

    def join(self) -> "ShardRegistration":
        grant = self.coordinator.join(self.worker_id, self._info())
        self.generation = grant["generation"]
        self._thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"pt-embed-hb-{self.shard.shard_id}")
        self._thread.start()
        return self

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_s):
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

    def stop(self, leave: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if leave:
            try:
                self.coordinator.leave(self.worker_id)
            except Exception:  # noqa: BLE001 — best-effort goodbye
                pass


class _Member:
    """One live shard: table + server + (optional) registration."""

    def __init__(self, shard, server, registration):
        self.shard = shard
        self.server = server
        self.registration = registration


class EmbedService:
    """In-process N-shard embedding service (the test, phase and demo harness).

    store: shared snapshot/WAL KVStore (default InMemStore — it must be
    SHARED so a replacement can restore a dead shard's key range).
    coordinator: optional; when given, every shard registers on the
    membership plane and :meth:`client` resolves endpoints through it
    (the failover path); without one, clients get a static endpoint map.
    """

    def __init__(self, num_shards: int, dim: int, *,
                 store: Optional[KVStore] = None, coordinator: Any = None,
                 seed: int = 0, init_std: float = 0.01,
                 heartbeat_s: float = 0.2, restore: bool = False):
        self.num_shards = int(num_shards)
        self.dim = int(dim)
        self.seed = int(seed)
        self.init_std = float(init_std)
        self.store = store if store is not None else InMemStore()
        self.coordinator = coordinator
        self.heartbeat_s = float(heartbeat_s)
        self._lock = named_lock("embed.service")
        self._members: Dict[int, _Member] = {}  # ptlint: guarded-by(embed.service)
        for sid in range(self.num_shards):
            self._spawn(sid, restore=restore)

    def _spawn(self, shard_id: int, restore: bool) -> _Member:
        shard = EmbeddingShard(shard_id, self.num_shards, self.dim,
                               seed=self.seed, init_std=self.init_std,
                               store=self.store)
        if restore:
            shard.restore_from_store()
        server = EmbeddingShardServer(shard).start()
        registration = None
        if self.coordinator is not None:
            registration = ShardRegistration(
                self.coordinator, shard, server.endpoint,
                heartbeat_s=self.heartbeat_s).join()
        member = _Member(shard, server, registration)
        with self._lock:
            self._members[shard_id] = member
        return member

    # ------------------------------------------------------------- accessors
    def shard(self, shard_id: int) -> EmbeddingShard:
        with self._lock:
            return self._members[shard_id].shard

    def server(self, shard_id: int) -> EmbeddingShardServer:
        with self._lock:
            return self._members[shard_id].server

    def endpoints(self) -> Dict[int, str]:
        with self._lock:
            return {sid: m.server.endpoint
                    for sid, m in self._members.items()}

    def client(self, **kw) -> EmbeddingClient:
        """A client wired to this service — through the coordinator
        directory when there is one (failover-capable), else the static
        endpoint map."""
        if self.coordinator is not None:
            kw.setdefault("coordinator", self.coordinator)
        else:
            kw.setdefault("endpoints", self.endpoints())
        return EmbeddingClient(self.num_shards, self.dim, **kw)

    # -------------------------------------------------------------- failover
    def kill(self, shard_id: int):
        """SIGKILL twin: tear the shard's server out with no snapshot
        and no goodbye — its lease lapses on its own. The dead table
        object is dropped; only the store (snapshot + WAL) survives,
        which is the point."""
        with self._lock:
            member = self._members.pop(shard_id)
        if member.registration is not None:
            # the heartbeat thread dies WITHOUT leave() — the lease must
            # lapse exactly as a killed process's would
            member.registration.stop(leave=False)
        member.server.kill()

    def replace(self, shard_id: int) -> EmbeddingShard:
        """Spawn the replacement: restore the key range from
        snapshot+WAL, serve on a NEW endpoint, re-join the membership
        plane under the same worker id. Any remnant of the dead member
        (a server the chaos seam killed in place, its lease keeper) is
        reaped first — a real SIGKILL takes the whole process; the
        in-process twin has to collect the corpse itself."""
        with self._lock:
            old = self._members.pop(shard_id, None)
        if old is not None:
            if old.registration is not None:
                old.registration.stop(leave=False)
            if not old.server._dead:
                old.server.kill()
        member = self._spawn(shard_id, restore=True)
        _emit_embed("shard_replaced", shard_id=shard_id,
                    replayed=member.shard.stats()["replayed_wal"],
                    endpoint=member.server.endpoint)
        return member.shard

    # ------------------------------------------------------------- integrity
    def table_digest(self) -> str:
        """Combined digest over every live shard (sorted by shard id) —
        THE acceptance value: equal across an uninterrupted run and a
        kill/replace run iff no update was lost or doubled."""
        with self._lock:
            members = sorted(self._members.items())
        h = hashlib.md5()
        for sid, m in members:
            h.update(f"{sid}:{m.shard.digest()};".encode())
        return h.hexdigest()

    def snapshot_all(self) -> Dict[int, int]:
        with self._lock:
            members = sorted(self._members.items())
        return {sid: m.shard.save_snapshot() for sid, m in members}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            members = sorted(self._members.items())
        return {"num_shards": self.num_shards, "dim": self.dim,
                "live_shards": len(members),
                "shards": {sid: m.shard.stats() for sid, m in members}}

    # ------------------------------------------------------------- lifecycle
    def stop(self):
        with self._lock:
            members = list(self._members.values())
            self._members.clear()
        for m in members:
            if m.registration is not None:
                m.registration.stop(leave=True)
            m.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
