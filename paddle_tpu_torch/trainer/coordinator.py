"""Elastic training coordinator — the port of
``paddle_tpu/trainer/coordinator.py`` (host-only: no tensor crosses it).

The go/master design: the coordinator partitions a dataset's chunk list
into tasks, serves them to stateless trainers over RPC, re-queues a task
whose trainer died (a renewable per-task lease), drops a task that
failed ``failure_max`` times, snapshots its queues to a KVStore so it
can restart itself, and elects one trainer to save the model.

  - Coordinator        — task queues todo/pending/done, epochs, the
                         elastic membership (join/leave/heartbeat with
                         generations and a canonical reshard), the
                         fleet's MemoryPlan, snapshot/recover and the
                         save election
  - KVStore            — the snapshot store: InMemStore, FileStore
                         (framed, crc-checked, tolerant of torn files),
                         RpcStore (chunked binary over XML-RPC) served
                         by KVStoreServer
  - CoordinatorServer  — a threading stdlib XML-RPC server, so trainer
                         PROCESSES share one coordinator
  - task_reader        — the client side: pulls tasks, yields records,
                         heartbeats the lease, reports finish/failure

The RPC method names, their argument order, the grant dicts and the
snapshot bytes are the JAX package's, so a trainer of either package
works against a coordinator of the other. Every lease and deadline
reads the clock through ``Coordinator.time`` (patch it to drive leases
without waiting). Journal events and the ``paddle_tpu_coord_*`` gauges
go through the port's obs package; threads are named ``pt-coord-*``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from paddle_tpu_torch.analysis.lockdep import named_lock


@dataclasses.dataclass
class Task:
    task_id: int
    chunks: List[Any]           # opaque chunk descriptors (paths, ranges…)
    epoch: int = 0
    num_failures: int = 0
    #: in-flight reader position handed back by a gracefully departing
    #: worker (task_release): {"records_consumed": n, ...} — the next
    #: holder resumes after the consumed prefix instead of re-reading
    #: it (exactly-once across a reshape)
    resume_state: Optional[Dict[str, Any]] = None


class KVStore:
    """Snapshot store interface (the etcd stand-in)."""

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError


class InMemStore(KVStore):
    """go/master/inmem_store.go parity."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = named_lock("coord.store")

    def put(self, key, value):
        with self._lock:
            self._data[key] = value

    def get(self, key):
        with self._lock:
            return self._data.get(key)


class FileStore(KVStore):
    """Durable snapshot store on a shared filesystem.

    Writes are ATOMIC (tmp + ``os.replace``, the recordio/checkpoint
    protocol — a crash mid-write never leaves a torn value at the final
    path, and a failed write removes its tmp) and FRAMED (magic + crc32
    + length header), so :meth:`get` detects a torn or bit-rotted value
    and returns ``None`` with a warning instead of handing garbage to
    the recovery path — a corrupt snapshot must degrade to a fresh
    partition, not kill the coordinator. Unframed files (an older
    writer, hand-dropped content) pass through verbatim."""

    _MAGIC = b"PTKV1\n"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_"))

    def put(self, key, value):
        import zlib
        tmp = self._path(key) + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(self._MAGIC)
                f.write((zlib.crc32(value) & 0xFFFFFFFF)
                        .to_bytes(4, "little"))
                f.write(len(value).to_bytes(8, "little"))
                f.write(value)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        os.replace(tmp, self._path(key))

    def get(self, key):
        import warnings
        import zlib
        try:
            with open(self._path(key), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            warnings.warn(
                f"FileStore: could not read {key!r} ({e}); treating as "
                "absent", stacklevel=2)
            return None
        if not blob.startswith(self._MAGIC):
            return blob          # legacy/unframed value: pass through
        hdr_end = len(self._MAGIC) + 12
        if len(blob) < hdr_end:
            warnings.warn(
                f"FileStore: {key!r} is torn (truncated header); "
                "treating as absent", stacklevel=2)
            return None
        crc = int.from_bytes(blob[len(self._MAGIC):len(self._MAGIC) + 4],
                             "little")
        size = int.from_bytes(blob[len(self._MAGIC) + 4:hdr_end],
                              "little")
        value = blob[hdr_end:]
        if len(value) != size or (zlib.crc32(value) & 0xFFFFFFFF) != crc:
            warnings.warn(
                f"FileStore: {key!r} is torn or corrupt "
                f"({len(value)} of {size} bytes, crc "
                f"{'ok' if len(value) == size else 'n/a'}); treating "
                "as absent", stacklevel=2)
            return None
        return value


#: chunk-manifest magic for RpcStore values split across several keys —
#: multi-MB payloads (embedding shard snapshots) would otherwise hit the
#: server's single-value size guard and bloat one XML-RPC body
_CHUNK_MAGIC = b"PTCHUNK1\n"


class RpcStore(KVStore):
    """KVStore client over XML-RPC (a :class:`KVStoreServer`) — the
    snapshot store WITHOUT a shared filesystem: the coordinator (or a
    standby) keeps its queue state on a remote process exactly like the
    reference kept the master state in etcd. Values travel as
    ``xmlrpc.client.Binary`` (JSON snapshots are bytes, not text), every
    call retries transport blips through :func:`call_with_retry`, and a
    lock serializes calls (a ``ServerProxy`` is not thread-safe).

    Values larger than ``chunk_bytes`` are split across
    ``key + ".chunk.<i>"`` keys with a crc-stamped manifest written at
    the base key LAST — a reader either sees the old value or a
    manifest whose chunks are already durable. A torn/corrupt chunk set
    (partial overwrite, missing chunk, crc mismatch) reads as *absent*
    with a warning, mirroring :class:`FileStore` torn-frame semantics."""

    def __init__(self, host: str, port: int,
                 retry: Optional["RetryPolicy"] = None,
                 chunk_bytes: int = 2 * 1024 * 1024):
        from xmlrpc.client import ServerProxy
        self._proxy = ServerProxy(f"http://{host}:{port}",
                                  allow_none=True)
        self._retry = retry
        self.chunk_bytes = int(chunk_bytes)
        self._lock = named_lock("coord.rpcstore")

    def _rpc_put(self, key: str, value: bytes):
        from xmlrpc.client import Binary
        with self._lock:
            # the lock serializes the non-thread-safe ServerProxy: the
            # RPC is the critical section
            call_with_retry(self._proxy.put, str(key), Binary(value),
                            policy=self._retry)

    def _rpc_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            # the lock serializes the non-thread-safe ServerProxy: the
            # RPC is the critical section
            blob = call_with_retry(self._proxy.get, str(key),
                                   policy=self._retry)
        return None if blob is None else blob.data

    def put(self, key, value):
        import zlib
        value = bytes(value)
        if len(value) <= self.chunk_bytes:
            self._rpc_put(str(key), value)
            return
        n = (len(value) + self.chunk_bytes - 1) // self.chunk_bytes
        for i in range(n):
            part = value[i * self.chunk_bytes:(i + 1) * self.chunk_bytes]
            self._rpc_put(f"{key}.chunk.{i}", part)
        manifest = _CHUNK_MAGIC + json.dumps(
            {"n": n, "size": len(value),
             "crc": zlib.crc32(value) & 0xFFFFFFFF}).encode()
        self._rpc_put(str(key), manifest)

    def get(self, key):
        import warnings
        import zlib
        raw = self._rpc_get(str(key))
        if raw is None or not raw.startswith(_CHUNK_MAGIC):
            return raw
        try:
            meta = json.loads(raw[len(_CHUNK_MAGIC):].decode())
            n, size, crc = int(meta["n"]), int(meta["size"]), \
                int(meta["crc"])
        except Exception:  # noqa: BLE001 — not a manifest after all
            return raw
        parts = []
        for i in range(n):
            part = self._rpc_get(f"{key}.chunk.{i}")
            if part is None:
                warnings.warn(
                    f"RpcStore: {key!r} chunk {i}/{n} missing (torn "
                    "chunked write); treating as absent", stacklevel=2)
                return None
            parts.append(part)
        value = b"".join(parts)
        if len(value) != size or (zlib.crc32(value) & 0xFFFFFFFF) != crc:
            warnings.warn(
                f"RpcStore: {key!r} chunked value torn or corrupt "
                f"({len(value)} of {size} bytes); treating as absent",
                stacklevel=2)
            return None
        return value


class KVStoreServer:
    """Serve any :class:`KVStore` over XML-RPC for :class:`RpcStore`
    clients (threaded; handler threads named ``pt-coord-kv-*``). A
    single-value size guard rejects bodies above ``max_value_bytes`` —
    big payloads must ride the client's chunked path instead of turning
    one XML-RPC body into a memory bomb."""

    def __init__(self, store: Optional[KVStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_value_bytes: int = 8 * 1024 * 1024):
        from xmlrpc.client import Binary
        self.store = store or InMemStore()
        self.max_value_bytes = int(max_value_bytes)
        self.server = _ThreadingXMLRPCServer(
            (host, port), allow_none=True, logRequests=False,
            thread_prefix="pt-coord-kv")
        self.port = self.server.server_address[1]

        def put(key, value):
            data = value.data if isinstance(value, Binary) else \
                bytes(value)
            if len(data) > self.max_value_bytes:
                raise ValueError(
                    f"KVStoreServer: value for {key!r} is {len(data)} "
                    f"bytes > max_value_bytes={self.max_value_bytes}; "
                    "use RpcStore's chunked put")
            self.store.put(str(key), data)
            return True

        def get(key):
            v = self.store.get(str(key))
            return None if v is None else Binary(v)

        self.server.register_function(put, "put")
        self.server.register_function(get, "get")
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="pt-coord-kv")
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


_SNAPSHOT_KEY = "coordinator/state"


def _emit_coord(kind: str, **fields):
    """Journal one ``coordinator/*`` membership event (join, leave,
    lease_expired, reshard, generation) — run_id/host stamped by the
    journal itself; never raises into the dispatch path."""
    try:
        from paddle_tpu_torch.obs.events import emit
        emit("coordinator", kind, **fields)
    except Exception:  # noqa: BLE001 — obs must not break dispatch
        pass


#: weakref to the most recently constructed Coordinator — the registry
#: collector scrapes it so /metrics shows fleet membership without the
#: coordinator having to push gauges on every transition
_LIVE_COORD = None
_COLLECTOR_INSTALLED = False


def _coord_collector():
    from paddle_tpu_torch.obs.metrics import SampleFamily
    coord = _LIVE_COORD() if _LIVE_COORD is not None else None
    if coord is None:
        return []
    st = coord.stats()
    out = []
    gauges = (
        ("workers", "live workers holding a membership lease"),
        ("generation", "membership generation (bumps on every reshape)"),
        ("tasks_todo", "tasks waiting to be served"),
        ("tasks_pending", "tasks leased out to workers"),
        ("tasks_done", "tasks finished this epoch"),
        ("tasks_dropped", "tasks dropped after failure_max failures"),
        ("stale_grants", "task completions rejected for carrying a "
                         "superseded generation"),
        ("epoch", "current data pass"),
    )
    for key, help_ in gauges:
        fam = SampleFamily(f"paddle_tpu_coord_{key}", "gauge", help_)
        fam.add({}, float(st[key]))
        out.append(fam)
    return out


def _install_coord_collector():
    """Register the membership collector once per process (collectors
    survive MetricsRegistry.reset(), so tests see fresh values but the
    registration itself persists)."""
    global _COLLECTOR_INSTALLED
    if _COLLECTOR_INSTALLED:
        return
    try:
        from paddle_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.register_collector(_coord_collector)
        _COLLECTOR_INSTALLED = True
    except Exception:  # noqa: BLE001 — obs must not break dispatch
        pass


class Coordinator:
    """Task dispatch with lease re-queue and bounded failures.

    Mirrors go/master/service.go taskQueues {todo, pending, done, failed}:
    partition (:106), GetTask (:368), TaskFinished (:410), TaskFailed
    (:448), checkTimeoutFunc (:341), snapshot (:207), recover (:166).

    ``timeout_s`` is a renewable LEASE, not a wall-clock budget: a served
    task must finish (or heartbeat) within it. A slow-but-alive trainer
    calls :meth:`heartbeat` to extend its lease; a dead trainer stops
    heartbeating and its task is re-served to someone else — the server
    distinguishes slow from dead instead of guessing a global timeout.
    """

    def __init__(self, chunks: Sequence[Any], chunks_per_task: int = 1,
                 timeout_s: float = 60.0, failure_max: int = 3,
                 store: Optional[KVStore] = None,
                 worker_lease_s: Optional[float] = None):
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        #: membership lease (join/worker_heartbeat renew it; expiry is
        #: an implicit leave) — defaults to the task lease
        self.worker_lease_s = timeout_s if worker_lease_s is None \
            else worker_lease_s
        self.store = store or InMemStore()
        self._lock = named_lock("coord.state")
        self._save_lock = named_lock("coord.save")
        self._saving_for_epoch = -1
        self._saving_trainer: Optional[str] = None
        self._last_save_grant = float("-inf")
        self._todo: List[Task] = []
        # id -> {task, deadline, worker_id, generation}
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._done: List[Task] = []
        self._failed_dropped: List[Task] = []
        self._epoch = 0
        self._next_id = 0
        self._chunks = list(chunks)
        self._chunks_per_task = chunks_per_task
        # ----- elastic membership (v2) -----
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._generation = 0
        self._memory_plan: Optional[dict] = None
        self._stale_grants = 0
        self._grants = 0
        #: fault-injection seam (a test's membership script):
        #: called OUTSIDE the lock as (grant_index, grant_dict) right
        #: after each successful get_task grant
        self._grant_interceptor: \
            Optional[Callable[[int, Dict[str, Any]], None]] = None
        self._expiry_times: List[float] = []
        self._recovered = self._recover()
        if not self._recovered:
            self._partition()
            self._snapshot()
        global _LIVE_COORD
        import weakref
        _LIVE_COORD = weakref.ref(self)
        _install_coord_collector()

    # ------------------------------------------------------------- queues
    def _partition(self):
        """service.go:106 — split chunk list into tasks."""
        self._todo = []
        cpt = self._chunks_per_task
        for i in range(0, len(self._chunks), cpt):
            self._todo.append(Task(self._next_id, self._chunks[i:i + cpt],
                                   self._epoch))
            self._next_id += 1

    def get_task(self, epoch: Optional[int] = None,
                 worker_id: Optional[str] = None
                 ) -> Optional[Dict[str, Any]]:
        """Next task (re-queueing timed-out pending tasks first). Returns
        {task_id, chunks, generation, resume_state} or None when the
        queue is empty — pass the `epoch` the caller is working on to
        also get None once that pass has turned over (so per-pass readers
        terminate; the queue itself refills every epoch like the Go
        master's turnover). A ``worker_id`` renews that worker's
        membership lease and ties the grant to it, so a graceful leave
        (or lease expiry) re-queues exactly this worker's tasks."""
        with self._lock:
            self._expire_workers_locked()
            self._requeue_timed_out()
            if worker_id is not None and worker_id in self._workers:
                self._workers[worker_id]["deadline"] = \
                    self.time() + self.worker_lease_s
            if epoch is not None and self._epoch != epoch:
                return None
            if not self._todo:
                return None
            task = self._todo.pop(0)
            self._pending[task.task_id] = {
                "task": task, "deadline": self.time() + self.timeout_s,
                "worker_id": worker_id, "generation": self._generation}
            grant = {"task_id": task.task_id, "chunks": task.chunks,
                     "generation": self._generation,
                     "resume_state": task.resume_state}
            task.resume_state = None      # consumed by this grant
            idx = self._grants
            self._grants += 1
            hook = self._grant_interceptor
            self._snapshot()
        if hook is not None:
            # outside the lock: the hook may join()/leave() workers
            # (a test's membership script) without deadlocking
            hook(idx, grant)
        return grant

    def _stale(self, kind: str, task_id: int, generation: int,
               stamped: Optional[int]) -> bool:
        """Reject a completion carrying a superseded grant — called
        under _lock. The check is against the GENERATION STAMPED ON THE
        GRANT (not the current one): a live worker finishing work it
        was granted before a reshape is still accepted exactly once; a
        zombie finishing a task that was re-queued and re-granted after
        its membership lapsed is refused, so the record counts stay
        exactly-once."""
        if stamped is None or generation == stamped:
            return False
        self._stale_grants += 1
        _emit_coord("stale_grant", rpc=kind, task_id=task_id,
                    grant_generation=generation,
                    current_generation=self._generation)
        return True

    def task_finished(self, task_id: int,
                      generation: Optional[int] = None) -> bool:
        with self._lock:
            ent = self._pending.get(task_id)
            if ent is None:
                return False
            if generation is not None and self._stale(
                    "task_finished", task_id, generation,
                    ent.get("generation")):
                return False
            self._pending.pop(task_id)
            self._done.append(ent["task"])
            if not self._todo and not self._pending:
                self._turn_epoch()
            self._snapshot()
            return True

    def task_release(self, task_id: int,
                     generation: Optional[int] = None,
                     state: Optional[Dict[str, Any]] = None) -> bool:
        """Gracefully hand a leased task back (no failure penalty): a
        departing worker returns the task WITH its reader position so
        the next holder resumes after the consumed prefix — the elastic
        counterpart of the dead-trainer lease expiry, preserving
        exactly-once accounting across a planned reshape."""
        with self._lock:
            ent = self._pending.get(task_id)
            if ent is None:
                return False
            if generation is not None and self._stale(
                    "task_release", task_id, generation,
                    ent.get("generation")):
                return False
            self._pending.pop(task_id)
            task: Task = ent["task"]
            if state:
                task.resume_state = dict(state)
            self._todo.append(task)
            self._todo.sort(key=lambda t: (t.epoch, t.task_id))
            self._snapshot()
            return True

    def heartbeat(self, task_id: int) -> bool:
        """Renew the lease on a pending task (the client-side reader
        beats every lease/3 while it processes the task's records).
        Returns False when the lease is already gone — the task was
        finished, failed, or re-served to another trainer; the caller
        should treat its work as superseded."""
        with self._lock:
            ent = self._pending.get(task_id)
            if ent is None:
                return False
            if ent["deadline"] <= self.time():
                # the lease already lapsed — the task belongs to the
                # queue again (a late heartbeat must not resurrect it
                # after another trainer may have been promised it)
                self._requeue_timed_out()
                return False
            ent["deadline"] = self.time() + self.timeout_s
            return True

    def task_failed(self, task_id: int,
                    generation: Optional[int] = None) -> bool:
        """service.go:448 + processFailedTask:313 — re-queue with bounded
        retries; after failure_max the task is dropped (bad data skipped,
        training continues)."""
        with self._lock:
            ent = self._pending.get(task_id)
            if ent is None:
                return False
            if generation is not None and self._stale(
                    "task_failed", task_id, generation,
                    ent.get("generation")):
                return False
            self._pending.pop(task_id)
            task: Task = ent["task"]
            task.num_failures += 1
            if task.num_failures >= self.failure_max:
                self._failed_dropped.append(task)
            else:
                self._todo.append(task)
            if not self._todo and not self._pending:
                self._turn_epoch()
            self._snapshot()
            return True

    def _requeue_timed_out(self):
        now = self.time()
        mutated = False
        for tid in list(self._pending):
            if self._pending[tid]["deadline"] <= now:
                ent = self._pending.pop(tid)
                task = ent["task"]
                task.num_failures += 1
                mutated = True
                if task.num_failures >= self.failure_max:
                    self._failed_dropped.append(task)
                else:
                    self._todo.append(task)
        # Mirror task_failed: if the last outstanding task died by timeout
        # (its trainer crashed — the module's whole point) the pass must
        # still turn over, or the queue drains forever (processFailedTask
        # behavior, go/master/service.go:313).
        if not self._todo and not self._pending and \
                (self._done or self._failed_dropped):
            self._turn_epoch()
        if mutated:
            # persist failure counts / turnover even if the caller's
            # get_task then returns None (a restart must not reset them)
            self._snapshot()

    def _turn_epoch(self):
        """All tasks done: start the next pass (service.go:410 turns the
        todo queue over from done)."""
        self._epoch += 1
        self._done = []
        self._failed_dropped = []
        self._partition()

    # -------------------------------------------- elastic membership (v2)
    def join(self, worker_id: str,
             info: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """A worker enters the fleet (scale-out, or a replacement for a
        dead host). Grants a membership lease, bumps the generation
        (stale grants from the previous membership are then rejected at
        task_finished/task_failed), and returns everything the joiner
        needs to start safely: the generation, the current epoch, the
        live roster, and the published :class:`MemoryPlan` meta — a
        replacement host with less HBM adopts the known-safe microbatch
        plan (provenance="adopted") instead of re-OOMing through a
        fresh probe."""
        with self._lock:
            self._expire_workers_locked()
            rejoin = worker_id in self._workers
            self._workers[worker_id] = {
                "info": dict(info or {}),
                "joined_at": self.time(),
                "deadline": self.time() + self.worker_lease_s,
            }
            if not rejoin:
                self._reshard_locked("join", worker_id=worker_id)
            _emit_coord("join", worker_id=worker_id, rejoin=rejoin,
                        generation=self._generation,
                        workers=len(self._workers))
            self._snapshot()
            return {"generation": self._generation,
                    "epoch": self._epoch,
                    "workers": sorted(self._workers),
                    "memory_plan": self._memory_plan}

    def leave(self, worker_id: str) -> bool:
        """Graceful departure (scale-in): the worker's leased tasks go
        back to todo WITHOUT a failure penalty (it didn't fail — it was
        asked to shrink), the generation bumps, and the queues reshard
        deterministically. Tasks the worker released beforehand via
        :meth:`task_release` carry their reader position."""
        with self._lock:
            if self._workers.pop(worker_id, None) is None:
                return False
            self._release_worker_tasks_locked(worker_id, penalty=False)
            self._reshard_locked("leave", worker_id=worker_id)
            _emit_coord("leave", worker_id=worker_id,
                        generation=self._generation,
                        workers=len(self._workers))
            self._snapshot()
            return True

    def worker_heartbeat(self, worker_id: str) -> int:
        """Renew a membership lease; returns the current generation so
        workers learn about a reshape from their own heartbeat instead
        of a broadcast channel. An unknown worker_id gets -1 — it was
        expired (or never joined) and must re-join."""
        with self._lock:
            self._expire_workers_locked()
            w = self._workers.get(worker_id)
            if w is None:
                return -1
            w["deadline"] = self.time() + self.worker_lease_s
            return self._generation

    def _release_worker_tasks_locked(self, worker_id: str,
                                     penalty: bool):
        """Re-queue every pending task granted to ``worker_id`` —
        failure-counted on an implicit leave (lease expiry: the worker
        may be dead mid-record), free on a graceful one."""
        for tid in list(self._pending):
            if self._pending[tid].get("worker_id") != worker_id:
                continue
            ent = self._pending.pop(tid)
            task: Task = ent["task"]
            if penalty:
                task.num_failures += 1
                if task.num_failures >= self.failure_max:
                    self._failed_dropped.append(task)
                    continue
            self._todo.append(task)
        # the departed worker may have held the pass's last tasks and
        # all of them dropped: the pass must still turn over
        # (_requeue_timed_out's drain rule)
        if not self._todo and not self._pending and \
                (self._done or self._failed_dropped):
            self._turn_epoch()

    def _expire_workers_locked(self):
        """Membership sweep: a worker whose lease lapsed is an IMPLICIT
        leave — its tasks re-queue (with a failure count: it may have
        died mid-record) and the membership generation bumps. A burst of
        expiries is a fleet event, not one sick host: the flight
        recorder dumps a postmortem bundle on a storm (>= 2 within
        10s)."""
        now = self.time()
        expired = [w for w, ent in self._workers.items()
                   if ent["deadline"] <= now]
        if not expired:
            return
        for worker_id in expired:
            self._workers.pop(worker_id, None)
            self._release_worker_tasks_locked(worker_id, penalty=True)
            self._expiry_times.append(now)
            _emit_coord("lease_expired", worker_id=worker_id,
                        workers=len(self._workers))
        self._reshard_locked("lease_expired", expired=sorted(expired))
        self._expiry_times = [t for t in self._expiry_times
                              if now - t <= 10.0]
        if len(self._expiry_times) >= 2:
            # off-thread: the dump scrapes /metrics, whose coordinator
            # collector takes _lock — dumping inline here (under _lock)
            # would self-deadlock the sweep
            try:
                from paddle_tpu_torch.obs.flight import FLIGHT
                threading.Thread(
                    target=FLIGHT.maybe_autodump,
                    args=("coord-lease-expiry-storm",),
                    daemon=True, name="pt-coord-dump").start()
            except Exception:  # noqa: BLE001 — obs must not break sweep
                pass

    def _reshard_locked(self, reason: str, **fields):
        """Deterministic repartition on a membership change — called
        under _lock. The generation bumps (every later grant carries
        the new one; completions stamped with an older grant whose task
        was re-queued are rejected), and the todo queue is sorted into
        the CANONICAL (epoch, task_id) order so every surviving worker
        agrees on what is served next regardless of which host departed
        — the same schedule a fixed-membership run would produce once
        the departed worker's tasks are back in line."""
        self._generation += 1
        self._todo.sort(key=lambda t: (t.epoch, t.task_id))
        _emit_coord("generation", generation=self._generation,
                    reason=reason)
        _emit_coord("reshard", reason=reason,
                    generation=self._generation,
                    todo=len(self._todo), pending=len(self._pending),
                    workers=len(self._workers), **fields)

    def put_memory_plan(self, meta: Optional[Dict[str, Any]]) -> bool:
        """Publish the fleet's known-safe MemoryPlan meta
        (MemoryPlan.to_meta()) so :meth:`join` can hand it to a
        replacement host — checkpoint-meta parity without requiring the
        joiner to read the checkpoint store."""
        with self._lock:
            self._memory_plan = dict(meta) if meta else None
            self._snapshot()
            return True

    @property
    def memory_plan(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return None if self._memory_plan is None \
                else dict(self._memory_plan)

    @property
    def generation(self) -> int:
        """Membership generation — monotonic, bumps on every join /
        leave / lease expiry; stamped on every grant."""
        with self._lock:
            return self._generation

    def workers(self) -> List[str]:
        with self._lock:
            self._expire_workers_locked()
            return sorted(self._workers)

    def worker_info(self, worker_id: str) -> Optional[Dict[str, Any]]:
        """The info dict the worker registered at :meth:`join` — the
        membership plane doubles as a service directory (embedding
        shards publish their RPC endpoint here; clients re-resolve
        through this after a transport failure). ``None`` once the
        lease lapsed, so nobody keeps talking to a ghost."""
        with self._lock:
            self._expire_workers_locked()
            ent = self._workers.get(worker_id)
            return None if ent is None else dict(ent["info"])

    def stats(self) -> Dict[str, Any]:
        """One consistent membership/queue snapshot (the /metrics
        collector and the CLI status line read this)."""
        with self._lock:
            return {"workers": len(self._workers),
                    "generation": self._generation,
                    "epoch": self._epoch,
                    "tasks_todo": len(self._todo),
                    "tasks_pending": len(self._pending),
                    "tasks_done": len(self._done),
                    "tasks_dropped": len(self._failed_dropped),
                    "stale_grants": self._stale_grants,
                    "grants": self._grants}

    def num_stale_grants(self) -> int:
        with self._lock:
            return self._stale_grants

    # ------------------------------------------------------ pass tracking
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def num_dropped(self) -> int:
        with self._lock:
            return len(self._failed_dropped)

    @staticmethod
    def time() -> float:
        """The coordinator's wall clock (unix seconds) — the reference
        clock every worker measures its offset against (sync_clock) so
        merged multi-host timelines share a time base
        (``sync_clock``)."""
        return time.time()

    # ------------------------------------------------- read-only status
    @property
    def chunks(self) -> tuple:
        """The chunk list being served (after snapshot recovery this is
        the RECOVERED list, which may differ from the constructor's)."""
        with self._lock:
            return tuple(self._chunks)

    @property
    def chunks_per_task(self) -> int:
        with self._lock:
            return self._chunks_per_task

    @property
    def recovered(self) -> bool:
        """True when this coordinator restored its queues from a
        snapshot store instead of partitioning the constructor args."""
        return self._recovered

    # --------------------------------------------------------- snapshots
    def _snapshot(self):
        """Gob-snapshot parity (service.go:207) — called under _lock."""
        state = {
            "epoch": self._epoch,
            "next_id": self._next_id,
            "todo": [dataclasses.asdict(t) for t in self._todo],
            # pending tasks snapshot as todo: a recovered master must
            # re-serve them (their trainers may have died with it)
            "pending": [dataclasses.asdict(e["task"])
                        for e in self._pending.values()],
            "done": [dataclasses.asdict(t) for t in self._done],
            "dropped": [dataclasses.asdict(t)
                        for t in self._failed_dropped],
            "chunks": self._chunks,
            "chunks_per_task": self._chunks_per_task,
            # elastic state: the generation survives a coordinator
            # restart (grants from before it stay rejectable); worker
            # leases do NOT — the fleet re-joins a recovered master
            "generation": self._generation,
            "memory_plan": self._memory_plan,
        }
        self.store.put(_SNAPSHOT_KEY, json.dumps(state).encode())

    def _recover(self) -> bool:
        """service.go:166 — restore queues from the store if present.
        A torn/corrupt snapshot (unframed legacy file truncated
        mid-JSON) degrades to a fresh partition with a warning — the
        coordinator re-serves the constructor's chunk list instead of
        dying on its own recovery data."""
        blob = self.store.get(_SNAPSHOT_KEY)
        if not blob:
            return False
        try:
            state = json.loads(blob.decode())
            state["epoch"], state["todo"], state["chunks"]
        except (ValueError, UnicodeDecodeError, KeyError, TypeError) as e:
            import warnings
            warnings.warn(
                f"coordinator snapshot is torn or corrupt ({e!r}); "
                "starting from a fresh partition", stacklevel=2)
            return False
        self._epoch = state["epoch"]
        self._next_id = state["next_id"]
        mk = lambda d: Task(**d)
        self._todo = [mk(d) for d in state["todo"]] + \
            [mk(d) for d in state["pending"]]
        self._done = [mk(d) for d in state["done"]]
        self._failed_dropped = [mk(d) for d in state["dropped"]]
        self._chunks = state["chunks"]
        self._chunks_per_task = state["chunks_per_task"]
        # absent in pre-elastic snapshots: recover tolerantly
        self._generation = int(state.get("generation", 0))
        self._memory_plan = state.get("memory_plan")
        self._pending = {}
        return True

    # ------------------------------------------------------- save election
    def request_save_model(self, epoch: int = None,
                           window_s: float = 30.0,
                           trainer_id: Optional[str] = None) -> bool:
        """RequestSaveModel parity (service.go:474): exactly ONE caller
        wins True and performs the save.

        With an explicit ``epoch``, one winner per epoch. Without one, the
        election is a time window exactly like the Go master's
        (service.go RequestSaveModel dedups within the client-passed
        duration): the first caller in a ``window_s`` span wins. The
        window is resolved server-side under the save lock, so
        concurrent end-of-pass callers cannot both win by observing a
        pass counter mid-turnover.

        ``trainer_id`` mirrors the Go master's TrainerID re-grant: the
        CURRENT saving trainer asking again (same epoch, or within the
        window) gets need=true again instead of a denial — a single
        trainer saving faster than the window never silently skips a
        save. Anonymous callers (trainer_id None) are never re-granted."""
        with self._save_lock:
            regrant = trainer_id is not None and \
                trainer_id == self._saving_trainer
            if epoch is not None:
                if self._saving_for_epoch == epoch and regrant:
                    return True
                if self._saving_for_epoch >= epoch:
                    return False
                self._saving_for_epoch = epoch
                self._saving_trainer = trainer_id
                return True
            now = time.monotonic()
            if now - self._last_save_grant < window_s:
                # the winner re-requesting keeps the grant; the window is
                # NOT refreshed (Go master: saveModelStarted unchanged)
                return regrant
            self._last_save_grant = now
            self._saving_trainer = trainer_id
            return True


# ---------------------------------------------------------------------------
# RPC wrapper (multi-process trainers; go net/rpc parity via stdlib)


def _make_threading_server():
    import socketserver
    from xmlrpc.server import SimpleXMLRPCServer

    class ThreadingXMLRPCServer(socketserver.ThreadingMixIn,
                                SimpleXMLRPCServer):
        """Concurrent request handling for the coordinator RPCs: on the
        single-threaded stdlib server one slow get_task (a snapshot
        write to a sluggish store) serializes behind it every other
        worker's heartbeat — long enough and a HEALTHY worker's lease
        expires spuriously. Handler threads are daemons named
        ``pt-coord-rpc-*`` (the test suite's thread-leak check
        watches the prefix) and die with their request."""

        daemon_threads = True

        def __init__(self, *args, thread_prefix: str = "pt-coord-rpc",
                     **kwargs):
            self._thread_prefix = thread_prefix
            self._request_seq = 0
            super().__init__(*args, **kwargs)

        def process_request(self, request, client_address):
            self._request_seq += 1
            # a per-request handler: it dies with the request, and
            # server.shutdown() is the server's lifecycle
            t = threading.Thread(
                target=self.process_request_thread,
                args=(request, client_address), daemon=True,
                name=f"{self._thread_prefix}-{self._request_seq}")
            t.start()

    return ThreadingXMLRPCServer


_ThreadingXMLRPCServer = _make_threading_server()


class CoordinatorServer:
    """Expose a Coordinator over XML-RPC (threaded stdlib server — one
    handler thread per request, so a blocked RPC cannot starve another
    worker's heartbeat into a spurious lease expiry)."""

    #: RPCs forwarded verbatim to the Coordinator — dispatch +
    #: elastic-membership surface (join/leave/…) + observability
    _RPCS = ("get_task", "task_finished", "task_failed", "task_release",
             "heartbeat", "request_save_model", "time",
             "join", "leave", "worker_heartbeat", "put_memory_plan",
             "stats", "num_dropped", "num_stale_grants", "workers",
             "worker_info")

    def __init__(self, coordinator: Coordinator, host: str = "127.0.0.1",
                 port: int = 0):
        self.coordinator = coordinator
        self.server = _ThreadingXMLRPCServer(
            (host, port), allow_none=True, logRequests=False)
        self.port = self.server.server_address[1]
        for name in self._RPCS:
            self.server.register_function(getattr(coordinator, name), name)
        self.server.register_function(lambda: coordinator.epoch, "epoch")
        self.server.register_function(lambda: coordinator.generation,
                                      "generation")
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="pt-coord-rpc")
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def connect(host: str, port: int):
    """Client proxy for a CoordinatorServer."""
    from xmlrpc.client import ServerProxy
    return ServerProxy(f"http://{host}:{port}", allow_none=True)


# ---------------------------------------------------------------------------
# client-side retry / lease plumbing


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with jitter and a hard deadline for client
    RPCs (the Go client wrapped every master call in a backoff loop,
    go/master/client.go). ``seed`` makes the jitter deterministic — the
    fault-injection tests replay exact schedules."""

    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    deadline: float = 60.0
    jitter: float = 0.25
    seed: int = 0


# transport-level failures worth retrying; an xmlrpc.client.Fault is a
# SERVER-side exception (a bug, not a blip) and is never retried
def _retryable_errors():
    import http.client
    import xmlrpc.client
    return (OSError, xmlrpc.client.ProtocolError, http.client.HTTPException)


def call_with_retry(fn, *args, policy: Optional[RetryPolicy] = None,
                    _sleep=time.sleep):
    """Call ``fn(*args)``, retrying transport failures with exponential
    backoff + jitter until ``policy.deadline`` seconds have elapsed —
    graceful degradation when the coordinator restarts or the network
    blips, a clear TimeoutError when it is really gone."""
    import random
    policy = policy or RetryPolicy()
    rng = random.Random(policy.seed)
    retryable = _retryable_errors()
    delay = policy.base_delay
    start = time.monotonic()
    while True:
        try:
            return fn(*args)
        except retryable as e:
            elapsed = time.monotonic() - start
            if elapsed >= policy.deadline:
                raise TimeoutError(
                    f"coordinator RPC failed for {elapsed:.1f}s "
                    f"(deadline {policy.deadline}s): {e!r}") from e
            d = delay * (1.0 + policy.jitter * (2.0 * rng.random() - 1.0))
            _sleep(max(0.0, min(d, policy.deadline - elapsed)))
            delay = min(delay * policy.multiplier, policy.max_delay)


def sync_clock(coordinator, samples: int = 5,
               journal: bool = True) -> float:
    """Measure this process's wall-clock offset against the
    coordinator's (``offset_s`` = local − coordinator, seconds), using
    the lowest-RTT sample of ``samples`` round trips over the existing
    RPC channel (the NTP trick: the tightest round trip bounds the
    skew estimate best). Works against an in-process Coordinator (a
    trivial ~0 offset) or an xmlrpc proxy.

    The offset is journaled as a ``clock_sync`` record, so a merge of
    several hosts' journals can put this host's records on the
    coordinator's time base with no extra plumbing — call it once after
    connecting, alongside the first heartbeat."""
    remote = getattr(coordinator, "time", None)
    if remote is None:
        raise TypeError("coordinator exposes no time() RPC — old "
                        "server? (CoordinatorServer registers it)")
    best_rtt, best_off = None, 0.0
    for _ in range(max(1, int(samples))):
        t0 = time.time()
        server_t = float(remote())
        t1 = time.time()
        rtt = t1 - t0
        off = (t0 + rtt / 2.0) - server_t
        if best_rtt is None or rtt < best_rtt:
            best_rtt, best_off = rtt, off
    if journal:
        from paddle_tpu_torch.obs.events import emit as journal_emit
        journal_emit("coordinator", "clock_sync", offset_s=best_off,
                     rtt_s=best_rtt, samples=int(samples))
    return best_off


def coordinator_epoch(coordinator, retry: Optional[RetryPolicy] = None
                      ) -> int:
    """Current epoch of an in-process Coordinator (property) or an RPC
    proxy (registered function), optionally retried through a
    RetryPolicy."""
    e = coordinator.epoch
    if not callable(e):
        return e
    if retry is None:
        return e()
    return call_with_retry(e, policy=retry)


def _heartbeat_conn(coordinator):
    """A connection the heartbeat THREAD may use concurrently with the
    reader's. An in-process Coordinator is thread-safe (its lock); an
    xmlrpc ServerProxy is NOT, so the heartbeater gets its own proxy to
    the same endpoint. Returns None when no safe channel exists."""
    import xmlrpc.client as xc
    if isinstance(coordinator, xc.ServerProxy):
        host = coordinator._ServerProxy__host        # "host:port"
        return xc.ServerProxy(f"http://{host}", allow_none=True)
    if isinstance(coordinator, Coordinator):
        return coordinator
    return None                                      # wrapped/unknown


class _Heartbeater:
    """Background lease renewal for one task: beats every
    ``interval`` seconds until stopped. Transport errors are tolerated
    (the next beat retries; a missed lease just re-queues the task); a
    server without the heartbeat RPC (xmlrpc Fault) stops the beats —
    the pre-lease wall-clock timeout then governs, as before."""

    def __init__(self, conn, task_id: int, interval: float):
        self._stop = threading.Event()

        def beat():
            import xmlrpc.client as xc
            while not self._stop.wait(interval):
                try:
                    conn.heartbeat(task_id)
                except xc.Fault:
                    return                       # old server: no leases
                except Exception:
                    pass                         # blip: retry next beat
        self._thread = threading.Thread(target=beat, daemon=True,
                                        name="pt-coord-heartbeat")
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def _chunk_reader_takes_state(fn) -> bool:
    """Does ``chunk_reader`` accept a second (resume_state) positional
    argument? Decided by signature, not by trial call — a TypeError
    raised INSIDE the reader must not be mistaken for arity."""
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    n = 0
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return True
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            n += 1
    return n >= 2


def task_reader(coordinator, chunk_reader: Callable[[Any], Any],
                idle_timeout: float = 600.0, poll_interval: float = 0.2,
                retry: Optional[RetryPolicy] = None,
                heartbeat_interval: Optional[float] = None,
                worker_id: Optional[str] = None,
                on_generation_change: Optional[Callable[[int], None]]
                = None):
    """Reader over coordinator-dispatched tasks (master client NextRecord
    parity, go/master/client.go:232).

    chunk_reader(chunk) -> iterable of records. Yields records; reports
    task_finished after a task's chunks are exhausted and task_failed on a
    reader exception (the task is then retried elsewhere, the bad task
    bounded by failure_max).

    An empty queue whose epoch has NOT turned means other trainers still
    hold pending tasks (one may have died — its lease expires and the
    task re-queues): like the Go client, poll until the pass completes or
    `idle_timeout` seconds pass with nothing to do (raise it when peer
    trainers may legitimately hold a task longer than that).

    Robustness: every RPC goes through
    ``call_with_retry`` — exponential backoff with jitter up to
    ``retry.deadline`` (default 60s), so a coordinator restart or
    network blip delays the reader instead of killing the trainer; a
    coordinator unreachable at startup degrades the same way. While a
    task's records are being consumed, a background heartbeat renews its
    lease every ``heartbeat_interval`` seconds (default: a third of the
    server lease when discoverable, else 5s), so a SLOW trainer keeps
    its task while a DEAD one loses it.

    Elastic mode: with a
    ``worker_id`` every grant is tied to this worker's membership lease
    and stamped with the coordinator's GENERATION; finish/fail report
    that stamp back so a completion superseded by a reshape is rejected
    instead of double-counting records. A grant carrying
    ``resume_state`` (a task gracefully handed back mid-read) skips the
    already-consumed record prefix, and an ABANDONED reader (generator
    closed mid-task — a planned scale-in) releases its task back with
    its own position via ``task_release`` rather than letting the lease
    lapse with a failure count. ``on_generation_change(gen)`` fires
    when a grant reveals a new membership generation (the SGD reshape
    hook rides on it)."""
    retry = retry or RetryPolicy()
    takes_state = _chunk_reader_takes_state(chunk_reader)

    def reader():
        epoch0 = coordinator_epoch(coordinator, retry=retry)
        idle = 0.0
        hb_conn = _heartbeat_conn(coordinator)
        hb_every = heartbeat_interval
        if hb_every is None:
            lease = getattr(coordinator, "timeout_s", None)
            hb_every = lease / 3.0 if isinstance(lease, (int, float)) \
                else 5.0
        last_gen: Optional[int] = None
        while True:
            if worker_id is not None:
                t = call_with_retry(coordinator.get_task, epoch0,
                                    worker_id, policy=retry)
            else:
                t = call_with_retry(coordinator.get_task, epoch0,
                                    policy=retry)
            if t is None:
                if coordinator_epoch(coordinator, retry=retry) != epoch0:
                    return                   # pass completed
                if idle >= idle_timeout:
                    import warnings
                    warnings.warn(
                        f"task_reader: no task served for {idle:.0f}s and "
                        f"epoch {epoch0} never completed — giving up "
                        "(a peer may hold a straggler task; raise "
                        "idle_timeout if that is legitimate)")
                    return
                time.sleep(poll_interval)
                idle += poll_interval
                continue
            idle = 0.0
            gen = t.get("generation") if isinstance(t, dict) else None
            if gen is not None and gen != last_gen:
                if last_gen is not None and \
                        on_generation_change is not None:
                    on_generation_change(gen)
                last_gen = gen
            rs = t.get("resume_state") if isinstance(t, dict) else None
            skip = int((rs or {}).get("records_consumed", 0))
            consumed = 0
            beater = _Heartbeater(hb_conn, t["task_id"], hb_every) \
                if hb_conn is not None else None
            failed = done = False
            try:
                for i, chunk in enumerate(t["chunks"]):
                    it = chunk_reader(chunk, rs if i == 0 else None) \
                        if takes_state else chunk_reader(chunk)
                    for rec in it:
                        if consumed < skip:
                            consumed += 1     # handed-off prefix:
                            continue          # already delivered once
                        consumed += 1
                        yield rec
                done = True
            except GeneratorExit:
                # consumer abandoned the reader mid-task. A worker with
                # an identity hands the task back WITH its position
                # (graceful scale-in: the successor resumes after the
                # consumed prefix — no record lost, none re-read); an
                # anonymous reader keeps the legacy behavior: the lease
                # expires on its own and the task re-queues, exactly
                # the dead-trainer path.
                if worker_id is not None:
                    if beater is not None:
                        beater.stop()
                        beater = None
                    try:
                        call_with_retry(
                            coordinator.task_release, t["task_id"],
                            gen, {"records_consumed": consumed},
                            policy=retry)
                    except Exception:  # noqa: BLE001 — best-effort:
                        pass     # lease expiry then re-queues it
                raise
            except Exception:
                failed = True
            finally:
                if beater is not None:
                    beater.stop()
            if failed:
                call_with_retry(coordinator.task_failed, t["task_id"],
                                gen, policy=retry)
                continue
            if done:
                call_with_retry(coordinator.task_finished, t["task_id"],
                                gen, policy=retry)
    return reader
