"""EmbeddingShard — one hash-partitioned slice of a row-sparse table.

The 2017 pserver reborn on the elastic plane: `ParameterServer2`
(paddle/pserver/ParameterServer2.cpp) held sparse parameter blocks and
served `sendParameter`/`getParameter`; the Go rewrite
(go/pserver/service.go) sharded them by key hash. This module is that
server side on this repo's own substrate:

- rows live in a host dict keyed by int64 id, lazily initialized from a
  DETERMINISTIC per-key seed — a row's initial value is a pure function
  of (key, seed, dim), so a replacement shard that never saw a key
  produces the same row the dead shard would have (digest stability
  across failover does not depend on which keys were ever gathered);
- every applied update batch is WAL-appended to a :class:`KVStore`
  BEFORE it mutates the table or acks — a SIGKILL between append and
  ack leaves an entry the replacement replays and a retry the
  per-client ``applied_seq`` map dedupes: exactly-once, both sides;
- :class:`EmbeddingShardServer` serves row-gather / scatter-update over
  the same threaded XML-RPC plane as the coordinator (handler threads
  ``pt-embed-rpc-*``), with a fault seam (``_rpc_interceptor``) the
  chaos family (o) drives and a ``kill()`` that tears connections
  without a response — the in-process twin of SIGKILL.

Updates reuse the :mod:`paddle_tpu_torch.parallel.async_sgd` reconcile
semantics row-wise (`filter_finite_rows`): a poisoned gradient row is
dropped + counted instead of contaminating the shared table.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.parallel.async_sgd import filter_finite_rows
from paddle_tpu_torch.trainer.coordinator import KVStore, _ThreadingXMLRPCServer
from paddle_tpu_torch.utils.stats import global_counters

__all__ = ["EmbeddingShard", "EmbeddingShardServer", "ShardKilled",
           "stable_hash64", "shard_of"]

#: header/payload separator inside WAL and snapshot frames
_SEP = b"\n\x00"


def stable_hash64(key: int) -> int:
    """splitmix64 — a process-independent key hash (python's builtin
    ``hash`` is salted per process; routing must agree across client,
    shard and replacement)."""
    z = (int(key) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def shard_of(key: int, num_shards: int) -> int:
    """Consistent hash routing: key -> owning shard id. Clients and
    shards must agree; this IS the partition function."""
    return stable_hash64(key) % int(num_shards)


def _emit_embed(kind: str, **fields):
    """Journal one ``embed/*`` event — never raises into the serving or
    update path (same discipline as the coordinator's ``_emit_coord``)."""
    try:
        from paddle_tpu_torch.obs.events import emit
        emit("embed", kind, **fields)
    except Exception:  # noqa: BLE001 — obs must not break the data path
        pass


def _frame(header: Dict[str, Any], *arrays: np.ndarray) -> bytes:
    """json header + raw array payloads, lengths recorded in the header
    (keys/rows ride as raw little-endian bytes — compact, and immune to
    XML-RPC's 32-bit int limit)."""
    payloads = [np.ascontiguousarray(a).tobytes() for a in arrays]
    header = dict(header)
    header["payload_lens"] = [len(p) for p in payloads]
    return json.dumps(header).encode() + _SEP + b"".join(payloads)


def _unframe(blob: bytes):
    head, _, rest = blob.partition(_SEP)
    header = json.loads(head.decode())
    out, off = [], 0
    for n in header["payload_lens"]:
        out.append(rest[off:off + n])
        off += n
    return header, out


class ShardKilled(BaseException):
    """Raised by the chaos family (o) kill seam: a ``BaseException`` so
    the XML-RPC dispatch CANNOT turn it into a marshalled ``Fault`` —
    the connection tears with no response, exactly what the client of a
    SIGKILL'd process observes (and must retry through)."""


class EmbeddingShard:
    """One key-range slice of a hash-partitioned row-sparse table."""

    def __init__(self, shard_id: int, num_shards: int, dim: int, *,
                 seed: int = 0, init_std: float = 0.01,
                 store: Optional[KVStore] = None):
        assert 0 <= shard_id < num_shards
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        self.dim = int(dim)
        self.seed = int(seed)
        self.init_std = float(init_std)
        self.store = store
        self._prefix = f"embed/shard{self.shard_id}"
        self._lock = named_lock("embed.shard")
        self._rows: Dict[int, np.ndarray] = {}   # ptlint: guarded-by(embed.shard)
        self._applied: Dict[str, int] = {}       # ptlint: guarded-by(embed.shard)
        self._wal_seq = 0                        # ptlint: guarded-by(embed.shard)
        self._gathers = 0                        # ptlint: guarded-by(embed.shard)
        self._gathered_rows = 0                  # ptlint: guarded-by(embed.shard)
        self._applied_updates = 0                # ptlint: guarded-by(embed.shard)
        self._updated_rows = 0                   # ptlint: guarded-by(embed.shard)
        self._dup_updates = 0                    # ptlint: guarded-by(embed.shard)
        self._replayed_wal = 0                   # ptlint: guarded-by(embed.shard)
        self.restored = False
        from paddle_tpu_torch.embed.obs import track_shard
        track_shard(self)        # weakref: /metrics + flight bundles
        #: chaos family (o) seam — called under the shard lock AFTER the
        #: WAL append and BEFORE the table mutates/acks, i.e. inside the
        #: torn window a SIGKILL would hit; may raise :class:`ShardKilled`
        self._commit_interceptor: Optional[Callable[[int], None]] = None

    # ------------------------------------------------------------- routing
    def owns(self, key: int) -> bool:
        return shard_of(key, self.num_shards) == self.shard_id

    # ---------------------------------------------------------------- rows
    def _init_row(self, key: int) -> np.ndarray:
        """Deterministic lazy init: a pure function of (key, seed) — any
        shard (original or replacement) derives the same virgin row."""
        rng = np.random.default_rng(
            stable_hash64(int(key) ^ (self.seed * 0x5851F42D4C957F2D)))
        return rng.normal(0.0, self.init_std, self.dim).astype(np.float32)

    def gather(self, keys: Sequence[int]) -> np.ndarray:
        """Row block for ``keys`` ([n, dim] f32). Never-updated keys get
        their deterministic init WITHOUT materializing — the table holds
        only rows an update touched, so the digest covers exactly the
        mutated state."""
        keys = np.asarray(keys, np.int64)
        out = np.empty((len(keys), self.dim), np.float32)
        with self._lock:
            for i, k in enumerate(keys.tolist()):
                row = self._rows.get(k)
                out[i] = self._init_row(k) if row is None else row
            self._gathers += 1
            self._gathered_rows += len(keys)
        return out

    # -------------------------------------------------------------- updates
    def apply_updates(self, client_id: str, seq: int,
                      keys: Sequence[int], grads: np.ndarray,
                      lr: float) -> Dict[str, Any]:
        """Apply one sparse SGD batch exactly once.

        ``seq`` is the client's per-shard monotonic counter (1-based).
        A retry of an already-applied batch (the shard died after the
        WAL append but before the ack) dedupes via the per-client
        ``applied_seq`` map; a gap means the transport reordered or
        dropped an ack the client never retried — a protocol bug, so it
        raises instead of silently corrupting the exactly-once ledger.
        The WAL append happens BEFORE the mutation: a kill in between
        is replayed by the replacement and deduped on retry."""
        seq = int(seq)
        keys = np.asarray(keys, np.int64)
        grads = np.asarray(grads, np.float32).reshape(len(keys), self.dim)
        # reconcile guard, row-wise (AsyncSGDIsland semantics): poisoned
        # rows are dropped from the update, never from the ledger — seq
        # still advances so the stream stays gap-free
        keys, grads = filter_finite_rows(
            keys, grads, counter="embed/poisoned_rows")
        with self._lock:
            last = self._applied.get(client_id, 0)
            if seq <= last:
                self._dup_updates += 1
                global_counters.bump("embed/dup_updates")
                return {"applied": False, "dup": True, "seq": seq}
            if seq != last + 1:
                raise ValueError(
                    f"embed shard {self.shard_id}: client {client_id!r} "
                    f"update seq {seq} leaves a gap after {last} — "
                    "pushes must be applied in order")
            wal_seq = self._wal_seq + 1
            if self.store is not None:
                frame = _frame({"client_id": client_id, "seq": seq,
                                "lr": float(lr), "n": len(keys)},
                               keys, grads)
                self.store.put(f"{self._prefix}/wal/{wal_seq}", frame)
            self._wal_seq = wal_seq
            if self._commit_interceptor is not None:
                # the torn window: WAL durable, table not yet mutated,
                # ack not yet sent — where a real SIGKILL hurts most
                self._commit_interceptor(wal_seq)
            self._apply_rows_locked(keys, grads, float(lr))
            self._applied[client_id] = seq
            self._applied_updates += 1
            self._updated_rows += len(keys)
        return {"applied": True, "dup": False, "seq": seq}

    def _apply_rows_locked(self, keys: np.ndarray, grads: np.ndarray,
                           lr: float):
        for k, g in zip(keys.tolist(), grads):
            row = self._rows.get(k)
            if row is None:
                row = self._init_row(k)
            self._rows[k] = row - lr * g

    # ------------------------------------------------------------ integrity
    def digest(self) -> str:
        """Order-independent md5 over the mutated table state — equal
        across an uninterrupted run and a kill/restore/replay run iff
        every update landed exactly once."""
        with self._lock:
            items = sorted(self._rows.items())
        h = hashlib.md5()
        for k, row in items:
            h.update(np.int64(k).tobytes())
            h.update(np.ascontiguousarray(row, np.float32).tobytes())
        return h.hexdigest()

    def applied_seqs(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._applied)

    # ----------------------------------------------------------- durability
    def save_snapshot(self) -> int:
        """Write the full shard state (rows + applied ledger + the WAL
        horizon) to the store. Serialized under the lock, PUT outside it
        (multi-MB snapshots ride RpcStore's chunked path; updates that
        land mid-put stay replayable past ``wal_upto``). Returns the
        row count saved."""
        assert self.store is not None, "snapshot requires a store"
        with self._lock:
            keys = np.array(sorted(self._rows), np.int64)
            rows = (np.stack([self._rows[k] for k in keys.tolist()])
                    if len(keys) else np.empty((0, self.dim), np.float32))
            header = {"v": 1, "shard_id": self.shard_id,
                      "num_shards": self.num_shards, "dim": self.dim,
                      "seed": self.seed, "wal_upto": self._wal_seq,
                      "applied": dict(self._applied)}
        blob = _frame(header, keys, rows.astype(np.float32))
        self.store.put(f"{self._prefix}/snap", blob)
        _emit_embed("snapshot", shard_id=self.shard_id,
                    rows=int(len(keys)), wal_upto=header["wal_upto"])
        return int(len(keys))

    def restore_from_store(self) -> bool:
        """Recover this key range: load the last snapshot (absent is
        fine — a fresh shard), then replay WAL entries PAST its
        ``wal_upto`` horizon, deduping through the applied ledger the
        snapshot carried. This is what a replacement runs before it
        rejoins the membership plane."""
        assert self.store is not None, "restore requires a store"
        snap = self.store.get(f"{self._prefix}/snap")
        replayed = 0
        with self._lock:
            if snap is not None:
                header, payloads = _unframe(snap)
                assert header["dim"] == self.dim and \
                    header["num_shards"] == self.num_shards, \
                    "snapshot/shard geometry mismatch"
                keys = np.frombuffer(payloads[0], np.int64)
                rows = np.frombuffer(payloads[1], np.float32).reshape(
                    len(keys), self.dim)
                self._rows = {int(k): rows[i].copy()
                              for i, k in enumerate(keys)}
                self._applied = {str(c): int(s)
                                 for c, s in header["applied"].items()}
                self._wal_seq = int(header["wal_upto"])
            while True:
                frame = self.store.get(
                    f"{self._prefix}/wal/{self._wal_seq + 1}")
                if frame is None:
                    break
                header, payloads = _unframe(frame)
                self._wal_seq += 1
                cid, seq = str(header["client_id"]), int(header["seq"])
                if seq <= self._applied.get(cid, 0):
                    self._dup_updates += 1     # retried batch, WAL'd twice
                    continue
                keys = np.frombuffer(payloads[0], np.int64)
                grads = np.frombuffer(payloads[1], np.float32).reshape(
                    len(keys), self.dim)
                self._apply_rows_locked(keys, grads,
                                        float(header["lr"]))
                self._applied[cid] = seq
                replayed += 1
            self._replayed_wal = replayed
            self.restored = snap is not None or replayed > 0
        _emit_embed("restore", shard_id=self.shard_id,
                    from_snapshot=snap is not None, replayed=replayed)
        return self.restored

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"shard_id": self.shard_id,
                    "num_shards": self.num_shards,
                    "dim": self.dim,
                    "rows": len(self._rows),
                    "gathers": self._gathers,
                    "gathered_rows": self._gathered_rows,
                    "applied_updates": self._applied_updates,
                    "updated_rows": self._updated_rows,
                    "dup_updates": self._dup_updates,
                    "replayed_wal": self._replayed_wal,
                    "wal_seq": self._wal_seq,
                    "clients": len(self._applied)}


class _EmbedRPCServer(_ThreadingXMLRPCServer):
    """An XML-RPC server whose handlers can DIE mid-request.

    The stdlib dispatcher marshals ANY escaping exception — including
    ``BaseException`` on current CPython — into a ``Fault`` response; a
    SIGKILL'd process answers NOTHING. So ``_marshaled_dispatch`` is
    re-implemented to let :class:`ShardKilled` propagate: the request
    thread unwinds, ``shutdown_request`` in socketserver's ``finally``
    closes the connection with no response written, and the client
    observes a transport error (the killed-process shape) instead of a
    Fault it could mistake for an answer. ``process_request_thread``
    then swallows the escape to keep the chaos suite's stderr clean."""

    def _marshaled_dispatch(self, data, dispatch_method=None, path=None):
        import xmlrpc.client as xc
        try:
            params, method = xc.loads(
                data, use_builtin_types=self.use_builtin_types)
            if dispatch_method is not None:
                response = dispatch_method(method, params)
            else:
                response = self._dispatch(method, params)
            response = xc.dumps((response,), methodresponse=1,
                                allow_none=self.allow_none,
                                encoding=self.encoding)
        except ShardKilled:
            raise              # tear the connection: NO response at all
        except xc.Fault as fault:
            response = xc.dumps(fault, allow_none=self.allow_none,
                                encoding=self.encoding)
        except Exception as exc:  # noqa: BLE001 — Fault, stdlib contract
            response = xc.dumps(xc.Fault(1, f"{type(exc)}:{exc}"),
                                allow_none=self.allow_none,
                                encoding=self.encoding)
        return response.encode(self.encoding, "xmlrpc")

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        except ShardKilled:
            pass


class EmbeddingShardServer:
    """Serve an :class:`EmbeddingShard` over threaded XML-RPC.

    Wire format: keys ride as ``Binary`` little-endian int64, rows and
    grads as ``Binary`` f32 — immune to XML-RPC's 32-bit int ceiling
    and ~4x smaller than marshalled arrays. Every RPC takes a
    ``trace_id`` (bound into the obs context while handling, so the
    per-RPC journal record and anything nested carries it end-to-end).
    """

    def __init__(self, shard: EmbeddingShard, host: str = "127.0.0.1",
                 port: int = 0):
        from xmlrpc.client import Binary
        self.shard = shard
        self.server = _EmbedRPCServer(
            (host, port), allow_none=True, logRequests=False,
            thread_prefix="pt-embed-rpc")
        self.host = host
        self.port = self.server.server_address[1]
        self.endpoint = f"{host}:{self.port}"
        self._dead = False
        self._seam_lock = named_lock("embed.rpcseam")
        self._rpc_index = 0                 # ptlint: guarded-by(embed.rpcseam)
        #: chaos family (o) seam — called at the TOP of every RPC with
        #: (method, 0-based index); may sleep (slow_shard) or raise
        #: :class:`ShardKilled` (kill_shard)
        self._rpc_interceptor: Optional[Callable[[str, int], None]] = None

        def _seam(method: str):
            with self._seam_lock:
                idx = self._rpc_index
                self._rpc_index += 1
                interceptor = self._rpc_interceptor
                dead = self._dead
            if dead:
                raise ShardKilled(f"shard {shard.shard_id} is killed")
            if interceptor is not None:
                interceptor(method, idx)

        def _bound(trace_id):
            from paddle_tpu_torch.obs import context as obs_context
            return obs_context.bind(
                trace_id=trace_id or obs_context.new_trace_id())

        def ping():
            _seam("ping")
            return {"shard_id": shard.shard_id,
                    "num_shards": shard.num_shards, "dim": shard.dim}

        def gather(keys_blob, trace_id=None):
            _seam("gather")
            keys = np.frombuffer(keys_blob.data, "<i8")
            with _bound(trace_id):
                rows = shard.gather(keys)
                _emit_embed("gather", shard_id=shard.shard_id,
                            rows=len(keys))
            return {"rows": Binary(rows.astype("<f4").tobytes()),
                    "n": len(keys), "dim": shard.dim}

        def scatter_update(client_id, seq, keys_blob, grads_blob, lr,
                           trace_id=None):
            _seam("scatter_update")
            keys = np.frombuffer(keys_blob.data, "<i8")
            grads = np.frombuffer(grads_blob.data, "<f4").reshape(
                len(keys), shard.dim)
            with _bound(trace_id):
                res = shard.apply_updates(str(client_id), int(seq),
                                          keys, grads, float(lr))
                _emit_embed("update", shard_id=shard.shard_id,
                            rows=len(keys), seq=int(seq),
                            dup=bool(res["dup"]))
            return res

        def digest():
            _seam("digest")
            return shard.digest()

        def stats():
            _seam("stats")
            return shard.stats()

        def snapshot_now():
            _seam("snapshot_now")
            return shard.save_snapshot()

        for fn in (ping, gather, scatter_update, digest, stats,
                   snapshot_now):
            self.server.register_function(fn, fn.__name__)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "EmbeddingShardServer":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="pt-embed-rpc")
        self._thread.start()
        return self

    def _serve(self):
        try:
            self.server.serve_forever()
        except OSError:
            if not self._dead:       # killed: listening socket torn out
                raise

    def stop(self):
        """Graceful: finish in-flight requests, close the socket."""
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def kill(self):
        """The SIGKILL twin: mark dead (every in-flight and future RPC
        dies mid-handling with no response) and tear the listening
        socket out so new connections are refused. No snapshot, no
        goodbye to the coordinator — its lease just lapses. The accept
        loop is reaped too (closing the socket alone leaves it spinning
        on an empty selector forever — an in-process-only corpse a real
        SIGKILL would have taken): ``shutdown()`` only stops NEW
        accepts; in-flight handlers still die un-answered on the dead
        flag."""
        with self._seam_lock:
            self._dead = True
        try:
            self.server.socket.close()
        except OSError:
            pass
        self.server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        _emit_embed("shard_killed", shard_id=self.shard.shard_id)
