"""Port parity: paddle_tpu_torch/trainer/coordinator.py on the CPU — the
cases of tests/test_elastic.py (TestCoordinator, TestFileStoreTornFiles)
and tests/test_elastic_membership.py (the membership protocol, the
threading server, the stores, the observability) rewritten for the
port, plus the wire compatibility with the JAX package's coordinator.

Leases run on a fake clock: ``Coordinator.time`` is patched
(``clock`` fixture) and every deadline is stated in its seconds, so no
test waits for a lease to lapse in wall time. Exact comparisons
throughout (the coordinator is host logic: task ids, generations,
snapshot bytes).
"""

import collections
import os
import threading
import time
import xmlrpc.client

import numpy as np
import pytest

from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.obs.events import tail
from paddle_tpu_torch.obs.metrics import REGISTRY
from paddle_tpu_torch.testing.faults import FaultPlan
from paddle_tpu_torch.trainer.coordinator import (Coordinator,
                                                  CoordinatorServer,
                                                  FileStore, InMemStore,
                                                  KVStoreServer, RpcStore,
                                                  connect, task_reader)

RECORDS_PER_CHUNK = 4


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


class FakeClock:
    """The coordinator's clock, advanced by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(Coordinator, "time", staticmethod(c))
    return c


# the port's FaultPlan.membership_script: ``at[i]()`` right after the
# coordinator's i-th grant (0-based from entering), outside its lock,
# through its ``_grant_interceptor`` seam
membership_script = FaultPlan.membership_script


# ------------------------------------------------ tests/test_elastic.py
class TestCoordinator:
    def test_dispatch_and_finish_turns_epoch(self):
        c = Coordinator(chunks=list(range(6)), chunks_per_task=2)
        seen = []
        for _ in range(3):
            t = c.get_task()
            seen.extend(t["chunks"])
            assert c.task_finished(t["task_id"])
        assert sorted(seen) == list(range(6))
        assert c.epoch == 1
        assert c.get_task() is not None

    def test_timeout_requeues(self, clock):
        # task lease 0.05 s of the fake clock; 0.08 s later both lapsed
        c = Coordinator(chunks=[1, 2], chunks_per_task=1, timeout_s=0.05)
        t1, t2 = c.get_task(), c.get_task()
        assert c.get_task() is None
        clock.advance(0.08)
        t3 = c.get_task()
        assert t3 is not None
        assert t3["task_id"] in (t1["task_id"], t2["task_id"])

    def test_timeout_drain_turns_epoch(self, clock):
        # the last task dying by lease expiry (failure_max 1: dropped)
        # must turn the pass over
        c = Coordinator(chunks=[1], chunks_per_task=1, timeout_s=0.03,
                        failure_max=1)
        assert c.get_task() is not None
        clock.advance(0.05)
        t2 = c.get_task()
        assert c.epoch == 1
        assert t2 is not None

    def test_task_reader_over_rpc(self):
        c = Coordinator(chunks=["a", "b"], chunks_per_task=1)
        srv = CoordinatorServer(c).start()
        try:
            client = connect("127.0.0.1", srv.port)
            recs = list(task_reader(client, lambda ch: [ch + "0"])())
            assert sorted(recs) == ["a0", "b0"]
        finally:
            srv.stop()

    def test_failure_max_drops_task(self):
        c = Coordinator(chunks=[1], chunks_per_task=1, failure_max=2)
        t = c.get_task()
        assert c.task_failed(t["task_id"])
        t = c.get_task()
        assert c.task_failed(t["task_id"])
        assert c.epoch == 1

    def test_snapshot_recover(self, tmp_path):
        store = FileStore(str(tmp_path))
        c1 = Coordinator(chunks=list(range(4)), chunks_per_task=1,
                         store=store)
        t = c1.get_task()                    # one task left pending
        c2 = Coordinator(chunks=[], store=store)
        epoch0 = c2.epoch
        served = []
        while True:
            t2 = c2.get_task(epoch0)
            if t2 is None:
                break
            served.append(t2["task_id"])
            c2.task_finished(t2["task_id"])
        assert t["task_id"] in served
        assert len(served) == 4

    def test_save_election(self):
        c = Coordinator(chunks=[1])
        grants = [c.request_save_model(0) for _ in range(5)]
        assert grants.count(True) == 1
        assert c.request_save_model(1) is True

    def test_save_election_regrants_current_trainer(self):
        c = Coordinator(chunks=[1])
        assert c.request_save_model(0, 30.0, "tr-A") is True
        assert c.request_save_model(0, 30.0, "tr-A") is True
        assert c.request_save_model(0, 30.0, "tr-B") is False
        c2 = Coordinator(chunks=[1])
        assert c2.request_save_model(None, 30.0, "tr-A") is True
        assert c2.request_save_model(None, 30.0, "tr-A") is True
        assert c2.request_save_model(None, 30.0, "tr-B") is False
        c3 = Coordinator(chunks=[1])
        assert c3.request_save_model() is True
        assert c3.request_save_model() is False

    def test_public_status_properties(self, tmp_path):
        store = FileStore(str(tmp_path))
        c1 = Coordinator(chunks=list(range(4)), chunks_per_task=2,
                         store=store)
        assert c1.chunks == tuple(range(4))
        assert c1.chunks_per_task == 2
        assert c1.recovered is False
        c2 = Coordinator(chunks=[], store=store)
        assert c2.recovered is True
        assert c2.chunks == tuple(range(4))
        assert c2.chunks_per_task == 2

    def test_task_reader_skips_bad_chunk(self):
        c = Coordinator(chunks=["a", "bad", "b"], chunks_per_task=1,
                        failure_max=2)

        def chunk_reader(chunk):
            if chunk == "bad":
                raise IOError("corrupt chunk")
            yield from [f"{chunk}{i}" for i in range(2)]

        recs = list(task_reader(c, chunk_reader)())
        assert sorted(recs) == ["a0", "a1", "b0", "b1"]
        assert c.num_dropped() in (0, 1)

    def test_rpc_server(self):
        c = Coordinator(chunks=list(range(4)), chunks_per_task=2)
        srv = CoordinatorServer(c).start()
        try:
            client = connect("127.0.0.1", srv.port)
            t = client.get_task()
            assert t is not None and len(t["chunks"]) == 2
            assert client.task_finished(t["task_id"])
            t2 = client.get_task()
            assert client.task_failed(t2["task_id"])
        finally:
            srv.stop()


class TestFileStoreTornFiles:
    def test_put_get_roundtrip(self, tmp_path):
        store = FileStore(str(tmp_path))
        store.put("coordinator/state", b"hello \x00 world")
        assert store.get("coordinator/state") == b"hello \x00 world"
        assert store.get("missing") is None
        assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]

    def test_torn_file_returns_none_with_warning(self, tmp_path):
        store = FileStore(str(tmp_path))
        store.put("k", b"x" * 256)
        path = store._path("k")
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])
        with pytest.warns(UserWarning, match="torn"):
            assert store.get("k") is None

    def test_corrupt_payload_returns_none_with_warning(self, tmp_path):
        store = FileStore(str(tmp_path))
        store.put("k", b"y" * 64)
        path = store._path("k")
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        with pytest.warns(UserWarning, match="torn or corrupt"):
            assert store.get("k") is None

    def test_legacy_unframed_value_passes_through(self, tmp_path):
        store = FileStore(str(tmp_path))
        with open(store._path("legacy"), "wb") as f:
            f.write(b'{"old": "snapshot"}')
        assert store.get("legacy") == b'{"old": "snapshot"}'

    def test_chunked_rpcstore_roundtrip_and_torn_chunk(self):
        backing = InMemStore()
        srv = KVStoreServer(backing, max_value_bytes=256 * 1024).start()
        try:
            store = RpcStore("127.0.0.1", srv.port, chunk_bytes=8 * 1024)
            big = bytes(np.random.default_rng(0).integers(
                0, 256, size=50 * 1024, dtype=np.uint8))
            store.put("embed/snap", big)
            assert store.get("embed/snap") == big
            assert store.get("embed/snap.chunk.0") is not None
            store.put("tiny", b"t")
            assert store.get("tiny") == b"t"
            backing.put("embed/snap.chunk.2", b"")
            with pytest.warns(UserWarning, match="torn or corrupt"):
                assert store.get("embed/snap") is None
            backing._data.pop("embed/snap.chunk.2")
            with pytest.warns(UserWarning, match="missing"):
                assert store.get("embed/snap") is None
            with pytest.raises(xmlrpc.client.Fault):
                store._rpc_put("bomb", b"\x00" * (300 * 1024))
        finally:
            srv.stop()

    def test_coordinator_recovers_fresh_from_torn_snapshot(self, tmp_path):
        store = FileStore(str(tmp_path))
        Coordinator(chunks=list(range(4)), chunks_per_task=1, store=store)
        path = store._path("coordinator/state")
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) - 7])
        with pytest.warns(UserWarning):
            c2 = Coordinator(chunks=list(range(2)), chunks_per_task=1,
                             store=store)
        assert c2.recovered is False
        assert c2.chunks == (0, 1)

    def test_coordinator_recovers_fresh_from_legacy_garbage(self, tmp_path):
        store = FileStore(str(tmp_path))
        with open(store._path("coordinator/state"), "wb") as f:
            f.write(b'{"epoch": 0, "todo": [{"task')
        with pytest.warns(UserWarning, match="torn or corrupt"):
            c = Coordinator(chunks=[9], chunks_per_task=1, store=store)
        assert c.recovered is False
        assert c.chunks == (9,)


# -------------------------------------- tests/test_elastic_membership.py
class TestMembershipProtocol:
    def test_join_bumps_generation_and_returns_roster(self):
        c = Coordinator(list(range(4)), chunks_per_task=1)
        r1 = c.join("w1", info={"host": "a"})
        assert r1["generation"] == 1 and r1["epoch"] == 0
        assert r1["workers"] == ["w1"]
        assert r1["memory_plan"] is None
        r2 = c.join("w2")
        assert r2["generation"] == 2
        assert r2["workers"] == ["w1", "w2"]
        r3 = c.join("w1")                   # a live member: no reshape
        assert r3["generation"] == 2
        assert c.workers() == ["w1", "w2"]
        assert c.worker_info("w1") == {}    # the re-join's info
        assert c.worker_info("ghost") is None

    def test_worker_heartbeat_renews_and_unknown_must_rejoin(self, clock):
        # lease 1 s; beats every 0.6 s keep it over 3 s
        c = Coordinator([1], chunks_per_task=1, worker_lease_s=1.0)
        assert c.worker_heartbeat("ghost") == -1
        c.join("w1")
        for _ in range(5):
            clock.advance(0.6)
            assert c.worker_heartbeat("w1") == c.generation
        clock.advance(1.01)
        assert c.worker_heartbeat("w1") == -1

    def test_leave_requeues_without_penalty_in_canonical_order(self):
        c = Coordinator(list(range(6)), chunks_per_task=1)
        c.join("a")
        c.join("b")
        for _ in range(2):
            assert c.get_task(0, "a") is not None     # tasks 0, 1
        gb = c.get_task(0, "b")                       # task 2
        gen_before = c.generation
        assert c.leave("a") is True
        assert c.generation == gen_before + 1
        assert [t.task_id for t in c._todo] == [0, 1, 3, 4, 5]
        assert all(t.num_failures == 0 for t in c._todo)
        order = []
        while True:
            t = c.get_task(0, "b")
            if t is None:
                break
            order.append(t["task_id"])
            assert c.task_finished(t["task_id"], t["generation"])
        assert order == [0, 1, 3, 4, 5]
        assert c.task_finished(gb["task_id"], gb["generation"])
        assert c.epoch == 1
        assert c.leave("a") is False

    def test_lease_expiry_is_an_implicit_leave(self, clock):
        # membership lease 0.05 s, task lease 30 s
        c = Coordinator([1, 2], chunks_per_task=1, timeout_s=30.0,
                        worker_lease_s=0.05)
        c.join("w1")
        g = c.get_task(0, "w1")
        assert g is not None
        clock.advance(0.08)
        gen_before = c.generation
        assert c.workers() == []
        assert c.generation == gen_before + 1
        requeued = [t for t in c._todo if t.task_id == g["task_id"]]
        assert requeued and requeued[0].num_failures == 1
        assert c.worker_heartbeat("w1") == -1

    def test_stale_grant_rejected_after_requeue(self, clock):
        c = Coordinator([7], chunks_per_task=1, timeout_s=30.0,
                        worker_lease_s=0.05)
        c.join("victim")
        g1 = c.get_task(0, "victim")
        clock.advance(0.08)
        c.join("spare")            # sweeps the victim, requeues its task
        g2 = c.get_task(0, "spare")
        assert g2["task_id"] == g1["task_id"]
        assert g2["generation"] > g1["generation"]
        assert c.task_finished(g1["task_id"], g1["generation"]) is False
        assert c.num_stale_grants() == 1
        assert tail(50, domain="coordinator", kind="stale_grant")
        assert c.task_finished(g2["task_id"], g2["generation"]) is True
        assert c.epoch == 1

    def test_live_workers_pre_reshape_grant_still_accepted(self):
        c = Coordinator([1, 2], chunks_per_task=1)
        c.join("w1")
        g = c.get_task(0, "w1")
        c.join("w2")
        assert c.generation > g["generation"]
        assert c.task_finished(g["task_id"], g["generation"]) is True
        assert c.num_stale_grants() == 0

    def test_task_release_hands_position_to_next_holder(self):
        c = Coordinator([5], chunks_per_task=1)
        c.join("w1")
        g = c.get_task(0, "w1")
        assert c.task_release(g["task_id"], g["generation"],
                              {"records_consumed": 2}) is True
        g2 = c.get_task(0, "w1")
        assert g2["task_id"] == g["task_id"]
        assert g2["resume_state"] == {"records_consumed": 2}
        assert c.task_release(g2["task_id"], g2["generation"]) is True
        assert c.get_task(0, "w1")["resume_state"] is None

    def test_task_reader_skips_released_prefix(self):
        c = Coordinator(["c0"], chunks_per_task=1)
        c.join("w1")
        g = c.get_task(0, "w1")
        c.task_release(g["task_id"], g["generation"],
                       {"records_consumed": 2})
        c.join("w2")
        recs = list(task_reader(
            c, lambda ch: [(ch, i) for i in range(RECORDS_PER_CHUNK)],
            worker_id="w2")())
        assert recs == [("c0", 2), ("c0", 3)]
        assert c.epoch == 1

    def test_abandoned_reader_releases_with_its_position(self):
        """A worker's reader closed mid-task (a planned scale-in) hands
        the task back with the records it consumed."""
        c = Coordinator(["c0", "c1"], chunks_per_task=1)
        c.join("w1")
        rd = task_reader(
            c, lambda ch: [(ch, i) for i in range(RECORDS_PER_CHUNK)],
            worker_id="w1")()
        assert [next(rd) for _ in range(3)] == [("c0", 0), ("c0", 1),
                                                ("c0", 2)]
        rd.close()
        t = c.get_task(0, "w1")
        assert t["chunks"] == ["c0"]
        assert t["resume_state"] == {"records_consumed": 3}

    def test_membership_script_fires_at_exact_grants(self):
        c = Coordinator(list(range(4)), chunks_per_task=1)
        c.join("w1")
        with membership_script(c, {1: lambda: c.join("mid-join")}) as st:
            while True:
                t = c.get_task(0, "w1")
                if t is None:
                    break
                assert c.task_finished(t["task_id"], t["generation"])
        assert st["fired"] == [1]
        assert "mid-join" in c.workers()
        assert c.epoch == 1
        assert c.num_stale_grants() == 0

    def test_kill_and_join_mid_pass_exactly_once(self, clock):
        """TestExactlyOnceChaos single-threaded on the fake clock: w1
        dies holding its second grant, w3 joins at grant 3, w1's lease
        (0.5 s) lapses while w2 and w3 drain the pass; every record is
        accepted exactly once and no live completion is refused."""
        coord = Coordinator(list(range(6)), chunks_per_task=1,
                            timeout_s=0.5, failure_max=10,
                            worker_lease_s=0.5)
        accepted = collections.Counter()
        live = ["w1", "w2"]

        def work(wid, t):
            skip = int((t.get("resume_state") or {})
                       .get("records_consumed", 0))
            recs = [(ch, i) for ch in t["chunks"]
                    for i in range(RECORDS_PER_CHUNK)][skip:]
            if coord.task_finished(t["task_id"], t["generation"]):
                accepted.update(recs)

        for wid in live:
            coord.join(wid)
        with membership_script(coord, {3: lambda: (coord.join("w3"),
                                                   live.append("w3"))}) \
                as st:
            grants = {"w1": 0}
            while coord.epoch == 0:
                progressed = False
                for wid in list(live):
                    t = coord.get_task(0, wid)
                    if t is None:
                        continue
                    progressed = True
                    if wid == "w1":
                        grants["w1"] += 1
                        if grants["w1"] >= 2:
                            live.remove("w1")     # SIGKILL's twin
                            continue
                    work(wid, t)
                if not progressed:
                    clock.advance(0.2)
                    for wid in live:
                        coord.worker_heartbeat(wid)
        for wid in live:
            coord.leave(wid)
        assert st["fired"] == [3]
        assert coord.epoch == 1
        assert accepted == collections.Counter(
            {(c, i): 1 for c in range(6) for i in range(RECORDS_PER_CHUNK)})
        assert coord.num_stale_grants() == 0
        assert coord.workers() == []
        assert {"w1"} == {r["worker_id"] for r in
                          tail(200, domain="coordinator",
                               kind="lease_expired")}


class TestThreadingServer:
    def test_blocked_rpc_does_not_expire_healthy_lease(self, clock):
        """One RPC blocked in a handler thread; heartbeats through a
        second connection keep a 1 s task lease alive over 2 s of the
        fake clock."""
        coord = Coordinator([0, 1], chunks_per_task=1, timeout_s=1.0)
        srv = CoordinatorServer(coord).start()
        entered = threading.Event()
        release = threading.Event()

        def slow():
            entered.set()
            release.wait(15.0)
            return True

        srv.server.register_function(slow, "slow")
        try:
            t = connect("127.0.0.1", srv.port).get_task()
            blocker = threading.Thread(
                target=lambda: connect("127.0.0.1", srv.port).slow(),
                daemon=True, name="pt-test-blocker")
            blocker.start()
            assert entered.wait(10.0)
            c2 = connect("127.0.0.1", srv.port)
            for _ in range(5):
                clock.advance(0.4)
                assert c2.heartbeat(t["task_id"]) is True
            names = [th.name for th in threading.enumerate()]
            assert any(n.startswith("pt-coord-rpc-") for n in names)
            release.set()
            blocker.join(15.0)
            assert c2.task_finished(t["task_id"], t["generation"]) is True
        finally:
            release.set()
            srv.stop()

    def test_membership_rpc_surface(self):
        coord = Coordinator([1, 2], chunks_per_task=1)
        srv = CoordinatorServer(coord).start()
        try:
            c = connect("127.0.0.1", srv.port)
            resp = c.join("rpc-w")
            assert resp["generation"] == 1
            assert c.worker_heartbeat("rpc-w") == 1
            assert c.generation() == 1 and c.epoch() == 0
            assert c.workers() == ["rpc-w"]
            assert c.stats()["workers"] == 1
            assert c.num_stale_grants() == 0
            assert c.put_memory_plan({"microbatch": 4, "accum_steps": 2,
                                      "provenance": "adapted"}) is True
            assert coord.memory_plan["microbatch"] == 4
            g = c.get_task(0, "rpc-w")
            assert c.task_release(g["task_id"], g["generation"],
                                  {"records_consumed": 1}) is True
            assert c.get_task(0, "rpc-w")["resume_state"] == \
                {"records_consumed": 1}
            assert isinstance(c.time(), float)
            assert c.leave("rpc-w") is True
        finally:
            srv.stop()


class TestStores:
    def test_binary_roundtrip_and_missing_key(self):
        kv = KVStoreServer().start()
        try:
            store = RpcStore("127.0.0.1", kv.port)
            store.put("k", b"\x00\xff raw \x01 bytes")
            assert store.get("k") == b"\x00\xff raw \x01 bytes"
            assert store.get("missing") is None
        finally:
            kv.stop()

    def test_coordinator_recovers_through_rpc_store(self):
        kv = KVStoreServer().start()
        try:
            c1 = Coordinator(list(range(4)), chunks_per_task=1,
                             store=RpcStore("127.0.0.1", kv.port))
            c1.join("w1")
            assert c1.get_task(0, "w1") is not None
            c2 = Coordinator([], store=RpcStore("127.0.0.1", kv.port))
            assert c2.recovered
            assert c2.chunks == (0, 1, 2, 3)
            assert c2.generation == c1.generation
            assert c2.workers() == []       # leases are not persisted
        finally:
            kv.stop()

    def test_filestore_oserror_treated_as_absent(self, tmp_path):
        store = FileStore(str(tmp_path))
        os.makedirs(store._path("k"))
        with pytest.warns(UserWarning, match="could not read"):
            assert store.get("k") is None

    def test_legacy_unframed_snapshot_recovers(self, tmp_path):
        store = FileStore(str(tmp_path))
        c1 = Coordinator(list(range(3)), chunks_per_task=1, store=store)
        c1.join("w1")
        path = store._path("coordinator/state")
        blob = open(path, "rb").read()
        assert blob.startswith(FileStore._MAGIC)
        with open(path, "wb") as f:
            f.write(blob[len(FileStore._MAGIC) + 12:])
        c2 = Coordinator([], store=FileStore(str(tmp_path)))
        assert c2.recovered
        assert c2.chunks == (0, 1, 2)
        assert c2.generation == c1.generation

    def test_num_dropped_survives_snapshot_recover(self, tmp_path):
        store = FileStore(str(tmp_path))
        c1 = Coordinator([1, 2], chunks_per_task=1, failure_max=1,
                         store=store)
        t = c1.get_task()
        assert c1.task_failed(t["task_id"]) is True
        assert c1.num_dropped() == 1
        assert c1.epoch == 0
        c2 = Coordinator([], store=store)
        assert c2.recovered
        assert c2.num_dropped() == 1
        assert c2.get_task(0) is not None


class TestObservability:
    def test_journal_events_and_gauges(self, clock):
        c = Coordinator(list(range(4)), chunks_per_task=1,
                        timeout_s=30.0, worker_lease_s=0.05)
        c.join("w1")
        c.join("w2")
        assert c.get_task(0, "w1") is not None
        c.leave("w2")
        clock.advance(0.08)
        assert c.worker_heartbeat("w1") == -1
        kinds = {r["kind"] for r in tail(300, domain="coordinator")}
        assert {"join", "leave", "lease_expired", "reshard",
                "generation"} <= kinds
        rec = tail(1, domain="coordinator")[0]
        assert "run_id" in rec and "host" in rec
        text = REGISTRY.exposition()
        for gauge in ("paddle_tpu_coord_workers",
                      "paddle_tpu_coord_generation",
                      "paddle_tpu_coord_stale_grants",
                      "paddle_tpu_coord_tasks_todo"):
            assert gauge in text, f"missing {gauge} in exposition"
        assert f"paddle_tpu_coord_generation {c.generation}" in text

    def test_lease_expiry_storm_dumps_flight_bundle(self, tmp_path, clock):
        tobs.FLIGHT.configure(dump_dir=str(tmp_path), min_dump_interval=0.0)
        c = Coordinator([1, 2], chunks_per_task=1, timeout_s=30.0,
                        worker_lease_s=0.03)
        c.join("a")
        c.join("b")
        clock.advance(0.06)
        c.workers()                  # one sweep expires both: a storm
        deadline = time.time() + 10.0     # the dump runs off-thread
        bundles = []
        while not bundles and time.time() < deadline:
            bundles = [p for p in os.listdir(tmp_path)
                       if "coord-lease-expiry-storm" in p]
            time.sleep(0.05)
        assert bundles, "lease-expiry storm did not auto-dump a bundle"
        for th in threading.enumerate():
            if th.name == "pt-coord-dump":
                th.join(10.0)


# ------------------------------------------------- against the JAX package
def _script(c, clock=None):
    """One fixed sequence of calls; returns the snapshot bytes after
    each."""
    out = []
    snap = lambda: out.append(c.store.get("coordinator/state"))  # noqa
    c.join("w1")
    snap()
    g = c.get_task(0, "w1")
    snap()
    c.join("w2")
    snap()
    c.task_release(g["task_id"], g["generation"], {"records_consumed": 1})
    snap()
    c.put_memory_plan({"microbatch": 2, "accum_steps": 4,
                       "provenance": "adapted"})
    snap()
    t = c.get_task(0, "w2")
    c.task_finished(t["task_id"], t["generation"])
    snap()
    t = c.get_task(0, "w2")
    c.task_failed(t["task_id"], t["generation"])
    snap()
    c.leave("w1")
    snap()
    return out


def test_snapshot_bytes_equal_the_jax_coordinators():
    from paddle_tpu.trainer import coordinator as jcoord
    chunks = [["/data/shard-0", 0], ["/data/shard-0", 1],
              ["/data/shard-1", 0]]
    jc = jcoord.Coordinator(chunks, chunks_per_task=1,
                            store=jcoord.InMemStore())
    tc = Coordinator(chunks, chunks_per_task=1, store=InMemStore())
    assert jc.store.get("coordinator/state") == \
        tc.store.get("coordinator/state")
    assert _script(jc) == _script(tc)
    assert jc.stats() == tc.stats()


def test_each_package_recovers_the_others_snapshot(tmp_path):
    from paddle_tpu.trainer import coordinator as jcoord
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j1 = jcoord.Coordinator(list(range(5)), chunks_per_task=2,
                            store=jcoord.FileStore(jdir))
    j1.join("w")
    j1.get_task(0, "w")
    t2 = Coordinator([], store=FileStore(jdir))
    assert t2.recovered and t2.chunks == tuple(range(5))
    assert t2.generation == j1.generation
    t1 = Coordinator(list(range(3)), chunks_per_task=1,
                     store=FileStore(tdir))
    t1.put_memory_plan({"microbatch": 8, "accum_steps": 2,
                        "provenance": "probe"})
    j2 = jcoord.Coordinator([], store=jcoord.FileStore(tdir))
    assert j2.recovered and j2.memory_plan == t1.memory_plan
    assert j2.stats() == t1.stats()
