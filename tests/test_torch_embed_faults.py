"""Chaos family (o) on the port's sharded embedding service, on the CPU.

The JAX package's acceptance runs (tests/test_embed_faults.py) on the
port's objects: three shards on the membership plane, a deterministic
pass of sparse pushes, one shard killed (the in-process SIGKILL twin,
``EmbeddingShardServer.kill``) inside a scatter-update's torn window —
WAL durable, table not mutated, ack never sent. The replacement
restores the key range from snapshot + WAL, re-joins under the same
worker id, the client's retry of the same seq dedupes to ``dup``, and
the final table digest equals an uninterrupted run's — and the JAX
package's uninterrupted run's. Then a kill at an RPC, stale reads
against a dead and a live shard, slow shards, and ``cli.py pserver``
in a process of its own through SIGTERM (snapshot, leave, close, the
``stopped`` line). After each, the port's armed protocol witness
(``embed_shard_failover`` included) holds zero live violations.

Tolerances: digests and ledgers exact.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu import embed as jembed
import paddle_tpu_torch.embed as tembed
import paddle_tpu_torch.obs as tobs
from paddle_tpu_torch.embed import (EmbeddingClient, EmbedService,
                                    EmbedUnavailable, shard_of)
from paddle_tpu_torch.obs.events import JOURNAL
from paddle_tpu_torch.testing import assert_exactly_once_applied
from paddle_tpu_torch.testing.faults import FaultPlan
from paddle_tpu_torch.trainer.coordinator import (Coordinator,
                                                  CoordinatorServer,
                                                  FileStore)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
SHARDS = 3
SEED = 7


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    assert tobs.WITNESS.violations() == []
    tobs.reset_all()


def _batches(n=6, rows=16, base=0):
    """Batch b updates its own key block with its own lr, so the final
    table does not depend on how the push worker coalesces, and the
    victim sees one scatter_update per batch."""
    rng = np.random.default_rng(1234)
    out = []
    for b in range(n):
        keys = np.arange(base + b * rows, base + (b + 1) * rows,
                         dtype=np.int64)
        grads = rng.normal(0.0, 1.0, (rows, DIM)).astype(np.float32)
        out.append((keys, grads, 0.1 + 0.05 * b))
    return out


def _run_reference(pkg, batches, client_id):
    with pkg.EmbedService(SHARDS, DIM, seed=SEED) as ref:
        with ref.client(client_id=client_id) as c:
            for keys, grads, lr in batches:
                c.push(keys, grads, lr=lr)
            assert c.flush(timeout=30.0)
        return ref.table_digest(), \
            {sid: ref.shard(sid).applied_seqs() for sid in range(SHARDS)}


def _wait_killed(stats, timeout=10.0):
    deadline = time.monotonic() + timeout
    while stats["killed_at"] is None and time.monotonic() < deadline:
        time.sleep(0.02)


def test_kill_shard_mid_commit_exactly_once_digest_stable():
    batches = _batches()
    victim = 1
    for keys, _, _ in batches:
        assert any(shard_of(int(k), SHARDS) == victim
                   for k in keys.tolist())
    ref_digest, ref_seqs = _run_reference(tembed, batches, "chaos-client")
    jax_digest, _ = _run_reference(jembed, batches, "chaos-client")
    assert ref_digest == jax_digest

    coord = Coordinator(chunks=[], worker_lease_s=30.0)
    with EmbedService(SHARDS, DIM, seed=SEED, coordinator=coord,
                      heartbeat_s=0.1) as svc:
        client = svc.client(client_id="chaos-client", retry_deadline=20.0)
        with FaultPlan.kill_shard(svc.server(victim), at=1,
                                  window="commit") as ks:
            for keys, grads, lr in batches:
                client.push(keys, grads, lr=lr)
            _wait_killed(ks)
            assert ks["killed_at"] == 1, "the commit-window kill never fired"
            replacement = svc.replace(victim)
            assert client.flush(timeout=30.0)
        st = replacement.stats()
        assert replacement.restored and st["replayed_wal"] >= 1
        cst = client.stats()
        assert cst["push_failures"] == 0 and cst["failovers"] >= 1
        assert_exactly_once_applied(svc, ref_seqs, dup_acks=cst["dup_acks"],
                                    min_dup_acks=1)
        assert svc.table_digest() == ref_digest
        info = coord.worker_info(f"embed/{victim}")
        assert info["endpoint"] == svc.server(victim).endpoint
        client.close()
    kinds = {r["kind"] for r in JOURNAL.tail(400, domain="embed")}
    assert {"shard_killed", "shard_replaced", "restore"} <= kinds


def test_kill_shard_in_rpc_window_retry_applies_cleanly():
    with EmbedService(1, DIM, seed=3,
                      coordinator=Coordinator(chunks=[], worker_lease_s=30.0),
                      heartbeat_s=0.1) as svc:
        with svc.client(client_id="rpc-kill", retry_deadline=15.0) as client:
            keys = np.arange(32, dtype=np.int64)
            with FaultPlan.kill_shard(svc.server(0), at=0,
                                      window="rpc") as ks:
                client.push(keys, np.ones((32, DIM), np.float32), lr=0.5)
                _wait_killed(ks)
                assert ks["killed_at"] == 0
                svc.replace(0)
                assert client.flush(timeout=30.0)
            st = svc.shard(0).stats()
            assert st["applied_updates"] == 1 and st["replayed_wal"] == 0
            assert_exactly_once_applied(svc, {0: {"rpc-kill": 1}})
            assert client.stats()["dup_acks"] == 0
            assert client.stats()["push_failures"] == 0
    with pytest.raises(ValueError, match="window"):
        with FaultPlan.kill_shard(object(), window="nope"):
            pass


def test_stale_read_against_a_dead_shard_is_journaled():
    with EmbedService(1, DIM, seed=5) as svc:
        with svc.client(client_id="stale-reader", staleness_s=30.0,
                        retry_deadline=0.3) as client:
            keys = np.arange(10, dtype=np.int64)
            fresh = client.gather(keys)
            svc.kill(0)
            with FaultPlan.stale_read(client, age_s=100.0) as st:
                rows = client.gather(keys)
                assert st["aged"] >= len(keys)
            np.testing.assert_array_equal(rows, fresh)
            assert client.stats()["stale_serves"] == len(keys)
            with pytest.raises(EmbedUnavailable):
                client.gather(np.array([777], np.int64))
    recs = [r for r in JOURNAL.tail(100, domain="embed")
            if r["kind"] == "stale_read"]
    assert recs and recs[-1]["age_s"] >= recs[-1]["bound_s"]
    assert recs[-1]["rows"] == 10


def test_stale_read_against_a_live_shard_refetches():
    with EmbedService(1, DIM, seed=5) as svc:
        with svc.client(client_id="fresh-reader", staleness_s=30.0) as client:
            keys = np.arange(6, dtype=np.int64)
            client.gather(keys)
            before = svc.shard(0).stats()["gathers"]
            with FaultPlan.stale_read(client, age_s=100.0):
                client.gather(keys)
                client.gather(keys)
            assert svc.shard(0).stats()["gathers"] >= before + 2
            assert client.stats()["stale_serves"] == 0


def test_slow_shard_stalls_exactly_the_chosen_rpcs():
    with EmbedService(1, DIM, seed=5) as svc:
        with svc.client(client_id="slow-reader") as client:
            keys = np.arange(4, dtype=np.int64)
            with FaultPlan.slow_shard(svc.server(0), ms=80.0,
                                      at=[1, 3]) as st:
                times = []
                for i in range(4):
                    t0 = time.monotonic()
                    client.gather(keys + 100 * i)
                    times.append(time.monotonic() - t0)
            assert st["slowed"] == [1, 3]
            assert times[1] >= 0.07 and times[3] >= 0.07
            with FaultPlan.slow_shard(svc.server(0), ms=1.0,
                                      every=True) as st:
                client.gather(keys + 1000)
                client.gather(keys + 2000)
            assert st["slowed"] == [4, 5]


def _read_json_line(proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line from pid {proc.pid}: "
                         f"{proc.stderr.read()[-2000:]}")


def test_pserver_sigterm_snapshots_leaves_and_stops(tmp_path):
    coord = Coordinator(chunks=[], worker_lease_s=30.0)
    csrv = CoordinatorServer(coord).start()
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.cli", "pserver",
           "--shard_id", "0", "--shards", "1", "--dim", str(DIM),
           "--seed", "4", "--coordinator", f"127.0.0.1:{csrv.port}",
           "--snapshot_dir", str(tmp_path), "--heartbeat", "0.2"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        up = _read_json_line(proc)
        assert up["status"] == "serving" and up["restored"] is False
        assert coord.worker_info("embed/0")["endpoint"] == up["endpoint"]
        with EmbeddingClient(1, DIM, coordinator=coord,
                             client_id="pc") as client:
            keys = np.arange(20, dtype=np.int64)
            before = client.gather(keys)
            client.push(keys, np.ones((20, DIM), np.float32), lr=0.5)
            assert client.flush(timeout=20.0)
        proc.send_signal(signal.SIGTERM)
        down = _read_json_line(proc)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    assert down["status"] == "stopped"
    assert down["stats"]["applied_updates"] == 1
    # the orderly exit: snapshot written, lease given up, socket closed
    assert FileStore(str(tmp_path)).get("embed/shard0/snap") is not None
    assert coord.worker_info("embed/0") is None
    import socket
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", up["port"]), timeout=2.0)
    # a replacement started with the same flags restores the range
    from paddle_tpu_torch.embed import EmbeddingShard
    r = EmbeddingShard(0, 1, DIM, seed=4, store=FileStore(str(tmp_path)))
    assert r.restore_from_store() and r.applied_seqs() == {"pc": 1}
    np.testing.assert_allclose(r.gather(np.arange(20)), before - 0.5,
                               rtol=1e-6)
    csrv.stop()
