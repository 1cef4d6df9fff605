"""The port's sharded embedding service (paddle_tpu_torch/embed/)
against the JAX package's, on the CPU.

- Routing: ``stable_hash64``'s golden values, ``shard_of`` equal to the
  JAX function key for key.
- The shard: lazy seeded rows equal to a JAX shard's, the exactly-once
  ledger (duplicates and gaps), snapshot plus WAL replay, chunked
  ``RpcStore`` snapshots.
- The client: cache and staleness bound, push and invalidate,
  duplicate keys, poisoned rows.
- The remote layer: no parameter, forward equal to a local table's
  within 1e-6 relative, KeyError without ``sparse_sub``, ``push_grads``
  updating the store, and the one key space the remote tables of one
  client share.
- Mixed runs: a JAX client against port shard servers and a port
  client against JAX servers give the same rows and the same digests
  after the same pushes; a port shard restores digest-equal from a JAX
  shard's ``FileStore`` directory, and the other way round.
- ``OnlineTrainer`` losses equal to the JAX trainer's for one seed, and
  ``run_online`` over a journal against a live store.
- The ``paddle_tpu_embed_*`` gauges and the flight provider.

Tolerances: rows, digests and losses exact (both packages run the same
numpy); the remote forward within 1e-6 relative of the local one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import embed as jembed
from paddle_tpu.trainer import coordinator as jcoord
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.obs as tobs
from paddle_tpu_torch.core.registry import ParamAttr, reset_name_counters
from paddle_tpu_torch.embed import (EmbeddingClient, EmbeddingShard,
                                    EmbedService, OnlineTrainer,
                                    RemoteLookup, journal_sample_reader,
                                    log_sample, run_online,
                                    serving_sample_log, shard_of,
                                    stable_hash64)
from paddle_tpu_torch.obs.events import JOURNAL
from paddle_tpu_torch.trainer.coordinator import (FileStore, InMemStore,
                                                  KVStoreServer, RpcStore)

DIM = 8


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    assert tobs.WITNESS.violations() == []
    tobs.reset_all()


@pytest.fixture(autouse=True)
def _port_device_restored():
    yield
    tpaddle.init(seed=0)


# -------------------------------------------------------------- routing
def test_stable_hash_golden_values_and_routing_equal_jax():
    assert stable_hash64(0) == 16294208416658607535
    assert stable_hash64(1) == 10451216379200822465
    assert stable_hash64(-1) == 16490336266968443936
    keys = list(range(-50, 1000)) + [2 ** 40 + 7, 2 ** 62]
    assert [stable_hash64(k) for k in keys] == \
        [jembed.stable_hash64(k) for k in keys]
    owners = [shard_of(k, 4) for k in range(1000)]
    assert owners == [jembed.shard_of(k, 4) for k in range(1000)]
    assert set(owners) <= {0, 1, 2, 3}
    assert np.bincount(owners, minlength=4).min() > 150


# ---------------------------------------------------------------- shard
def _shard(store=None, **kw):
    return EmbeddingShard(0, 1, DIM, seed=3, store=store, **kw)


def test_lazy_rows_deterministic_unmaterialized_and_equal_jax():
    a, b = _shard(), _shard()
    keys = np.arange(10, dtype=np.int64)
    np.testing.assert_array_equal(a.gather(keys), b.gather(keys))
    np.testing.assert_array_equal(
        a.gather(keys), jembed.EmbeddingShard(0, 1, DIM, seed=3).gather(keys))
    assert a.stats()["rows"] == 0 and a.digest() == b.digest()


def test_exactly_once_ledger_dup_and_gap():
    s = _shard()
    keys = np.arange(4, dtype=np.int64)
    g = np.ones((4, DIM), np.float32)
    assert s.apply_updates("c", 1, keys, g, 0.1)["applied"]
    d0 = s.digest()
    res = s.apply_updates("c", 1, keys, g, 0.1)
    assert res["dup"] and not res["applied"] and s.digest() == d0
    with pytest.raises(ValueError, match="gap"):
        s.apply_updates("c", 3, keys, g, 0.1)
    assert s.apply_updates("c", 2, keys, g, 0.1)["applied"]
    assert s.applied_seqs() == {"c": 2}
    assert s.stats()["dup_updates"] == 1


def _updates(shard, rng, seqs, n_of=lambda seq: seq * 5, lr=0.1):
    for seq in seqs:
        n = n_of(seq)
        shard.apply_updates("c", seq, np.arange(n, dtype=np.int64),
                            rng.normal(size=(n, DIM)).astype(np.float32),
                            lr)


def test_snapshot_plus_wal_replay_restores_digest():
    store = InMemStore()
    s = _shard(store=store)
    rng = np.random.default_rng(0)
    _updates(s, rng, (1, 2, 3))
    s.save_snapshot()
    _updates(s, rng, (4, 5), n_of=lambda seq: 8, lr=0.2)
    r = _shard(store=store)
    assert r.restore_from_store()
    assert r.stats()["replayed_wal"] == 2
    assert r.digest() == s.digest() and r.applied_seqs() == {"c": 5}
    kinds = [x["kind"] for x in JOURNAL.tail(10, domain="embed")]
    assert kinds == ["snapshot", "restore"]


def test_multi_mb_snapshot_rides_chunked_rpcstore():
    srv = KVStoreServer(host="127.0.0.1", port=0).start()
    try:
        store = RpcStore("127.0.0.1", srv.port, chunk_bytes=4096)
        s = _shard(store=store)
        s.apply_updates("c", 1, np.arange(600, dtype=np.int64),
                        np.ones((600, DIM), np.float32), 0.5)
        s.save_snapshot()                # ~19KB frame -> 5 chunks
        assert srv.store.get("embed/shard0/snap.chunk.0") is not None
        r = _shard(store=RpcStore("127.0.0.1", srv.port))
        assert r.restore_from_store() and r.digest() == s.digest()
    finally:
        srv.stop()


# --------------------------------------------------------------- client
def _rpc_gathers(svc, n):
    return sum(svc.shard(s).stats()["gathers"] for s in range(n))


def test_client_cache_and_staleness_bound():
    with EmbedService(2, DIM, seed=1) as svc:
        with svc.client(client_id="c1", staleness_s=60.0) as c:
            keys = np.arange(12, dtype=np.int64)
            first = c.gather(keys)
            rpc = _rpc_gathers(svc, 2)
            np.testing.assert_array_equal(c.gather(keys), first)
            assert _rpc_gathers(svc, 2) == rpc
            assert c.stats()["cache_hits"] == len(keys)
            c.gather(keys, max_stale_s=0.0)
            assert _rpc_gathers(svc, 2) > rpc


def test_client_push_invalidates_and_duplicate_keys_accumulate():
    with EmbedService(2, DIM, seed=1) as svc:
        with svc.client(client_id="c2") as c:
            keys = np.arange(6, dtype=np.int64)
            before = c.gather(keys)
            g = np.full((6, DIM), 2.0, np.float32)
            c.push(keys, g, lr=0.5)
            assert c.flush(timeout=15.0)
            np.testing.assert_allclose(c.gather(keys), before - 0.5 * g,
                                       rtol=1e-6)
            k7 = np.array([7], np.int64)
            b7 = c.gather(k7)
            c.push(np.array([7, 7], np.int64), np.ones((2, DIM), np.float32),
                   lr=0.1)
            assert c.flush(timeout=15.0)
            np.testing.assert_allclose(c.gather(k7), b7 - 0.2, rtol=1e-6)
            assert c.stats()["push_failures"] == 0


def test_client_drops_poisoned_rows_at_source():
    with EmbedService(1, DIM, seed=1) as svc:
        with svc.client(client_id="c4") as c:
            keys = np.arange(3, dtype=np.int64)
            before = c.gather(keys)
            g = np.zeros((3, DIM), np.float32)
            g[1] = np.nan
            g[0] = g[2] = 1.0
            with pytest.warns(UserWarning, match="non-finite"):
                c.push(keys, g, lr=1.0)
            assert c.flush(timeout=15.0)
            after = c.gather(keys)
            np.testing.assert_allclose(after[1], before[1])
            np.testing.assert_allclose(after[0], before[0] - 1.0, rtol=1e-6)


# ---------------------------------------------------------- remote layer
def _remote_pair(vocab, two=False):
    """The same model twice: local table vs remote=True (with ``two``,
    two remote tables reading one ids layer)."""
    reset_name_counters()
    tpaddle.init(use_gpu=False, seed=11)
    ids = tpaddle.layer.data("ids", tpaddle.data_type.integer_value(vocab))
    local = tpaddle.layer.embedding(ids, size=DIM, name="tbl",
                                    param_attr=ParamAttr(name="_tbl_w"))
    topo_local = tpaddle.Topology(local)
    reset_name_counters()
    ids = tpaddle.layer.data("ids", tpaddle.data_type.integer_value(vocab))
    rem = tpaddle.layer.embedding(ids, size=DIM, name="tbl",
                                  param_attr=ParamAttr(name="_tbl_w"),
                                  remote=True)
    outs = [rem]
    if two:
        outs.append(tpaddle.layer.embedding(
            ids, size=DIM, name="tbl2", param_attr=ParamAttr(name="_tbl2_w"),
            remote=True))
    return topo_local, tpaddle.Topology(outs)


def test_remote_table_never_materializes():
    _, topo_rem = _remote_pair(vocab=40)
    assert topo_rem.remote_tables() == {"_tbl_w": "ids"}
    assert "_tbl_w" not in topo_rem.param_specs
    assert topo_rem.init_params() == {}
    assert topo_rem.sparse_tables() == {}


def test_remote_forward_matches_local_table():
    vocab = 40
    topo_local, topo_rem = _remote_pair(vocab)
    with EmbedService(2, DIM, seed=9) as svc:
        with svc.client(client_id="lkp") as client:
            lookup = RemoteLookup(topo_rem, client, device="cpu")
            table = client.gather(np.arange(vocab, dtype=np.int64))
            ids = torch.as_tensor(np.random.default_rng(4).integers(
                0, vocab, 16).astype(np.int64))
            out_l, _ = topo_local.forward(
                {"_tbl_w": torch.as_tensor(table)}, {}, {"ids": ids},
                mode="test")
            sub = lookup.sparse_sub({"ids": ids})
            uids, rows = sub["_tbl_w"]
            assert isinstance(rows, torch.Tensor) and rows.device.type == "cpu"
            assert uids.dtype == torch.int64 and rows.dtype == torch.float32
            out_r, _ = topo_rem.forward({}, {}, {"ids": ids}, mode="test",
                                        sparse_sub=sub)
            np.testing.assert_allclose(out_r["tbl"].numpy(),
                                       out_l["tbl"].numpy(), rtol=1e-6)
            assert lookup.gathered_batches == 1


def test_remote_forward_without_sparse_sub_raises():
    _, topo_rem = _remote_pair(vocab=40)
    with pytest.raises(KeyError, match="REMOTE table"):
        topo_rem.forward({}, {}, {"ids": torch.arange(4)}, mode="test")


def test_push_grads_updates_store():
    _, topo_rem = _remote_pair(vocab=40)
    with EmbedService(2, DIM, seed=9) as svc:
        with svc.client(client_id="upd") as client:
            lookup = RemoteLookup(topo_rem, client, device="cpu")
            sub = lookup.sparse_sub({"ids": np.array([3, 3, 11], np.int64)})
            uids, rows = sub["_tbl_w"]
            assert uids.tolist() == [3, 11]
            lookup.push_grads(sub, {"_tbl_w": torch.ones_like(rows)},
                              lr=0.25)
            assert client.flush(timeout=15.0)
            np.testing.assert_allclose(client.gather(uids.numpy()),
                                       rows.numpy() - 0.25, rtol=1e-6)


def test_remote_tables_of_one_client_share_one_key_space():
    """The reference's contract (paddle_tpu/embed/lookup.py): every
    remote table of a lookup reads through one client, so id k is one
    row of the store whichever table asks — a push through one table
    shows in the other."""
    _, topo_rem = _remote_pair(vocab=40, two=True)
    assert topo_rem.remote_tables() == {"_tbl_w": "ids", "_tbl2_w": "ids"}
    with EmbedService(2, DIM, seed=9) as svc:
        with svc.client(client_id="shared") as client:
            lookup = RemoteLookup(topo_rem, client, device="cpu")
            ids = np.array([5, 7], np.int64)
            sub = lookup.sparse_sub({"ids": ids})
            torch.testing.assert_close(sub["_tbl_w"][1], sub["_tbl2_w"][1],
                                       rtol=0, atol=0)
            lookup.push_grads({"_tbl_w": sub["_tbl_w"]},
                              {"_tbl_w": np.ones((2, DIM), np.float32)},
                              lr=0.5)
            assert client.flush(timeout=15.0)
            fresh = lookup.sparse_sub({"ids": ids}, max_stale_s=0.0)
            np.testing.assert_allclose(fresh["_tbl2_w"][1].numpy(),
                                       sub["_tbl_w"][1].numpy() - 0.5,
                                       rtol=1e-6)
            # the JAX package's lookup shares it the same way
            jreset = jpaddle.core.registry.reset_name_counters
            jreset()
            jids = jpaddle.layer.data("ids",
                                      jpaddle.data_type.integer_value(40))
            jtopo = jpaddle.Topology([
                jpaddle.layer.embedding(jids, size=DIM, name="tbl",
                                        param_attr=jpaddle.attr.Param(
                                            name="_tbl_w"), remote=True),
                jpaddle.layer.embedding(jids, size=DIM, name="tbl2",
                                        param_attr=jpaddle.attr.Param(
                                            name="_tbl2_w"), remote=True)])
            jsub = jembed.RemoteLookup(jtopo, client).sparse_sub(
                {"ids": ids}, max_stale_s=0.0)
            for name in ("_tbl_w", "_tbl2_w"):
                np.testing.assert_array_equal(jsub[name][1],
                                              fresh[name][1].numpy())


# ------------------------------------------------------------ mixed runs
def _pushes(n=5, rows=12):
    rng = np.random.default_rng(77)
    return [(np.arange(b * rows, (b + 1) * rows, dtype=np.int64),
             rng.normal(size=(rows, DIM)).astype(np.float32), 0.1 + 0.02 * b)
            for b in range(n)]


def _drive(client, keys):
    before = client.gather(keys)
    for k, g, lr in _pushes():
        client.push(k, g, lr=lr)
    assert client.flush(timeout=20.0)
    return before, client.gather(keys, max_stale_s=0.0)


def test_mixed_rpc_both_ways_same_rows_and_digests():
    keys = np.arange(60, dtype=np.int64)
    with EmbedService(3, DIM, seed=4) as tsvc, \
            jembed.EmbedService(3, DIM, seed=4) as jsvc:
        # a JAX client against the port's shard servers ...
        jc = jembed.EmbeddingClient(3, DIM, endpoints=tsvc.endpoints(),
                                    client_id="mix")
        # ... and a port client against the JAX package's
        tc = EmbeddingClient(3, DIM, endpoints=jsvc.endpoints(),
                             client_id="mix")
        try:
            j_before, j_after = _drive(jc, keys)
            t_before, t_after = _drive(tc, keys)
        finally:
            jc.close()
            tc.close()
        np.testing.assert_array_equal(j_before, t_before)
        np.testing.assert_array_equal(j_after, t_after)
        assert tsvc.table_digest() == jsvc.table_digest()
        for sid in range(3):
            assert tsvc.shard(sid).applied_seqs() == \
                jsvc.shard(sid).applied_seqs()
            assert tsvc.shard(sid).digest() == jsvc.shard(sid).digest()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_filestore_restore_across_packages(tmp_path, writer):
    wpkg = (jembed.EmbeddingShard, jcoord.FileStore) if writer == "jax" \
        else (EmbeddingShard, FileStore)
    rpkg = (EmbeddingShard, FileStore) if writer == "jax" \
        else (jembed.EmbeddingShard, jcoord.FileStore)
    s = wpkg[0](1, 2, DIM, seed=6, store=wpkg[1](str(tmp_path)))
    rng = np.random.default_rng(3)
    for seq in (1, 2, 3):
        s.apply_updates("c", seq, np.arange(seq * 7, dtype=np.int64),
                        rng.normal(size=(seq * 7, DIM)).astype(np.float32),
                        0.1)
    s.save_snapshot()
    for seq in (4, 5):                   # past the snapshot: WAL only
        s.apply_updates("c", seq, np.arange(9, dtype=np.int64),
                        rng.normal(size=(9, DIM)).astype(np.float32), 0.3)
    r = rpkg[0](1, 2, DIM, seed=6, store=rpkg[1](str(tmp_path)))
    assert r.restore_from_store()
    assert r.stats()["replayed_wal"] == 2
    assert r.digest() == s.digest()
    assert r.applied_seqs() == s.applied_seqs() == {"c": 5}
    keys = np.arange(30, dtype=np.int64)
    np.testing.assert_array_equal(r.gather(keys), s.gather(keys))


# ---------------------------------------------------------------- online
def _online_batches(n=6, size=4, vocab=60, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = []
        for _ in range(size):
            ids = rng.integers(0, vocab, 5)
            batch.append((ids, float(ids.sum() % 2)))
        out.append(batch)
    return out


def test_online_trainer_losses_equal_jax():
    batches = _online_batches()
    with EmbedService(2, DIM, seed=2) as tsvc, \
            jembed.EmbedService(2, DIM, seed=2) as jsvc:
        with tsvc.client(client_id="o") as tc, \
                jsvc.client(client_id="o") as jc:
            tt = OnlineTrainer(tc, lr=0.3, seed=0)
            jt = jembed.OnlineTrainer(jc, lr=0.3, seed=0)
            tl, jl = [], []
            for b in batches:
                tl.append(tt.step(b))
                assert tc.flush(timeout=15.0)
                jl.append(jt.step(b))
                assert jc.flush(timeout=15.0)
            assert tl == jl
            np.testing.assert_array_equal(tt.w, jt.w)
        assert tsvc.table_digest() == jsvc.table_digest()


def test_online_pass_trains_against_live_store(tmp_path):
    path = tmp_path / "serve.jsonl"
    rng = np.random.default_rng(8)
    JOURNAL.configure(str(path))
    try:
        for _ in range(24):
            ids = rng.integers(0, 60, 5)
            log_sample(ids, float(ids.sum() % 2))
    finally:
        JOURNAL.configure(None)
    with EmbedService(2, DIM, seed=2) as svc:
        with svc.client(client_id="online") as client:
            virgin = client.gather(np.arange(10, dtype=np.int64),
                                   max_stale_s=0.0).copy()
            stats = run_online(client, journal_sample_reader(str(path)),
                               batch_size=4, lr=0.3, num_workers=2, seed=0)
            assert stats["batches"] == 6 and stats["samples"] == 24
            assert np.isfinite(stats["loss_mean"])
            assert stats["client"]["push_failures"] == 0
            assert sum(svc.shard(s).stats()["applied_updates"]
                       for s in range(2)) >= stats["batches"]
            after = client.gather(np.arange(10, dtype=np.int64),
                                  max_stale_s=0.0)
            assert not np.allclose(after, virgin)
    recs = [r for r in JOURNAL.tail(50, domain="embed")
            if r["kind"] == "online_pass"]
    assert recs and recs[-1]["batches"] == 6


def test_serving_sample_log_seam():
    from paddle_tpu_torch.serving import InferenceServer
    from paddle_tpu_torch.trainer.inference import Inference
    reset_name_counters()
    tpaddle.init(use_gpu=False, seed=5)
    ids = tpaddle.layer.data("ids", tpaddle.data_type.integer_value(30))
    emb = tpaddle.layer.embedding(ids, size=DIM, name="emb")
    out = tpaddle.layer.fc(emb, size=2, act=tpaddle.activation.Softmax())
    params = tpaddle.create_parameters(tpaddle.Topology(out))
    inf = Inference(output_layer=out, parameters=params)
    srv = InferenceServer(
        inf, workers=1, breaker=False,
        sample_log=serving_sample_log(label_fn=lambda s: 1.0)).start()
    try:
        srv.infer([(3,), (17,)])
    finally:
        srv.shutdown(drain=True)
    recs = [r for r in JOURNAL.tail(50, domain="embed")
            if r["kind"] == "sample"]
    assert len(recs) >= 2
    assert recs[-2]["ids"] == [3] and recs[-1]["ids"] == [17]
    assert recs[-1]["label"] == 1.0


# ------------------------------------------------------------------- obs
def test_gauge_catalog_and_flight_provider():
    from paddle_tpu_torch.obs.catalog import METRIC_PREFIXES
    from paddle_tpu_torch.obs.flight import FLIGHT
    from paddle_tpu_torch.obs.metrics import REGISTRY
    with EmbedService(2, DIM, seed=1) as svc:
        with svc.client(client_id="obs") as c:
            c.gather(np.arange(8, dtype=np.int64))
            c.push(np.arange(8, dtype=np.int64),
                   np.ones((8, DIM), np.float32))
            assert c.flush(timeout=15.0)
            text = REGISTRY.exposition()
            for gauge in ("paddle_tpu_embed_shard_rows",
                          "paddle_tpu_embed_shard_applied_updates",
                          "paddle_tpu_embed_client_cached_rows",
                          "paddle_tpu_embed_client_pushes"):
                assert gauge in text, f"missing {gauge}"
            assert 'shard="0"' in text and 'shard="1"' in text
            fams = [l.split()[2] for l in text.splitlines()
                    if l.startswith("# TYPE paddle_tpu_embed_")]
            assert fams and all(any(f.startswith(p)
                                    for p in METRIC_PREFIXES)
                                for f in fams)
            state = FLIGHT.bundle(reason="test")["state"]
            assert "embed" in state
            assert any(s["shard_id"] == 0 for s in state["embed"]["shards"])
            assert state["embed"]["clients"][0]["client_id"] == "obs"
