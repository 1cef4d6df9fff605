"""Port parity: paddle_tpu_torch/parallel/multihost.py and async_sgd.py
against paddle_tpu, the cross-process cases as spawned gloo worlds of 2
(tests/torch_dist.py).

The counterparts of tests/test_multihost.py: init_distributed with no
arguments in a world of one (a no-op recorded in the config, the
coordinator); process_reader's round-robin dealing, against the JAX
function's; global_batch assembling the dp ranks' rows, against the JAX
function's global array; two processes (each its share of one stream,
the global batch assembled) agreeing on a regression's losses, against
the JAX computation on the global batch; local-SGD islands in one
process drifting then reconciling, and converging like sync, their
weights against the JAX islands' from one weight tar; two processes'
islands reconciling by average_pytree over the group, against the JAX
average. Plus two processes' AsyncSGDIsland(sync_group=None) with one
island poisoned: dropped from the average and healed.

Tolerances: rtol 1e-6 for the regressions (the same float32 products),
rtol 1e-4 / atol 1e-5 for the Adam islands' weights after 24 and 61
steps.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
from paddle_tpu.parallel import global_batch as jglobal_batch
from paddle_tpu.parallel import process_reader as jprocess_reader
from paddle_tpu.parallel.mesh import batch_sharding, data_parallel_mesh
from tests import torch_dist as td
from tests.test_torch_parallel import _tar
from tests.torch_dist import run_world


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    tar = _tar(tmp, "island", "island")
    rng = np.random.RandomState(3)
    w_true = rng.randn(8, 1).astype("float32")
    batches = []
    for r in range(2):
        rr = np.random.RandomState(10 + r)
        rows = []
        for _ in range(4):
            xs = rr.randn(16, 8).astype("float32")
            ys = (xs @ w_true).astype("float32")
            rows.append([(xs[i], ys[i]) for i in range(16)])
        batches.append(rows)
    res = run_world(td.scenario, 2, tmp, [
        ("multihost_sync", {}), ("multihost_async", {}),
        ("poisoned_islands", {"tar": tar, "batches": batches})])
    return res


def test_init_distributed_single_process_noop(monkeypatch):
    from paddle_tpu_torch import config
    from paddle_tpu_torch.parallel import init_distributed, is_coordinator
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()
    assert config.global_config().process_index == 0
    assert config.global_config().process_count == 1
    assert is_coordinator()


def test_backend_rule_reads_ranks_per_card():
    """The backend rule on faked layouts: a rank a card is NCCL however
    many hosts the world spans (2 hosts x 8 cards, 16 ranks); ranks that
    share a card, or compute on the CPU, are gloo. Cards follow the
    named card, else the rank's position on its host."""
    from paddle_tpu_torch.parallel.mesh import (RankPlace, backend_rule,
                                                resolve_places)
    two_hosts = resolve_places([RankPlace(f"h{r // 8}", 8, -1)
                                for r in range(16)])
    assert [p.card for p in two_hosts] == list(range(8)) * 2
    assert backend_rule("cuda", two_hosts) == "nccl"
    assert backend_rule("cpu", two_hosts) == "gloo"
    one_card = resolve_places([RankPlace("h", 1, -1)] * 4)
    assert [p.card for p in one_card] == [0] * 4
    assert backend_rule("cuda", one_card) == "gloo"
    assert backend_rule("cuda", resolve_places(
        [RankPlace("h", 8, -1)] * 4)) == "nccl"
    named = resolve_places([RankPlace("h", 8, 3), RankPlace("h", 8, 3)])
    assert backend_rule("cuda", named) == "gloo"
    # LOCAL_RANK-named cards on two hosts: each host's 0 and 1
    assert backend_rule("cuda", resolve_places(
        [RankPlace(h, 2, c) for h in "ab" for c in (0, 1)])) == "nccl"
    assert backend_rule("cuda", resolve_places(
        [RankPlace("h", 0, -1)])) == "gloo"


def test_process_reader_deals_round_robin():
    from paddle_tpu_torch.parallel import process_reader

    def reader():
        yield from range(10)

    for i in range(3):
        got = list(process_reader(reader, process_index=i,
                                  process_count=3)())
        want = list(jprocess_reader(reader, process_index=i,
                                    process_count=3)())
        assert got == want
    assert list(process_reader(reader, 0, 3)()) == [0, 3, 6, 9]


def _global_rows():
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 4).astype(np.float32)
    ys = rng.randn(16, 1).astype(np.float32)
    # rank r keeps rows i % 2 == r and steps on its first 4
    local = [[i for i in range(16) if i % 2 == r][:4] for r in range(2)]
    idx = local[0] + local[1]
    return xs[idx], ys[idx], xs, local


def test_global_batch_shards_over_mesh(world2):
    """Each rank's 4 rows -> the 8-row global batch in rank order, as
    the JAX global_batch assembles it over a dp mesh."""
    x, _, xs, local = _global_rows()
    mesh = data_parallel_mesh(8)
    want = np.asarray(jglobal_batch(x, mesh, batch_sharding(mesh).spec))
    for rank in world2:
        got = rank[0]
        np.testing.assert_array_equal(got["x"], want)
        assert got["n_local"] == 8
    assert [r[0]["me"] for r in world2] == [(0, 2), (1, 2)]
    assert [r[0]["coord"] for r in world2] == [True, False]
    # init_distributed exchanged the ranks' places before the group
    # formed: both ranks hold the same list, of one host
    places = [r[0]["places"] for r in world2]
    assert places[0] == places[1] and len(places[0]) == 2
    assert places[0][0][0] == places[0][1][0]


def test_two_process_group_agrees_on_loss(world2):
    x, y, _, _ = _global_rows()

    @jax.jit
    def step(w, x, y):
        loss, g = jax.value_and_grad(
            lambda w: jnp.mean((x @ w - y) ** 2))(w)
        return w - 0.1 * g, loss

    w = jnp.zeros((4, 1), jnp.float32)
    want = []
    for _ in range(2):
        w, loss = step(w, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))
    losses = [r[0]["losses"] for r in world2]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], want, rtol=1e-6)
    assert losses[0][1] < losses[0][0]


def test_two_process_async_islands_reconcile(world2):
    """Two islands on different data, averaged every 4 steps over the
    process group: identical weights after each reconcile, the JAX
    islands' average, and falling losses."""
    w_true = jnp.asarray(np.random.RandomState(9).randn(4, 1)
                         .astype(np.float32))

    @jax.jit
    def step(w, x):
        loss, g = jax.value_and_grad(
            lambda w: jnp.mean((x @ w - x @ w_true) ** 2))(w)
        return w - 0.2 * g, loss

    rngs = [np.random.RandomState(100 + r) for r in range(2)]
    ws = [jnp.zeros((4, 1), jnp.float32) for _ in range(2)]
    want = []
    for it in range(12):
        ws = [step(w, jnp.asarray(r.randn(32, 4).astype(np.float32)))[0]
              for w, r in zip(ws, rngs)]
        if (it + 1) % 4 == 0:
            avg = (ws[0] + ws[1]) / 2
            ws = [avg, avg]
            want.append(np.asarray(avg))
    got = [r[1] for r in world2]
    assert len(got[0]["syncs"]) == 3
    for a, b in zip(got[0]["syncs"], got[1]["syncs"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0]["syncs"], want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for g in got:
        assert g["losses"][-1] < g["losses"][0]


def test_two_process_poisoned_island_dropped_and_healed(world2):
    """AsyncSGDIsland(sync_group=None) a process: rank 1's parameters go
    NaN before step 3; the reconcile after it drops rank 1's tree (its
    counter bumped) and both ranks hold rank 0's parameters."""
    r0, r1 = (r[2] for r in world2)
    assert r1["poisoned"] == 1 and r0["poisoned"] == 0
    healed0, healed1 = r0["after"][1], r1["after"][1]
    for k in healed0:
        assert np.isfinite(healed0[k]).all()
        np.testing.assert_array_equal(healed1[k], healed0[k])
    # before the poison the islands had averaged normally
    for k in r0["after"][0]:
        np.testing.assert_array_equal(r0["after"][0][k], r1["after"][0][k])


class TestAsyncSGD:
    """In-process local-SGD islands (sync_group=), the port's against the
    JAX package's from one weight tar per island."""

    @pytest.fixture(autouse=True)
    def _card_default_after(self):
        """The islands run with init(use_gpu=False); later tests of the
        process see the card default again."""
        yield
        from paddle_tpu_torch import config
        config.init(seed=0)

    def _islands(self, tmp_path, lr):
        import paddle_tpu_torch as tpaddle
        from paddle_tpu_torch.trainer import Parameters
        tar = _tar(tmp_path, f"isl{lr}", "island")
        out = []
        for _ in range(2):
            jpaddle.init(use_tpu=False, seed=0)
            jc, _, _ = td.build(jpaddle, "island")
            with open(tar, "rb") as f:
                jp = jpaddle.Parameters.from_tar(f)
            jtr = jpaddle.SGD(cost=jc, parameters=jp,
                              update_equation=jpaddle.optimizer.Adam(
                                  learning_rate=lr))
            tpaddle.init(use_gpu=False, seed=0)
            tc, _, _ = td.build(tpaddle, "island")
            with open(tar, "rb") as f:
                tp = Parameters.from_tar(f, device="cpu")
            ttr = tpaddle.SGD(cost=tc, parameters=tp,
                              update_equation=tpaddle.optimizer.Adam(
                                  learning_rate=lr), device="cpu")
            out.append(((jtr, jp), (ttr, tp)))
        return out

    def _groups(self, pairs, period):
        from paddle_tpu.parallel import AsyncSGDIsland as JIsland
        from paddle_tpu_torch.parallel import AsyncSGDIsland
        jg = [p[0][1] for p in pairs]
        tg = [p[1][1] for p in pairs]
        return ([JIsland(p[0][0], sync_period=period, sync_group=jg)
                 for p in pairs],
                [AsyncSGDIsland(p[1][0], sync_period=period, sync_group=tg)
                 for p in pairs])

    @staticmethod
    def _w(params):
        v = params.raw["___fc_0__.w0"]
        return np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)

    def test_islands_drift_then_reconcile(self, tmp_path):
        pairs = self._islands(tmp_path, 3e-2)
        jis, tis = self._groups(pairs, 4)
        w_true = np.random.RandomState(0).randn(8, 1).astype("float32")

        def batch(r):
            xs = r.randn(32, 8).astype("float32")
            ys = (xs @ w_true).astype("float32")
            return [(xs[i], ys[i]) for i in range(32)]

        rs = [np.random.RandomState(1), np.random.RandomState(2)]
        drifted = False
        for it in range(24):
            bs = [batch(r) for r in rs]
            for isl_j, isl_t, b in zip(jis, tis, bs):
                isl_j.train_batch(b)
                isl_t.train_batch(b)
            wa, wb = (self._w(p[1][1]) for p in pairs)
            if (it + 1) % 4 == 0:
                np.testing.assert_array_equal(wa, wb)
            elif not np.array_equal(wa, wb):
                drifted = True
        assert drifted, "islands never drifted -> test is vacuous"
        for p in pairs:
            np.testing.assert_allclose(self._w(p[1][1]), self._w(p[0][1]),
                                       rtol=1e-4, atol=1e-5)

    def test_local_sgd_converges_like_sync(self, tmp_path):
        pairs = self._islands(tmp_path, 6e-2)
        jis, tis = self._groups(pairs, 5)
        w_true = np.random.RandomState(3).randn(8, 1).astype("float32")

        def batch(r, n=64):
            xs = r.randn(n, 8).astype("float32")
            ys = (xs @ w_true).astype("float32")
            return [(xs[i], ys[i]) for i in range(n)]

        rs = [np.random.RandomState(4), np.random.RandomState(5)]
        for _ in range(60):
            bs = [batch(r) for r in rs]
            for isl_j, isl_t, b in zip(jis, tis, bs):
                isl_j.train_batch(b)
                isl_t.train_batch(b)
        jis[0].reconcile()
        tis[0].reconcile()
        w = self._w(pairs[0][1][1])
        assert np.abs(w - w_true).max() < 0.15, (w - w_true)
        np.testing.assert_allclose(w, self._w(pairs[0][0][1]), rtol=1e-4,
                                   atol=1e-5)


def test_filter_finite_rows_and_tree_isfinite():
    """The row-wise reconcile guard: non-finite gradient rows dropped with
    the counter and a warning, as the JAX function drops them; and
    tree_isfinite over nested trees."""
    import torch

    from paddle_tpu.parallel.async_sgd import \
        filter_finite_rows as jfilter
    from paddle_tpu.utils.stats import global_counters as jcounters
    from paddle_tpu_torch.parallel.async_sgd import (filter_finite_rows,
                                                     tree_isfinite)
    from paddle_tpu_torch.utils.stats import global_counters
    keys = np.arange(5)
    grads = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    grads[1, 2] = np.nan
    grads[3, 0] = np.inf
    before = global_counters.value("parallel/poisoned_rows")
    jbefore = jcounters.value("parallel/poisoned_rows")
    with pytest.warns(UserWarning, match="non-finite"):
        k, g = filter_finite_rows(keys, grads)
    with pytest.warns(UserWarning, match="non-finite"):
        jk, jg = jfilter(keys, grads)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(g, jg)
    assert global_counters.value("parallel/poisoned_rows") - before == \
        jcounters.value("parallel/poisoned_rows") - jbefore == 2
    assert tree_isfinite({"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert not tree_isfinite({"a": {"b": torch.tensor([1.0, float("nan")])}})


@pytest.mark.parametrize("codes, says", [
    ((None, 1), "rank 1 failed: exit code 1; it wrote status 'ok'"),
    ((None, "kill"), "rank 1 failed: killed by signal SIGKILL (9); "
                     "it wrote status 'ok'"),
])
def test_run_world_reports_a_rank_that_exits_nonzero_after_ok(
        tmp_path, codes, says):
    # rank 1 writes its ("ok", result) record, then ends non-zero while
    # rank 0 still lingers: the world fails with the exit code or
    # signal and the written status — never a TypeError
    with pytest.raises(AssertionError) as err:
        run_world(td.exit_after_result, 2, tmp_path, codes, 3.0)
    assert says in str(err.value)


def test_world_teardown_ends_gloo_threads(tmp_path):
    # the port's record of the group's places held the default group
    # past destroy_process_group(), and with it gloo's loop and worker
    # threads, which then aborted some ranks at interpreter exit
    res, threads = run_world(td.places_then_threads, 2, tmp_path,
                             with_threads=True)
    assert res[0] == res[1] and len(res[0]) == 2
    for t in threads:
        assert t["python"] == ["MainThread"], t
        assert not [n for n in t["native"] if "gloo" in n], t
