"""Port parity: the two recommenders of paddle_tpu_torch
(models/recommender.py), the MovieLens dataset and the
demo/recommendation script against paddle_tpu on the CPU.

- ``wide_and_deep(sparse_dims=(200, 200, 50), dense_dim=4, emb_size=8,
  hidden_sizes=(16,))`` (six row-sparse tables) and
  ``movielens_regression(20, 30, 8)`` (dense tables and ``cos_sim``)
  train 8 steps in both packages from one weight tar: per-step costs
  within 1e-5 relative, parameters within rtol 1e-5 / atol 1e-6.
- An ``evaluator.auc`` on Wide&Deep (as ``tests/test_evaluators.py``
  builds it): the training passes' and the test sweep's AUC equal JAX's.
- ``dataset.movielens``: the synthetic catalog sample for sample.
- The copy of demo/recommendation/train.py in chip_smoke.py
  (``recommendation_v2_demo``, only its imports changed), one pass cut
  to 8 batches and its test sweep: costs at rtol 1e-5.
"""

import io

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import evaluator as jev
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as j_reset

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import evaluator as tev
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset

RTOL_COST = 1e-5
RTOL, ATOL = 1e-5, 1e-6
STEPS = 8


@pytest.fixture(autouse=True)
def _port_config():
    t_reset()
    yield
    tconfig.init(seed=0)


class _FakeLayer:
    def __init__(self, name):
        self.name = name


def _np(x):
    return x.detach().numpy() if hasattr(x, "detach") else np.asarray(x)


def _wd(models):
    return models.wide_and_deep(sparse_dims=(200, 200, 50), dense_dim=4,
                                emb_size=8, hidden_sizes=(16,))


def _wd_batches(n=STEPS, b=32, seed=0):
    """Skewed ids (many rows untouched for steps), the label from slot
    0's id; feed order sparse_0..2, dense_features, label."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        batch = []
        for _ in range(b):
            ids = [int(rng.zipf(1.3) - 1) % d for d in (200, 200, 50)]
            batch.append((*ids, rng.randn(4).astype(np.float32),
                          int(ids[0] % 2)))
        out.append(batch)
    return out


def _ml_batches(n=STEPS, b=16, seed=1):
    rng = np.random.RandomState(seed)
    return [[(int(rng.randint(20)), int(rng.randint(30)),
              np.float32([rng.randint(1, 6)])) for _ in range(b)]
            for _ in range(n)]


WD_FEEDING = {"sparse_0": 0, "sparse_1": 1, "sparse_2": 2,
              "dense_features": 3, "label": 4}
ML_FEEDING = {"user_id": 0, "movie_id": 1, "score": 2}


def _train_both(build, batches, feeding, opt, evaluators=None, passes=1):
    """Train ``build(models)`` in both packages from one tar; returns
    the two trainers and their per-step costs."""
    out = []
    tar = None
    for pkg, models, reset, ev in ((jpaddle, jmodels, j_reset, jev),
                                   (tpaddle, tmodels, t_reset, tev)):
        reset()
        if pkg is jpaddle:
            pkg.init(seed=3)
        else:
            pkg.init(use_gpu=False, seed=3)
        spec = build(models)
        if tar is None:
            params = pkg.create_parameters(pkg.Topology(spec.cost))
            buf = io.BytesIO()
            params.to_tar(buf)
            tar = buf.getvalue()
        else:
            params = pkg.Parameters.from_tar(io.BytesIO(tar))
        evs = evaluators(ev, spec) if evaluators else None
        tr = pkg.SGD(cost=spec.cost, parameters=params,
                     update_equation=opt(pkg), evaluators=evs)
        costs, passes_m = [], []

        def handler(e, pkg=pkg, costs=costs, passes_m=passes_m):
            if isinstance(e, pkg.event.EndIteration):
                costs.append(e.cost)
            if isinstance(e, pkg.event.EndPass):
                passes_m.append(dict(e.metrics))

        tr.train(lambda: iter(batches), num_passes=passes,
                 event_handler=handler, feeding=feeding)
        out.append((tr, costs, passes_m))
    return out


def _assert_params_equal(jtr, ttr):
    for k, v in jtr.parameters.raw.items():
        np.testing.assert_allclose(_np(ttr.parameters.raw[k]), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_wide_and_deep_trains_like_jax():
    (jtr, jc, _), (ttr, tc, _) = _train_both(
        _wd, _wd_batches(), WD_FEEDING,
        lambda p: p.optimizer.Adam(learning_rate=5e-3))
    assert sorted(ttr.topology.sparse_tables()) == sorted(
        jtr.topology.sparse_tables()) == [
        "_wd_emb0_w", "_wd_emb1_w", "_wd_emb2_w", "_wd_wide0_w",
        "_wd_wide1_w", "_wd_wide2_w"]
    assert len(tc) == len(jc) == STEPS
    np.testing.assert_allclose(tc, jc, rtol=RTOL_COST)
    _assert_params_equal(jtr, ttr)
    for k, slot in jtr.opt_state["slots"].items():
        if "_t" in slot:
            np.testing.assert_array_equal(
                _np(ttr.opt_state["slots"][k]["_t"]), np.asarray(slot["_t"]))


def test_movielens_regression_trains_like_jax():
    (jtr, jc, _), (ttr, tc, _) = _train_both(
        lambda m: m.movielens_regression(20, 30, 8), _ml_batches(),
        ML_FEEDING, lambda p: p.optimizer.Adam(learning_rate=2e-3))
    assert ttr.topology.sparse_tables() == {}
    assert len(tc) == len(jc) == STEPS
    np.testing.assert_allclose(tc, jc, rtol=RTOL_COST)
    _assert_params_equal(jtr, ttr)


def test_wide_and_deep_auc_equals_jax():
    batches = _wd_batches(n=4, b=64, seed=2)
    (jtr, _, jp), (ttr, _, tp) = _train_both(
        _wd, batches, WD_FEEDING,
        lambda p: p.optimizer.Adam(learning_rate=5e-3),
        evaluators=lambda ev, spec: [ev.auc(spec.output,
                                            _FakeLayer("label"))],
        passes=3)
    assert [p["auc"] for p in tp] == [p["auc"] for p in jp]
    assert tp[-1]["auc"] > tp[0]["auc"]
    test_batches = _wd_batches(n=2, b=64, seed=5)
    jres = jtr.test(lambda: iter(test_batches), feeding=WD_FEEDING)
    tres = ttr.test(lambda: iter(test_batches), feeding=WD_FEEDING)
    assert tres.metrics["auc"] == jres.metrics["auc"]
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=RTOL_COST)


def test_movielens_dataset_equals_jax():
    from paddle_tpu.dataset import movielens as jml
    from paddle_tpu_torch.dataset import movielens as tml
    for split in ("train", "test"):
        j = list(getattr(jml, split)()())
        t = list(getattr(tml, split)()())
        assert len(t) == len(j) > 0
        assert t == j
    assert (tml.max_user_id(), tml.max_movie_id(), tml.max_job_id()) == \
        (jml.max_user_id(), jml.max_movie_id(), jml.max_job_id())
    assert tpaddle.dataset.movielens is tml


def test_recommendation_v2_script_tracks_jax():
    quiet = lambda _: None  # noqa: E731
    j = chip_smoke.recommendation_v2_demo(jpaddle, use_tpu=False,
                                          num_passes=1,
                                          num_batches_per_pass=8, echo=quiet)
    t_reset()
    t = chip_smoke.recommendation_v2_demo(tpaddle, use_tpu=False,
                                          num_passes=1,
                                          num_batches_per_pass=8,
                                          init_tar=j["init_tar"], echo=quiet)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == 8
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=RTOL_COST)
    np.testing.assert_allclose(t["test_cost"], j["test_cost"],
                               rtol=RTOL_COST)
