"""Port parity: paddle_tpu_torch/parallel/pipeline.py and the pipelined
trainer against paddle_tpu on the CPU, the port as one spawned gloo
world of 4 (tests/torch_dist.py).

The counterparts of tests/test_pipeline.py (pp4): the GPipe output
against the JAX pipeline's on the same stacked stage parameters, with m
= n and m = 8 microbatches (and pipeline_loss on it), under ``torch.no_grad`` (the JAX test's
inside-jit case), and its gradients (stage weights, biases and the
input; GPipe with and without remat) against ``jax.grad`` of the JAX
test's sequential reference, which that test holds the JAX pipeline
to.

The counterparts of tests/test_pipeline_sgd.py: its MLP trained by SGD
over pp2 (dp2 x pp2 here: the same pipeline under each dp group) with
GPipe, GPipe with remat and 1F1B, over pp4 with GPipe and with 1F1B at
8 microbatches, and the transformer LM's blocks as stages (SequenceBatch
boundary, embedding prologue) under GPipe and 1F1B — each run's costs
and parameters, from one JAX weight tar, against the JAX package's
unpipelined run (which test_pipeline_sgd.py holds the JAX pipelined runs
to), so GPipe and 1F1B agree with each other and with the unpipelined
step; 1F1B's saved stage inputs flat in the microbatch count where
GPipe's grow; the stage-map refusals.

Tolerances: outputs rtol 1e-5 / atol 1e-6, gradients 1e-4 / 1e-5 (the
JAX test's), training the JAX package's pipeline parity (rtol 1e-4,
atol 1e-5; the LM's 2e-4 / 2e-5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
from paddle_tpu.parallel import PP_AXIS
from paddle_tpu.parallel import create_mesh as jmesh
from paddle_tpu.parallel.pipeline import pipeline as jpipeline
from tests import torch_dist as td
from tests.test_torch_parallel import _tar, assert_run_close, jax_run
from tests.torch_dist import run_world


def _stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _sequential(stage_params, x):
    for i in range(stage_params["w"].shape[0]):
        x = _stage({"w": stage_params["w"][i], "b": stage_params["b"][i]}, x)
    return x


def _params(n=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(n, d, d) * 0.3).astype("float32"),
            "b": (rng.randn(n, d) * 0.1).astype("float32")}


def _x(rows, seed):
    return np.random.RandomState(seed).randn(rows, 16).astype("float32")


CASES = {
    "sequential": dict(_params(), x=_x(8, 1), loss=True),
    "more_microbatches": dict(_params(seed=2), x=_x(16, 3), m=8),
    "grad": dict(_params(seed=4), x=_x(8, 5), grad=True),
    "grad_remat": dict(_params(seed=4), x=_x(8, 5), grad=True, remat=True),
    "no_grad": dict(_params(seed=6), x=_x(8, 7)),
}

MOMENTUM = ("Momentum", {"learning_rate": 0.1, "momentum": 0.9})
LM = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
          max_len=8)
PP2 = [("dp", 2), ("pp", 2)]
PP4 = [("pp", 4)]


def _mlp_batches(n_batches=3, b=8):
    rng = np.random.RandomState(0)
    return [[(rng.randn(32).astype("float32"), int(rng.randint(4)))
             for _ in range(b)] for _ in range(n_batches)]


def _lm_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(3):
        rows = []
        for _ in range(8):
            ids = rng.randint(0, 40, 9)
            rows.append(([int(v) for v in ids[:8]], list(range(8)),
                         [int(v) for v in ids[1:]]))
        out.append(rows)
    return out


def _sgd_runs(tmp):
    mlp = dict(model="pipe_mlp", tar=_tar(tmp, "mlp", "pipe_mlp"),
               opt=MOMENTUM, batches=_mlp_batches(), passes=2)
    two = [["pfc0", "pfc1"], ["pfc2", "pfc3"]]
    four = [[f"pfc{i}"] for i in range(4)]
    lm = dict(model="lm", model_kw=LM, tar=_tar(tmp, "lm", "lm", LM),
              opt=("Adam", {"learning_rate": 1e-3}), batches=_lm_batches(),
              passes=2, mesh=PP2)
    return {
        "mlp": mlp, "lm": lm,
        "pp2": dict(mlp, mesh=PP2, sgd={"pipeline_stages": two}),
        "pp2_remat": dict(mlp, mesh=PP2, sgd={"pipeline_stages": two,
                                              "pipeline_remat": True}),
        "pp2_1f1b": dict(mlp, mesh=PP2, sgd={"pipeline_stages": two,
                                             "pipeline_schedule": "1f1b"}),
        "pp4": dict(mlp, mesh=PP4, sgd={"pipeline_stages": four}),
        "pp4_1f1b_m8": dict(mlp, mesh=PP4, sgd={
            "pipeline_stages": four, "pipeline_schedule": "1f1b",
            "pipeline_microbatches": 8}),
        "lm_gpipe": dict(lm, sgd={"pipeline_stages": td.lm_stages(2)}),
        "lm_1f1b": dict(lm, sgd={"pipeline_stages": td.lm_stages(2),
                                 "pipeline_schedule": "1f1b",
                                 "pipeline_microbatches": 4}),
    }


SGD_RUNS = ["pp2", "pp2_remat", "pp2_1f1b", "pp4", "pp4_1f1b_m8", "lm_gpipe",
            "lm_1f1b"]


@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)


@pytest.fixture(scope="module")
def pp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    runs = _sgd_runs(tmp)
    names = list(CASES)
    items = [("pipeline_cases", {"cases": [CASES[n] for n in names]}),
             ("pipeline_memory", {"ms": [4, 32]}),
             ("stage_validation", {})]
    items += [("train_run", {"run": runs[n]}) for n in SGD_RUNS]
    res = run_world(td.scenario, 4, tmp, items)
    ranks = [dict(cases=dict(zip(names, r[0])), memory=r[1],
                  refusals=r[2], runs=dict(zip(SGD_RUNS, r[3:])))
             for r in res]
    return ranks, runs


def _check_case(pp_world, name):
    ranks, _ = pp_world
    c = CASES[name]
    params = {k: jnp.asarray(c[k]) for k in "wb"}
    x = jnp.asarray(c["x"])
    want = np.asarray(jpipeline(_stage, params, x, jmesh([(PP_AXIS, 4)]),
                                num_microbatches=c.get("m")))
    np.testing.assert_allclose(want, np.asarray(_sequential(params, x)),
                               rtol=1e-5, atol=1e-6)
    grads = None
    if c.get("grad"):
        grads = jax.grad(lambda p, x: jnp.sum(_sequential(p, x) ** 2),
                         argnums=(0, 1))(params, x)
    for rank in ranks:
        got = rank["cases"][name]
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-6)
        if c.get("loss"):
            np.testing.assert_allclose(got["loss"], float(np.sum(want ** 2)),
                                       rtol=1e-5)
        if grads is not None:
            for k in "wb":
                np.testing.assert_allclose(got["grads"][k],
                                           np.asarray(grads[0][k]),
                                           rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["grads"]["x"],
                                       np.asarray(grads[1]),
                                       rtol=1e-4, atol=1e-5)


class TestPipeline:
    def test_matches_sequential(self, pp_world):
        _check_case(pp_world, "sequential")

    def test_more_microbatches(self, pp_world):
        _check_case(pp_world, "more_microbatches")

    @pytest.mark.parametrize("name", ["grad", "grad_remat"])
    def test_differentiable(self, pp_world, name):
        _check_case(pp_world, name)

    def test_inside_no_grad(self, pp_world):
        _check_case(pp_world, "no_grad")


@pytest.fixture(scope="module")
def jax_single(pp_world):
    _, runs = pp_world
    return {"mlp": jax_run(runs["mlp"]),
            "lm": jax_run(dict(runs["lm"], mesh=None))}


class TestPipelineSGD:
    @pytest.mark.parametrize("name", ["pp2", "pp2_remat", "pp2_1f1b", "pp4",
                                      "pp4_1f1b_m8"])
    def test_matches_single_device(self, pp_world, jax_single, name):
        ranks, _ = pp_world
        for rank in ranks:
            assert_run_close(rank["runs"][name], jax_single["mlp"],
                             rtol=1e-4, atol=1e-5)

    def test_pp4_loss_falls(self, pp_world):
        ranks, _ = pp_world
        losses = ranks[0]["runs"]["pp4"]["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]

    def test_1f1b_memory_flat_in_microbatches(self, pp_world):
        """1F1B keeps at most 2n-1 stage inputs whatever m (its ring
        buffer fills once m reaches it); GPipe keeps all m."""
        ranks, _ = pp_world
        for rank in ranks:
            g4, g32 = rank["memory"]["gpipe"]
            f4, f32 = rank["memory"]["1f1b"]
            assert g32 == 8 * g4, (g4, g32)
            assert f4 <= f32 <= 2 * 4 - 1, (f4, f32)
            assert f32 < g32 / 2, (f32, g32)

    def test_stage_validation(self, pp_world):
        ranks, _ = pp_world
        for rank in ranks:
            (t1, m1), (t2, m2) = rank["refusals"]
            assert t1 == "AssertionError" and "structurally identical" in m1
            assert t2 == "ValueError" and "pipeline_stages" in m2


class TestTransformerPipeline:
    @pytest.mark.parametrize("name", ["lm_gpipe", "lm_1f1b"])
    def test_matches_single_device(self, pp_world, jax_single, name):
        ranks, _ = pp_world
        for rank in ranks:
            assert_run_close(rank["runs"][name], jax_single["lm"])
        if name == "lm_1f1b":
            drift = [m["pipeline_loss_drift"]
                     for m in ranks[0]["runs"][name]["metrics"]]
            np.testing.assert_allclose(drift, 0.0, atol=1e-5)


def test_sgd_validates_pipeline_options():
    """SGD takes pipeline_remat, pipeline_schedule and
    pipeline_microbatches as its own parameters and refuses an unknown
    schedule, as the JAX SGD does (an assert there); they are kept on
    the trainer."""
    import paddle_tpu_torch as tpaddle
    for paddle, err in ((jpaddle, AssertionError), (tpaddle, ValueError)):
        paddle.init(use_tpu=False, seed=0)
        cost, _, _ = td.build(paddle, "pipe_mlp")
        params = paddle.create_parameters(paddle.Topology(cost), **(
            {"device": "cpu"} if paddle is tpaddle else {}))
        opt = paddle.optimizer.Momentum(learning_rate=0.1)
        with pytest.raises(err):
            paddle.SGD(cost=cost, parameters=params, update_equation=opt,
                       pipeline_schedule="interleaved")
        tr = paddle.SGD(cost=cost, parameters=params, update_equation=opt,
                        pipeline_remat=True, pipeline_schedule="1f1b",
                        pipeline_microbatches=4)
        assert (tr.pipeline_remat, tr.pipeline_schedule,
                tr.pipeline_microbatches) == (True, "1f1b", 4)
