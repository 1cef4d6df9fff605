"""Port parity: the optimizers, model averaging and learning-rate
schedules of paddle_tpu_torch against paddle_tpu on the CPU.

- Adamax, AdaGrad, DecayedAdaGrad, AdaDelta and RmsProp (and Momentum
  and Adam beside them), each with and without ``ModelAverage``, and
  Momentum under each schedule: five steps of a small fc topology from
  one weight tar. Each step's gradient comes from the port's forward
  and autograd; the JAX rule (``Optimizer.update``) and the port's
  apply it to their own parameters and state. The parameters and
  ``test_params`` (the model average when it is on) stay within rtol
  1e-5 of the JAX rule's (atol 1e-7 for values that cross zero). The
  gradient is shared because AdaGrad-type rules divide a gradient by
  its own size: two autograds' last-bit differences on a near-zero
  entry move that parameter by up to the learning rate.
- The port's ``SGD`` trainer runs the same rules: its five
  ``train_batch`` steps give the parameters of the shared-gradient run
  (rtol 1e-5), and ``SGD.test`` evaluates ``test_params``.
- Each schedule (constant, poly, caffe_poly, exp, discexp, linear,
  noam) gives the JAX schedule's rate at rtol 1e-5: JAX evaluates it
  in float32 on a float32 sample count and the port in host float64,
  and caffe_poly's 1 - t/a loses float32 digits as t nears a (1.9e-6
  relative at t = 99, a = 100).
"""

import io

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as jpaddle
import torch
from paddle_tpu.optimizer import schedules as jsched

import paddle_tpu_torch as paddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.optimizer import schedules as tsched
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder

RTOL, ATOL = 1e-5, 1e-7
RTOL_RATE = 1e-5
STEPS = 5

RULES = {
    "Momentum": dict(momentum=0.9, learning_rate=0.05),
    "Adam": dict(learning_rate=0.01),
    "Adamax": dict(learning_rate=0.01, beta1=0.8, beta2=0.95),
    "AdaGrad": dict(learning_rate=0.05),
    "DecayedAdaGrad": dict(learning_rate=0.02, rho=0.9),
    "AdaDelta": dict(learning_rate=1.0, rho=0.9),
    "RmsProp": dict(learning_rate=0.01, rho=0.9),
}
SCHEDULES = {
    "constant": (0.0, 0.0),
    "poly": (0.1, 0.5),
    "caffe_poly": (100.0, 2.0),
    "exp": (0.5, 16.0),
    "discexp": (0.5, 16.0),
    "linear": (1e-3, 0.01),
    "noam": (16.0, 0.0),
}


@pytest.fixture(autouse=True)
def _port_config():
    t_reset()
    yield
    tconfig.init(seed=0)


def _net(pkg):
    x = pkg.layer.data("x", pkg.data_type.dense_vector(5))
    h = pkg.layer.fc(x, size=6, act=pkg.activation.Tanh(), name="h")
    out = pkg.layer.fc(h, size=3, act=pkg.activation.Softmax(), name="out")
    lbl = pkg.layer.data("y", pkg.data_type.integer_value(3))
    return pkg.layer.classification_cost(out, lbl, name="cost")


def _batches():
    rng = np.random.RandomState(1)
    return [[(rng.randn(5).astype(np.float32), int(rng.randint(0, 3)))
             for _ in range(8)] for _ in range(STEPS)]


def _np(table):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in table.items()}


def _shared_gradient_run(make_opt):
    """STEPS updates from one JAX table (through a params tar), both
    rules fed the port's gradient at the port's parameters. Returns the
    init tar and, per package, (params, test_params) as numpy."""
    jpaddle.init(use_tpu=False, seed=2)
    jtopo = jpaddle.Topology(_net(jpaddle))
    ttopo = paddle.Topology(_net(paddle))
    buf = io.BytesIO()
    jpaddle.create_parameters(jtopo).to_tar(buf)
    tar = buf.getvalue()
    tparams = paddle.Parameters.from_tar(io.BytesIO(tar), device="cpu").raw
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tparams.items()}
    jopt = make_opt(jpaddle).bind(jtopo.param_specs)
    topt = make_opt(paddle).bind(ttopo.param_specs)
    jstate, tstate = jopt.init_state(jparams), topt.init_state(tparams)
    names = sorted(tparams)
    for batch in _batches():
        feed = TFeeder(ttopo.data_type(), device="cpu")(batch)
        n = feed.pop("__batch_size__")
        leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
        outs, _ = ttopo.forward(leaves, {}, feed, mode="train")
        grads = dict(zip(names, torch.autograd.grad(
            outs["cost"].sum() / n, [leaves[k] for k in names])))
        jparams, jstate = jopt.update(
            jparams, {k: jnp.asarray(g.numpy()) for k, g in grads.items()},
            jstate, n)
        _, tstate = topt.update(tparams, grads, tstate, n)
    return tar, (_np(jparams), _np(jopt.test_params(jparams, jstate))), \
        (_np(tparams), _np(topt.test_params(tparams, tstate)))


def _trainer_run(make_opt, tar):
    """The same STEPS through the port's SGD.train_batch; returns the
    trained params, the test params and SGD.test's cost."""
    tconfig.init(use_gpu=False)
    cost = _net(paddle)
    params = paddle.Parameters.from_tar(io.BytesIO(tar))
    tr = paddle.SGD(cost=cost, parameters=params,
                    update_equation=make_opt(paddle))
    batches = _batches()
    for b in batches:
        tr.train_batch(b)
    own = tr._own_params()
    test = tr.optimizer.test_params(own, tr.opt_state)
    return _np(own), _np(test), tr, batches


def _close(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def _held(make_opt):
    tar, (jp, jtest), (tp, ttest) = _shared_gradient_run(make_opt)
    _close(tp, jp, "params")
    _close(ttest, jtest, "test_params")
    sp, stest, tr, batches = _trainer_run(make_opt, tar)
    _close(sp, tp, "SGD params")
    _close(stest, ttest, "SGD test_params")
    return tp, ttest, tr, batches


@pytest.mark.parametrize("average", [False, True],
                         ids=["plain", "model_average"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax_over_five_steps(rule, average):
    def make(pkg):
        kw = dict(RULES[rule])
        if average:
            kw["model_average"] = pkg.optimizer.ModelAverage(
                average_window=0.5, max_average_window=3)
        return getattr(pkg.optimizer, rule)(**kw)
    params, test_params, tr, batches = _held(make)
    moved = [k for k in params
             if not np.array_equal(params[k], test_params[k])]
    # with the average on, test_params is not the trained table
    assert bool(moved) == average
    # SGD.test evaluates test_params
    res = tr.test(lambda: iter(batches[:2]))
    ttopo = tr.topology
    total = 0.0
    for b in batches[:2]:
        feed = TFeeder(ttopo.data_type(), device="cpu")(b)
        n = feed.pop("__batch_size__")
        outs, _ = ttopo.forward({k: torch.tensor(v)
                                 for k, v in test_params.items()},
                                {}, feed, mode="test")
        total += float(outs["cost"].sum()) / n
    np.testing.assert_allclose(res.cost, total / 2, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_rate_matches_jax(name):
    a, b = SCHEDULES[name]
    jf = jsched.make_schedule(name, 0.1, a, b)
    tf = tsched.make_schedule(name, 0.1, a, b)
    for t in (0.0, 1.0, 8.0, 15.0, 16.0, 17.0, 40.0, 99.0):
        want = float(jf(jnp.asarray(t, jnp.float32)))
        np.testing.assert_allclose(tf(t), want, rtol=RTOL_RATE,
                                   err_msg=f"{name} at t={t}")


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_five_steps(name):
    a, b = SCHEDULES[name]

    def make(pkg):
        return pkg.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1, learning_rate_schedule=name,
            learning_rate_decay_a=a, learning_rate_decay_b=b)
    _held(make)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown"):
        tsched.make_schedule("manual", 0.1)
