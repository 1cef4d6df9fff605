"""Shared helpers of the port's training-infrastructure tests
(checkpoints, the guarded step, microbatching, the CLI): one small
classifier built in both packages from one JAX weight table, seeded
batch readers, the fault injections of the port's ``testing/faults.py``
under the names these tests use, and parameter comparisons.

Both trainers start from the same table: the JAX package's init,
carried to the port as numpy arrays. Names match because each package
builds the graph from reset name counters.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from paddle_tpu_torch.testing.faults import FaultPlan


def build(paddle, in_dim=8, hidden=4, classes=2, bn=False):
    """x -> fc(relu) [-> batch_norm] -> fc(softmax) -> cost, named."""
    x = paddle.layer.data("x", paddle.data_type.dense_vector(in_dim))
    y = paddle.layer.data("y", paddle.data_type.integer_value(classes))
    h = paddle.layer.fc(x, size=hidden, act=paddle.activation.Relu(),
                        name="hidden")
    if bn:
        h = paddle.layer.batch_norm(h, act=paddle.activation.Linear(),
                                    name="bn")
    out = paddle.layer.fc(h, size=classes,
                          act=paddle.activation.Softmax(), name="out")
    return paddle.layer.classification_cost(out, y, name="cost")


def table(seed=3, **kw):
    """The JAX init of ``build``'s graph as a numpy table."""
    jpaddle.init(use_tpu=False, seed=0)
    jreset()
    cost = build(jpaddle, **kw)
    topo = jpaddle.Topology(cost)
    return {k: np.asarray(v)
            for k, v in topo.init_params(jax.random.PRNGKey(seed)).items()}


def jax_trainer(opt, tab, **kw):
    jpaddle.init(use_tpu=False, seed=0)
    jreset()
    cost = build(jpaddle, **kw)
    params = jpaddle.Parameters({k: jnp.asarray(v) for k, v in tab.items()})
    return jpaddle.SGD(cost=cost, parameters=params, update_equation=opt)


def port_trainer(opt, tab, **kw):
    tpaddle.init(use_gpu=False, seed=0)
    treset()
    cost = build(tpaddle, **kw)
    params = tpaddle.Parameters({k: torch.tensor(v) for k, v in tab.items()},
                                device="cpu")
    return tpaddle.SGD(cost=cost, parameters=params, update_equation=opt,
                       device="cpu")


def reader(rows=8, batches=6, seed=42, in_dim=8, classes=2):
    """A batch reader: ``batches`` seeded batches of ``rows`` samples."""
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(batches):
            f = rng.randn(rows, in_dim).astype("float32")
            lbl = rng.randint(0, classes, rows)
            yield [(f[i], int(lbl[i])) for i in range(rows)]
    return r


def poison(rdr, steps, value=float("nan")):
    """The batches at ``steps`` with every feature replaced by ``value``
    (the port's ``FaultPlan.poison_batches``)."""
    return FaultPlan().poison_batches(rdr, steps, value=value)


def skipping(rdr, steps):
    bad = set(steps)

    def r():
        for i, batch in enumerate(rdr()):
            if i not in bad:
                yield batch
    return r


def run(trainer, rdr, num_passes=1, **kw):
    """Train; returns (costs per step, events)."""
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer.train(rdr, num_passes=num_passes,
                      event_handler=events.append, **kw)
    costs = [e.cost for e in events if type(e).__name__ in
             ("EndIteration", "LazyEndIteration")]
    return costs, events


def port_params(trainer):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in trainer.parameters.raw.items()}


def jax_params(trainer):
    return {k: np.asarray(v) for k, v in trainer.parameters.raw.items()}


def assert_close(a, b, rtol, atol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def kinds(events, cls):
    return [e for e in events if isinstance(e, cls)]


# the port's FaultPlan under the names these tests use: the step raises a
# device OOM on its first ``n`` attempts at step ``step``; every step or
# probe trial over ``max_rows`` microbatch rows raises one
oom_at = FaultPlan.oom_at
memory_pressure = FaultPlan.memory_pressure
