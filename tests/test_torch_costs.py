"""Port parity: the regression, ranking and other cost layers of
paddle_tpu_torch and ``cos_sim`` against paddle_tpu on the CPU.

Each cost type (``square_error`` with and without a weight,
``soft_binary_class_cross_entropy``, ``multi_binary_label_cross_entropy``,
``rank-cost`` with and without a weight, ``lambda_cost``,
``huber_regression``, ``huber_classification``, ``smooth_l1``,
``sum_cost``, ``cross_entropy_with_selfnorm``, ``hsigmoid``) and
``cos_sim`` is built in both DSLs on top of fc layers, on flat inputs
and on sequences where the type takes both, and run from one weight
tar on one seeded feed: the outputs equal JAX's, and autograd's
parameter gradients of a seeded projection of them equal ``jax.grad``'s,
at rtol 1e-4 / atol 1e-5 (``tests/torch_parity.check_parity``). The
ops themselves are held the same way against ``jax.vjp`` with respect
to their float inputs, on values that reach every branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import cost as jcost
from paddle_tpu.ops import linear as jlinear
from paddle_tpu_torch.ops import cost as tcost
from paddle_tpu_torch.ops import linear as tlinear
from tests.torch_parity import (ATOL, RTOL, assert_values_close,
                                check_parity, submodule)

LENS = [5, 2, 7]
D = 6


def _dt(L):
    return submodule(L, "core.data_type")


def _act(L):
    return submodule(L, "activation")


def _flat_samples(extra, n=4, seed=0):
    """n samples: x (dense D), then one column per ``extra`` maker."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(D).astype(np.float32),) + tuple(f(rng) for f in extra)
            for _ in range(n)]


def _seq_samples(extra, seed=0):
    """One sample per LENS entry: x (a [len, D] sequence), then one
    column per ``extra`` maker, called with the length."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, D).astype(np.float32),) +
            tuple(f(rng, n) for f in extra) for n in LENS]


def _x(L, seq):
    dt = _dt(L)
    return L.data("x", dt.dense_vector_sequence(D) if seq
                  else dt.dense_vector(D))


def _dense(L, name, dim, seq):
    dt = _dt(L)
    return L.data(name, dt.dense_vector_sequence(dim) if seq
                  else dt.dense_vector(dim))


def _pred(L, seq, size, act=None):
    return L.fc(_x(L, seq), size=size, act=act, name="pred")


def _regression(kind, seq):
    """(build, samples) of a regression-type cost on a 3-wide target."""
    opts = {"huber_regression_cost": dict(delta=0.7),
            "smooth_l1_cost": dict(sigma=1.5)}.get(kind, {})

    def build(L):
        pred = _pred(L, seq, 3)
        return getattr(L, kind)(pred, _dense(L, "y", 3, seq), name="cost",
                                **opts)

    col = (lambda r, n: r.randn(n, 3).astype(np.float32)) if seq else \
        (lambda r: r.randn(3).astype(np.float32))
    return build, (_seq_samples([col]) if seq else _flat_samples([col]))


def _binary(kind, seq):
    def build(L):
        pred = _pred(L, seq, 4, _act(L).Sigmoid())
        return getattr(L, kind)(pred, _dense(L, "y", 4, seq), name="cost")

    def lab(r, *n):
        v = r.rand(*(n + (4,))).astype(np.float32)
        return v if kind.startswith("soft") else (v > 0.5).astype(np.float32)

    return build, (_seq_samples([lab]) if seq else _flat_samples([lab]))


def _selfnorm(seq):
    def build(L):
        pred = _pred(L, seq, 4, _act(L).Exp())
        lbl = L.data("y", _dt(L).integer_value_sequence(4) if seq
                     else _dt(L).integer_value(4))
        return L.cross_entropy_with_selfnorm_cost(
            pred, lbl, name="cost", softmax_selfnorm_alpha=0.3)

    if seq:
        return build, _seq_samples(
            [lambda r, n: r.randint(0, 4, n).astype(np.int32)])
    return build, _flat_samples([lambda r: int(r.randint(4))])


def _sum(seq):
    def build(L):
        return L.sum_cost(_pred(L, seq, 3), name="cost")

    return build, (_seq_samples([]) if seq else _flat_samples([]))


def _cos_sim(seq):
    def build(L):
        x = _x(L, seq)
        a = L.fc(x, size=5, name="a")
        b = L.fc(x, size=5, act=_act(L).Tanh(), name="b")
        return L.cos_sim(a, b, scale=2.0, name="sim")

    return build, (_seq_samples([]) if seq else _flat_samples([]))


CASES = {}
for _kind in ("square_error_cost", "huber_regression_cost",
              "smooth_l1_cost"):
    for _seq in (False, True):
        CASES[f"{_kind}-{'seq' if _seq else 'flat'}"] = \
            (lambda k=_kind, s=_seq: _regression(k, s))
for _kind in ("soft_binary_class_cross_entropy_cost",
              "multi_binary_label_cross_entropy_cost"):
    for _seq in (False, True):
        CASES[f"{_kind}-{'seq' if _seq else 'flat'}"] = \
            (lambda k=_kind, s=_seq: _binary(k, s))
for _seq in (False, True):
    _tag = "seq" if _seq else "flat"
    CASES[f"cross_entropy_with_selfnorm-{_tag}"] = \
        (lambda s=_seq: _selfnorm(s))
    CASES[f"sum_cost-{_tag}"] = (lambda s=_seq: _sum(s))
    CASES[f"cos_sim-{_tag}"] = (lambda s=_seq: _cos_sim(s))


def _square_weighted():
    def build(L):
        w = L.data("w", _dt(L).dense_vector(1))
        return L.square_error_cost(_pred(L, False, 3),
                                   _dense(L, "y", 3, False), weight=w,
                                   name="cost")

    return build, _flat_samples([lambda r: r.randn(3).astype(np.float32),
                                 lambda r: r.rand(1).astype(np.float32)])


def _rank(weighted):
    def build(L):
        x = _x(L, False)
        sa = L.fc(x, size=1, name="sa")
        sb = L.fc(x, size=1, act=_act(L).Tanh(), name="sb")
        lbl = L.data("label", _dt(L).dense_vector(1))
        w = L.data("w", _dt(L).dense_vector(1)) if weighted else None
        return L.rank_cost(sa, sb, lbl, weight=w, name="cost")

    cols = [lambda r: r.rand(1).astype(np.float32)]
    if weighted:
        cols.append(lambda r: r.rand(1).astype(np.float32) + 0.5)
    return build, _flat_samples(cols)


def _lambda():
    def build(L):
        scores = L.fc(_x(L, True), size=1, name="scores")
        rel = L.data("rel", _dt(L).dense_vector_sequence(1))
        return L.lambda_cost(scores, rel, NDCG_num=3, name="cost")

    return build, _seq_samples(
        [lambda r, n: r.randint(0, 4, (n, 1)).astype(np.float32)])


def _huber_class():
    def build(L):
        lbl = L.data("y", _dt(L).integer_value(2))
        return L.huber_classification_cost(_pred(L, False, 1), lbl,
                                           name="cost")

    return build, _flat_samples([lambda r: int(r.randint(2))], n=8)


def _hsigmoid():
    def build(L):
        x = _x(L, False)
        h = L.fc(x, size=5, act=_act(L).Tanh(), name="h")
        lbl = L.data("y", _dt(L).integer_value(7))
        return L.hsigmoid([h, x], lbl, num_classes=7, name="cost")

    return build, _flat_samples([lambda r: int(r.randint(7))], n=6)


CASES.update({
    "square_error_cost-weighted": _square_weighted,
    "rank_cost-flat": lambda: _rank(False),
    "rank_cost-weighted": lambda: _rank(True),
    "lambda_cost-seq": _lambda,
    "huber_classification_cost-flat": _huber_class,
    "hsigmoid-flat": _hsigmoid,
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_layer_forward_and_gradients_match_jax(case):
    build, samples = CASES[case]()
    check_parity(build, samples, mode="train")


# ---------------------------------------------------------------- the ops
def _vjp(jfn, tfn, args, grad_args, seed=7):
    """Forward equal, and the cotangents of a seeded projection of the
    output with respect to ``grad_args`` equal ``jax.vjp``'s."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a, requires_grad=(i in grad_args))
             for i, a in enumerate(args)]

    def jf(*g):
        full = list(jargs)
        for i, v in zip(grad_args, g):
            full[i] = v
        return jfn(*full)

    jout, vjp = jax.vjp(jf, *[jargs[i] for i in grad_args])
    tout = tfn(*targs)
    assert_values_close(tout, jout, "out")
    proj = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jg = vjp(jnp.asarray(proj))
    tg = torch.autograd.grad((tout * torch.as_tensor(proj)).sum(),
                             [targs[i] for i in grad_args])
    for i, a, b in zip(grad_args, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d/darg{i}")


R = np.random.RandomState(11)
PRED = (R.randn(6, 4) * 1.5).astype(np.float32)
TARGET = (R.randn(6, 4) * 1.5).astype(np.float32)
PROB = R.uniform(0.02, 0.98, (6, 4)).astype(np.float32)
SOFT = R.rand(6, 4).astype(np.float32)
LABEL4 = R.randint(0, 4, 6).astype(np.int32)
LABEL2 = np.array([0, 1, 1, 0, 0, 0], np.int32)
SCORE = np.array([[-2.5], [-0.4], [0.3], [0.9], [2.2], [-1.1]], np.float32)

OPS = {
    "square_error": (jcost.square_error, tcost.square_error,
                     (PRED, TARGET), (0, 1)),
    "huber_regression": (lambda p, l: jcost.huber_regression(p, l, 1.3),
                         lambda p, l: tcost.huber_regression(p, l, 1.3),
                         (PRED, TARGET), (0, 1)),
    "smooth_l1": (lambda p, l: jcost.smooth_l1(p, l, 0.8),
                  lambda p, l: tcost.smooth_l1(p, l, 0.8),
                  (PRED, TARGET), (0, 1)),
    "soft_binary_ce": (jcost.soft_binary_class_cross_entropy,
                       tcost.soft_binary_class_cross_entropy,
                       (PROB, SOFT), (0, 1)),
    "multi_binary_ce": (jcost.multi_binary_label_cross_entropy,
                        tcost.multi_binary_label_cross_entropy,
                        (PROB, (SOFT > 0.5).astype(np.float32)), (0,)),
    "selfnorm": (lambda p, l: jcost.cross_entropy_with_selfnorm(p, l, 0.2),
                 lambda p, l: tcost.cross_entropy_with_selfnorm(p, l, 0.2),
                 (PROB * 2.0, LABEL4), (0,)),
    "rank_cost": (jcost.rank_cost, tcost.rank_cost,
                  (SCORE, SCORE[::-1].copy(), SOFT[:, :1]), (0, 1)),
    "rank_cost_weighted": (jcost.rank_cost, tcost.rank_cost,
                           (SCORE, SCORE[::-1].copy(), SOFT[:, :1],
                            SOFT[:, 1:2]), (0, 1, 3)),
    "huber_classification": (jcost.huber_classification,
                             tcost.huber_classification,
                             (SCORE, LABEL2), (0,)),
    "sum_cost": (jcost.sum_cost, tcost.sum_cost, (PRED,), (0,)),
    "lambda_cost": (lambda s, r, m: jcost.lambda_cost(s, r, m, 3),
                    lambda s, r, m: tcost.lambda_cost(s, r, m, 3),
                    (PRED, R.randint(0, 4, (6, 4)).astype(np.float32),
                     np.array([[1, 1, 1, 0]] * 3 + [[1, 1, 1, 1]] * 3,
                              np.float32)), (0,)),
    "hsigmoid": (lambda f, w, b, l: jcost.hsigmoid_loss(f, w, b, l, 5),
                 lambda f, w, b, l: tcost.hsigmoid_loss(f, w, b, l, 5),
                 (PRED, R.randn(4, 4).astype(np.float32),
                  R.randn(4).astype(np.float32), LABEL4 + 1), (0, 1, 2)),
    "cos_sim": (lambda a, b: jlinear.cos_sim(a, b, 3.0),
                lambda a, b: tlinear.cos_sim(a, b, 3.0),
                (PRED, TARGET), (0, 1)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_cost_op_matches_jax_vjp(op):
    jfn, tfn, args, grad_args = OPS[op]
    _vjp(jfn, tfn, args, grad_args)


def test_huber_and_smooth_l1_reach_both_branches():
    a = np.abs(PRED - TARGET)
    assert (a <= 1.3).any() and (a > 1.3).any()
    assert (a < 1.0 / 0.64).any() and (a >= 1.0 / 0.64).any()
    z = SCORE[:, 0] * (2.0 * LABEL2 - 1.0)
    assert (z < -1).any() and ((z >= -1) & (z < 1)).any() and (z >= 1).any()
