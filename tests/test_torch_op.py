"""Port parity: ``paddle_tpu_torch.op`` — the unary math ops and the
LayerOutput operators — against ``paddle_tpu.op`` on the CPU.

Each unary op (exp, log, abs, sigmoid, tanh, square, relu, sqrt,
reciprocal, softmax) and each operator form (``a + b``, ``a + 2.0``,
``2.0 + a``, a size-1 operand broadcast on either side of ``+``,
``-a``, ``a - b``, ``a - 3.0`` — which subtracts, the JAX package's
documented deviation from the 2017 code —, ``3.0 - a``, ``2 * a``, a
size-1 layer times a layer on either side) builds, in both packages,
the same topology JSON (``check_parity`` asserts it) and computes the
same outputs and parameter gradients at rtol 1e-4 / atol 1e-5. The
operand errors raise ``TypeError`` in both. Both packages are imported
here, each with its operators on its own LayerOutput class.
"""

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import LayerOutput as JLayerOutput
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu_torch.core.registry import LayerOutput as TLayerOutput
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from tests.torch_parity import check_parity, submodule

B, D = 4, 6
UNARY = ("exp", "log", "abs", "sigmoid", "tanh", "square", "relu", "sqrt",
         "reciprocal", "softmax")
# ops whose input must be positive take a sigmoid fc
POSITIVE = ("log", "sqrt", "reciprocal")


def _samples(seed=0):
    rng = np.random.RandomState(seed)
    return [tuple(rng.randn(D).astype(np.float32) for _ in range(3))
            for _ in range(B)]


def _inputs(L, sigmoid=False):
    """a and b (fc size D) and w (fc size 1), each over its own data."""
    dt = submodule(L, "core.data_type")
    act = submodule(L, "activation").Sigmoid() if sigmoid else None
    a = L.fc(L.data("x", dt.dense_vector(D)), size=D, act=act, name="a")
    b = L.fc(L.data("y", dt.dense_vector(D)), size=D, name="b")
    w = L.fc(L.data("z", dt.dense_vector(D)), size=1, name="w")
    return a, b, w


@pytest.mark.parametrize("name", UNARY)
def test_unary_op_matches_jax(name):
    def build(L):
        a, _, _ = _inputs(L, sigmoid=name in POSITIVE)
        return getattr(submodule(L, "op"), name)(a, name="out")

    check_parity(build, _samples())


FORMS = {
    "a_plus_b": lambda a, b, w: a + b,
    "a_plus_number": lambda a, b, w: a + 2.0,
    "number_plus_a": lambda a, b, w: 2.0 + a,
    "a_plus_size1": lambda a, b, w: a + w,
    "size1_plus_a": lambda a, b, w: w + a,
    "neg_a": lambda a, b, w: -a,
    "a_minus_b": lambda a, b, w: a - b,
    "a_minus_number": lambda a, b, w: a - 3.0,
    "number_minus_a": lambda a, b, w: 3.0 - a,
    "a_minus_size1": lambda a, b, w: a - w,
    "number_times_a": lambda a, b, w: 2 * a,
    "a_times_number": lambda a, b, w: a * 0.5,
    "size1_times_a": lambda a, b, w: w * a,
    "a_times_size1": lambda a, b, w: a * w,
    "chain": lambda a, b, w: 1.0 - (a * w + (-b)) * 2,
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_operator_matches_jax(form):
    def build(L):
        out = FORMS[form](*_inputs(L))
        assert isinstance(out, JLayerOutput if L is jpaddle.layer
                          else TLayerOutput)
        return out

    check_parity(build, _samples())


def test_a_minus_number_subtracts():
    """The JAX package's deviation from the 2017 op.py (which added the
    constant): ``a - 3.0`` is slope_intercept(intercept=-3.0)."""
    treset()
    a, _, _ = _inputs(tpaddle.layer)
    out = a - 3.0
    assert out.type == "slope_intercept"
    assert out.config["intercept"] == -3.0 and out.config["slope"] == 1.0


ERRORS = {
    "add_string": lambda a, b, w, c: a + "x",
    "sub_string": lambda a, b, w, c: a - "x",
    "mul_string": lambda a, b, w, c: a * "x",
    "add_sizes": lambda a, b, w, c: a + c,
    "mul_sizes": lambda a, b, w, c: a * b,
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_operand_errors_raise_type_error(case):
    for pkg, reset in ((jpaddle, jreset), (tpaddle, treset)):
        reset()
        L = pkg.layer
        a, b, w = _inputs(L)
        c = L.fc(a, size=4, name="c")
        with pytest.raises(TypeError):
            ERRORS[case](a, b, w, c)


def test_each_package_patches_its_own_layer_output():
    """Both packages are imported in one process: ``+`` on a JAX node
    builds a JAX node with the JAX package's layer, and on a port node a
    port node."""
    assert JLayerOutput.__add__ is not TLayerOutput.__add__
    assert JLayerOutput.__add__.__module__ == "paddle_tpu.op"
    assert TLayerOutput.__add__.__module__ == "paddle_tpu_torch.op"
    jreset()
    ja, jb, _ = _inputs(jpaddle.layer)
    treset()
    ta, tb, _ = _inputs(tpaddle.layer)
    assert type(ja + jb) is JLayerOutput and type(ta + tb) is TLayerOutput
    assert tpaddle.op is submodule(tpaddle.layer, "op")
    assert sorted(tpaddle.op.__all__) == sorted(jpaddle.op.__all__)
