"""Port parity: the image ops of paddle_tpu_torch (ops/conv.py,
ops/pool.py, ops/norm.py, ops/fused.py, the space_to_depth and dropout
layers) against paddle_tpu's on the CPU.

Inputs are made with numpy from a seed and go through both packages,
in float32 and under bfloat16 compute; gradients are ``torch.autograd``
against ``jax.vjp`` with one seeded cotangent.

Tolerances: float32 forwards at rtol 1e-4 / atol 1e-5 (the golden
harness's; two CPU convolution libraries summing in different orders),
float32 gradients at a relative norm of 1e-4 (each gradient's
||port - jax|| / ||jax||). bfloat16: both packages round the conv
inputs to bf16 and emit bf16, one ulp of which is 2^-8 of the value, so
forwards are held at a relative norm of 2e-2 (a few ulps of rounding
order on the bf16 outputs) and gradients at 3e-2: the JAX package's
bf16 batch-norm dgamma lies 2.3e-2 from its own float32 dgamma (its
bf16 products summed in bf16), where the port's lies 4.3e-3 from the
port's float32 one (measured on test_batch_norm_train_matches_jax's
inputs).

Dropout draws from torch generators and cannot match JAX's masks: it is
held on its own (keep rate, scaling, seeding, test mode, rate 0).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu.ops import conv as jconv, fused as jfused, norm as jnorm
from paddle_tpu.ops import pool as jpool

from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import ApplyContext
from paddle_tpu_torch.layers import base as tbase
from paddle_tpu_torch.ops import conv as tconv, fused as tfused
from paddle_tpu_torch.ops import norm as tnorm, pool as tpool

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4
BF16_REL = 2e-2
BF16_GRAD_REL = 3e-2
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def compute_dtype():
    """Sets both packages' compute dtype; float32 again afterwards."""
    def set_(name):
        paddle.init(use_tpu=False, seed=0, compute_dtype=name)
        tconfig.init(seed=0, compute_dtype=name)
    yield set_
    set_("float32")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _rel(got, want):
    """||got - want|| / ||want|| over the finite entries; the others (a
    max-pool window wholly in the padding is -inf) must be equal."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    live = np.isfinite(want)
    np.testing.assert_array_equal(got[~live], want[~live])
    got, want = got[live], want[live]
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _held(got, want, dtype):
    assert _np(got).shape == _np(want).shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **FWD)
    else:
        assert _rel(got, want) <= BF16_REL


def _check(jfn, tfn, arrays, dtype, seed=1):
    """Forward of ``jfn`` / ``tfn`` on ``arrays`` (numpy), then the
    gradient of every array under one seeded cotangent."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    jout, vjp = jax.vjp(jfn, *jargs)
    tout = tfn(*targs)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = tout if isinstance(tout, tuple) else (tout,)
    rng = np.random.RandomState(seed)
    cts = [rng.randn(*np.shape(o)).astype(np.float32) for o in jouts]
    for t, j in zip(touts, jouts):
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                           else torch.float32)
        _held(t, j, dtype)
    jg = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, jouts))
             if isinstance(jout, tuple) else jnp.asarray(cts[0], jout.dtype))
    tg = torch.autograd.grad(
        touts, targs, [torch.tensor(c).to(o.dtype)
                       for c, o in zip(cts, touts)], allow_unused=True)
    for t, j in zip(tg, jg):
        assert _rel(t, j) <= (GRAD_REL if dtype == "float32"
                               else BF16_GRAD_REL)
    return touts


# ---------------------------------------------------------------- conv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (1, 1, 1, 1), (2, 1, 1, 1), (2, 0, 1, 2), (1, 2, 2, 1),
    (3, 1, 1, 3), (1, 1, 1, 6)])
def test_conv2d_matches_jax(compute_dtype, dtype, stride, padding, dilation,
                            groups):
    compute_dtype(dtype)
    rng = np.random.RandomState(stride * 10 + padding + groups)
    x = rng.randn(2, 9, 7, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6 // groups, 12) * 0.3).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    _check(lambda x, w: jconv.conv2d(x, w, **kw),
           lambda x, w: tconv.conv2d(x, w, **kw), [x, w], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, 0), (3, 2, 1), (4, 2, 1), (2, 3, 0), (5, 2, 2)])
def test_conv2d_transpose_matches_jax(compute_dtype, dtype, k, stride,
                                      padding):
    """lax.conv_transpose without transpose_kernel: no kernel flip, which
    the port's F.conv_transpose2d call undoes by flipping w."""
    compute_dtype(dtype)
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 5, 4, 6).astype(np.float32)
    w = (rng.randn(k, k, 6, 4) * 0.3).astype(np.float32)
    kw = dict(stride=stride, padding=padding)
    _check(lambda x, w: jconv.conv2d_transpose(x, w, **kw),
           lambda x, w: tconv.conv2d_transpose(x, w, **kw), [x, w], dtype)


def test_conv_out_size_matches_jax():
    for i in range(1, 20):
        for k in range(1, 6):
            for s in range(1, 4):
                for p in range(0, 3):
                    for d in (1, 2):
                        for cm in (True, False):
                            assert tconv.conv_out_size(i, k, s, p, d, cm) == \
                                jconv.conv_out_size(i, k, s, p, d, cm)


# ---------------------------------------------------------------- pool

# (in, k, s, p, ceil_mode): caffe ceil windows, the clip of a last
# window past in + p (5/2/2/1, 8/3/3/2), a last window wholly in the
# right pad at padding 0 (9/1/3/0, where torch's own ceil_mode clips),
# padding above k/2 (6/2/2/2, which torch's pools refuse), floor mode
POOL_GRID = [(8, 2, 2, 0, True), (9, 3, 2, 1, True), (5, 2, 2, 1, True),
             (8, 3, 3, 2, True), (9, 1, 3, 0, True), (7, 3, 2, 0, True),
             (6, 2, 2, 2, True), (9, 3, 2, 1, False), (10, 4, 3, 1, False),
             (7, 7, 1, 0, True)]


@pytest.mark.parametrize("in_,k,s,p,ceil", POOL_GRID)
def test_pool_out_size_matches_jax(in_, k, s, p, ceil):
    assert tpool.pool_out_size(in_, k, s, p, ceil) == \
        jpool.pool_out_size(in_, k, s, p, ceil)
    assert tpool._ceil_pads(in_, k, s, p, ceil) == \
        jpool._ceil_pads(in_, k, s, p, ceil)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_,k,s,p,ceil", POOL_GRID)
def test_max_pool_matches_jax(compute_dtype, dtype, in_, k, s, p, ceil):
    compute_dtype(dtype)
    cd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = np.random.RandomState(in_ + k).randn(2, in_, in_ + 2, 3) \
        .astype(np.float32)
    if dtype == "bfloat16":       # the pool of a bf16 activation map
        x = np.asarray(jnp.asarray(x, cd).astype(jnp.float32))
    touts = _check(
        lambda x: jpool.max_pool2d(x.astype(cd), k, s, p, ceil_mode=ceil),
        lambda x: tpool.max_pool2d(x.to(tconv.compute_dtype()), k, s, p,
                                   ceil_mode=ceil), [x], dtype)
    assert touts[0].shape[1:3] == (jpool.pool_out_size(in_, k, s, p, ceil),
                                   jpool.pool_out_size(in_ + 2, k, s, p,
                                                       ceil))


@pytest.mark.parametrize("exclude_padding", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_,k,s,p,ceil", POOL_GRID)
def test_avg_pool_matches_jax(compute_dtype, dtype, in_, k, s, p, ceil,
                              exclude_padding):
    compute_dtype(dtype)
    cd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = np.random.RandomState(in_ * k).randn(2, in_, in_ + 1, 3) \
        .astype(np.float32)
    kw = dict(exclude_padding=exclude_padding, ceil_mode=ceil)
    _check(lambda x: jpool.avg_pool2d(x.astype(cd), k, s, p, **kw),
           lambda x: tpool.avg_pool2d(x.to(tconv.compute_dtype()), k, s, p,
                                      **kw), [x], dtype)


def test_global_avg_pool_matches_jax():
    x = np.random.RandomState(3).randn(3, 5, 4, 6).astype(np.float32)
    _check(jpool.global_avg_pool, tpool.global_avg_pool, [x], "float32")


# ---------------------------------------------------------------- norm


def _bn_inputs(seed, c=5):
    rng = np.random.RandomState(seed)
    # a mean well off 0, as after a ReLU: E[x^2] - E[x]^2 cancels
    x = (rng.randn(4, 6, 5, c) * 1.5 + 2.0).astype(np.float32)
    gamma = rng.randn(c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mm = rng.randn(c).astype(np.float32)
    mv = rng.rand(c).astype(np.float32) + 0.5
    return x, gamma, beta, mm, mv


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_train_matches_jax(compute_dtype, dtype):
    """y, the new moving mean and variance, and the gradients of x,
    gamma and beta under cotangents of all three outputs."""
    compute_dtype(dtype)
    cd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, gamma, beta, mm, mv = _bn_inputs(0)

    def jfn(x, g, b):
        return jnorm.batch_norm_train(x.astype(cd), g, b, jnp.asarray(mm),
                                      jnp.asarray(mv), momentum=0.8)

    def tfn(x, g, b):
        return tnorm.batch_norm_train(
            x.to(tconv.compute_dtype()), g, b, torch.tensor(mm),
            torch.tensor(mv), momentum=0.8)

    touts = _check(jfn, tfn, [x, gamma, beta], dtype)
    assert touts[1].dtype == touts[2].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_infer_matches_jax(compute_dtype, dtype):
    compute_dtype(dtype)
    cd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, gamma, beta, mm, mv = _bn_inputs(1)
    _check(lambda x, g, b, m, v: jnorm.batch_norm_infer(x.astype(cd), g, b,
                                                        m, v),
           lambda x, g, b, m, v: tnorm.batch_norm_infer(
               x.to(tconv.compute_dtype()), g, b, m, v),
           [x, gamma, beta, mm, mv], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("power", [0.75, 0.5, 1.3])
def test_lrn_cross_map_matches_jax(compute_dtype, dtype, power):
    compute_dtype(dtype)
    cd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = (np.random.RandomState(4).randn(2, 4, 3, 11) * 3).astype(np.float32)
    _check(lambda x: jnorm.lrn_cross_map(x.astype(cd), 5, 0.0128, power),
           lambda x: tnorm.lrn_cross_map(x.to(tconv.compute_dtype()), 5,
                                         0.0128, power), [x], dtype)


# ---------------------------------------------------------------- fused


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_bn_train_matches_jax_custom_vjp(compute_dtype, dtype):
    """z, the batch mean and variance, and dx, dw, dgamma, dbeta under
    cotangents of all three outputs, against the JAX custom_vjp."""
    compute_dtype(dtype)
    rng = np.random.RandomState(5)
    x = np.maximum(rng.randn(3, 5, 4, 6), 0).astype(np.float32)
    w = (rng.randn(1, 1, 6, 7) * 0.5).astype(np.float32)
    gamma = rng.randn(7).astype(np.float32)
    beta = rng.randn(7).astype(np.float32)
    _check(lambda *a: jfused.conv_bn_train(*a, 1e-5),
           lambda *a: tfused.conv_bn_train(*a, 1e-5),
           [x, w, gamma, beta], dtype)


def test_conv_bn_train_zero_gamma_gradient():
    """A pruned (exactly zero) gamma channel keeps its true dgamma: the
    fused op's gradients equal the unfused conv + batch norm's, in the
    port and against the JAX custom_vjp (the case of
    tests/test_fused_convbn.py)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 3, 4).astype(np.float32)
    w = rng.randn(1, 1, 4, 3).astype(np.float32)
    gamma = np.asarray([1.0, 0.0, -0.5], np.float32)
    beta = np.asarray([0.1, 0.2, 0.3], np.float32)

    def t_fused(x, w, g, b):
        z, m, v = tfused.conv_bn_train(x, w, g, b, 1e-5)
        return (z ** 2).sum() + m.sum() + v.sum()

    def t_ref(x, w, g, b):
        c = tconv.conv2d(x, w)
        z, nm, nv = tnorm.batch_norm_train(c, g, b, torch.zeros_like(g),
                                           torch.ones_like(g), momentum=0.0)
        return (z ** 2).sum() + nm.sum() + nv.sum()

    def j_fused(x, w, g, b):
        z, m, v = jfused.conv_bn_train(x, w, g, b, 1e-5)
        return jnp.sum(z ** 2) + jnp.sum(m) + jnp.sum(v)

    def grads(fn):
        args = [torch.tensor(a, requires_grad=True)
                for a in (x, w, gamma, beta)]
        return torch.autograd.grad(fn(*args), args)

    gf, gr = grads(t_fused), grads(t_ref)
    gj = jax.grad(j_fused, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, gamma, beta)))
    for a, b, j, name in zip(gf, gr, gj, ("dx", "dw", "dgamma", "dbeta")):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **FWD)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), err_msg=name,
                                   **FWD)
    assert gf[2][1] != 0.0          # the pruned channel still learns


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", DTYPES)
def test_space_to_depth_matches_jax(compute_dtype, dtype):
    """The layer on a flat channel-major feed and on an NHWC value."""
    from paddle_tpu.core.registry import ApplyContext as JCtx
    from paddle_tpu.layers.extra_layers import SpaceToDepthLayer as JS2D
    from paddle_tpu_torch.layers.extra_layers import SpaceToDepthLayer as TS2D
    compute_dtype(dtype)
    rng = np.random.RandomState(6)
    for shape, meta in (((2, 3 * 8 * 4), (3, 8, 4)), ((2, 6, 4, 5), None)):
        x = rng.randn(*shape).astype(np.float32)
        c, h, w = meta or (shape[3], shape[1], shape[2])
        cfg = {"_ic": c, "_ih": h, "_iw": w, "_f": 2}
        _check(lambda x: JS2D.apply(JCtx("test", None, {}), "s", cfg, {},
                                    [x]),
               lambda x: TS2D.apply(ApplyContext("test", {}), "s", cfg, {},
                                    [x]), [x], dtype)


def _dropout(x, rate, mode="train", rng=7, name="drop"):
    ctx = ApplyContext(mode, {}, rng)
    return tbase.DropoutLayer.apply(ctx, name, {"dropout_rate": rate}, {},
                                    [x])


def test_dropout_keep_rate_scaling_and_seeding():
    x = torch.full((400, 500), 2.0)
    before = torch.get_rng_state()
    y = _dropout(x, 0.3)
    assert torch.equal(torch.get_rng_state(), before)   # not the global RNG
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 2.0 / 0.7, rtol=1e-6)
    assert torch.equal(_dropout(x, 0.3), y)              # same seed, mask
    assert not torch.equal(_dropout(x, 0.3, name="other") != 0, kept)
    assert not torch.equal(_dropout(x, 0.3, rng=8) != 0, kept)
    assert torch.equal(_dropout(x, 0.3, mode="test"), x)
    assert torch.equal(_dropout(x, 0.0), x)
    yb = _dropout(x.to(torch.bfloat16), 0.5)
    assert yb.dtype == torch.bfloat16
    assert set(torch.unique(yb.float()).tolist()) == {0.0, 4.0}


def test_dropout_masks_differ_across_trainer_steps():
    """SGD seeds each step from init(seed=) and its step count: at
    learning rate 0 two steps on one batch give different costs (other
    masks), a new trainer with the same seed repeats both, and another
    seed draws others."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.core.registry import reset_name_counters
    rng = np.random.RandomState(0)
    batch = [(rng.randn(64).astype(np.float32), int(rng.randint(2)))
             for _ in range(8)]

    def run(seed):
        tconfig.init(use_gpu=False, seed=seed)
        reset_name_counters()
        x = tp.layer.data("x", tp.data_type.dense_vector(64))
        d = tp.layer.dropout(x, 0.5, name="d")
        out = tp.layer.fc(d, size=2, act=tp.activation.Softmax(), name="o")
        y = tp.layer.data("y", tp.data_type.integer_value(2))
        cost = tp.layer.classification_cost(out, y)
        params = tp.create_parameters(
            tp.Topology(cost), torch.Generator().manual_seed(0))
        trainer = tp.SGD(cost=cost, parameters=params,
                         update_equation=tp.optimizer.Momentum(
                             learning_rate=0.0))
        return [trainer.train_batch(batch)[0] for _ in range(2)]

    try:
        first, again, other = run(3), run(3), run(4)
    finally:
        tconfig.init(seed=0)
    assert first[0] != first[1]
    assert first == again
    assert other != first
