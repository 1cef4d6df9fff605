"""Port parity: the 3-D and image-transform layer types of
paddle_tpu_torch against paddle_tpu on the CPU — conv3d, deconv3d,
pool3d, pad, crop, rotate, bilinear_interp, maxout and spp — and C3D
(``chip_smoke.c3d_net``) cut small.

Each case is built in both DSLs behind a conv (so every gradient
reaches a parameter) and run from one JAX init tar on one seeded feed:
the outputs equal JAX's, and autograd's gradients of a seeded
projection of them equal ``jax.grad``'s, at rtol 1e-4 / atol 1e-5
(``tests/torch_parity.check_parity``). The cases that carry the traps
of the port: deconv3d at stride 2 and padding 1 (JAX correlates its
kernel unflipped), pool3d max and average with a ceil-mode right pad
and with padding, bilinear enlarging and shrinking (JAX's resize
antialiases a shrink), spp with more bins than pixels.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from chip_smoke import C3D, c3d_net
from paddle_tpu.ops import conv as jconv
from paddle_tpu.ops import pool as jpool
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import pool as tpool
from tests.test_torch_image_ops import _check
from tests.torch_parity import RTOL, ATOL, build_both, check_parity, \
    submodule

B = 3


@pytest.fixture(autouse=True)
def _port_config():
    yield
    tconfig.init(seed=0)


def _dt(L):
    return submodule(L, "core.data_type")


def _act(L):
    return submodule(L, "activation")


def _volume(L, c, d, h, w, nf=3, name="v"):
    """data -> conv3d 3x3x3 (padding 1): an NDHWC map with a parameter
    behind it."""
    x = L.data(name, _dt(L).dense_vector(c * d * h * w))
    return L.img_conv3d(x, filter_size=3, num_filters=nf, input_depth=d,
                        num_channels=c, input_height=h, input_width=w,
                        padding=1, act=_act(L).Tanh(), name=f"{name}_c3d")


def _image(L, c, h, w, nf=4, name="im"):
    """data -> conv 3x3 (padding 1): an NHWC map with a parameter."""
    x = L.data(name, _dt(L).dense_vector(c * h * w), height=h, width=w)
    return L.img_conv(x, filter_size=3, num_filters=nf, num_channels=c,
                      padding=1, name=f"{name}_conv")


def _cols(dim, n=B, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(dim).astype(np.float32),) for _ in range(n)]


def _cases():
    c = {}
    # 3-D
    c["conv3d_s1_p1"] = (lambda L: _volume(L, 2, 4, 5, 6), _cols(240))
    c["conv3d_s2_kernel_2x3x3"] = (
        lambda L: L.img_conv3d(
            _volume(L, 2, 5, 6, 7), filter_size=[2, 3, 3], num_filters=4,
            input_depth=5, input_height=6, input_width=7, stride=[1, 2, 2],
            name="c2"),
        _cols(2 * 5 * 6 * 7))
    c["deconv3d_s2_p1"] = (
        lambda L: L.img_conv3d(
            _volume(L, 2, 3, 4, 5), filter_size=3, num_filters=2,
            input_depth=3, input_height=4, input_width=5, stride=2,
            padding=1, trans=True, act=_act(L).Relu(), name="dc"),
        _cols(2 * 3 * 4 * 5))
    c["deconv3d_s1_p0"] = (
        lambda L: L.img_conv3d(
            _volume(L, 2, 3, 3, 4), filter_size=[2, 3, 2], num_filters=3,
            input_depth=3, input_height=3, input_width=4, trans=True,
            name="dc"),
        _cols(2 * 3 * 3 * 4))
    for kind in ("max", "avg"):
        ptype = (lambda L, k=kind: submodule(L, "pooling").Max() if k ==
                 "max" else submodule(L, "pooling").Avg())
        # 5 x 5 x 7 by 2 / 2: ceil mode gives 3 x 3 x 4, the last window
        # hanging over a right pad of 1
        c[f"pool3d_{kind}_ceil_pad"] = (
            lambda L, p=ptype: L.img_pool3d(
                _volume(L, 2, 5, 5, 7), pool_size=2, stride=2,
                input_depth=5, input_height=5, input_width=7,
                pool_type=p(L), name="p3"),
            _cols(2 * 5 * 5 * 7))
        c[f"pool3d_{kind}_padding_1"] = (
            lambda L, p=ptype: L.img_pool3d(
                _volume(L, 2, 4, 6, 5), pool_size=3, stride=2, padding=1,
                input_depth=4, input_height=6, input_width=5,
                pool_type=p(L), name="p3"),
            _cols(2 * 4 * 6 * 5))
        c[f"pool3d_{kind}_1x2x2"] = (
            lambda L, p=ptype: L.img_pool3d(
                _volume(L, 2, 3, 4, 4), pool_size=[1, 2, 2],
                stride=[1, 2, 2], input_depth=3, input_height=4,
                input_width=4, pool_type=p(L), name="p3"),
            _cols(2 * 3 * 4 * 4))
    # image transforms
    c["pad"] = (lambda L: L.pad(_image(L, 2, 4, 5), pad_c=[0, 1],
                                pad_h=[1, 2], pad_w=[2, 0]),
                _cols(2 * 4 * 5))
    c["crop"] = (lambda L: L.crop(_image(L, 2, 6, 5, nf=5), shape=[3, 4, 2],
                                  offset=[1, 2, 1]),
                 _cols(2 * 6 * 5))
    c["rotate"] = (lambda L: L.fc(L.rotate(_image(L, 2, 4, 6)), size=3,
                                  name="rot_fc"),
                   _cols(2 * 4 * 6))
    c["rotate_twice"] = (lambda L: L.rotate(L.rotate(_image(L, 1, 3, 5))),
                         _cols(3 * 5))
    for name, (h, w, oh, ow) in {
            "enlarge_8_to_16": (8, 8, 16, 16),
            "enlarge_to_12x20": (6, 8, 12, 20),
            "shrink_8_to_5": (8, 8, 5, 5),
            "shrink_8_to_3x7": (8, 8, 3, 7),
            "mixed_6x8_to_12x5": (6, 8, 12, 5)}.items():
        c[f"bilinear_{name}"] = (
            lambda L, h=h, w=w, oh=oh, ow=ow: L.bilinear_interp(
                _image(L, 2, h, w), out_size_x=ow, out_size_y=oh),
            _cols(2 * h * w))
    for g in (2, 3):
        c[f"maxout_groups_{g}"] = (
            lambda L, g=g: L.maxout(_image(L, 2, 4, 5, nf=6), groups=g),
            _cols(2 * 4 * 5))
    for ptype, (h, w, ph) in {"max": (5, 7, 3), "avg": (5, 7, 3),
                              "max_more_bins": (3, 3, 3)}.items():
        c[f"spp_{ptype}"] = (
            lambda L, h=h, w=w, ph=ph, t=ptype: L.spp(
                _image(L, 2, h, w), pyramid_height=ph,
                pool_type=submodule(L, "pooling").Avg() if t == "avg"
                else None),
            _cols(2 * h * w))
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_volume_and_transform_layers_match_jax(case):
    build, samples = CASES[case]
    check_parity(build, samples)


def test_deconv3d_output_size_and_unflipped_kernel():
    """deconv3d's output is (i - 1) s - 2p + k in each axis, and its
    kernel is correlated as it is (lax.conv_transpose without
    transpose_kernel): the port equals JAX, and the same call with the
    kernel flipped does not."""
    rng = np.random.RandomState(4)
    x = rng.randn(1, 2, 3, 2, 2).astype(np.float32)
    w = rng.randn(3, 3, 2, 2, 3).astype(np.float32)
    want = np.asarray(jconv.conv3d_transpose(jnp.asarray(x), jnp.asarray(w),
                                             stride=2, padding=1))
    got = tconv.conv3d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                                 padding=1).numpy()
    assert got.shape == want.shape == (1, 3, 5, 2, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    flipped = tconv.conv3d_transpose(
        torch.tensor(x), torch.tensor(w[::-1, ::-1, ::-1].copy()), stride=2,
        padding=1).numpy()
    assert np.abs(flipped - want).max() > 0.1


@pytest.fixture
def compute_dtype():
    """Sets both packages' compute dtype; float32 again afterwards."""
    def set_(name):
        jpaddle.init(use_tpu=False, seed=0, compute_dtype=name)
        tconfig.init(seed=0, compute_dtype=name)
    yield set_
    set_("float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,kw", [
    ("conv3d", dict(stride=1, padding=1)),
    # (JAX's CPU compiler aborts on the vjp of a 3-D conv both strided
    # and padded; the layer cases run the padded stride-1 and the
    # unpadded strided convs that C3D and the golden have)
    ("conv3d", dict(stride=[1, 2, 2], padding=0)),
    ("conv3d_transpose", dict(stride=2, padding=1)),
    ("conv3d_transpose", dict(stride=[1, 2, 1], padding=0))])
def test_conv3d_ops_match_jax_vjp(compute_dtype, dtype, op, kw):
    """conv3d and conv3d_transpose against jax.vjp under both compute
    dtypes (bf16: operands cast, output bf16, as in JAX; the image
    ops' tolerances, tests/test_torch_image_ops.py)."""
    compute_dtype(dtype)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 5, 6, 3).astype(np.float32)
    w = rng.randn(3, 3, 2, 3, 4).astype(np.float32)
    _check(lambda a, b: getattr(jconv, op)(a, b, **kw),
           lambda a, b: getattr(tconv, op)(a, b, **kw), [x, w], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("shape,k,s,p", [
    ((2, 5, 5, 7, 3), 2, 2, 0),              # ceil mode: right pad 1
    ((2, 4, 6, 5, 2), 3, 2, 1),
    ((1, 3, 4, 4, 2), (1, 2, 2), (1, 2, 2), 0),
    ((1, 2, 7, 7, 2), 2, 2, 0)])             # C3D's pool5: 1 x 4 x 4
def test_pool3d_ops_match_jax_vjp(compute_dtype, dtype, kind, shape, k, s,
                                  p):
    compute_dtype(dtype)
    cd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jf = getattr(jpool, f"{kind}_pool3d")
    tf = getattr(tpool, f"{kind}_pool3d")
    _check(lambda a: jf(a.astype(cd), k, s, p),
           lambda a: tf(a.to(tconv.compute_dtype()), k, s, p), [x], dtype)


@pytest.mark.parametrize("shape,pyramid", [((2, 5, 7, 3), 3),
                                           ((1, 3, 3, 2), 3),
                                           ((2, 1, 6, 2), 2)])
@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_spp_bins_match_jax(shape, pyramid, ptype):
    """The pyramid's bins, degenerate clamps included (a 3 x 3 map at 4
    x 4 bins, a 1-row map), against the JAX op."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = np.asarray(jpool.spatial_pyramid_pool(jnp.asarray(x), pyramid,
                                                 ptype))
    got = tpool.spatial_pyramid_pool(torch.tensor(x), pyramid, ptype)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


C3D_SMALL = dict(C3D, depth=8, height=32, width=32,
                 filters=tuple(f // 16 for f in C3D["filters"]), fc=64)


def test_c3d_small_matches_jax_through_json_both_ways():
    """chip_smoke.c3d_net with filters / 16 on a 3 x 8 x 32 x 32 clip and
    fc 64: the port's JSON deserializes in JAX and JAX's in the port,
    each serializing back equal; the cost, the softmax and the
    gradients of every parameter equal JAX's from one init tar."""
    def build(L):
        paddle = jpaddle if L is jpaddle.layer else tpaddle
        return list(c3d_net(paddle, **C3D_SMALL))

    jt, tt = build_both(build)
    blob_t, blob_j = tt.serialize(), jt.serialize()
    assert json.loads(jpaddle.Topology.deserialize(blob_t).serialize()) == \
        json.loads(blob_t)
    assert json.loads(tpaddle.Topology.deserialize(blob_j).serialize()) == \
        json.loads(blob_j)
    # pool5 over 1 x 2 x 2 in ceil mode: 1 x 1 x 1 of 32 channels
    fc6 = [l for l in tt.layers if l.name == "c3d_fc6"][0]
    assert fc6.parents[0].meta.size == C3D_SMALL["filters"][-1]
    rng = np.random.RandomState(5)
    dim = 3 * 8 * 32 * 32
    samples = [(rng.randn(dim).astype(np.float32), int(rng.randint(487)))
               for _ in range(2)]
    check_parity(build, samples)


def test_c3d_full_width_shapes():
    """The full-width graph (built, not run): pool5 gives 1 x 4 x 4 x 512
    = 8192 features (ceil mode over 2 x 7 x 7), and 80.0 M parameters."""
    from paddle_tpu_torch.core.registry import reset_name_counters
    reset_name_counters()
    cost, _ = c3d_net(tpaddle, **C3D)
    topo = tpaddle.Topology(cost)
    fc6 = [l for l in topo.layers if l.name == "c3d_fc6"][0]
    assert fc6.parents[0].meta.size == 8192
    n = sum(int(np.prod(s.shape)) for s in topo.param_specs.values())
    assert 79.9e6 < n < 80.1e6
