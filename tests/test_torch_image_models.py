"""Port parity: the image models of paddle_tpu_torch (models/image.py,
networks.py, the image layers and batch norm's state in the trainer)
against paddle_tpu's on the CPU.

Every comparison starts from one weight table, the JAX package's init
carried through a ``paddle_tpu.params.v1`` tar, on inputs made with
numpy from a seed.

- The digits CNN of demo/mnist/convergence.py (``chip_smoke.
  convergence_cnn``) at dropout 0: test-mode probabilities at rtol 1e-4
  / atol 1e-5, train-mode gradients per parameter at a relative norm of
  1e-4, and the first 16 Adam steps of the port copy of the script
  (``chip_smoke.convergence_demo``) per-step costs at rtol 1e-5, each
  package on its own copy of the digits.
- ResNet-50 in test mode at __graft_entry__.py's 64 x 64, batch 8, 100
  classes: probabilities at rtol 1e-4 / atol 1e-5.
- One ResNet-50 train step (32 x 32, batch 8, 10 classes; full depth):
  the cost, the gradients and the new moving statistics. Training-mode
  batch norm takes E[x^2] - E[x]^2 of ReLU'd activations whose mean is
  far from 0, which amplifies float32 rounding layer by layer, so the
  two packages' float32 gradients differ by a few 1e-2 in norm. The JAX
  package cannot run the step in float64 (its conv asks for a float32
  result), so the near-exact run is the port's in float64 (batch norm's
  statistics follow a float64 input). Two checks use it. The JAX
  package's float32 step must lie within a fixed ceiling of it
  (``STEP_CEIL``), which ties the float64 run to JAX: a fault of the
  port's composition in training mode that shows in both dtypes moves
  every quantity by far more. And the port's float32 step may lie no
  further from it than the JAX package's does (or within 1e-4 in norm,
  1e-5 relative for the cost).
- GoogleNet in test mode (no batch norm; dropout off) at 64 x 64,
  batch 2, 10 classes: probabilities at rtol 1e-4 / atol 1e-5 and each
  parameter's gradient of the summed cost at a relative norm of 1e-4.
- smallnet, alexnet, vgg16, googlenet, mnist_mlp, resnet50 and its
  space-to-depth stem build to the JAX package's serialized topology,
  byte for byte.
"""

import importlib.util
import io
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
import torch
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as j_reset

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.dataset import digits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4
RTOL_STEP = 1e-5
# The JAX package's float32 train step against the port's float64 run,
# largest distance allowed: about twice what was measured on the CPU
# (cost 1.27e-4 relative; gradients 3.72e-2 in global norm and 4.47e-2
# for the worst parameter; moving statistics 1.73e-5 in global norm).
STEP_CEIL = dict(cost=3e-4, grad=8e-2, param=1e-1, state=4e-5)
# GoogleNet's float32 gradients against the port's float64 run, per
# parameter, below a max-pool window whose two largest values float32
# orders differently (test_googlenet_forward_and_gradients_match_jax):
# about twice the 8.5e-3 measured on the CPU; above it, GRAD_REL
POOL_TIE_CEIL = 2e-2
POOL_TIE_CLEAR = ("_gn_out", "_gn_i4d", "_gn_i4e", "_gn_i5")


@pytest.fixture(autouse=True)
def _fresh_names():
    j_reset()
    t_reset()
    jpaddle.init(use_tpu=False, seed=0)
    yield
    tconfig.init(seed=0)


def _jax_table(jtopo, seed=3):
    """The JAX package's init as numpy, and the port's tensors of it
    through a params tar."""
    buf = io.BytesIO()
    jpaddle.Parameters(jtopo.init_params(jax.random.PRNGKey(seed))) \
        .to_tar(buf)
    buf.seek(0)
    tparams = tpaddle.Parameters.from_tar(buf, device="cpu").raw
    return {k: v.numpy() for k, v in tparams.items()}, tparams


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _global_rel(got, want):
    num = sum(float(np.sum((np.asarray(got[k], np.float64) -
                            np.asarray(want[k], np.float64)) ** 2))
              for k in want)
    den = sum(float(np.sum(np.asarray(want[k], np.float64) ** 2))
              for k in want)
    return (num / den) ** 0.5


def _convergence_readers():
    path = os.path.join(ROOT, "demo", "mnist", "convergence.py")
    spec = importlib.util.spec_from_file_location("convergence_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.digits_readers


# ------------------------------------------------------------ digits CNN


def test_convergence_cnn_forward_and_gradients_match_jax():
    jcost, jout, _ = chip_smoke.convergence_cnn(jpaddle, drop_rate=0.0)
    tcost, tout, _ = chip_smoke.convergence_cnn(tpaddle, drop_rate=0.0)
    jtopo, ttopo = jpaddle.Topology(jcost), tpaddle.Topology(tcost)
    assert ttopo.serialize() == jtopo.serialize()
    table, tparams = _jax_table(jtopo)
    x, y = digits.load()
    feed = {"pixel": x[:16], "label": y[:16]}
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
    jparams = {k: jnp.asarray(v) for k, v in table.items()}
    jo, _ = jtopo.forward(jparams, {}, jfeed, mode="test",
                          output_names=[jout.name])
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    to, _ = ttopo.forward(leaves, {}, tfeed, mode="test",
                          output_names=[tout.name])
    np.testing.assert_allclose(to[tout.name].detach().numpy(),
                               np.asarray(jo[jout.name]), **FWD)

    def jloss(p):
        outs, _ = jtopo.forward(p, {}, jfeed, mode="train")
        return jnp.sum(outs[jcost.name])

    jg = jax.grad(jloss)(jparams)
    outs, _ = ttopo.forward(leaves, {}, tfeed, mode="train")
    names = sorted(leaves)
    tg = torch.autograd.grad(outs[tcost.name].sum(),
                             [leaves[k] for k in names])
    for k, g in zip(names, tg):
        assert _rel(g.numpy(), jg[k]) <= GRAD_REL, k


def test_convergence_script_first_steps_track_jax():
    """The port copy of the convergence script at dropout 0, 2 passes cut
    to 8 batches each: per-step costs and the test sweep against the JAX
    package's run of the same copy on the reference's digits readers."""
    pytest.importorskip("sklearn")
    kw = dict(use_tpu=False, num_passes=2, batch_size=128, drop_rate=0.0,
              num_batches_per_pass=8)
    j = chip_smoke.convergence_demo(jpaddle, _convergence_readers(), **kw)
    t = chip_smoke.convergence_demo(tpaddle, digits.readers,
                                    init_tar=j["init_tar"], **kw)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == 16
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=RTOL_STEP)
    assert t["costs"][-1] < t["costs"][0]
    np.testing.assert_allclose(t["test_cost"], j["test_cost"],
                               rtol=RTOL_STEP)
    assert t["test_accuracy"] == j["test_accuracy"]


# ------------------------------------------------------------ ResNet-50


def _resnet_case(height, batch, classes, seed=0):
    jspec = jmodels.resnet50(height=height, width=height,
                             num_classes=classes)
    tspec = tmodels.resnet50(height=height, width=height,
                             num_classes=classes)
    jtopo, ttopo = jpaddle.Topology(jspec.cost), tpaddle.Topology(tspec.cost)
    assert ttopo.serialize() == jtopo.serialize()
    table, tparams = _jax_table(jtopo)
    rng = np.random.RandomState(seed)
    img = rng.randn(batch, height * height * 3).astype(np.float32)
    lbl = rng.randint(0, classes, batch).astype(np.int32)
    return (jspec, tspec, jtopo, ttopo, table, tparams,
            {"image": img, "label": lbl})


def test_resnet50_forward_matches_jax():
    """__graft_entry__.py's flagship forward: 64 x 64, batch 8, 100
    classes, test mode (the moving statistics at their init)."""
    jspec, tspec, jtopo, ttopo, table, tparams, feed = \
        _resnet_case(64, 8, 100)
    jo, _ = jtopo.forward({k: jnp.asarray(v) for k, v in table.items()},
                          jtopo.init_state(),
                          {k: jnp.asarray(v) for k, v in feed.items()},
                          mode="test", output_names=[jspec.output.name])
    with torch.no_grad():
        to, _ = ttopo.forward(tparams, ttopo.init_state(),
                              {k: torch.from_numpy(v)
                               for k, v in feed.items()},
                              mode="test", output_names=[tspec.output.name])
    got = to[tspec.output.name].numpy()
    assert got.shape == (8, 100)
    np.testing.assert_allclose(got, np.asarray(jo[jspec.output.name]), **FWD)


def test_resnet50_train_step_matches_jax():
    jspec, tspec, jtopo, ttopo, table, tparams, feed = \
        _resnet_case(32, 8, 10, seed=1)
    jstate = jtopo.init_state()
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}

    def jloss(p):
        outs, new_state = jtopo.forward(p, jstate, jfeed, mode="train")
        return jnp.sum(outs[jspec.cost.name]), new_state

    (jcost, jnew), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in table.items()})

    def port(dtype):
        leaves = {k: v.to(dtype).requires_grad_()
                  for k, v in tparams.items()}
        state = {k: v.to(dtype)
                 for k, v in ttopo.init_state(device="cpu").items()}
        tfeed = {"image": torch.from_numpy(feed["image"]).to(dtype),
                 "label": torch.from_numpy(feed["label"])}
        outs, new_state = ttopo.forward(leaves, state, tfeed, mode="train")
        cost = outs[tspec.cost.name].sum()
        names = sorted(leaves)
        grads = torch.autograd.grad(cost, [leaves[k] for k in names])
        return (cost.item(), {k: g.numpy() for k, g in zip(names, grads)},
                {k: v.detach().numpy() for k, v in new_state.items()})

    tcost, tg, tnew = port(torch.float32)
    exact_cost, exact_g, exact_new = port(torch.float64)
    jg = {k: np.asarray(v) for k, v in jg.items()}
    jnew = {k: np.asarray(v) for k, v in jnew.items()}
    assert sorted(tg) == sorted(jg) and sorted(tnew) == sorted(jnew)
    assert len(tnew) == 2 * 53          # the moving mean and var of each bn
    port_err = abs(tcost - exact_cost) / exact_cost
    jax_err = abs(float(jcost) - exact_cost) / exact_cost
    assert jax_err <= STEP_CEIL["cost"], jax_err
    assert port_err <= max(RTOL_STEP, jax_err), (port_err, jax_err)
    port_err, jax_err = _global_rel(tg, exact_g), _global_rel(jg, exact_g)
    assert jax_err <= STEP_CEIL["grad"], jax_err
    worst = max((_rel(jg[k], exact_g[k]), k) for k in exact_g)
    assert worst[0] <= STEP_CEIL["param"], worst
    assert port_err <= max(GRAD_REL, jax_err), (port_err, jax_err)
    port_err = _global_rel(tnew, exact_new)
    jax_err = _global_rel(jnew, exact_new)
    assert jax_err <= STEP_CEIL["state"], jax_err
    assert port_err <= max(1e-6, jax_err), (port_err, jax_err)
    for k in tnew:
        assert not np.array_equal(tnew[k], ttopo.init_state()[k].numpy()), k


# ------------------------------------------------------------ builders


@pytest.mark.parametrize("name,kw", [
    ("mnist_mlp", {}), ("smallnet", {}), ("alexnet", {}), ("vgg16", {}),
    ("googlenet", {}), ("resnet50", {}), ("resnet50", {"tpu_stem": True}),
    ("resnet", {"depth": 18, "height": 64, "width": 64})])
def test_image_models_serialize_like_jax(name, kw):
    jspec = getattr(jmodels, name)(**kw)
    tspec = getattr(tmodels, name)(**kw)
    jtopo = jpaddle.Topology(jspec.cost, extra_outputs=[jspec.error])
    ttopo = tpaddle.Topology(tspec.cost, extra_outputs=[tspec.error])
    assert ttopo.serialize() == jtopo.serialize()
    assert {k: tuple(v.shape) for k, v in ttopo.param_specs.items()} == \
        {k: tuple(v.shape) for k, v in jtopo.param_specs.items()}
    assert sorted(ttopo.state_specs) == sorted(jtopo.state_specs)
    assert tpaddle.Topology.deserialize(ttopo.serialize()).serialize() == \
        ttopo.serialize()


def test_googlenet_forward_and_gradients_match_jax():
    """GoogleNet at tests/test_models.py's 64 x 64, batch 2, 10 classes:
    its inception blocks cut one wide 1x1 conv into channel slices
    (``slice_projection(channel_slice=True)``). No batch norm, so test
    mode (dropout off) holds the forward and the gradients of the
    summed cost. The port's float32 probabilities equal JAX's at rtol
    1e-4 / atol 1e-5. The gradients are held in float64: the port's run
    in float64 (the convs, pools and fcs follow their input's dtype; the
    softmax normalizes in float32, as in both packages) against JAX's
    float32 ``jax.grad``, each parameter at a relative norm of 1e-4.
    Max pooling is not differentiable at a tie, and at this seed one
    window of gn_i4d_maxpool holds two values 1.5e-6 apart (relative):
    float32 rounding in the port's convs orders them the other way than
    JAX's float32 and both float64 runs do, which moves the gradient of
    every layer below it (up to 8.5e-3 relative at gn_conv1). So the
    port's float32 gradients are held against its float64 run at the
    ceiling ``POOL_TIE_CEIL`` per parameter, and must agree to GRAD_REL
    above that pool (the fc and the last three inception blocks)."""
    jspec = jmodels.googlenet(height=64, width=64, num_classes=10)
    tspec = tmodels.googlenet(height=64, width=64, num_classes=10)
    jtopo, ttopo = jpaddle.Topology(jspec.cost), tpaddle.Topology(tspec.cost)
    assert ttopo.serialize() == jtopo.serialize()
    assert sum(l.type == "slice" for l in ttopo.layers) == 27
    table, tparams = _jax_table(jtopo)
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(2, 64 * 64 * 3).astype(np.float32),
            "label": rng.randint(0, 10, 2).astype(np.int32)}
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    jparams = {k: jnp.asarray(v) for k, v in table.items()}
    names = [jspec.output.name, jspec.cost.name]
    jo, _ = jtopo.forward(jparams, {}, jfeed, mode="test",
                          output_names=names)

    def jloss(p):
        outs, _ = jtopo.forward(p, {}, jfeed, mode="test",
                                output_names=[jspec.cost.name])
        return jnp.sum(outs[jspec.cost.name])

    jg = jax.grad(jloss)(jparams)
    keys = sorted(tparams)
    grads = {}
    for dt in (torch.float32, torch.float64):
        leaves = {k: v.to(dt).clone().requires_grad_()
                  for k, v in tparams.items()}
        tfeed = {"image": torch.from_numpy(feed["image"]).to(dt),
                 "label": torch.from_numpy(feed["label"])}
        to, _ = ttopo.forward(leaves, {}, tfeed, mode="test",
                              output_names=names)
        got = to[tspec.output.name].detach().numpy()
        assert got.shape == (2, 10)
        np.testing.assert_allclose(got, np.asarray(jo[jspec.output.name]),
                                   **FWD)
        grads[dt] = dict(zip(keys, torch.autograd.grad(
            to[tspec.cost.name].sum(), [leaves[k] for k in keys])))
    for k in keys:
        exact = grads[torch.float64][k].numpy()
        assert _rel(exact, jg[k]) <= GRAD_REL, k
        ceil = GRAD_REL if k.startswith(POOL_TIE_CLEAR) else POOL_TIE_CEIL
        assert _rel(grads[torch.float32][k].numpy(), exact) <= ceil, k


def test_trainer_stores_moving_stats_detached_and_infer_reads_them():
    """A conv + batch norm net: after train steps the state holds plain
    tensors (no graph), and infer in test mode normalizes with them."""
    tconfig.init(use_gpu=False, seed=0)
    L, act = tpaddle.layer, tpaddle.activation
    img = L.data("im", tpaddle.data_type.dense_vector(3 * 6 * 6), height=6,
                 width=6)
    c = L.img_conv(img, filter_size=3, num_filters=4, num_channels=3,
                   padding=1, bias_attr=False, name="c")
    bn = L.batch_norm(c, act=act.Relu(), name="bn")
    out = L.fc(L.img_pool(bn, pool_size=2, stride=2), size=3,
               act=act.Softmax(), name="out")
    lbl = L.data("y", tpaddle.data_type.integer_value(3))
    cost = L.classification_cost(out, lbl)
    params = tpaddle.create_parameters(tpaddle.Topology(cost))
    trainer = tpaddle.SGD(cost=cost, parameters=params,
                          update_equation=tpaddle.optimizer.Adam(1e-2))
    rng = np.random.RandomState(0)
    batch = [(rng.randn(108).astype(np.float32) * 2 + 1, i % 3)
             for i in range(16)]
    for _ in range(3):
        trainer.train_batch(batch)
    state = params.state
    assert sorted(state) == ["_bn.moving_mean", "_bn.moving_var"]
    for v in state.values():
        assert v.grad_fn is None and not v.requires_grad
    assert not torch.equal(state["_bn.moving_var"], torch.ones(4))
    probs = tpaddle.infer(output_layer=out, parameters=params,
                          input=[(s[0],) for s in batch])
    topo = tpaddle.Topology(out)
    with torch.no_grad():
        want, _ = topo.forward(params.raw, state,
                               {"im": torch.from_numpy(
                                   np.stack([s[0] for s in batch]))},
                               mode="test")
        fresh, _ = topo.forward(params.raw, topo.init_state(),
                                {"im": torch.from_numpy(
                                    np.stack([s[0] for s in batch]))},
                                mode="test")
    np.testing.assert_allclose(probs, want["out"].numpy(), rtol=1e-6)
    assert not np.allclose(probs, fresh["out"].numpy())


def test_image_entry_points_refuse_to_run_without_cuda():
    """With no GPU and no CPU request, building parameters, a trainer or
    an inference of an image model raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    tconfig.init(seed=0)                     # the card, the default
    spec = tmodels.smallnet()
    topo = tpaddle.Topology(spec.cost)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaddle.create_parameters(topo)
    params = tpaddle.create_parameters(topo, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaddle.SGD(cost=spec.cost, parameters=params,
                    update_equation=tpaddle.optimizer.Momentum(0.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpaddle.infer(output_layer=spec.output, parameters=params,
                      input=[(np.zeros(3 * 32 * 32, np.float32),)])
