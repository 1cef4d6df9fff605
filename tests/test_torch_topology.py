"""Port parity: the transformer_lm graph of paddle_tpu_torch (layer DSL,
registry, Topology executor, ops) against paddle_tpu's on the CPU.

The config is the CFG of tests/test_paged_decode.py. The serialized
topology must equal the JAX one (parsed as JSON) — same layers,
auto-names, configs and ParamAttr fields — and the parameter specs
must agree. From one JAX ``init_params`` table (as numpy), one
``Topology.forward`` on a ragged batch gives the same per-row costs
and ``torch.autograd.grad`` the same gradients as ``jax.grad``:
rtol 1e-4 / atol 1e-5 in float32 (two CPU matmul libraries summing
in different orders). The bfloat16 case compares per-token costs and
the gradients of the per-token mean cost at atol 2e-2: both packages
round the matmul inputs to bf16 and accumulate in float32, but at
other places and in another order.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as j_reset
from paddle_tpu.ops import cost as jcost
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder

from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.models import transformer_lm as t_transformer_lm
from paddle_tpu_torch.ops import cost as tcost
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder
from tests.torch_parity import assert_values_close, feeds_of, table_of

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)
RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 2e-2


@pytest.fixture
def compute_dtype():
    """Sets both packages' compute dtype; float32 again afterwards."""
    def set_(name):
        paddle.init(use_tpu=False, seed=0, compute_dtype=name)
        tconfig.init(seed=0, compute_dtype=name)
    yield set_
    set_("float32")


def _topologies(**overrides):
    cfg = {**CFG, **overrides}
    paddle.init(use_tpu=False, seed=0)
    j_reset()
    jspec = jmodels.transformer_lm(**cfg)
    t_reset()
    tspec = t_transformer_lm(**cfg)
    return (paddle.Topology(jspec.cost, extra_outputs=[jspec.output]),
            TTopology(tspec.cost, extra_outputs=[tspec.output]),
            jspec, tspec)


def _batch(seed=0, lens=(9, 5, 12)):
    rng = np.random.RandomState(seed)
    out = []
    for L in lens:
        toks = rng.randint(0, CFG["vocab_size"], (L + 1,)).astype(np.int32)
        out.append((toks[:-1], np.arange(L, dtype=np.int32), toks[1:]))
    return out


@pytest.mark.parametrize("tied", [False, True])
def test_serialized_topology_and_param_specs_equal(tied):
    jtopo, ttopo, _, _ = _topologies(tie_embeddings=tied)
    assert json.loads(ttopo.serialize()) == json.loads(jtopo.serialize())
    assert {k: tuple(v.shape) for k, v in ttopo.param_specs.items()} == \
        {k: tuple(v.shape) for k, v in jtopo.param_specs.items()}
    # the blob round-trips through the port's deserializer
    again = TTopology.deserialize(ttopo.serialize())
    assert json.loads(again.serialize()) == json.loads(ttopo.serialize())


def test_default_names_serialize_equal():
    """Layers built without names take the same auto-names in both
    packages (the counters are per layer type)."""
    from paddle_tpu_torch import layers as tl
    from paddle_tpu_torch.core.data_type import (dense_vector_sequence,
                                                 integer_value_sequence)
    j_reset()
    jx = paddle.layer.data("x", paddle.data_type.dense_vector_sequence(8))
    jy = paddle.layer.data("y", paddle.data_type.integer_value_sequence(5))
    jh = paddle.layer.fc(paddle.layer.layer_norm(jx), size=5)
    jc = paddle.layer.cross_entropy_cost(
        paddle.layer.addto([jh, paddle.layer.fc(jx, size=5)]), jy,
        from_logits=True, label_smoothing=0.1)
    t_reset()
    tx = tl.data("x", dense_vector_sequence(8))
    ty = tl.data("y", integer_value_sequence(5))
    th = tl.fc(tl.layer_norm(tx), size=5)
    tc = tl.cross_entropy_cost(tl.addto([th, tl.fc(tx, size=5)]), ty,
                               from_logits=True, label_smoothing=0.1)
    assert json.loads(TTopology(tc).serialize()) == \
        json.loads(paddle.Topology(jc).serialize())


def _cost_and_grads(tied, dtype_name, compute_dtype):
    jtopo, ttopo, jspec, tspec = _topologies(tie_embeddings=tied)
    compute_dtype(dtype_name)
    table = {k: np.asarray(v)
             for k, v in jtopo.init_params(jax.random.PRNGKey(7)).items()}
    batch = _batch()
    jfeed = JFeeder(jtopo.data_type())(batch)
    jfeed.pop("__batch_size__")
    tfeed = TFeeder(ttopo.data_type(), device="cpu")(batch)
    tfeed.pop("__batch_size__")
    name = jspec.cost.name

    def jloss(p):
        outs, _ = jtopo.forward(p, {}, jfeed, mode="train",
                                output_names=[name])
        return jnp.sum(outs[name]), outs[name]

    (_, jrows), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in table.items()})
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in table.items()}
    outs, _ = ttopo.forward(tparams, {}, tfeed, mode="train",
                            output_names=[tspec.cost.name])
    trows = outs[tspec.cost.name]
    names = sorted(tparams)
    tgrads = torch.autograd.grad(trows.sum(), [tparams[k] for k in names])
    lens = np.array([len(b[0]) for b in batch], np.float32)
    return (np.asarray(jrows), trows.detach().numpy(), lens,
            {k: np.asarray(jgrads[k]) for k in names},
            {k: g.numpy() for k, g in zip(names, tgrads)})


@pytest.mark.parametrize("tied", [False, True])
def test_cost_and_gradients_match_jax_float32(tied, compute_dtype):
    jrows, trows, _, jg, tg = _cost_and_grads(tied, "float32",
                                              compute_dtype)
    np.testing.assert_allclose(trows, jrows, rtol=RTOL, atol=ATOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if tied:
        # the token table takes gradient from both of its uses
        assert np.abs(tg["_tfm_tok_emb.w0"]).sum() > 0


def test_cost_and_gradients_match_jax_bfloat16(compute_dtype):
    jrows, trows, lens, jg, tg = _cost_and_grads(True, "bfloat16",
                                                 compute_dtype)
    np.testing.assert_allclose(trows / lens, jrows / lens, atol=BF16_ATOL)
    # gradients of the per-token mean cost
    for k in jg:
        np.testing.assert_allclose(tg[k] / lens.sum(), jg[k] / lens.sum(),
                                   atol=BF16_ATOL, err_msg=k)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ce_from_logits_matches_jax(smoothing):
    rng = np.random.RandomState(5)
    x = (3 * rng.randn(4, 6, 40)).astype(np.float32)
    labels = rng.randint(0, 40, (4, 6)).astype(np.int32)
    g = rng.randn(4, 6).astype(np.float32)

    def jf(x_):
        return jcost.cross_entropy(x_, jnp.asarray(labels), from_logits=True,
                                   label_smoothing=smoothing)

    jval, jvjp = jax.vjp(jf, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tval = tcost.cross_entropy(tx, torch.tensor(labels), from_logits=True,
                               label_smoothing=smoothing)
    (tgrad,) = torch.autograd.grad(tval, tx, torch.tensor(g))
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tgrad.numpy(),
                               np.asarray(jvjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=ATOL)
    # the backward emits the logits dtype
    xb = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    (gb,) = torch.autograd.grad(
        tcost.cross_entropy(xb, torch.tensor(labels), from_logits=True,
                            label_smoothing=smoothing).sum(), xb)
    assert gb.dtype == torch.bfloat16


def test_unported_layers_and_options_raise():
    from paddle_tpu_torch.core.registry import make_layer
    from paddle_tpu.core.registry import make_layer as jmake_layer
    for make in (make_layer, jmake_layer):
        with pytest.raises(KeyError, match="unknown layer type"):
            make("no_such_layer_type", None, [])
    # forward(injected=, skip=) (the pipelined trainer's prologue and
    # tail): a skipped value that is not injected and is consumed
    # downstream raises KeyError naming it, in both packages; an
    # injected value replaces the layer, the outputs as the full pass's
    jtopo, ttopo, _, _ = _topologies()
    table, raw = table_of(jtopo)
    jfeed, tfeed = feeds_of(jtopo, ttopo, _batch())
    jparams = {k: jnp.asarray(v) for k, v in table.items()}
    name = "tfm_l0_attn"
    with pytest.raises(KeyError, match=name):
        jtopo.forward(jparams, jtopo.init_state(), jfeed, skip=[name])
    with pytest.raises(KeyError, match=name):
        ttopo.forward(raw, ttopo.init_state(), tfeed, skip=[name])
    jmid, _ = jtopo.forward(jparams, jtopo.init_state(), jfeed,
                            output_names=[name])
    inj = jmid[name]
    tinj = SequenceBatch(torch.as_tensor(np.asarray(inj.data)),
                         torch.as_tensor(np.asarray(inj.lengths)))
    tfull, _ = ttopo.forward(raw, ttopo.init_state(), tfeed)
    tout, _ = ttopo.forward(raw, ttopo.init_state(), tfeed,
                            injected={name: tinj}, skip=[name])
    for k in tfull:
        assert_values_close(tout[k], tfull[k], k)


@pytest.mark.parametrize("golden", ["simple_fc", "attention_net",
                                    "simple_lstm_net", "crf_tagger"])
def test_deserialize_in_a_fresh_process_round_trips_the_golden(golden):
    """A process that imports only the port's topology module reads a
    golden topology and serializes it back byte for byte, as the JAX
    package does: importing the package fills the layer registry, so
    nothing else has to be imported first (the test process has
    imported the layers already, which would hide the fault)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "tests", "golden", f"{golden}.json")
    with open(path) as f:
        src = f.read()
    assert paddle.Topology.deserialize(src).serialize() == src
    code = (
        "import sys\n"
        "from paddle_tpu_torch.core.topology import Topology\n"
        f"src = open({path!r}).read()\n"
        "topo = Topology.deserialize(src)\n"
        "print('ROUND_TRIP', topo.serialize() == src)\n"
        "print('FOREIGN', sorted(m for m in sys.modules if m in "
        "('jax', 'paddle_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-B", "-c", code], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "ROUND_TRIP True" in res.stdout, res.stdout
    assert "FOREIGN []" in res.stdout, res.stdout
