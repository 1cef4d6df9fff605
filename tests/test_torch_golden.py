"""Port parity: the golden topologies of tests/golden/ in
paddle_tpu_torch against paddle_tpu on the CPU.

Every golden of tests/golden/ (32 of 32) is held here, in one
parametrised test: it deserializes in both packages (and serializes
back equal to the file in the port), runs from one weight table
(the JAX package's init, carried through a ``paddle_tpu.params.v1``
tar) on one seeded ragged batch (``chip_smoke.golden_samples``, which
phase 41 feeds the card too), and gives the JAX forward's outputs
at rtol 1e-4 / atol 1e-5. Where the golden has a cost, autograd's
gradients of the summed cost equal ``jax.grad``'s at the same
tolerance (two CPU matmul libraries summing in different orders);
``ctc_net``'s cost is a CTC layer. The image goldens (``img_layers``,
``tpu_stem_net``), ``cost_suite`` (an addto of five costs), the goldens
of the layer families (``util_layers``, ``op_sugar_net``,
``projections``, ``misc_utils``, ``extra_algebra_layers``,
``selection_layers``, ``switch_order_net``) and those of the 3-D,
image-transform and OCR/speech types (``img_trans_layers``,
``conv3d_net``, ``deep_speech_row_conv``, ``mdlstm_ocr``),
``detection_net`` (its output a detection_output) and
``nce_hsigmoid`` (an addto of the nce and hsigmoid costs) have no
cost node: their train-mode gradients (batch norm on the batch
statistics) are those of a fixed seeded projection of the outputs;
``util_layers`` has no parameter, so its gradients are those of its
float feeds. ``multibox_net``'s output is a multibox_loss cost.
``nce`` draws its noise in test mode as well: the port's layers take
the JAX package's draw (``torch_parity.use_draws``). Layers with state
(batch norm's moving statistics) start from each package's
``init_state``.

``test_held_goldens_are_every_one_the_port_deserializes`` keeps the
list complete.
"""

import io
import json
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
import torch
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder

from chip_smoke import GOLDEN_LENGTHS, golden_samples
from torch_parity import jax_nce_draws, use_draws

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.trainer import Parameters as TParameters
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder

RTOL, ATOL = 1e-4, 1e-5
GOLDEN = pathlib.Path(__file__).parent / "golden"
HELD = ["attention_net", "beam_cost_net", "bidirectional_gru", "conv3d_net",
        "cost_suite", "crf_tagger", "ctc_net", "deep_speech_row_conv",
        "detection_net", "extra_algebra_layers", "generation_helpers",
        "img_layers", "img_trans_layers", "mdlstm_ocr", "misc_utils",
        "moe_block", "multibox_net", "nce_hsigmoid", "nested_rnn_group",
        "op_sugar_net", "projections", "rank_costs", "rnn_group",
        "selection_layers", "seq_ops_suite", "simple_fc", "simple_lstm_net",
        "simple_rnn", "switch_order_net", "tpu_stem_net", "util_layers",
        "word_embedding_ngram"]
# goldens without a cost node whose gradients are held through a
# projection (cost_suite's and nce_hsigmoid's outputs are addtos of
# costs)
PROJECTED = ("conv3d_net", "cost_suite", "deep_speech_row_conv",
             "detection_net", "extra_algebra_layers", "img_layers",
             "img_trans_layers", "mdlstm_ocr", "misc_utils", "nce_hsigmoid",
             "op_sugar_net", "projections", "selection_layers",
             "switch_order_net", "tpu_stem_net", "util_layers")


def _payload(v):
    return v.data if isinstance(v, SequenceBatch) else v


def _jpayload(v):
    return v.data if hasattr(v, "lengths") else v


def _is_cost(topo, name):
    t = topo.by_name[name].type
    return t.endswith("cost") or t in ("crf", "multi-class-cross-entropy",
                                       "ctc", "warp_ctc", "multibox_loss")


@pytest.mark.parametrize("golden", HELD)
def test_golden_forward_and_gradients_match_jax(golden, monkeypatch):
    blob = (GOLDEN / f"{golden}.json").read_text()
    jpaddle.init(use_tpu=False, seed=0)
    jtopo = jpaddle.Topology.deserialize(blob)
    ttopo = TTopology.deserialize(blob)
    # nce samples its noise in test mode as well: the port takes the JAX
    # package's draw (the same one in both modes, rng None)
    use_draws(monkeypatch, jax_nce_draws(jtopo, len(GOLDEN_LENGTHS)))
    assert json.loads(ttopo.serialize()) == json.loads(blob)
    assert [n for n, _ in ttopo.data_type()] == \
        [n for n, _ in jtopo.data_type()]
    buf = io.BytesIO()
    jpaddle.Parameters(jtopo.init_params(jax.random.PRNGKey(3))).to_tar(buf)
    buf.seek(0)
    tparams = TParameters.from_tar(buf, device="cpu").raw
    table = {k: v.numpy() for k, v in tparams.items()}
    assert sorted(table) == sorted(ttopo.param_specs)
    samples = golden_samples(jtopo.data_type())
    jfeed = JFeeder(jtopo.data_type())(samples)
    jfeed.pop("__batch_size__")
    tfeed = TFeeder(ttopo.data_type(), device="cpu")(samples)
    tfeed.pop("__batch_size__")
    jstate, tstate = jtopo.init_state(), ttopo.init_state(device="cpu")
    jout, _ = jtopo.forward({k: jnp.asarray(v) for k, v in table.items()},
                            jstate, jfeed, mode="test")
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tout, _ = ttopo.forward(leaves, tstate, tfeed, mode="test")
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(_payload(tout[k]).detach().numpy(),
                                   np.asarray(_jpayload(jout[k])),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    costs = [o.name for o in ttopo.outputs if _is_cost(ttopo, o.name)]
    assert bool(costs) == (golden in ("crf_tagger", "ctc_net", "moe_block",
                                      "multibox_net", "rank_costs",
                                      "simple_fc"))
    if not costs and golden not in PROJECTED:
        return
    held = costs or [o.name for o in ttopo.outputs]
    rng = np.random.RandomState(9)
    proj = {} if costs else {
        k: rng.randn(*np.shape(_jpayload(jout[k]))).astype(np.float32)
        for k in held}

    def jloss(p, feed):
        outs, _ = jtopo.forward(p, jstate, feed, mode="train",
                                output_names=held)
        return sum(jnp.sum(_jpayload(outs[c]) * proj.get(c, 1.0))
                   for c in held)

    if table:
        names = sorted(leaves)
        jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in table.items()},
                             jfeed)
        wrt = [leaves[k] for k in names]
    else:
        # no parameter (util_layers): the gradients of the float feeds
        names = sorted(k for k, v in tfeed.items()
                       if isinstance(v, torch.Tensor)
                       and v.is_floating_point())
        assert names, golden
        jg = jax.grad(lambda f: jloss({}, dict(jfeed, **f)))(
            {k: jfeed[k] for k in names})
        wrt = [tfeed[k].clone().requires_grad_() for k in names]
        tfeed = dict(tfeed, **dict(zip(names, wrt)))
    outs, _ = ttopo.forward(leaves, tstate, tfeed, mode="train",
                            output_names=held)
    tloss = sum((_payload(outs[c]) * torch.as_tensor(proj[c])).sum()
                if c in proj else _payload(outs[c]).sum() for c in held)
    tg = torch.autograd.grad(tloss, wrt)
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d/d{k}")


def test_held_goldens_are_every_one_the_port_deserializes():
    ok = []
    for path in sorted(GOLDEN.glob("*.json")):
        try:
            TTopology.deserialize(path.read_text())
        except KeyError:        # an unknown layer type
            continue
        ok.append(path.stem)
    assert ok == sorted(HELD)
    assert len(list(GOLDEN.glob("*.json"))) == 32
