"""Port parity: the sequence models of paddle_tpu_torch (the IMDB
stacked-LSTM classifier, its bidirectional variant and the GRU-CRF
tagger; the recurrent, sequence, concat, classification and CRF layers
under them; Inference / infer) against paddle_tpu on the CPU.

- The serialized topology and the parameter specs of
  ``stacked_lstm_net``, ``bidi_lstm_net`` and ``rnn_crf_tagger`` are
  byte-equal to the JAX package's, and the golden
  ``simple_lstm_net.json``, ``bidirectional_gru.json`` and
  ``simple_rnn.json`` deserialize in the port and give the JAX
  package's outputs.
- From one ``paddle_tpu.params.v1`` tar written by the JAX package and
  read by the port, one forward on a ragged batch gives the same
  per-row costs and autograd the same gradients as ``jax.grad``: rtol
  1e-4 / atol 1e-5 in float32 (two CPU matmul libraries summing in
  different orders).
- Three Adam ``train_batch`` steps give the same losses (rtol 1e-4),
  ``infer`` the same probabilities (rtol 1e-4 / atol 1e-5) and the same
  Viterbi labels (exactly), and ``crf_nll`` / ``crf_viterbi`` match the
  JAX functions.

The widths are small (h <= 16, a few steps): float32 throughout.
"""

import io
import json
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as j_reset
from paddle_tpu.layers import crf_layers as jcrf
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder

from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.layers import crf_layers as tcrf
from paddle_tpu_torch.trainer import SGD as TSGD
from paddle_tpu_torch.trainer import Inference as TInference
from paddle_tpu_torch.trainer import Parameters as TParameters
from paddle_tpu_torch.trainer import infer as tinfer
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder

RTOL, ATOL = 1e-4, 1e-5
GOLDEN = pathlib.Path(__file__).parent / "golden"
CFGS = {
    "stacked_lstm_net": dict(vocab_size=50, emb_size=8, hidden_size=12,
                             lstm_num=2, num_classes=3),
    "bidi_lstm_net": dict(vocab_size=50, emb_size=8, hidden_size=12,
                          num_classes=3),
    "rnn_crf_tagger": dict(vocab_size=50, num_labels=5, emb_size=8,
                           hidden_size=12),
}
MODELS = sorted(CFGS)


def _outputs(spec):
    """The graph a test runs: the cost, then the error metric or the
    Viterbi path."""
    extra = getattr(spec, "decoded", None) or spec.error
    return [spec.cost, extra]


def _models(name):
    paddle.init(use_tpu=False, seed=0)
    j_reset()
    jspec = getattr(jmodels, name)(**CFGS[name])
    t_reset()
    tspec = getattr(tmodels, name)(**CFGS[name])
    return (jspec, tspec, paddle.Topology(_outputs(jspec)),
            TTopology(_outputs(tspec)))


def _batch(name, seed=0, n=4):
    """Ragged seeded samples: (words, label) for the classifiers,
    (words, labels) for the tagger."""
    rng = np.random.RandomState(seed)
    cfg = CFGS[name]
    out = []
    for i in range(n):
        L = [9, 3, 12, 1, 7, 5][i % 6]
        words = rng.randint(0, cfg["vocab_size"], (L,)).astype(np.int32)
        if name == "rnn_crf_tagger":
            out.append((words, rng.randint(0, cfg["num_labels"], (L,))
                        .astype(np.int32)))
        else:
            out.append((words, int(rng.randint(0, cfg["num_classes"]))))
    return out


def _table(jtopo, seed=7):
    return {k: np.asarray(v)
            for k, v in jtopo.init_params(jax.random.PRNGKey(seed)).items()}


def _tar_round_trip(table):
    """JAX Parameters -> paddle_tpu.params.v1 tar -> the port's
    Parameters on the CPU."""
    buf = io.BytesIO()
    paddle.Parameters({k: jnp.asarray(v) for k, v in table.items()}) \
        .to_tar(buf)
    buf.seek(0)
    return TParameters.from_tar(buf, device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_serialized_topology_and_param_specs_byte_equal(name):
    jspec, tspec, jtopo, ttopo = _models(name)
    assert ttopo.serialize() == jtopo.serialize()
    assert [(k, tuple(v.shape)) for k, v in ttopo.param_specs.items()] == \
        [(k, tuple(v.shape)) for k, v in jtopo.param_specs.items()]
    again = TTopology.deserialize(ttopo.serialize())
    assert again.serialize() == ttopo.serialize()


@pytest.mark.parametrize("golden", ["simple_lstm_net", "bidirectional_gru",
                                    "simple_rnn"])
def test_golden_topologies_deserialize_and_run(golden):
    blob = (GOLDEN / f"{golden}.json").read_text()
    jtopo = paddle.Topology.deserialize(blob)
    ttopo = TTopology.deserialize(blob)
    assert json.loads(ttopo.serialize()) == json.loads(blob)
    table = _table(jtopo, seed=3)
    vocab = jtopo.data_type()[0][1].dim
    rng = np.random.RandomState(4)
    samples = [(rng.randint(0, vocab, (L,)).astype(np.int32),)
               for L in (6, 2, 11)]
    jfeed = JFeeder(jtopo.data_type())(samples)
    jfeed.pop("__batch_size__")
    tfeed = TFeeder(ttopo.data_type(), device="cpu")(samples)
    tfeed.pop("__batch_size__")
    jout, _ = jtopo.forward({k: jnp.asarray(v) for k, v in table.items()},
                            {}, jfeed, mode="test")
    tout, _ = ttopo.forward({k: torch.tensor(v) for k, v in table.items()},
                            {}, tfeed, mode="test")
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_cost_and_gradients_from_one_tar_match_jax(name):
    jspec, tspec, jtopo, ttopo = _models(name)
    table = _table(jtopo)
    tparams = _tar_round_trip(table)
    batch = _batch(name)
    jfeed = JFeeder(jtopo.data_type())(batch)
    jfeed.pop("__batch_size__")
    tfeed = TFeeder(ttopo.data_type(), device="cpu")(batch)
    tfeed.pop("__batch_size__")
    cname = jspec.cost.name

    def jloss(p):
        outs, _ = jtopo.forward(p, {}, jfeed, mode="train",
                                output_names=[cname])
        return jnp.sum(outs[cname]), outs[cname]

    (_, jrows), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in table.items()})
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.raw.items()}
    outs, _ = ttopo.forward(leaves, {}, tfeed, mode="train",
                            output_names=[tspec.cost.name])
    trows = outs[tspec.cost.name]
    names = sorted(leaves)
    tg = torch.autograd.grad(trows.sum(), [leaves[k] for k in names])
    np.testing.assert_allclose(trows.detach().numpy(), np.asarray(jrows),
                               rtol=RTOL, atol=ATOL)
    assert set(names) == set(jg)
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        if "_lstm" in k or "_fw" in k or "_bw" in k:
            assert np.abs(g.numpy()).sum() > 0, k


@pytest.mark.parametrize("name", MODELS)
def test_adam_train_batch_losses_match_jax(name):
    jspec, tspec, jtopo, _ = _models(name)
    table = _table(jtopo, seed=9)
    jtr = paddle.SGD(cost=jspec.cost, parameters=paddle.Parameters(
        {k: jnp.asarray(v) for k, v in table.items()}),
        update_equation=paddle.optimizer.Adam(learning_rate=1e-2))
    ttr = TSGD(cost=tspec.cost, parameters=_tar_round_trip(table),
               update_equation=topt.Adam(learning_rate=1e-2), device="cpu")
    losses = []
    for step in range(3):
        batch = _batch(name, seed=10 + step)
        jl, _ = jtr.train_batch(batch)
        tl, _ = ttr.train_batch(batch)
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        losses.append(tl)
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("name", MODELS)
def test_infer_matches_jax(name):
    jspec, tspec, jtopo, _ = _models(name)
    table = _table(jtopo, seed=11)
    jparams = paddle.Parameters({k: jnp.asarray(v) for k, v in table.items()})
    tparams = _tar_round_trip(table)
    samples = [(w,) for w, _ in _batch(name, seed=12, n=6)]
    if name == "rnn_crf_tagger":
        jout = paddle.infer(output_layer=jspec.decoded, parameters=jparams,
                            input=samples, batch_size=3)
        tout = tinfer(output_layer=tspec.decoded, parameters=tparams,
                      input=samples, batch_size=3, device="cpu")
        np.testing.assert_array_equal(tout, np.asarray(jout))
        lens = [len(s[0]) for s in samples]
        for r, L in enumerate(lens):
            assert not tout[r, L:].any()
    else:
        jout = paddle.infer(output_layer=jspec.output, parameters=jparams,
                            input=samples, batch_size=4)
        tout = tinfer(output_layer=tspec.output, parameters=tparams,
                      input=samples, batch_size=4, device="cpu")
        assert tout.shape == (6, CFGS[name]["num_classes"])
        np.testing.assert_allclose(tout, np.asarray(jout), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tout.sum(-1), 1.0, rtol=1e-6)


def test_inference_runs_without_gradients_and_refuses_without_cuda():
    _, tspec, jtopo, _ = _models("stacked_lstm_net")
    tparams = _tar_round_trip(_table(jtopo))
    inf = TInference(output_layer=tspec.output, parameters=tparams,
                     device="cpu")
    (probs,) = inf.forward_batch([(w,) for w, _ in _batch(
        "stacked_lstm_net")])
    assert probs.shape == (4, 3) and np.isfinite(probs).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TInference(output_layer=tspec.output, parameters=tparams)
        with pytest.raises(RuntimeError, match="CUDA"):
            tinfer(tspec.output, tparams, [(np.zeros(3, np.int32),)])


def _crf_case(seed=20, b=4, T=7, n=5):
    rng = np.random.RandomState(seed)
    em = rng.randn(b, T, n).astype(np.float32)
    lab = rng.randint(0, n, (b, T)).astype(np.int32)
    lens = np.array([7, 1, 4, 6], np.int32)
    w = (rng.randn(n + 2, n) * 0.5).astype(np.float32)
    return em, lab, lens, w


def test_crf_nll_and_gradients_match_jax():
    em, lab, lens, w = _crf_case()

    def jf(e, ww):
        return jcrf.crf_nll(e, jnp.asarray(lab), jnp.asarray(lens), ww[0],
                            ww[1], ww[2:])

    jval, vjp = jax.vjp(jf, jnp.asarray(em), jnp.asarray(w))
    g = np.random.RandomState(21).randn(4).astype(np.float32)
    jg = vjp(jnp.asarray(g))
    te, tw = torch.tensor(em, requires_grad=True), \
        torch.tensor(w, requires_grad=True)
    tval = tcrf.crf_nll(te, torch.tensor(lab), torch.tensor(lens), tw[0],
                        tw[1], tw[2:])
    tg = torch.autograd.grad(tval, (te, tw), torch.tensor(g))
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               rtol=1e-5, atol=1e-5)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=RTOL,
                                   atol=ATOL)
    assert (tval.detach().numpy() > 0).all()


def test_crf_viterbi_matches_jax():
    em, _, lens, w = _crf_case(seed=22)
    jpath = jcrf.crf_viterbi(jnp.asarray(em), jnp.asarray(lens),
                             jnp.asarray(w[0]), jnp.asarray(w[1]),
                             jnp.asarray(w[2:]))
    tpath = tcrf.crf_viterbi(torch.tensor(em), torch.tensor(lens),
                             torch.tensor(w[0]), torch.tensor(w[1]),
                             torch.tensor(w[2:]))
    assert tpath.dtype == torch.int32
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
