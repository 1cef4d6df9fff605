"""Port parity: the attention NMT (models/seq2seq.py), beam search, the
beam cross entropy and the inference artifact of paddle_tpu_torch
against paddle_tpu on the CPU, at a small size (vocab 40, embedding 8,
encoder and decoder 16, batches of 4 WMT-14 synthetic pairs).

- ``nmt_attention``: the same JSON; from one weight table (the JAX init
  through a params tar) the cost equals JAX's and its gradients equal
  ``jax.grad``'s at rtol 1e-4 / atol 1e-5 (the golden harness's
  tolerance).
- Three ``Adam(1e-3)`` ``train_batch`` steps from that table: per-step
  costs at rtol 1e-4 (Adam's g / sqrt(v) makes near-zero gradients
  sign-sensitive, so its parameters are held through the costs, as in
  tests/test_torch_train.py).
- ``nmt_generator`` (beam 3, max_length 7, three results a sample) on
  the trained table: JAX's paths token for token, scores within rtol
  1e-5 / atol 1e-5.
- ``cross_entropy_over_beam`` over two expansions (a flat and a nested
  one), with golds on the beam, off it, and out of range: the cost and
  its gradients at rtol 1e-4 / atol 1e-5.
- The inference artifact: JAX's ``save_inference_model`` loads in the
  port and gives JAX's paths and scores, the port's loads in JAX, and a
  missing, torn or foreign file raises JAX's ValueError message.
- chip_smoke.py's copy of demo/seqToseq/train.py runs in both packages
  (4 batches): costs at rtol 1e-4, the same beam paths.
"""

import io
import json
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu.models.seq2seq import nmt_attention as j_nmt
from paddle_tpu.models.seq2seq import nmt_generator as j_gen
from paddle_tpu.trainer import inference as jinf
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from paddle_tpu_torch.models import nmt_attention as t_nmt
from paddle_tpu_torch.models import nmt_generator as t_gen
from paddle_tpu_torch.trainer import inference as tinf
from tests.torch_parity import (RTOL, check_parity, feeds_of, nested_rows,
                                seq_rows, submodule, table_of)

WIDTH = dict(src_vocab=40, trg_vocab=40, emb_size=8, enc_size=16,
             dec_size=16)
GEN = dict(beam_size=3, max_length=7)
FEEDING = {"source_words": 0, "target_words": 1, "target_next_words": 2}


def _pairs(n, split="train"):
    reader = getattr(tpaddle.dataset.wmt14, split)(WIDTH["src_vocab"])
    return [s for _, s in zip(range(n), reader())]


def _both(build_j, build_t, **kw):
    jreset()
    j = build_j(**WIDTH, **kw)
    treset()
    t = build_t(**WIDTH, **kw)
    return j, t


def _gen_pair(n_results=1):
    """The generator in both packages; ``n_results`` paths a sample."""
    jreset()
    jbeam = j_gen(**WIDTH, **GEN)
    treset()
    tbeam = t_gen(**WIDTH, **GEN)
    for b in (jbeam, tbeam):
        b.config["num_results_per_sample"] = n_results
    return jbeam, tbeam


def _trainers():
    jpaddle.init(use_tpu=False, seed=0)
    jspec, tspec = _both(j_nmt, t_nmt)
    jtopo = jpaddle.Topology(jspec.cost)
    table, raw = table_of(jtopo)
    jtr = jpaddle.SGD(cost=jspec.cost, parameters=jpaddle.Parameters(
        {k: jnp.asarray(v) for k, v in table.items()}),
        update_equation=jpaddle.optimizer.Adam(learning_rate=1e-3),
        extra_layers=jspec.extra_layers)
    ttr = tpaddle.SGD(cost=tspec.cost, parameters=tpaddle.Parameters(
        dict(raw), device="cpu"),
        update_equation=tpaddle.optimizer.Adam(learning_rate=1e-3),
        extra_layers=tspec.extra_layers, device="cpu")
    return jtr, ttr


def test_nmt_cost_and_gradients_match_jax():
    def build(L):
        pkg = jpaddle if L is jpaddle.layer else tpaddle
        nmt = j_nmt if pkg is jpaddle else t_nmt
        return nmt(**WIDTH).cost

    samples = _pairs(4)
    jout, tout = check_parity(build, samples, feeding=FEEDING, mode="train")
    assert np.isfinite(np.asarray(jout["nmt_cost"])).all()


@pytest.fixture(scope="module")
def trained():
    """The two trainers after three Adam steps, and their costs."""
    jtr, ttr = _trainers()
    pairs = _pairs(12)
    costs = []
    for i in range(3):
        batch = pairs[4 * i: 4 * i + 4]
        jl, _ = jtr.train_batch(batch, feeding=FEEDING)
        tl, _ = ttr.train_batch(batch, feeding=FEEDING)
        costs.append((jl, tl))
    return jtr, ttr, costs


def test_three_adam_steps_track_jax(trained):
    _, _, costs = trained
    for jl, tl in costs:
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert all(np.isfinite(c) for pair in costs for c in pair)


def _generate(jtopo, jbeam, jparams, ttopo, tbeam, tparams, sources):
    samples = [(s,) for s in sources]
    jfeed, tfeed = feeds_of(jtopo, ttopo, samples)
    jo, _ = jtopo.forward({k: jnp.asarray(np.asarray(jparams[k]))
                           for k in jtopo.param_specs}, {}, jfeed,
                          mode="test")
    to, _ = ttopo.forward({k: tparams[k] for k in ttopo.param_specs}, {},
                          tfeed, mode="test")
    return jo[jbeam], to[tbeam]


def _same_paths(jres, tres):
    jl, tl = jres.to_list(), tres.to_list()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert [p for _, p in a] == [p for _, p in b]
        np.testing.assert_allclose([s for s, _ in b], [s for s, _ in a],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tres.data.numpy(), np.asarray(jres.data))
    np.testing.assert_array_equal(tres.lengths.numpy(),
                                  np.asarray(jres.lengths))


def test_generator_paths_and_scores_match_jax(trained):
    jtr, ttr, _ = trained
    jbeam, tbeam = _gen_pair(n_results=3)
    jtopo, ttopo = jpaddle.Topology(jbeam), tpaddle.Topology(tbeam)
    assert json.loads(ttopo.serialize()) == json.loads(jtopo.serialize())
    assert ttopo.generates
    sources = [s[0] for s in _pairs(5, "test")]
    jres, tres = _generate(jtopo, jbeam.name, jtr.parameters.raw, ttopo,
                           tbeam.name, ttr.parameters.raw, sources)
    assert tres.all_data.shape == (5, 3, GEN["max_length"])
    _same_paths(jres, tres)
    # generation runs without autograd on leaves that require gradients
    assert not tres.scores.requires_grad


# ---------------------------------------------- cross_entropy_over_beam

def _beam_cost_graph(L):
    dt = submodule(L, "core.data_type")
    s1 = L.data("s1", dt.dense_vector_sequence(4))
    s2 = L.data("s2", dt.dense_vector_sub_sequence(4))
    g1 = L.data("g1", dt.integer_value(12))
    g2 = L.data("g2", dt.integer_value(12))
    sc1 = L.fc(s1, size=1, name="sc1")
    sc2 = L.fc(s2, size=1, name="sc2")
    sel1 = L.kmax_seq_score(sc1, beam_size=2, name="sel1")
    sel2 = L.kmax_seq_score(sc2, beam_size=2, name="sel2")
    return L.cross_entropy_over_beam(
        [L.BeamInput(sc1, sel1, g1), L.BeamInput(sc2, sel2, g2)],
        name="beam_ce")


def test_cross_entropy_over_beam_matches_jax():
    rng = np.random.RandomState(21)
    lens = [5, 3, 6, 4, 2, 5]
    splits = [[2, 2], [1, 2], [3, 1, 2], [2, 1], [1], [2, 3]]
    flat = seq_rows(rng, lens, 4)
    nested = nested_rows(rng, splits, 4)
    # golds: on the beam, off it, past the sequence, and 11 (never a
    # position here)
    g1 = [0, 2, 4, 1, 11, 3]
    g2 = [1, 0, 2, 11, 0, 1]
    samples = list(zip(flat, nested, g1, g2))
    jout, tout = check_parity(_beam_cost_graph, samples, feeding={
        "s1": 0, "s2": 1, "g1": 2, "g2": 3})
    assert np.isfinite(np.asarray(jout["beam_ce"])).all()


# ------------------------------------------------- the inference artifact

def test_artifact_loads_across_the_packages(tmp_path, trained):
    jtr, ttr, _ = trained
    jbeam, tbeam = _gen_pair()
    sources = [(s[0],) for s in _pairs(4, "test")]
    jpath = str(tmp_path / "jax.tar")
    tpath = str(tmp_path / "port.tar")
    jtopo = jpaddle.Topology(jbeam)
    jparams = jpaddle.Parameters({k: jtr.parameters.raw[k]
                                  for k in jtopo.param_specs})
    jinf.save_inference_model(jpath, jbeam, jparams)
    ttopo = tpaddle.Topology(tbeam)
    tparams = tpaddle.Parameters({k: ttr.parameters.raw[k].detach()
                                  for k in ttopo.param_specs},
                                 device="cpu")
    tinf.save_inference_model(tpath, tbeam, tparams)
    with tarfile.open(jpath) as a, tarfile.open(tpath) as b:
        assert a.getnames() == b.getnames() == ["topology.json",
                                                "params.tar"]
        assert json.loads(a.extractfile("topology.json").read()) == \
            json.loads(b.extractfile("topology.json").read())

    want = jinf.load_inference_model(jpath)
    got = tinf.load_inference_model(jpath, device="cpu")
    back = jinf.load_inference_model(tpath)
    np.testing.assert_array_equal(got.forward_batch(sources)[0],
                                  want.forward_batch(sources)[0])
    np.testing.assert_array_equal(back.forward_batch(sources)[0],
                                  want.forward_batch(sources)[0])
    jres, tres = _generate(want.topology, jbeam.name, want.parameters.raw,
                           got.topology, tbeam.name, got.parameters.raw,
                           [s for s, in sources])
    _same_paths(jres, tres)


def _messages(load, path):
    with pytest.raises(ValueError) as e:
        load(path)
    return str(e.value)


@pytest.mark.parametrize("case", ["missing", "torn", "foreign"])
def test_artifact_errors_are_jax_errors(tmp_path, case):
    path = tmp_path / "model.tar"
    if case == "torn":
        jbeam, _ = _gen_pair()
        topo = jpaddle.Topology(jbeam)
        jinf.save_inference_model(str(path), jbeam, jpaddle.Parameters(
            topo.init_params(jax.random.PRNGKey(0))))
        path.write_bytes(path.read_bytes()[:700])
    elif case == "foreign":
        with tarfile.open(path, "w") as tf:
            blob = b"{}"
            info = tarfile.TarInfo("weights.bin")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    want = _messages(jinf.load_inference_model, str(path))
    assert _messages(tinf.load_inference_model, str(path)) == want


# ------------------------------------------- the demo/seqToseq script copy

def test_seqtoseq_v2_script_tracks_jax():
    """chip_smoke.seqtoseq_v2_demo, the copy of demo/seqToseq/train.py
    with only its imports changed, in both packages on the CPU: one pass
    cut to 4 batches from the JAX run's init tar, per-step costs at rtol
    1e-4, and the same beam paths (scores within rtol 1e-5 / atol
    1e-5)."""
    import chip_smoke
    from paddle_tpu_torch import config as tconfig

    def quiet(_):
        pass

    jreset()
    j = chip_smoke.seqtoseq_v2_demo(jpaddle, use_tpu=False, num_passes=1,
                                    num_batches_per_pass=4, echo=quiet)
    treset()
    try:
        t = chip_smoke.seqtoseq_v2_demo(tpaddle, use_tpu=False,
                                        num_passes=1,
                                        num_batches_per_pass=4,
                                        init_tar=j["init_tar"], echo=quiet)
    finally:
        tconfig.init(seed=0)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == 4
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=RTOL)
    assert len(t["paths"]) == 3
    for a, b in zip(t["paths"], j["paths"]):
        assert [p for _, p in a] == [p for _, p in b]
        np.testing.assert_allclose([s for s, _ in a], [s for s, _ in b],
                                   rtol=1e-5, atol=1e-5)
