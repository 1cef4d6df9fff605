"""Port parity: the text and tagger builders that wait on the layer
families — ``models.convolution_net``, ``models.ngram_lm`` and
``models.crf_tagger`` — ``dataset.imdb`` and the port copy of
demo/quick_start/train.py, against paddle_tpu on the CPU.

- Each builder at small widths builds the same topology JSON in both
  packages and, from one weight tar on one seeded feed, the same
  outputs and parameter gradients (of a seeded projection of the cost
  and the output) at rtol 1e-4 / atol 1e-5
  (``tests/torch_parity.check_parity``); the CRF tagger's Viterbi path
  is equal.
- ``dataset.imdb``: the first 64 train and test samples equal JAX's.
- The copy of demo/quick_start/train.py in chip_smoke.py
  (``quick_start_v2_demo``, only its imports changed) runs 4 batches
  of its one pass in both packages from one init tar: the costs are
  within 1e-4 relative, and so are the test sweep's cost and AUC.
"""

import itertools

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from tests.torch_parity import check_parity, seq_rows, submodule

LENS = [5, 2, 7]
QUICK_BATCHES = 4
RTOL_COST = 1e-4


@pytest.fixture(autouse=True)
def _port_config():
    treset()
    yield
    tconfig.init(seed=0)


def _conv_net(L):
    spec = submodule(L, "models.text").convolution_net(
        vocab_size=50, emb_size=8, hidden_size=6, num_classes=3)
    return [spec.cost, spec.output]


def _ngram(L):
    spec = submodule(L, "models.text").ngram_lm(
        vocab_size=40, emb_size=5, hidden_size=12, context=3)
    assert [w.name for w in spec.words] == ["w0", "w1", "w2"]
    return [spec.cost, spec.output]


def _crf(L):
    spec = submodule(L, "models.tagger").crf_tagger(
        vocab_size=50, num_labels=5, emb_size=8, hidden_size=10,
        context_len=3)
    return [spec.cost, spec.output, spec.decoded]


def _text_samples(seed=0):
    rng = np.random.RandomState(seed)
    words = seq_rows(rng, LENS, 0, integer=True, vocab=50)
    return [(w, int(rng.randint(0, 3))) for w in words]


def _ngram_samples(seed=0):
    rng = np.random.RandomState(seed)
    return [tuple(int(v) for v in rng.randint(0, 40, 4)) for _ in range(5)]


def _tagger_samples(seed=0):
    rng = np.random.RandomState(seed)
    words = seq_rows(rng, LENS, 0, integer=True, vocab=50)
    labels = seq_rows(rng, LENS, 0, integer=True, vocab=5)
    return list(zip(words, labels))


BUILDERS = {"convolution_net": (_conv_net, _text_samples),
            "ngram_lm": (_ngram, _ngram_samples),
            "crf_tagger": (_crf, _tagger_samples)}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_jax(name):
    build, samples = BUILDERS[name]
    check_parity(build, samples())


def test_builders_export_under_the_jax_names():
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import models as tmodels
    for name in ("convolution_net", "ngram_lm", "crf_tagger", "googlenet"):
        assert name in tmodels.__all__ and name in jmodels.__all__
        assert getattr(tmodels, name).__name__ == name


def test_imdb_samples_equal_jax():
    assert tpaddle.dataset.imdb.word_dict() == \
        jpaddle.dataset.imdb.word_dict()
    for split in ("train", "test"):
        t = list(itertools.islice(getattr(tpaddle.dataset.imdb, split)()(),
                                  64))
        j = list(itertools.islice(getattr(jpaddle.dataset.imdb, split)()(),
                                  64))
        assert len(t) == len(j) == 64
        for (tw, tl), (jw, jl) in zip(t, j):
            assert tl == jl and tw.dtype == jw.dtype
            np.testing.assert_array_equal(tw, jw)
    with pytest.raises(NotImplementedError, match="A.9"):
        tpaddle.dataset.imdb.convert("unused")


def test_quick_start_v2_script_tracks_jax():
    quiet = lambda _: None  # noqa: E731
    j = chip_smoke.quick_start_v2_demo(jpaddle, use_tpu=False, num_passes=1,
                                       num_batches_per_pass=QUICK_BATCHES,
                                       echo=quiet)
    treset()
    lines = []
    t = chip_smoke.quick_start_v2_demo(tpaddle, use_tpu=False, num_passes=1,
                                       num_batches_per_pass=QUICK_BATCHES,
                                       init_tar=j["init_tar"],
                                       echo=lines.append)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == QUICK_BATCHES
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=RTOL_COST)
    np.testing.assert_allclose(t["test_cost"], j["test_cost"],
                               rtol=RTOL_COST)
    np.testing.assert_allclose(t["test_metrics"]["auc"],
                               j["test_metrics"]["auc"], rtol=RTOL_COST)
    assert lines[0].startswith("pass 0 batch 0 cost ")
    assert lines[-1].startswith("test: cost ") and "auc" in lines[-1]
