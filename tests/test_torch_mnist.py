"""Port parity: the two v2 scripts of this slice — demo/mnist/train.py
and demo/sequence_tagging/train.py — run in paddle_tpu_torch on the
CPU and track paddle_tpu's run of the same script.

The scripts are the copies in chip_smoke.py (``mnist_v2_demo``,
``tagging_v2_demo``): the demo's code with only its imports changed,
taking the package as an argument, so one copy runs in both packages.
``use_tpu=False`` is the CPU request. Each port run starts from the
JAX run's initial weights (its ``init_tar``), since the two packages'
initialisers draw differently.

- MNIST MLP (784-128-64-10, batch 128, Momentum, the synthetic set
  shuffled with seed 1), 2 passes cut to 6 batches each: per-step costs
  at rtol 1e-5; pass averages at rtol 1e-6 (the JAX trainer sums them
  compensated, the port in plain floats); the test cost at rtol 1e-5
  and its classification error exactly; the saved
  ``pass-00001/params.tar`` reloads and infers the JAX argmax, with
  probabilities within 1e-5.
- The GRU-CRF tagger with the chunk evaluator (vocab 44068, 106 labels,
  batch 16, synthetic CoNLL-05), one pass cut to 4 batches: per-step
  costs at rtol 1e-5, and the chunk precision, recall and F1 of the
  training pass and of the test sweep over the 400 test sentences
  equal the JAX package's.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jpaddle

import chip_smoke
import paddle_tpu_torch as paddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset

RTOL_STEP = 1e-5
RTOL_PASS = 1e-6
CHUNK_KEYS = ("chunk_f1_precision", "chunk_f1_recall", "chunk_f1_f1")


@pytest.fixture(autouse=True)
def _port_config():
    t_reset()
    yield
    tconfig.init(seed=0)


def _quiet(_):
    pass


def test_mnist_v2_script_tracks_jax(tmp_path):
    j = chip_smoke.mnist_v2_demo(jpaddle, use_tpu=False, num_passes=2,
                                 num_batches_per_pass=6,
                                 output=str(tmp_path / "jax"), echo=_quiet)
    t = chip_smoke.mnist_v2_demo(paddle, use_tpu=False, num_passes=2,
                                 num_batches_per_pass=6,
                                 output=str(tmp_path / "port"),
                                 init_tar=j["init_tar"], echo=_quiet)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == 12
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=RTOL_STEP)
    assert t["costs"][-1] < t["costs"][0]
    assert len(t["passes"]) == 2
    for tp, jp in zip(t["passes"], j["passes"]):
        assert sorted(tp) == sorted(jp) == ["cost", "error"]
        np.testing.assert_allclose(tp["cost"], jp["cost"], rtol=RTOL_PASS)
        assert tp["error"] == jp["error"]
    np.testing.assert_allclose(t["test_cost"], j["test_cost"],
                               rtol=RTOL_STEP)
    assert t["test_metrics"]["error"] == j["test_metrics"]["error"]
    assert t["ckpt"] == os.path.join(str(tmp_path / "port"), "pass-00001",
                                     "params.tar")
    assert os.path.isfile(t["ckpt"])
    assert t["probs"].shape == j["probs"].shape == (8, 10)
    assert t["probs"].argmax(-1).tolist() == j["probs"].argmax(-1).tolist()
    np.testing.assert_allclose(t["probs"], j["probs"], rtol=0, atol=1e-5)


def test_tagging_v2_script_chunk_f1_equals_jax():
    j = chip_smoke.tagging_v2_demo(jpaddle, use_tpu=False, num_passes=1,
                                   num_batches_per_pass=4, echo=_quiet)
    t = chip_smoke.tagging_v2_demo(paddle, use_tpu=False, num_passes=1,
                                   num_batches_per_pass=4,
                                   init_tar=j["init_tar"], echo=_quiet)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == 4
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=RTOL_STEP)
    for got, want in ((t["passes"][0], j["passes"][0]),
                      (t["test_metrics"], j["test_metrics"])):
        assert sorted(got) == sorted(want)
        for k in CHUNK_KEYS:
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["rcrf_cost"], want["rcrf_cost"],
                                   rtol=RTOL_STEP)
    assert t["test_metrics"]["chunk_f1_f1"] > 0.0
    np.testing.assert_allclose(t["test_cost"], j["test_cost"],
                               rtol=RTOL_STEP)
