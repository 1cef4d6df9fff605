"""The port's copy of the UCI 8x8 digits (paddle_tpu_torch/dataset/
digits.py) and the convergence run it feeds, on the CPU.

- The copy gives scikit-learn's ``load_digits()`` arrays exactly
  (images / 16 as float32, the labels), and the same 80/20 split, in
  the same order, as demo/mnist/convergence.py's ``digits_readers()``.
  Each check skips only where scikit-learn is absent.
- The copy is read as it is: a missing file raises, with no fallback.
- The port copy of the convergence script (``chip_smoke.
  convergence_demo``: the digits CNN, dropout 0.5, Adam(1e-3), batch
  128, 100 passes) reaches the script's own target, test accuracy
  >= 0.98, on the port's CPU path.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as paddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import reset_name_counters
from paddle_tpu_torch.dataset import digits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _convergence_module():
    pytest.importorskip("sklearn")
    path = os.path.join(ROOT, "demo", "mnist", "convergence.py")
    spec = importlib.util.spec_from_file_location("convergence_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_digits_copy_equals_sklearn():
    sk = pytest.importorskip("sklearn.datasets")
    d = sk.load_digits()
    x, y = digits.load()
    assert x.dtype == np.float32 and y.dtype == np.int32
    np.testing.assert_array_equal(
        x, (d.images.reshape(len(d.images), 64) / 16.0).astype("float32"))
    np.testing.assert_array_equal(y, d.target)


def test_digits_split_equals_convergence_script():
    mod = _convergence_module()
    want_train, want_test, want_dim = mod.digits_readers()
    got_train, got_test, got_dim = digits.readers()
    assert got_dim == want_dim == 64
    for got, want in ((got_train, want_train), (got_test, want_test)):
        g, w = list(got()), list(want())
        assert len(g) == len(w)
        for (gx, gy), (wx, wy) in zip(g, w):
            np.testing.assert_array_equal(gx, wx)
            assert gy == wy
    assert len(list(got_test())) == int(1797 * 0.2)


def test_missing_digits_copy_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(digits, "PATH", str(tmp_path / "digits.csv.gz"))
    with pytest.raises(FileNotFoundError, match="digits copy"):
        digits.readers()


def test_port_convergence_run_meets_the_target():
    """Two torch threads: the suite's workers share the machine's cores
    (about 30 s alone)."""
    reset_name_counters()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = chip_smoke.convergence_demo(paddle, digits.readers,
                                        use_tpu=False, num_passes=100)
    finally:
        torch.set_num_threads(threads)
        tconfig.init(seed=0)
    assert r["trainer"].device.type == "cpu"
    assert len(r["costs"]) == 100 * (1438 // 128)
    assert np.all(np.isfinite(r["costs"]))
    assert r["test_accuracy"] >= 0.98
