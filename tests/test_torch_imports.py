"""The port's isolation rules: ``paddle_tpu_torch`` (and
``chip_smoke.py``) import neither JAX nor the JAX package, and the
entry points refuse to run without CUDA unless a device is asked for.

Checked in fresh subprocesses, so nothing this test process imported
(it imports both packages) can mask a leak. The package-name test is
exact: ``paddle_tpu_torch`` itself starts with the string
``paddle_tpu``."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import paddle_tpu_torch
    names = ["paddle_tpu_torch"]
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _run(code, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_imports_without_jax_or_paddle_tpu():
    mods = _port_modules()
    for m in ("serving.engine", "ops.paged_decode", "ops.flash_attention",
              "core.topology", "core.registry", "layers.base",
              "layers.attention_layers", "models.transformer",
              "optimizer.optimizers", "trainer.trainer",
              "trainer.parameters", "trainer.data_feeder", "pooling",
              "networks", "ops.fused_rnn", "ops.recurrent",
              "ops.sequence_ops", "layers.recurrent_layers",
              "layers.seq_layers", "layers.crf_layers", "models.text",
              "models.tagger", "trainer.inference", "serving.spill",
              "serving.prefix", "models.decode", "reader", "dataset",
              "dataset.common", "dataset.synthetic", "dataset.mnist",
              "dataset.conll05", "evaluator", "attr", "activation",
              "optimizer.schedules", "config", "device", "ops.conv",
              "ops.pool", "ops.norm", "ops.fused", "layers.conv_layers",
              "layers.extra_layers", "models.image", "dataset.digits",
              "layers.group", "layers.beam", "layers.misc_layers",
              "models.seq2seq", "dataset.wmt14", "ops.moe",
              "layers.moe_layers", "op", "dataset.imdb"):
        assert f"paddle_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m.startswith('jaxlib.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports, without running it (there is no card
    here): its module-level import list pulls in nothing of JAX."""
    code = (
        "import ast, importlib, sys\n"
        "tree = ast.parse(open('chip_smoke.py').read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        for a in node.names: importlib.import_module(a.name)\n"
        "    elif isinstance(node, ast.ImportFrom) and node.level == 0:\n"
        "        importlib.import_module(node.module)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_entry_points_refuse_to_run_without_cuda():
    from paddle_tpu_torch import params as pt_params
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models import TransformerDecoder
    table = pt_params.init_transformer_lm_params(
        dict(vocab_size=10, d_model=8, n_heads=2, n_layers=1, d_ff=16,
             max_len=8), seed=0)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerDecoder(table, n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_params.params_from_numpy({"w": np.zeros(2, np.float32)})
    dec = TransformerDecoder(table, n_layers=1, n_heads=2, device="cpu")
    assert dec.generate(np.zeros((1, 2), np.int32), max_len=4)


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository, the script cannot run the port and must fail."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_build_sources_name_every_routed_kernel():
    """_build.SOURCES names the tensor-core kernels of the bf16 routes
    that replaced SIMT ones (the flash dq and the LSTM forward and
    backward), every library a flash route or the LSTM kernels load,
    and only sources that exist."""
    from paddle_tpu_torch.ops import _build, flash_attention
    assert _build.SOURCES["flash_dq_sm90"] == "flash_dq_sm90.cu"
    assert _build.SOURCES["lstm_bwd_sm90"] == "lstm_bwd_sm90.cu"
    assert _build.SOURCES["lstm_fwd_sm90"] == "lstm_fwd_sm90.cu"
    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).is_file(), src
    for lib, _ in flash_attention._KERNELS.values():
        assert lib in _build.SOURCES, lib
    assert flash_attention._KERNELS[("dq", "sm90")][0] == "flash_dq_sm90"
