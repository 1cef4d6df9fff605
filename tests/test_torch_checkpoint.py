"""Port parity: full-state checkpoints (paddle_tpu_torch/trainer/
checkpoint.py ``CheckpointManager``, ``SGD.save_checkpoint`` /
``restore_checkpoint``, ``train(auto_resume=)``) on the CPU.

- The port's counterparts of tests/test_faults.py's
  TestCheckpointFaults: ENOSPC surfaces and the previous checkpoint
  survives, a torn write recovers, an async failure surfaces at
  ``wait``, an md5 corruption falls back, an explicit step is verified.
- ``save`` returns a completed host copy: parameters written right
  after it do not reach the checkpoint.
- Across the packages, both ways (the flat key scheme and layout are
  the JAX package's): a JAX checkpoint taken mid-pass auto-resumes in
  the port, which trains on to the JAX trainer's final parameters, and
  a port checkpoint auto-resumes in the JAX package, which trains on to
  the port's. Momentum 0.9 from one table: rtol 1e-5 / atol 1e-6. An
  Adam checkpoint's slots and counters restore exactly.
"""

import errno
import io
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.trainer.checkpoint import CheckpointManager as JManager
from paddle_tpu_torch.trainer import checkpoint as ck
from paddle_tpu_torch.trainer.checkpoint import CheckpointManager

import torch_train_infra as infra

RTOL, ATOL = 1e-5, 1e-6

@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)



class _WriteFailure:
    """The ``at_save``-th checkpoint write (0-based) raises ENOSPC; with
    ``at_byte`` that many bytes land first (the torn artifact a crash
    mid-write leaves) — ``testing/faults.py``
    ``checkpoint_write_failure`` on the port's ``_savez``."""

    def __init__(self, monkeypatch, at_save=0, at_byte=None):
        self.count = 0
        real = ck._savez

        def savez(path, flat):
            i = self.count
            self.count += 1
            if i != at_save:
                return real(path, flat)
            if at_byte is not None:
                buf = io.BytesIO()
                np.savez(buf, **flat)
                with open(path, "wb") as f:
                    f.write(buf.getvalue()[:at_byte])
            raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC))

        monkeypatch.setattr(ck, "_savez", savez)


def _corrupt_newest(directory):
    newest = CheckpointManager(directory).all_steps()[-1]
    with open(os.path.join(directory, f"ckpt-{newest:010d}",
                           "state.npz"), "wb") as f:
        f.write(b"garbage")
    return newest


def test_enospc_surfaces_and_previous_survives(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    w = {"w": torch.ones(4, 4)}
    _WriteFailure(monkeypatch, at_save=1)
    mgr.save(1, w)
    with pytest.raises(OSError):
        mgr.save(2, w)
    assert mgr.latest_step() == 1


def test_torn_write_recovery(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    w = {"w": torch.arange(256, dtype=torch.float32).reshape(16, 16)}
    mgr.save(1, w)
    _WriteFailure(monkeypatch, at_save=0, at_byte=128)
    with pytest.raises(OSError):
        mgr.save(2, w)
    torn = tmp_path / "ckpt-0000000002.tmp" / "state.npz"
    assert torn.exists() and torn.stat().st_size <= 128
    assert mgr.latest_step() == 1
    step, tree = mgr.restore()
    assert step == 1
    np.testing.assert_array_equal(tree["params"]["w"], w["w"].numpy())


def test_async_write_failure_surfaces_at_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    _WriteFailure(monkeypatch, at_save=0)
    mgr.save(1, {"w": torch.ones(2, 2)})
    with pytest.raises(RuntimeError, match="checkpoint"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_md5_corruption_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": torch.full((2, 2), 1.0)})
    mgr.save(2, {"w": torch.full((2, 2), 2.0)})
    assert _corrupt_newest(str(tmp_path)) == 2
    assert mgr.latest_step() == 1
    step, tree = mgr.restore()
    assert step == 1
    np.testing.assert_array_equal(tree["params"]["w"], np.ones((2, 2)))


def test_explicit_step_restore_verifies_too(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": torch.full((2, 2), 1.0)})
    mgr.save(2, {"w": torch.full((2, 2), 2.0)})
    bad = _corrupt_newest(str(tmp_path))
    with pytest.raises(RuntimeError, match=f"ckpt-{bad:010d}"):
        mgr.restore(step=bad)
    step, tree = mgr.restore(step=1)
    assert step == 1
    np.testing.assert_array_equal(tree["params"]["w"], np.ones((2, 2)))


def test_save_is_a_host_copy_before_it_returns(tmp_path):
    """The port's optimizer writes the parameters in place: what save()
    took must not change when they do, the async write still pending."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    p = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)
         .requires_grad_()}
    want = p["w"].detach().numpy().copy()
    mgr.save(7, p, {"step": 3, "num_samples": 24.0,
                    "slots": {"w": {"m": torch.ones(3, 4)}}})
    with torch.no_grad():
        p["w"].mul_(-5.0)
    mgr.wait()
    step, tree = mgr.restore()
    assert step == 7
    np.testing.assert_array_equal(tree["params"]["w"], want)
    # the JAX package's scalar dtypes, on disk
    assert tree["opt_state"]["step"].dtype == np.int32
    assert tree["opt_state"]["num_samples"].dtype == np.float32


def test_keep_last_n_and_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.full((2,), float(s))}, meta={"s": s})
    assert mgr.all_steps() == [2, 3]
    assert mgr.peek_meta() == {"s": 3}
    with pytest.raises(TypeError, match="JSON"):
        mgr.save(4, {"w": torch.ones(1)}, meta={"x": object()})


def _jax_opt():
    return jpaddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9)


def _port_opt():
    return tpaddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9)


def _mid_pass_copy(src, dst, step):
    """A checkpoint directory holding only ``src``'s step ``step``: the
    state a run killed right after that step left."""
    os.makedirs(dst)
    name = f"ckpt-{step:010d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    tab = infra.table()
    rdr = infra.reader(batches=6)
    jtr = infra.jax_trainer(_jax_opt(), tab)
    infra.run(jtr, rdr, checkpoint_dir=str(tmp_path / "j"),
              checkpoint_period=3)
    d = _mid_pass_copy(str(tmp_path / "j"), str(tmp_path / "t"), 3)
    ttr = infra.port_trainer(_port_opt(), tab)
    costs, _ = infra.run(ttr, rdr, checkpoint_dir=d, auto_resume=True)
    assert len(costs) == 3                   # batches 3..5 only
    assert ttr._step_count == 6 and ttr.opt_state["step"] == 6
    infra.assert_close(infra.port_params(ttr), infra.jax_params(jtr),
                       RTOL, ATOL)
    # the port wrote its own pass-end checkpoint into the JAX layout
    assert CheckpointManager(d).peek_meta()["pass_count"] == 1


def test_port_checkpoint_resumes_in_jax(tmp_path):
    tab = infra.table()
    rdr = infra.reader(batches=6)
    ttr = infra.port_trainer(_port_opt(), tab)
    infra.run(ttr, rdr, checkpoint_dir=str(tmp_path / "t"),
              checkpoint_period=3)
    d = _mid_pass_copy(str(tmp_path / "t"), str(tmp_path / "j"), 3)
    jtr = infra.jax_trainer(_jax_opt(), tab)
    costs, _ = infra.run(jtr, rdr, checkpoint_manager=JManager(d),
                         auto_resume=True)
    assert len(costs) == 3
    assert int(jtr.opt_state["step"]) == 6
    infra.assert_close(infra.jax_params(jtr), infra.port_params(ttr),
                       RTOL, ATOL)


def test_adam_state_round_trips_across_packages(tmp_path):
    """Adam's slots and counters written by one package restore exactly
    in the other (no training in between)."""
    tab = infra.table()
    rdr = infra.reader(batches=2)
    jtr = infra.jax_trainer(jpaddle.optimizer.Adam(learning_rate=0.01), tab)
    infra.run(jtr, rdr)
    jtr.save_checkpoint(JManager(str(tmp_path / "j"), async_write=False))
    ttr = infra.port_trainer(tpaddle.optimizer.Adam(learning_rate=0.01),
                             tab)
    assert ttr.restore_checkpoint(CheckpointManager(str(tmp_path / "j")))
    assert ttr.opt_state["step"] == 2 and \
        ttr.opt_state["num_samples"] == 16.0
    for k, slots in jtr.opt_state["slots"].items():
        for n, v in slots.items():
            np.testing.assert_array_equal(
                ttr.opt_state["slots"][k][n].numpy(), np.asarray(v))
    infra.assert_equal(infra.port_params(ttr), infra.jax_params(jtr))
    # the restored values are the trainer's autograd leaves still
    assert all(p.requires_grad for p in ttr.parameters.raw.values())
    ttr.save_checkpoint(CheckpointManager(str(tmp_path / "t"),
                                          async_write=False))
    jtr2 = infra.jax_trainer(jpaddle.optimizer.Adam(learning_rate=0.01),
                             tab)
    assert jtr2.restore_checkpoint(JManager(str(tmp_path / "t")))
    assert int(jtr2.opt_state["step"]) == 2
    for k, slots in jtr.opt_state["slots"].items():
        for n, v in slots.items():
            np.testing.assert_array_equal(
                np.asarray(jtr2.opt_state["slots"][k][n]), np.asarray(v))


def test_restore_refuses_another_optimizers_slots(tmp_path):
    tab = infra.table()
    ttr = infra.port_trainer(tpaddle.optimizer.Adam(), tab)
    ttr.save_checkpoint(CheckpointManager(str(tmp_path),
                                          async_write=False))
    other = infra.port_trainer(_port_opt(), tab)
    with pytest.raises(ValueError, match="slots"):
        other.restore_checkpoint(CheckpointManager(str(tmp_path)))
