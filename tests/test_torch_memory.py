"""Port parity: adaptive microbatching (paddle_tpu_torch/trainer/
memory.py, ``SGD.train(microbatch=, oom_probe=)``) on the CPU — the
port's counterparts of tests/test_oom.py's trainer classes.

- The accumulation step at k = 1, 2, 4 and a padded tail (6 rows at
  microbatch 4) against the port's full-batch step (per-step costs and
  final parameters at rtol 2e-5 / atol 2e-6) and against the JAX
  package's full-batch step (rtol 1e-5 / atol 1e-6; not against its
  accumulation step, which fails in the JAX package, ROADMAP C.2); an
  LSTM classifier's sequence feed split the same way.
- An OOM injected through ``_step_interceptor`` at step 3 (twice) ends
  with the parameters of the run without it, no sample lost; at the
  floor the OOM re-raises; a non-OOM error passes through; an OOM once
  the update began writing is re-raised, not bisected.
- The warmup probe finds a microbatch under pressure and mutates
  nothing; the plan rides in checkpoint meta and resume adopts it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
from paddle_tpu_torch.trainer.fault import FaultPolicy
from paddle_tpu_torch.trainer.memory import (MemoryPlan,
                                             is_resource_exhausted,
                                             plan_memory,
                                             resource_exhausted_error)
from paddle_tpu_torch.utils.stats import global_counters

import torch_train_infra as infra

RTOL, ATOL = 2e-5, 2e-6          # port microbatched vs port full batch
JRTOL, JATOL = 1e-5, 1e-6        # port vs the JAX package's full batch

@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)



def _opt():
    return tpaddle.optimizer.Momentum(learning_rate=0.05)


def _trainer():
    return infra.port_trainer(_opt(), infra.table())


def test_memory_plan():
    assert MemoryPlan().steps_for(64) == 1
    assert MemoryPlan(microbatch=64).steps_for(64) == 1
    assert MemoryPlan(microbatch=16).steps_for(64) == 4
    assert MemoryPlan(microbatch=3).steps_for(8) == 3
    assert MemoryPlan().to_meta() is None
    m = MemoryPlan(microbatch=16, accum_steps=4, provenance="adapted")
    assert m.to_meta() == {"microbatch": 16, "accum_steps": 4,
                           "provenance": "adapted"}
    q = MemoryPlan.from_meta(m.to_meta(), provenance="resumed")
    assert (q.microbatch, q.accum_steps, q.provenance) == (16, 4, "resumed")
    assert MemoryPlan.from_meta(None) is None
    assert MemoryPlan.from_meta({}) is None


def test_oom_predicate_and_injected_error():
    e = resource_exhausted_error(123456, where="test")
    assert isinstance(e, torch.cuda.OutOfMemoryError)
    assert is_resource_exhausted(e) and "123456" in str(e)
    assert not is_resource_exhausted(RuntimeError("CUDA out of memory"))
    assert not is_resource_exhausted(ValueError("out of memory"))


@pytest.mark.parametrize("rows,mb", [(8, 8), (8, 4), (8, 2), (6, 4)],
                         ids=["k1", "k2", "k4", "padded-tail"])
def test_accumulation_matches_full_batch(rows, mb):
    tab = infra.table()
    rdr = infra.reader(rows=rows)
    base_costs, _ = infra.run(infra.port_trainer(_opt(), tab), rdr)
    tr = infra.port_trainer(_opt(), tab)
    costs, events = infra.run(tr, rdr, microbatch=mb)
    base = infra.port_trainer(_opt(), tab)
    infra.run(base, rdr)
    assert not infra.kinds(events, tpaddle.event.OOMEvent)
    np.testing.assert_allclose(costs, base_costs, rtol=RTOL, atol=ATOL)
    infra.assert_close(infra.port_params(tr), infra.port_params(base),
                       RTOL, ATOL)
    jtr = infra.jax_trainer(jpaddle.optimizer.Momentum(learning_rate=0.05),
                            tab)
    jcosts, _ = infra.run(jtr, rdr)
    np.testing.assert_allclose(costs, jcosts, rtol=JRTOL, atol=JATOL)
    infra.assert_close(infra.port_params(tr), infra.jax_params(jtr),
                       JRTOL, JATOL)


def test_accumulation_splits_sequence_feeds():
    """A ragged LSTM classifier (word ids, sequence feed) at microbatch
    2 of 6 rows (k 3) against its full-batch step."""
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import stacked_lstm_net

    def trainer():
        tpaddle.init(use_gpu=False, seed=0)
        reset_name_counters()
        spec = stacked_lstm_net(vocab_size=30, emb_size=8, hidden_size=8,
                                lstm_num=1, num_classes=2)
        params = tpaddle.create_parameters(tpaddle.Topology(spec.cost),
                                           device="cpu")
        return tpaddle.SGD(spec.cost, params,
                           tpaddle.optimizer.Adam(learning_rate=1e-2),
                           device="cpu")

    rng = np.random.RandomState(5)
    batches = [[(rng.randint(0, 30, (int(rng.randint(1, 9)),))
                 .astype(np.int32), int(rng.randint(0, 2)))
                for _ in range(6)] for _ in range(3)]
    base, acc = trainer(), trainer()
    bc, _ = infra.run(base, lambda: iter(batches))
    ac, _ = infra.run(acc, lambda: iter(batches), microbatch=2)
    np.testing.assert_allclose(ac, bc, rtol=RTOL, atol=ATOL)
    infra.assert_close(infra.port_params(acc), infra.port_params(base),
                       1e-4, 1e-5)


def test_composes_with_fault_policy():
    tab = infra.table()
    base = infra.port_trainer(_opt(), tab)
    bc, _ = infra.run(base, infra.reader())
    tr = infra.port_trainer(_opt(), tab)
    costs, _ = infra.run(tr, infra.reader(), microbatch=4,
                         fault_policy=FaultPolicy(max_bad_steps=3))
    np.testing.assert_allclose(costs, bc, rtol=RTOL, atol=ATOL)
    infra.assert_close(infra.port_params(tr), infra.port_params(base),
                       RTOL, ATOL)


def test_injected_oom_loses_no_sample():
    tab = infra.table()
    base = infra.port_trainer(_opt(), tab)
    bc, _ = infra.run(base, infra.reader())
    tr = infra.port_trainer(_opt(), tab)
    before = global_counters.value("trainer/oom_events")
    with infra.oom_at(tr, step=3, n=2) as stats:
        costs, events = infra.run(tr, infra.reader(), microbatch="auto")
    ooms = infra.kinds(events, tpaddle.event.OOMEvent)
    assert stats["injected"] == 2
    assert global_counters.value("trainer/oom_events") == before + 2
    assert [(e.kind, e.batch_id, e.microbatch, e.accum_steps)
            for e in ooms] == [("oom", 3, 4, 2), ("oom", 3, 2, 4)]
    assert len(costs) == 6
    np.testing.assert_allclose(costs, bc, rtol=RTOL, atol=ATOL)
    infra.assert_close(infra.port_params(tr), infra.port_params(base),
                       RTOL, ATOL)
    assert tr._memory_exec.plan.provenance == "adapted"


def test_oom_at_the_floor_reraises():
    tr = _trainer()
    with infra.memory_pressure(tr, max_rows=0):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            infra.run(tr, infra.reader(), microbatch="auto")


def test_non_oom_errors_pass_through():
    tr = _trainer()

    def bad(k, mb):
        raise ValueError("not an OOM")

    tr._step_interceptor = bad
    with pytest.raises(ValueError, match="not an OOM"):
        infra.run(tr, infra.reader(), microbatch="auto")


def test_oom_inside_the_update_is_not_bisected(monkeypatch):
    """An OOM after the update wrote a parameter cannot be retried on a
    smaller microbatch: the executor raises and says why."""
    tr = _trainer()
    real = tr.optimizer.update
    calls = [0]

    def update(params, *a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            with torch.no_grad():
                next(iter(params.values())).add_(1.0)
            raise resource_exhausted_error(where="inside the update")
        return real(params, *a, **kw)

    monkeypatch.setattr(tr.optimizer, "update", update)
    with pytest.raises(RuntimeError, match="inside the optimizer update"):
        infra.run(tr, infra.reader(), microbatch="auto")
    assert tr._memory_exec.oom_events == 1


def test_fixed_microbatch_under_pressure():
    tr = _trainer()
    with infra.memory_pressure(tr, max_rows=4) as stats:
        costs, events = infra.run(tr, infra.reader(), microbatch=4)
    assert not infra.kinds(events, tpaddle.event.OOMEvent)
    assert stats["injected"] == 0 and len(costs) == 6
    assert tr._memory_exec.plan.provenance == "configured"


def test_probe_under_pressure_and_mutating_nothing():
    tr = _trainer()
    with infra.memory_pressure(tr, max_rows=3):
        costs, events = infra.run(tr, infra.reader(), microbatch="auto",
                                  oom_probe=True)
    assert not infra.kinds(events, tpaddle.event.OOMEvent)
    assert len(costs) == 6
    plan = tr._memory_exec.plan
    assert plan.provenance == "probe" and plan.microbatch <= 3

    tr = _trainer()
    before = infra.port_params(tr)
    opt_before = {k: {n: v.clone() for n, v in s.items()}
                  for k, s in tr.opt_state["slots"].items()}
    batch = next(iter(infra.reader()()))
    with infra.memory_pressure(tr, max_rows=3):
        plan = plan_memory(tr, batch)
    assert plan.provenance == "probe" and plan.microbatch <= 3
    infra.assert_equal(infra.port_params(tr), before)
    assert tr.opt_state["step"] == 0 and tr._step_count == 0
    for k, s in opt_before.items():
        for n, v in s.items():
            assert torch.equal(tr.opt_state["slots"][k][n], v)
    assert plan_memory(_trainer(), batch).microbatch is None


def test_plan_rides_checkpoint_meta_and_resume_adopts(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tr = _trainer()
    with infra.memory_pressure(tr, max_rows=4):
        _, events = infra.run(tr, infra.reader(), microbatch="auto",
                              checkpoint_dir=ckpt, checkpoint_period=1)
    assert len(infra.kinds(events, tpaddle.event.OOMEvent)) == 1
    assert CheckpointManager(ckpt).peek_meta()["memory_plan"] == {
        "microbatch": 4, "accum_steps": 2, "provenance": "adapted"}
    tr2 = _trainer()
    fails = global_counters.value("trainer/oom_probe_failures")
    with infra.memory_pressure(tr2, max_rows=4):
        _, events = infra.run(tr2, infra.reader(), num_passes=2,
                              checkpoint_dir=ckpt, checkpoint_period=1,
                              auto_resume=True, microbatch="auto",
                              oom_probe=True)
    assert not infra.kinds(events, tpaddle.event.OOMEvent)
    assert tr2._memory_exec.plan.provenance == "resumed"
    assert tr2._memory_exec.plan.microbatch == 4
    assert global_counters.value("trainer/oom_probe_failures") == fails
