"""Port parity: the guarded train step (``SGD.train(fault_policy=)``,
paddle_tpu_torch/trainer/fault.py) against the JAX package's, on the
CPU — the port's counterparts of tests/test_faults.py's TestGuardedStep.

- Poisoned batches (NaN or inf features) leave the parameters, the
  optimizer's slots and counters and the layer state (batch norm's
  moving statistics) BIT-identical to the port's run that skipped those
  batches, and equal the JAX package's guarded run at rtol 1e-5 / atol
  1e-6 (Momentum 0.9 from one table; the same batches).
- ``fault_ok`` is 0.75 with 2 bad batches of 8, the pass cost finite.
- A streak of 3 rolls back to the newest checkpoint (one FaultEvent
  "rollback", at the batch the JAX package rolls back at), and a streak
  that ends between two host checks is still caught.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.trainer.fault import FaultPolicy as JFaultPolicy
from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
from paddle_tpu_torch.trainer.fault import FaultPolicy

import torch_train_infra as infra

RTOL, ATOL = 1e-5, 1e-6
BAD = (2, 5)

@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)



def _opts():
    return (jpaddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9),
            tpaddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9))


def _port_state(tr):
    """Every value the guard must leave as a skip leaves it."""
    out = {f"p/{k}": v for k, v in infra.port_params(tr).items()}
    for k, slots in tr.opt_state["slots"].items():
        for n, v in slots.items():
            out[f"slot/{k}/{n}"] = v.detach().numpy().copy()
    for k, v in tr.parameters.state.items():
        out[f"state/{k}"] = v.detach().numpy().copy()
    out["step"] = np.asarray(tr.opt_state["step"])
    out["num_samples"] = np.asarray(tr.opt_state["num_samples"])
    return out


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_bad_steps_match_the_skip_run_bit_for_bit(value):
    tab = infra.table(bn=True)
    _, topt = _opts()
    rdr = infra.reader(batches=8)
    tr = infra.port_trainer(topt, tab, bn=True)
    _, events = infra.run(tr, infra.poison(rdr, BAD, value),
                          fault_policy=FaultPolicy(max_bad_steps=3))
    skip = infra.port_trainer(_opts()[1], tab, bn=True)
    infra.run(skip, infra.skipping(rdr, BAD),
              fault_policy=FaultPolicy(max_bad_steps=3))
    got, want = _port_state(tr), _port_state(skip)
    assert any(k.startswith("state/") for k in got)
    infra.assert_equal(got, want)
    assert all(np.isfinite(v).all() for v in got.values())
    faults = infra.kinds(events, tpaddle.event.FaultEvent)
    assert [f.kind for f in faults] == ["nonfinite", "nonfinite"]
    done = infra.kinds(events, tpaddle.event.EndPass)[0]
    assert done.metrics["fault_ok"] == pytest.approx(0.75)
    assert np.isfinite(done.metrics["cost"])


def test_guarded_run_matches_jax():
    tab = infra.table()
    jopt, topt = _opts()
    rdr = infra.poison(infra.reader(batches=8), BAD)
    jtr = infra.jax_trainer(jopt, tab)
    jcosts, jev = infra.run(jtr, rdr,
                            fault_policy=JFaultPolicy(max_bad_steps=3))
    ttr = infra.port_trainer(topt, tab)
    tcosts, tev = infra.run(ttr, rdr,
                            fault_policy=FaultPolicy(max_bad_steps=3))
    infra.assert_close(infra.port_params(ttr), infra.jax_params(jtr),
                       RTOL, ATOL)
    good = [i for i in range(8) if i not in BAD]
    np.testing.assert_allclose(np.asarray(tcosts)[good],
                               np.asarray(jcosts)[good], rtol=RTOL)
    assert all(not np.isfinite(tcosts[i]) for i in BAD)
    jdone = infra.kinds(jev, jpaddle.event.EndPass)[0].metrics
    tdone = infra.kinds(tev, tpaddle.event.EndPass)[0].metrics
    assert tdone["fault_ok"] == jdone["fault_ok"] == pytest.approx(0.75)
    np.testing.assert_allclose(tdone["cost"], jdone["cost"], rtol=RTOL)
    assert ttr.opt_state["step"] == int(jtr.opt_state["step"]) == 6


def test_streak_rolls_back_like_jax(tmp_path):
    tab = infra.table()
    jopt, topt = _opts()
    rdr = infra.poison(infra.reader(batches=8), {3, 4, 5})
    jtr = infra.jax_trainer(jopt, tab)
    from paddle_tpu.trainer.checkpoint import CheckpointManager as JManager
    _, jev = infra.run(jtr, rdr, fault_policy=JFaultPolicy(max_bad_steps=3),
                       checkpoint_manager=JManager(str(tmp_path / "j")),
                       checkpoint_period=2)
    ttr = infra.port_trainer(topt, tab)
    _, tev = infra.run(ttr, rdr, fault_policy=FaultPolicy(max_bad_steps=3),
                       checkpoint_manager=CheckpointManager(
                           str(tmp_path / "t")),
                       checkpoint_period=2)
    jrb = [(e.kind, e.batch_id, e.bad_streak, e.restored_step)
           for e in infra.kinds(jev, jpaddle.event.FaultEvent)]
    trb = [(e.kind, e.batch_id, e.bad_streak, e.restored_step)
           for e in infra.kinds(tev, tpaddle.event.FaultEvent)]
    assert trb == jrb == [("rollback", 5, 3, 4)]
    infra.assert_close(infra.port_params(ttr), infra.jax_params(jtr),
                       RTOL, ATOL)
    for v in ttr.parameters.raw.values():
        assert torch.isfinite(v).all()


def test_streak_ending_between_checks_is_caught():
    _, topt = _opts()
    tr = infra.port_trainer(topt, infra.table())
    _, events = infra.run(
        tr, infra.poison(infra.reader(batches=8), {1, 2, 3}),
        fault_policy=FaultPolicy(max_bad_steps=3, check_period=4))
    faults = infra.kinds(events, tpaddle.event.FaultEvent)
    assert [(f.kind, f.batch_id, f.bad_streak) for f in faults] == \
        [("rollback", 3, 3)]
    # no checkpoint manager: nothing to restore, every bad update skipped
    assert faults[0].restored_step is None
    assert tr._bad_streak == [0, 0]


def test_guard_journals_fault_events_like_jax():
    """Each FaultEvent lands in the journal as the JAX package records
    it; with check_period 1 an ended streak below the limit is reported
    at the check after it too, as in the JAX package."""
    from paddle_tpu.obs import events as jevents
    from paddle_tpu_torch.obs import events as tevents
    jopt, topt = _opts()
    tab = infra.table()
    rdr = infra.poison(infra.reader(batches=4), {1})
    recs = []
    for ev_mod, tr, policy in (
            (jevents, infra.jax_trainer(jopt, tab), JFaultPolicy),
            (tevents, infra.port_trainer(topt, tab), FaultPolicy)):
        last = ev_mod.tail(1)
        seq = last[-1]["seq"] if last else 0
        infra.run(tr, rdr, fault_policy=policy(max_bad_steps=2,
                                               check_period=1))
        recs.append([(r["domain"], r["kind"], r["batch_id"],
                      r["bad_streak"], r.get("restored_step"))
                     for r in ev_mod.tail(50, domain="trainer",
                                          since_seq=seq)
                     if r["kind"] in ("nonfinite", "rollback")])
    assert recs[1] == recs[0] == [("trainer", "nonfinite", 1, 1, None),
                                  ("trainer", "nonfinite", 2, 1, None)]
