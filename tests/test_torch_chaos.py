"""The port's chaos harness (paddle_tpu_torch/testing/) against the JAX
package's, on the CPU.

- Engine families: the same ``decode_script`` (join, cancel, a forced
  eviction, shutdown at fixed engine steps), ``disconnect_after``,
  ``divergent_twins``, ``prefix_evict_storm``, ``cancel_mid_verify`` at
  spec_k 2, ``corrupt_spilled_page`` and ``kill_during_spill`` (read and
  commit) drive a JAX engine and a port engine built from one weight
  table: the requests a fault did not touch give identical tokens in
  both packages and equal solo runs of the port's decoder, both pools
  end with ``leaked == 0``, and the port's armed protocol witness saw
  no violation.
- Trainer families on the port trainer: ``oom_at`` (one
  ``trainer/oom`` record, the batch completed by the bisect),
  ``poison_batches`` under ``FaultPolicy`` (a ``trainer/nonfinite``
  record, parameters bit-equal to a run that skipped the batch),
  ``slow_step`` (``slo/step_regression`` attributed to ``compute``).
- Host-only families byte-identical to the JAX ones for a seed, and
  ``audit_exactly_once`` reports equal on the same journals.
- The checkpoint, lock, process and forward families on the port's
  own objects.

Tolerances: tokens and parameters exact; the engines' decoders agree
within rtol 1e-4 (tests/test_torch_decode.py), which keeps every
greedy token equal at these sizes.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu.testing import audit as jaudit
from paddle_tpu.testing.faults import FaultPlan as JaxFaultPlan
from paddle_tpu.testing.faults import WorkerCrash as JaxWorkerCrash
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.obs as tobs
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.testing import audit as taudit
from paddle_tpu_torch.testing.faults import FaultPlan, WorkerCrash
from tests import torch_train_infra as infra
from tests.test_torch_two_tier import _pair, assert_pool_balanced

MAX_LEN = 32


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    # every scenario here leaves the port's witness clean
    assert tobs.WITNESS.violations() == []
    tobs.reset_all()


@pytest.fixture(autouse=True)
def _port_device_restored():
    yield
    tpaddle.init(seed=0)


@pytest.fixture(scope="module")
def decoders():
    return _pair()


def _engines(decoders, **kw):
    """(package name, engine, its FaultPlan class) for each package."""
    jdec, tdec = decoders
    base = dict(num_slots=2, page_size=4, max_seq_len=MAX_LEN)
    base.update(kw)
    out = []
    for name, cls, dec, plan in (("jax", JaxEngine, jdec, JaxFaultPlan),
                                 ("port", DecodeEngine, tdec, FaultPlan)):
        extra = {}
        if kw.get("spec_k"):
            extra["draft"] = dec
        out.append((name, cls(dec, **base, **extra), plan))
    return out


def _solo(tdec, prompt, n):
    p = np.asarray(prompt, "int32")
    return [int(t) for t in tdec.generate(p[None, :], max_len=len(p) + n)[0]]


def _slot_of(eng, req):
    return next(s for s, sl in enumerate(eng.slots)
                if sl is not None and sl.req is req)


# ------------------------------------------------------------ engine chaos
def _script(eng, plan):
    """Join, cancel, a forced eviction, a late join and a shutdown
    (drain=False) at fixed steps."""
    rng = np.random.RandomState(0)
    ps = [rng.randint(0, 40, (n,)).astype("int32") for n in (4, 6, 5, 7)]
    r0 = eng.submit(ps[0], 14)
    joined = {}
    acts = {
        2: lambda: joined.setdefault("a", eng.submit(ps[1], 8)),
        4: lambda: joined.setdefault("b", eng.submit(ps[2], 7)),
        6: r0.cancel,
        7: lambda: eng._evict(_slot_of(eng, joined["a"])),
        9: lambda: joined.setdefault("late", eng.submit(ps[3], 20)),
        24: lambda: eng.shutdown(drain=False),
    }
    with plan.decode_script(eng, acts) as st:
        eng.run(timeout=300)
    assert st["fired"] == sorted(acts)
    assert r0.state == "cancelled" and 0 < r0.num_generated < 14
    assert joined["a"].evictions == 1
    assert joined["late"].state == "failed"
    out = {"cancelled": (r0.state, r0.tokens)}
    for key, p, n in (("a", ps[1], 8), ("b", ps[2], 7), ("late", ps[3], 20)):
        req = joined[key]
        if req.state == "done":
            out[key] = (p, n, req.get(timeout=1))
        else:       # shut down mid-generation: its partial tokens
            out[f"cancelled_{key}"] = (req.state, req.tokens)
    assert "a" in out and "b" in out
    return out


def _disconnect(eng, plan):
    rng = np.random.RandomState(2)
    pa = rng.randint(0, 40, (4,)).astype("int32")
    pb = rng.randint(0, 40, (5,)).astype("int32")
    eng.start()
    try:
        ra = eng.submit(pa, 20)
        rb = eng.submit(pb, 10)
        killer = plan.disconnect_after(ra, 4)
        got = rb.get(timeout=120)
        killer.join(60)
        assert not killer.is_alive()
        ra.done.wait(60)
        assert ra.state == "cancelled" and ra.num_generated >= 4
    finally:
        eng.shutdown(drain=True, timeout=60)
    return {"b": (pb, 10, got)}


def _twins(eng, plan):
    twins = plan(seed=21).divergent_twins(eng, max_new=4, pairs=2, vocab=40)
    eng.run(timeout=300)
    st = eng.stats()
    assert st["prefix_hit_pages"] >= 1 and st["prefix_cow_copies"] >= 1
    return {f"t{i}": (p, 4, r.get(timeout=1))
            for i, (r, p) in enumerate(twins)}


def _evict_storm(eng, plan):
    schedule, submitted = plan(seed=22).prefix_evict_storm(
        eng, waves=4, per_wave=2, gap=3, prompt_len=8, max_new=3,
        vocab=40)
    with plan.decode_script(eng, schedule) as st:
        eng.run(timeout=300)
    assert st["fired"] == sorted(schedule)
    assert eng.stats()["prefix_evicted_pages"] >= 1
    return {f"s{i}": (p, 3, r.get(timeout=1))
            for i, (r, p) in enumerate(submitted)}


def _mid_verify(eng, plan):
    rng = np.random.RandomState(23)
    shared = [int(t) for t in rng.randint(0, 40, 6)]
    victim = eng.submit(shared + [int(t) for t in rng.randint(0, 40, 3)],
                        12)
    surv_p = shared + [int(t) for t in rng.randint(0, 40, 3)]
    surv = eng.submit(surv_p, 8)
    with plan.decode_script(eng, plan.cancel_mid_verify(victim, at=2)) \
            as st:
        eng.run(timeout=300)
    assert st["fired"] == [2] and victim.state == "cancelled"
    s = eng.stats()
    assert s["spec_proposed_tokens"] > 0 and s["spec_accepted_tokens"] > 0
    return {"survivor": (surv_p, 8, surv.get(timeout=1)),
            "cancelled": victim.tokens}


def _corrupt_spill(eng, plan):
    schedule, submitted = plan(seed=33).spill_storm(
        eng, waves=5, per_wave=2, gap=4, prompt_len=8, max_new=3,
        vocab=40, revisit_from=2)
    fp = plan(seed=5)
    corrupted = []

    def corrupt_once():
        # bit-rot one host entry at the first step the store holds one
        if not corrupted and len(eng.spill):
            corrupted.append(fp.corrupt_spilled_page(eng))

    acts = {i: (lambda f=schedule.get(i): (f and f(), corrupt_once()))
            for i in range(64)}
    with plan.decode_script(eng, acts):
        eng.run(timeout=300)
    assert corrupted and corrupted[0] is not None
    assert eng.page_accounting()["spill_puts"] >= 1
    out = {f"s{i}": (p, 3, r.get(timeout=1))
           for i, (r, p) in enumerate(submitted)}
    out["cancelled"] = eng.stats()["kv_spill_integrity_drops"]
    return out


def _kill_spill(stage):
    def scenario(eng, plan):
        crash = WorkerCrash if plan is FaultPlan else JaxWorkerCrash
        schedule, submitted = plan(seed=34).spill_storm(
            eng, waves=4, per_wave=2, gap=4, prompt_len=8, max_new=3,
            vocab=40, revisit_from=4)
        with plan.decode_script(eng, schedule):
            with plan.kill_during_spill(eng, at=0, stage=stage) as ks:
                with pytest.raises(crash):
                    eng.run(timeout=300)
        assert ks["fired"] == 1
        acc = eng.page_accounting()
        assert acc["leaked"] == 0
        assert tuple(ks["path"]) not in eng.spill._entries
        eng.run(timeout=300)
        return {f"s{i}": (p, 3, r.get(timeout=1))
                for i, (r, p) in enumerate(submitted)}
    return scenario


SCENARIOS = {
    "decode_script": (_script, {}),
    "disconnect_after": (_disconnect, {}),
    "divergent_twins": (_twins, {}),
    "prefix_evict_storm": (_evict_storm, dict(max_seq_len=20,
                                              num_pages=9)),
    "cancel_mid_verify": (_mid_verify, dict(spec_k=2)),
    "corrupt_spilled_page": (_corrupt_spill, dict(max_seq_len=20,
                                                  num_pages=9,
                                                  kv_spill_pages=8)),
    "kill_during_spill_read": (_kill_spill("read"), dict(
        max_seq_len=20, num_pages=9, kv_spill_pages=8)),
    "kill_during_spill_commit": (_kill_spill("commit"), dict(
        max_seq_len=20, num_pages=9, kv_spill_pages=8)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_fault_matches_jax(decoders, name):
    fn, kw = SCENARIOS[name]
    out = {}
    for pkg, eng, plan in _engines(decoders, **kw):
        out[pkg] = fn(eng, plan)
        acc = eng.page_accounting()
        assert acc["leaked"] == 0, pkg
        if pkg == "port":
            assert_pool_balanced(eng)
    tdec = decoders[1]
    for pkg in out:     # prompts as lists: numpy arrays compare per item
        out[pkg] = {k: (list(map(int, v[0])),) + tuple(v[1:])
                    if isinstance(v, tuple) and len(v) == 3 else v
                    for k, v in out[pkg].items()}
    if name == "disconnect_after":
        # the cancel lands on another thread: only the survivor is
        # deterministic
        assert out["port"]["b"] == out["jax"]["b"]
    else:
        assert out["port"] == out["jax"]
    for key, val in out["port"].items():
        if not key.startswith("cancelled"):
            prompt, n, got = val
            assert got == _solo(tdec, prompt, n), key
    assert tobs.WITNESS.violation_count == 0


def test_slow_phase_books_the_engine_phase(decoders):
    """``slow_phase`` on the port engine: the decode step's sleeping
    proxy, and any other phase under its serving/<phase> timer."""
    from paddle_tpu_torch.utils.stats import global_stat
    (_, _, _), (_, eng, plan) = _engines(decoders)
    eng.submit([1, 2, 3], 6)
    with plan.slow_phase(eng, "decode_step", ms=5.0, at=1, n=2) as st, \
            plan.slow_phase(eng, "admit", ms=1.0, at=0, n=1) as st2:
        eng.run(timeout=120)
    assert st["injected"] == 2 and st2["injected"] == 1
    assert "serving/admit" in dict(global_stat.items())


# ----------------------------------------------------------- trainer chaos
def test_oom_at_bisects_and_journals_one_oom():
    tab = infra.table()
    tr = infra.port_trainer(tpaddle.optimizer.Adam(learning_rate=1e-2), tab)
    with FaultPlan.oom_at(tr, step=2, n=1) as st:
        costs, _ = infra.run(tr, infra.reader(), microbatch="auto")
    assert st["injected"] == 1 and len(costs) == 6
    ooms = tobs.JOURNAL.tail(50, domain="trainer", kind="oom")
    assert len(ooms) == 1 and ooms[0]["microbatch"] == 4


def test_memory_pressure_converges_under_the_cap():
    tab = infra.table()
    tr = infra.port_trainer(tpaddle.optimizer.Adam(learning_rate=1e-2), tab)
    with FaultPlan.memory_pressure(tr, max_rows=2) as st:
        costs, _ = infra.run(tr, infra.reader(), microbatch="auto")
    assert st["injected"] >= 2 and len(costs) == 6
    assert tr._memory_exec.plan.microbatch <= 2


def test_poison_batches_skipped_and_journaled():
    from paddle_tpu_torch.trainer.fault import FaultPolicy
    opt = lambda: tpaddle.optimizer.Adam(learning_rate=1e-2)  # noqa: E731
    tab = infra.table()
    bad = infra.port_trainer(opt(), tab)
    rdr = FaultPlan(seed=0).poison_batches(infra.reader(), [3])
    infra.run(bad, rdr, fault_policy=FaultPolicy(max_bad_steps=3,
                                                 check_period=1))
    ref = infra.port_trainer(opt(), tab)
    infra.run(ref, infra.skipping(infra.reader(), [3]))
    infra.assert_equal(infra.port_params(bad), infra.port_params(ref))
    recs = tobs.JOURNAL.tail(50, domain="trainer", kind="nonfinite")
    assert recs and recs[0]["batch_id"] == 3
    assert all(r["bad_streak"] == 1 for r in recs)


def test_slow_step_regression_attributed_to_compute(tmp_path):
    from paddle_tpu_torch.obs import FLIGHT, PROFILER, WATCHDOG
    FLIGHT.configure(dump_dir=str(tmp_path), min_dump_interval=0)
    PROFILER.enable(sample_every=1)
    WATCHDOG.configure(regression_factor=3.0, regression_steps=2,
                       min_samples=4, cooldown_s=0.0)
    tr = infra.port_trainer(tpaddle.optimizer.Adam(learning_rate=1e-2),
                            infra.table())
    try:
        with FaultPlan.slow_step(tr, step=10, factor=5.0, n=4) as st:
            infra.run(tr, infra.reader(batches=24), microbatch="auto")
    finally:
        PROFILER.disable()
        FLIGHT.configure(dump_dir=None)
    assert st["injected"] == 4 and st["slept_ms"] > 0
    regs = [r for r in tobs.JOURNAL.tail(200, domain="slo",
                                         kind="step_regression")
            if r["step_kind"] == "train"]
    assert regs and regs[-1]["phase"] == "compute"
    assert regs[-1]["factor"] >= 3.0


# -------------------------------------------------------- host-only families
@pytest.mark.parametrize("seed", [0, 7])
def test_host_families_byte_identical_to_jax(seed):
    recs = [bytes([i]) * (5 + i) for i in range(10)]
    assert list(FaultPlan(seed=seed).corrupt_records(recs, [0, 6])) == \
        list(JaxFaultPlan(seed=seed).corrupt_records(recs, [0, 6]))
    kw = dict(ticks=40, base=2, peak=15, burst_start=5, burst_len=10)
    assert FaultPlan.bursty_trace(seed, **kw) == \
        JaxFaultPlan.bursty_trace(seed, **kw)
    res, errs = FaultPlan.burst(lambda i: i * i if i % 3 else 1 // 0, 9)
    assert res == [None, 1, 4, None, 16, 25, None, 49, 64]
    assert [type(e).__name__ if e else None for e in errs].count(
        "ZeroDivisionError") == 3


def test_data_and_coordinator_families():
    hang = threading.Event()
    plan = FaultPlan()
    rdr = FaultPlan.hung_reader(lambda: iter(range(4)), release={2: hang})
    hang.set()
    assert list(rdr()) == [0, 1, 2, 3]
    m = plan.raising_mapper(lambda v: v, at=[1])
    with pytest.raises(ValueError):
        [m(v) for v in range(3)]
    c = plan.crashing_mapper(lambda v: v, at=[0])
    with pytest.raises(WorkerCrash):
        c(0)
    assert c(1) == 1

    class Target:
        def ping(self, x):
            return x

    flaky = plan.flaky_coordinator(Target(), drop={"ping": [1]})
    assert flaky.ping(3) == 3
    with pytest.raises(ConnectionError):
        flaky.ping(4)
    holder = type("Holder", (), {"coordinator": Target()})()
    with FaultPlan.coordinator_outage(holder):
        with pytest.raises(OSError):
            holder.coordinator.ping(1)
    assert holder.coordinator.ping(2) == 2


# ------------------------------------------------------------------- audit
def _settles(path, tids, pid):
    with open(path, "w") as f:
        for i, t in enumerate(tids):
            f.write(json.dumps({"v": 1, "ts": 100.0 + i * 0.5 + pid * 0.1,
                                "seq": i + 1, "pid": pid, "domain": "fleet",
                                "kind": "settle", "trace_id": t,
                                "host": f"h{pid}"}) + "\n")


def test_audit_reports_equal_jax(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _settles(a, ["t1", "t2", "t3", "t2"], 1)
    _settles(b, ["t4", "stray", "t1"], 2)
    expected = ["t1", "t2", "t3", "t4", "t5"]
    for journals in (a, [a, b], taudit._load_records([a, b])):
        got = taudit.audit_exactly_once(journals, expected)
        assert got == jaudit.audit_exactly_once(journals, expected)
    rep = taudit.audit_exactly_once([a, b], expected)
    assert rep["duplicates"] == {"t1": 2, "t2": 2} and rep["lost"] == ["t5"]
    assert rep["strays"] == ["stray"] and not rep["ok"]
    assert taudit._load_records([a, b]) == jaudit._load_records([a, b])
    with pytest.raises(AssertionError, match="exactly-once violated"):
        taudit.assert_exactly_once([a, b], expected)
    ok = taudit.assert_exactly_once(b, ["t4", "t1"])
    assert ok == jaudit.assert_exactly_once(b, ["t4", "t1"])

    class Shard:
        def __init__(self, seqs):
            self.seqs = seqs

        def applied_seqs(self):
            return self.seqs

    taudit.assert_exactly_once_applied({0: Shard({"c": 3})}, {0: {"c": 3}},
                                       dup_acks=1, min_dup_acks=1)
    with pytest.raises(AssertionError, match="diverged"):
        taudit.assert_exactly_once_applied({0: Shard({"c": 4})},
                                           {0: {"c": 3}})


# ------------------------------------------- checkpoints, locks, processes
def test_checkpoint_families_match_jax(tmp_path):
    """checkpoint_write_failure (ENOSPC, a torn write) and
    corrupt_newest_checkpoint on the port's CheckpointManager: the
    previous checkpoint stays the newest intact one, as the JAX
    package's families leave its manager."""
    import torch

    from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    w = {"w": torch.arange(256, dtype=torch.float32).reshape(16, 16)}
    mgr.save(1, w)
    with FaultPlan().checkpoint_write_failure(at_save=0, at_byte=128) as n:
        with pytest.raises(OSError):
            mgr.save(2, w)
    assert n == [1]
    torn = tmp_path / "ckpt-0000000002.tmp" / "state.npz"
    assert torn.exists() and torn.stat().st_size <= 128
    with FaultPlan().checkpoint_write_failure(at_save=1):
        mgr.save(3, w)
        with pytest.raises(OSError):
            mgr.save(4, w)
    assert mgr.latest_step() == 3
    assert FaultPlan.corrupt_newest_checkpoint(str(tmp_path)) == 3
    assert mgr.latest_step() == 1
    step, tree = mgr.restore()
    assert step == 1
    np.testing.assert_array_equal(tree["params"]["w"], w["w"].numpy())
    with pytest.raises(FileNotFoundError):
        FaultPlan.corrupt_newest_checkpoint(str(tmp_path / "none"))


def test_hold_lock_books_contention():
    """hold_lock squats on a named lockdep lock from a step seam: a
    thread taking it meanwhile waits the hold and is booked as a
    contention."""
    from paddle_tpu_torch.analysis.lockdep import LOCKDEP
    from paddle_tpu_torch.obs import JOURNAL

    class Target:
        _step_interceptor = None

    t = Target()
    with pytest.raises(KeyError):
        with FaultPlan.hold_lock(t, "no.such.lock"):
            pass
    waited = []

    def contend():
        time.sleep(0.05)        # the hold has begun
        t0 = time.perf_counter()
        JOURNAL.emit("obs", "selfcheck", probe=1)     # takes obs.journal
        waited.append(time.perf_counter() - t0)

    with FaultPlan.hold_lock(t, "obs.journal", at=1, ms=200.0) as st:
        t._step_interceptor(0)
        th = threading.Thread(target=contend, name="pt-test-contend")
        th.start()
        t._step_interceptor(1)
        th.join(5)
    assert not th.is_alive() and st["injected"] == 1
    assert st["held_ms"] >= 200.0 and waited[0] >= 0.1
    assert LOCKDEP.metrics_snapshot()["contentions"].get("obs.journal", 0) \
        >= 1


def test_kill_at_marker_and_flaky_forward():
    """kill_at_marker SIGKILLs a process at its STEP marker (as JAX's);
    flaky_forward fails, delays and hangs chosen Inference.forward_batch
    calls of the port."""
    import signal
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-c", "import time\nfor i in range(100):\n"
         "    print(f'STEP {i}', flush=True); time.sleep(0.05)"],
        stdout=subprocess.PIPE, text=True)
    try:
        assert FaultPlan.kill_at_marker(proc, 3, timeout=60) == 3
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
        proc.stdout.close()
    assert proc.returncode == -signal.SIGKILL

    class Inf:
        def forward_batch(self, samples, feeding=None):
            return [len(samples)]

    inf = Inf()
    release = threading.Event()
    with FaultPlan(seed=3).flaky_forward(inf, fail=[1], delay={2: 0.05},
                                         hang={3: release}) as st:
        assert inf.forward_batch([0]) == [1]
        with pytest.raises(RuntimeError, match="call #1"):
            inf.forward_batch([0])
        t0 = time.perf_counter()
        assert inf.forward_batch([0, 1]) == [2]
        assert time.perf_counter() - t0 >= 0.05
        opener = threading.Thread(
            target=lambda: (time.sleep(0.05), release.set()),
            name="pt-test-release")
        opener.start()
        assert inf.forward_batch([0]) == [1]
        opener.join(5)
    assert st == {"injected": 3, "calls": 4}
    assert "forward_batch" not in vars(inf)        # the seam is restored
