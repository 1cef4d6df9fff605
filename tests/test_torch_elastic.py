"""Port parity: the elastic fleet on the CPU — ``SGD.train``'s
coordinator mode (paddle_tpu_torch/trainer/trainer.py), ``model.py``,
``reader.creator.cloud_reader`` and ``cli.py coordinator``.

- The elastic ``SGD.train`` against the JAX package's on one weight
  table, one task schedule and one chunk set: per-step losses and the
  final parameters at rtol 1e-5 / atol 1e-6 (float32 Adam in two
  frameworks); a leave and a join at a pass boundary bit-identical to
  fixed membership within the port; the reshape hook; the MemoryPlan
  handed to a joiner.
- Phase 48's fleet (``chip_smoke.run_elastic_fleet``) at a narrow size
  in CPU worker processes: a SIGKILL and a join mid-pass with every
  record delivered exactly once, the plan adopted without a probe,
  one winner of the save election, and the digest run.
- ``model.save_model`` / ``load_model`` locally and under a
  coordinator's election; ``cloud_reader`` over shards from the port's
  ``convert`` (the same records as the JAX package's reader);
  ``cli.py coordinator`` as a subprocess.
- A mixed fleet both ways: the JAX package's unedited
  tests/elastic_worker.py against the port's CoordinatorServer, and a
  port worker against the JAX package's.
"""

import json
import os
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.obs.events import tail
from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
from paddle_tpu_torch.trainer.coordinator import (Coordinator,
                                                  CoordinatorServer,
                                                  connect)

import torch_train_infra as infra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
RECORDS_PER_CHUNK = 4
NET = dict(in_dim=16, hidden=8, classes=4)


@pytest.fixture(autouse=True)
def _port_state_restored():
    tobs.reset_all()
    yield
    tobs.reset_all()
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)


def _chunks(chunk):
    r = np.random.RandomState(1000 + int(chunk))
    return [(r.randn(16).astype("float32"), int(r.randint(4)))
            for _ in range(RECORDS_PER_CHUNK)]


def _elastic_run(tr, coord, worker_id, num_passes, mgr=None, **kw):
    losses = []

    def on_ev(e):
        if isinstance(e, tpaddle.event.EndIteration):
            losses.append(float(e.cost))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr.train(coordinator=coord, chunk_reader=_chunks, batch_size=4,
                 num_passes=num_passes, checkpoint_manager=mgr,
                 event_handler=on_ev, worker_id=worker_id, **kw)
    return losses


def _port(tab):
    return infra.port_trainer(tpaddle.optimizer.Adam(learning_rate=1e-2),
                              tab, **NET)


def test_elastic_train_matches_jax_trajectory():
    import paddle_tpu as jpaddle
    from paddle_tpu.trainer import coordinator as jcoord
    tab = infra.table(**NET)
    jtr = infra.jax_trainer(jpaddle.optimizer.Adam(learning_rate=1e-2),
                            tab, **NET)
    jlosses = []
    jtr.train(coordinator=jcoord.Coordinator(list(range(6)),
                                             chunks_per_task=1),
              chunk_reader=_chunks, batch_size=4, num_passes=2,
              worker_id="solo",
              event_handler=lambda e: jlosses.append(float(e.cost))
              if isinstance(e, jpaddle.event.EndIteration) else None)
    ttr = _port(tab)
    tlosses = _elastic_run(ttr, Coordinator(list(range(6)),
                                            chunks_per_task=1), "solo", 2)
    assert len(tlosses) == len(jlosses) == 12
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL, atol=ATOL)
    infra.assert_close(infra.port_params(ttr), infra.jax_params(jtr),
                       RTOL, ATOL)


def test_leave_join_at_pass_boundary_is_digest_identical(tmp_path):
    tab = infra.table(**NET)
    fixed = _elastic_run(_port(tab), Coordinator(list(range(4)),
                                                 chunks_per_task=1),
                         "solo", 2, CheckpointManager(str(tmp_path / "f")))
    coord = Coordinator(list(range(4)), chunks_per_task=1)
    ck = str(tmp_path / "e")
    elastic = _elastic_run(_port(tab), coord, "w1", 1, CheckpointManager(ck))
    assert len(elastic) == len(fixed) // 2
    elastic += _elastic_run(_port(tab), coord, "w2", 2, CheckpointManager(ck))
    assert elastic == fixed
    assert coord.generation >= 3        # w1 joined, left; w2 joined, left
    leaves = {r["worker_id"] for r in tail(200, domain="coordinator",
                                            kind="leave")}
    assert leaves == {"solo", "w1", "w2"}


def test_reshape_event_and_hook_on_a_mid_pass_join():
    """A worker joining at the second grant bumps the generation; the
    trainer's next grant shows it: a ``trainer/reshape`` record and one
    ``on_reshape`` call with the new generation."""
    from test_torch_coordinator import membership_script
    coord = Coordinator(list(range(4)), chunks_per_task=1)
    seen = []
    with membership_script(coord, {1: lambda: coord.join("late")}) as st:
        _elastic_run(_port(infra.table(**NET)), coord, "w1", 1,
                     on_reshape=seen.append)
    assert st["fired"] == [1]
    assert seen == [2]
    rec = tail(50, domain="trainer", kind="reshape")
    assert [(r["generation"], r["worker_id"]) for r in rec] == [(2, "w1")]


def test_join_adopts_published_plan_without_probe():
    c = Coordinator(list(range(4)), chunks_per_task=1)
    assert c.put_memory_plan({"microbatch": 2, "accum_steps": 2,
                              "provenance": "adapted"})
    tr = _port(infra.table(**NET))
    _elastic_run(tr, c, "replacement", 1, microbatch="auto",
                 oom_probe=True)
    plan = tr._memory_exec.plan
    assert plan.provenance == "adopted"
    assert plan.microbatch == 2 and plan.accum_steps == 2
    kinds = [r["kind"] for r in tail(300, domain="trainer")]
    assert "plan_adopted" in kinds and "oom" not in kinds


def test_worker_publishes_its_plan_for_the_next_joiner():
    c = Coordinator(list(range(4)), chunks_per_task=1)
    _elastic_run(_port(infra.table(**NET)), c, "w1", 1, microbatch=2)
    # a 4-row batch at 2-row microbatches: 2 accumulation steps
    assert c.memory_plan == {"microbatch": 2, "accum_steps": 2,
                             "provenance": "configured"}
    assert c.join("w2")["memory_plan"]["microbatch"] == 2


def test_fleet_kill_join_exactly_once_on_cpu(tmp_path):
    """chip_smoke's phase 48 fleet with the narrow net in CPU worker
    processes: w1 SIGKILLed at its STEP 2, w3 joining mid-pass, every
    record of the pass delivered exactly once (counted per chunk from
    the workers' logs), w3 on the adopted plan, one save-election
    winner, and the leave+join losses equal to fixed membership's."""
    sys.path.insert(0, REPO)
    import chip_smoke
    r = chip_smoke.run_elastic_fleet(str(tmp_path), narrow=True, timeout=300)
    assert r["stats"]["epoch"] == 1
    assert r["records"] == chip_smoke.ELASTIC_CHUNKS * chip_smoke.NARROW_ROWS
    assert r["accepted"]["w3"] > 0 and r["todo_at_kill"] > 0
    assert r["plan"]["provenance"] == "adopted"
    assert sorted(r["saved"].values()) == [False, True]
    assert all(x["device"] == "cpu" for x in r["results"].values())


# ------------------------------------------------------------ model.py
def _params(seed):
    tpaddle.init(use_gpu=False, seed=0)
    from paddle_tpu_torch.core.registry import reset_name_counters
    reset_name_counters()
    cost = infra.build(tpaddle, **NET)
    return tpaddle.create_parameters(tpaddle.Topology(cost),
                                     torch.Generator().manual_seed(seed))


def test_save_model_local_and_load_model(tmp_path, monkeypatch):
    from paddle_tpu import model as jmodel
    from paddle_tpu_torch import model
    monkeypatch.delenv("PADDLE_TPU_COORDINATOR", raising=False)
    src = _params(1)
    path = str(tmp_path / "a" / "b" / "m.tar")
    assert model.save_model(src, path) is True
    dst = _params(2)
    model.load_model(dst, path)
    for k in src.names():
        np.testing.assert_array_equal(dst[k], src[k])
    # the JAX package loads the port's tar into its own parameters
    import paddle_tpu as jpaddle
    from paddle_tpu.core.registry import reset_name_counters
    jpaddle.init(use_tpu=False, seed=0)
    reset_name_counters()
    jp = jpaddle.create_parameters(jpaddle.Topology(
        infra.build(jpaddle, **NET)))
    jmodel.load_model(jp, path)
    for k in src.names():
        np.testing.assert_array_equal(jp[k], src[k])


def test_save_model_election_one_writer(tmp_path, monkeypatch):
    from paddle_tpu_torch import model
    coord = Coordinator([0], chunks_per_task=1)
    srv = CoordinatorServer(coord).start()
    try:
        monkeypatch.setenv("PADDLE_TPU_COORDINATOR", f"127.0.0.1:{srv.port}")
        p = _params(1)
        won = []
        for tid in ("trainer-a", "trainer-b", "trainer-a"):
            monkeypatch.setattr(model, "trainer_id", tid)
            won.append(model.save_model(p, str(tmp_path)))
        # a wins, b is denied within the window, a is granted again
        assert won == [True, False, True]
        assert sorted(os.listdir(tmp_path)) == ["trainer-a"]
        dst = _params(2)
        model.load_model(dst, str(tmp_path / "trainer-a" / "model.tar"))
        for k in p.names():
            np.testing.assert_array_equal(dst[k], p[k])
        # one winner per epoch
        monkeypatch.setattr(model, "trainer_id", "trainer-b")
        assert model.save_model(p, str(tmp_path), epoch=3) is True
        monkeypatch.setattr(model, "trainer_id", "trainer-c")
        assert model.save_model(p, str(tmp_path), epoch=3) is False
    finally:
        srv.stop()


# ------------------------------------------------- cloud_reader, the CLI
def _shards(d, n=5, per=3):
    from paddle_tpu_torch.dataset import common
    rng = np.random.RandomState(7)
    samples = [(rng.randn(4).astype(np.float32), int(rng.randint(3)))
               for _ in range(n * per)]
    return common.convert(str(d), lambda: iter(samples), per, "cloud"), \
        samples


def _same(got, want):
    assert len(got) == len(want)
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert la == lb


def test_cloud_reader_over_converted_shards(tmp_path):
    import paddle_tpu as jpaddle
    from paddle_tpu_torch.reader import recordio as rio
    paths, samples = _shards(tmp_path)
    chunks = [list(d) for p in paths for d in rio.chunk_descriptors(p)]
    for creator in (tpaddle.reader.creator, jpaddle.reader.creator):
        srv = CoordinatorServer(Coordinator(chunks,
                                            chunks_per_task=2)).start()
        try:
            got = list(creator.cloud_reader("127.0.0.1", srv.port,
                                            timeout_sec=30.0)())
        finally:
            srv.stop()
        _same(got, samples)


def test_cli_coordinator_daemon(tmp_path):
    paths, samples = _shards(tmp_path / "data")
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "coordinator",
         "--data", str(tmp_path / "data" / "cloud-*"), "--port", "0",
         "--chunks_per_task", "2", "--task_timeout", "30",
         "--snapshot", str(tmp_path / "snap")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        start = json.loads(p.stdout.readline())
        assert start == {"job": "coordinator", "status": "serving",
                         "host": "127.0.0.1", "port": start["port"],
                         "files": 5, "chunks": 5, "chunks_per_task": 2,
                         "recovered": False, "generation": 0}
        got = list(tpaddle.reader.creator.cloud_reader(
            "127.0.0.1", start["port"], timeout_sec=30.0)())
        _same(got, samples)
        assert connect("127.0.0.1", start["port"]).epoch() == 1
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err
    stop = json.loads(out.strip().splitlines()[-1])
    assert stop["status"] == "stopped"
    assert stop["stats"]["epoch"] == 1 and stop["stats"]["grants"] == 3
    assert os.listdir(tmp_path / "snap") == ["coordinator_state"]


# ----------------------------------------------------------- mixed fleet
def test_jax_worker_against_port_coordinator(tmp_path):
    """The JAX package's unedited tests/elastic_worker.py (fc 8 -> 2,
    Momentum, 2 passes, checkpoint_period 1) against the port's
    CoordinatorServer, with elastic membership."""
    coord = Coordinator(list(range(4)), chunks_per_task=1, timeout_s=30.0)
    srv = CoordinatorServer(coord).start()
    try:
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tests", "elastic_worker.py"),
             str(srv.port), str(tmp_path / "ck"), "0", "jax-w"],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
    finally:
        srv.stop()
    assert r.returncode == 0, r.stderr[-3000:]
    assert "WORKER DONE steps=8" in r.stdout
    assert [ln.split()[1] for ln in r.stdout.splitlines()
            if ln.startswith("STEP ")] == ["0", "1", "2", "3"] * 2
    assert coord.epoch == 2 and coord.num_stale_grants() == 0
    assert coord.workers() == []
    joins = {x["worker_id"] for x in tail(100, domain="coordinator",
                                          kind="join")}
    assert joins == {"jax-w"}


def test_port_worker_against_jax_coordinator(tmp_path):
    """chip_smoke's elastic worker (narrow net, CPU) against the JAX
    package's CoordinatorServer over shards from the port's convert:
    one pass, every chunk read once, the worker's join and leave in the
    JAX journal."""
    from paddle_tpu.obs.events import tail as jtail
    from paddle_tpu.trainer import coordinator as jcoord
    sys.path.insert(0, REPO)
    import chip_smoke
    from paddle_tpu_torch.reader import recordio as rio
    paths = chip_smoke.elastic_shards(str(tmp_path / "shards"), 4,
                                      narrow=True)
    chunks = [list(d) for p in paths for d in rio.chunk_descriptors(p)]
    coord = jcoord.Coordinator(chunks, chunks_per_task=1, timeout_s=30.0)
    srv = jcoord.CoordinatorServer(coord).start()
    try:
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--elastic-worker", str(srv.port), "port-w", "--narrow",
             "--device", "cpu"], capture_output=True, text=True,
            timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    finally:
        srv.stop()
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    res = json.loads([ln for ln in lines
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert res["steps"] == 4 and res["device"] == "cpu"
    assert all(np.isfinite(float(c)) for c in res["losses"])
    read = sorted(ln.split()[-1] for ln in lines if ln.startswith("CHUNK "))
    assert read == [str(chip_smoke.NARROW_ROWS)] * 4
    assert coord.epoch == 1 and coord.workers() == []
    kinds = [(x["kind"], x["worker_id"]) for x in jtail(
        100, domain="coordinator") if x["kind"] in ("join", "leave")]
    assert kinds == [("join", "port-w"), ("leave", "port-w")]
