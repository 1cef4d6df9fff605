"""The port CLI's obs commands against the JAX CLI's, on the CPU:
``events tail`` (with ``--follow``), ``obs catalog``, ``obs selfcheck``,
``obs dump``, ``trace merge``, and ``train --metrics_port 0`` serving
its endpoint for the whole run (scraped from a subprocess trainer).

Where the output is deterministic (``events tail``, ``obs catalog``,
``trace merge``) the port prints byte for byte what the JAX CLI prints;
``obs selfcheck`` and the ``--metrics_port`` line agree on every key.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request

import pytest

import paddle_tpu_torch.obs as tobs
from paddle_tpu import cli as jcli
from paddle_tpu_torch import cli as tcli
from tests.test_torch_obs_plane import _journal, _trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


def _out(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _both(argv, capsys):
    got = _out(tcli.main, argv, capsys)
    want = _out(jcli.main, argv, capsys)
    return got, want


@pytest.fixture
def journal(tmp_path):
    p = str(tmp_path / "events.jsonl")
    _journal(p, "hostA", 11, seed=3, n=20, sync=0.5)
    return p


@pytest.mark.parametrize("flags", [
    [], ["-n", "3"], ["--domain", "engine"], ["--kind", "oom", "-n", "50"],
    ["--domain", "coordinator", "--kind", "clock_sync"]])
def test_events_tail_equals_jax(journal, capsys, flags):
    got, want = _both(["events", "tail", "--log", journal] + flags, capsys)
    assert got == want and got[0] == 0


def test_events_tail_follow_streams_appended_records(journal, capsys):
    """--follow prints the tail, then the records appended while it
    follows, and exits after --exit-after-idle seconds without one."""
    outs = []
    for main in (tcli.main, jcli.main):
        def append(path=journal):
            time.sleep(0.4)
            with open(path, "a") as f:
                f.write("\n" + json.dumps(
                    {"v": 1, "ts": 2000.0, "seq": 99, "pid": 1,
                     "domain": "engine", "kind": "late"}) + "\n")
        t = threading.Thread(target=append, name="pt-test-append")
        t.start()
        rc = main(["events", "tail", "--log", journal, "-n", "2",
                   "--follow", "--exit-after-idle", "1.5"])
        t.join()
        outs.append((rc, capsys.readouterr().out))
        with open(journal) as f:        # drop the appended record again
            lines = [ln for ln in f.read().splitlines()
                     if '"late"' not in ln and ln.strip()]
        with open(journal, "w") as f:
            f.write("\n".join(lines))
    assert outs[0] == outs[1]
    printed = [json.loads(ln) for ln in outs[0][1].splitlines()]
    assert len(printed) == 3 and printed[-1]["kind"] == "late"
    with pytest.raises(SystemExit):
        tcli.main(["events", "tail", "--log", journal + ".missing"])


def test_obs_catalog_equals_jax(capsys):
    got, want = _both(["obs", "catalog"], capsys)
    assert got == want and got[0] == 0
    assert set(json.loads(got[1])) == {"v", "journals", "metrics",
                                       "metric_prefixes", "protocols",
                                       "fault_families"}


def test_obs_selfcheck_matches_jax(capsys):
    got, want = _both(["obs", "selfcheck"], capsys)
    g, w = json.loads(got[1]), json.loads(want[1])
    assert got[0] == want[0] == 0
    assert g == w and g["status"] == "ok"


def test_obs_dump_local_and_remote(tmp_path, capsys):
    rc, out = _out(tcli.main, ["obs", "dump", "--out",
                               str(tmp_path / "local.json")], capsys)
    rec = json.loads(out)
    assert rc == 0 and rec["status"] == "ok"
    with open(rec["out"]) as f:
        assert json.load(f)["v"] == 1
    tobs.emit("trainer", "run_start", job="x", config="y")
    srv = tobs.start_obs_server()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        out_path = str(tmp_path / "remote.json")
        rc, out = _out(tcli.main, ["obs", "dump", "--url", url, "--out",
                                   out_path], capsys)
    finally:
        srv.shutdown()
    rec = json.loads(out)
    assert rc == 0 and rec["source"] == url and rec["out"] == out_path
    with open(out_path) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "http"
    assert bundle["journal"]["tail"][-1]["kind"] == "run_start"


def test_trace_merge_equals_jax(tmp_path, capsys):
    js, ts = [], []
    for k, (host, pid) in enumerate([("hostA", 11), ("hostB", 11)]):
        js.append(str(tmp_path / f"j{k}.jsonl"))
        _journal(js[-1], host, pid, seed=k, sync=0.25 if k else None)
        ts.append(str(tmp_path / f"t{k}.json"))
        _trace(ts[-1], host, pid, seed=k)
    outs = []
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        oj = str(tmp_path / f"{name}.jsonl")
        ot = str(tmp_path / f"{name}.json")
        rc, out = _out(main, ["trace", "merge", "--journal", *js, "--trace",
                              *ts, "--out-journal", oj, "--out-trace", ot,
                              "--offset", "hostA=1.5"], capsys)
        line = json.loads(out)
        line.pop("out_journal"), line.pop("out_trace")
        with open(oj) as f1, open(ot) as f2:
            outs.append((rc, line, f1.read(), f2.read()))
    assert outs[0] == outs[1]
    assert outs[0][1]["records"] == 24 and outs[0][1]["hosts"] == [
        "hostA", "hostB"]
    merged = [json.loads(ln) for ln in outs[0][2].splitlines()]
    assert [r["mseq"] for r in merged] == list(range(1, 25))


CONFIG = textwrap.dedent("""\
    import time
    import numpy as np
    import {pkg} as paddle
    x = paddle.layer.data("x", paddle.data_type.dense_vector(8))
    y = paddle.layer.data("y", paddle.data_type.integer_value(2))
    out = paddle.layer.fc(x, size=2, act=paddle.activation.Softmax(),
                          name="out")
    cost = paddle.layer.classification_cost(out, y, name="cost")
    optimizer = paddle.optimizer.Adam(learning_rate=0.02)

    def train_reader():
        rng = np.random.RandomState(0)
        for _ in range({batches}):
            time.sleep({delay})
            f = rng.randn(4, 8).astype("float32")
            yield [(f[i], int(rng.randint(0, 2))) for i in range(4)]

    num_passes = 1
    """)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def test_train_metrics_port_serves_the_whole_run(tmp_path, capsys):
    """``train --metrics_port 0`` in a subprocess: the serving line
    first, every endpoint answers while it trains, the journal's
    run_start is on /events, and the server is gone after the run. The
    JAX CLI's line has the same keys."""
    cfg = tmp_path / "cfg.py"
    cfg.write_text(CONFIG.format(pkg="paddle_tpu_torch", batches=12,
                                 delay=0.25))
    log = str(tmp_path / "ev.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "train",
         "--use_tpu=false", "--config", str(cfg), "--metrics_port", "0",
         "--event_log", log, "--log_period", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = json.loads(proc.stdout.readline())
        port = line["metrics_port"]
        assert line == {"job": "obs", "status": "serving",
                        "metrics_port": port} and port > 0
        assert _get(port, "/health") == (200, '{"status": "ok"}')
        code, text = _get(port, "/metrics")
        assert code == 200 and "# TYPE" in text
        code, body = _get(port, "/events?since_seq=0")
        kinds = [r["kind"] for r in json.loads(body)["events"]]
        assert code == 200 and kinds[0] == "run_start"
        for path in ("/flight", "/profile"):
            assert _get(port, path)[0] == 200
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    with pytest.raises(OSError):
        _get(port, "/health")
    with open(log) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["kind"] for r in recs if r["domain"] == "trainer"][-1] == \
        "run_end"
    # the JAX CLI's serving line, in this process
    jcfg = tmp_path / "jcfg.py"
    jcfg.write_text(CONFIG.format(pkg="paddle_tpu", batches=1, delay=0.0))
    rc = jcli.main(["train", "--config", str(jcfg), "--metrics_port", "0"])
    jline = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rc == 0 and set(jline) == set(line)
    assert {k: v for k, v in jline.items() if k != "metrics_port"} == \
        {k: v for k, v in line.items() if k != "metrics_port"}
