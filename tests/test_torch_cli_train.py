"""``python -m paddle_tpu_torch.cli train`` on the CPU: each job
(train, time, test, checkgrad, dump_config, profile) on a tiny config,
the training-infrastructure flags reaching ``SGD.train``, the journal,
and a subprocess trainer SIGKILLed mid-run and relaunched with
``--auto_resume`` ending with the parameters of an uninterrupted run
(bit for bit: the same CPU ops in the same order).
"""

import io
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = textwrap.dedent("""\
    import time
    import numpy as np
    import paddle_tpu_torch as paddle
    x = paddle.layer.data("x", paddle.data_type.dense_vector(8))
    y = paddle.layer.data("y", paddle.data_type.integer_value(2))
    h = paddle.layer.fc(x, size=6, act=paddle.activation.Relu())
    out = paddle.layer.fc(h, size=2, act=paddle.activation.Softmax(),
                          name="out")
    cost = paddle.layer.classification_cost(out, y, name="cost")
    extra_layers = [paddle.layer.classification_error(out, y,
                                                      name="error")]
    optimizer = paddle.optimizer.Adam(learning_rate=0.02)
    DELAY = {delay}

    def train_reader():
        rng = np.random.RandomState(0)
        for _ in range(6):
            if DELAY:
                time.sleep(DELAY)
            f = rng.randn(4, 8).astype("float32")
            yield [(f[i], int(rng.randint(0, 2))) for i in range(4)]

    test_reader = train_reader
    num_passes = 1
    """)

@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)



def _config(tmp_path, delay=0.0):
    p = tmp_path / f"cfg_{str(delay).replace('.', '_')}.py"
    p.write_text(CONFIG.format(delay=delay))
    return str(p)


def _main(args, capsys):
    rc = cli.main(["train", "--use_tpu=false"] + args)
    return rc, capsys.readouterr()


def _json_lines(out):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def test_train_job_with_every_infrastructure_flag(tmp_path, capsys):
    cfg = _config(tmp_path)
    ckpt, save = tmp_path / "ckpt", tmp_path / "save"
    rc, cap = _main(["--config", cfg, "--num_passes", "2",
                     "--log_period", "2", "--save_dir", str(save),
                     "--checkpoint_dir", str(ckpt),
                     "--checkpoint_period", "2", "--auto_resume",
                     "--fault_max_bad_steps", "2", "--microbatch", "2",
                     "--data_prefetch", "2", "--data_sample_timeout", "5",
                     "--data_max_bad", "3",
                     "--event_log", str(tmp_path / "j.jsonl")], capsys)
    assert rc == 0
    assert "Pass 1 done." in cap.out and "fault_ok=1" in cap.out
    assert "Test: cost=" in cap.out
    assert (save / "pass-00001" / "params.tar").exists()
    from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
    meta = CheckpointManager(str(ckpt)).peek_meta()
    assert meta["pass_count"] == 2 and meta["step_count"] == 12
    assert meta["memory_plan"]["microbatch"] == 2
    kinds = [json.loads(l)["kind"] for l in
             (tmp_path / "j.jsonl").read_text().splitlines()]
    assert kinds[0] == "run_start" and "save" in kinds


def test_flags_reach_sgd_train(tmp_path, capsys, monkeypatch):
    captured = {}

    def fake_train(self, reader=None, **kw):
        captured.update(kw)

    monkeypatch.setattr(tpaddle.SGD, "train", fake_train)
    cfg = _config(tmp_path)
    assert _main(["--config", cfg, "--microbatch", "auto", "--oom_probe",
                  "--fault_max_bad_steps", "4"], capsys)[0] == 0
    assert captured["microbatch"] == "auto" and captured["oom_probe"]
    assert captured["fault_policy"].max_bad_steps == 4
    captured.clear()
    assert _main(["--config", cfg, "--microbatch", "16"], capsys)[0] == 0
    assert captured["microbatch"] == 16 and not captured["oom_probe"]
    assert captured["fault_policy"] is None


def test_time_test_checkgrad_dump_and_profile_jobs(tmp_path, capsys):
    cfg = _config(tmp_path)
    rc, cap = _main(["--config", cfg, "--job", "time", "--batch_size", "4",
                     "--iters", "3"], capsys)
    rec = _json_lines(cap.out)[-1]
    assert rc == 0 and rec["metric"] == "train_ms_per_batch"
    assert rec["value"] > 0 and rec["device"] == "cpu"
    rc, cap = _main(["--config", cfg, "--job", "checkgrad",
                     "--batch_size", "4"], capsys)
    rec = _json_lines(cap.out)[-1]
    assert rc == 0 and rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["params_checked"] == 4 and rec["coords_checked"] == 6 + 6 + 6 + 2
    rc, cap = _main(["--config", cfg, "--job", "dump_config"], capsys)
    topo = json.loads(cap.out)
    assert rc == 0 and topo["outputs"] == ["cost", "error"]
    blob = tmp_path / "topo.json"
    blob.write_text(cap.out)
    rc, cap = _main(["--config", str(blob), "--job", "time",
                     "--batch_size", "4", "--iters", "2"], capsys)
    assert rc == 0 and _json_lines(cap.out)[-1]["value"] > 0
    rc, cap = _main(["--config", cfg, "--job", "profile", "--batch_size",
                     "4", "--iters", "2", "--profile_dir",
                     str(tmp_path / "prof")], capsys)
    rec = _json_lines(cap.out)[-1]
    assert rc == 0 and rec["job"] == "profile"
    assert os.path.getsize(rec["trace"]) > 0
    save = tmp_path / "save"
    assert _main(["--config", cfg, "--save_dir", str(save)], capsys)[0] == 0
    rc, cap = _main(["--config", cfg, "--job", "test", "--init_model_path",
                     str(save / "pass-00000" / "params.tar")], capsys)
    assert rc == 0 and "Test: cost=" in cap.out


def _launch(cfg, ckpt, save):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "train",
         "--use_tpu=false", "--config", cfg, "--num_passes", "2",
         "--log_period", "1", "--checkpoint_dir", ckpt,
         "--checkpoint_period", "1", "--auto_resume", "--save_dir", save],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _final_params(save):
    from paddle_tpu_torch.trainer import Parameters
    with open(os.path.join(save, "pass-00001", "params.tar"), "rb") as f:
        p = Parameters.from_tar(io.BytesIO(f.read()), device="cpu")
    return {k: p[k] for k in p.keys()}


@pytest.mark.chaos(timeout=150)
def test_sigkill_then_auto_resume_matches_uninterrupted(tmp_path):
    cfg = _config(tmp_path, delay=0.15)
    ref = _launch(cfg, str(tmp_path / "ref_ckpt"), str(tmp_path / "ref"))
    victim = _launch(cfg, str(tmp_path / "ckpt"), str(tmp_path / "out"))
    try:
        seen = []
        for line in victim.stdout:       # killed after its 4th step
            if line.startswith("Pass 0, Batch"):
                seen.append(line)
                if len(seen) == 4:
                    victim.send_signal(signal.SIGKILL)
                    break
        victim.wait(timeout=60)
        assert victim.returncode == -signal.SIGKILL
        out, err = ref.communicate(timeout=120)
        assert ref.returncode == 0, err[-2000:]
    finally:
        for p in (victim, ref):
            if p.poll() is None:
                p.kill()
                p.wait()
    from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() is not None
    resumed = _launch(cfg, str(tmp_path / "ckpt"), str(tmp_path / "out"))
    out2, err2 = resumed.communicate(timeout=120)
    assert resumed.returncode == 0, err2[-2000:]
    steps = [l for l in out2.splitlines() if l.startswith("Pass ")
             and "Batch" in l]
    assert 0 < len(steps) < 12           # the resumed run skipped work
    got, want = _final_params(str(tmp_path / "out")), \
        _final_params(str(tmp_path / "ref"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
