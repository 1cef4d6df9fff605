"""The port's warm-start artifact plane (paddle_tpu_torch/artifacts/)
against the JAX package's, on the CPU.

- Fingerprints: the same fields digest equal in both packages, and one
  weight table loaded in both packages has one ``model_digest`` (in
  float32 and in bfloat16: dtypes are written under numpy's names).
- The store: a frame written by either package is read by the other;
  each ``corrupt_artifact`` mode damages a shared frame byte-identically
  in both packages and both journal the same ``artifacts/fallback``;
  ``stale_fingerprint`` gives reason ``stale`` while ``verify`` passes
  the doctored frame; ``cache_race`` leaves one complete winner.
- The ladder end to end, without a card: a fake ``nvcc`` (a script
  under a ``CUDA_HOME`` in a temporary directory) counts its calls and
  writes a tiny shared library that g++ built, which ``ctypes`` loads
  and calls. A cold process builds and backfills; a fresh process with
  the compile cache off loads from the store with 0 ``nvcc`` calls; a
  corrupt payload inside a valid frame (``unloadable``) recovers by a
  rebuild; ``warm=False`` never reads the store; a failed cold build
  raises (the ladder never ends in a plain version).
- ``cache.resolve_dir``'s grammar and ``disabled()``; ``artifacts
  ls|verify`` JSON equal to the JAX CLI's on one directory apart from
  paths and ages; the engine's ``warmup()`` stats.

Tolerances: none — digests, bytes, records and counts are exact.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from paddle_tpu import artifacts as JA
from paddle_tpu import cli as jcli
from paddle_tpu.artifacts.fingerprint import Fingerprint as JFingerprint
from paddle_tpu.artifacts.fingerprint import model_digest as j_model_digest
from paddle_tpu.obs.events import JOURNAL as JJOURNAL
from paddle_tpu.testing import FaultPlan as JaxFaultPlan
import paddle_tpu_torch.obs as tobs
from paddle_tpu_torch import artifacts as A
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.artifacts import cache as compile_cache
from paddle_tpu_torch.artifacts.fingerprint import (Fingerprint,
                                                    device_signature,
                                                    fingerprint,
                                                    model_digest)
from paddle_tpu_torch.artifacts.runtime import ExecutableCache
from paddle_tpu_torch.obs.events import JOURNAL
from paddle_tpu_torch.obs.metrics import REGISTRY
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.testing.faults import FaultPlan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = "decode_attention"      # any kernel library: the fake nvcc serves all

TINY_SRC = textwrap.dedent("""\
    extern "C" int pt_fake_answer(void) { return 42; }
""")

FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    # counts its calls, fails on demand, else copies the tiny library
    echo "$@" >> "{log}"
    if [ -e "{fail}" ]; then echo "nvcc: planted failure"; exit 1; fi
    while [ "$1" != "-o" ]; do shift; done
    cp "{lib}" "$2"
    echo "ptxas info    : Used 8 registers, 0 bytes spill stores"
""")


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    assert tobs.WITNESS.violations() == []
    tobs.reset_all()


@pytest.fixture(scope="module")
def fake_cuda(tmp_path_factory):
    """A CUDA_HOME whose bin/nvcc is the counting fake."""
    root = tmp_path_factory.mktemp("fake_cuda")
    src, lib = root / "tiny.cc", root / "tiny.so"
    src.write_text(TINY_SRC)
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    nvcc = root / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(log=root / "calls", lib=lib,
                                     fail=root / "fail"))
    nvcc.chmod(0o755)
    return root


def _calls(fake_cuda):
    path = fake_cuda / "calls"
    return len(path.read_text().splitlines()) if path.exists() else 0


@pytest.fixture
def ladder(fake_cuda, tmp_path, monkeypatch):
    """This process on the fake toolkit, with a fresh compile cache and
    store; everything it loaded is forgotten after."""
    monkeypatch.setenv("CUDA_HOME", str(fake_cuda / "cuda"))
    (fake_cuda / "calls").unlink(missing_ok=True)
    (fake_cuda / "fail").unlink(missing_ok=True)
    compile_cache.enable(str(tmp_path / "cc"))
    store = A.configure(str(tmp_path / "store"))
    A.EXECUTABLES.clear()
    yield store
    A.configure(None)
    A.EXECUTABLES.clear()
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    compile_cache.enable(None)


def _journal(kind=None):
    return JOURNAL.tail(50, domain="artifacts", kind=kind)


def _gauge(name):
    return REGISTRY.gauge(name).value()


def _fields(kind="toy", n=4):
    return {"v": 1, "kind": kind, "model": "0123456789abcdef",
            "plan": {"n": n, "flags": ["-O3"]},
            "env": {"backend": "cuda", "torch": "2.x"}}


# ---------------------------------------------------------- fingerprints
def test_fingerprint_digest_equals_jax():
    for n in range(4):
        assert Fingerprint(_fields(n=n)).digest == \
            JFingerprint(_fields(n=n)).digest
    fp = Fingerprint(_fields())
    assert Fingerprint.from_dict(fp.to_dict()) == fp
    assert Fingerprint(_fields(n=5)) != fp


def test_model_digest_of_one_table_equal_across_packages():
    import jax.numpy as jnp
    from tests.test_torch_two_tier import _pair
    jdec, tdec = _pair()
    assert model_digest(tdec.p) == j_model_digest(jdec.p)
    jbf = {k: v.astype(jnp.bfloat16) for k, v in jdec.p.items()}
    tbf = {k: v.to(torch.bfloat16) for k, v in tdec.p.items()}
    assert model_digest(tbf) == j_model_digest(jbf)
    assert model_digest(tbf) != model_digest(tdec.p)
    # numpy arrays digest as the tensors they hold
    assert model_digest({k: v.numpy() for k, v in tdec.p.items()}) == \
        model_digest(tdec.p)


def test_device_signature_is_the_torch_environment():
    sig = device_signature()
    assert sig["torch"] == torch.__version__
    assert sig["cuda"] == torch.version.cuda
    assert sig["backend"] == ("cuda" if torch.cuda.is_available()
                              else "cpu")
    fp = _build.fingerprint_of(LIB)
    assert fp.fields["kind"] == LIB
    assert fp.fields["plan"] == {"arch": "sm_90a",
                                 "flags": list(_build.NVCC_FLAGS)}
    assert fp.fields["model"] == _build._source_digest(LIB)[:16]
    assert fp.fields["env"] == sig


# ---------------------------------------------------------------- store
def test_frames_read_across_packages(tmp_path):
    fields = _fields()
    payload = b"\x7fELF" + bytes(range(256)) * 4
    jst = JA.ArtifactStore(str(tmp_path / "j"))
    tst = A.ArtifactStore(str(tmp_path / "t"))
    jst.put("toy-exe", JFingerprint(fields), payload, meta={"w": 1})
    tst.put("toy-exe", Fingerprint(fields), payload, meta={"w": 1})
    # each reads the other's directory
    assert A.ArtifactStore(jst.root).get("toy-exe",
                                         Fingerprint(fields)) == payload
    assert JA.ArtifactStore(tst.root).get("toy-exe",
                                          JFingerprint(fields)) == payload
    # the frames differ only in the header's creation time
    with open(jst.path("toy-exe"), "rb") as f:
        jb = f.read()
    with open(tst.path("toy-exe"), "rb") as f:
        tb = f.read()
    assert jb[:4] == tb[:4] == b"PTA1"
    assert jb.endswith(payload) and tb.endswith(payload)
    jrow, trow = jst.inspect(jst.path("toy-exe")), \
        tst.inspect(tst.path("toy-exe"))
    for row in (jrow, trow):
        for k in ("path", "age_s", "created", "size"):   # the time's digits
            row.pop(k)
    assert jrow == trow


@pytest.mark.parametrize("mode", ["payload", "torn", "magic"])
def test_corrupt_artifact_byte_identical_in_both_packages(tmp_path, mode):
    fields = _fields()
    payload = b"payload" * 100
    jst = JA.ArtifactStore(str(tmp_path / "j"))
    jst.put("toy-exe", JFingerprint(fields), payload)
    tst = A.ArtifactStore(str(tmp_path / "t"))
    shutil.copy(jst.path("toy-exe"), tst.path("toy-exe"))
    with JaxFaultPlan.corrupt_artifact(jst, mode=mode) as js, \
            FaultPlan.corrupt_artifact(tst, mode=mode) as ts:
        with open(js["path"], "rb") as f:
            jbytes = f.read()
        with open(ts["path"], "rb") as f:
            assert f.read() == jbytes
        assert jst.get("toy-exe", JFingerprint(fields)) is None
        assert tst.get("toy-exe", Fingerprint(fields)) is None
        jrec = JJOURNAL.tail(5, domain="artifacts", kind="fallback")[-1]
        trec = _journal("fallback")[-1]
        for k in ("name", "reason", "detail"):
            assert trec[k] == jrec[k], k
        assert trec["reason"] == "corrupt" and trec["path"] == ts["path"]
        assert _gauge("paddle_tpu_artifacts_fallbacks") == 1
        bad = tst.verify()
        assert len(bad) == 1 and not bad[0]["ok"]
        assert _journal("verify_failed")
    assert tst.get("toy-exe", Fingerprint(fields)) == payload
    assert tst.verify() == []


def test_stale_fingerprint_doctors_torch_and_degrades_as_stale(tmp_path):
    st = A.ArtifactStore(str(tmp_path))
    fp = Fingerprint(_fields())
    st.put("toy-exe", fp, b"x" * 64)
    with FaultPlan.stale_fingerprint(st) as stats:
        assert st.verify() == []            # the frame is intact
        assert st.get("toy-exe", fp) is None
        rec = _journal("fallback")[-1]
        assert rec["reason"] == "stale"
        assert stats["doctored_digest"] in rec["detail"]
        header = st.inspect(stats["path"])
        assert header["ok"] and header["digest"] == stats["doctored_digest"]
    assert st.get("toy-exe", fp) == b"x" * 64


def test_cache_race_leaves_one_complete_winner(tmp_path):
    st = A.ArtifactStore(str(tmp_path))
    fp = Fingerprint(_fields())
    payloads = [bytes([i]) * (512 + i) for i in range(12)]
    stats = FaultPlan.cache_race(st, "toy-exe", fp, payloads, threads=8)
    assert stats["errors"] == [] and stats["writes"] == 12
    assert stats["winner"]["ok"], stats["winner"]
    assert st.get("toy-exe", fp) in payloads
    assert [n for n in os.listdir(st.root) if ".tmp." in n] == []


# --------------------------------------------------------------- ladder
def _run_ladder(fake_cuda, cc, store, extra=""):
    """A fresh process on the fake toolkit: load LIB, call it, report
    nvcc launches and the artifacts journal."""
    code = textwrap.dedent(f"""\
        import json
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.obs.events import JOURNAL
        from paddle_tpu_torch.obs import WITNESS
        lib = _build.load({LIB!r})
        {extra}
        print(json.dumps({{
            "answer": lib.pt_fake_answer(),
            "nvcc": _build.nvcc_launches(),
            "records": [[r["kind"], r.get("source"), r.get("reason")]
                        for r in JOURNAL.tail(20, domain="artifacts")],
            "violations": WITNESS.violations()}}))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               CUDA_HOME=str(fake_cuda / "cuda"),
               PADDLE_TPU_COMPILE_CACHE=cc, PADDLE_TPU_ARTIFACTS=store)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_fresh_process_loads_from_the_store_without_nvcc(fake_cuda,
                                                         tmp_path):
    (fake_cuda / "calls").unlink(missing_ok=True)
    store = str(tmp_path / "store")
    cold = _run_ladder(fake_cuda, str(tmp_path / "cc"), store)
    assert cold["answer"] == 42 and cold["nvcc"] == 1
    assert [r[0] for r in cold["records"]] == ["build"]
    assert _calls(fake_cuda) == 1
    assert len(A.ArtifactStore(store).entries()) == 1
    # compile cache off: the only place the library can come from is
    # the store — 0 nvcc calls
    warm = _run_ladder(fake_cuda, "0", store)
    assert warm["answer"] == 42 and warm["nvcc"] == 0
    assert warm["records"] == [["load", "store", None]]
    assert _calls(fake_cuda) == 1
    # the compile cache alone (empty store) serves with 0 nvcc too
    cc_only = _run_ladder(fake_cuda, str(tmp_path / "cc"),
                          str(tmp_path / "store2"))
    assert cc_only["nvcc"] == 0 and _calls(fake_cuda) == 1
    assert [r[0] for r in cc_only["records"]] == ["build"]
    # cold on both counts: nvcc again, and the witness saw no violation
    again = _run_ladder(fake_cuda, "0", str(tmp_path / "store3"))
    assert again["nvcc"] == 1 and _calls(fake_cuda) == 2
    for run in (cold, warm, cc_only, again):
        assert run["violations"] == []


def test_ladder_in_process_backfills_and_hits(ladder, fake_cuda):
    lib = _build.load(LIB)
    assert lib.pt_fake_answer() == 42
    assert _build.load(LIB) is lib                  # rung 1
    rec = _journal("build")[-1]
    assert rec["name"] == A.runtime._artifact_name(_build.fingerprint_of(LIB))
    assert rec["payload_bytes"] > 0
    assert _gauge("paddle_tpu_artifacts_build_ms") > 0
    assert len(ladder.entries()) == 1
    A.EXECUTABLES.clear()                           # rung 2
    with compile_cache.disabled():
        lib2 = _build.load(LIB)
    assert lib2.pt_fake_answer() == 42
    assert _journal("load")[-1]["source"] == "store"
    assert _calls(fake_cuda) == 1


@pytest.mark.parametrize("junk", [b"not-a-library",
                                  b"\x7fELF" + b"\x00" * 64])
def test_unloadable_payload_recovers_by_rebuild(ladder, fake_cuda, junk):
    fp = _build.fingerprint_of(LIB)
    name = A.runtime._artifact_name(fp)
    ladder.put(name, fp, junk)
    lib = _build.load(LIB)
    assert lib.pt_fake_answer() == 42
    recs = _journal()
    assert [r["kind"] for r in recs[-2:]] == ["fallback", "build"]
    assert recs[-2]["reason"] == "unloadable"
    # the rebuild's backfill repaired the store
    A.EXECUTABLES.clear()
    _build.load(LIB)
    assert _journal("load")[-1]["digest"] == fp.digest
    assert _calls(fake_cuda) == 1


def test_warm_false_never_reads_the_store(ladder, fake_cuda):
    fp = _build.fingerprint_of(LIB)
    ladder.put(A.runtime._artifact_name(fp), fp, b"junk")
    lib = _build.load(LIB, warm=False)
    assert lib.pt_fake_answer() == 42 and _calls(fake_cuda) == 1
    assert _gauge("paddle_tpu_artifacts_misses") == 0
    assert _gauge("paddle_tpu_artifacts_fallbacks") == 0
    assert _journal() == []
    # the junk frame is still there: nothing wrote the store either
    assert ladder.get(A.runtime._artifact_name(fp), fp) == b"junk"


def test_failed_cold_build_raises_never_a_plain_version(ladder, fake_cuda):
    (fake_cuda / "fail").write_text("")
    with pytest.raises(_build.KernelBuildError, match="planted failure"):
        _build.load(LIB)
    assert _journal("build_failed")[-1]["digest"] == \
        _build.fingerprint_of(LIB).digest
    assert A.EXECUTABLES.stats()["entries"] == 0


def test_build_all_reports_and_counts(ladder, fake_cuda):
    before = _build.nvcc_launches()
    reports = _build.build_all([LIB, "gru_fwd"])
    assert _build.nvcc_launches() - before == 2 == _calls(fake_cuda)
    assert all("0 bytes spill" in r for r in reports.values())
    # built once: a second call reuses the compile cache
    assert _build.build_all([LIB]) == {LIB: ""}
    assert _calls(fake_cuda) == 2


def test_executable_cache_lru_bounded():
    cache = ExecutableCache(capacity=2)
    fps = [Fingerprint(_fields(n=i)) for i in range(3)]
    for i, fp in enumerate(fps):
        cache.put(fp, f"lib{i}")
    assert cache.stats()["entries"] == 2
    assert cache.get(fps[0]) is None
    assert cache.get(fps[2]) == "lib2"
    assert A.EXECUTABLES.capacity >= len(_build.SOURCES)


# ---------------------------------------------------------- compile cache
def test_resolve_dir_grammar(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.resolve_dir(None) is None
    assert compile_cache.resolve_dir("/x") == "/x"
    for off in ("0", "off", "OFF", "none", ""):
        assert compile_cache.resolve_dir(off) is None
    monkeypatch.setenv(compile_cache.ENV_VAR, "/from/env")
    assert compile_cache.resolve_dir(None) == "/from/env"
    assert compile_cache.resolve_dir("/flag") == "/flag"
    monkeypatch.setenv(compile_cache.ENV_VAR, "off")
    assert compile_cache.resolve_dir(None, fallback="/fb") is None
    monkeypatch.delenv(compile_cache.ENV_VAR)
    assert compile_cache.resolve_dir(None, fallback="/fb") == "/fb"
    # the JAX package's grammar, value for value
    from paddle_tpu.artifacts import cache as jcache
    for v in (None, "/x", "0", "off", "none", ""):
        assert compile_cache.resolve_dir(v, "/fb") == \
            jcache.resolve_dir(v, "/fb")


def test_cache_on_by_default_and_disabled_restores(monkeypatch, tmp_path):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.enable(None) == compile_cache.default_dir()
    assert compile_cache.build_dir() == compile_cache.default_dir()
    assert compile_cache.ensure_default() == compile_cache.default_dir()
    assert str(_build._target(LIB)).startswith(compile_cache.default_dir())
    with compile_cache.disabled():
        private = compile_cache.build_dir()
        assert private != compile_cache.default_dir()
        assert os.path.isdir(private)
        assert str(_build._target(LIB)).startswith(private)
    assert compile_cache.build_dir() == compile_cache.default_dir()
    assert not os.path.exists(private)      # removed on exit
    monkeypatch.setenv(compile_cache.ENV_VAR, "0")
    assert compile_cache.ensure_default() is None
    off = compile_cache.build_dir()
    assert off != compile_cache.default_dir() and os.path.isdir(off)
    assert compile_cache.enable("off") is None
    assert compile_cache.build_dir() == off   # one private dir a process
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    assert compile_cache.ensure_default() == str(tmp_path / "cc")
    monkeypatch.delenv(compile_cache.ENV_VAR)
    compile_cache.enable(None)


def test_cli_compile_cache_seam_exports_the_choice(monkeypatch, tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(textwrap.dedent("""\
        import paddle_tpu_torch as paddle
        x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
        y = paddle.layer.data("y", paddle.data_type.dense_vector(1))
        cost = paddle.layer.square_error_cost(
            input=paddle.layer.fc(x, size=1), label=y)
    """))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    with redirect_stdout(io.StringIO()):
        assert tcli.main(["train", "--config", str(cfg), "--job",
                          "dump_config", "--compile_cache", "off"]) == 0
    assert os.environ[compile_cache.ENV_VAR] == "0"
    assert compile_cache.build_dir() != compile_cache.default_dir()
    with redirect_stdout(io.StringIO()):
        tcli.main(["train", "--config", str(cfg), "--job", "dump_config",
                   "--compile_cache", str(tmp_path / "cc")])
    assert os.environ[compile_cache.ENV_VAR] == str(tmp_path / "cc")
    assert compile_cache.build_dir() == str(tmp_path / "cc")
    monkeypatch.delenv(compile_cache.ENV_VAR)
    compile_cache.enable(None)


# ------------------------------------------------------------------ CLI
def _cli_json(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue())


def _strip(doc):
    doc = json.loads(json.dumps(doc))
    doc.pop("dir", None)
    for key in ("entries", "defective"):
        for row in doc.get(key, []):
            for k in ("path", "age_s", "created"):
                row.pop(k, None)
    return doc


def test_artifacts_ls_and_verify_equal_the_jax_cli(tmp_path):
    d = str(tmp_path / "arts")
    st = A.ArtifactStore(d)
    for n in range(3):
        st.put(f"toy{n}-exe", Fingerprint(_fields(kind=f"toy{n}")),
               b"\x7fELF" * (50 + n), meta={"build_ms": n})
    for action in ("ls", "verify"):
        trc, tdoc = _cli_json(tcli.main, ["artifacts", action, "--dir", d])
        jrc, jdoc = _cli_json(jcli.main, ["artifacts", action, "--dir", d])
        assert trc == jrc == 0
        assert _strip(tdoc) == _strip(jdoc)
    with FaultPlan.corrupt_artifact(st, name="toy1-exe", mode="torn"):
        trc, tdoc = _cli_json(tcli.main, ["artifacts", "verify", "--dir", d])
        jrc, jdoc = _cli_json(jcli.main, ["artifacts", "verify", "--dir", d])
        assert trc == jrc == 1
        assert _strip(tdoc) == _strip(jdoc)
        assert len(tdoc["defective"]) == 1
    assert _journal("verify_failed")[-1]["name"] == "toy1-exe.ptaf"
    with pytest.raises(SystemExit, match="decode_config"):
        tcli.main(["artifacts", "build", "--dir", d])


def test_engine_warmup_returns_cache_stats(ladder):
    from tests.test_torch_two_tier import _pair
    from paddle_tpu_torch.serving import DecodeEngine
    _, tdec = _pair()
    for warm in (True, False):
        eng = DecodeEngine(tdec, num_slots=2, page_size=4, max_seq_len=16,
                           warm_start=warm)
        stats = eng.warmup()
        assert stats == dict(A.EXECUTABLES.stats(), warm_start=warm)
        assert eng.paged.warm_start is warm
        # off the card the step launches no kernel library
        assert eng.paged.load_kernels() == ()
    assert eng.paged.KERNEL_LIBRARIES == ("paged_window_attention",)
    assert ladder.entries() == []
