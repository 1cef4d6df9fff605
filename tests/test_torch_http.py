"""Port parity of the serving plane's HTTP front (serving/http.py,
serving/server.py, serving/breaker.py, the engine's obs hooks) against
the JAX package's front, on the CPU at a small size: decoders of 2
layers and width 32 built from one weight table (the ``_decoder``
idiom of tests/test_torch_serving.py), 4-slot engines with pages of 4.

- ``/generate`` plain and streamed gives identical tokens through both
  fronts, with a terminal record of the same keys;
- the status codes match for 400, 404, 429, 501, 503 and 504;
- ``/metrics`` has the JAX front's family names, ``/events``,
  ``/flight`` and ``/profile`` its top-level keys, and
  ``/admin/drain|resume|quit`` its behaviour;
- ``/infer`` on one JAX-saved artifact matches the JAX front (atol
  1e-5);
- and the port's counterparts of tests/test_serving_faults.py's server,
  backpressure, breaker and mixed-chaos cases, at its sizes (an 8 -> 4
  softmax model, batches of 2): a hung forward, the breaker opening
  and recovering through half-open, a ``torch.cuda.OutOfMemoryError``
  shed with reason ``resource_exhausted`` that halves the batch limit
  without feeding the breaker, and a mid-stream disconnect that
  returns its pages.

Faults are injected by wrapping the served model's ``forward_batch``
(``_Flaky``) or the engine's paged step (``_slow_steps``).
"""

import http.client
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jpaddle
from paddle_tpu import models as jmodels
from paddle_tpu import serving as jserving
from paddle_tpu.trainer import inference as jinf

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import decode as tdecode
from paddle_tpu_torch.trainer.inference import Inference as TInference

pytestmark = pytest.mark.chaos

CFG = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=32)
PROMPTS = [[3, 9, 1, 4, 4], [5, 2, 8, 8, 1, 0, 3], [7, 7, 2],
           [1, 2, 3, 4, 5, 6, 7, 8, 9]]
NEW = [6, 5, 7, 4]
INFER_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


@pytest.fixture(scope="module")
def decoders():
    jpaddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = jmodels.transformer_lm(**CFG)
    topo = jpaddle.Topology([spec.cost], extra_outputs=[spec.output])
    params = topo.init_params(jax.random.PRNGKey(11))
    jdec = jmodels.TransformerDecoder(params, n_layers=2, n_heads=2)
    table = {k: np.asarray(v) for k, v in params.items()}
    tdec = tdecode.TransformerDecoder(table, n_layers=2, n_heads=2,
                                      device="cpu")
    return jdec, tdec


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One merged MLP artifact saved by the JAX package (12 -> 16 ->
    5 softmax)."""
    jpaddle.init(use_tpu=False, seed=0)
    L = jpaddle.layer
    x = L.data("x", jpaddle.data_type.dense_vector(12))
    h = L.fc(x, size=16, act=jpaddle.activation.Relu())
    out = L.fc(h, size=5, act=jpaddle.activation.Softmax())
    params = jpaddle.create_parameters(jpaddle.Topology(out))
    path = str(tmp_path_factory.mktemp("artifact") / "mlp.tar")
    jinf.save_inference_model(path, out, params)
    return path


def _engine(pkg, dec, **kw):
    mod = jserving if pkg == "jax" else tserving
    return mod.DecodeEngine(dec, num_slots=4, page_size=4,
                            max_seq_len=CFG["max_len"], **kw)


def _port_model(model):
    """A port model argument on the CPU: a path loads after
    ``init(use_gpu=False)``."""
    if not isinstance(model, str):
        return model
    tconfig.init(use_gpu=False, seed=0)
    try:
        return tpaddle.trainer.load_inference_model(model)
    finally:
        tconfig.init(seed=0)


class _Front:
    """One package's InferenceServer behind its HTTP front on a
    loopback port; ``close()`` stops both and joins every thread."""

    def __init__(self, pkg, model=None, engine=None, on_quit=None, **kw):
        mod = jserving if pkg == "jax" else tserving
        if pkg == "port":
            model = _port_model(model)
        self.server = mod.InferenceServer(model, engine=engine,
                                          **kw).start()
        self.httpd = mod.build_http_server(self.server, "127.0.0.1", 0,
                                           on_quit=on_quit)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="pt-serve-http")
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.thread.join(timeout=10)
        self.httpd.server_close()
        self.server.shutdown(drain=True, timeout=30)


@pytest.fixture
def fronts(decoders, artifact):
    """The JAX front and the port's, each serving the artifact on
    /infer and its package's decoder on /generate."""
    jdec, tdec = decoders
    made = {}
    yield lambda **kw: made.setdefault("pair", (
        _Front("jax", artifact, _engine("jax", jdec, **kw)),
        _Front("port", artifact, _engine("port", tdec, **kw))))
    for f in made.get("pair", ()):
        f.close()


def _request(url, payload=None, headers=None, method=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method=method or ("GET" if data is None
                                          else "POST"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            return r.status, dict(r.headers), body
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json(url, payload=None, headers=None, method=None):
    code, hdrs, body = _request(url, payload, headers, method)
    return code, hdrs, json.loads(body)


def _stream(base, payload, headers=None):
    """POST /generate with stream: the parsed NDJSON lines."""
    code, hdrs, body = _request(base + "/generate",
                                dict(payload, stream=True), headers)
    assert code == 200, body
    assert hdrs["Content-Type"] == "application/x-ndjson"
    return hdrs, [json.loads(x) for x in body.decode().splitlines()]


# ---------------------------------------------------------- /generate
def test_generate_plain_and_streamed_match_jax(fronts):
    jf, tf = fronts()
    for p, n in zip(PROMPTS, NEW):
        want = None
        for f in (jf, tf):
            code, hdrs, body = _json(f.base + "/generate",
                                     {"prompt": p, "max_new_tokens": n},
                                     {"X-Trace-Id": "tid-plain"})
            assert code == 200, body
            assert hdrs["X-Trace-Id"] == body["trace_id"] == "tid-plain"
            assert set(body) == {"tokens", "prefix_hit_pages",
                                 "accepted_tokens", "trace_id"}
            hdrs, lines = _stream(f.base, {"prompt": p,
                                           "max_new_tokens": n})
            toks = [x["token"] for x in lines[:-1]]
            done = lines[-1]
            assert done["done"] is True and done["tokens"] == toks
            assert hdrs["X-Trace-Id"] == done["trace_id"]
            assert body["tokens"] == toks
            if want is None:
                want, want_keys = toks, set(done)
            else:
                assert toks == want, (p, toks, want)
                assert set(done) == want_keys
    # the hop machine: start + settle, for each streamed request
    hops = [r["phase"] for r in tobs.tail(100, domain="serving",
                                          kind="hop")]
    assert hops == ["start", "settle"] * len(PROMPTS)
    acc = tf.server.engine.page_accounting()
    assert acc["leaked"] == 0


def test_status_codes_match_jax(decoders, artifact):
    """The same requests get the same codes from both fronts."""
    jdec, tdec = decoders
    cases = {}

    def run(pkg, f, kw):
        codes = {}
        b = f.base
        codes["bad_json"] = _request(b + "/generate", None, method="POST")[0]
        codes["bad_prompt"] = _json(b + "/generate", {"prompt": []})[0]
        codes["bad_new"] = _json(b + "/generate",
                                 {"prompt": [1], "max_new_tokens": 0})[0]
        codes["bad_rows"] = _json(b + "/infer", {"rows": "x"})[0]
        codes["ragged_rows"] = _json(b + "/infer",
                                     {"rows": [[1.0], [1.0, 2.0]]})[0]
        codes["bad_events"] = _request(b + "/events?n=x")[0]
        codes["bad_deep"] = _request(b + "/profile?deep_steps=x")[0]
        codes["no_route_get"] = _request(b + "/nope")[0]
        codes["no_route_post"] = _json(b + "/nope", {})[0]
        if kw.get("engine", True):
            code, hdrs, body = _json(b + "/generate",
                                     {"prompt": [1] * 30,
                                      "max_new_tokens": 9})
            codes["kv_capacity"] = (code, body.get("reason"),
                                    "Retry-After" in hdrs)
            codes["gen_deadline"] = _json(
                b + "/generate", {"prompt": [1, 2], "max_new_tokens": 20,
                                  "deadline_ms": 0.001})[0]
        else:
            codes["no_engine"] = _json(b + "/generate",
                                       {"prompt": [1],
                                        "max_new_tokens": 2})[0]
        code, hdrs, body = _json(b + "/infer", {"rows": [[0.5] * 12],
                                                "deadline_ms": 0.001})
        codes["infer_deadline"] = code
        codes["quit_unwired"] = _json(b + "/admin/quit", {})[0]
        return codes

    for kw in ({}, {"engine": False}):
        for pkg, dec in (("jax", jdec), ("port", tdec)):
            eng = _engine(pkg, dec) if kw.get("engine", True) else None
            f = _Front(pkg, artifact, eng)
            try:
                cases[(pkg, bool(eng))] = run(pkg, f, kw)
            finally:
                f.close()
    assert cases[("port", True)] == cases[("jax", True)]
    assert cases[("port", False)] == cases[("jax", False)]
    want = cases[("port", True)]
    assert want["kv_capacity"] == (503, "kv_capacity", True)
    assert (want["bad_prompt"], want["gen_deadline"], want["no_route_get"],
            want["quit_unwired"]) == (400, 504, 404, 501)
    assert cases[("port", False)]["no_engine"] == 501

    # 429: a full /infer queue and a full generation queue
    got = {}
    for pkg, dec in (("jax", jdec), ("port", tdec)):
        f = _Front(pkg, artifact, _engine(pkg, dec, max_waiting=0),
                   max_queue=0)
        try:
            c1, h1, b1 = _json(f.base + "/infer", {"rows": [[0.0] * 12]})
            c2, h2, b2 = _json(f.base + "/generate",
                               {"prompt": [1], "max_new_tokens": 2})
            got[pkg] = (c1, b1["reason"], "Retry-After" in h1,
                        c2, b2["reason"], "Retry-After" in h2)
        finally:
            f.close()
    assert got["port"] == got["jax"] == (429, "queue_full", True,
                                         429, "queue_full", True)


# ------------------------------------------------------------ /metrics
#: the families of the modules this slice ports (the JAX registry also
#: holds those of unported planes: protocol, trainer, fleet, ...).
#: Lock contention is timing-dependent, so its family is left out.
PORTED = ("paddle_tpu_serving_", "paddle_tpu_prefix_", "paddle_tpu_spec_",
          "paddle_tpu_kv_", "paddle_tpu_profile_", "paddle_tpu_lockdep_",
          "paddle_tpu_trace_", "paddle_tpu_counter_total",
          "paddle_tpu_timer_", "paddle_tpu_artifacts_")
TIMING = {"paddle_tpu_lockdep_contentions_total"}
#: gauges of whatever embedding shards and clients this process still
#: holds (a collector over live objects), not of the serving front
OTHER_PLANES = ("paddle_tpu_embed_",)


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")
            and not ln.split()[2].startswith(OTHER_PLANES)}


def test_metrics_families_and_gauges_match_jax(fronts):
    jf, tf = fronts()
    for f in (jf, tf):
        for p, n in zip(PROMPTS[:2], NEW[:2]):
            assert _json(f.base + "/generate",
                         {"prompt": p, "max_new_tokens": n})[0] == 200
        assert _json(f.base + "/infer", {"rows": [[0.1] * 12]})[0] == 200
    texts = {}
    for name, f in (("jax", jf), ("port", tf)):
        code, hdrs, body = _request(f.base + "/metrics")
        assert code == 200
        assert hdrs["Content-Type"] == "text/plain; version=0.0.4"
        texts[name] = body.decode()
    jfam = {n for n in _families(texts["jax"])
            if n.startswith(PORTED)} - TIMING
    tfam = _families(texts["port"]) - TIMING
    assert tfam == jfam, (sorted(tfam - jfam), sorted(jfam - tfam))
    text = texts["port"]
    st = tf.server.stats()
    for key in ("kv_pages_free", "kv_pages_used", "kv_pages_total",
                "finished", "tokens_out"):
        assert f"paddle_tpu_serving_engine_{key} " \
               f"{st['engine'][key]}" in text
    assert f"paddle_tpu_serving_served {st['served']}" in text
    assert 'paddle_tpu_serving_replica_info{endpoint="' \
           f'{tf.base}",' in text


# ----------------------------------------- /events, /flight, /profile
def test_events_flight_profile_keys_match_jax(fronts):
    jf, tf = fronts()
    tids = {}
    for name, f in (("jax", jf), ("port", tf)):
        tids[name] = []
        for i, (p, n) in enumerate(zip(PROMPTS[:3], NEW[:3])):
            code, _, body = _json(f.base + "/generate",
                                  {"prompt": p, "max_new_tokens": n},
                                  {"X-Trace-Id": f"{name}-{i}"})
            assert code == 200
            tids[name].append(body["trace_id"])
        # one shed so the journal has something to page through
        _json(f.base + "/generate", {"prompt": [1] * 30,
                                     "max_new_tokens": 9})
    keys = {}
    for name, f in (("jax", jf), ("port", tf)):
        _, _, ev = _json(f.base + "/events?n=50")
        _, _, fl = _json(f.base + "/flight")
        _, _, pr = _json(f.base + "/profile?deep_steps=2")
        keys[name] = (set(ev), set(fl), set(pr), set(fl["journal"]))
        if name == "port":
            events, flight, profile = ev, fl, pr
    assert keys["port"] == keys["jax"]
    # /events pages forward with since_seq
    last = events["last_seq"]
    tobs.emit("serving", "shed", reason="probe")
    tobs.emit("serving", "shed", reason="probe2")
    _, _, page = _json(tf.base + f"/events?since_seq={last}&n=1")
    assert [r["reason"] for r in page["events"]] == ["probe"]
    _, _, page = _json(tf.base + f"/events?since_seq={last + 1}&n=5"
                       "&domain=serving&kind=shed")
    assert [r["reason"] for r in page["events"]] == ["probe2"]
    assert page["last_seq"] == last + 2
    # /flight holds the trace ids it served, each chain whole
    ring_tids = {r.get("trace_id") for r in flight["ring"]}
    assert set(tids["port"]) <= ring_tids
    assert any(k.startswith("engine-") for k in flight["state"])
    assert any(k.startswith("serving-") for k in flight["state"])
    # /profile armed a window and carries the profiler + SLO state
    assert profile["armed_trace_dir"]
    assert set(profile) == {"armed_trace_dir", "profile", "slo"}


# -------------------------------------------------------------- /admin
def test_admin_drain_resume_quit_like_jax(decoders, artifact):
    jdec, tdec = decoders
    seen = {}
    for pkg, dec in (("jax", jdec), ("port", tdec)):
        quit_called = threading.Event()
        f = _Front(pkg, artifact, _engine(pkg, dec),
                   on_quit=quit_called.set)
        try:
            steps = []
            code, _, body = _json(f.base + "/admin/drain", {})
            steps.append((code, body["status"], body["accepting"],
                          sorted(body)))
            c, _, b = _json(f.base + "/generate",
                            {"prompt": [1, 2], "max_new_tokens": 2})
            steps.append((c, b.get("reason")))
            c, _, b = _json(f.base + "/infer", {"rows": [[0.0] * 12]})
            steps.append((c, b.get("reason")))
            code, _, body = _json(f.base + "/admin/resume", {})
            steps.append((code, body["status"], body["accepting"]))
            c, _, b = _json(f.base + "/generate",
                            {"prompt": [1, 2], "max_new_tokens": 2})
            steps.append((c, len(b["tokens"])))
            code, _, body = _json(f.base + "/admin/quit", {})
            steps.append((code, body["quitting"], sorted(body["replica"])))
            assert quit_called.wait(10)
            drains = [r["action"] for r in (
                jpaddle.obs.tail(10, domain="serving", kind="drain")
                if pkg == "jax" else
                tobs.tail(10, domain="serving", kind="drain"))]
            steps.append(drains)
            seen[pkg] = steps
        finally:
            f.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == (503, "draining")
    assert seen["port"][3][1] == "ok"


# -------------------------------------------------------------- /infer
def test_infer_matches_jax_front_on_jax_artifact(decoders, artifact):
    rows = np.random.RandomState(5).randn(64, 12).astype(np.float32)
    want = jinf.load_inference_model(artifact).forward_batch(
        [(r,) for r in rows])[0]
    outs = {}
    for pkg in ("jax", "port"):
        f = _Front(pkg, artifact)
        try:
            code, hdrs, body = _json(f.base + "/infer",
                                     {"rows": rows.tolist()},
                                     {"X-Trace-Id": "infer-1"})
            assert code == 200, body
            assert body["trace_id"] == hdrs["X-Trace-Id"] == "infer-1"
            outs[pkg] = np.asarray(body["outputs"])
            assert f.server.stats()["served"] == 1
        finally:
            f.close()
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0,
                               atol=INFER_ATOL)
    np.testing.assert_allclose(outs["port"], want, rtol=0,
                               atol=INFER_ATOL)


# ------------------------------------------------- the chaos counterparts
def tiny_inference(dim=8, out=4, seed=5):
    """The port's counterpart of tests/test_serving_faults.py's model:
    an 8 -> 4 softmax on the CPU."""
    tconfig.init(use_gpu=False, seed=seed)
    try:
        from paddle_tpu_torch.core.registry import reset_name_counters
        reset_name_counters()
        x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(dim))
        o = tpaddle.layer.fc(x, size=out,
                             act=tpaddle.activation.Softmax())
        params = tpaddle.create_parameters(tpaddle.Topology(o))
        return TInference(output_layer=o, parameters=params)
    finally:
        tconfig.init(seed=0)


def samples(batch=2, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(dim).astype(np.float32),) for _ in range(batch)]


class _Flaky:
    """Wrap ``inf.forward_batch`` so chosen 0-based calls fail
    (RuntimeError), run out of device memory
    (``torch.cuda.OutOfMemoryError``), sleep, or block on an Event;
    ``fail_rate`` adds seeded random failures. Thread-safe."""

    def __init__(self, inf, fail=(), oom=(), delay=None, hang=None,
                 fail_rate=0.0, seed=0):
        self.inf, self.real = inf, inf.forward_batch
        self.fail, self.oom = set(fail), set(oom)
        self.delay, self.hang = dict(delay or {}), dict(hang or {})
        self.fail_rate, self.rng = fail_rate, random.Random(seed)
        self.lock = threading.Lock()
        self.calls = 0

    def fwd(self, samples_, feeding=None):
        with self.lock:
            i = self.calls
            self.calls += 1
            bad = i in self.fail or (self.fail_rate and
                                     self.rng.random() < self.fail_rate)
        if i in self.hang:
            self.hang[i].wait()
        if self.delay.get(i):
            time.sleep(self.delay[i])
        if i in self.oom:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        if bad:
            raise RuntimeError(f"injected forward failure (call {i})")
        return self.real(samples_, feeding)

    def __enter__(self):
        self.inf.forward_batch = self.fwd
        return self

    def __exit__(self, *exc):
        del self.inf.forward_batch
        return False


def _burst(fn, n, threads=8, timeout=60.0):
    """``n`` calls of ``fn(i)`` over ``threads`` client threads:
    (results, errors), one slot per call."""
    results, errors = [None] * n, [None] * n
    it = iter(range(n))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            try:
                results[i] = fn(i)
            except Exception as e:  # noqa: BLE001 — collected, typed below
                errors[i] = e

    ts = [threading.Thread(target=client, name=f"pt-test-client-{k}")
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
        assert not t.is_alive(), "client thread wedged"
    return results, errors


def test_serves_and_snapshots():
    inf = tiny_inference()
    srv = tserving.InferenceServer(inf, max_queue=8, workers=2,
                                   breaker=False).start()
    try:
        want = np.asarray(inf.infer(samples()))
        got = np.asarray(srv.infer(samples()))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for _ in range(5):
            srv.infer(samples())
        st = srv.stats()
        assert st["served"] == 6 and st["p50_ms"] > 0.0
        assert st["breaker"] is None
        assert srv.health() == {"status": "ok", "accepting": True,
                                "queue_depth": 0, "workers": 2,
                                "breaker": "disabled"}
        assert [t.name for t in srv._threads] == ["pt-serve-worker-0",
                                                  "pt-serve-worker-1"]
    finally:
        srv.shutdown(drain=True)
    assert srv.health()["status"] == "stopped"
    from paddle_tpu_torch.utils.stats import global_stat
    assert global_stat.items()["serving/forward"].snapshot()[0] == 6


def test_graceful_drain_completes_queued_work():
    inf = tiny_inference()
    srv = tserving.InferenceServer(inf, max_queue=16, workers=1,
                                   breaker=False).start()
    with _Flaky(inf, delay={i: 0.05 for i in range(8)}):
        reqs = [srv.submit(samples(seed=i)) for i in range(6)]
        t = threading.Thread(target=srv.shutdown, kwargs={"drain": True},
                             name="pt-test-drain")
        t.start()
        for r in reqs:
            assert np.asarray(r.get(timeout=30)).shape == (2, 4)
        t.join(30)
        assert not t.is_alive()
    with pytest.raises(tserving.ServerClosed):
        srv.submit(samples())
    assert srv.stats()["served"] == 6


def test_shutdown_without_drain_fails_queued_typed():
    inf = tiny_inference()
    srv = tserving.InferenceServer(inf, max_queue=16, workers=1,
                                   breaker=False).start()
    with _Flaky(inf, delay={0: 0.2}):
        first = srv.submit(samples())
        queued = [srv.submit(samples(seed=i)) for i in range(4)]
        time.sleep(0.05)
        srv.shutdown(drain=False, timeout=10)
        dropped = 0
        for r in queued:
            try:
                r.get(timeout=10)
            except tserving.ServerClosed:
                dropped += 1
        assert dropped >= 3
        first.get(timeout=10)
    assert srv.stats()["closed"] >= 3


def test_burst_overload_rejects_with_retry_after():
    inf = tiny_inference()
    srv = tserving.InferenceServer(inf, max_queue=3, workers=1,
                                   breaker=False).start()
    try:
        with _Flaky(inf, delay={i: 0.03 for i in range(64)}):
            results, errors = _burst(
                lambda i: srv.infer(samples(seed=i)), 30)
        served = sum(r is not None for r in results)
        rejected = [e for e in errors
                    if isinstance(e, tserving.Rejected)]
        other = [e for e in errors if e is not None and
                 not isinstance(e, tserving.Rejected)]
        assert other == []
        assert served + len(rejected) == 30 and rejected
        assert all(e.retry_after > 0 and e.reason == "queue_full"
                   for e in rejected)
        st = srv.stats()
        assert st["rejected_full"] == len(rejected)
        assert st["served"] == served
        sheds = tobs.tail(100, domain="serving", kind="shed")
        assert len(sheds) == len(rejected)
        assert all(r["reason"] == "queue_full" and r["trace_id"]
                   for r in sheds)
    finally:
        srv.shutdown(drain=True)


def test_deadline_expires_queued_requests():
    inf = tiny_inference()
    srv = tserving.InferenceServer(inf, max_queue=16, workers=1,
                                   breaker=False).start()
    try:
        with _Flaky(inf, delay={0: 0.3}):
            slow = srv.submit(samples())
            doomed = srv.submit(samples(seed=1), deadline=0.05)
            with pytest.raises(tserving.Expired):
                doomed.get()
            slow.get(timeout=10)
        assert srv.stats()["expired"] >= 1
    finally:
        srv.shutdown(drain=True)


def test_hung_forward_expires_then_recovers():
    inf = tiny_inference()
    release = threading.Event()
    srv = tserving.InferenceServer(inf, max_queue=8, workers=1,
                                   breaker=False).start()
    try:
        with _Flaky(inf, hang={0: release}):
            req = srv.submit(samples(), deadline=0.2)
            t0 = time.monotonic()
            with pytest.raises(tserving.Expired):
                req.get()
            assert time.monotonic() - t0 < 5.0
            release.set()
            out = srv.infer(samples(), deadline=10.0)
            assert np.asarray(out).shape == (2, 4)
    finally:
        release.set()
        srv.shutdown(drain=True, timeout=10)


def test_breaker_opens_under_faults_and_half_open_recovers(tmp_path):
    inf = tiny_inference()
    breaker = tserving.CircuitBreaker(window=16, failure_threshold=0.5,
                                      min_requests=4, cooldown=0.3,
                                      half_open_probes=2)
    tobs.FLIGHT.configure(dump_dir=str(tmp_path))
    srv = tserving.InferenceServer(inf, max_queue=16, workers=1,
                                   breaker=breaker).start()
    try:
        with _Flaky(inf, fail_rate=1.0):
            failures = 0
            for i in range(8):
                try:
                    srv.infer(samples(seed=i), deadline=5.0)
                except tserving.ServingError:
                    failures += 1
            assert failures >= 4
            assert breaker.state == "open"
            with pytest.raises(tserving.Rejected) as ei:
                srv.submit(samples())
            assert ei.value.reason == "breaker_open"
            assert ei.value.retry_after > 0
            assert srv.health()["status"] == "shedding"
        time.sleep(0.35)
        for i in range(3):
            out = srv.infer(samples(seed=100 + i), deadline=10.0)
            assert np.asarray(out).shape == (2, 4)
        assert breaker.state == "closed"
        st = srv.stats()
        assert st["rejected_breaker"] >= 1 and st["breaker"]["trips"] >= 1
    finally:
        srv.shutdown(drain=True)
    flips = [r["state"] for r in tobs.tail(100, domain="serving",
                                           kind="breaker")]
    assert flips == ["open", "half_open", "closed"]
    # the open flip auto-dumped one postmortem bundle
    assert tobs.FLIGHT.dumps == 1


def test_oom_sheds_resource_exhausted_and_halves_batch_limit():
    """``torch.cuda.OutOfMemoryError`` from the forward is a capacity
    fault: the request is shed (``resource_exhausted``, with a retry
    hint), the adaptive row limit halves, the next oversized request
    is shed at admission, and the breaker is NOT fed."""
    inf = tiny_inference()
    breaker = tserving.CircuitBreaker(window=8, failure_threshold=0.5,
                                      min_requests=2, cooldown=5.0)
    srv = tserving.InferenceServer(inf, max_queue=8, workers=1,
                                   breaker=breaker).start()
    try:
        with _Flaky(inf, oom={0, 1}):
            with pytest.raises(tserving.Rejected) as ei:
                srv.infer(samples(batch=8), deadline=10.0)
            assert ei.value.reason == "resource_exhausted"
            assert ei.value.retry_after > 0
            assert srv.stats()["batch_limit"] == 4
            with pytest.raises(tserving.Rejected) as ei:   # admission
                srv.submit(samples(batch=6))
            assert ei.value.reason == "resource_exhausted"
            with pytest.raises(tserving.Rejected):          # OOM again
                srv.infer(samples(batch=4), deadline=10.0)
            assert srv.stats()["batch_limit"] == 2
            out = srv.infer(samples(batch=2), deadline=10.0)
            assert np.asarray(out).shape == (2, 4)
        st = srv.stats()
        assert st["oom_events"] == 2 and st["rejected_oom"] == 1
        assert st["failed"] == 0 and st["served"] == 1
        assert breaker.state == "closed"
        assert st["breaker"]["window"] == 1     # only the success
        sheds = [(r["where"], r.get("new_batch_limit"))
                 for r in tobs.tail(10, domain="serving", kind="shed")]
        assert sheds == [("forward", 4), ("admission_rows", None),
                         ("forward", 2)]
        from paddle_tpu_torch.utils.stats import global_counters
        assert global_counters.value("serving/oom_events") == 2
    finally:
        srv.shutdown(drain=True)
    srv2 = tserving.InferenceServer(inf, max_batch_memory=100).start()
    try:
        with pytest.raises(tserving.Rejected) as ei:
            srv2.submit(samples(batch=4))      # 4 x 8 float32 = 128 B
        assert ei.value.reason == "resource_exhausted"
        assert np.asarray(srv2.infer(samples(batch=3))).shape == (3, 4)
    finally:
        srv2.shutdown()


def test_sample_log_sees_served_batches():
    inf = tiny_inference()
    logged = []
    srv = tserving.InferenceServer(inf, sample_log=logged.append).start()
    try:
        batch = samples(batch=3)
        srv.infer(batch)
    finally:
        srv.shutdown()
    assert logged == [batch]


def test_eight_clients_mixed_faults_no_crash_no_deadlock():
    """8 client threads of mixed traffic while the forwards fail half
    the time and some are slow: zero untyped exceptions, zero
    deadlocks; the breaker opens under the storm and the server serves
    again after it passes."""
    inf = tiny_inference()
    breaker = tserving.CircuitBreaker(window=16, failure_threshold=0.5,
                                      min_requests=4, cooldown=0.25,
                                      half_open_probes=1)
    srv = tserving.InferenceServer(inf, max_queue=8, workers=2,
                                   default_deadline=5.0,
                                   breaker=breaker).start()
    untyped = []

    def client(tid):
        rng = random.Random(tid)
        for i in range(25):
            try:
                srv.infer(samples(seed=tid * 100 + i),
                          deadline=rng.choice([0.5, 2.0, 5.0]))
            except (tserving.Rejected, tserving.Expired,
                    tserving.ServingError):
                pass
            except BaseException as e:  # noqa: BLE001 — the failure under test
                untyped.append(repr(e))

    with _Flaky(inf, fail_rate=0.5, seed=13,
                delay={i: 0.02 for i in range(0, 60, 7)}):
        threads = [threading.Thread(target=client, args=(t,),
                                    name=f"pt-test-http-{t}")
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive(), "client thread wedged"
    assert untyped == []
    assert srv.stats()["breaker"]["trips"] >= 1
    deadline = time.monotonic() + 30
    ok = False
    while time.monotonic() < deadline:
        try:
            out = srv.infer(samples(seed=999), deadline=10.0)
            assert np.asarray(out).shape == (2, 4)
            ok = True
            break
        except (tserving.Rejected, tserving.Expired):
            time.sleep(0.1)
    assert ok, "server never recovered after faults stopped"
    assert srv.stats()["served"] > 0
    srv.shutdown(drain=True, timeout=30)


def test_counters_hold_under_contention():
    """More client threads than cores against 4 forward workers, the
    switch interval shortened: every request is counted exactly once —
    served + rejected_full + expired + failed equals the requests sent,
    the forward timer counts each forward that returned, and the
    breaker's window saw every forward's outcome."""
    import os
    import sys
    inf = tiny_inference()
    n_threads = max(8, 2 * (os.cpu_count() or 4))
    srv = tserving.InferenceServer(inf, max_queue=4, workers=4,
                                   breaker=tserving.CircuitBreaker(
                                       window=100000,
                                       failure_threshold=1.0,
                                       min_requests=100000)).start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _Flaky(inf, fail_rate=0.2, seed=5):
            results, errors = _burst(
                lambda i: srv.infer(samples(seed=i), deadline=30.0),
                400, threads=n_threads, timeout=120)
    finally:
        sys.setswitchinterval(old)
        srv.shutdown(drain=True, timeout=30)
    st = srv.stats()
    untyped = [e for e in errors if e is not None and
               not isinstance(e, tserving.ServingError)]
    assert untyped == []
    assert st["served"] == sum(r is not None for r in results)
    assert st["served"] + st["rejected_full"] + st["expired"] + \
        st["failed"] == 400
    from paddle_tpu_torch.utils.stats import global_stat
    # the timer counts the forwards that returned (a raising one is not
    # timed), the breaker every forward's outcome; a request that
    # expired while queued reached neither
    forwards = global_stat.items()["serving/forward"].snapshot()[0]
    assert st["served"] <= forwards <= st["served"] + st["expired"]
    window = st["breaker"]["window"]
    assert st["served"] + st["failed"] <= window <= \
        st["served"] + st["failed"] + st["expired"]
    assert st["failed"] > 0 and st["served"] > 0


def _slow_steps(eng, seconds):
    """Slow the engine's paged step (each step sleeps first)."""
    real = eng.paged.step

    def step(*a, **kw):
        time.sleep(seconds)
        return real(*a, **kw)

    eng.paged.step = step


def test_stream_disconnect_cancels_and_returns_pages(decoders):
    _, tdec = decoders
    eng = _engine("port", tdec)
    _slow_steps(eng, 0.02)
    f = _Front("port", None, eng)
    try:
        body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 24,
                           "stream": True}).encode()
        sock = socket.create_connection(
            ("127.0.0.1", f.httpd.server_address[1]), timeout=30)
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"X-Trace-Id: torn-1\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        got = b""
        while b'{"token"' not in got:
            got += sock.recv(4096)
        sock.close()                          # the client goes away
        t0 = time.monotonic()
        while eng.stats()["cancelled"] < 1:
            assert time.monotonic() - t0 < 20, eng.stats()
            time.sleep(0.02)
        acc = eng.page_accounting()
        assert acc["leaked"] == 0
        assert acc["free"] + acc["held_by_trie"] == acc["total_usable"]
        assert acc["refs_total"] == acc["held_by_slots"] + \
            acc["held_by_trie"]
        t0 = time.monotonic()
        while not tobs.tail(10, domain="serving", kind="hop",
                            since_seq=0) or tobs.tail(
                1, domain="serving", kind="hop")[0]["phase"] != "torn":
            assert time.monotonic() - t0 < 10
            time.sleep(0.02)
        hops = tobs.tail(10, domain="serving", kind="hop")
        assert [h["phase"] for h in hops] == ["start", "torn"]
        assert hops[-1]["trace_id"] == "torn-1"
        # the front still serves
        code, _, b = _json(f.base + "/generate",
                           {"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert code == 200 and len(b["tokens"]) == 2
    finally:
        f.close()


def test_kill_tears_live_streams():
    """``kill()`` tears every live connection and the listener: a
    streaming client sees a close-delimited body with no terminal
    record."""
    from paddle_tpu_torch import params as pt_params
    dec = tdecode.TransformerDecoder(
        pt_params.init_transformer_lm_params(CFG, seed=1), n_layers=2,
        n_heads=2, device="cpu")
    eng = _engine("port", dec)
    _slow_steps(eng, 0.03)
    srv = tserving.InferenceServer(engine=eng).start()
    httpd = tserving.build_http_server(srv, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, name="pt-serve-http")
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=30)
        conn.request("POST", "/generate", json.dumps(
            {"prompt": [4, 5], "max_new_tokens": 20, "stream": True}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        first = resp.fp.readline()
        assert b'"token"' in first
        httpd.kill()
        rest = b""
        try:
            rest = resp.read()
        except (http.client.IncompleteRead, ConnectionError, OSError):
            pass
        assert b'"done"' not in rest
        conn.close()
    finally:
        t.join(timeout=10)
        srv.shutdown(drain=False, timeout=30)
    assert not t.is_alive()
    assert eng.page_accounting()["leaked"] == 0


# ----------------------------------------------------------- cli serve
def _serve_proc(tmp_path, decoders):
    import os
    import subprocess
    import sys
    _, tdec = decoders
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    np.savez(tmp_path / "w.npz",
             **{k: v.numpy() for k, v in tdec.p.items()})
    cfg = tmp_path / "decode_cfg.py"
    cfg.write_text(
        "import numpy as np\n"
        "from paddle_tpu_torch.models import TransformerDecoder\n"
        f"w = dict(np.load({str(tmp_path / 'w.npz')!r}))\n"
        "decoder = TransformerDecoder(w, n_layers=2, n_heads=2,\n"
        "                             device='cpu')\n")
    flight = tmp_path / "flight"
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "serve",
         "--decode_config", str(cfg), "--gen_slots", "4",
         "--gen_page_size", "4", "--flight_dir", str(flight),
         "--event_log", str(tmp_path / "events.jsonl"),
         "--run_id", "run-cli-test", "--profile_every", "2"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root,
                           CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    first = json.loads(proc.stdout.readline())
    assert first["status"] == "serving", first
    return proc, f"http://127.0.0.1:{first['port']}", flight


def _bundle_reasons(flight):
    import os
    return sorted(json.load(open(flight / f))["reason"]
                  for f in os.listdir(flight))


def test_cli_serve_admin_quit_drains_with_a_postmortem(tmp_path,
                                                        decoders):
    proc, base, flight = _serve_proc(tmp_path, decoders)
    try:
        code, _, body = _json(base + "/generate",
                              {"prompt": [1, 2, 3], "max_new_tokens": 3})
        assert code == 200 and len(body["tokens"]) == 3
        code, _, prof = _json(base + "/profile")
        assert prof["profile"]["enabled"] is True
        code, _, body = _json(base + "/admin/quit", {})
        assert code == 200 and body["quitting"] is True
        assert body["replica"]["run_id"] == "run-cli-test"
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert last["status"] == "stopped"
    assert last["stats"]["engine"]["finished"] == 1
    assert _bundle_reasons(flight) == ["admin_quit"]
    recs = [json.loads(x) for x in
            (tmp_path / "events.jsonl").read_text().splitlines()]
    assert all(r["run_id"] == "run-cli-test" for r in recs)


def test_cli_serve_sigterm_drains_with_a_postmortem(tmp_path, decoders):
    import signal
    proc, base, flight = _serve_proc(tmp_path, decoders)
    try:
        code, _, body = _json(base + "/generate",
                              {"prompt": [4, 5], "max_new_tokens": 2})
        assert code == 200
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1])["status"] == "stopped"
    assert _bundle_reasons(flight) == ["sigterm"]
