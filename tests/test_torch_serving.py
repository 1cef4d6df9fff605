"""The port's serving front on the CPU: InferenceServer.generate and
POST /generate over a loopback HTTP server, both against the JAX
package's dense ``TransformerDecoder.generate``, the typed admission
errors and the serve CLI's wiring — with the server built the JAX
package's way, ``InferenceServer(model, engine=...)``, including from
a JAX-saved inference artifact served on POST /infer."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu import models

from paddle_tpu_torch.models import decode as pt_decode
from paddle_tpu_torch.serving import (DecodeEngine, InferenceServer,
                                      Rejected, ServerClosed,
                                      build_http_server)

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)


@pytest.fixture(scope="module")
def decoders():
    paddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = models.transformer_lm(**CFG)
    topo = paddle.Topology([spec.cost], extra_outputs=[spec.output])
    params = topo.init_params(jax.random.PRNGKey(7))
    jdec = models.TransformerDecoder(params, n_layers=2, n_heads=2)
    table = {k: np.asarray(v) for k, v in params.items()}
    tdec = pt_decode.TransformerDecoder(table, n_layers=2, n_heads=2,
                                        device="cpu")
    return jdec, tdec, table


def _engine(tdec, **kw):
    return DecodeEngine(tdec, num_slots=2, page_size=4,
                        max_seq_len=CFG["max_len"], **kw)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_server_generate_matches_reference(decoders):
    jdec, tdec, _ = decoders
    prompt = np.array([3, 9, 1, 4, 4], np.int32)
    want = jdec.generate(prompt[None, :], max_len=len(prompt) + 7)[0]
    srv = InferenceServer(engine=_engine(tdec)).start()
    try:
        assert srv.health()["status"] == "ok"
        got = srv.generate(prompt, 7)
        again = srv.generate(prompt, 7)
    finally:
        srv.shutdown()
    assert got == [int(t) for t in want] == again
    st = srv.stats()
    assert st["engine"]["finished"] == 2
    assert st["engine"]["prefix_hit_pages"] >= 1
    assert srv.health()["status"] == "stopped"
    with pytest.raises(ServerClosed):
        srv.submit_generate(prompt, 2)


def test_http_generate_health_stats(decoders):
    jdec, tdec, _ = decoders
    prompt = [5, 2, 8, 8, 1, 0, 3]
    want = jdec.generate(np.asarray(prompt, np.int32)[None, :],
                         max_len=len(prompt) + 6)[0]
    srv = InferenceServer(engine=_engine(tdec)).start()
    httpd = build_http_server(srv, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, name="pt-serve-http")
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body = _post(base + "/generate",
                           {"prompt": prompt, "max_new_tokens": 6})
        assert code == 200, body
        assert body["tokens"] == [int(x) for x in want]
        assert body["prefix_hit_pages"] == 0
        assert body["accepted_tokens"] == 0 and body["trace_id"]
        code, body = _post(base + "/generate",
                           {"prompt": prompt, "max_new_tokens": 6})
        assert code == 200 and body["prefix_hit_pages"] >= 1
        code, body = _post(base + "/generate", {"prompt": []})
        assert code == 400
        code, body = _post(base + "/generate",
                           {"prompt": [1] * 30, "max_new_tokens": 9})
        assert code == 503 and body["reason"] == "kv_capacity"
        code, health = _get(base + "/health")
        assert code == 200 and health["status"] == "ok"
        code, stats = _get(base + "/stats")
        assert stats["engine"]["finished"] == 2
        assert stats["engine"]["rejected_capacity"] == 1
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()
        srv.shutdown()
    assert not t.is_alive()


def test_full_queue_rejects_typed(decoders):
    """The engine's bounded wait queue: with no loop thread stepping,
    the (max_waiting + 1)-th request is shed with Rejected queue_full
    and a retry hint; the queued ones then complete."""
    _, tdec, _ = decoders
    srv = InferenceServer(engine=_engine(tdec, max_waiting=2))
    reqs = [srv.submit_generate([1, 2, 3], 2) for _ in range(2)]
    with pytest.raises(Rejected) as ei:
        srv.submit_generate([1, 2, 3], 2)
    assert ei.value.reason == "queue_full" and ei.value.retry_after > 0
    assert srv.stats()["engine"]["rejected_queue"] == 1
    srv.engine.run(timeout=60)
    assert all(len(r.get(timeout=1)) == 2 for r in reqs)


def test_cli_builds_engine_from_decode_config(decoders, tmp_path):
    """``serve --decode_config``: the script defines ``decoder``; the
    flags reach the engine."""
    from paddle_tpu_torch import cli
    _, _, table = decoders
    np.savez(tmp_path / "w.npz", **table)
    cfg = tmp_path / "decode_cfg.py"
    cfg.write_text(
        "import numpy as np\n"
        "from paddle_tpu_torch.models import TransformerDecoder\n"
        f"w = dict(np.load({str(tmp_path / 'w.npz')!r}))\n"
        "decoder = TransformerDecoder(w, n_layers=2, n_heads=2,\n"
        "                             device='cpu')\n")
    args = cli.build_parser().parse_args(
        ["serve", "--decode_config", str(cfg), "--gen_slots", "3",
         "--gen_page_size", "8", "--prefix_cache", "off",
         "--max_queue", "5"])
    eng = cli._build_engine(args)
    assert eng.num_slots == 3 and eng.page_size == 8
    assert eng.prefix is None and eng.max_waiting == 5
    r = eng.submit([1, 2], 3)
    eng.run(timeout=60)
    assert len(r.get(timeout=1)) == 3


def test_server_from_jax_artifact_infers_like_reference(decoders, tmp_path):
    """``InferenceServer(model_path, engine=eng)``, the JAX package's
    call: the model is a merged artifact the JAX package saved, loaded
    by the port (on the CPU after ``init(use_gpu=False)``). POST /infer
    matches ``paddle_tpu``'s ``load_inference_model(...).forward_batch``
    on the same rows (atol 1e-5); /generate is served beside it."""
    from paddle_tpu.trainer import inference as jinf
    from paddle_tpu_torch import config as tconfig
    _, tdec, _ = decoders
    L = paddle.layer
    x = L.data("x", paddle.data_type.dense_vector(12))
    h = L.fc(x, size=16, act=paddle.activation.Relu())
    out = L.fc(h, size=5, act=paddle.activation.Softmax())
    params = paddle.create_parameters(paddle.Topology(out))
    path = str(tmp_path / "mlp.tar")
    jinf.save_inference_model(path, out, params)
    rows = np.random.RandomState(3).randn(7, 12).astype(np.float32)
    want = jinf.load_inference_model(path).forward_batch(
        [(r,) for r in rows])[0]
    tconfig.init(use_gpu=False, seed=0)
    try:
        srv = InferenceServer(path, engine=_engine(tdec)).start()
    finally:
        tconfig.init(seed=0)
    httpd = build_http_server(srv, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, name="pt-serve-http")
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body = _post(base + "/infer", {"rows": rows.tolist()})
        assert code == 200, body
        np.testing.assert_allclose(np.asarray(body["outputs"]), want,
                                   rtol=0, atol=1e-5)
        code, body = _post(base + "/generate",
                           {"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert code == 200 and len(body["tokens"]) == 2
        st = srv.stats()
        assert st["served"] == 1 and st["engine"]["finished"] == 1
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()
        srv.shutdown()
