"""Shared builders of the port's fleet tests (test_torch_fleet.py,
test_torch_fleet_faults.py, test_torch_autopilot.py): the tiny decoder
of tests/test_fleet.py (vocab 40, d 16, 2 heads, 2 layers, pages of 4)
drawn once by the JAX package and carried into the port through one
``paddle_tpu.params.v1`` tar, in-process replicas of either package
behind their HTTP fronts, and the subprocess topology helpers (a
``cli.py serve`` decode config that reads the tar with the port
alone)."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

import jax
import paddle_tpu as jpaddle
from paddle_tpu import models as jmodels
from paddle_tpu import serving as jserving
from paddle_tpu.trainer.parameters import Parameters as JParameters

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import decode as tdecode
from paddle_tpu_torch.params import load_params_tar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEC_CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2,
               d_ff=32, max_len=32)
PAGE = 4
SEED = 7


def jax_table(seed=SEED):
    """The JAX package's init of the tiny transformer_lm
    (tests/test_fleet.py's ``tiny_decoder``) as a parameter dict."""
    jpaddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = jmodels.transformer_lm(**DEC_CFG)
    costs = spec.cost if isinstance(spec.cost, list) else [spec.cost]
    topo = jpaddle.Topology(costs, extra_outputs=[spec.output])
    return topo.init_params(jax.random.PRNGKey(seed))


def write_tar(path, seed=SEED):
    """One weight tar for both packages; returns the JAX params."""
    params = jax_table(seed)
    with open(path, "wb") as f:
        JParameters(params).to_tar(f)
    return params


def jax_decoder(params):
    return jmodels.TransformerDecoder(params, n_layers=DEC_CFG["n_layers"],
                                      n_heads=DEC_CFG["n_heads"])


def port_decoder(tar_path):
    with open(tar_path, "rb") as f:
        table = load_params_tar(f)
    return tdecode.TransformerDecoder(table, n_layers=DEC_CFG["n_layers"],
                                      n_heads=DEC_CFG["n_heads"],
                                      device="cpu")


def direct_tokens(dec, prompt, n):
    """Greedy decode of one prompt through a decoder's dense path."""
    out = dec.generate(np.asarray(prompt, "int32")[None, :],
                       max_len=len(prompt) + n)[0]
    return [int(t) for t in out]


class Replica:
    """One in-process serving replica of either package: decode engine
    + InferenceServer + HTTP front on a loopback port. Same weights on
    every replica — greedy decode is then deterministic across the
    fleet, which is what makes mid-stream failover token-exact."""

    def __init__(self, rid, dec, pkg="port", max_queue=8, on_quit=None,
                 **engine_kw):
        mod = tserving if pkg == "port" else jserving
        self.rid = rid
        self.dec = dec
        kw = dict(num_slots=2, page_size=PAGE,
                  max_seq_len=DEC_CFG["max_len"])
        kw.update(engine_kw)
        self.engine = mod.DecodeEngine(dec, **kw)
        self.server = mod.InferenceServer(None, max_queue=max_queue,
                                          workers=1, breaker=False,
                                          engine=self.engine).start()
        self.httpd = mod.build_http_server(self.server, "127.0.0.1", 0,
                                           on_quit=on_quit)
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True,
                                   name=f"pt-test-replica-{rid}")
        self._t.start()
        self._killed = False

    def kill(self):
        """In-process SIGKILL twin: tear every live connection."""
        self._killed = True
        self.httpd.kill()

    def stop(self):
        if not self._killed:
            self.httpd.shutdown()
            self.httpd.server_close()
        self._t.join(timeout=10)
        self.server.shutdown(drain=True, timeout=30)


def fleet(Router, dec, n=2, pkg="port", router_kw=None, **engine_kw):
    reps = {f"r{i}": Replica(f"r{i}", dec, pkg=pkg, **engine_kw)
            for i in range(n)}
    kw = dict(affinity="prefix", page_size=PAGE, scrape_interval=0.1,
              queue_timeout=2.0, queue_poll=0.02, drain_timeout=5.0)
    kw.update(router_kw or {})
    router = Router(endpoints={r.rid: r.endpoint for r in reps.values()},
                    **kw)
    return reps, router


def stop_fleet(reps, router):
    router.shutdown(drain=True, timeout=10)
    for r in reps.values():
        r.stop()


def wait_scraped(router, n, timeout=10.0):
    """Refresh until ``n`` replicas are live and scraped."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        router.refresh()
        live = [s for s in router.balancer.replicas().values()
                if s.live and s.last_scrape > 0]
        if len(live) >= n:
            return
        time.sleep(0.02)
    raise AssertionError(f"fewer than {n} replicas scraped in {timeout}s")


def http_json(url, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), dict(r.headers)


# ------------------------------------------------------ subprocess fleets
#: a ``cli.py serve --decode_config`` script for the port: the tiny
#: decoder from the tar named by $FLEET_TEST_TAR, on the CPU; with
#: $FLEET_TEST_THROTTLE each paged decode step sleeps that many seconds
#: (the subprocess serve CLI has no throttle flag, and a kill must land
#: genuinely mid-stream)
PORT_DEC_SRC = """\
import os
import time as _time
from paddle_tpu_torch.models.decode import TransformerDecoder
from paddle_tpu_torch.params import load_params_tar
with open(os.environ["FLEET_TEST_TAR"], "rb") as _f:
    _table = load_params_tar(_f)
decoder = TransformerDecoder(_table, n_layers=2, n_heads=2, device="cpu")
_throttle = float(os.environ.get("FLEET_TEST_THROTTLE", "0") or 0)
if _throttle:
    _orig_paged = decoder.paged

    def _slow_paged(**kw):
        pd = _orig_paged(**kw)
        _step = pd.step

        def _throttled(*a, **k):
            _time.sleep(_throttle)
            return _step(*a, **k)
        pd.step = _throttled
        return pd
    decoder.paged = _slow_paged
"""


def proc_env(host_tag, tar=None, throttle=0.0):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PADDLE_TPU_HOST"] = host_tag
    env["CUDA_VISIBLE_DEVICES"] = ""
    if tar is not None:
        env["FLEET_TEST_TAR"] = str(tar)
    env["FLEET_TEST_THROTTLE"] = str(throttle)
    return env


def cli_proc(args, env):
    return subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.cli"]
                            + [str(a) for a in args],
                            stdout=subprocess.PIPE, text=True, env=env)


def read_status(proc, timeout=120.0):
    """The daemon's first JSON status line, with its own timeout."""
    out = {}

    def read():
        out["line"] = proc.stdout.readline()

    t = threading.Thread(target=read, daemon=True, name="pt-test-status")
    t.start()
    t.join(timeout)
    line = out.get("line")
    if not line:
        raise AssertionError(f"no status line within {timeout}s "
                             f"(exit {proc.poll()})")
    return json.loads(line)


def stop_proc(proc, timeout=30.0):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout)


def coordinator_proc(tmp_path, lease):
    from paddle_tpu_torch.reader import recordio as rio
    data = str(tmp_path / "seed.ptr")
    rio.write_records(data, [b"r0", b"r1"], max_chunk_bytes=64)
    return cli_proc(["coordinator", "--data", data, "--worker_lease",
                     lease], proc_env("coord"))


def serve_proc(cport, rid, cfg, tar, journal, throttle=0.0, extra=()):
    return cli_proc(["serve", "--decode_config", cfg, "--gen_slots", 2,
                     "--gen_page_size", PAGE, "--workers", 1,
                     "--coordinator", f"127.0.0.1:{cport}",
                     "--replica_id", rid, "--heartbeat", 0.5,
                     "--event_log", journal, *extra],
                    proc_env(rid, tar, throttle))


def read_stream(resp, stop_after=None):
    """NDJSON records off a streaming /generate response until the
    terminal record, EOF, or ``stop_after`` token records. Returns
    (token_records, done_record_or_None, torn)."""
    tokens, done, torn = [], None, False
    try:
        while True:
            line = resp.readline()
            if not line:
                torn = done is None
                break
            rec = json.loads(line)
            if rec.get("done"):
                done = rec
                break
            if "token" in rec:
                tokens.append(rec["token"])
                if stop_after is not None and len(tokens) >= stop_after:
                    break
    except (OSError, json.JSONDecodeError):
        torn = True
    return tokens, done, torn


def stream_open(base, body, timeout=120):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)

