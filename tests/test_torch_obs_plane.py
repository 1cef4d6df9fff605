"""The rest of the port's obs plane against the JAX package's, on the
CPU: the declared catalog, the journal/trace merge, the protocol
witness and the standalone obs endpoint.

Every comparison is exact (JSON-equal records, offsets, counters and
violations; the HTTP payloads equal once each package's own envelope
fields — ``ts``, ``run_id`` — are set aside).
"""

from __future__ import annotations

import json
import os
import random
import urllib.error
import urllib.request

import pytest

import paddle_tpu.obs as jobs
import paddle_tpu_torch.obs as tobs
from paddle_tpu.obs import catalog as jcatalog
from paddle_tpu.obs import merge as jmerge
from paddle_tpu.obs import protocol as jprotocol
from paddle_tpu_torch.obs import catalog as tcatalog
from paddle_tpu_torch.obs import httpd as thttpd
from paddle_tpu_torch.obs import merge as tmerge
from paddle_tpu_torch.obs import protocol as tprotocol


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


# ------------------------------------------------------------------ catalog
def test_catalog_as_dict_equals_jax():
    got = json.dumps(tcatalog.catalog_as_dict(), sort_keys=True)
    want = json.dumps(jcatalog.catalog_as_dict(), sort_keys=True)
    assert got == want
    assert set(tcatalog.PROTOCOLS) == set(jcatalog.PROTOCOLS)
    assert tcatalog.journal_entry("serving", "hop").required == \
        ("trace_id", "phase")
    rec = {"domain": "fleet", "kind": "route", "trace_id": "t"}
    assert tcatalog.protocol_for_start(rec).name == \
        jcatalog.protocol_for_start(rec).name == "fleet_request"


# -------------------------------------------------------------------- merge
def _journal(path, host, pid, seed, n=12, t0=1000.0, sync=None):
    """A seeded journal of ``n`` records (some clock_sync ones), written
    as JSON lines the way EventJournal writes them."""
    rng = random.Random(seed)
    t = t0
    with open(path, "w") as f:
        for i in range(n):
            t += rng.uniform(0.01, 0.5)
            rec = {"v": 1, "ts": round(t, 6), "seq": i + 1, "pid": pid,
                   "domain": rng.choice(["trainer", "engine", "serving"]),
                   "kind": rng.choice(["oom", "step", "hop"]),
                   "run_id": f"run-{host}", "host": host,
                   "step": i}
            if sync is not None and i in (2, 7):
                rec.update(domain="coordinator", kind="clock_sync",
                           offset_s=sync + 0.01 * i, rtt_s=0.002,
                           samples=8)
            f.write(json.dumps(rec) + "\n")
        f.write('{"v": 1, "ts": 99')            # a torn final line


def _trace(path, host, pid, seed, n=6, meta_pid=True):
    rng = random.Random(seed)
    evs = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "x"}}]
    for i in range(n):
        ev = {"ph": "X", "name": f"span{i}", "ts": rng.uniform(0, 1e6),
              "dur": 10.0, "tid": 1, "args": {"i": i}}
        if i % 3 != 2:
            ev["pid"] = pid
        evs.append(ev)
    meta = {"host": host, "pid": pid, "run_id": "r"} if meta_pid else {}
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "metadata": meta}, f)


@pytest.fixture
def streams(tmp_path):
    js = []
    for k, (host, pid, sync) in enumerate([("hostA", 11, 2.5),
                                           ("hostB", 11, None),
                                           ("hostC", 42, -0.75)]):
        p = str(tmp_path / f"j{k}.jsonl")
        _journal(p, host, pid, seed=k, sync=sync)
        js.append(p)
    ts = []
    for k, (host, pid) in enumerate([("hostA", 11), ("hostB", 11),
                                     ("hostC", 7)]):
        p = str(tmp_path / f"t{k}.json")
        _trace(p, host, pid, seed=10 + k, meta_pid=k != 2)
        ts.append(p)
    return js, ts


@pytest.mark.parametrize("offsets", [
    None,
    {"hostB": 1.25},
    # an explicit offset beats the journal's own clock_sync record,
    # by host and by path
    {"hostA": -3.0, "hostC": 0.5},
    "by_path",
])
def test_merge_journals_equals_jax(streams, tmp_path, offsets):
    js, _ = streams
    if offsets == "by_path":
        offsets = {js[0]: 7.0, "hostA": -1.0}
    for p in js:
        assert tmerge.journal_clock_offset(p) == \
            jmerge.journal_clock_offset(p)
    assert tmerge.journal_clock_offset(js[0]) == pytest.approx(2.57)
    got = tmerge.merge_journals(js, offsets,
                                out=str(tmp_path / "port.jsonl"))
    want = jmerge.merge_journals(js, offsets,
                                 out=str(tmp_path / "jax.jsonl"))
    assert got == want
    assert [r["mseq"] for r in got] == list(range(1, len(got) + 1))
    assert all(a["ts_adj"] <= b["ts_adj"] for a, b in zip(got, got[1:]))
    with open(tmp_path / "port.jsonl") as a, open(tmp_path / "jax.jsonl") as b:
        assert a.read() == b.read()
    if offsets and "hostA" in offsets and js[0] not in offsets:
        rec = next(r for r in got if r["host"] == "hostA")
        assert rec["ts_adj"] == pytest.approx(rec["ts"] - offsets["hostA"])


def test_merge_of_port_written_journals(tmp_path):
    """Journals the port's EventJournal wrote merge the same in both
    packages, with a monotone mseq and both processes' records."""
    paths = []
    for k in range(2):
        j = tobs.EventJournal()
        p = str(tmp_path / f"port{k}.jsonl")
        j.configure(p)
        for i in range(5):
            j.emit("trainer", "step", i=i, who=k)
        if k == 1:
            j.emit("coordinator", "clock_sync", offset_s=0.25, rtt_s=0.001,
                   samples=4)
        j.configure(None)
        paths.append(p)
    got = tmerge.merge_journals(paths)
    assert got == jmerge.merge_journals(paths)
    assert len(got) == 11
    assert [r["mseq"] for r in got] == list(range(1, 12))


@pytest.mark.parametrize("offsets", [None, {"hostB": 0.5, "hostC": -2.0}])
def test_merge_traces_equals_jax(streams, tmp_path, offsets):
    _, ts = streams
    got = tmerge.merge_traces(ts, offsets, out=str(tmp_path / "p.json"))
    want = jmerge.merge_traces(ts, offsets, out=str(tmp_path / "j.json"))
    assert got == want
    labels = [e["args"]["name"] for e in got["traceEvents"]
              if e.get("ph") == "M"]
    assert "hostA pid=11" in labels and "hostB pid=11" in labels
    lanes = {e["pid"] for e in got["traceEvents"] if e.get("ph") == "M"}
    assert len(lanes) == len(labels)             # colliding pids remapped


def test_merge_main_equals_jax(streams, tmp_path, capsys):
    js, ts = streams
    outs = {}
    for name, mod in (("port", tmerge), ("jax", jmerge)):
        oj, ot = str(tmp_path / f"{name}.jsonl"), str(tmp_path / f"{name}.t")
        assert mod.main(["--journal", *js, "--trace", *ts,
                         "--out-journal", oj, "--out-trace", ot,
                         "--offset", "hostB=0.125"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        line.pop("out_journal"), line.pop("out_trace")
        with open(oj) as f1, open(ot) as f2:
            outs[name] = (line, f1.read(), json.load(f2))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["records"] == 36
    with pytest.raises(SystemExit):
        tmerge.main(["--journal", js[0], "--offset", "nonsense"])


# ------------------------------------------------------------------ witness
def _stream():
    """One record stream over the declared machines: a torn hop, an
    orphan settle, a superseded hop, a fleet request extended by a
    re-route then settled twice, a spill restored, a reject with no
    route (legal), a shard killed and never restored (unterminated)."""
    recs = [
        ("serving", "hop", {"trace_id": "t1", "phase": "start"}),
        ("serving", "hop", {"trace_id": "t1", "phase": "torn",
                            "streamed": 2}),
        ("serving", "hop", {"trace_id": "t2", "phase": "settle",
                            "tokens": 4}),
        ("serving", "hop", {"trace_id": "t3", "phase": "start"}),
        ("serving", "hop", {"trace_id": "t3", "phase": "start"}),
        ("serving", "hop", {"trace_id": "t3", "phase": "settle",
                            "tokens": 1}),
        ("fleet", "route", {"trace_id": "t4", "replica": "r0", "hop": 0}),
        ("fleet", "failover", {"trace_id": "t4", "victim": "r0",
                               "hop": 0}),
        ("fleet", "route", {"trace_id": "t4", "replica": "r1", "hop": 1}),
        ("fleet", "settle", {"trace_id": "t4", "replica": "r1",
                             "hops": 2, "tokens": 3}),
        ("fleet", "settle", {"trace_id": "t4", "replica": "r1",
                             "hops": 2, "tokens": 3}),
        ("engine", "page_spill", {"page": 3, "key_pages": 1}),
        ("engine", "page_restore", {"page": 5, "key_pages": 1}),
        ("fleet", "reject", {"trace_id": "t5", "reason": "full"}),
        ("embed", "shard_killed", {"shard_id": 1}),
        ("serving", "hop", {"trace_id": "t6", "phase": "start"}),
        ("protocol", "violation", {"protocol": "x", "key": "y",
                                   "reason": "z"}),
    ]
    return [dict(domain=d, kind=k, seq=i + 1, **f)
            for i, (d, k, f) in enumerate(recs)]


def _witness_run(mod):
    w = mod.ProtocolWitness()
    for rec in _stream():
        w.observe_journal(rec)
    live = w.violations()
    counts = w.counts()
    opened = w.open_machines()
    late = w.finalize()
    return dict(live=live, counts=counts, opened=opened, late=late,
                after=w.counts(), n=w.violation_count)


@pytest.mark.protocol_violation_expected
def test_fresh_witness_equals_jax():
    got, want = _witness_run(tprotocol), _witness_run(jprotocol)
    assert got == want
    assert [(v["protocol"], v["key"], v["reason"]) for v in got["live"]] \
        == [("serving_hop", "t2", "orphan_terminal"),
            ("fleet_request", "t4", "orphan_terminal")]
    assert got["counts"]["completed"] == {
        "serving_hop": 2, "fleet_request": 1, "kv_page_spill": 1}
    assert got["counts"]["superseded"] == {"serving_hop": 1}
    assert sorted((v["protocol"], v["key"]) for v in got["late"]) == [
        ("embed_shard_failover", 1), ("serving_hop", "t6")]
    assert got["n"] == 4
    # the fresh witnesses journaled their violations in their own
    # package; the port's armed witness ignores protocol records
    assert len(tobs.JOURNAL.tail(50, domain="protocol",
                                 kind="violation")) == 4
    assert tobs.WITNESS.violation_count == 0


@pytest.mark.protocol_violation_expected
def test_armed_witness_sees_live_violations_and_bridges_metrics():
    """The witness armed at import: an orphan hop settle in the port's
    journal is a live violation, scraped as
    paddle_tpu_protocol_violations_total and reset by reset_all."""
    tobs.emit("serving", "hop", trace_id="a", phase="start")
    tobs.emit("serving", "hop", trace_id="a", phase="settle", tokens=1)
    assert tobs.WITNESS.violation_count == 0
    tobs.emit("serving", "hop", trace_id="b", phase="settle", tokens=1)
    assert tobs.WITNESS.violation_count == 1
    assert tobs.JOURNAL.tail(1, domain="protocol")[0]["key"] == "b"
    text = tobs.REGISTRY.exposition()
    assert 'paddle_tpu_protocol_violations_total{protocol="serving_hop"} 1' \
        in text
    assert 'paddle_tpu_protocol_completed{protocol="serving_hop"} 1' in text
    tobs.reset_all()
    assert tobs.WITNESS.violation_count == 0
    assert "paddle_tpu_protocol_" not in tobs.REGISTRY.exposition()


# -------------------------------------------------------------------- httpd
def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _strip(payload):
    """An /events payload without each package's own envelope."""
    return [{k: v for k, v in r.items() if k not in ("ts", "run_id")}
            for r in payload["events"]], payload["last_seq"]


def test_httpd_endpoints_match_jax():
    for journal in (tobs.JOURNAL, jobs.JOURNAL):
        for i in range(6):
            journal.emit("trainer" if i % 2 else "data",
                         "oom" if i % 3 else "quarantine", i=i,
                         microbatch=8, accum_steps=1, count=1, where="x")
    servers = [thttpd.start_obs_server(), jobs.start_obs_server()]
    try:
        bases = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        for path in ("/events", "/events?n=2", "/events?domain=trainer",
                     "/events?kind=oom&n=10", "/events?since_seq=3",
                     "/events?n=x", "/health", "/nope", "/profile?deep_steps=x"):
            (c1, b1), (c2, b2) = [_get(b, path) for b in bases]
            assert c1 == c2, path
            p1, p2 = json.loads(b1), json.loads(b2)
            if path.startswith("/events") and c1 == 200:
                assert _strip(p1) == _strip(p2), path
            else:
                assert p1 == p2, path
        (c1, m1), (c2, m2) = [_get(b, "/metrics") for b in bases]
        assert c1 == c2 == 200 and m1.endswith("\n")
        (c1, f1), (c2, f2) = [_get(b, "/flight") for b in bases]
        f1, f2 = json.loads(f1), json.loads(f2)
        assert c1 == c2 == 200 and f1["v"] == f2["v"] == 1
        assert f1["reason"] == f2["reason"] == "http"
        assert [r["kind"] for r in f1["journal"]["tail"]] == \
            [r["kind"] for r in f2["journal"]["tail"]]
        assert set(f1) == set(f2)
        (c1, q1), (c2, q2) = [_get(b, "/profile") for b in bases]
        assert c1 == c2 == 200
        assert set(json.loads(q1)) == set(json.loads(q2)) == {"profile",
                                                             "slo"}
    finally:
        for s in servers:
            s.shutdown()
    # the port's shutdown joins its thread
    assert not servers[0].thread.is_alive()


def test_serving_front_shares_the_obs_handlers():
    """The front's /events, /flight and /profile are the endpoint's own
    payload functions (one implementation)."""
    import inspect

    from paddle_tpu_torch.serving import http as front
    src = inspect.getsource(front.build_http_server)
    for fn in ("events_payload", "flight_payload", "profile_payload",
               "send_json", "send_text"):
        assert fn in src and getattr(front, fn) is getattr(thttpd, fn)
    assert "JOURNAL.tail" not in src and "FLIGHT.bundle" not in src
    code, payload = thttpd.events_payload({"n": ["0"]})
    assert code == 200 and payload["events"] == []


@pytest.mark.protocol_violation_expected
def test_violation_triggers_a_flight_dump(tmp_path):
    """A live violation's own protocol/violation record is a flight
    auto-dump trigger: the bundle holding the offending chain is on
    disk before anyone asks."""
    tobs.FLIGHT.configure(dump_dir=str(tmp_path), min_dump_interval=0)
    try:
        tobs.emit("serving", "hop", trace_id="gone", phase="torn",
                  streamed=3)
    finally:
        tobs.FLIGHT.configure(dump_dir=None)
    dumps = [f for f in os.listdir(tmp_path) if "protocol_violation" in f]
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as f:
        bundle = json.load(f)
    rec = [r for r in bundle["journal"]["tail"]
           if r["domain"] == "protocol"][0]
    assert (rec["protocol"], rec["key"], rec["reason"]) == (
        "serving_hop", "gone", "orphan_terminal")
