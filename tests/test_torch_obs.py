"""Port parity of the observability plane (paddle_tpu_torch/obs/,
analysis/lockdep.py, utils/stats.py, serving/breaker.py) against the
JAX package's modules of the same paths, on the CPU.

Each case feeds the same inputs to both packages and holds the outputs
equal: the Prometheus exposition byte for byte (the run-specific
labels masked), the journal's schema, keys and ``since_seq`` paging,
the flight bundle's keys, providers and auto-dump reasons, the SLO
verdicts on one series, the breaker's state sequence under one record
sequence and one injected clock, and ``stat_timer``'s counts. The
lock-order witness reports an inversion with both stacks in both
packages. The profiler's snapshot has the JAX keys, and its live MFU
and roofline share stay at or below 1.0 on a real engine run.

The conftest resets only the JAX package's obs state between tests;
``_reset_port_obs`` resets the port's.
"""

import re
import threading

import pytest

from paddle_tpu import obs as jobs
from paddle_tpu.analysis import lockdep as jlockdep
from paddle_tpu.obs import events as jevents
from paddle_tpu.obs import flight as jflight
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import profile as jprofile
from paddle_tpu.obs import slo as jslo
from paddle_tpu.serving import breaker as jbreaker
from paddle_tpu.utils import stats as jstats

from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.analysis import lockdep as tlockdep
from paddle_tpu_torch.obs import events as tevents
from paddle_tpu_torch.obs import flight as tflight
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import profile as tprofile
from paddle_tpu_torch.obs import slo as tslo
from paddle_tpu_torch.serving import breaker as tbreaker
from paddle_tpu_torch.utils import stats as tstats

BOTH = [("jax", jmetrics, jevents, jflight, jslo, jbreaker, jstats),
        ("port", tmetrics, tevents, tflight, tslo, tbreaker, tstats)]


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


# ------------------------------------------------------------ metrics
def _feed(metrics):
    """One registry of the package ``metrics``, fed a fixed series:
    labelled counters, gauges, a histogram, and the serving stats()
    flattening with the JAX front's counter keys."""
    reg = metrics.MetricsRegistry()
    c = reg.counter("paddle_tpu_test_requests_total", "requests served",
                    ("route", "code"))
    g = reg.gauge("paddle_tpu_test_queue_depth", "queue depth")
    h = reg.histogram("paddle_tpu_test_latency_seconds",
                      "request latency", ("route",),
                      buckets=(0.01, 0.1, 1.0))
    for route, code, n in (("infer", "200", 3), ("generate", "200", 5),
                           ("generate", "429", 2), ("infer", "504", 1)):
        c.labels(route=route, code=code).inc(n)
    g.set(7)
    g.inc(2.5)
    for v in (0.004, 0.05, 0.5, 3.0, 0.07):
        h.labels(route="generate").observe(v)
    h.labels(route="infer").observe(0.2)
    stats = {"served": 12, "rejected_full": 2, "expired": 1,
             "p50_ms": 3.25, "p99_ms": 41.0, "batch_limit": None,
             "breaker": {"state": "closed", "trips": 1,
                         "failure_rate": 0.125},
             "engine": {"finished": 9, "tokens_out": 311,
                        "kv_pages_free": 40, "slot_utilization": 0.75,
                        "kv_quant": "none", "prefix_hit_pages": 4}}
    from paddle_tpu.serving.http import _COUNTER_KEYS
    info = metrics.SampleFamily("paddle_tpu_serving_replica_info", "gauge",
                                "replica identity")
    info.add({"run_id": "run-0123456789ab", "host": "host-a",
              "endpoint": "http://127.0.0.1:8080"}, 1.0)
    return reg.exposition(
        extra=metrics.stats_families("paddle_tpu_serving", stats,
                                     _COUNTER_KEYS) + [info])


def _mask(text):
    """Mask the run-specific label values (run_id, host, endpoint)."""
    return re.sub(r'(run_id|host|endpoint)="[^"]*"', r'\1="*"', text)


def test_exposition_byte_identical_to_jax():
    jtext, ttext = _feed(jmetrics), _feed(tmetrics)
    assert _mask(ttext) == _mask(jtext)
    assert "paddle_tpu_serving_engine_tokens_out 311" in ttext
    assert "# TYPE paddle_tpu_serving_served counter" in ttext
    assert 'paddle_tpu_test_latency_seconds_bucket{le="+Inf",' \
           'route="generate"} 5' in ttext


def test_stats_families_names_and_kinds_match_jax():
    from paddle_tpu.serving.http import _COUNTER_KEYS as JKEYS
    from paddle_tpu_torch.serving.http import _COUNTER_KEYS as TKEYS
    assert TKEYS == JKEYS
    stats = {"served": 1, "engine": {"steps": 4, "kv_pages_used": 3,
                                     "nested": {"deep": 1.5}},
             "status": "ok", "flag": True}
    j = [(f.name, f.kind, f.samples()) for f in
         jmetrics.stats_families("p", stats, JKEYS)]
    t = [(f.name, f.kind, f.samples()) for f in
         tmetrics.stats_families("p", stats, TKEYS)]
    assert t == j
    assert [n for n, _, _ in t] == ["p_engine_kv_pages_used",
                                    "p_engine_nested_deep",
                                    "p_engine_steps", "p_served"]


def test_stats_bridge_counts_like_jax():
    for _, _, _, _, _, _, stats in BOTH:
        stats.global_counters.bump("serving/decode_finished", 3)
        stats.global_counters.bump("serving/oom_events")
    for metrics in (jmetrics, tmetrics):
        reg = metrics.MetricsRegistry()
        reg.register_collector(metrics._stats_bridge)
        text = reg.exposition()
        assert 'paddle_tpu_counter_total{name="serving/decode_finished"}' \
               ' 3' in text
        assert 'paddle_tpu_counter_total{name="serving/oom_events"} 1' \
               in text


# ------------------------------------------------------------ journal
def _journal_run(events, path):
    j = events.EventJournal(ring_size=8)
    j.configure(str(path))
    for i in range(12):
        j.emit("serving", "shed" if i % 3 else "breaker",
               reason="queue_full", depth=i, obj=object,
               trace_id=f"t{i:02d}")
    pages, cursor = [], 0
    while True:
        got = j.tail(3, since_seq=cursor)
        if not got:
            break
        pages.append([r["seq"] for r in got])
        cursor = got[-1]["seq"]
    recs = list(events.read_journal(str(path)))
    j.configure(None)
    return j, pages, recs


def test_journal_schema_keys_and_paging_match_jax(tmp_path):
    jj, jpages, jrecs = _journal_run(jevents, tmp_path / "j.jsonl")
    tj, tpages, trecs = _journal_run(tevents, tmp_path / "t.jsonl")
    assert tevents.SCHEMA_VERSION == jevents.SCHEMA_VERSION == 1
    assert tevents.REQUIRED_FIELDS == jevents.REQUIRED_FIELDS
    assert tevents.RESERVED_FIELDS == jevents.RESERVED_FIELDS
    # the ring keeps the newest 8: paging from 0 starts at seq 5
    assert tpages == jpages == [[5, 6, 7], [8, 9, 10], [11, 12]]
    assert len(trecs) == len(jrecs) == 12
    for t, j in zip(trecs, jrecs):
        assert set(t) == set(j)
        assert {k: t[k] for k in ("v", "seq", "domain", "kind", "depth",
                                  "trace_id", "reason", "obj")} == \
            {k: j[k] for k in ("v", "seq", "domain", "kind", "depth",
                               "trace_id", "reason", "obj")}
        tevents.validate(t)
    assert tj.tail(2, kind="breaker") == [
        r for r in tj.tail(100) if r["kind"] == "breaker"][-2:]
    assert [r["seq"] for r in tj.tail(100, domain="serving",
                                       kind="breaker")] == \
        [r["seq"] for r in jj.tail(100, domain="serving", kind="breaker")]
    with pytest.raises(ValueError):
        tj.emit("serving", "shed", seq=3)
    with pytest.raises(ValueError):
        tj.emit("", "shed")


def test_journal_rotation_spans_segments_like_jax(tmp_path):
    for events, name in ((jevents, "j"), (tevents, "t")):
        j = events.EventJournal()
        path = str(tmp_path / f"{name}.jsonl")
        j.configure(path, max_bytes=600, keep=2)
        for i in range(30):
            j.emit("engine", "preemption", generated=i)
        j.configure(None)
        segs = events.journal_segments(path)
        seqs = [r["seq"] for r in events.read_journal(path)]
        assert seqs == sorted(seqs) and seqs[-1] == 30
        if name == "j":
            want = ([s.rsplit("/", 1)[-1].replace("j.", "") for s in segs],
                    seqs, j.rotations)
        else:
            got = ([s.rsplit("/", 1)[-1].replace("t.", "") for s in segs],
                   seqs, j.rotations)
    assert got == want


# ------------------------------------------------------------- flight
def _flight_run(flight, events, dump_dir):
    rec = flight.FlightRecorder(capacity=16, min_dump_interval=60.0)
    rec.configure(dump_dir=str(dump_dir))
    journal = events.EventJournal()
    journal.add_observer(rec.observe_journal)
    state = {"n": 0}

    def provider():
        state["n"] += 1
        return {"queued_trace_ids": ["a", "b"], "calls": state["n"]}

    rec.register_state_provider("serving-x", provider)
    rec.register_state_provider("dead", lambda: None)
    rec.register_state_provider(
        "sick", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    rec.record("mark", "serving/admit", trace_id="t1", queue_depth=0)
    journal.emit("serving", "shed", reason="queue_full", trace_id="t1")
    journal.emit("serving", "breaker", state="half_open")
    journal.emit("serving", "breaker", state="open", trips=1)
    journal.emit("serving", "breaker", state="open", trips=2)  # limited
    journal.emit("engine", "step_failure", error="x",
                 trace_ids=["t1", "t2"])
    import json
    import os
    reasons = sorted(json.load(open(os.path.join(str(dump_dir), f)))
                     ["reason"] for f in os.listdir(str(dump_dir)))
    b = rec.bundle("http")
    return b, reasons, rec


def test_flight_bundle_providers_and_autodump_match_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jb, jreasons, _ = _flight_run(jflight, jevents, tmp_path / "j")
    tb, treasons, trec = _flight_run(tflight, tevents, tmp_path / "t")
    assert set(tb) == set(jb)
    assert tb["v"] == jb["v"] == 1 and tb["reason"] == "http"
    assert set(tb["state"]) == set(jb["state"]) == {"serving-x", "sick"}
    assert tb["state"]["sick"]["error"].startswith("RuntimeError")
    assert treasons == jreasons == ["engine_step_failure",
                                    "serving_breaker"]
    assert [r["name"] for r in tb["ring"]] == \
        [r["name"] for r in jb["ring"]]
    step_failure = tb["ring"][-1]
    assert step_failure["trace_ids"] == ["t1", "t2"]
    assert tflight.AUTO_DUMP_TRIGGERS == jflight.AUTO_DUMP_TRIGGERS
    assert trec.dumps == 2


# ---------------------------------------------------------------- slo
SPECS = ["ttft_p50_ms<=50", "tokens_per_s>=100@8", " shed_rate <= 0.05 "]


def test_parse_objective_matches_jax():
    from dataclasses import asdict
    for spec in SPECS:
        assert asdict(tslo.parse_objective(spec)) == \
            asdict(jslo.parse_objective(spec))
    for bad in ("ttft_p50_ms", "x==3"):
        with pytest.raises(ValueError):
            tslo.parse_objective(bad)
        with pytest.raises(ValueError):
            jslo.parse_objective(bad)


def _slo_run(slo, events, monkeypatch):
    """One watchdog over one series, on an injected clock."""
    now = [1000.0]
    monkeypatch.setattr(slo.time, "monotonic", lambda: now[0])
    wd = slo.SLOWatchdog()
    seen = []
    wd.add_breach_listener(seen.append)
    wd.configure(objectives=[slo.parse_objective(s) for s in SPECS],
                 regression_factor=2.0, regression_steps=2,
                 min_samples=4, cooldown_s=5.0)
    series = [(40, 150, 0.0), (45, 140, 0.01), (60, 90, 0.0),
              (70, 80, 0.2), (80, 70, 0.3), (30, 200, 0.0),
              (90, 50, 0.5), (95, 40, 0.5), (20, 300, 0.0),
              (99, 10, 0.9)]
    cur = {}
    wd.add_source("server", lambda: dict(cur))
    verdicts = []
    for i, (ttft, tps, shed) in enumerate(series):
        cur.update(ttft_p50_ms=ttft, tokens_per_s=tps, shed_rate=shed)
        verdicts.append(sorted(b["objective"] for b in wd.evaluate()))
        now[0] += 3.0
    for dt in (10, 11, 10, 12, 10, 11, 40, 45, 10, 50, 55):
        wd.observe_step("decode", dt, {"decode_step": dt * 0.9})
        now[0] += 3.0
    recs = [(r["kind"], r.get("objective"), r.get("phase"))
            for r in events.tail(100, domain="slo")]
    return verdicts, recs, [s["detector"] for s in seen], wd.snapshot()


def test_slo_verdicts_match_jax(monkeypatch):
    jv, jrecs, jseen, jsnap = _slo_run(jslo, jevents, monkeypatch)
    tv, trecs, tseen, tsnap = _slo_run(tslo, tevents, monkeypatch)
    assert tv == jv
    assert any(tv) and trecs == jrecs and tseen == jseen
    assert ("step_regression", None, "decode_step") in trecs
    assert set(tsnap) == set(jsnap)
    assert tsnap["breaches"] == jsnap["breaches"] > 0


# ------------------------------------------------------------ breaker
def _breaker_run(breaker):
    now = [0.0]
    b = breaker.CircuitBreaker(window=8, failure_threshold=0.5,
                               min_requests=4, cooldown=1.0,
                               half_open_probes=2, clock=lambda: now[0])
    script = [True, False, False, True, False, "allow", 0.5, "allow",
              1.2, "allow", "allow", "allow", True, False, "allow", 0.4,
              "allow", 0.7, "allow", True, "allow", True, "allow",
              False, False, False, False, "allow"]
    out = []
    for step in script:
        if step == "allow":
            ok, retry = b.allow()
            out.append(("allow", ok, round(retry, 6)))
        elif isinstance(step, bool):
            b.record(step)
        else:
            now[0] += step
        out.append(b.state)
    return out, b.snapshot()


def test_breaker_state_sequence_matches_jax():
    jout, jsnap = _breaker_run(jbreaker)
    tout, tsnap = _breaker_run(tbreaker)
    assert tout == jout
    assert tsnap == jsnap
    states = [s for s in tout if isinstance(s, str)]
    assert {"closed", "open", "half_open"} <= set(states)
    flips = [r["state"] for r in tobs.tail(100, domain="serving",
                                           kind="breaker")]
    assert flips == [r["state"] for r in jobs.tail(
        100, domain="serving", kind="breaker")]
    with pytest.raises(ValueError):
        tbreaker.CircuitBreaker(failure_threshold=0.0)


# ------------------------------------------------------------ lockdep
def _invert(lockdep, tag):
    a = lockdep.named_lock(f"test.{tag}.a")
    b = lockdep.named_lock(f"test.{tag}.b")

    def ab():
        with a:
            with b:
                pass

    t = threading.Thread(target=ab, name="pt-test-lockdep")
    t.start()
    t.join()
    with b:
        with a:
            pass
    return lockdep.LOCKDEP.inversions


@pytest.mark.lockdep_allow_inversion
def test_lockdep_reports_inversion_with_both_stacks():
    jrec = _invert(jlockdep, "j")
    trec = _invert(tlockdep, "t")
    assert len(trec) == len(jrec) == 1
    t, j = trec[0], jrec[0]
    assert set(t) == set(j)
    assert t["cycle"] == "test.t.b -> test.t.a -> test.t.b"
    assert t["other_thread"] == "pt-test-lockdep"
    assert ", in ab\n" in t["other_stack"]
    assert ", in _invert\n" in t["this_stack"]
    rec = tobs.tail(10, domain="lockdep", kind="inversion")
    assert len(rec) == 1 and rec[0]["this_stack"] == t["this_stack"]
    # a flight bundle was written for it only where a dump dir is armed
    assert tflight.FLIGHT.dumps == 0
    text = tmetrics.REGISTRY.exposition()
    assert "paddle_tpu_lockdep_inversions_total 1" in text
    tlockdep.LOCKDEP.configure(on_inversion="raise")
    try:
        c = tlockdep.named_lock("test.t.c")
        d = tlockdep.named_lock("test.t.d")
        with c:
            with d:
                pass
        with pytest.raises(tlockdep.LockOrderInversion):
            with d:
                # ptlint: disable=R8(the order cycle this test provokes so the witness raises)
                with c:
                    pass
        # the raise comes after the acquisition, as in the JAX package:
        # the witness's caller owns the lock it was refused
        assert tlockdep.LOCKDEP.held_names() == ("test.t.c",)
        c.release()
        assert tlockdep.LOCKDEP.held_names() == ()
    finally:
        tlockdep.LOCKDEP.configure(on_inversion="journal")


def test_named_condition_waits_through_the_witness():
    cv = tlockdep.named_condition("test.cv")
    box = []

    def waiter():
        with cv:
            while not box:
                cv.wait(1.0)

    t = threading.Thread(target=waiter, name="pt-test-cv")
    t.start()
    with cv:
        box.append(1)
        cv.notify_all()
    t.join(5)
    assert not t.is_alive()
    assert tlockdep.LOCKDEP.held_names() == ()
    assert tlockdep.LOCKDEP.metrics_snapshot()["acquisitions"][
        "test.cv"] >= 2


# --------------------------------------------------------------- stats
def test_stat_timer_counts_and_timers_match_jax():
    for stats in (jstats, tstats):
        for _ in range(3):
            with stats.stat_timer("serving/forward"):
                pass
        with stats.stat_timer("serving/decode_step"):
            sum(range(1000))
        stats.global_counters.bump("serving/oom_events", 2)

        @stats.timed("wrapped")
        def f(x):
            return x + 1

        assert f(1) == 2
    jt, tt = jstats.global_stat.items(), tstats.global_stat.items()
    assert sorted(tt) == sorted(jt) == ["serving/decode_step",
                                        "serving/forward", "wrapped"]
    for name in tt:
        tc, ttot, tmax = tt[name].snapshot()
        jc, _, _ = jt[name].snapshot()
        assert tc == jc and ttot >= tmax > 0
    assert tstats.global_counters.items() == \
        jstats.global_counters.items() == {"serving/oom_events": 2}
    tstats.global_stat.enabled = False
    try:
        with tstats.stat_timer("off"):
            pass
    finally:
        tstats.global_stat.enabled = True
    assert "off" not in tstats.global_stat.items()


def test_trace_spans_and_chrome_export():
    from paddle_tpu_torch.obs import context
    from paddle_tpu_torch.obs.trace import TRACER
    TRACER.start(capture_compiles=True)
    with context.bind(trace_id="tid-1"):
        with tstats.stat_timer("serving/forward"):
            with TRACER.span("inner", rows=2):
                pass
    TRACER.instant("mark", k=1)
    TRACER.stop()
    spans = TRACER.spans()
    assert [s["name"] for s in spans] == ["inner", "serving/forward"]
    assert spans[0]["parent"] == "serving/forward"
    assert spans[0]["trace_id"] == "tid-1"
    ct = TRACER.chrome_trace()
    assert [e["ph"] for e in ct["traceEvents"]] == ["M", "X", "X", "i"]
    assert set(ct["metadata"]) == {"run_id", "host", "pid", "dropped"}
    # the always-on flight feed kept the spans too
    names = [r["name"] for r in tflight.FLIGHT.snapshot()]
    assert "inner" in names and "serving/forward" in names


# ------------------------------------------------------------ profiler
def test_roofline_share_never_above_one():
    for ms in (0.5, 1.0, 3.0):
        r = tprofile.roofline(ms, flops=67e9, bytes_acc=1e9,
                              peak_flops=67e12, hbm_gbps=3350.0)
        assert r == jprofile.roofline(ms, flops=67e9, bytes_acc=1e9,
                                      peak_flops=67e12, hbm_gbps=3350.0)
        if r["roofline_frac"] >= 1.0:
            assert r["mfu"] <= 1.0
    # at the bound itself both readings are exactly 1
    r = tprofile.roofline(1.0, flops=67e9, peak_flops=67e12)
    assert r["roofline_frac"] == pytest.approx(1.0)
    assert r["mfu"] == pytest.approx(1.0)
    assert tprofile.device_peak_flops("NVIDIA H100 80GB HBM3",
                                      "bfloat16") == 989e12
    assert tprofile.device_peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert tprofile.device_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert tprofile.device_peak_flops("cpu") is None


def test_cost_of_counts_a_matmul():
    import torch
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert tprofile.cost_of(torch.matmul, a, b) == (2 * 8 * 16 * 4, None)
    assert tprofile.cost_of(torch.relu, a) == (None, None)


def _profile_calls(profiler, stats):
    profiler.enable(sample_every=2)
    for _ in range(5):
        with stats.stat_timer("serving/decode_step"):
            pass
        profiler.on_step("decode")
    profiler.register_pool("engine-x", lambda: {"allocated": 3,
                                                "total_usable": 12})
    profiler.sample_memory()
    snap = profiler.snapshot()
    profiler.disable()
    return snap


def test_profiler_snapshot_keys_match_jax():
    jsnap = _profile_calls(jprofile.PROFILER, jstats)
    tsnap = _profile_calls(tprofile.PROFILER, tstats)
    assert set(tsnap) == set(jsnap)
    assert set(tsnap["kinds"]["decode"]) == set(jsnap["kinds"]["decode"])
    assert tsnap["kinds"]["decode"]["steps"] == 5
    assert set(tsnap["kinds"]["decode"]["phases"]) == {"decode_step"}
    assert tsnap["pools"] == jsnap["pools"] == {
        "engine-x": {"occupancy": 0.25, "trend_per_s": 0.0}}
    assert set(jsnap["memory"]) <= set(tsnap["memory"])
    assert set(tsnap["window"]) == set(jsnap["window"])


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    import os
    P = tprofile.PROFILER
    P.enable(sample_every=1)
    try:
        out = P.arm_window(2, str(tmp_path / "w"))
        for _ in range(3):
            P.on_step("decode")
    finally:
        P.disable()
    assert os.path.isfile(os.path.join(out, "trace.json"))
    assert P.snapshot()["window"]["last_trace_dir"] == out
    assert tobs.tail(5, domain="profile", kind="window")[0]["dir"] == out


def test_engine_live_mfu_and_share_at_most_one():
    """A real engine run under the profiler: the decode step's FLOPs are
    counted once (FlopCounterMode on an all-inactive step), the gauges
    read against an H100's float32 peak, and neither the MFU nor the
    roofline share (1 / roofline_frac) exceeds 1.0."""
    from paddle_tpu_torch import params as pt_params
    from paddle_tpu_torch.models import TransformerDecoder
    from paddle_tpu_torch.serving import DecodeEngine
    cfg = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2,
               d_ff=64, max_len=32)
    dec = TransformerDecoder(pt_params.init_transformer_lm_params(
        cfg, seed=0), n_layers=2, n_heads=2, device="cpu")
    eng = DecodeEngine(dec, num_slots=4, page_size=4, max_seq_len=32)
    P = tprofile.PROFILER
    P.configure(peak_flops=tprofile.device_peak_flops(
        "NVIDIA H100 80GB HBM3"), hbm_gbps=3350.0)
    P.enable(sample_every=2)
    try:
        reqs = [eng.submit([1 + i, 2, 3], 6) for i in range(3)]
        eng.run(timeout=60)
        P.sample_memory()
    finally:
        P.disable()
    assert all(len(r.get(timeout=1)) == 6 for r in reqs)
    snap = P.snapshot()
    flops = snap["cost"]["decode"]["flops"]
    # at least the vocab projection of 4 slots: 2 * 4 * 32 * 40
    assert flops >= 2 * 4 * 32 * 40
    mfu = snap["mfu"]["decode"]
    frac = snap["roofline_frac"]["decode"]
    # the CPU against an H100's peak: the MFU rounds to ~0; with no byte
    # count the FLOP bound binds, so the share 1 / frac is the MFU
    assert 0.0 <= mfu <= 1.0
    assert frac >= 1.0 and 1.0 / frac <= 1.0
    assert abs(1.0 / frac - mfu) < 1e-6
    assert snap["kinds"]["decode"]["phases"]["decode_step"] > 0.0
    assert snap["pools"][f"engine-{id(eng):x}"]["occupancy"] >= 0.0
    # the engine's marks carry every request's chain by trace_id
    ring = tflight.FLIGHT.snapshot()
    for r in reqs:
        names = [x["name"] for x in ring
                 if x.get("trace_id") == r.trace_id]
        assert names[:2] == ["engine/submit", "engine/admit"]
        assert names.count("engine/slot_step") >= 6
        assert names[-1] == "engine/settle"


def test_engine_warmup_counts_the_step_cost_before_any_request(
        monkeypatch):
    """With the profiler on, ``warmup()`` pays the one-time FLOP count
    (a process's first ``FlopCounterMode`` takes seconds): the sampled
    steps of the requests that follow count nothing again. Off, it
    counts nothing."""
    from paddle_tpu_torch import params as pt_params
    from paddle_tpu_torch.models import TransformerDecoder
    from paddle_tpu_torch.serving import DecodeEngine
    cfg = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2,
               d_ff=64, max_len=32)
    dec = TransformerDecoder(pt_params.init_transformer_lm_params(
        cfg, seed=0), n_layers=2, n_heads=2, device="cpu")
    P = tprofile.PROFILER
    calls = []
    real = DecodeEngine.decode_cost

    def counted(self):
        calls.append(self.stats()["steps"])
        return real(self)

    monkeypatch.setattr(DecodeEngine, "decode_cost", counted)
    DecodeEngine(dec, num_slots=2, page_size=4, max_seq_len=32).warmup()
    assert calls == []
    eng = DecodeEngine(dec, num_slots=2, page_size=4, max_seq_len=32)
    P.enable(sample_every=1)
    try:
        eng.warmup()
        assert calls == [0]
        r = eng.submit([1, 2, 3], 4)
        eng.run(timeout=60)
    finally:
        P.disable()
    assert len(r.get(timeout=1)) == 4 and calls == [0]
    assert P.snapshot()["cost"]["decode"]["flops"] >= 2 * 2 * 32 * 40
