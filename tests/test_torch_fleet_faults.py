"""The port's fleet chaos (testing/faults.py families (p) and (q)) over
``cli.py serve --coordinator`` replica processes on the CPU, the
counterpart of tests/test_fleet_faults.py at its size (the tiny
decoder from one weight tar, pages of 4, 2 slots a replica):

- ``kill_replica``: SIGKILL one replica mid-stream under a burst of 8
  streamed requests from 8 threads through an in-process port router —
  every request settles exactly once (``assert_exactly_once`` over the
  router's journal), every failed-over continuation equals the
  undisturbed decode, the survivors leak no KV page, and
  ``merge_journals`` over the router's and the replicas' journals
  rebuilds each failover's hop chain from the trace id alone;
- ``kill_router``: SIGKILL a ``cli.py router`` process while it relays
  a stream; the client retries the same trace id on a second router of
  the same coordinator and lands token-exact, the two routers agree on
  the home replica, and the trace settles once across the merged
  journals (the replica's hop journal shows start, torn, start,
  settle); the second router, SIGTERMed, exits 0 after leaving its
  ``fleet/router`` lease;
- ``drain_during_burst``: an admin drain under load in an in-process
  fleet loses no request, and ``undrain`` re-admits the replica;
- a ``serve --coordinator`` replica leaves the directory on SIGTERM.

One topology serves the subprocess tests: a coordinator, three
replicas (each decode step slowed by 50 ms in its decode config so a
kill lands mid-stream) and two router daemons, started together."""

import json
import os
import signal
import time

import pytest

from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.fleet import Router
from paddle_tpu_torch.obs import WITNESS
from paddle_tpu_torch.obs.events import JOURNAL
from paddle_tpu_torch.obs.merge import merge_journals
from paddle_tpu_torch.serving import (Expired, Rejected, ServerClosed,
                                      ServingError)
from paddle_tpu_torch.testing import FaultPlan, assert_exactly_once
from paddle_tpu_torch.trainer.coordinator import connect

from torch_fleet_infra import (PORT_DEC_SRC, cli_proc, coordinator_proc,
                               direct_tokens, fleet, http_json,
                               port_decoder, proc_env, read_status,
                               read_stream, serve_proc, stop_fleet,
                               stop_proc, stream_open, write_tar)

pytestmark = pytest.mark.chaos

TYPED = (Rejected, Expired, ServerClosed, ServingError)
REPLICAS = ("rA", "rB", "rC")
THROTTLE = 0.05            # seconds a decode step of a replica process
SHARED = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    JOURNAL.configure(None)
    tobs.reset_all()


@pytest.fixture(scope="module")
def topo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet-chaos")
    tar = tmp / "tiny.tar"
    write_tar(tar)
    cfg = tmp / "dec.py"
    cfg.write_text(PORT_DEC_SRC)
    coord = coordinator_proc(tmp, "2.5")
    procs, journals = {}, {}
    try:
        cport = read_status(coord)["port"]
        for rid in REPLICAS:
            journals[rid] = str(tmp / f"{rid}.jsonl")
            procs[rid] = serve_proc(cport, rid, cfg, tar, journals[rid],
                                    throttle=THROTTLE)
        for name in ("router1", "router2"):
            journals[name] = str(tmp / f"{name}.jsonl")
            procs[name] = cli_proc(
                ["router", "--coordinator", f"127.0.0.1:{cport}",
                 "--page_size", 4, "--scrape_interval", 0.2,
                 "--queue_timeout", 10.0, "--event_log", journals[name]],
                proc_env(name))
        status = {name: read_status(p) for name, p in procs.items()}
        for rid in REPLICAS:
            assert status[rid]["status"] == "serving"
            assert status[rid]["replica_id"] == rid
            assert status[rid]["device"] == "cpu"
        yield dict(tmp=tmp, cport=cport, procs=procs, journals=journals,
                   dec=port_decoder(tar),
                   endpoints={rid: f"http://127.0.0.1:{status[rid]['port']}"
                              for rid in REPLICAS},
                   bases={n: f"http://127.0.0.1:{status[n]['port']}"
                          for n in ("router1", "router2")})
    finally:
        for p in procs.values():
            stop_proc(p)
        stop_proc(coord)


def _live(topo):
    return [rid for rid in REPLICAS if topo["procs"][rid].poll() is None]


def _wait_live(stats_fn, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if stats_fn()["replicas_live"] == n:
            return
        time.sleep(0.1)
    raise AssertionError(f"replicas_live never reached {n}")


def _wait_no_leak(endpoint, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st, _ = http_json(endpoint + "/stats")
        if st["engine"]["kv_pages_leaked"] == 0 and \
                st["engine"]["active_slots"] == 0:
            break
        time.sleep(0.1)
    st, _ = http_json(endpoint + "/stats")
    return st["engine"]["kv_pages_leaked"]


def test_kill_replica_mid_stream_under_burst(topo):
    journals = dict(topo["journals"])
    journals["router"] = str(topo["tmp"] / "router.jsonl")
    JOURNAL.configure(journals["router"])
    router = Router(coordinator=connect("127.0.0.1", topo["cport"]),
                    page_size=4, scrape_interval=0.2, queue_timeout=10.0,
                    queue_poll=0.05).start()
    try:
        live = _live(topo)
        _wait_live(router.stats, len(live))
        prime = router.generate(SHARED + [39], 2)
        victim = prime.replica_chain[-1]
        proc = topo["procs"][victim]

        def one(i):
            return router.generate(SHARED + [20 + i], 8)

        with FaultPlan.kill_replica(router, victim, proc.kill,
                                    at=2) as chaos:
            results, errors = FaultPlan.burst(one, 8, threads=8,
                                              timeout=120)
        assert chaos["fired"] == 1
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
        untyped = [e for e in errors
                   if e is not None and not isinstance(e, TYPED)]
        assert untyped == []
        settled = [r for r in results if r is not None]
        assert len(settled) == 8, errors
        failed_over = [r for r in settled if r.hops >= 2]
        assert failed_over, [r.replica_chain for r in settled]
        for i, r in enumerate(results):
            # token-exact: every continuation is the undisturbed decode
            assert r.tokens == direct_tokens(topo["dec"],
                                             SHARED + [20 + i], 8), i
        for r in failed_over:
            assert r.replica_chain[0] == victim
            assert r.replica_chain[-1] != victim
        st = router.stats()
        assert st["failovers"] >= 1
        assert st["settled_failover"] >= len(failed_over)
        assert st["settled"] == len(settled) + 1
        for rid in _live(topo):
            assert _wait_no_leak(topo["endpoints"][rid]) == 0, rid
        assert WITNESS.violations() == []
        JOURNAL.configure(None)
        assert_exactly_once(journals["router"],
                            [r.trace_id for r in settled])
        merged = merge_journals([journals["router"]] +
                                [journals[rid] for rid in REPLICAS])
        for probe in failed_over:
            chain = [r for r in merged
                     if r.get("trace_id") == probe.trace_id]
            routes = [r for r in chain if r["domain"] == "fleet"
                      and r["kind"] == "route"]
            fails = [r for r in chain if r["domain"] == "fleet"
                     and r["kind"] == "failover"]
            assert routes[0]["replica"] == victim
            assert routes[-1]["replica"] == probe.replica_chain[-1]
            assert fails and fails[0]["victim"] == victim
            order = [r["mseq"] for r in (routes[0], fails[0], routes[-1])]
            assert order == sorted(order)
            settle = [r for r in chain if r["kind"] == "settle"]
            assert len(settle) == 1 and settle[0]["mseq"] > order[-1]
            victim_hops = [r for r in chain if r["kind"] == "hop"
                           and r.get("host") == victim]
            assert [r["phase"] for r in victim_hops] == ["start"]
            sib_hops = [r for r in chain if r["kind"] == "hop"
                        and r.get("host") == probe.replica_chain[-1]]
            assert [r["phase"] for r in sib_hops] == ["start", "settle"]
    finally:
        JOURNAL.configure(None)
        router.shutdown(drain=True, timeout=10)


def test_kill_router_mid_stream_and_client_retry(topo):
    bases, procs, journals = topo["bases"], topo["procs"], topo["journals"]
    live = _live(topo)
    for name, base in bases.items():
        _wait_live(lambda: http_json(base + "/stats")[0], len(live))
    tid = "q-sigkill-1"
    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    resp = stream_open(bases["router1"],
                       {"prompt": shared, "max_new_tokens": 12,
                        "stream": True, "trace_id": tid})
    tokens1, done1, _ = read_stream(resp, stop_after=2)
    assert len(tokens1) == 2 and done1 is None
    os.kill(procs["router1"].pid, signal.SIGKILL)
    procs["router1"].wait(timeout=30)
    _, done_post, torn = read_stream(resp)
    assert done_post is None and torn
    resp2 = stream_open(bases["router2"],
                        {"prompt": shared, "max_new_tokens": 12,
                         "stream": True, "trace_id": tid})
    tokens2, done2, torn2 = read_stream(resp2)
    assert not torn2 and done2 is not None
    assert done2["trace_id"] == tid
    want = direct_tokens(topo["dec"], shared, 12)
    assert tokens2 == done2["tokens"] == want
    assert tokens2[:2] == tokens1
    for rid in _live(topo):
        assert _wait_no_leak(topo["endpoints"][rid]) == 0, rid
    # the daemon's SIGTERM: drain, leave its fleet/router lease, close.
    # Both routers join as fleet/router (the JAX CLI's one id), so the
    # entry names whichever joined last, and router2's heartbeats keep
    # it alive past router1's death
    coord = connect("127.0.0.1", topo["cport"])
    info = coord.worker_info("fleet/router")
    assert info["role"] == "fleet_router"
    assert info["endpoint"] in (bases["router1"], bases["router2"])
    procs["router2"].terminate()
    out, _ = procs["router2"].communicate(timeout=60)
    assert procs["router2"].returncode == 0
    stopped = json.loads(out.strip().splitlines()[-1])
    assert stopped["status"] == "stopped"
    assert stopped["stats"]["settled"] >= 1
    assert coord.worker_info("fleet/router") is None
    merged = merge_journals([journals["router1"], journals["router2"]] +
                            [journals[rid] for rid in REPLICAS])
    assert_exactly_once(merged, [tid])
    chain = [r for r in merged if r.get("trace_id") == tid]
    settles = [r for r in chain if r["domain"] == "fleet"
               and r["kind"] == "settle"]
    assert settles[0]["host"] == "router2"
    r1 = [r for r in chain if r.get("host") == "router1"]
    assert any(r["kind"] == "route" for r in r1)
    assert not any(r["kind"] == "settle" for r in r1)
    # both routers placed the trace on one home (rendezvous over the
    # prompt's first page; neither had learned it), so the replica hop
    # journal is the dedupe witness on ONE host
    routes = [r for r in chain if r["domain"] == "fleet"
              and r["kind"] == "route"]
    assert len({r["replica"] for r in routes}) == 1
    hops = [r for r in chain if r["domain"] == "serving"
            and r["kind"] == "hop"]
    assert len({r["host"] for r in hops}) == 1
    phases = [r["phase"] for r in hops]
    assert sorted(phases) == ["settle", "start", "start", "torn"]
    assert phases[0] == "start" and phases[-1] == "settle"
    assert next(r for r in hops if r["phase"] == "torn")["streamed"] >= 2
    assert next(r for r in hops
                if r["phase"] == "settle")["tokens"] == 12
    # a replica's SIGTERM: leave first (the directory drops it at once,
    # no lease wait), then the transport, then the drain
    rid = _live(topo)[-1]
    assert coord.worker_info(f"serve/{rid}") is not None
    procs[rid].terminate()
    out, _ = procs[rid].communicate(timeout=60)
    assert json.loads(out.splitlines()[-1])["status"] == "stopped"
    assert coord.worker_info(f"serve/{rid}") is None


def test_drain_during_burst_redirects_and_settles_all(topo):
    reps, router = fleet(Router, topo["dec"], 2)
    try:
        router.refresh()
        shared = [2, 4, 6, 8, 10, 12, 14, 16]
        target = router.generate(shared + [30], 2).replica_chain[-1]
        other = ("r0", "r1")[target == "r0"]
        reps[target].engine._step_interceptor = lambda s: time.sleep(0.01)

        def one(i):
            return router.generate(shared + [31 + i], 4)

        with FaultPlan.drain_during_burst(router, target,
                                          after=3) as chaos:
            results, errors = FaultPlan.burst(one, 8, threads=4,
                                              timeout=120)
        reps[target].engine._step_interceptor = None
        assert chaos["drained"]["draining"] is True
        assert chaos["dispatches"] >= 3
        assert errors == [None] * 8
        for i, r in enumerate(results):
            assert r.tokens == direct_tokens(topo["dec"],
                                             shared + [31 + i], 4)
        health, _ = http_json(reps[target].endpoint + "/health")
        assert health["status"] == "draining"
        assert router.generate(shared + [39], 2).replica_chain == [other]
        assert router.stats()["drains"] == 1
        router.undrain(target)
        health, _ = http_json(reps[target].endpoint + "/health")
        assert health["status"] == "ok"
        assert router.balancer.get(target).routable()
        router.drain(other)      # the learned prefix now points there
        assert router.generate(shared + [30], 2).replica_chain == [target]
        for rep in reps.values():
            assert rep.engine.stats()["kv_pages_leaked"] == 0
    finally:
        stop_fleet(reps, router)
