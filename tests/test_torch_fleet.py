"""The port's serving fleet (paddle_tpu_torch/fleet/) against the JAX
package's, on the CPU at tests/test_fleet.py's size (a decoder of 2
layers, width 16, 2 heads, vocabulary 40; pages of 4), drawn once by
the JAX package and carried into the port through one weight tar.

- the pure host functions are EXACTLY the JAX ones: ``stable_prefix_key``,
  ``rendezvous_choose``, ``AffinityIndex``'s keys and matches, and
  ``FleetBalancer.choose`` / ``feasible_anywhere`` / ``stats`` on one
  seeded script of scrapes, drains, deaths and observations;
- an in-process port fleet: generate equals direct decode (and the
  JAX decoder's tokens), prefix affinity pins >= 90% of same-prefix
  requests, the typed ``fleet_kv_capacity`` reject, drain and
  re-admit, token-exact mid-stream failover, lease lapse and rejoin
  over the port's ``Coordinator`` on a fake clock, the coordinator
  outage's last-known view and its staleness bound, the router's HTTP
  front and ``/metrics`` families (those of the JAX router), and two
  routers agreeing on placement;
- mixed fleets both ways from the one tar: a JAX ``Router`` over port
  replicas and a port ``Router`` over JAX replicas, tokens equal and
  one ``fleet/settle`` per trace.
"""

import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.fleet import Router as JRouter
from paddle_tpu.fleet import balance as jbal
from paddle_tpu.fleet import build_router_http_server as jbuild_router
from paddle_tpu.obs.events import JOURNAL as JJOURNAL
from paddle_tpu.testing import assert_exactly_once as jassert_once

from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.fleet import (AffinityIndex, FleetBalancer,
                                    ReplicaRegistration, ReplicaRegistry,
                                    Router, build_router_http_server,
                                    rendezvous_choose, stable_prefix_key)
from paddle_tpu_torch.fleet.router import _HopTorn, _Reroute
from paddle_tpu_torch.obs.events import JOURNAL
from paddle_tpu_torch.serving import Rejected, ServerClosed
from paddle_tpu_torch.testing import FaultPlan, assert_exactly_once
from paddle_tpu_torch.trainer.coordinator import Coordinator

from torch_fleet_infra import (PAGE, Replica, direct_tokens, fleet,
                               http_json, jax_decoder, port_decoder,
                               stop_fleet, wait_scraped, write_tar)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """(JAX decoder, port decoder, tar path) from one weight tar."""
    tar = tmp_path_factory.mktemp("fleet") / "tiny.tar"
    params = write_tar(tar)
    return jax_decoder(params), port_decoder(tar), tar


@pytest.fixture
def dec(decoders):
    return decoders[1]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(Coordinator, "time", staticmethod(c))
    return c


# ------------------------------------------------------ pure-host parity
def test_stable_prefix_key_and_rendezvous_equal_jax():
    rng = random.Random(30)
    for _ in range(300):
        toks = [rng.randrange(0, 40) for _ in range(rng.randrange(0, 30))]
        ps = rng.choice([1, 2, 4, 16])
        assert stable_prefix_key(toks, ps) == \
            jbal.stable_prefix_key(toks, ps)
    rids = [f"r{i}" for i in range(6)]
    for i in range(300):
        key = stable_prefix_key([i, i + 1, 3, 4, 5], 4)
        sub = rids[:1 + i % 6]
        assert rendezvous_choose(key, sub) == \
            jbal.rendezvous_choose(key, sub)
        assert rendezvous_choose(key, reversed(sub)) == \
            rendezvous_choose(key, sub)
    assert rendezvous_choose(b"k", []) is None


def test_affinity_index_keys_and_matches_equal_jax():
    rng = random.Random(31)
    ours = AffinityIndex(page_size=4, max_nodes=24)
    theirs = jbal.AffinityIndex(page_size=4, max_nodes=24)
    shared = [rng.randrange(40) for _ in range(8)]
    for step in range(200):
        toks = (shared if rng.random() < 0.5 else []) + \
            [rng.randrange(40) for _ in range(rng.randrange(0, 14))]
        assert ours._keys(toks) == theirs._keys(toks)
        op = rng.random()
        if op < 0.5:
            rid = f"r{rng.randrange(3)}"
            assert ours.observe(toks, rid) == theirs.observe(toks, rid)
        elif op < 0.95:
            assert ours.match(toks) == theirs.match(toks)
        else:
            rid = f"r{rng.randrange(3)}"
            assert ours.forget(rid) == theirs.forget(rid)
        assert ours.stats() == theirs.stats()
    # tests/test_fleet.py's keying case: the final token is a query
    idx = AffinityIndex(page_size=4)
    assert idx.observe([1, 2, 3, 4], "r0") == 0
    assert idx.observe(list(range(9)), "r0") == 2
    assert idx.match([0, 1, 2, 3, 9, 9, 9, 9, 9]) == ("r0", 1)


def _balancer_script(seed, n=240):
    """One seeded script of balancer operations (scrapes at several
    page sizes with reclaimable and spill gauges, drains, deaths,
    removals, inflight, observations) with a choose/feasibility probe
    after each."""
    rng = random.Random(seed)
    shared = [rng.randrange(40) for _ in range(8)]
    ops = []
    for _ in range(n):
        rid = f"r{rng.randrange(4)}"
        u = rng.random()
        if u < 0.35:
            total = rng.choice([8, 16, 32])
            ops.append(("scrape", rid, dict(
                kv_pages_total=total,
                kv_pages_free=rng.randrange(total + 1),
                page_size=rng.choice([4, 4, 4, 8]),
                kv_pages_reclaimable=rng.randrange(4),
                kv_spill_headroom=rng.randrange(3),
                kv_pages_spilled_now=rng.randrange(3))))
        elif u < 0.45:
            ops.append(("upsert", rid, f"http://h/{rid}"))
        elif u < 0.52:
            ops.append(("drain", rid, rng.random() < 0.5))
        elif u < 0.56:
            ops.append(("dead", rid, None))
        elif u < 0.58:
            ops.append(("remove", rid, None))
        elif u < 0.66:
            ops.append(("inflight", rid, rng.choice([1, 1, -1])))
        else:
            toks = (shared if rng.random() < 0.6 else []) + \
                [rng.randrange(40) for _ in range(rng.randrange(1, 12))]
            ops.append(("observe", rid, toks))
        probe = (shared if rng.random() < 0.6 else []) + \
            [rng.randrange(40) for _ in range(rng.randrange(1, 12))]
        ops.append(("probe", probe, len(probe) + rng.randrange(1, 40),
                    {f"r{rng.randrange(4)}"} if rng.random() < 0.2
                    else set()))
    return ops


def _replay(bal, ops):
    out = []
    for op in ops:
        if op[0] == "scrape":
            bal.record_scrape(op[1], **op[2])
        elif op[0] == "upsert":
            bal.upsert(op[1], op[2])
        elif op[0] == "drain":
            bal.mark_draining(op[1], op[2])
        elif op[0] == "dead":
            bal.mark_dead(op[1])
        elif op[0] == "remove":
            bal.remove(op[1])
        elif op[0] == "inflight":
            bal.adjust_inflight(op[1], op[2])
        elif op[0] == "observe":
            bal.observe_served(op[2], op[1])
        else:
            _, toks, total, excl = op
            out.append((bal.choose(toks, total, excl),
                        bal.feasible_anywhere(total)))
    st = bal.stats()
    return out, st


@pytest.mark.parametrize("affinity", ["prefix", "load"])
def test_balancer_choices_equal_jax_on_scripted_scrapes(affinity):
    ops = _balancer_script(32 if affinity == "prefix" else 33)
    ours = _replay(FleetBalancer(affinity=affinity, page_size=16), ops)
    theirs = _replay(jbal.FleetBalancer(affinity=affinity, page_size=16),
                     ops)
    assert ours == theirs
    choices = [c[0][0] for c in ours[0]]
    assert len(set(choices)) >= 3          # the script exercises choice


def test_scrape_counts_reclaimable_trie_pages_as_headroom():
    router = Router(endpoints={"a": "http://127.0.0.1:1"}, page_size=4,
                    scrape_interval=3600.0)
    router._http_get_text = lambda ep, path: (
        "paddle_tpu_serving_engine_kv_pages_total 16\n"
        "paddle_tpu_serving_engine_kv_pages_free 0\n"
        "paddle_tpu_serving_engine_kv_pages_reclaimable 14\n"
        "paddle_tpu_serving_engine_page_size 4\n")
    router.refresh()
    st = router.balancer.get("a")
    assert st.kv_pages_free == 14 and st.kv_pages_reclaimable == 14
    assert router.balancer.choose([1, 2, 3], 8)[0] == "a"
    router.shutdown(drain=False)


# ------------------------------------------------------ in-process fleet
def test_generate_matches_direct_decode(decoders):
    jdec, dec, _ = decoders
    reps, router = fleet(Router, dec, 1)
    try:
        router.refresh()
        prompt = [3, 1, 4, 1, 5]
        want = direct_tokens(dec, prompt, 6)
        assert want == direct_tokens(jdec, prompt, 6)
        streamed = []
        res = router.generate(prompt, 6, on_token=streamed.append)
        assert res.tokens == want
        assert streamed == res.tokens
        assert res.hops == 1 and res.replica_chain == ["r0"]
    finally:
        stop_fleet(reps, router)


def test_prefix_affinity_pins_and_warm_ratio_survives_hop(dec):
    reps, router = fleet(Router, dec, 2)
    try:
        router.refresh()
        shared = list(range(1, 13))
        results = [router.generate(shared + [13 + i], 2)
                   for i in range(10)]
        homes = [r.replica_chain[-1] for r in results]
        assert max(homes.count(h) for h in set(homes)) >= 9, homes
        assert sum(r.affinity_hit for r in results) >= 9
        warm = router.generate(shared + [13], 2)
        assert warm.replica_chain[-1] == homes[0]
        assert warm.prefix_hit_pages >= 1
        st = router.stats()
        assert st["settled"] == 11 and st["failovers"] == 0
    finally:
        stop_fleet(reps, router)


def test_fleet_kv_capacity_is_typed_and_journaled(dec):
    reps, router = fleet(Router, dec, 2)
    try:
        router.refresh()
        total_pages = max(st.kv_pages_total
                          for st in router.balancer.replicas().values())
        assert total_pages > 0
        too_big = (total_pages + 1) * PAGE
        seq0 = JOURNAL.last_seq
        with pytest.raises(Rejected) as ei:
            router.generate([1] * (too_big - 1), 1)
        assert ei.value.reason == "fleet_kv_capacity"
        assert ei.value.retry_after == 0.0
        assert router.stats()["rejected_kv_capacity"] == 1
        rej = JOURNAL.tail(20, domain="fleet", kind="reject",
                           since_seq=seq0)
        assert [r["reason"] for r in rej] == ["fleet_kv_capacity"]
        assert len(router.generate([1] * 8, 2).tokens) == 2
    finally:
        stop_fleet(reps, router)


def test_drain_redirects_then_readmit(dec):
    reps, router = fleet(Router, dec, 2)
    try:
        router.refresh()
        out = router.drain("r0")
        assert out["draining"] and out["settled"]
        health, _ = http_json(reps["r0"].endpoint + "/health")
        assert health["status"] == "draining"
        for i in range(4):
            assert router.generate([20 + i, 1, 2], 2).replica_chain == \
                ["r1"]
        assert router.health()["replicas_draining"] == 1
        router.undrain("r0")
        router.drain("r1")
        assert router.generate([30, 1, 2], 2).replica_chain == ["r0"]
        health, _ = http_json(reps["r0"].endpoint + "/health")
        assert health["status"] == "ok"
        assert router.stats()["drains"] == 2
        router.shutdown(drain=True)
        with pytest.raises(ServerClosed):
            router.generate([1, 2, 3], 2)
    finally:
        stop_fleet(reps, router)


def test_failover_resumes_token_exact(dec):
    """The victim's transport is torn after 2 streamed tokens; the
    router replays prompt + streamed tokens on the sibling (a re-prefill
    over a window of several positions) and the settled stream equals
    an undisturbed solo decode. Exactly-once: one return, one settle
    record, the original trace_id on both hops."""
    reps, router = fleet(Router, dec, 2)
    victim = None
    try:
        router.refresh()
        prompt = [5, 6, 7, 8, 9, 10, 11, 12]
        victim = router.generate(prompt, 2).replica_chain[-1]
        sibling = ("r0", "r1")[victim == "r0"]
        want = direct_tokens(dec, prompt, 10)
        reps[victim].engine._step_interceptor = lambda s: time.sleep(0.02)
        streamed = []
        with FaultPlan.kill_replica(router, victim, reps[victim].kill,
                                    at=2) as chaos:
            res = router.generate(prompt, 10, on_token=streamed.append)
        assert chaos["fired"] == 1
        assert chaos["victim_traces"] == [res.trace_id]
        assert res.hops == 2 and res.replica_chain == [victim, sibling]
        assert res.tokens == want
        assert streamed == res.tokens
        st = router.stats()
        assert (st["failovers"], st["settled_failover"], st["settled"]) \
            == (1, 1, 2)
        assert not router.balancer.get(victim).live
        assert reps[sibling].engine.page_accounting()["leaked"] == 0
        assert_exactly_once(JOURNAL.tail(500, domain="fleet"),
                            [res.trace_id])
    finally:
        router.shutdown(drain=True)
        if victim is not None:
            reps[victim].server.shutdown(drain=False, timeout=10)
        for rid, r in reps.items():
            if rid != victim:
                r.stop()


def test_pre_dispatch_kill_fails_over_with_zero_streamed(dec):
    reps, router = fleet(Router, dec, 2)
    victim = None
    try:
        router.refresh()
        prompt = [21, 22, 23, 24]
        victim = router.generate(prompt, 2).replica_chain[-1]
        sibling = ("r0", "r1")[victim == "r0"]
        with FaultPlan.kill_replica(router, victim, reps[victim].kill,
                                    mid_stream=False) as chaos:
            res = router.generate(prompt, 4)
        assert chaos["fired"] == 1 and chaos["at_tokens"] == 0
        assert res.hops == 2 and res.replica_chain == [victim, sibling]
        assert res.tokens == direct_tokens(dec, prompt, 4)
    finally:
        router.shutdown(drain=True)
        if victim is not None:
            reps[victim].server.shutdown(drain=False, timeout=10)
        for rid, r in reps.items():
            if rid != victim:
                r.stop()


class _StubRouter:
    """tests/test_fleet.py's torn-stream edges on a stubbed dispatch."""

    @staticmethod
    def make(**kw):
        kwargs = dict(page_size=4, scrape_interval=3600.0,
                      queue_timeout=1.0, queue_poll=0.01)
        kwargs.update(kw)
        router = Router(endpoints={"a": "http://127.0.0.1:1",
                                   "b": "http://127.0.0.1:2"}, **kwargs)
        for rid in ("a", "b"):
            router.balancer.record_scrape(rid, kv_pages_total=16,
                                          kv_pages_free=16, page_size=4)
        return router


@pytest.mark.parametrize("edge", ["final_token", "eos", "reroute_storm"])
def test_failover_settle_edges(edge):
    router = _StubRouter.make(queue_timeout=0.3 if edge == "reroute_storm"
                              else 1.0)
    calls = []

    def dispatch(st, prompt, remaining, eos_id, deadline_s, trace_id,
                 on_token, base_count):
        calls.append(st.replica_id)
        if edge == "final_token":
            for t in (101, 102, 103):
                on_token(t)
            raise _HopTorn([101, 102, 103], "eof before done record")
        if edge == "eos":
            raise _HopTorn([55, 7], "read: torn")
        raise _Reroute("replica_queue_full", exclude=False,
                       draining=False)

    router._dispatch_stream = dispatch
    try:
        if edge == "final_token":
            streamed = []
            res = router.generate([1, 2, 3, 4], 3,
                                  on_token=streamed.append)
            assert calls == res.replica_chain and len(calls) == 1
            assert res.tokens == [101, 102, 103] == streamed
            st = router.stats()
            assert (st["settled"], st["settled_failover"],
                    st["failovers"]) == (1, 1, 1)
            other = ("a", "b")[calls[0] == "a"]
            assert router.balancer.get(other).live is True
        elif edge == "eos":
            res = router.generate([1, 2, 3, 4], 10, eos_id=7)
            assert len(calls) == 1 and res.tokens == [55, 7]
        else:
            t0 = time.monotonic()
            with pytest.raises(Rejected) as ei:
                router.generate([1, 2, 3, 4], 2)
            assert ei.value.reason == "queue_full"
            assert time.monotonic() - t0 < 5.0
            assert router.stats()["rejected_queue_full"] == 1
    finally:
        router.shutdown(drain=False)


# ------------------------------------------------ coordinator discovery
def test_lease_lapse_and_rejoin_over_coordinator(dec, clock):
    """Replicas join the port's Coordinator; a paused heartbeat lets
    the lease lapse on the fake clock (an implicit drain) while the
    sibling renews, traffic stays on the sibling, and the resumed
    heartbeat re-joins and re-admits."""
    coord = Coordinator([], worker_lease_s=5.0)
    reps = {f"r{i}": Replica(f"r{i}", dec) for i in range(2)}
    regs = {"r0": ReplicaRegistration(coord, "r0", reps["r0"].endpoint,
                                      heartbeat_s=0.05).join(),
            "r1": ReplicaRegistration(coord, "r1", reps["r1"].endpoint,
                                      heartbeat_s=3600.0).join()}
    router = Router(coordinator=coord, page_size=PAGE, queue_timeout=2.0,
                    queue_poll=0.02)
    try:
        router.refresh()
        assert router.health()["replicas_live"] == 2
        seq0 = JOURNAL.last_seq
        with FaultPlan.lease_lapse(regs["r0"]):
            clock.advance(3.0)
            assert coord.worker_heartbeat("serve/r1") >= 0
            clock.advance(3.0)             # r0's lease is 6 s old
            router.refresh()
            assert router.health()["replicas_live"] == 1
            assert coord.worker_info("serve/r0") is None
            assert router.generate([1, 2, 3], 2).replica_chain == ["r1"]
        lapse = JOURNAL.tail(50, domain="fleet", kind="lease_lapse",
                             since_seq=seq0)
        assert [r["replica"] for r in lapse] == ["r0"]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                router.health()["replicas_live"] < 2:
            router.refresh()
            time.sleep(0.02)
        assert router.health()["replicas_live"] == 2
        assert regs["r0"].rejoins >= 1
        assert router.stats()["rejoins"] >= 1
    finally:
        router.shutdown(drain=True)
        for reg in regs.values():
            reg.stop(leave=True)
        for rep in reps.values():
            rep.stop()


def test_registry_reports_restart_as_rejoin_and_leave(clock):
    coord = Coordinator([], worker_lease_s=30.0)
    events = []
    reg = ReplicaRegistry(
        coordinator=coord,
        on_join=lambda v: events.append(("join", v.replica_id)),
        on_leave=lambda rid: events.append(("leave", rid)),
        on_rejoin=lambda v: events.append(("rejoin", v.replica_id)))
    a = ReplicaRegistration(coord, "a", "http://h:1",
                            heartbeat_s=3600).join()
    assert coord.worker_info("serve/a")["boot_id"] == a.info["boot_id"]
    reg.poll()
    assert events == [("join", "a")]
    a.stop(leave=False)
    a2 = ReplicaRegistration(coord, "a", "http://h:2",
                             heartbeat_s=3600).join()
    reg.poll()
    assert events[-1] == ("rejoin", "a")
    assert reg.view()["a"].endpoint == "http://h:2"
    a2.stop(leave=True)
    reg.poll()
    assert events[-1] == ("leave", "a")


def test_coordinator_outage_keeps_view_then_bound_expires_it(clock):
    coord = Coordinator([], worker_lease_s=30.0)
    leaves = []
    fake = FakeClock(50.0)
    reg = ReplicaRegistry(coordinator=coord, on_leave=leaves.append,
                          max_stale_s=10.0, clock=fake)
    a = ReplicaRegistration(coord, "a", "http://h:1",
                            heartbeat_s=3600).join()
    reg.poll()
    seq0 = JOURNAL.last_seq
    with FaultPlan.coordinator_outage(reg):
        for _ in range(3):
            reg.poll()
            fake.advance(1.0)
        assert set(reg.view()) == {"a"} and leaves == []
        assert reg.staleness() == 3.0 and reg.stale_polls == 3
    stale = JOURNAL.tail(50, domain="fleet", kind="stale_view",
                         since_seq=seq0)
    assert len(stale) == 1 and stale[0]["replicas"] == 1
    reg.poll()
    assert reg.staleness() == 0.0
    rec = JOURNAL.tail(50, domain="fleet", kind="view_recovered",
                       since_seq=seq0)
    assert rec and rec[-1]["stale_s"] == 3.0
    # the bound: past max_stale_s the view empties and leaves fire
    with FaultPlan.coordinator_outage(reg):
        reg.poll()
        fake.advance(10.5)
        reg.poll()
        assert reg.view() == {} and leaves == ["a"]
    exp = JOURNAL.tail(50, domain="fleet", kind="stale_view_expired",
                       since_seq=seq0)
    assert exp and exp[-1]["dropped"] == ["a"]
    a.stop(leave=True)
    with pytest.raises(ValueError):
        with FaultPlan.coordinator_outage(
                ReplicaRegistry(endpoints={"r0": "http://h:1"})):
            pass


def test_router_serves_through_outage_with_zero_sheds(dec, clock):
    coord = Coordinator([], worker_lease_s=30.0)
    reps = {f"r{i}": Replica(f"r{i}", dec) for i in range(2)}
    regs = {rid: ReplicaRegistration(coord, rid, rep.endpoint,
                                     heartbeat_s=3600).join()
            for rid, rep in reps.items()}
    router = Router(coordinator=coord, page_size=PAGE, queue_timeout=2.0,
                    queue_poll=0.02)
    fake = FakeClock(7.0)
    router.registry._clock = fake
    try:
        wait_scraped(router, 2)
        before = router.stats()
        with FaultPlan.coordinator_outage(router):
            router.refresh()
            fake.advance(2.5)

            def one(i):
                res = router.generate([1 + i % 5, 2, 3], 3)
                assert len(res.tokens) == 3
                return res
            results, errors = FaultPlan.burst(one, n=8, threads=4,
                                              timeout=60)
            assert [e for e in errors if e] == []
            assert router.stats()["registry_stale_s"] == 2.5
        after = router.stats()
        for k in ("rejected_queue_full", "rejected_kv_capacity",
                  "rejected_no_replica"):
            assert after[k] == before[k], k
        assert after["replicas_live"] == 2
        router.refresh()
        assert router.stats()["registry_stale_s"] == 0.0
    finally:
        router.shutdown(drain=True, timeout=10)
        for reg in regs.values():
            reg.stop(leave=True)
        for rep in reps.values():
            rep.stop()


# ------------------------------------------------------------ router HTTP
def _fleet_families(base):
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
    return text, {ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE paddle_tpu_fleet_")}


def test_router_http_and_metrics_families_equal_jax(decoders):
    jdec, dec, _ = decoders
    reps, router = fleet(Router, dec, 1)
    jreps, jrouter = fleet(JRouter, jdec, 1, pkg="jax")
    httpd = build_router_http_server(router, "127.0.0.1", 0)
    jhttpd = jbuild_router(jrouter, "127.0.0.1", 0)
    serving = [threading.Thread(target=h.serve_forever,
                                name=f"pt-test-router-httpd-{k}")
               for k, h in enumerate((httpd, jhttpd))]
    for t in serving:
        t.start()
    base, jbase = (f"http://127.0.0.1:{h.server_address[1]}"
                   for h in (httpd, jhttpd))
    try:
        router.refresh()
        jrouter.refresh()
        bodies = []
        for b in (base, jbase):
            body, headers = http_json(
                b + "/generate", {"prompt": [1, 2, 3],
                                  "max_new_tokens": 3,
                                  "trace_id": "fleet-http-1"})
            assert body["trace_id"] == headers["X-Trace-Id"] == \
                "fleet-http-1"
            assert body["hops"] == 1 and body["replica_chain"] == ["r0"]
            bodies.append(body)
        assert bodies[0]["tokens"] == bodies[1]["tokens"] == \
            direct_tokens(dec, [1, 2, 3], 3)
        assert sorted(bodies[0]) == sorted(bodies[1])
        health, _ = http_json(base + "/health")
        jhealth, _ = http_json(jbase + "/health")
        assert health == jhealth and health["status"] == "ok"
        stats, _ = http_json(base + "/stats")
        jstats, _ = http_json(jbase + "/stats")
        assert sorted(stats) == sorted(jstats)
        text, fams = _fleet_families(base)
        assert fams == _fleet_families(jbase)[1]
        assert "# TYPE paddle_tpu_fleet_routed counter" in text
        assert "paddle_tpu_fleet_routed 1" in text
        assert "# TYPE paddle_tpu_fleet_replicas_live gauge" in text
        out, _ = http_json(base + "/admin/drain", {"replica": "r0"})
        assert out["draining"] is True
        out, _ = http_json(base + "/admin/resume", {"replica": "r0"})
        assert out["draining"] is False
        for path, body in (("/admin/drain", {"replica": "ghost"}),
                           ("/autopilot", None), ("/nope", None)):
            codes = []
            for b in (base, jbase):
                try:
                    http_json(b + path, body)
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
            assert codes[0] == codes[1] and codes[0] in (404, 501), path
        # the streamed relay: token lines, then the terminal record
        from torch_fleet_infra import read_stream, stream_open
        toks, done, torn = read_stream(stream_open(
            base, {"prompt": [1, 2, 3], "max_new_tokens": 3,
                   "stream": True}))
        assert not torn and toks == done["tokens"] == bodies[0]["tokens"]
    finally:
        for h in (httpd, jhttpd):
            h.shutdown()
            h.server_close()
        for t in serving:
            t.join(timeout=10)
        stop_fleet(reps, router)
        stop_fleet(jreps, jrouter)


def test_two_routers_agree_on_placement(dec):
    """Two port routers (no shared learned state) over one fleet put
    the same cold prompt on the same home, and so does a JAX balancer
    fed the same membership."""
    reps, r1 = fleet(Router, dec, 3)
    r2 = Router(endpoints={r.rid: r.endpoint for r in reps.values()},
                page_size=PAGE, queue_timeout=2.0, queue_poll=0.02)
    jb = jbal.FleetBalancer(affinity="prefix", page_size=PAGE)
    try:
        wait_scraped(r1, 3)
        wait_scraped(r2, 3)
        for rid, st in r1.balancer.replicas().items():
            jb.upsert(rid, st.endpoint)
            jb.record_scrape(rid, kv_pages_total=st.kv_pages_total,
                             kv_pages_free=st.kv_pages_free,
                             page_size=st.page_size)
        rng = random.Random(11)
        homes = set()
        for i in range(6):
            prompt = [rng.randrange(2, 40) for _ in range(9)]
            a = r1.generate(prompt, 2).replica_chain[0]
            b = r2.generate(prompt, 2).replica_chain[0]
            assert a == b == jb.choose(prompt, len(prompt) + 2)[0]
            homes.add(a)
        assert len(homes) >= 2
    finally:
        r2.shutdown(drain=True, timeout=10)
        stop_fleet(reps, r1)


# ------------------------------------------------------------ mixed fleets
@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_mixed_fleet_tokens_equal_and_settle_once(decoders, router_pkg):
    """One weight tar: a JAX Router over two port replicas, and a port
    Router over two JAX replicas — tokens equal the direct decode of
    both packages, and each trace settles once in the router's own
    journal."""
    jdec, dec, _ = decoders
    if router_pkg == "jax":
        reps, router = fleet(JRouter, dec, 2, pkg="port")
        journal, audit = JJOURNAL, jassert_once
    else:
        reps, router = fleet(Router, jdec, 2, pkg="jax")
        journal, audit = JOURNAL, assert_exactly_once
    seq0 = journal.last_seq
    try:
        wait_scraped(router, 2)
        shared = [2, 4, 6, 8, 10, 12, 14, 16]
        tids = []
        for i, extra in enumerate(([3], [5, 7], [9], [1, 1, 2])):
            prompt = shared + extra
            res = router.generate(prompt, 5,
                                  trace_id=f"mixed-{router_pkg}-{i}")
            want = direct_tokens(dec, prompt, 5)
            assert res.tokens == want == direct_tokens(jdec, prompt, 5)
            tids.append(res.trace_id)
        prompt = [30, 31, 32, 33, 34]
        res = router.generate(prompt, 4, trace_id=f"mixed-{router_pkg}-x")
        assert res.tokens == direct_tokens(dec, prompt, 4)
        tids.append(res.trace_id)
        audit(journal.tail(500, domain="fleet", since_seq=seq0), tids)
        for rep in reps.values():
            assert rep.engine.page_accounting()["leaked"] == 0
    finally:
        stop_fleet(reps, router)


def test_rendezvous_spreads_keys():
    rids = ["r0", "r1", "r2", "r3"]
    homes = {rendezvous_choose(f"key-{i}".encode(), rids)
             for i in range(50)}
    assert len(homes) >= 3
    assert np.all([rendezvous_choose(f"k{i}".encode(), rids) ==
                   rendezvous_choose(f"k{i}".encode(), reversed(rids))
                   for i in range(20)])
