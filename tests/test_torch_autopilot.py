"""The port's fleet autopilot (paddle_tpu_torch/fleet/autopilot.py) and
the CLI's fleet verbs, on the CPU at tests/test_autopilot.py's size:

- ``AutopilotPolicy.decide`` is decision-for-decision the JAX policy's
  on the seeded bursty trace (``FaultPlan.bursty_trace`` of both
  packages is one list), and on tests/test_autopilot.py's unit cases;
- ``scale_to`` clamps to the policy and journals each action; the
  control loop holds while an operator's ``scale_to`` or deploy runs
  (the JAX loop can drain a replica between two of its spawns);
- ``RollingDeploy`` restarts every replica one at a time under an
  open-loop burst with zero failed requests; an SLO breach pauses it
  and ``force`` overrides; its build budget counts the kernel-library
  builds (``artifacts/build`` records) of this process during the
  rollout — 0 on a warm fleet, a journaled breach when one builds;
- POST ``/admin/quit`` (501 without the hook), the provisioners, and
  ``SubprocessProvisioner``'s forwarding of the warm-start variables;
- the CLI wiring of ``serve --coordinator``, ``router`` (flags,
  ``_build_router``, ``_build_autopilot``, the teardown order) and ``fleet
  deploy|scale|status`` against a live router with an autopilot
  (exit 1 on a paused rollout), as tests/test_cli.py:803-880 does for
  the JAX CLI.
"""

import argparse
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from paddle_tpu.fleet.autopilot import AutopilotPolicy as JPolicy
from paddle_tpu.testing import FaultPlan as JFaultPlan

from paddle_tpu_torch import cli
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.fleet import Router, build_router_http_server
from paddle_tpu_torch.fleet.autopilot import (Autopilot, AutopilotPolicy,
                                              CallbackProvisioner,
                                              ReplicaProvisioner,
                                              RollingDeploy,
                                              SubprocessProvisioner)
from paddle_tpu_torch.obs.events import JOURNAL, emit
from paddle_tpu_torch.testing import FaultPlan

from torch_fleet_infra import (PAGE, Replica, direct_tokens, port_decoder,
                               write_tar)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _reset_port_obs():
    tobs.reset_all()
    yield
    tobs.reset_all()


@pytest.fixture(scope="module")
def decoder(tmp_path_factory):
    tar = tmp_path_factory.mktemp("autopilot") / "tiny.tar"
    write_tar(tar)
    return port_decoder(tar)


def _journal_since(seq, kind=None):
    return JOURNAL.tail(500, domain="autopilot", kind=kind, since_seq=seq)


def _sig(**kw):
    sig = dict(replicas_live=1, shed_rate=0.0, headroom_frac=1.0,
               headroom_trend_per_s=0.0, slo_breaches=0)
    sig.update(kw)
    return sig


# ----------------------------------------------------------- the policy
def _replay_trace(Policy, trace):
    """tests/test_autopilot.py's toy capacity model (~4 concurrent
    requests a replica) over one trace -> every decision."""
    p = Policy(min_replicas=1, max_replicas=2, up_cooldown_s=2.0,
               down_cooldown_s=3.0, down_stable_s=2.0)
    live, decisions = 1, []
    for t, load in enumerate(trace):
        shed = max(0, load - 4 * live)
        d = p.decide(_sig(replicas_live=live, shed_rate=float(shed),
                          headroom_frac=0.9 if shed == 0 else 0.2),
                     float(t))
        decisions.append(d)
        if d is not None:
            live += 1 if d["action"] == "scale_up" else -1
    return decisions, live


def test_policy_decides_as_jax_on_the_seeded_bursty_trace():
    trace = FaultPlan.bursty_trace(seed=0, ticks=30)
    assert trace == JFaultPlan.bursty_trace(seed=0, ticks=30)
    ours, live = _replay_trace(AutopilotPolicy, trace)
    theirs, jlive = _replay_trace(JPolicy, trace)
    assert ours == theirs and live == jlive == 1
    acts = [(t, d["action"]) for t, d in enumerate(ours) if d]
    ups = [t for t, a in acts if a == "scale_up"]
    downs = [t for t, a in acts if a == "scale_down"]
    assert ups and downs and 8 <= ups[0] <= 10
    assert downs[0] > max(ups) and len(acts) <= 4
    for seed in (1, 2, 3):
        t2 = FaultPlan.bursty_trace(seed=seed)
        assert t2 == JFaultPlan.bursty_trace(seed=seed)
        assert _replay_trace(AutopilotPolicy, t2) == \
            _replay_trace(JPolicy, t2)


def _policy_cases(Policy):
    """tests/test_autopilot.py's unit cases, as (case, decision) rows."""
    out = []
    p = Policy(min_replicas=1, max_replicas=3, up_cooldown_s=5.0)
    for s, t in ((_sig(shed_rate=2.0), 100.0),
                 (_sig(shed_rate=2.0, replicas_live=2), 102.0),
                 (_sig(shed_rate=2.0, replicas_live=2), 106.0),
                 (_sig(shed_rate=9.0, replicas_live=3), 120.0)):
        out.append(("cooldown", p.decide(s, t)))
    out.append(("headroom", Policy(headroom_low=0.15).decide(
        _sig(headroom_frac=0.10), 0.0)))
    out.append(("slo", Policy().decide(_sig(slo_breaches=2), 0.0)))
    p = Policy(min_replicas=1, max_replicas=4, down_stable_s=5.0,
               down_cooldown_s=0.0)
    calm = _sig(replicas_live=2, headroom_frac=0.9)
    for t in (0.0, 3.0, 6.0, 6.5, 12.0):
        out.append(("calm", p.decide(calm, t)))
    p = Policy(max_replicas=8, down_stable_s=2.0, down_cooldown_s=0.0)
    for s, t in ((calm, 0.0), (_sig(replicas_live=2, shed_rate=1.0), 1.0),
                 (calm, 2.5), (calm, 4.0), (calm, 5.0)):
        out.append(("reset", p.decide(s, t)))
    p = Policy(min_replicas=1, max_replicas=4, down_cooldown_s=10.0,
               down_stable_s=5.0)
    out.append(("ext", p.decide(_sig(replicas_live=1), 100.0)))
    out.append(("ext", p.decide(_sig(replicas_live=1), 106.0)))
    p.note_external_action(107.0)
    for t in (107.5, 111.0, 117.5):
        out.append(("ext", p.decide(_sig(replicas_live=2), t)))
    return out


def test_policy_unit_cases_equal_jax():
    ours = _policy_cases(AutopilotPolicy)
    assert ours == _policy_cases(JPolicy)
    acts = [d["action"] if d else None for _, d in ours]
    assert acts[:4] == ["scale_up", None, "scale_up", None]
    assert acts[4:6] == ["scale_up", "scale_up"]
    assert acts[6:11] == [None, None, "scale_down", None, "scale_down"]
    assert acts[11:16] == [None, "scale_up", None, None, "scale_down"]
    assert acts[16:] == [None, None, None, None, "scale_down"]


# ------------------------------------------------------- live mini-fleets
def _router(reps, **kw):
    args = dict(affinity="prefix", page_size=PAGE, scrape_interval=0.1,
                queue_timeout=10.0, queue_poll=0.02, drain_timeout=5.0)
    args.update(kw)
    router = Router(endpoints={rid: r.endpoint for rid, r in reps.items()},
                    **args).start()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            s.last_scrape == 0 for s in router.balancer.replicas().values()):
        time.sleep(0.02)
    return router


def _close(router, reps, ap=None):
    if ap is not None:
        ap.stop()
    router.shutdown(drain=True, timeout=10)
    for r in list(reps.values()):
        r.stop()


def test_scale_to_is_bounded_by_policy_and_journaled(decoder):
    reps = {"r0": Replica("r0", decoder)}
    router = _router(reps, affinity="load")

    def spawn(rid):
        reps[rid] = Replica(rid, decoder)
        return {"endpoint": reps[rid].endpoint}

    ap = Autopilot(router, CallbackProvisioner(
        spawn=spawn, stop=lambda rid: reps.pop(rid).stop()),
        policy=AutopilotPolicy(min_replicas=1, max_replicas=3))
    seq0 = JOURNAL.last_seq
    try:
        acts = ap.scale_to(99)
        assert [a["action"] for a in acts] == ["scale_up"] * 2
        assert router.stats()["replicas_live"] == 3
        ups = _journal_since(seq0, "scale_up")
        assert [u["replica"] for u in ups] == ["auto-1", "auto-2"]
        assert router.generate([1, 2, 3], 2).tokens == \
            direct_tokens(decoder, [1, 2, 3], 2)
        acts = ap.scale_to(0)
        assert [a["action"] for a in acts] == ["scale_down"] * 2
        assert {a["replica"] for a in acts} == {"auto-1", "auto-2"}
        assert router.stats()["replicas_live"] == 1
        st = ap.stats()
        assert (st["scale_ups"], st["scale_downs"]) == (2, 2)
        assert st["min_replicas"] == 1 and st["max_replicas"] == 3
    finally:
        _close(router, reps, ap)


def test_loop_holds_during_operator_scale_and_deploy(decoder):
    """A control tick between two of ``scale_to``'s spawns, or inside a
    deploy's restart, finds the fleet calm long past every window: it
    holds instead of draining what the operator asked for (or a replica
    the rollout has yet to restart). Both edges arm the hysteresis
    clocks, so the first tick after the action holds too."""
    reps = {"r0": Replica("r0", decoder)}
    router = _router(reps, affinity="load")
    now = [0.0]
    inner = []

    def calm_tick():
        now[0] += 100.0                # past down_stable_s and cooldown
        inner.append(ap.tick())

    def spawn(rid):
        reps[rid] = Replica(rid, decoder)
        calm_tick()
        return {"endpoint": reps[rid].endpoint}

    def restart(rid):
        reps[rid].stop()
        reps[rid] = Replica(rid, decoder)
        calm_tick()
        return {"endpoint": reps[rid].endpoint}

    ap = Autopilot(router, CallbackProvisioner(
        spawn=spawn, stop=lambda rid: reps.pop(rid).stop(),
        restart=restart),
        policy=AutopilotPolicy(min_replicas=1, max_replicas=3,
                               down_stable_s=1.0, down_cooldown_s=1.0),
        watchdog=FakeWatchdog(), clock=lambda: now[0])
    seq0 = JOURNAL.last_seq
    try:
        assert ap.tick() is None       # the calm clock starts at t 0
        assert [a["action"] for a in ap.scale_to(3)] == ["scale_up"] * 2
        out = ap.deploy(settle_timeout=30.0)
        assert out["status"] == "complete", out
        assert [s["replica"] for s in out["steps"]] == \
            ["auto-1", "auto-2", "r0"]
        assert inner == [None] * 5
        assert ap.tick() is None       # the action's edge: calm restarts
        assert router.stats()["replicas_live"] == 3
        assert not _journal_since(seq0, "scale_down")
        assert ap.stats()["ticks"] == 7
        now[0] += 100.0                # the loop resumes its policy
        d = ap.tick()
        assert d["action"] == "scale_down" and d["replica"] == "auto-1"
    finally:
        _close(router, reps, ap)


class FakeWatchdog:
    """SLO watchdog stand-in: .breaches is all RollingDeploy reads."""

    def __init__(self):
        self.breaches = 0

    def add_breach_listener(self, fn):
        pass

    def remove_breach_listener(self, fn):
        pass


def test_rolling_deploy_zero_failed_requests_under_burst(decoder):
    reps = {f"r{i}": Replica(f"r{i}", decoder) for i in range(2)}
    router = _router(reps)
    old = {rid: r.endpoint for rid, r in reps.items()}
    cycled = []

    def restart(rid):
        reps[rid].stop()
        reps[rid] = Replica(rid, decoder)
        cycled.append(rid)
        return {"endpoint": reps[rid].endpoint}

    roll = RollingDeploy(router, restart, watchdog=FakeWatchdog(),
                         settle_timeout=30.0, max_compiles=0)
    seq0 = JOURNAL.last_seq
    out = {}
    try:
        dt = threading.Thread(target=lambda: out.update(roll.run()),
                              daemon=True, name="pt-test-deploy")
        dt.start()

        def one(i):
            prompt = [1 + i % 5, 2, 3, 4]
            r = router.generate(prompt, 6)
            assert r.tokens == direct_tokens(decoder, prompt, 6)
            return r
        results, errors = FaultPlan.burst(one, n=40, threads=4,
                                          timeout=120)
        dt.join(timeout=60)
        assert not dt.is_alive()
        assert [e for e in errors if e is not None] == []
        assert sum(r is not None for r in results) == 40
        assert out["status"] == "complete", out
        assert cycled == ["r0", "r1"]
        assert all(s["ready"] for s in out["steps"])
        assert out["rollout_compiles"] == 0 and out["compile_budget_ok"]
        for rid, r in reps.items():
            assert r.endpoint != old[rid]
        steps = _journal_since(seq0, "deploy_step")
        assert [s["replica"] for s in steps] == ["r0", "r1"]
        assert _journal_since(seq0, "deploy_done")
    finally:
        _close(router, reps)


def test_slo_breach_pauses_rollout_force_overrides_and_builds_count(
        decoder):
    reps = {f"r{i}": Replica(f"r{i}", decoder) for i in range(2)}
    router = _router(reps)
    wd = FakeWatchdog()

    def restart(rid):
        reps[rid].stop()
        reps[rid] = Replica(rid, decoder)
        wd.breaches += 1               # the regression surfaces after r0
        return {"endpoint": reps[rid].endpoint}

    seq0 = JOURNAL.last_seq
    try:
        out = RollingDeploy(router, restart, watchdog=wd,
                            settle_timeout=30.0).run()
        assert out["status"] == "paused" and out["reason"] == "slo_breach"
        assert [s["replica"] for s in out["steps"]] == ["r0"]
        assert out["remaining"] == ["r1"]
        assert "compile_budget_ok" not in out   # no budget: report only
        paused = _journal_since(seq0, "deploy_paused")
        assert paused[-1]["replica"] == "r1" and paused[-1]["breaches"] == 1
        out2 = RollingDeploy(router, restart, watchdog=wd, force=True,
                             settle_timeout=30.0).run(["r1"])
        assert out2["status"] == "complete"

        def cold_restart(rid):
            # a respawn that builds its kernel library: the cold rung of
            # artifacts/runtime.py journals one artifacts/build record
            info = restart(rid)
            emit("artifacts", "build", name="paged_window_attention-x",
                 digest="x", build_ms=1.0, payload_bytes=1)
            return info

        out3 = RollingDeploy(router, cold_restart, watchdog=FakeWatchdog(),
                             settle_timeout=30.0, max_compiles=0).run(["r0"])
        assert out3["status"] == "complete"
        assert out3["rollout_compiles"] == 1
        assert out3["compile_budget_ok"] is False
        breach = _journal_since(seq0, "deploy_compile_budget_breach")
        assert breach[-1]["budget"] == 0
        assert breach[-1]["per_function"] == {"paged_window_attention-x": 1}
    finally:
        _close(router, reps)


def test_admin_quit_wires_hook_and_501s_without(decoder):
    quits = []
    plain = Replica("rq", decoder)
    hooked = Replica("rh", decoder, on_quit=lambda: quits.append(1))
    try:
        req = urllib.request.Request(plain.endpoint + "/admin/quit",
                                     data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 501
        req = urllib.request.Request(hooked.endpoint + "/admin/quit",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["quitting"] is True
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not quits:
            time.sleep(0.02)
        assert quits == [1]
    finally:
        plain.stop()
        hooked.stop()


def test_provisioner_seams(monkeypatch):
    calls = []
    prov = CallbackProvisioner(
        spawn=lambda rid: calls.append(("spawn", rid)) or
        {"endpoint": "http://x"},
        stop=lambda rid: calls.append(("stop", rid)))
    info = prov.restart("r7")
    assert calls == [("stop", "r7"), ("spawn", "r7")]
    assert info == {"endpoint": "http://x", "replica_id": "r7"}
    with pytest.raises(NotImplementedError):
        ReplicaProvisioner().spawn("r0")
    with pytest.raises(NotImplementedError):
        ReplicaProvisioner().stop("r0")
    # an explicit env inherits the warm-start plane's two variables
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "/warm/cache")
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS", "/warm/store")
    sp = SubprocessProvisioner(["serve"], env={"A": "1"})
    assert sp.env == {"A": "1", "PADDLE_TPU_COMPILE_CACHE": "/warm/cache",
                      "PADDLE_TPU_ARTIFACTS": "/warm/store"}
    assert SubprocessProvisioner(["serve"]).env is None


# ------------------------------------------------------------- the CLI
def test_serve_and_router_flags_parse_with_defaults(monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "_cmd_router",
                        lambda args: seen.update(vars(args)) or 0)
    monkeypatch.setattr(cli, "_cmd_serve",
                        lambda args: seen.update(vars(args)) or 0)
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "0")
    assert cli.main(["serve", "--decode_config", "d.py"]) == 0
    assert seen["coordinator"] is None and seen["replica_id"] is None
    assert seen["heartbeat"] == 1.0
    assert cli.main(["serve", "--decode_config", "d.py", "--coordinator",
                     "h:1", "--replica_id", "r9", "--heartbeat",
                     "0.25"]) == 0
    assert (seen["coordinator"], seen["replica_id"], seen["heartbeat"]) \
        == ("h:1", "r9", 0.25)
    seen.clear()
    assert cli.main(["router", "--coordinator", "127.0.0.1:9001"]) == 0
    assert seen["coordinator"] == "127.0.0.1:9001"
    assert seen["host"] == "127.0.0.1" and seen["port"] == 0
    assert (seen["affinity"], seen["drain_timeout"], seen["page_size"],
            seen["scrape_interval"], seen["queue_timeout"],
            seen["heartbeat"]) == ("prefix", 10.0, 16, 0.5, 5.0, 1.0)
    assert (seen["autopilot"], seen["spawn_cmd"], seen["kv_quant"],
            seen["kv_spill_pages"], seen["min_replicas"],
            seen["max_replicas"], seen["autopilot_interval"],
            seen["compile_cache"]) == (False, None, "none", 0, 1, 8, 1.0,
                                       None)
    assert cli.main(["router", "--coordinator", "h:1", "--port", "8088",
                     "--affinity", "load", "--drain_timeout", "3.5",
                     "--page_size", "4", "--scrape_interval", "0.1",
                     "--queue_timeout", "2.0"]) == 0
    assert seen["port"] == 8088 and seen["affinity"] == "load"
    assert seen["drain_timeout"] == 3.5 and seen["page_size"] == 4
    with pytest.raises(SystemExit):
        cli.main(["router"])
    with pytest.raises(SystemExit):
        cli.main(["router", "--coordinator", "h:1", "--affinity",
                  "random"])


def test_build_router_and_autopilot_wire_flags():
    coord_sentinel = object()
    connected, built = [], []

    class FakeRouter:
        def __init__(self, coordinator=None, **kw):
            self.coordinator = coordinator
            self.kw = kw
            self.started = False

        def start(self):
            self.started = True
            return self

    def fake_http(router, host, port, autopilot=None):
        built.append((router, host, port, autopilot))
        return object()

    ns = argparse.Namespace(
        coordinator="10.0.0.5:4321", affinity="load", page_size=8,
        scrape_interval=0.25, queue_timeout=3.0, drain_timeout=7.0,
        host="0.0.0.0", port=8088)
    router, httpd, coord, ap = cli._build_router(
        ns, FakeRouter, fake_http,
        lambda h, p: connected.append((h, p)) or coord_sentinel)
    assert connected == [("10.0.0.5", 4321)] and coord is coord_sentinel
    assert router.coordinator is coord_sentinel and router.started
    assert router.kw == {"affinity": "load", "page_size": 8,
                         "scrape_interval": 0.25, "queue_timeout": 3.0,
                         "drain_timeout": 7.0}
    assert ap is None and built == [(router, "0.0.0.0", 8088, None)]
    ns2 = argparse.Namespace(**vars(ns), autopilot=False,
                             spawn_cmd="python -m x serve --replica_id "
                                       "{replica_id}",
                             kv_quant="int8", kv_spill_pages=64,
                             min_replicas=2, max_replicas=5,
                             autopilot_interval=0.5)
    _, _, _, ap = cli._build_router(ns2, FakeRouter, fake_http,
                                    lambda h, p: coord_sentinel)
    try:
        assert isinstance(ap.provisioner, SubprocessProvisioner)
        assert ap.provisioner.argv == [
            "python", "-m", "x", "serve", "--replica_id", "{replica_id}",
            "--kv_quant", "int8", "--kv_spill_pages", "64"]
        assert (ap.policy.min_replicas, ap.policy.max_replicas,
                ap.interval, ap.drain_timeout) == (2, 5, 0.5, 7.0)
        assert built[-1][3] is ap
    finally:
        ap.stop()
    ns3 = argparse.Namespace(**{**vars(ns2), "spawn_cmd": None,
                                "autopilot": True})
    _, _, _, ap = cli._build_router(ns3, FakeRouter, fake_http,
                                    lambda h, p: coord_sentinel)
    try:
        assert isinstance(ap.provisioner, CallbackProvisioner)
        with pytest.raises(RuntimeError):
            ap.provisioner.spawn("r0")
    finally:
        ap.stop()


def test_router_teardown_order_and_fleet_requests():
    calls = []

    class FakeRouter:
        def shutdown(self, drain=False, timeout=None):
            assert drain is True
            calls.append("drain")

    class FakeReg:
        def stop(self, leave=False):
            assert leave is True
            calls.append("leave")

    class FakeHttpd:
        def shutdown(self):
            calls.append("close")

        def server_close(self):
            calls.append("close_socket")

    class FakeAutopilot:
        def stop(self):
            calls.append("autopilot_stop")

    cli._router_teardown(FakeRouter(), FakeReg(), FakeHttpd())
    assert calls == ["drain", "leave", "close", "close_socket"]
    calls.clear()
    cli._router_teardown(FakeRouter(), None, FakeHttpd(),
                         autopilot=FakeAutopilot())
    assert calls == ["autopilot_stop", "drain", "close", "close_socket"]

    def req(action, **kw):
        ns = argparse.Namespace(router="http://h:1/", action=action,
                                force=kw.get("force", False),
                                replicas=kw.get("replicas"))
        return cli._build_fleet_request(ns)

    assert req("deploy", force=True) == (
        "POST", "http://h:1/admin/deploy", {"force": True})
    assert req("scale", replicas=3) == (
        "POST", "http://h:1/admin/scale", {"replicas": 3})
    assert req("status") == ("GET", "http://h:1/stats", None)
    with pytest.raises(SystemExit):
        req("scale")


def test_fleet_verbs_against_a_live_router(decoder, capsys):
    """``fleet status|scale|deploy`` through cli.main against a port
    router with an autopilot over in-process replicas: status and
    scale exit 0, a completed deploy exits 0, a paused one 1."""
    reps = {"r0": Replica("r0", decoder)}
    router = _router(reps)

    def spawn(rid):
        reps[rid] = Replica(rid, decoder)
        return {"endpoint": reps[rid].endpoint}

    def stop(rid):
        reps.pop(rid).stop()

    wd = FakeWatchdog()
    ap = Autopilot(router, CallbackProvisioner(spawn=spawn, stop=stop),
                   policy=AutopilotPolicy(min_replicas=1, max_replicas=2),
                   watchdog=wd)
    httpd = build_router_http_server(router, "127.0.0.1", 0, autopilot=ap)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="pt-test-fleet-httpd")
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def run(*argv):
        rc = cli.main(["fleet", *argv, "--router", base,
                       "--timeout", "60"])
        return rc, json.loads(capsys.readouterr().out.splitlines()[-1])

    try:
        rc, out = run("status")
        assert rc == 0 and out["result"]["replicas_live"] == 1
        assert out["autopilot"]["max_replicas"] == 2
        rc, out = run("scale", "--replicas", "2")
        assert rc == 0 and out["result"]["replicas_live"] == 2
        rc, out = run("deploy")
        assert rc == 0 and out["result"]["status"] == "complete"
        assert [s["replica"] for s in out["result"]["steps"]] == \
            sorted(reps)
        wd.breaches = 0

        def breaching_restart(rid):
            info = CallbackProvisioner(spawn=spawn, stop=stop).restart(rid)
            wd.breaches += 1
            return info
        ap.provisioner = CallbackProvisioner(spawn=spawn, stop=stop,
                                             restart=breaching_restart)
        rc, out = run("deploy")
        assert rc == 1 and out["result"]["status"] == "paused"
        assert ap.stats()["deploys"] == 2
        assert ap.stats()["deploys_paused"] == 1
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "paddle_tpu_autopilot_deploys_paused 1" in text
    finally:
        httpd.shutdown()
        httpd.server_close()
        _close(router, reps, ap)

