"""Fleet autopilot — the controller that changes the fleet's size and
shape; the port of ``paddle_tpu/fleet/autopilot.py`` (PAPER.md layer
8's ParameterServerController role reborn for serving).

The router alone is routable and failover-tested but inert: nothing
consumes the shed counters, the KV-headroom scrapes, or the SLO
watchdog's breaches. Three legs close that loop, all journaled under
the ``autopilot`` domain so a flight bundle explains *why* the fleet
resized:

- **Autoscaler** (:class:`Autopilot` + :class:`AutopilotPolicy`): the
  ``pt-fleet-autopilot`` control loop samples the router's journaled
  shed rate (``paddle_tpu_fleet_rejected_*`` deltas), the aggregate
  KV-headroom fraction and its trend (the same occupancy-trend shape
  ``pt-obs-profiler`` exports for page pools), and SLO breach records
  (the ``obs/slo.py`` breach-listener seam), and decides spawn/drain
  through a pluggable :class:`ReplicaProvisioner`. Hysteresis is the
  point: min/max replica bounds, separate up/down cooldowns, and a
  sustained-calm requirement before any scale-down — a bursty trace
  scales up on the shed spike and down ONCE after the burst, never
  flapping (tests/test_torch_autopilot.py replays exactly that).
- **Rolling deploy** (:class:`RollingDeploy`, ``cli.py fleet
  deploy``): drain → restart → rejoin one replica at a time, riding
  the router's drain/resume primitive, gated on the SLO watchdog staying
  green between steps. A breach pauses the rollout (journal
  ``autopilot/deploy_paused``; ``force=True`` overrides) instead of
  marching a degraded fleet through more restarts.
- The **HA plane** needs no controller: N routers agree on placement
  via consistent hashing (fleet/balance.py ``rendezvous_choose``) and
  survive coordinator outages on the registry's stale-view degradation
  (fleet/registry.py).

Provisioners: :class:`SubprocessProvisioner` spawns one OS process per
replica from an argv template (tests/CPU; the daemon's ``--spawn_cmd``);
:class:`CallbackProvisioner` is the seam real deployments hang their
scheduler API on. Both only need spawn/stop — restart defaults to
stop + spawn.

Lock discipline: the autopilot lock guards counters and
signal history only; every journal emit, flight mark, provisioner call
and router RPC happens OUTSIDE it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.obs.flight import FLIGHT

__all__ = ["Autopilot", "AutopilotPolicy", "CallbackProvisioner",
           "ReplicaProvisioner", "RollingDeploy",
           "SubprocessProvisioner"]


# --------------------------------------------------------------- provisioners
class ReplicaProvisioner:
    """How the autopilot turns decisions into replicas. ``spawn``
    returns an info dict (``replica_id`` required; ``endpoint`` when
    the replica does not join a coordinator directory by itself);
    ``stop`` tears one down (gracefully — the drain already happened).
    ``restart`` is the deploy primitive; the default is stop+spawn."""

    def spawn(self, replica_id: str) -> Dict[str, Any]:
        raise NotImplementedError

    def stop(self, replica_id: str) -> bool:
        raise NotImplementedError

    def restart(self, replica_id: str) -> Dict[str, Any]:
        self.stop(replica_id)
        return self.spawn(replica_id)


class CallbackProvisioner(ReplicaProvisioner):
    """The real-deployment seam: hand the autopilot your scheduler's
    spawn/stop/restart calls and nothing else."""

    def __init__(self, spawn: Callable[[str], Optional[Dict[str, Any]]],
                 stop: Callable[[str], Any],
                 restart: Optional[
                     Callable[[str], Optional[Dict[str, Any]]]] = None):
        self._spawn = spawn
        self._stop = stop
        self._restart = restart

    def spawn(self, replica_id: str) -> Dict[str, Any]:
        out = self._spawn(replica_id) or {}
        out.setdefault("replica_id", replica_id)
        return out

    def stop(self, replica_id: str) -> bool:
        self._stop(replica_id)
        return True

    def restart(self, replica_id: str) -> Dict[str, Any]:
        if self._restart is not None:
            out = self._restart(replica_id) or {}
            out.setdefault("replica_id", replica_id)
            return out
        return super().restart(replica_id)


class SubprocessProvisioner(ReplicaProvisioner):
    """One OS process per replica from an argv template — the
    tests/CPU provisioner and the router daemon's ``--spawn_cmd``.
    ``{replica_id}`` in any argv element is substituted. The spawned
    process is expected to print one JSON status line on stdout (the
    CLI daemon convention); when it carries a ``port`` the provisioner
    reports the endpoint (static-registry fleets) — replicas that join
    a coordinator directory themselves need nothing more. ``stop``
    SIGTERMs (the daemons drain + leave on it) and escalates to kill
    past ``stop_timeout``."""

    def __init__(self, argv: List[str], env: Optional[dict] = None,
                 cwd: Optional[str] = None,
                 start_timeout: float = 120.0,
                 stop_timeout: float = 30.0):
        self.argv = list(argv)
        # Warm-start plane: when the fleet operator points an explicit
        # env dict at a compile cache / artifact store, every spawned
        # replica inherits it — an autoscale-up or crash respawn then
        # loads its kernel libraries instead of running nvcc
        # (paddle_tpu_torch/artifacts). A None env (inherit the parent's
        # environment wholesale) already forwards both vars; chaos
        # tests that need COLD children pass an env that omits them.
        if env is not None:
            from paddle_tpu_torch.artifacts import cache as _ccache
            from paddle_tpu_torch.artifacts.runtime import ENV_STORE
            env = dict(env)
            for var in (_ccache.ENV_VAR, ENV_STORE):
                if var not in env and os.environ.get(var):
                    env[var] = os.environ[var]
        self.env = env
        self.cwd = cwd
        self.start_timeout = float(start_timeout)
        self.stop_timeout = float(stop_timeout)
        self._lock = named_lock("fleet.provisioner")
        self._procs: Dict[str, Any] = {}  # ptlint: guarded-by(fleet.provisioner)

    def spawn(self, replica_id: str) -> Dict[str, Any]:
        argv = [a.replace("{replica_id}", replica_id)
                for a in self.argv]
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                text=True, env=self.env, cwd=self.cwd)
        info: Dict[str, Any] = {}
        line = proc.stdout.readline()
        try:
            info = json.loads(line)
        except (json.JSONDecodeError, TypeError):
            pass
        if proc.poll() is not None:
            raise RuntimeError(
                f"spawned replica {replica_id!r} exited "
                f"{proc.returncode} before serving: {line!r}")
        with self._lock:
            self._procs[replica_id] = proc
        out = {"replica_id": replica_id, "pid": proc.pid}
        if info.get("port"):
            out["endpoint"] = (
                f"http://{info.get('host', '127.0.0.1')}:"
                f"{info['port']}")
        return out

    def stop(self, replica_id: str) -> bool:
        with self._lock:
            proc = self._procs.pop(replica_id, None)
        if proc is None:
            return False
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=self.stop_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        return True

    def stop_all(self) -> int:
        with self._lock:
            rids = list(self._procs)
        return sum(1 for rid in rids if self.stop(rid))


# --------------------------------------------------------------------- policy
class AutopilotPolicy:
    """The hysteresis-bounded scaling decision, separated from the
    loop so tests replay signal traces deterministically.

    Scale UP when any pressure signal fires — shed rate above
    ``shed_up`` (default: ANY shed — a shed is a user-visible 429),
    aggregate KV-headroom fraction under ``headroom_low``, or SLO
    breaches in the window — bounded by ``max_replicas`` and
    ``up_cooldown_s``. Scale DOWN only after ``down_stable_s`` of
    sustained calm (zero sheds, zero breaches, headroom above
    ``headroom_high``) AND ``down_cooldown_s`` past the last action,
    floored at ``min_replicas``. Any pressure resets the calm clock,
    and every action restarts it — one decision per burst edge, never
    a flap."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 shed_up: float = 0.0, headroom_low: float = 0.15,
                 headroom_high: float = 0.60,
                 up_cooldown_s: float = 3.0,
                 down_cooldown_s: float = 10.0,
                 down_stable_s: float = 5.0):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.shed_up = float(shed_up)
        self.headroom_low = float(headroom_low)
        self.headroom_high = float(headroom_high)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.down_stable_s = float(down_stable_s)
        self._last_action_t: Optional[float] = None
        self._last_up_t: Optional[float] = None
        self._calm_since: Optional[float] = None

    def _pressure(self, sig: dict) -> List[str]:
        out = []
        if sig.get("shed_rate", 0.0) > self.shed_up:
            out.append(f"shed_rate {sig['shed_rate']:.3f}/s > "
                       f"{self.shed_up:g}")
        if sig.get("headroom_frac", 1.0) < self.headroom_low:
            out.append(f"headroom {sig['headroom_frac']:.3f} < "
                       f"{self.headroom_low:g}")
        if sig.get("slo_breaches", 0) > 0:
            out.append(f"slo_breaches {sig['slo_breaches']}")
        return out

    def decide(self, sig: dict, now: float) -> Optional[dict]:
        """One policy evaluation -> an action dict
        ({action, reason, evidence}) or None (hold)."""
        live = int(sig.get("replicas_live", 0))
        pressure = self._pressure(sig)
        if pressure:
            self._calm_since = None
            if live >= self.max_replicas:
                return None            # pinned at the ceiling
            if self._last_up_t is not None and \
                    now - self._last_up_t < self.up_cooldown_s:
                return None            # spawn already in flight
            self._last_up_t = now
            self._last_action_t = now
            return {"action": "scale_up",
                    "reason": "; ".join(pressure), "evidence": sig}
        calm = (sig.get("shed_rate", 0.0) <= 0.0
                and sig.get("slo_breaches", 0) == 0
                and sig.get("headroom_frac", 0.0)
                >= self.headroom_high)
        if not calm:
            self._calm_since = None
            return None
        if self._calm_since is None:
            self._calm_since = now
            return None
        if now - self._calm_since < self.down_stable_s:
            return None
        if live <= self.min_replicas:
            return None
        if self._last_action_t is not None and \
                now - self._last_action_t < self.down_cooldown_s:
            return None
        self._last_action_t = now
        self._calm_since = now         # one down per stability window
        return {"action": "scale_down",
                "reason": (f"calm {self.down_stable_s:g}s: headroom "
                           f"{sig['headroom_frac']:.3f} >= "
                           f"{self.headroom_high:g}, zero sheds"),
                "evidence": sig}

    def note_external_action(self, now: float) -> None:
        """An operator resized the fleet outside ``decide()``
        (``scale_to``). Arm the same clocks a policy decision would
        have: without this, an idle fleet's ``_calm_since`` already
        predates the operator's spawn, so the very next tick
        scale-downs the replicas the operator just asked for."""
        self._last_action_t = now
        self._last_up_t = now
        self._calm_since = None


# ------------------------------------------------------------------ autopilot
class Autopilot:
    """The control loop (module doc leg (a)). Construct over a live
    Router + provisioner, ``start()`` the ``pt-fleet-autopilot``
    thread (or drive ``tick()`` inline from tests/bench). Every
    decision journals ``autopilot/scale_up`` / ``autopilot/scale_down``
    carrying the triggering evidence snapshot."""

    def __init__(self, router, provisioner: ReplicaProvisioner, *,
                 policy: Optional[AutopilotPolicy] = None,
                 interval: float = 1.0,
                 drain_timeout: Optional[float] = None,
                 watchdog=None,
                 replica_prefix: str = "auto",
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.provisioner = provisioner
        self.policy = policy or AutopilotPolicy()
        self.interval = float(interval)
        self.drain_timeout = drain_timeout
        self.replica_prefix = str(replica_prefix)
        self._clock = clock
        self._lock = named_lock("fleet.autopilot")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._counters = {             # ptlint: guarded-by(fleet.autopilot)
            "ticks": 0, "scale_ups": 0, "scale_downs": 0,
            "spawn_failures": 0, "slo_breaches_seen": 0,
            "deploys": 0, "deploys_paused": 0}
        self._prev_shed: Optional[int] = None  # ptlint: guarded-by(fleet.autopilot)
        self._prev_t: Optional[float] = None  # ptlint: guarded-by(fleet.autopilot)
        self._breaches_pending = 0     # ptlint: guarded-by(fleet.autopilot)
        self._last_breach: Optional[dict] = None  # ptlint: guarded-by(fleet.autopilot)
        self._headroom_hist: deque = deque(maxlen=32)  # ptlint: guarded-by(fleet.autopilot)
        self._last_sig: Dict[str, Any] = {}  # ptlint: guarded-by(fleet.autopilot)
        self._last_decision: Optional[dict] = None  # ptlint: guarded-by(fleet.autopilot)
        self._last_decision_t: Optional[float] = None  # ptlint: guarded-by(fleet.autopilot)
        self._spawn_seq = 0            # ptlint: guarded-by(fleet.autopilot)
        self._operator = 0             # ptlint: guarded-by(fleet.autopilot)
        if watchdog is None:
            from paddle_tpu_torch.obs.slo import WATCHDOG as watchdog
        self._watchdog = watchdog
        watchdog.add_breach_listener(self._on_breach)

    # ---------------------------------------------------------- signals
    def _on_breach(self, record: dict) -> None:
        """obs/slo.py breach-listener seam: fold SLO breaches into the
        next sample window."""
        with self._lock:
            self._breaches_pending += 1
            self._counters["slo_breaches_seen"] += 1
            self._last_breach = record

    def sample(self) -> dict:
        """One signal snapshot off the router's stats: shed-rate delta
        since the last sample, aggregate headroom fraction + trend
        (the pt-obs-profiler occupancy-trend shape), pending SLO
        breaches. Pure observation — no decisions here."""
        st = self.router.stats()
        now = self._clock()
        shed_now = int(st.get("rejected_queue_full", 0)
                       + st.get("rejected_kv_capacity", 0)
                       + st.get("rejected_no_replica", 0))
        total = int(st.get("kv_pages_total", 0))
        frac = (st.get("kv_pages_free", 0) / total) if total > 0 else 1.0
        with self._lock:
            prev_shed, prev_t = self._prev_shed, self._prev_t
            self._prev_shed, self._prev_t = shed_now, now
            breaches = self._breaches_pending
            self._breaches_pending = 0
            last_breach = self._last_breach
            self._headroom_hist.append((now, frac))
            hist = list(self._headroom_hist)
        sheds = shed_now - prev_shed if prev_shed is not None else 0
        dt = (now - prev_t) if prev_t is not None else 0.0
        shed_rate = (sheds / dt) if dt > 1e-9 else float(sheds > 0)
        trend = 0.0
        if len(hist) >= 2 and hist[-1][0] > hist[0][0]:
            trend = (hist[-1][1] - hist[0][1]) \
                / (hist[-1][0] - hist[0][0])
        sig = {
            "t": round(now, 3),
            "replicas_live": int(st.get("replicas_live", 0)),
            "replicas": int(st.get("replicas", 0)),
            "sheds": sheds,
            "shed_rate": round(shed_rate, 4),
            "headroom_frac": round(frac, 4),
            "headroom_trend_per_s": round(trend, 6),
            "kv_pages_free": int(st.get("kv_pages_free", 0)),
            "kv_pages_total": total,
            "inflight": int(st.get("inflight", 0)),
            "slo_breaches": breaches,
        }
        if breaches and last_breach is not None:
            sig["last_breach"] = {
                k: last_breach[k] for k in
                ("detector", "objective", "metric", "value", "phase")
                if k in last_breach}
        with self._lock:
            self._last_sig = dict(sig)
        return sig

    # --------------------------------------------------------- decisions
    def tick(self) -> Optional[dict]:
        """One sample + decide + act pass; returns the decision taken
        (None on hold). The loop calls this every ``interval``."""
        with self._lock:
            self._counters["ticks"] += 1
            held = self._operator > 0
        if held:
            return None                # an operator's resize or deploy
        sig = self.sample()
        decision = self.policy.decide(sig, sig["t"])
        if decision is None:
            return None
        if decision["action"] == "scale_up":
            self._act_scale_up(decision)
        else:
            self._act_scale_down(decision)
        with self._lock:
            self._last_decision = decision
            self._last_decision_t = self._clock()
        return decision

    def _act_scale_up(self, decision: dict) -> None:
        with self._lock:
            self._spawn_seq += 1
            rid = f"{self.replica_prefix}-{self._spawn_seq}"
        try:
            info = self.provisioner.spawn(rid) or {}
        except Exception as e:  # noqa: BLE001 — a failed spawn is a
            with self._lock:    # journaled fact, not a loop killer
                self._counters["spawn_failures"] += 1
            journal_emit("autopilot", "spawn_failed", replica=rid,
                         error=repr(e), reason=decision["reason"])
            return
        rid = str(info.get("replica_id", rid))
        endpoint = info.get("endpoint")
        decision["replica"] = rid
        if endpoint and self.router.registry.coordinator is None:
            self.router.registry.set_static(rid, endpoint)
        with self._lock:
            self._counters["scale_ups"] += 1
        journal_emit("autopilot", "scale_up", replica=rid,
                     endpoint=endpoint, reason=decision["reason"],
                     evidence=decision["evidence"])
        FLIGHT.record("mark", "autopilot/scale_up", replica=rid,
                      reason=decision["reason"])
        self.router.refresh()          # admit it this tick, not next

    def _act_scale_down(self, decision: dict) -> None:
        victim = self._pick_victim()
        if victim is None:
            return
        decision["replica"] = victim
        journal_emit("autopilot", "scale_down", replica=victim,
                     reason=decision["reason"],
                     evidence=decision["evidence"])
        FLIGHT.record("mark", "autopilot/scale_down", replica=victim,
                      reason=decision["reason"])
        self.router.drain(victim, timeout=self.drain_timeout)
        try:
            self.provisioner.stop(victim)
        except Exception as e:  # noqa: BLE001 — journal, keep going
            journal_emit("autopilot", "stop_failed", replica=victim,
                         error=repr(e))
        if self.router.registry.coordinator is None:
            self.router.registry.drop_static(victim)
        self.router.balancer.remove(victim)
        with self._lock:
            self._counters["scale_downs"] += 1

    def _pick_victim(self) -> Optional[str]:
        """Least-disruptive drain target: prefer replicas this
        autopilot spawned (unwind own spawns first), then fewest
        in-flight, then most free pages (coldest cache)."""
        cands = [st for st in self.router.balancer.replicas().values()
                 if st.live and not st.draining]
        if len(cands) <= self.policy.min_replicas:
            return None
        own = self.replica_prefix + "-"
        cands.sort(key=lambda st: (
            0 if st.replica_id.startswith(own) else 1,
            st.inflight, -st.kv_pages_free, st.replica_id))
        return cands[0].replica_id

    @contextlib.contextmanager
    def _operator_action(self):
        """Hold the control loop for an operator's resize or deploy:
        each spawn takes seconds, and a tick between two of them would
        find the fleet calm and drain what the operator just asked for
        (or the replica a deploy is about to restart). Both edges arm
        the hysteresis clocks."""
        with self._lock:
            self._operator += 1
        self.policy.note_external_action(self._clock())
        try:
            yield
        finally:
            self.policy.note_external_action(self._clock())
            with self._lock:
                self._operator -= 1

    def scale_to(self, target: int) -> List[dict]:
        """Manual resize (``cli.py fleet scale``): spawn or drain,
        bounded by the policy's min/max, one journaled action per
        replica. Bypasses hysteresis — an operator said so."""
        with self._operator_action():
            return self._scale_to(target)

    def _scale_to(self, target: int) -> List[dict]:
        target = max(self.policy.min_replicas,
                     min(self.policy.max_replicas, int(target)))
        actions: List[dict] = []
        for _ in range(64):            # bound the loop, not the fleet
            live = self.router.stats()["replicas_live"]
            if live == target:
                break
            sig = self.sample()
            if live < target:
                d = {"action": "scale_up",
                     "reason": f"operator scale_to({target})",
                     "evidence": sig}
                self._act_scale_up(d)
            else:
                d = {"action": "scale_down",
                     "reason": f"operator scale_to({target})",
                     "evidence": sig}
                self._act_scale_down(d)
                if "replica" not in d:
                    break              # floor reached: nothing to drain
            actions.append(d)
            self.router.refresh()
        return actions

    def deploy(self, force: bool = False,
               settle_timeout: float = 60.0) -> dict:
        """Run a rolling deploy through this autopilot's provisioner
        (``cli.py fleet deploy`` lands here over /admin/deploy)."""
        roll = RollingDeploy(self.router, self.provisioner.restart,
                             watchdog=self._watchdog, force=force,
                             settle_timeout=settle_timeout,
                             drain_timeout=self.drain_timeout,
                             clock=self._clock)
        with self._operator_action():
            out = roll.run()
        with self._lock:
            self._counters["deploys"] += 1
            if out["status"] == "paused":
                self._counters["deploys_paused"] += 1
        return out

    # --------------------------------------------------------- lifecycle
    def start(self) -> "Autopilot":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="pt-fleet-autopilot")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a blip must not kill
                pass           # the controller; next tick retries

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._watchdog.remove_breach_listener(self._on_breach)

    # --------------------------------------------------------- snapshots
    def stats(self) -> dict:
        """Flattened into ``paddle_tpu_autopilot_*`` by fleet/obs.py."""
        now = self._clock()
        with self._lock:
            out: Dict[str, Any] = dict(self._counters)
            sig = dict(self._last_sig)
            last_t = self._last_decision_t
        out.update({
            "replicas_live": sig.get("replicas_live", 0),
            "shed_rate": sig.get("shed_rate", 0.0),
            "headroom_frac": sig.get("headroom_frac", 1.0),
            "headroom_trend_per_s": sig.get("headroom_trend_per_s",
                                            0.0),
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "last_decision_age_s": round(now - last_t, 3)
            if last_t is not None else -1.0,
        })
        return out


# ------------------------------------------------------------ rolling deploy
class _BuildWatch:
    """Counts the kernel-library builds this process runs: one
    ``artifacts/build`` journal record each (artifacts/runtime.py's
    cold rung), keyed by library name in ``per_function``."""

    def __init__(self):
        self.total = 0
        self.per_function: Dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, rec: dict) -> None:
        if rec.get("domain") != "artifacts" or rec.get("kind") != "build":
            return
        name = str(rec.get("name"))
        with self._lock:
            self.total += 1
            self.per_function[name] = self.per_function.get(name, 0) + 1


@contextlib.contextmanager
def _build_watch():
    """The rollout's build counter — the port's stand-in for the JAX
    package's ``compile_watch`` (which counts XLA compiles): a journal
    observer for the length of the context."""
    from paddle_tpu_torch.obs.events import JOURNAL
    watch = _BuildWatch()
    JOURNAL.add_observer(watch)
    try:
        yield watch
    finally:
        JOURNAL.remove_observer(watch)


class RollingDeploy:
    """Leg (b): drain → restart → rejoin, one replica at a time, SLO-
    gated between steps (module doc). ``restart`` is a callable
    ``(replica_id) -> info dict`` (a provisioner's restart, or any
    supervisor hook); when it reports a new ``endpoint`` and the
    registry is static, the entry is moved (the endpoint-change rejoin
    re-admits); otherwise the replica's fresh ``boot_id`` rejoin —
    or an explicit undrain in static/same-port mode — re-admits."""

    def __init__(self, router, restart: Callable[[str], Any], *,
                 watchdog=None, force: bool = False,
                 settle_timeout: float = 60.0,
                 drain_timeout: Optional[float] = None,
                 poll: float = 0.05,
                 max_compiles: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.restart = restart
        if watchdog is None:
            from paddle_tpu_torch.obs.slo import WATCHDOG as watchdog
        self.watchdog = watchdog
        self.force = bool(force)
        self.settle_timeout = float(settle_timeout)
        self.drain_timeout = drain_timeout
        self.poll = float(poll)
        # fleet-scope build budget: kernel-library builds observed IN
        # THIS PROCESS across the whole rollout (the artifacts/build
        # journal records of artifacts/runtime.py's cold rung). A warm
        # compile cache or store makes it literally 0 for in-process
        # restart callables; subprocess replicas build in their own
        # process and are kept warm by SubprocessProvisioner's env
        # forwarding instead. None = report but don't judge.
        self.max_compiles = max_compiles
        self._clock = clock

    def run(self, replica_ids: Optional[List[str]] = None) -> dict:
        with _build_watch() as cw:
            out = self._run(replica_ids)
        out["rollout_compiles"] = cw.total
        if self.max_compiles is not None and \
                cw.total > self.max_compiles:
            out["compile_budget_ok"] = False
            journal_emit("autopilot", "deploy_compile_budget_breach",
                         compiles=cw.total, budget=self.max_compiles,
                         per_function=dict(cw.per_function))
        elif self.max_compiles is not None:
            out["compile_budget_ok"] = True
        return out

    def _run(self, replica_ids: Optional[List[str]] = None) -> dict:
        t0 = self._clock()
        base_breaches = self.watchdog.breaches
        if replica_ids is None:
            replica_ids = sorted(
                rid for rid, st in
                self.router.balancer.replicas().items()
                if st.live and not st.draining)
        journal_emit("autopilot", "deploy_start",
                     replicas=list(replica_ids), force=self.force)
        steps: List[dict] = []
        settled = False             # a deploy_done/paused was journaled
        current = ""
        try:
            for i, rid in enumerate(replica_ids):
                current = rid
                breaches = self.watchdog.breaches - base_breaches
                if breaches > 0 and not self.force:
                    journal_emit("autopilot", "deploy_paused",
                                 replica=rid, breaches=breaches,
                                 completed=[s["replica"]
                                            for s in steps],
                                 remaining=list(replica_ids[i:]))
                    settled = True
                    FLIGHT.record("mark", "autopilot/deploy_paused",
                                  replica=rid, breaches=breaches)
                    return {"status": "paused", "reason": "slo_breach",
                            "breaches": breaches, "steps": steps,
                            "remaining": list(replica_ids[i:]),
                            "wall_s": round(self._clock() - t0, 3)}
                step = self._step(rid)
                steps.append(step)
                if not step["ready"] and not self.force:
                    journal_emit("autopilot", "deploy_paused",
                                 replica=rid, breaches=0,
                                 reason="replica_not_ready",
                                 remaining=list(replica_ids[i + 1:]))
                    settled = True
                    return {"status": "paused",
                            "reason": "replica_not_ready",
                            "breaches": 0, "steps": steps,
                            "remaining": list(replica_ids[i + 1:]),
                            "wall_s": round(self._clock() - t0, 3)}
            wall = round(self._clock() - t0, 3)
            journal_emit("autopilot", "deploy_done",
                         replicas=len(steps), wall_s=wall)
            settled = True
            return {"status": "complete", "steps": steps,
                    "breaches": self.watchdog.breaches - base_breaches,
                    "wall_s": wall}
        finally:
            if not settled:
                # an exception is unwinding out of a started deploy:
                # close the autopilot_deploy machine (ptproto) with a
                # paused record so the journal never shows a deploy
                # that silently vanished
                journal_emit("autopilot", "deploy_paused",
                             replica=current or "none", breaches=0,
                             reason="exception", remaining=[])

    def _step(self, rid: str) -> dict:
        st = self.router.balancer.get(rid)
        old_ep = st.endpoint if st is not None else None
        t0 = self._clock()
        drained = self.router.drain(rid, timeout=self.drain_timeout)
        info = self.restart(rid) or {}
        new_ep = info.get("endpoint")
        static = self.router.registry.coordinator is None
        if static and new_ep and new_ep != old_ep:
            self.router.registry.set_static(rid, new_ep)
        ready = self._wait_ready(rid, new_ep if new_ep else None,
                                 static=static,
                                 same_endpoint=new_ep in (None, old_ep))
        step = {"replica": rid, "ready": ready,
                "drain_settled": drained.get("settled", False),
                "endpoint": new_ep or old_ep,
                "step_s": round(self._clock() - t0, 3)}
        journal_emit("autopilot", "deploy_step", **step)
        return step

    def _wait_ready(self, rid: str, new_ep: Optional[str], *,
                    static: bool, same_endpoint: bool) -> bool:
        """Poll until the restarted replica is live, un-drained and
        scraped again. With a directory, the fresh boot_id's rejoin
        clears the drain mark; a static same-endpoint restart has no
        rejoin signal, so the deploy un-drains explicitly once the
        replica scrapes healthy."""
        deadline = self._clock() + self.settle_timeout
        undrained = False
        while self._clock() < deadline:
            self.router.refresh()
            st = self.router.balancer.get(rid)
            if st is not None and st.live and st.last_scrape > 0 and \
                    (new_ep is None or st.endpoint == new_ep):
                if st.draining and static and same_endpoint \
                        and not undrained:
                    undrained = True
                    self.router.undrain(rid)
                    continue
                if not st.draining:
                    return True
            time.sleep(self.poll)
        return False
