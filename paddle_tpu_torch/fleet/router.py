"""The fleet router: KV-aware, prefix-affine dispatch over N serving
replicas with exactly-once mid-stream failover — the port of
``paddle_tpu/fleet/router.py``.

One :class:`Router` fronts N ``cli.py serve`` replicas:

- **Discovery** through the coordinator membership plane
  (fleet/registry.py): replicas join as ``serve/<id>`` publishing
  their HTTP endpoint; lease expiry is an implicit drain, rejoin (new
  ``boot_id``) re-admits. A static ``endpoints`` map replaces the
  directory for in-process tests/bench.
- **Admission by aggregate KV headroom** (fleet/balance.py): the
  scrape loop reads each replica's existing
  ``paddle_tpu_serving_engine_kv_pages_*`` gauges off GET /metrics;
  a request no replica could EVER hold rejects typed
  (``Rejected(reason="fleet_kv_capacity")``), a momentarily-full fleet
  QUEUES the caller (bounded by ``queue_timeout``) instead of bouncing.
- **Prefix-affinity routing**: the radix index steers same-prefix
  traffic to the replica whose prefix trie already holds those pages;
  fallback is least-loaded-by-KV-headroom. ``affinity="load"``
  disables the index.
- **Drain + deploy**: :meth:`drain` stops new admissions to one
  replica, mirrors the mark to the replica's own POST /admin/drain,
  and waits for the router's in-flight requests there to settle;
  rejoin re-admits automatically.
- **Mid-stream failover**: dispatch streams tokens off the replica's
  NDJSON /generate; when the connection tears mid-generation the
  router replays the paged prompt PLUS the already-streamed tokens on
  a sibling and resumes — greedy decode is deterministic, so the
  continuation is exactly what the victim would have produced. Every
  request settles exactly once (tokens returned, or a typed error);
  the ORIGINAL trace_id flows through every hop, so ``cli.py trace
  merge`` over the router's + replicas' journals reconstructs the full
  chain from the id alone.

Chaos coverage: testing/faults.py family (p) (``kill_replica``, a
SIGKILL mid-stream under burst, rides ``_stream_interceptor``).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence
from urllib.parse import urlparse

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.obs.flight import FLIGHT
from paddle_tpu_torch.serving.server import (Expired, Rejected, ServerClosed,
                                       ServingError)

from paddle_tpu_torch.fleet.balance import FleetBalancer
from paddle_tpu_torch.fleet.obs import register_flight_provider
from paddle_tpu_torch.fleet.registry import ReplicaRegistry, ReplicaView

__all__ = ["Router", "FleetResult"]


def _hostport(endpoint: str):
    """'http://h:p' or 'h:p' -> (host, port)."""
    if "//" not in endpoint:
        endpoint = "http://" + endpoint
    u = urlparse(endpoint)
    return u.hostname or "127.0.0.1", int(u.port or 80)


class _HopTorn(Exception):
    """The replica connection died mid-request — failover material.
    ``streamed`` carries the tokens this hop delivered before tearing."""

    def __init__(self, streamed: List[int], why: str):
        super().__init__(why)
        self.streamed = list(streamed)
        self.why = why


class _Reroute(Exception):
    """The replica declined (draining / breaker / queue full / its pool
    can never hold this) — try a sibling; ``exclude`` says whether the
    replica is out for THIS request permanently."""

    def __init__(self, reason: str, exclude: bool, draining: bool):
        super().__init__(reason)
        self.reason = reason
        self.exclude = exclude
        self.draining = draining


class FleetResult:
    """One settled fleet request: the tokens plus its hop chain."""

    __slots__ = ("tokens", "trace_id", "hops", "replica_chain",
                 "prefix_hit_pages", "accepted_tokens", "affinity_hit")

    def __init__(self, tokens, trace_id, hops, replica_chain,
                 prefix_hit_pages, accepted_tokens, affinity_hit):
        self.tokens = tokens
        self.trace_id = trace_id
        self.hops = hops
        self.replica_chain = replica_chain
        self.prefix_hit_pages = prefix_hit_pages
        self.accepted_tokens = accepted_tokens
        self.affinity_hit = affinity_hit

    def as_dict(self) -> dict:
        return {"tokens": self.tokens, "trace_id": self.trace_id,
                "hops": self.hops, "replica_chain": self.replica_chain,
                "prefix_hit_pages": self.prefix_hit_pages,
                "accepted_tokens": self.accepted_tokens,
                "affinity_hit": self.affinity_hit}


class Router:
    """See module doc. Construct with ``coordinator=`` (directory
    discovery) or ``endpoints={replica_id: url}`` (static). ``start()``
    begins the scrape/membership loop; ``shutdown()`` stops it."""

    def __init__(self, coordinator: Any = None,
                 endpoints: Optional[Dict[str, str]] = None, *,
                 affinity: str = "prefix", page_size: int = 16,
                 scrape_interval: float = 0.5,
                 queue_timeout: float = 5.0,
                 queue_poll: float = 0.05,
                 drain_timeout: float = 10.0,
                 request_timeout: float = 30.0,
                 max_hops: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        self.balancer = FleetBalancer(affinity=affinity,
                                      page_size=page_size, clock=clock)
        self.registry = ReplicaRegistry(
            coordinator=coordinator, endpoints=endpoints,
            on_join=self._on_join, on_leave=self._on_leave,
            on_rejoin=self._on_rejoin)
        self.scrape_interval = float(scrape_interval)
        self.queue_timeout = float(queue_timeout)
        self.queue_poll = float(queue_poll)
        self.drain_timeout = float(drain_timeout)
        self.request_timeout = float(request_timeout)
        self.max_hops = int(max_hops)
        self._clock = clock
        self._cv = named_lock("fleet.router")
        self._accepting = True         # ptlint: guarded-by(fleet.router)
        self._counters = {             # ptlint: guarded-by(fleet.router)
            "routed": 0, "affinity_hits": 0, "failovers": 0,
            "reroutes": 0, "rejected_kv_capacity": 0,
            "rejected_queue_full": 0, "rejected_no_replica": 0,
            "drains": 0, "rejoins": 0, "settled": 0,
            "settled_failover": 0, "queued": 0, "scrape_errors": 0}
        # trace_id -> replica_id      # ptlint: guarded-by(fleet.router)
        self._inflight: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # chaos seams (testing/faults.py family (p)): called OUTSIDE
        # the router lock, between dispatch decisions / stream tokens
        self._route_interceptor: Optional[
            Callable[[str, str, int], None]] = None
        self._stream_interceptor: Optional[
            Callable[[str, str, int], None]] = None
        register_flight_provider(self)
        self.refresh()

    # --------------------------------------------------------- membership
    def _on_join(self, view: ReplicaView) -> None:
        self.balancer.upsert(view.replica_id, view.endpoint)
        journal_emit("fleet", "join", replica=view.replica_id,
                     endpoint=view.endpoint)

    def _on_rejoin(self, view: ReplicaView) -> None:
        self.balancer.upsert(view.replica_id, view.endpoint)
        # a rejoin clears the drain mark: deploy's re-admit leg
        self.balancer.mark_draining(view.replica_id, False)
        with self._cv:
            self._counters["rejoins"] += 1
        journal_emit("fleet", "rejoin", replica=view.replica_id,
                     endpoint=view.endpoint)

    def _on_leave(self, replica_id: str) -> None:
        # lease expiry = implicit drain: no new admissions, in-flight
        # streams keep running until they settle or tear
        self.balancer.mark_dead(replica_id)
        journal_emit("fleet", "lease_lapse", replica=replica_id)

    def refresh(self) -> None:
        """One membership poll + KV-gauge scrape pass."""
        view = self.registry.poll()
        for rid, rv in view.items():
            self.balancer.upsert(rid, rv.endpoint)
        for rid, st in self.balancer.replicas().items():
            if rid not in view and self.registry.coordinator is not None:
                continue              # lapsed: _on_leave already marked
            if not st.live and rid in view:
                self.balancer.upsert(rid, view[rid].endpoint)
            self._scrape(rid)

    def _scrape(self, replica_id: str) -> None:
        """Read the replica's existing paddle_tpu_serving_* page gauges
        off its GET /metrics (the fleet acts on the SAME numbers
        Prometheus sees — no side channel)."""
        st = self.balancer.get(replica_id)
        if st is None or not st.live:
            return
        try:
            text = self._http_get_text(st.endpoint, "/metrics")
        except (OSError, http.client.HTTPException):
            n = self.balancer.record_scrape_failure(replica_id)
            with self._cv:
                self._counters["scrape_errors"] += 1
            if n >= 3:
                # an unscrapeable replica with no directory to vouch
                # for it is dead to the router (static-endpoint mode;
                # with a coordinator the lease decides)
                if self.registry.coordinator is None:
                    self.balancer.mark_dead(replica_id)
            return
        vals = {}
        for line in text.splitlines():
            if line.startswith("#") or " " not in line:
                continue
            name, _, val = line.rpartition(" ")
            for key in ("engine_kv_pages_total", "engine_kv_pages_free",
                        "engine_kv_pages_reclaimable",
                        "engine_kv_pages_spilled_now",
                        "engine_kv_spill_headroom",
                        "engine_page_size"):
                if name == f"paddle_tpu_serving_{key}":
                    try:
                        vals[key] = int(float(val))
                    except ValueError:
                        pass
        if "engine_kv_pages_total" in vals:
            self.balancer.record_scrape(
                replica_id,
                kv_pages_total=vals["engine_kv_pages_total"],
                # headroom = free list + trie pages the engine would
                # evict on demand; counting only the free list
                # livelocks admission after a prefix-heavy burst
                # (trie pages free up only under the very dispatch
                # pressure a gated router withholds)
                kv_pages_free=(
                    vals.get("engine_kv_pages_free", 0)
                    + vals.get("engine_kv_pages_reclaimable", 0)),
                page_size=vals.get("engine_page_size", 0),
                # two-tier gauges (0 on single-tier replicas): they let
                # choose() prefer a replica whose spill store can catch
                # the reclaim, keeping warm prefixes restorable instead
                # of lossily evicted
                kv_pages_reclaimable=vals.get(
                    "engine_kv_pages_reclaimable", 0),
                kv_spill_headroom=vals.get(
                    "engine_kv_spill_headroom", 0),
                kv_pages_spilled_now=vals.get(
                    "engine_kv_pages_spilled_now", 0))

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Router":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._scrape_loop, daemon=True,
                name="pt-fleet-scrape")
            self._thread.start()
        return self

    def _scrape_loop(self) -> None:
        while not self._stop.wait(self.scrape_interval):
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 — a scrape blip must not
                pass           # kill the loop; next tick retries

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admitting; with ``drain`` wait for in-flight requests
        to settle (bounded by ``timeout``/``drain_timeout``)."""
        with self._cv:
            self._accepting = False
        if drain:
            deadline = self._clock() + (timeout if timeout is not None
                                        else self.drain_timeout)
            while self._clock() < deadline:
                with self._cv:
                    if not self._inflight:
                        break
                time.sleep(0.02)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ----------------------------------------------------------- transport
    def _http_get_text(self, endpoint: str, path: str) -> str:
        host, port = _hostport(endpoint)
        conn = http.client.HTTPConnection(host, port, timeout=5.0)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.read().decode("utf-8", "replace")
        finally:
            conn.close()

    def _http_post_json(self, endpoint: str, path: str, body: dict,
                        timeout: float = 5.0) -> dict:
        host, port = _hostport(endpoint)
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            payload = json.dumps(body)
            conn.request("POST", path, body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return json.loads(resp.read().decode("utf-8", "replace")
                              or "{}")
        finally:
            conn.close()

    def _dispatch_stream(self, st, prompt: List[int], remaining: int,
                         eos_id: Optional[int],
                         deadline_s: Optional[float], trace_id: str,
                         on_token: Optional[Callable[[int], None]],
                         base_count: int):
        """One hop: stream POST /generate off ``st`` and relay tokens.
        Returns (final_hop_tokens, info). Raises _HopTorn on a torn
        connection (failover), _Reroute on a typed decline, or the
        settled typed error (Expired/ServingError) to propagate."""
        host, port = _hostport(st.endpoint)
        timeout = self.request_timeout
        if deadline_s is not None:
            timeout = max(0.05, min(timeout,
                                    deadline_s - self._clock() + 0.5))
        body = {"prompt": prompt, "max_new_tokens": remaining,
                "stream": True, "trace_id": trace_id}
        if eos_id is not None:
            body["eos_id"] = eos_id
        if deadline_s is not None:
            body["deadline_ms"] = max(
                1.0, (deadline_s - self._clock()) * 1e3)
        streamed: List[int] = []
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            try:
                conn.request("POST", "/generate", body=json.dumps(body),
                             headers={"Content-Type": "application/json",
                                      "X-Trace-Id": trace_id})
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                raise _HopTorn([], f"connect/request: {e!r}")
            if resp.status != 200:
                raw = resp.read().decode("utf-8", "replace")
                try:
                    err = json.loads(raw or "{}")
                except json.JSONDecodeError:
                    err = {}
                reason = err.get("reason", "")
                if resp.status == 429:
                    raise _Reroute("replica_queue_full", exclude=False,
                                   draining=False)
                if resp.status == 503:
                    if reason == "draining":
                        raise _Reroute("replica_draining", exclude=False,
                                       draining=True)
                    if reason == "kv_capacity":
                        # this replica can NEVER hold it; siblings may
                        raise _Reroute("replica_kv_capacity",
                                       exclude=True, draining=False)
                    raise _Reroute(f"replica_503_{reason or 'shed'}",
                                   exclude=False, draining=False)
                if resp.status == 504:
                    raise Expired(err.get("error",
                                          "replica reported expiry"))
                raise ServingError(
                    f"replica {st.replica_id} answered "
                    f"{resp.status}: {err.get('error', raw[:200])}")
            # 200: close-delimited NDJSON token stream
            while True:
                try:
                    line = resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    raise _HopTorn(streamed, f"read: {e!r}")
                if not line:
                    # EOF with no terminal record = torn mid-stream
                    raise _HopTorn(streamed, "eof before done record")
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    raise _HopTorn(streamed, "torn json line")
                if "token" in rec:
                    tok = int(rec["token"])
                    streamed.append(tok)
                    if on_token is not None:
                        on_token(tok)
                    interceptor = self._stream_interceptor
                    if interceptor is not None:
                        interceptor(trace_id, st.replica_id,
                                    base_count + len(streamed))
                    continue
                if rec.get("done"):
                    return ([int(t) for t in rec.get("tokens",
                                                     streamed)],
                            rec)
                if "error" in rec:
                    # typed settle relayed mid-stream
                    reason = rec.get("reason", "")
                    if reason in ("queue_full", "draining",
                                  "breaker_open"):
                        raise _Reroute(f"replica_{reason}",
                                       exclude=False,
                                       draining=reason == "draining")
                    if reason == "kv_capacity":
                        raise _Reroute("replica_kv_capacity",
                                       exclude=True, draining=False)
                    if rec.get("expired"):
                        raise Expired(rec["error"])
                    raise ServingError(rec["error"])
        finally:
            conn.close()

    # ------------------------------------------------------------ admission
    def generate(self, prompt: Sequence[int], max_new_tokens: int, *,
                 eos_id: Optional[int] = None,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 on_token: Optional[Callable[[int], None]] = None
                 ) -> FleetResult:
        """Route one generation through the fleet. Settles exactly
        once: returns the FleetResult or raises ONE typed serving
        error. ``on_token`` streams tokens as they arrive (across
        failover hops — the resumed stream continues the same
        callback). The trace_id (minted here when none is passed)
        rides every hop."""
        trace_id = trace_id or obs_context.current().trace_id \
            or obs_context.new_trace_id()
        prompt = [int(t) for t in prompt]
        max_new = int(max_new_tokens)
        if not prompt or max_new < 1:
            raise ValueError("need a non-empty prompt and "
                             "max_new_tokens >= 1")
        with self._cv:
            if not self._accepting:
                raise ServerClosed("router is draining or stopped")
        total = len(prompt) + max_new
        deadline_s = (self._clock() + deadline) \
            if deadline is not None else None
        tokens: List[int] = []
        exclude: set = set()
        chain: List[str] = []
        hop = 0
        queue_deadline = self._clock() + self.queue_timeout
        queued = False
        prefix_hits = 0
        accepted = 0
        affinity_hit = False
        routed = False          # a fleet/route was journaled
        terminal = False        # a fleet/settle|reject was journaled
        try:
            while True:
                if deadline_s is not None and self._clock() > deadline_s:
                    raise Expired("fleet request still unplaced past "
                                  "its deadline")
                rid, depth = self.balancer.choose(
                    prompt + tokens, total, exclude)
                if rid is None:
                    if not self.balancer.feasible_anywhere(total):
                        with self._cv:
                            self._counters["rejected_kv_capacity"] += 1
                        journal_emit("fleet", "reject", trace_id=trace_id,
                                     reason="fleet_kv_capacity",
                                     total_tokens=total)
                        terminal = True
                        raise Rejected(
                            f"request needs {total} positions but no "
                            "replica's KV pool can ever hold it",
                            retry_after=0.0, reason="fleet_kv_capacity")
                    if self._clock() >= queue_deadline:
                        if exclude and not any(
                                st.routable() for st in
                                self.balancer.replicas().values()
                                if st.replica_id not in exclude):
                            with self._cv:
                                self._counters["rejected_no_replica"] \
                                    += 1
                            journal_emit("fleet", "reject",
                                         trace_id=trace_id,
                                         reason="fleet_no_replica")
                            terminal = True
                            raise Rejected(
                                "no live replica left to place this "
                                "request on", retry_after=1.0,
                                reason="fleet_no_replica")
                        with self._cv:
                            self._counters["rejected_queue_full"] += 1
                        journal_emit("fleet", "reject", trace_id=trace_id,
                                     reason="queue_full")
                        terminal = True
                        raise Rejected(
                            f"fleet KV headroom stayed exhausted for "
                            f"{self.queue_timeout:.1f}s",
                            retry_after=self.queue_timeout / 2,
                            reason="queue_full")
                    if not queued:
                        queued = True
                        with self._cv:
                            self._counters["queued"] += 1
                    time.sleep(self.queue_poll)
                    self.refresh()
                    continue
                st = self.balancer.get(rid)
                if st is None:
                    continue
                interceptor = self._route_interceptor
                if interceptor is not None:
                    interceptor(trace_id, rid, hop)
                with self._cv:
                    self._counters["routed"] += 1
                    if depth > 0:
                        self._counters["affinity_hits"] += 1
                    self._inflight[trace_id] = rid
                if depth > 0:
                    affinity_hit = True
                self.balancer.adjust_inflight(rid, +1)
                chain.append(rid)
                journal_emit("fleet", "route", trace_id=trace_id,
                             replica=rid, hop=hop,
                             affinity_pages=depth,
                             prompt_len=len(prompt) + len(tokens),
                             max_new=max_new - len(tokens))
                routed = True
                FLIGHT.record("mark", "fleet/route", trace_id=trace_id,
                              replica=rid, hop=hop)
                try:
                    hop_tokens, info = self._dispatch_stream(
                        st, prompt + tokens, max_new - len(tokens),
                        eos_id, deadline_s, trace_id, on_token,
                        base_count=len(tokens))
                except _HopTorn as e:
                    tokens.extend(e.streamed)
                    self.balancer.mark_dead(rid)
                    exclude.add(rid)
                    hop += 1
                    with self._cv:
                        self._counters["failovers"] += 1
                    journal_emit("fleet", "failover", trace_id=trace_id,
                                 victim=rid, hop=hop, why=e.why,
                                 streamed=len(tokens))
                    FLIGHT.record("mark", "fleet/failover",
                                  trace_id=trace_id, victim=rid)
                    if max_new - len(tokens) <= 0 or (
                            eos_id is not None and tokens
                            and tokens[-1] == eos_id):
                        # The victim streamed every token the request
                        # could produce (budget spent, or EOS out) and
                        # tore before the done record. There is nothing
                        # left to replay — a sibling dispatch would
                        # either ask for max_new_tokens=0 or generate
                        # past EOS, both of which a non-failed run can
                        # never do. Settle with what we hold.
                        with self._cv:
                            self._counters["settled"] += 1
                            self._counters["settled_failover"] += 1
                        journal_emit("fleet", "settle",
                                     trace_id=trace_id, replica=rid,
                                     hops=hop, tokens=len(tokens))
                        terminal = True
                        return FleetResult(tokens, trace_id, hop, chain,
                                           prefix_hits, accepted,
                                           affinity_hit)
                    if hop >= self.max_hops:
                        raise ServingError(
                            f"request failed over {hop} times "
                            f"(trace {trace_id}); giving up")
                    queue_deadline = self._clock() + self.queue_timeout
                    continue
                except _Reroute as e:
                    with self._cv:
                        self._counters["reroutes"] += 1
                    if e.draining:
                        self.balancer.mark_draining(rid, True)
                    if e.exclude:
                        exclude.add(rid)
                    journal_emit("fleet", "reroute", trace_id=trace_id,
                                 replica=rid, reason=e.reason)
                    if self._clock() >= queue_deadline:
                        # Declines (429/typed 503) must respect the
                        # same queueing bound as choose() returning
                        # None, or a replica that keeps answering
                        # replica_queue_full while its scraped headroom
                        # looks fine would spin this loop forever.
                        with self._cv:
                            self._counters["rejected_queue_full"] += 1
                        journal_emit("fleet", "reject",
                                     trace_id=trace_id,
                                     reason="queue_full")
                        terminal = True
                        raise Rejected(
                            f"replicas kept declining for "
                            f"{self.queue_timeout:.1f}s "
                            f"(last: {e.reason})",
                            retry_after=self.queue_timeout / 2,
                            reason="queue_full")
                    time.sleep(self.queue_poll)
                    continue
                finally:
                    self.balancer.adjust_inflight(rid, -1)
                    with self._cv:
                        self._inflight.pop(trace_id, None)
                # settled on this hop: hop_tokens is the replica's
                # authoritative list for the replayed remainder
                tokens.extend(hop_tokens)
                prefix_hits += int(info.get("prefix_hit_pages", 0) or 0)
                accepted += int(info.get("accepted_tokens", 0) or 0)
                self.balancer.observe_served(prompt + tokens, rid)
                with self._cv:
                    self._counters["settled"] += 1
                    if hop > 0:
                        self._counters["settled_failover"] += 1
                journal_emit("fleet", "settle", trace_id=trace_id,
                             replica=rid, hops=hop + 1,
                             tokens=len(tokens))
                terminal = True
                return FleetResult(tokens, trace_id, hop + 1, chain,
                                   prefix_hits, accepted, affinity_hit)
        finally:
            with self._cv:
                self._inflight.pop(trace_id, None)
            if routed and not terminal:
                # an Expired deadline, max-hops ServingError, or an
                # unexpected error is unwinding out of a ROUTED
                # request: terminate the fleet_request machine
                # (ptproto) so a routed trace with no terminal record
                # can only mean a lost process
                with self._cv:
                    self._counters["rejected_router_error"] = \
                        self._counters.get("rejected_router_error",
                                           0) + 1
                journal_emit("fleet", "reject", trace_id=trace_id,
                             reason="router_error")

    # ---------------------------------------------------------------- drain
    def drain(self, replica_id: str,
              timeout: Optional[float] = None) -> dict:
        """Deploy leg: stop routing NEW requests to ``replica_id``,
        mirror the mark to the replica's own /admin/drain, and wait
        (bounded) for the router's in-flight requests there to settle.
        The replica re-admits automatically when it rejoins with a
        fresh boot_id."""
        st = self.balancer.get(replica_id)
        if st is None:
            raise KeyError(f"unknown replica {replica_id!r}")
        self.balancer.mark_draining(replica_id, True)
        with self._cv:
            self._counters["drains"] += 1
        try:
            self._http_post_json(st.endpoint, "/admin/drain", {})
        except (OSError, http.client.HTTPException,
                json.JSONDecodeError):
            pass                       # dead replica is already drained
        deadline = self._clock() + (timeout if timeout is not None
                                    else self.drain_timeout)
        settled = False
        while self._clock() < deadline:
            with self._cv:
                busy = any(r == replica_id
                           for r in self._inflight.values())
            if not busy:
                settled = True
                break
            time.sleep(0.02)
        journal_emit("fleet", "drain", replica=replica_id,
                     settled=settled)
        return {"replica": replica_id, "draining": True,
                "settled": settled}

    def undrain(self, replica_id: str) -> dict:
        """Manual re-admit (rejoin does this automatically)."""
        st = self.balancer.get(replica_id)
        if st is None:
            raise KeyError(f"unknown replica {replica_id!r}")
        self.balancer.mark_draining(replica_id, False)
        try:
            self._http_post_json(st.endpoint, "/admin/resume", {})
        except (OSError, http.client.HTTPException,
                json.JSONDecodeError):
            pass
        journal_emit("fleet", "undrain", replica=replica_id)
        return {"replica": replica_id, "draining": False}

    # ------------------------------------------------------------ snapshots
    def health(self) -> dict:
        bal = self.balancer.stats()
        with self._cv:
            accepting = self._accepting
            inflight = len(self._inflight)
        live = bal["replicas_live"]
        status = "ok" if (accepting and live) else \
            ("draining" if not accepting else "no_replicas")
        return {"status": status, "accepting": accepting,
                "inflight": inflight, "replicas": bal["replicas"],
                "replicas_live": live,
                "replicas_draining": bal["replicas_draining"]}

    def stats(self) -> dict:
        with self._cv:
            counters = dict(self._counters)
            inflight = len(self._inflight)
        bal = self.balancer.stats()
        out = dict(counters)
        out.update({
            "inflight": inflight,
            "replicas": bal["replicas"],
            "replicas_live": bal["replicas_live"],
            "replicas_draining": bal["replicas_draining"],
            "kv_pages_total": bal["kv_pages_total"],
            "kv_pages_free": bal["kv_pages_free"],
            "kv_pages_spilled_now": bal["kv_pages_spilled_now"],
            "kv_spill_headroom": bal["kv_spill_headroom"],
            "affinity_nodes": bal["index"]["nodes"],
            # seconds the membership view has been served without a
            # successful coordinator scan (fleet/registry.py stale-view
            # degradation) -> paddle_tpu_fleet_registry_stale_s
            "registry_stale_s": round(self.registry.staleness(), 3),
        })
        return out

    def flight_state(self) -> dict:
        with self._cv:
            inflight = dict(self._inflight)
        draining = [rid for rid, st in
                    self.balancer.replicas().items() if st.draining]
        return {"inflight_trace_ids": inflight, "draining": draining}
