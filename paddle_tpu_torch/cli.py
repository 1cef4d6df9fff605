"""Command line of the port — ``python -m paddle_tpu_torch.cli``.

``train`` is `paddle train` (TrainerMain.cpp:32-58): ``--config`` is a
Python config script (it defines ``cost``, and may define
``optimizer``, ``train_reader`` / ``test_reader``, ``extra_layers``,
``evaluators``, ``num_passes``) or a serialized topology JSON, and
``--job`` one of

  train      SGD over train_reader with the training infrastructure's
             flags (checkpoints and ``--auto_resume``, the guarded step,
             adaptive microbatching, the supervised reader pipeline);
  time       timed train steps on synthetic data, one JSON line;
  test       evaluate test_reader (from ``--init_model_path``);
  checkgrad  central differences against autograd over the config's
             topology;
  dump_config  the normalized topology JSON;
  profile    a ``torch.profiler`` trace of train steps.

The job runs on the card unless ``--use_tpu=false`` asks for the CPU
(``init(use_tpu=)``'s meaning).

``serve``: ``--model`` (a ``save_inference_model`` artifact) serves
``POST /infer`` through the admission-controlled ``InferenceServer``
(bounded queue, deadlines, circuit breaker, memory-pressure shedding),
and ``--decode_config`` (a Python file run with ``runpy`` that must
define ``decoder``, a ``paddle_tpu_torch.models.TransformerDecoder``)
attaches a continuous-batching ``DecodeEngine`` behind ``POST
/generate`` (plain or streamed). The front also serves ``/health``,
``/stats``, ``/metrics``, ``/events``, ``/flight``, ``/profile`` and
``/admin/drain|resume|quit`` (serving/http.py) until SIGTERM/SIGINT or
``POST /admin/quit``, then drains with a flight postmortem.
``--draft_config`` and ``--spec_k`` turn on speculative decoding,
``--kv_quant int8`` stores the KV pages in int8, and
``--kv_spill_pages`` attaches the host spill tier. With
``--coordinator HOST:PORT`` the replica joins the membership plane as
``serve/<--replica_id>`` (after its warmup, once its socket is bound)
and keeps the lease with a ``--heartbeat`` thread; it exits leave ->
transport -> drain.

``router``: the serving-fleet router daemon (fleet/) over the
``serve --coordinator`` replicas of one ``--coordinator`` —
aggregate-KV admission, prefix-affine placement, drain and
exactly-once mid-stream failover, behind ``/generate``, ``/health``,
``/stats``, ``/metrics`` and ``/admin/drain|resume``. ``--autopilot``
(implied by ``--spawn_cmd``) runs the autoscaler and arms
``/admin/deploy``, ``/admin/scale`` and ``/autopilot``. ``fleet
deploy|scale|status --router URL`` operates a running router over
that admin plane (exit 1 when a deploy pauses).

``coordinator``: the elastic-training coordinator daemon — partitions
the recordio chunks of ``--data`` into tasks and serves them, the
membership and the save election over XML-RPC (trainer/coordinator.py)
until SIGTERM/SIGINT, printing one JSON line when it serves and one
with its ``stats()`` when it stops.

``pserver``: one embedding shard daemon (embed/shard.py) — serves
row-gather / scatter-update RPCs for its key range, keeps a membership
lease on ``--coordinator``, and persists WAL + snapshots to
``--snapshot_dir``; SIGTERM snapshots, leaves, then closes the socket.

``artifacts build|verify|ls``: the warm-start store
(paddle_tpu_torch/artifacts) offline — ``build`` resolves a
``--decode_config`` engine's kernel libraries into ``--dir``; ``serve
--artifacts DIR`` then starts with no ``nvcc``. ``train`` and ``serve``
take ``--compile_cache`` (the directory the libraries are built into;
``0`` builds afresh into a private one).

``train --metrics_port N`` serves ``/metrics``, ``/events``,
``/flight``, ``/profile`` and ``/health`` (obs/httpd.py) for the whole
run and prints ``{"job": "obs", "status": "serving", "metrics_port":
N}``. ``events tail`` prints (and with ``--follow`` streams) a
journal's records; ``obs dump|selfcheck|catalog`` writes a flight
bundle (this process's, or ``--url``'s), exercises every obs surface,
or prints the declared contract (obs/catalog.py); ``trace merge`` fuses
per-process journals and traces (obs/merge.py). The JAX package's
``soak``, ``lint``, ``merge``, ``infer``, ``diagram``, ``profile`` and
``version`` wait for later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np


def _build_engine(args):
    """The --decode_config wiring, split out so tests can check the
    flag plumbing without serving."""
    from paddle_tpu_torch.serving import DecodeEngine

    ns = runpy.run_path(args.decode_config)
    decoder = ns.get("decoder")
    if decoder is None:
        raise SystemExit("--decode_config must define `decoder` "
                         "(a paddle_tpu_torch TransformerDecoder)")
    draft = None
    if args.draft_config:
        dns = runpy.run_path(args.draft_config)
        draft = dns.get("draft_decoder") or dns.get("decoder")
        if draft is None:
            raise SystemExit("--draft_config must define `decoder` "
                             "(or `draft_decoder`)")
    return DecodeEngine(decoder, num_slots=args.gen_slots,
                        page_size=args.gen_page_size,
                        max_waiting=args.max_queue,
                        draft=draft, spec_k=args.spec_k,
                        prefix_cache=args.prefix_cache == "on",
                        kv_quant=None if args.kv_quant == "none"
                        else args.kv_quant,
                        kv_spill_pages=args.kv_spill_pages)


def _build_server(args, on_quit=None):
    """serve-flag wiring, split from the signal loop so tests can check
    the flags reach InferenceServer: the merged artifact (``--model``,
    POST /infer), the decode engine (``--decode_config``, POST
    /generate), the queue, workers, deadline, memory budget and
    breaker. ``on_quit`` arms POST /admin/quit. Returns the started
    server and the (not yet serving) HTTP server."""
    from paddle_tpu_torch.serving import (CircuitBreaker, InferenceServer,
                                          build_http_server)

    breaker = CircuitBreaker(window=args.breaker_window,
                             failure_threshold=args.breaker_threshold,
                             cooldown=args.breaker_cooldown)
    engine = _build_engine(args) if args.decode_config else None
    if not args.model and engine is None:
        raise SystemExit("need --model (a merged artifact for /infer) "
                         "or --decode_config (a generate-only replica) "
                         "— got neither")
    if engine is not None:
        # the one-time costs (kernel build, first allocations) before
        # the listener admits traffic, never inside a request
        engine.warmup()
    server = InferenceServer(
        args.model or None,
        max_queue=args.max_queue, workers=args.workers,
        default_deadline=(args.deadline_ms / 1e3
                          if args.deadline_ms else None),
        max_batch_memory=args.max_batch_memory or None,
        breaker=breaker, engine=engine).start()
    httpd = build_http_server(server, args.host, args.port,
                              on_quit=on_quit)
    return server, httpd


def _wire_obs(args) -> None:
    """--run_id / --event_log / --flight_dir / --profile_every / --slo:
    the obs plane the serving front reports through. --slo alone
    implies profiling (the watchdog's step-time metrics come from the
    profiler)."""
    from paddle_tpu_torch.obs import context as obs_context
    from paddle_tpu_torch.obs.events import JOURNAL
    from paddle_tpu_torch.obs.flight import FLIGHT, install_excepthook
    if args.run_id:
        obs_context.set_run_id(args.run_id)
    if args.event_log:
        JOURNAL.configure(args.event_log,
                          max_bytes=args.event_log_max_bytes or None,
                          keep=args.event_log_keep)
    if args.flight_dir:
        FLIGHT.configure(dump_dir=args.flight_dir)
    install_excepthook()
    if not getattr(args, "profile_every", 0) and \
            not getattr(args, "slo", None):
        return
    from paddle_tpu_torch.obs.profile import PROFILER
    from paddle_tpu_torch.obs.slo import WATCHDOG, parse_objective
    if args.slo:
        WATCHDOG.configure(
            objectives=[parse_objective(s) for s in args.slo])
    PROFILER.enable(sample_every=args.profile_every or 8,
                    memory_interval=0.5)


def _cmd_serve(args) -> int:
    """Serve over HTTP with admission control until SIGTERM/SIGINT or
    POST /admin/quit: the transport stops first, then the server drains
    the admitted requests, with a flight postmortem of the moment the
    stop came."""
    from paddle_tpu_torch.obs.flight import FLIGHT

    _wire_obs(args)
    stop = threading.Event()

    def _on_admin_quit():
        # POST /admin/quit rides the SIGTERM path: the same postmortem,
        # the same transport -> drain -> close order below
        FLIGHT.maybe_autodump("admin_quit")
        stop.set()

    def _on_stop_signal(*_):
        # the SIGTERM postmortem: a bundle of the last moments before
        # the drain, while the queue/slot state is still live
        FLIGHT.maybe_autodump("sigterm")
        stop.set()

    server, httpd = _build_server(args, on_quit=_on_admin_quit)
    # fleet membership: join the coordinator directory as
    # serve/<replica_id> publishing the HTTP endpoint (the engine is
    # warm and the socket bound), so a `router` discovers and fails
    # over this replica with no static config
    registration = None
    if args.coordinator:
        from paddle_tpu_torch.fleet import ReplicaRegistration
        from paddle_tpu_torch.trainer.coordinator import connect
        chost, _, cport = args.coordinator.rpartition(":")
        port = httpd.server_address[1]
        registration = ReplicaRegistration(
            connect(chost or "127.0.0.1", int(cport)),
            args.replica_id or f"{args.host}-{port}",
            f"http://{args.host}:{port}",
            heartbeat_s=args.heartbeat).join()
    signal.signal(signal.SIGTERM, _on_stop_signal)
    signal.signal(signal.SIGINT, _on_stop_signal)
    t = threading.Thread(target=httpd.serve_forever, name="pt-serve-http")
    t.start()
    engine = server.engine
    print(json.dumps({"job": "serve", "status": "serving",
                      "host": args.host, "port": httpd.server_address[1],
                      "workers": args.workers,
                      "max_queue": args.max_queue,
                      "device": str(engine.paged.device)
                      if engine is not None else None,
                      "replica_id": registration.replica_id
                      if registration else None}), flush=True)
    while not stop.wait(0.2):
        pass
    # the goodbye FIRST (a router mid-retry sees the directory lose the
    # entry before the endpoint stops answering), then the transport,
    # then the drain
    if registration is not None:
        registration.stop(leave=True)
    httpd.shutdown()             # stop admissions at the transport...
    t.join()
    httpd.server_close()
    server.shutdown(drain=True)  # ...then drain the admitted requests
    if args.profile_every or args.slo:
        from paddle_tpu_torch.obs.profile import PROFILER
        PROFILER.disable()       # joins the pt-obs-profiler thread
    print(json.dumps({"job": "serve", "status": "stopped",
                      "stats": server.stats()}), flush=True)
    return 0


def _cmd_coordinator(args) -> int:
    """Run the elastic-training coordinator as a daemon (go/master's
    role): partition the recordio chunks into tasks, serve the task,
    membership and save-election RPCs, and snapshot the queues for a
    restart (``--snapshot`` dir or ``--snapshot_rpc`` KVStoreServer)."""
    import glob as _glob

    from paddle_tpu_torch.reader import recordio as rio
    from paddle_tpu_torch.trainer.coordinator import (Coordinator,
                                                      CoordinatorServer,
                                                      FileStore, RpcStore)
    # overlapping globs must not serve a chunk twice
    paths = sorted({p for pat in args.data for p in _glob.glob(pat)})
    if not paths:
        raise SystemExit(f"no files match --data {args.data}")
    chunks = [d for p in paths for d in rio.chunk_descriptors(p)]
    if args.snapshot and args.snapshot_rpc:
        raise SystemExit("--snapshot and --snapshot_rpc are mutually "
                         "exclusive")
    store = None
    if args.snapshot:
        store = FileStore(args.snapshot)
    elif args.snapshot_rpc:
        host, _, port = args.snapshot_rpc.rpartition(":")
        store = RpcStore(host or "127.0.0.1", int(port))
    coord = Coordinator(chunks, chunks_per_task=args.chunks_per_task,
                        timeout_s=args.task_timeout,
                        failure_max=args.failure_max, store=store,
                        worker_lease_s=args.worker_lease)
    server = CoordinatorServer(coord, host=args.host, port=args.port)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    server.start()
    # the coordinator's own state: after a snapshot recovery it serves
    # the recovered chunk list, not this invocation's --data
    print(json.dumps({"job": "coordinator", "status": "serving",
                      "host": args.host, "port": server.port,
                      "files": len(paths), "chunks": len(coord.chunks),
                      "chunks_per_task": coord.chunks_per_task,
                      "recovered": coord.recovered,
                      "generation": coord.generation}), flush=True)
    while not stop.wait(0.2):
        pass
    server.stop()
    print(json.dumps({"job": "coordinator", "status": "stopped",
                      "stats": coord.stats()}), flush=True)
    return 0


def _cmd_artifacts(args) -> int:
    """`artifacts build|verify|ls` — operate the warm-start store
    offline: a deploy pipeline builds the kernel libraries ONCE,
    verifies them, and every replica of the rollout then cold-starts
    with no ``nvcc`` from them."""
    from paddle_tpu_torch.artifacts import ArtifactStore, configure
    from paddle_tpu_torch.artifacts.runtime import ENV_STORE
    root = args.dir or os.environ.get(ENV_STORE)
    if not root:
        raise SystemExit("need --dir (or $PADDLE_TPU_ARTIFACTS)")
    if args.event_log:
        from paddle_tpu_torch.obs.events import JOURNAL
        JOURNAL.configure(args.event_log)
    store = ArtifactStore(root)
    if args.action == "ls":
        rows = store.entries()
        print(json.dumps({"job": "artifacts", "action": "ls",
                          "dir": store.root, "count": len(rows),
                          "entries": rows}, indent=2))
        return 0
    if args.action == "verify":
        rows = store.entries()
        bad = [r for r in rows if not r["ok"]]
        from paddle_tpu_torch.obs.events import emit
        for r in bad:   # same audit trail as ArtifactStore.verify()
            emit("artifacts", "verify_failed", name=r["name"],
                 path=r["path"], detail=r.get("error"))
        print(json.dumps({"job": "artifacts", "action": "verify",
                          "dir": store.root, "checked": len(rows),
                          "defective": bad}, indent=2))
        return 1 if bad else 0
    # build: construct the engine exactly as `serve` would and warm it
    # up — the ladder backfills the store with the kernel libraries
    # the engine launches
    if not args.decode_config:
        raise SystemExit("artifacts build needs --decode_config")
    configure(store.root)
    engine = _build_engine(args)
    stats = engine.warmup()
    rows = store.entries()
    print(json.dumps({"job": "artifacts", "action": "build",
                      "dir": store.root, "executables": stats,
                      "entries": rows}, indent=2))
    return 0


def _cmd_pserver(args) -> int:
    """Run one embedding shard as a daemon — the 2017 `paddle pserver`
    binary's role reborn: serve row-gather/scatter-update RPCs for this shard's
    key range, keep a membership lease on the coordinator so clients
    resolve (and fail over) through the directory, and persist
    WAL+snapshots to --snapshot_dir so a replacement started with the
    same flags restores the range digest-stable. SIGTERM snapshots,
    leaves the membership plane, and drains cleanly."""
    from paddle_tpu_torch.embed import (EmbeddingShard, EmbeddingShardServer,
                                  ShardRegistration)
    from paddle_tpu_torch.trainer.coordinator import FileStore, connect

    store = FileStore(args.snapshot_dir) if args.snapshot_dir else None
    shard = EmbeddingShard(args.shard_id, args.shards, args.dim,
                           seed=args.seed, store=store)
    restored = shard.restore_from_store() if store is not None else False
    server = EmbeddingShardServer(shard, host=args.host,
                                  port=args.port).start()
    registration = None
    if args.coordinator:
        host, _, port = args.coordinator.rpartition(":")
        registration = ShardRegistration(
            connect(host or "127.0.0.1", int(port)), shard,
            server.endpoint, heartbeat_s=args.heartbeat).join()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    print(json.dumps({"job": "pserver", "status": "serving",
                      "shard_id": shard.shard_id, "shards": shard.num_shards,
                      "dim": shard.dim, "endpoint": server.endpoint,
                      "port": server.port, "restored": restored,
                      "generation": registration.generation
                      if registration else None}), flush=True)
    while not stop.wait(0.2):
        pass
    # orderly exit: durable state first, then the goodbye, then the
    # socket — a client mid-retry sees the directory lose the entry
    # before the endpoint stops answering
    if store is not None:
        shard.save_snapshot()
    if registration is not None:
        registration.stop(leave=True)
    server.stop()
    print(json.dumps({"job": "pserver", "status": "stopped",
                      "stats": shard.stats()}), flush=True)
    return 0


# ------------------------------------------------------------ the fleet
def _build_router(args, Router, build_router_http_server, connect):
    """router-flag wiring, split from the signal loop so tests can
    check the flags reach Router (and the autopilot, when enabled)
    without a live coordinator."""
    chost, _, cport = args.coordinator.rpartition(":")
    coord = connect(chost or "127.0.0.1", int(cport))
    router = Router(coordinator=coord, affinity=args.affinity,
                    page_size=args.page_size,
                    scrape_interval=args.scrape_interval,
                    queue_timeout=args.queue_timeout,
                    drain_timeout=args.drain_timeout).start()
    autopilot = None
    if getattr(args, "autopilot", False) or \
            getattr(args, "spawn_cmd", None):
        autopilot = _build_autopilot(args, router)
    httpd = build_router_http_server(router, args.host, args.port,
                                     autopilot=autopilot)
    return router, httpd, coord, autopilot


def _build_autopilot(args, router):
    """autopilot-flag wiring (fleet/autopilot.py): with --spawn_cmd the
    provisioner runs one subprocess per replica (the {replica_id}
    template); without, spawning is impossible (journaled
    ``autopilot/spawn_failed``) but the ROLLING DEPLOY still works —
    restart asks each replica to POST /admin/quit itself and its
    supervisor to respawn it (the fresh boot_id rejoin re-admits)."""
    import shlex

    from paddle_tpu_torch.fleet.autopilot import (Autopilot,
                                                  AutopilotPolicy,
                                                  CallbackProvisioner,
                                                  SubprocessProvisioner)
    policy = AutopilotPolicy(min_replicas=args.min_replicas,
                             max_replicas=args.max_replicas)
    if getattr(args, "spawn_cmd", None):
        cmd = shlex.split(args.spawn_cmd)
        # the fleet's KV mode rides into every autoscaled replica: a
        # spawn that comes up single-tier/float in an int8+spill fleet
        # would scrape mismatched capacity and break restore-path
        # affinity
        if getattr(args, "kv_quant", "none") not in (None, "none"):
            cmd += ["--kv_quant", args.kv_quant]
        if getattr(args, "kv_spill_pages", 0):
            cmd += ["--kv_spill_pages", str(args.kv_spill_pages)]
        prov = SubprocessProvisioner(cmd)
    else:
        def _no_spawn(rid):
            raise RuntimeError("no --spawn_cmd: this autopilot can "
                               "deploy but not spawn")

        def _quit_restart(rid):
            # supervisor-managed replica: ask it to exit cleanly; the
            # supervisor respawns it and the fresh boot_id rejoins
            st = router.balancer.get(rid)
            if st is None:
                raise KeyError(f"unknown replica {rid!r}")
            router._http_post_json(st.endpoint, "/admin/quit", {})
            return {}

        prov = CallbackProvisioner(spawn=_no_spawn, stop=_no_spawn,
                                   restart=_quit_restart)
    return Autopilot(router, prov, policy=policy,
                     interval=args.autopilot_interval,
                     drain_timeout=args.drain_timeout)


def _router_teardown(router, registration, httpd,
                     autopilot=None) -> None:
    """The SIGTERM contract, in this order: AUTOPILOT FIRST — stop the
    control loop so no scale/deploy decision races the teardown;
    DRAIN — stop admitting, let in-flight requests settle on their
    replicas; LEAVE — drop the router's membership lease so clients
    resolving through the directory stop finding it; CLOSE — only then
    stop answering the socket. A client mid-retry never sees a live
    directory entry pointing at a dead port."""
    if autopilot is not None:
        autopilot.stop()
    router.shutdown(drain=True)
    if registration is not None:
        registration.stop(leave=True)
    httpd.shutdown()
    httpd.server_close()


def _cmd_router(args) -> int:
    """Run the serving-fleet router daemon: front N ``serve
    --coordinator`` replicas with aggregate-KV admission,
    prefix-affinity routing, drain/deploy and exactly-once mid-stream
    failover, until SIGTERM/SIGINT."""
    from paddle_tpu_torch.fleet import Router, build_router_http_server
    from paddle_tpu_torch.fleet.registry import Registration
    from paddle_tpu_torch.obs.flight import FLIGHT
    from paddle_tpu_torch.trainer.coordinator import connect

    _wire_obs(args)
    router, httpd, coord, autopilot = _build_router(
        args, Router, build_router_http_server, connect)
    if autopilot is not None:
        autopilot.start()
    endpoint = f"http://{args.host}:{httpd.server_address[1]}"
    registration = Registration(
        coord, "fleet/router",
        {"role": "fleet_router", "endpoint": endpoint},
        heartbeat_s=args.heartbeat).join()
    stop = threading.Event()

    def _on_stop_signal(*_):
        FLIGHT.maybe_autodump("sigterm")
        stop.set()

    signal.signal(signal.SIGTERM, _on_stop_signal)
    signal.signal(signal.SIGINT, _on_stop_signal)
    t = threading.Thread(target=httpd.serve_forever, name="pt-fleet-http")
    t.start()
    print(json.dumps({"job": "router", "status": "serving",
                      "host": args.host, "port": httpd.server_address[1],
                      "affinity": args.affinity,
                      "autopilot": autopilot is not None,
                      "replicas": len(router.balancer.replicas())}),
          flush=True)
    while not stop.wait(0.2):
        pass
    _router_teardown(router, registration, httpd, autopilot=autopilot)
    t.join()
    print(json.dumps({"job": "router", "status": "stopped",
                      "stats": router.stats()}), flush=True)
    return 0


def _build_fleet_request(args):
    """fleet-verb wiring, split from the HTTP call so tests can check
    the request shape without a live daemon: returns (method, url,
    json_body_or_None)."""
    base = args.router.rstrip("/")
    if args.action == "deploy":
        return "POST", f"{base}/admin/deploy", \
            {"force": bool(args.force)}
    if args.action == "scale":
        if args.replicas is None:
            raise SystemExit("fleet scale needs --replicas N")
        return "POST", f"{base}/admin/scale", \
            {"replicas": int(args.replicas)}
    return "GET", f"{base}/stats", None


def _cmd_fleet(args) -> int:
    """Operate a RUNNING ``router`` daemon over its admin plane:
    ``deploy`` runs the SLO-gated rolling restart (exit 1 when it
    pauses), ``scale`` resizes through the autopilot, ``status`` prints
    the fleet + autopilot snapshots."""
    import urllib.error
    import urllib.request

    def _call(method, url, body):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"}
            if data else {})
        try:
            with urllib.request.urlopen(req,
                                        timeout=args.timeout) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    method, url, body = _build_fleet_request(args)
    code, payload = _call(method, url, body)
    out = {"job": "fleet", "action": args.action, "router": args.router,
           "http_status": code, "result": payload}
    if args.action == "status" and code == 200:
        ap_code, ap = _call("GET",
                            args.router.rstrip("/") + "/autopilot", None)
        out["autopilot"] = ap if ap_code == 200 else None
    print(json.dumps(out), flush=True)
    if code != 200:
        return 1
    if args.action == "deploy" and payload.get("status") != "complete":
        return 1                       # a paused rollout is no success
    return 0


def _add_router_parsers(sub) -> None:
    rt = sub.add_parser("router", help="run the serving-fleet router "
                        "daemon: KV-aware, prefix-affine dispatch over "
                        "N serve replicas with mid-stream failover")
    rt.add_argument("--coordinator", required=True,
                    help="HOST:PORT of the `coordinator` whose "
                         "membership plane the replicas join")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed as JSON)")
    rt.add_argument("--affinity", choices=["prefix", "load"],
                    default="prefix",
                    help="placement policy: 'prefix' steers "
                         "shared-prefix traffic to the replica whose "
                         "KV trie holds those pages; 'load' is pure "
                         "least-loaded-by-KV-headroom")
    rt.add_argument("--drain_timeout", type=float, default=10.0,
                    help="seconds to wait for in-flight settles on "
                         "POST /admin/drain and SIGTERM")
    rt.add_argument("--page_size", type=int, default=16,
                    help="KV page size in tokens — must match the "
                         "replicas' --gen_page_size (the affinity index "
                         "mirrors their prefix-trie keying)")
    rt.add_argument("--scrape_interval", type=float, default=0.5,
                    help="seconds between KV-gauge scrapes of each "
                         "replica's /metrics")
    rt.add_argument("--queue_timeout", type=float, default=5.0,
                    help="how long a request may queue for fleet KV "
                         "headroom before a typed 429")
    rt.add_argument("--heartbeat", type=float, default=1.0,
                    help="the router's own membership lease heartbeat")
    rt.add_argument("--event_log", default=None,
                    help="append the fleet journal (route/failover/"
                         "drain/rejoin records) to this JSONL file")
    rt.add_argument("--run_id", default=None,
                    help="correlation id stamped on every journal "
                         "record and span (default: generated)")
    rt.add_argument("--flight_dir", default=None,
                    help="arm flight-recorder auto-dump (SIGTERM and "
                         "fatal exceptions)")
    rt.add_argument("--event_log_max_bytes", type=int, default=0,
                    help="rotate the --event_log file at N bytes "
                         "(0: never)")
    rt.add_argument("--event_log_keep", type=int, default=3,
                    help="rotated journal segments to keep")
    rt.add_argument("--autopilot", action="store_true",
                    help="run the fleet autopilot control loop "
                         "(autoscaler + SLO-gated deploys); implied by "
                         "--spawn_cmd")
    rt.add_argument("--spawn_cmd", default=None,
                    help="shell command template spawning ONE replica "
                         "process ({replica_id} substituted; the "
                         "process must print the serve daemon's JSON "
                         "status line) — arms scale-up/down; without "
                         "it the autopilot can deploy (replicas quit, "
                         "supervisors respawn) but not spawn")
    rt.add_argument("--kv_quant", choices=["none", "int8"],
                    default="none",
                    help="fleet KV mode, appended to --spawn_cmd so "
                         "autoscaled replicas boot in the same "
                         "configuration as the hand-started ones")
    rt.add_argument("--kv_spill_pages", type=int, default=0,
                    help="per-replica host spill capacity, appended to "
                         "--spawn_cmd replicas (0: omit)")
    rt.add_argument("--min_replicas", type=int, default=1,
                    help="autoscaler floor (scale-down stops here)")
    rt.add_argument("--max_replicas", type=int, default=8,
                    help="autoscaler ceiling (scale-up stops here)")
    rt.add_argument("--autopilot_interval", type=float, default=1.0,
                    help="seconds between autopilot control ticks")
    rt.add_argument("--compile_cache", default=None,
                    help="kernel-library compile cache dir, exported "
                         "to --spawn_cmd replicas so autoscale-up "
                         "starts load their libraries ('0'/'off' "
                         "disables; default: $PADDLE_TPU_COMPILE_CACHE)")
    rt.set_defaults(fn=_cmd_router)

    fl = sub.add_parser("fleet", help="operate a running `router` "
                        "daemon: SLO-gated rolling deploy, operator "
                        "scaling, status")
    fl.add_argument("action", choices=["deploy", "scale", "status"],
                    help="deploy: drain->restart->rejoin each replica "
                         "one at a time, pausing on SLO breaches; "
                         "scale: resize to --replicas through the "
                         "autopilot; status: fleet + autopilot "
                         "snapshots as JSON")
    fl.add_argument("--router", required=True,
                    help="base URL of the router daemon "
                         "(http://HOST:PORT)")
    fl.add_argument("--replicas", type=int, default=None,
                    help="scale: target replica count (clamped to the "
                         "daemon's --min/--max_replicas)")
    fl.add_argument("--force", action="store_true",
                    help="deploy: keep rolling through SLO breaches "
                         "(the journal still records them)")
    fl.add_argument("--timeout", type=float, default=600.0,
                    help="HTTP timeout for the admin call (a deploy "
                         "waits for every replica to cycle)")
    fl.set_defaults(fn=_cmd_fleet)


# ------------------------------------------------------------------ train
def _load_config(path: str) -> Dict[str, Any]:
    """Run a .py config (its namespace) or load a topology .json (whose
    outputs are its costs)."""
    if path.endswith(".py"):
        ns = runpy.run_path(path)
        if "cost" not in ns:
            raise SystemExit(f"config {path!r} defines no `cost`")
        return ns
    from paddle_tpu_torch.core.topology import Topology
    with open(path) as f:
        topo = Topology.deserialize(f.read())
    return {"cost": list(topo.outputs)}


def _topo_from_ns(ns: Dict[str, Any]):
    from paddle_tpu_torch.core.topology import Topology
    cost = ns["cost"]
    return Topology(cost if isinstance(cost, (list, tuple)) else [cost],
                    extra_outputs=list(ns.get("extra_layers") or []))


def _build_trainer(ns: Dict[str, Any], init_model_path: Optional[str]):
    import paddle_tpu_torch as paddle
    topo = _topo_from_ns(ns)
    if init_model_path:
        with open(init_model_path, "rb") as f:
            parameters = paddle.Parameters.from_tar(f)
    else:
        parameters = paddle.create_parameters(topo)
    optimizer = ns.get("optimizer") or paddle.optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9)
    return paddle.SGD(cost=ns["cost"], parameters=parameters,
                      update_equation=optimizer,
                      extra_layers=ns.get("extra_layers"),
                      evaluators=ns.get("evaluators"))


def _synthetic_batch(trainer, batch_size: int, seq_len: int = 16):
    """One seeded batch matching the topology's data types (``time`` and
    ``profile`` need shapes, not data)."""
    from paddle_tpu_torch.core.data_type import SeqType
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(batch_size):
        row = []
        for _, t in trainer.topology.data_type():
            if t.seq_type != SeqType.NO_SEQUENCE:
                if t.kind == "integer":
                    row.append([int(v) for v in
                                rng.randint(0, t.dim, seq_len)])
                else:
                    row.append([rng.randn(t.dim).astype("float32")
                                for _ in range(seq_len)])
            elif t.kind == "integer":
                row.append(int(rng.randint(0, t.dim)))
            else:
                row.append(rng.randn(t.dim).astype("float32"))
        samples.append(tuple(row))
    return samples


def _job_time(trainer, batch_size: int, iters: int,
              seq_len: int = 16) -> int:
    """TrainerBenchmark.cpp parity: timed train steps, update included;
    each step's time runs until its cost is on the host."""
    import paddle_tpu_torch as paddle
    batch = _synthetic_batch(trainer, batch_size, seq_len)

    def reader():
        while True:
            yield batch

    times = []
    t_last = [None]

    def handler(e):
        if isinstance(e, paddle.event.BeginIteration):
            t_last[0] = time.perf_counter()
        elif isinstance(e, paddle.event.EndIteration):
            e.cost                   # waits for the step
            times.append(time.perf_counter() - t_last[0])

    trainer.train(reader, num_passes=1, event_handler=handler,
                  num_batches_per_pass=iters + 3)
    steady = times[3:] or times              # drop the warm-up steps
    ms = 1000.0 * float(np.mean(steady))
    print(json.dumps({"metric": "train_ms_per_batch", "value": round(ms, 3),
                      "unit": "ms/batch", "batch_size": batch_size,
                      "seq_len": seq_len, "iters": len(steady),
                      "device": str(trainer.device)}), flush=True)
    return 0


def _job_profile(trainer, args) -> int:
    """``torch.profiler`` over ``--iters`` train steps on synthetic data
    (after two untraced warm-up steps): a Chrome trace under
    ``--profile_dir`` and the top operators by self time on stderr."""
    from torch.profiler import ProfilerActivity, profile

    batch = _synthetic_batch(trainer, args.batch_size, args.seq_len)

    def reader():
        while True:
            yield batch

    def quiet(e):
        getattr(e, "cost", None)     # lazy events: wait for each step

    out = args.profile_dir or os.path.join(".", "profile_out")
    os.makedirs(out, exist_ok=True)
    trainer.train(reader, num_passes=1, event_handler=quiet,
                  num_batches_per_pass=2)
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer.train(reader, num_passes=1, event_handler=quiet,
                      num_batches_per_pass=args.iters)
    trace = os.path.join(out, "trace.json")
    prof.export_chrome_trace(trace)
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15), file=sys.stderr)
    print(json.dumps({"job": "profile", "status": "ok", "trace_dir": out,
                      "trace": trace, "iters": args.iters}), flush=True)
    return 0


def _job_train(trainer, ns, args) -> int:
    import paddle_tpu_torch as paddle
    reader = ns.get("train_reader")
    if reader is None:
        raise SystemExit("--job=train needs a `train_reader` in the config")
    if args.data_max_bad or args.data_sample_timeout or args.data_prefetch:
        # supervise the config's batch reader: bounded prefetch with
        # clean shutdown, hung-source watchdog, per-batch error budget
        from paddle_tpu_torch.reader import ErrorBudget, supervised
        reader = supervised(
            reader, buffer_size=args.data_prefetch or 4,
            sample_timeout=args.data_sample_timeout or None,
            error_budget=ErrorBudget(max_bad=args.data_max_bad,
                                     on_bad=args.data_on_bad),
            name="train-feed")

    def handler(e):
        if isinstance(e, paddle.event.EndIteration) and \
                e.batch_id % max(args.log_period, 1) == 0:
            print(f"Pass {e.pass_id}, Batch {e.batch_id}, "
                  f"Cost {e.cost:.6f}, {e.evaluator}", flush=True)
        elif isinstance(e, paddle.event.EndPass):
            print(f"Pass {e.pass_id} done. {e.evaluator}", flush=True)
            if args.save_dir:
                trainer.save_pass(args.save_dir, e.pass_id)
        elif isinstance(e, paddle.event.FaultEvent):
            print(f"FAULT {e!r}", file=sys.stderr, flush=True)

    fault_policy = None
    if args.fault_max_bad_steps:
        from paddle_tpu_torch.trainer.fault import FaultPolicy
        fault_policy = FaultPolicy(max_bad_steps=args.fault_max_bad_steps)
    microbatch = args.microbatch
    if microbatch is not None and microbatch != "auto":
        microbatch = int(microbatch)
    num_passes = args.num_passes or int(ns.get("num_passes", 1))
    trainer.train(reader, num_passes=num_passes, event_handler=handler,
                  checkpoint_dir=args.checkpoint_dir,
                  checkpoint_period=args.checkpoint_period,
                  auto_resume=args.auto_resume, fault_policy=fault_policy,
                  microbatch=microbatch, oom_probe=args.oom_probe)
    if ns.get("test_reader") is not None:
        res = trainer.test(ns["test_reader"])
        print(f"Test: cost={res.cost:.6f} {res.evaluator}", flush=True)
    return 0


def _job_test(trainer, ns) -> int:
    reader = ns.get("test_reader") or ns.get("train_reader")
    if reader is None:
        raise SystemExit("--job=test needs a `test_reader` in the config")
    res = trainer.test(reader)
    print(f"Test: cost={res.cost:.6f} {res.evaluator}", flush=True)
    return 0


def _job_checkgrad(trainer, ns, args) -> int:
    """Trainer::checkGradient parity (Trainer.h:43): central finite
    differences against autograd over the config's whole topology, on a
    batch of the config's reader (else a synthetic one), on the
    trainer's device. The card keeps float32 matmuls off TF32
    (``paddle_tpu_torch/__init__.py``), so at the default float32
    ``--dtype`` the differences at eps 1e-3 hold there as here."""
    from paddle_tpu_torch.trainer.data_feeder import DataFeeder
    from paddle_tpu_torch.trainer.grad_check import check_topology_grads

    reader = ns.get("train_reader")
    if reader is not None:
        batch = next(iter(reader()))
        batch = batch[:min(len(batch), args.batch_size)]
    else:
        batch = _synthetic_batch(trainer, min(args.batch_size, 8),
                                 args.seq_len)
    feed = DataFeeder(trainer.topology.data_type(), None,
                      device=trainer.device)(batch)
    feed.pop("__batch_size__")
    checked = check_topology_grads(trainer.topology, feed,
                                   eps=args.checkgrad_eps, seed=args.seed,
                                   device=trainer.device)
    print(json.dumps({"job": "checkgrad", "status": "ok",
                      "params_checked": len(trainer.topology.param_specs),
                      "coords_checked": checked, "batch": len(batch),
                      "eps": args.checkgrad_eps,
                      "device": str(trainer.device)}), flush=True)
    return 0


def _cmd_train(args) -> int:
    import paddle_tpu_torch as paddle
    if args.job == "dump_config":
        print(_topo_from_ns(_load_config(args.config)).serialize())
        return 0
    paddle.init(use_tpu=args.use_tpu, trainer_count=args.trainer_count,
                seed=args.seed, compute_dtype=args.dtype,
                log_period=args.log_period)
    if args.trainer_count > 1:
        # data parallelism over the launcher's process group (torchrun
        # sets MASTER_ADDR / WORLD_SIZE / RANK): every rank runs this
        # command, and SGD builds the dp mesh
        from paddle_tpu_torch.parallel import init_distributed
        init_distributed(device_type="cpu" if args.use_tpu is False
                         else None)
    _wire_obs(args)
    from paddle_tpu_torch.obs.events import JOURNAL
    obs_httpd = None
    if args.metrics_port is not None:
        from paddle_tpu_torch.obs.httpd import start_obs_server
        obs_httpd = start_obs_server(port=args.metrics_port)
        print(json.dumps({"job": "obs", "status": "serving",
                          "metrics_port": obs_httpd.server_address[1]}),
              flush=True)
    JOURNAL.emit("trainer", "run_start", job=args.job, config=args.config)
    try:
        ns = _load_config(args.config)
        trainer = _build_trainer(ns, args.init_model_path)
        if args.job == "time":
            return _job_time(trainer, args.batch_size, args.iters,
                             args.seq_len)
        if args.job == "test":
            return _job_test(trainer, ns)
        if args.job == "checkgrad":
            return _job_checkgrad(trainer, ns, args)
        if args.job == "profile":
            return _job_profile(trainer, args)
        return _job_train(trainer, ns, args)
    finally:
        JOURNAL.emit("trainer", "run_end", job=args.job)
        if args.profile_every or args.slo:
            from paddle_tpu_torch.obs.profile import PROFILER
            PROFILER.disable()      # joins the pt-obs-profiler thread
        if obs_httpd is not None:
            obs_httpd.shutdown()    # joins the pt-obs-http thread


def _iter_journal_follow(path: str, domain=None, kind=None,
                         poll: float = 0.25, idle_timeout=None,
                         from_pos: int = 0, stop=None):
    """``tail -f`` over a journal JSONL file: yield each NEW
    schema-valid (filtered) record as it is appended. A torn trailing
    line stays buffered until its newline lands (the writer flushes
    whole lines, so this is just the race window). Ends when
    ``idle_timeout`` seconds pass with no new record (None: follow
    forever) or ``stop`` (a threading.Event) is set — the testable
    seam. Size-based rotation
    (EventJournal.configure(max_bytes=...)) is spanned losslessly:
    when the active file shrinks, the unread remainder of what is now
    ``path.1`` is drained first, then the fresh active file from 0."""
    from paddle_tpu_torch.obs.events import validate
    pos = from_pos
    buf = ""
    last_new = time.monotonic()
    while True:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size < pos:                  # truncated or rotated under us
            try:
                # rotation moved the active file to path.1 — drain the
                # records appended after our cursor before restarting
                with open(path + ".1", encoding="utf-8") as f:
                    f.seek(pos)
                    buf += f.read()
            except OSError:
                buf = ""                # plain truncation: drop the tail
            pos = 0
        if size > pos:
            with open(path, encoding="utf-8") as f:
                f.seek(pos)
                buf += f.read()
                pos = f.tell()
        if buf:
            lines = buf.split("\n")
            buf = lines.pop()           # possibly-torn tail
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = validate(json.loads(line))
                except (json.JSONDecodeError, ValueError):
                    continue            # torn/corrupt mid-stream line
                last_new = time.monotonic()
                if domain is not None and rec["domain"] != domain:
                    continue
                if kind is not None and rec["kind"] != kind:
                    continue
                yield rec
        if stop is not None and stop.is_set():
            return
        if idle_timeout is not None and \
                time.monotonic() - last_new >= idle_timeout:
            return
        time.sleep(poll)


def _cmd_events(args) -> int:
    """``events tail`` — the incident-response verb: newest journal
    records (schema-validated, filtered) as JSON lines; with
    ``--follow`` keep streaming records as the run appends them."""
    from paddle_tpu_torch.obs.events import read_journal
    if not os.path.exists(args.log):
        raise SystemExit(f"no journal at {args.log!r}")
    recs = list(read_journal(args.log, strict=False,
                             domain=args.domain, kind=args.kind))
    for r in recs[-max(args.n, 0):]:
        print(json.dumps(r), flush=True)
    if not args.follow:
        return 0
    idle = args.exit_after_idle if args.exit_after_idle > 0 else None
    for r in _iter_journal_follow(
            args.log, domain=args.domain, kind=args.kind,
            idle_timeout=idle,
            from_pos=os.path.getsize(args.log)):
        print(json.dumps(r), flush=True)
    return 0


def _cmd_obs(args) -> int:
    """``obs dump|selfcheck|catalog`` — the flight-recorder verbs plus
    the declared-contract dump."""
    from paddle_tpu_torch.obs.flight import FLIGHT
    if args.action == "catalog":
        # the machine-readable contract: every legal journal
        # (domain, kind) + fields, metric family, protocol machine and
        # fault-family mapping — what the runtime witness enforces
        from paddle_tpu_torch.obs.catalog import catalog_as_dict
        print(json.dumps(catalog_as_dict(), indent=2, sort_keys=True))
        return 0
    if args.action == "dump":
        if args.url:
            # a RUNNING process's bundle over its /flight endpoint
            # (serving front or obs httpd)
            import urllib.request
            with urllib.request.urlopen(
                    args.url.rstrip("/") + "/flight", timeout=30) as r:
                bundle = json.loads(r.read())
            out = args.out or f"flight-remote-{os.getpid()}.json"
            with open(out, "w", encoding="utf-8") as f:
                json.dump(bundle, f)
            print(json.dumps({"job": "obs_dump", "status": "ok",
                              "source": args.url, "out": out,
                              "ring_records":
                                  len(bundle.get("ring", []))}))
            return 0
        path = FLIGHT.dump("cli", path=args.out)
        print(json.dumps({"job": "obs_dump", "status": "ok",
                          "out": path}))
        return 0
    # selfcheck: exercise every observability surface end-to-end
    import tempfile

    from paddle_tpu_torch.obs.events import EventJournal, read_journal
    from paddle_tpu_torch.obs.metrics import REGISTRY
    from paddle_tpu_torch.obs.trace import TRACER
    from paddle_tpu_torch.utils.stats import global_counters
    checks = {}
    global_counters.bump("obs/selfcheck")
    text = REGISTRY.exposition()
    checks["metrics_scrape"] = \
        'paddle_tpu_counter_total{name="obs/selfcheck"} ' in text
    with tempfile.TemporaryDirectory(prefix="pt-obs-selfcheck-") as td:
        jpath = os.path.join(td, "journal.jsonl")
        j = EventJournal()
        j.configure(jpath)
        j.emit("obs", "selfcheck", probe=1)
        j.configure(None)
        recs = list(read_journal(jpath))
        checks["journal_roundtrip"] = (
            len(recs) == 1 and recs[0]["kind"] == "selfcheck"
            and "run_id" in recs[0] and "host" in recs[0])
        TRACER.start(capture_compiles=False)
        with TRACER.span("obs/selfcheck"):
            pass
        TRACER.stop()
        checks["trace_spans"] = any(
            s["name"] == "obs/selfcheck" for s in TRACER.spans())
        from paddle_tpu_torch.obs.flight import BUNDLE_VERSION
        FLIGHT.record("mark", "obs/selfcheck")
        dpath = FLIGHT.dump("selfcheck",
                            path=os.path.join(td, "flight.json"))
        with open(dpath, encoding="utf-8") as f:
            bundle = json.load(f)
        checks["flight_dump"] = (
            bundle.get("v") == BUNDLE_VERSION
            and any(r.get("name") == "obs/selfcheck"
                    for r in bundle.get("ring", []))
            and "metrics" in bundle and "journal" in bundle)
    ok = all(checks.values())
    print(json.dumps({"job": "obs_selfcheck",
                      "status": "ok" if ok else "fail",
                      "checks": checks}))
    return 0 if ok else 1


def _cmd_trace(args) -> int:
    """``trace merge`` — fuse per-process journals + chrome traces into
    one timeline (obs/merge.py)."""
    from paddle_tpu_torch.obs.merge import main as merge_main
    return merge_main(list(args.merge_args or []))


def _flag_bool(v: str) -> bool:
    low = str(v).lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v!r}")


def _add_train_parser(sub) -> None:
    tr = sub.add_parser("train", help="train / time / test / checkgrad / "
                        "dump_config / profile")
    tr.add_argument("--config", required=True,
                    help=".py config script or serialized topology .json")
    tr.add_argument("--job", default="train",
                    choices=["train", "time", "test", "checkgrad",
                             "dump_config", "profile"])
    tr.add_argument("--use_tpu", type=_flag_bool, nargs="?", const=True,
                    default=None,
                    help="the accelerator, as init(use_tpu=): false runs "
                         "the job on the CPU (default: the card)")
    tr.add_argument("--trainer_count", type=int, default=1,
                    help="data-parallel trainers: > 1 trains on a dp "
                         "mesh over the process group a launcher forms "
                         "(one rank a trainer)")
    tr.add_argument("--num_passes", type=int, default=None)
    tr.add_argument("--batch_size", type=int, default=128,
                    help="--job=time/profile synthetic batch size; "
                         "checkgrad's rows")
    tr.add_argument("--seq_len", type=int, default=16,
                    help="synthetic sequence length for --job=time")
    tr.add_argument("--iters", type=int, default=20,
                    help="--job=time/profile timed steps")
    tr.add_argument("--save_dir", default=None,
                    help="write pass-%%05d/params.tar at each pass end")
    tr.add_argument("--checkpoint_dir", default=None,
                    help="full-state checkpoint dir (params, optimizer "
                         "slots and counters, md5-verified)")
    tr.add_argument("--checkpoint_period", type=int, default=0,
                    help="checkpoint every N steps (0: pass ends only)")
    tr.add_argument("--auto_resume", action="store_true",
                    help="resume from the newest intact checkpoint in "
                         "--checkpoint_dir: a killed run relaunched with "
                         "the same flags continues where it died")
    tr.add_argument("--fault_max_bad_steps", type=int, default=0,
                    help="the guarded train step: skip non-finite "
                         "updates, roll back after N consecutive bad "
                         "steps (0 disables)")
    tr.add_argument("--data_prefetch", type=int, default=0,
                    help="supervise the train reader with an N-batch "
                         "bounded prefetch pipeline (0 disables)")
    tr.add_argument("--data_sample_timeout", type=float, default=0,
                    help="hung-source watchdog: warn and count when the "
                         "reader produces nothing for N seconds")
    tr.add_argument("--data_max_bad", type=int, default=0,
                    help="error budget: tolerate N quarantined bad "
                         "batches before a data FaultEvent")
    tr.add_argument("--data_on_bad", default="log",
                    choices=["log", "raise"],
                    help="past --data_max_bad: keep skipping (log) or "
                         "abort the run (raise)")
    tr.add_argument("--microbatch", default=None,
                    help="adaptive microbatching: 'auto' starts "
                         "full-batch and bisects into accumulated "
                         "microbatches when a step runs out of device "
                         "memory; an integer fixes the starting rows")
    tr.add_argument("--oom_probe", action="store_true",
                    help="with --microbatch: find the largest safe "
                         "microbatch on the first batch before training")
    tr.add_argument("--checkgrad_eps", type=float, default=1e-3,
                    help="--job=checkgrad finite-difference step")
    tr.add_argument("--init_model_path", default=None,
                    help="params.tar to start from")
    tr.add_argument("--profile_dir", default=None,
                    help="--job=profile trace dir (default ./profile_out)")
    tr.add_argument("--log_period", type=int, default=100)
    tr.add_argument("--metrics_port", type=int, default=None,
                    help="expose GET /metrics (Prometheus), /events, "
                         "/flight, /profile and /health on this port for "
                         "the whole run (0 picks a free port, printed as "
                         "JSON; omit to disable)")
    tr.add_argument("--event_log", default=None,
                    help="append the event journal (faults, OOMs, data "
                         "faults, checkpoints) to this JSONL file")
    tr.add_argument("--event_log_max_bytes", type=int, default=0,
                    help="rotate the --event_log file at N bytes")
    tr.add_argument("--event_log_keep", type=int, default=3,
                    help="rotated journal segments to keep")
    tr.add_argument("--run_id", default=None,
                    help="correlation id stamped on every journal record")
    tr.add_argument("--flight_dir", default=None,
                    help="arm flight-recorder auto-dump")
    tr.add_argument("--profile_every", type=int, default=0,
                    help="continuous step profiler: sample the "
                         "per-phase breakdown (data_wait, h2d, compute, "
                         "settle) every N steps and export live MFU and "
                         "device-memory gauges (0: off)")
    tr.add_argument("--slo", action="append", default=None,
                    metavar="METRIC<=TARGET[@WINDOW]",
                    help="SLO objective for the watchdog, repeatable "
                         "(e.g. step_time_p99_ms<=250@64); implies "
                         "--profile_every 8 when that flag is absent")
    tr.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--compile_cache", default=None,
                    help="kernel-library compile cache dir: a relaunched "
                         "run (auto_resume, elastic replacement) loads "
                         "its libraries instead of running nvcc ('0'/"
                         "'off' builds afresh into a private dir; "
                         "default: $PADDLE_TPU_COMPILE_CACHE, else the "
                         "repository's build/paddle_tpu_torch/)")
    tr.set_defaults(fn=_cmd_train)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_train_parser(sub)
    sv = sub.add_parser("serve", help="serve a merged artifact and/or "
                        "generation over HTTP with admission control")
    sv.add_argument("--model", default=None,
                    help="merged inference artifact "
                         "(save_inference_model) served on POST /infer "
                         "(optional with --decode_config)")
    sv.add_argument("--decode_config", default=None,
                    help="Python script defining `decoder`: attaches "
                         "the decode engine and POST /generate")
    sv.add_argument("--gen_slots", type=int, default=4,
                    help="decode slots (concurrent sequences)")
    sv.add_argument("--gen_page_size", type=int, default=16,
                    help="KV page size in tokens")
    sv.add_argument("--prefix_cache", choices=["on", "off"], default="on",
                    help="shared-prefix KV reuse")
    sv.add_argument("--draft_config", default=None,
                    help="Python script defining the draft `decoder` "
                         "for speculative decoding (with --spec_k >= 1)")
    sv.add_argument("--spec_k", type=int, default=0,
                    help="draft tokens proposed per decode step "
                         "(greedy verify; 0 disables speculation)")
    sv.add_argument("--kv_quant", choices=["none", "int8"],
                    default="none",
                    help="KV page dtype: int8 stores quantized pages "
                         "with per-row float32 scales")
    sv.add_argument("--kv_spill_pages", type=int, default=0,
                    help="host-RAM spill store capacity in pages: cold "
                         "prefix pages spill there instead of being "
                         "freed (0: off; needs --prefix_cache on)")
    sv.add_argument("--max_queue", type=int, default=64,
                    help="bound of the /infer queue and of the "
                         "generation wait queue")
    sv.add_argument("--workers", type=int, default=2,
                    help="forward worker threads for /infer")
    sv.add_argument("--deadline_ms", type=float, default=0,
                    help="default per-request deadline (0: none)")
    sv.add_argument("--max_batch_memory", type=int, default=0,
                    help="admission budget in bytes for one /infer "
                         "request's estimated footprint (0: none); a "
                         "forward that runs out of device memory "
                         "sheds and halves the batch-rows limit")
    sv.add_argument("--breaker_window", type=int, default=64,
                    help="circuit-breaker sliding window size")
    sv.add_argument("--breaker_threshold", type=float, default=0.5,
                    help="failure fraction that opens the breaker")
    sv.add_argument("--breaker_cooldown", type=float, default=2.0,
                    help="seconds open before half-open probes")
    sv.add_argument("--event_log", default=None,
                    help="append the event journal to this JSONL file "
                         "(the ring is always served on GET /events)")
    sv.add_argument("--event_log_max_bytes", type=int, default=0,
                    help="rotate the --event_log file at N bytes "
                         "(0: never)")
    sv.add_argument("--event_log_keep", type=int, default=3,
                    help="rotated journal segments to keep")
    sv.add_argument("--run_id", default=None,
                    help="correlation id stamped on every journal "
                         "record and span (default: generated)")
    sv.add_argument("--flight_dir", default=None,
                    help="arm flight-recorder auto-dump: postmortem "
                         "bundles land here on breaker-open, engine "
                         "step failures, SIGTERM, /admin/quit and "
                         "fatal exceptions")
    sv.add_argument("--profile_every", type=int, default=0,
                    help="continuous decode-step profiler, sampled "
                         "every N steps and served on GET /profile "
                         "(0: off)")
    sv.add_argument("--slo", action="append", default=None,
                    metavar="METRIC<=TARGET[@WINDOW]",
                    help="SLO objective, repeatable (e.g. "
                         "decode_step_time_p99_ms<=50); implies "
                         "--profile_every 8 when that flag is absent")
    sv.add_argument("--compile_cache", default=None,
                    help="kernel-library compile cache dir ('0'/'off' "
                         "builds afresh into a private dir; default: "
                         "$PADDLE_TPU_COMPILE_CACHE, else the "
                         "repository's build/paddle_tpu_torch/)")
    sv.add_argument("--artifacts", default=None,
                    help="artifact store dir: the decode engine loads "
                         "fingerprint-verified kernel libraries from "
                         "here at startup — a respawned replica serves "
                         "with no nvcc — and backfills it on a miss "
                         "(exported as $PADDLE_TPU_ARTIFACTS to the "
                         "processes it starts)")
    sv.add_argument("--coordinator", default=None,
                    help="HOST:PORT of a `coordinator` daemon — join "
                         "the membership plane as serve/<replica_id> "
                         "publishing this HTTP endpoint, so a `router` "
                         "discovers and fails over this replica")
    sv.add_argument("--replica_id", default=None,
                    help="fleet replica id (default: host-port)")
    sv.add_argument("--heartbeat", type=float, default=1.0,
                    help="membership lease heartbeat seconds")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed at start)")
    sv.set_defaults(fn=_cmd_serve)
    _add_router_parsers(sub)

    arts = sub.add_parser("artifacts", help="operate the warm-start "
                          "artifact store: build the decode engine's "
                          "kernel libraries into it, verify frame "
                          "integrity, list")
    arts.add_argument("action", choices=["build", "verify", "ls"],
                      help="build: resolve the kernel libraries of a "
                           "--decode_config's engine into --dir, so "
                           "replica cold starts run no nvcc; verify: "
                           "re-read every frame (nonzero exit + "
                           "artifacts/verify_failed journal records on "
                           "any corrupt/torn file); ls: one JSON row "
                           "per artifact with age/size/fingerprint")
    arts.add_argument("--dir", default=None,
                      help="artifact store directory (default: "
                           "$PADDLE_TPU_ARTIFACTS)")
    arts.add_argument("--decode_config", default=None,
                      help="build: .py script defining `decoder` — the "
                           "SAME script the serve replicas run with")
    arts.add_argument("--draft_config", default=None,
                      help="build: draft decoder script for "
                           "speculative fleets")
    arts.add_argument("--spec_k", type=int, default=0)
    arts.add_argument("--gen_slots", type=int, default=4)
    arts.add_argument("--gen_page_size", type=int, default=16)
    arts.add_argument("--prefix_cache", choices=["on", "off"],
                      default="on")
    arts.add_argument("--kv_quant", choices=["none", "int8"],
                      default="none")
    arts.add_argument("--kv_spill_pages", type=int, default=0)
    arts.add_argument("--max_queue", type=int, default=64)
    arts.add_argument("--event_log", default=None,
                      help="append the artifacts journal records to "
                           "this JSONL file")
    arts.set_defaults(fn=_cmd_artifacts)

    co = sub.add_parser("coordinator", help="run the elastic-training "
                        "coordinator daemon")
    co.add_argument("--data", nargs="+", required=True,
                    help="recordio file paths or globs to partition")
    co.add_argument("--chunks_per_task", type=int, default=1)
    co.add_argument("--host", default="127.0.0.1")
    co.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed as JSON)")
    co.add_argument("--task_timeout", type=float, default=60.0,
                    help="task lease seconds (renewed by heartbeats)")
    co.add_argument("--failure_max", type=int, default=3,
                    help="failures after which a task is dropped")
    co.add_argument("--worker_lease", type=float, default=None,
                    help="elastic membership lease seconds (expiry is "
                         "an implicit leave and a reshard; default: "
                         "--task_timeout)")
    co.add_argument("--snapshot", default=None,
                    help="dir for crash-recovery snapshots (FileStore)")
    co.add_argument("--snapshot_rpc", default=None,
                    help="HOST:PORT of a KVStoreServer: snapshots over "
                         "RPC instead of a shared filesystem (RpcStore; "
                         "exclusive with --snapshot)")
    co.set_defaults(fn=_cmd_coordinator)

    ps = sub.add_parser("pserver", help="run one embedding shard daemon "
                        "(the 2017 `paddle pserver` reborn)")
    ps.add_argument("--shard_id", type=int, required=True,
                    help="this shard's index in [0, --shards)")
    ps.add_argument("--shards", type=int, required=True,
                    help="total shard count (the hash-partition modulus "
                         "— every pserver of one table must agree)")
    ps.add_argument("--dim", type=int, default=64,
                    help="embedding row width")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed as JSON)")
    ps.add_argument("--coordinator", default=None,
                    help="HOST:PORT of a `coordinator` daemon — register "
                         "on the membership plane so clients resolve "
                         "endpoints (and fail over) through the "
                         "directory")
    ps.add_argument("--snapshot_dir", default=None,
                    help="dir for WAL + snapshots (FileStore): a "
                         "replacement started with the same flags "
                         "restores this shard's key range digest-stable")
    ps.add_argument("--heartbeat", type=float, default=1.0,
                    help="membership lease heartbeat seconds")
    ps.add_argument("--seed", type=int, default=0,
                    help="row-init seed (every pserver of one table "
                         "must agree)")
    ps.set_defaults(fn=_cmd_pserver)

    evp = sub.add_parser("events", help="inspect a structured event "
                         "journal")
    evp.add_argument("action", choices=["tail"],
                     help="tail: print the newest records as JSON lines")
    evp.add_argument("--log", required=True,
                     help="journal JSONL file (train/serve --event_log)")
    evp.add_argument("-n", type=int, default=20, dest="n",
                     help="how many records (newest last)")
    evp.add_argument("--domain", default=None,
                     help="filter: trainer|data|serving|engine|"
                          "checkpoint|slo|profile|protocol")
    evp.add_argument("--kind", default=None,
                     help="filter: oom, quarantine, shed, preemption, "
                          "...")
    evp.add_argument("--follow", action="store_true",
                     help="after printing the tail, keep streaming "
                          "records as the run appends them "
                          "(tail -f for the journal)")
    evp.add_argument("--exit-after-idle", type=float, default=0,
                     dest="exit_after_idle",
                     help="with --follow: exit after N seconds with "
                          "no new record (0: follow forever)")
    evp.set_defaults(fn=_cmd_events)

    ob = sub.add_parser("obs", help="flight-recorder verbs: postmortem "
                        "dump, observability selfcheck, the declared "
                        "contract")
    ob.add_argument("action", choices=["dump", "selfcheck", "catalog"],
                    help="dump: write a postmortem bundle (this "
                         "process, or --url for a running one); "
                         "selfcheck: exercise metrics/journal/trace/"
                         "recorder end-to-end; catalog: print the "
                         "declared journal/metric/protocol contracts "
                         "as JSON")
    ob.add_argument("--url", default=None,
                    help="dump: base URL of a running process's obs "
                         "endpoint (serving front or train "
                         "--metrics_port) — fetches GET /flight")
    ob.add_argument("--out", default=None,
                    help="dump: output path (default: the configured "
                         "dump dir or the system temp dir)")
    ob.set_defaults(fn=_cmd_obs)

    trc = sub.add_parser("trace", help="cross-process trace tooling")
    trc.add_argument("action", choices=["merge"],
                     help="merge: fuse N per-process journals + chrome "
                          "traces into one timeline")
    trc.add_argument("merge_args", nargs=argparse.REMAINDER,
                     help="merge flags: --journal FILES... "
                          "--trace FILES... --out-journal P "
                          "--out-trace P --offset HOST=SECONDS")
    trc.set_defaults(fn=_cmd_trace)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in ("train", "serve", "router"):
        # the warm-start plane, one seam for every long-lived verb:
        # --compile_cache wins, else $PADDLE_TPU_COMPILE_CACHE, else the
        # default directory. Exported so child processes inherit the
        # same choice.
        from paddle_tpu_torch.artifacts import cache as _compile_cache
        if args.compile_cache is not None:
            d = _compile_cache.enable(args.compile_cache)
            os.environ[_compile_cache.ENV_VAR] = d if d else "0"
        else:
            _compile_cache.ensure_default()
    if args.cmd == "serve" and args.artifacts:
        from paddle_tpu_torch.artifacts import configure
        from paddle_tpu_torch.artifacts.runtime import ENV_STORE
        configure(args.artifacts)
        os.environ[ENV_STORE] = args.artifacts
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
