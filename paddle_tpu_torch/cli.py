"""Command line of the port — ``python -m paddle_tpu_torch.cli``.

The port has ``serve``: ``--model`` (a ``save_inference_model``
artifact) serves ``POST /infer`` through the admission-controlled
``InferenceServer`` (bounded queue, deadlines, circuit breaker,
memory-pressure shedding), and ``--decode_config`` (a Python file run
with ``runpy`` that must define ``decoder``, a
``paddle_tpu_torch.models.TransformerDecoder``) attaches a
continuous-batching ``DecodeEngine`` behind ``POST /generate`` (plain
or streamed). The front also serves ``/health``, ``/stats``,
``/metrics``, ``/events``, ``/flight``, ``/profile`` and
``/admin/drain|resume|quit`` (serving/http.py) until SIGTERM/SIGINT or
``POST /admin/quit``, then drains with a flight postmortem.
``--draft_config`` and ``--spec_k`` turn on speculative decoding,
``--kv_quant int8`` stores the KV pages in int8, and
``--kv_spill_pages`` attaches the host spill tier. The other
subcommands of ``paddle_tpu`` wait for later slices.
"""

from __future__ import annotations

import argparse
import json
import runpy
import signal
import sys
import threading
from typing import List, Optional


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
    if not args.profile_every and not args.slo:
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
                      if engine is not None else None}), flush=True)
    while not stop.wait(0.2):
        pass
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
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
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed at start)")
    sv.set_defaults(fn=_cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
