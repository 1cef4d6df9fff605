"""Command line of the port — ``python -m paddle_tpu_torch.cli``.

The port has ``serve --decode_config``: the config script (a Python
file run with ``runpy``) must define ``decoder``, a
``paddle_tpu_torch.models.TransformerDecoder``; the command wraps it
in a continuous-batching ``DecodeEngine`` behind an
``InferenceServer`` and serves ``POST /generate``, ``GET /health`` and
``GET /stats`` until SIGTERM/SIGINT, then drains. ``--draft_config``
and ``--spec_k`` turn on speculative decoding, ``--kv_quant int8``
stores the KV pages in int8, and ``--kv_spill_pages`` attaches the
host spill tier. The other subcommands of ``paddle_tpu`` wait for
later slices.
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


def _cmd_serve(args) -> int:
    from paddle_tpu_torch.serving import InferenceServer, build_http_server

    engine = _build_engine(args)
    # the one-time costs (kernel build, first allocations) before the
    # listener admits traffic, never inside a request
    engine.warmup()
    server = InferenceServer(
        engine, default_deadline=(args.deadline_ms / 1e3
                                  if args.deadline_ms else None)).start()
    httpd = build_http_server(server, args.host, args.port)
    stop = threading.Event()

    def _on_stop_signal(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _on_stop_signal)
    signal.signal(signal.SIGINT, _on_stop_signal)
    t = threading.Thread(target=httpd.serve_forever, name="pt-serve-http")
    t.start()
    print(json.dumps({"job": "serve", "status": "serving",
                      "host": args.host, "port": httpd.server_address[1],
                      "device": str(engine.paged.device)}), flush=True)
    while not stop.wait(0.2):
        pass
    httpd.shutdown()             # stop admissions at the transport...
    t.join()
    httpd.server_close()
    server.shutdown(drain=True)  # ...then drain the admitted requests
    print(json.dumps({"job": "serve", "status": "stopped",
                      "stats": server.stats()}), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve", help="serve generation over HTTP")
    sv.add_argument("--decode_config", required=True,
                    help="Python script defining `decoder`")
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
                    help="bound of the generation wait queue")
    sv.add_argument("--deadline_ms", type=float, default=0,
                    help="default per-request deadline (0: none)")
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
