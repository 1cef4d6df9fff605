"""Standalone observability endpoint for non-serving processes — the
port of ``paddle_tpu/obs/httpd.py``.

The serving front exposes these routes beside its own
(serving/http.py); a trainer or coordinator starts this tiny stdlib
server instead (CLI ``train --metrics_port``):

  GET /metrics   Prometheus text exposition of the global registry
  GET /events    the event journal's in-memory ring as JSON
                 (?n=100&domain=...&kind=... filters; ?since_seq=N
                 pages forward from a cursor — the response's
                 "last_seq" is the next cursor)
  GET /flight    the flight recorder's postmortem bundle, on demand
                 (``cli.py obs dump --url`` fetches this)
  GET /profile   the continuous profiler's live snapshot plus the SLO
                 watchdog state; ?deep_steps=N arms a torch.profiler
                 window over the next N observed steps
  GET /health    {"status": "ok"} liveness probe

The /events, /flight and /profile payloads and the JSON/text writers
are one implementation each (``events_payload``, ``flight_payload``,
``profile_payload``, ``send_json``, ``send_text``), which the serving
front's handler calls too. Scrape handlers only READ snapshots; they
never touch the train step.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Tuple
from urllib.parse import parse_qs, urlparse

__all__ = ["build_obs_http_server", "start_obs_server", "ObsHTTPServer",
           "events_payload", "flight_payload", "profile_payload",
           "send_json", "send_text"]

Query = Dict[str, List[str]]


def send_json(handler: BaseHTTPRequestHandler, code: int, payload: dict,
              headers=()) -> None:
    body = json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in headers:
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


def send_text(handler: BaseHTTPRequestHandler, text: str) -> None:
    """A Prometheus text exposition body."""
    body = text.encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def events_payload(qs: Query) -> Tuple[int, dict]:
    """GET /events: the journal ring's newest ``n`` records (filtered by
    ``domain``/``kind``, paged by ``since_seq``) and ``last_seq``."""
    from paddle_tpu_torch.obs.events import JOURNAL
    try:
        n = int(qs.get("n", ["100"])[0])
        since = qs.get("since_seq", [None])[0]
        since = int(since) if since is not None else None
    except ValueError:
        return 400, {"error": "n/since_seq must be integers"}
    return 200, {"events": JOURNAL.tail(
        n, domain=qs.get("domain", [None])[0],
        kind=qs.get("kind", [None])[0], since_seq=since),
        "last_seq": JOURNAL.last_seq}


def flight_payload() -> Tuple[int, dict]:
    """GET /flight: the flight recorder's bundle, on demand."""
    from paddle_tpu_torch.obs.flight import FLIGHT
    return 200, FLIGHT.bundle(reason="http")


def profile_payload(qs: Query) -> Tuple[int, dict]:
    """GET /profile: the live per-phase/MFU/memory snapshot and the SLO
    state; ``deep_steps=N`` arms a torch.profiler window over the next
    N observed steps."""
    from paddle_tpu_torch.obs.profile import PROFILER
    from paddle_tpu_torch.obs.slo import WATCHDOG
    payload = {}
    deep = qs.get("deep_steps", [None])[0]
    if deep is not None:
        try:
            payload["armed_trace_dir"] = PROFILER.arm_window(int(deep))
        except ValueError:
            return 400, {"error": "deep_steps must be an integer"}
    payload["profile"] = PROFILER.snapshot()
    payload["slo"] = WATCHDOG.snapshot()
    return 200, payload


class ObsHTTPServer(ThreadingHTTPServer):
    """The endpoint's server; ``shutdown()`` also closes the socket and
    joins the serving thread ``start_obs_server`` started."""

    thread: threading.Thread = None

    def shutdown(self) -> None:
        super().shutdown()
        self.server_close()
        if self.thread is not None:
            self.thread.join()


def build_obs_http_server(host: str = "127.0.0.1",
                          port: int = 0) -> ObsHTTPServer:
    """Bound (not yet serving) observability HTTP server; port 0 picks
    a free one (see ``.server_address``). Caller runs
    ``.serve_forever()`` (usually on a thread) and ``.shutdown()``."""
    from paddle_tpu_torch.obs.metrics import REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):       # scrapes are not news
            pass

        def do_GET(self):
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            if url.path == "/metrics":
                send_text(self, REGISTRY.exposition())
            elif url.path == "/events":
                send_json(self, *events_payload(qs))
            elif url.path == "/flight":
                send_json(self, *flight_payload())
            elif url.path == "/profile":
                send_json(self, *profile_payload(qs))
            elif url.path == "/health":
                send_json(self, 200, {"status": "ok"})
            else:
                send_json(self, 404, {"error": f"no route {url.path}"})

    return ObsHTTPServer((host, port), Handler)


def start_obs_server(host: str = "127.0.0.1",
                     port: int = 0) -> ObsHTTPServer:
    """Build + serve on a daemon thread named ``pt-obs-http``. Returns
    the server; the bound port is ``server.server_address[1]``; stop
    with ``server.shutdown()``, which joins the thread."""
    httpd = build_obs_http_server(host, port)
    httpd.thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                                    name="pt-obs-http")
    httpd.thread.start()
    return httpd
