"""HTTP front for the fleet router (the ``cli.py router`` daemon's
transport; stdlib-only like serving/http.py) — the port of
``paddle_tpu/fleet/http.py``.

Endpoints:
  GET  /health          -> Router.health() (fleet membership + drain
                           marks + in-flight count)
  GET  /stats           -> Router.stats()
  GET  /metrics         -> paddle_tpu_fleet_* (+ paddle_tpu_autopilot_*
                           when an autopilot is attached) exposition +
                           the global registry (fleet/obs.py)
  GET  /autopilot       -> Autopilot.stats() (501 when the daemon runs
                           without one)
  POST /generate        -> body {"prompt": [int...],
                                 "max_new_tokens": int, ...} — routed
                           through fleet admission / prefix affinity /
                           failover; the response carries the hop
                           chain so a client can see a failover
                           happened without reading the journal.
                           With "stream": true the 200 body is
                           close-delimited NDJSON — one {"token": t}
                           line per token AS THE FLEET STREAMS IT
                           (failover hops continue the same stream),
                           then a terminal {"done": true, ...} record.
                           A torn stream (EOF before the terminal
                           record — this ROUTER died) is the client's
                           cue to retry the same trace_id on a sibling
                           router; the replica-side hop journal
                           dedupes (HA plane, family (q)).
  POST /admin/drain     -> body {"replica": id} — stop new admissions
                           to that replica, wait for in-flight settle
  POST /admin/resume    -> body {"replica": id} — manual re-admit
  POST /admin/deploy    -> body {"force": bool?} — run an SLO-gated
                           rolling deploy through the attached
                           autopilot's provisioner (fleet/autopilot.py;
                           501 without an autopilot); returns the
                           rollout summary ({"status": "complete" |
                           "paused", ...})
  POST /admin/scale     -> body {"replicas": int} — operator resize
                           through the autopilot (clamped to the
                           policy's min/max; 501 without one)

Error mapping matches serving/http.py, with the fleet's own typed
reasons: 503 + Retry-After for ``fleet_kv_capacity`` (no replica can
EVER hold the request) and ``fleet_no_replica``; 429 + Retry-After
for ``queue_full`` (headroom stayed exhausted past queue_timeout).

The returned server is a :class:`RouterHTTPServer` whose ``kill()``
tears live connections mid-write — the in-process SIGKILL twin for
the ROUTER plane (testing/faults.py family (q) ``kill_router``), the
same shape serving/http.py gives replicas.
"""

from __future__ import annotations

import json
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.serving.server import (Expired, Rejected, ServerClosed,
                                       ServingError)

from paddle_tpu_torch.fleet.obs import prometheus_text
from paddle_tpu_torch.fleet.router import Router

__all__ = ["build_router_http_server"]


def build_router_http_server(router: Router, host: str = "127.0.0.1",
                             port: int = 0,
                             autopilot=None) -> ThreadingHTTPServer:
    """An HTTP server bound to (host, port) — port 0 picks a free one.
    Caller runs .serve_forever() (usually on a thread) and
    .shutdown(). ``autopilot`` (fleet/autopilot.py) lights up the
    /admin/deploy, /admin/scale and /autopilot routes."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, router.health())
            elif self.path == "/stats":
                self._json(200, router.stats())
            elif self.path == "/metrics":
                body = prometheus_text(
                    router, autopilot=autopilot).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/autopilot":
                if autopilot is None:
                    self._json(501, {"error": "no autopilot attached "
                                              "to this router"})
                else:
                    self._json(200, autopilot.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/admin/drain":
                self._admin(req, drain=True)
                return
            if self.path == "/admin/resume":
                self._admin(req, drain=False)
                return
            if self.path == "/admin/deploy":
                self._deploy(req)
                return
            if self.path == "/admin/scale":
                self._scale(req)
                return
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                prompt = req["prompt"]
                if not isinstance(prompt, list) or not prompt:
                    raise ValueError("prompt must be a non-empty list "
                                     "of token ids")
                max_new = int(req["max_new_tokens"])
                eos_id = req.get("eos_id")
                eos_id = int(eos_id) if eos_id is not None else None
                deadline = req.get("deadline_ms")
                deadline = float(deadline) / 1e3 \
                    if deadline is not None else None
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            tid = self.headers.get("X-Trace-Id") or req.get("trace_id")
            tid = str(tid) if tid else obs_context.new_trace_id()
            hdr = [("X-Trace-Id", tid)]
            if bool(req.get("stream")):
                self._stream_generate(prompt, max_new, eos_id,
                                      deadline, tid)
                return
            try:
                with obs_context.bind(trace_id=tid):
                    res = router.generate(prompt, max_new,
                                          eos_id=eos_id,
                                          deadline=deadline,
                                          trace_id=tid)
            except Rejected as e:
                code = 429 if e.reason == "queue_full" else 503
                self._json(code, {"error": str(e), "reason": e.reason,
                                  "retry_after": e.retry_after,
                                  "trace_id": tid},
                           headers=hdr + [
                               ("Retry-After",
                                f"{max(e.retry_after, 0.01):.3f}")])
                return
            except Expired as e:
                self._json(504, {"error": str(e), "trace_id": tid},
                           headers=hdr)
                return
            except ServerClosed as e:
                self._json(503, {"error": str(e), "reason": "draining",
                                 "trace_id": tid}, headers=hdr)
                return
            except ServingError as e:
                self._json(500, {"error": str(e), "trace_id": tid},
                           headers=hdr)
                return
            out = res.as_dict()
            self._json(200, out, headers=hdr)

        def _stream_generate(self, prompt, max_new, eos_id, deadline,
                             tid: str) -> None:
            """Relay the fleet stream as close-delimited NDJSON — the
            same wire shape a replica speaks (serving/http.py), one
            level up: tokens keep flowing ACROSS a replica failover
            (the router replays and resumes), and this router's own
            death tears the stream before the terminal record, which
            is exactly the signal an HA client retries on a sibling
            router with (same trace_id; the replica hop journal is the
            fleet-wide dedupe witness)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("X-Trace-Id", tid)
            self.end_headers()
            dead = []                  # write failed: client is gone

            def _line(payload: dict) -> None:
                if dead:
                    return             # keep the fleet request alive;
                try:                   # the result still settles once
                    self.wfile.write(
                        json.dumps(payload).encode() + b"\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    dead.append(True)

            try:
                with obs_context.bind(trace_id=tid):
                    res = router.generate(
                        prompt, max_new, eos_id=eos_id,
                        deadline=deadline, trace_id=tid,
                        on_token=lambda t: _line({"token": int(t)}))
            except Rejected as e:
                _line({"error": str(e), "reason": e.reason,
                       "retry_after": e.retry_after, "trace_id": tid})
                return
            except Expired as e:
                _line({"error": str(e), "expired": True,
                       "trace_id": tid})
                return
            except ServerClosed as e:
                _line({"error": str(e), "reason": "draining",
                       "trace_id": tid})
                return
            except ServingError as e:
                _line({"error": str(e), "trace_id": tid})
                return
            out = res.as_dict()
            out["done"] = True
            _line(out)

        def _admin(self, req: dict, drain: bool):
            rid = req.get("replica")
            if not rid:
                self._json(400, {"error": "body must name a "
                                          "\"replica\""})
                return
            try:
                out = router.drain(str(rid)) if drain \
                    else router.undrain(str(rid))
            except KeyError as e:
                self._json(404, {"error": str(e)})
                return
            self._json(200, out)

        def _deploy(self, req: dict):
            if autopilot is None:
                self._json(501, {"error": "no autopilot attached to "
                                          "this router"})
                return
            out = autopilot.deploy(force=bool(req.get("force")))
            self._json(200, out)

        def _scale(self, req: dict):
            if autopilot is None:
                self._json(501, {"error": "no autopilot attached to "
                                          "this router"})
                return
            try:
                target = int(req["replicas"])
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            actions = autopilot.scale_to(target)
            self._json(200, {
                "target": target,
                "actions": [{"action": a["action"],
                             "replica": a.get("replica"),
                             "reason": a["reason"]} for a in actions],
                "replicas_live": router.stats()["replicas_live"]})

    class RouterHTTPServer(ThreadingHTTPServer):
        """ThreadingHTTPServer with connection-tracking ``kill()`` —
        the router plane's in-process SIGKILL twin (family (q)
        ``kill_router``): streaming clients see a torn NDJSON stream
        (no terminal record) and retry on a sibling router.
        serving/http.py's ReplicaHTTPServer is the one-level-down
        precedent."""

        daemon_threads = True

        def __init__(self, addr, handler):
            super().__init__(addr, handler)
            self._conn_lock = named_lock("fleet.httpd")
            self._conns = set()   # ptlint: guarded-by(fleet.httpd)
            self._killed = False

        def get_request(self):
            sock, addr = super().get_request()
            with self._conn_lock:
                self._conns.add(sock)
            return sock, addr

        def shutdown_request(self, request):
            with self._conn_lock:
                self._conns.discard(request)
            super().shutdown_request(request)

        def handle_error(self, request, client_address):
            import sys
            exc = sys.exc_info()[1]
            if isinstance(exc, (BrokenPipeError, ConnectionError,
                                OSError)):
                return             # torn sockets are chaos, not bugs
            super().handle_error(request, client_address)

        def kill(self) -> None:
            """Tear every live connection and stop the listener — no
            drain, no goodbye (connections FIRST; see
            ReplicaHTTPServer.kill for why the order matters)."""
            self._killed = True
            with self._conn_lock:
                conns = list(self._conns)
            for s in conns:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            self.shutdown()
            self.server_close()

    return RouterHTTPServer((host, port), Handler)
