"""Minimal JSON/HTTP front for the port's InferenceServer (stdlib only)
— the generate subset of ``paddle_tpu/serving/http.py``.

Endpoints:
  GET  /health     -> InferenceServer.health()
  GET  /stats      -> InferenceServer.stats()
  POST /generate   -> body {"prompt": [int...], "max_new_tokens": int,
                            "eos_id": optional, "deadline_ms": optional}
                      200 {"tokens": [int...], "prefix_hit_pages": int,
                           "accepted_tokens": int, "trace_id": str}

Admission failures map onto status codes: 429 + Retry-After (queue
full), 503 + Retry-After (the KV pool can never hold the request, or
the server is draining), 504 (deadline expired), 400 (malformed
payload), 500 (generation failed). Streaming, /metrics, /events,
/flight and /admin/* wait for later slices.
"""

from __future__ import annotations

import json
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from paddle_tpu_torch.serving.server import (Expired, InferenceServer,
                                             Rejected, ServerClosed,
                                             ServingError)


def build_http_server(server: InferenceServer, host: str = "127.0.0.1",
                      port: int = 0) -> ThreadingHTTPServer:
    """An HTTP server bound to (host, port) — port 0 picks a free one
    (see ``.server_address``). The caller runs ``.serve_forever()``
    (usually on a thread), then ``.shutdown()`` and
    ``.server_close()``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):     # quiet; stats() has it
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
                self._json(200, server.health())
            elif self.path == "/stats":
                self._json(200, server.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                if not isinstance(prompt, list) or not prompt:
                    raise ValueError("prompt must be a non-empty list "
                                     "of token ids")
                prompt = [int(t) for t in prompt]
                max_new = int(req["max_new_tokens"])
                if max_new < 1:
                    raise ValueError("max_new_tokens must be >= 1")
                eos_id = req.get("eos_id")
                eos_id = int(eos_id) if eos_id is not None else None
                deadline = req.get("deadline_ms")
                deadline = float(deadline) / 1e3 \
                    if deadline is not None else None
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            tid = self.headers.get("X-Trace-Id") or req.get("trace_id") \
                or uuid.uuid4().hex[:16]
            hdr = [("X-Trace-Id", str(tid))]
            try:
                t0 = time.perf_counter()
                gen = server.submit_generate(prompt, max_new,
                                             eos_id=eos_id,
                                             deadline=deadline,
                                             trace_id=str(tid))
                toks = server.wait(gen, t0)
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
            self._json(200, {"tokens": [int(t) for t in toks],
                             "prefix_hit_pages": gen.prefix_hit_pages,
                             "accepted_tokens": gen.accepted_tokens,
                             "trace_id": tid}, headers=hdr)

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

    return _Server((host, port), Handler)
