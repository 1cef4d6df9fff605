"""JSON/HTTP front for the port's InferenceServer — the port of
``paddle_tpu/serving/http.py`` (the ``serve`` CLI's transport;
stdlib-only so the serving path adds no dependency).

Endpoints:
  GET  /health          -> InferenceServer.health() + the replica's
                           identity
  GET  /stats           -> InferenceServer.stats()
  GET  /metrics         -> Prometheus text exposition through the
                           registry (obs/metrics.py): the serving
                           counters and latency gauges (and, with a
                           decode engine attached, its KV-page and
                           slot gauges) PLUS the global registry, so
                           one scrape sees the whole process
  GET  /events          -> the event journal's in-memory ring
                           (obs/events.py; ?n=100&domain=...&kind=...
                           filters; ?since_seq=N pages forward from a
                           cursor — the response's "last_seq" is the
                           next one)
  GET  /flight          -> the flight recorder's postmortem bundle on
                           demand (obs/flight.py)
  GET  /profile         -> the live profiler snapshot and SLO state
                           (obs/profile.py, obs/slo.py);
                           ?deep_steps=N arms a torch.profiler window
                           over the next N decode steps
  POST /infer           -> body {"rows": [[f32...], ...],
                                 "deadline_ms": optional}
                           200 {"outputs": [[...], ...]}
  POST /generate        -> body {"prompt": [int...],
                                 "max_new_tokens": int,
                                 "eos_id": optional,
                                 "deadline_ms": optional,
                                 "stream": optional bool}
                           200 {"tokens": [int...],
                                "prefix_hit_pages": int,
                                "accepted_tokens": int} — routed
                           through the continuous-batching decode
                           engine (501 when no engine is attached).
                           With "stream": true the 200 body is
                           close-delimited NDJSON — one
                           {"token": t} line per generated token as
                           it lands, then a terminal {"done": true,
                           "tokens": [...], ...} record (or an
                           {"error": ...} record when the request
                           settles with a typed error mid-stream). A
                           client that disconnects cancels the
                           request, and the engine returns its pages.
  POST /admin/drain     -> stop ADMITTING (503 reason "draining" on
                           new work) while in-flight requests settle
                           and the transport stays up. POST
                           /admin/resume re-opens admission. Both
                           return /health.
  POST /admin/quit      -> ask the daemon to exit cleanly (drain ->
                           close, the same order as SIGTERM). Answers
                           200 {"quitting": true} BEFORE the teardown
                           starts; 501 when the embedding (the CLI
                           daemon) wired no quit hook.

Every /infer and /generate request gets ONE trace_id at this front —
taken from an ``X-Trace-Id`` header or body ``trace_id`` field when a
gateway propagates its own, minted fresh otherwise — which flows
through admission, queue wait, the engine slot, every decode step and
settle/shed, and is echoed back in the response body + ``X-Trace-Id``
header.

Admission failures map onto transport status codes:
  429 + Retry-After     queue full (backpressure)
  503 + Retry-After     circuit breaker open (load shed) / draining /
                        KV pool can never hold the request / a forward
                        ran out of device memory
  504                   deadline expired
  400                   malformed payload
  500                   forward failed
"""

from __future__ import annotations

import itertools
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.obs.httpd import (events_payload, flight_payload,
                                        profile_payload, send_json,
                                        send_text)
from paddle_tpu_torch.obs.metrics import (REGISTRY, SampleFamily,
                                          stats_families)
from paddle_tpu_torch.serving.server import (Expired, InferenceServer,
                                             Rejected, ServerClosed,
                                             ServingError)

#: stats() leaf keys with cumulative (counter) semantics; every other
#: numeric leaf is a gauge. The flattened names these produce
#: (paddle_tpu_serving_served, paddle_tpu_serving_engine_finished, the
#: KV-page/slot gauges...) are the JAX package's — keep them stable.
_COUNTER_KEYS = {
    # InferenceServer counters
    "served", "rejected_full", "rejected_breaker", "rejected_oom",
    "oom_events", "expired", "failed", "closed",
    # DecodeEngine counters
    "submitted", "finished", "cancelled", "preemptions",
    "rejected_queue", "rejected_capacity", "step_failures",
    "tokens_out", "prefill_tokens", "steps", "cache_tokens_read",
    "trips",
    # prefix-cache / speculative-decoding counters
    "prefix_hit_pages", "prefix_miss_pages", "prefix_cow_copies",
    "prefix_evicted_pages", "spec_proposed_tokens",
    "spec_accepted_tokens", "draft_failures",
}


def replica_identity(endpoint: str = "") -> dict:
    """The labels that join this replica's series across scrapers
    without out-of-band config: the process's run_id (obs context), its
    host tag (PADDLE_TPU_HOST) and the HTTP endpoint it serves on."""
    return {"run_id": obs_context.ensure_run_id(),
            "host": obs_context.get_host(),
            "endpoint": endpoint or ""}


def prometheus_text(server: InferenceServer,
                    prefix: str = "paddle_tpu_serving",
                    endpoint: str = "") -> str:
    """Render ``server.stats()`` (engine sub-dict included) PLUS the
    global metrics registry as Prometheus text exposition 0.0.4 — the
    ONE exposition path (obs/metrics.py; stats() flattens through
    ``stats_families``). The constant-1
    ``paddle_tpu_serving_replica_info`` gauge carries the replica's
    identity labels (run_id/host/endpoint) so a scraper identifies
    per-replica series from the scrape alone."""
    info = SampleFamily(
        f"{prefix}_replica_info", "gauge",
        "replica identity (constant 1; labels are the payload)")
    info.add({k: str(v) for k, v in
              replica_identity(endpoint).items()}, 1.0)
    return REGISTRY.exposition(
        extra=stats_families(prefix, server.stats(), _COUNTER_KEYS)
        + [info])


def build_http_server(server: InferenceServer, host: str = "127.0.0.1",
                      port: int = 0,
                      on_quit=None) -> ThreadingHTTPServer:
    """An HTTP server bound to (host, port) — port 0 picks a free one
    (see .server_address). Caller runs .serve_forever() (usually on a
    thread), then .shutdown() and .server_close(). ``on_quit`` (no-arg
    callable) arms POST /admin/quit — the CLI daemon passes its
    orderly-exit trigger so a deploy can restart replicas over HTTP."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):     # quiet; stats() has it
            pass

        def _endpoint(self) -> str:
            h, p = self.server.server_address[:2]
            return f"http://{h}:{p}"

        def _json(self, code: int, payload: dict, headers=()):
            send_json(self, code, payload, headers)

        def _trace_id(self, req: dict) -> str:
            """The request's end-to-end correlation id, minted HERE at
            the front: an ``X-Trace-Id`` header or body ``trace_id``
            field wins (a client/gateway propagating its own id), else
            a fresh one. Echoed back in every response so the client
            can quote it at the journal / flight recorder."""
            tid = self.headers.get("X-Trace-Id") or req.get("trace_id")
            return str(tid) if tid else obs_context.new_trace_id()

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health":
                payload = server.health()
                payload["replica"] = replica_identity(self._endpoint())
                self._json(200, payload)
            elif url.path == "/stats":
                self._json(200, server.stats())
            elif url.path == "/metrics":
                send_text(self, prometheus_text(
                    server, endpoint=self._endpoint()))
            elif url.path == "/events":
                self._json(*events_payload(parse_qs(url.query)))
            elif url.path == "/flight":
                self._json(*flight_payload())
            elif url.path == "/profile":
                self._json(*profile_payload(parse_qs(url.query)))
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _do_generate(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                if not isinstance(prompt, list) or not prompt:
                    raise ValueError("prompt must be a non-empty list "
                                     "of token ids")
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
            if server.engine is None:
                self._json(501, {"error": "no decode engine attached "
                                          "to this server"})
                return
            stream = bool(req.get("stream"))
            tid = self._trace_id(req)
            hdr = [("X-Trace-Id", tid)]
            try:
                with obs_context.bind(trace_id=tid):
                    gen = server.submit_generate(prompt, max_new,
                                                 eos_id=eos_id,
                                                 deadline=deadline,
                                                 trace_id=tid)
                    if stream:
                        self._stream_generate(gen, tid)
                        return
                    toks = gen.get()
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

        def _stream_generate(self, gen, tid: str) -> None:
            """Relay tokens as the engine produces them: one NDJSON
            line per token, then the terminal done/error record. The
            response is close-delimited (HTTP/1.0, no Content-Length)
            — a TEAR before the terminal record tells a client a dead
            replica from a settled request. A client disconnect
            cancels the generation (the engine returns the pages and
            settles with the tokens so far)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("X-Trace-Id", tid)
            self.end_headers()
            # the replica's side of the trace: a hop that starts here
            # and never journals a settle is one the process lost
            # mid-stream (a kill)
            journal_emit("serving", "hop", trace_id=tid, phase="start")

            def _line(payload: dict) -> None:
                self.wfile.write(json.dumps(payload).encode() + b"\n")
                self.wfile.flush()

            sent = 0
            settled = False
            try:
                while True:
                    finished = gen.done.wait(0.005)
                    toks = list(gen.tokens)
                    while sent < len(toks):
                        _line({"token": int(toks[sent])})
                        sent += 1
                    if finished:
                        break
                try:
                    final = gen.get(timeout=1.0)
                except Rejected as e:
                    _line({"error": str(e), "reason": e.reason,
                           "retry_after": e.retry_after,
                           "trace_id": tid})
                    journal_emit("serving", "hop", trace_id=tid,
                                 phase="error", reason="rejected")
                    settled = True
                    return
                except Expired as e:
                    _line({"error": str(e), "expired": True,
                           "trace_id": tid})
                    journal_emit("serving", "hop", trace_id=tid,
                                 phase="error", reason="expired")
                    settled = True
                    return
                except ServerClosed as e:
                    _line({"error": str(e), "reason": "draining",
                           "trace_id": tid})
                    journal_emit("serving", "hop", trace_id=tid,
                                 phase="error", reason="draining")
                    settled = True
                    return
                except ServingError as e:
                    _line({"error": str(e), "trace_id": tid})
                    journal_emit("serving", "hop", trace_id=tid,
                                 phase="error", reason="serving_error")
                    settled = True
                    return
                _line({"done": True,
                       "tokens": [int(t) for t in final],
                       "prefix_hit_pages": gen.prefix_hit_pages,
                       "accepted_tokens": gen.accepted_tokens,
                       "trace_id": tid})
                journal_emit("serving", "hop", trace_id=tid,
                             phase="settle", tokens=len(final))
                settled = True
            except (BrokenPipeError, ConnectionError, OSError):
                gen.cancel()          # client went away mid-stream
                journal_emit("serving", "hop", trace_id=tid,
                             phase="torn", streamed=sent)
                settled = True
            finally:
                if not settled:
                    # an unexpected exception is unwinding through the
                    # handler: terminate the hop so only a process LOSS
                    # can leave a start with no terminal in the journal
                    try:
                        gen.cancel()
                    except Exception:  # noqa: BLE001
                        pass
                    journal_emit("serving", "hop", trace_id=tid,
                                 phase="torn", streamed=sent,
                                 reason="exception")

        def do_POST(self):
            if self.path == "/generate":
                self._do_generate()
                return
            if self.path == "/admin/drain":
                payload = server.drain()
                payload["replica"] = replica_identity(self._endpoint())
                self._json(200, payload)
                return
            if self.path == "/admin/resume":
                payload = server.resume()
                payload["replica"] = replica_identity(self._endpoint())
                self._json(200, payload)
                return
            if self.path == "/admin/quit":
                if on_quit is None:
                    self._json(501, {"error": "no quit hook wired "
                                              "(in-process server?)"})
                    return
                # answer FIRST — the teardown closes this transport
                self._json(200, {
                    "quitting": True,
                    "replica": replica_identity(self._endpoint())})
                threading.Thread(target=on_quit, daemon=True,
                                 name="pt-serve-quit").start()
                return
            if self.path != "/infer":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                rows = req["rows"]
                if not isinstance(rows, list) or not rows:
                    raise ValueError("rows must be a non-empty list")
                deadline = req.get("deadline_ms")
                deadline = float(deadline) / 1e3 \
                    if deadline is not None else None
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            tid = self._trace_id(req)
            hdr = [("X-Trace-Id", tid)]
            try:
                with obs_context.bind(trace_id=tid):
                    out = server.infer_rows(rows, deadline,
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
            except ValueError as e:       # ragged / non-numeric rows
                self._json(400, {"error": f"bad request: {e}"})
                return
            self._json(200, {"outputs": np.asarray(out).tolist(),
                             "trace_id": tid}, headers=hdr)

    class ReplicaHTTPServer(ThreadingHTTPServer):
        """ThreadingHTTPServer that tracks live connections so
        ``kill()`` can tear them mid-write — the in-process twin of a
        SIGKILL: clients see a reset/EOF, never a goodbye."""

        daemon_threads = True
        # the listen backlog: socketserver's default of 5 resets part
        # of a burst of connections before admission control (the
        # bounded queue, its typed 429s) ever sees it
        request_queue_size = 128

        def __init__(self, addr, handler):
            super().__init__(addr, handler)
            self._conn_lock = named_lock("serving.httpd")
            self._conns = set()
            self._killed = False
            self._conn_ids = itertools.count()

        def process_request(self, request, client_address):
            # ThreadingMixIn's, with the connection's thread named as
            # every serving thread is (``pt-serve-*``)
            threading.Thread(
                target=self.process_request_thread,
                args=(request, client_address), daemon=True,
                name=f"pt-serve-conn-{next(self._conn_ids)}").start()

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
            # torn sockets (kill(), client disconnects) are expected
            # under chaos — never traceback-spam the daemon's stderr
            import sys
            exc = sys.exc_info()[1]
            if isinstance(exc, (BrokenPipeError, ConnectionError,
                                OSError)):
                return
            super().handle_error(request, client_address)

        def kill(self) -> None:
            """Tear every live connection and stop the listener — no
            drain, no goodbye. Connections are torn FIRST (a SIGKILL
            is instant; the serve-loop handshake in shutdown() can
            take up to its poll interval, and a fast replica would
            finish streaming in that window). In-flight streaming
            handlers hit BrokenPipe on their next write; their
            clients see a torn (close-delimited, terminal-record-less)
            stream."""
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

    return ReplicaHTTPServer((host, port), Handler)
