"""Serving plane of the port: the continuous-batching decode engine
(engine.py) with its shared-prefix KV index (prefix.py) and host spill
tier (spill.py), the admission-controlled InferenceServer (server.py)
with its circuit breaker (breaker.py), and its JSON/HTTP front
(http.py)."""

from paddle_tpu_torch.serving.breaker import CircuitBreaker
from paddle_tpu_torch.serving.engine import (DecodeEngine, GenRequest,
                                             PagePool)
from paddle_tpu_torch.serving.http import (build_http_server,
                                           prometheus_text,
                                           replica_identity)
from paddle_tpu_torch.serving.prefix import PrefixIndex, PrefixMatch
from paddle_tpu_torch.serving.server import (Expired, InferenceServer,
                                             Rejected, ServerClosed,
                                             ServingError)
from paddle_tpu_torch.serving.spill import SpillEntry, SpillStore

__all__ = ["CircuitBreaker", "DecodeEngine", "Expired", "GenRequest",
           "InferenceServer", "PagePool", "PrefixIndex", "PrefixMatch",
           "Rejected", "ServerClosed", "ServingError", "SpillEntry",
           "SpillStore", "build_http_server", "prometheus_text",
           "replica_identity"]
