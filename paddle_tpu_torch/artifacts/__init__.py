"""Warm-start artifact plane — the port of ``paddle_tpu/artifacts/``.

Crash recovery, autoscale-up and rolling deploys are only as fast as a
replica's cold start, and the port's cold start is ``nvcc``-bound: its
executables are its hand-written kernel libraries. This package makes
recovery paths zero-build, bounded-time operations:

- ``fingerprint``  — the identity a library is reusable under (source,
  header and flags digest + build plan + torch/CUDA/device
  environment);
- ``store``        — framed (magic + crc) on-disk artifacts with
  atomic single-writer publishes, the JAX package's frame byte for
  byte; torn/corrupt/stale files are detected, journaled
  (``artifacts/fallback``) and degrade to a rebuild;
- ``aot``          — a library's build with ``nvcc``, its bytes, and
  loading stored bytes without a toolkit;
- ``runtime``      — the warm ladder every kernel library resolves
  through: in-process ExecutableCache -> artifact store -> cold build
  (the compile cache, or ``nvcc``) with backfill;
- ``cache``        — the compile cache: the directory the libraries
  are built into (on by default).
"""

from paddle_tpu_torch.artifacts import aot, cache, runtime
from paddle_tpu_torch.artifacts.fingerprint import (Fingerprint,
                                                    device_signature,
                                                    fingerprint,
                                                    model_digest)
from paddle_tpu_torch.artifacts.runtime import (EXECUTABLES, configure,
                                                current_store, resolve)
from paddle_tpu_torch.artifacts.store import ArtifactStore

__all__ = [
    "aot", "cache", "runtime",
    "Fingerprint", "fingerprint", "model_digest", "device_signature",
    "ArtifactStore", "EXECUTABLES", "configure", "current_store",
    "resolve",
]
