"""Kernel-library resolution — the one warm-start decision point (the
port of ``paddle_tpu/artifacts/runtime.py``).

Every kernel library (``ops/_build.load``) resolves through
:func:`resolve`, which walks the warm ladder:

1. the in-process :class:`ExecutableCache` (fingerprint-keyed): every
   engine, trainer and op of one process shares ONE loaded library;
2. the configured :class:`ArtifactStore` (``PADDLE_TPU_ARTIFACTS`` or
   :func:`configure`): a cross-process warm start loads the stored
   library — no ``nvcc`` — after the store verified frame integrity
   and fingerprint match;
3. a cold build: the compile cache's library (artifacts/cache.py), or
   ``nvcc`` — then BACKFILL both layers so the next starter is warm.
   Store write failures journal and degrade — a read-only artifact
   volume never blocks serving.

Every fallback is journaled (``artifacts/fallback``) and counted
(``paddle_tpu_artifacts_fallbacks``), and a rebuild follows it. The
ladder never ends in a plain PyTorch version: where the JAX package
serves a plain ``jit`` after a failed eager compile, a failed cold
build here raises (``KernelBuildError``), after journaling
``artifacts/build_failed``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.utils.logging import get_logger

from paddle_tpu_torch.artifacts import aot
from paddle_tpu_torch.artifacts.fingerprint import Fingerprint
from paddle_tpu_torch.artifacts.store import ArtifactStore

__all__ = ["ExecutableCache", "EXECUTABLES", "configure",
           "current_store", "resolve", "ENV_STORE"]

#: env var naming the artifact store directory — the cross-process
#: warm-start switch (``cli.py serve --artifacts`` exports it to the
#: processes it starts)
ENV_STORE = "PADDLE_TPU_ARTIFACTS"


class ExecutableCache:
    """Process-global fingerprint -> loaded-library map, bounded (LRU);
    the default capacity holds every kernel library of the port."""

    def __init__(self, capacity: int = 32):
        self._lock = named_lock("artifacts.executables")
        self._entries: Dict[str, object] = {}  # ptlint: guarded-by(artifacts.executables)
        self._order: list = []  # ptlint: guarded-by(artifacts.executables)
        self.capacity = int(capacity)
        self.hits = 0
        self.misses = 0

    def get(self, fp: Fingerprint):
        with self._lock:
            exe = self._entries.get(fp.digest)
            if exe is not None:
                self.hits += 1
                if self._order[-1] != fp.digest:
                    self._order.remove(fp.digest)
                    self._order.append(fp.digest)
            else:
                self.misses += 1
            return exe

    def put(self, fp: Fingerprint, exe) -> None:
        with self._lock:
            if fp.digest not in self._entries:
                self._order.append(fp.digest)
            self._entries[fp.digest] = exe
            while len(self._order) > self.capacity:
                evict = self._order.pop(0)
                self._entries.pop(evict, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._order.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses}


EXECUTABLES = ExecutableCache()

_store_lock = threading.Lock()
_store: Optional[ArtifactStore] = None
_store_from_env = False


def configure(root: Optional[str]) -> Optional[ArtifactStore]:
    """Set (or with None clear) the process artifact store. Returns
    the active store."""
    global _store, _store_from_env
    with _store_lock:
        _store = ArtifactStore(root) if root else None
        _store_from_env = False
        return _store


def current_store() -> Optional[ArtifactStore]:
    """The configured store, falling back to ``PADDLE_TPU_ARTIFACTS``
    from the environment (resolved lazily, once)."""
    global _store, _store_from_env
    with _store_lock:
        if _store is None and not _store_from_env:
            _store_from_env = True
            root = os.environ.get(ENV_STORE)
            if root:
                _store = ArtifactStore(root)
        return _store


def _artifact_name(fp: Fingerprint) -> str:
    return f"{fp.fields.get('kind', 'fn')}-{fp.digest}"


def resolve(fp: Fingerprint, build: Callable[[], Tuple[object, str]], *,
            store: Optional[ArtifactStore] = None,
            warm: bool = True):
    """The warm ladder (module doc). ``build`` is the cold path: a
    zero-argument callable that returns ``(library, path)`` — the
    compile cache's library or a fresh ``nvcc`` build — and raises
    when it cannot. With ``warm=False`` the store is neither read nor
    written (the in-process cache still serves). Returns the loaded
    library."""
    exe = EXECUTABLES.get(fp)
    if exe is not None:
        return exe
    name = _artifact_name(fp)
    if not warm:
        store = None
    elif store is None:
        store = current_store()
    if store is not None:
        blob = store.get(name, fp)
        if blob is not None:
            try:
                exe = aot.load_compiled(blob)
            except Exception as e:  # noqa: BLE001 — degrade, never crash
                # frame was intact but the library would not load
                # (no shared library, or dlopen refuses it): same
                # contract as corrupt — journal and rebuild
                store._fallback(name, store.path(name), "unloadable",
                                repr(e)[:200])
                exe = None
            if exe is not None:
                journal_emit("artifacts", "load", name=name,
                             digest=fp.digest, source="store")
                EXECUTABLES.put(fp, exe)
                return exe
    # cold: the compile cache or nvcc, then backfill both layers
    t0 = time.monotonic()
    try:
        exe, path = build()
    except Exception as e:
        journal_emit("artifacts", "build_failed", name=name,
                     digest=fp.digest, detail=repr(e)[:200])
        raise
    build_ms = (time.monotonic() - t0) * 1e3
    EXECUTABLES.put(fp, exe)
    if store is not None:
        try:
            payload = aot.serialize_compiled(path)
            store.put(name, fp, payload,
                      meta={"build_ms": round(build_ms, 3)})
            store.record_build_ms(build_ms)
            journal_emit("artifacts", "build", name=name,
                         digest=fp.digest,
                         build_ms=round(build_ms, 3),
                         payload_bytes=len(payload))
        except Exception as e:  # noqa: BLE001 — RO volume
            journal_emit("artifacts", "build_failed", name=name,
                         digest=fp.digest, detail=repr(e)[:200])
            get_logger().warning(
                "artifact %s: built in-process but could not be "
                "persisted (%s) — later processes start cold",
                name, e)
    return exe
