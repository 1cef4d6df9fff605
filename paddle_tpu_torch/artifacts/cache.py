"""The compile cache — the directory ``ops/_build.py`` builds the kernel
libraries into (the port of ``paddle_tpu/artifacts/cache.py``).

The port compiles no per-shape program: what it compiles is one shared
library per ``csrc/`` source, with ``nvcc``. Those libraries, named by
a hash of their source, the shared headers and the flags, are the
compile cache: a process that finds its library there loads it without
running ``nvcc``. This module is the one place the knobs live, so the
trainer, the serving front and the CLI wire it the same way:

- the cache is ON by default, in the repository's
  ``build/paddle_tpu_torch/`` (a bare JAX process stays cold; a bare
  port process would otherwise rebuild all of its libraries);
- ``PADDLE_TPU_COMPILE_CACHE`` and the CLI's ``--compile_cache`` share
  one grammar (:func:`resolve_dir`): a directory, or ``0`` / ``off`` /
  ``none`` / empty for off;
- OFF builds into a private temporary directory that is removed at
  exit, so every library is freshly built;
- :func:`disabled` is the scoped opt-out.

The compile cache is the layer UNDER the artifact store
(artifacts/runtime.py): a store hit loads a stored library; a miss (a
new source, a stale fingerprint, a corrupt frame) takes the library
from here, or builds it.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

__all__ = ["ENV_VAR", "default_dir", "resolve_dir", "enable",
           "enable_from_env", "ensure_default", "disabled", "build_dir"]

ENV_VAR = "PADDLE_TPU_COMPILE_CACHE"

#: values of the env var / --compile_cache flag that mean "off"
_OFF = ("0", "off", "none", "")

_lock = threading.Lock()
_dir: Optional[str] = None        # the directory in effect, once resolved
_private: Optional[str] = None    # this process's "off" directory


def default_dir() -> str:
    """The repository's ``build/paddle_tpu_torch/`` (listed in
    ``.gitignore``)."""
    return str(Path(__file__).resolve().parent.parent.parent / "build"
               / "paddle_tpu_torch")


def resolve_dir(value: Optional[str] = None,
                fallback: Optional[str] = None) -> Optional[str]:
    """One grammar for flag and env var: an explicit ``value`` wins,
    else ``PADDLE_TPU_COMPILE_CACHE``, else ``fallback``; "0"/"off"
    anywhere resolves to None (disabled)."""
    for v in (value, os.environ.get(ENV_VAR), fallback):
        if v is None:
            continue
        return None if str(v).lower() in _OFF else str(v)
    return None


def _private_dir() -> str:
    global _private
    if _private is None or not os.path.isdir(_private):
        _private = tempfile.mkdtemp(prefix="pt-compile-")
        atexit.register(shutil.rmtree, _private, ignore_errors=True)
    return _private


def enable(value: Optional[str] = None) -> Optional[str]:
    """Point this process's compile cache at ``resolve_dir``'s answer
    (created if missing), the default directory when nothing is set.
    Off (None answer) builds into a private temporary directory.
    Returns the cache directory in effect, or None when off."""
    global _dir
    d = resolve_dir(value, fallback=default_dir())
    with _lock:
        if d is None:
            _dir = _private_dir()
            return None
        os.makedirs(d, exist_ok=True)
        _dir = d
        return d


def enable_from_env() -> Optional[str]:
    """The env var, else the default directory."""
    return enable(None)


def ensure_default() -> Optional[str]:
    """Long-lived entry points (trainer start): take
    ``PADDLE_TPU_COMPILE_CACHE`` when it is set, and otherwise keep
    the directory in effect (the default one). Returns the cache
    directory in effect, or None when off."""
    if ENV_VAR in os.environ:
        return enable(None)
    d = build_dir()
    return None if d == _private else d


def build_dir() -> str:
    """The directory libraries are built into and loaded from: the
    cache directory, or the private one when the cache is off.
    Resolved from the environment at first use."""
    if _dir is None:
        enable_from_env()
    return _dir


@contextmanager
def disabled():
    """Scoped compile-cache OFF: inside, every library this process
    has not loaded yet is freshly built, into a fresh temporary
    directory removed on exit; the directory in effect before is
    restored."""
    global _dir
    prev = build_dir()
    fresh = tempfile.mkdtemp(prefix="pt-compile-")
    with _lock:
        _dir = fresh
    try:
        yield
    finally:
        with _lock:
            _dir = prev
        shutil.rmtree(fresh, ignore_errors=True)
