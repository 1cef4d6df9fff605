"""Kernel-library builds and their (de)serialization — the payload
inside an artifact (the port of ``paddle_tpu/artifacts/aot.py``).

The port's executable is a built kernel library: ``nvcc`` compiles one
``csrc/`` source for ``sm_90a`` into a shared library with a plain C
interface, which ``ctypes`` loads.

- :func:`compile_aot` runs ``nvcc`` for one source into a private tmp
  path in the compile-cache directory (artifacts/cache.py) and renames
  it over the library's cache name (:func:`start_compile` /
  :func:`finish_compile` split it, so ``ops/_build.build_all`` starts
  every build at once);
- :func:`serialize_compiled` is the library's bytes;
- :func:`load_compiled` writes stored bytes atomically to a
  content-addressed file (sha256 of the payload) in the compile-cache
  directory and loads it: no ``nvcc``, and no toolkit needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
from pathlib import Path
from typing import Tuple

__all__ = ["serialize_compiled", "load_compiled", "compile_aot",
           "start_compile", "finish_compile"]

_ELF_MAGIC = b"\x7fELF"
_tmp_seq = itertools.count(1)


def start_compile(name: str) -> Tuple[subprocess.Popen, Path]:
    """Start ``nvcc`` for library ``name`` into a private tmp path.
    Returns the process and that path."""
    from paddle_tpu_torch.ops import _build
    out = _build._target(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{next(_tmp_seq)}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(tmp),
           str(_build.CSRC / _build.SOURCES[name])]
    _build._count_nvcc()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def finish_compile(name: str, proc: subprocess.Popen,
                   tmp: Path) -> Tuple[Path, str]:
    """Wait for a :func:`start_compile` build; rename its output over
    the library's cache name (atomic: readers never see a torn
    library). Returns (library path, ptxas report); raises
    ``KernelBuildError`` with nvcc's log when the build fails."""
    from paddle_tpu_torch.ops import _build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise _build.KernelBuildError(
            f"kernel build failed: {name} (nvcc exit "
            f"{proc.returncode}):\n{log}")
    out = _build._target(name)
    os.replace(tmp, out)
    return out, log


def compile_aot(name: str) -> Path:
    """Build library ``name`` with ``nvcc`` now; returns its path."""
    return finish_compile(name, *start_compile(name))[0]


def serialize_compiled(path) -> bytes:
    """A built library -> artifact payload bytes."""
    return Path(path).read_bytes()


def load_compiled(blob: bytes) -> ctypes.CDLL:
    """Artifact payload bytes -> the loaded library. Raises ValueError
    when the payload is no shared library or ``dlopen`` refuses it (the
    store's crc catches torn bytes; this catches a valid frame around
    a wrong payload)."""
    from paddle_tpu_torch.artifacts import cache
    if blob[:4] != _ELF_MAGIC:
        raise ValueError("artifact payload is no shared library "
                         "(no ELF magic)")
    digest = hashlib.sha256(blob).hexdigest()[:16]
    d = Path(cache.build_dir())
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"artifact-{digest}.so"
    if not path.is_file() or path.stat().st_size != len(blob):
        tmp = path.with_suffix(f".tmp{os.getpid()}.{next(_tmp_seq)}.so")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        path.unlink(missing_ok=True)
        raise ValueError(f"dlopen refused the artifact payload: {e}") \
            from e
