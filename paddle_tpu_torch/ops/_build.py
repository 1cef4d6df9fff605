"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``paddle_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers: a build takes seconds).
Libraries go to the compile cache (artifacts/cache.py: the
repository's ``build/paddle_tpu_torch/`` by default, listed in
``.gitignore``), named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds and an unchanged one is reused.

:func:`load` resolves a library through the warm-start ladder
(artifacts/runtime.py): the in-process cache, then the artifact store
(a library built elsewhere, loaded with no ``nvcc`` once its frame and
its fingerprint — the source digest, the build plan, the torch, CUDA
and device environment — check out), then the compile cache or
``nvcc``, which backfills the store.

Everything happens at first use, never at import: the CPU tests import
every module on machines with no ``nvcc``. A build or load failure is
an exception — no caller falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "paged_window_attention": "paged_window_attention.cu",
    "gru_fwd": "gru_fwd.cu",
    "decode_attention": "decode_attention.cu",
    "flash_fwd_sm90": "flash_fwd_sm90.cu",
    "flash_dkv_sm90": "flash_dkv_sm90.cu",
    "flash_dq_sm90": "flash_dq_sm90.cu",
    "lstm_bwd_sm90": "lstm_bwd_sm90.cu",
    "lstm_fwd_sm90": "lstm_fwd_sm90.cu",
    "gru_fwd_sm90": "gru_fwd_sm90.cu",
    "flash_dq_tf32_sm90": "flash_dq_tf32_sm90.cu",
    "flash_dkv_tf32_sm90": "flash_dkv_tf32_sm90.cu",
    "flash_fwd_tf32_sm90": "flash_fwd_tf32_sm90.cu",
    "lstm_fwd_bf16x3_sm90": "lstm_fwd_bf16x3_sm90.cu",
    "lstm_bwd_bf16x3_sm90": "lstm_bwd_bf16x3_sm90.cu",
}

ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.RLock()
_digests: Dict[str, str] = {}
_nvcc = 0


class KernelBuildError(RuntimeError):
    """nvcc missing, or a kernel source failed to compile or load."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the "
            "port's CUDA kernels build on a machine with the CUDA "
            "toolkit")
    return found


def _count_nvcc() -> None:
    global _nvcc
    with _lock:
        _nvcc += 1


def nvcc_launches() -> int:
    """``nvcc`` processes this process started (the cold-start cost the
    artifact plane removes)."""
    return _nvcc


def _source_digest(name: str) -> str:
    # the shared headers are part of every source's hash: an edited
    # header rebuilds every library
    with _lock:
        digest = _digests.get(name)
        if digest is None:
            blob = (CSRC / SOURCES[name]).read_bytes()
            for header in sorted(CSRC.glob("*.cuh")):
                blob += header.read_bytes()
            digest = hashlib.sha256(
                blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
            _digests[name] = digest
        return digest


def _target(name: str) -> Path:
    from paddle_tpu_torch.artifacts import cache
    return Path(cache.build_dir()) / \
        f"{name}-{_source_digest(name)[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing from the compile
    cache, one ``nvcc`` per source, all started together. Returns
    ``{name: ptxas report}`` (registers, shared memory, spills — empty
    for a reused library). Raises :class:`KernelBuildError` naming
    each failed source."""
    from paddle_tpu_torch.artifacts import aot
    names = list(SOURCES if names is None else names)
    procs = {name: aot.start_compile(name) for name in names
             if not _target(name).exists()}
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp) in procs.items():
        try:
            reports[name] = aot.finish_compile(name, proc, tmp)[1]
        except KernelBuildError as e:
            failed.append(str(e))
    if failed:
        raise KernelBuildError("\n".join(failed))
    return reports


def fingerprint_of(name: str):
    """The library's artifact fingerprint: kind = its name, model = the
    source, header and flags digest, plan = the architecture and
    flags, env = artifacts.fingerprint.device_signature()."""
    from paddle_tpu_torch.artifacts import fingerprint
    return fingerprint(name, _source_digest(name)[:16],
                       plan={"arch": ARCH, "flags": list(NVCC_FLAGS)})


_fps: Dict[str, object] = {}
_resolve_ms: Dict[str, float] = {}


def _cold(name: str):
    """The ladder's cold rung: the compile cache's library, else a
    fresh ``nvcc`` build into it."""
    path = _target(name)
    if not path.exists():
        build_all([name])
    try:
        return ctypes.CDLL(str(path)), str(path)
    except OSError as e:
        raise KernelBuildError(f"cannot load {name}: {e}") from e


def load(name: str, warm: bool = True) -> ctypes.CDLL:
    """The kernel's shared library, resolved through the warm ladder
    (module doc). ``warm=False`` skips the artifact store: the library
    comes from this process, the compile cache, or ``nvcc``."""
    from paddle_tpu_torch.artifacts import resolve
    fp = _fps.get(name)
    if fp is None:
        with _lock:
            fp = _fps.get(name)
            if fp is None:
                fp = _fps[name] = fingerprint_of(name)
    with _lock:
        if name in _resolve_ms:
            return resolve(fp, lambda: _cold(name), warm=warm)
        t0 = time.perf_counter()
        lib = resolve(fp, lambda: _cold(name), warm=warm)
        _resolve_ms[name] = (time.perf_counter() - t0) * 1e3
        return lib


def resolve_ms() -> Dict[str, float]:
    """Milliseconds of each library's first resolution in this process
    (a store load, a compile-cache load, or a build)."""
    with _lock:
        return dict(_resolve_ms)
