"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``paddle_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers: a build takes seconds).
Libraries go to ``build/paddle_tpu_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds and an unchanged one is reused.

Everything happens at first use, never at import: the CPU tests import
every module on machines with no ``nvcc``. A build or load failure is
an exception — no caller falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "paddle_tpu_torch"

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "paged_window_attention": "paged_window_attention.cu",
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "lstm_fwd": "lstm_fwd.cu",
    "lstm_bwd": "lstm_bwd.cu",
    "gru_fwd": "gru_fwd.cu",
    "decode_attention": "decode_attention.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def _target(name: str) -> Path:
    # the shared headers are part of every source's hash: an edited
    # header rebuilds every library
    blob = (CSRC / SOURCES[name]).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        blob += header.read_bytes()
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns ``{name: ptxas report}``
    (registers, shared memory, spills — empty for a reused library).
    Raises :class:`KernelBuildError` naming each failed source."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: readers never see a torn .so
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as e:
                raise KernelBuildError(f"cannot load {name}: {e}") from e
            _libs[name] = lib
        return lib
