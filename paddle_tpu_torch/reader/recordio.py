"""PTRecordIO — chunked record files; the port of
``paddle_tpu/reader/recordio.py``.

- the native codec is ``paddle_tpu_torch/native/recordio.cc`` (C ABI),
  built with the system C++ compiler into ``build/paddle_tpu_torch/``
  at first use and loaded with ctypes;
- this module holds a byte-identical pure-Python twin and the
  user-facing API:

      write_records(path, records_iter)
      num_chunks(path) / read_chunk(path, k) -> [bytes]
      chunk_reader(deserialize)  -> a (path, k) descriptor reader
      chunk_descriptors(path)    -> [(path, k)]

Layout (little-endian u32): chunk := magic "PTRC" | num_records |
payload_len | crc32(payload) | payload; payload := (len | bytes)*. The
JAX package writes the same bytes: a shard written by either package
reads in the other.

``use_native``: None takes the native codec when it builds and loads
and the Python twin otherwise (as the JAX package does); True raises
when the build or the load fails — it never falls back; False is the
Python twin.

Robustness: writes land in ``path + ".tmp"`` and are renamed into
place; a torn tail (bad magic, or a chunk running past EOF) ends the
index with a warning; ``skip_corrupt=True`` drops a crc-mismatched
chunk (counted in ``corrupt_chunks_skipped()``) instead of raising.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Iterable, List, Optional

from paddle_tpu_torch.utils.logging import get_logger

_MAGIC = 0x50545243
_HDR = struct.Struct("<IIII")

PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE_SRC = PKG_DIR / "native" / "recordio.cc"
BUILD_DIR = PKG_DIR.parent / "build" / "paddle_tpu_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

#: chunks dropped by skip_corrupt across this process (all shards)
_CORRUPT_SKIPPED = [0]


def corrupt_chunks_skipped() -> int:
    """How many crc-mismatched chunks skip_corrupt dropped (process-wide
    counter)."""
    return _CORRUPT_SKIPPED[0]

# --------------------------------------------------------------- native


class NativeCodecError(RuntimeError):
    """The native codec did not build or load (``use_native=True``)."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _build() -> Path:
    """Compile the codec (once per source and flags) and return the
    library's path; raises NativeCodecError."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("cc")
    if cxx is None:
        raise NativeCodecError("no C++ compiler (g++, c++, cc) on PATH")
    digest = hashlib.sha256(NATIVE_SRC.read_bytes() +
                            " ".join(CXX_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libptrecordio-{digest[:12]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           str(NATIVE_SRC)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeCodecError(f"{cxx} failed on {NATIVE_SRC} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)        # atomic: a reader never loads a torn .so
    return so


def _native(strict: bool = False) -> Optional[ctypes.CDLL]:
    """The loaded native codec, built at first use. None when it cannot
    be built or loaded — or, with ``strict``, NativeCodecError."""
    global _lib, _lib_error
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
            except (NativeCodecError, OSError,
                    subprocess.SubprocessError) as e:
                _lib_error = f"{type(e).__name__}: {e}"
            else:
                _bind(lib)
                _lib = lib
    if _lib is None and strict:
        raise NativeCodecError(
            f"the native recordio codec is unavailable: {_lib_error}")
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.pt_writer_open.restype = ctypes.c_void_p
    lib.pt_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.pt_writer_write.restype = ctypes.c_int
    lib.pt_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint32]
    lib.pt_writer_close.restype = ctypes.c_int
    lib.pt_writer_close.argtypes = [ctypes.c_void_p]
    lib.pt_reader_open.restype = ctypes.c_void_p
    lib.pt_reader_open.argtypes = [ctypes.c_char_p]
    lib.pt_reader_num_chunks.restype = ctypes.c_uint32
    lib.pt_reader_num_chunks.argtypes = [ctypes.c_void_p]
    lib.pt_reader_seek_chunk.restype = ctypes.c_int
    lib.pt_reader_seek_chunk.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.pt_reader_next.restype = ctypes.c_int64
    lib.pt_reader_next.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.POINTER(
                                       ctypes.c_uint8))]
    lib.pt_reader_close.restype = None
    lib.pt_reader_close.argtypes = [ctypes.c_void_p]


def _codec(use_native: Optional[bool]) -> Optional[ctypes.CDLL]:
    if use_native is False:
        return None
    return _native(strict=use_native is True)


# --------------------------------------------------------------- writing


def write_records(path: str, records: Iterable[bytes],
                  max_chunk_bytes: int = 1 << 20,
                  use_native: Optional[bool] = None) -> None:
    """Write an iterable of byte records as a PTRecordIO file.
    Atomic: bytes land in ``path + ".tmp"`` and are renamed into place
    only after a successful flush/close — a crash mid-write leaves the
    previous shard (or nothing) at ``path``, never a torn file."""
    lib = _codec(use_native)
    tmp = path + ".tmp"
    try:
        if lib is not None:
            w = lib.pt_writer_open(tmp.encode(), max_chunk_bytes)
            if not w:
                raise OSError(f"cannot open {tmp!r} for writing")
            try:
                for rec in records:
                    if lib.pt_writer_write(w, rec, len(rec)) != 0:
                        raise OSError("recordio write failed")
            finally:
                if lib.pt_writer_close(w) != 0:
                    raise OSError("recordio flush/close failed")
        else:
            with open(tmp, "wb") as f:
                payload = bytearray()
                n = 0

                def flush():
                    nonlocal payload, n
                    if not n:
                        return
                    f.write(_HDR.pack(
                        _MAGIC, n, len(payload),
                        zlib.crc32(bytes(payload)) & 0xFFFFFFFF))
                    f.write(payload)
                    payload = bytearray()
                    n = 0

                for rec in records:
                    payload += struct.pack("<I", len(rec)) + rec
                    n += 1
                    if len(payload) >= max_chunk_bytes:
                        flush()
                flush()
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


# --------------------------------------------------------------- reading


#: path -> ((mtime_ns, size), index): shards are immutable once
#: written, so the chunk index is cached per file identity
_INDEX_CACHE: dict = {}


def _py_index(path: str) -> List[tuple]:
    st = os.stat(path)
    ident = (st.st_mtime_ns, st.st_size)
    hit = _INDEX_CACHE.get(path)
    if hit is not None and hit[0] == ident:
        return hit[1]
    chunks = []
    with open(path, "rb") as f:
        while True:
            off = f.tell()
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            magic, n, plen, crc = _HDR.unpack(hdr)
            if magic != _MAGIC:
                get_logger().warning(
                    "%s: bad chunk magic at byte %d — treating as "
                    "end-of-file (torn shard tail?); %d intact chunks "
                    "indexed", path, off, len(chunks))
                break
            if off + _HDR.size + plen > st.st_size:
                get_logger().warning(
                    "%s: chunk at byte %d declares %d payload bytes but "
                    "the file ends at %d — dropping the torn tail chunk "
                    "(%d intact chunks indexed)", path, off, plen,
                    st.st_size, len(chunks))
                break
            chunks.append((off, n, plen, crc))
            f.seek(plen, 1)
    if len(_INDEX_CACHE) > 256:
        _INDEX_CACHE.clear()
    _INDEX_CACHE[path] = (ident, chunks)
    return chunks


def num_chunks(path: str, use_native: Optional[bool] = None) -> int:
    lib = _codec(use_native)
    if lib is not None:
        r = lib.pt_reader_open(path.encode())
        if not r:
            raise OSError(f"cannot open {path!r}")
        try:
            return int(lib.pt_reader_num_chunks(r))
        finally:
            lib.pt_reader_close(r)
    return len(_py_index(path))


def _skip_corrupt_chunk(path: str, k: int) -> List[bytes]:
    _CORRUPT_SKIPPED[0] += 1
    get_logger().warning(
        "%s: chunk %d crc mismatch — skipping its records "
        "(skip_corrupt; %d corrupt chunks skipped so far)",
        path, k, _CORRUPT_SKIPPED[0])
    return []


def read_chunk(path: str, k: int,
               use_native: Optional[bool] = None,
               skip_corrupt: bool = False) -> List[bytes]:
    """All records of chunk k (crc-validated). A crc mismatch raises
    ValueError — or, with ``skip_corrupt=True``, logs, bumps
    ``corrupt_chunks_skipped()`` and returns []."""
    lib = _codec(use_native)
    if lib is not None:
        r = lib.pt_reader_open(path.encode())
        if not r:
            raise OSError(f"cannot open {path!r}")
        try:
            rc = lib.pt_reader_seek_chunk(r, k)
            if rc == -2:
                if skip_corrupt:
                    return _skip_corrupt_chunk(path, k)
                raise ValueError(f"{path}: chunk {k} crc mismatch")
            if rc != 0:
                raise IndexError(f"{path}: no chunk {k}")
            out = []
            ptr = ctypes.POINTER(ctypes.c_uint8)()
            while True:
                ln = lib.pt_reader_next(r, ctypes.byref(ptr))
                if ln < 0:
                    break
                out.append(ctypes.string_at(ptr, ln))
            return out
        finally:
            lib.pt_reader_close(r)
    chunks = _py_index(path)
    if k >= len(chunks):
        raise IndexError(f"{path}: no chunk {k}")
    off, n, plen, crc = chunks[k]
    with open(path, "rb") as f:
        f.seek(off + _HDR.size)
        payload = f.read(plen)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        if skip_corrupt:
            return _skip_corrupt_chunk(path, k)
        raise ValueError(f"{path}: chunk {k} crc mismatch")
    out = []
    cur = 0
    while cur + 4 <= plen:
        (ln,) = struct.unpack_from("<I", payload, cur)
        out.append(bytes(payload[cur + 4:cur + 4 + ln]))
        cur += 4 + ln
    return out


def chunk_descriptors(path: str) -> List[tuple]:
    """[(path, k)] for every chunk of the shard."""
    return [(path, k) for k in range(num_chunks(path))]


def chunk_reader(deserialize=None, skip_corrupt: bool = False):
    """A reader of (path, k) descriptors: yields the (deserialized)
    records of that chunk. With ``skip_corrupt=True`` a crc-mismatched
    chunk is logged, counted and yields nothing."""
    def read(desc):
        path, k = desc
        for rec in read_chunk(path, k, skip_corrupt=skip_corrupt):
            yield deserialize(rec) if deserialize else rec
    return read
