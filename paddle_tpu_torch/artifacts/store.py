"""ArtifactStore — the on-disk, integrity-checked store of built kernel
libraries (the port of ``paddle_tpu/artifacts/store.py``: the same
frame, byte for byte, so each package reads the other's files).

Every failure mode a fleet of cold-starting replicas can hit is
detected and degrades to a rebuild (``nvcc``, or the compile cache)
instead of crashing a rejoining replica.

File format (``<name>.ptaf``), framed so a torn write is DETECTABLE::

    magic     4 bytes   b"PTA1"
    hlen      u32 LE    header length
    header    hlen bytes of JSON:
                {"name", "fingerprint": {...}, "digest", "created",
                 "payload_len", "payload_crc", "meta": {...}}
    payload   payload_len bytes (the built shared library)

A reader accepts a file only when the magic matches, the header parses,
the payload is exactly ``payload_len`` bytes and crc32-clean, and the
header's fingerprint digest re-derives from its fields. Anything else
is CORRUPT; a clean frame whose digest differs from the requested
fingerprint is STALE. Both outcomes journal an ``artifacts/fallback``
record with the reason and return None — the caller rebuilds.

Writes are single-writer safe by construction: each writer writes a
private ``.tmp.<pid>.<n>`` sibling, fsyncs, then ``os.replace``s it
over the final name. N replicas cold-starting at once race only on the
atomic rename — last writer wins with a complete frame, and no reader
ever observes a partial file under the final name
(``FaultPlan.cache_race``). Orphaned tmp files from a SIGKILL mid-write
are ignored by readers and swept opportunistically by the next put().
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import time
import zlib
from typing import Dict, List, Optional

from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.obs.metrics import REGISTRY
from paddle_tpu_torch.utils.logging import get_logger

from paddle_tpu_torch.artifacts.fingerprint import Fingerprint

__all__ = ["ArtifactStore", "MAGIC", "SUFFIX"]

MAGIC = b"PTA1"
SUFFIX = ".ptaf"

_tmp_seq = itertools.count(1)

#: metric families (obs/catalog.py, "artifacts store gauges");
#: registration is idempotent
_HITS = REGISTRY.gauge(
    "paddle_tpu_artifacts_hits",
    "artifact loads served from the store (warm starts)")
_MISSES = REGISTRY.gauge(
    "paddle_tpu_artifacts_misses",
    "artifact lookups that found nothing (cold starts)")
_FALLBACKS = REGISTRY.gauge(
    "paddle_tpu_artifacts_fallbacks",
    "corrupt/stale/unloadable artifacts degraded to JIT")
_BUILD_MS = REGISTRY.gauge(
    "paddle_tpu_artifacts_build_ms",
    "wall ms spent building (compile + serialize) the last artifact")


class ArtifactStore:
    """One directory of framed executable artifacts (module doc)."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------- paths
    def path(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in str(name))
        return os.path.join(self.root, safe + SUFFIX)

    def _files(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        return [os.path.join(self.root, n) for n in names
                if n.endswith(SUFFIX)]

    # ------------------------------------------------------------- write
    def put(self, name: str, fp: Fingerprint, payload: bytes,
            meta: Optional[Dict] = None) -> str:
        """Atomically publish one artifact; returns the final path.
        Concurrent writers are safe (private tmp + os.replace)."""
        final = self.path(name)
        header = {
            "name": str(name),
            "fingerprint": fp.to_dict(),
            "digest": fp.digest,
            "created": time.time(),
            "payload_len": len(payload),
            "payload_crc": zlib.crc32(payload) & 0xFFFFFFFF,
            "meta": dict(meta or {}),
        }
        hbytes = json.dumps(header, sort_keys=True).encode()
        tmp = f"{final}.tmp.{os.getpid()}.{next(_tmp_seq)}"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(hbytes)))
            f.write(hbytes)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._sweep_tmp(final)
        return final

    def _sweep_tmp(self, final: str) -> None:
        """Best-effort removal of orphaned tmp siblings (a writer that
        was SIGKILLed mid-write leaves one; readers never look at
        them)."""
        d, base = os.path.split(final)
        try:
            for n in os.listdir(d):
                if n.startswith(base + ".tmp."):
                    p = os.path.join(d, n)
                    try:
                        # a LIVE concurrent writer's tmp is younger than
                        # a crash orphan; only sweep files old enough
                        # that no in-flight put() still owns them
                        if time.time() - os.path.getmtime(p) > 60.0:
                            os.remove(p)
                    except OSError:
                        pass
        except OSError:
            pass

    # -------------------------------------------------------------- read
    def _read_frame(self, path: str):
        """(header, payload) or raises ValueError naming the defect."""
        with open(path, "rb") as f:
            blob = f.read()
        if len(blob) < 8 or blob[:4] != MAGIC:
            raise ValueError("bad magic (not an artifact, or torn)")
        (hlen,) = struct.unpack("<I", blob[4:8])
        if len(blob) < 8 + hlen:
            raise ValueError("torn header")
        try:
            header = json.loads(blob[8:8 + hlen])
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"unparseable header: {e}") from e
        payload = blob[8 + hlen:]
        want = int(header.get("payload_len", -1))
        if len(payload) != want:
            raise ValueError(
                f"torn payload ({len(payload)} bytes, header "
                f"declares {want})")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        if crc != int(header.get("payload_crc", -1)):
            raise ValueError("payload crc mismatch (corrupt)")
        rederived = Fingerprint(header.get("fingerprint", {})).digest
        if rederived != header.get("digest"):
            raise ValueError("fingerprint digest mismatch (doctored "
                             "or corrupt header)")
        return header, payload

    def get(self, name: str, fp: Fingerprint) -> Optional[bytes]:
        """The payload for ``name`` iff present, intact and matching
        ``fp`` — otherwise None. Never raises: a missing file counts a
        miss; corrupt/stale files journal ``artifacts/fallback`` (the
        degrade witness) and count a fallback."""
        path = self.path(name)
        if not os.path.exists(path):
            _MISSES.inc()
            return None
        try:
            header, payload = self._read_frame(path)
        except (ValueError, OSError) as e:
            self._fallback(name, path, "corrupt", str(e))
            return None
        if header.get("digest") != fp.digest:
            self._fallback(
                name, path, "stale",
                f"artifact built for {header.get('digest')}, "
                f"need {fp.digest}")
            return None
        _HITS.inc()
        return payload

    def _fallback(self, name: str, path: str, reason: str,
                  detail: str) -> None:
        _FALLBACKS.inc()
        journal_emit("artifacts", "fallback", name=str(name),
                     path=path, reason=reason, detail=detail)
        get_logger().warning(
            "artifact %s %s (%s) — degrading to a rebuild", name, reason,
            detail)

    # ------------------------------------------------------------ inspect
    def inspect(self, path: str) -> Dict:
        """One ``ls`` row; ``ok`` False carries the defect in
        ``error``."""
        row = {"path": path, "name": os.path.basename(path),
               "size": 0, "age_s": None, "ok": False}
        try:
            st = os.stat(path)
            row["size"] = int(st.st_size)
            row["age_s"] = round(time.time() - st.st_mtime, 1)
        except OSError as e:
            row["error"] = str(e)
            return row
        try:
            header, _ = self._read_frame(path)
        except (ValueError, OSError) as e:
            row["error"] = str(e)
            return row
        row.update(ok=True, digest=header.get("digest"),
                   kind=header.get("fingerprint", {}).get("kind"),
                   created=header.get("created"),
                   meta=header.get("meta", {}))
        return row

    def entries(self) -> List[Dict]:
        return [self.inspect(p) for p in self._files()]

    def verify(self) -> List[Dict]:
        """Re-read every frame; returns the defective rows (empty =
        clean store). Each defect journals ``artifacts/verify_failed``
        so ``cli.py artifacts verify`` leaves an audit trail."""
        bad = []
        for row in self.entries():
            if not row["ok"]:
                bad.append(row)
                journal_emit("artifacts", "verify_failed",
                             name=row["name"], path=row["path"],
                             detail=row.get("error"))
        return bad

    def record_build_ms(self, ms: float) -> None:
        _BUILD_MS.set(float(ms))
