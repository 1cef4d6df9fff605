"""Dataset cache helpers — the port of ``paddle_tpu/dataset/common.py``.

Every loader first checks the cache directory for real data and
otherwise falls back to a DETERMINISTIC synthetic generator with the
same shapes and vocabulary; nothing is downloaded. ``DATA_HOME`` reads
the same ``PADDLE_TPU_DATA_HOME`` variable as the JAX package, so both
packages find the same files. ``convert`` and ``record_deserializer``
wait for the port's recordio (ROADMAP.md).
"""

from __future__ import annotations

import os

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


#: optional per-module integrity manifest: DATA_HOME/<module>/MD5SUMS
#: with `md5sum`-format lines ("<hex digest>  <filename>"). When a real
#: file is listed there, has_cached()/verified loaders check it before
#: training on it — a corrupt/truncated drop-in WARNS and falls back to
#: the synthetic generator instead of silently training on garbage.
MANIFEST_NAME = "MD5SUMS"


def cache_path(module: str, filename: str) -> str:
    d = os.path.join(DATA_HOME, module)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, filename)


def _manifest_md5(module: str, filename: str):
    """Expected digest for `filename` from the module's MD5SUMS manifest
    (None when no manifest or no entry)."""
    mpath = os.path.join(DATA_HOME, module, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[-1] in (
                        filename, "*" + filename):
                    return parts[0].lower()
    except OSError:
        return None
    return None


def file_md5(path: str) -> str:
    import hashlib
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def has_cached(module: str, filename: str, md5: str = None) -> bool:
    """True when a REAL data file is present (and intact). Integrity is
    checked against an explicit ``md5`` argument or the module's
    optional MD5SUMS manifest; on mismatch this WARNS and returns False
    so every loader falls back to its deterministic synthetic generator
    instead of training on corrupt data."""
    path = os.path.join(DATA_HOME, module, filename)
    if not os.path.exists(path):
        return False
    expected = (md5 or _manifest_md5(module, filename) or "").lower()
    if not expected:
        return True
    actual = file_md5(path)
    if actual == expected:
        return True
    import warnings
    warnings.warn(
        f"{path}: md5 mismatch (expected {expected}, got {actual}) — "
        "the file is corrupt or truncated; IGNORING it and falling back "
        "to the synthetic generator. Re-download it or fix the "
        f"{MANIFEST_NAME} entry.", stacklevel=2)
    return False
