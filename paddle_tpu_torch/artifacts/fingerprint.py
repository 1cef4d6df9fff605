"""Artifact fingerprints — the identity a built kernel library is
reusable under (the port of ``paddle_tpu/artifacts/fingerprint.py``).

The port's executables are its hand-written kernel libraries: one
``nvcc`` build of one ``csrc/`` source for ``sm_90a``. A library is only
valid for the exact (source, flags, toolchain world) it was built for,
so the artifact plane keys everything on a digest over the axes that
change it:

- the KIND: which library this is (``paged_window_attention``, ...);
- the MODEL digest: for a kernel library, the digest of its source,
  the shared headers and the flags (``ops/_build._source_digest``);
  :func:`model_digest` keeps the JAX package's meaning too — sorted
  (name, shape, dtype) triples of a parameter table, dtypes under
  numpy's names, so one weight tar digests equal in both packages;
- the PLAN: the build's knobs (``{"arch": "sm_90a", "flags": [...]}``);
- the ENVIRONMENT (:func:`device_signature`): the torch and CUDA
  versions and the card's name, capability and count — a library built
  in another world must MISS instead of load.

The digest is sha256 over the canonical-JSON field dict, truncated to
16 hex chars, byte for byte the JAX package's: the same fields digest
equal in both packages.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional

__all__ = ["Fingerprint", "model_digest", "device_signature",
           "fingerprint"]


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class Fingerprint:
    """Immutable field dict + its digest. ``fields`` is JSON-safe by
    construction so the store can frame it verbatim and ``verify`` can
    re-derive the digest from what is on disk."""

    __slots__ = ("fields", "digest")

    def __init__(self, fields: Dict):
        self.fields = fields
        self.digest = hashlib.sha256(
            _canonical(fields).encode()).hexdigest()[:16]

    def __eq__(self, other) -> bool:
        return isinstance(other, Fingerprint) and \
            self.digest == other.digest

    def __hash__(self) -> int:
        return hash(self.digest)

    def __repr__(self) -> str:
        return f"Fingerprint({self.fields.get('kind')!r}, {self.digest})"

    def to_dict(self) -> Dict:
        return dict(self.fields)

    @classmethod
    def from_dict(cls, fields: Dict) -> "Fingerprint":
        return cls(fields)


def _dtype_name(v) -> str:
    """numpy's name for a tensor's or an array's dtype (``float32``,
    ``bfloat16``), never ``torch.float32``."""
    import numpy as np
    dt = getattr(v, "dtype", None)
    if dt is None:
        return str(np.asarray(v).dtype)
    text = str(dt)
    return text[len("torch."):] if text.startswith("torch.") else text


def model_digest(params: Dict) -> str:
    """Digest over the parameter TABLE SHAPE — sorted (name, shape,
    dtype) triples, never values. Takes torch tensors or numpy arrays;
    the dtype is written under numpy's name, so a table loaded in
    either package digests equal."""
    rows = []
    for name in sorted(params):
        v = params[name]
        shape = tuple(int(s) for s in getattr(v, "shape", ()))
        rows.append((name, shape, _dtype_name(v)))
    return hashlib.sha256(_canonical(rows).encode()).hexdigest()[:16]


def device_signature() -> Dict:
    """The environment axis: anything that invalidates a built kernel
    library when it changes. Reads torch only — never runs ``nvcc``: a
    warm replica may have no toolkit."""
    import torch
    sig = {"backend": "cpu", "device_kind": "cpu", "capability": None,
           "num_devices": 0, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        sig.update(backend="cuda",
                   device_kind=torch.cuda.get_device_name(0),
                   capability=f"{major}.{minor}",
                   num_devices=torch.cuda.device_count())
    return sig


def fingerprint(kind: str, model,
                plan: Optional[Dict] = None) -> Fingerprint:
    """The full fingerprint of one artifact: ``kind`` names it (a
    kernel library), ``model`` is a digest string — or a parameter
    dict, digested here by :func:`model_digest` — and ``plan`` carries
    every build knob (JSON scalars and lists only)."""
    return Fingerprint({
        "v": 1,
        "kind": str(kind),
        "model": model if isinstance(model, str) else
        model_digest(model),
        "plan": dict(plan or {}),
        "env": device_signature(),
    })
