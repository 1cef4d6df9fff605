"""Parameters — the named parameter store with checkpoint I/O; the port
of ``paddle_tpu/trainer/parameters.py``.

The tar layout is the JAX package's ``paddle_tpu.params.v1``: one
``<name>.npy`` member per parameter, ``_state/<name>.npy`` for
non-trainable state, and ``_meta.json``. A tar written by either
package loads in the other.
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.params import PARAMS_FORMAT


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Parameters:
    """Dict-like named parameters (+ optional non-trainable state), as
    torch tensors on one device."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 specs=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params: Dict[str, torch.Tensor] = {
            k: v.to(self.device) for k, v in (params or {}).items()}
        self.state: Dict[str, torch.Tensor] = {
            k: v.to(self.device) for k, v in (state or {}).items()}
        self.specs = specs or {}

    # --- mapping interface ------------------------------------------------
    def keys(self):
        return self._params.keys()

    def names(self):
        return list(self._params.keys())

    def has_key(self, key):
        return key in self._params

    def __contains__(self, key):
        return key in self._params

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key) -> np.ndarray:
        return _to_numpy(self._params[key])

    def __setitem__(self, key, value):
        if key in self.specs:
            exp = tuple(self.specs[key].shape)
            if tuple(np.shape(value)) != exp:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{np.shape(value)} vs {exp}")
        t = torch.as_tensor(np.asarray(value)).to(self.device)
        old = self._params.get(key)
        if old is not None:
            # a parameter a trainer holds stays its dtype and an
            # autograd leaf: setting it mid-training (the v2 API's
            # parameters.set) goes on training from the new value
            t = t.to(old.dtype).requires_grad_(old.requires_grad)
        self._params[key] = t

    def get(self, key) -> np.ndarray:
        return self[key]

    def set(self, key, value):
        self[key] = value

    def get_shape(self, key):
        return tuple(self._params[key].shape)

    # --- device-side access ----------------------------------------------
    @property
    def raw(self) -> Dict[str, torch.Tensor]:
        """The live, device-resident parameter tensors."""
        return self._params

    def replace(self, new_params: Dict[str, torch.Tensor]):
        self._params = new_params

    # --- checkpoints ------------------------------------------------------
    def to_tar(self, f):
        """Write a ``paddle_tpu.params.v1`` tar checkpoint."""
        tf = tarfile.open(fileobj=f, mode="w")
        meta = {"format": PARAMS_FORMAT, "params": {},
                "state": sorted(self.state)}
        for name, val in sorted(self._params.items()):
            arr = _to_numpy(val)
            meta["params"][name] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
            self._add_npy(tf, f"{name}.npy", arr)
        for name, val in sorted(self.state.items()):
            self._add_npy(tf, f"_state/{name}.npy", _to_numpy(val))
        blob = json.dumps(meta).encode()
        info = tarfile.TarInfo("_meta.json")
        info.size = len(blob)
        tf.addfile(info, io.BytesIO(blob))
        tf.close()

    @staticmethod
    def _add_npy(tf, name, arr):
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        data = buf.getvalue()
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    @classmethod
    def from_tar(cls, f, device: DeviceLike = None) -> "Parameters":
        tf = tarfile.open(fileobj=f, mode="r")
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {}
        for member in tf.getmembers():
            if not member.name.endswith(".npy"):
                continue
            arr = np.load(io.BytesIO(tf.extractfile(member).read()),
                          allow_pickle=False)
            if member.name.startswith("_state/"):
                state[member.name[len("_state/"):-4]] = torch.from_numpy(arr)
            else:
                params[member.name[:-4]] = torch.from_numpy(arr)
        tf.close()
        return cls(params, state, device=device)

    def init_from_tar(self, f):
        """Load the values of matching names in place (v2's
        ``init_from_tar``): each parameter keeps its device, dtype and
        autograd-leaf state (``__setitem__``), each state entry its
        device and dtype."""
        other = Parameters.from_tar(f, device="cpu")
        for name in other.names():
            if name in self._params:
                self[name] = other[name]
        for name, val in other.state.items():
            if name in self.state:
                old = self.state[name]
                self.state[name] = val.to(device=old.device,
                                          dtype=old.dtype)


def create(topology, generator: Optional[torch.Generator] = None,
           device: DeviceLike = None) -> Parameters:
    """paddle.v2.parameters.create(topology): fresh parameters on
    ``device`` (the CUDA card unless the CPU is asked for), drawn from
    ``generator`` (one seeded with the global seed when None)."""
    dev = resolve_device(device)
    return Parameters(topology.init_params(generator, device=dev),
                      topology.init_state(device=dev), topology.param_specs,
                      device=dev)
