"""Parameter tables carried across from the JAX package.

The port keeps the JAX package's parameter contract unchanged: a flat
``{name: array}`` table with the DSL's names (``_tfm_l0_q.w0``,
``_tfm_l0_ln1.wbias``, ...), fully-connected weights in ``[in, out]``
layout, and the stored dtype. So a table from ``Topology.init_params``
or a ``paddle_tpu.params.v1`` checkpoint tar drops straight in.
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device

PARAMS_FORMAT = "paddle_tpu.params.v1"


def params_from_numpy(table: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy table -> tensors on ``device``: same names, same layout,
    same dtype (no gradient tracking — the port's decode path is
    inference only). The tensors own copies of the data."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(arr, order="C")).to(dev)
            for name, arr in table.items()}


def load_params_tar(f) -> Dict[str, np.ndarray]:
    """Read a ``paddle_tpu.params.v1`` checkpoint (one ``<name>.npy``
    member per parameter plus ``_meta.json``) with tarfile and numpy
    only — the counterpart of ``Parameters.from_tar``. Non-trainable
    ``_state/`` members are skipped; the decode path has none."""
    out: Dict[str, np.ndarray] = {}
    with tarfile.open(fileobj=f, mode="r") as tf:
        names = tf.getnames()
        if "_meta.json" in names:
            meta = json.loads(tf.extractfile("_meta.json").read())
            if meta.get("format") != PARAMS_FORMAT:
                raise ValueError(
                    f"unknown checkpoint format {meta.get('format')!r}; "
                    f"expected {PARAMS_FORMAT!r}")
        for member in tf.getmembers():
            if not member.name.endswith(".npy") or \
                    member.name.startswith("_state/"):
                continue
            out[member.name[:-4]] = np.load(
                io.BytesIO(tf.extractfile(member).read()),
                allow_pickle=False)
    return out


def init_transformer_lm_params(cfg: Mapping, seed: int = 0,
                               name: str = "tfm",
                               dtype=np.float32) -> Dict[str, np.ndarray]:
    """A ``transformer_lm`` parameter table with the JAX package's names
    and shapes, drawn from a numpy ``RandomState(seed)``: fc weights
    ~ N(0, 1/fan_in), embeddings ~ N(0, 0.01^2), layer-norm gains 1
    and biases 0. The distributions follow the JAX init; the bits do
    not (it draws with ``jax.random``).

    ``cfg`` keys: vocab_size, d_model, n_heads, n_layers, d_ff,
    max_len, and optionally n_kv_heads and tie_embeddings."""
    rng = np.random.RandomState(seed)
    V, d = int(cfg["vocab_size"]), int(cfg["d_model"])
    h, L = int(cfg["n_heads"]), int(cfg["n_layers"])
    ff, T = int(cfg["d_ff"]), int(cfg["max_len"])
    kv_h: Optional[int] = cfg.get("n_kv_heads") or h
    kv_dim = (d // h) * int(kv_h)
    n = f"_{name}"

    def fc(fan_in, fan_out):
        return (rng.standard_normal((fan_in, fan_out))
                / np.sqrt(fan_in)).astype(dtype)

    def ln(width):
        return np.ones((width,), dtype), np.zeros((width,), dtype)

    p: Dict[str, np.ndarray] = {
        f"{n}_tok_emb.w0": (0.01 * rng.standard_normal((V, d))).astype(dtype),
        f"{n}_pos_emb.w0": (0.01 * rng.standard_normal((T, d))).astype(dtype),
    }
    for i in range(L):
        li = f"{n}_l{i}"
        p[f"{li}_ln1.w0"], p[f"{li}_ln1.wbias"] = ln(d)
        p[f"{li}_q.w0"] = fc(d, d)
        p[f"{li}_k.w0"] = fc(d, kv_dim)
        p[f"{li}_v.w0"] = fc(d, kv_dim)
        p[f"{li}_proj.w0"] = fc(d, d)
        p[f"{li}_ln2.w0"], p[f"{li}_ln2.wbias"] = ln(d)
        p[f"{li}_up.w0"] = fc(d, ff)
        p[f"{li}_up.wbias"] = np.zeros((ff,), dtype)
        p[f"{li}_down.w0"] = fc(ff, d)
    p[f"{n}_lnf.w0"], p[f"{n}_lnf.wbias"] = ln(d)
    if not cfg.get("tie_embeddings"):
        p[f"{n}_head.w0"] = fc(d, V)
    return p
