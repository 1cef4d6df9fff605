"""Numeric gradient check — the port of
``paddle_tpu/trainer/grad_check.py``.

Reference: paddle/gserver/tests/LayerGradUtil.h testLayerGrad:307 —
perturbation-based finite differences against the analytic gradients.
Here: central finite differences against ``torch.autograd`` through the
whole Topology, on a random subset of coordinates per parameter (the
reference also sampled coordinates).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.device import DeviceLike, resolve_device


def check_topology_grads(topology: Topology, feed: Dict, *,
                         eps: float = 1e-3, rtol: float = 2e-2,
                         atol: float = 1e-4, n_coords: int = 6,
                         seed: int = 0, mode: str = "train",
                         device: DeviceLike = None) -> int:
    """Assert numeric ~= analytic gradients of the summed outputs with
    respect to every parameter, on ``n_coords`` sampled coordinates
    each; parameters drawn from ``seed`` on ``device`` (where the feed
    lives). Returns the number of coordinates checked."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = topology.init_params(torch.Generator().manual_seed(seed),
                                  device=dev)
    state = topology.init_state(device=dev)
    out_names = [o.name for o in topology.outputs]

    def loss_fn(p):
        outs, _ = topology.forward(p, state, feed, mode=mode, rng=0)
        total = 0.0
        for n in out_names:
            v = outs[n]
            v = v.data if isinstance(v, SequenceBatch) else v
            total = total + torch.sum(v.float())
        return total

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    names = sorted(leaves)
    grads = torch.autograd.grad(loss_fn(leaves), [leaves[k] for k in names],
                                allow_unused=True)
    analytic = {k: (torch.zeros_like(leaves[k]) if g is None else g)
                .detach().cpu().double().reshape(-1).numpy()
                for k, g in zip(names, grads)}
    checked = 0
    with torch.no_grad():
        for pname in names:
            pval = params[pname]
            flat = pval.detach().cpu().double().reshape(-1).numpy()
            k = min(n_coords, flat.size)
            for c in rng.choice(flat.size, size=k, replace=False):
                fs = []
                for step in (eps, -eps):
                    pp = flat.copy()
                    pp[c] += step
                    moved = torch.from_numpy(pp.reshape(pval.shape)).to(
                        device=dev, dtype=pval.dtype)
                    fs.append(float(loss_fn({**params, pname: moved})))
                num = (fs[0] - fs[1]) / (2 * eps)
                ana = float(analytic[pname][c])
                denom = max(abs(num), abs(ana), 1.0)
                assert abs(num - ana) <= atol + rtol * denom, (
                    f"grad mismatch {pname}[{c}]: numeric={num:.6g} "
                    f"analytic={ana:.6g}")
                checked += 1
    return checked
