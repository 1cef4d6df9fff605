"""Normalization ops — the port of ``batch_norm_train``,
``batch_norm_infer`` and ``lrn_cross_map`` of
``paddle_tpu/ops/norm.py``.

Batch norm mirrors the reference's arithmetic, not ``F.batch_norm``:

- the batch statistics in float32 (float64 for float64 x) as
  E[x^2] - E[x]^2, clamped at 0 (the biased variance), over every axis
  but the last (the channel);
- gamma, beta and the statistics folded into one per-channel scale and
  shift, cast to x's dtype, so a bf16 activation map stays bf16;
- the moving statistics as ``moving * m + batch * (1 - m)`` with the
  biased variance (``F.batch_norm``'s running update uses the unbiased
  one and the opposite momentum convention).

The ops are differentiable throughout, as the JAX functions are; the
trainer stores the new moving statistics detached.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 x (a reference computation)."""
    return torch.promote_types(x.dtype, torch.float32)


def _batch_stats(x: torch.Tensor, axes, mesh=None):
    """The biased batch statistics over ``axes``. With a ``mesh`` whose
    dp axis splits the rows they are the GLOBAL batch's: the ranks' sums
    of x and x^2 all-reduced together (differentiably) over dp — the
    statistics XLA's mean takes over the dp shards of one global
    program. Without one the all-reduce is the identity."""
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import DP_AXIS, axis_size
    xf = x.to(_stats_dtype(x))
    count = axis_size(mesh, DP_AXIS)
    for a in axes:
        count *= x.shape[a]
    sums = comm.all_reduce(torch.stack([torch.sum(xf, dim=axes),
                                        torch.sum(xf * xf, dim=axes)]),
                           mesh, DP_AXIS)
    mean = sums[0] / count
    return mean, torch.clamp(sums[1] / count - mean * mean, min=0.0)


def _affine(x, gamma, beta, mean, inv_std):
    inv = inv_std * gamma
    scale = inv.to(x.dtype)
    shift = (beta - mean * inv).to(x.dtype)
    return x * scale + shift


def batch_norm_train(x: torch.Tensor, gamma, beta, moving_mean, moving_var,
                     *, momentum: float = 0.9, eps: float = 1e-5,
                     axes: Optional[Tuple[int, ...]] = None, mesh=None):
    """Training-mode batch norm over all axes but the last. Returns
    (y, new_moving_mean, new_moving_var). With a ``mesh`` whose dp axis
    splits the batch, the statistics are the global batch's (so the
    moving statistics agree on every rank)."""
    if axes is None:
        axes = tuple(range(x.dim() - 1))
    mean, var = _batch_stats(x, axes, mesh)
    y = _affine(x, gamma, beta, mean, torch.rsqrt(var + eps))
    new_mean = moving_mean * momentum + mean * (1.0 - momentum)
    new_var = moving_var * momentum + var * (1.0 - momentum)
    return y, new_mean, new_var


def batch_norm_infer(x: torch.Tensor, gamma, beta, moving_mean, moving_var,
                     *, eps: float = 1e-5):
    return _affine(x, gamma, beta, moving_mean,
                   torch.rsqrt(moving_var + eps))


def lrn_cross_map(x: torch.Tensor, size: int = 5, scale: float = 1e-4,
                  power: float = 0.75) -> torch.Tensor:
    """Local response norm across channels, x: [N, H, W, C]:
    y = x * (1 + scale/size * sum over the channel window of x^2)^-power,
    the window sum as a banded [C, C] product (one read of x^2). Powers
    0.75 and 0.5 go through rsqrt, as in the JAX package."""
    sq = x * x
    half = size // 2
    c = x.shape[-1]
    ch = torch.arange(c, device=x.device)
    band = ((ch[:, None] >= ch[None, :] - half) &
            (ch[:, None] <= ch[None, :] + size - 1 - half)).to(x.dtype)
    window = torch.matmul(sq, band)
    base = 1.0 + (scale / size) * window
    if power == 0.75:
        r = torch.rsqrt(base)
        return x * (r * torch.sqrt(r))
    if power == 0.5:
        return x * torch.rsqrt(base)
    return x / base ** power
