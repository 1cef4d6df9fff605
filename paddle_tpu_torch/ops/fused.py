"""Fused 1x1 conv + training batch norm — the port of ``conv_bn_train``
of ``paddle_tpu/ops/fused.py``, behind ``conv_bn(fuse_stats=True)``.
Not the default, as in the JAX package, where it measured slower end
to end than the plain composition.

A ``torch.autograd.Function`` where the JAX package has a
``custom_vjp``, with the same residual contract: it saves only
``(x, w, gamma, beta, mean, var)``. The backward recomputes the conv
output with one extra conv (reconstructing y-hat from z would be wrong
at gamma == 0, where a pruned channel's dgamma must stay true), takes
the cotangents of the mean and variance outputs too, and gets dx and
dw from the conv's own autograd.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops.norm import _affine, _batch_stats


def _conv(x, w):
    return conv_ops.conv2d(x, w, stride=1, padding=0)


class ConvBNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps):
        y = _conv(x, w)
        mean, var = _batch_stats(y, tuple(range(y.dim() - 1)))
        z = _affine(y, gamma, beta, mean, torch.rsqrt(var + eps))
        ctx.save_for_backward(x, w, gamma, beta, mean, var)
        ctx.eps = eps
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, dmean_ct, dvar_ct):
        x, w, gamma, beta, mean, var = ctx.saved_tensors
        m = dz.numel() // dz.shape[-1]
        rstd = torch.rsqrt(var + ctx.eps)
        inv = rstd * gamma
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            wg = w.detach().requires_grad_(True)
            y3 = _conv(xg, wg)            # the one extra conv
        yhat = (y3.detach().to(mean.dtype) - mean) * rstd
        dzf = dz.to(mean.dtype)
        axes = tuple(range(dz.dim() - 1))
        dbeta = torch.sum(dzf, dim=axes)
        dgamma = torch.sum(dzf * yhat, dim=axes)
        dy = inv * (dzf - dbeta / m - yhat * dgamma / m)
        # mean = E[y], var = E[y^2] - E[y]^2 clamped at 0 (no gradient
        # through the clamp)
        dvar_live = torch.where(var > 0, dvar_ct, torch.zeros_like(dvar_ct))
        dy = dy + dmean_ct / m + dvar_live * 2.0 * (yhat / rstd) / m
        dx, dw = torch.autograd.grad(y3, (xg, wg), dy.to(dz.dtype))
        return (dx.to(x.dtype), dw.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None)


def conv_bn_train(x, w, gamma, beta, eps: float):
    """1x1 conv (x [b,h,w,Cin], w [1,1,Cin,C]) + training batch norm ->
    (z [b,h,w,C], batch mean, batch var); the numerics of conv2d +
    batch_norm_train."""
    return ConvBNTrain.apply(x, w, gamma, beta, eps)
