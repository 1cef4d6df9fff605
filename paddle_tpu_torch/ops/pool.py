"""Pooling ops — the port of the 2-D pooling of
``paddle_tpu/ops/pool.py`` (``maxout``, SPP and 3-D pooling wait for
the slice of the layer families).

The caffe window arithmetic is the JAX package's, exactly: the output
size of ``pool_out_size`` (ceil mode, and the clip of a last window
that would start past in + padding, applied only when padding > 0),
reached by an explicit left pad of ``padding`` and an asymmetric right
pad. The padded tensor is then pooled with floor arithmetic, as
``lax.reduce_window`` pools it; torch's own ``ceil_mode`` is not used,
since it clips even at padding 0 and refuses padding above k/2. Max
pads with -inf, average with 0 and divides by the count of real
pixels in each window (``exclude_padding``) or by k.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.conv import _pair


def pool_out_size(in_size: int, kernel: int, stride: int, padding: int,
                  ceil_mode: bool = True) -> int:
    """Caffe ceil mode (or floor) with the clip: the last window must
    start inside in + padding."""
    if ceil_mode:
        out = int(math.ceil((in_size - kernel + 2 * padding) / stride)) + 1
    else:
        out = (in_size - kernel + 2 * padding) // stride + 1
    if padding > 0 and (out - 1) * stride >= in_size + padding:
        out -= 1
    return out


def _ceil_pads(in_size: int, kernel: int, stride: int, padding: int,
               ceil_mode: bool = True):
    """(out, (left_pad, right_pad)): the asymmetric right pad that makes
    a floor-mode window walk produce exactly ``out`` windows."""
    out = pool_out_size(in_size, kernel, stride, padding, ceil_mode)
    right = (out - 1) * stride + kernel - in_size - padding
    return out, (padding, max(right, 0))


def _padded(x: torch.Tensor, kernel, stride, padding, ceil_mode, value):
    """x [N, H, W, C] -> its NCHW view padded for a floor-mode walk, and
    the (kh, kw), (sh, sw) of the walk."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride if stride is not None else kernel)
    ph, pw = _pair(padding)
    _, (top, bottom) = _ceil_pads(x.shape[1], kh, sh, ph, ceil_mode)
    _, (left, right) = _ceil_pads(x.shape[2], kw, sw, pw, ceil_mode)
    v = x.permute(0, 3, 1, 2)
    pads = (left, right, top, bottom)
    if any(pads):
        v = F.pad(v, pads, value=value)
    return v, (kh, kw), (sh, sw), pads


def max_pool2d(x: torch.Tensor, kernel, stride=None, padding=0,
               ceil_mode: bool = True) -> torch.Tensor:
    """x: [N, H, W, C] -> [N, H', W', C], caffe window arithmetic."""
    v, k, s, _ = _padded(x, kernel, stride, padding, ceil_mode,
                         float("-inf"))
    return F.max_pool2d(v, k, s).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, kernel, stride=None, padding=0,
               exclude_padding: bool = True,
               ceil_mode: bool = True) -> torch.Tensor:
    v, k, s, pads = _padded(x, kernel, stride, padding, ceil_mode, 0.0)
    sums = F.avg_pool2d(v, k, s, divisor_override=1)
    if exclude_padding and any(pads):
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[1:3]),
                                dtype=x.dtype, device=x.device), pads)
        counts = F.avg_pool2d(ones, k, s, divisor_override=1)
        out = sums / torch.clamp(counts, min=1.0)
    else:
        out = sums / float(k[0] * k[1])
    return out.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))
