"""Pooling ops — the port of ``paddle_tpu/ops/pool.py``: 2-D and 3-D
max and average pooling, ``maxout`` and the spatial pyramid pool.

The caffe window arithmetic is the JAX package's, exactly: the output
size of ``pool_out_size`` (ceil mode, and the clip of a last window
that would start past in + padding, applied only when padding > 0),
reached by an explicit left pad of ``padding`` and an asymmetric right
pad. The padded tensor is then pooled with floor arithmetic, as
``lax.reduce_window`` pools it; torch's own ``ceil_mode`` is not used,
since it clips even at padding 0 and refuses padding above k/2. Max
pads with -inf, average with 0 and divides by the count of real
pixels in each window (``exclude_padding``) or by k. The 3-D pools
walk the same way on NDHWC maps; their average always divides by the
count of real voxels (the JAX op has no switch).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.conv import _pair, _triple


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


def maxout(x: torch.Tensor, groups: int) -> torch.Tensor:
    """MaxOutLayer: [N, H, W, C] -> the max over each run of ``groups``
    adjacent channels -> [N, H, W, C // groups]."""
    n, h, w, c = x.shape
    assert c % groups == 0
    return torch.amax(x.reshape(n, h, w, c // groups, groups), dim=-1)


def spatial_pyramid_pool(x: torch.Tensor, pyramid_height: int,
                         pool_type: str = "max") -> torch.Tensor:
    """SPP: levels of 1x1, 2x2, ... 2^(h-1) x 2^(h-1) bins of [N, H, W,
    C], concatenated -> [N, C * sum(4^l)]. The bins' bounds are the JAX
    op's, clamps included: a level with more bins than pixels repeats
    pixels, so the size is always C * sum(4^l)."""
    n, h, w, c = x.shape
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        hb = [h * i / bins for i in range(bins + 1)]
        wb = [w * i / bins for i in range(bins + 1)]
        for bi in range(bins):
            h0, h1 = int(math.floor(hb[bi])), int(math.ceil(hb[bi + 1]))
            h1 = max(h1, h0 + 1)
            h0 = min(h0, h - 1)
            for bj in range(bins):
                w0, w1 = int(math.floor(wb[bj])), int(math.ceil(wb[bj + 1]))
                w1 = max(w1, w0 + 1)
                w0 = min(w0, w - 1)
                region = x[:, h0:h1, w0:w1, :]
                if pool_type == "max":
                    outs.append(torch.amax(region, dim=(1, 2)))
                else:
                    outs.append(torch.mean(region, dim=(1, 2)))
    return torch.cat(outs, dim=-1)


def _padded3d(x: torch.Tensor, kernel, stride, padding, value):
    """x [N, D, H, W, C] -> its NCDHW view padded for a floor-mode walk,
    and the kernel, stride and pads of the walk."""
    k = _triple(kernel)
    s = _triple(stride if stride is not None else kernel)
    p = _triple(padding)
    lr = [_ceil_pads(x.shape[1 + i], k[i], s[i], p[i])[1] for i in range(3)]
    pads = (lr[2][0], lr[2][1], lr[1][0], lr[1][1], lr[0][0], lr[0][1])
    v = x.permute(0, 4, 1, 2, 3)
    if any(pads):
        v = F.pad(v, pads, value=value)
    return v, k, s, pads


def max_pool3d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """x: [N, D, H, W, C] (Pool3DLayer), the 2-D caffe arithmetic."""
    v, k, s, _ = _padded3d(x, kernel, stride, padding, float("-inf"))
    return F.max_pool3d(v, k, s).permute(0, 2, 3, 4, 1)


def avg_pool3d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """The window sums in float32 (the CPU has no bf16 3-D average
    pool), emitted in x's dtype."""
    v, k, s, pads = _padded3d(x, kernel, stride, padding, 0.0)
    sums = F.avg_pool3d(v.float(), k, s, divisor_override=1)
    if any(pads):
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[1:4]),
                                device=x.device), pads)
        counts = F.avg_pool3d(ones, k, s, divisor_override=1)
        out = sums / torch.clamp(counts, min=1.0)
    else:
        out = sums / float(k[0] * k[1] * k[2])
    return out.to(x.dtype).permute(0, 2, 3, 4, 1)
