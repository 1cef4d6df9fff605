"""Convolution ops — the port of ``paddle_tpu/ops/conv.py``: ``conv2d``,
``conv2d_transpose``, ``conv3d``, ``conv3d_transpose``, ``im2col``,
``row_conv`` and ``conv_out_size``.

The layouts are the JAX package's: activations are logical NHWC
``[b, h, w, c]`` (NDHWC ``[b, d, h, w, c]`` in 3-D) and weights HWIO
``[kh, kw, Cin/groups, C]`` (DHWIO), so a ``paddle_tpu.params.v1`` tar
carries across unchanged and an fc after a conv flattens in (h, w, c)
order. cuDNN (or the CPU's convolution) runs on permuted views, not
copies: ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is an NCHW tensor
with channels-last strides (``permute(0, 4, 1, 2, 3)`` of an NDHWC one
is channels-last-3d), which cuDNN takes as it is; the result is
permuted back.

Mixed precision as in the JAX package: under ``compute_dtype
"bfloat16"`` x and w are cast to bf16 and the output is bf16 (cuDNN
accumulates in float32); under float32 the convolution runs in full
float32 (TF32 off, ``paddle_tpu_torch/__init__.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.linear import compute_dtype


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _triple(v: Union[int, Sequence[int]]) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]), int(v[2]))
    return (int(v), int(v), int(v))


def _operands(x: torch.Tensor, w: torch.Tensor):
    """x and w in the dtype the product runs in."""
    cd = compute_dtype()
    if cd != torch.float32:
        return x.to(cd), w.to(cd)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """x: [N, H, W, C], w: [kh, kw, C/groups, OC] -> [N, H', W', OC]."""
    x, w = _operands(x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=_pair(stride), padding=_pair(padding),
                 dilation=_pair(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                     padding=0) -> torch.Tensor:
    """The JAX package's transposed conv: ``lax.conv_transpose`` without
    ``transpose_kernel``, i.e. the stride-dilated input padded by
    k - 1 - p and correlated with w (HWIO, I the input's channels) as it
    is. ``F.conv_transpose2d`` is the true adjoint of a convolution,
    which correlates with the spatially flipped kernel, so w goes in
    flipped, as ``[in, out, kh, kw]``."""
    x, w = _operands(x, w)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           w.flip(0, 1).permute(2, 3, 0, 1),
                           stride=_pair(stride), padding=_pair(padding))
    return y.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, w: torch.Tensor, *, stride=1,
           padding=0) -> torch.Tensor:
    """x: [N, D, H, W, C], w: [kd, kh, kw, C, OC] -> [N, D', H', W', OC]."""
    x, w = _operands(x, w)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 stride=_triple(stride), padding=_triple(padding))
    return y.permute(0, 2, 3, 4, 1)


def conv3d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                     padding=0) -> torch.Tensor:
    """The 3-D form of ``conv2d_transpose``: w [kd, kh, kw, IC, OC] (IC
    the input's channels) correlated as it is with the stride-dilated
    input padded by k - 1 - p, so it goes into the true adjoint
    flipped, as ``[in, out, kd, kh, kw]``. Output (i - 1) s - 2p + k."""
    x, w = _operands(x, w)
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3),
                           w.flip(0, 1, 2).permute(3, 4, 0, 1, 2),
                           stride=_triple(stride), padding=_triple(padding))
    return y.permute(0, 2, 3, 4, 1)


def im2col(x: torch.Tensor, kernel, stride=1, padding=0) -> torch.Tensor:
    """Patch extraction (BlockExpandLayer): x [N, H, W, C] ->
    [N, H', W', C*kh*kw], each patch's features channel-major (C, kh,
    kw) and the walk floor-mode, as ``lax.conv_general_dilated_patches``
    gives them."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    n, h, w_, c = x.shape
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w_ + 2 * pw - kw) // sw + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw), padding=(ph, pw),
                    stride=(sh, sw))                   # [N, C*kh*kw, L]
    return cols.transpose(1, 2).reshape(n, oh, ow, c * kh * kw)


def row_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Lookahead row convolution (RowConvLayer): x [b, T, d], w
    [context, d]; y[t] = sum_{i < context} x[t + i] * w[i], the steps
    past T read as zeros. A depthwise correlation over time."""
    context, d = w.shape
    dt = torch.promote_types(x.dtype, w.dtype)
    v = F.pad(x.to(dt).transpose(1, 2), (0, context - 1))   # [b, d, T+c-1]
    y = F.conv1d(v, w.to(dt).t()[:, None, :], groups=d)
    return y.transpose(1, 2)


def conv_out_size(in_size: int, kernel: int, stride: int, padding: int,
                  dilation: int = 1, caffe_mode: bool = True) -> int:
    """Output spatial size: caffe mode floor((i + 2p - k_eff)/s) + 1,
    else the ceil variant."""
    eff_k = dilation * (kernel - 1) + 1
    if caffe_mode:
        return (in_size + 2 * padding - eff_k) // stride + 1
    return (in_size + 2 * padding - eff_k + stride - 1) // stride + 1
