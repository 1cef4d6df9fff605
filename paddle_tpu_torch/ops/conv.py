"""Convolution ops — the port of ``conv2d``, ``conv2d_transpose`` and
``conv_out_size`` of ``paddle_tpu/ops/conv.py`` (``conv3d``, ``im2col``
and ``row_conv`` wait for the slice of the layer families).

The layouts are the JAX package's: activations are logical NHWC
``[b, h, w, c]`` and weights HWIO ``[kh, kw, Cin/groups, C]``, so a
``paddle_tpu.params.v1`` tar carries across unchanged and an fc after
a conv flattens in (h, w, c) order. cuDNN (or the CPU's convolution)
runs on permuted views, not copies: ``x.permute(0, 3, 1, 2)`` of an
NHWC tensor is an NCHW tensor with channels-last strides, which cuDNN
takes as it is; the result is permuted back.

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


def conv_out_size(in_size: int, kernel: int, stride: int, padding: int,
                  dilation: int = 1, caffe_mode: bool = True) -> int:
    """Output spatial size: caffe mode floor((i + 2p - k_eff)/s) + 1,
    else the ceil variant."""
    eff_k = dilation * (kernel - 1) + 1
    if caffe_mode:
        return (in_size + 2 * padding - eff_k) // stride + 1
    return (in_size + 2 * padding - eff_k + stride - 1) // stride + 1
