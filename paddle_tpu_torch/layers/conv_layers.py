"""Image layers — the port of ``paddle_tpu/layers/conv_layers.py``:
``conv``, ``conv_bn``, ``pool``, ``img_cmrnorm``, ``maxout``, ``spp``,
``pad``, ``crop``, ``bilinear_interp``, ``block_expand`` and the 3-D
``conv3d``, ``deconv3d`` and ``pool3d``.

Image values are logical NHWC ``[b, h, w, c]`` (NDHWC in 3-D), as in
the JAX package; a flat channel-major feed ``[b, c*h*w]`` (the paddle
image convention) becomes NHWC on entry. ``build`` is the JAX
package's, so topologies serialize identically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            StateSpec, register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import activations as act_ops
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import fused as fused_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops import pool as pool_ops
from paddle_tpu_torch.ops.conv import _triple


def ensure_nhwc(x: torch.Tensor, meta_c: int, meta_h: int,
                meta_w: int) -> torch.Tensor:
    """Accept [b, c*h*w] flat channel-major or already-NHWC [b,h,w,c]. A
    flat feed is transposed once here, into NHWC memory, so every conv
    after it runs on channels-last strides."""
    if x.dim() == 4:
        return x
    b = x.shape[0]
    return x.reshape(b, meta_c, meta_h, meta_w).permute(0, 2, 3, 1) \
        .contiguous()


def _conv_geometry(name, cfg, m, kind):
    """(ic, ih, iw, oh, ow) of a conv layer's input and output."""
    ic = cfg.get("channels") or m.channels
    assert ic, f"{kind} layer {name}: input channel count unknown"
    ih = m.height or cfg.get("input_height", 0)
    iw = m.width or cfg.get("input_width", 0)
    k = cfg["filter_size"]
    s = cfg.get("stride", 1)
    p = cfg.get("padding", 0)
    d = cfg.get("dilation", 1)
    cm = cfg.get("caffe_mode", True)
    return (ic, ih, iw, conv_ops.conv_out_size(ih, k, s, p, d, cm),
            conv_ops.conv_out_size(iw, k, s, p, d, cm))


@register_layer("conv")
class ConvLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        ic, ih, iw, oh, ow = _conv_geometry(name, cfg, input_metas[0],
                                            "conv")
        oc = cfg["num_filters"]
        k = cfg["filter_size"]
        g = cfg.get("groups", 1)
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        init = a.initializer or initializers.msra((0, 1, 2))
        specs = [ParamSpec(wname, (k, k, ic // g, oc), init, a)]
        cfg["_w_name"] = wname
        if cfg.get("bias_attr") is not False:
            battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                                 else cfg.get("bias_attr"))
            bname = battr.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (oc,), initializers.zeros, battr))
            cfg["_bias_name"] = bname
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = ic, ih, iw
        return (LayerMeta(size=oc * oh * ow, height=oh, width=ow,
                          channels=oc), specs, [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        w = params[cfg["_w_name"]]
        if cfg.get("trans"):
            y = conv_ops.conv2d_transpose(x, w, stride=cfg.get("stride", 1),
                                          padding=cfg.get("padding", 0))
        else:
            y = conv_ops.conv2d(x, w, stride=cfg.get("stride", 1),
                                padding=cfg.get("padding", 0),
                                dilation=cfg.get("dilation", 1),
                                groups=cfg.get("groups", 1))
        if cfg.get("_bias_name"):
            # the f32 master bias must not promote a bf16 activation map
            y = y + params[cfg["_bias_name"]].to(y.dtype)
        return act_ops.get(cfg.get("act", "linear"))(y)


@register_layer("conv_bn")
class ConvBNLayer:
    """Conv + batch norm in one node, the same arithmetic as
    ``img_conv(bias_attr=False)`` then ``batch_norm``. With
    ``fuse_stats`` a 1x1/s1/p0 conv trains through
    ``ops/fused.conv_bn_train``; every other case runs conv2d then
    batch_norm_train inside the layer."""

    @staticmethod
    def build(name, cfg, input_metas):
        ic, ih, iw, oh, ow = _conv_geometry(name, cfg, input_metas[0],
                                            "conv_bn")
        oc = cfg["num_filters"]
        k = cfg["filter_size"]
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        init = a.initializer or initializers.msra((0, 1, 2))
        specs = [ParamSpec(wname, (k, k, ic, oc), init, a),
                 ParamSpec(f"_{name}.wgamma", (oc,), initializers.ones,
                           ParamAttr.of(None)),
                 ParamSpec(f"_{name}.wbeta", (oc,), initializers.zeros,
                           ParamAttr.of(None))]
        cfg["_w_name"] = wname
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = ic, ih, iw
        states = [StateSpec(f"_{name}.moving_mean", (oc,), 0.0),
                  StateSpec(f"_{name}.moving_var", (oc,), 1.0)]
        return (LayerMeta(size=oc * oh * ow, height=oh, width=ow,
                          channels=oc), specs, states)

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        w = params[cfg["_w_name"]]
        gamma = params[f"_{name}.wgamma"]
        beta = params[f"_{name}.wbeta"]
        mm = ctx.get_state(f"_{name}.moving_mean")
        mv = ctx.get_state(f"_{name}.moving_var")
        k = cfg["filter_size"]
        s = cfg.get("stride", 1)
        p = cfg.get("padding", 0)
        d = cfg.get("dilation", 1)
        eps = cfg.get("epsilon", 1e-5)
        train = ctx.is_train and not cfg.get("use_global_stats")
        mom = cfg.get("moving_average_fraction", 0.9)
        # batch statistics over a dp mesh reduce across ranks: the
        # unfused path carries that reduction
        fusable = (cfg.get("fuse_stats") and k == 1 and s == 1
                   and p == 0 and d == 1 and not _dp_live(ctx))
        if train and fusable:
            y, mean, var = fused_ops.conv_bn_train(x, w, gamma, beta, eps)
            ctx.set_state(f"_{name}.moving_mean",
                          mm * mom + mean * (1.0 - mom))
            ctx.set_state(f"_{name}.moving_var",
                          mv * mom + var * (1.0 - mom))
        else:
            c = conv_ops.conv2d(x, w, stride=s, padding=p, dilation=d)
            if train:
                y, nm, nv = norm_ops.batch_norm_train(
                    c, gamma, beta, mm, mv, momentum=mom, eps=eps,
                    mesh=ctx.mesh)
                ctx.set_state(f"_{name}.moving_mean", nm)
                ctx.set_state(f"_{name}.moving_var", nv)
            else:
                y = norm_ops.batch_norm_infer(c, gamma, beta, mm, mv,
                                              eps=eps)
        return act_ops.get(cfg.get("act", "linear"))(y)


def _dp_live(ctx) -> bool:
    from paddle_tpu_torch.parallel.mesh import DP_AXIS, live
    return live(ctx.mesh, DP_AXIS)


@register_layer("pool")
class PoolLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        c = cfg.get("channels") or m.channels
        ih, iw = m.height, m.width
        ky = cfg["pool_size"]
        kx = cfg.get("pool_size_x") or ky
        s = cfg.get("stride", 1)
        p = cfg.get("padding", 0)
        cm = cfg.get("ceil_mode", True)
        oh = pool_ops.pool_out_size(ih, ky, s, p, cm)
        ow = pool_ops.pool_out_size(iw, kx, s, p, cm)
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = c, ih, iw
        return (LayerMeta(size=c * oh * ow, height=oh, width=ow, channels=c),
                [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        ky = cfg["pool_size"]
        kx = cfg.get("pool_size_x") or ky
        s = cfg.get("stride", 1)
        p = cfg.get("padding", 0)
        cm = cfg.get("ceil_mode", True)
        if cfg.get("pool_type", "max") in ("max", "cudnn-max"):
            return pool_ops.max_pool2d(x, (ky, kx), s, p, ceil_mode=cm)
        return pool_ops.avg_pool2d(x, (ky, kx), s, p, ceil_mode=cm)


@register_layer("img_cmrnorm")
class CMRNormLayer:
    """Cross-map response norm (LRN)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        return (LayerMeta(size=m.size, height=m.height, width=m.width,
                          channels=m.channels), [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        return norm_ops.lrn_cross_map(x, cfg.get("size", 5),
                                      cfg.get("scale", 0.0128),
                                      cfg.get("power", 0.75))


@register_layer("maxout")
class MaxOutLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        oc = m.channels // cfg["groups"]
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        return (LayerMeta(size=oc * m.height * m.width, height=m.height,
                          width=m.width, channels=oc), [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        return pool_ops.maxout(x, cfg["groups"])


@register_layer("spp")
class SPPLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        total_bins = sum(4 ** lvl for lvl in range(cfg.get("pyramid_height",
                                                           3)))
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        return LayerMeta(size=m.channels * total_bins), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        return pool_ops.spatial_pyramid_pool(
            x, cfg.get("pyramid_height", 3), cfg.get("pool_type", "max"))


@register_layer("pad")
class PadLayer:
    """Zero pad of the channel, height and width axes."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        oc = m.channels + sum(cfg.get("pad_c", [0, 0]))
        oh = m.height + sum(cfg.get("pad_h", [0, 0]))
        ow = m.width + sum(cfg.get("pad_w", [0, 0]))
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        return (LayerMeta(size=oc * oh * ow, height=oh, width=ow, channels=oc),
                [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        pc = cfg.get("pad_c", [0, 0])
        ph = cfg.get("pad_h", [0, 0])
        pw = cfg.get("pad_w", [0, 0])
        return F.pad(x, (pc[0], pc[1], pw[0], pw[1], ph[0], ph[1]))


@register_layer("crop")
class CropLayer:
    """Crop to ``shape`` [c, h, w] from ``offset`` [c, h, w]."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        oc, oh, ow = cfg["shape"]
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        return (LayerMeta(size=oc * oh * ow, height=oh, width=ow, channels=oc),
                [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        oc, oh, ow = cfg["shape"]
        off = cfg.get("offset", [0, 0, 0])
        return x[:, off[1]:off[1] + oh, off[2]:off[2] + ow,
                 off[0]:off[0] + oc]


@register_layer("bilinear_interp")
class BilinearInterpLayer:
    """``jax.image.resize(method="bilinear")``: half-pixel centres, and
    a triangle kernel widened by the scale where it shrinks (antialias),
    which is ``F.interpolate(..., antialias=True)``."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        oh, ow = cfg["out_size_y"], cfg["out_size_x"]
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        return (LayerMeta(size=m.channels * oh * ow, height=oh, width=ow,
                          channels=m.channels), [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        y = F.interpolate(x.permute(0, 3, 1, 2),
                          size=(cfg["out_size_y"], cfg["out_size_x"]),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return y.permute(0, 2, 3, 1)


@register_layer("block_expand")
class BlockExpandLayer:
    """Image -> a sequence of flattened blocks (the OCR stacks feed it
    to an RNN and a CTC cost). The meta's step count is the JAX
    package's ceil-mode reckoning; the sequence itself has the floor
    walk's length, as the JAX op returns it."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        bx, by = cfg["block_x"], cfg["block_y"]
        sx, sy = cfg.get("stride_x", 1), cfg.get("stride_y", 1)
        px, py = cfg.get("padding_x", 0), cfg.get("padding_y", 0)
        c = cfg.get("channels") or m.channels
        oh = conv_ops.conv_out_size(m.height, by, sy, py, caffe_mode=False)
        ow = conv_ops.conv_out_size(m.width, bx, sx, px, caffe_mode=False)
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = c, m.height, m.width
        cfg["_steps"] = oh * ow
        return LayerMeta(size=bx * by * c, seq_level=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        patches = conv_ops.im2col(
            x, (cfg["block_y"], cfg["block_x"]),
            (cfg.get("stride_y", 1), cfg.get("stride_x", 1)),
            (cfg.get("padding_y", 0), cfg.get("padding_x", 0)))
        b, oh, ow, d = patches.shape
        lengths = torch.full((b,), oh * ow, dtype=torch.int32,
                             device=x.device)
        return SequenceBatch(patches.reshape(b, oh * ow, d), lengths)


def ensure_ndhwc(x: torch.Tensor, c: int, d: int, h: int,
                 w: int) -> torch.Tensor:
    """Accept [b, c*d*h*w] flat channel-major or already-NDHWC; a flat
    feed is transposed once, into NDHWC memory (channels-last-3d for
    cuDNN)."""
    if x.dim() == 5:
        return x
    b = x.shape[0]
    return x.reshape(b, c, d, h, w).permute(0, 2, 3, 4, 1).contiguous()


def _conv3d_specs(name, cfg, ic, oc, k):
    """The DHWIO weight [kd, kh, kw, ic, oc] and, unless bias_attr is
    False, the bias [oc] — the JAX package's names and initializers."""
    a = ParamAttr.of(cfg.get("param_attr"))
    wname = a.name or f"_{name}.w0"
    specs = [ParamSpec(wname, tuple(k) + (ic, oc),
                       a.initializer or initializers.msra((0, 1, 2, 3)), a)]
    cfg["_w_name"] = wname
    if cfg.get("bias_attr") is not False:
        battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                             else cfg.get("bias_attr"))
        bname = battr.name or f"_{name}.wbias"
        specs.append(ParamSpec(bname, (oc,), initializers.zeros, battr))
        cfg["_bias_name"] = bname
    return specs


def _conv3d_out(y, cfg, params):
    if cfg.get("_bias_name"):
        y = y + params[cfg["_bias_name"]].to(y.dtype)
    return act_ops.get(cfg.get("act", "linear"))(y)


@register_layer("conv3d")
class Conv3DLayer:
    """Volumetric convolution; the input is [b, c*d*h*w] flat
    channel-major or NDHWC."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        ic = cfg.get("channels") or m.channels
        idp = cfg["input_depth"]
        ih = cfg.get("input_height") or m.height or \
            int(round((m.size // (ic * idp)) ** 0.5))
        iw = cfg.get("input_width") or m.width or (m.size // (ic * idp * ih))
        oc = cfg["num_filters"]
        k = _triple(cfg["filter_size"])
        s = _triple(cfg.get("stride", 1))
        p = _triple(cfg.get("padding", 0))
        od, oh, ow = (conv_ops.conv_out_size(i, k[a], s[a], p[a])
                      for a, i in enumerate((idp, ih, iw)))
        specs = _conv3d_specs(name, cfg, ic, oc, k)
        cfg["_in"] = (ic, idp, ih, iw)
        cfg["_out"] = (oc, od, oh, ow)
        return (LayerMeta(size=oc * od * oh * ow, height=oh, width=ow,
                          channels=oc), specs, [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_ndhwc(inputs[0], *cfg["_in"])
        y = conv_ops.conv3d(x, params[cfg["_w_name"]],
                            stride=cfg.get("stride", 1),
                            padding=cfg.get("padding", 0))
        return _conv3d_out(y, cfg, params)


@register_layer("deconv3d")
class DeConv3DLayer:
    """Volumetric transposed convolution: output (i - 1) s - 2p + k."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        ic = cfg.get("channels") or m.channels
        idp = cfg["input_depth"]
        ih = cfg.get("input_height") or m.height
        iw = cfg.get("input_width") or m.width
        oc = cfg["num_filters"]
        k = _triple(cfg["filter_size"])
        s = _triple(cfg.get("stride", 1))
        p = _triple(cfg.get("padding", 0))
        od, oh, ow = ((i - 1) * s[a] - 2 * p[a] + k[a]
                      for a, i in enumerate((idp, ih, iw)))
        specs = _conv3d_specs(name, cfg, ic, oc, k)
        cfg["_in"] = (ic, idp, ih, iw)
        return (LayerMeta(size=oc * od * oh * ow, height=oh, width=ow,
                          channels=oc), specs, [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_ndhwc(inputs[0], *cfg["_in"])
        y = conv_ops.conv3d_transpose(x, params[cfg["_w_name"]],
                                      stride=cfg.get("stride", 1),
                                      padding=cfg.get("padding", 0))
        return _conv3d_out(y, cfg, params)


@register_layer("pool3d")
class Pool3DLayer:
    """Volumetric max or average pooling, caffe ceil-mode windows."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        c = cfg.get("channels") or m.channels
        idp = cfg["input_depth"]
        ih = cfg.get("input_height") or m.height
        iw = cfg.get("input_width") or m.width
        k = _triple(cfg["pool_size"])
        s = _triple(cfg.get("stride", 1))
        p = _triple(cfg.get("padding", 0))
        od, oh, ow = (pool_ops.pool_out_size(i, k[a], s[a], p[a])
                      for a, i in enumerate((idp, ih, iw)))
        cfg["_in"] = (c, idp, ih, iw)
        return (LayerMeta(size=c * od * oh * ow, height=oh, width=ow,
                          channels=c), [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_ndhwc(inputs[0], *cfg["_in"])
        k = _triple(cfg["pool_size"])
        s = _triple(cfg.get("stride", 1))
        p = _triple(cfg.get("padding", 0))
        if cfg.get("pool_type", "max") in ("max", "cudnn-max"):
            return pool_ops.max_pool3d(x, k, s, p)
        return pool_ops.avg_pool3d(x, k, s, p)
