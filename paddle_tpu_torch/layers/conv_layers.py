"""Image layers — the port of the ``conv``, ``conv_bn``, ``pool`` and
``img_cmrnorm`` layers of ``paddle_tpu/layers/conv_layers.py`` (maxout,
SPP, pad, crop, bilinear, block expand and the 3-D layers wait for the
slice of the layer families).

Image values are logical NHWC ``[b, h, w, c]``, as in the JAX package;
a flat channel-major feed ``[b, c*h*w]`` (the paddle image convention)
becomes NHWC on entry. ``build`` is the JAX package's, so topologies
serialize identically.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            StateSpec, register_layer)
from paddle_tpu_torch.ops import activations as act_ops
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import fused as fused_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops import pool as pool_ops


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
        fusable = (cfg.get("fuse_stats") and k == 1 and s == 1
                   and p == 0 and d == 1)
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
                    c, gamma, beta, mm, mv, momentum=mom, eps=eps)
                ctx.set_state(f"_{name}.moving_mean", nm)
                ctx.set_state(f"_{name}.moving_var", nv)
            else:
                y = norm_ops.batch_norm_infer(c, gamma, beta, mm, mv,
                                              eps=eps)
        return act_ops.get(cfg.get("act", "linear"))(y)


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
