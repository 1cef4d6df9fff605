"""The port of ``paddle_tpu/layers/extra_layers.py``: the bilinear
tensor product, circular correlation, the convex combination,
parametric ReLU, row L2 normalization, the NCHW -> NHWC order switch,
``space_to_depth`` and ``layer_norm``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            default_weight_init,
                                            register_layer)
from paddle_tpu_torch.layers.base import _apply_act, _map_seq, _payload
from paddle_tpu_torch.layers.conv_layers import ensure_nhwc


@register_layer("tensor")
class TensorLayer:
    """Bilinear tensor product out[b, k] = e1[b] @ W_k @ e2[b], with one
    [size, in1, in2] weight."""

    @staticmethod
    def build(name, cfg, input_metas):
        assert len(input_metas) == 2, "tensor layer takes exactly 2 inputs"
        size = cfg["size"]
        h, w = input_metas[0].size, input_metas[1].size
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        cfg["_w_name"] = wname
        specs = [ParamSpec(wname, (size, h, w),
                           default_weight_init(a, fan_in_axes=(1, 2)), a)]
        if cfg.get("bias_attr") is not False:
            battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                                 else cfg.get("bias_attr"))
            bname = battr.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (size,), initializers.zeros, battr))
            cfg["_bias_name"] = bname
        return LayerMeta(size=size, seq_level=input_metas[0].seq_level), \
            specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w = params[cfg["_w_name"]]
        e1, e2 = _payload(inputs[0]), _payload(inputs[1])
        out = torch.einsum("...i,kij,...j->...k", e1, w, e2)
        if cfg.get("_bias_name"):
            out = out + params[cfg["_bias_name"]].to(out.dtype)
        out = _apply_act(out, cfg.get("act", "linear"))
        ref = inputs[0]
        return ref.with_data(out) if hasattr(ref, "with_data") else out


@register_layer("conv_shift")
class ConvShiftLayer:
    """Circular correlation (NTM-style addressing): c[i] = sum_j
    a[(i + j) mod M] * w[j], j over the centered window of the odd-sized
    shift input."""

    @staticmethod
    def build(name, cfg, input_metas):
        n = input_metas[1].size
        assert n % 2 == 1, "conv_shift: shift input size must be odd"
        cfg["_n"] = n
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        half = (cfg["_n"] - 1) // 2
        a = _payload(inputs[0])
        w = _payload(inputs[1])
        # a[i + j] is roll(a, -j)[i]; window offset j is shift column
        # j + half. The window is a few columns: a sum of rolls.
        out = sum(torch.roll(a, -j, dims=-1) * w[..., j + half:j + half + 1]
                  for j in range(-half, half + 1))
        ref = inputs[0]
        return ref.with_data(out) if hasattr(ref, "with_data") else out


@register_layer("convex_comb")
class ConvexCombinationLayer:
    """Weighted sum of the data-dim blocks of input 1 by input 0
    (linear_comb_layer): out[b, j] = sum_i w[b, i] * v[b, i * d + j]."""

    @staticmethod
    def build(name, cfg, input_metas):
        wdim = input_metas[0].size
        vdim = input_metas[1].size
        size = cfg.get("size") or vdim // wdim
        assert wdim * size == vdim, (
            f"convex_comb: weight dim {wdim} * data dim {size} != {vdim}")
        cfg["_wdim"], cfg["_ddim"] = wdim, size
        return LayerMeta(size=size, seq_level=input_metas[0].seq_level), \
            [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        m, d = cfg["_wdim"], cfg["_ddim"]
        w = _payload(inputs[0])
        v = _payload(inputs[1])
        out = torch.einsum("...m,...md->...d", w,
                           v.reshape(v.shape[:-1] + (m, d)))
        ref = inputs[0]
        return ref.with_data(out) if hasattr(ref, "with_data") else out


@register_layer("prelu")
class ParameterReluLayer:
    """y = x > 0 ? x : w * x with a learned slope per group of
    ``partial_sum`` consecutive features (1: one slope an element; the
    channel size: one a channel; the input size: one shared)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        ps = cfg.get("partial_sum", 1)
        assert ps > 0 and m.size % ps == 0, (
            f"prelu: partial_sum {ps} must divide input size {m.size}")
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        cfg["_w_name"], cfg["_ps"] = wname, ps
        specs = [ParamSpec(wname, (m.size // ps,),
                           a.initializer or initializers.constant(0.25), a)]
        return LayerMeta(size=m.size, seq_level=m.seq_level, height=m.height,
                         width=m.width, channels=m.channels), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w = torch.repeat_interleave(params[cfg["_w_name"]], cfg["_ps"])

        def act(x):
            wx = w.reshape((1,) * (x.dim() - 1) + (-1,)).to(x.dtype)
            return torch.where(x > 0, x, wx * x)

        return _map_seq(act, inputs[0])


@register_layer("row_l2_norm")
class RowL2NormLayer:
    """out = in / ||in||_2 per row; an all-zero row (a padded step)
    gives 0."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        def norm(x):
            return x / torch.clamp(
                torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True)),
                min=1e-12)

        return _map_seq(norm, inputs[0])


@register_layer("switch_order")
class SwitchOrderLayer:
    """A channel-major feature map to NHWC order, flattened
    ``[b, h*w*c]``."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        h = cfg.get("height") or m.height
        w = cfg.get("width") or m.width
        c = m.channels or (m.size // max(h * w, 1))
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = c, h, w
        return LayerMeta(size=m.size, height=h, width=w, channels=c), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        return x.reshape(x.shape[0], -1)


@register_layer("space_to_depth")
class SpaceToDepthLayer:
    """[b, h, w, c] -> [b, h/f, w/f, c*f*f]: each f x f spatial block
    folded into channels, in (row in block, column in block, channel)
    order. ``models.image.resnet(tpu_stem=True)`` opens with it."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        f = cfg.get("factor", 2)
        ic = cfg.get("channels") or m.channels
        ih, iw = m.height, m.width
        assert ic and ih and iw, (
            f"space_to_depth {name}: input needs channel/height/width meta")
        assert ih % f == 0 and iw % f == 0, (
            f"space_to_depth {name}: {ih}x{iw} not divisible by factor {f}")
        cfg["_ic"], cfg["_ih"], cfg["_iw"], cfg["_f"] = ic, ih, iw, f
        return LayerMeta(size=m.size or ic * ih * iw, height=ih // f,
                         width=iw // f, channels=ic * f * f), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        f = cfg["_f"]
        x = ensure_nhwc(_payload(inputs[0]), cfg["_ic"], cfg["_ih"],
                        cfg["_iw"])
        b, h, w, c = x.shape
        x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h // f, w // f, f * f * c)


@register_layer("layer_norm")
class LayerNormLayer:
    """Per-position layer normalization with learned gain/bias:
    statistics in float32 (var = E[x^2] - mean^2 clamped at 0, eps
    1e-5), the normalized map emitted in the input dtype."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        gname = a.name or f"_{name}.w0"
        bname = f"_{name}.wbias"
        cfg["_g_name"], cfg["_b_name"] = gname, bname
        specs = [ParamSpec(gname, (m.size,), initializers.ones, a),
                 ParamSpec(bname, (m.size,), initializers.zeros,
                           ParamAttr())]
        return LayerMeta(size=m.size, seq_level=m.seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        g = params[cfg["_g_name"]]
        b = params[cfg["_b_name"]]

        def norm(x):
            xf = x.float()
            mean = xf.mean(dim=-1, keepdim=True)
            var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                              - mean * mean, min=0.0)
            y = (xf - mean) * torch.rsqrt(var + 1e-5)
            return (y * g + b).to(x.dtype)

        return _map_seq(norm, inputs[0])
