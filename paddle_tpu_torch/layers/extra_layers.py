"""The ``space_to_depth`` and ``layer_norm`` layers of
``paddle_tpu/layers/extra_layers.py`` (the rest of that file waits for
the slice of the layer families)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.layers.base import _map_seq, _payload
from paddle_tpu_torch.layers.conv_layers import ensure_nhwc


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
