"""Assorted layers — the port of ``paddle_tpu/layers/misc_layers.py``:
the id helpers of generation (``maxid``, ``sampling_id``, ``eos_id``),
``multiplex``, the element-wise utilities (``clip``, ``scale_shift``,
``power``, ``featmap_expand``), ``data_norm``, ``selective_fc``,
``print``, ``rotate`` and the lookahead ``row_conv``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            default_weight_init,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.base import _map_seq, _payload
from paddle_tpu_torch.layers.conv_layers import ensure_nhwc
from paddle_tpu_torch.layers.seq_layers import topk_desc
from paddle_tpu_torch.ops import activations as act_ops
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import linear as linear_ops


@register_layer("maxid")
class MaxIdLayer:
    """The argmax id of each row, or its beam_size top ids (ties to the
    lower id)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=cfg.get("beam_size", 1), seq_level=m.seq_level,
                         is_integer=True), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        k = cfg.get("beam_size", 1)

        def top(x):
            if k == 1:
                return torch.argmax(x, dim=-1).to(torch.int32)[..., None]
            return topk_desc(x, k)[1].to(torch.int32)

        return _map_seq(top, inputs[0])


@register_layer("sampling_id")
class SamplingIdLayer:
    """One id drawn from each row's distribution in a train step, from
    the layer's own generator (``ctx.rng_for``); the argmax in test
    mode, so test passes stay deterministic."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=1, seq_level=m.seq_level, is_integer=True), \
            [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        def sample(x):
            logits = torch.log(torch.clamp(x, min=1e-20))
            if not ctx.is_train:
                return torch.argmax(logits, dim=-1).to(torch.int32)[..., None]
            flat = torch.softmax(logits.reshape(-1, logits.shape[-1]).float(),
                                 dim=-1)
            ids = torch.multinomial(flat, 1,
                                    generator=ctx.rng_for(name, x.device))
            return ids.reshape(logits.shape[:-1] + (1,)).to(torch.int32)

        return _map_seq(sample, inputs[0])


@register_layer("eos_id")
class EosIdCheckLayer:
    """1.0 where the input id equals eos_id."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=1, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        val = inputs[0]
        ids = _payload(val)
        # id payloads are [b] / [b, T] (or already [.., 1] from maxid):
        # the output always has a trailing size-1 feature axis
        if ids.dim() == (2 if isinstance(val, SequenceBatch) else 1):
            ids = ids[..., None]
        out = (ids == cfg["eos_id"]).to(torch.float32)
        return val.with_data(out) if isinstance(val, SequenceBatch) else out


@register_layer("multiplex")
class MultiplexLayer:
    """Row-wise select among k value inputs by an id input (input 0 is
    the ids, inputs 1..k the candidates). An id out of range selects as
    JAX's gather does: a negative id counts from the end, then every id
    is clamped into [0, k) — on the card an index past the end would be
    a device assert, not a value. As in JAX, whose gradient of a gather
    is a scatter that drops out-of-range indices, a row whose id is
    still out of range after the wrap passes no gradient back."""

    @staticmethod
    def build(name, cfg, input_metas):
        size = input_metas[1].size
        for m in input_metas[2:]:
            assert m.size == size, "multiplex candidates must agree in size"
        return LayerMeta(size=size), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        stacked = torch.stack([_payload(v) for v in inputs[1:]], dim=0)
        k = stacked.shape[0]
        ids = _payload(inputs[0]).reshape(-1).long()
        ids = torch.where(ids < 0, ids + k, ids)
        valid = ((ids >= 0) & (ids < k))[:, None]
        out = stacked[ids.clamp(0, k - 1),
                      torch.arange(stacked.shape[1], device=stacked.device)]
        return torch.where(valid, out, out.detach())


@register_layer("clip")
class ClipLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level, height=m.height,
                         width=m.width, channels=m.channels), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        lo, hi = cfg["min"], cfg["max"]
        return _map_seq(lambda x: torch.clamp(x, lo, hi), inputs[0])


@register_layer("scale_shift")
class ScaleShiftLayer:
    """y = w * x + b with a learned scalar w (and scalar b unless
    ``bias_attr=False``)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        specs = [ParamSpec(wname, (1,), a.initializer or initializers.ones,
                           a)]
        cfg["_w_name"] = wname
        if cfg.get("bias_attr") is not False:
            battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                                 else cfg.get("bias_attr"))
            bname = battr.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (1,), initializers.zeros, battr))
            cfg["_bias_name"] = bname
        return LayerMeta(size=m.size, seq_level=m.seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w = params[cfg["_w_name"]]
        b = params[cfg["_bias_name"]] if cfg.get("_bias_name") else 0.0
        return _map_seq(lambda x: w * x + b, inputs[0])


@register_layer("power")
class PowerLayer:
    """y = v ** w with a per-row exponent (input 0, [b, 1]); the
    exponent's gradient goes through log(v), so v must be positive
    wherever it is taken (the layer does not clamp, as JAX's does
    not)."""

    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[1].size,
                         seq_level=input_metas[1].seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w = _payload(inputs[0])
        v = inputs[1]
        out = torch.pow(_payload(v), w)
        return v.with_data(out) if isinstance(v, SequenceBatch) else out


@register_layer("featmap_expand")
class FeatureMapExpandLayer:
    """Repeats a [b, d] input num_filters times -> [b, num_filters*d]:
    the whole row after itself (``as_row_vector``, the default) or each
    element in place."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        nf = cfg["num_filters"]
        return LayerMeta(size=m.size * nf, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        nf = cfg["num_filters"]
        as_row = cfg.get("as_row_vector", True)

        def expand(x):
            if as_row:
                return x.repeat(*([1] * (x.dim() - 1)), nf)
            return torch.repeat_interleave(x, nf, dim=-1)

        return _map_seq(expand, inputs[0])


def _data_norm_stats_init(gen, shape, dtype=torch.float32):
    """Rows (min, max, mean, std, decimal_scale) = (0, 1, 0, 1, 1): the
    identity under every strategy until statistics are loaded."""
    base = torch.zeros(shape, dtype=dtype)
    base[1] = 1.0
    base[3] = 1.0
    base[4] = 1.0
    return base


@register_layer("data_norm")
class DataNormLayer:
    """Feature normalization from precomputed statistics: z-score,
    min-max or decimal scaling. The statistics are one static
    ``[5, size]`` parameter with rows (min, max, mean, std,
    decimal_scale), loaded and never trained."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        a.is_static = True
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        specs = [ParamSpec(pname, (5, m.size), _data_norm_stats_init, a)]
        return LayerMeta(size=m.size, seq_level=m.seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        mn, mx, mean, std, dscale = params[cfg["_w_name"]].unbind(0)
        strat = cfg.get("data_norm_strategy", "z-score")

        def norm(x):
            if strat == "min-max":
                return (x - mn) / torch.clamp(mx - mn, min=1e-8)
            if strat == "decimal-scaling":
                return x / torch.clamp(dscale, min=1e-8)
            return (x - mean) / torch.clamp(std, min=1e-8)

        return _map_seq(norm, inputs[0])


@register_layer("selective_fc")
class SelectiveFCLayer:
    """An fc whose outputs are kept only on the selected columns: the
    selection is a dense 0/1 mask [b, size] (input 1), applied after the
    activation; without it, a plain fc. The weight is stored [size, in],
    as the reference stores it."""

    @staticmethod
    def build(name, cfg, input_metas):
        size = cfg["size"]
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        specs = [ParamSpec(wname, (size, m.size),
                           default_weight_init(a, (1,)), a)]
        cfg["_w_name"] = wname
        if cfg.get("bias_attr") is not False:
            battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                                 else cfg.get("bias_attr"))
            bname = battr.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (size,), initializers.zeros, battr))
            cfg["_bias_name"] = bname
        cfg["_has_select"] = len(input_metas) > 1
        return LayerMeta(size=size, seq_level=m.seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w = params[cfg["_w_name"]]
        b = params[cfg["_bias_name"]] if cfg.get("_bias_name") else None
        sel = _payload(inputs[1]) if cfg.get("_has_select") else None

        def run(v):
            y = linear_ops.matmul(v, w.t())
            if b is not None:
                y = y + b
            y = act_ops.get(cfg.get("act", "linear"))(y)
            if sel is not None:
                y = y * sel.to(y.dtype)
            return y

        return _map_seq(run, inputs[0])


@register_layer("rotate")
class RotateLayer:
    """A CHW map turned 90 degrees counter-clockwise; the meta's height
    and width swap."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        h = cfg.get("height") or m.height
        w = cfg.get("width") or m.width
        c = m.channels or (m.size // max(h * w, 1))
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = c, h, w
        return LayerMeta(size=m.size, height=w, width=h, channels=c), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], cfg["_ic"], cfg["_ih"], cfg["_iw"])
        return torch.rot90(x, 1, dims=(1, 2))


@register_layer("row_conv")
class RowConvLayer:
    """Lookahead row convolution over a sequence (DeepSpeech2): out[t] =
    sum_{i < context} in[t + i] * w[i], per-channel weights [context,
    d]. The padding of a row reads as zeros, so a row's lookahead stops
    at its own end."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        specs = [ParamSpec(pname, (cfg["context_len"], m.size),
                           default_weight_init(a, (0,)), a)]
        return LayerMeta(size=m.size, seq_level=1), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        out = conv_ops.row_conv(seq.masked_data(), params[cfg["_w_name"]])
        return seq.with_data(act_ops.get(cfg.get("act", "linear"))(out))


@register_layer("print")
class PrintLayer:
    """The identity, which prints its input's payload when it runs
    (``format``, default ``name + ": {x}"``, with the values as a numpy
    array). It returns the input object itself, so autograd flows
    through and a SequenceBatch stays one. Printing reads the values
    back to the host: on the card it waits for them."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level, height=m.height,
                         width=m.width, channels=m.channels,
                         is_integer=m.is_integer), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        val = inputs[0]
        fmt = cfg.get("format", name + ": {x}")
        print(fmt.format(x=_payload(val).detach().cpu().numpy()))
        return val
