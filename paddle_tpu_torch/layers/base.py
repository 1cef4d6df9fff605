"""Core layers — the port of ``paddle_tpu/layers/base.py``: ``data``,
``fc``, ``embedding``, ``dropout``, ``addto``, ``concat``,
``batch_norm``, ``scaling`` and ``cos_sim``, the element-wise types
(``dotmul``, ``interpolation``, ``slope_intercept``, ``outer_prod``,
``sum_to_one_norm``, ``trans``, ``resize``) and the projections that
are layers of their own (``slice``, ``scaling_projection``,
``dotmul_projection``, ``trans_fc``).

Conventions (the JAX package's): non-sequence values are
``[batch, size]``; sequences are SequenceBatch with data
``[batch, T, size]`` (ids ``[batch, T]``). ``build`` is the JAX
package's, line for line, so topologies serialize identically;
``apply`` computes on torch tensors.
"""

from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.data_type import InputType
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            StateSpec, default_weight_init,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.conv_layers import ensure_nhwc
from paddle_tpu_torch.ops import activations as act_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import linear as linear_ops
from paddle_tpu_torch.ops import norm as norm_ops


def _apply_act(x, act_name: str, mask=None):
    if act_name == "sequence_softmax":
        return act_ops.sequence_softmax(x, mask)
    return act_ops.get(act_name)(x)


def _map_seq(fn, value):
    """Apply fn to the dense payload whether value is a SequenceBatch or
    a tensor."""
    if isinstance(value, SequenceBatch):
        return value.with_data(fn(value.data))
    return fn(value)


def _payload(value):
    return value.data if isinstance(value, SequenceBatch) else value


def _norm_attrs(param_attr, n: int) -> List[ParamAttr]:
    if param_attr is None:
        return [ParamAttr() for _ in range(n)]
    if isinstance(param_attr, (list, tuple)):
        out = [ParamAttr.of(a) for a in param_attr]
        assert len(out) == n, "param_attr list length mismatch"
        return out
    return [ParamAttr.of(param_attr) for _ in range(n)]


@register_layer("data")
class DataLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        it: InputType = cfg["input_type"]
        height = cfg.get("height", 0)
        width = cfg.get("width", 0)
        channels = it.dim // (height * width) if height and width else 0
        return (LayerMeta(size=it.dim, seq_level=it.seq_type.value,
                          height=height, width=width, channels=channels,
                          is_integer=(it.kind == "integer")), [], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        v = inputs[0]
        # mixed-precision entry cast: dense float feeds drop to the
        # compute dtype once, here
        it: InputType = cfg["input_type"]
        if it.kind != "integer":
            cd = linear_ops.compute_dtype()
            if cd != torch.float32:
                if isinstance(v, SequenceBatch):
                    if v.data.is_floating_point():
                        v = v.with_data(v.data.to(cd))
                elif v.is_floating_point():
                    v = v.to(cd)
        return v


@register_layer("fc")
class FCLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        size = cfg["size"]
        attrs = _norm_attrs(cfg.get("param_attr"), len(input_metas))
        cfg["param_attr"] = attrs
        specs = []
        for i, (m, a) in enumerate(zip(input_metas, attrs)):
            pname = a.name or (f"_{name}.w{i}" if i else f"_{name}.w0")
            # tied_transpose stores the weight [out, in] — the shape of
            # an embedding table — so an LM head can share the token
            # table; the fc applies it transposed
            shape = (size, m.size) if cfg.get("tied_transpose") \
                else (m.size, size)
            fan_in = (1,) if cfg.get("tied_transpose") else (0,)
            specs.append(ParamSpec(pname, shape,
                                   default_weight_init(a, fan_in), a))
        battr = ParamAttr.of(cfg.get("bias_attr")) if not isinstance(
            cfg.get("bias_attr"), bool) else ParamAttr()
        if cfg.get("bias_attr") is not False:
            bname = battr.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (size,),
                                   battr.initializer or initializers.zeros,
                                   battr))
            cfg["_bias_name"] = bname
        seq_level = max(m.seq_level for m in input_metas)
        return LayerMeta(size=size, seq_level=seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        attrs = cfg["param_attr"]
        ws = [params[a.name or f"_{name}.w{i}"] for i, a in enumerate(attrs)]
        b = params.get(cfg.get("_bias_name")) if cfg.get("_bias_name") \
            else None
        out = None
        ref = None
        for val, w in zip(inputs, ws):
            x = _payload(val)
            if not isinstance(val, SequenceBatch) and x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            y = linear_ops.matmul(x, w.t() if cfg.get("tied_transpose")
                                  else w)
            out = y if out is None else out + y
            if isinstance(val, SequenceBatch):
                ref = val
        if b is not None:
            out = out + b.to(out.dtype)     # f32 master bias: no promote
        mask = ref.mask() if ref is not None else None
        out = _apply_act(out, cfg.get("act", "linear"), mask)
        return ref.with_data(out) if ref is not None else out


@register_layer("embedding")
class EmbeddingLayer:
    """A table lookup. With ``ParamAttr(sparse=True)`` the table is an
    ordinary parameter; a train step that prefetches its rows passes
    them in ``ctx.sparse_sub[table name]`` as ``(uids, rows)``, and the
    lookup then runs inside that block (``row_sub_lookup``), so the
    gradient is the block's and not the table's. With ``remote=True``
    the table lives in the sharded embedding store
    (paddle_tpu_torch/embed): no parameter is created — the
    ``[vocab, size]`` table never materializes on the device — and the
    rows arrive per batch through ``ctx.sparse_sub``
    (``embed.lookup.RemoteLookup``)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        assert m.is_integer, "embedding input must be integer ids"
        size = cfg["size"]
        a = ParamAttr.of(cfg.get("param_attr"))
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        if cfg.get("remote") or a.remote:
            cfg["_remote"] = True
            cfg["_vocab"] = m.size
            return LayerMeta(size=size, seq_level=m.seq_level), [], []
        init = a.initializer or initializers.normal(a.initial_std or 0.01)
        specs = [ParamSpec(pname, (m.size, size), init, a)]
        return LayerMeta(size=size, seq_level=m.seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        pname = cfg["_w_name"]
        val = inputs[0]
        ids = _payload(val)
        sub = ctx.sparse_sub
        if cfg.get("_remote"):
            if not sub or pname not in sub:
                raise KeyError(
                    f"embedding layer {name!r} uses a REMOTE table "
                    f"({pname}); pass sparse_sub={{...}} built by "
                    "paddle_tpu_torch.embed.lookup.RemoteLookup for this "
                    "batch")
            uids, rows = sub[pname][:2]
            out = emb_ops.row_sub_lookup(uids, rows, ids, cfg["_vocab"],
                                         pad_id=cfg.get("pad_id", -1))
        elif sub and pname in sub:
            uids, rows = sub[pname][:2]
            table = params[pname]
            # a table held as an mp shard: the global row count rides
            # third in the entry
            vocab = sub[pname][2] if len(sub[pname]) > 2 else table.shape[0]
            out = emb_ops.row_sub_lookup(uids, rows, ids, vocab,
                                         pad_id=cfg.get("pad_id", -1))
        else:
            out = emb_ops.embedding_lookup(params[pname], ids,
                                           pad_id=cfg.get("pad_id", -1))
        return val.with_data(out) if isinstance(val, SequenceBatch) else out


@register_layer("dropout")
class DropoutLayer:
    """Inverted dropout: in a train step each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), on a mask drawn
    from the layer's own generator (``ctx.rng_for``); the identity in
    test mode and at rate 0."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level, height=m.height,
                         width=m.width, channels=m.channels), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        rate = cfg.get("dropout_rate", 0.5)
        val = inputs[0]
        if not ctx.is_train or rate <= 0.0:
            return val

        def drop(x):
            keep = 1.0 - rate
            u = torch.rand(x.shape, generator=ctx.rng_for(name, x.device),
                           device=x.device)
            return torch.where(u < keep, x / keep,
                               torch.zeros((), dtype=x.dtype,
                                           device=x.device)).to(x.dtype)

        return _map_seq(drop, val)


@register_layer("addto")
class AddtoLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        size = input_metas[0].size
        for m in input_metas:
            assert m.size == size, "addto inputs must agree in size"
        specs = []
        if cfg.get("bias_attr") not in (False, None):
            a = ParamAttr.of(None if cfg.get("bias_attr") is True
                             else cfg.get("bias_attr"))
            bname = a.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (size,), initializers.zeros, a))
            cfg["_bias_name"] = bname
        m0 = input_metas[0]
        return LayerMeta(size=size,
                         seq_level=max(m.seq_level for m in input_metas),
                         height=m0.height, width=m0.width,
                         channels=m0.channels), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        ref = next((v for v in inputs if isinstance(v, SequenceBatch)), None)
        out = _payload(inputs[0])
        for v in inputs[1:]:
            out = out + _payload(v)        # f32 + bf16 promotes to f32
        if cfg.get("_bias_name"):
            out = out + params[cfg["_bias_name"]].to(out.dtype)
        out = _apply_act(out, cfg.get("act", "linear"))
        return ref.with_data(out) if ref is not None else out


@register_layer("concat")
class ConcatLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        size = sum(m.size for m in input_metas)
        m0 = input_metas[0]
        seq_level = max(m.seq_level for m in input_metas)
        # image channel-concat: same spatial dims -> channels add
        if all(m.height and m.height == m0.height and m.width == m0.width
               and m.channels for m in input_metas):
            return LayerMeta(size=size, seq_level=seq_level,
                             height=m0.height, width=m0.width,
                             channels=sum(m.channels for m in input_metas)), \
                [], []
        return LayerMeta(size=size, seq_level=seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        ref = next((v for v in inputs if isinstance(v, SequenceBatch)), None)
        out = torch.cat([_payload(v) for v in inputs], dim=-1)
        out = _apply_act(out, cfg.get("act", "linear"))
        return ref.with_data(out) if ref is not None else out


@register_layer("batch_norm")
class BatchNormLayer:
    """Batch norm over the channel axis (the last of an NHWC image, or
    the feature axis); batch statistics in a train step unless
    ``use_global_stats``, the moving statistics in test mode."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        c = m.channels if m.channels else m.size
        a = ParamAttr.of(cfg.get("param_attr"))
        gname = a.name or f"_{name}.w0"
        specs = [ParamSpec(gname, (c,), initializers.ones, a)]
        battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                             else cfg.get("bias_attr"))
        bname = battr.name or f"_{name}.wbias"
        specs.append(ParamSpec(bname, (c,), initializers.zeros, battr))
        states = [StateSpec(f"_{name}.moving_mean", (c,), 0.0),
                  StateSpec(f"_{name}.moving_var", (c,), 1.0)]
        cfg["_g_name"], cfg["_b_name"] = gname, bname
        cfg["_channels"] = c
        return (LayerMeta(size=m.size, seq_level=m.seq_level, height=m.height,
                          width=m.width, channels=m.channels), specs, states)

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        val = inputs[0]
        x = _payload(val)
        c = cfg["_channels"]
        gamma = params[cfg["_g_name"]]
        beta = params[cfg["_b_name"]]
        mm = ctx.get_state(f"_{name}.moving_mean")
        mv = ctx.get_state(f"_{name}.moving_var")
        shape = x.shape
        flat_image = x.dim() == 2 and shape[-1] != c
        if flat_image:
            # an image fed flat [b, c*h*w], channel-major (paddle layout)
            xr = x.reshape(shape[0], c, -1).transpose(1, 2).reshape(-1, c)
        elif shape[-1] != c or x.dim() == 2:
            xr = x.reshape(-1, c)
        else:
            xr = x
        if cfg.get("use_global_stats") or not ctx.is_train:
            y = norm_ops.batch_norm_infer(xr, gamma, beta, mm, mv)
        else:
            y, nm, nv = norm_ops.batch_norm_train(
                xr, gamma, beta, mm, mv,
                momentum=cfg.get("moving_average_fraction", 0.9),
                mesh=ctx.mesh)
            ctx.set_state(f"_{name}.moving_mean", nm)
            ctx.set_state(f"_{name}.moving_var", nv)
        if flat_image:
            y = y.reshape(shape[0], -1, c).transpose(1, 2).reshape(shape)
        else:
            y = y.reshape(shape)
        y = _apply_act(y, cfg.get("act", "linear"))
        return val.with_data(y) if isinstance(val, SequenceBatch) else y


@register_layer("scaling")
class ScalingLayer:
    """ScalingLayer: a per-row scalar (input 0, [b, 1]) times input 1."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[1].size,
                         seq_level=input_metas[1].seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w, v = inputs
        out = _payload(w) * _payload(v)
        return v.with_data(out) if isinstance(v, SequenceBatch) else out


@register_layer("cos_sim")
class CosSimLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1, seq_level=max(m.seq_level
                                               for m in input_metas)), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        a, b = inputs
        out = linear_ops.cos_sim(_payload(a), _payload(b),
                                 cfg.get("scale", 1.0))[..., None]
        ref = next((v for v in inputs if isinstance(v, SequenceBatch)), None)
        return ref.with_data(out) if ref is not None else out


@register_layer("dotmul")
class DotMulLayer:
    """dotmul_operator as a layer: elementwise a * b, optionally
    scaled."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[0].size,
                         seq_level=max(m.seq_level
                                       for m in input_metas)), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        a, b = inputs
        ref = next((v for v in inputs if isinstance(v, SequenceBatch)), None)
        out = cfg.get("scale", 1.0) * _payload(a) * _payload(b)
        return ref.with_data(out) if ref is not None else out


@register_layer("interpolation")
class InterpolationLayer:
    """w * a + (1 - w) * b with a per-row weight (input 0, [b, 1])."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[1].size,
                         seq_level=input_metas[1].seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w, a, b = inputs
        out = linear_ops.interpolation(_payload(w), _payload(a), _payload(b))
        ref = next((v for v in (a, b) if isinstance(v, SequenceBatch)), None)
        return ref.with_data(out) if ref is not None else out


@register_layer("slope_intercept")
class SlopeInterceptLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _map_seq(
            lambda x: linear_ops.slope_intercept(
                x, cfg.get("slope", 1.0), cfg.get("intercept", 0.0)),
            inputs[0])


@register_layer("outer_prod")
class OuterProdLayer:
    """Row-wise outer product [b, m], [b, n] -> [b, m*n]."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[0].size
                         * input_metas[1].size), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return linear_ops.outer(_payload(inputs[0]), _payload(inputs[1]))


@register_layer("sum_to_one_norm")
class SumToOneNormLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _map_seq(linear_ops.sum_to_one_norm, inputs[0])


@register_layer("trans")
class TransLayer:
    """Transposes the [b, n] activation as a matrix (the reference's use
    has b == n); the output is a plain, non-sequence value."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[0].size), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _payload(inputs[0]).transpose(-1, -2)


@register_layer("slice")
class SliceLayer:
    """Feature slice [start, end) — identity_projection with an offset.
    With ``channel_slice=True`` on an image input, [start, end) indexes
    channels (of the NHWC payload; a flat channel-major feed becomes
    NHWC first) and the image meta is kept for the convs and pools
    after it."""
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        n = cfg["end"] - cfg["start"]
        if cfg.get("channel_slice"):
            assert m.channels and m.height and cfg["end"] <= m.channels, \
                f"channel_slice needs an image input with >= {cfg['end']} " \
                "channels"
            cfg["_chan"] = (m.channels, m.height, m.width)
            return LayerMeta(size=n * m.height * m.width, height=m.height,
                             width=m.width, channels=n,
                             seq_level=m.seq_level), [], []
        return LayerMeta(size=n, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        def cut(x):
            if cfg.get("_chan"):
                # a channel block of NHWC memory, made contiguous so the
                # conv after it runs on channels-last strides
                if x.dim() == 2:
                    x = ensure_nhwc(x, *cfg["_chan"])
                return x[..., cfg["start"]:cfg["end"]].contiguous()
            return x[..., cfg["start"]:cfg["end"]]

        return _map_seq(cut, inputs[0])


@register_layer("scaling_projection")
class ScalingProjection:
    """w * x with one learned scalar weight (ScalingProjection)."""
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        return (LayerMeta(size=m.size, seq_level=m.seq_level),
                [ParamSpec(pname, (1,), initializers.ones, a)], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _map_seq(lambda x: params[cfg["_w_name"]] * x, inputs[0])


@register_layer("dotmul_projection")
class DotMulProjection:
    """x * w elementwise with a learned [size] weight
    (DotMulProjection)."""
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        return (LayerMeta(size=m.size, seq_level=m.seq_level),
                [ParamSpec(pname, (m.size,), initializers.ones, a)], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _map_seq(lambda x: x * params[cfg["_w_name"]], inputs[0])


@register_layer("trans_fc")
class TransFCLayer:
    """trans_full_matrix_projection: y = x @ W^T with W [size, in], so a
    weight can be shared between a projection and its transpose."""
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        size = cfg["size"]
        a = ParamAttr.of(cfg.get("param_attr"))
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        return (LayerMeta(size=size, seq_level=m.seq_level),
                [ParamSpec(pname, (size, m.size),
                           default_weight_init(a, (1,)), a)], [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        w = params[cfg["_w_name"]]
        return _map_seq(lambda x: linear_ops.matmul(x, w.t()), inputs[0])


@register_layer("resize")
class ResizeLayer:
    """Reshapes the payload to [-1, size]: rows change with the width;
    the output is a plain, non-sequence value."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=cfg["size"]), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _payload(inputs[0]).reshape(-1, cfg["size"])
