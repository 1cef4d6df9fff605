"""Recurrent layers — the port of the ``lstmemory``, ``gru`` and
``recurrent`` layers of ``paddle_tpu/layers/recurrent_layers.py``
(full-sequence scans) and of its step layers ``gru_step`` and
``lstm_step``, which run inside a ``recurrent_group``, and the 2-D
``mdlstm`` over an image.

The input of lstmemory / grumemory is already projected by a
preceding fc to 4*size (LSTM) or 3*size (GRU); the layer owns only the
recurrent weight ``_{name}.w0`` and the bias ``_{name}.wbias`` — for the
LSTM 7h wide: the 4h gate bias, then the 3h peepholes.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.conv_layers import ensure_nhwc
from paddle_tpu_torch.ops import recurrent as rnn_ops


def _recurrent_specs(name, cfg, h, w_cols, b_size):
    """The recurrent weight [h, w_cols] and, unless bias_attr is False,
    the bias [b_size] — the JAX package's names and initializers."""
    a = ParamAttr.of(cfg.get("param_attr"))
    wname = a.name or f"_{name}.w0"
    specs = [ParamSpec(wname, (h, w_cols),
                       a.initializer or initializers.smart_normal(0), a)]
    cfg["_w_name"] = wname
    if cfg.get("bias_attr") is not False:
        battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                             else cfg.get("bias_attr"))
        bname = battr.name or f"_{name}.wbias"
        specs.append(ParamSpec(bname, (b_size,), initializers.zeros, battr))
        cfg["_b_name"] = bname
    return specs


@register_layer("lstmemory")
class LstmemoryLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        assert m.size % 4 == 0, "lstmemory input must be projected to 4*size"
        h = m.size // 4
        return LayerMeta(size=h, seq_level=1), \
            _recurrent_specs(name, cfg, h, 4 * h, 7 * h), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        h = seq.data.shape[-1] // 4
        w = params[cfg["_w_name"]]
        bias = peep = None
        if cfg.get("_b_name"):
            full = params[cfg["_b_name"]]
            bias, peep = full[:4 * h], full[4 * h:]
        return rnn_ops.lstm_scan(
            seq, w, bias, peep, reverse=cfg.get("reverse", False),
            act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"),
            state_act=cfg.get("state_act", "tanh"))


@register_layer("gru")
class GrumemoryLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        assert m.size % 3 == 0, "grumemory input must be projected to 3*size"
        h = m.size // 3
        return LayerMeta(size=h, seq_level=1), \
            _recurrent_specs(name, cfg, h, 3 * h, 3 * h), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        w = params[cfg["_w_name"]]
        bias = params.get(cfg.get("_b_name")) if cfg.get("_b_name") else None
        return rnn_ops.gru_scan(
            seq, w, bias, reverse=cfg.get("reverse", False),
            act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"))


@register_layer("recurrent")
class SimpleRecurrentLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        h = input_metas[0].size
        return LayerMeta(size=h, seq_level=1), \
            _recurrent_specs(name, cfg, h, h, h), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        w = params[cfg["_w_name"]]
        bias = params.get(cfg.get("_b_name")) if cfg.get("_b_name") else None
        return rnn_ops.rnn_scan(seq, w, bias,
                                reverse=cfg.get("reverse", False),
                                act=cfg.get("act", "tanh"))


@register_layer("gru_step")
class GruStepLayer:
    """Step-level GRU for recurrent_group decoders: inputs [x3 (the 3h
    projection), the h memory]; owns the recurrent weight and the gate
    bias."""

    @staticmethod
    def build(name, cfg, input_metas):
        h = cfg.get("size") or input_metas[1].size
        assert input_metas[0].size == 3 * h, \
            f"gru_step {name}: input must be 3*size projection"
        return LayerMeta(size=h), \
            _recurrent_specs(name, cfg, h, 3 * h, 3 * h), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x3, h = inputs
        w = params[cfg["_w_name"]]
        bias = params.get(cfg.get("_b_name")) if cfg.get("_b_name") else None
        return rnn_ops.gru_cell(x3, h, w, bias, act=cfg.get("act", "tanh"),
                                gate_act=cfg.get("gate_act", "sigmoid"))


@register_layer("lstm_step")
class LstmStepLayer:
    """Step-level LSTM: inputs [the 4h gate projection (the caller
    projects the previous h into it), the previous cell]; owns only the
    3h peephole weights (its bias). The output is h'; with
    ``expose_state`` it packs [h' | c'] so a cell memory can link to it
    (the state input may then be that packed 2h value)."""

    @staticmethod
    def build(name, cfg, input_metas):
        h = cfg.get("size") or input_metas[0].size // 4
        assert input_metas[0].size == 4 * h, \
            f"lstm_step {name}: input must be 4*size projection"
        assert input_metas[1].size in (h, 2 * h), \
            f"lstm_step {name}: state must be size h or 2h (packed [h|c])"
        specs = []
        if cfg.get("bias_attr") is not False:
            battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                                 else cfg.get("bias_attr"))
            bname = battr.name or f"_{name}.wbias"
            specs.append(ParamSpec(bname, (3 * h,), initializers.zeros, battr))
            cfg["_b_name"] = bname
        cfg["_h"] = h
        size = 2 * h if cfg.get("expose_state") else h
        return LayerMeta(size=size), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x4, c_prev = inputs
        hdim = cfg["_h"]
        if c_prev.shape[-1] == 2 * hdim:
            c_prev = c_prev[..., hdim:]
        peep = params.get(cfg.get("_b_name")) if cfg.get("_b_name") else None
        zero_w = torch.zeros((hdim, 4 * hdim), dtype=x4.dtype,
                             device=x4.device)
        h_new, c_new = rnn_ops.lstm_cell(
            x4, x4.new_zeros((x4.shape[0], hdim)), c_prev, zero_w, None,
            peep, act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"),
            state_act=cfg.get("state_act", "tanh"))
        if cfg.get("expose_state"):
            return torch.cat([h_new, c_new], dim=-1)
        return h_new


@register_layer("mdlstm")
class MDLstmLayer:
    """2-D multi-directional LSTM over an image whose channels are the
    pre-projected gates, 5*size of them (in, ig, fg_y, fg_x, og). Owns
    the shared recurrent weight [size, 5*size] and the 9*size bias
    (gates, then the peepholes of ig, fg_y, fg_x, og). ``directions``
    [bool, bool]: False walks that axis (height, width) backwards."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        assert m.channels and m.channels % 5 == 0, \
            f"mdlstm {name}: input channels must be 5*size"
        h = m.channels // 5
        specs = _recurrent_specs(name, cfg, h, 5 * h, 9 * h)
        cfg["_in"] = (m.channels, m.height, m.width)
        return (LayerMeta(size=h * m.height * m.width, height=m.height,
                          width=m.width, channels=h), specs, [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(inputs[0], *cfg["_in"])
        bias = params[cfg["_b_name"]] if cfg.get("_b_name") else None
        dirs = cfg.get("directions", [True, True])
        return rnn_ops.mdlstm_2d(
            x, params[cfg["_w_name"]], bias, act=cfg.get("act", "tanh"),
            gate_act=cfg.get("gate_act", "sigmoid"),
            reverse_h=not dirs[0], reverse_w=not dirs[1])
