"""Recurrent layers — the port of the ``lstmemory``, ``gru`` and
``recurrent`` layers of ``paddle_tpu/layers/recurrent_layers.py``
(full-sequence scans; the step layers wait for ``recurrent_group``, and
so does ``mdlstm``).

The input of lstmemory / grumemory is already projected by a
preceding fc to 4*size (LSTM) or 3*size (GRU); the layer owns only the
recurrent weight ``_{name}.w0`` and the bias ``_{name}.wbias`` — for the
LSTM 7h wide: the 4h gate bias, then the 3h peepholes.
"""

from __future__ import annotations

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
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
