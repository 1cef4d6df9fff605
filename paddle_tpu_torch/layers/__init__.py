"""The layer DSL — the port of the ``paddle_tpu.layers`` wrappers that
the ported models build from: ``transformer_lm`` (data, fc, embedding,
addto, layer_norm, dot_product_attention, cross_entropy_cost) and the
sequence models (lstmemory, grumemory, recurrent, last_seq, first_seq,
pooling, concat, classification_cost, classification_error, crf,
crf_decoding).

Each wrapper normalizes its arguments exactly as the JAX package's
does (activation objects -> names, non-default options only), so the
same calls give the same graph, the same auto-names and the same
serialized topology. Layer types of later slices are not registered:
building or deserializing one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pool_mod
from paddle_tpu_torch.core.data_type import InputType
from paddle_tpu_torch.core.registry import LayerOutput, make_layer

# import implementations to populate the registry
from paddle_tpu_torch.layers import base as _base            # noqa: F401
from paddle_tpu_torch.layers import cost_layers as _cost     # noqa: F401
from paddle_tpu_torch.layers import extra_layers as _extra   # noqa: F401
from paddle_tpu_torch.layers import recurrent_layers as _rec  # noqa: F401
from paddle_tpu_torch.layers import seq_layers as _seq       # noqa: F401
from paddle_tpu_torch.layers.crf_layers import (  # noqa: F401
    crf, crf_decoding, crf_error)
from paddle_tpu_torch.layers.attention_layers import (  # noqa: F401
    dot_product_attention)


def _listify(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def data(name: str, type: InputType, height: int = 0, width: int = 0,
         **kw) -> LayerOutput:
    return make_layer("data", name, [], input_type=type, height=height,
                      width=width)


def fc(input, size: int, act=None, name: Optional[str] = None,
       param_attr=None, bias_attr=None, layer_attr=None,
       tied_transpose: bool = False, **kw) -> LayerOutput:
    if layer_attr is not None and getattr(layer_attr, "drop_rate", None):
        raise NotImplementedError("dropout is not ported yet (the "
                                  "transformer slice trains without it)")
    opts = {"tied_transpose": True} if tied_transpose else {}
    return make_layer("fc", name, _listify(input), size=size,
                      act=act_mod.to_name(act), param_attr=param_attr,
                      bias_attr=bias_attr, **opts)


def embedding(input, size: int, name: Optional[str] = None, param_attr=None,
              remote: bool = False, **kw) -> LayerOutput:
    kw = dict(size=size, param_attr=param_attr)
    if remote:
        kw["remote"] = True
    return make_layer("embedding", name, [input], **kw)


def addto(input, act=None, name: Optional[str] = None,
          bias_attr=None, **kw) -> LayerOutput:
    return make_layer("addto", name, _listify(input),
                      act=act_mod.to_name(act), bias_attr=bias_attr)


def concat(input, act=None, name: Optional[str] = None, **kw) -> LayerOutput:
    return make_layer("concat", name, _listify(input),
                      act=act_mod.to_name(act))


def layer_norm(input, name=None, param_attr=None, **kw) -> LayerOutput:
    return make_layer("layer_norm", name, [input], param_attr=param_attr)


def cross_entropy_cost(input, label, name=None, weight=None,
                       from_logits: bool = False,
                       label_smoothing: float = 0.0, **kw) -> LayerOutput:
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing={label_smoothing} must be in [0, 1)")
    if label_smoothing > 0.0 and not from_logits:
        raise ValueError(
            "label_smoothing needs from_logits=True (the probs CE path "
            "gathers only the label column)")
    opts = {}
    if from_logits:
        opts["from_logits"] = True
    if label_smoothing > 0.0:
        opts["label_smoothing"] = label_smoothing
    nodes = [input, label] + ([weight] if weight is not None else [])
    return make_layer("multi-class-cross-entropy", name, nodes, **opts)


# ---------------------------------------------------------------------------
# sequence layers


def pooling(input, pooling_type=None, agg_level: int = 0, name=None,
            max_segments=None, **kw) -> LayerOutput:
    return make_layer("seqpool", name, [input],
                      pool_type=pool_mod.to_name(pooling_type),
                      agg_level=agg_level, max_segments=max_segments)


def last_seq(input, name=None, agg_level: int = 0, **kw) -> LayerOutput:
    return make_layer("seqlastins", name, [input], first=False)


def first_seq(input, name=None, agg_level: int = 0, **kw) -> LayerOutput:
    return make_layer("seqlastins", name, [input], first=True)


# ---------------------------------------------------------------------------
# recurrent layers


def lstmemory(input, name=None, reverse: bool = False, act=None,
              gate_act=None, state_act=None, bias_attr=None, param_attr=None,
              **kw) -> LayerOutput:
    return make_layer("lstmemory", name, [input], reverse=reverse,
                      act=act_mod.to_name(act or "tanh"),
                      gate_act=act_mod.to_name(gate_act or "sigmoid"),
                      state_act=act_mod.to_name(state_act or "tanh"),
                      bias_attr=bias_attr, param_attr=param_attr)


def grumemory(input, name=None, reverse: bool = False, act=None,
              gate_act=None, bias_attr=None, param_attr=None,
              **kw) -> LayerOutput:
    return make_layer("gru", name, [input], reverse=reverse,
                      act=act_mod.to_name(act or "tanh"),
                      gate_act=act_mod.to_name(gate_act or "sigmoid"),
                      bias_attr=bias_attr, param_attr=param_attr)


def recurrent(input, name=None, reverse: bool = False, act=None,
              bias_attr=None, param_attr=None, **kw) -> LayerOutput:
    return make_layer("recurrent", name, [input], reverse=reverse,
                      act=act_mod.to_name(act or "tanh"),
                      bias_attr=bias_attr, param_attr=param_attr)


# ---------------------------------------------------------------------------
# classification costs


def classification_cost(input, label, weight=None, name=None,
                        **kw) -> LayerOutput:
    """CE over softmax probabilities (v2 classification_cost); the input
    carries a softmax activation already."""
    nodes = [input, label] + ([weight] if weight is not None else [])
    return make_layer("multi-class-cross-entropy", name, nodes)


def classification_error(input, label, name=None, **kw) -> LayerOutput:
    return make_layer("classification_error", name, [input, label])
