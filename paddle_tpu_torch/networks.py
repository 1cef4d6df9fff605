"""Network composition helpers — the port of the recurrent stacks of
``paddle_tpu/networks.py`` (simple_lstm, simple_gru, bidirectional_lstm,
bidirectional_gru). Pure composition over the layer DSL: the same calls
give the same layers and names as in the JAX package."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import layers as layer
from paddle_tpu_torch.core.registry import LayerOutput, _auto_name


def simple_lstm(input, size: int, name: Optional[str] = None,
                reverse: bool = False, act=None, gate_act=None,
                state_act=None, mat_param_attr=None, bias_param_attr=None,
                inner_param_attr=None) -> LayerOutput:
    """fc(4*size) -> lstmemory."""
    name = name or _auto_name("lstm")
    mix = layer.fc(input, size=size * 4, act=None, bias_attr=False,
                   param_attr=mat_param_attr, name=f"{name}_transform")
    return layer.lstmemory(mix, name=name, reverse=reverse, act=act,
                           gate_act=gate_act, state_act=state_act,
                           bias_attr=bias_param_attr,
                           param_attr=inner_param_attr)


def simple_gru(input, size: int, name: Optional[str] = None,
               reverse: bool = False, act=None, gate_act=None,
               mixed_param_attr=None, gru_param_attr=None,
               gru_bias_attr=None) -> LayerOutput:
    """fc(3*size) -> grumemory."""
    name = name or _auto_name("gru")
    mix = layer.fc(input, size=size * 3, act=None, bias_attr=False,
                   param_attr=mixed_param_attr, name=f"{name}_transform")
    return layer.grumemory(mix, name=name, reverse=reverse, act=act,
                           gate_act=gate_act, param_attr=gru_param_attr,
                           bias_attr=gru_bias_attr)


def _bidirectional(cell, input, size, name, return_seq):
    fwd = cell(input, size, name=f"{name}_fw", reverse=False)
    bwd = cell(input, size, name=f"{name}_bw", reverse=True)
    if return_seq:
        return layer.concat([fwd, bwd], name=f"{name}_concat")
    f_last = layer.last_seq(fwd, name=f"{name}_fw_last")
    b_first = layer.first_seq(bwd, name=f"{name}_bw_first")
    return layer.concat([f_last, b_first], name=f"{name}_concat")


def bidirectional_lstm(input, size: int, name: Optional[str] = None,
                       return_seq: bool = False) -> LayerOutput:
    """Forward and reverse simple_lstm, concatenated (their last / first
    instances unless ``return_seq``)."""
    return _bidirectional(simple_lstm, input, size,
                          name or _auto_name("bilstm"), return_seq)


def bidirectional_gru(input, size: int, name: Optional[str] = None,
                      return_seq: bool = False) -> LayerOutput:
    """Forward and reverse simple_gru, concatenated."""
    return _bidirectional(simple_gru, input, size,
                          name or _auto_name("bigru"), return_seq)
