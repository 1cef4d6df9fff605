"""Network composition helpers — the port of the image stacks
(simple_img_conv_pool, img_conv_bn_pool, img_conv_group,
vgg_16_network), the recurrent stacks (simple_lstm, simple_gru,
bidirectional_lstm, bidirectional_gru), simple_attention and the text
convolution block (sequence_conv_pool / text_conv_pool) of
``paddle_tpu/networks.py``.
Pure composition over the layer DSL: the same calls give the same
layers and names as in the JAX package."""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch import pooling
from paddle_tpu_torch.core.registry import LayerOutput, _auto_name


# ---------------------------------------------------------------------------
# image stacks


def simple_img_conv_pool(input, filter_size: int, num_filters: int,
                         pool_size: int, name: Optional[str] = None,
                         pool_type=None, act=None, groups: int = 1,
                         conv_stride: int = 1, conv_padding: int = 0,
                         pool_stride: int = 1, pool_padding: int = 0,
                         num_channels: Optional[int] = None,
                         bias_attr=None, param_attr=None) -> LayerOutput:
    """conv -> pool."""
    name = name or _auto_name("conv_pool")
    c = layer.img_conv(input, filter_size=filter_size,
                       num_filters=num_filters, num_channels=num_channels,
                       stride=conv_stride, padding=conv_padding,
                       groups=groups, act=act, bias_attr=bias_attr,
                       param_attr=param_attr, name=f"{name}_conv")
    return layer.img_pool(c, pool_size=pool_size, stride=pool_stride,
                          padding=pool_padding, pool_type=pool_type,
                          name=f"{name}_pool")


def img_conv_bn_pool(input, filter_size: int, num_filters: int,
                     pool_size: int, name: Optional[str] = None,
                     pool_type=None, act=None, groups: int = 1,
                     conv_stride: int = 1, conv_padding: int = 0,
                     pool_stride: int = 1, pool_padding: int = 0,
                     num_channels: Optional[int] = None) -> LayerOutput:
    """conv -> batch_norm -> pool."""
    name = name or _auto_name("conv_bn_pool")
    c = layer.img_conv(input, filter_size=filter_size,
                       num_filters=num_filters, num_channels=num_channels,
                       stride=conv_stride, padding=conv_padding,
                       groups=groups, act=None, bias_attr=False,
                       name=f"{name}_conv")
    bn = layer.batch_norm(c, act=act, name=f"{name}_bn")
    return layer.img_pool(bn, pool_size=pool_size, stride=pool_stride,
                          padding=pool_padding, pool_type=pool_type,
                          name=f"{name}_pool")


def img_conv_group(input, conv_num_filter: Sequence[int],
                   pool_size: int, num_channels: Optional[int] = None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, pool_stride: int = 1,
                   pool_type=None, name: Optional[str] = None) -> LayerOutput:
    """N convs (each optionally batch-normed) then one pool — the VGG
    block."""
    name = name or _auto_name("conv_group")
    conv_act = conv_act or act.Relu()

    def _seq(v, n):
        return v if isinstance(v, (list, tuple)) else [v] * n

    n = len(conv_num_filter)
    pads = _seq(conv_padding, n)
    ks = _seq(conv_filter_size, n)
    bns = _seq(conv_with_batchnorm, n)
    tmp = input
    for i in range(n):
        tmp = layer.img_conv(tmp, filter_size=ks[i],
                             num_filters=conv_num_filter[i],
                             num_channels=num_channels if i == 0 else None,
                             padding=pads[i],
                             act=None if bns[i] else conv_act,
                             bias_attr=not bns[i],
                             name=f"{name}_conv{i}")
        if bns[i]:
            tmp = layer.batch_norm(tmp, act=conv_act, name=f"{name}_bn{i}")
    return layer.img_pool(tmp, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type, name=f"{name}_pool")


def vgg_16_network(input_image, num_channels: int, num_classes: int = 1000,
                   name: str = "vgg16") -> LayerOutput:
    """VGG-16: 5 conv groups (2, 2, 3, 3, 3) + 2 fc 4096."""
    tmp = input_image
    cfgs = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    for gi, (reps, nf) in enumerate(cfgs):
        tmp = img_conv_group(
            tmp, conv_num_filter=[nf] * reps, pool_size=2, pool_stride=2,
            num_channels=num_channels if gi == 0 else None,
            conv_with_batchnorm=True, name=f"{name}_g{gi}")
    tmp = layer.dropout(tmp, 0.5, name=f"{name}_drop0")
    tmp = layer.fc(tmp, size=4096, act=act.Relu(), name=f"{name}_fc6")
    tmp = layer.dropout(tmp, 0.5, name=f"{name}_drop1")
    tmp = layer.fc(tmp, size=4096, act=act.Relu(), name=f"{name}_fc7")
    return layer.fc(tmp, size=num_classes, act=act.Softmax(),
                    name=f"{name}_out")


# ---------------------------------------------------------------------------
# recurrent stacks


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


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name: Optional[str] = None) -> LayerOutput:
    """Additive (Bahdanau) attention inside a recurrent_group step:
    score_t = v . tanh(enc_proj_t + s), context = sum_t softmax(score)_t
    * enc_t over the source's valid steps. encoded_sequence and
    encoded_proj are StaticInput sequences, decoder_state a memory."""
    name = name or _auto_name("attention")
    dec_expand = layer.expand(decoder_state, expand_as=encoded_proj,
                              name=f"{name}_expand")
    combined = layer.addto([encoded_proj, dec_expand], act=act.Tanh(),
                           name=f"{name}_combine")
    scores = layer.fc(combined, size=1, act=act.SequenceSoftmax(),
                      bias_attr=False, param_attr=softmax_param_attr,
                      name=f"{name}_weight")
    scaled = layer.scaling(scores, encoded_sequence, name=f"{name}_scale")
    return layer.pooling(scaled, pooling_type=pooling.Sum(),
                         name=f"{name}_context")


# ---------------------------------------------------------------------------
# text conv


def sequence_conv_pool(input, context_len: int, hidden_size: int,
                       name: Optional[str] = None, context_start=None,
                       pool_type=None, context_proj_param_attr=None,
                       fc_param_attr=None, fc_act=None) -> LayerOutput:
    """Context window projection -> fc -> sequence pool (the text CNN
    block)."""
    name = name or _auto_name("seq_conv_pool")
    ctx = layer.context_projection(input, context_len=context_len,
                                   context_start=context_start,
                                   param_attr=context_proj_param_attr,
                                   name=f"{name}_ctx")
    hidden = layer.fc(ctx, size=hidden_size, act=fc_act or act.Tanh(),
                      param_attr=fc_param_attr, name=f"{name}_fc")
    return layer.pooling(hidden, pooling_type=pool_type or pooling.Max(),
                         name=f"{name}_pool")


text_conv_pool = sequence_conv_pool
