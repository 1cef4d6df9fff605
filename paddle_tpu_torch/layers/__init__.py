"""The layer DSL — the port of the ``paddle_tpu.layers`` wrappers that
the ported models build from: ``transformer_lm`` (data, fc, embedding,
addto, layer_norm, dot_product_attention, cross_entropy_cost), the
sequence models (lstmemory, grumemory, recurrent, last_seq, first_seq,
pooling, concat, classification_cost, classification_error, crf,
crf_decoding), the image models (dropout, batch_norm, img_conv,
conv_bn, img_pool, global_img_pool, space_to_depth, img_cmrnorm) and
the sequence-generation path (recurrent_group, memory, StaticInput,
SubsequenceInput, GeneratedInput, get_output, beam_search, gru_step,
lstm_step, scaling, context_projection, expand, seq_concat,
seq_reshape, seq_slice, seq_reverse, sub_seq, kmax_seq_score,
sub_nested_seq, max_id, sampling_id, eos, cross_entropy_over_beam),
the CTR and ranking path (cos_sim, square_error_cost with its aliases
mse_cost and regression_cost, the binary and self-normalizing cross
entropies, rank_cost, lambda_cost, the Huber and smooth-L1 costs,
sum_cost, hsigmoid), the mixture-of-experts pair (moe,
moe_aux_cost), ``multi_head_attention``, and the layer families:
``mixed`` with the projections (full_matrix, identity, slice, table,
scaling, dotmul, trans_full_matrix), the element-wise types (dotmul,
interpolation, slope_intercept, outer_prod, sum_to_one_norm, trans,
resize, clip, scale_shift, power, featmap_expand), data_norm,
selective_fc, multiplex, print_layer, tensor, conv_shift,
linear_comb, prelu, row_l2_norm and switch_order; the image
transforms and the 3-D and multi-dimensional types (maxout, spp, pad,
crop, bilinear_interp, block_expand, rotate, row_conv, img_conv3d,
img_pool3d, mdlstm), the CTC costs (ctc, warp_ctc), nce and the SSD
detection types (priorbox, cross_channel_norm, multibox_loss,
detection_output) — with the JAX package's ``*_layer`` aliases of
each, and none it lacks.

Each wrapper normalizes its arguments exactly as the JAX package's
does (activation objects -> names, non-default options only), so the
same calls give the same graph, the same auto-names and the same
serialized topology. Every layer type of the JAX package is
registered; an unknown type raises ``KeyError``, as there.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import pooling as pool_mod
from paddle_tpu_torch.core.data_type import InputType
from paddle_tpu_torch.core.registry import LayerOutput, make_layer

# import implementations to populate the registry
from paddle_tpu_torch.layers import base as _base            # noqa: F401
from paddle_tpu_torch.layers import conv_layers as _conv     # noqa: F401
from paddle_tpu_torch.layers import cost_layers as _cost     # noqa: F401
from paddle_tpu_torch.layers import extra_layers as _extra   # noqa: F401
from paddle_tpu_torch.layers import recurrent_layers as _rec  # noqa: F401
from paddle_tpu_torch.layers import seq_layers as _seq       # noqa: F401
from paddle_tpu_torch.layers import group as _group          # noqa: F401
from paddle_tpu_torch.layers import misc_layers as _misc     # noqa: F401
from paddle_tpu_torch.layers import detection_layers as _det  # noqa: F401
from paddle_tpu_torch.layers.group import (  # noqa: F401
    GeneratedInput, StaticInput, SubsequenceInput, beam_search, get_output,
    memory, recurrent_group)
from paddle_tpu_torch.layers.beam import (  # noqa: F401
    BeamInput, cross_entropy_over_beam)
from paddle_tpu_torch.layers.crf_layers import (  # noqa: F401
    crf, crf_decoding, crf_error, ctc, ctc_layer, warp_ctc)
from paddle_tpu_torch.layers.attention_layers import (  # noqa: F401
    dot_product_attention, multi_head_attention)
from paddle_tpu_torch.layers.moe_layers import (  # noqa: F401
    moe, moe_aux_cost)


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


data_layer = data


def fc(input, size: int, act=None, name: Optional[str] = None,
       param_attr=None, bias_attr=None, layer_attr=None,
       tied_transpose: bool = False, **kw) -> LayerOutput:
    opts = {"tied_transpose": True} if tied_transpose else {}
    node = make_layer("fc", name, _listify(input), size=size,
                      act=act_mod.to_name(act), param_attr=param_attr,
                      bias_attr=bias_attr, **opts)
    return _maybe_dropout(node, layer_attr)


fc_layer = fc


def embedding(input, size: int, name: Optional[str] = None, param_attr=None,
              remote: bool = False, **kw) -> LayerOutput:
    kw = dict(size=size, param_attr=param_attr)
    if remote:
        kw["remote"] = True
    return make_layer("embedding", name, [input], **kw)


embedding_layer = embedding


def dropout(input, dropout_rate: float = 0.5,
            name: Optional[str] = None) -> LayerOutput:
    return make_layer("dropout", name, [input], dropout_rate=dropout_rate)


dropout_layer = dropout


def _maybe_dropout(node: LayerOutput, layer_attr) -> LayerOutput:
    """``layer_attr=ExtraAttr(drop_rate=r)``: a dropout layer after the
    node, as the JAX package builds it."""
    if layer_attr is not None and getattr(layer_attr, "drop_rate", None):
        return dropout(node, layer_attr.drop_rate)
    return node


def addto(input, act=None, name: Optional[str] = None,
          bias_attr=None, **kw) -> LayerOutput:
    return make_layer("addto", name, _listify(input),
                      act=act_mod.to_name(act), bias_attr=bias_attr)


addto_layer = addto


def concat(input, act=None, name: Optional[str] = None, **kw) -> LayerOutput:
    return make_layer("concat", name, _listify(input),
                      act=act_mod.to_name(act))


concat_layer = concat


def batch_norm(input, act=None, name: Optional[str] = None, num_channels=None,
               param_attr=None, bias_attr=None, use_global_stats=None,
               moving_average_fraction: float = 0.9, **kw) -> LayerOutput:
    return make_layer("batch_norm", name, [input], act=act_mod.to_name(act),
                      param_attr=param_attr, bias_attr=bias_attr,
                      channels=num_channels,
                      use_global_stats=use_global_stats,
                      moving_average_fraction=moving_average_fraction)


batch_norm_layer = batch_norm


def cos_sim(a, b, scale: float = 1.0, size: int = 1,
            name: Optional[str] = None, **kw) -> LayerOutput:
    return make_layer("cos_sim", name, [a, b], scale=scale)


def scaling(weight, input, name: Optional[str] = None, **kw) -> LayerOutput:
    return make_layer("scaling", name, [weight, input])


scaling_layer = scaling


def dotmul(a, b, scale: float = 1.0, name: Optional[str] = None) -> LayerOutput:
    return make_layer("dotmul", name, [a, b], scale=scale)


def interpolation(input, weight, name: Optional[str] = None,
                  **kw) -> LayerOutput:
    a, b = input
    return make_layer("interpolation", name, [weight, a, b])


interpolation_layer = interpolation


def slope_intercept(input, slope: float = 1.0, intercept: float = 0.0,
                    name: Optional[str] = None, **kw) -> LayerOutput:
    return make_layer("slope_intercept", name, [input], slope=slope,
                      intercept=intercept)


slope_intercept_layer = slope_intercept


def outer_prod(a, b, name: Optional[str] = None) -> LayerOutput:
    return make_layer("outer_prod", name, [a, b])


def sum_to_one_norm(input, name: Optional[str] = None) -> LayerOutput:
    return make_layer("sum_to_one_norm", name, [input])


sum_to_one_norm_layer = sum_to_one_norm


def trans(input, name: Optional[str] = None) -> LayerOutput:
    return make_layer("trans", name, [input])


trans_layer = trans


def resize(input, size: int, name: Optional[str] = None) -> LayerOutput:
    return make_layer("resize", name, [input], size=size)


resize_layer = resize


def mixed(size: int = 0, input=None, act=None, name: Optional[str] = None,
          bias_attr=None, **kw) -> LayerOutput:
    """mixed_layer: the sum of its projections (each already a node),
    with an optional bias and activation — an ``addto``."""
    return make_layer("addto", name, _listify(input),
                      act=act_mod.to_name(act), bias_attr=bias_attr)


mixed_layer = mixed


# Projections are plain nodes here, summed by mixed() / addto.

def full_matrix_projection(input, size: int, param_attr=None,
                           **kw) -> LayerOutput:
    return make_layer("fc", None, [input], size=size, act="linear",
                      param_attr=param_attr, bias_attr=False)


def identity_projection(input, offset: int = 0, size: Optional[int] = None,
                        **kw):
    if offset == 0 and size is None:
        return input
    sz = size if size is not None else input.size - offset
    return slice_projection(input, offset, offset + sz)


def slice_projection(input, start: int, end: int,
                     channel_slice: bool = False, **kw) -> LayerOutput:
    return make_layer("slice", None, [input], start=start, end=end,
                      channel_slice=channel_slice)


def table_projection(input, size: int, param_attr=None,
                     **kw) -> LayerOutput:
    return make_layer("embedding", None, [input], size=size,
                      param_attr=param_attr)


def scaling_projection(input, param_attr=None, **kw) -> LayerOutput:
    return make_layer("scaling_projection", None, [input],
                      param_attr=param_attr)


def dotmul_projection(input, param_attr=None, **kw) -> LayerOutput:
    return make_layer("dotmul_projection", None, [input],
                      param_attr=param_attr)


def trans_full_matrix_projection(input, size: int, param_attr=None,
                                 **kw) -> LayerOutput:
    return make_layer("trans_fc", None, [input], size=size,
                      param_attr=param_attr)


def context_projection(input, context_len: int, context_start=None,
                       padding_attr=False, **kw) -> LayerOutput:
    trainable = padding_attr not in (False, None)
    return make_layer(
        "context_projection", None, [input], context_len=context_len,
        context_start=(context_start if context_start is not None
                       else -(context_len // 2)),
        trainable_padding=trainable,
        param_attr=None if padding_attr in (False, True, None)
        else padding_attr)


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
# image layers


def img_conv(input, filter_size: int, num_filters: int, name=None,
             num_channels=None, act=None, groups: int = 1, stride: int = 1,
             padding: int = 0, dilation: int = 1, bias_attr=None,
             param_attr=None, trans: bool = False, layer_attr=None,
             **kw) -> LayerOutput:
    node = make_layer("conv", name, [input], filter_size=filter_size,
                      num_filters=num_filters, channels=num_channels,
                      act=act_mod.to_name(act), groups=groups, stride=stride,
                      padding=padding, dilation=dilation, bias_attr=bias_attr,
                      param_attr=param_attr, trans=trans)
    return _maybe_dropout(node, layer_attr)


img_conv_layer = img_conv


def conv_bn(input, filter_size: int, num_filters: int, name=None,
            num_channels=None, act=None, stride: int = 1, padding: int = 0,
            dilation: int = 1, param_attr=None, use_global_stats=None,
            moving_average_fraction: float = 0.9, epsilon: float = 1e-5,
            fuse_stats: bool = False, groups: int = 1,
            **kw) -> LayerOutput:
    """Conv + batch norm in one node, the arithmetic of
    img_conv(bias_attr=False) -> batch_norm; ``fuse_stats`` opts 1x1/s1/p0
    convs into ``ops/fused.conv_bn_train`` (not the default)."""
    assert groups == 1, \
        "conv_bn does not support grouped convs — use img_conv + batch_norm"
    return make_layer("conv_bn", name, [input], filter_size=filter_size,
                      num_filters=num_filters, channels=num_channels,
                      act=act_mod.to_name(act), stride=stride,
                      padding=padding, dilation=dilation,
                      param_attr=param_attr,
                      use_global_stats=use_global_stats,
                      moving_average_fraction=moving_average_fraction,
                      epsilon=epsilon, fuse_stats=fuse_stats)


conv_bn_layer = conv_bn


def img_pool(input, pool_size: int, name=None, num_channels=None,
             pool_type=None, stride: int = 1, padding: int = 0,
             pool_size_x=None, ceil_mode: bool = True, **kw) -> LayerOutput:
    return make_layer("pool", name, [input], pool_size=pool_size,
                      pool_size_x=pool_size_x,
                      channels=num_channels, pool_type=pool_mod.to_name(
                          pool_type or "max"),
                      stride=stride, padding=padding, ceil_mode=ceil_mode)


img_pool_layer = img_pool


def global_img_pool(input, name=None, pool_type=None, **kw) -> LayerOutput:
    """Global spatial pool (the GAP of the ResNet head)."""
    return make_layer("pool", name, [input], pool_size=input.meta.height,
                      pool_size_x=input.meta.width,
                      pool_type=pool_mod.to_name(pool_type or "average"),
                      stride=1, padding=0)


def space_to_depth(input, factor: int = 2, name=None, num_channels=None,
                   **kw) -> LayerOutput:
    """Fold factor x factor spatial blocks into channels."""
    return make_layer("space_to_depth", name, [input], factor=factor,
                      channels=num_channels)


def img_cmrnorm(input, size: int = 5, scale: float = 0.0128,
                power: float = 0.75, name=None, **kw) -> LayerOutput:
    return make_layer("img_cmrnorm", name, [input], size=size, scale=scale,
                      power=power)


img_cmrnorm_layer = img_cmrnorm


def maxout(input, groups: int, name=None, **kw) -> LayerOutput:
    return make_layer("maxout", name, [input], groups=groups)


maxout_layer = maxout


def spp(input, pyramid_height: int = 3, pool_type=None, name=None,
        **kw) -> LayerOutput:
    return make_layer("spp", name, [input], pyramid_height=pyramid_height,
                      pool_type=pool_mod.to_name(pool_type or "max"))


spp_layer = spp


def pad(input, pad_c=None, pad_h=None, pad_w=None, name=None,
        **kw) -> LayerOutput:
    return make_layer("pad", name, [input], pad_c=pad_c or [0, 0],
                      pad_h=pad_h or [0, 0], pad_w=pad_w or [0, 0])


pad_layer = pad


def crop(input, shape, offset=None, name=None, **kw) -> LayerOutput:
    return make_layer("crop", name, [input], shape=shape,
                      offset=offset or [0, 0, 0])


def bilinear_interp(input, out_size_x: int, out_size_y: int, name=None,
                    **kw) -> LayerOutput:
    return make_layer("bilinear_interp", name, [input], out_size_x=out_size_x,
                      out_size_y=out_size_y)


bilinear_interp_layer = bilinear_interp


def block_expand(input, block_x: int, block_y: int, stride_x: int = 1,
                 stride_y: int = 1, padding_x: int = 0, padding_y: int = 0,
                 num_channels=None, name=None, **kw) -> LayerOutput:
    return make_layer("block_expand", name, [input], block_x=block_x,
                      block_y=block_y, stride_x=stride_x, stride_y=stride_y,
                      padding_x=padding_x, padding_y=padding_y,
                      channels=num_channels)


block_expand_layer = block_expand


def img_conv3d(input, filter_size, num_filters: int, input_depth: int,
               name=None, num_channels=None, act=None, stride=1, padding=0,
               trans: bool = False, param_attr=None, bias_attr=None,
               input_height=None, input_width=None, **kw) -> LayerOutput:
    """A 3-D conv (``trans``: the transposed conv, type deconv3d)."""
    return make_layer("deconv3d" if trans else "conv3d", name, [input],
                      filter_size=filter_size, num_filters=num_filters,
                      input_depth=input_depth, channels=num_channels,
                      act=act_mod.to_name(act), stride=stride,
                      padding=padding, param_attr=param_attr,
                      bias_attr=bias_attr, input_height=input_height,
                      input_width=input_width)


def img_pool3d(input, pool_size, input_depth: int, name=None,
               num_channels=None, pool_type=None, stride=1, padding=0,
               input_height=None, input_width=None, **kw) -> LayerOutput:
    return make_layer("pool3d", name, [input], pool_size=pool_size,
                      input_depth=input_depth, channels=num_channels,
                      pool_type=pool_mod.to_name(pool_type) if pool_type
                      else "max",
                      stride=stride, padding=padding,
                      input_height=input_height, input_width=input_width)


# ---------------------------------------------------------------------------
# sequence layers


def pooling(input, pooling_type=None, agg_level: int = 0, name=None,
            max_segments=None, **kw) -> LayerOutput:
    return make_layer("seqpool", name, [input],
                      pool_type=pool_mod.to_name(pooling_type),
                      agg_level=agg_level, max_segments=max_segments)


pooling_layer = pooling


def last_seq(input, name=None, agg_level: int = 0, **kw) -> LayerOutput:
    return make_layer("seqlastins", name, [input], first=False)


def first_seq(input, name=None, agg_level: int = 0, **kw) -> LayerOutput:
    return make_layer("seqlastins", name, [input], first=True)


def expand(input, expand_as, name=None, expand_level: int = 0,
           **kw) -> LayerOutput:
    return make_layer("expand", name, [input, expand_as])


expand_layer = expand


def seq_concat(a, b, name=None, **kw) -> LayerOutput:
    return make_layer("seqconcat", name, [a, b])


seq_concat_layer = seq_concat


def seq_reshape(input, reshape_size: int, name=None, **kw) -> LayerOutput:
    return make_layer("seqreshape", name, [input], reshape_size=reshape_size)


seq_reshape_layer = seq_reshape


def seq_slice(input, starts=None, ends=None, name=None, **kw) -> LayerOutput:
    nodes = [input] + [n for n in (starts, ends) if n is not None]
    return make_layer("seqslice", name, nodes)


seq_slice_layer = seq_slice


def seq_reverse(input, name=None, **kw) -> LayerOutput:
    return make_layer("seqreverse", name, [input])


def sub_seq(input, offsets, sizes, name=None, **kw) -> LayerOutput:
    return make_layer("subseq", name, [input, offsets, sizes])


def kmax_seq_score(input, beam_size: int = 1, name=None,
                   **kw) -> LayerOutput:
    return make_layer("kmax_seq_score", name, [input], beam_size=beam_size)


def sub_nested_seq(input, selected_indices, name=None, **kw) -> LayerOutput:
    return make_layer("sub_nested_seq", name, [input, selected_indices])


# ---------------------------------------------------------------------------
# recurrent layers


def mdlstm(input, name=None, directions=None, act=None, gate_act=None,
           param_attr=None, bias_attr=None, **kw) -> LayerOutput:
    return make_layer("mdlstm", name, [input],
                      directions=directions or [True, True],
                      act=act_mod.to_name(act) if act else "tanh",
                      gate_act=act_mod.to_name(gate_act) if gate_act
                      else "sigmoid",
                      param_attr=param_attr, bias_attr=bias_attr)


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


recurrent_layer = recurrent


def gru_step(input, output_mem, size=None, name=None, act=None,
             gate_act=None, bias_attr=None, param_attr=None,
             **kw) -> LayerOutput:
    """Step-level GRU for recurrent_group decoders."""
    return make_layer("gru_step", name, [input, output_mem], size=size,
                      act=act_mod.to_name(act or "tanh"),
                      gate_act=act_mod.to_name(gate_act or "sigmoid"),
                      bias_attr=bias_attr, param_attr=param_attr)


gru_step_layer = gru_step


def lstm_step(input, state, size=None, name=None, act=None, gate_act=None,
              state_act=None, bias_attr=None, expose_state: bool = False,
              **kw) -> LayerOutput:
    """Step-level LSTM: ``state`` is the previous-cell memory."""
    return make_layer("lstm_step", name, [input, state], size=size,
                      act=act_mod.to_name(act or "tanh"),
                      gate_act=act_mod.to_name(gate_act or "sigmoid"),
                      state_act=act_mod.to_name(state_act or "tanh"),
                      bias_attr=bias_attr, expose_state=expose_state)


lstm_step_layer = lstm_step


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


# ---------------------------------------------------------------------------
# regression, ranking and the other costs


def cross_entropy_with_selfnorm_cost(input, label, name=None,
                                     softmax_selfnorm_alpha: float = 0.1,
                                     **kw) -> LayerOutput:
    return make_layer("cross_entropy_with_selfnorm", name, [input, label],
                      softmax_selfnorm_alpha=softmax_selfnorm_alpha)


def square_error_cost(input, label, weight=None, name=None,
                      **kw) -> LayerOutput:
    nodes = [input, label] + ([weight] if weight is not None else [])
    return make_layer("square_error", name, nodes)


mse_cost = square_error_cost
regression_cost = square_error_cost


def soft_binary_class_cross_entropy_cost(input, label, name=None, **kw):
    return make_layer("soft_binary_class_cross_entropy", name, [input, label])


def multi_binary_label_cross_entropy_cost(input, label, name=None, **kw):
    return make_layer("multi_binary_label_cross_entropy", name,
                      [input, label])


def rank_cost(left, right, label, weight=None, name=None,
              **kw) -> LayerOutput:
    nodes = [left, right, label] + ([weight] if weight is not None else [])
    return make_layer("rank-cost", name, nodes)


def lambda_cost(input, score, NDCG_num: int = 5, name=None,
                **kw) -> LayerOutput:
    return make_layer("lambda_cost", name, [input, score], NDCG_num=NDCG_num)


def huber_regression_cost(input, label, delta: float = 1.0, name=None, **kw):
    return make_layer("huber_regression", name, [input, label], delta=delta)


def huber_classification_cost(input, label, name=None, **kw) -> LayerOutput:
    return make_layer("huber_classification", name, [input, label])


def smooth_l1_cost(input, label, sigma: float = 1.0, name=None, **kw):
    return make_layer("smooth_l1", name, [input, label], sigma=sigma)


def sum_cost(input, name=None, **kw) -> LayerOutput:
    return make_layer("sum_cost", name, [input])


def nce(input, label, num_classes: int, num_neg_samples: int = 10,
        param_attr=None, bias_attr=None, name=None, **kw) -> LayerOutput:
    return make_layer("nce", name, [input, label], num_classes=num_classes,
                      num_neg_samples=num_neg_samples, param_attr=param_attr,
                      bias_attr=bias_attr)


nce_layer = nce


def hsigmoid(input, label, num_classes: int, param_attr=None, bias_attr=None,
             name=None, **kw) -> LayerOutput:
    nodes = _listify(input) + [label]
    return make_layer("hsigmoid", name, nodes, num_classes=num_classes,
                      param_attr=param_attr, bias_attr=bias_attr)


# ---------------------------------------------------------------------------
# id / sampling / generation helpers


def max_id(input, name=None, beam_size: int = 1, **kw) -> LayerOutput:
    return make_layer("maxid", name, [input], beam_size=beam_size)


maxid = max_id


def sampling_id(input, name=None, **kw) -> LayerOutput:
    return make_layer("sampling_id", name, [input])


def eos(input, eos_id: int, name=None, **kw) -> LayerOutput:
    return make_layer("eos_id", name, [input], eos_id=eos_id)


def multiplex(input, name=None, **kw) -> LayerOutput:
    return make_layer("multiplex", name, _listify(input))


# ---------------------------------------------------------------------------
# element-wise and feature utilities


def clip(input, min: float, max: float, name=None, **kw) -> LayerOutput:
    return make_layer("clip", name, [input], min=min, max=max)


def scale_shift(input, name=None, param_attr=None, bias_attr=None,
                **kw) -> LayerOutput:
    return make_layer("scale_shift", name, [input], param_attr=param_attr,
                      bias_attr=bias_attr)


def power(input, weight, name=None, **kw) -> LayerOutput:
    return make_layer("power", name, [weight, input])


def rotate(input, height=None, width=None, name=None, **kw) -> LayerOutput:
    return make_layer("rotate", name, [input], height=height, width=width)


def featmap_expand(input, num_filters: int, as_row_vector: bool = True,
                   name=None, **kw) -> LayerOutput:
    return make_layer("featmap_expand", name, [input],
                      num_filters=num_filters, as_row_vector=as_row_vector)


def data_norm(input, data_norm_strategy: str = "z-score", name=None,
              param_attr=None, **kw) -> LayerOutput:
    return make_layer("data_norm", name, [input],
                      data_norm_strategy=data_norm_strategy,
                      param_attr=param_attr)


def selective_fc(input, size: int, select=None, act=None, name=None,
                 param_attr=None, bias_attr=None, **kw) -> LayerOutput:
    inputs = _listify(input) + ([select] if select is not None else [])
    return make_layer("selective_fc", name, inputs, size=size,
                      act=act_mod.to_name(act), param_attr=param_attr,
                      bias_attr=bias_attr)


def row_conv(input, context_len: int, act=None, name=None, param_attr=None,
             **kw) -> LayerOutput:
    return make_layer("row_conv", name, [input], context_len=context_len,
                      act=act_mod.to_name(act), param_attr=param_attr)


def print_layer(input, format=None, name=None, **kw) -> LayerOutput:
    return make_layer("print", name, [input],
                      **({"format": format} if format else {}))


# ---------------------------------------------------------------------------
# bilinear, addressing and normalization types


def tensor(a, b, size: int, act=None, name=None, param_attr=None,
           bias_attr=None, **kw) -> LayerOutput:
    return make_layer("tensor", name, [a, b], size=size,
                      act=act_mod.to_name(act), param_attr=param_attr,
                      bias_attr=bias_attr)


tensor_layer = tensor


def conv_shift(a, b, name=None, **kw) -> LayerOutput:
    return make_layer("conv_shift", name, [a, b])


conv_shift_layer = conv_shift


def linear_comb(weights, vectors, size: int = None, name=None,
                **kw) -> LayerOutput:
    return make_layer("convex_comb", name, [weights, vectors], size=size)


linear_comb_layer = linear_comb
convex_comb_layer = linear_comb


def prelu(input, partial_sum: int = 1, name=None, param_attr=None,
          **kw) -> LayerOutput:
    return make_layer("prelu", name, [input], partial_sum=partial_sum,
                      param_attr=param_attr)


prelu_layer = prelu


def row_l2_norm(input, name=None, **kw) -> LayerOutput:
    return make_layer("row_l2_norm", name, [input])


row_l2_norm_layer = row_l2_norm


def switch_order(input, reshape_axis=None, height=None, width=None,
                 name=None, **kw) -> LayerOutput:
    return make_layer("switch_order", name, [input], height=height,
                      width=width)


switch_order_layer = switch_order


# ---------------------------------------------------------------------------
# SSD detection (priorbox_layer:1095, multibox_loss_layer:1141,
#  detection_output_layer:1214, cross_channel_norm_layer:1294)


def priorbox(input, image, aspect_ratio, variance, min_size, max_size=None,
             name=None, **kw) -> LayerOutput:
    return make_layer("priorbox", name, [input, image],
                      aspect_ratio=list(aspect_ratio),
                      variance=list(variance), min_size=list(min_size),
                      max_size=list(max_size or []))


def cross_channel_norm(input, name=None, param_attr=None, **kw) -> LayerOutput:
    return make_layer("cross_channel_norm", name, [input],
                      param_attr=param_attr)


def multibox_loss(input_loc, input_conf, priorbox, label, num_classes: int,
                  overlap_threshold: float = 0.5, neg_pos_ratio: float = 3.0,
                  neg_overlap: float = 0.5, background_id: int = 0,
                  name=None, **kw) -> LayerOutput:
    locs = _listify(input_loc)
    confs = _listify(input_conf)
    assert len(locs) == len(confs)
    return make_layer("multibox_loss", name,
                      [priorbox, label] + locs + confs,
                      input_num=len(locs), num_classes=num_classes,
                      overlap_threshold=overlap_threshold,
                      neg_pos_ratio=neg_pos_ratio, neg_overlap=neg_overlap,
                      background_id=background_id)


def detection_output(input_loc, input_conf, priorbox, num_classes: int,
                     nms_threshold: float = 0.45, nms_top_k: int = 400,
                     keep_top_k: int = 200,
                     confidence_threshold: float = 0.01,
                     background_id: int = 0, name=None, **kw) -> LayerOutput:
    locs = _listify(input_loc)
    confs = _listify(input_conf)
    assert len(locs) == len(confs)
    return make_layer("detection_output", name, [priorbox] + locs + confs,
                      input_num=len(locs), num_classes=num_classes,
                      nms_threshold=nms_threshold, nms_top_k=nms_top_k,
                      keep_top_k=keep_top_k,
                      confidence_threshold=confidence_threshold,
                      background_id=background_id)
