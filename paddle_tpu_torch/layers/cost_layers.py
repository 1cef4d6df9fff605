"""Cost layers — the port of ``paddle_tpu/layers/cost_layers.py``:
``multi-class-cross-entropy``, ``square_error``,
``soft_binary_class_cross_entropy``, ``multi_binary_label_cross_entropy``,
``rank-cost``, ``lambda_cost``, ``huber_regression``,
``huber_classification``, ``smooth_l1``, ``sum_cost``,
``cross_entropy_with_selfnorm``, ``nce``, ``hsigmoid`` and
``classification_error``. A cost layer outputs per-sample loss
[batch]; a sequence prediction sums its per-position costs over the
valid positions.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import cost as cost_ops


def _payload(v):
    return v.data if isinstance(v, SequenceBatch) else v


def _flatten_seq_cost(per_pos, seq: SequenceBatch, average: bool = False):
    """Reduce per-position costs [b, T] over valid positions -> [b]."""
    m = seq.mask(per_pos.dtype)
    tot = torch.sum(per_pos * m, dim=1)
    if average:
        tot = tot / torch.clamp(torch.sum(m, dim=1), min=1.0)
    return tot


def _seq_or_sample_cost(fn, pred, label):
    """Apply a per-row cost either per sample or per (valid) timestep."""
    if isinstance(pred, SequenceBatch):
        per_pos = fn(pred.data, _payload(label))
        return _flatten_seq_cost(per_pos, pred)
    return fn(_payload(pred), _payload(label))


@register_layer("multi-class-cross-entropy")
class CrossEntropyCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        pred, label = inputs[0], inputs[1]

        def fn(p, l):
            return cost_ops.cross_entropy(
                p, l, from_logits=cfg.get("from_logits", False),
                label_smoothing=cfg.get("label_smoothing", 0.0))

        w = inputs[2] if len(inputs) > 2 else None
        if isinstance(pred, SequenceBatch) and isinstance(w, SequenceBatch):
            # per-token weights, applied before the reduction
            per_pos = fn(pred.data, _payload(label))
            per_pos = per_pos * w.data.reshape(per_pos.shape)
            return _flatten_seq_cost(per_pos, pred)
        out = _seq_or_sample_cost(fn, pred, label)
        if w is not None:
            out = out * _payload(w).reshape(out.shape)
        return out


@register_layer("square_error")
class SquareErrorCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        out = _seq_or_sample_cost(cost_ops.square_error, inputs[0], inputs[1])
        if len(inputs) > 2:
            out = out * _payload(inputs[2]).reshape(out.shape)
        return out


@register_layer("soft_binary_class_cross_entropy")
class SoftBinaryCECost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(cost_ops.soft_binary_class_cross_entropy,
                                   inputs[0], inputs[1])


@register_layer("multi_binary_label_cross_entropy")
class MultiBinaryLabelCECost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(cost_ops.multi_binary_label_cross_entropy,
                                   inputs[0], inputs[1])


@register_layer("rank-cost")
class RankCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        left, right, label = inputs[0], inputs[1], inputs[2]
        w = _payload(inputs[3]) if len(inputs) > 3 else None
        return cost_ops.rank_cost(_payload(left), _payload(right),
                                  _payload(label), w)


@register_layer("lambda_cost")
class LambdaCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        scores, rel = inputs[0], inputs[1]
        assert isinstance(scores, SequenceBatch), \
            "lambda_cost expects a sequence of document scores per query"
        s = scores.data[..., 0]
        r = _payload(rel)
        r = r[..., 0] if r.dim() == 3 else r
        return cost_ops.lambda_cost(s, r, scores.mask(s.dtype),
                                    cfg.get("NDCG_num", 5))


@register_layer("huber_regression")
class HuberRegressionCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(
            lambda p, l: cost_ops.huber_regression(p, l,
                                                   cfg.get("delta", 1.0)),
            inputs[0], inputs[1])


@register_layer("huber_classification")
class HuberClassificationCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return cost_ops.huber_classification(_payload(inputs[0]),
                                             _payload(inputs[1]))


@register_layer("smooth_l1")
class SmoothL1Cost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(
            lambda p, l: cost_ops.smooth_l1(p, l, cfg.get("sigma", 1.0)),
            inputs[0], inputs[1])


@register_layer("sum_cost")
class SumCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        v = inputs[0]
        if isinstance(v, SequenceBatch):
            return _flatten_seq_cost(torch.sum(v.data, dim=-1), v)
        return cost_ops.sum_cost(v)


@register_layer("cross_entropy_with_selfnorm")
class CrossEntropySelfNormCost:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(
            lambda p, l: cost_ops.cross_entropy_with_selfnorm(
                p, l, cfg.get("softmax_selfnorm_alpha", 0.1)),
            inputs[0], inputs[1])


def nce_sample_ids(ctx, name: str, batch: int, k: int, num_classes: int,
                   device) -> torch.Tensor:
    """The ``nce`` layer's noise draw: [batch, k] uniform class ids from
    the layer's own generator of this step (``ctx.rng_for``), in test
    mode as well, as the JAX package draws them."""
    return torch.randint(0, num_classes, (batch, k), device=device,
                         generator=ctx.rng_for(name, device))


@register_layer("nce")
class NCELayer:
    @staticmethod
    def build(name, cfg, input_metas):
        num_classes = cfg["num_classes"]
        feat_dim = input_metas[0].size
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        specs = [ParamSpec(wname, (num_classes, feat_dim),
                           a.initializer or initializers.smart_normal(1), a)]
        cfg["_w_name"] = wname
        battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                             else cfg.get("bias_attr"))
        bname = battr.name or f"_{name}.wbias"
        specs.append(ParamSpec(bname, (num_classes,), initializers.zeros,
                               battr))
        cfg["_b_name"] = bname
        return LayerMeta(size=1), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        feats, labels = _payload(inputs[0]), _payload(inputs[1])
        nc = cfg["num_classes"]
        sample_ids = nce_sample_ids(ctx, name, feats.shape[0],
                                    cfg.get("num_neg_samples", 10), nc,
                                    feats.device)
        return cost_ops.nce_loss(feats, params[cfg["_w_name"]],
                                 params[cfg["_b_name"]], labels, sample_ids,
                                 nc)


@register_layer("hsigmoid")
class HSigmoidLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        num_classes = cfg["num_classes"]
        feat_dim = sum(m.size for m in input_metas[:-1])  # last = label
        a = ParamAttr.of(cfg.get("param_attr"))
        wname = a.name or f"_{name}.w0"
        specs = [ParamSpec(wname, (max(num_classes - 1, 1), feat_dim),
                           a.initializer or initializers.smart_normal(1), a)]
        cfg["_w_name"] = wname
        battr = ParamAttr.of(None if cfg.get("bias_attr") in (True, None)
                             else cfg.get("bias_attr"))
        bname = battr.name or f"_{name}.wbias"
        specs.append(ParamSpec(bname, (max(num_classes - 1, 1),),
                               initializers.zeros, battr))
        cfg["_b_name"] = bname
        return LayerMeta(size=1), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        feats = torch.cat([_payload(v) for v in inputs[:-1]], dim=-1)
        labels = _payload(inputs[-1])
        return cost_ops.hsigmoid_loss(feats, params[cfg["_w_name"]],
                                      params[cfg["_b_name"]], labels,
                                      cfg["num_classes"])


@register_layer("classification_error")
class ClassificationErrorLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(cost_ops.classification_error,
                                   inputs[0], inputs[1])
