"""Cost layers — the port of the ``multi-class-cross-entropy`` and
``classification_error`` layers of ``paddle_tpu/layers/cost_layers.py``.
A cost layer outputs per-sample loss [batch]; a sequence prediction
sums its per-position costs over the valid positions.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import LayerMeta, register_layer
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


@register_layer("classification_error")
class ClassificationErrorLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return _seq_or_sample_cost(cost_ops.classification_error,
                                   inputs[0], inputs[1])
