"""Sequence layers — the port of the ``seqpool`` and ``seqlastins``
layers of ``paddle_tpu/layers/seq_layers.py`` (nested sequences wait)."""

from __future__ import annotations

from paddle_tpu_torch.core.registry import LayerMeta, register_layer
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import sequence_ops as seq_ops


@register_layer("seqpool")
class SeqPoolLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        assert m.seq_level >= 1, "sequence pooling needs a sequence input"
        agg_level = cfg.get("agg_level", 0)
        if m.seq_level == 2 and agg_level != 0:
            raise NotImplementedError("pooling nested sequences to "
                                      "sequences is not ported yet")
        return LayerMeta(size=m.size, seq_level=0), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        return seq_ops.seq_pool(seq, cfg.get("pool_type", "average"))


@register_layer("seqlastins")
class SeqLastInsLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=max(m.seq_level - 1, 0)), \
            [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        if cfg.get("first"):
            return seq_ops.first_instance(seq)
        return seq_ops.last_instance(seq)
