"""Id helpers of generation — the port of ``maxid``, ``sampling_id``
and ``eos_id`` of ``paddle_tpu/layers/misc_layers.py`` (the file's
other layers wait for queue A.7)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import LayerMeta, register_layer
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.base import _map_seq, _payload
from paddle_tpu_torch.layers.seq_layers import topk_desc


@register_layer("maxid")
class MaxIdLayer:
    """The argmax id of each row, or its beam_size top ids (ties to the
    lower id)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=cfg.get("beam_size", 1), seq_level=m.seq_level,
                         is_integer=True), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        k = cfg.get("beam_size", 1)

        def top(x):
            if k == 1:
                return torch.argmax(x, dim=-1).to(torch.int32)[..., None]
            return topk_desc(x, k)[1].to(torch.int32)

        return _map_seq(top, inputs[0])


@register_layer("sampling_id")
class SamplingIdLayer:
    """One id drawn from each row's distribution in a train step, from
    the layer's own generator (``ctx.rng_for``); the argmax in test
    mode, so test passes stay deterministic."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=1, seq_level=m.seq_level, is_integer=True), \
            [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        def sample(x):
            logits = torch.log(torch.clamp(x, min=1e-20))
            if not ctx.is_train:
                return torch.argmax(logits, dim=-1).to(torch.int32)[..., None]
            flat = torch.softmax(logits.reshape(-1, logits.shape[-1]).float(),
                                 dim=-1)
            ids = torch.multinomial(flat, 1,
                                    generator=ctx.rng_for(name, x.device))
            return ids.reshape(logits.shape[:-1] + (1,)).to(torch.int32)

        return _map_seq(sample, inputs[0])


@register_layer("eos_id")
class EosIdCheckLayer:
    """1.0 where the input id equals eos_id."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=1, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        val = inputs[0]
        ids = _payload(val)
        # id payloads are [b] / [b, T] (or already [.., 1] from maxid):
        # the output always has a trailing size-1 feature axis
        if ids.dim() == (2 if isinstance(val, SequenceBatch) else 1):
            ids = ids[..., None]
        out = (ids == cfg["eos_id"]).to(torch.float32)
        return val.with_data(out) if isinstance(val, SequenceBatch) else out
