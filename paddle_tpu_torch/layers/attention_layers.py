"""Multi-head dot-product attention layer — the port of
``paddle_tpu/layers/attention_layers.py``.

On a CUDA card, with ``use_flash_attention`` on and a shape the kernels
take (``flash_supported``), attention runs the hand-written Hopper
flash kernels (ops/flash_attention.py), forward and backward. Anywhere
else it runs the plain version, which computes the same function as
both branches of the JAX layer (the masked XLA attention it takes off
the TPU, and its flash kernel). As in the JAX layer, only
``kv_lens=ks.lengths`` is passed: rows past a sequence's length still
attend to its valid columns, and the cost layer masks them.

Ring attention over a mesh ``sp`` axis comes with the parallelism
slice.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import (LayerMeta, make_layer,
                                            register_layer)


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


@register_layer("dot_product_attention")
class DotProductAttentionLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        q, k, v = input_metas
        assert q.seq_level >= 1 and k.seq_level >= 1 and v.seq_level >= 1, \
            "attention inputs must be sequences"
        h = cfg.get("num_heads", 1)
        kv_h = cfg.get("num_kv_heads") or h
        assert h % kv_h == 0, \
            f"num_heads={h} must be a multiple of num_kv_heads={kv_h}"
        assert q.size % h == 0 and k.size % kv_h == 0 \
            and v.size % kv_h == 0, \
            f"head counts ({h}, kv {kv_h}) must divide q/k/v sizes " \
            f"({q.size}, {k.size}, {v.size})"
        assert q.size // h == k.size // kv_h, \
            "q and k head dims must match"
        return LayerMeta(size=(v.size // kv_h) * h, seq_level=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        from paddle_tpu_torch.config import global_config
        from paddle_tpu_torch.ops import flash_attention as flash
        qs, ks, vs = inputs
        h = cfg.get("num_heads", 1)
        kv_h = cfg.get("num_kv_heads") or h
        causal = cfg.get("causal", False)
        if getattr(ctx, "mesh", None) is not None:
            raise NotImplementedError(
                "ring attention over a mesh sp axis is not ported yet "
                "(the parallelism slice)")
        q = _split_heads(qs.data, h)
        k = _split_heads(ks.data, kv_h)
        v = _split_heads(vs.data, kv_h)
        if kv_h != h:
            # grouped-query attention: each k/v head serves h/kv_h query
            # heads — repeated to full width for the kernels
            k = torch.repeat_interleave(k, h // kv_h, dim=2)
            v = torch.repeat_interleave(v, h // kv_h, dim=2)
        if (q.device.type == "cuda" and global_config().use_flash_attention
                and flash.flash_supported(q, k)):
            out = flash.flash_attention(q, k, v, kv_lens=ks.lengths,
                                        causal=causal)
        else:
            out = flash.flash_attention_reference(q, k, v,
                                                  kv_lens=ks.lengths,
                                                  causal=causal)
        return qs.with_data(_merge_heads(out))


def dot_product_attention(query, key=None, value=None, num_heads: int = 1,
                          num_kv_heads=None, causal: bool = False,
                          name=None, **kw):
    """Multi-head scaled-dot-product attention over sequences
    (key/value default to query — self-attention; num_kv_heads <
    num_heads is grouped-query attention)."""
    key = key if key is not None else query
    value = value if value is not None else key
    opts = {"num_kv_heads": num_kv_heads} if num_kv_heads else {}
    return make_layer("dot_product_attention", name, [query, key, value],
                      num_heads=num_heads, causal=causal, **opts)


multi_head_attention = dot_product_attention
