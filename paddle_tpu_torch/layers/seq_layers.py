"""Sequence layers — the port of ``paddle_tpu/layers/seq_layers.py``:
pooling (to a sample, or per subsequence of a nested input), first /
last instance, expand, concat, reshape, slice, reverse, the context
window projection, sub-sequence selection, the top-k positions of a
score sequence and the selection of subsequences of a nested input."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import sequence_ops as seq_ops


def topk_desc(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (``lax.top_k``'s order): a stable descending sort,
    since ``torch.topk`` on CUDA promises no order among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_layer("seqpool")
class SeqPoolLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        assert m.seq_level >= 1, "sequence pooling needs a sequence input"
        # agg_level 0 pools the whole sequence to a sample; on a nested
        # input any other level pools each subsequence (a level-1
        # sequence of pooled vectors)
        agg_level = cfg.get("agg_level", 0)
        out_level = 1 if (m.seq_level == 2 and agg_level != 0) else 0
        return LayerMeta(size=m.size, seq_level=out_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        ptype = cfg.get("pool_type", "average")
        if seq.is_nested and cfg.get("agg_level", 0) != 0:
            return seq_ops.sub_seq_pool(seq, ptype, cfg.get("max_segments"))
        return seq_ops.seq_pool(seq, ptype)


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


@register_layer("expand")
class ExpandLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[0].size,
                         seq_level=input_metas[1].seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x, like = inputs
        payload = x.data if isinstance(x, SequenceBatch) else x
        return seq_ops.expand_to_sequence(payload, like)


@register_layer("seqconcat")
class SeqConcatLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[0].size, seq_level=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return seq_ops.seq_concat(inputs[0], inputs[1])


@register_layer("seqreshape")
class SeqReshapeLayer:
    """SequenceReshapeLayer: [b, T, d] read as [b, T*d/size, size]."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=cfg["reshape_size"], seq_level=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        ns = cfg["reshape_size"]
        b, T, d = seq.data.shape[0], seq.data.shape[1], seq.data.shape[-1]
        assert (T * d) % ns == 0, "seq reshape size must divide T*d"
        return SequenceBatch(seq.data.reshape(b, T * d // ns, ns),
                             ((seq.lengths * d) // ns).to(torch.int32))


@register_layer("seqslice")
class SeqSliceLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq = inputs[0]
        starts = inputs[1] if len(inputs) > 1 else None
        ends = inputs[2] if len(inputs) > 2 else None
        s = starts[..., 0].to(torch.int32) if starts is not None else \
            torch.zeros((seq.batch_size,), dtype=torch.int32,
                        device=seq.lengths.device)
        e = ends[..., 0].to(torch.int32) if ends is not None \
            else seq.lengths
        return seq_ops.seq_slice(seq, s, e)


@register_layer("seqreverse")
class SeqReverseLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        return seq_ops.seq_reverse(inputs[0])


@register_layer("context_projection")
class ContextProjectionLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        clen = cfg["context_len"]
        specs = []
        if cfg.get("trainable_padding"):
            cstart = cfg.get("context_start", -(clen // 2))
            n_pad = max(0, -cstart) + max(0, cstart + clen - 1)
            a = ParamAttr.of(cfg.get("param_attr"))
            pname = a.name or f"_{name}.w0"
            specs = [ParamSpec(pname, (max(n_pad, 1), m.size),
                               initializers.zeros, a)]
            cfg["_pad_name"] = pname
        return LayerMeta(size=m.size * clen, seq_level=1), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        clen = cfg["context_len"]
        cstart = cfg.get("context_start", -(clen // 2))
        pad = params.get(cfg.get("_pad_name")) if cfg.get("_pad_name") \
            else None
        return seq_ops.context_projection(inputs[0], clen, cstart, pad)


def _first_col(v):
    x = v.data if isinstance(v, SequenceBatch) else v
    return x.reshape(x.shape[0], -1)[:, 0].to(torch.int32)


@register_layer("subseq")
class SubSeqLayer:
    """SubSequenceLayer: a per-row slice from offset and size inputs."""
    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        return LayerMeta(size=m.size, seq_level=m.seq_level), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq, offsets, sizes = inputs
        off = _first_col(offsets)
        return seq_ops.seq_slice(seq, off, off + _first_col(sizes))


def _pad_k(idx: torch.Tensor, k: int) -> torch.Tensor:
    if idx.shape[-1] < k:
        idx = torch.nn.functional.pad(idx, (0, k - idx.shape[-1]), value=-1)
    return idx


@register_layer("kmax_seq_score")
class KmaxSeqScoreLayer:
    """Top-k positions of per-step scores within each sequence: [b, k]
    int32 position ids, -1 past the sequence's length. On a nested
    input, one row of top-k ids per subsequence, relative to the
    subsequence's start: a [b, R, k] SequenceBatch over subsequences."""
    @staticmethod
    def build(name, cfg, input_metas):
        lvl = 1 if input_metas[0].seq_level == 2 else 0
        return LayerMeta(size=cfg.get("beam_size", 1), seq_level=lvl,
                         is_integer=True), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        k = cfg.get("beam_size", 1)
        T = seq.max_len
        scores = seq.data.reshape(seq.batch_size, T)
        ninf = torch.full((), float("-inf"), dtype=scores.dtype,
                          device=scores.device)
        if seq.is_nested:
            rows = torch.arange(T, device=scores.device)
            eq = seq.segment_ids.long()[:, None, :] == rows[None, :, None]
            per_row = torch.where(eq, scores[:, None, :], ninf)  # [b, R, T]
            vals, idx = topk_desc(per_row, min(k, T))
            start = torch.argmax(eq.to(torch.int32), dim=2)      # [b, R]
            rel = torch.where(torch.isfinite(vals), idx - start[..., None],
                              -1).to(torch.int32)
            return SequenceBatch(_pad_k(rel, k), seq.num_segments)
        scores = torch.where(seq.bool_mask(), scores, ninf)
        vals, idx = topk_desc(scores, min(k, T))
        return _pad_k(torch.where(torch.isfinite(vals), idx, -1)
                      .to(torch.int32), k)


@register_layer("sub_nested_seq")
class SubNestedSeqLayer:
    """Select subsequences of a nested sequence by index: input 1 holds
    the selected segment indices [b, k] (-1: unused). The output keeps
    only those subsequences, renumbered 0..k'-1 in selection order and
    packed to the front of the time axis."""
    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=input_metas[0].size, seq_level=2), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        assert seq.is_nested, "sub_nested_seq needs a nested sequence input"
        sel = inputs[1]
        sel = sel.data if isinstance(sel, SequenceBatch) else sel
        sel = sel.reshape(sel.shape[0], -1).long()               # [b, k]
        T = seq.max_len
        segs = seq.segment_ids.long()
        dev = segs.device
        eq = (segs[:, None, :] == sel[:, :, None]) & \
            (sel[:, :, None] >= 0) & (segs[:, None, :] >= 0)     # [b, k, T]
        hit = eq.any(dim=1)
        nj = torch.where(hit, torch.argmax(eq.to(torch.int32), dim=1), -1)
        seg_len = eq.sum(dim=2)                                  # [b, k]
        offset = torch.cumsum(seg_len, dim=1) - seg_len
        first = torch.argmax(eq.to(torch.int32), dim=2)          # [b, k]
        njc = torch.clamp(nj, min=0)
        rank = torch.arange(T, device=dev)[None, :] - \
            torch.gather(first, 1, njc)
        newpos = torch.where(nj >= 0, torch.gather(offset, 1, njc) + rank, T)
        data = seq_ops._scatter_rows(seq.data, newpos, T)
        out_segs = seq_ops._scatter_rows(nj.to(torch.int32), newpos, T,
                                         fill=-1)
        return SequenceBatch(data, seg_len.sum(dim=1).to(torch.int32),
                             out_segs, (sel >= 0).sum(dim=1)
                             .to(torch.int32))
