"""SSD detection layers — the port of
``paddle_tpu/layers/detection_layers.py``: ``priorbox``,
``cross_channel_norm``, ``multibox_loss`` and ``detection_output``.

Reference: paddle/gserver/layers/{PriorBox.cpp, MultiBoxLossLayer.cpp,
DetectionOutputLayer.cpp, CrossChannelNormLayer.cpp}.

The loc and conf heads arrive as NHWC images and are flattened from
NHWC, so the prior order is (row, column, prior), the order
``prior_boxes`` emits (the reference permutes NCHW to NHWC before it
flattens). The JAX package ``vmap``s the loss and the output over the
images; here both run batched on a leading image axis, and the
detection output's NMS runs every (image, class) pair in one loop
(``ops.detection.batched_nms``). The loss and the output compute in
float32 whatever the heads' dtype (bf16 under ``compute_dtype
"bfloat16"``): the loss sums thousands of per-prior terms. Detection
output is a fixed [b, keep_top_k * 7] tensor of (image_id, label,
score, xmin, ymin, xmax, ymax) rows, label -1 on padded rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.conv_layers import ensure_nhwc
from paddle_tpu_torch.layers.seq_layers import topk_desc
from paddle_tpu_torch.ops import detection as det_ops


def _payload(v):
    return v.data if isinstance(v, SequenceBatch) else v


@register_layer("priorbox")
class PriorBoxLayer:
    """SSD anchors of one feature map (PriorBox.cpp:34-106), the same
    row for every image of the batch."""

    @staticmethod
    def build(name, cfg, input_metas):
        m, img = input_metas
        n_ratio_boxes = sum(2 for r in cfg["aspect_ratio"]
                            if abs(r - 1.0) >= 1e-6)
        n_priors = (len(cfg["min_size"]) * (1 + len(cfg.get("max_size", [])))
                    + n_ratio_boxes)
        cfg["_n_priors"] = n_priors
        cfg["_lh"], cfg["_lw"] = m.height, m.width
        cfg["_ih"], cfg["_iw"] = img.height, img.width
        size = m.height * m.width * n_priors * 8
        return LayerMeta(size=size), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = _payload(inputs[0])
        pb = det_ops.cached_prior_boxes(
            cfg["_lh"], cfg["_lw"], cfg["_ih"], cfg["_iw"],
            tuple(cfg["min_size"]), tuple(cfg.get("max_size", [])),
            tuple(cfg["aspect_ratio"]), tuple(cfg["variance"]), x.device)
        return pb.reshape(1, -1).expand(x.shape[0], -1)


@register_layer("cross_channel_norm")
class CrossChannelNormLayer:
    """Per-position L2 norm across channels with a learned per-channel
    scale [C], initialized to 20 (CrossChannelNormLayer.cpp — SSD's
    conv4_3 normalization)."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        a = ParamAttr.of(cfg.get("param_attr"))
        pname = a.name or f"_{name}.w0"
        cfg["_w_name"] = pname
        cfg["_ic"], cfg["_ih"], cfg["_iw"] = m.channels, m.height, m.width
        specs = [ParamSpec(pname, (m.channels,),
                           a.initializer or initializers.constant(20.0), a)]
        return (LayerMeta(size=m.size, height=m.height, width=m.width,
                          channels=m.channels), specs, [])

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x = ensure_nhwc(_payload(inputs[0]), cfg["_ic"], cfg["_ih"],
                        cfg["_iw"])
        scale = params[cfg["_w_name"]]
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-10)
        return x / norm * scale


def _gather_heads(cfg, inputs, start, n, per_box, shapes_key):
    """Flatten n NHWC head outputs into [b, total_priors, per_box], in
    float32."""
    parts = []
    for i in range(n):
        x = ensure_nhwc(_payload(inputs[start + i]), *cfg[shapes_key][i])
        parts.append(x.reshape(x.shape[0], -1, per_box))
    return torch.cat(parts, dim=1).float()


def _priors_from_input(val):
    return _payload(val)[0].reshape(-1, 8)   # the same for every image


def _label_column(logp: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """logp[..., cls] as JAX's ``take_along_axis`` reads it: a negative
    class counts from the end, and one still out of range reads NaN."""
    c = logp.shape[-1]
    cls = torch.where(cls < 0, cls + c, cls)
    ok = (cls >= 0) & (cls < c)
    got = torch.gather(logp, -1, cls.clamp(0, c - 1)[..., None])[..., 0]
    return torch.where(ok, got, torch.full_like(got, float("nan")))


def _box_heads(cfg, input_metas, start):
    n = cfg["input_num"]
    cfg["_loc_shapes"] = [(m.channels, m.height, m.width)
                          for m in input_metas[start:start + n]]
    cfg["_conf_shapes"] = [(m.channels, m.height, m.width)
                           for m in input_metas[start + n:start + 2 * n]]


def hard_negatives(ce: torch.Tensor, neg_cand: torch.Tensor,
                   n_neg: torch.Tensor) -> torch.Tensor:
    """SSD's hard-negative mining: of each image's candidates (neg_cand
    [b, P]), the n_neg [b] with the highest conf loss (ce [b, P]), as a
    [b, P] mask. The rank comes from a stable sort, so ties go to the
    lower prior index, as the JAX package's ``argsort``."""
    with torch.no_grad():
        neg_score = torch.where(neg_cand, ce,
                                torch.full_like(ce, -float("inf")))
        order = torch.sort(-neg_score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(ce.shape[1], device=order.device)
            .expand_as(order))
    return neg_cand & (rank < n_neg[:, None])


@register_layer("multibox_loss")
class MultiBoxLossLayer:
    """SSD training loss (MultiBoxLossLayer.cpp): prior/gt matching,
    smooth-L1 loc loss on the matched priors, softmax conf loss on the
    positives and the hard-mined negatives, over max(n_pos, 1).

    Inputs: [priorbox, label, loc..., conf...]; label is a SequenceBatch
    of per-image gt rows (label_id, xmin, ymin, xmax, ymax,
    [difficult]). Output: [b, 1]."""

    @staticmethod
    def build(name, cfg, input_metas):
        _box_heads(cfg, input_metas, 2)
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        n = cfg["input_num"]
        bg = cfg.get("background_id", 0)
        priors = _priors_from_input(inputs[0]).float()    # [P, 8]
        label: SequenceBatch = inputs[1]
        loc = _gather_heads(cfg, inputs, 2, n, 4, "_loc_shapes")  # [b, P, 4]
        conf = _gather_heads(cfg, inputs, 2 + n, n, cfg["num_classes"],
                             "_conf_shapes")
        gt = label.data.float()
        gt_boxes = gt[..., 1:5]                           # [b, G, 4]
        gt_labels = gt[..., 0].long()                     # truncated
        gt_valid = label.bool_mask()                      # [b, G]

        midx, miou = det_ops.batched_match_priors(
            priors, gt_boxes, gt_valid,
            overlap_threshold=cfg.get("overlap_threshold", 0.5))
        pos = midx >= 0
        n_pos = torch.sum(pos, dim=1)
        safe = midx.clamp(min=0)
        # localization: smooth L1 on the matched priors
        matched = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
        targets = det_ops.encode_boxes(matched, priors)
        loc_loss = torch.sum(torch.where(
            pos[..., None], det_ops.smooth_l1(loc - targets),
            torch.zeros_like(loc)), dim=(1, 2))
        # confidence: softmax CE, the matched label on positives and the
        # background on the hard-mined negatives
        tgt_cls = torch.where(pos, torch.gather(gt_labels, 1, safe),
                              torch.full_like(safe, bg))
        ce = -_label_column(F.log_softmax(conf, dim=-1), tgt_cls)
        neg_cand = (~pos) & (miou < cfg.get("neg_overlap", 0.5))
        n_neg = torch.minimum(
            (cfg.get("neg_pos_ratio", 3.0) * n_pos.float()).long(),
            torch.sum(neg_cand, dim=1))
        neg_sel = hard_negatives(ce, neg_cand, n_neg)
        conf_loss = torch.sum(torch.where(pos | neg_sel, ce,
                                          torch.zeros_like(ce)), dim=1)
        denom = torch.clamp(n_pos.to(loc_loss.dtype), min=1.0)
        return ((loc_loss + conf_loss) / denom)[:, None]


@register_layer("detection_output")
class DetectionOutputLayer:
    """Decode, per-class NMS and keep-top-k (DetectionOutputLayer.cpp).

    Inputs: [priorbox, loc..., conf...]. Output [b, keep_top_k * 7]
    rows of (image_id, label, score, xmin, ymin, xmax, ymax); a row
    whose score is not positive, or past the candidates, is
    (image_id, -1, 0, 0, 0, 0, 0)."""

    @staticmethod
    def build(name, cfg, input_metas):
        _box_heads(cfg, input_metas, 1)
        return LayerMeta(size=cfg.get("keep_top_k", 200) * 7), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        n = cfg["input_num"]
        num_classes = cfg["num_classes"]
        bg = cfg.get("background_id", 0)
        keep_top_k = cfg.get("keep_top_k", 200)
        priors = _priors_from_input(inputs[0]).float()
        loc = _gather_heads(cfg, inputs, 1, n, 4, "_loc_shapes")
        conf = _gather_heads(cfg, inputs, 1 + n, n, num_classes,
                             "_conf_shapes")
        probs = torch.softmax(conf, dim=-1)                 # [b, P, C]
        decoded = det_ops.decode_boxes(loc, priors)         # [b, P, 4]
        b, P = probs.shape[:2]
        classes = [c for c in range(num_classes) if c != bg]
        nc = len(classes)
        scores = probs[..., classes].transpose(1, 2).reshape(b * nc, P)
        boxes = decoded[:, None].expand(b, nc, P, 4).reshape(b * nc, P, 4)
        cand, sc, keep = det_ops.batched_nms(
            boxes, scores, iou_threshold=cfg.get("nms_threshold", 0.45),
            score_threshold=cfg.get("confidence_threshold", 0.01),
            top_k=cfg.get("nms_top_k", 400))
        K = sc.shape[-1]
        cls = torch.tensor(classes, dtype=sc.dtype, device=sc.device)
        # row r of the NMS is image r // nc, class classes[r % nc]
        lab = torch.where(keep, cls.repeat(b)[:, None].expand(b * nc, K),
                          torch.full_like(sc, -1.0))
        rows = torch.cat([lab[..., None], sc[..., None], cand], dim=-1) \
            .reshape(b, nc * K, 6)
        k = min(keep_top_k, nc * K)
        top_scores, order = topk_desc(rows[..., 1], k)
        sel = torch.gather(rows, 1, order[..., None].expand(b, k, 6))
        pad = torch.zeros(6, dtype=sel.dtype, device=sel.device)
        pad[0] = -1.0
        sel = torch.where(top_scores[..., None] > 0, sel, pad)
        if k < keep_top_k:
            sel = torch.cat([sel, pad.expand(b, keep_top_k - k, 6)], dim=1)
        img_id = torch.arange(b, dtype=sel.dtype, device=sel.device)
        out = torch.cat([img_id[:, None, None].expand(b, keep_top_k, 1), sel],
                        dim=-1)
        return out.reshape(b, keep_top_k * 7)
