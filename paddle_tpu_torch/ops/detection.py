"""SSD-style detection ops — the port of ``paddle_tpu/ops/detection.py``:
prior boxes, box encode/decode, IoU, prior matching, greedy NMS and
smooth L1.

Reference: paddle/gserver/layers/PriorBox.cpp, DetectionUtil.cpp
(decodeBBox, encodeBBoxWithVar, matchBBox) and DetectionOutputLayer.cpp.

Every op is fixed-shape, as in the JAX package. The plain forms
(``iou_matrix``, ``match_priors``, ``nms``) take one image and stay the
spec the tests hold; the batched forms (``batched_iou``,
``batched_match_priors``, ``batched_nms``) take a leading batch axis and
are what the layers run, so no Python loop walks the images or the
classes. Two orders are the JAX package's on purpose:

- ties: ``lax.top_k`` and ``argsort`` keep tied values lowest index
  first, and ``torch.topk`` promises no order among them, so every
  top-k here and in the detection layers is a stable descending sort,
  then a slice (``layers.seq_layers.topk_desc``);
- duplicate claims in matching: two ground-truth boxes with one best
  prior — JAX's drop-mode scatter keeps the last writer, the highest gt
  index. ``scatter_`` leaves duplicates undefined (and on CUDA
  nondeterministic), so the claim is a ``scatter_reduce("amax")`` of
  the gt indices.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch


def _shapes(min_sizes, max_sizes, aspect_ratios):
    """Per-cell (w, h) box shapes in pixels, in the reference's emission
    order (PriorBox.cpp:103-130)."""
    shapes = []
    for s in min_sizes:
        shapes.append((s, s))
        for m in max_sizes:
            d = math.sqrt(s * m)
            shapes.append((d, d))
    base = min_sizes[-1]
    for r in aspect_ratios:
        if abs(r - 1.0) < 1e-6:
            continue
        for ar in (r, 1.0 / r):
            shapes.append((base * math.sqrt(ar), base / math.sqrt(ar)))
    return shapes


def prior_boxes(layer_h: int, layer_w: int, image_h: int, image_w: int,
                min_sizes: Sequence[float], max_sizes: Sequence[float],
                aspect_ratios: Sequence[float], variance: Sequence[float],
                clip: bool = True, device=None) -> torch.Tensor:
    """SSD prior boxes of one feature map: [layer_h * layer_w * np, 8],
    each row (xmin, ymin, xmax, ymax, var0..var3) normalized to [0, 1],
    cells in (row, column) order and the priors of a cell in the
    reference's order. The step is image / map, as in the JAX package."""
    assert len(variance) == 4
    step_w = image_w / layer_w
    step_h = image_h / layer_h
    shapes = torch.tensor(_shapes(min_sizes, max_sizes, aspect_ratios),
                          dtype=torch.float32, device=device)   # [np, 2]
    n_priors = shapes.shape[0]
    cx = (torch.arange(layer_w, dtype=torch.float32, device=device)
          + 0.5) * step_w
    cy = (torch.arange(layer_h, dtype=torch.float32, device=device)
          + 0.5) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")         # [h, w]
    cxg = cxg[..., None]
    cyg = cyg[..., None]
    bw = shapes[None, None, :, 0]
    bh = shapes[None, None, :, 1]
    xmin = (cxg - bw / 2.0) / image_w
    ymin = (cyg - bh / 2.0) / image_h
    xmax = (cxg + bw / 2.0) / image_w
    ymax = (cyg + bh / 2.0) / image_h
    boxes = torch.stack([xmin, ymin, xmax, ymax], dim=-1)    # [h, w, np, 4]
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(list(variance), dtype=torch.float32,
                       device=device).expand(boxes.shape)
    out = torch.cat([boxes, var], dim=-1)
    return out.reshape(layer_h * layer_w * n_priors, 8)


@functools.lru_cache(maxsize=64)
def cached_prior_boxes(layer_h, layer_w, image_h, image_w, min_sizes,
                       max_sizes, aspect_ratios, variance,
                       device) -> torch.Tensor:
    """``prior_boxes`` made once per map and device (the priors depend on
    the configuration only); the arguments are tuples. Read only."""
    return prior_boxes(layer_h, layer_w, image_h, image_w, min_sizes,
                       max_sizes, aspect_ratios, variance, device=device)


def _center_form(boxes: torch.Tensor):
    """(xmin, ymin, xmax, ymax) -> (cx, cy, w, h)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return cx, cy, w, h


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Predicted offsets [..., P, 4] against priors [P, 8] -> corner-form
    boxes [..., P, 4] (DetectionUtil decodeBBox)."""
    pcx, pcy, pw, ph = _center_form(priors[..., :4])
    var = priors[..., 4:]
    cx = var[..., 0] * loc[..., 0] * pw + pcx
    cy = var[..., 1] * loc[..., 1] * ph + pcy
    w = torch.exp(torch.clamp(var[..., 2] * loc[..., 2], -10.0, 10.0)) * pw
    h = torch.exp(torch.clamp(var[..., 3] * loc[..., 3], -10.0, 10.0)) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Ground-truth corner boxes -> regression targets, the inverse of
    ``decode_boxes`` (DetectionUtil encodeBBoxWithVar)."""
    pcx, pcy, pw, ph = _center_form(priors[..., :4])
    var = priors[..., 4:]
    gcx, gcy, gw, gh = _center_form(gt)
    eps = 1e-8
    dx = (gcx - pcx) / torch.clamp(pw, min=eps) / var[..., 0]
    dy = (gcy - pcy) / torch.clamp(ph, min=eps) / var[..., 1]
    dw = torch.log(torch.clamp(gw, min=eps) / torch.clamp(pw, min=eps)) \
        / var[..., 2]
    dh = torch.log(torch.clamp(gh, min=eps) / torch.clamp(ph, min=eps)) \
        / var[..., 3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def batched_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of corner boxes: a [..., N, 4], b [..., M, 4] ->
    [..., N, M] (leading axes broadcast)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros_like(inter))


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: [N, 4], b: [M, 4] corner boxes -> [N, M]."""
    return batched_iou(a, b)


def batched_match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_valid: torch.Tensor,
                         overlap_threshold: float = 0.5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match priors [P, 8] to each image's ground truth (gt_boxes
    [b, G, 4], gt_valid [b, G] bool; MultiBoxLossLayer matchBBox).

    Two phases, as in the JAX package: each prior takes its best gt when
    the IoU passes ``overlap_threshold``; then every valid gt claims its
    best prior, and where two gts claim one prior the higher gt index
    wins. Returns (match_idx [b, P] int64, -1 unmatched; match_iou
    [b, P])."""
    P = priors.shape[0]
    iou = batched_iou(priors[:, :4], gt_boxes)           # [b, P, G]
    iou = torch.where(gt_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    best_iou = torch.amax(iou, dim=2)
    best_gt = torch.argmax(iou, dim=2)                    # first maximum
    match_idx = torch.where(best_iou > overlap_threshold, best_gt,
                            torch.full_like(best_gt, -1))
    best_prior = torch.argmax(iou, dim=1)                 # [b, G]
    G = gt_boxes.shape[1]
    g_ids = torch.arange(G, device=priors.device).expand_as(best_prior)
    # invalid gts go to slot P, which is sliced off
    scatter_idx = torch.where(gt_valid, best_prior,
                              torch.full_like(best_prior, P))
    claimed = torch.full((best_prior.shape[0], P + 1), -1, dtype=torch.long,
                         device=priors.device)
    claimed = claimed.scatter_reduce(1, scatter_idx, g_ids, reduce="amax",
                                     include_self=True)[:, :P]
    hit = claimed >= 0
    match_idx = torch.where(hit, claimed, match_idx)
    claimed_iou = torch.gather(iou, 2, claimed.clamp(min=0)[..., None])[..., 0]
    match_iou = torch.where(hit, claimed_iou, best_iou)
    return match_idx, match_iou


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, overlap_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image's ``batched_match_priors``: gt_boxes [G, 4], gt_valid
    [G] -> (match_idx [P], match_iou [P])."""
    idx, iou = batched_match_priors(priors, gt_boxes[None], gt_valid[None],
                                    overlap_threshold)
    return idx[0], iou[0]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
                iou_threshold: float = 0.45, score_threshold: float = 0.01,
                top_k: int = 400
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS of B independent rows at once (DetectionUtil
    applyNMSFast): boxes [B, N, 4], scores [B, N] -> (boxes [B, K, 4],
    scores [B, K], keep [B, K]) with K = min(top_k, N); suppressed and
    padded slots have score 0. Scores under ``score_threshold`` are
    zeroed first. Slot i is kept only if no kept earlier slot overlaps
    it past ``iou_threshold``: a loop of K steps over all B rows, on
    one [B, K, K] suppression mask."""
    k = min(top_k, boxes.shape[-2])
    scores = torch.where(scores >= score_threshold, scores,
                         torch.zeros_like(scores))
    # ties to the lower index, as lax.top_k: a stable descending sort
    top_scores, order = torch.sort(scores, dim=-1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[..., :k], order[..., :k]
    cand = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    with torch.no_grad():
        over = batched_iou(cand, cand) > iou_threshold    # [B, K, K]
        valid = top_scores > 0.0
        keep = torch.zeros_like(valid)
        # keep[:, j] is still False for every j >= i at step i, so the
        # kept earlier slots are the kept ones
        for i in range(k):
            sup = torch.any(over[:, i] & keep, dim=-1)
            keep[:, i] = valid[:, i] & ~sup
    return cand, torch.where(keep, top_scores, torch.zeros_like(top_scores)), \
        keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, *,
        iou_threshold: float = 0.45, score_threshold: float = 0.01,
        top_k: int = 400) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row's ``batched_nms``: boxes [N, 4], scores [N] ->
    (boxes [K, 4], scores [K], keep [K])."""
    cand, sc, keep = batched_nms(boxes[None], scores[None],
                                 iou_threshold=iou_threshold,
                                 score_threshold=score_threshold,
                                 top_k=top_k)
    return cand[0], sc[0], keep[0]


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth L1 (Huber with delta 1), SSD's loc loss."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)
