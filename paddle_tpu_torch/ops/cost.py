"""Cost functions — the port of ``paddle_tpu/ops/cost.py``: cross
entropy (with the self-normalizing term), soft and multi-label binary
CE, squared error, the ranking costs (pairwise ``rank_cost`` and
LambdaRank's ``lambda_cost``), Huber regression and two-class Huber,
smooth L1, ``sum_cost``, NCE, hierarchical sigmoid and the
classification error. Costs return per-sample values; the trainer
averages. Each is the JAX function's formula, term for term, so
autograd gives ``jax.grad``'s gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _gather_label(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[..., labels] — the label column of a [.., V] tensor."""
    return torch.gather(x, -1, labels[..., None].long())[..., 0]


class _CEFromLogits(torch.autograd.Function):
    """Stable logits cross entropy with a width-controlled backward
    (the JAX package's ``_ce_from_logits`` custom_vjp).

    Forward: lse - x_label, with the logsumexp in float32; it saves the
    logits in their own dtype, the labels and the [..] lse. Backward:
    dlogits = (softmax - target) * g as one expression cast to the
    LOGITS dtype. Left to autograd, the logsumexp backward keeps float32
    [.., V] tensors alive — 1 GB each for [8, 1024, 32000] logits."""

    @staticmethod
    def forward(ctx, x, labels, a):
        xf = x.float()
        lse = torch.logsumexp(xf, dim=-1)
        nll = lse - _gather_label(x, labels).float()
        if a > 0.0:
            nll = (1.0 - a) * nll + a * (lse - xf.mean(dim=-1))
        del xf
        ctx.a = a
        ctx.save_for_backward(x, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        a = ctx.a
        v = x.shape[-1]
        p = torch.exp(x.float() - lse[..., None])
        if a > 0.0:
            p = p - a / v
        p.scatter_add_(-1, labels[..., None].long(),
                       torch.full(labels.shape + (1,), -(1.0 - a),
                                  dtype=p.dtype, device=p.device))
        dl = (p * g[..., None].float()).to(x.dtype)
        return dl, None, None


def cross_entropy(probs_or_logits: torch.Tensor, labels: torch.Tensor, *,
                  from_logits: bool = False, eps: float = 1e-10,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Multi-class CE with integer labels. ``from_logits=True`` takes
    the lse - x_label path with its own backward; ``label_smoothing``
    mixes the one-hot target with uniform mass a/V (logits path only).
    The probs path gathers the label column first, then logs it."""
    if from_logits:
        return _CEFromLogits.apply(probs_or_logits, labels,
                                   float(label_smoothing))
    if label_smoothing != 0.0:
        raise ValueError(
            "label_smoothing needs from_logits=True (probs CE gathers "
            "only the label column)")
    p = _gather_label(probs_or_logits, labels)
    return -torch.log(torch.clamp(p.float(), min=eps))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp with
    0; torch's softplus switches to x past a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def cross_entropy_with_selfnorm(probs: torch.Tensor, labels: torch.Tensor,
                                softmax_selfnorm_alpha: float = 0.1,
                                eps: float = 1e-10) -> torch.Tensor:
    """CostLayer.cpp MultiClassCrossEntropyWithSelfNorm: CE +
    alpha*log(Z)^2."""
    z = torch.sum(probs, dim=-1)
    ce = cross_entropy(probs / z[..., None], labels, eps=eps)
    return ce + softmax_selfnorm_alpha * torch.square(
        torch.log(torch.clamp(z, min=eps)))


def soft_binary_class_cross_entropy(p: torch.Tensor, label: torch.Tensor,
                                    eps: float = 1e-10) -> torch.Tensor:
    """Element-wise binary CE with soft labels, summed over features."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return torch.sum(-label * torch.log(p) - (1.0 - label) * torch.log1p(-p),
                     dim=-1)


def multi_binary_label_cross_entropy(p: torch.Tensor, labels: torch.Tensor,
                                     eps: float = 1e-10) -> torch.Tensor:
    """Multi-label CE: labels is a {0,1} dense matrix (a
    sparse_binary_vector feed densified by the feeder)."""
    return soft_binary_class_cross_entropy(p, labels, eps)


def square_error(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """SumOfSquaresCostLayer: 0.5 * sum (pred - label)^2 per sample."""
    d = pred - label
    return 0.5 * torch.sum(torch.square(d), dim=-1)



def rank_cost(left: torch.Tensor, right: torch.Tensor, label: torch.Tensor,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RankingCost: pairwise logistic loss on the score difference,
    softplus(o) - label * o with o = left - right, label in [0, 1]."""
    o = (left - right)[..., 0]
    lab = label.to(o.dtype)
    if lab.dim() > o.dim():
        lab = lab[..., 0]
    c = _softplus(o) - lab * o
    if weight is not None:
        c = c * weight[..., 0] if weight.dim() > c.dim() else c * weight
    return c


def lambda_cost(scores: torch.Tensor, relevance: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                ndcg_num: int = 5) -> torch.Tensor:
    """LambdaRank (LambdaCost): one query's documents along the time
    axis, scores and relevance [batch, n], mask 1.0 on valid documents.
    The JAX package's differentiable surrogate: over pairs with
    rel_i > rel_j, |delta gain| * log(1 + exp(-(s_i - s_j))), the gains
    normalized by the ideal DCG of the top ``ndcg_num``."""
    n = scores.shape[1]
    if mask is None:
        mask = torch.ones_like(scores)
    rel = relevance
    sorted_rel = torch.sort(rel, dim=-1, descending=True).values
    pos = torch.arange(n, device=scores.device)
    disc = 1.0 / torch.log2(pos + 2.0)
    topk = (pos < ndcg_num).to(scores.dtype)
    idcg = torch.sum((torch.pow(2.0, sorted_rel) - 1.0) * disc * topk,
                     dim=-1, keepdim=True)
    idcg = torch.clamp(idcg, min=1e-5)
    gain = (torch.pow(2.0, rel) - 1.0) / idcg                # [b, n]
    s_diff = scores[:, :, None] - scores[:, None, :]          # s_i - s_j
    rel_gt = (rel[:, :, None] > rel[:, None, :]).to(scores.dtype)
    pair_mask = mask[:, :, None] * mask[:, None, :] * rel_gt
    dgain = torch.abs(gain[:, :, None] - gain[:, None, :])
    loss = _softplus(-s_diff) * dgain * pair_mask
    return torch.sum(loss, dim=(1, 2))


def huber_regression(pred: torch.Tensor, label: torch.Tensor,
                     delta: float = 1.0) -> torch.Tensor:
    """HuberRegressionLoss (CostLayer.cpp)."""
    a = torch.abs(pred - label)
    quad = 0.5 * torch.square(a)
    lin = delta * a - 0.5 * delta * delta
    return torch.sum(torch.where(a <= delta, quad, lin), dim=-1)


def huber_classification(pred: torch.Tensor,
                         label: torch.Tensor) -> torch.Tensor:
    """HuberTwoClassification: labels {0,1} -> y in {-1,1}; squared
    hinge with a linear tail."""
    y = 2.0 * label.to(pred.dtype) - 1.0
    z = pred[..., 0] * y
    return torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z),
                                   torch.zeros_like(z)))


def smooth_l1(pred: torch.Tensor, label: torch.Tensor,
              sigma: float = 1.0) -> torch.Tensor:
    """SmoothL1CostLayer."""
    s2 = sigma * sigma
    d = torch.abs(pred - label)
    loss = torch.where(d < 1.0 / s2, 0.5 * s2 * torch.square(d), d - 0.5 / s2)
    return torch.sum(loss, dim=-1)


def sum_cost(x: torch.Tensor) -> torch.Tensor:
    """SumCostLayer: the sum of the input as the loss."""
    return torch.sum(x, dim=tuple(range(1, x.dim())))


def nce_loss(features: torch.Tensor, weights: torch.Tensor,
             bias: torch.Tensor, labels: torch.Tensor,
             sample_ids: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Noise-contrastive estimation (NCELayer.cpp) against a uniform
    noise distribution. features [b, d], weights [num_classes, d], bias
    [num_classes], labels [b], sample_ids [b, k] -> [b]: the true
    class's logit and the k noise logits (gathered rows, no product
    over all classes), each through softplus(-/+(logit - log k -
    log(1 / num_classes)))."""
    k = sample_ids.shape[-1]
    log_noise = math.log(1.0 / num_classes)
    labels = labels.reshape(-1).long()
    sample_ids = sample_ids.long()
    true_logit = torch.sum(features * weights[labels], dim=-1) + bias[labels]
    noise_logit = torch.sum(features[:, None, :] * weights[sample_ids],
                            dim=-1) + bias[sample_ids]
    true_cost = _softplus(-(true_logit - math.log(float(k)) - log_noise))
    noise_cost = _softplus(noise_logit - math.log(float(k)) - log_noise)
    return true_cost + torch.sum(noise_cost, dim=-1)


def hsigmoid_loss(features: torch.Tensor, weights: torch.Tensor,
                  bias: torch.Tensor, labels: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """Hierarchical sigmoid over an implicit complete binary tree
    (HierarchicalSigmoidLayer): classes are leaves, the internal nodes
    ``num_classes - 1`` logistic classifiers addressed by the binary
    code of the label. The JAX package's scan over the depth, as a
    loop."""
    depth = max(int(num_classes - 1).bit_length(), 1)
    node = labels.long() + num_classes            # leaf index, heap order
    total = torch.zeros(features.shape[0], dtype=features.dtype,
                        device=features.device)
    for _ in range(depth):
        parent = node // 2
        is_right = (node % 2).to(features.dtype)   # bit: went right?
        valid = (parent >= 1).to(features.dtype)
        at = torch.clamp(parent - 1, 0, num_classes - 2)
        logit = torch.sum(features * weights[at], dim=-1) + bias[at]
        # sigmoid CE: a right child is label 1
        total = total + valid * (_softplus(logit) - is_right * logit)
        node = parent
    return total


def classification_error(probs: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-sample 0/1 error (ClassificationErrorLayer / evaluator)."""
    pred = torch.argmax(probs, dim=-1)
    return (pred != labels.to(pred.dtype)).to(torch.float32)
