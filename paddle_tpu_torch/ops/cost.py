"""Cost functions — the port of the cross-entropy and classification
error parts of ``paddle_tpu/ops/cost.py``. Costs return per-sample values; the
trainer averages.
"""

from __future__ import annotations

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


def classification_error(probs: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-sample 0/1 error (ClassificationErrorLayer / evaluator)."""
    pred = torch.argmax(probs, dim=-1)
    return (pred != labels.to(pred.dtype)).to(torch.float32)
