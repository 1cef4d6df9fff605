"""Connectionist Temporal Classification loss — the port of
``paddle_tpu/ops/ctc.py``: the lattice forward algorithm over the
extended label sequence (2U + 1 states, a blank between and around the
labels) with the three-way recurrence (stay, advance, skip a blank
between two different labels), in log space, the batch and the states
vectorized and a loop over time.

Scores are floored at ``_NEG`` (-1e30) rather than -inf, as in the JAX
package, so a label that no alignment can emit (too long for its
frames) costs about 1e30 and every gradient stays finite.
``F.ctc_loss`` is not this function: it gives inf there (or 0 with
``zero_infinity``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG = -1e30


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with the JAX package's derivative,
    exp(a - out) and exp(b - out) as computed: where both inputs sit at
    _NEG, out rounds to _NEG and each derivative is 1, not 1/2."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    # maximum, not clamp: at a tie the derivative splits, as in JAX
    m_safe = torch.maximum(m, torch.full_like(m, _NEG))
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe) +
                             torch.exp(c - m_safe))
    return torch.where(m > _NEG / 2, out, torch.full_like(out, _NEG))


def _shift(x, k):
    """x [b, S] shifted right by k states, _NEG coming in."""
    return F.pad(x, (k, 0), value=_NEG)[:, :x.shape[1]]


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-sequence negative log-likelihood of ``labels`` under CTC [b].

    logits [b, T, C] unnormalized (log-softmaxed here);
    logit_paddings [b, T] 1.0 on padding frames; labels [b, U] int;
    label_paddings [b, U] 1.0 on padding positions; blank_id the index
    of the blank class. Padding frames freeze the lattice."""
    b, T, C = logits.shape
    U = labels.shape[1]
    S = 2 * U + 1
    dev = logits.device

    logp = torch.log_softmax(logits, dim=-1)
    lab_len = torch.sum(1.0 - label_paddings, dim=1).to(torch.int64)
    seq_len = torch.sum(1.0 - logit_paddings, dim=1).to(torch.int64)

    z = torch.full((b, S), blank_id, dtype=torch.int64, device=dev)
    z[:, 1::2] = labels.to(torch.int64)
    s_idx = torch.arange(S, device=dev)[None, :]
    z_valid = s_idx < (2 * lab_len[:, None] + 1)
    z_prev2 = F.pad(z, (2, 0), value=-1)[:, :S]
    can_skip = (z != blank_id) & (z != z_prev2) & (s_idx >= 2)

    emit = torch.gather(logp, 2, z[:, None, :].expand(b, T, S))   # [b,T,S]
    neg = torch.full((b, S), _NEG, dtype=logp.dtype, device=dev)

    first_lab = torch.where(lab_len > 0, emit[:, 0, 1] if S > 1 else
                            neg[:, 0], neg[:, 0])
    alpha = torch.cat([emit[:, 0, :1], first_lab[:, None], neg[:, 2:]],
                      dim=1)[:, :S]
    alpha = torch.where(z_valid, alpha, neg)

    for t in range(1, T):
        a2 = torch.where(can_skip, _shift(alpha, 2), neg)
        new = _logaddexp3(alpha, _shift(alpha, 1), a2) + emit[:, t]
        new = torch.where(z_valid, new, neg)
        live = (t < seq_len)[:, None]
        alpha = torch.where(live, new, alpha)

    # total = logaddexp(alpha[2U], alpha[2U-1]); an empty label: alpha[0]
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    prev = torch.clamp(last - 1, min=0)
    a_prev = torch.gather(alpha, 1, prev[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, neg[:, 0])
    return -_LogAddExp.apply(a_last, a_prev)
