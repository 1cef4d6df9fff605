"""Linear-chain CRF and CTC layers — the port of the ``crf``,
``crf_decoding``, ``crf_error``, ``ctc`` and ``warp_ctc`` layers of
``paddle_tpu/layers/crf_layers.py``.

The parameter is (n+2, n): row 0 the start scores, row 1 the end
scores, rows 2.. the transitions (trans[i, j] = score of i -> j). The
negative log-likelihood is the forward algorithm and decoding is
Viterbi, each a loop over time of batched [b, n, n] logsumexp / max.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            make_layer, register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops.ctc import ctc_loss


def crf_nll(emissions: torch.Tensor, labels: torch.Tensor,
            lengths: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
            trans: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of the label paths [b].

    emissions [b, T, n]; labels [b, T] int; lengths [b]; start, end
    [n]; trans [n, n]."""
    b, T, n = emissions.shape
    labels = labels.long()
    lengths = lengths.long()
    valid = torch.arange(T, device=emissions.device)[None, :] < \
        lengths[:, None]
    zero = emissions.new_zeros(())
    # score of the gold path
    emit = torch.gather(emissions, -1, labels[..., None])[..., 0]
    gold_emit = torch.where(valid, emit, zero).sum(dim=1)
    pair = trans[labels[:, :-1], labels[:, 1:]]
    gold_trans = torch.where(valid[:, 1:], pair, zero).sum(dim=1)
    last = torch.gather(labels, 1, torch.clamp(lengths - 1, min=0)[:, None])
    gold = gold_emit + gold_trans + start[labels[:, 0]] + end[last[:, 0]]
    # log partition: the forward algorithm
    alpha = start[None, :] + emissions[:, 0, :]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            emissions[:, t, :]
        alpha = torch.where((t < lengths)[:, None], new, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=-1)
    return log_z - gold


def crf_viterbi(emissions: torch.Tensor, lengths: torch.Tensor,
                start: torch.Tensor, end: torch.Tensor,
                trans: torch.Tensor) -> torch.Tensor:
    """Viterbi decode -> best path [b, T] int32 (padding positions 0)."""
    b, T, n = emissions.shape
    lengths = lengths.long()
    score = start[None, :] + emissions[:, 0, :]
    backptrs = []
    for t in range(1, T):
        cand = score[:, :, None] + trans[None]            # [b, prev, n]
        best, arg = torch.max(cand, dim=1)
        backptrs.append(arg)
        score = torch.where((t < lengths)[:, None], best + emissions[:, t, :],
                            score)
    lab = torch.argmax(score + end[None, :], dim=-1)      # [b]
    path = [lab]
    for t in range(T - 1, 0, -1):
        prev = torch.gather(backptrs[t - 1], 1, lab[:, None])[:, 0]
        lab = torch.where(t < lengths, prev, lab)
        path.append(lab)
    path = torch.stack(path[::-1], dim=1)
    valid = torch.arange(T, device=emissions.device)[None, :] < \
        lengths[:, None]
    return torch.where(valid, path, torch.zeros_like(path)).to(torch.int32)


def _crf_param_specs(name, cfg, n):
    a = ParamAttr.of(cfg.get("param_attr"))
    pname = a.name or f"_{name}.w0"
    cfg["_w_name"] = pname
    return [ParamSpec(pname, (n + 2, n),
                      a.initializer or initializers.normal(0.01), a)]


@register_layer("crf")
class CRFLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        n = cfg.get("size") or input_metas[0].size
        return LayerMeta(size=1), _crf_param_specs(name, cfg, n), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        labels = inputs[1]
        lab = labels.data if isinstance(labels, SequenceBatch) else labels
        w = params[cfg["_w_name"]]
        return crf_nll(seq.data, lab, seq.lengths, w[0], w[1], w[2:])


@register_layer("crf_decoding")
class CRFDecodingLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        n = cfg.get("size") or input_metas[0].size
        return LayerMeta(size=1, seq_level=1, is_integer=True), \
            _crf_param_specs(name, cfg, n), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        w = params[cfg["_w_name"]]
        path = crf_viterbi(seq.data, seq.lengths, w[0], w[1], w[2:])
        if len(inputs) > 1:
            # with a label input: the per-position 0/1 error
            labels = inputs[1]
            lab = labels.data if isinstance(labels, SequenceBatch) else labels
            return seq.with_data((path != lab).to(torch.float32))
        return SequenceBatch(path, seq.lengths)


@register_layer("crf_error")
class CRFDecodingErrorLayer(CRFDecodingLayer):
    """Viterbi-decode and emit the per-position 0/1 disagreement with the
    label (CRFDecodingLayer given a label input)."""

    @staticmethod
    def build(name, cfg, input_metas):
        assert len(input_metas) == 2, "crf_error needs emissions + label"
        return CRFDecodingLayer.build(name, cfg, input_metas)


@register_layer("ctc")
class CTCLayer:
    """CTC cost of a sequence of class scores against a label sequence.
    ``ctc`` takes probabilities (a softmax output), clamped at 1e-10
    and logged, with the blank the last class; ``from_logits`` takes
    raw scores. ``blank`` overrides the blank class."""

    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        seq: SequenceBatch = inputs[0]
        labels = inputs[1]
        logits = seq.data
        if not cfg.get("from_logits", False):
            logits = torch.log(torch.clamp(logits, min=1e-10))
        if isinstance(labels, SequenceBatch):
            lab, lab_pad = labels.data, 1.0 - labels.mask()
        else:
            lab = labels
            lab_pad = torch.zeros(lab.shape, dtype=torch.float32,
                                  device=lab.device)
        blank = cfg.get("blank")
        if blank is None:
            blank = logits.shape[-1] - 1
        return ctc_loss(logits, 1.0 - seq.mask(), lab, lab_pad,
                        blank_id=blank)


@register_layer("warp_ctc")
class WarpCTCLayer(CTCLayer):
    """The warp-ctc semantics even when the config carries only the
    type's name: raw logits in, blank 0."""

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        cfg = {"from_logits": True, "blank": 0, **cfg}
        return CTCLayer.apply(ctx, name, cfg, params, inputs)


def crf(input, label, size=None, param_attr=None, name=None, **kw):
    return make_layer("crf", name, [input, label], size=size,
                      param_attr=param_attr)


def crf_decoding(input, size=None, label=None, param_attr=None, name=None,
                 **kw):
    nodes = [input] + ([label] if label is not None else [])
    return make_layer("crf_decoding", name, nodes, size=size,
                      param_attr=param_attr)


def crf_error(input, label, size=None, param_attr=None, name=None, **kw):
    return make_layer("crf_error", name, [input, label], size=size,
                      param_attr=param_attr)


def ctc(input, label, size=None, blank=None, name=None, **kw):
    """CTC cost on probabilities; the blank defaults to the last class."""
    return make_layer("ctc", name, [input, label], size=size, blank=blank)


ctc_layer = ctc


def warp_ctc(input, label, size=None, blank=0, name=None, **kw):
    """CTC cost on raw logits; the blank defaults to class 0."""
    return make_layer("warp_ctc", name, [input, label], size=size,
                      blank=blank, from_logits=True)
