"""Evaluator framework — the port of ``paddle_tpu/evaluator``
(gserver/evaluators parity).

The streaming pass-level statistics (AUC buckets, chunk matching, edit
distance, pair ordering, sums, the printers) are host numpy
accumulators fed with each batch's fetched outputs, as in the JAX
package — the same code, so both packages give the same results on the
same batches. ``SGD(evaluators=[...])`` wires them: their input layers
become extra outputs of the step, fetched with the cost in one host
transfer, and the rows below the batch's real count are evaluated.

``gradient_printer`` takes d(cost)/d(activation) of its input layer
from the train step's own backward pass (``SGD`` sees
``wants_gradient``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.registry import LayerOutput

__all__ = [
    "Evaluator", "auc", "classification_error", "precision_recall",
    "chunk", "ctc_error", "pnpair", "rank_auc", "sum_evaluator",
    "column_sum", "maxid_printer", "value_printer", "seq_text_printer",
    "max_frame_printer", "gradient_printer",
]


def _tensor_np(x):
    """A tensor (of any dtype numpy lacks, such as bfloat16, as float32)
    or an array-like as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype not in (torch.float32,
                                                     torch.float64):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _to_np(x):
    """Fetch a step output to host. SequenceBatch -> (data, lengths)."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    if isinstance(x, SequenceBatch):
        return (_tensor_np(x.data), _tensor_np(x.lengths))
    return _tensor_np(x)


def _rows(x, n_real: int):
    """First n_real rows of an output (drop feed padding)."""
    if isinstance(x, tuple):      # (data, lengths) from a SequenceBatch
        return (x[0][:n_real], x[1][:n_real])
    return x[:n_real]


class Evaluator:
    """Base: start() -> eval_batch(per batch) -> result() per pass."""

    name: str = "evaluator"
    #: LayerOutputs whose values this evaluator consumes each batch.
    inputs: List[LayerOutput]

    def start(self) -> None:
        raise NotImplementedError

    def eval_batch(self, values: Sequence[Any], n_real: int) -> None:
        """values: host arrays for self.inputs, in order."""
        raise NotImplementedError

    def result(self) -> Dict[str, float]:
        raise NotImplementedError

    def __str__(self):
        return " ".join(f"{k}={v:.6g}" for k, v in self.result().items())


# ---------------------------------------------------------------------------
# AUC (streaming, bucketed — AucEvaluator parity)


class AucEvaluator(Evaluator):
    """Streaming ROC AUC over score buckets (Evaluator.cpp AucEvaluator).

    input: probability output — [b] / [b,1] score of the positive class,
    or [b,2] softmax (column 1 taken). label: [b] in {0,1}.
    """

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 num_buckets: int = 1 << 12, name: str = "auc"):
        self.name = name
        self.inputs = [input, label]
        self.num_buckets = num_buckets
        self.start()

    def start(self):
        self._pos = np.zeros(self.num_buckets, np.int64)
        self._neg = np.zeros(self.num_buckets, np.int64)

    def eval_batch(self, values, n_real):
        score, label = (_rows(v, n_real) for v in values)
        score = np.asarray(score, np.float64)
        if score.ndim == 2:
            score = score[:, -1] if score.shape[1] <= 2 else score[:, 1]
        label = np.asarray(label).reshape(-1).astype(np.int64)
        idx = np.clip((score * self.num_buckets).astype(np.int64),
                      0, self.num_buckets - 1)
        np.add.at(self._pos, idx[label == 1], 1)
        np.add.at(self._neg, idx[label != 1], 1)

    def result(self):
        P, N = self._pos.sum(), self._neg.sum()
        if P == 0 or N == 0:
            return {self.name: 0.0}
        cum_neg_below = np.concatenate([[0], np.cumsum(self._neg)[:-1]])
        correct = np.sum(self._pos * (cum_neg_below + 0.5 * self._neg))
        return {self.name: float(correct / (P * N))}


# ---------------------------------------------------------------------------
# precision / recall / F1


class PrecisionRecallEvaluator(Evaluator):
    """Per-class TP/FP/FN counts (PrecisionRecallEvaluator parity).

    input: [b, n_classes] probabilities (argmax taken) or [b] predicted
    ids; label: [b] int class ids. With positive_label set, reports the
    binary precision/recall/F1 of that class; otherwise macro-averaged.
    """

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 positive_label: Optional[int] = None,
                 name: str = "precision_recall"):
        self.name = name
        self.inputs = [input, label]
        self.positive_label = positive_label
        self.start()

    def start(self):
        self._tp: Dict[int, int] = {}
        self._fp: Dict[int, int] = {}
        self._fn: Dict[int, int] = {}

    def eval_batch(self, values, n_real):
        pred, label = (_rows(v, n_real) for v in values)
        pred = np.asarray(pred)
        if pred.ndim == 2:
            pred = pred.argmax(-1)
        pred = pred.reshape(-1).astype(np.int64)
        label = np.asarray(label).reshape(-1).astype(np.int64)
        for c in np.unique(np.concatenate([pred, label])):
            c = int(c)
            self._tp[c] = self._tp.get(c, 0) + int(
                np.sum((pred == c) & (label == c)))
            self._fp[c] = self._fp.get(c, 0) + int(
                np.sum((pred == c) & (label != c)))
            self._fn[c] = self._fn.get(c, 0) + int(
                np.sum((pred != c) & (label == c)))

    @staticmethod
    def _prf(tp, fp, fn):
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f

    def result(self):
        if self.positive_label is not None:
            c = self.positive_label
            p, r, f = self._prf(self._tp.get(c, 0), self._fp.get(c, 0),
                                self._fn.get(c, 0))
        else:
            classes = sorted(self._tp)
            if not classes:
                p = r = f = 0.0
            else:
                prf = [self._prf(self._tp[c], self._fp[c], self._fn[c])
                       for c in classes]
                p, r, f = (float(np.mean([x[i] for x in prf]))
                           for i in range(3))
        return {f"{self.name}_precision": p, f"{self.name}_recall": r,
                f"{self.name}_f1": f}


# ---------------------------------------------------------------------------
# chunk F1 (NER — ChunkEvaluator.cpp parity)


def extract_chunks(ids: np.ndarray, scheme: str, num_chunk_types: int):
    """Decode (begin, end, type) chunks from a tag-id sequence.

    Label encoding follows ChunkEvaluator.cpp: with T tag positions per
    scheme (IOB:2 [B,I], IOE:2 [I,E], IOBES:4 [B,I,E,S], plain:1),
    id = chunk_type * T + tag, and the single "other/O" id is
    num_chunk_types * T.
    """
    tag_num = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    other = num_chunk_types * tag_num
    chunks = []
    start, ctype = None, None

    def is_begin(tag, prev_tag, prev_type, typ):
        if scheme == "plain":
            return prev_type != typ or prev_tag is None
        if scheme == "IOB":
            return tag == 0 or prev_type != typ
        if scheme == "IOE":
            # begins when previous ended (prev tag E) or type changed
            return prev_tag in (None, 1) or prev_type != typ
        if scheme == "IOBES":
            # B/S begin; so does anything right after an E/S or a type flip
            return tag in (0, 3) or prev_tag in (2, 3) or prev_type != typ
        raise ValueError(scheme)

    prev_tag = prev_type = None
    for i, lab in enumerate(np.asarray(ids).tolist()):
        if lab == other or lab < 0 or lab > other:
            if start is not None:
                chunks.append((start, i - 1, ctype))
            start = ctype = None
            prev_tag = prev_type = None
            continue
        tag, typ = lab % tag_num, lab // tag_num
        if is_begin(tag, prev_tag, prev_type, typ):
            if start is not None:
                chunks.append((start, i - 1, ctype))
            start, ctype = i, typ
        if scheme == "IOE" and tag == 1:       # E closes the chunk
            chunks.append((start if start is not None else i, i,
                           ctype if ctype is not None else typ))
            start = ctype = None
        elif scheme == "IOBES" and tag in (2, 3):   # E / S close
            chunks.append((start if start is not None else i, i,
                           ctype if ctype is not None else typ))
            start = ctype = None
        prev_tag, prev_type = tag, typ
    if start is not None:
        chunks.append((start, len(np.asarray(ids)) - 1, ctype))
    return chunks


class ChunkEvaluator(Evaluator):
    """Chunk-level precision/recall/F1 for sequence tagging
    (ChunkEvaluator.cpp — the CRF/NER metric).

    input / label: SequenceBatch of tag ids ([b, T] + lengths), e.g. the
    crf_decoding output vs the gold tags.
    """

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 chunk_scheme: str = "IOB", num_chunk_types: int = 1,
                 name: str = "chunk"):
        assert chunk_scheme in ("plain", "IOB", "IOE", "IOBES")
        self.name = name
        self.inputs = [input, label]
        self.scheme = chunk_scheme
        self.num_chunk_types = num_chunk_types
        self.start()

    def start(self):
        self._correct = self._pred = self._gold = 0

    def _seq_iter(self, v):
        if isinstance(v, tuple):
            data, lengths = v
            for row, ln in zip(data, lengths):
                yield row[: int(ln)]
        else:                                   # dense [b, T]
            for row in v:
                yield row

    def eval_batch(self, values, n_real):
        pred, gold = (_rows(v, n_real) for v in values)
        for p_row, g_row in zip(self._seq_iter(pred), self._seq_iter(gold)):
            pc = set(extract_chunks(p_row, self.scheme, self.num_chunk_types))
            gc = set(extract_chunks(g_row, self.scheme, self.num_chunk_types))
            self._correct += len(pc & gc)
            self._pred += len(pc)
            self._gold += len(gc)

    def result(self):
        p = self._correct / self._pred if self._pred else 0.0
        r = self._correct / self._gold if self._gold else 0.0
        f = 2 * p * r / (p + r) if p + r else 0.0
        return {f"{self.name}_precision": p, f"{self.name}_recall": r,
                f"{self.name}_f1": f}


# ---------------------------------------------------------------------------
# CTC edit distance (CTCErrorEvaluator.cpp parity)


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance (insert/delete/substitute, all cost 1)."""
    a, b = list(a), list(b)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


class CTCErrorEvaluator(Evaluator):
    """Sequence error rate: edit_distance(best-path CTC decode, label) /
    label length, averaged per pass (CTCErrorEvaluator.cpp).

    input: SequenceBatch of per-frame class scores [b, T, C] (or already
    -decoded id sequences [b, T]); label: SequenceBatch of target ids.
    blank: id of the CTC blank — default None = the LAST class for score
    inputs, matching layer.ctc (LinearChainCTC.cpp:86 blank=numClasses-1);
    pass it explicitly for pre-decoded id inputs or warp_ctc models.
    """

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 blank: Optional[int] = None, name: str = "ctc_error"):
        self.name = name
        self.inputs = [input, label]
        self.blank = blank
        self.start()

    def start(self):
        self._dist = 0.0
        self._len = 0

    def _decode(self, frames):
        """Best-path: argmax per frame, collapse repeats, drop blanks."""
        blank = self.blank
        if frames.ndim == 2:
            ids = frames.argmax(-1)
            if blank is None:
                blank = frames.shape[-1] - 1      # layer.ctc convention
        else:
            ids = frames                           # pre-decoded: no blank
        out, prev = [], None
        for t in ids.tolist():
            if t != prev and t != blank:
                out.append(t)
            prev = t
        return out

    def eval_batch(self, values, n_real):
        pred, gold = (_rows(v, n_real) for v in values)
        pred_it = (row[: int(ln)] for row, ln in zip(*pred)) \
            if isinstance(pred, tuple) else iter(pred)
        gold_it = (row[: int(ln)] for row, ln in zip(*gold)) \
            if isinstance(gold, tuple) else iter(gold)
        for p_row, g_row in zip(pred_it, gold_it):
            hyp = self._decode(np.asarray(p_row))
            ref = np.asarray(g_row).reshape(-1).tolist()
            self._dist += edit_distance(hyp, ref)
            self._len += max(len(ref), 1)

    def result(self):
        return {self.name: self._dist / self._len if self._len else 0.0}


# ---------------------------------------------------------------------------
# pair ordering metrics (PnpairEvaluator / RankAucEvaluator parity)


class _PassBufferedPairEvaluator(Evaluator):
    """Base for pair-ordering metrics: buffers the whole pass (the
    reference PnpairEvaluator does the same — query groups may span batch
    boundaries, so per-batch counting would drop cross-batch pairs).
    `expensive_result` tells the trainer to compute result() only at pass
    end, not per batch (it redoes the full pairwise pass)."""

    expensive_result = True

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 query_id: LayerOutput, name: str):
        self.name = name
        self.inputs = [input, label, query_id]
        self.start()

    def start(self):
        self._score: list = []
        self._label: list = []
        self._qid: list = []

    def eval_batch(self, values, n_real):
        score, label, qid = (np.asarray(_rows(v, n_real)).reshape(-1)
                             for v in values)
        self._score.append(score)
        self._label.append(label)
        self._qid.append(qid)

    def _groups(self):
        if not self._score:
            return
        score = np.concatenate(self._score)
        label = np.concatenate(self._label)
        qid = np.concatenate(self._qid)
        for q in np.unique(qid):
            m = qid == q
            yield score[m], label[m]


class PnpairEvaluator(_PassBufferedPairEvaluator):
    """Positive-negative pair ordering within query groups
    (PnpairEvaluator: counts pairs where the higher-labelled sample also
    scored higher; reports pos/neg ratio).

    inputs: score [b], label [b] (graded relevance), query_id [b].
    """

    def __init__(self, input, label, query_id, name: str = "pnpair"):
        super().__init__(input, label, query_id, name)

    def result(self):
        pos = neg = 0
        for s, l in self._groups():
            ds = s[:, None] - s[None, :]
            dl = l[:, None] - l[None, :]
            upper = np.triu(np.ones_like(ds, bool), 1) & (dl != 0)
            agree = np.sign(ds) == np.sign(dl)
            pos += int(np.sum(upper & agree & (ds != 0)))
            neg += int(np.sum(upper & ~agree & (ds != 0)))
        return {f"{self.name}_pos": float(pos), f"{self.name}_neg": float(neg),
                f"{self.name}_ratio": pos / neg if neg else float(pos)}


class RankAucEvaluator(_PassBufferedPairEvaluator):
    """Query-averaged pairwise AUC over graded labels (RankAucEvaluator):
    fraction of correctly-ordered (non-tied) pairs, ties counted half."""

    def __init__(self, input, label, query_id, name: str = "rank_auc"):
        super().__init__(input, label, query_id, name)

    def result(self):
        auc_sum, n_queries = 0.0, 0
        for s, l in self._groups():
            ds = s[:, None] - s[None, :]
            dl = l[:, None] - l[None, :]
            valid = np.triu(np.ones_like(ds, bool), 1) & (dl != 0)
            n = int(valid.sum())
            if n == 0:
                continue
            agree = (np.sign(ds) == np.sign(dl)) & (ds != 0)
            auc_sum += (np.sum(valid & agree) +
                        0.5 * np.sum(valid & (ds == 0))) / n
            n_queries += 1
        return {self.name: auc_sum / n_queries if n_queries else 0.0}


# ---------------------------------------------------------------------------
# sums + printers


class SumEvaluator(Evaluator):
    """Pass-total of an output (SumEvaluator)."""

    def __init__(self, input: LayerOutput, name: str = "sum"):
        self.name = name
        self.inputs = [input]
        self.start()

    def start(self):
        self._sum = 0.0

    def eval_batch(self, values, n_real):
        v = _rows(values[0], n_real)
        if isinstance(v, tuple):
            data, lengths = v
            t = np.arange(data.shape[1])[None, :] < lengths[:, None]
            v = data * t.reshape(t.shape + (1,) * (data.ndim - 2))
        self._sum += float(np.sum(v))

    def result(self):
        return {self.name: self._sum}


class ColumnSumEvaluator(Evaluator):
    """Pass-total of one column (ColumnSumEvaluator)."""

    def __init__(self, input: LayerOutput, column: int = 0,
                 name: str = "column_sum"):
        self.name = name
        self.inputs = [input]
        self.column = column
        self.start()

    def start(self):
        self._sum = 0.0

    def eval_batch(self, values, n_real):
        v = np.asarray(_rows(values[0], n_real))
        self._sum += float(np.sum(v.reshape(v.shape[0], -1)[:, self.column]))

    def result(self):
        return {self.name: self._sum}


class ClassificationErrorEvaluator(Evaluator):
    """Host-side error rate (ClassificationErrorEvaluator; the device
    metric layer `classification_error` is usually preferable)."""

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 top_k: int = 1, name: str = "classification_error"):
        self.name = name
        self.inputs = [input, label]
        self.top_k = top_k
        self.start()

    def start(self):
        self._wrong = self._total = 0

    def eval_batch(self, values, n_real):
        probs, label = (_rows(v, n_real) for v in values)
        probs = np.asarray(probs)
        label = np.asarray(label).reshape(-1)
        topk = np.argsort(-probs, axis=-1)[:, : self.top_k]
        hit = (topk == label[:, None]).any(axis=1)
        self._wrong += int(np.sum(~hit))
        self._total += len(label)

    def result(self):
        return {self.name: self._wrong / self._total if self._total else 0.0}


class PrinterEvaluator(Evaluator):
    """Debug printer (ValuePrinter / MaxIdPrinter / SeqTextPrinter):
    prints per batch, contributes no metrics."""

    def __init__(self, input: LayerOutput, mode: str = "value",
                 name: str = "printer", stream=None):
        self.name = name
        self.inputs = [input]
        self.mode = mode
        self.stream = stream

    def start(self):
        pass

    def eval_batch(self, values, n_real):
        import sys
        v = _rows(values[0], n_real)
        arr = v[0] if isinstance(v, tuple) else v
        arr = np.asarray(arr)
        if self.mode == "maxid" and arr.ndim >= 2:
            arr = arr.argmax(-1)
        print(f"[{self.name}] {arr}", file=self.stream or sys.stdout)

    def result(self):
        return {}


class SeqTextPrinterEvaluator(Evaluator):
    """Prints decoded token sequences during eval — SequenceTextPrinter
    (Evaluator.cpp:1319; config api seqtext_printer_evaluator), the
    natural companion of the beam decoder: each sequence prints as
    `sample_id \\t tokens`, ids mapped through a dictionary.

    input: SequenceBatch of ids [b, T] (a maxid/generation output), or
    per-frame scores [b, T, C] (argmax-decoded here); dict_data: list of
    tokens (id -> token) or {id: token}; dict_file: one token per line
    (the reference's dict_file). Without a dictionary, raw ids print.
    delimited=False joins tokens without spaces (char models)."""

    expensive_result = False

    def __init__(self, input: LayerOutput, dict_data=None,
                 dict_file: Optional[str] = None, delimited: bool = True,
                 name: str = "seq_text_printer", stream=None):
        self.name = name
        self.inputs = [input]
        self.stream = stream
        self.delimited = delimited
        if dict_file is not None:
            with open(dict_file) as f:
                dict_data = [ln.rstrip("\n") for ln in f]
        if isinstance(dict_data, dict):
            self._dict = dict(dict_data)
        elif dict_data is not None:
            self._dict = {i: t for i, t in enumerate(dict_data)}
        else:
            self._dict = None
        self._sample_id = 0

    def start(self):
        self._sample_id = 0

    def _decode(self, ids) -> str:
        toks = [self._dict.get(int(i), f"<unk:{int(i)}>")
                if self._dict is not None else str(int(i)) for i in ids]
        return (" " if self.delimited else "").join(toks)

    def eval_batch(self, values, n_real):
        import sys
        v = _rows(values[0], n_real)
        out = self.stream or sys.stdout
        if isinstance(v, tuple):            # SequenceBatch (data, lengths)
            data, lengths = v
            if data.ndim >= 3:              # scores -> ids
                data = data.argmax(-1)
            for i in range(len(lengths)):
                ids = data[i, :int(lengths[i])]
                print(f"{self._sample_id}\t{self._decode(ids)}", file=out)
                self._sample_id += 1
        else:                               # dense [b, T] id rows
            arr = np.asarray(v)
            if arr.ndim >= 3:
                arr = arr.argmax(-1)
            for row in arr.reshape(arr.shape[0], -1):
                print(f"{self._sample_id}\t{self._decode(row)}", file=out)
                self._sample_id += 1

    def result(self):
        return {}


class MaxFramePrinterEvaluator(Evaluator):
    """Per sequence, prints the frame (timestep) holding the max value —
    MaxFramePrinter (Evaluator.cpp:1142; config api
    maxframe_printer_evaluator). input: SequenceBatch of width-1 scores
    [b, T] or [b, T, 1]."""

    def __init__(self, input: LayerOutput, name: str = "max_frame_printer",
                 stream=None):
        self.name = name
        self.inputs = [input]
        self.stream = stream

    def start(self):
        pass

    def eval_batch(self, values, n_real):
        import sys
        v = _rows(values[0], n_real)
        out = self.stream or sys.stdout
        if not isinstance(v, tuple):
            raise ValueError(f"{self.name}: input must be a sequence layer")
        data, lengths = v
        data = np.asarray(data).reshape(data.shape[0], data.shape[1], -1)
        if data.shape[-1] != 1:
            raise ValueError(
                f"{self.name}: width-1 sequences required, got width "
                f"{data.shape[-1]}")
        for i in range(len(lengths)):
            t = int(lengths[i])
            frames = data[i, :t, 0]
            j = int(frames.argmax()) if t else 0
            print(f"[{self.name}] seq{i}: frame {j} : "
                  f"{float(frames[j]) if t else float('nan'):.6g}, "
                  f"total {t} frames", file=out)

    def result(self):
        return {}


class GradientPrinterEvaluator(Evaluator):
    """Prints d(cost)/d(activation) of the input layer each batch —
    GradientPrinter (Evaluator.cpp:1046; config api
    gradient_printer_evaluator). The trainer sees ``wants_gradient``
    and adds a zero tap to the layer's output (its payload, for a
    sequence), so the activation's gradient comes out of the same
    backward pass as the parameters' (no second forward)."""

    wants_gradient = True

    def __init__(self, input: LayerOutput, name: str = "gradient_printer",
                 stream=None):
        self.name = name
        self.inputs = [input]
        self.stream = stream

    def start(self):
        pass

    def eval_batch(self, values, n_real):
        import sys
        g = _rows(values[0], n_real)
        arr = np.asarray(g[0] if isinstance(g, tuple) else g)
        print(f"[{self.name}] grad {arr}", file=self.stream or sys.stdout)

    def result(self):
        return {}


class DetectionMAPEvaluator(Evaluator):
    """Mean average precision over detection outputs
    (Evaluator.cpp REGISTER_EVALUATOR detection_map,
    DetectionMAPEvaluator.cpp).

    input: a detection_output layer — rows of
    (image_id, label, score, xmin, ymin, xmax, ymax), [b, K*7].
    label: ground-truth SequenceBatch rows (label, xmin, ymin, xmax, ymax,
    difficult). AP per class via `ap_type`: '11point' (VOC 11-point
    interpolation, the reference default) or 'integral' (area under the
    raw precision-recall curve) — DetectionMAPEvaluator's ap_type option.
    Result is the mean over classes with at least one gt box.
    """

    def __init__(self, input: LayerOutput, label: LayerOutput,
                 overlap_threshold: float = 0.5, background_id: int = 0,
                 evaluate_difficult: bool = False, ap_type: str = "11point",
                 name: str = "detection_map"):
        ap_type = ap_type.lower()   # reference spells it 'Integral'
        assert ap_type in ("11point", "integral"), ap_type
        self.name = name
        self.inputs = [input, label]
        self.overlap_threshold = overlap_threshold
        self.background_id = background_id
        self.evaluate_difficult = evaluate_difficult
        self.ap_type = ap_type
        self.start()

    def start(self):
        self._dets = []          # (class, score, image_key, box)
        self._gts = {}           # (image_key, class) -> [(box, difficult)]
        self._img_base = 0

    @staticmethod
    def _iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.clip(rb - lt, 0.0, None)
        inter = wh[0] * wh[1]
        ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0) + \
            max(b[2] - b[0], 0) * max(b[3] - b[1], 0) - inter
        return inter / ua if ua > 0 else 0.0

    def eval_batch(self, values, n_real):
        det, lab = values
        det = np.asarray(_to_np(det)[0] if isinstance(_to_np(det), tuple)
                         else _to_np(det))[:n_real].reshape(n_real, -1, 7)
        ld = _to_np(lab)
        if isinstance(ld, tuple):
            gdata, glens = ld
            lab_rows = [gdata[i][:int(glens[i])] for i in range(n_real)]
        else:
            lab_rows = [ld[i] for i in range(n_real)]
        for i in range(n_real):
            key = self._img_base + i
            for row in det[i]:
                cls = int(row[1])
                if cls < 0 or cls == self.background_id:
                    continue
                self._dets.append((cls, float(row[2]), key, row[3:7].copy()))
            for g in lab_rows[i]:
                cls = int(g[0])
                diff = bool(g[5]) if len(g) > 5 else False
                self._gts.setdefault((key, cls), []).append(
                    (np.asarray(g[1:5], np.float64), diff))
        self._img_base += n_real

    def result(self):
        classes = sorted({c for _, c in self._gts})
        aps = []
        for c in classes:
            gt_items = {k: v for k, v in self._gts.items() if k[1] == c}
            n_pos = sum(1 for v in gt_items.values() for b, d in v
                        if self.evaluate_difficult or not d)
            dets = sorted((d for d in self._dets if d[0] == c),
                          key=lambda d: -d[1])
            matched = {k: [False] * len(v) for k, v in gt_items.items()}
            tp, fp = [], []
            for _, score, key, box in dets:
                gts = gt_items.get((key, c), [])
                best, best_j = 0.0, -1
                for j, (gbox, diff) in enumerate(gts):
                    ov = self._iou(box, gbox)
                    if ov > best:
                        best, best_j = ov, j
                if best >= self.overlap_threshold and best_j >= 0:
                    gbox, diff = gts[best_j]
                    if diff and not self.evaluate_difficult:
                        continue       # difficult boxes neither tp nor fp
                    if not matched[(key, c)][best_j]:
                        matched[(key, c)][best_j] = True
                        tp.append(1.0)
                        fp.append(0.0)
                    else:
                        tp.append(0.0)
                        fp.append(1.0)
                else:
                    tp.append(0.0)
                    fp.append(1.0)
            if n_pos == 0:
                continue
            tp = np.cumsum(tp) if tp else np.zeros(0)
            fp = np.cumsum(fp) if fp else np.zeros(0)
            recall = tp / n_pos
            precision = tp / np.maximum(tp + fp, 1e-12)
            ap = 0.0
            if self.ap_type == "11point":
                for t in np.arange(0.0, 1.01, 0.1):
                    p = precision[recall >= t].max() if np.any(recall >= t) \
                        else 0.0
                    ap += p / 11.0
            else:                                 # integral: sum p * dR
                prev_r = 0.0
                for p, r in zip(precision, recall):
                    ap += p * (r - prev_r)
                    prev_r = r
            aps.append(min(ap, 1.0))
        return {self.name: float(np.mean(aps)) if aps else 0.0}


# ---------------------------------------------------------------------------
# v2-style DSL constructors (trainer_config_helpers/evaluators.py names)


def auc(input, label, **kw):
    return AucEvaluator(input, label, **kw)


def classification_error(input, label, **kw):
    return ClassificationErrorEvaluator(input, label, **kw)


def precision_recall(input, label, **kw):
    return PrecisionRecallEvaluator(input, label, **kw)


def chunk(input, label, **kw):
    return ChunkEvaluator(input, label, **kw)


def ctc_error(input, label, **kw):
    return CTCErrorEvaluator(input, label, **kw)


def pnpair(input, label, query_id, **kw):
    return PnpairEvaluator(input, label, query_id, **kw)


def rank_auc(input, label, query_id, **kw):
    return RankAucEvaluator(input, label, query_id, **kw)


def sum_evaluator(input, **kw):
    return SumEvaluator(input, **kw)


def column_sum(input, **kw):
    return ColumnSumEvaluator(input, **kw)


def detection_map(input, label, **kw):
    return DetectionMAPEvaluator(input, label, **kw)


def maxid_printer(input, **kw):
    return PrinterEvaluator(input, mode="maxid", **kw)


def value_printer(input, **kw):
    return PrinterEvaluator(input, mode="value", **kw)


def seq_text_printer(input, **kw):
    """seqtext_printer_evaluator parity (Evaluator.cpp:1319)."""
    return SeqTextPrinterEvaluator(input, **kw)


def max_frame_printer(input, **kw):
    """maxframe_printer_evaluator parity (Evaluator.cpp:1142)."""
    return MaxFramePrinterEvaluator(input, **kw)


def gradient_printer(input, **kw):
    """gradient_printer_evaluator parity (Evaluator.cpp:1046)."""
    return GradientPrinterEvaluator(input, **kw)
