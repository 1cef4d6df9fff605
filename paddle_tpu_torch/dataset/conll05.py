"""CoNLL-2005 semantic role labeling — the port of
``paddle_tpu/dataset/conll05.py`` (v2/dataset/conll05.py parity).

Samples (the 9-slot SRL layout the sequence_tagging demo feeds):
  (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark_ids,
   label_ids) — all equal-length id sequences per sentence.
Real data: DATA_HOME/conll05/{train,test}.txt with lines
  "word<TAB>verb<TAB>label", blank line between sentences; otherwise a
deterministic synthetic corpus over the same dict sizes."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

WORD_DICT_LEN = 44068
LABEL_DICT_LEN = 106
PRED_DICT_LEN = 3162


def word_dict_len() -> int:
    return WORD_DICT_LEN


def label_dict_len() -> int:
    return LABEL_DICT_LEN


def pred_dict_len() -> int:
    return PRED_DICT_LEN


def get_dict():
    """(word_dict, verb_dict, label_dict) as id maps (synthetic: ranges)."""
    return ({i: i for i in range(WORD_DICT_LEN)},
            {i: i for i in range(PRED_DICT_LEN)},
            {i: i for i in range(LABEL_DICT_LEN)})


def _ctx(words, i, off):
    j = min(max(i + off, 0), len(words) - 1)
    return words[j]


def _to_sample(words, verb, marks, labels):
    n = len(words)
    return (words,
            [_ctx(words, i, -2) for i in range(n)],
            [_ctx(words, i, -1) for i in range(n)],
            list(words),
            [_ctx(words, i, 1) for i in range(n)],
            [_ctx(words, i, 2) for i in range(n)],
            [verb] * n, marks, labels)


def _parse_real(path):
    """One SRL sample PER PREDICATE (the reference yields a separate
    sample for each predicate, marks set only at that predicate)."""
    wd, vd, ld = {}, {}, {}

    def emit(rows):
        words = [wd.setdefault(w, len(wd)) % WORD_DICT_LEN
                 for w, _, _ in rows]
        labels = [ld.setdefault(l, len(ld)) % LABEL_DICT_LEN
                  for _, _, l in rows]
        for pos, (_, v, _) in enumerate(rows):
            if v in ("-", "_"):
                continue
            verb = vd.setdefault(v, len(vd)) % PRED_DICT_LEN
            marks = [1 if i == pos else 0 for i in range(len(rows))]
            yield _to_sample(words, verb, marks, labels)

    rows = []
    with open(path, encoding="utf8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                yield from emit(rows)
                rows = []
                continue
            w, v, l = (line.split("\t") + ["-", "O"])[:3]
            rows.append((w, v, l))
    yield from emit(rows)


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        ln = int(rng.randint(4, 20))
        words = [int(w) for w in rng.randint(0, WORD_DICT_LEN, ln)]
        pred_pos = int(rng.randint(ln))
        marks = [1 if i == pred_pos else 0 for i in range(ln)]
        verb = int(rng.randint(PRED_DICT_LEN))
        labels = [int(l) for l in rng.randint(0, LABEL_DICT_LEN, ln)]
        yield _to_sample(words, verb, marks, labels)


def _reader(split, n_syn, seed):
    path = os.path.join(common.DATA_HOME, "conll05", f"{split}.txt")

    def reader():
        if os.path.exists(path):
            yield from _parse_real(path)
        else:
            yield from _synthetic(n_syn, seed)
    return reader


def train():
    return _reader("train", 2000, 5)


def test():
    return _reader("test", 400, 6)


def convert(path):
    """RecordIO shards of the splits (the JAX package's convert: the
    same shards, the same records)."""
    from paddle_tpu_torch.dataset import common
    common.convert(path, test(), 1000, "conll05-test")
