"""Movie-review sentiment (the NLTK corpus) — the port of
``paddle_tpu/dataset/sentiment.py`` (python/paddle/v2/dataset/
sentiment.py parity).

Samples: (word_ids, label), label 0 negative, 1 positive. Real data:
DATA_HOME/sentiment/{train,test}.txt, lines "label<TAB>word word ...";
otherwise the JAX package's seeded synthetic reviews over a vocabulary
split by sentiment."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

WORD_DICT_LEN = 5147


def get_word_dict():
    return {i: i for i in range(WORD_DICT_LEN)}


def _parse_real(path):
    vocab = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) != 2:
                continue
            label, text = parts
            ids = [vocab.setdefault(w, len(vocab) % WORD_DICT_LEN)
                   for w in text.split()]
            if ids:
                yield ids, int(label)


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    half = WORD_DICT_LEN // 2
    for _ in range(n):
        label = int(rng.randint(2))
        ln = int(rng.randint(5, 40))
        base = rng.randint(0, half, ln)
        ids = [int(w + (half if label else 0)) for w in base]
        yield ids, label


def _reader(split, n_syn, seed):
    path = os.path.join(common.DATA_HOME, "sentiment", f"{split}.txt")

    def reader():
        if os.path.exists(path):
            yield from _parse_real(path)
        else:
            yield from _synthetic(n_syn, seed)
    return reader


def train():
    return _reader("train", 1600, 21)


def test():
    return _reader("test", 400, 22)


def convert(path):
    """RecordIO shards of the splits (the JAX package's convert: the
    same shards, the same records)."""
    from paddle_tpu_torch.dataset import common
    common.convert(path, train(), 1000, "sentiment-train")
    common.convert(path, test(), 1000, "sentiment-test")
