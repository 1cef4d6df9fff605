"""PTB (imikolov) language-model n-grams — the port of
``paddle_tpu/dataset/imikolov.py`` (python/paddle/v2/dataset/
imikolov.py parity).

Samples: n-gram tuples of word ids (the word-embedding demo), cut from
the JAX package's seeded token sequences over a 2048-word vocabulary,
so both packages read the same samples."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import synthetic

_VOCAB = 2048


def build_dict(min_word_freq: int = 50):
    return {f"w{i}": i for i in range(_VOCAB)}


def _ngram_reader(n_samples, n, seed):
    def reader():
        # drawn and unused, as the JAX package does
        np.random.RandomState(seed)
        seqs = synthetic.token_sequences(n_samples // 16 + 1, _VOCAB, 4, seed,
                                         min_len=n * 8, max_len=n * 16)
        count = 0
        for toks, _ in seqs:
            for i in range(len(toks) - n + 1):
                yield tuple(int(t) for t in toks[i:i + n])
                count += 1
                if count >= n_samples:
                    return
    return reader


def train(word_idx=None, n: int = 5):
    return _ngram_reader(8192, n, 21)


def test(word_idx=None, n: int = 5):
    return _ngram_reader(1024, n, 22)


def convert(path):
    """RecordIO shards of the splits (the JAX package's convert: the
    same shards, the same records)."""
    from paddle_tpu_torch.dataset import common
    w = build_dict()
    common.convert(path, train(w), 1000, "imikolov-train")
    common.convert(path, test(w), 1000, "imikolov-test")
