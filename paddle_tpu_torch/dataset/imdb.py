"""IMDB sentiment — the port of ``paddle_tpu/dataset/imdb.py``
(python/paddle/v2/dataset/imdb.py parity).

Samples: (token ids int64[seq_len], label 0/1), from the synthetic
corpus both packages draw with the same seeds (vocabulary 30000,
lengths 50-100; 4096 train and 512 test samples), so they read the same
samples."""

from __future__ import annotations

from paddle_tpu_torch.dataset import synthetic

_VOCAB = 30000


def word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _reader(n, seed):
    def reader():
        for toks, lab in synthetic.token_sequences(
                n, _VOCAB, 2, seed, min_len=50, max_len=100,
                profile_seed=1000):
            yield toks, lab
    return reader


def train(word_idx=None):
    return _reader(4096, 11)


def test(word_idx=None):
    return _reader(512, 12)


def convert(path):
    """RecordIO shards for cloud dispatch: they need
    ``dataset.common.convert``, which comes with the training
    infrastructure (ROADMAP.md queue A.9)."""
    raise NotImplementedError(
        "imdb.convert needs dataset.common.convert, which is not ported "
        "yet (ROADMAP.md queue A.9)")
