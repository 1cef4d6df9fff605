"""WMT-14 French -> English — the port of
``paddle_tpu/dataset/wmt14.py``.

Samples are (src_ids, trg_ids, trg_next_ids) id sequences: trg starts
with <s> (START), trg_next ends with <e> (END). The real data is read
from ``DATA_HOME/wmt14/{train,test}.{src,trg}`` (parallel files, one
tokenized sentence a line, ids or words) when both files exist;
otherwise the reader yields the JAX package's seeded synthetic pairs
(3-11 source tokens, target = source + 1)."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

START = 0      # <s>
END = 1        # <e>
UNK = 2        # <unk>
DEFAULT_DICT_SIZE = 30000


def _encode(line, vocab, dict_size):
    out = []
    for t in line.strip().split():
        if t.isdigit():
            out.append(min(int(t), dict_size - 1))
        else:
            out.append(vocab.setdefault(t, 3 + len(vocab) % (dict_size - 3)))
    return out


def _parse_real(src_path, trg_path, dict_size):
    sv, tv = {}, {}
    with open(src_path, encoding="utf8") as fs, \
            open(trg_path, encoding="utf8") as ft:
        for s_line, t_line in zip(fs, ft):
            src = _encode(s_line, sv, dict_size)
            trg = _encode(t_line, tv, dict_size)
            if not src or not trg:
                continue
            yield src, [START] + trg, trg + [END]


def _synthetic(n, dict_size, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        ln = int(rng.randint(3, 12))
        src = [int(w) for w in rng.randint(3, dict_size, ln)]
        trg = [(w + 1) % dict_size for w in src]     # a learnable mapping
        yield src, [START] + trg, trg + [END]


def _reader(split, n_syn, seed, dict_size):
    src_p = os.path.join(common.DATA_HOME, "wmt14", f"{split}.src")
    trg_p = os.path.join(common.DATA_HOME, "wmt14", f"{split}.trg")

    def reader():
        if os.path.exists(src_p) and os.path.exists(trg_p):
            yield from _parse_real(src_p, trg_p, dict_size)
        else:
            yield from _synthetic(n_syn, dict_size, seed)
    return reader


def train(dict_size: int = DEFAULT_DICT_SIZE):
    return _reader("train", 2000, 14, dict_size)


def test(dict_size: int = DEFAULT_DICT_SIZE):
    return _reader("test", 400, 15, dict_size)


def convert(path, dict_size: int = DEFAULT_DICT_SIZE):
    """RecordIO shards of the splits (the JAX package's convert: the
    same shards, the same records)."""
    from paddle_tpu_torch.dataset import common
    common.convert(path, train(dict_size), 1000, "wmt14-train")
    common.convert(path, test(dict_size), 1000, "wmt14-test")
