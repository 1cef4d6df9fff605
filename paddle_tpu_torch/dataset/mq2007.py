"""MQ2007 learning to rank (LETOR 4.0) — the port of
``paddle_tpu/dataset/mq2007.py`` (python/paddle/v2/dataset/mq2007.py
parity).

Formats (the reference's pointwise, pairwise and listwise readers):
  train/test(format="pointwise") -> (features[46], relevance)
  ...("pairwise")                -> (better_features, worse_features)
  ...("listwise")                -> (query index, [features...], [labels...])
Real data: DATA_HOME/mq2007/{train,test}.txt in LETOR format
("rel qid:ID 1:v 2:v ... # docid"); otherwise the JAX package's seeded
synthetic queries, whose relevance is a noisy linear function of the
features."""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from paddle_tpu_torch.dataset import common

FEATURE_DIM = 46


def _parse_real(path):
    queries = OrderedDict()
    with open(path, encoding="utf8") as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            rel = int(parts[0])
            qid = parts[1].split(":")[1]
            feats = np.zeros(FEATURE_DIM, np.float32)
            for p in parts[2:]:
                k, v = p.split(":")
                k = int(k) - 1
                if 0 <= k < FEATURE_DIM:
                    feats[k] = float(v)
            queries.setdefault(qid, []).append((feats, rel))
    return queries


def _synthetic(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(FEATURE_DIM)
    queries = OrderedDict()
    for q in range(n_queries):
        docs = []
        for _ in range(int(rng.randint(5, 15))):
            f = rng.randn(FEATURE_DIM).astype(np.float32)
            score = float(f @ w) + 0.1 * rng.randn()
            rel = int(np.clip(np.digitize(score, [-3, 3]), 0, 2))
            docs.append((f, rel))
        queries[f"q{q}"] = docs
    return queries


_cache = {}


def _load(split, n_syn, seed):
    key = (common.DATA_HOME, split)
    if key not in _cache:
        path = os.path.join(common.DATA_HOME, "mq2007", f"{split}.txt")
        _cache[key] = _parse_real(path) if os.path.exists(path) \
            else _synthetic(n_syn, seed)
    return _cache[key]


def _reader(split, fmt, n_syn, seed):
    def pointwise():
        for docs in _load(split, n_syn, seed).values():
            for f, rel in docs:
                yield f, float(rel)

    def pairwise():
        for docs in _load(split, n_syn, seed).values():
            for i, (fi, ri) in enumerate(docs):
                for fj, rj in docs[i + 1:]:
                    if ri > rj:
                        yield fi, fj
                    elif rj > ri:
                        yield fj, fi

    def listwise():
        for qi, (qid, docs) in enumerate(
                _load(split, n_syn, seed).items()):
            yield (qi, [f for f, _ in docs], [float(r) for _, r in docs])

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[fmt]


def train(format: str = "pointwise"):
    return _reader("train", format, 120, 31)


def test(format: str = "pointwise"):
    return _reader("test", format, 30, 32)


def convert(path):
    """RecordIO shards for cloud dispatch: they need
    ``dataset.common.convert`` (ROADMAP.md queue A.9)."""
    raise NotImplementedError(
        "mq2007.convert needs dataset.common.convert, which is not "
        "ported yet (ROADMAP.md queue A.9)")
