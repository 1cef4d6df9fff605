"""MovieLens-1M — the port of ``paddle_tpu/dataset/movielens.py``
(python/paddle/v2/dataset/movielens.py parity).

Samples: (user_id, gender_id, age_id, job_id, movie_id, category_ids,
title_ids, score). Real data: ml-1m's users.dat / movies.dat /
ratings.dat under DATA_HOME/movielens/; otherwise the JAX package's
deterministic synthetic catalog with the same field ranges (the same
seed and draws, so both packages read the same samples)."""

from __future__ import annotations

import os
import re

import numpy as np

from paddle_tpu_torch.dataset import common

AGES = [1, 18, 25, 35, 45, 50, 56]
MAX_JOB = 20
N_CATEGORIES = 18
TITLE_VOCAB = 5000


def _real_dir():
    d = os.path.join(common.DATA_HOME, "movielens")
    if all(os.path.exists(os.path.join(d, f))
           for f in ("users.dat", "movies.dat", "ratings.dat")):
        return d
    return None


def _load_real(d):
    users = {}
    with open(os.path.join(d, "users.dat"), encoding="latin1") as f:
        for line in f:
            uid, gender, age, job, _zip = line.strip().split("::")
            users[int(uid)] = (0 if gender == "F" else 1,
                               AGES.index(int(age)), int(job))
    movies, categories, title_vocab = {}, {}, {}
    with open(os.path.join(d, "movies.dat"), encoding="latin1") as f:
        for line in f:
            mid, title, cats = line.strip().split("::")
            cat_ids = [categories.setdefault(c, len(categories))
                       for c in cats.split("|")]
            words = re.sub(r"\(\d{4}\)$", "", title).strip().lower().split()
            tids = [title_vocab.setdefault(w, len(title_vocab))
                    for w in words]
            movies[int(mid)] = (cat_ids, tids)
    ratings = []
    with open(os.path.join(d, "ratings.dat"), encoding="latin1") as f:
        for line in f:
            uid, mid, score, _ts = line.strip().split("::")
            uid, mid = int(uid), int(mid)
            if uid in users and mid in movies:
                g, a, j = users[uid]
                cats, tids = movies[mid]
                ratings.append((uid, g, a, j, mid, cats, tids,
                                float(score)))
    return ratings


def _load_synthetic(n=8000, seed=1337):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        uid = int(rng.randint(1, max_user_id() + 1))
        mid = int(rng.randint(1, max_movie_id() + 1))
        cats = [int(c) for c in
                rng.randint(0, N_CATEGORIES, rng.randint(1, 4))]
        tids = [int(t) for t in
                rng.randint(0, TITLE_VOCAB, rng.randint(1, 6))]
        score = float(1 + (uid * 7 + mid * 13) % 5)   # learnable signal
        out.append((uid, int(rng.randint(2)), int(rng.randint(len(AGES))),
                    int(rng.randint(MAX_JOB + 1)), mid, cats, tids, score))
    return out


_cache = {}


def _load():
    # memoized per DATA_HOME: the ratings are parsed once
    key = common.DATA_HOME
    if key not in _cache:
        d = _real_dir()
        _cache[key] = _load_real(d) if d else _load_synthetic()
    return _cache[key]


def max_user_id() -> int:
    return 6040


def max_movie_id() -> int:
    return 3952


def max_job_id() -> int:
    return MAX_JOB


def age_table():
    return list(AGES)


def movie_categories():
    return N_CATEGORIES


def train(seed: int = 0):
    def reader():
        for i, s in enumerate(_load()):
            if i % 10 != 1:                 # ~90/10 split, deterministic
                yield s
    return reader


def test(seed: int = 0):
    def reader():
        for i, s in enumerate(_load()):
            if i % 10 == 1:
                yield s
    return reader
