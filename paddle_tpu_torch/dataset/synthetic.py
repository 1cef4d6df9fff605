"""Deterministic synthetic data generators shared by the dataset
loaders — the port of ``paddle_tpu/dataset/synthetic.py``: the same
``np.random.RandomState`` draws in the same order, so both packages
give bit-identical samples."""

from __future__ import annotations

import numpy as np


def class_clustered(n: int, dim: int, n_classes: int, seed: int,
                    noise: float = 0.7, center_seed: int = None):
    """Per-class Gaussian clusters — linearly separable-ish, so models
    actually converge (lets convergence tests assert decreasing loss).

    center_seed fixes the class centers independently of the sample seed so
    a train/test pair drawn with different `seed`s shares the same underlying
    classes (otherwise test accuracy on the synthetic fallback is noise)."""
    rng_c = np.random.RandomState(center_seed if center_seed is not None
                                  else seed)
    centers = rng_c.randn(n_classes, dim).astype(np.float32) * 1.5
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n).astype(np.int64)
    feats = centers[labels] + noise * rng.randn(n, dim).astype(np.float32)
    return feats.astype(np.float32), labels


def token_sequences(n: int, vocab: int, n_classes: int, seed: int,
                    min_len: int = 10, max_len: int = 100,
                    profile_seed: int = None):
    """Class-conditioned token sequences: each class draws from a distinct
    token-frequency profile, so bag-of-words/LSTM classifiers converge.

    profile_seed fixes the class profiles independently of the sample seed
    (same reason as class_clustered's center_seed: train/test must share
    classes)."""
    rng_p = np.random.RandomState(profile_seed if profile_seed is not None
                                  else seed)
    profiles = rng_p.dirichlet(np.ones(vocab) * 0.05, size=n_classes)
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lab = int(rng.randint(n_classes))
        L = int(rng.randint(min_len, max_len + 1))
        toks = rng.choice(vocab, size=L, p=profiles[lab])
        out.append((toks.astype(np.int64), lab))
    return out


def regression(n: int, dim: int, seed: int, noise: float = 0.1):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim).astype(np.float32)
    x = rng.randn(n, dim).astype(np.float32)
    y = x @ w + noise * rng.randn(n).astype(np.float32)
    return x, y.astype(np.float32)
