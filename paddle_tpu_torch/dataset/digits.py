"""The UCI handwritten digits (8x8, 1797 samples) — the data of the
digits tier of ``demo/mnist/convergence.py``, read from the copy beside
this module.

``digits.csv.gz`` is a byte copy of the file scikit-learn 1.9.0 bundles
as ``sklearn/datasets/data/digits.csv.gz`` (57,523 bytes): the test set
of the UCI ML "Optical Recognition of Handwritten Digits" data
(optdigits; creator E. Alpaydin; E. Alpaydin, C. Kaynak (1998),
Cascading Classifiers, Kybernetika), as scikit-learn distributes it
under its BSD 3-Clause license ("Copyright (c) 2007-2026 The
scikit-learn developers. All rights reserved."). Each row is 64 pixel
counts in 0..16, row-major over the 8x8 image, then the label.

``load()`` gives the arrays of ``sklearn.datasets.load_digits()``
(``images.reshape(n, 64) / 16`` as float32, the labels as int32), and
``readers()`` the 80/20 split of the convergence script's
``digits_readers(test_frac=0.2, seed=7)``. Nothing is downloaded and
there is no synthetic fallback: a missing copy raises.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "digits.csv.gz")
DIM = 64


def load():
    """(x float32 [1797, 64] in [0, 1], y int32 [1797])."""
    if not os.path.exists(PATH):
        raise FileNotFoundError(
            f"the digits copy {PATH} is missing; the port reads only it")
    with gzip.open(PATH, "rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    x = (data[:, :-1] / 16.0).astype(np.float32)
    y = data[:, -1].astype(np.int32)
    return x, y


def readers(test_frac: float = 0.2, seed: int = 7):
    """(train reader, test reader, input dim): a seeded permutation, its
    first ``test_frac`` the test set. Each reader yields
    (float32[64], int label)."""
    x, y = load()
    order = np.random.RandomState(seed).permutation(len(x))
    n_test = int(len(x) * test_frac)
    test_idx, train_idx = order[:n_test], order[n_test:]

    def reader_of(idx):
        def reader():
            for i in idx:
                yield x[i], int(y[i])
        return reader

    return reader_of(train_idx), reader_of(test_idx), DIM
