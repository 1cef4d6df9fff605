"""UCI housing regression — the port of
``paddle_tpu/dataset/uci_housing.py`` (python/paddle/v2/dataset/
uci_housing.py parity).

Samples: (features float32[13], price float32[1]); the first 80% of
the rows train, the rest test. Real data: DATA_HOME/uci_housing/
housing.data (whitespace-separated, the features standardized);
otherwise the JAX package's seeded linear regression set of 506 rows."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]


def _load():
    p = os.path.join(common.DATA_HOME, "uci_housing", "housing.data")
    if os.path.exists(p):
        data = np.loadtxt(p).astype(np.float32)
        x, y = data[:, :13], data[:, 13:14]
        x = (x - x.mean(0)) / (x.std(0) + 1e-6)
        return x, y
    x, y = synthetic.regression(506, 13, seed=13)
    return x.astype(np.float32), y[:, None].astype(np.float32)


def train():
    def reader():
        x, y = _load()
        n = int(len(x) * 0.8)
        for i in range(n):
            yield x[i], y[i]
    return reader


def test():
    def reader():
        x, y = _load()
        n = int(len(x) * 0.8)
        for i in range(n, len(x)):
            yield x[i], y[i]
    return reader


def convert(path):
    """RecordIO shards for cloud dispatch: they need
    ``dataset.common.convert`` (ROADMAP.md queue A.9)."""
    raise NotImplementedError(
        "uci_housing.convert needs dataset.common.convert, which is not "
        "ported yet (ROADMAP.md queue A.9)")
