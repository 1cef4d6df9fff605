"""CIFAR-10/100 — the port of ``paddle_tpu/dataset/cifar.py``
(python/paddle/v2/dataset/cifar.py parity).

Samples: (image float32[3072] channel-major scaled to [0, 1], label).
Real data: DATA_HOME/cifar/cifar-10-python.tar.gz (the python pickles);
otherwise class-clustered synthetic images drawn as the JAX package
draws them, so both packages read the same samples."""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic


def _synthetic_reader(n, n_classes, seed):
    def reader():
        feats, labels = synthetic.class_clustered(n, 3072, n_classes, seed,
                                                  noise=0.5,
                                                  center_seed=n_classes)
        feats = (feats - feats.min()) / (feats.max() - feats.min() + 1e-6)
        for i in range(n):
            yield feats[i].astype(np.float32), int(labels[i])
    return reader


def _tar_reader(path, members_prefix, n_classes):
    def reader():
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if members_prefix in m.name and ("data_batch" in m.name or
                                                 "test_batch" in m.name or
                                                 "train" in m.name):
                    d = pickle.loads(tf.extractfile(m).read(),
                                     encoding="bytes")
                    data = d[b"data"].astype(np.float32) / 255.0
                    labels = d.get(b"labels", d.get(b"fine_labels"))
                    for x, y in zip(data, labels):
                        yield x, int(y)
    return reader


def _cifar10():
    return os.path.join(common.DATA_HOME, "cifar", "cifar-10-python.tar.gz")


def train10():
    p = _cifar10()
    if os.path.exists(p):
        return _tar_reader(p, "data_batch", 10)
    return _synthetic_reader(8192, 10, 77)


def test10():
    p = _cifar10()
    if os.path.exists(p):
        return _tar_reader(p, "test_batch", 10)
    return _synthetic_reader(1024, 10, 78)


def train100():
    return _synthetic_reader(8192, 100, 79)


def test100():
    return _synthetic_reader(1024, 100, 80)


def convert(path):
    """RecordIO shards of the splits (the JAX package's convert: the
    same shards, the same records)."""
    from paddle_tpu_torch.dataset import common
    common.convert(path, train100(), 1000, "cifar-100-train")
    common.convert(path, test100(), 1000, "cifar-100-test")
    common.convert(path, train10(), 1000, "cifar-10-train")
    common.convert(path, test10(), 1000, "cifar-10-test")
