"""MNIST loader — the port of ``paddle_tpu/dataset/mnist.py``
(python/paddle/v2/dataset/mnist.py parity).

Samples are (image: float32[784] scaled to [-1, 1], label: int). Reads the
standard IDX files from the cache dir when present; otherwise falls back to
a deterministic synthetic set with the same shapes (see common.py).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic

_TRAIN_IMAGES = "train-images-idx3-ubyte.gz"
_TRAIN_LABELS = "train-labels-idx1-ubyte.gz"
_TEST_IMAGES = "t10k-images-idx3-ubyte.gz"
_TEST_LABELS = "t10k-labels-idx1-ubyte.gz"


def _read_idx(images_path: str, labels_path: str):
    with gzip.open(labels_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
    with gzip.open(images_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8) \
            .reshape(n, rows * cols)
    images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    return images, labels


def _reader(images_file, labels_file, synth_n, synth_seed):
    def reader():
        ip = os.path.join(common.DATA_HOME, "mnist", images_file)
        lp = os.path.join(common.DATA_HOME, "mnist", labels_file)
        # has_cached verifies the optional MD5SUMS manifest: a corrupt
        # drop-in warns and falls back to synthetic (common.py)
        if common.has_cached("mnist", images_file) and \
                common.has_cached("mnist", labels_file):
            images, labels = _read_idx(ip, lp)
        else:
            images, labels = synthetic.class_clustered(
                synth_n, 784, 10, synth_seed, center_seed=99)
            images = np.clip(images, -1.0, 1.0)
        for i in range(len(labels)):
            yield images[i], int(labels[i])
    return reader


def train():
    return _reader(_TRAIN_IMAGES, _TRAIN_LABELS, 8192, 1234)


def test():
    return _reader(_TEST_IMAGES, _TEST_LABELS, 1024, 4321)
