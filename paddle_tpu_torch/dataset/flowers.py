"""Oxford-102 flowers — the port of ``paddle_tpu/dataset/flowers.py``
(python/paddle/v2/dataset/flowers.py parity).

Samples: (image float32[3*H*W] flattened channel-major, label int
0..101). Real data: DATA_HOME/flowers/{train,valid,test}.npz with
arrays ``images`` [n, 3, H, W] (uint8 or float) and ``labels`` [n]
(decode the jpgs once into that cache — image codecs stay out of the
loader); otherwise the JAX package's seeded synthetic images whose
class tints the channels."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

N_CLASSES = 102
DEFAULT_SIZE = 32     # synthetic fallback resolution (3*32*32 features)

# (path, split) -> (images, labels): keyed by the path, so a changed
# DATA_HOME reads its own files
_real_cache = {}


def _real(split):
    p = os.path.join(common.DATA_HOME, "flowers", f"{split}.npz")
    if p in _real_cache:
        return _real_cache[p]
    if not os.path.exists(p):
        return None
    blob = np.load(p)
    imgs = blob["images"].astype(np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    out = (imgs.reshape(len(imgs), -1), blob["labels"].astype(np.int64))
    _real_cache[p] = out
    return out


def _synthetic(split, n, seed, size=DEFAULT_SIZE):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, N_CLASSES, n)
    imgs = rng.rand(n, 3, size, size).astype(np.float32) * 0.3
    # class-dependent channel tint => linearly separable signal
    for c in range(3):
        imgs[:, c] += ((labels % (3 + c + 1)) / (3.0 + c)).reshape(-1, 1, 1)
    return imgs.reshape(n, -1), labels


def _reader(split, n_syn, seed):
    def reader():
        real = _real(split)
        x, y = real if real is not None else _synthetic(split, n_syn, seed)
        for i in range(len(x)):
            yield x[i], int(y[i])
    return reader


def train():
    return _reader("train", 1020, 41)


def valid():
    return _reader("valid", 306, 42)


def test():
    return _reader("test", 306, 43)


def convert(path):
    """RecordIO shards of the splits (the JAX package's convert: the
    same shards, the same records)."""
    from paddle_tpu_torch.dataset import common
    common.convert(path, train(), 200, "flowers-train")
    common.convert(path, valid(), 200, "flowers-valid")
    common.convert(path, test(), 200, "flowers-test")
