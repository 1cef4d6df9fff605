"""PASCAL VOC2012 segmentation — the port of
``paddle_tpu/dataset/voc2012.py`` (python/paddle/v2/dataset/voc2012.py
parity).

Samples: (image float32[3*H*W], label int32[H*W] class map 0..20, 255
void). Real data: DATA_HOME/voc2012/{train,val}.npz with ``images``
[n, 3, H, W] and ``masks`` [n, H, W] (decode the VOC jpg/png pairs into
that cache once); otherwise the JAX package's seeded synthetic scenes
of class-coloured rectangles with their masks."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

N_CLASSES = 21
VOID = 255
DEFAULT_SIZE = 32

# path -> (images, masks): keyed by the path, so a changed DATA_HOME
# reads its own files
_real_cache = {}


def _real(split):
    p = os.path.join(common.DATA_HOME, "voc2012", f"{split}.npz")
    if p in _real_cache:
        return _real_cache[p]
    if not os.path.exists(p):
        return None
    blob = np.load(p)
    imgs = blob["images"].astype(np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    out = (imgs.reshape(len(imgs), -1),
           blob["masks"].astype(np.int32).reshape(len(imgs), -1))
    _real_cache[p] = out
    return out


def _synthetic(n, seed, size=DEFAULT_SIZE):
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, 3, size, size), np.float32)
    masks = np.zeros((n, size, size), np.int32)
    for i in range(n):
        for _ in range(int(rng.randint(1, 4))):
            c = int(rng.randint(1, N_CLASSES))
            x0, y0 = rng.randint(0, size // 2, 2)
            w, h = rng.randint(4, size // 2, 2)
            masks[i, y0:y0 + h, x0:x0 + w] = c
            imgs[i, :, y0:y0 + h, x0:x0 + w] = \
                (np.array([c % 3, c % 5, c % 7], np.float32) / 7.0
                 ).reshape(3, 1, 1)
        imgs[i] += 0.05 * rng.rand(3, size, size)
    return imgs.reshape(n, -1), masks.reshape(n, -1)


def _reader(split, n_syn, seed):
    def reader():
        real = _real(split)
        x, y = real if real is not None else _synthetic(n_syn, seed)
        for i in range(len(x)):
            yield x[i], y[i]
    return reader


def train():
    return _reader("train", 400, 51)


def val():
    return _reader("val", 100, 52)


test = val


def convert(path):
    """RecordIO shards for cloud dispatch: they need
    ``dataset.common.convert`` (ROADMAP.md queue A.9)."""
    raise NotImplementedError(
        "voc2012.convert needs dataset.common.convert, which is not "
        "ported yet (ROADMAP.md queue A.9)")
