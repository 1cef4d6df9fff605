"""Image preprocessing utilities — the port's own copy of
``paddle_tpu/image.py`` (python/paddle/v2/image.py parity).

Pure numpy (the reference shells out to cv2; PIL stays an optional
import inside ``load_image_bytes``, so the loaders work in minimal
containers): resize_short, center and random crop, flip, CHW
conversion, the simple_transform / load_and_transform pipelines the
image demos feed through, and the tar-to-batches ingestion of
``batch_images_from_tar``. The same calls give the JAX package's
arrays, bit for bit.
"""

from __future__ import annotations

import numpy as np


def batch_images_from_tar(data_file: str, dataset_name: str, img2label,
                          num_per_batch: int = 1024) -> str:
    """Read images out of a tar archive and shard them into pickled batch
    files of `num_per_batch` samples each, plus a meta file listing the
    shard paths — the flowers-scale ingestion path
    (python/paddle/v2/image.py:33). Returns the meta-file path. Each shard
    is a pickle of {"label": [...], "data": [raw image bytes, ...]}."""
    import os
    import pickle
    import tarfile

    batch_dir = data_file + "_batch"
    out_path = os.path.join(batch_dir, dataset_name)
    meta_file = os.path.join(batch_dir, dataset_name + ".txt")
    # out_path appears only via the final rename below, so its existence
    # certifies a COMPLETE ingestion — a crash mid-run leaves only the
    # .tmp workdir, and the rerun redoes the work instead of silently
    # serving a partial shard set
    if os.path.exists(out_path):
        return meta_file
    work = out_path + ".tmp"
    if os.path.exists(work):
        import shutil
        shutil.rmtree(work)
    os.makedirs(work)

    data, labels, file_id = [], [], 0

    def _flush():
        nonlocal file_id, data, labels
        with open(os.path.join(work, f"batch_{file_id}"), "wb") as f:
            pickle.dump({"label": labels, "data": data}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        file_id += 1
        data, labels = [], []

    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if mem.name in img2label:
                data.append(tf.extractfile(mem).read())
                labels.append(img2label[mem.name])
                if len(data) == num_per_batch:
                    _flush()
    if data:
        _flush()

    with open(meta_file + ".tmp", "w") as meta:
        for i in range(file_id):
            meta.write(os.path.abspath(
                os.path.join(out_path, f"batch_{i}")) + "\n")
    # meta first: if we crash between the two renames, out_path is still
    # absent, so the rerun redoes the work and rewrites the meta
    os.replace(meta_file + ".tmp", meta_file)
    os.rename(work, out_path)
    return meta_file


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Decode an encoded image buffer to HWC uint8 (needs PIL)."""
    import io

    from PIL import Image

    im = Image.open(io.BytesIO(data))
    im = im.convert("RGB" if is_color else "L")
    arr = np.asarray(im)
    return arr if is_color else arr[..., None]


def load_image(path: str, is_color: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize_bilinear(im: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize in numpy (HWC)."""
    ih, iw = im.shape[:2]
    if (ih, iw) == (h, w):
        return im
    ys = np.linspace(0, ih - 1, h)
    xs = np.linspace(0, iw - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = im.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Scale so the SHORT side equals `size` (image.py:143)."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return _resize_bilinear(im, nh, nw)


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (the framework's flat channel-major feed layout)."""
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    hs = max((h - size) // 2, 0)
    ws = max((w - size) // 2, 0)
    return im[hs:hs + size, ws:ws + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng: np.random.RandomState = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    hs = rng.randint(0, max(h - size, 0) + 1)
    ws = rng.randint(0, max(w - size, 0) + 1)
    return im[hs:hs + size, ws:ws + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True,
                     mean=None, rng=None) -> np.ndarray:
    """resize-short -> crop (random+flip when training, center otherwise)
    -> CHW float32 -> optional mean subtraction (image.py:265)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(2) == 1:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean.reshape((-1,) + (1,) * (im.ndim - 1)) if mean.ndim == 1 \
            else mean
    return im


def load_and_transform(path: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True,
                       mean=None) -> np.ndarray:
    return simple_transform(load_image(path, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
