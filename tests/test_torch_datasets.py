"""Port parity: the v2 datasets of this slice (cifar, uci_housing,
imikolov, flowers, mq2007, sentiment, voc2012), ``image.py`` and the
``gradient_printer`` evaluator of paddle_tpu_torch against paddle_tpu.

Each reader's first 64 samples are bit-identical to the JAX package's:
on the synthetic fallback (an empty ``DATA_HOME``), and on small
real-format files written into a temporary ``DATA_HOME`` as
tests/test_datasets.py writes its own. ``image.py``'s transforms give
the same arrays on a seeded uint8 image. The gradient printer's values
(d(cost)/d(activation) of its input layer) from one ``SGD`` step, from
one weight tar, equal the JAX evaluator's within 1e-5, on a flat fc
output and on a sequence's.
"""

import io
import os
import pickle
import tarfile

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.dataset as JD
import paddle_tpu.image as jimage
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.dataset as TD
import paddle_tpu_torch.image as timage

N_SAMPLES = 64
# (module, reader, args): every reader of the seven datasets
READERS = [("cifar", r, ()) for r in ("train10", "test10", "train100",
                                      "test100")] + \
    [("uci_housing", r, ()) for r in ("train", "test")] + \
    [("imikolov", r, a) for r in ("train", "test")
     for a in ((), (None, 3))] + \
    [("flowers", r, ()) for r in ("train", "valid", "test")] + \
    [("mq2007", r, (f,)) for r in ("train", "test")
     for f in ("pointwise", "pairwise", "listwise")] + \
    [("sentiment", r, ()) for r in ("train", "test")] + \
    [("voc2012", r, ()) for r in ("train", "val", "test")]
# the readers with a real-file format, and the one that has none
REAL = [c for c in READERS if c[0] != "imikolov"]
# the samples of _write_real_files's files (mq2007's are drawn)
REAL_COUNTS = {("cifar", "train10"): 70, ("cifar", "test10"): 20,
               ("uci_housing", "train"): 24, ("uci_housing", "test"): 6,
               ("flowers", "train"): 12, ("flowers", "valid"): 5,
               ("flowers", "test"): 7, ("voc2012", "train"): 9,
               ("voc2012", "val"): 4, ("voc2012", "test"): 4,
               ("sentiment", "train"): 20, ("sentiment", "test"): 20}


@pytest.fixture
def data_home(tmp_path, monkeypatch):
    """One empty DATA_HOME for both packages, and their file caches
    emptied (the JAX package keys flowers' and voc2012's by split)."""
    for pkg in (JD, TD):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(tmp_path))
        for mod in ("flowers", "voc2012"):
            monkeypatch.setattr(getattr(pkg, mod), "_real_cache", {})
        monkeypatch.setattr(pkg.mq2007, "_cache", {})
    return str(tmp_path)


def _first(reader, n=N_SAMPLES):
    out = []
    for s in reader():
        out.append(s)
        if len(out) >= n:
            break
    return out


def assert_identical(got, want, path="sample"):
    """Bit for bit: the same nesting, types, dtypes, shapes and values."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_identical(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _readers(case):
    mod, name, args = case
    return (getattr(getattr(TD, mod), name)(*args),
            getattr(getattr(JD, mod), name)(*args))


@pytest.mark.parametrize("case", READERS, ids=lambda c: "-".join(
    [c[0], c[1]] + [str(a) for a in c[2]]))
def test_synthetic_samples_are_bit_identical(case, data_home):
    treader, jreader = _readers(case)
    got, want = _first(treader), _first(jreader)
    assert len(want) > 0
    assert_identical(got, want)


def _write_real_files(root):
    """Small files in each dataset's real format under ``root``."""
    rng = np.random.RandomState(0)

    def d(name):
        p = os.path.join(root, name)
        os.makedirs(p, exist_ok=True)
        return p

    # cifar-10: the python pickles in a tar.gz
    buf = os.path.join(d("cifar"), "cifar-10-python.tar.gz")
    with tarfile.open(buf, "w:gz") as tf:
        for member, n in (("cifar-10-batches-py/data_batch_1", 40),
                          ("cifar-10-batches-py/data_batch_2", 30),
                          ("cifar-10-batches-py/test_batch", 20)):
            blob = pickle.dumps({
                b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                b"labels": [int(v) for v in rng.randint(0, 10, n)]})
            info = tarfile.TarInfo(member)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    np.savetxt(os.path.join(d("uci_housing"), "housing.data"),
               rng.rand(30, 14) * 50.0, fmt="%.4f")
    for split, n in (("train", 12), ("valid", 5), ("test", 7)):
        np.savez(os.path.join(d("flowers"), f"{split}.npz"),
                 images=rng.randint(0, 256, (n, 3, 8, 8)).astype(np.uint8),
                 labels=rng.randint(0, 102, n))
    for split, n in (("train", 9), ("val", 4)):
        np.savez(os.path.join(d("voc2012"), f"{split}.npz"),
                 images=rng.rand(n, 3, 8, 8).astype(np.float32),
                 masks=rng.randint(0, 21, (n, 8, 8)))
    for split in ("train", "test"):
        with open(os.path.join(d("mq2007"), f"{split}.txt"), "w") as f:
            for q in range(5):
                for doc in range(int(rng.randint(2, 6))):
                    feats = " ".join(f"{k}:{rng.rand():.4f}"
                                     for k in rng.choice(46, 6, False) + 1)
                    f.write(f"{rng.randint(0, 3)} qid:{q} {feats} "
                            f"# doc{doc}\n")
        with open(os.path.join(d("sentiment"), f"{split}.txt"), "w") as f:
            words = [f"w{i}" for i in range(40)]
            for _ in range(20):
                f.write(f"{rng.randint(0, 2)}\t"
                        + " ".join(rng.choice(words, rng.randint(1, 9)))
                        + "\n")
            f.write("malformed line without a tab\n")


@pytest.mark.parametrize("case", REAL, ids=lambda c: "-".join(
    [c[0], c[1]] + [str(a) for a in c[2]]))
def test_real_format_samples_are_bit_identical(case, data_home):
    _write_real_files(data_home)
    treader, jreader = _readers(case)
    # the small files whole; cifar-100 has no file (its first 64)
    n = REAL_COUNTS.get(case[:2])
    got = _first(treader, n or N_SAMPLES)
    want = _first(jreader, n or N_SAMPLES)
    if n is not None:      # the real files, not the synthetic fallback
        assert len(want) == n
    assert_identical(got, want)


def test_every_dataset_is_ported_and_convert_waits():
    assert sorted(TD.__all__) == sorted(set(JD.__all__) | {"digits"})
    for mod in ("cifar", "uci_housing", "imikolov", "flowers", "mq2007",
                "sentiment", "voc2012"):
        with pytest.raises(NotImplementedError, match="A.9"):
            getattr(TD, mod).convert("unused")
    assert TD.imikolov.build_dict() == JD.imikolov.build_dict()
    assert TD.sentiment.get_word_dict() == JD.sentiment.get_word_dict()
    assert TD.uci_housing.feature_names == JD.uci_housing.feature_names


def _image(seed=0, h=37, w=52):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("is_train", [True, False])
def test_image_transforms_are_identical(is_train):
    im = _image()
    for fn, args in (("resize_short", (24,)), ("resize_short", (80,)),
                     ("to_chw", ()), ("center_crop", (20,)),
                     ("left_right_flip", ())):
        assert_identical(getattr(timage, fn)(im, *args),
                         getattr(jimage, fn)(im, *args))
    assert_identical(
        timage.random_crop(im, 20, rng=np.random.RandomState(3)),
        jimage.random_crop(im, 20, rng=np.random.RandomState(3)))
    for mean in (None, [100.0, 110.0, 120.0]):
        assert_identical(
            timage.simple_transform(im, 32, 24, is_train, mean=mean,
                                    rng=np.random.RandomState(4)),
            jimage.simple_transform(im, 32, 24, is_train, mean=mean,
                                    rng=np.random.RandomState(4)))


def test_image_loading_and_tar_batches_are_identical(tmp_path):
    from PIL import Image
    raw = {}
    for i in range(5):
        b = io.BytesIO()
        Image.fromarray(_image(i, 12, 9)).save(b, format="PNG")
        raw[f"img{i}.png"] = b.getvalue()
    path = tmp_path / "one.png"
    path.write_bytes(raw["img0.png"])
    for color in (True, False):
        assert_identical(timage.load_image(str(path), color),
                         jimage.load_image(str(path), color))
        assert_identical(timage.load_and_transform(str(path), 10, 8, False,
                                                   color),
                         jimage.load_and_transform(str(path), 10, 8, False,
                                                   color))
    metas = []
    for pkg, image in (("port", timage), ("jax", jimage)):
        tar = tmp_path / pkg / "imgs.tar"
        tar.parent.mkdir()
        with tarfile.open(tar, "w") as tf:
            for name, blob in raw.items():
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
        meta = image.batch_images_from_tar(
            str(tar), "flowers", {f"img{i}.png": i for i in range(4)},
            num_per_batch=3)
        shards = open(meta).read().split()
        metas.append([pickle.load(open(p, "rb")) for p in shards])
    assert len(metas[0]) == 2
    assert_identical(metas[0], metas[1])


def _tap_net(pkg, seq):
    L, dt, act = pkg.layer, pkg.data_type, pkg.activation
    if seq:
        x = L.data("x", dt.dense_vector_sequence(5))
        h = L.fc(x, size=6, act=act.Tanh(), name="h")
        feat = L.pooling(h, pooling_type=pkg.pooling.Max(), name="pool")
    else:
        x = L.data("x", dt.dense_vector(5))
        h = feat = L.fc(x, size=6, act=act.Tanh(), name="h")
    out = L.fc(feat, size=3, act=act.Softmax(), name="out")
    lbl = L.data("y", dt.integer_value(3))
    cost = L.classification_cost(out, lbl, name="cost")
    return cost, [pkg.evaluator.gradient_printer(h, stream=io.StringIO()),
                  pkg.evaluator.gradient_printer(out, name="gp_out",
                                                 stream=io.StringIO())]


def _printed(pkg, seq, init_tar=None):
    """The values each gradient printer receives in one SGD step on a
    batch of 6, the init tar, and what the printers printed."""
    pkg.init(use_tpu=False, seed=3)
    cost, evs = _tap_net(pkg, seq)
    params = pkg.create_parameters(pkg.Topology(cost))
    if init_tar is not None:
        params = pkg.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    params.to_tar(buf)
    seen = {}
    for ev in evs:
        def record(values, n_real, ev=ev, orig=ev.eval_batch):
            seen[ev.name] = (values[0], n_real)
            orig(values, n_real)
        ev.eval_batch = record
    tr = pkg.SGD(cost=cost, parameters=params,
                 update_equation=pkg.optimizer.Momentum(learning_rate=0.1,
                                                        momentum=0.9),
                 evaluators=evs)
    rng = np.random.RandomState(5)
    data = [((rng.randn(int(rng.randint(1, 5)), 5) if seq else
              rng.randn(5)).astype(np.float32), int(rng.randint(0, 3)))
            for _ in range(6)]
    tr.train(lambda: iter([data]), num_passes=1, event_handler=lambda e: 0)
    return buf.getvalue(), seen, [ev.stream.getvalue() for ev in evs]


@pytest.mark.parametrize("seq", [False, True], ids=["flat", "sequence"])
def test_gradient_printer_values_match_jax(seq):
    tar, jseen, jtext = _printed(jpaddle, seq)
    _, tseen, ttext = _printed(tpaddle, seq, init_tar=tar)
    assert sorted(tseen) == sorted(jseen) == ["gp_out", "gradient_printer"]
    for k in jseen:
        (tv, tn), (jv, jn) = tseen[k], jseen[k]
        assert tn == jn == 6
        # a sequence output gives the gradient of its padded payload
        assert tv.shape == jv.shape and tv.shape[0] == 6
        assert tv.ndim == (3 if seq and k == "gradient_printer" else 2)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5, err_msg=k)
        assert np.abs(jv).max() > 0
    assert all(t.startswith("[gradient_printer] grad") or
               t.startswith("[gp_out] grad") for t in ttext)
