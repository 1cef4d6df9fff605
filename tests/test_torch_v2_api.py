"""Port parity: the v2 API around the MNIST main path of
paddle_tpu_torch against paddle_tpu on the CPU.

- ``import paddle_tpu_torch as paddle`` gives the v2 namespace of
  ``paddle_tpu/__init__.py`` (``op`` and ``model`` wait), and
  ``init(use_gpu=False)`` / ``init(use_tpu=False)`` make the CPU the
  process's device while ``init()`` keeps the card rule.
- ``attr``: ``Param`` builds the same ParamAttr fields; ``Extra`` and
  ``HookAttribute`` carry the same fields.
- Every activation of the JAX package gives its values at rtol 1e-6
  (``sequence_softmax`` over a masked time axis too, alone and as an
  fc layer's activation on a sequence).
- The readers (batch, shuffle(seed=), map_readers, compose, chain,
  firstn, buffered, xmap_readers, cache, creator) yield exactly the
  JAX package's samples in its order.
- The synthetic MNIST and CoNLL-05 sets and the synthetic generators
  are bit-identical to the JAX package's; real IDX files and the MD5
  manifest are read the same way.
- ``SGD(evaluators=...)`` rejects unknown inputs at construction and
  initialises the parameters of layers only evaluators reach;
  ``save_pass`` writes ``pass-%05d/params.tar``.
"""

import gzip
import os
import struct

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as jpaddle
import torch
from paddle_tpu import activation as jact
from paddle_tpu import attr as jattr
from paddle_tpu import reader as jreader
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import conll05 as jconll05
from paddle_tpu.dataset import mnist as jmnist
from paddle_tpu.dataset import synthetic as jsynthetic
from paddle_tpu.ops import activations as jact_ops
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder

import paddle_tpu_torch as paddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import ParamAttr as TParamAttr
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.dataset import mnist as tmnist
from paddle_tpu_torch.ops import activations as tact_ops
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder

RTOL_ACT = 1e-6
NAMESPACE = ["init", "layer", "optimizer", "trainer", "event", "Parameters",
             "create_parameters", "SGD", "infer", "Inference", "reader",
             "dataset", "Topology", "data_type", "activation", "attr",
             "pooling", "evaluator", "op"]


@pytest.fixture(autouse=True)
def _port_config():
    """Fresh port layer names; the port's process config (device, seed,
    dtype) back to its defaults after each test."""
    t_reset()
    yield
    tconfig.init(seed=0)


def test_v2_namespace():
    assert set(NAMESPACE) <= set(paddle.__all__)
    for name in NAMESPACE:
        assert getattr(paddle, name) is not None, name
    x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
    y = paddle.layer.fc(x, size=3, act=paddle.activation.Tanh())
    assert y.size == 3
    assert paddle.create_parameters is paddle.trainer.create
    assert paddle.event.EndPass is paddle.trainer.event.EndPass
    # the LayerOutput operators are installed; what waits (ROADMAP.md):
    # the model coordinator
    assert (x + x).type == "addto" and (2 * x).type == "slope_intercept"
    assert not hasattr(paddle, "model")


def test_init_cpu_request_and_card_rule():
    tconfig.init(use_gpu=False)
    assert paddle.resolve_device() == torch.device("cpu")
    tconfig.init(use_tpu=False, use_gpu=True)     # use_tpu decides
    assert paddle.resolve_device() == torch.device("cpu")
    assert paddle.create_parameters(paddle.Topology(paddle.layer.fc(
        paddle.layer.data("x", paddle.data_type.dense_vector(2)),
        size=2))).device == torch.device("cpu")
    assert paddle.resolve_device("cpu") == torch.device("cpu")
    for kw in ({}, {"use_gpu": True}, {"use_tpu": None}):
        tconfig.init(**kw)
        assert tconfig.global_config().device is None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.resolve_device()


def test_attr_matches_jax():
    kw = dict(name="w", learning_rate=0.5, l1_rate=1e-3, l2_rate=2e-3,
              initial_std=0.1, initial_mean=0.2, is_static=True,
              sparse_update=True, gradient_clipping_threshold=5.0)
    j, t = jattr.Param(**kw), paddle.attr.Param(**kw)
    assert isinstance(t, TParamAttr)
    for f in ("name", "learning_rate", "l1_rate", "l2_rate", "initial_std",
              "initial_mean", "is_static", "sparse",
              "gradient_clipping_threshold", "initializer", "update_hooks"):
        assert getattr(t, f) == getattr(j, f), f
    assert paddle.attr.ParameterAttribute is paddle.attr.Param
    assert paddle.attr.Extra is paddle.attr.ExtraAttr is \
        paddle.attr.ExtraLayerAttribute
    je = jattr.Extra(drop_rate=0.3, device=1, error_clipping_threshold=2.0)
    te = paddle.attr.Extra(drop_rate=0.3, device=1,
                           error_clipping_threshold=2.0)
    assert vars(te) == vars(je)
    assert vars(paddle.attr.HookAttribute("pruning")) == \
        vars(jattr.HookAttribute("pruning"))
    assert vars(paddle.attr.HookAttribute("pruning", 0.3)) == \
        vars(jattr.HookAttribute("pruning", 0.3))
    with pytest.raises(AssertionError):
        paddle.attr.HookAttribute("decay")


def test_activation_classes_match_jax():
    jnames = {n: getattr(jact, n).name for n in dir(jact)
              if isinstance(getattr(jact, n), type)
              and issubclass(getattr(jact, n), jact.BaseActivation)}
    tnames = {n: getattr(paddle.activation, n).name
              for n in dir(paddle.activation)
              if isinstance(getattr(paddle.activation, n), type)
              and issubclass(getattr(paddle.activation, n),
                             paddle.activation.BaseActivation)}
    assert tnames == jnames
    assert len(jnames) == 18        # 16 + Identity + the base class
    assert paddle.activation.Identity is paddle.activation.Linear
    assert tact_ops.names() == jact_ops.names()
    assert paddle.activation.to_name(paddle.activation.STanh()) == "stanh"
    with pytest.raises(KeyError):
        paddle.activation.to_name("no_such_act")


@pytest.mark.parametrize("name", sorted(set(jact_ops.names()) -
                                        {"sequence_softmax"}))
def test_activation_values_match_jax(name):
    x = np.random.RandomState(3).randn(5, 7).astype(np.float32) * 3
    x[0, :3] = [45.0, -45.0, 0.0]          # past softrelu's clip
    if name in ("log", "sqrt", "reciprocal"):
        x = np.abs(x) + 0.1
    want = np.asarray(jact_ops.get(name)(jnp.asarray(x)))
    got = tact_ops.get(name)(torch.tensor(x)).numpy()
    assert got.dtype == want.dtype
    # atol only below float32's normal range: XLA's CPU kernels flush
    # subnormal results (softmax's e^-90 here) to zero, PyTorch keeps them
    np.testing.assert_allclose(got, want, rtol=RTOL_ACT, atol=1e-37,
                               err_msg=name)


def test_sequence_softmax_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 6, 1).astype(np.float32)
    mask = (np.arange(6)[None, :] < np.array([6, 2, 4])[:, None]) \
        .astype(np.float32)
    want = np.asarray(jact_ops.sequence_softmax(jnp.asarray(x),
                                                jnp.asarray(mask)))
    got = tact_ops.sequence_softmax(torch.tensor(x),
                                    torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_ACT, atol=1e-12)
    np.testing.assert_allclose(
        tact_ops.sequence_softmax(torch.tensor(x)).numpy(),
        np.asarray(jact_ops.sequence_softmax(jnp.asarray(x))),
        rtol=RTOL_ACT)


def test_sequence_softmax_layer_matches_jax():
    """An fc with SequenceSoftmax on a ragged sequence: the mask reaches
    the activation (attention-style scores over time)."""
    def net(pkg):
        s = pkg.layer.data("s", pkg.data_type.dense_vector_sequence(5))
        return pkg.layer.fc(s, size=1, act=pkg.activation.SequenceSoftmax(),
                            name="att")
    jpaddle.init(use_tpu=False, seed=0)
    jtopo = jpaddle.Topology(net(jpaddle))
    ttopo = paddle.Topology(net(paddle))
    assert ttopo.serialize() == jtopo.serialize()
    rng = np.random.RandomState(5)
    table = {"_att.w0": rng.randn(5, 1).astype(np.float32),
             "_att.wbias": rng.randn(1).astype(np.float32)}
    samples = [(rng.randn(L, 5).astype(np.float32),) for L in (4, 1, 7)]
    jfeed = JFeeder(jtopo.data_type())(samples)
    jfeed.pop("__batch_size__")
    tfeed = TFeeder(ttopo.data_type(), device="cpu")(samples)
    tfeed.pop("__batch_size__")
    jout, _ = jtopo.forward({k: jnp.asarray(v) for k, v in table.items()},
                            {}, jfeed, mode="test")
    tout, _ = ttopo.forward({k: torch.tensor(v) for k, v in table.items()},
                            {}, tfeed, mode="test")
    want = np.asarray(jout["att"].data)
    got = tout["att"].data.numpy()
    lens = np.asarray(jout["att"].lengths)
    for i, n in enumerate(lens):           # padding positions are 0 in both
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=RTOL_ACT,
                                   atol=1e-12)
        np.testing.assert_allclose(got[i, :n].sum(), 1.0, rtol=1e-6)


def _samples(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [(int(i), float(x)) for i, x in enumerate(rng.randn(n))]


def _reader_of(rows):
    def r():
        return iter(list(rows))
    return r


def _both(fn):
    """fn(reader module) -> list of samples, for both packages."""
    return fn(jreader), fn(paddle.reader)


@pytest.mark.parametrize("case", [
    "batch", "batch_drop_last", "shuffle", "shuffle_batch", "map_readers",
    "compose", "chain", "firstn", "buffered", "xmap_ordered", "cache",
    "np_array"])
def test_readers_match_jax(case):
    rows = _samples()
    src = _reader_of(rows)
    other = _reader_of([(i * 10,) for i in range(len(rows))])
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    build = {
        "batch": lambda m: m.batch(src, 5),
        "batch_drop_last": lambda m: m.batch(src, 5, drop_last=True),
        "shuffle": lambda m: m.shuffle(src, 7, seed=11),
        "shuffle_batch": lambda m: m.batch(m.shuffle(src, 100, seed=1), 4),
        "map_readers": lambda m: m.map_readers(lambda a, b: (a[0], b[0]),
                                               src, other),
        "compose": lambda m: m.compose(src, other),
        "chain": lambda m: m.chain(src, other),
        "firstn": lambda m: m.firstn(src, 6),
        "buffered": lambda m: m.buffered(src, 3),
        "xmap_ordered": lambda m: m.xmap_readers(lambda s: s[1] * 2, src, 3,
                                                 4, order=True),
        "cache": lambda m: m.cache(src),
        "np_array": lambda m: m.creator.np_array(arr),
    }[case]
    jr, tr = _both(build)
    jout, tout = list(jr()), list(tr())
    assert len(tout) > 0
    if case == "np_array":
        np.testing.assert_array_equal(np.stack(tout), np.stack(jout))
    else:
        assert tout == jout
        assert list(tr()) == tout           # a reader re-iterates


def test_reader_xmap_unordered_compose_misaligned_and_text_file(tmp_path):
    rows = _samples()
    src = _reader_of(rows)
    got = sorted(paddle.reader.xmap_readers(lambda s: s[0], src, 4, 2)())
    assert got == sorted(jreader.xmap_readers(lambda s: s[0], src, 4, 2)())
    short = _reader_of(rows[:3])
    with pytest.raises(paddle.reader.ComposeNotAligned):
        list(paddle.reader.compose(src, short)())
    assert list(paddle.reader.compose(src, short, check_alignment=False)()) \
        == list(jreader.compose(src, short, check_alignment=False)())
    p = tmp_path / "lines.txt"
    p.write_text("a\nbb\n\nccc\n")
    assert list(paddle.reader.creator.text_file(str(p))()) == \
        list(jreader.creator.text_file(str(p))())

    def bad():
        yield 1
        raise ValueError("source failed")
    with pytest.raises(ValueError, match="source failed"):
        list(paddle.reader.buffered(bad, 2)())


def test_synthetic_generators_bit_identical():
    a = jsynthetic.class_clustered(50, 8, 3, seed=5, center_seed=9)
    b = paddle.dataset.synthetic.class_clustered(50, 8, 3, seed=5,
                                                 center_seed=9)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for (xa, la), (xb, lb) in zip(
            jsynthetic.token_sequences(20, 30, 4, seed=2, profile_seed=3),
            paddle.dataset.synthetic.token_sequences(20, 30, 4, seed=2,
                                                     profile_seed=3)):
        np.testing.assert_array_equal(xa, xb)
        assert la == lb
    for x, y in zip(jsynthetic.regression(10, 4, seed=1),
                    paddle.dataset.synthetic.regression(10, 4, seed=1)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_synthetic_bit_identical(split):
    jr, tr = getattr(jmnist, split)(), getattr(paddle.dataset.mnist, split)()
    n = 0
    for (ja, jl), (ta, tl) in zip(jr(), tr()):
        assert ta.dtype == ja.dtype == np.float32 and ta.shape == (784,)
        assert tl == jl and type(tl) is type(jl)
        np.testing.assert_array_equal(ta, ja)
        n += 1
    assert n == {"train": 8192, "test": 1024}[split]


@pytest.mark.parametrize("split", ["train", "test"])
def test_conll05_synthetic_bit_identical(split):
    t05 = paddle.dataset.conll05
    assert (t05.word_dict_len(), t05.label_dict_len(), t05.pred_dict_len()) \
        == (jconll05.word_dict_len(), jconll05.label_dict_len(),
            jconll05.pred_dict_len())
    jrows = list(getattr(jconll05, split)()())
    trows = list(getattr(t05, split)()())
    assert len(trows) == {"train": 2000, "test": 400}[split]
    assert trows == jrows
    assert all(len(r) == 9 for r in trows)


def test_shuffled_mnist_batches_equal_jax():
    """The demo's train reader: batch(shuffle(mnist.train(), 8192,
    seed=1), 128, drop_last=True)."""
    def reader(pkg):
        return pkg.reader.batch(pkg.reader.shuffle(pkg.dataset.mnist.train(),
                                                   8192, seed=1),
                                128, drop_last=True)
    nb = 0
    for jb, tb in zip(reader(jpaddle)(), reader(paddle)()):
        assert [s[1] for s in tb] == [s[1] for s in jb]
        np.testing.assert_array_equal(np.stack([s[0] for s in tb]),
                                      np.stack([s[0] for s in jb]))
        nb += 1
    assert nb == 64


def _write_idx(path_images, path_labels, images, labels):
    with gzip.open(path_labels, "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.astype(np.uint8).tobytes())
    with gzip.open(path_images, "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
        f.write(images.astype(np.uint8).tobytes())


def test_real_mnist_files_and_md5_manifest(tmp_path, monkeypatch):
    for mod in (jcommon, tcommon):
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path))
    assert tcommon.DATA_HOME == jcommon.DATA_HOME
    d = tmp_path / "mnist"
    d.mkdir()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (6, 784))
    labels = rng.randint(0, 10, 6)
    _write_idx(d / tmnist._TEST_IMAGES, d / tmnist._TEST_LABELS, images,
               labels)
    got, want = list(tmnist.test()()), list(jmnist.test()())
    assert len(got) == 6
    for (ta, tl), (ja, jl) in zip(got, want):
        np.testing.assert_array_equal(ta, ja)
        assert tl == jl
    path = str(d / tmnist._TEST_IMAGES)
    assert tcommon.file_md5(path) == jcommon.file_md5(path)
    (d / tcommon.MANIFEST_NAME).write_text(
        f"{'0' * 32}  {tmnist._TEST_IMAGES}\n")
    with pytest.warns(UserWarning, match="md5 mismatch"):
        assert not tcommon.has_cached("mnist", tmnist._TEST_IMAGES)
    with pytest.warns(UserWarning, match="md5 mismatch"):
        got = list(tmnist.test()())     # falls back to the synthetic set
    assert len(got) == 1024
    (d / tcommon.MANIFEST_NAME).write_text(
        f"{tcommon.file_md5(path)}  {tmnist._TEST_IMAGES}\n")
    assert tcommon.has_cached("mnist", tmnist._TEST_IMAGES)
    assert not tcommon.has_cached("mnist", "absent.gz")
    assert tcommon.cache_path("mnist", "x") == jcommon.cache_path("mnist", "x")


def _mlp(pkg):
    x = pkg.layer.data("x", pkg.data_type.dense_vector(6))
    h = pkg.layer.fc(x, size=5, act=pkg.activation.Relu(), name="h")
    out = pkg.layer.fc(h, size=3, act=pkg.activation.Softmax(), name="out")
    lbl = pkg.layer.data("y", pkg.data_type.integer_value(3))
    return x, h, out, lbl, pkg.layer.classification_cost(out, lbl,
                                                         name="cost")


def test_sgd_evaluator_wiring():
    tconfig.init(use_gpu=False)
    x, h, out, lbl, cost = _mlp(paddle)
    params = paddle.create_parameters(paddle.Topology(cost))
    opt = paddle.optimizer.Momentum(learning_rate=0.1)
    with pytest.raises(ValueError, match="nowhere"):
        paddle.SGD(cost=cost, parameters=params, update_equation=opt,
                   evaluators=[paddle.evaluator.classification_error(
                       out, lbl, name="ce")] +
                   [paddle.evaluator.sum_evaluator(_Named("nowhere"))])
    # a layer only an evaluator reaches: its parameters are initialised
    side = paddle.layer.fc(h, size=2, name="side")
    tr = paddle.SGD(cost=cost, parameters=params, update_equation=opt,
                    evaluators=[paddle.evaluator.sum_evaluator(side)])
    assert "_side.w0" in params.raw and "_side.wbias" in params.raw
    assert tr.topology.by_name["side"] is side


class _Named:
    def __init__(self, name):
        self.name = name


def test_save_pass_writes_pass_tar(tmp_path):
    tconfig.init(use_gpu=False)
    _, _, out, lbl, cost = _mlp(paddle)
    params = paddle.create_parameters(paddle.Topology(cost))
    tr = paddle.SGD(cost=cost, parameters=params,
                    update_equation=paddle.optimizer.Momentum(
                        learning_rate=0.1))
    rng = np.random.RandomState(0)
    tr.train_batch([(rng.randn(6).astype(np.float32), 1) for _ in range(4)])
    tr.save_pass(str(tmp_path), 3)
    path = tmp_path / "pass-00003" / "params.tar"
    assert path.is_file()
    with open(path, "rb") as f:
        loaded = paddle.Parameters.from_tar(f)
    assert loaded.device == torch.device("cpu")
    assert sorted(loaded.keys()) == sorted(params.keys())
    for k in params.keys():
        np.testing.assert_array_equal(loaded[k], params[k])
    with open(path, "rb") as f:           # and the JAX package reads it
        jloaded = jpaddle.Parameters.from_tar(f)
    for k in params.keys():
        np.testing.assert_array_equal(np.asarray(jloaded[k]), params[k])
    assert os.listdir(tmp_path) == ["pass-00003"]
