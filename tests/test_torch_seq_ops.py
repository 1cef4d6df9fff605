"""Port parity: the sequence ops and layers of the sequence-generation
path in paddle_tpu_torch against paddle_tpu on the CPU.

Each op (ops/sequence_ops.py) runs on the same seeded arrays in both
packages: outputs equal, and autograd's input gradients of a seeded
projection of the output equal ``jax.vjp``'s. Each layer (seq_layers,
``scaling``, the id helpers) runs in a graph built by the same DSL calls
in both, from one weight table (the JAX init through a params tar), on
one ragged or nested feed: outputs and parameter gradients equal. The
tolerance is the golden harness's, rtol 1e-4 / atol 1e-5; integer
outputs (ids, lengths, segment planes) are equal. ``sampling_id``
is held by its support and shape only: the two packages' generators
cannot draw alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu.core.data_type import (dense_vector,
                                       dense_vector_sub_sequence,
                                       integer_value_sub_sequence)
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.core.sequence import pack_nested_sequences as jpack_nested
from paddle_tpu.ops import sequence_ops as jops
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder
from paddle_tpu_torch.core import data_type as tdt
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.core.sequence import \
    pack_nested_sequences as tpack_nested
from paddle_tpu_torch.ops import sequence_ops as tops
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder
from tests.torch_parity import (ATOL, RTOL, assert_values_close,
                                check_parity, nested_rows, seq_rows,
                                submodule)

LENS = [5, 2, 7]
SPLITS = [[2, 3], [1], [3, 1, 2]]        # subsequence lengths per sample
D = 6


def _ragged(seed=0, d=D, lens=LENS):
    rng = np.random.RandomState(seed)
    data = np.zeros((len(lens), max(lens), d), np.float32)
    for i, n in enumerate(lens):
        data[i, :n] = rng.randn(n, d)
    return data, np.asarray(lens, np.int32)


def _nested(seed=0, d=D, splits=SPLITS):
    rng = np.random.RandomState(seed)
    rows = nested_rows(rng, splits, d)
    return rows, jpack_nested(rows), tpack_nested(rows)


def _vjp_parity(jfn, tfn, args, grad_args):
    """Forward equal, and the input cotangents of a seeded projection of
    the first output equal. args: numpy arrays; grad_args: the indices
    that get gradients (float)."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a, requires_grad=(i in grad_args))
             for i, a in enumerate(args)]

    def jf(*g):
        full = list(jargs)
        for i, v in zip(grad_args, g):
            full[i] = v
        return jfn(*full)

    jout, vjp = jax.vjp(jf, *[jargs[i] for i in grad_args])
    tout = tfn(*targs)
    assert_values_close(tout, jout, "out")
    j0 = jout.data if hasattr(jout, "lengths") else jout
    t0 = tout.data if hasattr(tout, "lengths") else tout
    proj = np.random.RandomState(7).randn(*j0.shape).astype(np.float32)
    if hasattr(jout, "lengths"):
        cot = jax.tree_util.tree_map(jnp.zeros_like, jout)
        cot = type(jout)(jnp.asarray(proj), *[
            None if c is None else jnp.zeros(c.shape, jax.dtypes.float0)
            for c in (cot.lengths, cot.segment_ids, cot.num_segments)])
    else:
        cot = jnp.asarray(proj)
    jg = vjp(cot)
    tg = torch.autograd.grad((t0 * torch.as_tensor(proj)).sum(),
                             [targs[i] for i in grad_args])
    for i, a, b in zip(grad_args, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d/darg{i}")


# ---------------------------------------------------------------- the ops

def test_expand_to_sequence():
    x = np.random.RandomState(1).randn(3, D).astype(np.float32)
    data, lens = _ragged()
    _vjp_parity(lambda a: jops.expand_to_sequence(
                    a, JSeq(jnp.asarray(data), jnp.asarray(lens))),
                lambda a: tops.expand_to_sequence(
                    a, TSeq(torch.tensor(data), torch.tensor(lens))),
                [x], [0])


def test_seq_concat():
    a, la = _ragged(1)
    b, lb = _ragged(2, lens=[3, 4, 1])
    _vjp_parity(lambda x, y: jops.seq_concat(JSeq(x, jnp.asarray(la)),
                                             JSeq(y, jnp.asarray(lb))),
                lambda x, y: tops.seq_concat(TSeq(x, torch.tensor(la)),
                                             TSeq(y, torch.tensor(lb))),
                [a, b], [0, 1])


def test_seq_slice():
    data, lens = _ragged(3)
    starts = np.asarray([1, 0, 2], np.int32)
    ends = np.asarray([4, 9, 5], np.int32)
    _vjp_parity(lambda x, s, e: jops.seq_slice(JSeq(x, jnp.asarray(lens)),
                                               s, e),
                lambda x, s, e: tops.seq_slice(TSeq(x, torch.tensor(lens)),
                                               s, e),
                [data, starts, ends], [0])


def test_seq_reverse():
    data, lens = _ragged(4)
    _vjp_parity(lambda x: jops.seq_reverse(JSeq(x, jnp.asarray(lens))),
                lambda x: tops.seq_reverse(TSeq(x, torch.tensor(lens))),
                [data], [0])


@pytest.mark.parametrize("clen,cstart,pad", [(3, -1, False), (3, -1, True),
                                             (4, 0, True), (2, -2, True),
                                             (5, -3, True)])
def test_context_projection(clen, cstart, pad):
    data, lens = _ragged(5)
    n_pad = max(0, -cstart) + max(0, cstart + clen - 1)
    w = np.random.RandomState(6).randn(max(n_pad, 1), D).astype(np.float32)
    args, grads = [data], [0]
    if pad:
        args, grads = [data, w], [0, 1]
    _vjp_parity(
        lambda x, *p: jops.context_projection(JSeq(x, jnp.asarray(lens)),
                                              clen, cstart,
                                              p[0] if p else None),
        lambda x, *p: tops.context_projection(TSeq(x, torch.tensor(lens)),
                                              clen, cstart,
                                              p[0] if p else None),
        args, grads)


@pytest.mark.parametrize("ptype", ["average", "sum", "max", "last", "first"])
def test_sub_seq_pool(ptype):
    _, jseq, tseq = _nested(7)
    _vjp_parity(lambda x: jops.sub_seq_pool(jseq.with_data(x), ptype),
                lambda x: tops.sub_seq_pool(tseq.with_data(x), ptype),
                [np.asarray(jseq.data)], [0])


@pytest.mark.parametrize("bounds", [(None, None), (2, 2), (3, 1)])
def test_nested_to_padded_and_back(bounds):
    _, jseq, tseq = _nested(8)
    S, Lm = bounds
    jd, jl = jops.nested_to_padded(jseq, S, Lm)
    td, tl = tops.nested_to_padded(tseq, S, Lm)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jback = jops.padded_to_nested(jd, jl, jseq.num_segments, jseq.max_len)
    tback = tops.padded_to_nested(td, tl, tseq.num_segments, tseq.max_len)
    assert_values_close(tback, jback, "padded_to_nested")
    if S is None:        # the unbounded view is lossless
        np.testing.assert_array_equal(tback.data.numpy(),
                                      np.asarray(jseq.data))


def test_nested_to_padded_gradients():
    _, jseq, tseq = _nested(9)
    _vjp_parity(lambda x: jops.nested_to_padded(jseq.with_data(x), 3, 2)[0],
                lambda x: tops.nested_to_padded(tseq.with_data(x), 3, 2)[0],
                [np.asarray(jseq.data)], [0])


# ---------------------------------------------------------- nested feeds

@pytest.mark.parametrize("kind", ["dense", "integer"])
def test_nested_feed_matches_jax(kind):
    rng = np.random.RandomState(10)
    if kind == "dense":
        col = nested_rows(rng, SPLITS, D)
        jt, tt = dense_vector_sub_sequence(D), tdt.dense_vector_sub_sequence(D)
    else:
        col = [[rng.randint(0, 50, (n,)) for n in s] for s in SPLITS]
        jt = integer_value_sub_sequence(50)
        tt = tdt.integer_value_sub_sequence(50)
    flat = [rng.randn(4).astype(np.float32) for _ in SPLITS]
    samples = list(zip(col, flat))
    jfeed = JFeeder([("ns", jt), ("x", dense_vector(4))])(samples)
    tfeed = TFeeder([("ns", tt), ("x", tdt.dense_vector(4))],
                    device="cpu")(samples)
    assert jfeed.pop("__batch_size__") == tfeed.pop("__batch_size__") == 3
    assert tfeed["ns"].is_nested
    for k in jfeed:
        assert_values_close(tfeed[k], jfeed[k], k)


# ------------------------------------------------------------ the layers

def _seq_samples(seed=11, d=D, lens=LENS):
    rng = np.random.RandomState(seed)
    return [(r,) for r in seq_rows(rng, lens, d)]


def _dt(L):
    return submodule(L, "core.data_type")


def _s(L, dim=D):
    return L.data("s", _dt(L).dense_vector_sequence(dim))


@pytest.mark.parametrize("what", ["expand", "seqconcat", "seqreshape",
                                  "seqreverse", "seqslice"])
def test_sequence_layers(what):
    def build(L):
        s = _s(L)
        h = L.fc(s, size=4, act="tanh", name="h")
        if what == "expand":
            return L.expand(L.last_seq(h), expand_as=s, name="out")
        if what == "seqconcat":
            return L.seq_concat(h, L.seq_reverse(h), name="out")
        if what == "seqreshape":
            return L.seq_reshape(h, reshape_size=2, name="out")
        if what == "seqreverse":
            return L.seq_reverse(h, name="out")
        dt = _dt(L)
        st = L.data("st", dt.dense_vector(1))
        en = L.data("en", dt.dense_vector(1))
        return L.seq_slice(h, starts=st, ends=en, name="out")

    samples = _seq_samples()
    if what == "seqslice":
        samples = [r + (np.float32([a]), np.float32([b])) for r, a, b in
                   zip(samples, [1, 0, 2], [4, 9, 6])]
    check_parity(build, samples)


@pytest.mark.parametrize("padding", [False, True])
def test_context_projection_layer(padding):
    def build(L):
        ctx = L.context_projection(_s(L), context_len=3,
                                   padding_attr=padding)
        return L.fc(ctx, size=5, act="tanh", name="out")

    check_parity(build, _seq_samples(12))


def test_subseq_layer():
    def build(L):
        dt = _dt(L)
        off = L.data("off", dt.integer_value(8))
        size = L.data("size", dt.integer_value(8))
        h = L.fc(_s(L), size=4, name="h")
        return L.sub_seq(h, off, size, name="out")

    samples = [r + (o, z) for r, o, z in
               zip(_seq_samples(13), [1, 0, 3], [3, 2, 4])]
    check_parity(build, samples)


@pytest.mark.parametrize("ptype", ["Avg", "Sum", "Max", "Last", "First"])
def test_seqpool_nested_to_sequence(ptype):
    def build(L):
        dt = _dt(L)
        pool = submodule(L, "pooling")
        ns = L.data("ns", dt.dense_vector_sub_sequence(D))
        h = L.fc(ns, size=4, act="tanh", name="h")
        return L.pooling(h, pooling_type=getattr(pool, ptype)(),
                         agg_level=1, name="out")

    rng = np.random.RandomState(14)
    check_parity(build, [(r,) for r in nested_rows(rng, SPLITS, D)])


@pytest.mark.parametrize("nested", [False, True])
def test_kmax_seq_score_layer(nested):
    def build(L):
        dt = _dt(L)
        s = L.data("s", dt.dense_vector_sub_sequence(D) if nested
                   else dt.dense_vector_sequence(D))
        score = L.fc(s, size=1, name="score")
        return [score, L.kmax_seq_score(score, beam_size=3, name="km")]

    rng = np.random.RandomState(15)
    rows = nested_rows(rng, SPLITS, D) if nested else \
        seq_rows(rng, [5, 2, 7], D)
    check_parity(build, [(r,) for r in rows])


def test_sub_nested_seq_layer():
    def build(L):
        dt = _dt(L)
        ns = L.data("ns", dt.dense_vector_sub_sequence(D))
        h = L.fc(ns, size=4, act="tanh", name="h")
        score = L.fc(L.pooling(h, agg_level=1, name="pooled"), size=1,
                     name="score")
        sel = L.kmax_seq_score(score, beam_size=2, name="sel")
        return L.sub_nested_seq(h, sel, name="out")

    rng = np.random.RandomState(16)
    check_parity(build, [(r,) for r in nested_rows(rng, SPLITS, D)])


def test_scaling_layer():
    def build(L):
        s = _s(L)
        w = L.fc(s, size=1, act="sigmoid", name="w")
        return L.scaling(w, L.fc(s, size=4, name="v"), name="out")

    check_parity(build, _seq_samples(17))


@pytest.mark.parametrize("k", [1, 3])
def test_maxid_and_eos_layers(k):
    def build(L):
        dt = _dt(L)
        x = L.data("x", dt.dense_vector(D))
        probs = L.fc(x, size=10, act="softmax", name="probs")
        mid = L.max_id(probs, beam_size=k, name="mid")
        return [probs, mid, L.eos(L.max_id(probs), eos_id=3, name="e")]

    rng = np.random.RandomState(18)
    check_parity(build, [(rng.randn(D).astype(np.float32),)
                         for _ in range(8)])


def test_maxid_ties_go_to_the_lower_id():
    from paddle_tpu_torch.layers.misc_layers import MaxIdLayer
    x = torch.tensor([[0.1, 0.4, 0.4, 0.1, 0.4]])
    for k, want in ((1, [1]), (3, [1, 2, 4])):
        got = MaxIdLayer.apply(None, "m", {"beam_size": k}, {}, [x])
        assert got.tolist() == [want]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_sampling_id_support_and_shape(mode):
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.core.registry import reset_name_counters
    reset_name_counters()
    L = tpaddle.layer
    x = L.data("x", tdt.dense_vector(6))
    ids = L.sampling_id(x, name="ids")
    topo = Topology(ids)
    probs = torch.zeros(64, 6)
    probs[:, 1], probs[:, 4] = 0.25, 0.75          # support {1, 4}
    probs[::2, 4], probs[::2, 1] = 0.0, 1.0        # even rows: only 1
    out, _ = topo.forward({}, {}, {"x": probs}, mode=mode, rng=5)
    got = out["ids"]
    assert got.shape == (64, 1) and got.dtype == torch.int32
    assert set(got[::2, 0].tolist()) == {1}
    assert set(got[1::2, 0].tolist()) <= {1, 4}
    if mode == "test":           # the argmax, as in JAX
        assert set(got[1::2, 0].tolist()) == {4}
    again, _ = topo.forward({}, {}, {"x": probs}, mode=mode, rng=5)
    assert torch.equal(again["ids"], got)


@pytest.mark.parametrize("start", [None, 0])
def test_sequence_conv_pool_network(start):
    """networks.sequence_conv_pool (text_conv_pool): the context window
    projection, an fc and a max pool over time."""
    def build(L):
        nets = submodule(L, "networks")
        return nets.sequence_conv_pool(_s(L), context_len=3, hidden_size=5,
                                       context_start=start, name="scp")

    check_parity(build, _seq_samples(19))
