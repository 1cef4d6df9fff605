"""Port parity: the row-sparse embedding path of paddle_tpu_torch
against paddle_tpu on the CPU.

- The row ops: ``touched_ids`` / ``touched_rows`` equal to JAX's
  element for element (the sentinel ``vocab`` included) on ids with
  repeats, out-of-range values and -1 pads; ``row_sub_lookup`` equal
  to the dense lookup, its gradient ``[k, emb]`` with repeats summed on
  one row (``jax.grad``'s at rtol 1e-5); ``one_hot`` and ``sparse_dot``.
- The feeder's ``sparse_binary`` / ``sparse_float`` columns, flat and
  as sequences, bit-equal to the JAX feeder's numpy arrays.
- ``_run`` of ``tests/test_sparse.py`` in both packages from one
  weight tar, 6 batches: raw parameters, optimizer slots and row
  clocks ``_t`` within rtol 1e-5 / atol 1e-6 of JAX's, for Momentum,
  SGD, AdaGrad and Adam; the port's own sparse-against-dense
  equivalences and Adam's frozen untouched rows.
- Pruning hooks: masks equal to JAX's, masked weights 0 through
  updates, ``refresh_update_hooks`` after a late load, and the
  ``ValueError`` for a hook on a sparse table. A topology with a hook
  round-trips through the JSON port to port and across the packages in
  both directions, and a port trainer built from the deserialized JAX
  graph reaches JAX's masks.
"""

import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
import torch
from paddle_tpu.core.registry import reset_name_counters as j_reset
from paddle_tpu.ops import embedding as jemb
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.ops import embedding as temb
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_config():
    t_reset()
    yield
    tconfig.init(seed=0)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------- row ops
ID_CASES = {
    "repeats": (np.array([[3, 7], [3, 1]], np.int32), 10),
    "out_of_range_and_pads": (np.array([[-1, 12, 4, 4], [0, -1, 99, 4]],
                                       np.int32), 10),
    "seeded": (np.random.RandomState(0).randint(-2, 70, (6, 9))
               .astype(np.int32), 64),
    "one_row": (np.array([5, 5, 5], np.int32), 6),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_touched_ids_and_rows_equal_jax(case):
    ids, vocab = ID_CASES[case]
    table = np.random.RandomState(1).randn(vocab, 3).astype(np.float32)
    juids, jrows = jemb.touched_rows(jnp.asarray(table), jnp.asarray(ids))
    tuids, trows = temb.touched_rows(torch.from_numpy(table),
                                     torch.from_numpy(ids))
    assert tuids.shape == (ids.size,)
    np.testing.assert_array_equal(_np(tuids), np.asarray(juids))
    np.testing.assert_array_equal(_np(trows), np.asarray(jrows))
    np.testing.assert_array_equal(
        _np(temb.touched_ids(torch.from_numpy(ids), vocab)),
        np.asarray(jemb.touched_ids(jnp.asarray(ids), vocab)))


def test_row_sub_lookup_forward_and_row_gradient():
    rng = np.random.RandomState(2)
    vocab, emb = 50, 8
    table = rng.randn(vocab, emb).astype(np.float32)
    ids = rng.randint(0, vocab, (4, 6)).astype(np.int32)
    ids[1, 2] = ids[0, 0] = ids[3, 5]          # a repeated id
    ids[2, 4] = -1                             # a pad
    w = rng.randn(4, 6, emb).astype(np.float32)
    tuids, trows = temb.touched_rows(torch.from_numpy(table),
                                     torch.from_numpy(ids))
    rows = trows.clone().requires_grad_(True)
    got = temb.row_sub_lookup(tuids, rows, torch.from_numpy(ids), vocab)
    want = temb.embedding_lookup(torch.from_numpy(table),
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got), _np(want))
    g, = torch.autograd.grad((got * torch.from_numpy(w)).sum(), rows)
    assert g.shape == (ids.size, emb)          # [k, emb], not [vocab, emb]

    juids, jrows = jemb.touched_rows(jnp.asarray(table), jnp.asarray(ids))
    jg = jax.grad(lambda r: jnp.sum(jemb.row_sub_lookup(
        juids, r, jnp.asarray(ids), vocab) * w))(jrows)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=RTOL, atol=ATOL)
    # the repeated id's three uses sum on its one row
    pos = int(np.searchsorted(_np(tuids), ids[0, 0]))
    np.testing.assert_allclose(_np(g[pos]),
                               w[0, 0] + w[1, 2] + w[3, 5], rtol=RTOL)


def test_one_hot_and_sparse_dot_equal_jax():
    rng = np.random.RandomState(3)
    ids = rng.randint(-1, 12, (5, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(temb.one_hot(torch.from_numpy(ids), 12)),
        np.asarray(jemb.one_hot(jnp.asarray(ids), 12)))
    table = rng.randn(12, 6).astype(np.float32)
    wts = rng.rand(5, 4).astype(np.float32)
    for weights in (None, wts):
        got = temb.sparse_dot(torch.from_numpy(table), torch.from_numpy(ids),
                              None if weights is None
                              else torch.from_numpy(weights))
        want = jemb.sparse_dot(jnp.asarray(table), jnp.asarray(ids),
                               None if weights is None
                               else jnp.asarray(weights))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------- feeds
def _feed_both(types, samples):
    j = JFeeder([(f"c{i}", t(jpaddle.data_type)) for i, t in
                 enumerate(types)])(samples)
    t = TFeeder([(f"c{i}", t(tpaddle.data_type)) for i, t in
                 enumerate(types)], device="cpu")(samples)
    return j, t


def _bits_equal(t, j):
    a, b = _np(t), np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_sparse_flat_feeds_bit_equal_jax():
    rng = np.random.RandomState(4)
    binary = [[int(i) for i in rng.randint(0, 40, rng.randint(0, 6))]
              for _ in range(5)]
    binary[1] = [3, 3, -1, 39]                 # a repeat, a negative index
    floats = []
    for _ in range(5):
        idx = [int(i) for i in rng.randint(0, 40, rng.randint(1, 6))]
        floats.append((idx, rng.randn(len(idx)).astype(np.float32).tolist()))
    floats[2] = ([7, 7, -2, 7], [1.5, -2.25, 0.125, 3.0])  # last write wins
    samples = list(zip(binary, floats))
    j, t = _feed_both([lambda d: d.sparse_binary_vector(40),
                       lambda d: d.sparse_vector(40)], samples)
    for c in ("c0", "c1"):
        _bits_equal(t[c], j[c])
    assert float(t["c1"][2, 7]) == 3.0


def test_sparse_binary_sequence_feed_bit_equal_jax():
    rng = np.random.RandomState(5)
    samples = []
    for n in (3, 1, 6):
        samples.append(([[int(i) for i in rng.randint(0, 25,
                                                        rng.randint(0, 4))]
                         for _ in range(n)],))
    j, t = _feed_both([lambda d: d.sparse_binary_vector_sequence(25)],
                      samples)
    _bits_equal(t["c0"].data, j["c0"].data)
    np.testing.assert_array_equal(_np(t["c0"].lengths),
                                  np.asarray(j["c0"].lengths))


def test_sparse_feed_rejects_out_of_range_index():
    feeder = TFeeder([("s", tpaddle.data_type.sparse_binary_vector(8))],
                     device="cpu")
    with pytest.raises(IndexError):
        feeder([([1, 8],)])


# ------------------------------------------------ training against JAX
def _emb_model(pkg, vocab, emb, sparse, hook=None):
    ids = pkg.layer.data("ids", pkg.data_type.integer_value(vocab))
    lbl = pkg.layer.data("y", pkg.data_type.integer_value(2))
    e = pkg.layer.embedding(
        ids, size=emb, name="tbl",
        param_attr=pkg.attr.Param(name="_tbl_w", sparse_update=sparse))
    out = pkg.layer.fc(e, size=2, act=pkg.activation.Softmax(), name="out",
                       param_attr=pkg.attr.Param(name="_out.w0",
                                                 update_hooks=hook))
    return pkg.layer.classification_cost(out, lbl, name="cost")


def _batches(n=6, b=8, vocab=32):
    rng = np.random.RandomState(3)
    # skewed ids so many rows go untouched for several steps
    return [(rng.randint(0, vocab // 2, b) * 2, rng.randint(0, 2, b))
            for _ in range(n)]


def _run(pkg, sparse, opt_fn, batches, vocab=32, emb=4, seed=7, tar=None,
         hook=None):
    """tests/test_sparse.py's _run in ``pkg``; the port loads ``tar``."""
    (j_reset if pkg is jpaddle else t_reset)()
    if pkg is jpaddle:
        pkg.init(seed=seed)
    else:
        pkg.init(use_gpu=False, seed=seed)
    cost = _emb_model(pkg, vocab, emb, sparse, hook)
    if tar is None:
        params = pkg.create_parameters(pkg.Topology(cost))
    else:
        params = pkg.Parameters.from_tar(io.BytesIO(tar))
    buf = io.BytesIO()
    params.to_tar(buf)
    tr = pkg.SGD(cost=cost, parameters=params, update_equation=opt_fn(pkg))

    def reader():
        for ids, ys in batches:
            yield [(int(i), int(y)) for i, y in zip(ids, ys)]

    tr.train(reader, num_passes=1, event_handler=lambda e: None)
    return tr, buf.getvalue()


OPTIMIZERS = {
    "momentum": lambda p: p.optimizer.Momentum(learning_rate=0.1,
                                               momentum=0.9),
    "sgd": lambda p: p.optimizer.Momentum(learning_rate=0.1),
    "adagrad": lambda p: p.optimizer.AdaGrad(learning_rate=0.1),
    "adam": lambda p: p.optimizer.Adam(learning_rate=0.05),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sparse_training_equals_jax(opt):
    batches = _batches()
    jtr, tar = _run(jpaddle, True, OPTIMIZERS[opt], batches)
    ttr, _ = _run(tpaddle, True, OPTIMIZERS[opt], batches, tar=tar)
    assert ttr.topology.sparse_tables() == jtr.topology.sparse_tables() \
        == {"_tbl_w": "ids"}
    for k, v in jtr.parameters.raw.items():
        np.testing.assert_allclose(_np(ttr.parameters.raw[k]), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert ttr.opt_state["step"] == int(jtr.opt_state["step"]) == 6
    for k, slot in jtr.opt_state["slots"].items():
        tslot = ttr.opt_state["slots"][k]
        assert sorted(tslot) == sorted(slot), k
        for kk, v in slot.items():
            if kk == "_t":
                assert tslot[kk].dtype == torch.int32
                np.testing.assert_array_equal(_np(tslot[kk]), np.asarray(v))
            else:
                np.testing.assert_allclose(_np(tslot[kk]), np.asarray(v),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{k}/{kk}")
    jt = jtr.optimizer.test_params(jtr.parameters.raw, jtr.opt_state)
    tt = ttr.optimizer.test_params(ttr.parameters.raw, ttr.opt_state)
    for k, v in jt.items():
        np.testing.assert_allclose(_np(tt[k]), np.asarray(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("opt", ["momentum", "sgd", "adagrad"])
def test_sparse_equals_dense_in_the_port(opt):
    """Momentum's catch-up is exact, SGD and AdaGrad freeze untouched
    rows exactly: the sparse run's materialized table is the dense
    run's (tests/test_sparse.py:81-122)."""
    batches = _batches()
    d, tar = _run(tpaddle, False, OPTIMIZERS[opt], batches)
    s, _ = _run(tpaddle, True, OPTIMIZERS[opt], batches, tar=tar)
    assert s.topology.sparse_tables() and not d.topology.sparse_tables()
    dp = d.optimizer.test_params(d.parameters.raw, d.opt_state)
    sp = s.optimizer.test_params(s.parameters.raw, s.opt_state)
    for k in dp:
        np.testing.assert_allclose(_np(sp[k]), _np(dp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_adam_untouched_rows_frozen():
    vocab = 32
    batches = [(np.arange(8) * 2, np.ones(8, np.int64)) for _ in range(4)]
    tr, _ = _run(tpaddle, True, OPTIMIZERS["adam"], batches, vocab=vocab)
    slots = tr.opt_state["slots"]["_tbl_w"]
    odd = np.arange(1, vocab, 2)
    even = np.arange(0, 16, 2)
    assert (_np(slots["m"])[odd] == 0.0).all()
    assert (_np(slots["v"])[odd] == 0.0).all()
    assert (_np(slots["_t"])[odd] == 0).all()
    assert (_np(slots["_t"])[even] == 4).all()   # each fed row's last step


def _graph_leaves(t):
    """The leaf tensors that ``t``'s autograd graph reaches."""
    seen, leaves, todo = set(), [], [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            leaves.append(fn.variable)
        todo.extend(f for f, _ in fn.next_functions)
    return leaves


def test_sparse_step_makes_no_table_gradient(monkeypatch):
    """The trainer differentiates the row blocks, never the tables: no
    ``autograd.grad`` call takes a [vocab, emb] table among its inputs,
    and the loss's graph reaches a [k, emb] row block and no table."""
    vocab, emb, b = 32, 4, 8
    calls = []
    grad = torch.autograd.grad

    def spy(outputs, inputs, *args, **kwargs):
        calls.append(([tuple(x.shape) for x in inputs],
                      [tuple(x.shape) for x in _graph_leaves(outputs)]))
        return grad(outputs, inputs, *args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    _run(tpaddle, True, OPTIMIZERS["adam"], _batches(n=2, b=b, vocab=vocab),
         vocab=vocab, emb=emb)
    assert len(calls) == 2
    for inputs, leaves in calls:
        assert (vocab, emb) not in inputs and (vocab, emb) not in leaves
        assert (b, emb) in inputs and (b, emb) in leaves


# ---------------------------------------------------------------- pruning
@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.75])
def test_pruning_masks_equal_jax_and_stay_zero(ratio):
    batches = _batches()
    mk = OPTIMIZERS["momentum"]
    jtr, tar = _run(jpaddle, False, mk, batches,
                    hook=jpaddle.attr.HookAttribute("pruning", ratio))
    ttr, _ = _run(tpaddle, False, mk, batches, tar=tar,
                  hook=tpaddle.attr.HookAttribute("pruning", ratio))
    jmask = np.asarray(jtr.opt_state["slots"]["_out.w0"]["_mask"])
    tmask = _np(ttr.opt_state["slots"]["_out.w0"]["_mask"])
    np.testing.assert_array_equal(tmask, jmask)
    assert 0 < tmask.sum() < tmask.size
    w = _np(ttr.parameters.raw["_out.w0"])
    assert (w[tmask == 0] == 0.0).all() and (w[tmask == 1] != 0.0).any()
    np.testing.assert_allclose(w, np.asarray(jtr.parameters.raw["_out.w0"]),
                               rtol=RTOL, atol=ATOL)


def test_refresh_update_hooks_recomputes_masks_like_jax():
    mk = OPTIMIZERS["momentum"]
    jtr, tar = _run(jpaddle, False, mk, _batches(n=1),
                    hook=jpaddle.attr.HookAttribute("pruning", 0.5))
    ttr, _ = _run(tpaddle, False, mk, _batches(n=1), tar=tar,
                  hook=tpaddle.attr.HookAttribute("pruning", 0.5))
    late = np.random.RandomState(8).randn(4, 2).astype(np.float32)
    jtr.parameters.raw["_out.w0"] = jnp.asarray(late)
    jtr.refresh_update_hooks()
    with torch.no_grad():
        ttr.parameters.raw["_out.w0"].copy_(torch.from_numpy(late))
    ttr.refresh_update_hooks()
    np.testing.assert_array_equal(
        _np(ttr.opt_state["slots"]["_out.w0"]["_mask"]),
        np.asarray(jtr.opt_state["slots"]["_out.w0"]["_mask"]))


def _hooked_blob(pkg, ratio=0.5):
    (j_reset if pkg is jpaddle else t_reset)()
    cost = _emb_model(pkg, 32, 4, False,
                      hook=pkg.attr.HookAttribute("pruning", ratio))
    return pkg.Topology(cost).serialize()


@pytest.mark.parametrize("src,dst", [("port", "port"), ("jax", "port"),
                                     ("port", "jax")])
def test_hooked_topology_round_trips(src, dst):
    """A topology with a pruning hook deserializes with the hook rebuilt
    (the reading package's HookAttribute, its ratio kept) and
    serializes back to the same JSON, port to port and across the
    packages in both directions."""
    pkgs = {"port": tpaddle, "jax": jpaddle}
    blob = _hooked_blob(pkgs[src], 0.3)
    topo = pkgs[dst].Topology.deserialize(blob)
    assert topo.serialize() == blob
    attr = topo.by_name["out"].config["param_attr"][0]
    (hook,) = attr.update_hooks
    assert isinstance(hook, pkgs[dst].attr.HookAttribute)
    assert (hook.type, hook.sparsity_ratio) == ("pruning", 0.3)


def test_trainer_from_deserialized_hooked_graph_reaches_jax_masks():
    """The port trains from the JAX package's serialized topology (the
    hook rebuilt on deserialize) and reaches the JAX trainer's masks and
    weights after the steps of
    test_pruning_masks_equal_jax_and_stay_zero."""
    batches = _batches()
    mk = OPTIMIZERS["momentum"]
    jtr, tar = _run(jpaddle, False, mk, batches,
                    hook=jpaddle.attr.HookAttribute("pruning", 0.5))
    tconfig.init(use_gpu=False, seed=7)
    topo = tpaddle.Topology.deserialize(jtr.topology.serialize())
    params = tpaddle.Parameters.from_tar(io.BytesIO(tar))
    ttr = tpaddle.SGD(cost=topo.outputs[0], parameters=params,
                      update_equation=mk(tpaddle))
    ttr.train(lambda: ([(int(i), int(y)) for i, y in zip(ids, ys)]
                       for ids, ys in batches),
              num_passes=1, event_handler=lambda e: None)
    jmask = np.asarray(jtr.opt_state["slots"]["_out.w0"]["_mask"])
    tmask = _np(ttr.opt_state["slots"]["_out.w0"]["_mask"])
    np.testing.assert_array_equal(tmask, jmask)
    assert 0 < tmask.sum() < tmask.size
    w = _np(ttr.parameters.raw["_out.w0"])
    assert (w[tmask == 0] == 0.0).all()
    np.testing.assert_allclose(w, np.asarray(jtr.parameters.raw["_out.w0"]),
                               rtol=RTOL, atol=ATOL)


def test_sort_quantile_matches_jnp_quantile():
    from paddle_tpu_torch.optimizer.optimizers import _quantile
    x = np.abs(np.random.RandomState(6).randn(1001)).astype(np.float32)
    for q in (0.0, 0.1, 0.37, 0.5, 0.6, 0.99, 1.0):
        assert float(_quantile(torch.from_numpy(x), q)) == \
            float(jnp.quantile(jnp.asarray(x), q)), q


def test_pruning_hook_on_sparse_table_raises():
    t_reset()
    tpaddle.init(use_gpu=False)
    ids = tpaddle.layer.data("ids", tpaddle.data_type.integer_value(100))
    emb = tpaddle.layer.embedding(
        ids, size=8, param_attr=tpaddle.attr.Param(
            name="tbl", sparse_update=True,
            update_hooks=tpaddle.attr.HookAttribute("pruning", 0.5)))
    cost = tpaddle.layer.sum_cost(emb)
    topo = tpaddle.Topology(cost)
    assert topo.sparse_tables() == {"tbl": "ids"}
    params = tpaddle.create_parameters(topo)
    with pytest.raises(ValueError, match="pruning hook"):
        tpaddle.SGD(cost=cost, parameters=params,
                    update_equation=tpaddle.optimizer.Momentum(
                        learning_rate=0.1))


def test_sparse_tables_dense_fallbacks_equal_jax():
    """A table fed computed ids, or shared across two id sources, falls
    back to dense gradients in both packages."""
    def build(pkg):
        a = pkg.layer.data("a", pkg.data_type.integer_value(20))
        b = pkg.layer.data("b", pkg.data_type.integer_value(20))
        c = pkg.layer.data("c", pkg.data_type.integer_value(20))
        attr = pkg.attr.Param
        e1 = pkg.layer.embedding(a, size=3, param_attr=attr(
            name="shared", sparse_update=True))
        e2 = pkg.layer.embedding(b, size=3, param_attr=attr(
            name="shared", sparse_update=True))
        e3 = pkg.layer.embedding(c, size=3, param_attr=attr(
            name="own", sparse_update=True))
        return pkg.layer.sum_cost(pkg.layer.concat([e1, e2, e3]))

    j_reset()
    t_reset()
    jt = jpaddle.Topology(build(jpaddle))
    tt = tpaddle.Topology(build(tpaddle))
    assert tt.sparse_tables() == jt.sparse_tables() == {"own": "c"}


def test_remote_table_raises_naming_its_queue():
    """A remote table creates no parameter, and its forward without a
    ``sparse_sub`` raises KeyError naming the REMOTE table — the JAX
    layer's behaviour (the rows live in the embedding store)."""
    t_reset()
    ids = tpaddle.layer.data("ids", tpaddle.data_type.integer_value(10))
    emb = tpaddle.layer.embedding(ids, size=4, param_attr=tpaddle.attr.Param(
        name="r"), remote=True)
    topo = tpaddle.Topology(emb)
    assert topo.remote_tables() == {"r": "ids"}
    assert "r" not in topo.param_specs and topo.init_params() == {}
    j_reset()
    jids = jpaddle.layer.data("ids", jpaddle.data_type.integer_value(10))
    jtopo = jpaddle.Topology(jpaddle.layer.embedding(
        jids, size=4, param_attr=jpaddle.attr.Param(name="r"), remote=True))
    assert jtopo.remote_tables() == topo.remote_tables()
    feed = np.arange(4, dtype=np.int64)
    with pytest.raises(KeyError, match="REMOTE table"):
        topo.forward({}, {}, {"ids": torch.as_tensor(feed)}, mode="test")
    with pytest.raises(KeyError, match="REMOTE table"):
        jtopo.forward({}, {}, {"ids": feed}, mode="test")
