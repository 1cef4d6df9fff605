"""Port parity: the element-wise, projection and selection layer types
of paddle_tpu_torch against paddle_tpu on the CPU.

Each of the 25 types is built in both DSLs on top of fc (or conv)
layers, on flat inputs and on sequences wherever the type maps over a
SequenceBatch, and run from one weight tar on one seeded feed: the
outputs equal JAX's, and autograd's parameter gradients of a seeded
projection of them equal ``jax.grad``'s, at rtol 1e-4 / atol 1e-5
(``tests/torch_parity.check_parity``). The cases cover data_norm's
three strategies on seeded statistics, both featmap_expand modes,
prelu at partial_sum 1, the channel size and the input size,
selective_fc with and without a selection, a channel slice of an image
(flat and NHWC), multiplex with out-of-range ids (clamped as JAX's
gather clamps), print's stdout, and data_norm's statistics staying
bit-unchanged under SGD, with no optimizer state of their own.
"""

import io

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.registry import _LAYER_REGISTRY as T_REGISTRY
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from paddle_tpu_torch.core.sequence import SequenceBatch
from tests.torch_parity import check_parity, submodule

LENS = [5, 2, 7]
B, D = 4, 6

FAMILY_TYPES = (
    "dotmul", "interpolation", "slope_intercept", "outer_prod",
    "sum_to_one_norm", "trans", "slice", "scaling_projection",
    "dotmul_projection", "trans_fc", "resize", "multiplex", "clip",
    "scale_shift", "power", "featmap_expand", "data_norm", "selective_fc",
    "print", "tensor", "conv_shift", "convex_comb", "prelu", "row_l2_norm",
    "switch_order")


@pytest.fixture(autouse=True)
def _port_config():
    yield
    tconfig.init(seed=0)


def _dt(L):
    return submodule(L, "core.data_type")


def _act(L):
    return submodule(L, "activation")


def _in(L, name, seq, size=D, act=None):
    """fc(data(name)): an input whose gradient reaches a parameter."""
    dt = _dt(L)
    x = L.data(name, dt.dense_vector_sequence(D) if seq
               else dt.dense_vector(D))
    return L.fc(x, size=size, act=act, name=f"{name}_fc")


def _cols(n_in, seq=False, n=B, seed=0):
    """Samples of ``n_in`` dense columns, each D wide (the data layers
    of a case all are): flat rows, or one sequence a LENS entry."""
    rng = np.random.RandomState(seed)
    if seq:
        return [tuple(rng.randn(L, D).astype(np.float32)
                      for _ in range(n_in)) for L in LENS]
    return [tuple(rng.randn(D).astype(np.float32) for _ in range(n_in))
            for _ in range(n)]


def _image(L, name="im", c=3, h=4, w=4):
    return L.data(name, _dt(L).dense_vector(c * h * w), height=h, width=w)


def _image_cols(n=B, c=3, h=4, w=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(c * h * w).astype(np.float32),) for _ in range(n)]


def _stats_edit(name, size, seed=5):
    """Seeded data_norm statistics: rows min, max, mean, std and the
    decimal scale, the spreads and scales positive."""
    def edit(table):
        rng = np.random.RandomState(seed)
        mn = rng.randn(size).astype(np.float32) - 2.0
        table[name] = np.stack([
            mn, mn + 1.0 + rng.rand(size).astype(np.float32) * 3,
            rng.randn(size).astype(np.float32),
            0.5 + rng.rand(size).astype(np.float32),
            10.0 ** rng.randint(0, 3, size).astype(np.float32)])
        return table
    return edit


def _case(layer_fn, n_in, seq=False, **kw):
    """A case on ``n_in`` dense inputs: ``layer_fn(L, *inputs)`` builds
    the layer over one fc each."""
    def build(L):
        ins = [_in(L, f"x{i}", seq) for i in range(n_in)]
        return layer_fn(L, *ins)
    return build, _cols(n_in, seq), kw


def _positive(L, name, seq, size=D):
    return _in(L, name, seq, size=size, act=_act(L).Sigmoid())


def _cases():
    c = {}
    for seq in (False, True):
        tag = "seq" if seq else "flat"
        c[f"dotmul_{tag}"] = _case(
            lambda L, a, b: L.dotmul(a, b, scale=0.5), 2, seq)
        c[f"slope_intercept_{tag}"] = _case(
            lambda L, a: L.slope_intercept(a, slope=-1.5, intercept=0.25),
            1, seq)
        c[f"clip_{tag}"] = _case(
            lambda L, a: L.clip(a, min=-0.3, max=0.4), 1, seq)
        c[f"scale_shift_{tag}"] = _case(
            lambda L, a: L.scale_shift(a), 1, seq)
        c[f"scaling_projection_{tag}"] = _case(
            lambda L, a: L.scaling_projection(a), 1, seq)
        c[f"dotmul_projection_{tag}"] = _case(
            lambda L, a: L.dotmul_projection(a), 1, seq)
        c[f"trans_fc_{tag}"] = _case(
            lambda L, a: L.trans_full_matrix_projection(a, size=3), 1, seq)
        c[f"slice_{tag}"] = _case(
            lambda L, a: L.slice_projection(a, 1, 4), 1, seq)
        c[f"row_l2_norm_{tag}"] = _case(
            lambda L, a: L.row_l2_norm(a), 1, seq)
        c[f"resize_{tag}"] = _case(lambda L, a: L.resize(a, size=3), 1, seq)
        c[f"featmap_expand_row_{tag}"] = _case(
            lambda L, a: L.featmap_expand(a, num_filters=3), 1, seq)
        c[f"featmap_expand_col_{tag}"] = _case(
            lambda L, a: L.featmap_expand(a, num_filters=3,
                                          as_row_vector=False), 1, seq)
        c[f"tensor_{tag}"] = _case(
            lambda L, a, b: L.tensor(a, b, size=3, act=_act(L).Tanh()),
            2, seq)
        c[f"convex_comb_{tag}"] = (
            lambda L, seq=seq: L.linear_comb(
                _in(L, "w", seq, size=3),
                _in(L, "v", seq, size=12), size=4),
            _cols(2, seq), {})
        c[f"sum_to_one_norm_{tag}"] = (
            lambda L, seq=seq: L.sum_to_one_norm(_positive(L, "x", seq)),
            _cols(1, seq), {})
        c[f"interpolation_{tag}"] = (
            lambda L, seq=seq: L.interpolation(
                input=[_in(L, "a", seq), _in(L, "b", seq)],
                weight=_positive(L, "w", seq, size=1)),
            _cols(3, seq), {})
        c[f"power_{tag}"] = (
            lambda L, seq=seq: L.power(
                input=L.sum_to_one_norm(_positive(L, "v", seq)),
                weight=_in(L, "w", seq, size=1)),
            _cols(2, seq), {})
        for strat in ("z-score", "min-max", "decimal-scaling"):
            c[f"data_norm_{strat}_{tag}"] = (
                lambda L, seq=seq, strat=strat: L.fc(
                    L.data_norm(L.data("x", _dt(L).dense_vector_sequence(D)
                                       if seq else _dt(L).dense_vector(D)),
                                data_norm_strategy=strat, name="dn"),
                    size=3, name="dn_fc"),
                _cols(1, seq), {"edit": _stats_edit("_dn.w0", D)})
        c[f"selective_fc_{tag}"] = _case(
            lambda L, a: L.selective_fc(a, size=5, act=_act(L).Tanh(),
                                        name="sfc"), 1, seq)
    c["outer_prod_flat"] = _case(lambda L, a, b: L.outer_prod(a, b), 2)
    c["trans_flat"] = _case(lambda L, a: L.trans(a), 1)
    c["conv_shift_3_flat"] = (
        lambda L: L.conv_shift(_in(L, "a", False),
                               _positive(L, "s", False, size=3)),
        _cols(2), {})
    c["conv_shift_5_flat"] = (
        lambda L: L.conv_shift(_in(L, "a", False, size=7),
                               _in(L, "s", False, size=5)),
        _cols(2), {})
    c["selective_fc_select_flat"] = (
        lambda L: L.selective_fc(
            _in(L, "x", False), size=5, act=_act(L).Tanh(), name="sfc",
            select=L.data("sel", _dt(L).dense_vector(5))),
        [(x, (np.arange(5) % (i + 2) == 0).astype(np.float32))
         for i, (x,) in enumerate(_cols(1))], {})
    c["selective_fc_no_bias_flat"] = _case(
        lambda L, a: L.selective_fc(a, size=5, bias_attr=False), 1)
    c["scale_shift_no_bias_flat"] = _case(
        lambda L, a: L.scale_shift(a, bias_attr=False), 1)
    c["prelu_partial_sum_1_flat"] = _case(lambda L, a: L.prelu(a), 1)
    c["prelu_input_size_flat"] = _case(
        lambda L, a: L.prelu(a, partial_sum=D), 1)
    # a flat channel-major image: one slope a channel of h * w values
    c["prelu_channel_size_image"] = (
        lambda L: L.fc(L.prelu(_image(L), partial_sum=16), size=3,
                       name="pr_fc"),
        _image_cols(), {})
    c["prelu_partial_sum_1_seq"] = _case(lambda L, a: L.prelu(a), 1, True)
    c["multiplex_flat"] = (
        lambda L: L.multiplex([L.data("idx", _dt(L).integer_value(3)),
                               _in(L, "a", False), _in(L, "b", False),
                               _in(L, "c", False)]),
        [(int(i),) + r for i, r in zip([2, 0, 1, 2], _cols(3))], {})
    c["slice_channel_flat_image"] = (
        lambda L: L.img_conv(
            L.slice_projection(_image(L, c=5), 1, 4, channel_slice=True),
            filter_size=3, num_filters=2, padding=1, name="sc"),
        _image_cols(c=5), {})
    c["slice_channel_nhwc_image"] = (
        lambda L: L.img_conv(
            L.slice_projection(L.img_conv(_image(L), filter_size=1,
                                          num_filters=7, name="pre"),
                               2, 6, channel_slice=True),
            filter_size=3, num_filters=2, padding=1, name="sc"),
        _image_cols(), {})
    c["switch_order_conv"] = (
        lambda L: L.fc(L.switch_order(L.img_conv(_image(L), filter_size=3,
                                                 num_filters=2, padding=1,
                                                 name="so_conv")),
                       size=3, name="so_fc"),
        _image_cols(), {})
    c["switch_order_flat_image"] = (
        lambda L: L.fc(L.switch_order(_image(L)), size=3, name="so_fc"),
        _image_cols(), {})
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_family_matches_jax(case):
    build, samples, kw = CASES[case]
    check_parity(build, samples, **kw)


def test_every_type_is_registered_and_held():
    """The 25 types are in the port's registry, each reached by a case
    here (print by its own test), and the port's registry holds every
    type of the JAX package's, 101 of 101."""
    from paddle_tpu.core.registry import _LAYER_REGISTRY as J_REGISTRY
    assert set(FAMILY_TYPES) <= set(T_REGISTRY)
    held = {t for t in FAMILY_TYPES
            if any(k.startswith(t) for k in CASES)}
    assert sorted(set(FAMILY_TYPES) - held) == ["print"]
    assert len(T_REGISTRY) == 101
    assert sorted(set(J_REGISTRY) - set(T_REGISTRY)) == []


def test_multiplex_out_of_range_ids_clamp_as_jax():
    """An id past the candidates (5 of 2), a negative one counted from
    the end (-1) and one below that (-3): JAX's gather wraps the
    negative ids once and clamps, and its gradient (a scatter) drops
    the rows still out of range; the port selects the same rows and
    passes back the same gradients."""
    samples = [(int(i),) + r for i, r in
               zip([5, -1, -3, 1, 0], _cols(2, n=5))]
    jout, _ = check_parity(
        lambda L: L.multiplex([L.data("idx", _dt(L).integer_value(2)),
                               _in(L, "a", False, size=3),
                               _in(L, "b", False, size=3)],
                              name="mx"), samples)
    out = np.asarray(jout["mx"])
    assert out.shape == (5, 3)


def test_print_prints_and_passes_its_input_through(capsys):
    """print is the identity: it returns the input object itself (a
    SequenceBatch stays one, autograd flows through) and prints the
    payload with the default format ``name: {x}`` or a given one."""
    treset()
    tconfig.init(use_gpu=False, seed=0)
    L = tpaddle.layer
    x = L.data("x", tpaddle.data_type.dense_vector_sequence(3))
    h = L.fc(x, size=2, name="h")
    p = L.print_layer(h, name="shown")
    q = L.print_layer(p, format="again {x}", name="shown2")
    out = L.fc(q, size=1, name="o")
    topo = tpaddle.Topology(out)
    params = {k: v.requires_grad_() for k, v in topo.init_params().items()}
    data = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
    feed = {"x": SequenceBatch(data, torch.tensor([2, 1]))}
    outs, _ = topo.forward(params, {}, feed,
                           output_names=["h", "shown", "shown2", "o"])
    assert outs["shown"] is outs["h"] and outs["shown2"] is outs["h"]
    assert isinstance(outs["shown"], SequenceBatch)
    shown = outs["h"].data.detach().numpy()
    assert capsys.readouterr().out == f"shown: {shown}\nagain {shown}\n"
    g = torch.autograd.grad(outs["o"].data.sum(), params["_h.w0"])[0]
    assert torch.count_nonzero(g) > 0
    # the JAX package's layer serializes alike
    jreset()
    jL = jpaddle.layer
    jx = jL.data("x", jpaddle.data_type.dense_vector_sequence(3))
    jq = jL.print_layer(jL.print_layer(jL.fc(jx, size=2, name="h"),
                                       name="shown"),
                        format="again {x}", name="shown2")
    assert jpaddle.Topology(jL.fc(jq, size=1, name="o")).serialize() == \
        topo.serialize()


def _data_norm_trainer(pkg, tar):
    pkg.init(use_gpu=False, seed=0) if pkg is tpaddle else \
        pkg.init(use_tpu=False, seed=0)
    (treset if pkg is tpaddle else jreset)()
    L = pkg.layer
    x = L.data("x", pkg.data_type.dense_vector(D))
    y = L.data("y", pkg.data_type.dense_vector(1))
    h = L.fc(L.data_norm(x, name="dn"), size=1, name="h")
    cost = L.square_error_cost(h, y, name="cost")
    params = pkg.create_parameters(pkg.Topology(cost)) if tar is None \
        else pkg.Parameters.from_tar(io.BytesIO(tar))
    opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    return pkg.SGD(cost=cost, parameters=params, update_equation=opt)


def test_data_norm_statistics_stay_static_under_sgd():
    """data_norm's [5, size] statistics are a static parameter: after 3
    Momentum steps they are bit-unchanged in both packages, its momentum
    slot is still all zeros (no optimizer state of its own), and the fc
    after it trained as JAX's did."""
    rng = np.random.RandomState(0)
    stats = _stats_edit("_dn.w0", D)({})["_dn.w0"]
    jtr = _data_norm_trainer(jpaddle, None)
    jtr.parameters["_dn.w0"] = stats
    buf = io.BytesIO()
    jtr.parameters.to_tar(buf)
    jtr = _data_norm_trainer(jpaddle, buf.getvalue())
    ttr = _data_norm_trainer(tpaddle, buf.getvalue())
    assert ttr.topology.param_specs["_dn.w0"].attr.is_static
    for _ in range(3):
        batch = [(rng.randn(D).astype(np.float32),
                  rng.randn(1).astype(np.float32)) for _ in range(8)]
        jc, _ = jtr.train_batch(batch)
        tc, _ = ttr.train_batch(batch)
        np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_array_equal(ttr.parameters["_dn.w0"], stats)
    np.testing.assert_array_equal(np.asarray(jtr.parameters["_dn.w0"]),
                                  stats)
    for v in ttr.opt_state["slots"]["_dn.w0"].values():
        assert not torch.count_nonzero(v)
    assert any(torch.count_nonzero(v) for v in
               ttr.opt_state["slots"]["_h.w0"].values())
    np.testing.assert_allclose(ttr.parameters["_h.w0"],
                               np.asarray(jtr.parameters["_h.w0"]),
                               rtol=1e-5, atol=1e-6)
