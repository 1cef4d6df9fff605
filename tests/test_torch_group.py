"""Port parity: the recurrent-group engine of paddle_tpu_torch against
paddle_tpu on the CPU.

Every graph is built by the same DSL calls in both packages (the same
JSON, sub-topologies included), runs from one weight table (the JAX
init through a params tar) on one seeded ragged or nested feed, and
gives JAX's outputs and ``jax.grad``'s parameter gradients of a seeded
projection of them at rtol 1e-4 / atol 1e-5 (the golden harness's
tolerance). Covered: the flat group forward and reverse, static
sequence and vector inputs (attention over the source), boot
layers, several outputs through get_output, remat (the same gradients
as without it), the step layers gru_step and lstm_step (expose_state
too), and the nested group — subsequence pooling, per-position inner
outputs, memory across subsequences, two levels, reverse, and the
bounded max_segments / max_sub_len view.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import data_type as tdt
from tests.torch_parity import (build_both, check_parity, feeds_of,
                                nested_rows, seq_rows, submodule, table_of)

LENS = [5, 2, 7]
SPLITS = [[2, 3], [1], [3, 1, 2]]
D, H = 4, 6


def _dt(L):
    return submodule(L, "core.data_type")


def _samples(seed, lens=LENS, d=D):
    rng = np.random.RandomState(seed)
    return [(r,) for r in seq_rows(rng, lens, d)]


def _nested_samples(seed, splits=SPLITS, d=D):
    rng = np.random.RandomState(seed)
    return [(r,) for r in nested_rows(rng, splits, d)]


# ----------------------------------------------------------- flat groups

@pytest.mark.parametrize("reverse", [False, True])
def test_simple_rnn_group(reverse):
    def build(L):
        s = L.data("s", _dt(L).dense_vector_sequence(D))

        def step(x):
            m = L.memory(name="h", size=H)
            return L.fc([x, m], size=H, act="tanh", name="h")

        g = L.recurrent_group(step=step, input=s, reverse=reverse, name="rg")
        return [g, L.last_seq(g, name="last")]

    check_parity(build, _samples(0))


def test_static_sequence_inputs_attention_step():
    def build(L):
        dt = _dt(L)
        s = L.data("s", dt.dense_vector_sequence(D))
        src = L.data("src", dt.dense_vector_sequence(H))
        proj = L.fc(src, size=H, bias_attr=False, name="proj")
        boot = L.fc(L.first_seq(src, name="first"), size=H, act="tanh",
                    name="boot")
        nets = submodule(L, "networks")

        def step(x, enc, enc_proj):
            m = L.memory(name="dec", size=H, boot_layer=boot)
            ctx = nets.simple_attention(enc, enc_proj, m, name="att")
            return L.fc([x, ctx, m], size=H, act="tanh", name="dec")

        return L.recurrent_group(
            step=step, input=[s, L.StaticInput(src, is_seq=True),
                              L.StaticInput(proj, is_seq=True)],
            name="rg")

    rng = np.random.RandomState(1)
    samples = [(a, b) for a, b in zip(seq_rows(rng, LENS, D),
                                      seq_rows(rng, [3, 6, 4], H))]
    check_parity(build, samples)


def test_static_vector_input_and_boot_layer():
    def build(L):
        dt = _dt(L)
        s = L.data("s", dt.dense_vector_sequence(D))
        v = L.data("v", dt.dense_vector(H))
        boot = L.fc(v, size=H, act="tanh", name="boot")

        def step(x, vec):
            m = L.memory(name="h", size=H, boot_layer=boot)
            return L.fc([x, vec, m], size=H, act="tanh", name="h")

        return L.recurrent_group(step=step,
                                 input=[s, L.StaticInput(v)], name="rg")

    rng = np.random.RandomState(2)
    samples = [(a, rng.randn(H).astype(np.float32))
               for a in seq_rows(rng, LENS, D)]
    check_parity(build, samples)


def test_several_outputs_with_get_output():
    def build(L):
        s = L.data("s", _dt(L).dense_vector_sequence(D))

        def step(x):
            m = L.memory(name="h", size=H)
            h = L.fc([x, m], size=H, act="tanh", name="h")
            o = L.fc(h, size=3, act="softmax", name="o")
            return [o, h]

        g = L.recurrent_group(step=step, input=s, name="rg")
        return [g, L.get_output(g, "h", name="hs"), L.get_output(g, "o")]

    jout, tout = check_parity(build, _samples(3))
    assert set(tout) == {"rg", "hs"}


@pytest.mark.parametrize("nested", [False, True])
def test_remat_gives_the_same_gradients(nested):
    """remat recomputes the step in the backward pass: outputs and
    gradients equal to the group without it (and to JAX's)."""
    def build(remat):
        def fn(L):
            dt = _dt(L)
            if nested:
                ns = L.data("ns", dt.dense_vector_sub_sequence(D))

                def step(sub):
                    m = L.memory(name="h", size=H)
                    p = L.pooling(L.fc(sub, size=H, act="tanh", name="nf"))
                    return L.fc([p, m], size=H, act="tanh", name="h")

                inp = L.SubsequenceInput(ns)
            else:
                inp = L.data("s", dt.dense_vector_sequence(D))

                def step(x):
                    m = L.memory(name="h", size=H)
                    return L.fc([x, m], size=H, act="tanh", name="h")

            return L.recurrent_group(step=step, input=inp, remat=remat,
                                     name="rg")
        return fn

    samples = _nested_samples(4) if nested else _samples(4)
    check_parity(build(True), samples)
    grads = []
    for remat in (False, True):
        jt, tt = build_both(build(remat))
        _, raw = table_of(jt)
        _, tfeed = feeds_of(jt, tt, samples)
        leaves = {k: v.clone().requires_grad_() for k, v in raw.items()}
        out, _ = tt.forward(leaves, {}, tfeed, mode="train")
        loss = (out["rg"].data ** 2).sum()
        grads.append([g.numpy() for g in torch.autograd.grad(
            loss, [leaves[k] for k in sorted(leaves)])])
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


def test_dropout_in_a_step_draws_one_mask_for_every_step():
    """The group seeds its step once per call (as the JAX package's scan
    does): a dropout inside the step drops the same units at each
    timestep."""
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.core.sequence import pack_sequences
    reset_name_counters()
    L = tpaddle.layer
    s = L.data("s", tdt.dense_vector_sequence(32))
    g = L.recurrent_group(step=lambda x: L.dropout(x, 0.5, name="d"),
                          input=s, name="rg")
    topo = tpaddle.Topology(g)
    feed = {"s": pack_sequences([np.ones((6, 32), np.float32)] * 2)}
    out, _ = topo.forward({}, {}, feed, mode="train", rng=7)
    d = out["rg"].data
    assert 0 < int((d == 0).sum()) < d.numel()
    for t in range(1, 6):
        assert torch.equal(d[:, t], d[:, 0])
    again, _ = topo.forward({}, {}, feed, mode="train", rng=8)
    assert not torch.equal(again["rg"].data, d)


# ----------------------------------------------------------- step layers

def test_gru_step_group_matches_jax():
    def build(L):
        s = L.data("s", _dt(L).dense_vector_sequence(D))

        def step(x):
            m = L.memory(name="g", size=H)
            x3 = L.fc(x, size=3 * H, bias_attr=False, name="x3")
            return L.gru_step(x3, output_mem=m, size=H, name="g")

        return L.recurrent_group(step=step, input=s, name="rg")

    check_parity(build, _samples(5))


@pytest.mark.parametrize("expose_state", [False, True])
def test_lstm_step_group_matches_jax(expose_state):
    def build(L):
        s = L.data("s", _dt(L).dense_vector_sequence(D))

        def step(x):
            if expose_state:
                # one packed [h | c] memory carries both
                hc = L.memory(name="cell", size=2 * H)
                h_prev = L.fc(hc, size=4 * H, bias_attr=False, name="hp")
                x4 = L.addto([L.fc(x, size=4 * H, name="x4"), h_prev])
                return L.lstm_step(x4, hc, size=H, name="cell",
                                   expose_state=True)
            c = L.memory(name="cell", size=H)
            x4 = L.fc(x, size=4 * H, name="x4")
            return L.lstm_step(x4, c, size=H, name="cell", act="relu")

        return L.recurrent_group(step=step, input=s, name="rg")

    check_parity(build, _samples(6))


# --------------------------------------------------------- nested groups

def test_nested_subsequence_pooling_step():
    def build(L):
        ns = L.data("ns", _dt(L).dense_vector_sub_sequence(D))

        def step(sub):
            return L.pooling(L.fc(sub, size=H, act="tanh", name="f"),
                             pooling_type=submodule(L, "pooling").Avg())

        return L.recurrent_group(step=step, input=L.SubsequenceInput(ns),
                                 name="nrg")

    _, tout = check_parity(build, _nested_samples(7))
    assert not tout["nrg"].is_nested
    assert tout["nrg"].lengths.tolist() == [2, 1, 3]


def test_nested_inner_sequence_output_stays_nested():
    def build(L):
        ns = L.data("ns", _dt(L).dense_vector_sub_sequence(D))
        return L.recurrent_group(
            step=lambda sub: L.fc(sub, size=H, act="tanh", name="f"),
            input=L.SubsequenceInput(ns), name="nrg")

    _, tout = check_parity(build, _nested_samples(8))
    assert tout["nrg"].is_nested


@pytest.mark.parametrize("reverse", [False, True])
def test_nested_memory_across_subsequences(reverse):
    def build(L):
        ns = L.data("ns", _dt(L).dense_vector_sub_sequence(D))

        def step(sub):
            m = L.memory(name="acc", size=H)
            pooled = L.pooling(L.fc(sub, size=H, name="f"),
                               pooling_type=submodule(L, "pooling").Sum())
            return L.fc([pooled, m], size=H, act="tanh", name="acc")

        return L.recurrent_group(step=step, input=L.SubsequenceInput(ns),
                                 reverse=reverse, name="nrg")

    check_parity(build, _nested_samples(9))


def test_nested_two_levels():
    def build(L):
        ns = L.data("ns", _dt(L).dense_vector_sub_sequence(D))

        def inner_step(x):
            m = L.memory(name="ih", size=H)
            return L.fc([x, m], size=H, act="tanh", name="ih")

        def outer_step(sub):
            m = L.memory(name="oh", size=H)
            h = L.recurrent_group(step=inner_step, input=sub,
                                  name="inner_rg")
            return L.fc([L.last_seq(h), m], size=H, act="tanh", name="oh")

        return L.recurrent_group(step=outer_step,
                                 input=L.SubsequenceInput(ns),
                                 name="outer_rg")

    check_parity(build, _nested_samples(10))


@pytest.mark.parametrize("bounds", [(2, 2), (3, 1), (1, 3)])
def test_nested_bounded_view(bounds):
    S, Lm = bounds

    def build(L):
        ns = L.data("ns", _dt(L).dense_vector_sub_sequence(D))

        def step(sub):
            return L.fc(sub, size=H, act="tanh", name="f")

        return L.recurrent_group(
            step=step, input=L.SubsequenceInput(ns, max_segments=S,
                                                max_sub_len=Lm),
            name="nrg")

    check_parity(build, _nested_samples(11))


def test_group_round_trips_through_json():
    """A deserialized group (its sub-topology rebuilt from the JSON) gives
    the same outputs as the built one."""
    def build(L):
        ns = L.data("ns", _dt(L).dense_vector_sub_sequence(D))

        def step(sub):
            m = L.memory(name="h", size=H)
            return L.fc([L.pooling(sub), m], size=H, act="tanh", name="h")

        return L.recurrent_group(step=step, input=L.SubsequenceInput(ns),
                                 name="nrg")

    jt, tt = build_both(build)
    t2 = tpaddle.Topology.deserialize(jt.serialize())
    table, raw = table_of(jt)
    samples = _nested_samples(12)
    _, tfeed = feeds_of(jt, tt, samples)
    a, _ = tt.forward(raw, {}, tfeed, mode="test")
    b, _ = t2.forward(raw, {}, tfeed, mode="test")
    assert torch.equal(a["nrg"].data, b["nrg"].data)
