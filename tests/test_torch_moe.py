"""Port parity: paddle_tpu_torch/ops/moe.py and layers/moe_layers.py
against paddle_tpu on the CPU, at a small size (d 6-16, 2-4 experts,
16-24 tokens).

- ``moe_dispatch``: the dispatch tensor exactly JAX's, combine and aux
  at rtol 1e-6, with and without padded rows, and the trimmed batch's
  rows at fixed capacity.
- ``moe_ffn`` on the sort path (the port's "auto") against JAX's
  einsum and sort paths at k 1 and 2 (and 3), with and without
  capacity drops, its gradients against ``jax.grad`` at rtol 1e-4 /
  atol 1e-5; the port's einsum path against JAX's.
- The layers: the ``k > E`` refusal, ``n_real`` masking of the aux
  cost, ``moe_block``'s graph through ``check_parity`` (forward and
  gradients of the shared gate), and the MoE transformer_lm's costs
  over three ``Adam(1e-3)`` steps from one weight table at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu.ops import moe as jmoe
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from paddle_tpu_torch.ops import moe as tmoe
from tests.torch_parity import (ATOL, RTOL, check_parity, submodule,
                                table_of)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("n,E,k,cap,pad", [(12, 4, 2, 3, 0),
                                           (12, 4, 1, 5, 0),
                                           (16, 3, 3, 4, 5),
                                           (10, 2, 2, 10, 3)])
def test_dispatch_matches_jax(n, E, k, cap, pad):
    rng = np.random.RandomState(n + E + k)
    logits = rng.randn(n, E).astype(np.float32)
    valid = None
    if pad:
        valid = np.array([1.0] * (n - pad) + [0.0] * pad, np.float32)
    jd, jc, ja = jmoe.moe_dispatch(jnp.asarray(logits),
                                   None if valid is None
                                   else jnp.asarray(valid),
                                   k=k, capacity=cap)
    td, tc, ta = tmoe.moe_dispatch(_t(logits),
                                   None if valid is None else _t(valid),
                                   k=k, capacity=cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # the aux cost layer's aux, computed without the [n, E, C] tensors
    np.testing.assert_allclose(
        float(tmoe.moe_aux_loss(_t(logits),
                                None if valid is None else _t(valid))),
        float(ja), rtol=1e-6)


def test_capacity_drops_and_uniform_router():
    d, _, aux = tmoe.moe_dispatch(torch.zeros(8, 4), None, k=2, capacity=8)
    assert abs(float(aux) - 1.0) < 1e-6
    # all tokens prefer expert 0; capacity 2 keeps the first 2 only
    d, _, _ = tmoe.moe_dispatch(torch.tensor([[5.0, 0.0]] * 4), None, k=1,
                                capacity=2)
    assert d[:2, 0].sum() == 2 and d[2:, 0].sum() == 0
    # invalid rows eat no capacity and dispatch nowhere
    d, _, _ = tmoe.moe_dispatch(torch.tensor([[5.0, 0.0]] * 4),
                                torch.tensor([0.0, 0.0, 1.0, 1.0]), k=1,
                                capacity=2)
    assert d[:2].sum() == 0 and d[2:, 0].sum() == 2


def test_masked_rows_match_trimmed_batch():
    rng = np.random.RandomState(0)
    logits6 = torch.tensor(rng.randn(6, 2).astype(np.float32))
    logits8 = torch.cat([logits6, torch.zeros(2, 2)])
    valid = torch.tensor([1.0] * 6 + [0.0] * 2)
    d6, c6, a6 = tmoe.moe_dispatch(logits6, None, k=2, capacity=3)
    d8, c8, a8 = tmoe.moe_dispatch(logits8, valid, k=2, capacity=3)
    assert torch.equal(d8[:6], d6) and float(d8[6:].sum()) == 0.0
    np.testing.assert_allclose(c8[:6].numpy(), c6.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(a8), float(a6), rtol=1e-6)


def test_capacity_is_the_reference_expression():
    for args in [(8192, 8, 2, 1.25), (100, 3, 2, 1.0), (7, 4, 1, 0.1),
                 (4352, 8, 2, 2.0), (24, 4, 2, 1.25)]:
        assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)
    assert tmoe.moe_capacity(8192, 8, 2, 1.25) == 2560


def test_k_beyond_experts_and_mesh_refused():
    with pytest.raises(ValueError, match="k=3"):
        tmoe.moe_dispatch(torch.zeros(4, 2), None, k=3, capacity=4)
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="k=3"):
        tmoe.moe_ffn(x, None, torch.zeros(3, 2), torch.zeros(2, 3, 5),
                     torch.zeros(2, 5, 3), k=3, dispatch_mode="sort")
    with pytest.raises(NotImplementedError, match="A.10"):
        tmoe.moe_ffn(x, None, torch.zeros(3, 2), torch.zeros(2, 3, 5),
                     torch.zeros(2, 5, 3), mesh=object())
    with pytest.raises(ValueError, match="dispatch_mode"):
        tmoe.moe_ffn(x, None, torch.zeros(3, 2), torch.zeros(2, 3, 5),
                     torch.zeros(2, 5, 3), dispatch_mode="ring")
    treset()
    xin = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(6))
    with pytest.raises(ValueError, match="expert_num=2"):
        tpaddle.layer.moe(xin, expert_num=2, k=3)


# ------------------------------------------------------------------ ffn

def _ffn_inputs(n, d, E, f, seed, valid=None):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(n, d).astype(np.float32),
                gate_w=rng.randn(d, E).astype(np.float32),
                w_up=(0.1 * rng.randn(E, d, f)).astype(np.float32),
                w_down=(0.1 * rng.randn(E, f, d)).astype(np.float32),
                valid=valid)


def _jax_ffn(a, k, cap, mode):
    valid = None if a["valid"] is None else jnp.asarray(a["valid"])
    return jmoe.moe_ffn(jnp.asarray(a["x"]), valid, jnp.asarray(a["gate_w"]),
                        jnp.asarray(a["w_up"]), jnp.asarray(a["w_down"]),
                        k=k, capacity=cap, dispatch_mode=mode)


def _port_ffn(a, k, cap, mode):
    valid = None if a["valid"] is None else _t(a["valid"])
    return tmoe.moe_ffn(_t(a["x"]), valid, _t(a["gate_w"]), _t(a["w_up"]),
                        _t(a["w_down"]), k=k, capacity=cap,
                        dispatch_mode=mode)


@pytest.mark.parametrize("k,cap,seed", [(1, 24, 0), (2, 24, 0), (1, 3, 1),
                                        (2, 3, 1), (3, 3, 1), (2, 5, 4)])
def test_sort_path_matches_jax_einsum_and_sort(k, cap, seed):
    a = _ffn_inputs(24, 8, 4, 16, seed)
    y, aux = _port_ffn(a, k, cap, "auto")
    for mode in ("einsum", "sort"):
        jy, ja = _jax_ffn(a, k, cap, mode)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6, err_msg=mode)
        np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    # the port's einsum path agrees with JAX's too
    ye, ae = _port_ffn(a, k, cap, "einsum")
    jy, ja = _jax_ffn(a, k, cap, "einsum")
    np.testing.assert_allclose(ye.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ae), float(ja), rtol=1e-6)


def test_sort_path_with_invalid_rows():
    valid = np.array([1] * 10 + [0] * 6, np.float32)
    a = _ffn_inputs(16, 8, 4, 16, 2, valid)
    y, aux = _port_ffn(a, 2, 4, "sort")
    jy, ja = _jax_ffn(a, 2, 4, "einsum")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    assert float(y[10:].abs().max()) == 0.0


def test_single_expert_is_dense_ffn():
    a = _ffn_inputs(6, 5, 1, 7, 0)
    y, _ = tmoe.moe_ffn(_t(a["x"]), None, _t(a["gate_w"]), _t(a["w_up"]),
                        _t(a["w_down"]), k=1, capacity_factor=2.0,
                        dispatch_mode="sort")
    want = torch.relu(_t(a["x"]) @ _t(a["w_up"])[0]) @ _t(a["w_down"])[0]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_gradients_match_jax(mode):
    a = _ffn_inputs(16, 6, 4, 12, 3)
    a["valid"] = np.array([1] * 13 + [0] * 3, np.float32)

    def jloss(x, gw, wu, wd):
        y, aux = jmoe.moe_ffn(x, jnp.asarray(a["valid"]), gw, wu, wd, k=2,
                              capacity=5, dispatch_mode="einsum")
        return jnp.sum(y * y) + 0.01 * aux

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a[n]) for n in ("x", "gate_w", "w_up", "w_down")))
    leaves = [_t(a[n]).requires_grad_()
              for n in ("x", "gate_w", "w_up", "w_down")]
    y, aux = tmoe.moe_ffn(leaves[0], _t(a["valid"]), *leaves[1:], k=2,
                          capacity=5, dispatch_mode=mode)
    tg = torch.autograd.grad((y * y).sum() + 0.01 * aux, leaves)
    for name, g, want in zip(("x", "gate", "up", "down"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# --------------------------------------------------------------- layers

def test_aux_cost_masks_feeder_pad_rows_by_n_real():
    """A dense moe input takes its validity from ctx.n_real: with it the
    aux statistics see the 6 real rows (as JAX's do); without it the 2
    zero pad rows join the router and move the value."""
    rng = np.random.RandomState(0)
    xv = rng.randn(6, 6).astype(np.float32)
    xpad = np.concatenate([xv, np.zeros((2, 6), np.float32)])

    def build(L):
        x = L.data("x", submodule(L, "core.data_type").dense_vector(6))
        node = L.moe(x, expert_num=2, expert_hidden=5, k=2, name="m")
        return L.moe_aux_cost(x, node, coeff=1.0, name="aux")

    jreset()
    jt = jpaddle.Topology(build(jpaddle.layer))
    treset()
    tt = tpaddle.Topology(build(tpaddle.layer))
    table, raw = table_of(jt)
    jp = {k: jnp.asarray(v) for k, v in table.items()}

    def jrun(feed_x, n_real):
        outs, _ = jt.forward(jp, {}, {"x": jnp.asarray(feed_x)}, mode="test",
                             n_real=n_real)
        return float(np.asarray(outs["aux"])[0])

    def trun(feed_x, n_real):
        outs, _ = tt.forward(raw, {}, {"x": _t(feed_x)}, mode="test",
                             n_real=n_real)
        return float(outs["aux"][0])

    full = trun(xv, 6)
    np.testing.assert_allclose(trun(xpad, 6), full, rtol=1e-5)
    np.testing.assert_allclose(full, jrun(xv, jnp.asarray(6)), rtol=1e-5)
    np.testing.assert_allclose(trun(xpad, None), jrun(xpad, None),
                               rtol=1e-5)
    assert abs(trun(xpad, None) - full) > 1e-4


def _moe_block(L):
    """moe_block's graph (tests/golden/moe_block.json) over a sequence
    input, with the aux cost sharing the gate."""
    dt = submodule(L, "core.data_type")
    x = L.data("x", dt.dense_vector_sequence(8))
    ln = L.layer_norm(x, name="moe_ln")
    m = L.moe(ln, expert_num=4, expert_hidden=32, k=2, name="moe1")
    y = L.data("y", dt.integer_value_sequence(8))
    head = L.fc(m, size=8, act=None, bias_attr=False, name="moe_head")
    ce = L.cross_entropy_cost(head, y, from_logits=True, name="moe_ce")
    aux = L.moe_aux_cost(ln, m, name="moe_aux")
    return [ce, aux]


def test_moe_block_sequence_graph_matches_jax():
    """Ragged sequences: padded steps are invalid rows (the mask), the
    gate is one parameter shared by both layers, and the cost and
    gradients equal JAX's."""
    rng = np.random.RandomState(1)
    samples = [(rng.randn(n, 8).astype(np.float32),
                rng.randint(0, 8, (n,)).astype(np.int32)) for n in (5, 2, 7)]
    jt, _ = check_parity(_moe_block, samples, mode="train")
    assert sorted(jt) == ["moe_aux", "moe_ce"]
    treset()
    tt = tpaddle.Topology(_moe_block(tpaddle.layer))
    assert [k for k in tt.param_specs if "gate" in k] == ["_moe1.gate"]


# ------------------------------------------------------------- the MoE LM

LM = dict(vocab_size=50, d_model=16, n_heads=2, n_layers=2, d_ff=32,
          max_len=32, moe_experts=4)


def _lm_batches(n, b=8, T=8, vocab=50):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, T + 1)).astype("int32")
        out.append([(ids[i, :-1], np.arange(T, dtype="int32"), ids[i, 1:])
                    for i in range(b)])
    return out


def test_moe_lm_three_adam_steps_track_jax():
    """The MoE transformer_lm (4 experts, top-2, factor 1.25: the first
    batch of 64 tokens drops some) from one table: the same 3 cost
    nodes per layer set, and the total cost of three Adam(1e-3)
    train_batch steps at rtol 1e-4."""
    jpaddle.init(use_tpu=False, seed=0)
    jreset()
    jspec = jmodels.transformer_lm(**LM)
    treset()
    tspec = tmodels.transformer_lm(**LM)
    assert [c.name for c in tspec.cost] == [c.name for c in jspec.cost] == \
        ["tfm_cost", "tfm_l0_aux", "tfm_l1_aux"]
    jtopo = jpaddle.Topology(jspec.cost, extra_outputs=[jspec.output])
    table, raw = table_of(jtopo)
    jtr = jpaddle.SGD(cost=jspec.cost, parameters=jpaddle.Parameters(
        {k: jnp.asarray(v) for k, v in table.items()}),
        update_equation=jpaddle.optimizer.Adam(learning_rate=1e-3))
    ttr = tpaddle.SGD(cost=tspec.cost, parameters=tpaddle.Parameters(
        dict(raw), device="cpu"),
        update_equation=tpaddle.optimizer.Adam(learning_rate=1e-3),
        device="cpu")
    for batch in _lm_batches(3):
        jl, jm = jtr.train_batch(batch)
        tl, tm = ttr.train_batch(batch)
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        for name in ("tfm_cost", "tfm_l0_aux", "tfm_l1_aux"):
            np.testing.assert_allclose(tm[name], jm[name], rtol=RTOL,
                                       err_msg=name)
        assert np.isfinite(tl)
