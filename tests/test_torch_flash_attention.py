"""Port parity: paddle_tpu_torch/ops/flash_attention.py against
paddle_tpu/ops/pallas_attention.py on the CPU.

The JAX side runs its Pallas kernels as its own tests run them here
(``interpret=True``), forward and the custom-vjp backward (the dq and
dk/dv kernels). The port's side is the plain version its CPU wrappers
take — the same functions its CUDA kernels are held against on the
card. Inputs are numpy arrays from a seeded RandomState handed to
both. Tolerance: atol 2e-5 in float32, the bound of
tests/test_pallas_attention.py for the kernel against its reference;
in bfloat16 (the same values rounded to bf16 on both sides) max |err|
<= 2e-2 max(1, max|ref|), the bound chip_smoke.py's phase 6 holds the
bf16 kernels to: the two sides round p to bf16 at different points.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
BF16_ATOL = 2e-2

# name -> (tq, tk, q_lens, kv_lens, causal, block): the cases of
# tests/test_pallas_attention.py, each in the port
CASES = {
    "full": (24, 40, None, None, False, 512),
    "ragged_kv": (24, 40, None, [17, 40], False, 512),
    "q_lens_zero_rows": (24, 40, [10, 24], None, False, 512),
    "causal": (32, 32, None, [32, 20], True, 512),
    "multi_block": (70, 90, None, [90, 33], False, 16),
    "multi_block_causal_ragged": (90, 90, [90, 61], [77, 90], True, 16),
    "fully_masked_row": (24, 40, None, [0, 5], False, 512),
}


def _inputs(tq, tk, seed=0, b=2, h=2, d=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h, d).astype(np.float32)
    v = rng.randn(b, tk, h, d).astype(np.float32)
    do = rng.randn(b, tq, h, d).astype(np.float32)
    return q, k, v, do


def _lens(x):
    return None if x is None else np.asarray(x, np.int32)


def _jax_out_and_grads(q, k, v, do, ql, kl, causal, block,
                       dtype=jnp.float32):
    def f(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_,
            q_lens=None if ql is None else jnp.asarray(ql),
            kv_lens=None if kl is None else jnp.asarray(kl),
            causal=causal, block_q=block, block_k=block, interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return tuple(np.asarray(x.astype(jnp.float32)) for x in
                 (out,) + vjp(jnp.asarray(do, dtype)))


def _t(x, grad=False):
    return None if x is None else torch.tensor(x, requires_grad=grad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_pallas_interpret(case):
    tq, tk, ql, kl, causal, block = CASES[case]
    q, k, v, do = _inputs(tq, tk)
    ql, kl = _lens(ql), _lens(kl)
    want = _jax_out_and_grads(q, k, v, do, ql, kl, causal, block)
    tq_, tk_, tv_ = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_attention(tq_, tk_, tv_, q_lens=_t(ql), kv_lens=_t(kl),
                              causal=causal)
    grads = torch.autograd.grad(out, (tq_, tk_, tv_), torch.tensor(do))
    got = (out.detach().numpy(),) + tuple(g.numpy() for g in grads)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    if case == "fully_masked_row":
        assert np.all(got[0][0] == 0.0) and np.all(np.isfinite(got[0]))
    if case == "q_lens_zero_rows":
        assert np.all(got[0][0, 10:] == 0.0)


@pytest.mark.parametrize("d", [16, 24, 64, 72, 128])
@pytest.mark.parametrize("case", ["causal", "multi_block_causal_ragged",
                                  "fully_masked_row"])
def test_bf16_forward_and_gradients_match_pallas_interpret(case, d):
    """bfloat16 q/k/v/dO (d 24 and 72: head dims the gate admits with
    d % 16 != 0; 64, 72 and 128: the head dims the card's bf16 dq is held
    at, one and two d panels): the port's flash_attention, forward and
    autograd backward — the plain versions the bf16 wgmma kernels are
    held against — against the JAX package's, in interpret mode, with
    its custom-vjp dq and dk/dv kernels; q_lens below T and
    fully-masked rows among the cases."""
    tq, tk, ql, kl, causal, block = CASES[case]
    q, k, v, do = _inputs(tq, tk, seed=2, d=d)
    ql, kl = _lens(ql), _lens(kl)
    want = _jax_out_and_grads(q, k, v, do, ql, kl, causal, block,
                              jnp.bfloat16)
    leaves = [torch.tensor(x).to(torch.bfloat16).requires_grad_()
              for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, q_lens=_t(ql), kv_lens=_t(kl),
                              causal=causal)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, leaves,
                                torch.tensor(do).to(torch.bfloat16))
    got = [x.detach().float().numpy() for x in (out,) + grads]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        bound = BF16_ATOL * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= bound, f"{name}: max |err| {err} > {bound}"
    if case == "fully_masked_row":
        assert np.all(got[0][0] == 0.0) and np.all(np.isfinite(got[0]))


@pytest.mark.parametrize("d", [8, 24, 64, 72, 128])
def test_route_is_chosen_by_dtype_alone(d):
    """bfloat16 forward, dq and dk/dv take the wgmma kernels (sm90);
    float32 the 3xTF32 wgmma forward, dq and dk/dv (tf32x3), at every
    head dim the gate admits."""
    q = torch.zeros(2, 16, 2, d)
    for dtype, want in ((torch.bfloat16, ("sm90", "sm90", "sm90")),
                        (torch.float32, ("tf32x3",) * 3)):
        x = q.to(dtype)
        assert tfa.flash_supported(x, x)
        got = tuple(tfa.flash_route(n, x.dtype) for n in ("fwd", "dq", "dkv"))
        assert got == want
        for kernel, route in zip(("fwd", "dq", "dkv"), got):
            assert (kernel, route) in tfa._KERNELS
    with pytest.raises(TypeError):
        tfa.flash_route("fwd", torch.float16)
    with pytest.raises(ValueError):
        tfa.flash_route("bwd", torch.bfloat16)


@pytest.mark.parametrize("case", ["ragged_kv", "q_lens_zero_rows", "causal",
                                  "fully_masked_row"])
def test_wrappers_match_pallas_residual_and_backward(case):
    """The three CPU wrappers (flash_forward's lse, flash_backward_dq,
    flash_backward_dkv) against the JAX kernels' saved logsumexp
    (``_flash_fwd``'s residual, lane 0) and their backward."""
    tq, tk, ql, kl, causal, _ = CASES[case]
    q, k, v, do = _inputs(tq, tk, seed=1)
    b = q.shape[0]
    ql = _lens(ql) if ql is not None else np.full((b,), tq, np.int32)
    kl = _lens(kl) if kl is not None else np.full((b,), tk, np.int32)
    scale = q.shape[-1] ** -0.5
    _, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(ql), jnp.asarray(kl), causal, scale,
                            tq, tk, True)
    want_lse = np.asarray(res[4])[..., 0]
    want = _jax_out_and_grads(q, k, v, do, ql, kl, causal, 512)

    lens2 = torch.tensor(np.stack([ql, kl], 1))
    tq_, tk_, tv_, tdo = (torch.tensor(x) for x in (q, k, v, do))
    out, lse = tfa.flash_forward(tq_, tk_, tv_, lens2, causal, scale)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), want[0], atol=ATOL)
    dd = tfa.rowsum_do_o(tdo, out)
    dq = tfa.flash_backward_dq(tq_, tk_, tv_, tdo, lse, dd, lens2, causal,
                               scale)
    dk, dv = tfa.flash_backward_dkv(tq_, tk_, tv_, tdo, lse, dd, lens2,
                                    causal, scale)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want[1:]):
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=name)


def test_gqa_through_the_attention_layer():
    """dot_product_attention with 4 query heads over 2 kv heads (the
    layer repeats k/v), causal with ragged lengths: the port's layer
    against the JAX layer, forward and input gradients."""
    import paddle_tpu as paddle
    from paddle_tpu.core.registry import reset_name_counters as j_reset
    from paddle_tpu.core.sequence import pack_sequences as j_pack
    from paddle_tpu_torch import layers as tl
    from paddle_tpu_torch.core.data_type import dense_vector_sequence
    from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
    from paddle_tpu_torch.core.sequence import pack_sequences as t_pack
    from paddle_tpu_torch.core.topology import Topology as TTopology

    rng = np.random.RandomState(3)
    lens = [11, 7]
    rows = {n: [rng.randn(L, w).astype(np.float32) for L in lens]
            for n, w in (("q", 32), ("k", 16), ("v", 16))}
    w_out = rng.randn(2, 11, 32).astype(np.float32)

    j_reset()
    jd = {n: paddle.layer.data(n, paddle.data_type.dense_vector_sequence(
        rows[n][0].shape[1])) for n in rows}
    jatt = paddle.layer.dot_product_attention(jd["q"], jd["k"], jd["v"],
                                              num_heads=4, num_kv_heads=2,
                                              causal=True)
    jtopo = paddle.Topology(jatt)
    feed0 = {n: j_pack(rows[n]) for n in rows}

    def jloss(datas):
        feed = {n: feed0[n].with_data(datas[n]) for n in rows}
        outs, _ = jtopo.forward({}, {}, feed, mode="test")
        out = outs[jatt.name].data
        return jnp.sum(out * w_out), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        {n: feed0[n].data for n in rows})

    t_reset()
    td = {n: tl.data(n, dense_vector_sequence(rows[n][0].shape[1]))
          for n in rows}
    tatt = tl.dot_product_attention(td["q"], td["k"], td["v"], num_heads=4,
                                    num_kv_heads=2, causal=True)
    ttopo = TTopology(tatt)
    feed = {n: t_pack(rows[n]) for n in rows}
    leaves = {n: feed[n].data.requires_grad_() for n in rows}
    outs, _ = ttopo.forward({}, {}, feed, mode="test")
    tout = outs[tatt.name].data
    tg = torch.autograd.grad(torch.sum(tout * torch.tensor(w_out)),
                             [leaves[n] for n in rows])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for n, g in zip(rows, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), atol=ATOL,
                                   err_msg=n)


def test_supported_gate_and_cpu_path_launches_nothing():
    q = torch.zeros(2, 24, 2, 16)
    assert tfa.flash_supported(q, q)
    assert not tfa.flash_supported(torch.zeros(2, 24, 2, 12), q)
    assert not tfa.flash_supported(torch.zeros(2, 24, 2, 136),
                                   torch.zeros(2, 24, 2, 136))
    assert not tfa.flash_supported(q.double(), q.double())
    wrappers = (tfa.flash_forward, tfa.flash_backward_dq,
                tfa.flash_backward_dkv)

    def counts():
        return [(w.launches, dict(w.route_launches)) for w in wrappers]

    before = counts()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1, 16, 2, 8).to(dtype).requires_grad_()
        tfa.flash_attention(x, x, x, causal=True).sum().backward()
    assert counts() == before
    tfa.reset_launches()
    assert counts() == [(0, {"sm90": 0, "tf32x3": 0}),
                        (0, {"sm90": 0, "tf32x3": 0}),
                        (0, {"sm90": 0, "tf32x3": 0})]


def test_kernel_wrappers_refuse_other_devices():
    q = torch.zeros(1, 8, 1, 8, device="meta")
    lens2 = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no flash attention kernel"):
        tfa.flash_forward(q, q, q, lens2, False, 1.0)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_tf32_plan_fits_every_admitted_head_dim(d):
    """The float32 forward, dq and dk/dv take the tf32x3 route at every
    head dim the gate admits, and their plan (chosen by d alone) fits the
    227 KB of shared memory a block may use on sm_90, static words
    included; the LM's d 64 gets two consumer warpgroups and 2-stage
    rings, and the forward 64-key tiles."""
    x = torch.zeros(1, 16, 1, d)
    assert tfa.flash_supported(x, x)
    for kernel in ("fwd", "dq", "dkv"):
        assert tfa.flash_route(kernel, torch.float32) == "tf32x3"
        assert (kernel, "tf32x3") in tfa._KERNELS
        plan = tfa.flash_tf32_plan(kernel, d)
        assert plan["smem"] + plan["static"] <= tfa.SMEM_LIMIT == 232448
        assert plan["tile"] in (16, 32, 64) and plan["stages"] in (1, 2)
    fwd, dq, dkv = (tfa.flash_tf32_plan(k, d) for k in ("fwd", "dq", "dkv"))
    assert fwd["rows"] == 64 * fwd["warpgroups"] and fwd["stages"] == 2
    assert dq["rows"] == 64 * dq["warpgroups"] and dkv["rows"] == 64
    if d <= 64:
        assert fwd["warpgroups"] == dq["warpgroups"] == dkv["warpgroups"] == 2
        assert dq["stages"] == dkv["stages"] == 2 and fwd["tile"] == 64


def test_tf32_plan_refuses_what_the_gate_refuses():
    for kernel in ("fwd", "dq"):
        for d in (0, 12, 136):
            with pytest.raises(ValueError):
                tfa.flash_tf32_plan(kernel, d)
    with pytest.raises(ValueError):
        tfa.flash_tf32_plan("bwd", 64)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits: the low 13 of float32 masked)
    to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(eq, a, b, split):
    """einsum ``eq`` as the tf32x3 kernels multiply: lo.hi + hi.lo +
    hi.hi of TF32 parts on float32 sums (``split``), or one TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + \
        torch.einsum(eq, ah, bh)


def _tf32x3_grads(q, k, v, do, lse, dd, ql, kl, causal, scale, split):
    """(dq, dk, dv) as csrc/flash_{dq,dkv}_tf32_sm90.cu compute them:
    S and dP^T from split operands, p under the mask from the saved lse,
    dS split again (from its accumulator, in registers on the card),
    every product in TF32 parts."""
    b, t, h, _ = q.shape
    mask = tfa.lens_mask(torch.tensor(ql), torch.tensor(kl), t, k.shape[1],
                         causal)[:, None]
    s = _mm("bqhd,bkhd->bhqk", q, k, split)
    lse4 = lse.reshape(b, h, t, 1)
    p = torch.where(mask, torch.exp2(torch.where(
        mask, s * (scale * 1.4426950408889634) - lse4 * 1.4426950408889634,
        torch.zeros_like(s))), torch.zeros_like(s))
    dp = _mm("bqhd,bkhd->bhqk", do, v, split)
    ds = p * (dp - dd.reshape(b, h, t, 1)) * scale
    return (_mm("bhqk,bkhd->bqhd", ds, k, split),
            _mm("bhqk,bqhd->bkhd", ds, q, split),
            _mm("bhqk,bqhd->bkhd", p, do, split))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 72])
def test_tf32x3_products_meet_the_float32_tolerance(d, causal):
    """The float32 kernels' arithmetic emulated on the CPU (b 2, T 80,
    h 2, ragged q and kv lengths with fully-masked rows) against the JAX
    package's _flash_grads in interpret mode at the float32 atol 2e-5:
    the three-pass split meets it, one TF32 pass does not."""
    t = 80
    q, k, v, do = _inputs(t, t, seed=20 + d, b=2, h=2, d=d)
    ql = np.array([80, 61], np.int32)
    kl = np.array([77, 80], np.int32)
    want = _jax_out_and_grads(q, k, v, do, ql, kl, causal, 16)
    tq_, tk_, tv_, tdo = (torch.tensor(x) for x in (q, k, v, do))
    lens2 = torch.tensor(np.stack([ql, kl], 1))
    scale = d ** -0.5
    out, lse = tfa.flash_forward(tq_, tk_, tv_, lens2, causal, scale)
    dd = tfa.rowsum_do_o(tdo, out)
    args = (tq_, tk_, tv_, tdo, lse, dd, ql, kl, causal, scale)
    for name, a, w in zip(("dq", "dk", "dv"), _tf32x3_grads(*args, True),
                          want[1:]):
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=name)
    one_pass = _tf32x3_grads(*args, False)
    assert max(float(np.abs(a.numpy() - w).max())
               for a, w in zip(one_pass, want[1:])) > ATOL


def _tf32x3_forward(q, k, v, ql, kl, causal, scale, tile, split):
    """(out, lse) as csrc/flash_fwd_tf32_sm90.cu computes them: over key
    tiles of ``tile`` keys, S from split operands, the base-2 online
    softmax (scale*log2(e) folded into S, p zeroed where masked), P split
    again from its accumulator and O rescaled, then P V; every product
    in TF32 parts (``_mm``); lse in natural units, NEG_INF where l == 0."""
    b, t, h, _ = q.shape
    tk = k.shape[1]
    mask = tfa.lens_mask(torch.tensor(ql), torch.tensor(kl), t, tk,
                         causal)[:, None]
    m = torch.full((b, h, t, 1), tfa.NEG_INF)
    l = torch.zeros(b, h, t, 1)
    o = torch.zeros(b, h, t, q.shape[-1])
    for k0 in range(0, tk, tile):
        valid = mask[..., k0:k0 + tile]
        s = _mm("bqhd,bkhd->bhqk", q, k[:, k0:k0 + tile], split) * \
            (scale * 1.4426950408889634)
        s = torch.where(valid, s, torch.full_like(s, tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(valid, torch.exp2(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm("bhqk,bkhd->bhqd", p, v[:, k0:k0 + tile], split)
        m = m_new
    live = l > 0
    out = torch.where(live, o / torch.where(live, l, torch.ones_like(l)),
                      torch.zeros_like(o))
    lse = torch.where(live, m * 0.6931471805599453 +
                      torch.log(torch.where(live, l, torch.ones_like(l))),
                      torch.full_like(l, tfa.NEG_INF))
    return out.permute(0, 2, 1, 3), lse.reshape(b * h, t)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 72])
def test_tf32x3_forward_meets_the_float32_tolerance(d, causal):
    """The float32 forward kernel's arithmetic emulated on the CPU (b 2,
    T 80, h 2, ragged q and kv lengths with fully-masked rows, key tiles
    of flash_tf32_plan("fwd", d)["tile"]) against the JAX package's
    flash_attention and its saved logsumexp (``_flash_fwd``'s residual),
    in interpret mode, at the float32 atol 2e-5: the three-pass split
    meets it, one TF32 pass does not."""
    t = 80
    q, k, v, _ = _inputs(t, t, seed=40 + d, b=2, h=2, d=d)
    ql = np.array([80, 61], np.int32)
    kl = np.array([77, 80], np.int32)
    scale = d ** -0.5
    want, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(ql),
                               jnp.asarray(kl), causal, scale, 16, 16, True)
    want, want_lse = np.asarray(want), np.asarray(res[4])[..., 0]
    live = want_lse > tfa.NEG_INF / 2
    assert not live.all() and live.any()
    tile = tfa.flash_tf32_plan("fwd", d)["tile"]
    tq_, tk_, tv_ = (torch.tensor(x) for x in (q, k, v))
    args = (tq_, tk_, tv_, ql, kl, causal, scale, tile)
    out, lse = _tf32x3_forward(*args, True)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, err_msg="out")
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL,
                               err_msg="lse")
    assert np.all(lse.numpy()[~live] == tfa.NEG_INF)
    out1, lse1 = _tf32x3_forward(*args, False)
    assert max(float(np.abs(out1.numpy() - want).max()),
               float(np.abs(lse1.numpy()[live] - want_lse[live]).max())) \
        > ATOL
