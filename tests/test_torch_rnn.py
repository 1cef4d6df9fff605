"""Port parity: the recurrent ops of paddle_tpu_torch (ops/fused_rnn.py,
ops/recurrent.py) against paddle_tpu's on the CPU.

Inputs are made with numpy from a seed and go through both packages:

- the fused sequence ops — the port's ``lstm_sequence`` /
  ``gru_sequence`` (on the CPU: the kernels' plain versions, and for
  the LSTM the same autograd Function the card runs) against
  ``pallas_rnn.lstm_sequence`` / ``gru_sequence`` with
  ``interpret=True`` (the Pallas kernels and their custom_vjp): forward,
  final state and ``jax.vjp`` gradients, with ragged lengths, with and
  without bias and peepholes;
- the masked scans — ``lstm_scan`` / ``gru_scan`` / ``rnn_scan``, forward
  and reverse, with ``h0`` / ``c0`` — against the JAX package's.

Tolerances: float32 forwards at the JAX package's own kernel-vs-scan
bound (rtol 1e-5, atol 1e-6, tests/test_pallas_rnn.py:33), gradients at
its gradient bound (rtol 1e-4, atol 1e-5, :70); bfloat16 compute at atol
2e-2 (both round the product inputs and streams to bf16, and sum in
another order). The JAX package's scans refuse bfloat16 compute (their
carry changes dtype, ROADMAP.md queue C), so the scans are compared in
float32 only.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.ops import pallas_rnn, recurrent as jrec

from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.ops import fused_rnn, recurrent as trec

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 2e-2


@pytest.fixture
def compute_dtype():
    """Sets both packages' compute dtype; float32 again afterwards."""
    def set_(name):
        paddle.init(use_tpu=False, seed=0, compute_dtype=name)
        tconfig.init(seed=0, compute_dtype=name)
    yield set_
    set_("float32")


def _inputs(gates, h=6, b=4, t=12, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, gates * h) * 0.5).astype(np.float32)
    lens = rng.randint(3, t + 1, b).astype(np.int32)
    lens[0] = t
    w = (rng.randn(h, gates * h) * 0.3).astype(np.float32)
    bias = (rng.randn(gates * h) * 0.1).astype(np.float32)
    peep = (rng.randn(3 * h) * 0.1).astype(np.float32)
    return x, lens, w, bias, peep


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def _t(a):
    return None if a is None else torch.tensor(a, requires_grad=True)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _lstm_pair(x, lens, w, bias, peep, cts):
    """(outs, grads) of the fused LSTM in both packages for the
    cotangents ``cts`` = (d_out, d_hT, d_cT)."""
    args = [a for a in (x, w, bias, peep) if a is not None]

    def jf(*a):
        it = iter(a)
        xx, ww = next(it), next(it)
        bb = next(it) if bias is not None else None
        pp = next(it) if peep is not None else None
        return pallas_rnn.lstm_sequence(xx, jnp.asarray(lens), ww, bb, pp,
                                        interpret=True)

    jouts, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    jgrads = vjp(tuple(jnp.asarray(c).astype(o.dtype)
                       for c, o in zip(cts, jouts)))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    it = iter(leaves)
    tx, tw = next(it), next(it)
    tb = next(it) if bias is not None else None
    tp = next(it) if peep is not None else None
    touts = fused_rnn.lstm_sequence(tx, torch.tensor(lens), tw, tb, tp)
    loss = sum((o.float() * torch.tensor(c)).sum()
               for o, c in zip(touts, cts))
    tgrads = torch.autograd.grad(loss, leaves)
    return jouts, touts, jgrads, tgrads


@pytest.mark.parametrize("with_bias,with_peep", [(True, True), (True, False),
                                                 (False, False)])
def test_lstm_sequence_matches_pallas_float32(with_bias, with_peep):
    x, lens, w, bias, peep = _inputs(4, seed=1)
    rng = np.random.RandomState(2)
    cts = [rng.randn(4, 12, 6).astype(np.float32),
           rng.randn(4, 6).astype(np.float32),
           rng.randn(4, 6).astype(np.float32)]
    jouts, touts, jg, tg = _lstm_pair(x, lens, w,
                                      bias if with_bias else None,
                                      peep if with_peep else None, cts)
    for j, t in zip(jouts, touts):
        _close(t.detach(), j, FWD)
    for j, t in zip(jg, tg):
        _close(t, j, GRAD)
    # the padded tail of every row is zero, the final state the last
    # valid step's
    out = touts[0].detach().numpy()
    for r, L in enumerate(lens):
        assert not out[r, L:].any()
        np.testing.assert_array_equal(out[r, L - 1], touts[1][r].detach())


def test_lstm_sequence_matches_pallas_bfloat16(compute_dtype):
    compute_dtype("bfloat16")
    x, lens, w, bias, peep = _inputs(4, h=16, seed=3)
    rng = np.random.RandomState(4)
    cts = [rng.randn(4, 12, 16).astype(np.float32),
           rng.randn(4, 16).astype(np.float32),
           rng.randn(4, 16).astype(np.float32)]
    jouts, touts, jg, tg = _lstm_pair(x, lens, w, bias, peep, cts)
    assert touts[0].dtype == torch.bfloat16
    assert touts[1].dtype == torch.float32
    for j, t in zip(jouts, touts):
        _close(t.detach(), j, dict(rtol=0, atol=BF16_ATOL))
    for j, t in zip(jg, tg):
        _close(t, j, dict(rtol=0, atol=BF16_ATOL))


def test_lstm_no_grad_bfloat16_matches_pallas(compute_dtype):
    """The no-residual forward (the infer call) in bfloat16: the port's
    lstm_sequence under no_grad against the Pallas kernel in interpret
    mode, out, hT and cT."""
    compute_dtype("bfloat16")
    x, lens, w, bias, peep = _inputs(4, h=16, seed=15)
    jouts = pallas_rnn.lstm_sequence(jnp.asarray(x), jnp.asarray(lens),
                                     jnp.asarray(w), jnp.asarray(bias),
                                     jnp.asarray(peep), interpret=True)
    with torch.no_grad():
        touts = fused_rnn.lstm_sequence(torch.tensor(x), torch.tensor(lens),
                                        torch.tensor(w), torch.tensor(bias),
                                        torch.tensor(peep))
    assert touts[0].dtype == torch.bfloat16
    for j, t in zip(jouts, touts):
        _close(t, j, dict(rtol=0, atol=BF16_ATOL))


def test_lstm_no_grad_call_takes_the_no_residual_forward():
    """Without a gradient the op runs the forward once, without
    residuals, and gives the same values as the differentiable call."""
    x, lens, w, bias, peep = _inputs(4, seed=5)
    with torch.no_grad():
        plain = fused_rnn.lstm_sequence(torch.tensor(x), torch.tensor(lens),
                                        torch.tensor(w), torch.tensor(bias),
                                        torch.tensor(peep))
    diff = fused_rnn.lstm_sequence(_t(x), torch.tensor(lens), _t(w),
                                   _t(bias), _t(peep))
    for a, b_ in zip(plain, diff):
        assert not a.requires_grad
        torch.testing.assert_close(a, b_.detach(), rtol=0, atol=0)


def test_lstm_backward_reference_is_the_pallas_backward():
    """dz of the plain backward (the kernel's oracle) is the JAX
    package's dx4, from the same residuals."""
    x, lens, w, bias, peep = _inputs(4, seed=6)
    tl = torch.tensor(lens)
    out, hT, cT, cseq, gates = fused_rnn.lstm_reference(
        torch.tensor(x), tl, torch.tensor(w), torch.tensor(bias),
        torch.tensor(peep), save_res=True)
    rng = np.random.RandomState(7)
    d_out = rng.randn(*out.shape).astype(np.float32)
    dhT, dcT = (rng.randn(*hT.shape).astype(np.float32) for _ in range(2))
    dz = fused_rnn.lstm_backward(torch.tensor(w), torch.tensor(peep), tl,
                                 gates, cseq, torch.tensor(d_out),
                                 torch.tensor(dhT), torch.tensor(dcT))
    _, vjp = jax.vjp(lambda xx: pallas_rnn.lstm_sequence(
        xx, jnp.asarray(lens), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(peep), interpret=True), jnp.asarray(x))
    (dx4,) = vjp((jnp.asarray(d_out), jnp.asarray(dhT), jnp.asarray(dcT)))
    _close(dz, dx4, GRAD)


@pytest.mark.parametrize("with_bias", [True, False])
def test_gru_sequence_matches_pallas_float32(with_bias):
    x, lens, w, bias, _ = _inputs(3, seed=8)
    bias = bias if with_bias else None
    jout, jhT = pallas_rnn.gru_sequence(jnp.asarray(x), jnp.asarray(lens),
                                        jnp.asarray(w), _j(bias),
                                        interpret=True)
    with torch.no_grad():
        tout, thT = fused_rnn.gru_sequence(torch.tensor(x),
                                           torch.tensor(lens),
                                           torch.tensor(w),
                                           None if bias is None
                                           else torch.tensor(bias))
    _close(tout, jout, FWD)
    _close(thT, jhT, FWD)
    # gradients: the plain float32 scan under autograd on both sides
    rng = np.random.RandomState(9)
    cts = (rng.randn(*tout.shape).astype(np.float32),
           rng.randn(*thT.shape).astype(np.float32))
    args = [a for a in (x, w, bias) if a is not None]
    _, vjp = jax.vjp(lambda *a: pallas_rnn.gru_sequence(
        a[0], jnp.asarray(lens), a[1], a[2] if len(a) > 2 else None,
        interpret=True), *[jnp.asarray(a) for a in args])
    jg = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    touts = fused_rnn.gru_sequence(leaves[0], torch.tensor(lens), leaves[1],
                                   leaves[2] if len(leaves) > 2 else None)
    tg = torch.autograd.grad(sum((o * torch.tensor(c)).sum()
                                 for o, c in zip(touts, cts)), leaves)
    for j, t in zip(jg, tg):
        _close(t, j, GRAD)


def test_gru_sequence_matches_pallas_bfloat16(compute_dtype):
    compute_dtype("bfloat16")
    x, lens, w, bias, _ = _inputs(3, h=16, seed=10)
    jout, jhT = pallas_rnn.gru_sequence(jnp.asarray(x), jnp.asarray(lens),
                                        jnp.asarray(w), jnp.asarray(bias),
                                        interpret=True)
    with torch.no_grad():
        tout, thT = fused_rnn.gru_sequence(torch.tensor(x),
                                           torch.tensor(lens),
                                           torch.tensor(w),
                                           torch.tensor(bias))
    assert tout.dtype == torch.float32
    _close(tout, jout, dict(rtol=0, atol=BF16_ATOL))
    _close(thT, jhT, dict(rtol=0, atol=BF16_ATOL))


def _tagger_inputs(seed=11):
    """The tagger's decode widths (b 64, h 128, T 64), ragged, one row at
    the full 64 steps and one at 1."""
    rng = np.random.RandomState(seed)
    b, h, t = 64, 128, 64
    x = (rng.randn(b, t, 3 * h) * 0.5).astype(np.float32)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    lens[0], lens[1] = t, 1
    w = (rng.randn(h, 3 * h) * h ** -0.5).astype(np.float32)
    bias = (rng.randn(3 * h) * 0.1).astype(np.float32)
    return x, lens, w, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_sequence_matches_pallas_at_tagger_width(dtype, compute_dtype):
    """The decode path's GRU at the tagger's width: the port's
    gru_sequence (on the CPU: the sm90 kernel's plain version) against
    the Pallas kernel in interpret mode; float32 at the card check's
    tolerance (rtol 2e-4, atol 2e-5), bfloat16 at BF16_ATOL."""
    compute_dtype(dtype)
    x, lens, w, bias = _tagger_inputs()
    jout, jhT = pallas_rnn.gru_sequence(jnp.asarray(x), jnp.asarray(lens),
                                        jnp.asarray(w), jnp.asarray(bias),
                                        interpret=True)
    with torch.no_grad():
        tout, thT = fused_rnn.gru_sequence(torch.tensor(x),
                                           torch.tensor(lens),
                                           torch.tensor(w),
                                           torch.tensor(bias))
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else \
        dict(rtol=0, atol=BF16_ATOL)
    _close(tout, jout, tol)
    _close(thT, jhT, tol)


def _old_gru_rule(h, sms=132):
    """The cooperative GRU kernel's admission rule before the sm90 route
    existed: U = ceil(h / SMs) <= 16 units a block and its resident
    slice plus staging, 4 * (32 * ceil(h / 32) * 3U + max(4224, 256U))
    bytes, within the 232,448 a block may use."""
    units = -(-h // sms)
    smem = 4 * (32 * -(-h // 32) * 3 * units + max(4224, 256 * units))
    return units <= 16 and smem <= 232448


@pytest.mark.parametrize("b", [1, 6, 64, 1000])
def test_gru_fwd_plan_admits_todays_shapes(b):
    """At 132 SMs the plan has a route (sm90 or coop) for exactly the
    (b, h) the cooperative kernel took before, in both dtypes, and
    kernel_ok's GRU gate agrees with it."""
    for dtype in (torch.float32, torch.bfloat16):
        for h in range(1, 1601):
            plan = fused_rnn.gru_fwd_plan(b, h, dtype, 132)
            assert (plan is not None) == _old_gru_rule(h), (b, h, dtype)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_fwd_plan_covers_each_unit_and_row_once(cluster, dtype):
    """With n blocks a cluster, block q of cluster c owns units [qU, qU +
    U) and rows [cR, cR + R): over every shape the cluster holds, each
    hidden unit and each batch row is owned exactly once, and the
    block's shared memory stays under the plan's limit."""
    seen = 0
    for h in (4, 13, 45, 48, 100, 128, 160, 256, 352, 448, 544):
        for b in (1, 5, 37, 64, 1000):
            try:
                plan = fused_rnn.gru_fwd_plan(b, h, dtype, 132,
                                              cluster=cluster)
            except ValueError:
                continue            # the weight does not fit this cluster
            seen += 1
            assert plan.route == "sm90" and plan.cluster == cluster
            assert plan.smem <= fused_rnn._GRU_SMEM
            assert plan.units % 4 == 0 and plan.rows in (1, 2, 4)
            units = np.zeros(h, np.int64)
            for q in range(cluster):
                units[q * plan.units:(q + 1) * plan.units] += 1
            assert (units == 1).all(), (h, b)
            clusters = plan.blocks // cluster
            assert plan.blocks % cluster == 0
            rows = np.zeros(b, np.int64)
            for c in range(clusters):
                rows[c * plan.rows:(c + 1) * plan.rows] += 1
            assert (rows == 1).all(), (h, b)
    assert seen >= 10


def test_gru_fwd_plan_routes_by_shape():
    """The tagger's h 128 takes the sm90 kernel in one block a row (n 1,
    R 1: 64 blocks at b 64) in both dtypes; the cluster size grows with
    h, the rows a cluster with b; h 1024 keeps the cooperative kernel;
    past kernel_ok's limit there is no route. On the CPU gru_forward
    takes the plain version and counts no launch on either route."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = fused_rnn.gru_fwd_plan(64, 128, dtype, 132)
        assert (plan.route, plan.cluster, plan.rows, plan.blocks) == \
            ("sm90", 1, 1, 64)
        assert fused_rnn.gru_fwd_plan(64, 1024, dtype, 132).route == "coop"
        assert fused_rnn.gru_fwd_plan(64, 1473, dtype, 132) is None
    sizes = [fused_rnn.gru_fwd_plan(64, h, torch.float32, 132).cluster
             for h in (128, 160, 256, 352)]
    assert sizes == [1, 2, 4, 8]
    assert fused_rnn.gru_fwd_plan(64, 448, torch.float32, 132).route == \
        "coop"
    assert fused_rnn.gru_fwd_plan(64, 448, torch.bfloat16, 132).cluster == 8
    # rows a cluster: enough to fill the SMs in one wave, at most 4, and
    # at most 2 for a lone block
    rows = [(p.cluster, p.rows) for p in
            (fused_rnn.gru_fwd_plan(b, h, torch.float32, 132)
             for b, h in ((64, 256), (64, 352), (200, 128), (600, 128),
                          (600, 48), (600, 160)))]
    assert rows == [(4, 2), (8, 4), (1, 2), (1, 2), (1, 2), (2, 4)]
    with pytest.raises(ValueError):
        fused_rnn.gru_fwd_plan(64, 128, torch.float32, 132, rows=8)
    assert fused_rnn.gru_fwd_plan(600, 128, torch.float32, 132, cluster=1,
                                  rows=1).blocks == 600
    with pytest.raises(ValueError):
        fused_rnn.gru_fwd_plan(64, 1024, torch.float32, 132, cluster=8)
    with pytest.raises(TypeError):
        fused_rnn.gru_fwd_plan(64, 128, torch.float16, 132)
    fwd = fused_rnn.gru_forward
    before = (fwd.launches, dict(fwd.route_launches))
    x, lens, w, bias, _ = _inputs(3, seed=15)
    got = fwd(torch.tensor(x), torch.tensor(lens), torch.tensor(w),
              torch.tensor(bias))
    want = fused_rnn.gru_reference(torch.tensor(x), torch.tensor(lens),
                                   torch.tensor(w), torch.tensor(bias))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (fwd.launches, dict(fwd.route_launches)) == before
    assert set(fwd.route_launches) == {"sm90", "coop"}


def _scan_case(kind, reverse, with_state, seed):
    gates = {"lstm": 4, "gru": 3, "rnn": 1}[kind]
    x, lens, w, bias, peep = _inputs(gates, seed=seed)
    w = w[:, :gates * 6] if kind != "rnn" else w[:, :6]
    rng = np.random.RandomState(seed + 1)
    h0 = rng.randn(4, 6).astype(np.float32) if with_state else None
    c0 = rng.randn(4, 6).astype(np.float32) if with_state else None
    return x, lens, w, bias, peep, h0, c0


def _scan(pkg, kind, x, lens, w, bias, peep, h0, c0, reverse):
    seq_cls = JSeq if pkg is jrec else TSeq
    arr = jnp.asarray if pkg is jrec else torch.as_tensor
    seq = seq_cls(x, arr(lens))
    if kind == "lstm":
        out, (hT, cT) = pkg.lstm_scan(seq, w, bias, peep, reverse=reverse,
                                      h0=h0, c0=c0, return_state=True)
        return out.data, hT, cT
    if kind == "gru":
        out, hT = pkg.gru_scan(seq, w, bias, reverse=reverse, h0=h0,
                               return_state=True)
        return out.data, hT
    return (pkg.rnn_scan(seq, w, bias, reverse=reverse, h0=h0).data,)


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("reverse,with_state", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_masked_scans_match_jax(kind, reverse, with_state):
    x, lens, w, bias, peep, h0, c0 = _scan_case(kind, reverse, with_state,
                                                seed=11)
    if kind == "gru":
        bias = bias[:18]
    elif kind == "rnn":
        bias = bias[:6]
    peep = peep if kind == "lstm" else None
    c0 = c0 if kind == "lstm" else None
    diff = [a for a in (x, w, bias, peep, h0, c0) if a is not None]
    pos = {id(a): i for i, a in enumerate(diff)}

    def pick(vals, a):
        return None if a is None else vals[pos[id(a)]]

    def run(pkg, vals):
        return _scan(pkg, kind, pick(vals, x), lens, pick(vals, w),
                     pick(vals, bias), pick(vals, peep), pick(vals, h0),
                     pick(vals, c0), reverse)

    jouts, vjp = jax.vjp(lambda *v: run(jrec, v),
                         *[jnp.asarray(a) for a in diff])
    rng = np.random.RandomState(12)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in jouts]
    jg = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [torch.tensor(a, requires_grad=True) for a in diff]
    touts = run(trec, leaves)
    tg = torch.autograd.grad(sum((o * torch.tensor(c)).sum()
                                 for o, c in zip(touts, cts)), leaves)
    for j, t in zip(jouts, touts):
        _close(t.detach(), j, FWD)
    for j, t in zip(jg, tg):
        _close(t, j, GRAD)


def test_cells_match_jax():
    x, _, w, bias, peep = _inputs(4, seed=13)
    rng = np.random.RandomState(14)
    h, c = (rng.randn(4, 6).astype(np.float32) for _ in range(2))
    jh, jc = jrec.lstm_cell(jnp.asarray(x[:, 0]), jnp.asarray(h),
                            jnp.asarray(c), jnp.asarray(w),
                            jnp.asarray(bias), jnp.asarray(peep))
    th, tc = trec.lstm_cell(torch.tensor(x[:, 0]), torch.tensor(h),
                            torch.tensor(c), torch.tensor(w),
                            torch.tensor(bias), torch.tensor(peep))
    _close(th, jh, FWD)
    _close(tc, jc, FWD)
    jg = jrec.gru_cell(jnp.asarray(x[:, 0, :18]), jnp.asarray(h),
                       jnp.asarray(w[:, :18]), jnp.asarray(bias[:18]))
    tg = trec.gru_cell(torch.tensor(x[:, 0, :18]), torch.tensor(h),
                       torch.tensor(w[:, :18]), torch.tensor(bias[:18]))
    _close(tg, jg, FWD)


def test_kernel_gate_and_wrappers_off_the_card():
    """The dispatch gate never admits a CPU tensor, and a wrapper given a
    tensor that is neither on the CPU nor on a CUDA card raises instead
    of falling back to its plain version."""
    assert not fused_rnn.kernel_ok(4, 6, device="cpu")
    assert not fused_rnn.kernel_ok(4, 6, device=None)
    x = torch.zeros((2, 3, 24), device="meta")
    with pytest.raises(ValueError, match="no recurrent kernel"):
        fused_rnn.lstm_forward(x, torch.zeros(2, dtype=torch.int32),
                               torch.zeros((6, 24)), torch.zeros(24),
                               torch.zeros(18))
    with pytest.raises(ValueError, match="no recurrent kernel"):
        fused_rnn.gru_forward(torch.zeros((2, 3, 18), device="meta"),
                              torch.zeros(2, dtype=torch.int32),
                              torch.zeros((6, 18)), torch.zeros(18))
    # the shared-memory plan of the documented limits: the cooperative
    # GRU at 12 units a block (132 SMs) fits up to h 1472
    assert fused_rnn.kernel_smem(1472, 12) <= fused_rnn._SM90_SMEM
    assert fused_rnn.kernel_smem(1473, 12) > fused_rnn._SM90_SMEM


def test_lstm_backward_route_is_chosen_by_dtype_alone():
    """bfloat16 weights take the tensor-core backward (sm90,
    csrc/lstm_bwd_sm90.cu), float32 the three-pass one (bf16x3,
    csrc/lstm_bwd_bf16x3_sm90.cu), decided by dtype before any launch;
    on the CPU both dtypes take the plain version and count no launch."""
    assert fused_rnn.lstm_bwd_route(torch.bfloat16) == "sm90"
    assert fused_rnn.lstm_bwd_route(torch.float32) == "bf16x3"
    with pytest.raises(TypeError):
        fused_rnn.lstm_bwd_route(torch.float16)
    bwd = fused_rnn.lstm_backward
    before = (bwd.launches, dict(bwd.route_launches))
    x, lens, w, bias, peep = _inputs(4, seed=12)
    tl = torch.tensor(lens)
    rng = np.random.RandomState(13)
    for dtype in (torch.float32, torch.bfloat16):
        wd = torch.tensor(w).to(dtype)
        _, hT, _, cseq, gates = fused_rnn.lstm_reference(
            torch.tensor(x).to(dtype), tl, wd, torch.tensor(bias),
            torch.tensor(peep), save_res=True)
        d_out = torch.tensor(rng.randn(*cseq.shape).astype(np.float32)) \
            .to(dtype)
        dhT, dcT = (torch.tensor(rng.randn(*hT.shape).astype(np.float32))
                    for _ in range(2))
        args = (wd, torch.tensor(peep), tl, gates, cseq, d_out, dhT, dcT)
        dz = fused_rnn.lstm_backward(*args)
        assert dz.dtype == dtype
        torch.testing.assert_close(dz, fused_rnn.lstm_backward_reference(
            *args), rtol=0, atol=0)
    assert (bwd.launches, dict(bwd.route_launches)) == before
    assert set(bwd.route_launches) == {"sm90", "bf16x3"}


def _check_sm90_plan(plan, w_bytes_1280):
    """A bf16 LSTM kernel's shared-memory plan: its weight tiles plus ring
    stages of 16384 bytes under the 232,448 bytes a block may use — 4
    stages at the classifier's h 1280, at least 2 up to h 1536, none past
    it; a stage cap takes at most what fits, and a cap of 1 is refused
    (a consumer holds one stage while it waits for the next)."""
    full = (1024 + w_bytes_1280 + 4 * 16384, 4)
    assert plan(1280) == plan(1280, 0) == plan(1280, 8) == full
    for cap in (2, 3):
        assert plan(1280, cap) == (1024 + w_bytes_1280 + cap * 16384, cap)
    assert plan(1280, 1)[1] == 0
    for h in (1, 13, 48, 50, 128, 256, 1312, 1536):
        smem, stages = plan(h)
        assert 2 <= stages <= 8 and smem + 1024 <= fused_rnn._SM90_SMEM, h
    assert plan(1537)[1] == 0


def test_lstm_bwd_sm90_shared_memory_plan():
    """The bf16 backward (csrc/lstm_bwd_sm90.cu): 16 units a block as
    2048-byte weight tiles of 64 of its 4h columns."""
    _check_sm90_plan(fused_rnn.lstm_bwd_sm90_smem, 80 * 2048)


def test_lstm_fwd_sm90_shared_memory_plan():
    """The bf16 forward (csrc/lstm_fwd_sm90.cu): the 64 weight columns of
    16 units a block as 8192-byte tiles of 64 rows of h — the same
    1024 + 20 * 8192 + 4 * 16384 bytes as the backward at h 1280."""
    _check_sm90_plan(fused_rnn.lstm_fwd_sm90_smem, 20 * 8192)
    assert fused_rnn.lstm_fwd_sm90_smem(1280) == \
        fused_rnn.lstm_bwd_sm90_smem(1280)


def test_lstm_forward_route_is_chosen_by_dtype_alone():
    """bfloat16 weights take the tensor-core forward (sm90,
    csrc/lstm_fwd_sm90.cu), float32 the three-pass one (bf16x3,
    csrc/lstm_fwd_bf16x3_sm90.cu), decided by dtype before any launch;
    on the CPU both dtypes take the plain version, with and without
    residuals, and count no launch on either route."""
    assert fused_rnn.lstm_fwd_route(torch.bfloat16) == "sm90"
    assert fused_rnn.lstm_fwd_route(torch.float32) == "bf16x3"
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            fused_rnn.lstm_fwd_route(bad)
    fwd = fused_rnn.lstm_forward
    before = (fwd.launches, fwd.res_launches, dict(fwd.route_launches))
    x, lens, w, bias, peep = _inputs(4, seed=14)
    tl = torch.tensor(lens)
    for dtype in (torch.float32, torch.bfloat16):
        args = (torch.tensor(x).to(dtype), tl, torch.tensor(w).to(dtype),
                torch.tensor(bias), torch.tensor(peep))
        for save_res in (False, True):
            got = fwd(*args, save_res=save_res)
            want = fused_rnn.lstm_reference(*args, save_res=save_res)
            assert got[0].dtype == dtype and got[1].dtype == torch.float32
            for g, r in zip(got, want):
                torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (fwd.launches, fwd.res_launches, dict(fwd.route_launches)) == \
        before
    assert set(fwd.route_launches) == {"sm90", "bf16x3"}


def test_kernel_ok_admits_the_same_grid(monkeypatch):
    """On an emulated H100 (sm_90, 132 SMs) the dispatch gate admits the
    LSTM up to h 1320 and the GRU up to h 1472 at any batch: the float32
    LSTM kernels' 132 blocks bind (the forward's of 10 units, the
    backward's 4 a group of 40 units; both bf16 LSTM kernels fit up to h
    1536). Another architecture is never admitted."""
    import types
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    hs = range(1, 1601)
    for gates, top in ((4, 1320), (3, 1472)):
        for b in (1, 6, 128, 160, 4096):
            admitted = [h for h in hs
                        if fused_rnn.kernel_ok(b, h, gates=gates,
                                               device="cuda")]
            assert admitted == list(range(1, top + 1)), (gates, b)
    assert not fused_rnn.kernel_ok(128, 1280, act="relu", device="cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    assert not fused_rnn.kernel_ok(128, 1280, device="cuda")


# ---- the float32 LSTM forward's product (csrc/lstm_fwd_bf16x3_sm90.cu)
# and plan. Its tolerance is the card check's float32 one (chip_smoke.py
# phase 11): rtol 2e-4, atol 2e-5 x max(1, max|ref|).
F32_CARD = dict(rtol=2e-4, atol=2e-5)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16x3_matmul(h, w, passes):
    """The kernel's product, emulated in plain torch: h and w split into
    bf16 halves by round to nearest even, h1 = bf16(h), h2 = bf16(h -
    h1) and the same for w; with 3 passes (h1 w2 + h2 w1) + h1 w1, the
    small passes summed apart, each in float32; with 1, h1 w1 alone."""
    h1, w1 = _bf16(h), _bf16(w)
    big = h1 @ w1
    if passes == 1:
        return big
    return (h1 @ _bf16(w - w1) + _bf16(h - h1) @ w1) + big


def _lstm_scan_bf16x3(x4, lens, w, bias, peep, passes):
    """The LSTM forward of fused_rnn.lstm_reference (float32), its
    product h @ W replaced by the kernel's: (out, hT, cT)."""
    b, T, four_h = x4.shape
    h = four_h // 4
    pi, pf, po = peep.reshape(3, h)
    hh = torch.zeros((b, h))
    cc = torch.zeros((b, h))
    outs = []
    for t in range(T):
        z = x4[:, t] + _bf16x3_matmul(hh, w, passes) + bias
        zi, zf, zc, zo = z.split(h, dim=-1)
        i = torch.sigmoid(zi + pi * cc)
        f = torch.sigmoid(zf + pf * cc)
        c_new = f * cc + i * torch.tanh(zc)
        h_new = torch.sigmoid(zo + po * c_new) * torch.tanh(c_new)
        valid = (lens > t)[:, None]
        hh = torch.where(valid, h_new, hh)
        cc = torch.where(valid, c_new, cc)
        outs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1), hh, cc


def _card_scale_inputs(b, h, T, seed):
    """Seeded float32 inputs at chip_smoke.py's scales (_rnn_inputs): x4
    0.5, W 1/sqrt(h), bias and peepholes 0.1; ragged lengths with T and
    1 among them."""
    rng = np.random.RandomState(seed)
    x4 = (rng.randn(b, T, 4 * h) * 0.5).astype(np.float32)
    w = (rng.randn(h, 4 * h) * h ** -0.5).astype(np.float32)
    bias = (rng.randn(4 * h) * 0.1).astype(np.float32)
    peep = (rng.randn(3 * h) * 0.1).astype(np.float32)
    lens = rng.randint(1, T + 1, b).astype(np.int32)
    lens[0], lens[1] = T, 1
    return x4, lens, w, bias, peep


def _jax_lstm_f32(x4, lens, w, bias, peep):
    """The JAX package's LSTM oracle (pallas_rnn._lstm_ref) in float32."""
    b, T, four_h = x4.shape
    h = four_h // 4
    return pallas_rnn._lstm_ref(jnp.asarray(x4),
                                jnp.asarray(lens).reshape(b, 1),
                                jnp.asarray(w),
                                jnp.asarray(bias).reshape(1, four_h),
                                jnp.asarray(peep).reshape(3, h))


def _within_card_f32(got, want) -> bool:
    """assert_close at F32_CARD, atol scaled by max(1, max|ref|)."""
    want = torch.tensor(np.array(want, np.float32))
    atol = F32_CARD["atol"] * max(1.0, want.abs().max().item())
    return bool(((got - want).abs() <=
                 atol + F32_CARD["rtol"] * want.abs()).all())


def test_bf16x3_lstm_scan_matches_jax_float32():
    """Three bf16 passes inside an LSTM scan (b 4, h 256, T 24 ragged)
    against the JAX package's float32 LSTM (_lstm_ref): out, hT and cT
    at the card check's float32 tolerance."""
    x4, lens, w, bias, peep = _card_scale_inputs(4, 256, 24, seed=30)
    want = _jax_lstm_f32(x4, lens, w, bias, peep)
    got = _lstm_scan_bf16x3(torch.tensor(x4), torch.tensor(lens),
                            torch.tensor(w), torch.tensor(bias),
                            torch.tensor(peep), passes=3)
    for g, j in zip(got, want):
        atol = F32_CARD["atol"] * max(1.0, float(np.abs(j).max()))
        _close(g, j, dict(rtol=F32_CARD["rtol"], atol=atol))


@pytest.mark.parametrize("passes", [1, 3])
def test_bf16x3_check_has_teeth_at_full_width(passes):
    """At the classifier's h 1280 (b 4, T 8: small enough for the CPU),
    one bf16 pass of the product fails the card's float32 check against
    the JAX package's float32 LSTM, and the kernel's three pass it."""
    x4, lens, w, bias, peep = _card_scale_inputs(4, 1280, 8, seed=31)
    want = _jax_lstm_f32(x4, lens, w, bias, peep)
    got = _lstm_scan_bf16x3(torch.tensor(x4), torch.tensor(lens),
                            torch.tensor(w), torch.tensor(bias),
                            torch.tensor(peep), passes=passes)
    held = [_within_card_f32(g, j) for g, j in zip(got, want)]
    assert all(held) if passes == 3 else not any(held), held


def test_lstm_fwd_bf16x3_plan(monkeypatch):
    """The float32 forward's plan: 128 blocks of 10 units at h 1280, its
    two weight halves in 205,824 bytes, under the opt-in with its static
    reserve, the ring 8 k-steps deep (4 on request); on an emulated H100
    it fits the largest h the dispatch gate admits (1320), and wherever
    it does not fit (h past 10 x SMs) the gate sends the float32 LSTM to
    no kernel route. On 114 SMs the backward's plan binds first: the
    gate admits up to h 1120 (lstm_bwd_bf16x3_plan)."""
    import types
    plan = fused_rnn.lstm_fwd_bf16x3_plan(1280, 132)
    assert plan == (10, 128, 1024 + 2 * 20 * 5120, 8, 80)
    assert plan.smem + 1024 <= fused_rnn._SM90_SMEM
    assert fused_rnn.lstm_fwd_bf16x3_plan(1280, 132, stages=4).stages == 4
    with pytest.raises(ValueError):
        fused_rnn.lstm_fwd_bf16x3_plan(1280, 132, stages=3)
    # odd tile counts round up to even: k-steps a multiple of the ring
    assert fused_rnn.lstm_fwd_bf16x3_plan(100, 132).k_steps == 8
    assert fused_rnn.lstm_fwd_bf16x3_plan(1312, 132).k_steps == 88
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for sms in (132, 114):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device=None, n=sms: types.SimpleNamespace(
                                multi_processor_count=n))
        admitted = [h for h in range(1, 1601)
                    if fused_rnn.kernel_ok(128, h, device="cuda")]
        for h in range(1, 1601):
            p = fused_rnn.lstm_fwd_bf16x3_plan(h, sms)
            assert (p is not None) == (h <= 10 * sms), (sms, h)
            if p is None:
                assert h not in admitted, (sms, h)
            else:
                assert p.blocks <= sms and \
                    p.smem + 1024 <= fused_rnn._SM90_SMEM
                assert p.k_steps * 16 >= h and p.k_steps % 8 == 0
        assert fused_rnn.lstm_fwd_bf16x3_plan(admitted[-1], sms) is not None
    assert admitted[-1] == 1120


# ---- the float32 LSTM backward's product (csrc/lstm_bwd_bf16x3_sm90.cu)
# and plan, at the same float32 tolerance.
def _bf16x3_dz_wt(dz, w, passes):
    """dz W^T as the backward kernel forms it: block (c, q) multiplies
    gate q's columns of dz by gate q's slice of W's rows, each split into
    bf16 halves (_bf16x3_matmul: the small passes summed apart), and the
    owner of a unit sums the four partials in gate order."""
    h = w.shape[0]
    parts = [_bf16x3_matmul(dz[:, q * h:(q + 1) * h],
                            w[:, q * h:(q + 1) * h].t(), passes)
             for q in range(4)]
    return ((parts[0] + parts[1]) + parts[2]) + parts[3]


def _lstm_bwd_bf16x3(w, peep, lens, gates, cseq, d_out, dhT, dcT, passes):
    """The LSTM backward of fused_rnn.lstm_backward_reference (float32),
    its product dz W^T replaced by the kernel's: dz [b, T, 4h]."""
    b, T, four_h = gates.shape
    h = four_h // 4
    pi, pf, po = peep.reshape(3, h)
    dh, dc = dhT, dcT
    dz = torch.empty((b, T, four_h))
    for t in reversed(range(T)):
        i, f, cand, o = gates[:, t].split(h, dim=-1)
        c_t = cseq[:, t]
        c_prev = cseq[:, t - 1] if t > 0 else torch.zeros_like(c_t)
        valid = (lens > t)[:, None]
        dh_t = dh + torch.where(valid, d_out[:, t], torch.zeros_like(dh))
        tc = torch.tanh(c_t)
        dzo = dh_t * tc * o * (1.0 - o)
        dc_t = dc + dh_t * o * (1.0 - tc * tc) + dzo * po
        dzi = dc_t * cand * i * (1.0 - i)
        dzf = dc_t * c_prev * f * (1.0 - f)
        dzc = dc_t * i * (1.0 - cand * cand)
        dz_t = torch.cat([dzi, dzf, dzc, dzo], dim=-1)
        dz_t = torch.where(valid, dz_t, torch.zeros_like(dz_t))
        dh = torch.where(valid, _bf16x3_dz_wt(dz_t, w, passes), dh)
        dc = torch.where(valid, dc_t * f + dzi * pi + dzf * pf, dc)
        dz[:, t] = dz_t
    return dz


def _bwd_case(b, h, T, seed, passes):
    """(the emulated kernel's dz and the contractions of _LSTMFn.backward
    over it, jax.vjp of the JAX package's float32 LSTM: dx4, dw, dbias,
    dpeep) for seeded card-scale inputs and cotangents."""
    x4, lens, w, bias, peep = _card_scale_inputs(b, h, T, seed)
    rng = np.random.RandomState(seed + 1)
    d_out = rng.randn(b, T, h).astype(np.float32)
    dhT, dcT = (rng.randn(b, h).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(
        lambda x, w_, b_, p_: pallas_rnn._lstm_ref(
            x, jnp.asarray(lens).reshape(b, 1), w_, b_.reshape(1, 4 * h),
            p_.reshape(3, h)),
        *(jnp.asarray(a) for a in (x4, w, bias, peep)))
    want = vjp((jnp.asarray(d_out), jnp.asarray(dhT), jnp.asarray(dcT)))
    tl = torch.tensor(lens)
    out, _, _, cseq, gates = fused_rnn.lstm_reference(
        torch.tensor(x4), tl, torch.tensor(w), torch.tensor(bias),
        torch.tensor(peep), save_res=True)
    dz = _lstm_bwd_bf16x3(torch.tensor(w), torch.tensor(peep), tl, gates,
                          cseq, torch.tensor(d_out), torch.tensor(dhT),
                          torch.tensor(dcT), passes)
    return (dz,) + fused_rnn.lstm_param_grads(dz, out, cseq), want


def test_bf16x3_lstm_backward_matches_jax_float32():
    """Three bf16 passes of dz W^T, split by gate as the backward kernel
    splits them, inside the reverse scan (b 4, h 256, T 24 ragged):
    dz, then dw, dbias and dpeep through the contractions the card runs
    after the kernel, against jax.vjp of the JAX package's float32 LSTM
    (_lstm_ref: its dx4 is dz) at the card check's float32 tolerance."""
    got, want = _bwd_case(4, 256, 24, seed=32, passes=3)
    for name, g, j in zip(("dz", "dw", "dbias", "dpeep"), got, want):
        atol = F32_CARD["atol"] * max(1.0, float(np.abs(j).max()))
        _close(g, j, dict(rtol=F32_CARD["rtol"], atol=atol))


@pytest.mark.parametrize("passes", [1, 3])
def test_bf16x3_backward_check_has_teeth_at_full_width(passes):
    """At the classifier's h 1280 (b 4, T 8: small enough for the CPU),
    one bf16 pass of dz W^T fails the card's float32 check of dz against
    the JAX package's float32 LSTM gradient, and the kernel's three pass
    it."""
    got, want = _bwd_case(4, 1280, 8, seed=34, passes=passes)
    assert _within_card_f32(got[0], want[0]) == (passes == 3)


def test_lstm_bwd_bf16x3_plan(monkeypatch):
    """The float32 backward's plan: 128 blocks (32 groups of 40 units x 4
    gates) at h 1280, each owning 10 units and holding its two weight
    halves in the forward's 205,824 bytes; the ring 8 k-steps deep (4 on
    request); it fits wherever 4 ceil(h / 40) blocks fit the SMs — up to
    h 1320 on 132 SMs, 1120 on 114 — and the dispatch gate admits the
    LSTM exactly up to the smaller of its and the forward's limits on
    emulated 132- and 114-SM cards."""
    import types
    plan = fused_rnn.lstm_bwd_bf16x3_plan(1280, 132)
    assert plan == (10, 128, 1024 + 2 * 20 * 5120, 8, 80)
    assert plan.smem == fused_rnn.lstm_fwd_bf16x3_plan(1280, 132).smem
    assert plan.smem + 1024 <= fused_rnn._SM90_SMEM
    assert fused_rnn.lstm_bwd_bf16x3_plan(1280, 132, stages=4).stages == 4
    with pytest.raises(ValueError):
        fused_rnn.lstm_bwd_bf16x3_plan(1280, 132, stages=3)
    assert fused_rnn.lstm_bwd_bf16x3_plan(45, 132).blocks == 8
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for sms, top in ((132, 1320), (114, 1120)):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device=None, n=sms: types.SimpleNamespace(
                                multi_processor_count=n))
        fits = [h for h in range(1, 1601)
                if fused_rnn.lstm_bwd_bf16x3_plan(h, sms) is not None]
        assert fits == [h for h in range(1, 1601)
                        if 4 * -(-h // 40) <= sms]
        assert fits[-1] == top
        for h in fits:
            p = fused_rnn.lstm_bwd_bf16x3_plan(h, sms)
            assert p.blocks <= sms and p.k_steps * 16 >= h
        admitted = [h for h in range(1, 1601)
                    if fused_rnn.kernel_ok(128, h, device="cuda")]
        assert admitted == list(range(1, top + 1)), sms
