"""Port parity: the OCR and speech types of paddle_tpu_torch against
paddle_tpu on the CPU — row_conv, block_expand, mdlstm, ctc and
warp_ctc — and the two graphs that end in a CTC cost.

Layers run through ``tests/torch_parity.check_parity`` (both DSLs, one
JAX init tar, one seeded feed; outputs and the gradients of a seeded
projection at rtol 1e-4 / atol 1e-5); the ops also directly against
``jax.vjp``. The cases that carry the port's traps: row_conv on ragged
rows whose lookahead crosses a row's end (it must read zeros there),
block_expand with a stride that does not divide the height (the JAX op
walks in floor mode while its meta counts in ceil mode), mdlstm in all
four directions and its anti-diagonal walk against the cell-by-cell
plain version, and CTC on ragged frames and labels with a label no
alignment can emit (the JAX package's cost is about 1e30, not inf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from chip_smoke import ocr_ctc_net, speech_ctc_net
from paddle_tpu.ops import ctc as jctc
from paddle_tpu.ops import recurrent as jrnn
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.ops import ctc as tctc
from paddle_tpu_torch.ops import recurrent as trnn
from tests.torch_parity import RTOL, ATOL, build_both, check_parity, \
    seq_rows, submodule

LENS = [5, 2, 7]


@pytest.fixture(autouse=True)
def _port_config():
    yield
    tconfig.init(seed=0)


def _dt(L):
    return submodule(L, "core.data_type")


def _act(L):
    return submodule(L, "activation")


# ------------------------------------------------------------- row_conv


@pytest.mark.parametrize("context,act", [(4, "relu"), (1, None), (3, None)])
def test_row_conv_on_ragged_rows_matches_jax(context, act):
    """fc -> row_conv over rows of 5, 2 and 7 steps: a context of 4
    reaches past every row's end."""
    def build(L):
        x = L.data("s", _dt(L).dense_vector_sequence(6))
        h = L.fc(x, size=5, name="h")
        a = _act(L).Relu() if act else None
        return L.row_conv(h, context_len=context, act=a, name="rc")

    rng = np.random.RandomState(0)
    samples = [(r,) for r in seq_rows(rng, LENS, 6)]
    _, tout = check_parity(build, samples)
    assert list(tout["rc"].lengths) == LENS


def test_row_conv_op_reads_zeros_past_the_end():
    """The op alone against the JAX op and a numpy loop: y[t] = sum_i
    x[t + i] w[i], steps past T as zeros."""
    from paddle_tpu.ops import conv as jconv
    from paddle_tpu_torch.ops import conv as tconv
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 3).astype(np.float32)
    w = rng.randn(4, 3).astype(np.float32)
    want = np.zeros_like(x)
    for t in range(6):
        for i in range(4):
            if t + i < 6:
                want[:, t] += x[:, t + i] * w[i]
    got = tconv.row_conv(torch.tensor(x), torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jconv.row_conv(jnp.asarray(x), jnp.asarray(w))),
        rtol=RTOL, atol=ATOL)


# --------------------------------------------------------- block_expand


def _image(L, c, h, w, nf, name="im", k=3):
    x = L.data(name, _dt(L).dense_vector(c * h * w), height=h, width=w)
    return L.img_conv(x, filter_size=k, num_filters=nf, num_channels=c,
                      padding=(k - 1) // 2, name=f"{name}_conv")


def _image_cols(dim, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(dim).astype(np.float32),) for _ in range(n)]


@pytest.mark.parametrize("kw,steps", [
    # H 8 by 3 / 2: floor 3 rows of blocks (ceil would give 4)
    (dict(block_x=2, block_y=3, stride_x=2, stride_y=2), 12),
    (dict(block_x=3, block_y=3, stride_x=3, stride_y=3, padding_x=1,
          padding_y=1), 9),
    (dict(block_x=1, block_y=8), 8)])
def test_block_expand_floor_walk_matches_jax(kw, steps):
    def build(L):
        return L.block_expand(_image(L, 2, 8, 8, nf=3), name="be", **kw)

    jt, tt = build_both(build)
    _, tout = check_parity(build, _image_cols(2 * 8 * 8))
    assert tout["be"].data.shape == (3, steps, 3 * kw["block_x"] *
                                     kw["block_y"])
    assert list(tout["be"].lengths) == [steps] * 3
    if kw["block_y"] == 3 and kw["stride_y"] == 2:
        # the meta's count is the JAX package's ceil-mode reckoning
        cfg = [l for l in tt.layers if l.name == "be"][0].config
        assert cfg["_steps"] == 16


# ---------------------------------------------------------------- mdlstm


@pytest.mark.parametrize("directions", [[True, True], [False, True],
                                        [True, False], [False, False]])
def test_mdlstm_directions_match_jax(directions):
    """conv 1x1 to 5 x 3 gate channels -> mdlstm, each walk direction;
    the gradients reach the recurrent weight, the 9h bias and the
    conv."""
    def build(L):
        g = _image(L, 2, 4, 5, nf=15, k=1)
        return L.mdlstm(g, directions=directions, name="md")

    check_parity(build, _image_cols(2 * 4 * 5))


@pytest.mark.parametrize("shape", [(2, 4, 5), (3, 6, 2), (1, 1, 7),
                                   (2, 5, 1)])
@pytest.mark.parametrize("reverse_h,reverse_w", [(False, False),
                                                 (True, False),
                                                 (False, True),
                                                 (True, True)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_mdlstm_op_walks_match_jax_vjp(shape, reverse_h, reverse_w,
                                       with_bias):
    """The anti-diagonal walk (``mdlstm_2d``) and the plain cell-by-cell
    one (``mdlstm_2d_reference``) each against JAX's nested scan:
    outputs and the gradients of x, w and the bias."""
    b, H, W = shape
    h = 3
    rng = np.random.RandomState(7)
    x = rng.randn(b, H, W, 5 * h).astype(np.float32)
    w = (rng.randn(h, 5 * h) * 0.5).astype(np.float32)
    bias = (rng.randn(9 * h) * 0.5).astype(np.float32)
    g = rng.randn(b, H, W, h).astype(np.float32)
    kw = dict(reverse_h=reverse_h, reverse_w=reverse_w)
    args = [x, w] + ([bias] if with_bias else [])

    def jf(x, w, *bias):
        return jrnn.mdlstm_2d(x, w, bias[0] if bias else None, **kw)

    jy, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    jg = vjp(jnp.asarray(g))
    for fn in (trnn.mdlstm_2d, trnn.mdlstm_2d_reference):
        targs = [torch.tensor(a, requires_grad=True) for a in args]
        ty = fn(targs[0], targs[1], targs[2] if with_bias else None, **kw)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=RTOL, atol=ATOL)
        tg = torch.autograd.grad(ty, targs, torch.tensor(g))
        for a, j in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=ATOL)


# ------------------------------------------------------------------- ctc


def _ctc_batch(rng, frames, labels, C):
    b, T = len(frames), max(frames)
    U = max(len(l) for l in labels)
    x = rng.randn(b, T, C).astype(np.float32)
    lp = np.ones((b, T), np.float32)
    lab = np.zeros((b, U), np.int32)
    labp = np.ones((b, U), np.float32)
    for i, (n, l) in enumerate(zip(frames, labels)):
        lp[i, :n] = 0.0
        lab[i, :len(l)] = l
        labp[i, :len(l)] = 0.0
    return x, lp, lab, labp


@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_op_matches_jax_with_an_infeasible_label(blank):
    """Ragged frames and labels, a repeated label (a blank must come
    between), and a row whose label cannot fit its 2 frames: that row
    costs > 1e10 in both packages (the JAX package's 1e30, not inf), and
    every cost and gradient agrees."""
    rng = np.random.RandomState(3)
    shift = 0 if blank == 0 else 1           # keep the labels off the blank
    labels = [[l - shift for l in row]
              for row in ([1, 2, 2], [3], [1, 2, 3], [4, 4])]
    x, lp, lab, labp = _ctc_batch(rng, [7, 4, 2, 6], labels, 6)
    jl, vjp = jax.vjp(lambda a: jctc.ctc_loss(a, lp, lab, labp, blank),
                      jnp.asarray(x))
    g = np.ones(4, np.float32)
    (jg,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    tl = tctc.ctc_loss(xt, torch.tensor(lp), torch.tensor(lab),
                       torch.tensor(labp), blank)
    (tg,) = torch.autograd.grad(tl, xt, torch.tensor(g))
    jl, tl = np.asarray(jl), tl.detach().numpy()
    assert jl[2] > 1e10 and tl[2] > 1e10 and np.isfinite(tl).all()
    assert (jl[[0, 1, 3]] < 1e3).all()
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)


def test_ctc_op_matches_alignment_enumeration():
    """A small case against the brute-force sum over every alignment
    (the JAX package's own golden method, tests/test_ctc.py)."""
    from tests.test_ctc import brute_force_nll
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 3).astype(np.float32)
    want = brute_force_nll(logits, [1, 1], 0)
    got = tctc.ctc_loss(torch.tensor(logits[None]), torch.zeros(1, 4),
                        torch.tensor([[1, 1]]), torch.zeros(1, 2), 0)
    np.testing.assert_allclose(got.numpy()[0], want, rtol=RTOL)


FRAMES = [7, 4, 9]
LABELS = [[1, 3, 2], [2], [0, 0, 4]]


def _ctc_samples(frames, labels, dim, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, dim).astype(np.float32),
             np.asarray(l, np.int32)) for n, l in zip(frames, labels)]


@pytest.mark.parametrize("kind", ["ctc", "warp_ctc"])
def test_ctc_layers_on_ragged_frames_and_labels_match_jax(kind):
    """ctc on softmax probabilities (blank the last class, 5) and
    warp_ctc on raw logits (blank 0, so labels are shifted off it)."""
    labels = LABELS if kind == "ctc" else [[l + 1 for l in r] for r in
                                           LABELS]

    def build(L):
        x = L.data("s", _dt(L).dense_vector_sequence(4))
        lbl = L.data("lbl", _dt(L).integer_value_sequence(6))
        if kind == "ctc":
            p = L.fc(x, size=6, act=_act(L).Softmax(), name="probs")
            return L.ctc(p, lbl, size=6, name="cost")
        return L.warp_ctc(L.fc(x, size=6, name="logits"), lbl, size=6,
                          name="cost")

    jout, _ = check_parity(build, _ctc_samples(FRAMES, labels, 4))
    assert (np.asarray(jout["cost"]) < 1e3).all()


@pytest.mark.parametrize("kind", ["ctc", "warp_ctc"])
def test_ctc_layers_infeasible_label_agree(kind):
    """A 2-frame row with a 3-label target: > 1e10 in both packages and
    equal; the feasible rows' costs and every gradient equal JAX's."""
    def build(L):
        x = L.data("s", _dt(L).dense_vector_sequence(4))
        lbl = L.data("lbl", _dt(L).integer_value_sequence(6))
        h = L.fc(x, size=6, act=_act(L).Softmax() if kind == "ctc" else
                 None, name="h")
        return getattr(L, kind)(h, lbl, size=6, name="cost")

    jout, tout = check_parity(build, _ctc_samples(
        [6, 2, 5], [[1, 2], [1, 2, 3], [3]], 4, seed=2))
    for out in (np.asarray(jout["cost"]), tout["cost"].detach().numpy()):
        assert out[1] > 1e10 and out[0] < 1e3 and out[2] < 1e3


# ----------------------------------------------- graphs ending in CTC


OCR = dict(height=8, width=12, hidden=4, classes=6)
SPEECH = dict(dim=8, hidden=16, context=3, classes=7)


def _package(L):
    return jpaddle if L is jpaddle.layer else tpaddle


def ocr_graph(L):
    """chip_smoke.ocr_ctc_net: 1x1 conv gates -> mdlstm -> block_expand
    into columns -> fc softmax -> ctc (blank the last class)."""
    return ocr_ctc_net(_package(L), **OCR)


def speech_graph(L):
    """chip_smoke.speech_ctc_net: fc -> row_conv -> fc logits ->
    warp_ctc (blank 0)."""
    return speech_ctc_net(_package(L), **SPEECH)


def test_ocr_graph_with_ctc_matches_jax():
    rng = np.random.RandomState(11)
    labels = [[1, 3, 0, 2], [4], [2, 2, 1]]
    samples = [(rng.randn(OCR["height"] * OCR["width"]).astype(np.float32),
                np.asarray(l, np.int32)) for l in labels]
    jout, _ = check_parity(ocr_graph, samples)
    assert (np.asarray(jout["ctc_cost"]) < 1e3).all()


def test_speech_graph_with_warp_ctc_matches_jax():
    labels = [[1, 3, 6], [2, 2], [5, 4, 1, 1]]
    jout, _ = check_parity(speech_graph,
                           _ctc_samples([9, 5, 12], labels, 8, seed=12))
    assert (np.asarray(jout["ctc_cost"]) < 1e3).all()
