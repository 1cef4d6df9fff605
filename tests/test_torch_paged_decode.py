"""Port parity: paddle_tpu_torch/ops/paged_decode.py against
paddle_tpu/ops/pallas_decode.py on the CPU.

The same seeded numpy inputs go through the port's
``paged_window_attention`` (a CPU tensor takes its plain gather/einsum
version) and the JAX package's, both as the einsum path
(``use_kernel=False``) and as the allocated-pages Pallas kernel in
interpret mode — the oracle the port's Hopper kernel replaces.
Tolerances are the JAX package's own for the same comparisons
(tests/test_paged_decode.py): rtol 2e-5 / atol 2e-6 against the exact
einsum, rtol 2e-4 / atol 2e-5 against the interpret kernel (base-2
online softmax vs natural-base softmax over -1e30 masks).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_decode as jax_ops
from paddle_tpu_torch.ops import paged_decode as pt_ops

TOLS = {"einsum": dict(rtol=2e-5, atol=2e-6),
        "interpret": dict(rtol=2e-4, atol=2e-5)}
# chunk sizes of the split page walk: one page, two, one chunk over the
# whole table
CHUNKS = [1, 2, "all"]


def _window_inputs(h, g, W, seed=3):
    """Ragged mid-page lengths, out-of-order physical pages, trailing
    table entries on the null page (tests/test_paged_decode.py
    TestPagedWindowKernel)."""
    rng = np.random.RandomState(seed)
    S, dh, ps, npages = 3, 8, 4, 12
    k_pages = rng.randn(npages, ps, g, dh).astype(np.float32)
    v_pages = rng.randn(npages, ps, g, dh).astype(np.float32)
    q = rng.randn(S, W, h, dh).astype(np.float32)
    tables = np.array([[3, 1, 7, 0, 0],
                       [2, 9, 4, 11, 8],
                       [5, 6, 0, 0, 0]], np.int32)
    base = np.array([9, 15, 5], np.int32)
    lens = (base[:, None] + np.arange(W)[None, :]).astype(np.int32)
    return q, k_pages, v_pages, tables, lens


@pytest.mark.parametrize("oracle", ["einsum", "interpret"])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (4, 1)])
def test_window_attention_matches_jax(h, g, W, oracle):
    arrs = _window_inputs(h, g, W)
    use_kernel = oracle == "interpret"
    want = np.asarray(jax_ops.paged_window_attention(
        *[jnp.asarray(a) for a in arrs], use_kernel=use_kernel,
        interpret=use_kernel))
    got = pt_ops.paged_window_attention(
        *[torch.from_numpy(a) for a in arrs])
    assert got.shape == (arrs[0].shape)
    np.testing.assert_allclose(got.numpy(), want, **TOLS[oracle])


@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (4, 1)])
def test_paged_attention_matches_jax(h, g):
    """The one-token plain path (paged_attention) itself, per-row
    ragged lengths, GQA/MQA widths."""
    rng = np.random.RandomState(0)
    b, dh, ps, npages = 3, 8, 4, 16
    k_pages = rng.randn(npages, ps, g, dh).astype(np.float32)
    v_pages = rng.randn(npages, ps, g, dh).astype(np.float32)
    q = rng.randn(b, h, dh).astype(np.float32)
    table = np.array([[3, 1, 7, 0, 0],
                      [2, 9, 4, 11, 0],
                      [5, 6, 0, 0, 0]], np.int32)
    lens = np.array([9, 17, 5], np.int32)
    arrs = (q, k_pages, v_pages, table, lens)
    want = np.asarray(jax_ops.paged_attention(
        *[jnp.asarray(a) for a in arrs]))
    got = pt_ops.paged_attention(*[torch.from_numpy(a) for a in arrs])
    np.testing.assert_allclose(got.numpy(), want, **TOLS["einsum"])


def test_gather_pages_matches_jax():
    rng = np.random.RandomState(1)
    pages = rng.randn(6, 4, 2, 8).astype(np.float32)
    table = np.array([[5, 0, 2], [1, 3, 0]], np.int32)
    want = np.asarray(jax_ops.gather_pages(jnp.asarray(pages),
                                           jnp.asarray(table)))
    got = pt_ops.gather_pages(torch.from_numpy(pages),
                              torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


def test_idle_slot_reads_null_page_and_stays_finite():
    """An inactive slot (kv_len 1, all-null table row) reads page 0
    only; its output is discarded by the engine but must be finite."""
    q, k_pages, v_pages, tables, lens = _window_inputs(4, 2, 1)
    tables[1] = 0
    lens[1] = 1
    got = pt_ops.paged_window_attention(
        *[torch.from_numpy(a) for a in (q, k_pages, v_pages, tables,
                                        lens)])
    assert torch.isfinite(got).all()
    # one visible column: the output is exactly that column's V row
    np.testing.assert_allclose(
        got[1, 0].numpy(),
        np.repeat(v_pages[0, 0], 2, axis=0).reshape(4, 8), rtol=1e-6)


def test_cpu_path_never_counts_a_kernel_launch():
    before = pt_ops.paged_window_attention.launches
    arrs = _window_inputs(4, 2, 3)
    pt_ops.paged_window_attention(*[torch.from_numpy(a) for a in arrs])
    assert pt_ops.paged_window_attention.launches == before


def test_bf16_plain_path_close_to_f32():
    """bfloat16 inputs run the same plain version with a float32
    softmax; the result stays within bf16 rounding of float32."""
    arrs = _window_inputs(4, 2, 3)
    f32 = pt_ops.paged_window_attention(
        *[torch.from_numpy(a) for a in arrs])
    bf = [torch.from_numpy(a) for a in arrs]
    bf[:3] = [t.to(torch.bfloat16) for t in bf[:3]]
    got = pt_ops.paged_window_attention(*bf)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(),
                               atol=5e-2, rtol=0)


def test_kernel_gate():
    q = torch.zeros((2, 2, 4, 8))
    assert pt_ops.paged_kernel_supported(q, torch.zeros((8, 4, 2, 8)))
    # head dim off the multiple of 8
    assert not pt_ops.paged_kernel_supported(
        torch.zeros((2, 2, 4, 6)), torch.zeros((8, 4, 2, 6)))
    # more than 32 query rows per kv group (W * rep)
    assert not pt_ops.paged_kernel_supported(
        torch.zeros((2, 9, 4, 8)), torch.zeros((8, 4, 1, 8)))
    # dtype the kernel does not take, or q and pages disagreeing
    assert not pt_ops.paged_kernel_supported(
        q.half(), torch.zeros((8, 4, 2, 8)).half())
    assert not pt_ops.paged_kernel_supported(
        q, torch.zeros((8, 4, 2, 8), dtype=torch.bfloat16))


# --------------------------------------------- the kernel's chunk plan
def plan_for(q, k_pages, tables, chunk):
    """The kernel's plan for these tensors with ``chunk`` pages a block
    ("all": one chunk over the whole table); int8 pages are quantized."""
    S, W, h, dh = q.shape
    _, ps, g, _ = k_pages.shape
    P = tables.shape[1]
    return pt_ops.window_plan(S, W, h, g, dh, ps, P,
                              k_pages.dtype.itemsize,
                              k_pages.dtype == torch.int8,
                              P if chunk == "all" else chunk)


def chunked_window_reference(q, k_pages, v_pages, tables, lens, plan, *,
                             k_scales=None, v_scales=None):
    """The Hopper window kernel's algorithm in plain float32 torch,
    driven by its chunk plan: each slot's used rows (plan.used_pages) in
    chunks of plan.rows; per chunk and query row the base-2 softmax
    state (m, l, acc) over the columns the row sees (a kv_len-0 row
    sees none and weighs every column 1, m staying NEG_INF; a live row
    with no column in the chunk gives (NEG_INF, 0, 0)); then the merge
    by factors exp2(m_c - max_c m_c) and the division by max(l,
    1e-30). int8 pages dequantize per element in float32."""
    S, W, h, dh = q.shape
    _, ps, g, _ = k_pages.shape
    rep = h // g
    scale_log2 = dh ** -0.5 * pt_ops.LOG2E
    used = plan.used_pages(lens)
    live = plan.live_chunks(lens)
    lens = torch.as_tensor(lens).long()
    out = torch.empty(S, W, h, dh)
    for s in range(S):
        pages = torch.as_tensor(tables[s, :int(used[s])]).long()
        k = k_pages[pages].float()
        v = v_pages[pages].float()
        if k_scales is not None:
            k = k * k_scales[pages].float()[..., None]
            v = v * v_scales[pages].float()[..., None]
        k = k.reshape(-1, g, dh).repeat_interleave(rep, dim=1)
        v = v.reshape(-1, g, dh).repeat_interleave(rep, dim=1)
        qf = q[s].float()                                   # [W, h, dh]
        ms, ls, accs = [], [], []
        for c in range(int(live[s])):
            c0 = c * plan.rows
            kc, vc = k[c0:c0 + plan.rows], v[c0:c0 + plan.rows]
            col = c0 + torch.arange(kc.shape[0])
            sees = col[None, :] < lens[s][:, None]          # [W, nk]
            blind = (lens[s] <= 0)[:, None].expand_as(sees)
            sc = torch.einsum("whd,khd->whk", qf, kc) * scale_log2
            sc = torch.where(sees[:, None], sc,
                             torch.tensor(pt_ops.NEG_INF))
            m = sc.max(dim=-1).values                       # [W, h]
            p = torch.where((sees | blind)[:, None],
                            torch.exp2(sc - m[..., None]),
                            torch.tensor(0.0))
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("whk,khd->whd", p, vc))
        m_all = torch.stack(ms).max(dim=0).values
        f = [torch.exp2(m - m_all) for m in ms]
        l_all = sum(l * fc for l, fc in zip(ls, f))
        acc = sum(a * fc[..., None] for a, fc in zip(accs, f))
        out[s] = acc / torch.clamp(l_all, min=1e-30)[..., None]
    return out


def test_chunk_plan_used_pages_and_live_chunks():
    """The plan's used pages are pallas_decode.py:448's ``used`` on
    seeded lengths (an idle slot at kv_len 1 on the null page, a
    kv_len-0 token, windows of 1 and 3 tokens); its live chunks cover
    exactly those pages."""
    rng = np.random.RandomState(11)
    S, P, ps = 9, 34, 16
    for W in (1, 3):
        lens = rng.randint(1, P * ps + 1, (S, W)).astype(np.int32)
        lens[0] = 1                                  # idle slot
        lens[1, 0] = 0
        lens[2] = P * ps                             # full context
        want = np.asarray(jnp.clip(-(-jnp.max(jnp.asarray(lens), axis=1)
                                     // ps), 1, P))
        for chunk in (None, 1, 2, 3, P):
            plan = pt_ops.window_plan(S, W, 8, 8, 64, ps, P, 4, False,
                                      chunk)
            used = plan.used_pages(lens).numpy()
            np.testing.assert_array_equal(used, want)
            n = plan.live_chunks(lens).numpy()
            assert ((n - 1) * plan.rows < used * ps).all()
            assert (n * plan.rows >= used * ps).all()
            assert plan.n_chunks == -(-P * ps // plan.rows)
            assert (n <= plan.n_chunks).all() and n[0] == 1
            split = plan.n_chunks > 1
            assert plan.partials == (S * 8 * plan.n_chunks * W * 66
                                     if split else 0)
            assert plan.flags == (S * 8 * plan.n_chunks if split else 0)


def test_chunk_plan_sizes():
    """8 whole pages a block at the engine's shapes (float32, bf16 and
    int8), fewer in a narrower table, and pages cut to what fits in
    float32 at dh 256; a block's shared memory within the kernel's 226
    KB at the gate's widest admitted shapes, where a page is cut into
    parts."""
    def plan(*a):
        return pt_ops.window_plan(*a)
    assert plan(8, 1, 8, 8, 64, 16, 34, 4, False).rows == 128
    assert plan(8, 1, 8, 8, 64, 16, 34, 2, False).rows == 128
    assert plan(8, 3, 8, 8, 64, 16, 34, 1, True).rows == 128
    assert plan(3, 1, 4, 2, 8, 4, 5, 4, False).rows == 20    # 5 pages
    assert plan(8, 1, 8, 8, 256, 16, 34, 4, False).rows == 96
    # the kernel's layout at the engine's float32 shapes, by hand: q
    # rows or P.V sums of 2 key parts 2 x 64 x 4, K and V 2 x 128 x 272,
    # probabilities 512, (m, l) 16, 10 page ids 48, lengths 16
    assert plan(8, 1, 8, 8, 64, 16, 34, 4, False).smem == \
        512 + 2 * 128 * 272 + 512 + 16 + 48 + 16
    gate = [  # (S, W, h, g, dh, ps, P, esize, quant) admitted by the gate
        (2, 1, 32, 1, 256, 56, 4, 4, False),
        (2, 4, 8, 1, 8, 3632, 2, 2, False),
        (2, 1, 8, 1, 8, 4841, 2, 1, True),
        (2, 32, 1, 1, 256, 14, 3, 4, False),
    ]
    for a in gate:
        S, W, h, g, dh, ps, P, esize, quant = a
        q = torch.zeros((S, W, h, dh), dtype=(torch.float32 if esize == 4
                                              else torch.bfloat16))
        kp = torch.zeros((4, ps, g, dh), dtype={4: torch.float32,
                                                2: torch.bfloat16,
                                                1: torch.int8}[esize])
        ks = torch.zeros((4, ps, g)) if quant else None
        if quant:
            q = q.float()
        assert pt_ops.paged_kernel_supported(q, kp, ks), a
        p = plan(*a)
        assert 1 <= p.rows and p.smem <= 226 * 1024, (a, p)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (4, 1)])
def test_chunked_merge_matches_pallas_interpret(h, g, W, chunk):
    """The kernel's split page walk and merge (plain, in float32) equal
    the JAX package's allocated-pages kernel in interpret mode, a
    kv_len-0 token included: both return the mean of V over the slot's
    used pages for it."""
    q, k_pages, v_pages, tables, lens = _window_inputs(h, g, W)
    lens[1, 0] = 0
    want = np.asarray(jax_ops.paged_window_attention(
        *[jnp.asarray(a) for a in (q, k_pages, v_pages, tables, lens)],
        use_kernel=True, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k_pages, v_pages)]
    plan = plan_for(t[0], t[1], tables, chunk)
    got = chunked_window_reference(*t, tables, lens, plan)
    np.testing.assert_allclose(got.numpy(), want, **TOLS["interpret"])
