"""The dense decode kernel's chunk plan and its split-and-merge
algorithm (paddle_tpu_torch/ops/paged_decode.py ``decode_plan``,
``decode_supported``; csrc/decode_attention.cu) on the CPU.

The Hopper kernel splits each row's live columns into chunks of
``decode_plan(...).cols`` columns, one block each, and the last block
of a (row, kv group) folds the chunks' partial softmax states. Here a
plain float32 emulation of that algorithm, driven by the plan, goes
through the same seeded numpy inputs as the JAX package's
``decode_attention`` in interpret mode (the TPU kernel the Hopper one
replaces) and the port's ``decode_reference``. Tolerance: rtol 2e-5 /
atol 2e-6, the bound the port's decode path is held to against the
interpret kernel (tests/test_torch_two_tier.py): the same exp2
arithmetic, summed in another order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_decode as jax_ops
from paddle_tpu_torch.ops import paged_decode as pt_ops

INTERPRET_DECODE_TOL = dict(rtol=2e-5, atol=2e-6)
# the kernel's dynamic shared memory budget, within the card's 227 KB
SMEM_BUDGET = 226 * 1024


def live_chunks(plan, kv_len, b, T):
    """Blocks per row the kernel runs to the end: ceil(n / plan.cols),
    n the row's live columns — its first kv_len (at most T), or all T
    for a kv_len-0 row; the last of them to finish merges."""
    lens = torch.as_tensor(kv_len).long().reshape(-1).expand(b)
    n = torch.where(lens > 0, torch.clamp(lens, max=T),
                    torch.full_like(lens, T))
    return -(-n // plan.cols)


def chunked_decode_reference(q, k_cache, v_cache, kv_len, plan):
    """The Hopper decode kernel's algorithm in plain float32 torch,
    driven by its plan: each row's live columns (its first kv_len, or
    all T for a kv_len-0 row) in chunks of plan.cols; per chunk and
    query head the base-2 softmax state (m, l, acc) over the chunk (a
    kv_len-0 row weighs every column 1, m staying NEG_INF); then the
    merge by factors exp2(m_c - max_c m_c)."""
    b, h, dh = q.shape
    _, g, _, T = k_cache.shape
    rep = h // g
    scale_log2 = dh ** -0.5 * pt_ops.LOG2E
    lens = torch.as_tensor(kv_len).long().reshape(-1).expand(b)
    live = live_chunks(plan, lens, b, T)
    out = torch.empty(b, h, dh)
    for i in range(b):
        blind = bool(lens[i] <= 0)
        n = T if blind else min(int(lens[i]), T)
        for j in range(g):
            qf = q[i, j * rep:(j + 1) * rep].float()           # [rep, dh]
            ms, ls, accs = [], [], []
            for c in range(int(live[i])):
                c0 = c * plan.cols
                c1 = min(n, c0 + plan.cols)
                kt = k_cache[i, j, :, c0:c1].float()           # [dh, nk]
                vt = v_cache[i, j, :, c0:c1].float()
                if blind:
                    m = torch.full((rep,), pt_ops.NEG_INF)
                    p = torch.ones(rep, c1 - c0)
                else:
                    s = (qf @ kt) * scale_log2
                    m = s.max(dim=-1).values
                    p = torch.exp2(s - m[:, None])
                ms.append(m)
                ls.append(p.sum(dim=-1))
                accs.append(p @ vt.T)
            m_all = torch.stack(ms).max(dim=0).values
            f = [torch.exp2(m - m_all) for m in ms]
            l_all = sum(l * fc for l, fc in zip(ls, f))
            acc = sum(a * fc[:, None] for a, fc in zip(accs, f))
            out[i, j * rep:(j + 1) * rep] = acc / l_all[:, None]
    return out.to(q.dtype)


def _inputs(h, g, T, b=4, dh=8, seed=15):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, dh).astype(np.float32)
    kc = rng.randn(b, g, dh, T).astype(np.float32)
    vc = rng.randn(b, g, dh, T).astype(np.float32)
    return q, kc, vc


# columns a block: one warp's worth, two, the plan's default, and the
# whole T (one chunk, no merge)
CHUNK_COLS = [32, 64, None, "whole"]


@pytest.mark.parametrize("chunk", CHUNK_COLS)
@pytest.mark.parametrize("lens_kind", ["shared", "per_row"])
@pytest.mark.parametrize("g", [8, 2, 1])
def test_split_merge_matches_pallas_interpret(g, lens_kind, chunk):
    """The kernel's split and merge (plain, float32) equal the JAX
    package's decode kernel in interpret mode and the port's plain
    version, at lengths of exactly one chunk, one chunk + 1, all T,
    and 0 (the mean of V over T)."""
    h, T = 8, 100
    q, kc, vc = _inputs(h, g, T)
    b, _, dh = q.shape
    plan = pt_ops.decode_plan(b, h, g, dh, T, 4,
                              T if chunk == "whole" else chunk)
    if chunk in (32, 64):
        assert plan.cols == chunk and plan.n_chunks > 1
    if chunk == "whole":
        assert plan.n_chunks == 1
    C = plan.cols
    lens = np.array([min(C + 1, T)] if lens_kind == "shared" else
                    [min(C, T), min(C + 1, T), T, 0], np.int32)
    want = np.asarray(jax_ops.decode_attention(
        *[jnp.asarray(a) for a in (q, kc, vc, lens)], interpret=True))
    t = [torch.from_numpy(a) for a in (q, kc, vc)]
    got = chunked_decode_reference(*t, torch.from_numpy(lens), plan)
    np.testing.assert_allclose(got.numpy(), want, **INTERPRET_DECODE_TOL)
    ref = pt_ops.decode_reference(*t, torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               **INTERPRET_DECODE_TOL)
    if lens_kind == "per_row":
        mean_v = vc[3].mean(axis=-1)                        # [g, dh]
        np.testing.assert_allclose(
            got[3].numpy(), np.repeat(mean_v, h // g, axis=0),
            rtol=1e-5, atol=1e-6)


def test_live_chunks_cover_the_live_columns():
    """A row's live chunks cover exactly its first kv_len columns (at
    most T), all T for a kv_len-0 row; blocks past them read nothing."""
    T = 544
    lens = torch.tensor([544, 1, 17, 100, 255, 256, 0, 513, 600],
                        dtype=torch.int32)
    for chunk in (32, 64, 128, None, T):
        plan = pt_ops.decode_plan(9, 8, 8, 64, T, 4, chunk)
        n = torch.where(lens > 0, torch.clamp(lens, max=T),
                        torch.full_like(lens, T)).long()
        live = live_chunks(plan, lens, 9, T)
        assert ((live - 1) * plan.cols < n).all()
        assert (live * plan.cols >= n).all()
        assert (live <= plan.n_chunks).all()
    shared = pt_ops.decode_plan(9, 8, 8, 64, T, 4, 64)
    assert live_chunks(shared, [100], 9, T).tolist() == [2] * 9


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("T", [1, 16, 31, 32, 33, 100, 544, 4096])
@pytest.mark.parametrize("chunk", [32, 64, 96, 128, None, 10 ** 6])
def test_decode_plan_chunks(chunk, T, esize):
    """The chunk is a multiple of 32 and at most T rounded up to 32;
    its chunks cover T with a non-empty last one; the merge workspace
    is 0 with one chunk and one record per (row, group, chunk, head)
    otherwise."""
    b, h, g, dh = 8, 8, 2, 64
    plan = pt_ops.decode_plan(b, h, g, dh, T, esize, chunk)
    assert plan.cols % 32 == 0 and 32 <= plan.cols < T + 32
    assert plan.n_chunks == -(-T // plan.cols)
    assert (plan.n_chunks - 1) * plan.cols < T
    if chunk is not None and chunk <= T and chunk % 32 == 0:
        assert plan.cols == chunk
    split = plan.n_chunks > 1
    assert plan.partials == (b * g * plan.n_chunks * 4 * (dh + 4)
                             if split else 0)
    assert plan.counters == (b * g if split else 0)
    assert plan.smem == pt_ops.decode_smem_bytes(4, dh, plan.cols, esize)


def test_decode_plan_default_and_smem_by_hand():
    """The serving shape's plan (b 8, h 8, g 8, dh 64, T 544, float32):
    128 columns a block, 5 chunks; its shared memory by hand: q rows or
    P.V sums of 2 column parts 2 x 64 x 4, K and V 2 x 64 rows of 528
    bytes (512 padded to an odd multiple of 16), the weights 128 x 4,
    (m, l) of 4 column groups 32, (m, l, factor) 12 padded to 16."""
    plan = pt_ops.decode_plan(8, 8, 8, 64, 544, 4)
    assert (plan.cols, plan.n_chunks) == (128, 5)
    assert plan.smem == 512 + 2 * 64 * 528 + 512 + 32 + 16
    assert plan.partials == 8 * 8 * 5 * 68
    assert plan.counters == 64
    # bfloat16: the rows as loaded are kept too, 64 x 2 bytes; a tile
    # row is 256 bytes padded to 272
    bf = pt_ops.decode_plan(8, 8, 8, 64, 544, 2)
    assert bf.smem == 512 + 128 + 2 * 64 * 272 + 512 + 32 + 16
    c64 = pt_ops.decode_plan(8, 8, 8, 64, 544, 4, 64)
    assert (c64.cols, c64.n_chunks) == (64, 9)
    assert c64.smem == 512 + 2 * 64 * 272 + 256 + 16 + 16
    # 32 heads a group at dh 8: one chunk's partial records (32 x 12
    # floats) outgrow the two 32-column tiles (2 x 8 x 80 bytes), and
    # the tiles' region takes the records' size
    wide = pt_ops.decode_plan(2, 32, 1, 8, 544, 2, 32)
    assert wide.smem == 4 * 32 * 8 * 4 + 32 * 8 * 2 + 32 * 12 * 4 + \
        32 * 32 * 4 + 2 * 32 * 4 + 32 * 12


# (b, h, g, dh, T, esize): the widest shapes the gate admits, where the
# plan cuts the chunk to what fits
GATE_EDGES = [
    (8, 32, 1, 256, 4096, 4),
    (8, 32, 1, 256, 4096, 2),
    (2, 32, 1, 512, 544, 4),
    (2, 32, 1, 512, 544, 2),
    (2, 8, 8, 512, 4096, 4),
    (1, 1, 1, 8, 1 << 20, 2),
]


@pytest.mark.parametrize("shape", GATE_EDGES)
def test_decode_plan_fits_every_admitted_shape(shape):
    b, h, g, dh, T, esize = shape
    dtype = torch.float32 if esize == 4 else torch.bfloat16
    q = torch.zeros((b, h, dh), dtype=dtype)
    k = torch.empty((b, g, dh, T), dtype=dtype, device="meta")
    assert pt_ops.decode_supported(q, k), shape
    plan = pt_ops.decode_plan(b, h, g, dh, T, esize)
    assert plan.smem <= SMEM_BUDGET, plan
    assert plan.cols >= 32 and plan.n_chunks * plan.cols >= T


def test_decode_gate_rejects_what_the_plan_cannot_fit():
    """32 query heads a group at dh 1024: one 32-column chunk's tiles
    and q rows pass shared memory, so the gate refuses the shape."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((2, 32, 1024), dtype=dtype)
        k = torch.empty((2, 1, 1024, 64), dtype=dtype)
        plan = pt_ops.decode_plan(2, 32, 1, 1024, 64, q.element_size())
        assert plan.cols == 32 and plan.smem > SMEM_BUDGET
        assert not pt_ops.decode_supported(q, k)
