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
