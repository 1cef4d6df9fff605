"""Paged decode attention — the counterpart of
``paddle_tpu/ops/pallas_decode.py`` for the serving path.

- :func:`gather_pages` / :func:`paged_attention`: the plain gather +
  einsum version (the same einsum strings, ``NEG_INF`` mask and float32
  softmax as the reference). It reads each slot's full page-table
  width; it is the CPU path and the oracle the kernel is held against.
- :func:`paged_window_attention`: attention for a W-token window per
  slot. A tensor on the CPU takes the plain version; a tensor on a
  CUDA card launches the hand-written Hopper kernel
  (``csrc/paged_window_attention.cu`` — replaces the allocated-pages
  Pallas kernel ``_paged_window_kernel``) or raises. There is no
  fallback from the card to the plain version.

Layouts are the reference's: q ``[S, W, h, dh]``, page pools
``[n_pages, page_size, g, dh]`` (h % g == 0 — grouped-query heads
read the cache at stored width), page tables ``[S, P]`` int32 whose
entries past a slot's allocation point at the reserved null page 0,
kv_lens ``[S, W]`` int32 per-token valid lengths (token w of slot s is
the query at position ``kv_lens[s, w] - 1``, so one mask is both the
ragged-length and the in-window causal mask).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

# the kernel's limits (csrc/paged_window_attention.cu): one warp per
# query row of a kv group, lanes striding over dh, two pages' K and V
# rows of one group double-buffered in shared memory by 16-byte copies
_MAX_ROWS_PER_GROUP = 32        # W * rep warps in one block
_MAX_HEAD_DIM = 256
_MAX_SMEM_BYTES = 227 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gather_pages(pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """Contiguous per-sequence view of a paged pool: ``pages``
    [n_pages, page_size, g, dh] gathered through ``page_table`` [b, P]
    -> [b, P*page_size, g, dh]."""
    b, pp = page_table.shape
    _, ps, g, dh = pages.shape
    return pages[page_table.long()].reshape(b, pp * ps, g, dh)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    kv_lens: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention over the paged pool, plain version.
    q [b, h, dh]; page_table [b, P]; kv_lens [b]. Returns [b, h, dh].
    The softmax runs in float32 whatever the input dtype."""
    b, h, dh = q.shape
    g = k_pages.shape[2]
    assert h % g == 0, (h, g)
    rep = h // g
    if scale is None:
        scale = dh ** -0.5
    k = gather_pages(k_pages, page_table)              # [b, T, g, dh]
    v = gather_pages(v_pages, page_table)
    t = k.shape[1]
    lens = kv_lens.reshape(-1).to(q.device)
    q5 = q.reshape(b, 1, g, rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", q5,
                          k.to(q.dtype)) * scale
    mask = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    logits = logits.float().masked_fill(~mask[:, None, None, None],
                                        NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    attn = torch.einsum("bgrqk,bkgd->bqgrd", w, v.to(q.dtype))
    return attn.reshape(b, h, dh)


def paged_window_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           page_tables: torch.Tensor,
                           kv_lens: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of :func:`paged_window_attention`: flattens the
    window into :func:`paged_attention` rows (every window token reads
    its slot's pages through a repeated table row). Runs on any
    device; the kernel is held against it."""
    S, W, h, dh = q.shape
    lens = kv_lens.reshape(S, W)
    out = paged_attention(
        q.reshape(S * W, h, dh), k_pages, v_pages,
        torch.repeat_interleave(page_tables, W, dim=0), lens.reshape(-1),
        scale=scale)
    return out.reshape(S, W, h, dh)


def paged_kernel_supported(q: torch.Tensor, k_pages: torch.Tensor) -> bool:
    """Does the Hopper kernel take these shapes and dtypes? dh a
    multiple of 8 and at most 256, float32 or bfloat16 with q and pages
    of one dtype, at most 32 query rows (W * rep) per kv group, and two
    pages' K+V rows of one group inside shared memory."""
    _, W, h, dh = q.shape
    _, ps, g, _ = k_pages.shape
    return (dh % 8 == 0 and dh <= _MAX_HEAD_DIM and h % g == 0
            and W * (h // g) <= _MAX_ROWS_PER_GROUP
            and q.dtype in _DTYPE_CODES and k_pages.dtype == q.dtype
            and 4 * ps * dh * q.element_size() <= _MAX_SMEM_BYTES)


def _launch_kernel(q, k_pages, v_pages, page_tables, kv_lens, scale):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, "kv_lens": kv_lens}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("page_tables", "kv_lens"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{tensors[name].dtype}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if not paged_kernel_supported(q, k_pages):
        raise ValueError(
            f"paged window kernel does not take q {tuple(q.shape)} "
            f"{q.dtype} with pages {tuple(k_pages.shape)} "
            f"{k_pages.dtype} (paged_kernel_supported)")
    S, W, h, dh = q.shape
    n_pages, ps, g, _ = k_pages.shape
    P = page_tables.shape[1]
    if page_tables.shape[0] != S or tuple(kv_lens.shape) != (S, W):
        raise ValueError(f"page_tables {tuple(page_tables.shape)} / "
                         f"kv_lens {tuple(kv_lens.shape)} do not match "
                         f"q {tuple(q.shape)}")
    from paddle_tpu_torch.ops import _build
    fn = _build.load("paged_window_attention").pt_paged_window_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
             S, W, h, g, dh, n_pages, ps, P, float(scale),
             _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged window kernel launch failed: CUDA error {err}")
    paged_window_attention.launches += 1
    return out


def paged_window_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           page_tables: torch.Tensor,
                           kv_lens: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention for a W-token window per slot over the paged pool.
    q [S, W, h, dh] -> [S, W, h, dh] (module doc for the layouts).

    On the CPU: :func:`paged_window_reference`. On a CUDA card: the
    allocated-pages Hopper kernel, which reads only each slot's used
    pages (``ceil(max_w kv_lens[s, w] / page_size)``, at least 1)
    instead of the full table width — or an exception for inputs it
    does not take. Each kernel launch adds one to
    ``paged_window_attention.launches``.

    A row with kv_len 0 (which the engine never feeds) sees no column.
    The kernel returns for it what the TPU kernel returns: the mean of
    V over the slot's used pages. The plain version returns what the
    JAX package's einsum path returns: the mean over the full table
    width."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_window_reference(q, k_pages, v_pages, page_tables,
                                      kv_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged window attention for device {q.device}")
    return _launch_kernel(q, k_pages, v_pages, page_tables, kv_lens, scale)


paged_window_attention.launches = 0
