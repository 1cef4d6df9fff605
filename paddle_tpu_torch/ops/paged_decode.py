"""Paged decode attention — the counterpart of
``paddle_tpu/ops/pallas_decode.py`` for the serving path.

- :func:`quantize_kv` / :func:`dequantize_kv`: the int8 KV contract of
  the two-tier pools (symmetric per-(row, kv-head) absmax/127 scales,
  round-half-even), bit-equal to the JAX package on the CPU.
- :func:`gather_pages` / :func:`gather_scales` / :func:`paged_attention`:
  the plain gather + einsum version (the same einsum strings,
  ``NEG_INF`` mask and float32 softmax as the reference; int8 pools
  dequantize the GATHERED view to ``q.dtype`` first). It reads each
  slot's full page-table width; it is the CPU path and the oracle the
  window kernel is held against. ``use_kernel=True`` instead hands the
  gathered view, transposed to ``[b, g, dh, T]``, to
  :func:`decode_attention`.
- :func:`paged_window_attention`: attention for a W-token window per
  slot. A tensor on the CPU takes the plain version; a tensor on a
  CUDA card launches the hand-written Hopper kernel
  (``csrc/paged_window_attention.cu`` — replaces the allocated-pages
  Pallas kernels ``_paged_window_kernel`` and, with ``k_scales`` /
  ``v_scales``, ``_paged_window_dequant_kernel``) or raises.
- :func:`decode_attention`: one query per row over a dense
  ``[b, g, dh, T]`` cache; on the card the Hopper kernel
  ``csrc/decode_attention.cu`` (replaces ``_decode_kernel``), on the
  CPU :func:`decode_reference`.

There is no fallback from the card to a plain version: a shape a
kernel does not take raises.

Layouts are the reference's: q ``[S, W, h, dh]``, page pools
``[n_pages, page_size, g, dh]`` (h % g == 0 — grouped-query heads
read the cache at stored width), int8 scales ``[n_pages, page_size,
g]`` float32, page tables ``[S, P]`` int32 whose entries past a slot's
allocation point at the reserved null page 0, kv_lens ``[S, W]`` int32
per-token valid lengths (token w of slot s is the query at position
``kv_lens[s, w] - 1``, so one mask is both the ragged-length and the
in-window causal mask).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# ---- int8 KV token-identity contract (the two-tier KV plane) ----
# The reference's constants (pallas_decode.py): int8 attention outputs
# sit within this tolerance of the exact float32 attention over the
# same pre-quantization pages; a change here is a semantics change.
INT8_KV_RTOL = 2e-2
INT8_KV_ATOL = 2e-2
# smallest per-row scale: all-zero rows (the null page, unwritten pool
# rows) stay exactly zero after dequant and the quantizer never
# divides by zero
INT8_KV_SCALE_EPS = 1e-12

# the window kernel's limits (csrc/paged_window_attention.cu): one warp
# per query row of a kv group, lanes striding over dh, two pages' K and
# V rows of one group double-buffered in shared memory
_MAX_ROWS_PER_GROUP = 32        # W * rep warps in one block
_MAX_HEAD_DIM = 256
_MAX_SMEM_BYTES = 227 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the decode kernel's limits (csrc/decode_attention.cu): one block per
# (row, kv group) holds its rep query rows and their rep x T scores in
# shared memory as float32, and keeps rep partial sums per thread
_DECODE_MAX_REP = 32


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(row, kv-head) int8 quantization of K/V rows:
    ``x`` [..., dh] -> (int8 values [..., dh], float32 scales [...]).
    absmax/127 scaling with round-half-even (``torch.round``, as
    ``jnp.round``), a pure function of the row. Both quotients are true
    divisions, as XLA:CPU computes the reference's: the divisor 127 is
    a tensor, because PyTorch's CUDA kernel turns division by a Python
    scalar into a multiply by its rounded reciprocal, which differs in
    the last bit — so the card, the CPU port and the JAX package agree
    bit for bit."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1), min=INT8_KV_SCALE_EPS)
    s = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: int8 values [..., dh] * scales
    [...] in float32, then cast to ``dtype``."""
    return (q.float() * scales.float()[..., None]).to(dtype)


def gather_pages(pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """Contiguous per-sequence view of a paged pool: ``pages``
    [n_pages, page_size, g, dh] gathered through ``page_table`` [b, P]
    -> [b, P*page_size, g, dh]."""
    b, pp = page_table.shape
    _, ps, g, dh = pages.shape
    return pages[page_table.long()].reshape(b, pp * ps, g, dh)


def gather_scales(scales: torch.Tensor,
                  page_table: torch.Tensor) -> torch.Tensor:
    """Per-row dequant scales gathered like :func:`gather_pages`:
    ``scales`` [n_pages, page_size, g] through ``page_table`` [b, P]
    -> [b, P*page_size, g]."""
    b, pp = page_table.shape
    _, ps, g = scales.shape
    return scales[page_table.long()].reshape(b, pp * ps, g)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    kv_lens: torch.Tensor, *,
                    scale: Optional[float] = None,
                    use_kernel: bool = False,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One-token decode attention over the paged pool. q [b, h, dh];
    page_table [b, P]; kv_lens [b]. Returns [b, h, dh].

    The gather materializes the [b, T, g, dh] view (int8 pools:
    dequantized to ``q.dtype`` through the gathered scales), then runs
    the exact einsum with a float32 softmax — or, with
    ``use_kernel=True``, transposes it into the ``[b, g, dh, T]``
    contract of :func:`decode_attention` (the Hopper decode kernel on
    the card)."""
    b, h, dh = q.shape
    g = k_pages.shape[2]
    assert h % g == 0, (h, g)
    rep = h // g
    if scale is None:
        scale = dh ** -0.5
    k = gather_pages(k_pages, page_table)              # [b, T, g, dh]
    v = gather_pages(v_pages, page_table)
    if k_scales is not None:
        k = dequantize_kv(k, gather_scales(k_scales, page_table), q.dtype)
        v = dequantize_kv(v, gather_scales(v_scales, page_table), q.dtype)
    lens = kv_lens.reshape(-1).to(device=q.device, dtype=torch.int32)
    if use_kernel:
        kt = k.permute(0, 2, 3, 1).to(q.dtype).contiguous()  # [b,g,dh,T]
        vt = v.permute(0, 2, 3, 1).to(q.dtype).contiguous()
        return decode_attention(q, kt, vt, lens, scale=scale)
    t = k.shape[1]
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
                           scale: Optional[float] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version of :func:`paged_window_attention`: flattens the
    window into :func:`paged_attention` rows (every window token reads
    its slot's pages through a repeated table row). Runs on any
    device; the kernel is held against it."""
    S, W, h, dh = q.shape
    lens = kv_lens.reshape(S, W)
    out = paged_attention(
        q.reshape(S * W, h, dh), k_pages, v_pages,
        torch.repeat_interleave(page_tables, W, dim=0), lens.reshape(-1),
        scale=scale, k_scales=k_scales, v_scales=v_scales)
    return out.reshape(S, W, h, dh)


def paged_kernel_supported(q: torch.Tensor, k_pages: torch.Tensor,
                           k_scales: Optional[torch.Tensor] = None) -> bool:
    """Does the Hopper window kernel take these shapes and dtypes? dh a
    multiple of 8 and at most 256, q float32 or bfloat16, at most 32
    query rows (W * rep) per kv group, and two pages' K+V rows of one
    group inside shared memory. Pages share q's dtype — or, with
    ``k_scales`` (the int8 two-tier layout), are int8 with float32
    scales ``[n_pages, page_size, g]``, and the shared-memory budget
    counts the int8 rows plus their scales."""
    _, W, h, _ = q.shape
    _, ps, g, dh = k_pages.shape
    ok = (q.shape[-1] == dh and dh % 8 == 0 and dh <= _MAX_HEAD_DIM
          and h % g == 0
          and W * (h // g) <= _MAX_ROWS_PER_GROUP
          and q.dtype in _DTYPE_CODES)
    if k_scales is None:
        return ok and k_pages.dtype == q.dtype and \
            4 * ps * dh * q.element_size() <= _MAX_SMEM_BYTES
    return (ok and k_pages.dtype == torch.int8
            and k_scales.dtype == torch.float32
            and tuple(k_scales.shape) == tuple(k_pages.shape[:3])
            and 4 * ps * dh + 4 * ps * 4 + 64 <= _MAX_SMEM_BYTES)


def _check_operands(tensors, device):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch_kernel(q, k_pages, v_pages, page_tables, kv_lens, scale,
                   k_scales, v_scales):
    quant = k_scales is not None
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, "kv_lens": kv_lens}
    if quant:
        if v_scales is None:
            raise ValueError("k_scales given without v_scales")
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    _check_operands(tensors, q.device)
    for name in ("page_tables", "kv_lens"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{tensors[name].dtype}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if quant and (v_scales.shape != k_scales.shape
                  or v_scales.dtype != k_scales.dtype):
        raise ValueError("k_scales and v_scales differ in shape or dtype")
    if not paged_kernel_supported(q, k_pages, k_scales):
        raise ValueError(
            f"paged window kernel does not take q {tuple(q.shape)} "
            f"{q.dtype} with pages {tuple(k_pages.shape)} "
            f"{k_pages.dtype}" + (" + scales" if quant else "")
            + " (paged_kernel_supported)")
    S, W, h, dh = q.shape
    n_pages, ps, g, _ = k_pages.shape
    P = page_tables.shape[1]
    if page_tables.shape[0] != S or tuple(kv_lens.shape) != (S, W):
        raise ValueError(f"page_tables {tuple(page_tables.shape)} / "
                         f"kv_lens {tuple(kv_lens.shape)} do not match "
                         f"q {tuple(q.shape)}")
    from paddle_tpu_torch.ops import _build
    lib = _build.load("paged_window_attention")
    fn = lib.pt_paged_window_attention_int8 if quant else \
        lib.pt_paged_window_attention
    n_ptr = 8 if quant else 6
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [page_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr()]
    err = fn(*ptrs, S, W, h, g, dh, n_pages, ps, P, float(scale),
             _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged window kernel launch failed: CUDA error {err}")
    if quant:
        paged_window_attention.dequant_launches += 1
    else:
        paged_window_attention.launches += 1
    return out


def paged_window_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           page_tables: torch.Tensor,
                           kv_lens: torch.Tensor, *,
                           scale: Optional[float] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Attention for a W-token window per slot over the paged pool.
    q [S, W, h, dh] -> [S, W, h, dh] (module doc for the layouts).

    On the CPU: :func:`paged_window_reference`. On a CUDA card: the
    allocated-pages Hopper kernel, which reads only each slot's used
    pages (``ceil(max_w kv_lens[s, w] / page_size)``, at least 1)
    instead of the full table width — or an exception for inputs it
    does not take. ``k_scales``/``v_scales`` switch the pools to the
    int8 layout: the kernel stages the int8 rows and their scales and
    dequantizes in float32 after they land in shared memory (never at
    float width in device memory). Each launch adds one to
    ``paged_window_attention.launches`` (float pages) or
    ``paged_window_attention.dequant_launches`` (int8 pages).

    A row with kv_len 0 (which the engine never feeds) sees no column.
    The kernel returns for it what the TPU kernels return: the mean of
    (dequantized) V over the slot's used pages. The plain version
    returns what the JAX package's einsum path returns: the mean over
    the full table width."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if q.device.type == "cpu":
        return paged_window_reference(q, k_pages, v_pages, page_tables,
                                      kv_lens, scale=scale,
                                      k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no paged window attention for device {q.device}")
    return _launch_kernel(q, k_pages, v_pages, page_tables, kv_lens, scale,
                          k_scales, v_scales)


paged_window_attention.launches = 0
paged_window_attention.dequant_launches = 0


# ------------------------------------------------------ dense decode
def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of :func:`decode_attention`, with the TPU
    kernel's arithmetic (``_decode_kernel``): float32 scores scaled by
    ``scale * log2(e)``, masked to ``NEG_INF`` at positions >= kv_len,
    an exp2 softmax, output in q's dtype. A row with kv_len 0 returns
    the mean of V over T (every masked weight is exp2(0) = 1)."""
    b, h, dh = q.shape
    _, g, _, t = k_cache.shape
    rep = h // g
    if scale is None:
        scale = dh ** -0.5
    lens = kv_len.reshape(-1).to(device=q.device, dtype=torch.int64)
    qf = q.float().reshape(b, g, rep, dh)
    s2 = torch.einsum("bgrd,bgdt->bgrt", qf, k_cache.float()) * \
        (scale * LOG2E)
    live = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    s2 = s2.masked_fill(~live[:, None, None, :], NEG_INF)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    acc = torch.einsum("bgrt,bgdt->bgrd", p, v_cache.float())
    return (acc / p.sum(dim=-1, keepdim=True)).reshape(b, h, dh) \
        .to(q.dtype)


def decode_supported(q: torch.Tensor, k_cache: torch.Tensor) -> bool:
    """The Hopper decode kernel's gate (the port's own, in place of the
    TPU kernel's VMEM budget): q and the cache float32 or bfloat16 of
    one dtype, dh a multiple of 8 and at most 256, h % g == 0 with at
    most 32 query heads per kv group, and the block's float32 rep x T
    scores plus its rep x dh query rows inside shared memory."""
    b, h, dh = q.shape
    _, g, dh_k, t = k_cache.shape
    return (q.dtype in _DTYPE_CODES and k_cache.dtype == q.dtype
            and dh == dh_k and dh % 8 == 0 and dh <= _MAX_HEAD_DIM
            and h % g == 0 and h // g <= _DECODE_MAX_REP
            and 4 * (h // g) * (t + dh + 1) <= _MAX_SMEM_BYTES)


def _launch_decode(q, k_cache, v_cache, lens, scale):
    _check_operands({"q": q, "k_cache": k_cache, "v_cache": v_cache,
                     "kv_len": lens}, q.device)
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache differ in shape or dtype")
    if not decode_supported(q, k_cache):
        raise ValueError(
            f"decode kernel does not take q {tuple(q.shape)} {q.dtype} "
            f"with a cache {tuple(k_cache.shape)} {k_cache.dtype} "
            "(decode_supported)")
    b, h, dh = q.shape
    _, g, _, t = k_cache.shape
    if k_cache.shape[0] != b or lens.numel() not in (1, b):
        raise ValueError(f"cache {tuple(k_cache.shape)} / kv_len "
                         f"{tuple(lens.shape)} do not match q "
                         f"{tuple(q.shape)}")
    from paddle_tpu_torch.ops import _build
    fn = _build.load("decode_attention").pt_decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lens.data_ptr(), out.data_ptr(), b, h, g, dh, t, lens.numel(),
             float(scale), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [b, h, dh]; k_cache/v_cache [b, g, dh, T] (T contiguous) with
    h % g == 0; kv_len one length shared by every row ([1] or a scalar)
    or per-row lengths [b] — positions >= kv_len are masked (each
    row's query sits at position kv_len - 1, so this is the causal
    mask). Returns [b, h, dh] in q's dtype.

    On the CPU: :func:`decode_reference`. On a CUDA card: the Hopper
    decode kernel, or an exception for inputs it does not take
    (:func:`decode_supported`). Each launch adds one to
    ``decode_attention.launches``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lens = torch.as_tensor(kv_len, device=q.device).to(torch.int32) \
        .reshape(-1).contiguous()
    if lens.numel() not in (1, q.shape[0]):
        raise ValueError(f"kv_len has {lens.numel()} entries for "
                         f"{q.shape[0]} rows")
    if q.device.type == "cpu":
        return decode_reference(q, k_cache, v_cache, lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    return _launch_decode(q, k_cache, v_cache, lens, scale)


decode_attention.launches = 0
