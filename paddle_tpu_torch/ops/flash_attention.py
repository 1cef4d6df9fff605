"""Flash attention — the counterpart of ``paddle_tpu/ops/pallas_attention.py``.

- :func:`flash_attention_reference`: the plain version (the JAX
  package's ``_reference`` + ``_lens_mask``): einsum logits in float32,
  the ``NEG_INF`` mask, a float32 softmax, fully-masked rows zeroed.
  It is the CPU path and the oracle the kernels are held against;
  :func:`flash_lse_reference`, :func:`flash_dq_reference` and
  :func:`flash_dkv_reference` are the plain versions of the other
  things the kernels compute.
- :func:`flash_forward`, :func:`flash_backward_dq`,
  :func:`flash_backward_dkv`: one wrapper per kernel. A tensor on the
  CPU takes the plain version; a tensor on a CUDA card launches a
  hand-written Hopper kernel or raises. The kernel (under ``csrc/``) is
  chosen by dtype alone (:func:`flash_route`), never on error:

  ========  =====================  =========================  ========
  kernel    bfloat16, "sm90"       float32                    route
  ========  =====================  =========================  ========
  forward   ``flash_fwd_sm90.cu``  ``flash_fwd_tf32_sm90.cu``  "tf32x3"
  dq        ``flash_dq_sm90.cu``   ``flash_dq_tf32_sm90.cu``   "tf32x3"
  dk/dv     ``flash_dkv_sm90.cu``  ``flash_dkv_tf32_sm90.cu``  "tf32x3"
  ========  =====================  =========================  ========

  The sm90 kernels run every product of every tile on wgmma over
  TMA-fed tiles. The tf32x3 kernels do too, each float32 product as
  three TF32 products of split operands (hi.hi + hi.lo + lo.hi), about
  float32 accuracy, as the JAX kernels' ``Precision.HIGHEST`` asks;
  their tiles by head dim are :func:`flash_tf32_plan`. They replace
  ``_flash_kernel``, ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``. Each launch adds one to the wrapper's
  ``launches`` and to its route's entry in ``route_launches``.
- :func:`flash_attention`: the differentiable entry point. On the card
  a ``torch.autograd.Function`` runs the forward kernel (saving q, k, v,
  out, lse and the lengths), and its backward computes
  D = rowsum(dO*O) in float32, then the dq and dk/dv kernels. There is
  no fallback from the card to the plain version.

Layouts are the JAX package's public ones: q ``[b, Tq, h, d]``, k and v
``[b, Tk, h, d]``, q_lens / kv_lens ``[b]``; the kernels read them in
place. The logsumexp is ``[b*h, Tq]`` float32 in natural units
(``NEG_INF`` on rows with no valid column) — the JAX kernel's
``[bh, Tq, 128]`` broadcast is a TPU lane-layout artefact and is not
kept.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_MAX_HEAD_DIM = 128
# shared memory a block may use on sm_90 (the 227 KB opt-in)
SMEM_LIMIT = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain version
def _lens(x: torch.Tensor, lens: Optional[torch.Tensor], t: int):
    b = x.shape[0]
    if lens is None:
        return torch.full((b,), t, dtype=torch.int32, device=x.device)
    return lens.to(device=x.device, dtype=torch.int32).reshape(b)


def lens_mask(q_lens: torch.Tensor, kv_lens: torch.Tensor, tq: int, tk: int,
              causal: bool) -> torch.Tensor:
    """[b, Tq, Tk] bool mask equivalent to the in-kernel computation."""
    rows = torch.arange(tq, device=q_lens.device)
    cols = torch.arange(tk, device=q_lens.device)
    m = (rows[None, :, None] < q_lens[:, None, None]) & \
        (cols[None, None, :] < kv_lens[:, None, None])
    if causal:
        m = m & (cols[None, None, :] <= rows[None, :, None])
    return m


def _masked_logits(q, k, mask, scale):
    """float32 [b, h, Tq, Tk] logits, NEG_INF where ``mask`` is off
    (bf16 inputs multiply exactly into float32 sums)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return logits.masked_fill(~mask[:, None], NEG_INF)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              q_lens: Optional[torch.Tensor] = None,
                              kv_lens: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Attention with the ragged-length + causal mask, plain version;
    differentiable by autograd. Rows with no valid column return 0."""
    tq, tk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = lens_mask(_lens(q, q_lens, tq), _lens(q, kv_lens, tk), tq, tk,
                     causal)
    w = torch.softmax(_masked_logits(q, k, mask, scale), dim=-1)
    # fully-masked rows: the softmax over all NEG_INF is uniform; zero them
    w = w * mask.any(dim=-1)[:, None, :, None].to(w.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_lse_reference(q, k, q_lens=None, kv_lens=None, causal=False,
                        scale=None) -> torch.Tensor:
    """The row logsumexp [b*h, Tq] float32 in natural units, NEG_INF on
    rows with no valid column."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = lens_mask(_lens(q, q_lens, tq), _lens(q, kv_lens, tk), tq, tk,
                     causal)
    lse = torch.logsumexp(_masked_logits(q, k, mask, scale), dim=-1)
    lse = torch.where(mask.any(dim=-1)[:, None, :], lse,
                      torch.full_like(lse, NEG_INF))
    return lse.reshape(b * h, tq)


def _recompute(q, k, v, do, lse, dd, q_lens, kv_lens, causal, scale):
    """p and ds = p*(dO.V^T - D)*scale, [b, h, Tq, Tk] float32, from the
    saved lse — what the backward kernels recompute tile by tile."""
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    mask = lens_mask(_lens(q, q_lens, tq), _lens(q, kv_lens, tk), tq, tk,
                     causal)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse4 = lse.reshape(b, h, tq, 1)
    # the mask goes first: exp(s - NEG_INF) would overflow
    p = torch.where(mask, torch.exp(torch.where(mask, s - lse4,
                                                torch.zeros_like(s))),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - dd.reshape(b, h, tq, 1)) * scale
    return p, ds


def rowsum_do_o(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in float32, [b*h, Tq]."""
    b, tq, h, _ = out.shape
    d = (do.float() * out.float()).sum(dim=-1)           # [b, Tq, h]
    return d.permute(0, 2, 1).reshape(b * h, tq).contiguous()


def flash_dq_reference(q, k, v, do, lse, dd, q_lens=None, kv_lens=None,
                       causal=False, scale=None) -> torch.Tensor:
    """dq from the saved lse and D, plain version, in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds = _recompute(q, k, v, do, lse, dd, q_lens, kv_lens, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, dd, q_lens=None, kv_lens=None,
                        causal=False, scale=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the saved lse and D, plain version."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds = _recompute(q, k, v, do, lse, dd, q_lens, kv_lens, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype)
    return dk, dv


# ------------------------------------------------------------ the kernels
def flash_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shape gate of the Hopper kernels: the JAX package's (head dim a
    multiple of 8, both sequences at least 8 long), plus d <= 128 and
    float32 or bfloat16 q/k of one dtype."""
    d = q.shape[-1]
    return (d % 8 == 0 and d <= _MAX_HEAD_DIM and q.shape[1] >= 8
            and k.shape[1] >= 8 and q.dtype in _DTYPE_CODES
            and k.dtype == q.dtype)


# (kernel, route) -> (library, C symbol)
_KERNELS = {
    ("fwd", "sm90"): ("flash_fwd_sm90", "pt_flash_fwd_sm90"),
    ("fwd", "tf32x3"): ("flash_fwd_tf32_sm90", "pt_flash_fwd_tf32_sm90"),
    ("dq", "sm90"): ("flash_dq_sm90", "pt_flash_dq_sm90"),
    ("dq", "tf32x3"): ("flash_dq_tf32_sm90", "pt_flash_dq_tf32_sm90"),
    ("dkv", "sm90"): ("flash_dkv_sm90", "pt_flash_dkv_sm90"),
    ("dkv", "tf32x3"): ("flash_dkv_tf32_sm90", "pt_flash_dkv_tf32_sm90"),
}


def flash_route(kernel: str, dtype: torch.dtype) -> str:
    """The route of ``kernel`` ("fwd", "dq" or "dkv") for operands of
    ``dtype``: bfloat16 takes the wgmma kernels ("sm90"), float32 the
    3xTF32 wgmma kernels ("tf32x3"). Every head dim the shape gate
    admits takes the same route (:func:`flash_tf32_plan` covers them
    all)."""
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"no flash kernel {kernel!r}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{dtype}")
    return "sm90" if dtype == torch.bfloat16 else "tf32x3"


def flash_routes(kernel: str) -> Tuple[str, ...]:
    """Every route of ``kernel``: the keys of its ``route_launches``."""
    return tuple(r for k, r in _KERNELS if k == kernel)


def flash_tf32_plan(kernel: str, d: int) -> dict:
    """The launch of the float32 ("tf32x3") forward, dq or dk/dv kernel
    at head dim ``d``, chosen by ``d`` alone: consumer ``warpgroups``
    (forward and dq: 64 query rows each; dk/dv: alternate query tiles of
    the block's keys), the block's ``rows`` (queries for the forward and
    dq, keys for dk/dv), the streamed ``tile`` (keys for the forward and
    dq, queries for dk/dv), ring ``stages``, and the shared bytes,
    ``smem`` (dynamic, 1024 of them alignment slack) and ``static`` (the
    mbarriers and, for dk/dv, each stage's lse and D, in 16-byte units).
    The kernels' ``Plan`` (``csrc/flash_{fwd,dq,dkv}_tf32_sm90.cu``)
    computes the same; ``chip_smoke.py`` holds the two equal.

    Each operand is held split (hi and lo, float32 rows of 128 bytes, a
    panel every 32 columns of d), plus a transposed copy (rows = d,
    64-row panels) of the tile the token contraction reads: the forward
    keeps its query rows' Q and streams K, V as loaded and V^T; dq keeps
    its query rows' Q and dO and streams K, V and K^T; dk/dv keeps its
    64 keys' K and V and streams Q, dO, Q^T and dO^T."""
    if d <= 0 or d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"no float32 flash plan for head dim {d}")
    npf = -(-d // 32)                  # 32-column panels of d
    np_ = -(-d // 64)                  # 64-column output panels
    row = 128                          # bytes of a panel row
    if kernel == "fwd":
        wg = 2 if npf <= 2 else 1
        stages = 2
        tile = 64 if npf <= 2 else 32
        resident = 2 * wg * 64 * row * npf          # Q hi and lo
        # K hi and lo, V as loaded; V^T hi and lo of each 32-key half
        stage = 3 * tile * row * npf + 2 * (tile // 32) * 64 * np_ * row
        static = 8 * (1 + 3 * stages)
        rows = 64 * wg
    elif kernel == "dq":
        wg = 2 if npf <= 2 else 1
        stages = 2 if npf <= 2 else 1
        tile = 32
        resident = 4 * wg * 64 * row * npf          # Q, dO hi and lo
        stage = 4 * tile * row * npf + 2 * 64 * np_ * row   # K, V; K^T
        static = 8 * (1 + 3 * stages)
        rows = 64 * wg
    elif kernel == "dkv":
        wg, rows = (2 if npf <= 2 else 1), 64
        tile = 32 if npf <= 2 else 16
        stages = 2 if npf <= 3 else 1
        resident = 4 * 64 * row * npf               # K, V hi and lo
        stage = 4 * tile * row * npf + 2 * (2 * tile // 32) * 64 * np_ * row
        static = 8 * (1 + 2 * stages) + 8 * stages * tile
    else:
        raise ValueError(f"no float32 flash plan for kernel {kernel!r}")
    return dict(warpgroups=wg, rows=rows, tile=tile, stages=stages,
                smem=1024 + resident + stages * stage,
                static=-(-static // 16) * 16)   # ptxas rounds to 16


def _fn(kernel: str, route: str, n_ptrs: int):
    from paddle_tpu_torch.ops import _build
    lib, sym = _KERNELS[(kernel, route)]
    fn = getattr(_build.load(lib), sym)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check(name_tensors, q):
    for name, t in name_tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_qkv(q, k, v, lens2):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected [b, T, h, d] with "
                         "k and v alike")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch, heads or head dim")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash kernels take float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"flash kernels take head dim d % 8 == 0 and "
                         f"d <= {_MAX_HEAD_DIM}, got {d}")
    if lens2.dtype != torch.int32 or tuple(lens2.shape) != (b, 2):
        raise ValueError(f"lens must be int32 [b, 2], got {lens2.dtype} "
                         f"{tuple(lens2.shape)}")


def _check_grad_inputs(q, do, lse, dd):
    b, tq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("dd", dd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, tq):
            raise ValueError(f"{name} must be float32 [{b * h}, {tq}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _cuda_or_raise(q):
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")


def _lens_pair(lens2):
    return lens2[:, 0], lens2[:, 1]


def _count(wrapper, route):
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def flash_forward(q, k, v, lens2, causal: bool, scale: float):
    """(out [b, Tq, h, d], lse [b*h, Tq] float32). ``lens2`` is int32
    [b, 2] (q_len, kv_len). CPU: the plain version; CUDA: the forward
    kernel of :func:`flash_route`."""
    if q.device.type == "cpu":
        ql, kl = _lens_pair(lens2)
        return (flash_attention_reference(q, k, v, ql, kl, causal, scale),
                flash_lse_reference(q, k, ql, kl, causal, scale))
    _cuda_or_raise(q)
    _check_qkv(q, k, v, lens2)
    _check({"q": q, "k": k, "v": v, "lens": lens2}, q)
    b, tq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    route = flash_route("fwd", q.dtype)
    fn = _fn("fwd", route, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens2.data_ptr(),
             out.data_ptr(), lse.data_ptr(), b, h, tq, k.shape[1], d,
             float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention forward launch failed: CUDA error {err}")
    _count(flash_forward, route)
    return out, lse


def flash_backward_dq(q, k, v, do, lse, dd, lens2, causal: bool,
                      scale: float) -> torch.Tensor:
    """dq from the saved lse and D = rowsum(dO*O) [b*h, Tq]. CPU: the
    plain version; CUDA: the dq kernel of :func:`flash_route` (bfloat16:
    ``csrc/flash_dq_sm90.cu``, float32: ``csrc/flash_dq_tf32_sm90.cu``)."""
    if q.device.type == "cpu":
        ql, kl = _lens_pair(lens2)
        return flash_dq_reference(q, k, v, do, lse, dd, ql, kl, causal,
                                  scale)
    _cuda_or_raise(q)
    _check_qkv(q, k, v, lens2)
    _check_grad_inputs(q, do, lse, dd)
    _check({"q": q, "k": k, "v": v, "do": do, "lse": lse, "dd": dd,
            "lens": lens2}, q)
    b, tq, h, d = q.shape
    dq = torch.empty_like(q)
    route = flash_route("dq", q.dtype)
    fn = _fn("dq", route, 8)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dd.data_ptr(), lens2.data_ptr(), dq.data_ptr(),
             b, h, tq, k.shape[1], d, float(scale), int(bool(causal)),
             _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention dq launch failed: CUDA error "
                           f"{err}")
    _count(flash_backward_dq, route)
    return dq


def flash_backward_dkv(q, k, v, do, lse, dd, lens2, causal: bool,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the saved lse and D. CPU: the plain version;
    CUDA: the dk/dv kernel of :func:`flash_route`."""
    if q.device.type == "cpu":
        ql, kl = _lens_pair(lens2)
        return flash_dkv_reference(q, k, v, do, lse, dd, ql, kl, causal,
                                   scale)
    _cuda_or_raise(q)
    _check_qkv(q, k, v, lens2)
    _check_grad_inputs(q, do, lse, dd)
    _check({"q": q, "k": k, "v": v, "do": do, "lse": lse, "dd": dd,
            "lens": lens2}, q)
    b, tq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = flash_route("dkv", q.dtype)
    fn = _fn("dkv", route, 9)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dd.data_ptr(), lens2.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), b, h, tq, k.shape[1], d, float(scale),
             int(bool(causal)), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention dk/dv launch failed: CUDA "
                           f"error {err}")
    _count(flash_backward_dkv, route)
    return dk, dv


def reset_launches():
    """Zero every flash wrapper's ``launches`` and ``route_launches``."""
    for kernel, fn in (("fwd", flash_forward), ("dq", flash_backward_dq),
                       ("dkv", flash_backward_dkv)):
        fn.launches = 0
        fn.route_launches = {r: 0 for r in flash_routes(kernel)}


reset_launches()


class _FlashFn(torch.autograd.Function):
    """The kernels as one differentiable op (the JAX package's
    ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, lens2, causal, scale):
        out, lse = flash_forward(q, k, v, lens2, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, lens2)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lens2 = ctx.saved_tensors
        # the gradient arrives strided after the layer's head merge
        do = do.contiguous()
        dd = rowsum_do_o(do, out)
        dq = flash_backward_dq(q, k, v, do, lse, dd, lens2, ctx.causal,
                               ctx.scale)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, dd, lens2,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_lens: Optional[torch.Tensor] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention with ragged-length + causal masking.

    q: [b, Tq, h, d]; k, v: [b, Tk, h, d]; q_lens / kv_lens: [b] valid
    lengths (None = full). Returns [b, Tq, h, d]; rows with no valid
    column (rows at/past q_len among them) are zero. CPU: the plain
    version (autograd differentiates it). CUDA: the Hopper kernels,
    forward and backward."""
    tq, tk = q.shape[1], k.shape[1]
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_lens, kv_lens, causal,
                                         scale)
    _cuda_or_raise(q)
    lens2 = torch.stack([_lens(q, q_lens, tq), _lens(q, kv_lens, tk)],
                        dim=1).contiguous()
    return _FlashFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          lens2, bool(causal), scale)
