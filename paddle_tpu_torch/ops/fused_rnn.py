"""Fused LSTM / GRU sequence ops — the counterpart of
``paddle_tpu/ops/pallas_rnn.py``.

- :func:`lstm_reference`, :func:`lstm_backward_reference` and
  :func:`gru_reference`: the plain versions of what the kernels compute
  (the JAX package's ``_lstm_ref``, the body of ``_lstm_bwd_kernel``
  and ``_gru_ref``), with the kernels' rounding points: the product
  inputs are rounded to the dtype of ``w`` (float32 or bfloat16), the
  streams are stored in it, the carries and gate math are float32.
  They are the CPU path and the oracles the kernels are held against.
- :func:`lstm_forward`, :func:`lstm_backward`, :func:`gru_forward`: one
  wrapper per kernel. A tensor on the CPU takes the plain version; a
  tensor on a CUDA card launches the hand-written Hopper kernel or
  raises. ``_lstm_kernel`` is ``csrc/lstm_fwd_sm90.cu`` in bfloat16 and
  ``csrc/lstm_fwd_bf16x3_sm90.cu`` in float32 (its product as three
  bf16 wgmma passes over split halves); ``_lstm_bwd_kernel`` is
  ``csrc/lstm_bwd_sm90.cu`` in bfloat16 and
  ``csrc/lstm_bwd_bf16x3_sm90.cu`` in float32 (the same three passes,
  its blocks split by gate); each chosen by ``w.dtype`` alone
  (:func:`lstm_fwd_route`, :func:`lstm_bwd_route`); ``_gru_kernel`` is
  ``csrc/gru_fwd_sm90.cu`` (batch rows split across clusters of blocks
  that hold the whole weight, no grid barrier) wherever a cluster of at
  most 8 blocks holds the weight, and the cooperative
  ``csrc/gru_fwd.cu`` at wider h, by shape alone (:func:`gru_fwd_plan`).
  Each launch adds one to the wrapper's ``launches``
  (``lstm_forward.res_launches`` counts the launches that also wrote
  the training residuals, ``route_launches`` each wrapper's launches by
  route, and the LSTM wrappers' ``row_launches`` their launches by batch
  rows — a microbatched step launches at fewer rows).
- :func:`lstm_sequence`: the differentiable LSTM. When a gradient is
  needed, a ``torch.autograd.Function`` (the JAX package's
  ``custom_vjp``) runs the forward with residuals and its backward runs
  the reverse-time kernel, then forms dW, dbias and dpeep as large
  contractions outside it; otherwise the forward runs without
  residuals.
- :func:`gru_sequence`: with no gradient needed the GRU kernel; with
  one, the plain float32 scan under autograd, as the JAX package's
  ``_gru_fwd`` trains through ``jax.vjp(_gru_ref)``.
- :func:`kernel_ok`: the dispatch gate of ``ops/recurrent.py``;
  :func:`gru_fwd_plan`: the GRU's route, cluster size, rows a cluster
  and shared memory, and :func:`lstm_fwd_bf16x3_plan` /
  :func:`lstm_bwd_bf16x3_plan` the float32 LSTM kernels' grid and shared
  memory, pure arithmetic on the shape.

Layouts are the layer's: x4 ``[b, T, 4h]`` (gates ``[i, f, c~, o]``),
x3 ``[b, T, 3h]`` (``[z, r, c~]``), w ``[h, 4h]`` / ``[h, 3h]``, bias
``[4h]`` / ``[3h]``, peep ``[3h]`` (``[i, f, o]``), lengths ``[b]``;
streams come back batch-major ``[b, T, .]`` (the TPU kernels' time-major
blocks are a grid artefact).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.ops.linear import compute_dtype

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tiling (csrc/rnn_common.cuh) and the sm_90 opt-in limit
_KC, _ROWS, _LDS = 32, 128, 132
_MAX_UNITS = 16
_SM90_SMEM = 232448
# the bf16 kernels (csrc/lstm_fwd_sm90.cu, csrc/lstm_bwd_sm90.cu): 16
# units a block, weight tiles of 64 contraction columns, ring stages of
# two 64 x 64 bf16 tiles, at most 8; the forward's tiles hold the
# block's 64 columns of W, the backward's its 16 rows
_SM90_UNITS, _SM90_CHUNK, _SM90_MAX_STAGES = 16, 64, 8
_SM90_STAGE, _SM90_STATIC = 2 * 64 * 64 * 2, 1024
_FWD_W_TILE, _BWD_W_TILE = 64 * 64 * 2, 16 * 64 * 2
# the float32 kernels (csrc/lstm_{fwd,bwd}_bf16x3_sm90.cu): 10 units a
# block (the forward's wgmma N 40 = 4 gates x 10 units; the backward's N
# 40 = a group of 40 units, one block per gate), 40 weight columns as two
# bf16 halves of [40 x 64] tiles, ceil(h / 64) rounded up to even a half;
# a ring of 8 (or 4) k-steps of the A operand's fragments in registers
_X3_UNITS, _X3_N, _X3_TILE, _X3_RINGS = 10, 40, 40 * 64 * 2, (8, 4)
# the sm90 GRU kernel (csrc/gru_fwd_sm90.cu): 256 threads a block,
# clusters of 1-8 blocks, 1-4 batch rows a cluster, at most 226 KB of
# dynamic shared memory a block (static words count against the opt-in)
_GRU_THREADS, _GRU_SMEM = 256, 226 * 1024
_GRU_CLUSTERS, _GRU_ROWS = (1, 2, 4, 8), (1, 2, 4)


# ------------------------------------------------------------ plain versions
def lstm_reference(x4: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor, peep: torch.Tensor,
                   save_res: bool = False):
    """The LSTM forward, plain version. ``x4`` [b, T, 4h] and ``w`` [h, 4h]
    hold the product dtype's values; returns (out [b, T, h] in ``w.dtype``,
    hT, cT [b, h] float32), plus (cseq [b, T, h], gates [b, T, 4h]) in
    ``w.dtype`` with ``save_res``. Differentiable by autograd."""
    mxu = w.dtype
    b, T, four_h = x4.shape
    h = four_h // 4
    xf, wf = x4.float(), w.float()
    bias = bias.float()
    pi, pf, po = peep.float().reshape(3, h)
    hh = xf.new_zeros((b, h))
    cc = xf.new_zeros((b, h))
    outs, cs, gs = [], [], []
    for t in range(T):
        z = xf[:, t] + hh.to(mxu).float() @ wf + bias
        zi, zf, zc, zo = z.split(h, dim=-1)
        i = torch.sigmoid(zi + pi * cc)
        f = torch.sigmoid(zf + pf * cc)
        cand = torch.tanh(zc)
        c_new = f * cc + i * cand
        o = torch.sigmoid(zo + po * c_new)
        h_new = o * torch.tanh(c_new)
        valid = (lens > t)[:, None]
        hh = torch.where(valid, h_new, hh)
        cc = torch.where(valid, c_new, cc)
        outs.append(torch.where(valid, h_new, torch.zeros_like(h_new))
                    .to(mxu))
        if save_res:
            cs.append(cc.to(mxu))
            gs.append(torch.cat([i, f, cand, o], dim=-1).to(mxu))
    out = torch.stack(outs, dim=1)
    if save_res:
        return out, hh, cc, torch.stack(cs, dim=1), torch.stack(gs, dim=1)
    return out, hh, cc


def lstm_backward_reference(w: torch.Tensor, peep: torch.Tensor,
                            lens: torch.Tensor, gates: torch.Tensor,
                            cseq: torch.Tensor, d_out: torch.Tensor,
                            dhT: torch.Tensor, dcT: torch.Tensor
                            ) -> torch.Tensor:
    """dz [b, T, 4h] in ``w.dtype``: the reverse-time recurrence of
    ``_lstm_bwd_kernel``, plain version."""
    mxu = w.dtype
    b, T, four_h = gates.shape
    h = four_h // 4
    wt = w.float().t()
    pi, pf, po = peep.float().reshape(3, h)
    dh, dc = dhT.float(), dcT.float()
    dz = gates.new_empty((b, T, four_h), dtype=mxu)
    for t in reversed(range(T)):
        i, f, cand, o = gates[:, t].float().split(h, dim=-1)
        c_t = cseq[:, t].float()
        c_prev = cseq[:, t - 1].float() if t > 0 else torch.zeros_like(c_t)
        valid = (lens > t)[:, None]
        dh_t = dh + torch.where(valid, d_out[:, t].float(),
                                torch.zeros_like(dh))
        tc = torch.tanh(c_t)
        dzo = dh_t * tc * o * (1.0 - o)
        dc_t = dc + dh_t * o * (1.0 - tc * tc) + dzo * po
        dzi = dc_t * cand * i * (1.0 - i)
        dzf = dc_t * c_prev * f * (1.0 - f)
        dzc = dc_t * i * (1.0 - cand * cand)
        dz_t = torch.cat([dzi, dzf, dzc, dzo], dim=-1)
        dz_t = torch.where(valid, dz_t, torch.zeros_like(dz_t)).to(mxu)
        dh = torch.where(valid, dz_t.float() @ wt, dh)
        dc = torch.where(valid, dc_t * f + dzi * pi + dzf * pf, dc)
        dz[:, t] = dz_t
    return dz


def gru_reference(x3: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU forward, plain version: (out [b, T, h], hT [b, h]), both
    float32; the two product inputs are rounded to ``w.dtype``.
    Differentiable by autograd."""
    mxu = w.dtype
    b, T, three_h = x3.shape
    h = three_h // 3
    xf, wf = x3.float(), w.float()
    bias = bias.float()
    hh = xf.new_zeros((b, h))
    outs = []
    for t in range(T):
        x_t = xf[:, t]
        zr = x_t[:, :2 * h] + hh.to(mxu).float() @ wf[:, :2 * h] + \
            bias[:2 * h]
        z = torch.sigmoid(zr[:, :h])
        r = torch.sigmoid(zr[:, h:])
        cand = x_t[:, 2 * h:] + (r * hh).to(mxu).float() @ wf[:, 2 * h:] + \
            bias[2 * h:]
        h_new = (1.0 - z) * hh + z * torch.tanh(cand)
        valid = (lens > t)[:, None]
        hh = torch.where(valid, h_new, hh)
        outs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1), hh


# ------------------------------------------------------------ the kernels
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _units(h: int, device: torch.device) -> int:
    """Hidden units a block owns: one block per SM at most."""
    return -(-h // _sms(device))


def _smem_bytes(k: int, n_w: int, n_tile: int) -> int:
    """rnn::smem_floats * 4: the resident slice [round_up(k, 32), n_w]
    plus the staging area (or the [128, n_tile] product tile)."""
    kpad = -(-k // _KC) * _KC
    return 4 * (kpad * n_w + max(_KC * _LDS, _ROWS * n_tile))


def kernel_smem(h: int, units: int) -> int:
    """Shared memory of the cooperative GRU forward (``csrc/gru_fwd.cu``,
    the one SIMT kernel left) at ``units`` hidden units a block."""
    return _smem_bytes(h, 3 * units, 2 * units)


def _sm90_plan(w_bytes: int, stages: int) -> Tuple[int, int]:
    """(dynamic shared-memory bytes, ring stages): 1024 of alignment
    slack, the resident weight tiles, and as many ring stages of 16384
    bytes as fit under the opt-in limit beside 1024 bytes of static
    memory — at most 8, at most ``stages`` when it is above 0; 0 stages
    when fewer than 2 remain, which the kernels refuse. The arithmetic
    of ``ring_stages`` in both bf16 LSTM kernels."""
    fit = (_SM90_SMEM - _SM90_STATIC - 1024 - w_bytes) // _SM90_STAGE
    fit = min(fit, _SM90_MAX_STAGES, stages if stages > 0 else fit)
    fit = 0 if fit < 2 else fit
    return 1024 + w_bytes + fit * _SM90_STAGE, fit


def lstm_fwd_sm90_smem(h: int, stages: int = 0) -> Tuple[int, int]:
    """:func:`_sm90_plan` of the bf16 forward kernel: the block's 64
    weight columns as ceil(h / 64) tiles of 8192 bytes."""
    return _sm90_plan(-(-h // _SM90_CHUNK) * _FWD_W_TILE, stages)


def lstm_bwd_sm90_smem(h: int, stages: int = 0) -> Tuple[int, int]:
    """:func:`_sm90_plan` of the bf16 backward kernel: the block's 16
    weight rows as ceil(4h / 64) tiles of 2048 bytes."""
    return _sm90_plan(-(-4 * h // _SM90_CHUNK) * _BWD_W_TILE, stages)


class Bf16x3Plan(NamedTuple):
    """How one float32 LSTM forward or backward call is launched
    (:func:`lstm_fwd_bf16x3_plan`, :func:`lstm_bwd_bf16x3_plan`)."""
    units: int       # hidden units a block owns
    blocks: int      # the cooperative grid, one block per SM at most
    smem: int        # dynamic shared-memory bytes a block
    stages: int      # k-steps of A's fragments in each thread's ring
    k_steps: int     # 16-row k-steps of the product (h padded)


def _bf16x3_plan(h: int, sms: int, stages: int,
                 blocks: int) -> Optional[Bf16x3Plan]:
    """The float32 kernels' plan with ``blocks`` blocks: 1024 bytes of
    alignment slack plus the block's 40 weight columns as two bf16 halves
    of ceil(h / 64) (rounded up to even) [40 x 64] tiles of 5120 bytes;
    None past ``sms`` blocks or the opt-in beside 1024 static bytes."""
    if stages not in (0,) + _X3_RINGS:
        raise ValueError(f"the ring depth is one of {_X3_RINGS}, got "
                         f"{stages}")
    if h < 1:
        return None
    chunks = (-(-h // _SM90_CHUNK) + 1) // 2 * 2
    smem = 1024 + 2 * chunks * _X3_TILE
    if blocks > sms or smem + _SM90_STATIC > _SM90_SMEM:
        return None
    return Bf16x3Plan(_X3_UNITS, blocks, smem, stages or _X3_RINGS[0],
                      4 * chunks)


def lstm_fwd_bf16x3_plan(h: int, sms: int,
                         stages: int = 0) -> Optional[Bf16x3Plan]:
    """The float32 LSTM forward's launch (``csrc/lstm_fwd_bf16x3_sm90.cu``,
    its ``plan_fits`` and ``dyn_smem``), pure arithmetic on the shape: 10
    units a block (the N 40 of its m64n40k16 product; ceil(h / 132) at
    the classifier's h 1280), ceil(h / 10) blocks, and 1024 bytes of
    alignment slack plus the block's weight columns as two bf16 halves
    of ceil(h / 64) (rounded up to even) [40 x 64] tiles of 5120 bytes —
    205,824 bytes at h 1280. ``stages`` is the ring depth in k-steps, 8
    or 4 (0: 8). None where it does not fit: more blocks than ``sms``,
    or more than the 232,448-byte opt-in beside 1024 bytes of static
    memory. On 132 SMs it fits every h up to 1320."""
    return _bf16x3_plan(h, sms, stages, -(-h // _X3_UNITS))


def lstm_bwd_bf16x3_plan(h: int, sms: int,
                         stages: int = 0) -> Optional[Bf16x3Plan]:
    """The float32 LSTM backward's launch (``csrc/lstm_bwd_bf16x3_sm90.cu``,
    its ``plan_fits`` and ``dyn_smem``), pure arithmetic on the shape:
    ceil(h / 40) groups of 40 units, 4 blocks a group (one per gate: 128
    at the classifier's h 1280), each owning 10 units and holding its
    gate's slice of the group's 40 weight rows in the forward's 205,824
    bytes at h 1280 (:func:`_bf16x3_plan`). ``stages`` as the forward's.
    None where it does not fit; on 132 SMs it fits every h up to 1320, on
    114 up to 1120."""
    return _bf16x3_plan(h, sms, stages, 4 * -(-h // _X3_N))


class GruPlan(NamedTuple):
    """How one GRU forward call is launched (:func:`gru_fwd_plan`)."""
    route: str       # "sm90" (csrc/gru_fwd_sm90.cu) or "coop" (gru_fwd.cu)
    cluster: int     # blocks a cluster (sm90; 1 for coop)
    rows: int        # batch rows a cluster (sm90; all b for coop)
    units: int       # hidden units a block
    smem: int        # dynamic shared-memory bytes a block
    blocks: int      # the grid


def _gru_sm90_smem(h: int, n: int, rows: int, esize: int) -> Tuple[int, int]:
    """(units a block, dynamic shared-memory bytes) of the sm90 GRU
    kernel with clusters of ``n`` blocks and ``rows`` batch rows a
    cluster: the ``layout`` of ``csrc/gru_fwd_sm90.cu``, each part
    rounded up to 16 bytes — the weight slice [kpad, 3U] in the product
    dtype (U = ceil(h / n) rounded up to 4, kpad = h rounded up to 4),
    round(h) and round(r*h) [rows, kpad + 4 ceil(kpad / 16)] (skewed),
    the owned units' h and z [rows, U], the bias slice [3U], three x3
    stages [3, rows, 3, wseg] of 4-byte words (wseg: the U elements'
    words plus one, rounded up to 4), the lengths."""
    units = -(-(-(-h // n)) // 4) * 4
    kpad = -(-h // 4) * 4
    kph = kpad + 4 * -(-kpad // 16)
    per_word = 4 // esize
    wseg = -(-(-(-units // per_word) + per_word - 1) // 4) * 4
    parts = (kpad * 3 * units * esize, rows * kph * 4, rows * kph * 4,
             rows * units * 4, rows * units * 4, 3 * units * 4,
             3 * rows * 3 * wseg * 4, (rows + 1) * 4)
    return units, sum(-(-p // 16) * 16 for p in parts)


def gru_fwd_plan(b: int, h: int, dtype: torch.dtype, sms: int,
                 cluster: int = 0, rows: int = 0) -> Optional[GruPlan]:
    """The GRU forward's launch, by shape alone (pure arithmetic: no
    card is asked). None when no kernel takes (b, h) — exactly when the
    cooperative kernel's persistent design does not fit (``kernel_ok``).

    - "sm90", ``csrc/gru_fwd_sm90.cu``: the smallest cluster n of 1, 2,
      4, 8 blocks whose blocks each hold a [h, 3h/n] weight slice plus
      their state and staging in 226 KB (a cluster's barrier costs more
      than the traffic a larger n divides); R batch rows a cluster, the
      smallest of 1, 2, 4 at least ceil(b n / sms), so that the clusters
      fit the ``sms`` SMs in one wave, but at most 2 at n 1 (a lone
      block has no cluster barrier to share among its rows, and more
      rows take the registers that hold its weight), less where that
      does not fit. ``chip_smoke.py`` phase 15 times every (n, R) and
      the cooperative kernel where this picks n > 1 or R > 1.
      ``cluster`` and ``rows`` force n and R (those sweeps); a forced
      plan that does not fit raises.
    - "coop", ``csrc/gru_fwd.cu``: where no cluster holds the weight
      (at 226 KB a block: float32 past h 384, bfloat16 past h 544), the
      cooperative kernel over hidden-unit slices with two grid barriers
      a step."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the GRU kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if b < 1 or h < 1:
        return None
    coop_units = -(-h // sms)
    if coop_units > _MAX_UNITS or \
            kernel_smem(h, coop_units) > _SM90_SMEM:
        return None
    esize = 2 if dtype == torch.bfloat16 else 4
    if cluster and cluster not in _GRU_CLUSTERS or \
            rows and rows not in _GRU_ROWS:
        raise ValueError(f"cluster and rows must be one of {_GRU_CLUSTERS}")
    for n in (cluster,) if cluster else _GRU_CLUSTERS:
        want = min(-(-b * n // sms), 2 if n == 1 else _GRU_ROWS[-1])
        top = next(r for r in _GRU_ROWS if r >= want)
        for r in (rows,) if rows else reversed(_GRU_ROWS):
            if r > top and not rows:
                continue
            units, smem = _gru_sm90_smem(h, n, r, esize)
            if smem <= _GRU_SMEM:
                return GruPlan("sm90", n, r, units, smem, n * -(-b // r))
    if cluster or rows:
        raise ValueError(f"no cluster of {cluster or 'any size'} with "
                         f"{rows or 'any'} rows holds the GRU's weight at "
                         f"h {h} in {dtype}")
    return GruPlan("coop", 1, b, coop_units,
                   kernel_smem(h, coop_units), -(-h // coop_units))


def kernel_ok(b: int, h: int, act: str = "tanh", gate_act: str = "sigmoid",
              state_act: str = "tanh", gates: int = 4,
              device=None) -> bool:
    """Whether ``ops/recurrent.py`` sends a forward-direction scan to the
    kernels (the port's ``pallas_ok``). Decided before any launch:

    - a CUDA tensor on an sm_90 card (the kernels are built for sm_90a);
    - the default activations (tanh, sigmoid gates, tanh state);
    - for the LSTM, all four tensor-core kernels fit, each a
      cooperative launch of at most one block per SM: the bf16 ones
      (``csrc/lstm_fwd_sm90.cu``, ``csrc/lstm_bwd_sm90.cu``) in
      ceil(h / 16) blocks of 16 units, each with its bf16 weight tiles
      (1024 + 8192 * ceil(h / 64) bytes forward, 1024 + 2048 *
      ceil(4h / 64) backward) plus at least two 16384-byte ring stages
      (:func:`lstm_fwd_sm90_smem`, :func:`lstm_bwd_sm90_smem`) — true up
      to h = 1536 — and the float32 ones in ceil(h / 10) blocks
      (``csrc/lstm_fwd_bf16x3_sm90.cu``, :func:`lstm_fwd_bf16x3_plan`)
      and 4 ceil(h / 40) blocks (``csrc/lstm_bwd_bf16x3_sm90.cu``,
      :func:`lstm_bwd_bf16x3_plan`), which bind;
    - for the GRU, :func:`gru_fwd_plan` has a route: the cluster kernel
      (``csrc/gru_fwd_sm90.cu``) where a cluster holds the weight, the
      cooperative one (``csrc/gru_fwd.cu``) elsewhere, which fits where
      U = ceil(h / SMs) <= 16 hidden units a block and its resident
      weight slice plus staging area, 4 * (32 * ceil(h / 32) * 3U +
      max(4224, 256U)) bytes (:func:`kernel_smem`), fit the 232,448
      bytes of shared memory a block may use.
    On an H100 SXM (132 SMs) that admits the LSTM up to h = 1320 and the
    GRU up to h = 1472, in float32 and bfloat16 alike. Any batch size.
    """
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return False
    if (act, gate_act, state_act) != ("tanh", "sigmoid", "tanh") or \
            b < 1 or h < 1:
        return False
    if torch.cuda.get_device_capability(device) != (9, 0):
        return False
    sms = _sms(device)
    if gates == 3:
        return gru_fwd_plan(b, h, torch.float32, sms) is not None
    return -(-h // _SM90_UNITS) <= sms and lstm_fwd_sm90_smem(h)[1] > 0 \
        and lstm_bwd_sm90_smem(h)[1] > 0 \
        and lstm_fwd_bf16x3_plan(h, sms) is not None \
        and lstm_bwd_bf16x3_plan(h, sms) is not None


def _fn(lib: str, sym: str, n_ptrs: int, n_ints: int = 5):
    """The C entry ``sym`` of kernel library ``lib``: n_ptrs pointers,
    n_ints ints, then the stream; returns the CUDA error."""
    from paddle_tpu_torch.ops import _build
    fn = getattr(_build.load(lib), sym)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + \
            [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return fn


def _cuda_or_raise(x: torch.Tensor, h: int, b: int, gates: int):
    if x.device.type != "cuda":
        raise ValueError(f"no recurrent kernel for device {x.device}")
    if not kernel_ok(b, h, gates=gates, device=x.device):
        raise ValueError(f"the recurrent kernels do not take b={b}, h={h} "
                         f"on {torch.cuda.get_device_name(x.device)} "
                         "(kernel_ok)")


def _check(named, dev, shapes_dtypes):
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape, dtype = shapes_dtypes[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _barrier(dev):
    """The kernels' grid-barrier arrival counter, zeroed for one launch
    (the caller keeps it alive until the launch is enqueued)."""
    return torch.zeros(1, dtype=torch.int32, device=dev)


def lstm_forward(x4: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor, peep: torch.Tensor,
                 save_res: bool = False):
    """The LSTM forward kernel: (out, hT, cT) or, with ``save_res``,
    (out, hT, cT, cseq, gates) — see :func:`lstm_reference`. ``x4`` and
    ``w`` share the product dtype; bias, peep float32; lens int32 [b].
    CPU: the plain version; CUDA: the kernel of :func:`lstm_fwd_route`."""
    if x4.device.type == "cpu":
        return lstm_reference(x4, lens, w, bias, peep, save_res)
    b, T, four_h = x4.shape
    h = four_h // 4
    _cuda_or_raise(x4, h, b, 4)
    dt = w.dtype
    route = lstm_fwd_route(dt)
    _check({"x4": x4, "w": w, "bias": bias, "peep": peep, "lens": lens},
           x4.device,
           {"x4": ((b, T, four_h), dt), "w": ((h, four_h), dt),
            "bias": ((four_h,), torch.float32),
            "peep": ((3 * h,), torch.float32),
            "lens": ((b,), torch.int32)})
    if route == "sm90":
        res = lstm_fwd_sm90_launch(x4, lens, w, bias, peep, save_res)
    else:
        res = lstm_fwd_bf16x3_launch(x4, lens, w, bias, peep, save_res)
    lstm_forward.launches += 1
    lstm_forward.route_launches[route] += 1
    lstm_forward.row_launches[b] = lstm_forward.row_launches.get(b, 0) + 1
    if save_res:
        lstm_forward.res_launches += 1
    return res


def _outputs(x4: torch.Tensor, save_res: bool):
    """The forward's outputs in ``x4.dtype``: out, cseq [b, T, h], gates
    [b, T, 4h] (None, None without residuals), hT, cT [b, h] float32."""
    b, T, four_h = x4.shape
    h, dt, dev = four_h // 4, x4.dtype, x4.device
    out = torch.empty((b, T, h), dtype=dt, device=dev)
    cseq = torch.empty((b, T, h), dtype=dt, device=dev) if save_res else None
    gates = torch.empty((b, T, four_h), dtype=dt, device=dev) \
        if save_res else None
    hT = torch.empty((b, h), dtype=torch.float32, device=dev)
    cT = torch.empty((b, h), dtype=torch.float32, device=dev)
    return out, cseq, gates, hT, cT


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def lstm_fwd_route(dtype: torch.dtype) -> str:
    """The LSTM forward's route for weights of ``dtype``: bfloat16 takes
    ``csrc/lstm_fwd_sm90.cu`` ("sm90"), float32
    ``csrc/lstm_fwd_bf16x3_sm90.cu`` ("bf16x3": the float32 product as
    three bf16 wgmma passes), both on the tensor cores. By dtype alone,
    decided before any launch."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the LSTM kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    return "sm90" if dtype == torch.bfloat16 else "bf16x3"


def lstm_fwd_bf16x3_launch(x4, lens, w, bias, peep, save_res: bool = False,
                           mode: int = 0, stages: int = 0):
    """One launch of ``csrc/lstm_fwd_bf16x3_sm90.cu`` on checked float32
    CUDA tensors; returns what :func:`lstm_forward` returns. ``mode`` 0
    computes the function (what :func:`lstm_forward` launches); 1 runs
    the steps without their product, 2 the grid barriers alone, 3 the
    loads of h's planes alone and 4 the steps with their products but
    without the h stream (fragments loaded once and reused), the
    per-step floors that ``chip_smoke.py`` times (their outputs are not
    the function). ``stages`` is the ring depth of
    :func:`lstm_fwd_bf16x3_plan` (0: its default; no result depends on
    it). Counts nothing: :func:`lstm_forward` counts its own launches."""
    b, T, four_h = x4.shape
    h, dev = four_h // 4, x4.device
    plan = lstm_fwd_bf16x3_plan(h, _sms(dev), stages)
    if plan is None:
        raise ValueError(f"the float32 LSTM forward does not fit h={h} on "
                         f"{_sms(dev)} SMs (lstm_fwd_bf16x3_plan)")
    out, cseq, gates, hT, cT = _outputs(x4, save_res)
    # h_{t-1} by step parity, as bf16(h) and bf16(h - bf16(h)), each in
    # the wgmma A fragment order: [parity, half, 64-row m-tiles x k-steps
    # x 128 lanes x 4 words]; parity 0 is h_{-1} = 0
    words = 2 * -(-b // 128) * plan.k_steps * 512
    hs = torch.zeros((2, 2, words), dtype=torch.int32, device=dev)
    bar = _barrier(dev)
    fn = _fn("lstm_fwd_bf16x3_sm90", "pt_lstm_fwd_bf16x3", 12)
    err = fn(x4.data_ptr(), w.data_ptr(), bias.data_ptr(), peep.data_ptr(),
             lens.data_ptr(), out.data_ptr(), _ptr(cseq), _ptr(gates),
             hT.data_ptr(), cT.data_ptr(), hs.data_ptr(), bar.data_ptr(), b,
             T, h, int(mode), plan.stages, _stream(dev))
    if err != 0:
        raise RuntimeError(f"LSTM forward (bf16x3) launch failed: CUDA "
                           f"error {err} ({plan})")
    return (out, hT, cT, cseq, gates) if save_res else (out, hT, cT)


def lstm_fwd_sm90_launch(x4, lens, w, bias, peep, save_res: bool = False,
                         mode: int = 0, stages: int = 0):
    """One launch of ``csrc/lstm_fwd_sm90.cu`` on checked bf16 CUDA
    tensors; returns what :func:`lstm_forward` returns. ``mode`` 0
    computes the function (what :func:`lstm_forward` launches); 1 runs
    the steps without their product and 2 the grid barriers alone, the
    per-step floors that ``chip_smoke.py`` times (their outputs are not
    the function). ``stages`` caps the ring's depth (0: as many as fit;
    no result depends on it). Counts nothing: :func:`lstm_forward`
    counts its own launches."""
    b, T, four_h = x4.shape
    h, dev = four_h // 4, x4.device
    out, cseq, gates, hT, cT = _outputs(x4, save_res)
    # round(h_{t-1}) by step parity; plane 0 is h_{-1} = 0
    hs = torch.zeros((2, b, -(-h // 8) * 8), dtype=torch.bfloat16,
                     device=dev)
    bar = _barrier(dev)
    fn = _fn("lstm_fwd_sm90", "pt_lstm_fwd_sm90", 12)
    err = fn(x4.data_ptr(), w.data_ptr(), bias.data_ptr(), peep.data_ptr(),
             lens.data_ptr(), out.data_ptr(), _ptr(cseq), _ptr(gates),
             hT.data_ptr(), cT.data_ptr(), hs.data_ptr(), bar.data_ptr(), b,
             T, h, int(mode), int(stages), _stream(dev))
    if err != 0:
        raise RuntimeError(f"LSTM forward (sm90) launch failed: CUDA error "
                           f"{err}")
    return (out, hT, cT, cseq, gates) if save_res else (out, hT, cT)


def lstm_bwd_route(dtype: torch.dtype) -> str:
    """The LSTM backward's route for weights of ``dtype``: bfloat16
    takes ``csrc/lstm_bwd_sm90.cu`` ("sm90"), float32
    ``csrc/lstm_bwd_bf16x3_sm90.cu`` ("bf16x3": dz W^T as three bf16
    wgmma passes), both on the tensor cores. By dtype alone, decided
    before any launch."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the LSTM kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    return "sm90" if dtype == torch.bfloat16 else "bf16x3"


def lstm_bwd_sm90_launch(w, peep, lens, gates, cseq, d_out, dhT, dcT,
                         mode: int = 0, stages: int = 0) -> torch.Tensor:
    """One launch of ``csrc/lstm_bwd_sm90.cu`` on checked bf16 CUDA
    tensors; returns dz. ``mode`` 0 computes the function (what
    :func:`lstm_backward` launches); 1 runs the steps without their
    product and 2 the grid barriers alone, the per-step floors that
    ``chip_smoke.py`` times (their dz is not the function). ``stages``
    caps the ring's depth (0: as many as fit; no result depends on it).
    Counts nothing: :func:`lstm_backward` counts its own launches."""
    b, T, four_h = gates.shape
    h = four_h // 4
    dev = gates.device
    dz = torch.empty((b, T, four_h), dtype=torch.bfloat16, device=dev)
    zt = torch.empty((2, b, -(-four_h // 8) * 8), dtype=torch.bfloat16,
                     device=dev)
    dh = torch.empty((b, h), dtype=torch.float32, device=dev)
    dc = torch.empty((b, h), dtype=torch.float32, device=dev)
    bar = _barrier(dev)
    fn = _fn("lstm_bwd_sm90", "pt_lstm_bwd_sm90", 13)
    err = fn(w.data_ptr(), peep.data_ptr(), lens.data_ptr(), gates.data_ptr(),
             cseq.data_ptr(), d_out.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
             dz.data_ptr(), zt.data_ptr(), dh.data_ptr(), dc.data_ptr(),
             bar.data_ptr(), b, T, h, int(mode), int(stages), _stream(dev))
    if err != 0:
        raise RuntimeError(f"LSTM backward (sm90) launch failed: CUDA error "
                           f"{err}")
    return dz


def lstm_bwd_bf16x3_launch(w, peep, lens, gates, cseq, d_out, dhT, dcT,
                           mode: int = 0, stages: int = 0) -> torch.Tensor:
    """One launch of ``csrc/lstm_bwd_bf16x3_sm90.cu`` on checked float32
    CUDA tensors; returns dz. ``mode`` 0 computes the function (what
    :func:`lstm_backward` launches); 1 runs the steps without their
    product, 2 the grid barriers and group syncs alone, 3 the loads of
    dz's planes alone and 4 the steps with their products but without
    the dz stream (fragments loaded once and reused), the per-step floors
    that ``chip_smoke.py`` times (their dz is not the function).
    ``stages`` is the ring depth of :func:`lstm_bwd_bf16x3_plan` (0: its
    default; no result depends on it). Counts nothing:
    :func:`lstm_backward` counts its own launches."""
    b, T, four_h = gates.shape
    h, dev = four_h // 4, gates.device
    plan = lstm_bwd_bf16x3_plan(h, _sms(dev), stages)
    if plan is None:
        raise ValueError(f"the float32 LSTM backward does not fit h={h} on "
                         f"{_sms(dev)} SMs (lstm_bwd_bf16x3_plan)")
    groups = plan.blocks // 4
    dz = torch.empty((b, T, four_h), dtype=torch.float32, device=dev)
    dh = torch.empty((b, h), dtype=torch.float32, device=dev)
    dc = torch.empty((b, h), dtype=torch.float32, device=dev)
    # dz_t split, bf16(dz) and bf16(dz - bf16(dz)), in the wgmma A
    # fragment order: [gate, parity, half, 64-row m-tiles x k-steps x 128
    # lanes x 4 words]; zero where no owner writes (rows past b, k past h)
    words = 2 * -(-b // 128) * plan.k_steps * 512
    zs = torch.zeros((4, 2, 2, words), dtype=torch.int32, device=dev)
    # the partial products [parity, group, gate, b, 40]
    part = torch.empty((2, groups, 4, b, _X3_N), dtype=torch.float32,
                       device=dev)
    # the grid barrier, then each group's counter, 128 bytes apart
    bar = torch.zeros((1 + groups) * 32, dtype=torch.int32, device=dev)
    fn = _fn("lstm_bwd_bf16x3_sm90", "pt_lstm_bwd_bf16x3", 14)
    err = fn(w.data_ptr(), peep.data_ptr(), lens.data_ptr(), gates.data_ptr(),
             cseq.data_ptr(), d_out.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
             dz.data_ptr(), dh.data_ptr(), dc.data_ptr(), zs.data_ptr(),
             part.data_ptr(), bar.data_ptr(), b, T, h, int(mode), plan.stages,
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"LSTM backward (bf16x3) launch failed: CUDA "
                           f"error {err} ({plan})")
    return dz


def lstm_backward(w: torch.Tensor, peep: torch.Tensor, lens: torch.Tensor,
                  gates: torch.Tensor, cseq: torch.Tensor,
                  d_out: torch.Tensor, dhT: torch.Tensor,
                  dcT: torch.Tensor) -> torch.Tensor:
    """The LSTM backward kernel: dz [b, T, 4h] in ``w.dtype`` from the
    forward's residuals and the cotangents (d_out in ``w.dtype``, dhT /
    dcT float32). CPU: the plain version; CUDA: the kernel of
    :func:`lstm_bwd_route`."""
    if gates.device.type == "cpu":
        return lstm_backward_reference(w, peep, lens, gates, cseq, d_out,
                                       dhT, dcT)
    b, T, four_h = gates.shape
    h = four_h // 4
    _cuda_or_raise(gates, h, b, 4)
    dt = w.dtype
    route = lstm_bwd_route(dt)
    _check({"w": w, "peep": peep, "lens": lens, "gates": gates, "cseq": cseq,
            "d_out": d_out, "dhT": dhT, "dcT": dcT}, gates.device,
           {"w": ((h, four_h), dt), "peep": ((3 * h,), torch.float32),
            "lens": ((b,), torch.int32), "gates": ((b, T, four_h), dt),
            "cseq": ((b, T, h), dt), "d_out": ((b, T, h), dt),
            "dhT": ((b, h), torch.float32), "dcT": ((b, h), torch.float32)})
    launch = lstm_bwd_sm90_launch if route == "sm90" else \
        lstm_bwd_bf16x3_launch
    dz = launch(w, peep, lens, gates, cseq, d_out, dhT, dcT)
    lstm_backward.launches += 1
    lstm_backward.route_launches[route] += 1
    lstm_backward.row_launches[b] = lstm_backward.row_launches.get(b, 0) + 1
    return dz


def gru_forward(x3: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU forward kernel: (out [b, T, h], hT [b, h]) float32; ``x3``
    and ``w`` share the product dtype, bias float32, lens int32 [b].
    CPU: the plain version; CUDA: the kernel of :func:`gru_fwd_plan`'s
    route, counted in ``route_launches``."""
    if x3.device.type == "cpu":
        return gru_reference(x3, lens, w, bias)
    b, T, three_h = x3.shape
    h = three_h // 3
    _cuda_or_raise(x3, h, b, 3)
    dt = w.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"the GRU kernel takes float32 or bfloat16, got {dt}")
    _check({"x3": x3, "w": w, "bias": bias, "lens": lens}, x3.device,
           {"x3": ((b, T, three_h), dt), "w": ((h, three_h), dt),
            "bias": ((three_h,), torch.float32),
            "lens": ((b,), torch.int32)})
    plan = gru_fwd_plan(b, h, dt, _sms(x3.device))
    if plan.route == "sm90":
        res = gru_fwd_sm90_launch(x3, lens, w, bias, plan)
    else:
        res = gru_fwd_coop_launch(x3, lens, w, bias)
    gru_forward.launches += 1
    gru_forward.route_launches[plan.route] += 1
    return res


def gru_fwd_sm90_launch(x3, lens, w, bias, plan: GruPlan, mode: int = 0):
    """One launch of ``csrc/gru_fwd_sm90.cu`` on checked CUDA tensors
    with ``plan``, an "sm90" plan of :func:`gru_fwd_plan` (the call's
    own, or one with a forced cluster size or rows: the sweeps of
    ``chip_smoke.py``); returns (out, hT). ``mode`` 0 computes the
    function (what :func:`gru_forward` launches); 1 stops after the
    weight load and 2 runs the steps without their products, the floors
    that ``chip_smoke.py`` times (their outputs are not the function).
    Counts nothing: :func:`gru_forward` counts its own launches."""
    b, T, three_h = x3.shape
    h, dev = three_h // 3, x3.device
    if plan.route != "sm90":
        raise ValueError(f"not a plan of the sm90 GRU kernel: {plan}")
    out = torch.empty((b, T, h), dtype=torch.float32, device=dev)
    hT = torch.empty((b, h), dtype=torch.float32, device=dev)
    fn = _fn("gru_fwd_sm90", "pt_gru_fwd_sm90", 6, 7)
    err = fn(x3.data_ptr(), w.data_ptr(), bias.data_ptr(), lens.data_ptr(),
             out.data_ptr(), hT.data_ptr(), b, T, h, plan.cluster, plan.rows,
             _DTYPE_CODES[w.dtype], int(mode), _stream(dev))
    if err != 0:
        raise RuntimeError(f"GRU forward (sm90) launch failed: CUDA error "
                           f"{err} ({plan})")
    return out, hT


def gru_fwd_coop_launch(x3, lens, w, bias):
    """One launch of the cooperative ``csrc/gru_fwd.cu`` on checked CUDA
    tensors; returns (out, hT). :func:`gru_forward`'s route where no
    cluster holds the weight; ``chip_smoke.py`` also times it at the
    tagger's shapes beside the sm90 kernel. Counts nothing."""
    b, T, three_h = x3.shape
    h, dev = three_h // 3, x3.device
    out = torch.empty((b, T, h), dtype=torch.float32, device=dev)
    hT = torch.empty((b, h), dtype=torch.float32, device=dev)
    hbuf = torch.zeros((2, b, h), dtype=torch.float32, device=dev)
    zbuf = torch.empty((b, h), dtype=torch.float32, device=dev)
    rhbuf = torch.empty((b, h), dtype=torch.float32, device=dev)
    bar = _barrier(dev)
    fn = _fn("gru_fwd", "pt_gru_fwd", 10)
    err = fn(x3.data_ptr(), w.data_ptr(), bias.data_ptr(), lens.data_ptr(),
             out.data_ptr(), hT.data_ptr(), hbuf.data_ptr(), zbuf.data_ptr(),
             rhbuf.data_ptr(), bar.data_ptr(), b, T, h, _units(h, dev),
             _DTYPE_CODES[w.dtype], _stream(dev))
    if err != 0:
        raise RuntimeError(f"GRU forward launch failed: CUDA error {err}")
    return out, hT


lstm_forward.launches = 0
lstm_forward.res_launches = 0
lstm_forward.route_launches = {"sm90": 0, "bf16x3": 0}
lstm_forward.row_launches = {}
lstm_backward.launches = 0
lstm_backward.route_launches = {"sm90": 0, "bf16x3": 0}
lstm_backward.row_launches = {}
gru_forward.launches = 0
gru_forward.route_launches = {"sm90": 0, "coop": 0}


# ------------------------------------------------------------ public ops
def lstm_param_grads(dz: torch.Tensor, out: torch.Tensor,
                     cseq: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dw [h, 4h] in dz's dtype, dbias [4h], dpeep [3h] float32): the
    contractions over all (t, b) that follow the backward kernel, from
    its dz [b, T, 4h] and the forward's out and cseq [b, T, h] (h_{t-1}
    and c_{t-1} are out and cseq one step back, 0 at t = 0)."""
    b, T, h = out.shape
    hprev = torch.cat([out.new_zeros((b, 1, h)), out[:, :-1]], dim=1)
    dw = torch.matmul(hprev.reshape(b * T, h).t(), dz.reshape(b * T, 4 * h))
    dbias = dz.sum(dim=(0, 1), dtype=torch.float32)
    cprev = torch.cat([cseq.new_zeros((b, 1, h)), cseq[:, :-1]], dim=1)
    dpeep = torch.cat([
        (dz[..., :h] * cprev).sum(dim=(0, 1), dtype=torch.float32),
        (dz[..., h:2 * h] * cprev).sum(dim=(0, 1), dtype=torch.float32),
        (dz[..., 3 * h:] * cseq).sum(dim=(0, 1), dtype=torch.float32)])
    return dw, dbias, dpeep


class _LSTMFn(torch.autograd.Function):
    """Forward with residuals, reverse-time backward kernel, then the
    parameter gradients as large contractions (``_lstm_fwd`` /
    ``_lstm_bwd``; :func:`lstm_param_grads`). dW comes out of one matmul
    over all (t, b) in the product dtype, like every bf16 matmul of the
    port."""

    @staticmethod
    def forward(ctx, x4, lens, w, bias, peep):
        mxu = compute_dtype()
        wm = w.to(mxu).contiguous()
        out, hT, cT, cseq, gates = lstm_forward(
            x4.to(mxu).contiguous(), lens, wm, bias.contiguous(),
            peep.contiguous(), save_res=True)
        ctx.save_for_backward(lens, wm, peep, cseq, gates, out)
        ctx.dtypes = (x4.dtype, w.dtype)
        return out, hT, cT

    @staticmethod
    def backward(ctx, d_out, d_hT, d_cT):
        lens, wm, peep, cseq, gates, out = ctx.saved_tensors
        b, T, h = out.shape
        d_out = torch.zeros_like(out) if d_out is None else \
            d_out.to(wm.dtype).contiguous()
        d_hT = out.new_zeros((b, h), dtype=torch.float32) if d_hT is None \
            else d_hT.float().contiguous()
        d_cT = out.new_zeros((b, h), dtype=torch.float32) if d_cT is None \
            else d_cT.float().contiguous()
        dz = lstm_backward(wm, peep.contiguous(), lens, gates, cseq, d_out,
                           d_hT, d_cT)
        dw, dbias, dpeep = lstm_param_grads(dz, out, cseq)
        x4_dtype, w_dtype = ctx.dtypes
        return dz.to(x4_dtype), None, dw.to(w_dtype), dbias, dpeep


def _lens(lengths: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return lengths.to(device=x.device, dtype=torch.int32) \
        .reshape(x.shape[0]).contiguous()


def lstm_sequence(x4: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  peep: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x4 [b, T, 4h] -> (h_seq [b, T, h] in the compute dtype, hT, cT
    [b, h] float32). Differentiable: fused kernels both directions on
    the card, their plain versions on the CPU."""
    four_h = x4.shape[-1]
    h = four_h // 4
    lens = _lens(lengths, x4)
    b_arr = (bias if bias is not None else
             x4.new_zeros((four_h,), dtype=torch.float32)).reshape(four_h) \
        .float()
    p_arr = (peep if peep is not None else
             x4.new_zeros((3 * h,), dtype=torch.float32)).reshape(3 * h) \
        .float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x4, w, b_arr, p_arr)):
        return _LSTMFn.apply(x4, lens, w, b_arr, p_arr)
    mxu = compute_dtype()
    return lstm_forward(x4.to(mxu).contiguous(), lens,
                        w.to(mxu).contiguous(), b_arr.contiguous(),
                        p_arr.contiguous())


def gru_sequence(x3: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x3 [b, T, 3h], w [h, 3h] (gates [h, 2h] | candidate [h, h]) ->
    (h_seq [b, T, h], hT [b, h]), float32. With no gradient needed: the
    GRU kernel (inputs rounded to the compute dtype); with one: the
    plain float32 scan under autograd."""
    three_h = x3.shape[-1]
    lens = _lens(lengths, x3)
    b_arr = (bias if bias is not None else
             x3.new_zeros((three_h,), dtype=torch.float32)) \
        .reshape(three_h).float()
    x3f, wf = x3.float(), w.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x3, w, b_arr)):
        return gru_reference(x3f, lens, wf, b_arr)
    mxu = compute_dtype()
    return gru_forward(x3f.to(mxu).contiguous(), lens,
                       wf.to(mxu).contiguous(), b_arr.contiguous())
