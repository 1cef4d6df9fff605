"""Recurrent cells and masked scans — the port of
``paddle_tpu/ops/recurrent.py``, with the 2-D multi-dimensional LSTM
``mdlstm_2d``.

A scan runs time-major over the padded axis with a per-step validity
mask: state freezes on padded steps, so results match the ragged
semantics exactly. The forward direction with no initial state goes to
the fused kernels (ops/fused_rnn.py) where ``kernel_ok`` admits it, as
the JAX package sends it to Pallas; everything else is a Python loop of
plain PyTorch steps.

Gate order: LSTM [input, forget, cell(candidate), output]; GRU [update
(z), reset (r), candidate (c)].

Under ``compute_dtype="bfloat16"`` the carries of a plain scan promote
to float32 after the first step (bf16 input + float32 bias); the JAX
package's ``lax.scan`` refuses that change of carry type instead
(ROADMAP.md queue C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops import fused_rnn
from paddle_tpu_torch.ops.linear import matmul
from paddle_tpu_torch.ops.sequence_ops import take_time


def lstm_cell(x4: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_rec: torch.Tensor, bias: Optional[torch.Tensor],
              peep: Optional[torch.Tensor] = None, act: str = "tanh",
              gate_act: str = "sigmoid", state_act: str = "tanh"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x4 [b, 4h] pre-projected input; w_rec [h, 4h];
    bias [4h]; peep [3h] (input|forget|output) or None. Returns
    (h', c')."""
    hdim = h.shape[-1]
    z = x4 + matmul(h, w_rec)
    if bias is not None:
        z = z + bias
    zi, zf, zc, zo = (z[..., :hdim], z[..., hdim:2 * hdim],
                      z[..., 2 * hdim:3 * hdim], z[..., 3 * hdim:])
    ga = activations.get(gate_act)
    if peep is not None:
        pi, pf, po = peep[:hdim], peep[hdim:2 * hdim], peep[2 * hdim:]
        i = ga(zi + pi * c)
        f = ga(zf + pf * c)
    else:
        i = ga(zi)
        f = ga(zf)
    cand = activations.get(act)(zc)
    c_new = f * c + i * cand
    o = ga(zo + po * c_new) if peep is not None else ga(zo)
    h_new = o * activations.get(state_act)(c_new)
    return h_new, c_new


def gru_cell(x3: torch.Tensor, h: torch.Tensor, w_rec: torch.Tensor,
             bias: Optional[torch.Tensor], act: str = "tanh",
             gate_act: str = "sigmoid") -> torch.Tensor:
    """One GRU step. x3 [b, 3h]; w_rec [h, 3h] (gates [h, 2h] +
    candidate [h, h])."""
    hdim = h.shape[-1]
    zr = x3[..., :2 * hdim] + matmul(h, w_rec[:, :2 * hdim])
    if bias is not None:
        zr = zr + bias[:2 * hdim]
    ga = activations.get(gate_act)
    z = ga(zr[..., :hdim])
    r = ga(zr[..., hdim:])
    cand = x3[..., 2 * hdim:] + matmul(r * h, w_rec[:, 2 * hdim:])
    if bias is not None:
        cand = cand + bias[2 * hdim:]
    c = activations.get(act)(cand)
    return (1.0 - z) * h + z * c


def simple_rnn_cell(x: torch.Tensor, h: torch.Tensor, w_rec: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    act: str = "tanh") -> torch.Tensor:
    """RecurrentLayer: h' = act(x + h @ W + b)."""
    z = x + matmul(h, w_rec)
    if bias is not None:
        z = z + bias
    return activations.get(act)(z)


def _where_valid(valid: torch.Tensor, new, old):
    return torch.where(valid.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def _masked_scan(step_fn, init_carry, seq: SequenceBatch, reverse: bool):
    """Run step_fn over time with the state frozen on padded steps.

    step_fn(carry, x_t) -> (new_carry, out_t); the carry is a tensor or
    a tuple of [b, ...] tensors. Reverse processes positions
    len-1 ... 0 of each row (a per-row gather of the padded axis)."""
    x = seq.data
    T = x.shape[1]
    rev_idx = None
    if reverse:
        t = torch.arange(T, dtype=torch.int64, device=x.device)
        rev_idx = torch.clamp(seq.lengths.long()[:, None] - 1 - t[None, :],
                              0, T - 1)
        x = take_time(x, rev_idx)
    carry = init_carry
    outs = []
    for t in range(T):
        valid = t < seq.lengths
        new_carry, out_t = step_fn(carry, x[:, t])
        if isinstance(carry, tuple):
            carry = tuple(_where_valid(valid, n, o)
                          for n, o in zip(new_carry, carry))
        else:
            carry = _where_valid(valid, new_carry, carry)
        outs.append(_where_valid(valid, out_t, torch.zeros_like(out_t)))
    outs = torch.stack(outs, dim=1)                  # [b, T, ...]
    if reverse:
        outs = take_time(outs, rev_idx)
        m = seq.mask(outs.dtype)
        outs = outs * m.reshape(m.shape + (1,) * (outs.dim() - 2))
    return carry, outs


def lstm_scan(seq4: SequenceBatch, w_rec: torch.Tensor,
              bias: Optional[torch.Tensor],
              peep: Optional[torch.Tensor] = None, *, reverse: bool = False,
              act: str = "tanh", gate_act: str = "sigmoid",
              state_act: str = "tanh", h0: Optional[torch.Tensor] = None,
              c0: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """LSTM over a pre-projected sequence [b, T, 4h] -> hidden [b, T, h]."""
    b = seq4.data.shape[0]
    h = w_rec.shape[0]
    dtype = seq4.data.dtype
    if not reverse and h0 is None and c0 is None and fused_rnn.kernel_ok(
            b, h, act, gate_act, state_act, gates=4,
            device=seq4.data.device):
        outs, hT, cT = fused_rnn.lstm_sequence(seq4.data, seq4.lengths,
                                               w_rec, bias, peep)
        out_seq = seq4.with_data(outs.to(dtype))
        if return_state:
            return out_seq, (hT.to(dtype), cT.to(dtype))
        return out_seq
    dev = seq4.data.device
    h_init = h0 if h0 is not None else torch.zeros((b, h), dtype=dtype,
                                                   device=dev)
    c_init = c0 if c0 is not None else torch.zeros((b, h), dtype=dtype,
                                                   device=dev)

    def step(carry, x_t):
        hh, cc = carry
        h_new, c_new = lstm_cell(x_t, hh, cc, w_rec, bias, peep, act,
                                 gate_act, state_act)
        return (h_new, c_new), h_new

    (hT, cT), outs = _masked_scan(step, (h_init, c_init), seq4, reverse)
    out_seq = seq4.with_data(outs)
    if return_state:
        return out_seq, (hT, cT)
    return out_seq


def gru_scan(seq3: SequenceBatch, w_rec: torch.Tensor,
             bias: Optional[torch.Tensor], *, reverse: bool = False,
             act: str = "tanh", gate_act: str = "sigmoid",
             h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """GRU over pre-projected [b, T, 3h] -> [b, T, h]."""
    b = seq3.data.shape[0]
    h = w_rec.shape[0]
    dtype = seq3.data.dtype
    if not reverse and h0 is None and fused_rnn.kernel_ok(
            b, h, act, gate_act, gates=3, device=seq3.data.device):
        outs, hT = fused_rnn.gru_sequence(seq3.data, seq3.lengths, w_rec,
                                          bias)
        out_seq = seq3.with_data(outs.to(dtype))
        if return_state:
            return out_seq, hT.to(dtype)
        return out_seq
    h_init = h0 if h0 is not None else torch.zeros(
        (b, h), dtype=dtype, device=seq3.data.device)

    def step(carry, x_t):
        h_new = gru_cell(x_t, carry, w_rec, bias, act, gate_act)
        return h_new, h_new

    hT, outs = _masked_scan(step, h_init, seq3, reverse)
    out_seq = seq3.with_data(outs)
    if return_state:
        return out_seq, hT
    return out_seq


def rnn_scan(seq: SequenceBatch, w_rec: torch.Tensor,
             bias: Optional[torch.Tensor], *, reverse: bool = False,
             act: str = "tanh", h0: Optional[torch.Tensor] = None):
    """Simple RNN (RecurrentLayer) over [b, T, h] -> [b, T, h]."""
    b = seq.data.shape[0]
    h = w_rec.shape[0]
    h_init = h0 if h0 is not None else torch.zeros(
        (b, h), dtype=seq.data.dtype, device=seq.data.device)

    def step(carry, x_t):
        h_new = simple_rnn_cell(x_t, carry, w_rec, bias, act)
        return h_new, h_new

    _, outs = _masked_scan(step, h_init, seq, reverse)
    return seq.with_data(outs)


def _mdlstm_parts(x, w, bias, act, gate_act, reverse_h, reverse_w):
    """The flipped input, and the cell function of ``mdlstm_2d``."""
    h = x.shape[-1] // 5
    fa = activations.get(act)
    ga = activations.get(gate_act)
    if bias is None:
        gate_b = torch.zeros((5 * h,), dtype=x.dtype, device=x.device)
        peep = torch.zeros((4 * h,), dtype=x.dtype, device=x.device)
    else:
        gate_b, peep = bias[:5 * h], bias[5 * h:]
    p_ig, p_fy, p_fx, p_og = (peep[i * h:(i + 1) * h] for i in range(4))
    flips = [d for d, r in ((1, reverse_h), (2, reverse_w)) if r]
    if flips:
        x = x.flip(flips)

    def cell(pre, h_up, c_up, h_left, c_left):
        pre = pre + matmul(h_up + h_left, w) + gate_b
        a_in = fa(pre[..., :h])
        ig = ga(pre[..., h:2 * h] + p_ig * (c_up + c_left))
        fy = ga(pre[..., 2 * h:3 * h] + p_fy * c_up)
        fx = ga(pre[..., 3 * h:4 * h] + p_fx * c_left)
        c = ig * a_in + fy * c_up + fx * c_left
        og = ga(pre[..., 4 * h:] + p_og * c)
        return og * fa(c), c

    return x, cell, flips


def mdlstm_2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              *, act: str = "tanh", gate_act: str = "sigmoid",
              reverse_h: bool = False, reverse_w: bool = False
              ) -> torch.Tensor:
    """2-D multi-dimensional LSTM over an image grid (MDLstmLayer).

    x [b, H, W, 5h] is the pre-projected gate input, laid out (in, ig,
    fg_y, fg_x, og); w [h, 5h] the recurrent weight both predecessors
    share; bias [9h] the 5h gate bias, then the peepholes of ig, fg_y,
    fg_x and og. Cell (i, j) reads h and c from (i-1, j) and (i, j-1);
    ``reverse_h`` / ``reverse_w`` walk an axis backwards. Returns
    [b, H, W, h].

    The cells of one anti-diagonal i + j = k depend only on diagonal
    k - 1, so the walk is H + W - 1 dependent steps, each one batched
    product over the diagonal's cells, in place of the H * W steps of
    the JAX package's nested scan (``mdlstm_2d_reference``, the plain
    version, walks those)."""
    b, H, W, d5 = x.shape
    h = d5 // 5
    x, cell, flips = _mdlstm_parts(x, w, bias, act, gate_act, reverse_h,
                                   reverse_w)
    dev = x.device
    zero = torch.zeros((b, 1, h), dtype=x.dtype, device=dev)
    prev_h = prev_c = None
    hs, order = [], []
    for k in range(H + W - 1):
        lo, hi = max(0, k - W + 1), min(H - 1, k)
        ii = torch.arange(lo, hi + 1, device=dev)
        pre = x[:, ii, k - ii]                        # [b, n, 5h]
        if prev_h is None:
            h_up = c_up = h_left = c_left = zero
        else:
            # the rows of diagonal k - 1 (plo..), a zero row each side
            plo = max(0, k - W)
            ph = F.pad(prev_h, (0, 0, 1, 1))
            pc = F.pad(prev_c, (0, 0, 1, 1))
            up = slice(lo - plo, hi - plo + 1)
            left = slice(lo - plo + 1, hi - plo + 2)
            h_up, c_up, h_left, c_left = ph[:, up], pc[:, up], ph[:, left], \
                pc[:, left]
        prev_h, prev_c = cell(pre, h_up, c_up, h_left, c_left)
        hs.append(prev_h)
        order += [i * W + (k - i) for i in range(lo, hi + 1)]
    inv = torch.empty(H * W, dtype=torch.long)
    inv[torch.tensor(order)] = torch.arange(H * W)
    out = torch.cat(hs, dim=1)[:, inv.to(dev)].reshape(b, H, W, h)
    return out.flip(flips) if flips else out


def mdlstm_2d_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor], *, act: str = "tanh",
                        gate_act: str = "sigmoid", reverse_h: bool = False,
                        reverse_w: bool = False) -> torch.Tensor:
    """The plain version of ``mdlstm_2d``: the JAX package's nested scan
    spelt out, a row at a time and a cell at a time (H * W dependent
    steps)."""
    b, H, W, d5 = x.shape
    h = d5 // 5
    x, cell, flips = _mdlstm_parts(x, w, bias, act, gate_act, reverse_h,
                                   reverse_w)
    zero = torch.zeros((b, h), dtype=x.dtype, device=x.device)
    h_up, c_up = [zero] * W, [zero] * W
    rows = []
    for i in range(H):
        h_left = c_left = zero
        hs, cs = [], []
        for j in range(W):
            h_left, c_left = cell(x[:, i, j], h_up[j], c_up[j], h_left,
                                  c_left)
            hs.append(h_left)
            cs.append(c_left)
        h_up, c_up = hs, cs
        rows.append(torch.stack(hs, dim=1))
    out = torch.stack(rows, dim=1)
    return out.flip(flips) if flips else out
