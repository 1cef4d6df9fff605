"""Recurrent cells and masked scans — the port of
``paddle_tpu/ops/recurrent.py`` (``mdlstm_2d`` waits).

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
