"""Mixture-of-experts FFN with capacity-based top-k routing — the port
of ``paddle_tpu/ops/moe.py``.

The JAX package computes this block outside Pallas (one-hot einsums,
or an argsort with gather and scatter, lowered by XLA), so the port
computes it with PyTorch's own operations: ``torch.argsort``, gathers,
``index_add`` and batched products. No kernel is written for it.

- :func:`moe_dispatch`: the k-round argmax routing as dense one-hot
  ``dispatch`` / ``combine`` tensors ``[n, E, C]`` (the einsum path).
- :func:`moe_sorted_ffn`: the same routing by a stable argsort on the
  expert id and a scatter into ``[E*C + 1, d]`` expert buffers, whose
  last row takes every dropped entry and is sliced off; it never
  materializes ``[n, E, C]``.
- :func:`moe_ffn`: the block, ``dispatch_mode`` "einsum", "sort" or
  "auto". The port has no ``ep`` mesh, so "auto" is "sort", as in the
  JAX package without one, and a ``mesh`` raises.

Routing runs in float32 at every compute dtype: the gate logits are
``x.float() @ gate.float()`` and ``dispatch`` / ``combine`` are built in
float32, then cast to the activation dtype for the expert products.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so
a row of zero probabilities (``valid`` 0) lands on expert 0 and is
masked out by ``valid``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Act = Callable[[torch.Tensor], torch.Tensor]


def moe_capacity(n_tokens: int, num_experts: int, k: int,
                 capacity_factor: float) -> int:
    """Per-expert token budget: ceil(k * n / E * factor), at least k."""
    cap = int(-(-k * n_tokens * capacity_factor // num_experts))
    return max(cap, k)


def _check_k(k: int, num_experts: int):
    if not 1 <= k <= num_experts:
        raise ValueError(f"moe: k={k} must be in [1, num_experts="
                         f"{num_experts}]")


def _valid(valid: Optional[torch.Tensor], n: int,
           device: torch.device) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return valid.to(device=device, dtype=torch.float32).reshape(n)


def _one_hot(idx: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows of ``idx``; an index outside [0, C) gives
    the zero row (``jax.nn.one_hot``). A comparison, where
    ``F.one_hot`` checks its range on the host and so waits for the
    card."""
    classes = torch.arange(num_classes, device=idx.device)
    return (idx.long()[:, None] == classes[None, :]).float()


def _route(probs: torch.Tensor, valid: torch.Tensor, k: int):
    """The k rounds of argmax routing over ``probs`` [n, E] (already
    masked by ``valid``): per round the chosen expert [n] and its
    one-hot row [n, E] (zero on invalid rows)."""
    num_experts = probs.shape[1]
    remaining = probs
    rounds = []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = _one_hot(idx, num_experts) * valid[:, None]
        rounds.append((idx, onehot))
        remaining = remaining * (1.0 - onehot)
    return rounds


def _aux(probs: torch.Tensor, first_choice: torch.Tensor,
         valid: torch.Tensor) -> torch.Tensor:
    """The switch-transformer load-balance loss E * sum_e mean(probs_e)
    * mean(assigned_e) over the valid rows (1.0 at a uniform router)."""
    n_valid = torch.clamp(valid.sum(), min=1.0)
    me = probs.sum(dim=0) / n_valid
    ce = first_choice.sum(dim=0) / n_valid
    return probs.shape[1] * torch.sum(me * ce)


def moe_aux_loss(gate_logits: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The ``aux`` that :func:`moe_dispatch` returns, computed without
    its ``[n, E, C]`` tensors: it depends only on the router's
    probabilities and each row's first choice, so neither ``k`` nor the
    capacity enters it."""
    n = gate_logits.shape[0]
    valid = _valid(valid, n, gate_logits.device)
    probs = torch.softmax(gate_logits.float(), dim=-1) * valid[:, None]
    first = _one_hot(torch.argmax(probs, dim=-1), probs.shape[1]) * \
        valid[:, None]
    return _aux(probs, first, valid)


def moe_dispatch(gate_logits: torch.Tensor, valid: Optional[torch.Tensor],
                 *, k: int, capacity: int, normalize: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k capacity routing.

    gate_logits: [n, E] (any float dtype; routing runs in float32).
    valid: [n] 0/1 mask (padded slots must not eat capacity).

    Returns (dispatch [n, E, C] 0/1, combine [n, E, C] gate-weighted,
    aux float32 scalar). A token's position in its expert's buffer is
    the count kept there in earlier rounds plus the earlier tokens of
    this round; positions at or past ``capacity`` are dropped. With
    ``normalize`` and k > 1 the combine weights are divided by the
    total of the KEPT slots, so a token whose other expert overflowed
    keeps full weight on the survivor."""
    n, num_experts = gate_logits.shape
    _check_k(k, num_experts)
    dev = gate_logits.device
    valid = _valid(valid, n, dev)
    probs = torch.softmax(gate_logits.float(), dim=-1) * valid[:, None]
    fill = torch.zeros((num_experts,), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((n, num_experts, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    rounds = _route(probs, valid, k)
    for _, onehot in rounds:
        gate_j = torch.sum(probs * onehot, dim=-1)
        pos = torch.cumsum(onehot, dim=0) - onehot + fill[None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1)
        keep = ((pos_tok < capacity) & (gate_j > 0)).float()
        fill = fill + torch.sum(onehot * keep[:, None], dim=0)
        slot = _one_hot(pos_tok, capacity)     # zero past the capacity
        placed = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]
        dispatch = dispatch + placed
        combine = combine + gate_j[:, None, None] * placed
    if normalize and k > 1:
        total = torch.sum(combine, dim=(1, 2), keepdim=True)
        combine = combine / torch.clamp(total, min=1e-9)
    return dispatch, combine, _aux(probs, rounds[0][1], valid)


def moe_sorted_ffn(x: torch.Tensor, valid: Optional[torch.Tensor],
                   gate_w: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, *, k: int = 2,
                   capacity_factor: float = 1.25,
                   capacity: Optional[int] = None, act: Act = torch.relu,
                   normalize: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch: the (token, choice) pairs ranked by a stable
    argsort on the expert id, in choice-major token order per expert —
    the einsum path's fill discipline, so the keep decisions, the kept
    slots and the combine weights are the einsum path's. Invalid rows
    take the sentinel expert E, which sorts past every real expert and
    eats no capacity. Kept entries are scattered once each into
    ``[E*C + 1, d]`` buffers whose last row takes every drop and is
    sliced off; each token sums its k weighted expert outputs."""
    n, d = x.shape
    num_experts = gate_w.shape[-1]
    _check_k(k, num_experts)
    if capacity is None:
        capacity = moe_capacity(n, num_experts, k, capacity_factor)
    dev = x.device
    valid = _valid(valid, n, dev)
    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1) * valid[:, None]
    rounds = _route(probs, valid, k)
    # invalid rows route to the E sentinel
    ek = torch.cat([torch.where(valid > 0, idx, num_experts)
                    for idx, _ in rounds])                     # [kn]
    gk = torch.cat([torch.sum(probs * onehot, dim=-1)
                    for _, onehot in rounds])                  # [kn]
    order = torch.argsort(ek, stable=True)
    es = ek[order]
    gs = gk[order]
    tok = order % n                       # flat entry j*n + i -> token i
    # rank within the expert's segment = global rank - segment start
    starts = torch.searchsorted(
        es, torch.arange(num_experts + 1, dtype=es.dtype, device=dev),
        right=False)
    pos = torch.arange(k * n, device=dev) - starts[es]
    keep = (pos < capacity) & (es < num_experts) & (gs > 0)
    dump = num_experts * capacity         # scratch row for drops
    dest = torch.where(keep, es * capacity + pos, dump)

    cdt = x.dtype
    xs = x[tok] * keep.to(cdt)[:, None]
    buf = torch.zeros((dump + 1, d), dtype=cdt, device=dev)
    expert_in = buf.index_add(0, dest, xs)[:-1].reshape(
        num_experts, capacity, d)
    h = act(torch.bmm(expert_in, w_up.to(cdt)))
    expert_out = torch.bmm(h, w_down.to(cdt))

    w = gs * keep.float()
    if normalize and k > 1:
        tot = torch.zeros((n,), dtype=torch.float32, device=dev) \
            .index_add(0, tok, w)
        w = w / torch.clamp(tot, min=1e-9)[tok]
    flat_out = torch.cat([expert_out.reshape(dump, d),
                          torch.zeros((1, d), dtype=cdt, device=dev)])
    contrib = flat_out[dest] * w.to(cdt)[:, None]
    y = torch.zeros((n, d), dtype=cdt, device=dev).index_add(0, tok, contrib)
    return y, _aux(probs, rounds[0][1], valid)


def moe_ffn(x: torch.Tensor, valid: Optional[torch.Tensor],
            gate_w: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
            *, k: int = 2, capacity_factor: float = 1.25,
            capacity: Optional[int] = None, act: Act = torch.relu,
            mesh=None, dispatch_mode: str = "einsum"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d] -> (y [n, d], aux loss).

    gate_w [d, E]; w_up [E, d, f]; w_down [E, f, d]. ``capacity``
    overrides the factor-derived per-expert buffer (capacity=n routes
    drop-free). ``dispatch_mode`` "auto" is "sort": the port has no
    ``ep`` mesh, whose dispatch einsum would carry the token
    all-to-all."""
    if mesh is not None:
        raise NotImplementedError(
            "an expert-parallel (ep) mesh is not ported yet (the "
            "parallelism slice, ROADMAP.md queue A.10)")
    if dispatch_mode == "auto":
        dispatch_mode = "sort"
    if dispatch_mode == "sort":
        return moe_sorted_ffn(x, valid, gate_w, w_up, w_down, k=k,
                              capacity_factor=capacity_factor,
                              capacity=capacity, act=act)
    if dispatch_mode != "einsum":
        raise ValueError(f"dispatch_mode must be 'einsum', 'sort' or "
                         f"'auto', got {dispatch_mode!r}")
    n = x.shape[0]
    num_experts = gate_w.shape[-1]
    if capacity is None:
        capacity = moe_capacity(n, num_experts, k, capacity_factor)
    logits = x.float() @ gate_w.float()
    dispatch, combine, aux = moe_dispatch(logits, valid, k=k,
                                          capacity=capacity)
    cdt = x.dtype
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cdt), x)
    h = act(torch.einsum("ecd,edf->ecf", expert_in, w_up.to(cdt)))
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down.to(cdt))
    y = torch.einsum("nec,ecd->nd", combine.to(cdt), expert_out)
    return y, aux
