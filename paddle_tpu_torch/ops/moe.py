"""Mixture-of-experts FFN with capacity-based top-k routing — the port
of ``paddle_tpu/ops/moe.py``.

The JAX package computes this block outside Pallas (one-hot einsums,
or an argsort with gather and scatter, lowered by XLA), so the port
computes it with PyTorch's own operations: ``torch.argsort``, gathers,
``index_add`` and batched products. No kernel is written for it.

- :func:`moe_dispatch`: the k-round argmax routing as dense one-hot
  ``dispatch`` / ``combine`` tensors ``[n, E, C]``, whose einsums
  define the einsum path's function.
- :func:`moe_sorted_ffn`: the same routing by a stable argsort on the
  expert id and a scatter into ``[E*C + 1, d]`` expert buffers, whose
  last row takes every dropped entry and is sliced off; it never
  materializes ``[n, E, C]``.
- :func:`moe_ffn`: the block, ``dispatch_mode`` "einsum", "sort" or
  "auto" ("einsum" under an ep mesh of size > 1, "sort" otherwise, as
  in the JAX package).

The einsum path's function is computed without its ``[n, E, C]``
tensors (``_experts_ffn``), which at 8192 tokens and 8 experts would
hold 0.67 GB each a layer: the routing's placements put each kept
token into its expert's buffer slot by a scatter, and each token
gathers its kept slots' outputs with the combine weights (a token
holds at most one slot per expert). One function serves one device
and every mesh. Under a mesh (parallel/mesh.py) routing runs over the
GLOBAL token order, as the one global JAX program's does: the block
all-gathers its tokens over dp (differentiably) and routes them all,
so the capacity and each token's position in its expert's buffer see
the whole global batch, and the gate logits are the single-device
product's, row for row. Under ``ep`` each rank holds E/ep experts
(``[E/ep, d, f]`` tables, parallel/tensor_parallel.py); the dp ranks
of an ep group split those experts further (where dp divides E/ep),
each filling its experts' buffers from every global token, and an
all-gather over dp returns the outputs. Each rank combines its own
rows, and one all-reduce over ep sums the experts' shares. The ranks
of an ep group hold the same tokens (the feed is split over dp only),
so that all-reduce takes the place of the token all-to-all a
token-sharded layout needs. So a rank of dp x ep runs 1/(dp * ep) of
the expert work.

Routing runs in float32 at every compute dtype: the gate logits are
``x.float() @ gate.float()`` and the placements and combine weights
are built in float32, then cast to the activation dtype for the expert
products.
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
    rounds, probs, aux = _placements(gate_logits, valid, k, capacity)
    dispatch = torch.zeros((n, num_experts, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    for onehot, gate_j, pos_tok, keep in rounds:
        slot = _one_hot(pos_tok, capacity)     # zero past the capacity
        placed = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]
        dispatch = dispatch + placed
        combine = combine + gate_j[:, None, None] * placed
    if normalize and k > 1:
        total = torch.sum(combine, dim=(1, 2), keepdim=True)
        combine = combine / torch.clamp(total, min=1e-9)
    return dispatch, combine, aux


def _placements(gate_logits, valid, k: int, capacity: int):
    """The einsum path's routing as per-round placements: for each of
    the k rounds (the expert one-hot [n, E] — zero on invalid rows —,
    the gate [n], the position in the expert's buffer [n], keep [n]
    0/1: below the capacity with a live gate), the masked probabilities
    and the aux loss. A token's position is the count kept there in
    earlier rounds plus the earlier tokens of this round."""
    n, num_experts = gate_logits.shape
    dev = gate_logits.device
    valid = _valid(valid, n, dev)
    probs = torch.softmax(gate_logits.float(), dim=-1) * valid[:, None]
    fill = torch.zeros((num_experts,), dtype=torch.float32, device=dev)
    rounds = _route(probs, valid, k)
    out = []
    for _, onehot in rounds:
        gate_j = torch.sum(probs * onehot, dim=-1)
        pos = torch.cumsum(onehot, dim=0) - onehot + fill[None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1)
        keep = ((pos_tok < capacity) & (gate_j > 0)).float()
        fill = fill + torch.sum(onehot * keep[:, None], dim=0)
        out.append((onehot, gate_j, pos_tok, keep))
    return out, probs, _aux(probs, rounds[0][1], valid)


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
            mesh=None, ep_axis: str = "ep", dispatch_mode: str = "einsum"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d] -> (y [n, d], aux loss).

    gate_w [d, E]; w_up [E, d, f]; w_down [E, f, d] (or this rank's
    [E/ep, ...] experts under an ep mesh). ``capacity`` overrides the
    factor-derived per-expert buffer (capacity=n routes drop-free).
    ``dispatch_mode`` "auto" is "einsum" under an ep mesh of size > 1
    and "sort" otherwise; "sort" under ep raises, as in the JAX
    package. With a ``mesh`` whose dp or ep axis is live, x is this
    rank's rows and the routing is the global batch's (module
    docstring); there "sort" computes its function — the einsum
    path's — by the mesh's split of the expert work."""
    from paddle_tpu_torch.parallel.mesh import DP_AXIS, axis_size
    ep = axis_size(mesh, ep_axis)
    if dispatch_mode == "auto":
        dispatch_mode = "einsum" if ep > 1 else "sort"
    if dispatch_mode not in ("einsum", "sort"):
        raise ValueError(f"dispatch_mode must be 'einsum', 'sort' or "
                         f"'auto', got {dispatch_mode!r}")
    if dispatch_mode == "sort" and ep > 1:
        raise ValueError("dispatch_mode='sort' is single-host; use "
                         "'einsum' under ep")
    if dispatch_mode == "sort" and axis_size(mesh, DP_AXIS) == 1:
        return moe_sorted_ffn(x, valid, gate_w, w_up, w_down, k=k,
                              capacity_factor=capacity_factor,
                              capacity=capacity, act=act)
    return _experts_ffn(x, valid, gate_w, w_up, w_down, k=k,
                        capacity_factor=capacity_factor, capacity=capacity,
                        act=act, mesh=mesh, ep_axis=ep_axis)


def _experts_ffn(x, valid, gate_w, w_up, w_down, *, k: int,
                 capacity_factor: float, capacity: Optional[int], act: Act,
                 mesh=None, ep_axis: str = "ep", normalize: bool = True):
    """The einsum path's function for this rank's rows, run by this
    rank's share of the expert work (module docstring): of its ep
    rank's experts [e_ep, e_ep + E/ep), the dp rank's block of E/ep/dp
    (all of them where dp does not divide E/ep), fed from every global
    token. The combine weights are normalized over all of a token's
    kept slots, the other ranks' experts included. Without a mesh every
    collective is the identity."""
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.mesh import DP_AXIS, axis_index, axis_size
    n_local, d = x.shape
    num_experts = gate_w.shape[-1]
    _check_k(k, num_experts)
    dp, ep = axis_size(mesh, DP_AXIS), axis_size(mesh, ep_axis)
    if num_experts % ep:
        raise ValueError(f"ep={ep} must divide the {num_experts} experts")
    e_local = num_experts // ep
    e_ep = axis_index(mesh, ep_axis) * e_local
    if w_up.shape[0] != e_local:            # full tables given
        w_up, w_down = w_up[e_ep:e_ep + e_local], w_down[e_ep:e_ep + e_local]
    split = e_local % dp == 0
    e_mine = e_local // dp if split else e_local
    e0 = e_ep + (axis_index(mesh, DP_AXIS) * e_mine if split else 0)
    dev, cdt = x.device, x.dtype
    xg = comm.all_gather(x, mesh, DP_AXIS, 0)
    vg = None
    if valid is not None:
        with torch.no_grad():
            vg = comm.all_gather(_valid(valid, n_local, dev), mesh,
                                 DP_AXIS, 0)
    n = xg.shape[0]
    if capacity is None:
        capacity = moe_capacity(n, num_experts, k, capacity_factor)
    rounds, _, aux = _placements(xg.float() @ gate_w.float(), vg, k,
                                 capacity)
    row0 = axis_index(mesh, DP_AXIS) * n_local
    own = slice(row0, row0 + n_local)

    def slots(e, pos, keep, lo, count):
        """Buffer rows of the kept placements on experts [lo, lo +
        count); the others go to the scratch row count * capacity."""
        on = (keep > 0) & (e >= lo) & (e < lo + count)
        return on, torch.where(on, (e - lo) * capacity + pos.long(),
                               torch.full_like(e, count * capacity))

    buf = torch.zeros((e_mine * capacity + 1, d), dtype=cdt, device=dev)
    combine = []
    total = torch.zeros((n_local,), dtype=torch.float32, device=dev)
    for onehot, gate_j, pos_tok, keep in rounds:
        e = torch.argmax(onehot, dim=-1)
        on, dest = slots(e, pos_tok, keep, e0, e_mine)
        buf = buf.index_add(0, dest, xg * on.to(cdt)[:, None])
        on, dest = slots(e[own], pos_tok[own], keep[own], e_ep, e_local)
        w = gate_j[own] * keep[own]
        combine.append((dest, w * on.float()))
        total = total + w
    expert_in = buf[:-1].reshape(e_mine, capacity, d)
    mine = slice(e0 - e_ep, e0 - e_ep + e_mine)
    h = act(torch.bmm(expert_in, w_up[mine].to(cdt)))
    expert_out = torch.bmm(h, w_down[mine].to(cdt))
    if split:
        expert_out = comm.all_gather(expert_out, mesh, DP_AXIS, 0)
    flat_out = torch.cat([expert_out.reshape(e_local * capacity, d),
                          torch.zeros((1, d), dtype=cdt, device=dev)])
    y = torch.zeros((n_local, d), dtype=cdt, device=dev)
    for dest, w in combine:
        if normalize and k > 1:
            w = w / torch.clamp(total, min=1e-9)
        y = y + flat_out[dest] * w.to(cdt)[:, None]
    return comm.all_reduce(y, mesh, ep_axis), aux
