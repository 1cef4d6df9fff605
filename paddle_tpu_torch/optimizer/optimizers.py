"""Optimizers — the port of ``paddle_tpu/optimizer/optimizers.py``:
the ``Optimizer`` base (per-parameter attributes, clipping, L1/L2,
the learning-rate schedule, ``ModelAverage``) with the ``Momentum``
(plain SGD at momentum 0), ``Adam``, ``Adamax``, ``AdaGrad``,
``DecayedAdaGrad``, ``AdaDelta`` and ``RmsProp`` rules.

``_apply(p, g, slot, lr, step)`` is the JAX package's rule, term for
term, on float32 tensors. ``update`` applies it to every parameter
and writes the result INTO the parameter tensors under ``no_grad``
(they are the trainer's autograd leaves); optimizer slots and the
model average are replaced by new tensors. The step and sample
counters live on the host, so an update needs no device sync.

Row-sparse tables (``ParamAttr(sparse=True)`` embeddings the trainer
prefetches): ``sparse_prefetch`` gathers a batch's touched rows and
their slots and catches them up over the steps they missed
(``_catch_up``: exact for Momentum, lazy for Adam, frozen otherwise);
``update(sparse_rows=)`` applies the rule to that row block and writes
the rows, their slots and their clocks (``_t``, the step each row was
last touched) back in place; ``materialize_sparse`` catches every row
up for evaluation. Pruning hooks (``HookAttribute("pruning")``) keep a
mask of the largest-|w| weights (``_mask``), applied after every
update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.optimizer.schedules import make_schedule


class L2Regularization:
    def __init__(self, rate: float = 0.0):
        self.rate = rate


class L1Regularization:
    def __init__(self, rate: float = 0.0):
        self.rate = rate


class ModelAverage:
    """AverageOptimizer parity: an average of the parameters, used at
    test time (``test_params``) — the JAX package's EMA whose decay
    min(step / (step + 1), (w - 1) / w) matches a window of
    ``max_average_window`` updates."""

    def __init__(self, average_window: float = 0.5,
                 max_average_window: Optional[int] = None):
        self.average_window = average_window
        self.max_average_window = max_average_window or 10000


class Optimizer:
    """Base class. Subclasses define _init_slot / _apply."""

    def __init__(self, learning_rate: float = 0.01,
                 regularization: Optional[Any] = None,
                 gradient_clipping_threshold: Optional[float] = None,
                 learning_rate_decay_a: float = 0.0,
                 learning_rate_decay_b: float = 0.0,
                 learning_rate_schedule: str = "constant",
                 model_average: Optional[ModelAverage] = None,
                 batch_size: int = 1, **kwargs):
        self.learning_rate = learning_rate
        self.l2 = regularization.rate if isinstance(
            regularization, L2Regularization) else 0.0
        self.l1 = regularization.rate if isinstance(
            regularization, L1Regularization) else 0.0
        self.clip = gradient_clipping_threshold
        self.schedule = make_schedule(learning_rate_schedule, learning_rate,
                                      learning_rate_decay_a,
                                      learning_rate_decay_b)
        self.model_average = model_average
        self.param_attrs: Dict[str, Any] = {}

    def bind(self, param_specs: Dict[str, Any],
             sparse_params=None) -> "Optimizer":
        """Attach per-parameter attrs from Topology.param_specs.
        sparse_params: names that take the row-sparse path (the
        trainer's topology.sparse_tables()); only they get a row
        clock. A sparse-attr table that falls back to dense gradients
        is an ordinary parameter."""
        self.param_attrs = {name: ps.attr for name, ps in param_specs.items()}
        self.sparse_params = set(sparse_params or ())
        return self

    # ---- subclass hooks --------------------------------------------------
    def _init_slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _apply(self, p, g, slot, lr, step) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def _catch_up(self, p_rows, slot_rows, dt):
        """Row-sparse catch-up for dt-1 missed (zero-gradient) steps
        since the row was last touched (``dt``: int32 [rows]). Default:
        rows freeze while untouched (exact for SGD/AdaGrad; the lazy
        convention for the rest). L1/L2 on sparse tables is lazy too:
        decay applies on touch only."""
        return p_rows, slot_rows

    # ---- public API ------------------------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        sparse = getattr(self, "sparse_params", set())
        for k in params:
            if self._pruning_hook(k) is not None and k in sparse:
                raise ValueError(
                    f"param {k!r}: pruning hook + sparse_update is "
                    "unsupported — the row-sparse path would skip the "
                    "mask; use a dense table or drop the hook")
        with torch.no_grad():
            slots = {k: self._init_slot(v.detach())
                     for k, v in params.items()}
            # per-row last-touched step of the row-sparse tables
            for k, v in params.items():
                if k in sparse:
                    slots[k]["_t"] = torch.zeros(
                        v.shape[0], dtype=torch.int32, device=v.device)
            state = {"step": 0, "num_samples": 0.0, "slots": slots}
            self.refresh_hooks(params, state)
            if self.model_average is not None:
                state["avg"] = {k: v.detach().clone()
                                for k, v in params.items()}
        return state

    def refresh_hooks(self, params, state):
        """Recompute the pruning masks from the CURRENT parameter values
        (StaticPruningHook): keep the weights whose |w| reaches the
        ``sparsity_ratio`` quantile of |w| (linear interpolation, as
        ``jnp.quantile``). For weights loaded after the optimizer state
        was made: ``SGD.refresh_update_hooks``."""
        with torch.no_grad():
            for k, v in params.items():
                hook = self._pruning_hook(k)
                if hook is not None:
                    a = torch.abs(v.detach())
                    kth = _quantile(a.float().reshape(-1),
                                    getattr(hook, "sparsity_ratio", 0.5))
                    state["slots"][k]["_mask"] = (a >= kth).to(v.dtype)
        return state

    def _pruning_hook(self, k):
        attr = self.param_attrs.get(k)
        hooks = getattr(attr, "update_hooks", None) if attr else None
        if hooks is None:
            return None
        for h in (hooks if isinstance(hooks, (list, tuple)) else [hooks]):
            if getattr(h, "type", None) == "pruning":
                return h
        return None

    def _adjust_grad(self, k, p, g):
        """Clipping + L1/L2. Returns (g, lr_scale)."""
        attr = self.param_attrs.get(k)
        clip = attr.gradient_clipping_threshold if (
            attr and attr.gradient_clipping_threshold) else self.clip
        if clip:
            g = torch.clamp(g, -clip, clip)
        l2 = attr.l2_rate if (attr and attr.l2_rate is not None) else self.l2
        l1 = attr.l1_rate if (attr and attr.l1_rate is not None) else self.l1
        if l2:
            g = g + l2 * p
        if l1:
            g = g + l1 * torch.sign(p)
        return g, (attr.learning_rate if attr else 1.0)

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               batch_size, sparse_rows: Optional[Dict[str, Any]] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """One step. ``params`` are updated in place (under no_grad) and
        returned with the new optimizer state. Static parameters and
        parameters without a gradient keep their values and slots.
        sparse_rows: {table name: (uids, grad_rows, p_rows, slot_rows)}
        — the row block's gradient and its caught-up prefetched rows
        (``sparse_prefetch``); only those rows, their slots and clocks
        change, so the cost scales with the batch's unique ids, not the
        vocabulary. Such tables need no entry in ``grads``."""
        sparse_rows = sparse_rows or {}
        step = state["step"] + 1
        num_samples = state["num_samples"] + float(batch_size)
        base_lr = self.schedule(num_samples)
        new_slots = {}
        with torch.no_grad():
            for k, p in params.items():
                attr = self.param_attrs.get(k)
                if (attr is not None and attr.is_static) or \
                        (grads.get(k) is None and k not in sparse_rows):
                    new_slots[k] = state["slots"][k]
                    continue
                if k in sparse_rows:
                    new_slots[k] = self._update_rows(
                        k, p.detach(), sparse_rows[k], state["slots"][k],
                        base_lr, step)
                    continue
                slot = state["slots"][k]
                g, lr_scale = self._adjust_grad(k, p.detach(), grads[k])
                np_, ns = self._apply(p.detach(), g, slot,
                                      base_lr * lr_scale, step)
                if "_t" in slot:
                    # a clocked table updated densely: every row touched
                    ns = dict(ns)
                    ns["_t"] = torch.full_like(slot["_t"], step)
                if "_mask" in slot:
                    np_ = np_ * slot["_mask"]
                    ns = dict(ns)
                    ns["_mask"] = slot["_mask"]
                p.copy_(np_)
                new_slots[k] = ns
            new_state = {"step": step, "num_samples": num_samples,
                         "slots": new_slots}
            if self.model_average is not None:
                # the JAX package's float32 decay on the float32 step
                w = self.model_average.max_average_window
                decay = float(min(_f32(step) / (_f32(step) + _f32(1)),
                                  _f32((w - 1.0) / w)))
                new_state["avg"] = {
                    k: state["avg"][k] * decay + p.detach() * (1.0 - decay)
                    for k, p in params.items()}
        return params, new_state

    def sparse_prefetch(self, k, p, slot, uids, next_step: int):
        """Prefetch the touched rows of a sparse table WITH catch-up:
        the returned p_rows are the values a dense run would hold at
        this step (untouched rows drift under momentum-style rules).
        The forward uses these rows, and ``update`` receives them back
        so the plain rule applies. ``next_step`` is a host int, so the
        clock arithmetic adds no sync."""
        with torch.no_grad():
            safe = uids.clamp(0, p.shape[0] - 1)
            p_rows = p.detach()[safe]
            slot_rows = {kk: v[safe] for kk, v in slot.items() if kk != "_t"}
            if "_t" in slot:
                dt = next_step - slot["_t"][safe]
                p_rows, slot_rows = self._catch_up(p_rows, slot_rows, dt)
        return p_rows, slot_rows

    def _update_rows(self, k, p, sparse_entry, slot, base_lr, step):
        """Row-sparse update: the dense rule on the (caught-up) row
        block, scattered back into ``p`` and its slots in place. The
        sentinel entries of ``uids`` (== vocab) have no row: each is
        pointed at entry 0's row with entry 0's new values, so every
        write to that row carries the same bits (no out-of-range index,
        no race). Returns the slots."""
        uids, g_rows, p_rows, slot_rows = sparse_entry
        g_rows, lr_scale = self._adjust_grad(k, p_rows, g_rows)
        np_rows, ns_rows = self._apply(p_rows, g_rows, slot_rows,
                                       base_lr * lr_scale, step)
        pad = uids >= p.shape[0]
        idx = torch.where(pad, uids[:1], uids)

        def same_as_first(rows):
            return torch.where(pad.reshape((-1,) + (1,) * (rows.dim() - 1)),
                               rows[:1], rows)

        p.index_copy_(0, idx, same_as_first(np_rows).to(p.dtype))
        for kk, v in ns_rows.items():
            slot[kk].index_copy_(0, idx, same_as_first(v).to(slot[kk].dtype))
        if "_t" in slot:
            slot["_t"].index_fill_(0, idx, step)
        return slot

    def materialize_sparse(self, params, state):
        """Every row of the sparse tables caught up to the current step
        (stale untouched rows drift under momentum-style rules; their
        true value materializes on fetch). One dense pass per table —
        for evaluation and export, not the train loop."""
        out = dict(params)
        step = state["step"]
        with torch.no_grad():
            for k, slot in state["slots"].items():
                if "_t" not in slot or k not in params:
                    continue
                dt = step - slot["_t"] + 1
                rows = {kk: v for kk, v in slot.items() if kk != "_t"}
                out[k], _ = self._catch_up(params[k].detach(), rows, dt)
        return out

    def test_params(self, params: Dict[str, torch.Tensor],
                    state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The parameters to evaluate with: the model average when it is
        on, else ``params`` with the sparse tables materialized."""
        if self.model_average is not None and "avg" in state:
            return state["avg"]
        return self.materialize_sparse(params, state)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a float32 vector (linear
    interpolation in its float32 arithmetic) by a sort, which has no
    ``torch.quantile`` size limit (2**24 elements)."""
    srt = torch.sort(x).values
    n = np.float32(srt.numel())
    pos = np.float32(q) * (n - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = np.float32(1) - w_hi
    lo = int(min(max(lo, 0), n - 1))
    hi = int(min(max(hi, 0), n - 1))
    return srt[lo] * float(w_lo) + srt[hi] * float(w_hi)


def _f32(x: float) -> np.float32:
    return np.float32(x)


class Momentum(Optimizer):
    """Momentum SGD; momentum=0 is plain SGD."""

    def __init__(self, momentum: float = 0.0, sparse: bool = False, **kw):
        super().__init__(**kw)
        self.momentum = momentum

    def _init_slot(self, p):
        if self.momentum:
            return {"mom": torch.zeros_like(p)}
        return {}

    def _apply(self, p, g, slot, lr, step):
        if not self.momentum:
            return p - lr * g, slot
        m = slot["mom"] * self.momentum - lr * g
        return p + m, {"mom": m}

    def _catch_up(self, p_rows, slot_rows, dt):
        """Exact sparse-momentum catch-up: dt-1 zero-grad steps each do
        m *= mu; p += m, so p gains m0*(mu + ... + mu^(dt-1)) and m
        decays by mu^(dt-1) (the reference's alpha/beta/tau closed form,
        FirstOrderOptimizer.h:60-117): sparse == dense."""
        if not self.momentum:
            return p_rows, slot_rows
        mu = self.momentum
        e = (dt - 1).to(torch.float32)
        e = e[:, None] if p_rows.dim() > 1 else e
        m = slot_rows["mom"]
        if mu >= 1.0:                      # geometric sum degenerates to e
            return p_rows + m * e, {"mom": m}
        geo = mu * (1.0 - torch.pow(mu, e)) / (1.0 - mu)
        return p_rows + m * geo, {"mom": m * torch.pow(mu, e)}


SGD = Momentum


class Adam(Optimizer):
    """Adam with bias correction; the step enters as a float32 power,
    as in the JAX rule."""

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw):
        super().__init__(**kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def _apply(self, p, g, slot, lr, step):
        t = _f32(step)
        m = self.b1 * slot["m"] + (1 - self.b1) * g
        v = self.b2 * slot["v"] + (1 - self.b2) * torch.square(g)
        mhat = m / float(_f32(1) - np.power(_f32(self.b1), t))
        vhat = v / float(_f32(1) - np.power(_f32(self.b2), t))
        return p - lr * mhat / (torch.sqrt(vhat) + self.eps), \
            {"m": m, "v": v}

    def _catch_up(self, p_rows, slot_rows, dt):
        """Lazy Adam: the moments decay for the dt-1 missed zero-grad
        steps on touch; the missed (tiny) parameter nudges are skipped."""
        e = (dt - 1).to(torch.float32)
        e = e[:, None] if p_rows.dim() > 1 else e
        return p_rows, {"m": slot_rows["m"] * torch.pow(self.b1, e),
                        "v": slot_rows["v"] * torch.pow(self.b2, e)}


class Adamax(Optimizer):
    """AdamaxOptimizer (FirstOrderOptimizer.h:303)."""

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, **kw):
        super().__init__(**kw)
        self.b1, self.b2 = beta1, beta2

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def _apply(self, p, g, slot, lr, step):
        t = _f32(step)
        m = self.b1 * slot["m"] + (1 - self.b1) * g
        u = torch.maximum(self.b2 * slot["u"], torch.abs(g))
        scale = lr / float(_f32(1) - np.power(_f32(self.b1), t))
        return p - scale * m / (u + 1e-12), {"m": m, "u": u}


class AdaGrad(Optimizer):
    """AdagradOptimizer (FirstOrderOptimizer.h:146)."""

    def __init__(self, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.eps = epsilon

    def _init_slot(self, p):
        return {"acc": torch.zeros_like(p)}

    def _apply(self, p, g, slot, lr, step):
        acc = slot["acc"] + torch.square(g)
        return p - lr * g / (torch.sqrt(acc) + self.eps), {"acc": acc}


class DecayedAdaGrad(Optimizer):
    """DecayedAdagradOptimizer (FirstOrderOptimizer.h:222)."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def _init_slot(self, p):
        return {"acc": torch.zeros_like(p)}

    def _apply(self, p, g, slot, lr, step):
        acc = self.rho * slot["acc"] + (1 - self.rho) * torch.square(g)
        return p - lr * g / (torch.sqrt(acc) + self.eps), {"acc": acc}


class AdaDelta(Optimizer):
    """AdaDeltaOptimizer (FirstOrderOptimizer.h:168)."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def _init_slot(self, p):
        return {"acc_g": torch.zeros_like(p), "acc_dx": torch.zeros_like(p)}

    def _apply(self, p, g, slot, lr, step):
        acc_g = self.rho * slot["acc_g"] + (1 - self.rho) * torch.square(g)
        dx = -torch.sqrt((slot["acc_dx"] + self.eps) /
                         (acc_g + self.eps)) * g
        acc_dx = self.rho * slot["acc_dx"] + (1 - self.rho) * torch.square(dx)
        return p + lr * dx, {"acc_g": acc_g, "acc_dx": acc_dx}


class RmsProp(Optimizer):
    """RMSPropOptimizer (FirstOrderOptimizer.h:190) — the variant with a
    first-moment term."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def _init_slot(self, p):
        return {"acc": torch.zeros_like(p), "mean": torch.zeros_like(p)}

    def _apply(self, p, g, slot, lr, step):
        acc = self.rho * slot["acc"] + (1 - self.rho) * torch.square(g)
        mean = self.rho * slot["mean"] + (1 - self.rho) * g
        return (p - lr * g / torch.sqrt(acc - torch.square(mean) + self.eps),
                {"acc": acc, "mean": mean})
