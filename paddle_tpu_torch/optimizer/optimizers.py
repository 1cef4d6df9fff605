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
Row-sparse tables and pruning hooks are not ported yet and raise.
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

    def bind(self, param_specs: Dict[str, Any]) -> "Optimizer":
        """Attach per-parameter attrs from Topology.param_specs."""
        for name, ps in param_specs.items():
            if ps.attr.sparse:
                raise NotImplementedError(
                    f"parameter {name!r}: row-sparse updates are not "
                    "ported yet")
            if ps.attr.update_hooks is not None:
                raise NotImplementedError(
                    f"parameter {name!r}: update hooks (pruning) are not "
                    "ported yet")
        self.param_attrs = {name: ps.attr for name, ps in param_specs.items()}
        return self

    # ---- subclass hooks --------------------------------------------------
    def _init_slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _apply(self, p, g, slot, lr, step) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    # ---- public API ------------------------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        with torch.no_grad():
            slots = {k: self._init_slot(v.detach())
                     for k, v in params.items()}
            state = {"step": 0, "num_samples": 0.0, "slots": slots}
            if self.model_average is not None:
                state["avg"] = {k: v.detach().clone()
                                for k, v in params.items()}
        return state

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
               batch_size) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """One step. ``params`` are updated in place (under no_grad) and
        returned with the new optimizer state. Static parameters and
        parameters without a gradient keep their values and slots."""
        step = state["step"] + 1
        num_samples = state["num_samples"] + float(batch_size)
        base_lr = self.schedule(num_samples)
        new_slots = {}
        with torch.no_grad():
            for k, p in params.items():
                attr = self.param_attrs.get(k)
                if (attr is not None and attr.is_static) or \
                        grads.get(k) is None:
                    new_slots[k] = state["slots"][k]
                    continue
                g, lr_scale = self._adjust_grad(k, p.detach(), grads[k])
                np_, new_slots[k] = self._apply(p.detach(), g,
                                                state["slots"][k],
                                                base_lr * lr_scale, step)
                p.copy_(np_)
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

    def test_params(self, params: Dict[str, torch.Tensor],
                    state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The parameters to evaluate with: the model average when it is
        on, else ``params``."""
        if self.model_average is not None and "avg" in state:
            return state["avg"]
        return params


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
