"""Mixture-of-experts layers — the port of
``paddle_tpu/layers/moe_layers.py``: the capacity-routed top-k MoE FFN
(ops/moe.py) as a graph layer, and a cost layer that exposes the
router's load-balance loss through the ordinary multi-cost trainer.

The two layers share the gate parameter by name: ``moe_aux_cost``
declares a ``ParamSpec`` identical to the ``moe`` layer's, and
``Topology`` keeps the first spec it sees, so the gate is created once.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializers
from paddle_tpu_torch.core.registry import (LayerMeta, ParamAttr, ParamSpec,
                                            default_weight_init, make_layer,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import moe as moe_ops


def _gate_name(name, cfg):
    a = ParamAttr.of(cfg.get("param_attr"))
    return a.name or f"_{name}.gate", a


def _flatten(v, ctx=None):
    """-> (x2d [n, d], valid [n] or None, restore(y2d) -> like v).

    Routing couples rows (padded rows would eat expert capacity and
    change real rows' outputs), so validity comes from the data:
    sequences from their lengths, dense inputs from ``ctx.n_real`` (the
    trainer's un-padded row count), all-valid outside a trainer step."""
    if isinstance(v, SequenceBatch):
        b, t, d = v.data.shape
        valid = v.mask().reshape(b * t)
        return (v.data.reshape(b * t, d), valid,
                lambda y: v.with_data(y.reshape(b, t, d)))
    n_real = getattr(ctx, "n_real", None) if ctx is not None else None
    valid = None
    if n_real is not None:
        valid = (torch.arange(v.shape[0], device=v.device)
                 < n_real).float()
    return v, valid, lambda y: y


@register_layer("moe")
class MoELayer:
    """Top-k capacity-routed expert FFN: x -> combine(experts(dispatch(x))).

    cfg: expert_num E, expert_hidden f, k (default 2), capacity_factor
    (default 1.25). Parameters: gate [d, E], up [E, d, f], down [E, f, d]
    (no biases). Output size = input size."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        d = m.size
        E = cfg["expert_num"]
        k = cfg.get("k", 2)
        if not 1 <= k <= E:
            raise ValueError(
                f"moe {name}: k={k} must be in [1, expert_num={E}] "
                "(a third round over 2 experts would double-dispatch)")
        f = cfg.get("expert_hidden") or 4 * d
        gname, a = _gate_name(name, cfg)
        cfg["_gate"], cfg["_up"], cfg["_down"] = \
            gname, f"_{name}.moe_up", f"_{name}.moe_down"
        specs = [
            ParamSpec(gname, (d, E), default_weight_init(a, fan_in_axes=(0,)),
                      a),
            ParamSpec(cfg["_up"], (E, d, f),
                      initializers.msra((1,)), ParamAttr()),
            ParamSpec(cfg["_down"], (E, f, d),
                      initializers.msra((1,)), ParamAttr()),
        ]
        return LayerMeta(size=d, seq_level=m.seq_level), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        x2d, valid, restore = _flatten(inputs[0], ctx)
        y, _aux = moe_ops.moe_ffn(
            x2d, valid, params[cfg["_gate"]], params[cfg["_up"]],
            params[cfg["_down"]], k=cfg.get("k", 2),
            capacity_factor=cfg.get("capacity_factor", 1.25),
            mesh=getattr(ctx, "mesh", None),
            dispatch_mode=cfg.get("dispatch_mode", "auto"))
        return restore(y)


@register_layer("moe_aux_cost")
class MoEAuxCostLayer:
    """The router load-balance loss of a ``moe`` layer as a per-sample
    cost node (constant across the batch, so the trainer's batch mean
    recovers the scalar), times ``coeff`` (0.01 is the usual setting).

    The JAX layer takes ``aux`` from ``moe_dispatch``, whose unused
    ``[n, E, C]`` tensors XLA drops from the trace; run eagerly they
    would be built every step, so the port computes the same ``aux``
    with ``moe_aux_loss``."""

    @staticmethod
    def build(name, cfg, input_metas):
        m = input_metas[0]
        d = m.size
        E = cfg["expert_num"]
        gname = cfg["gate_param"]
        cfg["_gate"] = gname
        # shared parameter: a spec IDENTICAL to the moe layer's, so the
        # topology's first-seen dedup picks the same one either way
        a = ParamAttr.of(cfg.get("param_attr"))
        specs = [ParamSpec(gname, (d, E),
                           default_weight_init(a, fan_in_axes=(0,)), a)]
        return LayerMeta(size=1, seq_level=0), specs, []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        v = inputs[0]
        x2d, valid, _ = _flatten(v, ctx)
        logits = x2d.float() @ params[cfg["_gate"]].float()
        aux = moe_ops.moe_aux_loss(logits, valid)
        b = v.data.shape[0] if isinstance(v, SequenceBatch) else v.shape[0]
        return torch.full((b,), cfg.get("coeff", 0.01), dtype=torch.float32,
                          device=aux.device) * aux


def moe(input, expert_num: int, expert_hidden=None, k: int = 2,
        capacity_factor: float = 1.25, name=None, param_attr=None,
        dispatch_mode: str = "auto", **kw):
    """Mixture-of-experts FFN layer (see MoELayer). dispatch_mode:
    'auto' (the default; 'sort' in the port, which has no ep mesh),
    'einsum' (dense [n, E, C] dispatch tensors) or 'sort' (argsort and
    scatter)."""
    return make_layer("moe", name, [input], expert_num=expert_num,
                      expert_hidden=expert_hidden, k=k,
                      capacity_factor=capacity_factor,
                      param_attr=param_attr, dispatch_mode=dispatch_mode)


def moe_aux_cost(input, moe_layer, coeff: float = 0.01, name=None, **kw):
    """Load-balance cost for ``moe_layer``, fed the same input node."""
    return make_layer("moe_aux_cost", name, [input],
                      expert_num=moe_layer.config["expert_num"],
                      k=moe_layer.config.get("k", 2),
                      capacity_factor=moe_layer.config.get(
                          "capacity_factor", 1.25),
                      gate_param=moe_layer.config["_gate"],
                      param_attr=moe_layer.config.get("param_attr"),
                      coeff=coeff)
