"""Layer registry and graph node types — the port of
``paddle_tpu/core/registry.py``.

A registered layer carries ``build`` (validate, infer the output size,
declare parameters — pure Python, identical to the JAX package's so
topologies serialize identically) and ``apply`` (the compute, here on
torch tensors; autograd replaces ``jax.grad``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.core import initializers

# ---------------------------------------------------------------------------
# Parameter declaration


@dataclasses.dataclass
class ParamAttr:
    """Per-parameter attributes (lr scale, L1/L2, static, shared name,
    init). The fields are the JAX package's, so ``_jsonify`` writes the
    same JSON; ``remote`` is carried for that and rejected where a layer
    would need it (the sharded embedding store is not ported)."""
    name: Optional[str] = None
    learning_rate: float = 1.0
    l1_rate: Optional[float] = None
    l2_rate: Optional[float] = None
    is_static: bool = False
    sparse: bool = False
    remote: bool = False
    initializer: Optional[Any] = None
    initial_std: Optional[float] = None
    initial_mean: float = 0.0
    gradient_clipping_threshold: Optional[float] = None
    update_hooks: Optional[Any] = None

    @staticmethod
    def of(x) -> "ParamAttr":
        if x is None:
            return ParamAttr()
        if isinstance(x, ParamAttr):
            return x
        if isinstance(x, dict):
            return ParamAttr(**x)
        raise TypeError(f"cannot convert {x!r} to ParamAttr")


@dataclasses.dataclass
class ParamSpec:
    name: str
    shape: Tuple[int, ...]
    initializer: Any
    attr: ParamAttr
    dtype: Any = torch.float32


@dataclasses.dataclass
class StateSpec:
    """Non-trainable state (e.g. batch-norm moving stats)."""
    name: str
    shape: Tuple[int, ...]
    init_value: float = 0.0
    dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# Graph nodes


@dataclasses.dataclass
class LayerMeta:
    """Static description of one layer's output."""
    size: int
    seq_level: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0
    is_integer: bool = False


_name_counters: Dict[str, "itertools.count"] = {}


def _auto_name(layer_type: str) -> str:
    c = _name_counters.setdefault(layer_type, itertools.count())
    return f"__{layer_type}_{next(c)}__"


def reset_name_counters():
    _name_counters.clear()


class LayerOutput:
    """The object a DSL call returns; doubles as the graph node."""

    def __init__(self, layer_type: str, name: Optional[str], parents:
                 Sequence["LayerOutput"], config: Dict[str, Any],
                 meta: LayerMeta, params: List[ParamSpec],
                 states: List[StateSpec]):
        self.type = layer_type
        self.name = name or _auto_name(layer_type)
        self.parents = list(parents)
        self.config = config
        self.meta = meta
        self.params = params
        self.states = states

    @property
    def size(self) -> int:
        return self.meta.size

    def __repr__(self):
        return f"LayerOutput({self.type}:{self.name}, size={self.meta.size})"


# ---------------------------------------------------------------------------
# Apply-time context


def fold_seed(*parts) -> int:
    """A 63-bit seed from ``parts``: the same parts give the same seed in
    every process (python's ``hash`` is salted per process)."""
    digest = hashlib.blake2b(":".join(str(p) for p in parts).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class ApplyContext:
    """Runtime context threaded through layer ``apply`` calls. ``rng``
    is the step's seed (the trainer folds it from ``init(seed=)`` and
    its step count); None draws as seed 0."""

    def __init__(self, mode: str, state: Dict[str, Any],
                 rng: Optional[int] = None):
        self.mode = mode                  # 'train' | 'test'
        self._rng = rng
        self.state = dict(state)          # read view
        self.state_updates: Dict[str, Any] = {}
        self.mesh = None
        self.n_real = None
        # {table name: (uids, rows)}: prefetched row blocks of the
        # row-sparse tables (Topology.forward's sparse_sub)
        self.sparse_sub = None

    @property
    def is_train(self) -> bool:
        return self.mode == "train"

    def seed_for(self, layer_name: str) -> int:
        """The seed of ``layer_name`` in this step (what a sub-topology
        run by that layer takes as its ``rng``)."""
        return fold_seed(self._rng or 0, layer_name)

    def rng_for(self, layer_name: str, device="cpu") -> torch.Generator:
        """A generator on ``device`` of its own for ``layer_name`` in this
        step: the draws differ across layers and steps and never touch
        the global RNG."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed_for(layer_name))
        return gen

    def get_state(self, name: str):
        return self.state[name]

    def set_state(self, name: str, value):
        self.state_updates[name] = value


# ---------------------------------------------------------------------------
# Registry

_LAYER_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_layer(layer_type: str):
    """build(name, cfg, input_metas) -> (LayerMeta, [ParamSpec], [StateSpec])
    apply(ctx, name, cfg, params, inputs) -> tensor or SequenceBatch"""
    def deco(cls):
        _LAYER_REGISTRY[layer_type] = {
            "build": cls.build, "apply": cls.apply, "cls": cls}
        return cls
    return deco


def get_layer_impl(layer_type: str) -> Dict[str, Callable]:
    if layer_type not in _LAYER_REGISTRY:
        raise KeyError(f"unknown layer type {layer_type!r}; registered: "
                       f"{sorted(_LAYER_REGISTRY)}")
    return _LAYER_REGISTRY[layer_type]


def make_layer(layer_type: str, name: Optional[str],
               inputs: Sequence[LayerOutput], **config) -> LayerOutput:
    """Construct a graph node: run the build half, wrap the result."""
    impl = get_layer_impl(layer_type)
    name = name or _auto_name(layer_type)
    metas = [i.meta for i in inputs]
    meta, params, states = impl["build"](name, config, metas)
    return LayerOutput(layer_type, name, inputs, config, meta, params, states)


def default_weight_init(attr: ParamAttr, fan_in_axes=(0,)):
    if attr.initializer is not None:
        return attr.initializer
    if attr.initial_std is not None:
        return initializers.normal(attr.initial_std, attr.initial_mean)
    return initializers.xavier(fan_in_axes)
