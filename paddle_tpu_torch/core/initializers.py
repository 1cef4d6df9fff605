"""Parameter initialization policies — the port of
``paddle_tpu/core/initializers.py``.

The same distributions, drawn from an explicit ``torch.Generator``
(on the CPU, then moved: the draws do not depend on the device). They
do not match the JAX package bit for bit — it draws with
``jax.random`` keys folded per parameter — so parity tests always start
from one numpy table.

Each initializer is ``init(generator, shape, dtype) -> tensor``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

Initializer = Callable[[Optional[torch.Generator], Tuple[int, ...],
                        torch.dtype], torch.Tensor]


def normal(std: float = 0.01, mean: float = 0.0) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        return mean + std * torch.randn(shape, generator=gen, dtype=dtype)
    return init


def uniform(scale: float) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        u = torch.rand(shape, generator=gen, dtype=dtype)
        return (2.0 * u - 1.0) * scale
    return init


def constant(value: float = 0.0) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype)
    return init


zeros = constant(0.0)
ones = constant(1.0)


def smart_normal(fan_in_axis: int = 0) -> Initializer:
    """The reference's ``initial_smart``: std = 1/sqrt(fan_in)."""
    def init(gen, shape, dtype=torch.float32):
        fan_in = shape[fan_in_axis] if shape else 1
        std = 1.0 / math.sqrt(max(fan_in, 1))
        return std * torch.randn(shape, generator=gen, dtype=dtype)
    return init


def xavier(fan_in_axes: Sequence[int] = (0,)) -> Initializer:
    """uniform(-sqrt(3/fan_in), sqrt(3/fan_in)) — the reference's default."""
    def init(gen, shape, dtype=torch.float32):
        fan_in = 1
        for a in fan_in_axes:
            fan_in *= shape[a]
        return uniform(math.sqrt(3.0 / max(fan_in, 1)))(gen, shape, dtype)
    return init


def msra(fan_in_axes: Sequence[int] = (0,)) -> Initializer:
    """He/MSRA init for conv/relu stacks: normal, std sqrt(2/fan_in)."""
    def init(gen, shape, dtype=torch.float32):
        fan_in = 1
        for a in fan_in_axes:
            fan_in *= shape[a]
        std = math.sqrt(2.0 / max(fan_in, 1))
        return std * torch.randn(shape, generator=gen, dtype=dtype)
    return init
