"""Activation functions — the port of ``paddle_tpu/ops/activations.py``:
the sixteen of the JAX package (and the ``identity`` alias of
``linear``); backward is autograd's."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown activation {name!r}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)


@register("linear")
def linear(x):
    return x


_REGISTRY["identity"] = linear


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("stanh")
def stanh(x):
    # scaled tanh: 1.7159 * tanh(2/3 x)
    return 1.7159 * torch.tanh(2.0 / 3.0 * x)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("brelu")
def brelu(x):
    # bounded relu: min(max(x, 0), 24)
    return torch.clamp(x, 0.0, 24.0)


@register("softrelu")
def softrelu(x):
    # log(1 + exp(x)), input clipped to [-40, 40]
    return torch.log1p(torch.exp(torch.clamp(x, -40.0, 40.0)))


@register("leaky_relu")
def leaky_relu(x):
    return F.leaky_relu(x, 0.01)       # jax.nn.leaky_relu's slope


@register("exponential")
def exponential(x):
    return torch.exp(x)


@register("log")
def log_act(x):
    return torch.log(x)


@register("square")
def square(x):
    return torch.square(x)


@register("sqrt")
def sqrt_act(x):
    return torch.sqrt(x)


@register("reciprocal")
def reciprocal(x):
    return 1.0 / x


@register("abs")
def abs_act(x):
    return torch.abs(x)


@register("softmax")
def softmax(x):
    # always normalize in float32 (bf16 exp/sum loses probability mass)
    return torch.softmax(x.float(), dim=-1)


@register("sequence_softmax")
def sequence_softmax(x, mask=None):
    """Softmax across the time axis (1) of a [batch, time, ...] score,
    padding masked out by ``mask`` [batch, time]."""
    if mask is not None:
        while mask.dim() < x.dim():
            mask = mask[..., None]
        x = torch.where(mask > 0, x, torch.full_like(x, -1e30))
    return torch.softmax(x, dim=1)
