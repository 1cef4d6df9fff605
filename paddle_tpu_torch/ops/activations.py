"""Activation functions — the port of ``paddle_tpu/ops/activations.py``
(linear, relu, softmax, sigmoid, tanh; the rest wait for the slices
that use them)."""

from __future__ import annotations

import torch

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)


@register("linear")
def linear(x):
    return x


_REGISTRY["identity"] = linear


@register("relu")
def relu(x):
    return torch.relu(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("softmax")
def softmax(x):
    # always normalize in float32 (bf16 exp/sum loses probability mass)
    return torch.softmax(x.float(), dim=-1)
