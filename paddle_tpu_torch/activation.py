"""paddle.v2.activation-compatible descriptors — the port of
``paddle_tpu/activation.py`` (each ``name`` keys into
ops/activations.py)."""

from __future__ import annotations


class BaseActivation:
    name = "linear"

    def __repr__(self):
        return f"activation.{type(self).__name__}"


def _make(cls_name, act_name):
    return type(cls_name, (BaseActivation,), {"name": act_name})


Tanh = _make("Tanh", "tanh")
Sigmoid = _make("Sigmoid", "sigmoid")
Softmax = _make("Softmax", "softmax")
SequenceSoftmax = _make("SequenceSoftmax", "sequence_softmax")
Relu = _make("Relu", "relu")
BRelu = _make("BRelu", "brelu")
SoftRelu = _make("SoftRelu", "softrelu")
LeakyRelu = _make("LeakyRelu", "leaky_relu")
STanh = _make("STanh", "stanh")
Linear = _make("Linear", "linear")
Identity = Linear
Exp = _make("Exp", "exponential")
Log = _make("Log", "log")
Square = _make("Square", "square")
Sqrt = _make("Sqrt", "sqrt")
Reciprocal = _make("Reciprocal", "reciprocal")
Abs = _make("Abs", "abs")


def to_name(act) -> str:
    """Normalize an activation argument (object, class, or string)."""
    if act is None:
        return "linear"
    if isinstance(act, str):
        from paddle_tpu_torch.ops import activations as _ops
        if act not in _ops.names():
            raise KeyError(f"unknown activation {act!r}; have {_ops.names()}")
        return act
    if isinstance(act, type) and issubclass(act, BaseActivation):
        return act.name
    if isinstance(act, BaseActivation):
        return act.name
    raise TypeError(f"bad activation: {act!r}")
