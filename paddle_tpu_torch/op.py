"""paddle.v2.op — arithmetic sugar over the port's LayerOutput graph
nodes; the port of ``paddle_tpu/op.py``.

Two surfaces:

  1. Unary math functions (``op.exp(x)``, ``op.sigmoid(x)`` ...): each
     is an identity ``mixed`` layer with the matching activation.
  2. Python operators installed on this package's LayerOutput at
     import: ``a + b``, ``a - b``, ``-a``, ``2 * a``, ``a * s``, where
     the other operand is a number, an equal-size layer or a size-1
     layer (broadcast through ``featmap_expand`` / ``scaling``).

The JAX package's deviation from the 2017 code is kept: there
``a - 3.0`` lowered to ``slope_intercept(intercept=3.0)``, adding the
number; here, as in the JAX package, ``a - c`` subtracts.
"""

from __future__ import annotations

import numbers

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch.core.registry import LayerOutput

__all__ = []


def _register_unary_math_op(op_name: str, act) -> None:
    def op(input, name=None):
        return layer.mixed(input=[layer.identity_projection(input=input)],
                           name=name, act=act)

    op.__name__ = op_name
    op.__doc__ = f"Elementwise {op_name} of a layer."
    globals()[op_name] = op
    __all__.append(op_name)


_register_unary_math_op("exp", act_mod.Exp())
_register_unary_math_op("log", act_mod.Log())
_register_unary_math_op("abs", act_mod.Abs())
_register_unary_math_op("sigmoid", act_mod.Sigmoid())
_register_unary_math_op("tanh", act_mod.Tanh())
_register_unary_math_op("square", act_mod.Square())
_register_unary_math_op("relu", act_mod.Relu())
_register_unary_math_op("sqrt", act_mod.Sqrt())
_register_unary_math_op("reciprocal", act_mod.Reciprocal())
_register_unary_math_op("softmax", act_mod.Softmax())


def _is_number(x) -> bool:
    return isinstance(x, numbers.Number)


def _broadcast_add(a: LayerOutput, b: LayerOutput) -> LayerOutput:
    """The sum of two layers, a size-1 operand repeated to the other's
    width."""
    if a.size == b.size:
        return layer.addto([a, b])
    if a.size != 1 and b.size != 1:
        raise TypeError(
            "Two layers can be added only if they have equal size or one "
            f"of their sizes is 1; sizes are {a.size} and {b.size}")
    if a.size == 1:
        a, b = b, a
    b = layer.featmap_expand(b, num_filters=a.size)
    return layer.addto([a, b])


def _add(self: LayerOutput, other) -> LayerOutput:
    if _is_number(other):
        return layer.slope_intercept(self, intercept=float(other))
    if not isinstance(other, LayerOutput):
        raise TypeError(
            "a layer can only be added to another layer or a number, "
            f"not {type(other).__name__}")
    return _broadcast_add(self, other)


def _neg(self: LayerOutput) -> LayerOutput:
    return layer.slope_intercept(self, slope=-1.0)


def _sub(self: LayerOutput, other) -> LayerOutput:
    if _is_number(other):
        return layer.slope_intercept(self, intercept=-float(other))
    if not isinstance(other, LayerOutput):
        raise TypeError(
            "a layer can only be subtracted by another layer or a number, "
            f"not {type(other).__name__}")
    return _broadcast_add(self, _neg(other))


def _rsub(self: LayerOutput, other) -> LayerOutput:
    if _is_number(other):
        return layer.slope_intercept(self, slope=-1.0,
                                     intercept=float(other))
    return _add(_neg(self), other)


def _mul(self: LayerOutput, other) -> LayerOutput:
    if _is_number(other):
        return layer.slope_intercept(self, slope=float(other))
    if not isinstance(other, LayerOutput):
        raise TypeError(
            "a layer can only be multiplied by another layer or a number, "
            f"not {type(other).__name__}")
    if self.size == 1:
        return layer.scaling(weight=self, input=other)
    if other.size == 1:
        return layer.scaling(weight=other, input=self)
    raise TypeError("at least one operand of '*' must be a number or a "
                    "layer of size 1 (a layer multiplies through scaling)")


LayerOutput.__add__ = _add
LayerOutput.__radd__ = _add
LayerOutput.__neg__ = _neg
LayerOutput.__sub__ = _sub
LayerOutput.__rsub__ = _rsub
LayerOutput.__mul__ = _mul
LayerOutput.__rmul__ = _mul
