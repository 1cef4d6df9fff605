"""Learning-rate schedules — the port of
``paddle_tpu/optimizer/schedules.py`` (paddle/parameter/
LearningRateScheduler.cpp): constant, poly, caffe_poly, exp, discexp,
linear and noam, with ``a`` / ``b`` from ``learning_rate_decay_a`` /
``_b``.

``t`` is the number of samples processed so far, a host float: the
update multiplies the host-float rate into float32 tensors. The JAX
package evaluates the same formulas in float32 on a float32 count, so
the two rates agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np


def make_schedule(name: str, lr: float, a: float = 0.0, b: float = 0.0):
    """Returns fn(t) -> learning rate, t = samples processed."""
    name = name or "constant"
    if name == "constant":
        return lambda t: float(lr)
    if name == "poly":
        return lambda t: float(lr * np.power(1.0 + a * t, -b))
    if name == "caffe_poly":
        # past t == a the base is negative: NaN, as the JAX power gives
        return lambda t: float(lr * np.power(np.float64(1.0 - t / a), b))
    if name == "exp":
        return lambda t: float(lr * np.power(a, t / b))
    if name == "discexp":
        return lambda t: float(lr * np.power(a, math.floor(t / b)))
    if name == "linear":
        return lambda t: float(max(lr - a * t, b))
    if name == "noam":
        # warmup-then-rsqrt decay: lr * min(t^-1/2, t * warmup^-3/2) with
        # a = warmup samples (b unused); peaks at lr / sqrt(a) at t == a
        warm = max(a, 1.0)
        return lambda t: float(lr * min(1.0 / math.sqrt(max(t, 1.0)),
                                        t * warm ** -1.5))
    raise ValueError(f"unknown learning_rate_schedule {name!r}")
