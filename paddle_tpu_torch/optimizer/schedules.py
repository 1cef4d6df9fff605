"""Learning-rate schedules — the port of
``paddle_tpu/optimizer/schedules.py`` (the constant schedule; the
decaying ones come with the slices whose configurations use them)."""

from __future__ import annotations


def make_schedule(name: str, lr: float, a: float = 0.0, b: float = 0.0):
    """Returns fn(t) -> learning rate, t = samples processed. The rate
    is a host float: the update multiplies it into float32 tensors, as
    the JAX package multiplies its float32 scalar."""
    name = name or "constant"
    if name == "constant":
        return lambda t: float(lr)
    raise NotImplementedError(
        f"learning_rate_schedule {name!r} is not ported yet (this slice "
        "has 'constant')")
