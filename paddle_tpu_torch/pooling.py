"""paddle.v2.pooling-compatible pooling descriptors — the port's copy
of ``paddle_tpu/pooling.py`` (the sequence-pooling types; each ``name``
keys into ops/sequence_ops.py ``seq_pool``)."""

from __future__ import annotations


class BasePoolingType:
    name = "average"


class Max(BasePoolingType):
    name = "max"

    def __init__(self, output_max_index: bool = False):
        self.output_max_index = output_max_index


class Avg(BasePoolingType):
    name = "average"

    def __init__(self, strategy: str = "average"):
        self.strategy = strategy


class Sum(BasePoolingType):
    name = "sum"


class SqrtAvg(BasePoolingType):
    name = "sqrt"


class First(BasePoolingType):
    name = "first"


class Last(BasePoolingType):
    name = "last"


MaxPooling = Max
AvgPooling = Avg
SumPooling = Sum
SqrtAvgPooling = SqrtAvg


def to_name(p) -> str:
    if p is None:
        return "average"
    if isinstance(p, str):
        return p
    if isinstance(p, type) and issubclass(p, BasePoolingType):
        return p.name
    if isinstance(p, BasePoolingType):
        return p.name
    raise TypeError(f"bad pooling type: {p!r}")
