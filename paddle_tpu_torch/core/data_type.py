"""Input data type declarations — the port's copy of
``paddle_tpu/core/data_type.py``: dense, integer, sparse binary and
sparse float inputs, with their sequence and sub-sequence forms.

Each type doubles as the feed-conversion spec the DataFeeder reads.
``InputType``/``SeqType`` serialize exactly as the JAX package's do,
so topologies round-trip between the packages.
"""

from __future__ import annotations

import dataclasses
from enum import Enum


class SeqType(Enum):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


@dataclasses.dataclass(frozen=True)
class InputType:
    """Declares shape/kind of one data source layer's feed."""
    dim: int
    kind: str  # 'dense' | 'integer' | 'sparse_binary' | 'sparse_float'
    seq_type: SeqType = SeqType.NO_SEQUENCE


def dense_vector(dim: int, seq_type: SeqType = SeqType.NO_SEQUENCE) -> InputType:
    return InputType(dim, "dense", seq_type)


def dense_array(dim: int) -> InputType:  # alias used by some v2 scripts
    return InputType(dim, "dense", SeqType.NO_SEQUENCE)


def integer_value(value_range: int,
                  seq_type: SeqType = SeqType.NO_SEQUENCE) -> InputType:
    return InputType(value_range, "integer", seq_type)


def sparse_binary_vector(dim: int,
                         seq_type: SeqType = SeqType.NO_SEQUENCE) -> InputType:
    return InputType(dim, "sparse_binary", seq_type)


def sparse_float_vector(dim: int,
                        seq_type: SeqType = SeqType.NO_SEQUENCE) -> InputType:
    return InputType(dim, "sparse_float", seq_type)


sparse_vector = sparse_float_vector


def dense_vector_sequence(dim: int) -> InputType:
    return dense_vector(dim, SeqType.SEQUENCE)


def integer_value_sequence(value_range: int) -> InputType:
    return integer_value(value_range, SeqType.SEQUENCE)


def dense_vector_sub_sequence(dim: int) -> InputType:
    return dense_vector(dim, SeqType.SUB_SEQUENCE)


def integer_value_sub_sequence(value_range: int) -> InputType:
    return integer_value(value_range, SeqType.SUB_SEQUENCE)


def sparse_binary_vector_sequence(dim: int) -> InputType:
    return sparse_binary_vector(dim, SeqType.SEQUENCE)


def sparse_float_vector_sequence(dim: int) -> InputType:
    return sparse_float_vector(dim, SeqType.SEQUENCE)
