"""Device-memory pressure — the part of ``paddle_tpu/trainer/memory.py``
the serving plane needs: the predicate that tells a device allocation
failure from every other fault.

The JAX package matches XLA's ``RESOURCE_EXHAUSTED`` message; on the
card an allocation failure is ``torch.cuda.OutOfMemoryError`` (also
``torch.OutOfMemoryError``), raised by the caching allocator. The
adaptive microbatching executor built on this predicate comes with the
training infrastructure (ROADMAP A.9).
"""

from __future__ import annotations

import torch

_OOM_TYPES = tuple({getattr(torch, "OutOfMemoryError", None),
                    torch.cuda.OutOfMemoryError} - {None})


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when ``exc`` is a device allocation failure — the ONE
    failure a memory-pressure path may absorb (serving/server.py sheds
    the request and halves its batch limit); everything else is a
    model fault."""
    return isinstance(exc, _OOM_TYPES)
