"""Fault policy for the guarded train step — the port of
``paddle_tpu/trainer/fault.py``.

With a policy attached (``SGD.train(..., fault_policy=FaultPolicy())``):

  - every train step checks the cost and every float value the step
    produced (parameters, optimizer slots, layer state) for finiteness
    on the device;
  - a bad step leaves parameters, slots, layer state and the
    optimizer's ``step`` / ``num_samples`` counters bit-identical to
    skipping the batch: the trainer snapshots what the in-place update
    overwrites and puts it back (trainer/trainer.py ``_guarded``);
  - a counter [current streak, sticky peak] tracks CONSECUTIVE bad
    steps; host ints, since the guard reads each step's outcome on the
    host (the JAX package keeps it on the device), acted on every
    ``check_period`` steps (default: ``max_bad_steps``);
  - once the streak reaches ``max_bad_steps`` the trainer restores the
    newest intact checkpoint (when a checkpoint manager is attached)
    and emits a :class:`paddle_tpu_torch.trainer.event.FaultEvent`.

Skipped steps still fire their iteration events (the cost a handler
reads is the raw, possibly non-finite value), but their metric
contributions are zeroed so pass averages stay finite; the per-step
metric ``fault_ok`` is 1.0 on good steps and 0.0 on skipped ones.

The data-path twin is :class:`ErrorBudget` (reader/pipeline.py) and
the memory twin :class:`MemoryPlan` / the adaptive microbatcher
(trainer/memory.py), both re-exported here: all three feed the same
event stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["FaultPolicy", "ErrorBudget", "ErrorBudgetExceeded",
           "MemoryPlan", "plan_memory", "is_resource_exhausted"]


def __getattr__(name):
    # lazy: reader.pipeline / trainer.memory load on first use
    if name in ("ErrorBudget", "ErrorBudgetExceeded"):
        from paddle_tpu_torch.reader import pipeline
        return getattr(pipeline, name)
    if name in ("MemoryPlan", "plan_memory", "is_resource_exhausted"):
        from paddle_tpu_torch.trainer import memory
        return getattr(memory, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class FaultPolicy:
    """Opt-in numeric fault handling for ``SGD.train``.

    max_bad_steps: consecutive non-finite steps tolerated (updates are
        skipped throughout) before a checkpoint rollback + FaultEvent.
    check_period: how often (in steps) the host reads the device-side
        bad-step streak. ``None`` means ``max_bad_steps``. ``1`` is
        per-step detection.
    rollback: restore from the newest intact checkpoint when the streak
        hits ``max_bad_steps``. With no checkpoint manager (or no
        checkpoint on disk yet) the rollback is a no-op — every bad
        update was skipped — and the FaultEvent carries
        ``restored_step=None``.
    """

    max_bad_steps: int = 3
    check_period: Optional[int] = None
    rollback: bool = True

    def __post_init__(self):
        if self.max_bad_steps < 1:
            raise ValueError("max_bad_steps must be >= 1")
        if self.check_period is not None and self.check_period < 1:
            raise ValueError("check_period must be >= 1 (or None)")

    @property
    def effective_check_period(self) -> int:
        return self.check_period or self.max_bad_steps
