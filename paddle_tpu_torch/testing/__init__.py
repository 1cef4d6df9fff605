"""Testing utilities of the port — deterministic fault injection for
chaos tests and the shared exactly-once audits (the port of
``paddle_tpu/testing/``)."""

from paddle_tpu_torch.testing.audit import (assert_exactly_once,
                                            assert_exactly_once_applied,
                                            audit_exactly_once)
from paddle_tpu_torch.testing.faults import FaultPlan, WorkerCrash

__all__ = ["FaultPlan", "WorkerCrash", "audit_exactly_once",
           "assert_exactly_once", "assert_exactly_once_applied"]
