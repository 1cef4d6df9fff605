"""Training events — the port of ``paddle_tpu/trainer/event.py``
(the events of the plain train loop)."""

from __future__ import annotations

from typing import Dict, Optional


class WithMetric:
    def __init__(self, metrics: Optional[Dict[str, float]] = None):
        self.metrics = metrics or {}

    @property
    def evaluator(self):
        return _MetricStr(self.metrics)


class _MetricStr:
    def __init__(self, metrics):
        self.metrics = metrics

    def __str__(self):
        return " ".join(f"{k}={v:.6g}" for k, v in self.metrics.items())


class BeginPass:
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id: int, metrics=None, parameters=None):
        super().__init__(metrics)
        self.pass_id = pass_id
        self.parameters = parameters


class BeginIteration:
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id: int, batch_id: int, cost: float,
                 metrics=None):
        super().__init__(metrics)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost


class TestResult(WithMetric):
    def __init__(self, cost: float, metrics=None):
        super().__init__(metrics)
        self.cost = cost
