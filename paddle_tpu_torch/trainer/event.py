"""Training events — the port of ``paddle_tpu/trainer/event.py``: the
v2 loop's events, the lazy ``LazyEndIteration``, and the fault events
of the training infrastructure (``FaultEvent``, ``OOMEvent``,
``DataFaultEvent``)."""

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


class LazyEndIteration(EndIteration):
    """EndIteration whose cost/metrics sync with the device only when
    ACCESSED. In an evaluator-free train loop nothing else needs per-step
    host data, so a handler that reads `e.cost` every `log_period` steps
    (the CLI's discipline) pays one device round-trip per log_period
    instead of per step, and the host queues the next step's launches
    while the card still runs this one. Accessing cost on EVERY event
    reproduces the eager behavior exactly."""

    def __init__(self, pass_id: int, batch_id: int, fetch):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._fetch = fetch
        self._got = None

    def _resolve(self):
        if self._got is None:
            self._got = self._fetch()
        return self._got

    @property
    def cost(self):
        return self._resolve()[0]

    @property
    def metrics(self):
        return self._resolve()[1]


class EndForwardBackward:
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class FaultEvent:
    """A numeric fault surfaced by the guarded train step (SGD.train with
    a FaultPolicy — see trainer/fault.py).

    kind: "nonfinite" — one or more recent steps produced a non-finite
        cost/gradient and their updates were skipped (bad_streak is the
        current consecutive count, still below the policy's limit);
        "rollback" — the streak reached max_bad_steps; params+optimizer
        state were restored from the newest intact checkpoint
        (restored_step), or kept as-is when no checkpoint exists
        (restored_step None — updates were skipped, so they are intact).

    Handlers may raise to abort the run; the default handler logs."""

    def __init__(self, pass_id: int, batch_id: int, kind: str,
                 bad_streak: int, restored_step: Optional[int] = None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.kind = kind
        self.bad_streak = bad_streak
        self.restored_step = restored_step

    def __repr__(self):
        return (f"FaultEvent(kind={self.kind!r}, pass={self.pass_id}, "
                f"batch={self.batch_id}, bad_streak={self.bad_streak}, "
                f"restored_step={self.restored_step})")


class OOMEvent(FaultEvent):
    """Device memory exhaustion absorbed by the adaptive microbatcher
    (trainer/memory.py). A FaultEvent subclass with ``kind="oom"``, so
    handlers watching
    numeric/data faults see memory faults through the same stream.

    The OOM'd step was re-run split into ``accum_steps`` microbatches
    of ``microbatch`` rows (numerically equivalent to the full-batch
    step): zero samples lost, zero updates skipped. ``error`` is the
    caught ``torch.cuda.OutOfMemoryError``. Handlers may raise to abort
    instead of adapting."""

    def __init__(self, pass_id: int, batch_id: int, microbatch: int,
                 accum_steps: int, error=None):
        super().__init__(pass_id, batch_id, "oom", 0, None)
        self.microbatch = microbatch
        self.accum_steps = accum_steps
        self.error = error

    def __repr__(self):
        return (f"OOMEvent(pass={self.pass_id}, batch={self.batch_id}, "
                f"microbatch={self.microbatch}, "
                f"accum_steps={self.accum_steps})")


class DataFaultEvent(FaultEvent):
    """A data-pipeline fault (reader/pipeline.py). A FaultEvent subclass
    so handlers that catch
    FaultEvent see data faults too; pass_id/batch_id are -1 (the
    pipeline runs below the train loop's batch numbering).

    kind: "data_budget"     — the ErrorBudget is exhausted: more than
              max_bad samples were quarantined (count is the running
              bad-sample total, error the last exception);
          "source_stall"    — the source produced nothing for longer
              than the watchdog's sample_timeout (count: consecutive
              stall ticks);
          "worker_restart"  — a crashed prefetch worker was replaced
              (count: restarts so far; its in-flight sample was
              requeued, not lost);
          "restart_budget"  — worker restarts exceeded max_restarts;
              the pipeline raises to the consumer after emitting this.
    """

    def __init__(self, kind: str, count: int, error=None,
                 where: Optional[str] = None):
        super().__init__(-1, -1, kind, count, None)
        self.count = count
        self.error = error
        self.where = where

    def __repr__(self):
        return (f"DataFaultEvent(kind={self.kind!r}, count={self.count}, "
                f"where={self.where!r}, error={self.error!r})")


class TestResult(WithMetric):
    def __init__(self, cost: float, metrics=None):
        super().__init__(metrics)
        self.cost = cost
