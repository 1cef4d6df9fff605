"""Memory-pressure resilience — the port of
``paddle_tpu/trainer/memory.py``: the predicate that tells a device
allocation failure from every other fault, ``MemoryPlan`` and the
adaptive microbatcher.

The JAX package matches XLA's ``RESOURCE_EXHAUSTED``; on the card an
allocation failure is ``torch.cuda.OutOfMemoryError`` (also
``torch.OutOfMemoryError``), raised by the caching allocator.

  - :class:`MemoryPlan` — how a batch is executed: microbatch rows,
    gradient-accumulation steps, and provenance (who decided).
  - :class:`AdaptiveMicrobatcher` — the executor behind
    ``SGD.train(microbatch=...)``. It catches a device OOM, bisects the
    batch into microbatches whose gradients accumulate into the
    full-batch gradient (``SGD._device_step``: the same mean over the
    real rows), re-runs the FAILED batch — no sample lost, no update
    skipped — and emits ``event.OOMEvent``.
  - :func:`plan_memory` — the optional warmup probe: the largest safe
    microbatch, found before the pass on copies of the training state.

An eager step can run out of memory halfway, unlike an XLA program
that fails whole. The executor absorbs only an OOM that no parameter
write has seen: the trainer counts the optimizer updates it has begun
(``SGD._update_writes``), and an OOM raised once the update began is
re-raised, never bisected (``_check_buffers_alive``). Before the
smaller retry the failed attempt's exception drops its traceback — its
frames pin that attempt's activations — and the allocator's cache is
emptied.

The discovered plan rides in checkpoint meta (``memory_plan``), so an
auto-resumed run restarts at the known-safe microbatch. The serving
plane uses :func:`is_resource_exhausted` too: an OOM'd forward sheds
with ``resource_exhausted`` and halves its batch-rows limit
(serving/server.py).
"""

from __future__ import annotations

import dataclasses
import gc
import warnings
from typing import Optional

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.trainer import event as evt
from paddle_tpu_torch.utils.stats import global_counters, stat_timer

__all__ = ["MemoryPlan", "AdaptiveMicrobatcher", "plan_memory",
           "is_resource_exhausted", "resource_exhausted_error"]

_OOM_TYPES = tuple({getattr(torch, "OutOfMemoryError", None),
                    torch.cuda.OutOfMemoryError} - {None})


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when ``exc`` is a device allocation failure — the ONE
    failure a memory-pressure path may absorb (the microbatcher bisects,
    serving/server.py sheds the request and halves its batch limit);
    everything else is a model fault."""
    return isinstance(exc, _OOM_TYPES)


def resource_exhausted_error(nbytes: int = 2 << 30,
                             where: str = "") -> Exception:
    """A ``torch.OutOfMemoryError`` with the caching allocator's message
    shape, for fault injection through ``SGD._step_interceptor``: the
    executor's catch path runs on the type a real allocator failure
    raises."""
    suffix = f" [injected: {where}]" if where else ""
    return _OOM_TYPES[0](
        f"CUDA out of memory. Tried to allocate {int(nbytes)} bytes."
        f"{suffix}")


@dataclasses.dataclass
class MemoryPlan:
    """How a train batch is executed against device memory.

    microbatch: rows per microbatch (None = the whole batch in one
        step). The accumulation count for a batch is
        ``steps_for(batch_rows)``.
    accum_steps: the accumulation count the last executed batch used.
    provenance: "full" (no microbatching until an OOM forces it),
        "configured" (user-passed size), "probe" (plan_memory()),
        "adapted" (shrunk at runtime by a caught OOM), "resumed"
        (restored from checkpoint meta).
    """

    microbatch: Optional[int] = None
    accum_steps: int = 1
    provenance: str = "full"

    def steps_for(self, batch_rows: int) -> int:
        if self.microbatch is None or self.microbatch >= batch_rows:
            return 1
        return -(-batch_rows // self.microbatch)

    def to_meta(self) -> Optional[dict]:
        """JSON payload for checkpoint meta; None while the plan is the
        trivial full-batch one."""
        if self.microbatch is None:
            return None
        return {"microbatch": int(self.microbatch),
                "accum_steps": int(self.accum_steps),
                "provenance": self.provenance}

    @classmethod
    def from_meta(cls, m, provenance: Optional[str] = None
                  ) -> Optional["MemoryPlan"]:
        if not m or m.get("microbatch") is None:
            return None
        return cls(microbatch=int(m["microbatch"]),
                   accum_steps=int(m.get("accum_steps", 1)),
                   provenance=provenance or
                   str(m.get("provenance", "resumed")))


def _leading_rows(feed) -> int:
    v = next(iter(feed.values()))
    return int((v.data if isinstance(v, SequenceBatch) else v).shape[0])


def _rows(v, lo: int, hi: int):
    """Rows [lo, hi) of one feed entry."""
    if isinstance(v, SequenceBatch):
        cut = [None if t is None else t[lo:hi]
               for t in (v.segment_ids, v.num_segments)]
        return SequenceBatch(v.data[lo:hi], v.lengths[lo:hi], *cut)
    return v[lo:hi]


def _pad_rows(v, pad: int):
    """One feed entry with ``pad`` empty rows appended (zero-length
    sequences, segment id -1 on their padding)."""
    def z(t, fill=0):
        if t is None:
            return None
        return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]),
                                        fill)])
    if isinstance(v, SequenceBatch):
        return SequenceBatch(z(v.data), z(v.lengths), z(v.segment_ids, -1),
                             z(v.num_segments))
    return z(v)


def _pad_to_multiple(feed, k: int):
    """Pad every feed entry to a row count divisible by ``k`` (zeros:
    the padded rows sit past ``n_real`` and are masked out of cost,
    metrics and gradients, a zero-length sequence each). Returns
    (padded_feed, microbatch_rows)."""
    b = _leading_rows(feed)
    mb = -(-b // k)
    pad = mb * k - b
    if pad == 0:
        return feed, mb
    return {name: _pad_rows(v, pad) for name, v in feed.items()}, mb


def split_feed(feed, k: int):
    """The k contiguous microbatches of a feed whose row count k
    divides."""
    b = _leading_rows(feed)
    mb = b // k
    return [{name: _rows(v, j * mb, (j + 1) * mb)
             for name, v in feed.items()} for j in range(k)]


def _check_buffers_alive(trainer, writes_before: int, exc):
    """An OOM that came after the optimizer update began writing the
    parameters in place cannot be retried on a smaller microbatch: the
    parameters are no longer those of the step's start."""
    if trainer._update_writes != writes_before:
        raise RuntimeError(
            "the train step ran out of device memory inside the "
            "optimizer update, after it began writing the parameters in "
            "place; the live training state is not the step's start — "
            "relaunch with auto_resume to restore the newest checkpoint "
            "(the adapted MemoryPlan rides in its meta)") from exc


def _release(exc):
    """Drop a failed attempt's frames (they pin its activations) and
    the allocator's cached blocks before a smaller retry."""
    exc.__traceback__ = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class AdaptiveMicrobatcher:
    """The adaptive executor behind ``SGD.train(microbatch=...)``.

    Runs every optimizer step under the current :class:`MemoryPlan`;
    when the step raises a device OOM before the update wrote anything,
    it bisects the microbatch (halving rows, doubling accumulation
    steps), emits an ``OOMEvent`` through the train loop's event handler
    and re-runs the SAME batch. Non-OOM errors re-raise untouched."""

    def __init__(self, trainer, plan: Optional[MemoryPlan] = None,
                 min_microbatch: int = 1, probe: bool = False):
        self.trainer = trainer
        self.plan = plan or MemoryPlan()
        self.min_microbatch = max(1, int(min_microbatch))
        self.oom_events = 0
        self._probe_pending = bool(probe)

    def adopt(self, plan: MemoryPlan):
        """Install a plan decided elsewhere (checkpoint meta on
        auto-resume) — cancels any pending warmup probe."""
        self.plan = plan
        self._probe_pending = False

    def maybe_probe(self, feed, rng, n_real):
        """Run the warmup probe on the first batch when requested and no
        better plan exists yet (an adapted/resumed/probed plan always
        wins — resume must NOT re-probe)."""
        if not self._probe_pending:
            return
        self._probe_pending = False
        if self.plan.provenance != "full":
            return
        self.plan = _probe_feed(self.trainer, feed, rng, n_real,
                                min_microbatch=self.min_microbatch)

    def run(self, feed, rng, n_real: int, guarded: bool = False,
            ctx=None):
        """One optimizer step over ``feed`` under the plan; returns
        ``SGD._device_step``'s (loss, metrics, eval_outs). ``ctx`` is
        (pass_id, batch_id, event_handler) for OOMEvent emission."""
        trainer = self.trainer
        self.maybe_probe(feed, rng, n_real)
        while True:
            b = _leading_rows(feed)
            k = self.plan.steps_for(b)
            if k == 1:
                run_feed, mb = feed, b
            else:
                with stat_timer("train/h2d"):
                    run_feed, mb = _pad_to_multiple(feed, k)
            self.plan.accum_steps = k
            writes = trainer._update_writes
            try:
                if trainer._step_interceptor is not None:
                    trainer._step_interceptor(k, mb)
                return trainer._device_step(run_feed, n_real, rng, k=k,
                                            guarded=guarded)
            except Exception as e:
                if not is_resource_exhausted(e):
                    raise
                exc = e
            # outside the handler: the frames of the attempt are no
            # longer on the stack
            del run_feed
            self._absorb_oom(exc, b, mb, ctx, writes)

    def _absorb_oom(self, exc, batch_rows: int, mb: int, ctx,
                    writes_before: int):
        """Account one OOM and bisect the plan; re-raise at the floor
        (the device cannot fit one minimal microbatch) and when the
        update had begun writing."""
        self.oom_events += 1
        global_counters.bump("trainer/oom_events")
        from paddle_tpu_torch.obs.profile import PROFILER
        if PROFILER.enabled:
            PROFILER.sample_memory()
        _check_buffers_alive(self.trainer, writes_before, exc)
        if mb <= self.min_microbatch:
            raise exc
        _release(exc)
        self.plan.microbatch = max(self.min_microbatch, (mb + 1) // 2)
        self.plan.accum_steps = self.plan.steps_for(batch_rows)
        self.plan.provenance = "adapted"
        from paddle_tpu_torch.obs.events import emit as journal_emit
        journal_emit("trainer", "oom", microbatch=self.plan.microbatch,
                     accum_steps=self.plan.accum_steps,
                     batch_rows=batch_rows, error=repr(exc)[:400])
        warnings.warn(
            f"train step ran out of device memory at microbatch={mb}; "
            f"bisecting to {self.plan.microbatch} rows x "
            f"{self.plan.accum_steps} accumulation steps and re-running "
            "the batch (no samples lost)", stacklevel=3)
        if ctx is not None:
            pass_id, batch_id, handler = ctx
            handler(evt.OOMEvent(pass_id, batch_id,
                                 microbatch=self.plan.microbatch,
                                 accum_steps=self.plan.accum_steps,
                                 error=exc))


def plan_memory(trainer, batch=None, *, feeding=None, feed=None,
                n_real=None, min_microbatch: int = 1) -> MemoryPlan:
    """Warmup probe: the largest safe microbatch, found BEFORE training
    by trial steps on COPIES of the training state — parameters,
    optimizer and layer state are untouched and no reader data is
    consumed (the probe reuses one sample batch).

    ``batch`` is a list of sample tuples (the reader's unit); pass
    ``feed``/``n_real`` instead to skip the conversion. Returns a
    :class:`MemoryPlan` with provenance="probe"."""
    if feed is None:
        feed = trainer._feeder(feeding)(batch)
        n_real = int(feed.pop("__batch_size__"))
    return _probe_feed(trainer, feed, 0, n_real, min_microbatch)


def _probe_feed(trainer, feed, rng, n_real: int,
                min_microbatch: int = 1) -> MemoryPlan:
    b = _leading_rows(feed)

    def trial(k: int) -> bool:
        run_feed, mb = (feed, b) if k == 1 else _pad_to_multiple(feed, k)
        try:
            if trainer._step_interceptor is not None:
                trainer._step_interceptor(k, mb)
            with trainer._scratch_state():
                out = trainer._device_step(run_feed, n_real, rng, k=k,
                                           guarded=False)
                out[0].item()           # force real execution
            return True
        except Exception as e:
            if not is_resource_exhausted(e):
                raise
            _release(e)
            global_counters.bump("trainer/oom_probe_failures")
            return False

    # descend in doubling accumulation counts until a microbatch fits
    k = 1
    while not trial(k):
        mb = -(-b // k)
        if mb <= min_microbatch:
            raise RuntimeError(
                f"memory probe failed at the minimum microbatch "
                f"({min_microbatch} row(s)): the model does not fit "
                "device memory at any accumulation count")
        k = min(b, k * 2)
    if k == 1:
        return MemoryPlan(provenance="probe")   # whole batch fits
    # refine: the largest safe microbatch lies between the winner and
    # the last failure — one bisection trial narrows the bracket
    lo = -(-b // k)                       # known-safe rows
    hi = -(-b // max(k // 2, 1))          # known-failing rows
    mid = (lo + hi) // 2
    if mid > lo:
        k_mid = -(-b // mid)
        if k_mid < k and trial(k_mid):
            k = k_mid
            lo = -(-b // k_mid)
    return MemoryPlan(microbatch=lo, accum_steps=k, provenance="probe")
