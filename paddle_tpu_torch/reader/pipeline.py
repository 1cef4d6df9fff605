"""Supervised, self-healing data pipeline — the port of
``paddle_tpu/reader/pipeline.py``. Host-only Python, the same logic as
the JAX package's, on the port's journal, counters and named locks.

The reference's ingestion path (PyDataProvider2 + the DoubleBuffer
prefetch thread, paddle/gserver/dataproviders/DataProvider.h:249) died
or silently truncated an epoch on the first bad sample, hung source, or
crashed worker. A production trainer is input-bound as often as it is
compute-bound, so the pipeline itself must supervise its workers and
budget its errors (the MapReduce "skip bad records" discipline, Dean &
Ghemawat OSDI'04) instead of propagating them. Three pieces:

  ErrorBudget          — the per-sample quarantine lane: a raising
                         mapper / corrupt record is skipped, logged and
                         counted into utils/stats
                         (``pipeline/quarantined``); past ``max_bad``
                         the budget emits a DataFaultEvent and, with
                         ``on_bad="raise"``, aborts the epoch with
                         ErrorBudgetExceeded.
  supervised()         — wrap any Reader (+ optional per-sample mapper)
                         in a worker pool with a real lifecycle:
                         bounded prefetch queues, clean shutdown when
                         the consumer abandons the generator (no leaked
                         threads — every thread is named ``pt-data-*``
                         and exits on a shared stop event), a hung-
                         source watchdog with per-sample timeout, and
                         crashed-worker restart (in-flight sample
                         requeued, never lost) with a bounded restart
                         budget.
  CheckpointableReader — recordio/`task_reader`-style sources with a
                         resumable position: (epoch, shard, chunk,
                         record-offset) advances exactly with consumed
                         records, so trainer/checkpoint.py can save it
                         alongside pass/batch state and a SIGKILL'd
                         run resumes MID-PASS without re-reading or
                         dropping records.

Thread-naming contract: every thread this module (and the reader
decorators) spawns is named ``pt-data-...`` and exits on the run's stop
event, so an abandoned generator leaks none.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from paddle_tpu_torch.utils.logging import get_logger
from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.utils.stats import global_counters

__all__ = ["ErrorBudget", "ErrorBudgetExceeded", "supervised",
           "SupervisedReader", "CheckpointableReader", "THREAD_PREFIX"]

#: every pipeline thread name starts with this (the trainer's feed
#: prefetcher's too): a leak check keys on it
THREAD_PREFIX = "pt-data"

_STATE_KEYS = ("epoch", "shard", "chunk", "offset")


def _emit(on_event, kind: str, count: int, error=None, where=None):
    """Build + deliver a DataFaultEvent (lazy import: trainer.event must
    not be a hard import edge from the reader package). Every data
    fault also lands in the structured event journal
    (obs/events.py) regardless of handler."""
    from paddle_tpu_torch.obs.events import emit_event
    from paddle_tpu_torch.trainer.event import DataFaultEvent
    ev = DataFaultEvent(kind, count, error=error, where=where)
    emit_event(ev)
    if on_event is not None:
        on_event(ev)
    else:
        get_logger().warning("data pipeline fault: %r", ev)
    return ev


class ErrorBudgetExceeded(RuntimeError):
    """Raised (on_bad="raise") when quarantined samples exceed max_bad."""


class ErrorBudget:
    """The quarantine lane: count bad samples instead of propagating
    them, up to a budget.

    max_bad: quarantined samples tolerated. Exceeding it emits a
        DataFaultEvent(kind="data_budget") once and, with
        ``on_bad="raise"``, raises ErrorBudgetExceeded from the sample
        that crossed the line; ``on_bad="log"`` keeps skipping (the
        event/log is the alarm).
    stat: utils.stats.global_counters name each quarantined sample bumps
        (chaos tests diff it around an epoch).
    on_event: callable receiving the DataFaultEvent (e.g. the trainer's
        event handler); default logs.

    Thread-safe: source and worker threads record concurrently.
    """

    def __init__(self, max_bad: int = 100, on_bad: str = "log",
                 stat: str = "pipeline/quarantined",
                 on_event: Optional[Callable] = None):
        if on_bad not in ("log", "raise"):
            raise ValueError(f"on_bad must be 'log' or 'raise', "
                             f"got {on_bad!r}")
        if max_bad < 0:
            raise ValueError("max_bad must be >= 0")
        self.max_bad = max_bad
        self.on_bad = on_bad
        self.stat = stat
        self.on_event = on_event
        self._lock = named_lock("data.error_budget")
        self.bad = 0
        self.last_errors: collections.deque = collections.deque(maxlen=16)
        self._exhausted_emitted = False

    @property
    def exhausted(self) -> bool:
        return self.bad > self.max_bad

    def record(self, exc: BaseException, where: str = "") -> int:
        """Quarantine one bad sample. Returns the running bad count;
        raises ErrorBudgetExceeded when the budget is blown and
        on_bad="raise"."""
        with self._lock:
            self.bad += 1
            n = self.bad
            self.last_errors.append((where, repr(exc)))
            emit_exhausted = n > self.max_bad and not self._exhausted_emitted
            if emit_exhausted:
                self._exhausted_emitted = True
        global_counters.bump(self.stat)
        from paddle_tpu_torch.obs.events import emit as journal_emit
        journal_emit("data", "quarantine", count=n, where=where,
                     error=repr(exc)[:400])
        if n <= 3 or n % 50 == 0:
            get_logger().warning(
                "quarantined bad sample #%d at %s: %r", n, where, exc)
        if emit_exhausted:
            _emit(self.on_event, "data_budget", n, error=exc, where=where)
        if n > self.max_bad and self.on_bad == "raise":
            raise ErrorBudgetExceeded(
                f"error budget exhausted: {n} bad samples "
                f"(max_bad={self.max_bad}); last at {where}: "
                f"{exc!r}") from exc
        return n


def _stop_put(q: "_queue.Queue", item, stop: threading.Event) -> bool:
    """Blocking put that gives up when the pipeline is shutting down —
    the reason an abandoned generator can never wedge a fill thread on a
    full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


class SupervisedReader:
    """``supervised()``'s return value — a Reader with a lifecycle.

    Each call builds a fresh run: a source thread prefetching from
    ``reader()``, ``num_workers`` mapper threads (when a mapper is
    given), bounded queues, and a consumer-side watchdog. See
    :func:`supervised` for the knobs. When the source is checkpointable
    (CheckpointableReader-like) and delivery preserves source order
    (``order=True`` or no mapper), this reader is checkpointable too:
    ``state()`` tracks the position after the last *yielded* sample.
    """

    def __init__(self, reader: Callable, mapper: Optional[Callable] = None,
                 num_workers: int = 2, buffer_size: int = 16,
                 sample_timeout: Optional[float] = None,
                 error_budget: Optional[ErrorBudget] = None,
                 max_restarts: int = 4, on_stall: str = "warn",
                 stall_limit: int = 8, order: bool = False,
                 on_event: Optional[Callable] = None,
                 name: str = "pipeline"):
        if on_stall not in ("warn", "raise"):
            raise ValueError("on_stall must be 'warn' or 'raise'")
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self._reader = reader
        self._mapper = mapper
        self._num_workers = num_workers if mapper is not None else 0
        self._buffer_size = max(1, buffer_size)
        self._sample_timeout = sample_timeout
        self.error_budget = error_budget or ErrorBudget(on_event=on_event)
        if self.error_budget.on_event is None:
            self.error_budget.on_event = on_event
        self._max_restarts = max_restarts
        self._on_stall = on_stall
        self._stall_limit = stall_limit
        self._order = order
        self._on_event = on_event
        self._name = name
        # source-side quarantine: a CheckpointableReader without its own
        # budget shares this pipeline's, so decode errors and mapper
        # errors draw from ONE budget
        if getattr(reader, "error_budget", "missing") is None:
            reader.error_budget = self.error_budget
        self.checkpointable = (
            hasattr(reader, "state") and hasattr(reader, "set_state") and
            (order or mapper is None))
        self._cursor: Optional[Dict[str, int]] = None
        self.restarts = 0
        self.stalls = 0

    # -------------------------------------------------- checkpoint state
    def state(self) -> Dict[str, int]:
        """Position after the last yielded sample (delegates to the
        source before the first yield)."""
        if not self.checkpointable:
            raise TypeError(
                f"{self._name}: not checkpointable (source has no "
                "state()/set_state(), or order=False with a mapper)")
        return dict(self._cursor) if self._cursor is not None \
            else self._reader.state()

    def set_state(self, st: Dict[str, int]) -> None:
        if not self.checkpointable:
            raise TypeError(f"{self._name}: not checkpointable")
        self._reader.set_state(st)
        self._cursor = None

    # ------------------------------------------------------------- run
    def __call__(self) -> Iterable[Any]:
        return self._run()

    def _run(self):
        stop = threading.Event()
        out_q: "_queue.Queue" = _queue.Queue(self._buffer_size)
        in_q: "_queue.Queue" = _queue.Queue(self._buffer_size) \
            if self._mapper is not None else out_q
        src_busy: List[Optional[float]] = [None]
        budget = self.error_budget
        mapper = self._mapper
        track_pos = self.checkpointable
        name = self._name

        def source():
            try:
                it = iter(self._reader())
                i = 0
                while True:
                    src_busy[0] = time.monotonic()
                    try:
                        sample = next(it)
                    except StopIteration:
                        break
                    finally:
                        src_busy[0] = None
                    pos = self._reader.state() if track_pos else None
                    if mapper is None:
                        if not _stop_put(out_q, ("item", i, sample, pos),
                                         stop):
                            return
                    else:
                        if not _stop_put(in_q, ("item", i, sample, pos),
                                         stop):
                            return
                    i += 1
                _stop_put(out_q, ("send", i), stop)
            except BaseException as e:      # incl. ErrorBudgetExceeded
                _stop_put(out_q, ("err", e), stop)

        worker_busy: List[List[Optional[float]]] = []

        def work(wid: int, busy: List[Optional[float]]):
            while not stop.is_set():
                try:
                    msg = in_q.get(timeout=0.1)
                except _queue.Empty:
                    continue
                _, i, sample, pos = msg
                busy[0] = time.monotonic()
                try:
                    value = mapper(sample)
                except Exception as e:          # bad SAMPLE: quarantine
                    busy[0] = None
                    try:
                        budget.record(e, where=f"{name} sample #{i} "
                                               f"(mapper)")
                    except ErrorBudgetExceeded as bx:
                        _stop_put(out_q, ("err", bx), stop)
                        return
                    _stop_put(out_q, ("skip", i, pos), stop)
                    continue
                except BaseException as e:      # the WORKER crashed
                    busy[0] = None
                    # report death FIRST so the supervisor can spawn a
                    # replacement that drains in_q — requeueing first
                    # could deadlock a lone worker against a full queue
                    _stop_put(out_q, ("died", wid, e), stop)
                    _stop_put(in_q, ("item", i, sample, pos), stop)
                    return
                busy[0] = None
                if not _stop_put(out_q, ("item", i, value, pos), stop):
                    return

        threads = [threading.Thread(target=source, daemon=True,
                                    name=f"{THREAD_PREFIX}-{name}-src")]
        for w in range(self._num_workers):
            busy: List[Optional[float]] = [None]
            worker_busy.append(busy)
            threads.append(threading.Thread(
                target=work, args=(w, busy), daemon=True,
                name=f"{THREAD_PREFIX}-{name}-w{w}"))
        for t in threads:
            t.start()

        timeout = self._sample_timeout
        tick = min(max(timeout / 4.0, 0.05), 1.0) if timeout else 0.5
        stall_ticks = 0
        n_total = None
        completed = 0
        restarts = 0
        pending: Dict[int, Any] = {}
        skipped: Dict[int, Any] = {}   # idx -> pos (quarantined holes)
        next_i = 0
        self._cursor = None

        def stalled_where(now: float) -> List[str]:
            out = []
            b = src_busy[0]
            if b is not None and now - b > timeout:
                out.append(f"source ({now - b:.1f}s)")
            for w, busy in enumerate(worker_busy):
                b = busy[0]
                if b is not None and now - b > timeout:
                    out.append(f"worker {w} ({now - b:.1f}s)")
            return out

        try:
            while n_total is None or completed < n_total:
                try:
                    msg = out_q.get(timeout=tick)
                except _queue.Empty:
                    if timeout is None:
                        continue
                    where = stalled_where(time.monotonic())
                    if not where:
                        stall_ticks = 0
                        continue
                    stall_ticks += 1
                    self.stalls += 1
                    global_counters.bump("pipeline/stalls")
                    if stall_ticks == 1 or stall_ticks % 5 == 0:
                        get_logger().warning(
                            "%s: no sample for > %.2fs — stalled at %s "
                            "(tick %d)", name, timeout, ", ".join(where),
                            stall_ticks)
                        _emit(self._on_event, "source_stall", stall_ticks,
                              where=", ".join(where))
                    if self._on_stall == "raise" and \
                            stall_ticks >= self._stall_limit:
                        raise TimeoutError(
                            f"{name}: pipeline stalled for "
                            f"~{stall_ticks * tick:.1f}s at "
                            f"{', '.join(where)} (sample_timeout="
                            f"{timeout}s, on_stall='raise')")
                    continue
                stall_ticks = 0
                kind = msg[0]
                if kind == "send":
                    n_total = msg[1]
                elif kind == "err":
                    raise msg[1]
                elif kind == "died":
                    _, wid, exc = msg
                    restarts += 1
                    self.restarts = restarts
                    global_counters.bump("pipeline/worker_restarts")
                    get_logger().warning(
                        "%s: worker %d crashed (%r); in-flight sample "
                        "requeued; restart %d/%d", name, wid, exc,
                        restarts, self._max_restarts)
                    if restarts > self._max_restarts:
                        _emit(self._on_event, "restart_budget", restarts,
                              error=exc, where=f"{name} worker {wid}")
                        raise RuntimeError(
                            f"{name}: worker restart budget exhausted "
                            f"({restarts} > max_restarts="
                            f"{self._max_restarts})") from exc
                    _emit(self._on_event, "worker_restart", restarts,
                          error=exc, where=f"{name} worker {wid}")
                    busy = worker_busy[wid]
                    t = threading.Thread(
                        target=work, args=(wid, busy), daemon=True,
                        name=f"{THREAD_PREFIX}-{name}-w{wid}r{restarts}")
                    threads.append(t)
                    t.start()
                elif kind == "skip":
                    completed += 1
                    if self._order:
                        skipped[msg[1]] = msg[2]
                elif kind == "item":
                    _, i, value, pos = msg
                    completed += 1
                    if not self._order or mapper is None:
                        if track_pos:
                            self._cursor = pos
                        yield value
                    else:
                        pending[i] = (value, pos)
                # drain in-order deliveries (and skipped holes)
                if self._order and mapper is not None:
                    while True:
                        if next_i in skipped:
                            pos = skipped.pop(next_i)
                            if track_pos and pos is not None:
                                # the quarantined record is consumed:
                                # advance past it so a resume doesn't
                                # re-read (and re-count) it
                                self._cursor = pos
                            next_i += 1
                            continue
                        if next_i in pending:
                            value, pos = pending.pop(next_i)
                            next_i += 1
                            if track_pos:
                                self._cursor = pos
                            yield value
                            continue
                        break
            assert not pending, f"{name}: lost in-flight samples"
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)


def supervised(reader: Callable, mapper: Optional[Callable] = None,
               num_workers: int = 2, buffer_size: int = 16,
               sample_timeout: Optional[float] = None,
               error_budget: Optional[ErrorBudget] = None,
               max_restarts: int = 4, on_stall: str = "warn",
               stall_limit: int = 8, order: bool = False,
               on_event: Optional[Callable] = None,
               name: str = "pipeline") -> SupervisedReader:
    """Wrap ``reader`` (and an optional per-sample ``mapper``) in a
    supervised prefetch pipeline — the self-healing replacement for
    ``buffered``/``xmap_readers``.

    reader: a v2 Reader (zero-arg callable -> iterable of samples).
    mapper: optional per-sample transform run by ``num_workers``
        threads. A mapper raising an ``Exception`` quarantines THAT
        sample through the error budget; a worker dying on any other
        ``BaseException`` has its in-flight sample requeued and the
        worker replaced, up to ``max_restarts``.
    buffer_size: bound of the prefetch queues — backpressure, and the
        shutdown guarantee: an abandoned generator stops the fill
        threads instead of leaking them against a full queue.
    sample_timeout: hung-source watchdog period (seconds per sample).
        A source/worker stuck past it logs, bumps the
        ``pipeline/stalls`` counter and emits
        DataFaultEvent(kind="source_stall"); with ``on_stall="raise"``
        the consumer gets a TimeoutError after ``stall_limit``
        consecutive stalled ticks instead of hanging forever. ``None``
        disables the watchdog.
    error_budget: shared ErrorBudget (default: a fresh
        ``ErrorBudget(max_bad=100, on_bad="log")``). A source with
        ``error_budget=None`` (CheckpointableReader) adopts it, so
        decode and mapper errors draw from one budget.
    order: deliver mapper outputs in source order (needed for
        checkpointability through a mapper).
    on_event: receives each DataFaultEvent (e.g. the trainer's event
        handler); default logs.
    """
    return SupervisedReader(
        reader, mapper=mapper, num_workers=num_workers,
        buffer_size=buffer_size, sample_timeout=sample_timeout,
        error_budget=error_budget, max_restarts=max_restarts,
        on_stall=on_stall, stall_limit=stall_limit, order=order,
        on_event=on_event, name=name)


class CheckpointableReader:
    """RecordIO sample reader with a resumable position.

    Yields (deserialized) records of ``paths`` (a path, comma-separated
    string, or list — the ``creator.recordio`` contract) while tracking
    the exact position (epoch, shard, chunk, record-offset) AFTER the
    last yielded sample: ``state()`` is always safe to save, and
    ``set_state()`` makes the next iteration resume mid-pass without
    re-reading or dropping consumed records. ``trainer/checkpoint.py``
    saves this state alongside pass/batch state when the train
    reader is checkpointable (``reader.batch`` propagates it).

    error_budget: quarantine lane for records that fail to deserialize
        (corrupt pickled records): counted + skipped, position still
        advances. ``None`` re-raises (strict mode) — ``supervised()``
        injects its own budget into a reader left at None.
    skip_corrupt_chunks: forward to recordio.read_chunk — crc-level
        corruption drops the chunk (counted separately in
        ``corrupt_chunks_skipped``), record-level corruption is this
        class's per-sample lane.
    use_native: the recordio codec (reader/recordio.py): None the
        native one where it builds, True the native one or an error.
    """

    def __init__(self, paths, deserialize: Optional[Callable] = "pickle",
                 error_budget: Optional[ErrorBudget] = None,
                 skip_corrupt_chunks: bool = False,
                 use_native: Optional[bool] = None):
        if isinstance(paths, str):
            paths = paths.split(",")
        self.paths = [p for p in paths if p]
        if not self.paths:
            raise ValueError("CheckpointableReader needs >= 1 shard path")
        if deserialize == "pickle":
            from paddle_tpu_torch.dataset.common import record_deserializer
            deserialize = record_deserializer
        self._deserialize = deserialize
        self.error_budget = error_budget
        self._skip_corrupt_chunks = skip_corrupt_chunks
        self._use_native = use_native
        self._epoch = 0
        self._pending: Optional[Dict[str, int]] = None
        self._cursor = {"epoch": 0, "shard": 0, "chunk": 0, "offset": 0}

    def state(self) -> Dict[str, int]:
        """Position of the next unconsumed record."""
        return dict(self._cursor)

    def set_state(self, st: Dict[str, int]) -> None:
        missing = [k for k in _STATE_KEYS if k not in st]
        if missing:
            raise ValueError(f"reader state missing keys {missing}; "
                             f"expected {list(_STATE_KEYS)}")
        pend = {k: int(st[k]) for k in _STATE_KEYS}
        if any(v < 0 for v in pend.values()):
            raise ValueError(f"reader state must be non-negative: {pend}")
        if pend["shard"] >= len(self.paths):
            raise ValueError(
                f"reader state shard {pend['shard']} out of range for "
                f"{len(self.paths)} shard(s) — was the shard list "
                "reordered or truncated since the checkpoint?")
        self._pending = pend
        self._cursor = dict(pend)   # state() reflects the seek at once

    def __call__(self) -> Iterable[Any]:
        start = self._pending or {"epoch": self._epoch, "shard": 0,
                                  "chunk": 0, "offset": 0}
        self._pending = None
        return self._iter(start)

    def _iter(self, start: Dict[str, int]):
        from paddle_tpu_torch.reader import recordio as rio
        epoch = start["epoch"]
        self._epoch = epoch
        self._cursor = dict(start)
        s0, c0, o0 = start["shard"], start["chunk"], start["offset"]
        for s in range(s0, len(self.paths)):
            path = self.paths[s]
            n_chunks = rio.num_chunks(path, use_native=self._use_native)
            for k in range(c0 if s == s0 else 0, n_chunks):
                recs = rio.read_chunk(
                    path, k, use_native=self._use_native,
                    skip_corrupt=self._skip_corrupt_chunks)
                first = o0 if (s == s0 and k == c0) else 0
                for j in range(first, len(recs)):
                    nxt = {"epoch": epoch, "shard": s, "chunk": k,
                           "offset": j + 1}
                    if self._deserialize is None:
                        self._cursor = nxt
                        yield recs[j]
                        continue
                    try:
                        val = self._deserialize(recs[j])
                    except Exception as e:
                        # the record is consumed either way — quarantine
                        # advances the position so a resume cannot
                        # re-trip on it forever
                        self._cursor = nxt
                        if self.error_budget is None:
                            raise
                        self.error_budget.record(
                            e, where=f"{path} chunk {k} record {j}")
                        continue
                    self._cursor = nxt
                    yield val
        self._epoch = epoch + 1
        self._cursor = {"epoch": self._epoch, "shard": 0, "chunk": 0,
                        "offset": 0}
