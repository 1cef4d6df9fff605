"""Structured event journal — the port of ``paddle_tpu/obs/events.py``:
one queryable record of everything that went wrong (and the
recoveries that followed).

Every fault-ish event flows through ONE versioned-schema sink:

- a per-process JSONL file (``JOURNAL.configure(path)`` — CLI
  ``serve --event_log``), one JSON object per line, append-only,
  crash-tolerant (a torn final line is skipped by the reader), with
  size-based rotation;
- an in-memory ring (``tail()``) served over HTTP as ``GET /events``
  by the serving front (serving/http.py), with ``since_seq`` paging.

Schema v1, the JAX package's own — every record carries:

    v       int     schema version (1)
    ts      float   unix seconds
    seq     int     per-process monotonic sequence number
    pid     int     emitting process
    domain  str     serving | engine | slo | profile | lockdep | ...
    kind    str     e.g. shed, breaker, drain, hop, preemption,
                    step_failure, prefix_evict, page_spill,
                    page_restore, breach, step_regression, window,
                    inversion

plus the correlation IDs — ``run_id`` and ``host`` on every record
(obs/context.py), ``trace_id`` / ``step`` when the emitting thread has
one bound — and free-form kind-specific fields (JSON scalars;
non-serializable values are repr()'d at emit time). Emission never
takes down a hot path: file-write failures are counted and warned
once, not raised; observer failures (the flight recorder's auto-dump
hook) are swallowed the same way.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable, Iterator, List, Optional, Tuple

from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.analysis.lockdep import named_lock
from paddle_tpu_torch.utils.logging import get_logger

__all__ = ["SCHEMA_VERSION", "REQUIRED_FIELDS", "RESERVED_FIELDS",
           "EventJournal", "JOURNAL",
           "emit", "emit_event", "tail", "validate", "read_journal",
           "journal_segments"]

SCHEMA_VERSION = 1
REQUIRED_FIELDS = ("v", "ts", "seq", "pid", "domain", "kind")
#: field names emit() REJECTS — they would collide with the envelope
#: keys the journal stamps itself (run_id/host ride in from
#: obs/context.py and must not be spoofed per-record either)
RESERVED_FIELDS = frozenset(("v", "ts", "seq", "pid", "run_id",
                             "host"))


def _jsonable(v):
    """Clamp one field value to something json.dumps accepts."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def validate(rec: dict) -> dict:
    """Raise ValueError unless ``rec`` is a schema-valid v1 record;
    returns it unchanged so readers can chain."""
    if not isinstance(rec, dict):
        raise ValueError(f"event record must be an object, got "
                         f"{type(rec).__name__}")
    missing = [k for k in REQUIRED_FIELDS if k not in rec]
    if missing:
        raise ValueError(f"event record missing required fields "
                         f"{missing}: {rec!r}")
    if int(rec["v"]) != SCHEMA_VERSION:
        raise ValueError(f"unknown event schema version {rec['v']!r} "
                         f"(this reader speaks v{SCHEMA_VERSION})")
    for key in ("domain", "kind"):
        if not isinstance(rec[key], str) or not rec[key]:
            raise ValueError(f"event {key!r} must be a non-empty "
                             f"string: {rec!r}")
    for key in ("ts",):
        if not isinstance(rec[key], (int, float)):
            raise ValueError(f"event {key!r} must be numeric: {rec!r}")
    for key in ("seq", "pid"):
        if not isinstance(rec[key], int):
            raise ValueError(f"event {key!r} must be an int: {rec!r}")
    return rec


#: configure() sentinel — "leave this rotation knob as it was"
_UNSET = object()


class EventJournal:
    """Thread-safe ring + optional JSONL file sink (see module doc).

    With ``max_bytes`` set the file sink rotates size-based with
    bounded retention: when the active file exceeds ``max_bytes`` it is
    renamed to ``<path>.1`` (existing segments shift to ``.2``…,
    anything past ``keep`` is deleted) and a fresh active file opens —
    a long serving run's journal is bounded at roughly
    ``(keep + 1) * max_bytes``. ``read_journal`` transparently spans
    the rotated segments."""

    def __init__(self, ring_size: int = 2048,
                 max_bytes: Optional[int] = None, keep: int = 3):
        self._lock = named_lock("obs.journal")
        self._ring: deque = deque(maxlen=int(ring_size))
        self._seq = 0
        self._fh = None
        self._path: Optional[str] = None
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._keep = max(0, int(keep))
        self._sink_bytes = 0
        self._rotations = 0
        self._write_errors = 0
        self._observers: List[Callable[[dict], None]] = []
        self._observer_errors = 0

    @property
    def path(self) -> Optional[str]:
        with self._lock:
            return self._path

    @property
    def rotations(self) -> int:
        with self._lock:
            return self._rotations

    def configure(self, path: Optional[str],
                  max_bytes=_UNSET, keep=_UNSET) -> None:
        """Attach (or with ``None`` detach) the JSONL file sink. The
        file opens append-mode so a resumed run extends its journal.
        ``max_bytes``/``keep`` set the rotation policy when passed and
        are left untouched otherwise."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            if max_bytes is not _UNSET:
                self._max_bytes = int(max_bytes) if max_bytes else None
            if keep is not _UNSET:
                self._keep = max(0, int(keep))
            self._path = path
            self._sink_bytes = 0
            if path:
                d = os.path.dirname(os.path.abspath(path))
                os.makedirs(d, exist_ok=True)
                self._fh = open(path, "a", encoding="utf-8")
                try:
                    self._sink_bytes = os.path.getsize(path)
                except OSError:
                    self._sink_bytes = 0

    def _rotate_locked(self) -> None:
        """Shift ``path -> path.1 -> … -> path.keep`` (dropping the
        oldest) and reopen a fresh active file. Called with the lock
        held, right after the write that crossed ``max_bytes``; any
        filesystem failure is absorbed into write_errors (journal
        emission never raises into a hot path)."""
        path = self._path
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        try:
            drop = f"{path}.{self._keep}" if self._keep else path
            if os.path.exists(drop):
                os.remove(drop)
            for i in range(self._keep - 1, 0, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            if self._keep:
                os.replace(path, f"{path}.1")
            self._rotations += 1
        except OSError:
            self._write_errors += 1
        try:
            self._fh = open(path, "a", encoding="utf-8")
            self._sink_bytes = os.path.getsize(path)
        except OSError:
            self._write_errors += 1
            self._sink_bytes = 0

    def emit(self, domain: str, kind: str, **fields) -> dict:
        """Build, ring-buffer, and (when configured) persist one
        record. Never raises into the caller's hot path ONCE the call
        is well-formed — a failed file write is counted and warned
        once; a malformed call (empty/non-str domain or kind, or a
        field colliding with an envelope key) raises immediately,
        because a record that silently overwrote its own seq/run_id
        would poison every downstream consumer. Correlation IDs
        (run_id/host always; trace_id/step when bound on the emitting
        thread — obs/context.py) are stamped unless the caller passed
        its own."""
        if not isinstance(domain, str) or not domain:
            raise ValueError(
                f"journal domain must be a non-empty str, got "
                f"{domain!r}")
        if not isinstance(kind, str) or not kind:
            raise ValueError(
                f"journal kind must be a non-empty str, got {kind!r}")
        reserved = RESERVED_FIELDS.intersection(fields)
        if reserved:
            raise ValueError(
                f"journal fields {sorted(reserved)} collide with "
                f"envelope keys (reserved: "
                f"{sorted(RESERVED_FIELDS)})")
        rec = {"v": SCHEMA_VERSION, "ts": time.time(),
               "pid": os.getpid(), "domain": domain, "kind": kind}
        for k, v in obs_context.current_fields().items():
            if k not in fields:
                rec[k] = _jsonable(v)
        for k, v in fields.items():
            if k not in rec and v is not None:
                rec[k] = _jsonable(v)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            observers = list(self._observers)
            if self._fh is not None:
                try:
                    line = json.dumps(rec) + "\n"
                    self._fh.write(line)
                    self._fh.flush()
                    self._sink_bytes += len(line)
                    if self._max_bytes is not None \
                            and self._sink_bytes >= self._max_bytes:
                        self._rotate_locked()
                except (OSError, ValueError):
                    self._write_errors += 1
                    if self._write_errors == 1:
                        get_logger().warning(
                            "event journal write to %s failed; further "
                            "failures counted silently "
                            "(journal/write_errors)", self._path)
        # observers run OUTSIDE the lock: the flight recorder's
        # auto-dump reads tail() back through it
        for fn in observers:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — emission never raises
                with self._lock:
                    self._observer_errors += 1
                    first = self._observer_errors == 1
                if first:
                    get_logger().warning(
                        "event journal observer %r failed; further "
                        "failures counted silently", fn)
        return rec

    def emit_event(self, event) -> dict:
        """Journal a trainer-event object (trainer/event.py) in its
        canonical shape (:func:`record_fields`)."""
        domain, kind, fields = record_fields(event)
        return self.emit(domain, kind, **fields)

    def tail(self, n: int = 100, domain: Optional[str] = None,
             kind: Optional[str] = None,
             since_seq: Optional[int] = None) -> List[dict]:
        """Newest-last slice of the in-memory ring, optionally
        filtered. With ``since_seq`` the semantics flip to a CURSOR:
        the OLDEST ``n`` matching records with seq > since_seq, so a
        scraper pages forward (``GET /events?since_seq=``) without
        re-reading the ring from the start — resume from the last
        record's seq."""
        with self._lock:
            recs = list(self._ring)
        if domain is not None:
            recs = [r for r in recs if r["domain"] == domain]
        if kind is not None:
            recs = [r for r in recs if r["kind"] == kind]
        if since_seq is not None:
            return [r for r in recs if r["seq"] > int(since_seq)][:int(n)]
        return recs[-int(n):]

    @property
    def last_seq(self) -> int:
        """The newest seq handed out — the ``since_seq`` cursor a
        scraper resumes from."""
        with self._lock:
            return self._seq

    def add_observer(self, fn: Callable[[dict], None]) -> None:
        """``fn(rec)`` is called after every emit (outside the journal
        lock). The flight recorder registers here (obs/__init__.py)."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    @property
    def write_errors(self) -> int:
        with self._lock:
            return self._write_errors

    def reset(self) -> None:
        """Detach the sink and clear the ring. Observers survive: the
        flight-recorder wiring is process topology, not state."""
        self.configure(None)
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._write_errors = 0
            self._observer_errors = 0
            self._rotations = 0
            self._max_bytes = None
            self._keep = 3


#: the process-global journal every subsystem emits through
JOURNAL = EventJournal()


def emit(domain: str, kind: str, **fields) -> dict:
    return JOURNAL.emit(domain, kind, **fields)


def emit_event(event) -> dict:
    return JOURNAL.emit_event(event)


def tail(n: int = 100, domain: Optional[str] = None,
         kind: Optional[str] = None,
         since_seq: Optional[int] = None) -> List[dict]:
    return JOURNAL.tail(n, domain=domain, kind=kind,
                        since_seq=since_seq)


def record_fields(event) -> Tuple[str, str, dict]:
    """(domain, kind, fields) for a trainer-event object, the JAX
    package's record shapes: the v2 loop's events and the fault events
    of trainer/event.py (FaultEvent, OOMEvent, DataFaultEvent), which
    the guarded step, the adaptive microbatcher and the reader pipeline
    journal. Import is function-level so obs never becomes a hard
    import edge into the trainer package."""
    from paddle_tpu_torch.trainer import event as evt
    if isinstance(event, evt.OOMEvent):
        return "trainer", "oom", {
            "pass_id": event.pass_id, "batch_id": event.batch_id,
            "microbatch": event.microbatch,
            "accum_steps": event.accum_steps,
            "error": _err_str(event.error)}
    if isinstance(event, evt.DataFaultEvent):
        return "data", event.kind, {
            "count": event.count, "where": event.where,
            "error": _err_str(event.error)}
    if isinstance(event, evt.FaultEvent):
        return "trainer", event.kind, {
            "pass_id": event.pass_id, "batch_id": event.batch_id,
            "bad_streak": event.bad_streak,
            "restored_step": event.restored_step}
    return "trainer", type(event).__name__, {
        k: _jsonable(v) for k, v in vars(event).items()
        if not k.startswith("_")}


def _err_str(e) -> Optional[str]:
    return None if e is None else repr(e)[:400]


def journal_segments(path: str) -> List[str]:
    """Every on-disk file of a (possibly rotated) journal, oldest
    first: ``path.N … path.1`` then the active ``path``. Segments are
    contiguous by construction (EventJournal._rotate_locked)."""
    rotated: List[str] = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        rotated.append(f"{path}.{i}")
        i += 1
    return list(reversed(rotated)) + [path]


def read_journal(path: str, strict: bool = True,
                 domain: Optional[str] = None,
                 kind: Optional[str] = None) -> Iterator[dict]:
    """Yield schema-validated records from a JSONL journal, spanning
    rotated segments (``path.N`` oldest … ``path``) transparently. A
    torn FINAL line (the process died mid-write; only possible in the
    active file) is always skipped; any other malformed line raises
    with ``strict`` and is skipped with a warning otherwise.
    ``domain``/``kind`` filter with the SAME semantics as
    ``EventJournal.tail``, so ring and file queries agree."""
    segments = journal_segments(path)
    for seg in segments:
        last_seg = seg == path
        try:
            with open(seg, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            if last_seg:
                raise
            continue  # rotated away between listing and open
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = validate(json.loads(line))
            except (json.JSONDecodeError, ValueError) as e:
                if last_seg and i == len(lines) - 1:
                    get_logger().warning(
                        "journal %s: skipping torn final line", seg)
                    return
                if strict:
                    raise ValueError(
                        f"{seg}:{i + 1}: malformed journal record: {e}"
                    ) from e
                get_logger().warning(
                    "journal %s:%d: skipping malformed record: %s",
                    seg, i + 1, e)
                continue
            if domain is not None and rec["domain"] != domain:
                continue
            if kind is not None and rec["kind"] != kind:
                continue
            yield rec
