"""Reader creators and decorators — the port of
``paddle_tpu/reader/__init__.py`` (python/paddle/v2/reader parity): a
*reader* is a zero-argument callable returning an iterable of samples;
the decorators compose (map_readers, buffered, shuffle, compose, chain,
firstn, xmap_readers, cache), and ``batch`` groups samples into lists.

Host-only Python, the same code as the JAX package's, so both packages
yield the same samples in the same order (``shuffle`` draws from
``random.Random(seed)``). The checkpointable batch reader,
``pipeline.py``, ``provider.py`` and ``recordio.py`` are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import itertools
import random as _random
import threading
import queue as _queue
from typing import Any, Callable, Iterable, List

Reader = Callable[[], Iterable[Any]]


def batch(reader: Reader, batch_size: int, drop_last: bool = False) -> Reader:
    """paddle.batch: sample reader -> batch reader."""

    def batch_reader():
        buf: List[Any] = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batch_reader


def shuffle(reader: Reader, buf_size: int, seed=None) -> Reader:
    def shuffled():
        rng = _random.Random(seed)
        buf: List[Any] = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        rng.shuffle(buf)
        for s in buf:
            yield s
    return shuffled


def map_readers(func, *readers: Reader) -> Reader:
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


class ComposeNotAligned(ValueError):
    """Raised when composed readers yield different sample counts
    (python/paddle/v2/reader/decorator.py:90)."""


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip several readers into tuple samples (reader.compose parity).

    With ``check_alignment`` (the default, as the reference), readers of
    unequal length raise ComposeNotAligned instead of silently truncating
    to the shortest (decorator.py:98 _check_input_not_empty zip)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    _end = object()

    def reader():
        its = [r() for r in readers]
        if not check_alignment:
            for items in zip(*its):
                yield sum((make_tuple(i) for i in items), ())
            return
        for items in itertools.zip_longest(*its, fillvalue=_end):
            if any(i is _end for i in items):
                if not all(i is _end for i in items):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                return
            yield sum((make_tuple(i) for i in items), ())
    return reader


def chain(*readers: Reader) -> Reader:
    def reader():
        return itertools.chain(*[r() for r in readers])
    return reader


def firstn(reader: Reader, n: int) -> Reader:
    def limited():
        return itertools.islice(reader(), n)
    return limited


def _shutdown_put(q: "_queue.Queue", item, stop: threading.Event) -> bool:
    """Bounded-queue put that bails once the consumer shut the reader
    down — a fill thread must never block forever against a full queue
    after the consumer abandoned the generator."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def buffered(reader: Reader, size: int) -> Reader:
    """Async prefetch via a background thread — the DoubleBuffer equivalent
    (paddle/gserver/dataproviders/DataProvider.h:249).

    A source exception re-raises in the CONSUMER at the point it
    occurred (never a silently truncated epoch), and abandoning the
    generator mid-epoch (break / close()) stops the fill thread instead
    of leaking it against a full queue."""

    def buffered_reader():
        q: _queue.Queue = _queue.Queue(maxsize=size)
        stop = threading.Event()

        def fill():
            try:
                for sample in reader():
                    if not _shutdown_put(q, ("item", sample), stop):
                        return
                _shutdown_put(q, ("end", None), stop)
            except BaseException as e:    # re-raised by the consumer
                _shutdown_put(q, ("err", e), stop)

        t = threading.Thread(target=fill, daemon=True,
                             name="pt-data-buffered")
        t.start()
        try:
            while True:
                kind, val = q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise val
                yield val
        finally:
            stop.set()
            t.join(timeout=1.0)
    return buffered_reader


def xmap_readers(mapper, reader: Reader, process_num: int,
                 buffer_size: int, order: bool = False) -> Reader:
    """Apply `mapper` to samples with `process_num` worker threads
    (reader.decorator.xmap_readers parity, decorator.py:233 — the
    reference's "processes" are threads too). order=True preserves the
    input order; otherwise samples come out as workers finish.

    A worker/source exception re-raises in the consumer AT the failing
    sample — not after the whole epoch drains — and abandoning the
    generator early shuts the feed/worker threads down instead of
    deadlocking them on full queues."""

    def xreader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)
        stop = threading.Event()

        def feed():
            try:
                for i, s in enumerate(reader()):
                    if not _shutdown_put(in_q, ("item", i, s), stop):
                        return
                for _ in range(process_num):
                    if not _shutdown_put(in_q, ("end",), stop):
                        return
            except BaseException as e:
                _shutdown_put(out_q, ("err", e), stop)

        def work():
            while not stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except _queue.Empty:
                    continue
                if item[0] == "end":
                    _shutdown_put(out_q, ("wend",), stop)
                    return
                _, i, s = item
                try:
                    v = mapper(s)
                except BaseException as e:   # surfaced NOW, not at drain
                    _shutdown_put(out_q, ("err", e), stop)
                    return
                if not _shutdown_put(out_q, ("item", i, v), stop):
                    return

        threads = [threading.Thread(target=feed, daemon=True,
                                    name="pt-data-xmap-feed")] + \
            [threading.Thread(target=work, daemon=True,
                              name=f"pt-data-xmap-w{w}")
             for w in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        pending = {}
        next_i = 0
        try:
            while finished < process_num:
                item = out_q.get()
                if item[0] == "wend":
                    finished += 1
                    continue
                if item[0] == "err":
                    raise item[1]
                _, i, v = item
                if not order:
                    yield v
                else:
                    pending[i] = v
                    while next_i in pending:
                        yield pending.pop(next_i)
                        next_i += 1
            # order mode: indices are dense, so nothing can stay pending
            assert not pending, "xmap_readers lost samples"
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)

    return xreader


def cache(reader: Reader) -> Reader:
    data: List[Any] = []
    filled = [False]

    def cached():
        if not filled[0]:
            data.extend(reader())
            filled[0] = True
        return iter(data)
    return cached


class creator:
    """reader.creator parity: build readers from arrays and text files
    (``recordio`` and ``cloud_reader`` wait for the reader pipeline,
    ROADMAP.md)."""

    @staticmethod
    def np_array(arr) -> Reader:
        def reader():
            for row in arr:
                yield row
        return reader

    @staticmethod
    def text_file(path: str) -> Reader:
        def reader():
            with open(path) as f:
                for line in f:
                    yield line.rstrip("\n")
        return reader
