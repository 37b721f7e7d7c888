"""``paddle.batch`` and the ``paddle.reader`` decorators (counterpart of
``paddle_tpu/reader.py``; reference: python/paddle/batch.py,
python/paddle/reader/decorator.py): ``batch``, ``cache``,
``map_readers``, ``shuffle``, ``chain``, ``compose``, ``buffered``,
``firstn``, ``xmap_readers`` and ``ComposeNotAligned``.

Plain generator combinators over readers (callables returning an
iterator), with no device work. ``buffered`` and ``xmap_readers`` run
threads, as the reference's do: every thread is a daemon, and each ends
with its reader, whether the consumer runs it to its end or closes it
early (the consumer's ``close``, or dropping a half-read generator, sets
a stop flag the threads poll while they wait on their queues, and then
joins them). An error in the reader or the mapper surfaces in the
consumer; output is never silently cut short.
"""
from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading

__all__ = ["batch", "cache", "map_readers", "shuffle", "chain", "compose",
           "buffered", "firstn", "xmap_readers", "ComposeNotAligned"]

#: how long a reader thread waits on a queue before it checks its stop
#: flag again, in seconds
_POLL_S = 0.05
#: how long a closing consumer waits for its threads to end, in seconds
_JOIN_S = 10.0


class ComposeNotAligned(ValueError):
    """reference: decorator.py ComposeNotAligned: ``compose`` inputs of
    different lengths with ``check_alignment=True``."""


def batch(reader, batch_size, drop_last=False):
    """reference: batch.py:18: instances grouped into lists."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def cache(reader):
    """reference: decorator.py:51: read once, replay from memory. A pass
    that raises part-way is not kept, so a retry reads from the start."""
    state = {}

    def cached():
        if "data" not in state:
            state["data"] = list(reader())
        yield from state["data"]
    return cached


def map_readers(func, *readers):
    """reference: decorator.py:91: ``func`` over the zipped readers."""

    def reader():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """reference: decorator.py:133: shuffled in windows of ``buf_size``
    (Python's ``random``)."""

    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return shuffled


def chain(*readers):
    """reference: decorator.py:182: the readers one after another."""

    def chained():
        return itertools.chain(*[r() for r in readers])
    return chained


def compose(*readers, **kwargs):
    """reference: decorator.py:247: the readers zipped into flat tuples;
    with ``check_alignment`` (default) readers of different lengths
    raise :class:`ComposeNotAligned`, else the output stops at the
    shortest."""
    check_alignment = kwargs.pop("check_alignment", True)
    end = object()

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*rs, fillvalue=end):
                if any(o is end for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
    return composed


class _End:
    """The end-of-stream marker on a reader thread's queue."""


def _put(q, item, stop):
    """``q.put(item)`` unless ``stop`` is set first; True if it went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except _queue.Full:
            pass
    return False


def _get(q, stop):
    """``q.get()`` unless ``stop`` is set first (then :class:`_End`)."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except _queue.Empty:
            pass
    return _End


def _close(it):
    close = getattr(it, "close", None) if it is not None else None
    if close is not None:
        close()


def _finish(stop, threads):
    stop.set()
    for t in threads:
        t.join(_JOIN_S)


def buffered(reader, size):
    """reference: decorator.py:307: a daemon thread reads ahead into a
    queue of ``size``."""

    def buffered_reader():
        q = _queue.Queue(maxsize=size)
        stop = threading.Event()
        err = []

        def fill():
            it = None
            try:
                it = reader()
                for d in it:
                    if not _put(q, d, stop):
                        return
            except BaseException as e:   # surfaced in the consumer
                err.append(e)
            finally:
                _close(it)
                _put(q, _End, stop)
        t = threading.Thread(target=fill, daemon=True,
                             name="reader.buffered")
        t.start()
        try:
            while True:
                e = _get(q, stop)
                if e is _End:
                    if err:
                        raise err[0]
                    return
                yield e
        finally:
            _finish(stop, [t])
    return buffered_reader


def firstn(reader, n):
    """reference: decorator.py:366: the first ``n`` items."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                return
            yield item
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """reference: decorator.py:411: ``mapper`` over the reader in
    ``process_num`` daemon threads (the mapper is usually NumPy work that
    releases the interpreter lock); ``order=True`` keeps the reader's
    order."""

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)
        stop = threading.Event()
        errs = []

        def feed():
            it = None
            try:
                it = reader()
                for i, d in enumerate(it):
                    if not _put(in_q, (i, d), stop):
                        return
            except BaseException as e:
                errs.append(e)
            finally:
                _close(it)
                for _ in range(process_num):
                    _put(in_q, _End, stop)

        def work():
            try:
                while True:
                    item = _get(in_q, stop)
                    if item is _End:
                        return
                    i, d = item
                    if not _put(out_q, (i, mapper(d)), stop):
                        return
            except BaseException as e:
                errs.append(e)
            finally:
                _put(out_q, _End, stop)     # always release the consumer

        threads = [threading.Thread(target=feed, daemon=True,
                                    name="reader.xmap.feed")]
        threads += [threading.Thread(target=work, daemon=True,
                                     name=f"reader.xmap.{k}")
                    for k in range(process_num)]
        for t in threads:
            t.start()
        try:
            finished, pending, next_i = 0, {}, 0
            while finished < process_num:
                item = _get(out_q, stop)
                if item is _End:
                    finished += 1
                    continue
                i, d = item
                if not order:
                    yield d
                    continue
                pending[i] = d
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
            if errs:
                raise errs[0]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        finally:
            _finish(stop, threads)
    return xreader
