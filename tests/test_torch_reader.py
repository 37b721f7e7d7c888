"""The port's reader decorators (``reader.py``) against the JAX
package's on the CPU: every decorator's output on the same readers
(``shuffle`` under one ``random.seed``), misaligned ``compose`` and
errors in a reader or a mapper surfacing, a partial ``cache`` pass not
kept; and the threads of ``buffered`` and ``xmap_readers`` ending with
their reader, whether it is read to its end or closed early."""
import random
import threading
import time

import numpy as np
import pytest

import paddle_tpu.reader as JR
import paddle_tpu_torch as P
import paddle_tpu_torch.reader as PR


def _r(n=10, start=0):
    def reader():
        for i in range(start, start + n):
            yield i
    return reader


def _pairs(n=6):
    def reader():
        for i in range(n):
            yield (i, np.float32(i) / 2)
    return reader


def _cases():
    return [
        ("batch", lambda R: R.batch(_r(10), 3)),
        ("batch_drop_last", lambda R: R.batch(_r(10), 3, drop_last=True)),
        ("cache", lambda R: R.cache(_r(5))),
        ("map_readers", lambda R: R.map_readers(lambda a, b: a * 10 + b,
                                                _r(5), _r(7, 3))),
        ("shuffle", lambda R: R.shuffle(_r(23), 5)),
        ("chain", lambda R: R.chain(_r(3), _r(4, 10), _pairs(2))),
        ("compose", lambda R: R.compose(_r(4), _pairs(4))),
        ("compose_unchecked", lambda R: R.compose(_r(6), _pairs(4),
                                                  check_alignment=False)),
        ("buffered", lambda R: R.buffered(_r(50), 4)),
        ("firstn", lambda R: R.firstn(_r(10), 4)),
        ("xmap_ordered", lambda R: R.xmap_readers(lambda v: v * v, _r(40), 3,
                                                  5, order=True)),
        ("batch_of_shuffled_buffered", lambda R: R.batch(R.shuffle(
            R.buffered(_r(30), 3), 7), 4)),
    ]


@pytest.mark.parametrize("name,make", _cases(), ids=[n for n, _ in _cases()])
def test_decorator_matches_jax(name, make):
    out = []
    for R in (PR, JR):
        random.seed(3)
        out.append([repr(x) for x in make(R)()])
    assert out[0] == out[1]
    if name == "cache":
        reader = make(PR)
        assert list(reader()) == list(reader()) == [0, 1, 2, 3, 4]


def test_xmap_unordered_yields_every_mapped_item():
    got = sorted(PR.xmap_readers(lambda v: v + 1, _r(30), 4, 3)())
    assert got == list(range(1, 31))


def test_compose_misaligned_raises():
    with pytest.raises(PR.ComposeNotAligned):
        list(PR.compose(_r(3), _r(4))())


@pytest.mark.parametrize("wrap", ["buffered", "xmap"])
def test_errors_surface_and_do_not_truncate(wrap):
    def bad_reader():
        yield 1
        yield 2
        raise IOError("disk gone")

    def bad_mapper(v):
        if v == 3:
            raise ValueError("mapper failed")
        return v
    if wrap == "buffered":
        r, exc = PR.buffered(bad_reader, 2), IOError
    else:
        r, exc = PR.xmap_readers(bad_mapper, _r(8), 2, 2, order=True), \
            ValueError
    with pytest.raises(exc):
        list(r())


def test_cache_keeps_no_partial_pass():
    calls = []

    def flaky():
        calls.append(1)
        yield 1
        if len(calls) == 1:
            raise IOError("first pass fails")
        yield 2
    reader = PR.cache(flaky)
    with pytest.raises(IOError):
        list(reader())
    assert list(reader()) == [1, 2] and list(reader()) == [1, 2]


def _reader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("reader.")]


def _wait_gone(timeout=10.0):
    end = time.monotonic() + timeout
    while _reader_threads() and time.monotonic() < end:
        time.sleep(0.02)
    return _reader_threads()


@pytest.mark.parametrize("make", [
    lambda: PR.buffered(_r(10_000), 2),
    lambda: PR.xmap_readers(lambda v: v, _r(10_000), 3, 2),
    lambda: PR.xmap_readers(lambda v: v, _r(10_000), 3, 2, order=True),
], ids=["buffered", "xmap", "xmap_ordered"])
def test_threads_end_with_a_reader_closed_early(make):
    """The consumer stops after 3 items of 10,000 and closes the
    generator: every daemon thread of the reader ends."""
    g = make()()
    assert len([next(g) for _ in range(3)]) == 3
    assert all(t.daemon for t in _reader_threads())
    g.close()
    assert not _wait_gone(), _reader_threads()


def test_threads_end_with_a_reader_read_to_its_end():
    assert list(PR.buffered(_r(20), 3)()) == list(range(20))
    assert sorted(PR.xmap_readers(lambda v: v, _r(20), 2, 2)()) == \
        list(range(20))
    assert not _wait_gone()


def test_top_level_batch_and_names():
    assert P.batch is PR.batch
    assert set(JR.__all__) == set(PR.__all__)
