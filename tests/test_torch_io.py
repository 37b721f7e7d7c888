"""The port's ``io`` against the JAX package's: datasets, samplers,
``default_collate_fn`` and ``DataLoader`` (mirrors
``tests/test_data_amp_hapi.py::TestDataLoader`` and
``tests/test_shm_dataloader.py``). The same ``np.random.seed`` gives the
same batches as the JAX package's loader, shuffled, single- and
multi-process; a worker's error reaches the caller; a batch larger than
the ring goes through the queue and is counted; two live iterators keep
their rings apart. Every multi-process loader here has ``timeout=20`` and
is run to its end, which joins its workers."""
import multiprocessing
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu.io as jio  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch.core import shm_ring  # noqa: E402
from paddle_tpu_torch.core.shm_ring import ShmRing  # noqa: E402

T = 20      # seconds a multi-process test may wait for any one batch

needs_ring = pytest.mark.skipif(not shm_ring.available(),
                                reason="no g++ or POSIX shared memory")


class _Range:
    def __init__(self, n=20):
        self.x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)

    def __len__(self):
        return len(self.x)


class JRange(_Range, jio.Dataset):
    pass


class TRange(_Range, tio.Dataset):
    pass


def _np(b):
    return [t.numpy() if isinstance(t, torch.Tensor) else
            np.asarray(t._data) for t in b]


def _loader(pkg, ds, **kw):
    if pkg == "jax":
        return jio.DataLoader(ds, **kw)
    return tio.DataLoader(ds, device="cpu", **kw)


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(_np(x), _np(y)):
            np.testing.assert_array_equal(u, v)


def _no_children():
    assert multiprocessing.active_children() == []


def test_single_process_batches():
    batches = list(tio.DataLoader(TRange(), batch_size=4, device="cpu"))
    assert len(batches) == 5
    assert batches[0][0].shape == (4, 3) and batches[0][1].dtype == \
        torch.int64
    np.testing.assert_allclose(batches[0][0].numpy()[:, 0], [0, 3, 6, 9])


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_shuffled_batches_equal_the_jax_loaders(workers, drop_last):
    out = {}
    for pkg, ds in (("jax", JRange(18)), ("torch", TRange(18))):
        np.random.seed(42)
        kw = dict(batch_size=4, shuffle=True, drop_last=drop_last,
                  num_workers=workers)
        if workers:
            kw["timeout"] = T
        out[pkg] = list(_loader(pkg, ds, **kw)) + \
            list(_loader(pkg, ds, **kw))
    _assert_same_batches(out["torch"], out["jax"])
    assert len(out["torch"]) == 2 * (4 if drop_last else 5)
    _no_children()


@needs_ring
def test_multiprocess_order_and_transport_counts():
    dl = tio.DataLoader(TRange(), batch_size=4, num_workers=2, timeout=T,
                        device="cpu")
    batches = list(dl)
    np.testing.assert_allclose(batches[1][1].numpy(), [4, 5, 6, 7])
    assert dl.stats["shm"] == 5 and dl.stats["queue"] == 0
    assert dl.stats["batches"] == 5
    _no_children()


def test_worker_exception_propagates():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=1, timeout=T,
                            device="cpu"))
    _no_children()


@needs_ring
def test_oversized_batch_takes_the_queue_and_is_counted():
    ds = TRange(16)
    dl = tio.DataLoader(ds, batch_size=8, num_workers=2, timeout=T,
                        shm_capacity=64, device="cpu")
    got = list(dl)
    assert dl.stats["queue"] == 2 and dl.stats["shm"] == 0
    _assert_same_batches(got, list(tio.DataLoader(ds, batch_size=8,
                                                  device="cpu")))
    off = tio.DataLoader(ds, batch_size=8, num_workers=2, timeout=T,
                         use_shared_memory=False, device="cpu")
    assert len(list(off)) == 2 and off.stats["queue"] == 2
    _no_children()


@needs_ring
def test_two_live_iterators_keep_their_rings_apart():
    ds = TRange(32)
    dl = tio.DataLoader(ds, batch_size=4, num_workers=2, timeout=T,
                        device="cpu")
    ref = list(tio.DataLoader(ds, batch_size=4, device="cpu"))
    it1 = iter(dl)
    first = next(it1)
    second = list(dl)
    _assert_same_batches(second, ref)
    _assert_same_batches([first] + list(it1), ref)
    assert dl.stats["shm"] == 16
    _no_children()


@pytest.mark.parametrize("workers", [0, 2])
def test_iterable_dataset(workers):
    class It(tio.IterableDataset):
        def __iter__(self):
            info = tio.get_worker_info()
            lo = 0 if info is None else info.id * 10
            for i in range(lo, lo + 10):
                yield np.float32(i)
    kw = dict(timeout=T) if workers else {}
    batches = list(tio.DataLoader(It(), batch_size=4, num_workers=workers,
                                  device="cpu", **kw))
    sizes = sorted(len(b[0]) for b in batches)
    assert sizes == ([2, 4, 4] if not workers else [2, 2, 4, 4, 4, 4])
    _no_children()


def test_samplers_and_datasets_match_jax():
    ds_j, ds_t = JRange(10), TRange(10)
    assert len(tio.BatchSampler(ds_t, batch_size=3)) == 4
    for rank in (0, 1):
        for shuffle in (False, True):
            j = jio.DistributedBatchSampler(ds_j, 2, num_replicas=2,
                                            rank=rank, shuffle=shuffle)
            t = tio.DistributedBatchSampler(ds_t, 2, num_replicas=2,
                                            rank=rank, shuffle=shuffle)
            j.set_epoch(3)
            t.set_epoch(3)
            assert list(t) == list(j) and len(t) == len(j)
    alone = tio.DistributedBatchSampler(ds_t, 4)
    assert (alone.nranks, alone.local_rank) == (1, 0)
    assert [i for b in alone for i in b] == list(range(10))
    np.random.seed(5)
    ja, jb = jio.random_split(ds_j, [7, 3])
    np.random.seed(5)
    ta, tb = tio.random_split(ds_t, [7, 3])
    assert ta.indices == ja.indices and tb.indices == jb.indices
    for sampler in ("RandomSampler", "WeightedRandomSampler"):
        args = (ds_j,) if sampler == "RandomSampler" else ([1, 2, 3, 4], 6)
        targs = (ds_t,) if sampler == "RandomSampler" else args
        np.random.seed(9)
        want = list(getattr(jio, sampler)(*args))
        np.random.seed(9)
        assert list(getattr(tio, sampler)(*targs)) == want
    cat = tio.ConcatDataset([TRange(3), TRange(4)])
    assert len(cat) == 7 and cat[5][1] == 2
    comp = tio.ComposeDataset([TRange(3), TRange(5)])
    assert len(comp) == 3 and len(comp[1]) == 4
    chain = tio.ChainDataset([[1, 2], [3]])
    assert [v for v in chain] == [1, 2, 3]
    td = tio.TensorDataset([np.zeros((4, 2)), np.arange(4)])
    assert len(td) == 4 and td[2][1] == 2


def test_default_collate_matches_jax():
    batch = [{"a": np.ones(2, np.float32) * i, "b": i, "c": float(i),
              "d": "s", "e": (np.int64(i), [np.zeros(1)])}
             for i in range(3)]
    j, t = jio.default_collate_fn(batch), tio.default_collate_fn(batch)
    for k in ("a", "b", "c"):
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype
    assert t["d"] == j["d"]
    np.testing.assert_array_equal(t["e"][0], j["e"][0])
    np.testing.assert_array_equal(t["e"][1][0], j["e"][1][0])
    tens = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(tens, np.ndarray) and tens.shape == (2, 2)


def test_loader_device_and_places():
    dl = tio.DataLoader(TRange(4), batch_size=2, places="cpu")
    assert dl.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.DataLoader(TRange(4), batch_size=2)


@needs_ring
class TestShmRing:
    def _name(self, tag):
        return f"/ptt_test_{tag}_{os.getpid()}"

    def test_bytes_roundtrip_with_wraparound(self):
        ring = ShmRing(self._name("a"), capacity=256, create=True)
        try:
            for i in range(10):
                data = bytes([i]) * 100
                ring.push_bytes(data)
                assert ring.pop_bytes(100) == data
        finally:
            ring.close()

    def test_object_roundtrip(self):
        ring = ShmRing(self._name("b"), capacity=1 << 20, create=True)
        try:
            obj = {"x": np.arange(100, dtype=np.float32),
                   "y": [np.ones((3, 4))], "meta": "hello"}
            out = ring.pop_object(ring.push_object(obj))
            np.testing.assert_array_equal(out["x"], obj["x"])
            np.testing.assert_array_equal(out["y"][0], obj["y"][0])
            assert out["meta"] == "hello" and out["x"].flags.writeable
        finally:
            ring.close()

    def test_oversized_payload_raises(self):
        ring = ShmRing(self._name("c"), capacity=128, create=True)
        try:
            with pytest.raises(ValueError, match="capacity"):
                ring.push_bytes(b"x" * 1024)
        finally:
            ring.close()

    def test_the_library_is_the_ports_own_build(self):
        assert shm_ring.library_path().parent.name == "paddle_tpu_torch"
        assert shm_ring.library_path().exists()
