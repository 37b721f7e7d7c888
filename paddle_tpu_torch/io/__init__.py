"""paddle.io: datasets, samplers and ``DataLoader`` (counterpart of
``paddle_tpu/io/__init__.py:29-515``).

The datasets, samplers, ``default_collate_fn`` and the worker loop are
the reference's. Shuffles draw from NumPy's global generator, as the
reference's do (``RandomSampler``, ``random_split``, the workers' seed),
so the same ``np.random.seed`` gives the same batches in both packages.

Workers run NumPy only: the dataset's ``__getitem__`` and the collate
function, in processes forked from the trainer. Worker ``w`` seeds
NumPy's and Python's global generators with the iterator's seed plus
``w`` (the JAX package seeds NumPy's only, so its forked workers replay
one Python stream: every worker the same random crops and flips). They
never touch torch or CUDA (a child that runs torch ops after the
parent's thread pool and CUDA are up can hang). Each batch goes back through the port's
shared-memory ring (``core/shm_ring.py``, one ring per worker, per
iterator, named ``/ptt_dl_<pid>_<serial>_<worker>``), with only its
size on the queue; a batch larger than the ring (``shm_capacity``, 64
MiB by default) goes through the queue, as in the reference. The loader
counts both in :attr:`DataLoader.stats` (``shm``, ``queue``), with the
batches delivered and the main process's seconds waiting on the queue
(``wait_s``), popping rings (``pop_s``) and making tensors
(``convert_s``).

The main process makes the tensors: every NumPy array of a batch becomes
a tensor on the loader's ``device`` (CUDA unless ``device="cpu"``;
``places=`` is taken as the device). On CUDA an array is copied into a
pinned host buffer kept per shape and type (two, used in turn, each
refilled only after its last copy is done) and from there to the device
on a copy stream of the loader's, which the consuming stream waits for;
page-locking memory anew for every batch would cost more than the copy.
On the CPU the arrays are wrapped without a copy.
"""
from __future__ import annotations

import bisect
import itertools
import math
import os
import queue as _queue
import random
import time
import traceback

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "default_convert_fn", "get_worker_info",
           "DataLoader"]


class Dataset:
    """A map-style dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    perm = np.random.permutation(n)
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln].tolist()))
        off += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across ``num_replicas`` ranks. Without
    ``num_replicas``/``rank`` it takes the data-parallel degree and rank
    of the hybrid topology (``fleet.init``), else the process world's
    (``distributed.get_world_size``/``get_rank``), so that each
    data-parallel rank reads its own shard."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size
            from ..distributed.topology import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            if hcg is not None:
                world = hcg.get_data_parallel_world_size()
                me = hcg.get_data_parallel_rank()
            else:
                world, me = get_world_size(), get_rank()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else me
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n) \
                .tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# -- collate ---------------------------------------------------------------

def default_collate_fn(batch):
    """Stack a list of samples into arrays, field by field (NumPy only:
    a CPU tensor sample is read as an array)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, 0)
    if isinstance(sample, torch.Tensor):
        return np.stack([s.numpy() for s in batch], 0)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    return list(batch)


def default_convert_fn(batch):
    return batch


class _WorkerInfo:
    def __init__(self, wid, num_workers, dataset, seed):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = [None]


def get_worker_info():
    return _worker_info[0]


def _worker_loop(dataset, index_queue, out_queue, collate_fn, wid,
                 num_workers, seed, iterable_mode, shm_name=None):
    """A worker process: indices in, collated NumPy batches out, through
    its ring when it has one (only ``(order, "SHM", (wid, nbytes))`` on
    the queue) and through the queue when the batch is larger than the
    ring."""
    np.random.seed((seed + wid) & 0xFFFFFFFF)
    # Python's generator too (the random transforms draw from it): a
    # forked worker would otherwise replay its parent's stream, every
    # worker the same crops and flips
    random.seed((seed + wid) & 0xFFFFFFFF)
    _worker_info[0] = _WorkerInfo(wid, num_workers, dataset, seed)
    ring = None
    if shm_name is not None:
        from ..core.shm_ring import ShmRing
        ring = ShmRing(shm_name, create=False)

    def send(order, batch):
        if ring is not None:
            try:
                n = ring.push_object(batch)
                out_queue.put((order, "SHM", (wid, n)))
                return
            except ValueError:
                pass  # payload larger than the ring: queue fallback
        out_queue.put((order, "OK", batch))

    try:
        if iterable_mode:
            it = iter(dataset)
            while True:
                msg = index_queue.get()
                if msg is None:
                    break
                order, batch_size = msg
                try:
                    batch = list(itertools.islice(it, batch_size))
                    if not batch:
                        out_queue.put((order, "END", None))
                        continue
                    send(order, collate_fn(batch))
                except Exception:
                    out_queue.put((order, "ERR", traceback.format_exc()))
        else:
            while True:
                msg = index_queue.get()
                if msg is None:
                    break
                order, indices = msg
                try:
                    batch = [dataset[i] for i in indices]
                    send(order, collate_fn(batch))
                except Exception:
                    out_queue.put((order, "ERR", traceback.format_exc()))
    except KeyboardInterrupt:
        pass


class _Staging:
    """The loader's host-to-device path on CUDA: two pinned buffers per
    shape and type, used in turn, and a copy stream."""

    DEPTH = 2

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = {}       # (shape, dtype) -> [[pinned, event], ...]
        self.turn = {}

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        key = (arr.shape, arr.dtype.str)
        slots = self.buffers.get(key)
        if slots is None:
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            slots = self.buffers[key] = [
                [torch.empty(arr.shape, dtype=dtype, pin_memory=True), None]
                for _ in range(self.DEPTH)]
        i = self.turn.get(key, 0)
        self.turn[key] = (i + 1) % self.DEPTH
        slot = slots[i]
        if slot[1] is not None:
            slot[1].synchronize()       # its last copy is done
        pinned = slot[0]
        np.copyto(pinned.numpy(), arr, casting="no")
        consumer = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(consumer)
        with torch.cuda.stream(self.stream):
            out = torch.empty(pinned.shape, dtype=pinned.dtype,
                              device=self.device)
            out.copy_(pinned, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        slot[1] = ev
        consumer.wait_stream(self.stream)
        out.record_stream(consumer)
        return out


class DataLoader:
    """Batches of a dataset as tensors on ``device`` (the reference's
    ``return_list=True`` form): single-process, or ``num_workers``
    processes for map-style and iterable datasets, delivered in order.
    ``timeout`` (seconds) bounds each wait for a worker's batch."""

    _iter_serial = 0  # distinguishes the rings of concurrent iterators

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=120, worker_init_fn=None,
                 persistent_workers=False, shm_capacity=64 << 20, *,
                 device: DeviceLike = None):
        if device is None and places is not None:
            device = places[0] if isinstance(places, (list, tuple)) \
                else places
        self.device = resolve_device(device)
        self.dataset = dataset
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.return_list = return_list
        self.use_shared_memory = use_shared_memory
        self.shm_capacity = int(shm_capacity)
        self.stats = {"shm": 0, "queue": 0, "batches": 0, "wait_s": 0.0,
                      "pop_s": 0.0, "convert_s": 0.0}
        self._staging = None
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return iter(self)

    def __iter__(self):
        if self.num_workers == 0:
            return self._single_process_iter()
        return self._multi_process_iter()

    # -- tensors on the device ---------------------------------------------
    def _tensor(self, arr):
        if not isinstance(arr, np.ndarray):
            return arr
        if self.device.type == "cpu":
            return torch.from_numpy(arr if arr.flags.writeable
                                    else arr.copy())
        if self._staging is None:
            self._staging = _Staging(self.device)
        return self._staging.to_device(arr)

    def _to_tensors(self, batch):
        t0 = time.perf_counter()
        self.stats["batches"] += 1
        if isinstance(batch, (list, tuple)):
            out = [self._tensor(b) for b in batch]
        elif isinstance(batch, np.ndarray):
            out = [self._tensor(batch)]
        elif isinstance(batch, dict):
            out = {k: self._tensor(v) for k, v in batch.items()}
        else:
            out = batch
        self.stats["convert_s"] += time.perf_counter() - t0
        return out

    def _single_process_iter(self):
        if self._iterable:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch or (self.drop_last
                                 and len(batch) < self.batch_size):
                    return
                yield self._to_tensors(self.collate_fn(batch))
        else:
            for indices in self.batch_sampler:
                batch = [self.dataset[i] for i in indices]
                yield self._to_tensors(self.collate_fn(batch))

    # -- worker processes ----------------------------------------------------
    def _multi_process_iter(self):
        """The worker pool, in-order delivery, and the rings and workers
        shut down when the iterator ends or is dropped."""
        import multiprocessing as mp
        ctx = mp.get_context("fork" if os.name == "posix" else "spawn")
        index_queues = []
        out_queue = ctx.Queue()
        workers = []
        # rings are per-iterator state: two live iterators of one loader
        # must not share (or unlink) each other's rings
        rings = {}
        DataLoader._iter_serial += 1
        serial = DataLoader._iter_serial
        use_shm = False
        if self.use_shared_memory and os.name == "posix":
            from ..core.shm_ring import ShmRing, available as _shm_ok
            use_shm = _shm_ok()
        seed = int(np.random.randint(0, 2 ** 31))
        try:
            for wid in range(self.num_workers):
                iq = ctx.Queue()
                shm_name = None
                if use_shm:
                    shm_name = f"/ptt_dl_{os.getpid()}_{serial}_{wid}"
                    rings[wid] = ShmRing(shm_name, create=True,
                                         capacity=self.shm_capacity)
                w = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, iq, out_queue, self.collate_fn, wid,
                          self.num_workers, seed, self._iterable, shm_name),
                    daemon=True)
                w.start()
                index_queues.append(iq)
                workers.append(w)
            if self._iterable:
                yield from self._mp_iterable(index_queues, out_queue, rings)
            else:
                yield from self._mp_map(index_queues, out_queue, rings)
        finally:
            for iq in index_queues:
                try:
                    iq.put(None)
                except Exception:
                    pass
            for w in workers:
                w.join(timeout=1)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=1)
            for r in rings.values():
                r.close()

    def _receive(self, out_queue, rings):
        """The next message, its payload popped from the ring when it
        came through one; counts the transport and the wait."""
        t0 = time.perf_counter()
        try:
            key, status, payload = out_queue.get(timeout=self.timeout)
        except _queue.Empty:
            raise RuntimeError(f"DataLoader: no batch from the workers in "
                               f"{self.timeout} s") from None
        t1 = time.perf_counter()
        self.stats["wait_s"] += t1 - t0
        if status == "ERR":
            raise RuntimeError(f"DataLoader worker failed:\n{payload}")
        if status == "SHM":
            wid, nbytes = payload
            payload = rings[wid].pop_object(nbytes)
            self.stats["shm"] += 1
            self.stats["pop_s"] += time.perf_counter() - t1
        elif status == "OK":
            self.stats["queue"] += 1
        return key, status, payload

    def _mp_map(self, index_queues, out_queue, rings):
        batches = list(self.batch_sampler)
        n = len(batches)
        inflight = next_send = next_recv = 0
        hold = {}
        max_inflight = self.num_workers * self.prefetch_factor
        while next_recv < n:
            while next_send < n and inflight < max_inflight:
                index_queues[next_send % self.num_workers].put(
                    (next_send, batches[next_send]))
                next_send += 1
                inflight += 1
            order, _, payload = self._receive(out_queue, rings)
            inflight -= 1
            hold[order] = payload
            while next_recv in hold:
                yield self._to_tensors(hold.pop(next_recv))
                next_recv += 1

    def _mp_iterable(self, index_queues, out_queue, rings):
        # each worker consumes its own iterator copy; messages tagged by wid
        live = set(range(self.num_workers))
        for wid in live:
            index_queues[wid].put((wid, self.batch_size))
        while live:
            wid, status, payload = self._receive(out_queue, rings)
            if status == "END":
                live.discard(wid)
                continue
            if wid in live:
                index_queues[wid].put((wid, self.batch_size))
            yield self._to_tensors(payload)
