"""Bulk-ingestion datasets ``InMemoryDataset`` and ``QueueDataset``
(counterpart of ``paddle_tpu/distributed/dataset.py``; reference:
python/paddle/distributed/fleet/dataset/dataset.py:253, load_into_memory
:680, local_shuffle :785, global_shuffle :817).

Ingestion is host-side NumPy: files are read by a thread pool
(``thread_num``), each line parsed by a pluggable ``parse_fn`` (default:
whitespace-separated floats), and ``batch_iterator()`` yields plain
``[B, ...]`` NumPy batches for ``Model.train_batch`` or a loop.

The port runs a world of one process, rank 0 of 1, where the JAX
package asks ``jax.process_index()``/``process_count()``: every file is
this process's and ``global_shuffle`` is ``local_shuffle``. If
``torch.distributed`` is initialised with more than one rank, the file
sharding, ``global_shuffle`` and the global sizes raise, naming the
second slice of ROADMAP queue A10.
"""
from __future__ import annotations

import concurrent.futures as _fut
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset"]


def _one_process(what):
    """Rank 0 of a world of one; raises naming A10's second slice in a
    larger one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} across {dist.get_world_size()} processes is the "
            f"second slice of ROADMAP queue A10 (not ported yet); the "
            f"port's datasets run in a world of one")
    return 0, 1


def _default_parse_fn(line: str):
    parts = line.split()
    if not parts:
        return None
    return np.asarray([float(p) for p in parts], np.float32)


class DatasetBase:
    """reference: dataset.py:24 DatasetBase (init/_set_* surface)."""

    def __init__(self):
        self._filelist: List[str] = []
        self._batch_size = 1
        self._thread_num = 1
        self._use_var: List[str] = []
        self._parse_fn: Callable = _default_parse_fn
        self._drop_last = False

    def init(self, batch_size=1, thread_num=1, use_var=None, parse_fn=None,
             drop_last=False, **kwargs):
        self._batch_size = int(batch_size)
        self._thread_num = int(thread_num)
        self._use_var = list(use_var or [])
        if parse_fn is not None:
            self._parse_fn = parse_fn
        self._drop_last = bool(drop_last)
        return self

    def set_filelist(self, filelist: Sequence[str]):
        missing = [f for f in filelist if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(f"set_filelist: {missing}")
        self._filelist = list(filelist)

    def set_batch_size(self, b):
        self._batch_size = int(b)

    def set_thread(self, n):
        self._thread_num = int(n)

    def set_parse_fn(self, fn):
        self._parse_fn = fn

    # -- helpers --------------------------------------------------------------
    def _my_files(self):
        """This process's files: all of them, in a world of one (the
        reference assigns whole files to trainers)."""
        _one_process("file sharding")
        return self._filelist

    def _read_file(self, path):
        out = []
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                s = self._parse_fn(line)
                if s is not None:
                    out.append(s)
        return out

    def _batches_from(self, samples):
        B = self._batch_size
        n = len(samples)
        end = (n // B) * B if self._drop_last else n
        for i in range(0, end, B):
            chunk = samples[i:i + B]
            if not chunk:
                return
            if isinstance(chunk[0], (tuple, list)):
                yield tuple(np.stack([c[j] for c in chunk])
                            for j in range(len(chunk[0])))
            else:
                yield np.stack(chunk)


class InMemoryDataset(DatasetBase):
    """reference: dataset.py:253 — bulk load, shuffle, iterate."""

    def __init__(self):
        super().__init__()
        self._samples: list = []
        self._loaded = False

    # -- ingestion ------------------------------------------------------------
    def load_into_memory(self):
        """reference :680 — parallel file-sharded ingestion."""
        files = self._my_files()
        self._samples = []
        if not files:
            self._loaded = True
            return
        with _fut.ThreadPoolExecutor(max_workers=max(self._thread_num, 1)) \
                as pool:
            for chunk in pool.map(self._read_file, files):
                self._samples.extend(chunk)
        self._loaded = True

    preload_into_memory = load_into_memory

    def wait_preload_done(self):
        return None

    def release_memory(self):
        """reference :884."""
        self._samples = []
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        """reference :906 — global instance count before shuffle."""
        return self._global_size(len(self._samples))

    def get_shuffle_data_size(self, fleet=None):
        """reference :940 — this process's post-shuffle count (summed
        globally like the reference when fleet is passed)."""
        return self._global_size(len(self._samples))

    def _global_size(self, local_n):
        _one_process("a global instance count")
        return local_n

    # -- shuffles -------------------------------------------------------------
    def local_shuffle(self, seed: Optional[int] = None):
        """reference :785 — in-process permutation."""
        rng = np.random.RandomState(seed)
        rng.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=12,
                       seed: Optional[int] = None):
        """reference :817: redistribute instances across processes; in a
        world of one, :meth:`local_shuffle` (as the reference without a
        fleet)."""
        _one_process("global_shuffle")
        self.local_shuffle(seed)

    # -- consumption ----------------------------------------------------------
    def batch_iterator(self):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        return self._batches_from(self._samples)

    def __iter__(self):
        return self.batch_iterator()

    def __len__(self):
        B = self._batch_size
        n = len(self._samples)
        return n // B if self._drop_last else -(-n // B)


class QueueDataset(DatasetBase):
    """reference: dataset.py QueueDataset — streaming (one pass, no
    memory residency, no global shuffle; the reference raises on
    shuffle too)."""

    def local_shuffle(self):
        raise RuntimeError(
            "QueueDataset streams from files; use InMemoryDataset for "
            "shuffling (reference raises the same)")

    global_shuffle = local_shuffle

    def batch_iterator(self):
        def gen():
            pending: list = []
            for path in self._my_files():
                pending.extend(self._read_file(path))
                B = self._batch_size
                while len(pending) >= B:
                    chunk, pending = pending[:B], pending[B:]
                    yield from self._batches_from(chunk)
            if pending and not self._drop_last:
                yield from self._batches_from(pending)
        return gen()

    def __iter__(self):
        return self.batch_iterator()
