"""The port's bulk-ingestion datasets (``distributed/dataset.py``)
against the JAX package's on the CPU, at a world of one: loading with a
thread pool, batches (with and without ``drop_last``), custom
``parse_fn`` tuples, ``local_shuffle`` and ``global_shuffle`` under one
seed, the sizes, ``release_memory``, ``QueueDataset``'s stream and its
refusal to shuffle; and, with ``torch.distributed`` up at two ranks, the
refusals naming A10."""
import numpy as np
import pytest

import paddle_tpu.distributed as JD
import paddle_tpu_torch.distributed as PD


def _write_files(tmp_path, n_files=4, rows_per=8, width=3):
    files, v = [], 0
    for i in range(n_files):
        p = tmp_path / f"part-{i:03d}.txt"
        with open(p, "w") as f:
            for _ in range(rows_per):
                f.write(" ".join(str(v * width + j) for j in range(width))
                        + "\n")
                v += 1
        files.append(str(p))
    return files


def _parse_pair(line):
    vals = line.split()
    return (np.asarray([float(v) for v in vals[:-1]], np.float32),
            np.int64(int(float(vals[-1])) % 2))


def _scenario(D, files, kind):
    ds = D.InMemoryDataset() if kind != "queue" else D.QueueDataset()
    ds.init(batch_size=5, thread_num=3,
            parse_fn=_parse_pair if kind == "pairs" else None,
            drop_last=(kind == "drop_last"))
    ds.set_filelist(files)
    if kind == "queue":
        return [list(ds)]
    ds.load_into_memory()
    out = [list(ds.batch_iterator()), len(ds), ds.get_memory_data_size()]
    if kind in ("shuffle", "pairs"):
        ds.local_shuffle(seed=7)
        out.append(list(ds))
        ds.global_shuffle(seed=11)
        out += [list(ds), ds.get_shuffle_data_size()]
    ds.release_memory()
    out.append(ds.get_memory_data_size())
    return out


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["plain", "drop_last", "shuffle", "pairs",
                                  "queue"])
def test_dataset_matches_jax_at_a_world_of_one(tmp_path, kind):
    files = _write_files(tmp_path)
    _same(_scenario(PD, files, kind), _scenario(JD, files, kind))


def test_queue_dataset_refuses_to_shuffle(tmp_path):
    ds = PD.QueueDataset()
    ds.init(batch_size=4)
    ds.set_filelist(_write_files(tmp_path, 1, 3))
    with pytest.raises(RuntimeError):
        ds.local_shuffle()
    with pytest.raises(RuntimeError):
        ds.global_shuffle()


def test_missing_files_and_unloaded_iteration_raise(tmp_path):
    ds = PD.InMemoryDataset()
    with pytest.raises(FileNotFoundError):
        ds.set_filelist([str(tmp_path / "nope.txt")])
    with pytest.raises(RuntimeError, match="load_into_memory"):
        list(ds.batch_iterator())


@pytest.mark.parametrize("call", ["load_into_memory", "global_shuffle",
                                  "get_memory_data_size", "queue"])
def test_a_larger_world_raises_naming_a10(tmp_path, monkeypatch, call):
    import torch.distributed as dist
    files = _write_files(tmp_path, 2, 2)
    ds = PD.QueueDataset() if call == "queue" else PD.InMemoryDataset()
    ds.init(batch_size=2)
    ds.set_filelist(files)
    if call in ("global_shuffle", "get_memory_data_size"):
        ds.load_into_memory()
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="A10"):
        if call == "queue":
            list(ds)
        else:
            getattr(ds, call)()


def test_namespaces():
    assert PD.fleet.InMemoryDataset is PD.InMemoryDataset
    assert PD.fleet.QueueDataset is PD.QueueDataset
    assert issubclass(PD.InMemoryDataset, PD.DatasetBase)


def test_reference_names():
    import paddle_tpu.distributed.dataset as jds
    import paddle_tpu_torch.distributed.dataset as pds
    assert set(pds.__all__) == set(jds.__all__)
    for n in jds.__all__:
        assert getattr(PD, n) is getattr(pds, n)
