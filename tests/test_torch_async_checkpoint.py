"""The port's crash-consistent async checkpointing against the JAX
package's: every scenario of the reference's commit protocol, bounded
queue, retry-then-degrade and fault actions runs on both packages with
the same assertions (``PKGS``), commits load across packages, and the
port's snapshot owns its bytes (an in-place update after ``save()``
does not reach the archive). The SIGKILL matrix is in
``test_torch_chaos_checkpoint.py``."""
import errno
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu.incubate.checkpoint as jck  # noqa: E402
from paddle_tpu.core import monitor as jmon  # noqa: E402
from paddle_tpu.incubate.checkpoint import async_ckpt as jac  # noqa: E402
from paddle_tpu.incubate.checkpoint import sharded as jsh  # noqa: E402
from paddle_tpu.utils import resilience as jres  # noqa: E402
import paddle_tpu_torch.incubate.checkpoint as tck  # noqa: E402
from paddle_tpu_torch.core import monitor as tmon  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import async_ckpt as tac  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import sharded as tsh  # noqa: E402
from paddle_tpu_torch.utils import resilience as tres  # noqa: E402


class _Pkg:
    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.ck, self.ac, self.sh = (tck, tac, tsh) if port else \
            (jck, jac, jsh)
        self.mon, self.res = (tmon, tres) if port else (jmon, jres)

    def state(self, scale=1.0):
        if self.name == "port":
            return {"w": torch.arange(16.0) * scale, "b": torch.ones(3),
                    "step": 1}
        return {"w": jnp.arange(16.0) * scale, "b": jnp.ones(3), "step": 1}

    def load(self, p, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        out = self.ck.load_sharded(p, return_tensor=False, **kw)
        return {k: (np.asarray(v) if not isinstance(v, torch.Tensor)
                    else v.numpy()) if not isinstance(v, (int, float))
                else v for k, v in out.items()}


PKGS = ["jax", "port"]


@pytest.fixture(params=PKGS)
def pkg(request, monkeypatch):
    p = _Pkg(request.param)

    def arm(spec):
        monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", spec)
        p.res._reset_fault_injector_for_tests()
    p.arm = arm
    p.res._reset_fault_injector_for_tests()
    yield p
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    p.res._reset_fault_injector_for_tests()


# -- the commit protocol ----------------------------------------------------
def test_commit_roundtrip_and_no_staging_left(pkg, tmp_path):
    p = str(tmp_path / "ck")
    pkg.ck.commit_checkpoint(pkg.state(), p, step=5)
    pkg.ck.verify_checkpoint(p)
    out = pkg.load(p)
    np.testing.assert_allclose(out["w"], np.arange(16.0))
    assert out["step"] == 1
    assert not os.path.exists(p + pkg.ck.STAGING_SUFFIX)
    with open(os.path.join(p, "metadata_0.json")) as f:
        doc = json.load(f)
    assert doc["format"] == 3 and doc["health"]["step"] == 5


def test_health_rides_the_commit(pkg, tmp_path):
    p = str(tmp_path / "ck")
    pkg.ck.commit_checkpoint(pkg.state(), p, healthy=False, step=9,
                             reason="nan")
    stamp = pkg.ck.read_health_stamp(p)
    assert stamp["healthy"] is False and stamp["reason"] == "nan"
    os.remove(os.path.join(p, "health.json"))
    stamp = pkg.ck.read_health_stamp(p)
    assert stamp["healthy"] is False and stamp["reason"] == "nan"
    pkg.ck.write_health_stamp(p, True, reason="cleared")
    assert pkg.ck.read_health_stamp(p)["healthy"] is True


def test_recommit_over_existing_checkpoint(pkg, tmp_path):
    p = str(tmp_path / "ck")
    pkg.ck.commit_checkpoint(pkg.state(1.0), p)
    pkg.ck.commit_checkpoint(pkg.state(2.0), p)
    np.testing.assert_allclose(pkg.load(p)["w"], np.arange(16.0) * 2)


def test_staging_and_parked_dirs_are_invisible(pkg, tmp_path):
    committed = str(tmp_path / "snap_1")
    pkg.ck.commit_checkpoint(pkg.state(), committed)
    for i, suffix in ((2, pkg.ck.STAGING_SUFFIX), (3, pkg.ck.OLD_SUFFIX)):
        pkg.ck.commit_checkpoint(pkg.state(2.0), str(tmp_path / "scratch"))
        os.rename(str(tmp_path / "scratch"),
                  str(tmp_path / f"snap_{i}{suffix}"))
        assert not pkg.sh._is_checkpoint_dir(
            str(tmp_path / f"snap_{i}{suffix}"))
    assert pkg.ck.newest_healthy_checkpoint(str(tmp_path)) == committed


def test_cleanup_stale_staging(pkg, tmp_path):
    keep = str(tmp_path / "snap_1")
    pkg.ck.commit_checkpoint(pkg.state(), keep)
    stale = str(tmp_path / ("snap_2" + pkg.ck.STAGING_SUFFIX))
    os.makedirs(stale)
    held = str(tmp_path / ("snap_3" + pkg.ck.STAGING_SUFFIX))
    os.makedirs(held)
    with open(os.path.join(keep, ".tmp_health_1.json"), "w") as f:
        f.write("{")
    removed = pkg.ck.cleanup_stale_staging(str(tmp_path), held={held})
    assert removed == [stale, os.path.join(keep, ".tmp_health_1.json")]
    assert os.path.isdir(held) and os.path.isdir(keep)


def test_recommit_never_has_a_zero_checkpoint_instant(pkg, tmp_path,
                                                      monkeypatch):
    p = str(tmp_path / "latest")
    pkg.ck.commit_checkpoint(pkg.state(1.0), p)
    real_replace = os.replace

    def exploding_replace(src, dst):
        real_replace(src, dst)
        if dst.endswith(pkg.ck.OLD_SUFFIX):  # crash right after parking
            raise RuntimeError("synthetic crash inside the swap window")

    monkeypatch.setattr(pkg.ac.os, "replace", exploding_replace)
    with pytest.raises(RuntimeError, match="swap window"):
        pkg.ck.commit_checkpoint(pkg.state(2.0), p)
    monkeypatch.setattr(pkg.ac.os, "replace", real_replace)
    assert not os.path.isdir(p) and os.path.isdir(p + pkg.ck.OLD_SUFFIX)
    pkg.ck.cleanup_stale_staging(str(tmp_path))
    pkg.ck.verify_checkpoint(p)
    np.testing.assert_allclose(pkg.load(p)["w"], np.arange(16.0))
    assert not os.path.isdir(p + pkg.ck.OLD_SUFFIX)
    assert not os.path.isdir(p + pkg.ck.STAGING_SUFFIX)
    pkg.ck.commit_checkpoint(pkg.state(3.0), p)
    np.testing.assert_allclose(pkg.load(p)["w"], np.arange(16.0) * 3)


@pytest.mark.parametrize("writer", PKGS)
def test_commits_load_across_packages(tmp_path, writer):
    w, r = _Pkg(writer), _Pkg("jax" if writer == "port" else "port")
    p = str(tmp_path / "ck")
    w.ck.commit_checkpoint(w.state(2.0), p, healthy=False, step=3,
                           reason="spike")
    r.ck.verify_checkpoint(p)
    out = r.load(p)
    np.testing.assert_allclose(out["w"], np.arange(16.0) * 2)
    np.testing.assert_allclose(out["b"], np.ones(3))
    stamp = r.ck.read_health_stamp(p)
    assert (stamp["healthy"], stamp["step"], stamp["reason"]) == \
        (False, 3, "spike")


# -- the async writer ---------------------------------------------------
class _BlockingWriter:
    """Replaces ``_write_staged``: parks the writer thread on an event so
    the queue's behaviour is deterministic."""

    def __init__(self, real):
        self.release = threading.Event()
        self.entered = threading.Event()
        self._real = real

    def __call__(self, staging, meta, blobs, scalars, health, fsync=True):
        self.entered.set()
        assert self.release.wait(10), "test never released the writer"
        return self._real(staging, meta, blobs, scalars, health, fsync=fsync)


def test_async_commit_roundtrip(pkg, tmp_path):
    with pkg.ck.AsyncCheckpointer() as ck:
        t = ck.save(pkg.state(), str(tmp_path / "ck"), step=3)
        assert t.wait(30) and t.committed and t.error is None
    np.testing.assert_allclose(pkg.load(str(tmp_path / "ck"))["w"],
                               np.arange(16.0))


def test_full_queue_supersedes_oldest(pkg, tmp_path, monkeypatch):
    reg = pkg.mon.StatRegistry()
    blocker = _BlockingWriter(pkg.ac._write_staged)
    monkeypatch.setattr(pkg.ac, "_write_staged", blocker)
    ck = pkg.ck.AsyncCheckpointer(pkg.ck.AsyncCheckpointConfig(queue_depth=2),
                                  registry=reg)
    tickets = [ck.save(pkg.state(1), str(tmp_path / "snap_1"))]
    assert blocker.entered.wait(10)
    for i in range(2, 6):
        tickets.append(ck.save(pkg.state(i), str(tmp_path / f"snap_{i}")))
    blocker.release.set()
    ck.close(timeout=30)
    assert [(t.committed, t.superseded) for t in tickets] == [
        (True, False), (False, True), (False, True), (True, False),
        (True, False)]
    assert reg.get("ckpt.async.superseded") == 2
    assert reg.get("ckpt.async.commits") == 3
    assert not os.path.exists(str(tmp_path / "snap_2"))
    np.testing.assert_allclose(pkg.load(str(tmp_path / "snap_5"))["w"],
                               np.arange(16.0) * 5)


def test_wait_blocks_until_in_flight_commit_lands(pkg, tmp_path,
                                                  monkeypatch):
    blocker = _BlockingWriter(pkg.ac._write_staged)
    monkeypatch.setattr(pkg.ac, "_write_staged", blocker)
    with pkg.ck.AsyncCheckpointer() as ck:
        t = ck.save(pkg.state(), str(tmp_path / "ck"))
        assert blocker.entered.wait(10)
        assert ck.wait(timeout=0.2) is False
        held = ck.held_paths()
        p = str(tmp_path / "ck")
        assert {p, p + pkg.ck.STAGING_SUFFIX, p + pkg.ck.OLD_SUFFIX} == held
        blocker.release.set()
        assert ck.wait(timeout=30) is True
        assert t.committed and ck.held_paths() == set()
    pkg.ck.verify_checkpoint(str(tmp_path / "ck"))


def test_save_after_close_raises(pkg, tmp_path):
    ck = pkg.ck.AsyncCheckpointer()
    ck.close()
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(pkg.state(), str(tmp_path / "ck"))


def test_writer_death_recorded_and_respawned(pkg, tmp_path, monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    reg = pkg.mon.StatRegistry()
    ck = pkg.ck.AsyncCheckpointer(registry=reg)
    boom = {"armed": True}
    real_process = ck._process

    def exploding(item):
        if boom["armed"]:
            boom["armed"] = False
            raise SystemExit("synthetic writer death")
        return real_process(item)

    ck._process = exploding
    t1 = ck.save(pkg.state(), str(tmp_path / "a"))
    deadline = time.monotonic() + 10
    while reg.get("ckpt.async.writer_deaths") == 0 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert reg.get("ckpt.async.writer_deaths") == 1
    t2 = ck.save(pkg.state(), str(tmp_path / "b"))
    assert t2.wait(30) and t2.committed
    assert reg.get("ckpt.async.writer_restarts") == 1
    assert not t1.committed
    ck.close(timeout=30)


def test_on_commit_failure_keeps_ticket_committed(pkg, tmp_path):
    reg = pkg.mon.StatRegistry()
    with pkg.ck.AsyncCheckpointer(registry=reg) as ck:
        with pytest.warns(UserWarning, match="on_commit"):
            t = ck.save(pkg.state(), str(tmp_path / "ck"),
                        on_commit=lambda: 1 / 0)
            assert t.wait(30)
            ck.wait(30)
    assert t.committed and t.error is None
    assert (reg.get("ckpt.async.commits"), reg.get("ckpt.async.errors"),
            reg.get("ckpt.async.on_commit_errors")) == (1, 0, 1)
    t = pkg.ck.SaveTicket("p", 1)
    t._finish(committed=True)
    t._finish(error=RuntimeError("late failure"))
    assert t.committed and t.error is None and t.done


def test_observability_surface(pkg, tmp_path):
    reg = pkg.mon.StatRegistry()
    with pkg.ck.AsyncCheckpointer(registry=reg) as ck:
        ck.save(pkg.state(), str(tmp_path / "ck")).wait(30)
        ck.wait(30)
    assert reg.get("ckpt.async.saves") == 1
    assert reg.get("ckpt.async.commits") == 1
    for hist in ("ckpt.async.enqueue_ms", "ckpt.async.fetch_ms",
                 "ckpt.async.write_ms", "ckpt.async.commit_ms"):
        assert reg.histogram(hist)["count"] == 1


# -- fault actions --------------------------------------------------------
def test_disk_full_raises_enospc_at_site(pkg, tmp_path):
    pkg.arm("ckpt_shard_write:1:disk_full")
    with pytest.raises(OSError) as ei:
        pkg.ck.commit_checkpoint(pkg.state(), str(tmp_path / "ck"))
    assert ei.value.errno == errno.ENOSPC
    assert pkg.ck.newest_healthy_checkpoint(str(tmp_path)) is None


def test_torn_write_is_caught_by_verification(pkg, tmp_path):
    pkg.arm("ckpt_shard_write:1:torn_write")
    p = str(tmp_path / "snap_2")
    pkg.ck.commit_checkpoint(pkg.state(), p)
    with pytest.raises(pkg.ck.CheckpointIntegrityError):
        pkg.ck.verify_checkpoint(p)
    with pytest.raises(pkg.ck.CheckpointIntegrityError):
        pkg.load(p)
    pkg.arm("")
    good = str(tmp_path / "snap_1")
    pkg.ck.commit_checkpoint(pkg.state(), good)
    with pytest.warns(UserWarning, match="skipping checkpoint"):
        assert pkg.ck.newest_healthy_checkpoint(str(tmp_path)) == good


def test_slow_io_stalls_the_commit(pkg, tmp_path, monkeypatch):
    monkeypatch.setattr(pkg.ac, "SLOW_IO_SECONDS", 0.3)
    pkg.arm("ckpt_pre_rename:1:slow_io")
    t0 = time.perf_counter()
    pkg.ck.commit_checkpoint(pkg.state(), str(tmp_path / "ck"))
    assert time.perf_counter() - t0 >= 0.3


def test_async_retries_then_degrades(pkg, tmp_path):
    reg = pkg.mon.StatRegistry()
    pkg.arm("ckpt_shard_write:1:disk_full,ckpt_shard_write:3:disk_full,"
            "ckpt_shard_write:4:disk_full,ckpt_shard_write:5:disk_full")
    cfg = pkg.ck.AsyncCheckpointConfig(max_attempts=3, backoff=0.01)
    with pkg.ck.AsyncCheckpointer(cfg, registry=reg) as ck:
        t = ck.save(pkg.state(), str(tmp_path / "snap_0"))
        assert t.wait(30) and t.committed            # retried once
        with pytest.warns(UserWarning, match="skipped"):
            t = ck.save(pkg.state(), str(tmp_path / "snap_1"))
            assert t.wait(30)
            assert not t.committed and t.error is not None
            t2 = ck.save(pkg.state(), str(tmp_path / "snap_2"))
            assert t2.wait(30) and t2.committed
    assert reg.get("ckpt.async.degraded_skips") == 1
    assert reg.get("ckpt.async.retries") == 3
    assert not os.path.exists(str(tmp_path / "snap_1"))
    assert not os.path.exists(str(tmp_path / "snap_1") +
                              pkg.ck.STAGING_SUFFIX)
    pkg.ck.verify_checkpoint(str(tmp_path / "snap_2"))


# -- the port's snapshot --------------------------------------------------
def test_snapshot_owns_its_bytes(tmp_path, monkeypatch):
    """An in-place update after ``save()`` (the optimizer's, a captured
    step's) never reaches the archive: the snapshot copied the tensors."""
    blocker = _BlockingWriter(tac._write_staged)
    monkeypatch.setattr(tac, "_write_staged", blocker)
    w = torch.arange(8.0)
    state = {"model": {"w": w}, "optimizer": {"m": torch.zeros(3),
                                              "global_step": 4}}
    with tck.AsyncCheckpointer() as ck:
        t = ck.save(state, str(tmp_path / "ck"), step=4)
        w.mul_(-1.0)
        state["optimizer"]["m"].add_(7.0)
        blocker.release.set()
        assert t.wait(30) and t.committed
    out = tck.load_sharded(str(tmp_path / "ck"), return_tensor=False,
                           device="cpu")
    np.testing.assert_array_equal(out["model"]["w"].numpy(),
                                  np.arange(8.0))
    np.testing.assert_array_equal(out["optimizer"]["m"].numpy(),
                                  np.zeros(3))
    assert out["optimizer"]["global_step"] == 4


def test_snapshot_copies_cpu_tensors_and_arrays():
    t, a = torch.ones(3), np.ones(2, np.float32)
    snap = tac.snapshot({"t": t, "a": a, "s": 2})
    assert snap.events == {}
    t.zero_()
    a[:] = 0
    assert snap.flat["t"].tolist() == [1.0] * 3
    assert snap.flat["a"].tolist() == [1.0] * 2 and snap.flat["s"] == 2
    host = tac._host_flat(snap)
    assert host["t"].tolist() == [1.0] * 3 and snap.flat == {}


def test_port_commit_refuses_a_larger_world(tmp_path, monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    with pytest.raises(NotImplementedError, match="A10"):
        tck.commit_checkpoint({"w": torch.ones(2)}, str(tmp_path / "ck"))
