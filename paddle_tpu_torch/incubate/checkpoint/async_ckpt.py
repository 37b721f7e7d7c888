"""Crash-consistent asynchronous checkpointing (counterpart of
``paddle_tpu/incubate/checkpoint/async_ckpt.py``).

:class:`AsyncCheckpointer` moves a save off the step path:

1. **Snapshot off the step path** — ``save()`` takes an owned copy of
   every tensor where it lives (:func:`snapshot`: ``clone()`` on the
   device's current stream, then one event recorded there) and returns
   without a host sync. The port's optimizer and captured train steps
   update parameters and moments in place, so a stashed reference would
   be overwritten under the writer; the clones are ordered before any
   later kernel or graph replay on that stream, which therefore cannot
   change what is written. The writer thread waits on the event from a
   stream of its own and copies to the host there. (The JAX package
   copies on the device and starts ``copy_to_host_async``, because its
   fused step donates the buffers.) CPU tensors are copied on the host.
   The copies cost one state's bytes of device memory until the writer
   has fetched them.
2. **Bounded queue + coalescing** — at most ``queue_depth`` snapshots
   wait; when full, the oldest unwritten snapshot is superseded by the
   newer one (its ticket reports ``superseded``) instead of blocking the
   trainer.
3. **Two-phase atomic commit** — shards, the sha256 manifest (with the
   health stamp folded in) and the sidecars land in a ``<path>.tmp``
   staging dir, every file and the dir are fsynced, then one
   ``os.replace`` publishes the checkpoint. A re-save over an existing
   path first parks the previous commit as ``<path>.old``, publishes,
   then removes the parked dir, so at every instant a complete
   checkpoint exists; a crash inside that window is recovered at startup
   (:func:`cleanup_stale_staging` renames the parked dir back).

The port commits from one process: a ``torch.distributed`` world larger
than one raises naming ROADMAP A10's second slice (the JAX package's cooperative
per-host commit and its barrier).

I/O failures retry on the writer thread (``utils.resilience.retry_call``)
and then degrade to a skip counted in ``ckpt.async.degraded_skips``: a
full disk loses a snapshot, not the job.

Fault sites (``PADDLE_TPU_FAULT_SPEC``): ``ckpt_fetch``,
``ckpt_shard_write``, ``ckpt_pre_rename``, ``ckpt_swap_window`` (the
previous checkpoint parked, the new one not yet published) and
``ckpt_post_rename`` fire at those stages; the actions
``kill_during_commit`` (hard exit), ``torn_write`` (truncate the staged
archive after checksumming), ``disk_full`` (raise ENOSPC) and
``slow_io`` (stall the writer, ``PADDLE_TPU_FAULT_SLOW_IO_S`` seconds)
are interpreted here.
"""
from __future__ import annotations

import errno
import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from ...core import monitor as _monitor
from ...observability import flight as _flight
from ...observability import tracer as _otrace
from ...utils.resilience import RetryError, fault_injector, retry_call
from .sharded import (HEALTH_STAMP_FILE, OLD_SUFFIX, STAGING_SUFFIX,
                      _flatten, _materialize_host, _process_index, _raw,
                      _sha256_of)

#: injected ``slow_io`` stall per fire (seconds); env-tunable so chaos
#: tests can widen the commit window enough to land a real SIGKILL in it.
SLOW_IO_SECONDS = float(os.environ.get("PADDLE_TPU_FAULT_SLOW_IO_S", "0.25"))


class CommitError(RuntimeError):
    """A checkpoint commit failed after exhausting its I/O retries."""


class Snapshot:
    """Owned copies of one state's leaves (flat key -> copy or scalar) and,
    per CUDA device, the event recorded after its copies."""

    __slots__ = ("flat", "events")

    def __init__(self, flat: Dict[str, Any], events: Dict[Any, Any]):
        self.flat = flat
        self.events = events


def snapshot(state) -> Snapshot:
    """Copy every tensor of ``state`` where it lives, with no host sync:
    a device tensor is cloned on its device's current stream (after every
    kernel already queued there that writes it, before any later one),
    and one event per device is recorded after the clones. Arrays are
    copied, scalars kept."""
    flat: Dict[str, Any] = {}
    devices = set()
    for k, v in _flatten(state).items():
        raw = _raw(v)
        if isinstance(raw, torch.Tensor):
            raw = raw.detach().clone()
            if raw.device.type == "cuda":
                devices.add(raw.device)
        elif isinstance(raw, np.ndarray):
            raw = raw.copy()
        flat[k] = raw
    events = {}
    for d in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events[d] = ev
    return Snapshot(flat, events)


def _host_flat(snap: Snapshot) -> Dict[str, Any]:
    """The snapshot's leaves on the host (writer thread only): per device,
    a stream of this thread's waits on the snapshot's event and copies
    each tensor out; each device copy is released once fetched."""
    streams = {}
    out: Dict[str, Any] = {}
    flat, snap.flat = snap.flat, {}
    for k in list(flat):
        raw = flat.pop(k)
        if isinstance(raw, torch.Tensor) and raw.device.type == "cuda":
            s = streams.get(raw.device)
            if s is None:
                s = streams[raw.device] = torch.cuda.Stream(raw.device)
                s.wait_event(snap.events[raw.device])
            with torch.cuda.stream(s):
                host = raw.cpu()
            raw.record_stream(s)
            raw = host
        out[k] = raw
    return out


def _fire(site: str, shard_path: Optional[str] = None):
    """Count one FaultInjector occurrence of ``site`` and interpret the
    checkpoint actions (``crash``/``kill_during_commit`` and ``raise``
    run inside ``fire`` itself)."""
    action = fault_injector().fire(site)
    if action is None:
        return
    if action == "disk_full":
        raise OSError(errno.ENOSPC, f"injected disk_full at {site}")
    if action == "slow_io":
        time.sleep(SLOW_IO_SECONDS)
    elif action == "torn_write" and shard_path is not None:
        # a write torn after the checksum was recorded: the manifest
        # claims the full digest, verification must catch the mismatch
        size = os.path.getsize(shard_path)
        with open(shard_path, "r+b") as f:
            f.truncate(max(1, size // 2))


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    """fsync a directory so its entries are durable; a filesystem that
    refuses costs durability, not atomicity."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _health_doc(healthy: bool, step: Optional[int],
                reason: Optional[str]) -> Dict[str, Any]:
    doc: Dict[str, Any] = {"healthy": bool(healthy), "time": time.time()}
    if step is not None:
        doc["step"] = int(step)
    if reason is not None:
        doc["reason"] = str(reason)
    return doc


def _write_staged(staging: str, meta, blobs, scalars, health,
                  fsync: bool = True):
    """Phase 1: every checkpoint file into ``staging``, in
    ``save_sharded``'s layout plus the manifest's health doc."""
    if os.path.isdir(staging):  # debris from a writer that died mid-stage
        shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging, exist_ok=True)
    proc = _process_index()
    shards_name = f"shards_{proc}.npz"
    shards_path = os.path.join(staging, shards_name)
    with open(shards_path, "wb") as f:
        np.savez(f, **blobs)
    if fsync:
        _fsync_file(shards_path)
    digest = _sha256_of(shards_path)
    # after the checksum: torn_write must leave a manifest that claims
    # the full digest, so verify-on-load catches the tear
    _fire("ckpt_shard_write", shards_path)
    doc = {"format": 3,
           "checksums": {shards_name: digest},
           "health": dict(health),
           "entries": meta}
    sidecars = [(f"metadata_{proc}.json", doc),
                (HEALTH_STAMP_FILE, dict(health)),
                ("scalars.json", scalars)]
    for name, payload in sidecars:
        p = os.path.join(staging, name)
        with open(p, "w") as f:
            json.dump(payload, f)
        if fsync:
            _fsync_file(p)
    if fsync:
        _fsync_dir(staging)


def _publish(staging: str, final: str):
    """Phase 2, the atomic publish: park a previous commit of ``final`` as
    ``final + ".old"``, rename the staging dir in, remove the parked dir.
    A crash before the last rename leaves only ``*.tmp``/``*.old`` dirs
    (skipped by readers, recovered by the startup sweep); after it, a
    complete checkpoint."""
    _fire("ckpt_pre_rename")
    old = final + OLD_SUFFIX
    if os.path.isdir(old):
        # debris from a previous crashed swap whose final was republished
        shutil.rmtree(old)
    if os.path.isdir(final):
        os.replace(final, old)
        _fire("ckpt_swap_window")
    os.replace(staging, final)
    _fsync_dir(os.path.dirname(os.path.abspath(final)))
    shutil.rmtree(old, ignore_errors=True)
    _fire("ckpt_post_rename")


def _commit_files(path: str, meta, blobs, scalars, health,
                  fsync: bool = True):
    """Land one materialized snapshot at ``path``: stage, then publish."""
    staging = path + STAGING_SUFFIX
    _write_staged(staging, meta, blobs, scalars, health, fsync=fsync)
    _publish(staging, path)


def commit_checkpoint(state, path: str, *, healthy: bool = True,
                      step: Optional[int] = None,
                      reason: Optional[str] = None,
                      fsync: bool = True):
    """Synchronous crash-consistent checkpoint commit: ``save_sharded``'s
    layout published atomically (stage, fsync, one ``os.replace``; a
    re-save parks the previous commit first), the health stamp inside the
    same commit. The cold path (rollback snapshots, tests); the device to
    host copies run on the caller's thread. Returns ``path``."""
    with _otrace.span("checkpoint/commit", {"path": path}):
        _process_index()
        flat = _flatten(state)
        _fire("ckpt_fetch")
        meta, blobs, scalars = _materialize_host(flat)
        health = _health_doc(healthy, step, reason)
        _commit_files(path, meta, blobs, scalars, health, fsync=fsync)
    return path


def cleanup_stale_staging(root: str,
                          held: Optional[Set[str]] = None) -> List[str]:
    """Sweep commit debris under ``root`` left by a writer killed in a
    previous run: orphaned ``*.tmp`` staging dirs are removed; a parked
    ``*.old`` dir is renamed back into place when its final is missing
    (the crash landed in the swap window) and removed otherwise; orphaned
    ``.tmp_*`` files in ``root`` and its checkpoint dirs are removed.
    ``held`` protects paths a live writer owns. Returns the removed
    paths. Startup only: it must never race an in-flight stage."""
    removed: List[str] = []
    recovered = 0
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    for name in names:
        full = os.path.join(root, name)
        if not os.path.isdir(full):
            continue
        if name.endswith(STAGING_SUFFIX):
            if held and full in held:
                continue
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
        elif name.endswith(OLD_SUFFIX):
            final = full[:-len(OLD_SUFFIX)]
            if held and (full in held or final in held):
                continue
            if os.path.isdir(final):
                # the new checkpoint made it: the parked dir is debris
                shutil.rmtree(full, ignore_errors=True)
                removed.append(full)
            else:
                # crash between parking the old commit and publishing the
                # new one: un-park it so the path stays restorable
                os.replace(full, final)
                recovered += 1
    staged_count = len(removed)
    tmp_files = 0
    candidates = [root] + [
        os.path.join(root, n) for n in names
        if not n.endswith(STAGING_SUFFIX) and not n.endswith(OLD_SUFFIX)]
    for d in candidates:
        if held and d in held:
            continue
        try:
            inner = os.listdir(d)
        except (OSError, NotADirectoryError):
            continue
        for fn in inner:
            if not fn.startswith(".tmp_"):
                continue
            fp = os.path.join(d, fn)
            if not os.path.isfile(fp):
                continue
            try:
                os.unlink(fp)
            except OSError:
                continue
            removed.append(fp)
            tmp_files += 1
    if staged_count:
        _monitor.stat_add("ckpt.async.stale_staging_cleaned", staged_count)
    if recovered:
        _monitor.stat_add("ckpt.async.parked_old_recovered", recovered)
    if tmp_files:
        _monitor.stat_add("ckpt.async.orphan_tmp_files_cleaned", tmp_files)
    return removed


class SaveTicket:
    """Handle for one enqueued snapshot. ``wait()`` blocks until it is
    committed, superseded or degraded-skipped; ``error`` is the terminal
    exception of a failed save (never raised on the step path)."""

    __slots__ = ("path", "step", "_done", "committed", "superseded",
                 "error")

    def __init__(self, path: str, step: Optional[int]):
        self.path = path
        self.step = step
        self._done = threading.Event()
        self.committed = False
        self.superseded = False
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once the ticket reached a terminal state."""
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, *, committed: bool = False, superseded: bool = False,
                error: Optional[BaseException] = None):
        if self._done.is_set():
            # terminal states are write-once: a late failure (an on_commit
            # callback) must not un-commit a published ticket
            return
        self.committed = committed
        self.superseded = superseded
        self.error = error
        self._done.set()


class _Pending:
    """One queued snapshot and its commit metadata."""

    __slots__ = ("snap", "path", "health", "on_commit", "ticket")

    def __init__(self, snap, path, health, on_commit, ticket):
        self.snap = snap
        self.path = path
        self.health = health
        self.on_commit = on_commit
        self.ticket = ticket


class AsyncCheckpointConfig:
    """Tunables for :class:`AsyncCheckpointer`."""

    def __init__(self, queue_depth: int = 2, max_attempts: int = 3,
                 backoff: float = 0.05, fsync: bool = True,
                 degrade_on_failure: bool = True):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.queue_depth = int(queue_depth)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff = float(backoff)
        self.fsync = bool(fsync)
        self.degrade_on_failure = bool(degrade_on_failure)


class AsyncCheckpointer:
    """Overlapped, crash-consistent checkpoint writer.

    ::

        ckpt = AsyncCheckpointer()
        for epoch in range(epochs):
            train_one_epoch(...)
            ckpt.save(state, f"{root}/epoch_{epoch}", step=epoch,
                      on_commit=lambda e=epoch: commit_status(e))
        ckpt.wait()     # or close(); SIGTERM paths drain the same way

    ``_pending``, ``_in_flight``, ``_closed`` and ``_thread`` are touched
    only under ``self._cond``; commit work, tickets and callbacks run
    outside it.
    """

    def __init__(self, config: Optional[AsyncCheckpointConfig] = None,
                 registry: Optional[_monitor.StatRegistry] = None):
        self._config = config or AsyncCheckpointConfig()
        self._registry = registry or _monitor.default_registry()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Pending] = []
        self._in_flight: Optional[_Pending] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    @property
    def config(self) -> AsyncCheckpointConfig:
        return self._config

    # -- step-path side (never blocks on I/O or a device fetch) -----------
    def save(self, state, path: str, *, step: Optional[int] = None,
             healthy: bool = True, reason: Optional[str] = None,
             on_commit: Optional[Callable[[], None]] = None) -> SaveTicket:
        """Enqueue one snapshot of ``state`` (:func:`snapshot`: device
        copies, no host sync) for background commit to ``path``; the
        caller may keep training at once. Never raises for I/O trouble and
        never blocks on the queue: a full queue supersedes the oldest
        unwritten snapshot."""
        t0 = time.perf_counter()
        snap = snapshot(state)
        ticket = SaveTicket(path, step)
        item = _Pending(snap, path, _health_doc(healthy, step, reason),
                        on_commit, ticket)
        superseded: List[_Pending] = []
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            while len(self._pending) >= self._config.queue_depth:
                superseded.append(self._pending.pop(0))
            self._pending.append(item)
            self._ensure_writer_locked()
            depth = len(self._pending)
            self._cond.notify_all()
        for old in superseded:
            old.snap.flat = {}      # its device copies go now
            old.ticket._finish(superseded=True)
        reg = self._registry
        reg.add("ckpt.async.saves", 1)
        if superseded:
            reg.add("ckpt.async.superseded", len(superseded))
        reg.set("ckpt.async.queue_depth", depth)
        reg.observe("ckpt.async.enqueue_ms",
                    (time.perf_counter() - t0) * 1e3)
        return ticket

    def _ensure_writer_locked(self):
        """(Re)start the writer thread; the caller holds ``self._cond``. A
        writer killed by an unexpected error is replaced at the next
        save."""
        if self._thread is not None and self._thread.is_alive():
            return
        if self._thread is not None:
            self._registry.add("ckpt.async.writer_restarts", 1)
        self._thread = threading.Thread(
            target=self._run, name="paddle-tpu-ckpt-writer", daemon=True)
        self._thread.start()

    # -- draining ---------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued snapshot reached a terminal state
        (committed, superseded or degraded)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: not self._pending and self._in_flight is None,
                timeout)

    def close(self, timeout: Optional[float] = None):
        """Drain, then stop the writer thread. Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)

    def held_paths(self) -> Set[str]:
        """Final, staging and parked paths the writer still owns:
        checkpoint GC must skip them."""
        with self._cond:
            items = list(self._pending)
            if self._in_flight is not None:
                items.append(self._in_flight)
        out: Set[str] = set()
        for it in items:
            out.add(it.path)
            out.add(it.path + STAGING_SUFFIX)
            out.add(it.path + OLD_SUFFIX)
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- writer thread ----------------------------------------------------
    def _run(self):
        clean_exit = False
        try:
            while True:
                with self._cond:
                    self._cond.wait_for(
                        lambda: self._pending or self._closed)
                    if not self._pending:
                        if self._closed:
                            clean_exit = True
                            return
                        continue
                    item = self._pending.pop(0)
                    self._in_flight = item
                    self._registry.set("ckpt.async.queue_depth",
                                       len(self._pending))
                try:
                    self._process(item)
                finally:
                    with self._cond:
                        self._in_flight = None
                        self._cond.notify_all()
        finally:
            if not clean_exit:
                self._registry.add("ckpt.async.writer_deaths", 1)
                _flight.record_event("ckpt_writer_death", {})
                _flight.dump_if_armed("ckpt_writer_death")

    def _process(self, item: _Pending):
        reg = self._registry
        staging = item.path + STAGING_SUFFIX
        try:
            with _otrace.span("checkpoint/async_write",
                              {"path": item.path}):
                t0 = time.perf_counter()
                _fire("ckpt_fetch")
                meta, blobs, scalars = _materialize_host(
                    _host_flat(item.snap))
                t1 = time.perf_counter()
                reg.observe("ckpt.async.fetch_ms", (t1 - t0) * 1e3)
                retry_call(
                    self._stage_and_publish,
                    (item, meta, blobs, scalars),
                    max_attempts=self._config.max_attempts,
                    backoff=self._config.backoff,
                    retry_on=(OSError,),
                    on_retry=lambda a, e, p: (
                        reg.add("ckpt.async.retries", 1),
                        _flight.record_event(
                            "ckpt_retry",
                            {"path": item.path, "attempt": a,
                             "error": repr(e)})))
                t2 = time.perf_counter()
                reg.observe("ckpt.async.write_ms", (t2 - t1) * 1e3)
            reg.add("ckpt.async.commits", 1)
            item.ticket._finish(committed=True)
        except RetryError as e:
            shutil.rmtree(staging, ignore_errors=True)
            if not self._config.degrade_on_failure:
                item.ticket._finish(error=e)
                raise
            reg.add("ckpt.async.degraded_skips", 1)
            _flight.record_event("ckpt_degraded_skip",
                                 {"path": item.path, "error": repr(e)})
            _flight.dump_if_armed("ckpt_degraded_skip")
            warnings.warn(
                f"async checkpoint to {item.path} failed after "
                f"{self._config.max_attempts} attempts and was skipped "
                f"({e.__cause__!r}); training continues on the previous "
                f"committed checkpoint")
            item.ticket._finish(error=e)
            return
        except Exception as e:
            # a non-I/O failure: the snapshot is lost, the writer and the
            # train loop live on
            shutil.rmtree(staging, ignore_errors=True)
            reg.add("ckpt.async.errors", 1)
            _flight.record_event("ckpt_error",
                                 {"path": item.path, "error": repr(e)})
            warnings.warn(f"async checkpoint to {item.path} failed: {e!r}")
            item.ticket._finish(error=e)
            return
        # the checkpoint is published: a failing post-commit callback is
        # accounted on its own and leaves the ticket committed
        if item.on_commit is not None:
            try:
                item.on_commit()
            except Exception as e:
                reg.add("ckpt.async.on_commit_errors", 1)
                _flight.record_event("ckpt_on_commit_error",
                                     {"path": item.path, "error": repr(e)})
                warnings.warn(
                    f"on_commit callback for committed checkpoint "
                    f"{item.path} failed: {e!r}")

    def _stage_and_publish(self, item: _Pending, meta, blobs, scalars):
        t0 = time.perf_counter()
        _commit_files(item.path, meta, blobs, scalars, item.health,
                      fsync=self._config.fsync)
        self._registry.observe("ckpt.async.commit_ms",
                               (time.perf_counter() - t0) * 1e3)
