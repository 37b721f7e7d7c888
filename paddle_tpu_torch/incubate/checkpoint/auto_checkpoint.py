"""Epoch-range auto-checkpoint: restart-safe training loops (counterpart
of ``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``; reference:
python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py:71).

A snapshot is a sharded checkpoint (``sharded.py``) of the registered
model's and optimizer's state under ``<root>/<name>/epoch_<N>``, and
``status.json`` names the last committed epoch. A killed job rebuilt
with the same name resumes at the next unfinished epoch with the state
restored, copied into the live tensors in place (a captured train step
reads it at its next replay). The root is
``PADDLE_EDL_HDFS_CHECKPOINT_PATH``, else ``PADDLE_CHECKPOINT_DIR``,
else ``./paddle_auto_checkpoint``; the name defaults to
``PADDLE_JOB_ID``.

Fault tolerance: restore verifies shard checksums and falls back to the
newest intact committed epoch that is not stamped unhealthy; orphaned
partial epoch dirs and commit debris are removed at startup; under the
elastic supervisor (``PADDLE_TPU_ELASTIC``) the loop polls a
``PreemptionGuard`` and, on preemption, commits a final checkpoint and
exits with the resume code; a ``StepWatchdog`` (given, or from
``PADDLE_TPU_STEP_DEADLINE_S``) is armed around each epoch body.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Dict, Optional

from .sharded import (save_sharded, load_sharded,
                      CheckpointIntegrityError, read_health_stamp,
                      write_health_stamp)
from .async_ckpt import AsyncCheckpointer, cleanup_stale_staging
from ...utils.resilience import fault_injector


def _default_root():
    return os.environ.get("PADDLE_EDL_HDFS_CHECKPOINT_PATH",
                          os.environ.get("PADDLE_CHECKPOINT_DIR",
                                         "./paddle_auto_checkpoint"))


def _job_id():
    return os.environ.get("PADDLE_JOB_ID", "default_job")


def _epoch_no(name: str) -> Optional[int]:
    """epoch_<N> -> N, or None for malformed names (stray dirs left by a
    crash must never abort the commit or GC path)."""
    suffix = name.split("_", 1)[1] if name.startswith("epoch_") else ""
    return int(suffix) if suffix.isdigit() else None


def state_of(model=None, optimizer=None) -> dict:
    """``{"model": ..., "optimizer": ...}`` of the live state (either may
    be None and is then left out)."""
    state = {}
    if model is not None:
        state["model"] = dict(model.state_dict())
    if optimizer is not None:
        state["optimizer"] = dict(optimizer.state_dict())
    return state


def restore_into(state, model=None, optimizer=None):
    """Copy a loaded ``state_of`` tree into ``model`` and ``optimizer`` in
    place (``set_state_dict``, or torch's ``load_state_dict``, which copies
    too), so captured programs read the restored values."""
    if model is not None and "model" in state:
        load = getattr(model, "set_state_dict", None) or \
            model.load_state_dict
        load(state["model"])
    if optimizer is not None and "optimizer" in state:
        optimizer.set_state_dict(state["optimizer"])


class TrainEpochRange:
    """Iterate epochs with automatic save and restore.

    ::

        r = TrainEpochRange(10, "job0", model=model, optimizer=opt)
        for epoch in r:
            train_one_epoch(...)
        # kill + rerun: the loop resumes at the first unfinished epoch
        # with model/optimizer state restored.

    ``async_save=True`` writes through an :class:`AsyncCheckpointer` (the
    status commit runs after the atomic publish); ``preemption_guard=``
    and ``step_watchdog=`` share explicitly armed ones.
    """

    def __init__(self, max_epoch_num: int, name: Optional[str] = None,
                 model=None, optimizer=None, checkpoint_path: Optional[str] = None,
                 save_checkpoint_inter: int = 1, async_save: bool = False,
                 keep_last: int = 2, preemption_guard=None,
                 step_watchdog=None):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name or _job_id()
        self._model = model
        self._optimizer = optimizer
        self._dir = os.path.join(checkpoint_path or _default_root(),
                                 self.name)
        self._inter = max(1, int(save_checkpoint_inter))
        self._keep_last = keep_last
        self._saver = AsyncCheckpointer() if async_save else None
        # mark_unhealthy verdicts for epochs whose async save is still
        # queued or in flight; applied by _commit once it publishes
        self._unhealthy_lock = threading.Lock()
        self._pending_unhealthy: Dict[int, Optional[str]] = {}
        from ...distributed.elastic import maybe_auto_guard
        self._guard = maybe_auto_guard(preemption_guard)
        from ...distributed.elastic_runtime.watchdog import (
            maybe_auto_watchdog)
        self._watchdog = maybe_auto_watchdog(step_watchdog)
        self.restored_epoch = -1
        self._last_saved = -1
        # debris from a writer killed mid-stage in a previous run; startup
        # only, so this can never race our own in-flight saves
        cleanup_stale_staging(self._dir)
        self._restore()

    # -- persistence ------------------------------------------------------
    def _status_path(self):
        return os.path.join(self._dir, "status.json")

    def _epoch_dir(self, epoch):
        return os.path.join(self._dir, f"epoch_{epoch}")

    def _state(self):
        return state_of(self._model, self._optimizer)

    def _committed_epoch(self) -> int:
        sp = self._status_path()
        if not os.path.exists(sp):
            return -1
        try:
            with open(sp) as f:
                status = json.load(f)
            return int(status.get("epoch_no", -1))
        except (ValueError, OSError):
            # a torn status.json: no commit, rather than a dead restart
            return -1

    def _gc_orphans(self, committed: int):
        """Remove partial epoch dirs newer than the committed epoch (startup
        only, so this never races an in-flight async save)."""
        if not os.path.isdir(self._dir):
            return
        for name in os.listdir(self._dir):
            e = _epoch_no(name)
            if e is not None and e > committed:
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)

    def _restore(self):
        committed = self._committed_epoch()
        self._gc_orphans(committed)
        if committed < 0:
            return
        # the referenced epoch first, then older surviving epoch dirs
        candidates = sorted(
            {e for e in (_epoch_no(n) for n in os.listdir(self._dir))
             if e is not None and e <= committed},
            reverse=True)
        for epoch in candidates:
            ckpt = self._epoch_dir(epoch)
            if not os.path.isdir(ckpt):
                continue
            stamp = read_health_stamp(ckpt)
            if not stamp.get("healthy", True):
                warnings.warn(
                    f"auto_checkpoint: epoch {epoch} checkpoint at {ckpt} "
                    f"is stamped unhealthy "
                    f"({stamp.get('reason', 'no reason recorded')}); "
                    f"falling back to an older epoch")
                continue
            try:
                # onto the host: restore_into copies into the live tensors
                state = load_sharded(ckpt, return_tensor=False,
                                     device="cpu")
            except (CheckpointIntegrityError, OSError, ValueError,
                    KeyError) as e:
                warnings.warn(
                    f"auto_checkpoint: epoch {epoch} checkpoint at {ckpt} "
                    f"is not intact ({e}); falling back to an older epoch")
                continue
            restore_into(state, self._model, self._optimizer)
            self.restored_epoch = epoch
            self._last_saved = epoch
            return

    def mark_unhealthy(self, epoch: int, reason: Optional[str] = None):
        """Stamp an already-saved epoch numerically bad (the sentinel saw
        the divergence after the save); a restore then skips it. With
        ``async_save`` the verdict is held and applied when the epoch's
        snapshot publishes."""
        ckpt = self._epoch_dir(epoch)
        if self._saver is not None:
            with self._unhealthy_lock:
                self._pending_unhealthy[epoch] = reason
        if os.path.isdir(ckpt):
            write_health_stamp(ckpt, False, step=epoch, reason=reason)
            if (self._saver is not None
                    and ckpt not in self._saver.held_paths()):
                # applied, and nothing in flight can republish it: don't
                # poison a future same-epoch save
                with self._unhealthy_lock:
                    self._pending_unhealthy.pop(epoch, None)

    def _commit(self, epoch: int):
        # a mark_unhealthy verdict that raced this epoch's in-flight save
        with self._unhealthy_lock:
            pending = epoch in self._pending_unhealthy
            reason = self._pending_unhealthy.pop(epoch, None)
        if pending:
            write_health_stamp(self._epoch_dir(epoch), False, step=epoch,
                               reason=reason)
        # status.json only after the shard files exist, through a
        # per-process .tmp_ file and os.replace
        sp = self._status_path()
        tmp = os.path.join(self._dir, f".tmp_status_{os.getpid()}.json")
        with open(tmp, "w") as f:
            json.dump({"epoch_no": epoch, "max_epoch_num": self.max_epoch_num},
                      f)
        os.replace(tmp, sp)
        self._gc(epoch)

    def save(self, epoch: int):
        ckpt = self._epoch_dir(epoch)
        self._last_saved = epoch
        if self._saver is not None:
            # the fetch, the write and the status commit run on the
            # writer thread; status.json only names a published checkpoint
            self._saver.save(self._state(), ckpt, step=epoch,
                             on_commit=lambda: self._commit(epoch))
        else:
            save_sharded(self._state(), ckpt)
            self._commit(epoch)

    def _gc(self, current):
        if self._keep_last is None:
            return
        held = self._saver.held_paths() if self._saver is not None else ()
        for name in os.listdir(self._dir):
            full = os.path.join(self._dir, name)
            if full in held:
                continue  # the writer still owns it
            e = _epoch_no(name)
            if e is None:
                continue
            if e <= current - self._keep_last * self._inter:
                shutil.rmtree(full, ignore_errors=True)

    # -- iteration --------------------------------------------------------
    def get(self):
        return iter(self)

    def wait(self):
        if self._saver is not None:
            self._saver.wait()

    def _poll_preemption(self, epoch: int):
        if self._guard is None or not self._guard.preempted:
            return
        if self._last_saved < epoch:
            self.save(epoch)
        self.wait()  # the final checkpoint is committed before the exit
        self._guard.exit_if_preempted()

    def __iter__(self):
        try:
            for epoch in range(self.restored_epoch + 1, self.max_epoch_num):
                # fault site "epoch": "epoch:N:crash" hard-kills the Nth
                # iteration of this process, mid-epoch
                fault_injector().fire("epoch")
                if self._watchdog is not None:
                    self._watchdog.arm(epoch)
                yield epoch
                if self._watchdog is not None:
                    self._watchdog.disarm()
                if ((epoch + 1) % self._inter == 0
                        or epoch == self.max_epoch_num - 1):
                    self.save(epoch)
                self._poll_preemption(epoch)
        finally:
            if self._watchdog is not None:
                self._watchdog.disarm()
            self.wait()  # don't exit with an uncommitted in-flight save


def train_epoch_range(max_epoch_num, save_checkpoint_inter=1, **kw):
    """Function form (reference: auto_checkpoint.py train_epoch_range)."""
    return TrainEpochRange(max_epoch_num,
                           save_checkpoint_inter=save_checkpoint_inter, **kw)
