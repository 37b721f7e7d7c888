"""Last-known-good snapshots for the sentinel's ``rollback`` rung
(counterpart of ``paddle_tpu/sentinel/rollback.py``).

Periodic snapshots of model and optimizer state in the sharded format,
each committed atomically with its health stamp
(``incubate.checkpoint.async_ckpt.commit_checkpoint``), and a restore
that walks snapshots newest-first, skipping anything stamped unhealthy
or failing its checksums, and copies the first survivor into the live
tensors in place: a captured train step's next replay reads the
restored state. A missing stamp means healthy. ``async_save=True``
moves the whole snapshot off the step path onto the writer thread.
"""
from __future__ import annotations

import os
import shutil
import threading
import warnings
from typing import Dict, List, Optional

from ..core import monitor as _monitor
from ..incubate.checkpoint.sharded import (
    load_sharded, CheckpointIntegrityError,
    write_health_stamp, read_health_stamp)
from ..incubate.checkpoint.async_ckpt import (
    AsyncCheckpointer, cleanup_stale_staging, commit_checkpoint)
from ..incubate.checkpoint.auto_checkpoint import restore_into, state_of


def _snap_no(name: str) -> Optional[int]:
    suffix = name.split("_", 1)[1] if name.startswith("snap_") else ""
    return int(suffix) if suffix.isdigit() else None


class CheckpointRollback:
    """Snapshot/restore pair used by
    :class:`~paddle_tpu_torch.sentinel.Sentinel`.

    ``model`` and ``optimizer`` are anything with ``state_dict`` /
    ``set_state_dict`` (an ``nn.Layer``, an ``Optimizer``); either may be
    None. ``keep_last`` bounds disk use — but unhealthy-stamped snapshots
    never count against it, so a divergence cannot GC away the last good
    state it will need.
    """

    def __init__(self, path: str, model=None, optimizer=None,
                 keep_last: int = 2, async_save: bool = False):
        self.path = str(path)
        self._model = model
        self._optimizer = optimizer
        self.keep_last = max(1, int(keep_last))
        self._ckpt = AsyncCheckpointer() if async_save else None
        # unhealthy verdicts whose snapshot was still queued/in-flight when
        # the sentinel spoke — applied when that snapshot publishes (the
        # commit hook) or, for snapshots that never publish, consumed and
        # re-checked by the restore walk after draining the writer
        self._unhealthy_lock = threading.Lock()
        self._pending_unhealthy: Dict[int, Optional[str]] = {}
        # orphaned *.tmp staging dirs from a previous crashed run; startup
        # only, so this can never race our own writer
        cleanup_stale_staging(self.path)

    # -- save side -----------------------------------------------------------
    def _snap_dir(self, step: int) -> str:
        return os.path.join(self.path, f"snap_{step}")

    def _state(self) -> dict:
        return state_of(self._model, self._optimizer)

    def snapshot(self, step: int, healthy: bool = True,
                 reason: Optional[str] = None) -> str:
        """Commit one snapshot with its health stamp folded into the same
        atomic publish; GC old *healthy* ones. With ``async_save`` the whole
        fetch+write runs on the writer thread and GC fires post-commit."""
        d = self._snap_dir(step)
        if self._ckpt is not None:
            self._ckpt.save(self._state(), d, step=step, healthy=healthy,
                            reason=reason,
                            on_commit=lambda: self._on_commit(step, d))
        else:
            commit_checkpoint(self._state(), d, healthy=healthy, step=step,
                              reason=reason)
            self._gc()
        return d

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain any in-flight async snapshots (no-op when synchronous)."""
        if self._ckpt is not None:
            return self._ckpt.wait(timeout)
        return True

    def steps(self) -> List[int]:
        if not os.path.isdir(self.path):
            return []
        return sorted(s for s in (_snap_no(n) for n in os.listdir(self.path))
                      if s is not None)

    def _on_commit(self, step: int, d: str):
        """Writer-thread hook, fired strictly after a snapshot's atomic
        publish: apply any ``mark_unhealthy`` verdict that raced the
        in-flight save (the snapshot published with its save-time healthy
        stamp, which the sentinel has since overruled), then GC."""
        with self._unhealthy_lock:
            pending = step in self._pending_unhealthy
            reason = self._pending_unhealthy.pop(step, None)
        if pending:
            write_health_stamp(d, False, step=step, reason=reason)
        self._gc()

    def mark_unhealthy(self, step: int, reason: Optional[str] = None):
        """Retroactively stamp a snapshot bad (the sentinel discovered the
        divergence only after this state was already saved). With
        ``async_save`` the snapshot may still be queued or in flight — the
        verdict is recorded and applied the moment it publishes, so a
        restore can never pick a snapshot the sentinel declared bad."""
        d = self._snap_dir(step)
        if self._ckpt is not None:
            with self._unhealthy_lock:
                self._pending_unhealthy[step] = reason
        if os.path.isdir(d):
            write_health_stamp(d, False, step=step, reason=reason)
            if self._ckpt is not None and d not in self._ckpt.held_paths():
                # the verdict landed on the committed dir and no queued
                # save can republish it — drop the pending entry so a
                # future snapshot at the same step (post-rollback retrain
                # revisits step numbers) is not wrongly poisoned
                with self._unhealthy_lock:
                    self._pending_unhealthy.pop(step, None)

    def _gc(self):
        held = self._ckpt.held_paths() if self._ckpt is not None else ()
        healthy = [s for s in self.steps()
                   if read_health_stamp(self._snap_dir(s)).get("healthy",
                                                               True)]
        for s in healthy[:-self.keep_last]:
            d = self._snap_dir(s)
            if d in held:  # the writer still owns it — never sweep
                continue
            shutil.rmtree(d, ignore_errors=True)

    # -- restore side --------------------------------------------------------
    def restore_newest_healthy(self) -> Optional[int]:
        """Walk snapshots newest-first; restore the first one that is both
        health-stamped healthy (missing stamp = healthy) and integrity-
        intact. Returns the restored step, or None when nothing usable is
        left."""
        self.wait()  # a queued async snapshot may be the newest state
        # verdicts whose snapshot never published (superseded or degraded-
        # skipped saves never fire the commit hook): conservatively stamp
        # any same-step dir that does exist — the sentinel said this step's
        # state diverged, so restoring it is exactly what must not happen
        with self._unhealthy_lock:
            pending = dict(self._pending_unhealthy)
            self._pending_unhealthy.clear()
        for step, reason in pending.items():
            d = self._snap_dir(step)
            if os.path.isdir(d):
                write_health_stamp(d, False, step=step, reason=reason)
        for step in reversed(self.steps()):
            d = self._snap_dir(step)
            stamp = read_health_stamp(d)
            if not stamp.get("healthy", True):
                continue
            try:
                # onto the host: restore_into copies into the live tensors
                state = load_sharded(d, return_tensor=False, device="cpu")
            except (CheckpointIntegrityError, OSError, ValueError,
                    KeyError) as e:
                warnings.warn(
                    f"sentinel rollback: snapshot {d} is not intact ({e}); "
                    f"trying an older one")
                continue
            restore_into(state, self._model, self._optimizer)
            _monitor.stat_add("sentinel.rollbacks", 1)
            return step
        return None
