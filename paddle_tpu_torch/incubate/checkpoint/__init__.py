"""Sharded, async and epoch checkpoints (counterpart of
``paddle_tpu/incubate/checkpoint/__init__.py``; reference:
python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py:71).

A checkpoint is a directory of shard archives and a JSON metadata index
in the JAX package's format (``sharded.py``), so either package loads
the other's. ``async_ckpt`` is the crash-consistent writer (device
snapshots off the step path, a bounded coalescing queue, one atomic
``os.replace`` publish) and ``auto_checkpoint`` the restart-safe epoch
loop. One process on one card; mesh checkpoints and multi-process
commits are the second slice of ROADMAP A10.
"""
from .sharded import (save_sharded, load_sharded, AsyncSaver,  # noqa: F401
                      CheckpointIntegrityError, verify_checkpoint,
                      HEALTH_STAMP_FILE, OLD_SUFFIX, STAGING_SUFFIX,
                      write_health_stamp, read_health_stamp,
                      newest_healthy_checkpoint, swap_eligible)
from .async_ckpt import (AsyncCheckpointer, AsyncCheckpointConfig,  # noqa: F401
                         CommitError, SaveTicket, commit_checkpoint,
                         cleanup_stale_staging)
from .auto_checkpoint import TrainEpochRange, train_epoch_range  # noqa: F401
