"""``dist.spawn``: start ``nprocs`` ranks from Python (counterpart of
``paddle_tpu/distributed/spawn_impl.py``; reference
``distributed/spawn.py:333``).

Each child gets the PADDLE_* contract (``PADDLE_TRAINER_ID``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``), its device (``FLAGS_selected_gpus``) and,
when the caller names one, the backend (``PADDLE_DISTRI_BACKEND``), and
runs ``func(*args)``; ``init_parallel_env`` in the child reads them.
Children start with the ``spawn`` method, never a fork (a forked child
would inherit the parent's CUDA context and threads). A child's
exception comes back to the parent as its traceback, and the parent's
``join`` raises it; every join takes a timeout.

Devices: ``gpus=`` (a list or a comma string, one entry a rank) places
the ranks; a repeated entry puts several ranks on one card, which only
the caller can ask for. Without it rank ``i`` gets CUDA device ``i``
(a CPU rank, ``init_parallel_env(device="cpu")``, reads none). The first
endpoint's port is ``start_port`` (default ``FLAGS_START_PORT``, else a
free local port).
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import time
import traceback


def _worker(func, args, rank, nprocs, endpoints, error_queue, env_updates):
    try:
        os.environ.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        })
        os.environ.update(env_updates[rank])
        func(*args)
    except KeyboardInterrupt:
        pass
    except BaseException:
        error_queue.put(traceback.format_exc())
        sys.exit(1)


class MultiprocessContext:
    """The started ranks (reference ``spawn.py`` ``MultiprocessContext``):
    ``join(timeout)`` waits for all of them and raises the first failed
    rank's traceback, terminating the others; a rank still running at
    the timeout is terminated and raises ``TimeoutError``."""

    def __init__(self, processes, error_queues):
        self.processes = processes
        self.error_queues = error_queues

    def terminate(self):
        """Stop every rank still running (SIGTERM, then SIGKILL)."""
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()

    def join(self, timeout=None):
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            failed = [(r, p) for r, p in enumerate(self.processes)
                      if p.exitcode not in (0, None)]
            if failed:
                rank, p = failed[0]
                q = self.error_queues[rank]
                msg = q.get() if not q.empty() else f"exitcode {p.exitcode}"
                self.terminate()
                raise RuntimeError(f"spawned rank {rank} failed:\n{msg}")
            if all(p.exitcode == 0 for p in self.processes):
                return True
            if end is not None and time.monotonic() > end:
                alive = [r for r, p in enumerate(self.processes)
                         if p.is_alive()]
                self.terminate()
                raise TimeoutError(f"spawned ranks {alive} still running "
                                   f"after {timeout} s; terminated")
            for p in self.processes:
                if p.exitcode is None:
                    p.join(0.05)
                    break


def _device_ids(nprocs, gpus):
    if gpus is not None:
        ids = [g.strip() for g in gpus.split(",")] if isinstance(gpus, str) \
            else [str(g) for g in gpus]
        if len(ids) != nprocs:
            raise ValueError(f"gpus names {len(ids)} devices for {nprocs} "
                             f"ranks; name one a rank")
        return ids
    return [str(r) for r in range(nprocs)]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` ranks running ``func(*args)`` (module docstring).
    Options: ``gpus``, ``backend`` ("nccl" or "gloo"), ``start_port``,
    ``ips`` (default "127.0.0.1"), ``env`` (more variables for every
    child), ``timeout`` (seconds for the join, default none). Returns the
    :class:`MultiprocessContext`, joined when ``join``."""
    if nprocs == -1:
        nprocs = max(1, int(os.environ.get("PADDLE_TRAINERS_NUM", "1")))
    port = options.get("start_port", os.environ.get("FLAGS_START_PORT"))
    if port is None:
        from .env import _free_port
        port = _free_port()
    port = int(port)
    ips = options.get("ips", "127.0.0.1")
    endpoints = [f"{ips}:{port + i}" for i in range(nprocs)]
    devices = _device_ids(nprocs, options.get("gpus"))
    extra = dict(options.get("env") or {})
    if options.get("backend"):
        extra["PADDLE_DISTRI_BACKEND"] = str(options["backend"])
    env_updates = [dict(extra, FLAGS_selected_gpus=d) for d in devices]

    ctx = multiprocessing.get_context("spawn")
    processes, queues = [], []
    for rank in range(nprocs):
        q = ctx.SimpleQueue()
        p = ctx.Process(target=_worker,
                        args=(func, args, rank, nprocs, endpoints, q,
                              env_updates),
                        daemon=daemon)
        p.start()
        processes.append(p)
        queues.append(q)
    mp_ctx = MultiprocessContext(processes, queues)
    if join:
        mp_ctx.join(options.get("timeout"))
    return mp_ctx
