"""The process world (counterpart of ``paddle_tpu/distributed/env.py``).

The JAX package is single-controller: one process per host owns every
local chip, and ``init_parallel_env`` turns the reference's env contract
into ``jax.distributed.initialize``. The port runs one process per rank,
as Paddle does on GPUs, and turns the same contract into a
``torch.distributed`` process group:

- ``PADDLE_TRAINER_ID`` (the rank), ``PADDLE_TRAINERS_NUM`` (the world
  size), ``PADDLE_TRAINER_ENDPOINTS`` (every rank's ``ip:port``; the
  first one hosts the TCP store every rank meets at) and
  ``PADDLE_CURRENT_ENDPOINT``, read verbatim, so launch scripts carry
  over. A world of one with no endpoints meets at a free local port.
- the rank's device: ``FLAGS_selected_gpus`` (set by ``launch`` and
  ``spawn``; several ranks on one card is the caller's explicit choice),
  made the current CUDA device and the port's default device
  (``set_device``). ``device="cpu"`` asks for a CPU rank.
- the backend: NCCL for a CUDA rank, gloo for a CPU rank, or what the
  caller names (``backend=``, or ``PADDLE_DISTRI_BACKEND``, which
  ``spawn(backend=)`` sets). NCCL refuses two ranks of one communicator
  on one device; the port keeps that refusal and never switches
  backends by itself. A gloo world with CUDA ranks carries CUDA tensors
  through pinned host memory (``collective.py``), DTensor's collectives
  included.

Bringing the group up retries with backoff within
``PADDLE_TPU_INIT_TIMEOUT`` seconds (default 300), as the JAX package's
``_initialize_distributed_with_retry`` does: workers racing the first
endpoint must wait for its store. The JAX package's
``bootstrap_pre_backend`` has no counterpart: it exists only because JAX
must be initialized before its backend is first touched, and a process
group can be made at any time.
"""
from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta
from typing import Optional

import torch

from ..utils import resilience

_LOG = logging.getLogger(__name__)

#: the rank's device once the group is up (the CPU or one CUDA device)
_DEVICE: list = [None]


class ParallelEnv:
    """The reference's ``ParallelEnv`` (``fluid/dygraph/parallel.py:70``):
    the env contract, with the rank and world size of the process group
    once it is up."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                                "")
        self._device_id = _selected_device_id()

    @property
    def rank(self):
        if is_initialized():
            return torch.distributed.get_rank()
        return self._rank

    local_rank = rank

    @property
    def world_size(self):
        if is_initialized():
            return torch.distributed.get_world_size()
        return self._world_size

    nranks = world_size

    @property
    def device_id(self):
        return self._device_id

    dev_id = device_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._endpoints


def _selected_device_id() -> int:
    raw = os.environ.get("FLAGS_selected_gpus",
                         os.environ.get("FLAGS_selected_devices", "0"))
    return int(raw.split(",")[0] or 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device() -> torch.device:
    """The device of this rank (after :func:`init_parallel_env`)."""
    if _DEVICE[0] is None:
        raise RuntimeError("the process group is not up: call "
                           "distributed.init_parallel_env() first")
    return _DEVICE[0]


def _require_initialized(what: str):
    if not is_initialized():
        raise RuntimeError(f"{what} needs the process group: call "
                           f"distributed.init_parallel_env() first")


def _init_with_retry(backend, init_method, world, rank, device, timeout):
    deadline = resilience.Deadline.from_env("PADDLE_TPU_INIT_TIMEOUT", 300.0)

    def attempt():
        kw = {}
        if device.type == "cuda" and backend == "nccl":
            kw["device_id"] = device        # eager NCCL communicator
        torch.distributed.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=timedelta(seconds=timeout), **kw)

    def on_retry(n, exc, pause):
        _LOG.warning(
            "init_process_group attempt %d against %s failed (%s); retrying "
            "in %.1fs (budget PADDLE_TPU_INIT_TIMEOUT=%ss)", n, init_method,
            exc, pause, deadline.seconds)

    # only a rendezvous that did not happen is worth another attempt (the
    # first endpoint's store not up yet); a backend's refusal (NCCL's
    # "Duplicate GPU detected") would refuse again
    transient = (torch.distributed.DistNetworkError,
                 torch.distributed.DistStoreError, ConnectionError,
                 TimeoutError)
    try:
        resilience.retry_call(attempt, max_attempts=1000, backoff=1.0,
                              max_backoff=15.0, deadline=deadline,
                              retry_on=transient, on_retry=on_retry)
    except resilience.RetryError as e:
        raise RuntimeError(
            f"init_process_group({backend}, {init_method}, world_size="
            f"{world}, rank={rank}) did not come up within "
            f"PADDLE_TPU_INIT_TIMEOUT={deadline.seconds}s") from (
                e.__cause__ or e)


def init_parallel_env(backend: Optional[str] = None, device=None,
                      timeout: float = 600.0) -> ParallelEnv:
    """The reference's ``init_parallel_env`` (``parallel.py:60``): bring
    up the process group from the env contract (module docstring) and
    make the rank's device current. ``device`` is "cuda" (the default;
    raises without CUDA, no fallback) or "cpu"; ``backend`` is "nccl" or
    "gloo" (default NCCL on CUDA, gloo on the CPU). A second call
    returns the same world."""
    from ..core.device import resolve_device
    if is_initialized():
        return ParallelEnv()
    env = ParallelEnv()
    world, rank = env._world_size, env._rank
    dev_type = resolve_device(device).type
    if dev_type == "cuda":
        dev = torch.device("cuda", env.device_id)
        torch.cuda.set_device(dev)
        resolve_device(dev)         # the port's CUDA settings (TF32 off)
    else:
        dev = torch.device("cpu")
    backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} is not 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA ranks")
    eps = [e for e in env.trainer_endpoints if e]
    if eps:
        init_method = f"tcp://{eps[0]}"
    elif world == 1:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    else:
        raise RuntimeError(
            f"PADDLE_TRAINERS_NUM={world} but PADDLE_TRAINER_ENDPOINTS is "
            f"empty: start the ranks with distributed.launch or spawn")
    _init_with_retry(backend, init_method, world, rank, dev, timeout)
    _DEVICE[0] = dev
    if backend == "gloo" and dev.type == "cuda":
        from .collective import stage_functional_collectives
        stage_functional_collectives()
    # the rank's device is where its entry points run by default, as
    # Paddle's trainers set their place
    from ..core.device import set_device
    set_device(dev)
    _LOG.info("process group up: backend=%s rank=%d world=%d device=%s",
              backend, rank, world, dev)
    return ParallelEnv()


def get_rank(group=None) -> int:
    return torch.distributed.get_rank() if is_initialized() else \
        int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None) -> int:
    return torch.distributed.get_world_size() if is_initialized() else \
        int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def is_initialized() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None before it is
    up."""
    return torch.distributed.get_backend() if is_initialized() else None


def destroy_process_group():
    """Take the process group down (and forget the rank's device and the
    global mesh)."""
    from . import mesh
    if is_initialized():
        torch.distributed.destroy_process_group()
    _DEVICE[0] = None
    mesh.set_mesh(None)


def device_count() -> int:
    """The CUDA devices this process sees (the JAX package counts its
    local chips)."""
    return torch.cuda.device_count()
