"""The launcher CLI: ``python -m paddle_tpu_torch.distributed.launch``
(counterpart of ``paddle_tpu/distributed/launch.py``; reference
``fleet/launch.py:364`` ``launch``, ``launch_utils.py:267`` ``get_cluster``,
``:452`` ``start_local_trainers``, ``:559`` ``watch_local_trainers``,
``:308`` ``terminate_local_procs``).

Each trainer gets the env contract verbatim (``PADDLE_TRAINER_ID``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``) and its device (``FLAGS_selected_gpus``,
its local rank, or the ``--gpus`` entry of its local rank: a repeated
entry puts several ranks on one card, the caller's explicit choice);
``init_parallel_env`` in the trainer turns them into a process group.
The port runs one process per GPU, so ``--nproc_per_node`` defaults to
the CUDA devices this host sees (1 without any); the JAX package runs one
process per TPU host (default 1). ``--backend`` sets
``PADDLE_DISTRI_BACKEND`` for every trainer.

``--elastic`` supervises the ranks instead of tearing the job down on a
failure (:class:`ElasticSupervisor`, over ``distributed/elastic.py``):
restarts with backoff and jitter under ``--max_restarts``, the
preemption exit restarted for free, the divergence exit never, SIGTERM
drained to the children. ``--step_deadline`` arms each trainer's
``StepWatchdog``. The JAX package's cohort supervisor (``--heartbeat``,
``--shrink_on_loss``, ``--spare_ips``: whole-cohort re-formation) is the
second slice of ROADMAP A10, and those options raise naming it.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from .elastic import (PREEMPTION_EXIT_CODE, DIVERGENCE_EXIT_CODE,
                      ELASTIC_ENV_VAR, RestartBudget)
from .elastic_runtime.watchdog import STEP_DEADLINE_VAR


def _visible_devices() -> int:
    """CUDA devices this host sees, without making a CUDA context (the
    trainers make their own)."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is not None:
        return len([d for d in raw.split(",") if d.strip()])
    try:
        import torch
        return torch.cuda.device_count()
    except ImportError:
        return 0


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips (reference: --ips)")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="processes per node (default: the CUDA devices "
                        "this host sees, 1 without any)")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--start_port", type=int,
                   default=int(os.environ.get("FLAGS_START_PORT", "6070")))
    p.add_argument("--log_dir", type=str, default=None,
                   help="per-rank log files (reference: launch_utils.py:544)")
    p.add_argument("--run_mode", type=str, default="collective")
    p.add_argument("--devices", "--gpus", "--selected_devices", type=str,
                   default=None, dest="devices",
                   help="comma-separated CUDA device of each local rank")
    p.add_argument("--backend", type=str, default=None,
                   choices=("nccl", "gloo"),
                   help="the trainers' backend (default NCCL on CUDA)")
    p.add_argument("--elastic", action="store_true",
                   help="supervise ranks: restart failures instead of "
                        "tearing the job down")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="crash-restart budget per job (preemption exits "
                        "are free and do not consume it)")
    p.add_argument("--grace_period", type=float, default=10.0,
                   help="seconds between graceful-drain SIGTERM and SIGKILL")
    p.add_argument("--restart_backoff", type=float,
                   default=float(os.environ.get(
                       "PADDLE_TPU_RESTART_BACKOFF", "1.0")),
                   help="initial restart backoff in seconds (doubles per "
                        "crash, +/-20%% jitter, capped at 30s)")
    # the cohort supervisor's options (the second slice of A10: refused)
    p.add_argument("--step_deadline", type=float, default=0.0,
                   help="guarded-step deadline in seconds: children arm a "
                        "StepWatchdog that converts a hung collective into "
                        "exit 121 (0 = off)")
    p.add_argument("--heartbeat", action="store_true",
                   help="the cohort's heartbeat plane (not ported yet)")
    p.add_argument("--heartbeat_port", type=int, default=0,
                   help="coordinator port (0 = ephemeral)")
    p.add_argument("--heartbeat_interval", type=float, default=None,
                   help="beacon period in seconds (default "
                        "PADDLE_TPU_HEARTBEAT_INTERVAL or 1.0)")
    p.add_argument("--shrink_on_loss", action="store_true",
                   help="re-form without a lost host (not ported yet)")
    p.add_argument("--spare_ips", type=str, default="",
                   help="replacement host ips (not ported yet)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_cluster(ips: List[str], nproc_per_node: int, start_port: int):
    """All (ip, port) endpoints, rank-major (reference: get_cluster)."""
    endpoints = []
    for ip in ips:
        for i in range(nproc_per_node):
            endpoints.append(f"{ip}:{start_port + i}")
    return endpoints


def _spawn_rank(rank: int, local_rank: int, endpoints: List[str],
                script: str, script_args: List[str],
                log_dir: Optional[str] = None,
                extra_env: Optional[dict] = None,
                restart_num: int = 0, devices: Optional[List[str]] = None):
    """Spawn one trainer with the PADDLE_* env contract. Restarts append to
    the same workerlog with a separator so the full history stays in one
    file."""
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_TRAINERS_NUM": str(len(endpoints)),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "FLAGS_selected_devices": str(local_rank),
        "FLAGS_selected_gpus": (devices[local_rank] if devices
                                else str(local_rank)),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_TPU_RESTART_NUM": str(restart_num),
    })
    if extra_env:
        env.update(extra_env)
    cmd = [sys.executable, "-u", script] + list(script_args)
    log_path = None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"workerlog.{rank}")
        log_f = open(log_path, "a" if restart_num else "w")
        if restart_num:
            log_f.write(f"\n----- restart {restart_num} -----\n")
            log_f.flush()
        proc = subprocess.Popen(cmd, env=env, stdout=log_f, stderr=log_f)
        proc._log_file = log_f
    else:
        proc = subprocess.Popen(cmd, env=env)
    proc._rank = rank
    proc._local_rank = local_rank
    proc._log_path = log_path
    return proc


def start_local_trainers(endpoints: List[str], node_ips: List[str],
                         node_rank: int, nproc_per_node: int,
                         script: str, script_args: List[str],
                         log_dir: Optional[str] = None,
                         extra_env: Optional[dict] = None,
                         devices: Optional[List[str]] = None):
    """Spawn this node's trainer processes with the PADDLE_* contract
    (reference: launch_utils.py:452)."""
    base_rank = node_rank * nproc_per_node
    return [_spawn_rank(base_rank + lr, lr, endpoints, script, script_args,
                        log_dir, extra_env, devices=devices)
            for lr in range(nproc_per_node)]


def terminate_local_procs(procs, grace_period: float = 5.0):
    """SIGTERM, wait up to ``grace_period``, then SIGKILL
    (reference: launch_utils.py:308)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace_period
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()  # SIGKILL sent: this only reaps
    for p in procs:
        f = getattr(p, "_log_file", None)
        if f:
            f.close()


def watch_local_trainers(procs) -> int:
    """Poll children; any nonzero exit tears the job down
    (reference: launch_utils.py:559)."""
    alive = list(procs)
    while alive:
        time.sleep(0.2)
        for p in list(alive):
            ret = p.poll()
            if ret is None:
                continue
            alive.remove(p)
            if ret != 0:
                sys.stderr.write(
                    f"trainer rank {p._rank} exited with code {ret}; "
                    f"terminating the job\n")
                terminate_local_procs(alive)
                return ret
    return 0


def _tail_log(path: Optional[str], lines: int = 40) -> str:
    if not path or not os.path.exists(path):
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 64 * 1024))
            data = f.read().decode("utf-8", errors="replace")
        return "\n".join(data.splitlines()[-lines:])
    except OSError as e:
        return f"<could not read {path}: {e}>"


class ElasticSupervisor:
    """Restart failed ranks instead of tearing the job down.

    Semantics (the JAX package's):

    - exit 0            → rank done, not restarted
    - PREEMPTION_EXIT_CODE → graceful drain; restart for free
    - DIVERGENCE_EXIT_CODE → sentinel halted a deterministic numerical
      divergence; never restarted (same state → same NaNs), job torn down
    - other nonzero     → crash; restart with exponential backoff + jitter
      while the shared ``max_restarts`` budget lasts, else tear down and
      propagate that exit code
    - SIGTERM/SIGINT on the supervisor → forward SIGTERM to children
      (their PreemptionGuard commits a final checkpoint), wait
      ``grace_period``, SIGKILL stragglers
    """

    def __init__(self, endpoints, script, script_args, log_dir=None,
                 max_restarts=3, grace_period=10.0, restart_backoff=1.0,
                 extra_env=None, poll_interval=0.2, sleep=time.sleep,
                 node_rank=0, nproc_per_node=None, devices=None):
        self.endpoints = endpoints
        self.node_rank = int(node_rank)
        self.nproc_per_node = (len(endpoints) if nproc_per_node is None
                               else int(nproc_per_node))
        self.script = script
        self.script_args = script_args
        self.log_dir = log_dir
        self.max_restarts = int(max_restarts)
        self.grace_period = float(grace_period)
        self.backoff0 = float(restart_backoff)
        self.poll_interval = poll_interval
        self._sleep = sleep
        self.extra_env = dict(extra_env or {})
        self.extra_env.setdefault(ELASTIC_ENV_VAR, "1")
        # shared accounting object — the serving replica Router reuses the
        # same RestartBudget semantics for replica resurrection
        self.budget = RestartBudget(self.max_restarts, self.backoff0)
        self._drain = False
        self._restart_counts = {}   # rank -> total respawns (incl. free)
        self.devices = devices

    @property
    def restarts_used(self) -> int:
        return self.budget.used

    def request_drain(self, signum=None, frame=None):
        self._drain = True

    def _respawn(self, dead):
        rank = dead._rank
        f = getattr(dead, "_log_file", None)
        if f:
            f.close()
        n = self._restart_counts.get(rank, 0) + 1
        self._restart_counts[rank] = n
        return _spawn_rank(rank, dead._local_rank, self.endpoints,
                           self.script, self.script_args, self.log_dir,
                           self.extra_env, restart_num=n,
                           devices=self.devices)

    def run(self) -> int:
        alive = start_local_trainers(
            self.endpoints, None, self.node_rank, self.nproc_per_node,
            self.script, self.script_args, self.log_dir, self.extra_env,
            self.devices)
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, self.request_drain)
        try:
            while alive:
                if self._drain:
                    sys.stderr.write(
                        "elastic supervisor: draining "
                        f"{len(alive)} rank(s) (grace "
                        f"{self.grace_period}s)\n")
                    terminate_local_procs(alive, self.grace_period)
                    return 1
                self._sleep(self.poll_interval)
                for p in list(alive):
                    ret = p.poll()
                    if ret is None:
                        continue
                    alive.remove(p)
                    f = getattr(p, "_log_file", None)
                    if f:
                        f.close()
                    if ret == 0:
                        continue
                    tail = _tail_log(p._log_path)
                    if tail:
                        sys.stderr.write(
                            f"----- workerlog.{p._rank} (tail) -----\n"
                            f"{tail}\n----- end workerlog.{p._rank} -----\n")
                    if ret == PREEMPTION_EXIT_CODE:
                        sys.stderr.write(
                            f"rank {p._rank} drained after preemption "
                            f"(exit {ret}); restarting (free — budget "
                            f"{self.max_restarts - self.restarts_used} "
                            f"left)\n")
                        alive.append(self._respawn(p))
                        continue
                    if ret == DIVERGENCE_EXIT_CODE:
                        # the sentinel halted a deterministic divergence:
                        # the same state replays the same NaNs, so a
                        # restart only burns budget — tear down instead
                        sys.stderr.write(
                            f"rank {p._rank} halted on numerical "
                            f"divergence (exit {ret}); not restarting — "
                            f"terminating the job\n")
                        terminate_local_procs(alive, self.grace_period)
                        return ret
                    if not self.budget.try_consume():
                        sys.stderr.write(
                            f"rank {p._rank} exited with code {ret}; "
                            f"restart budget ({self.max_restarts}) "
                            f"exhausted — terminating the job\n")
                        terminate_local_procs(alive, self.grace_period)
                        return ret
                    pause = self.budget.pause()
                    sys.stderr.write(
                        f"rank {p._rank} exited with code {ret}; "
                        f"restarting in {pause:.2f}s "
                        f"({self.restarts_used}/{self.max_restarts} "
                        f"restarts used)\n")
                    self._sleep(pause)
                    if self._drain:
                        break
                    alive.append(self._respawn(p))
            return 0
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)
            terminate_local_procs(alive, self.grace_period)


def launch(argv=None) -> int:
    args = _parse_args(argv)
    ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
    nproc = args.nproc_per_node or max(1, _visible_devices())
    devices = None
    if args.devices:
        devices = [d.strip() for d in args.devices.split(",")]
        if len(devices) != nproc:
            raise SystemExit(f"--gpus names {len(devices)} devices for "
                             f"{nproc} local ranks; name one a rank")
    endpoints = get_cluster(ips, nproc, args.start_port)
    extra = {}
    if args.backend:
        extra["PADDLE_DISTRI_BACKEND"] = args.backend
    if args.step_deadline:
        extra[STEP_DEADLINE_VAR] = str(args.step_deadline)

    if args.elastic:
        if args.heartbeat or args.shrink_on_loss or args.spare_ips:
            raise SystemExit(
                "--heartbeat, --shrink_on_loss and --spare_ips belong to the "
                "cohort supervisor, the second slice of ROADMAP A10 (not "
                "ported yet)")
        sup = ElasticSupervisor(
            endpoints, args.training_script, args.training_script_args,
            log_dir=args.log_dir, max_restarts=args.max_restarts,
            grace_period=args.grace_period,
            restart_backoff=args.restart_backoff, extra_env=extra,
            node_rank=args.node_rank, nproc_per_node=nproc,
            devices=devices)
        return sup.run()

    procs = start_local_trainers(
        endpoints, ips, args.node_rank, nproc, args.training_script,
        args.training_script_args, args.log_dir, extra, devices)

    def _sig(_signum, _frame):
        terminate_local_procs(procs, args.grace_period)
        sys.exit(1)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    rc = watch_local_trainers(procs)
    terminate_local_procs(procs)
    return rc


if __name__ == "__main__":
    sys.exit(launch())
