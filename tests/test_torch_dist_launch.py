"""The port's process world: the launcher CLI and ``spawn`` write the
reference's env contract, ``init_parallel_env`` reads it into a gloo
world, ``launch --elastic`` restarts a rank that exits with the
preemption code (free of the restart budget) and ``spawn`` carries a
rank's failure and a join's timeout back to the parent. Held against the
JAX package's launcher (``get_cluster``, the contract's names, the
elastic exit codes), as ``tests/test_launch_spawn.py`` runs it. Every
child imports neither JAX nor the JAX package."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.distributed import launch as jlaunch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import env as penv
from paddle_tpu_torch.distributed import launch as plaunch

import torch_dist_worlds as W

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = str(Path(W.__file__))


def _launch(args, timeout=90):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PADDLE_TPU_RESTART_BACKOFF="0.01")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
        + args, cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_cluster_and_exit_codes_are_the_jax_packages():
    for ips, n, port in ((["127.0.0.1"], 2, 6070),
                         (["10.0.0.1", "10.0.0.2"], 4, 7000)):
        assert plaunch.get_cluster(ips, n, port) == \
            jlaunch.get_cluster(ips, n, port)
    assert dist.PREEMPTION_EXIT_CODE == jelastic.PREEMPTION_EXIT_CODE
    assert plaunch.DIVERGENCE_EXIT_CODE == jelastic.DIVERGENCE_EXIT_CODE


def test_nproc_per_node_defaults_to_the_visible_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert plaunch._visible_devices() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert plaunch._visible_devices() == 0
    assert plaunch._parse_args(["x.py"]).nproc_per_node is None


def test_launch_writes_the_contract_init_parallel_env_reads(tmp_path):
    port = penv._free_port()
    r = _launch(["--nproc_per_node", "2", "--backend", "gloo",
                 "--start_port", str(port), SCRIPT, "env", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-3000:]
    eps = jlaunch.get_cluster(["127.0.0.1"], 2, port)
    for rank in range(2):
        with open(tmp_path / f"env{rank}.pkl", "rb") as f:
            rec = pickle.load(f)
        assert rec == {"rank": rank, "world": 2, "endpoint": eps[rank],
                       "endpoints": eps, "device_id": rank,
                       "backend": "gloo", "sum": [3.0, 3.0],
                       "imported": []}


def test_elastic_restarts_a_preempted_rank_for_free(tmp_path):
    r = _launch(["--nproc_per_node", "2", "--elastic", "--max_restarts",
                 "0", "--start_port", str(penv._free_port()), SCRIPT,
                 "preempt", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "drained after preemption" in r.stderr
    # rank 1 ran again as restart 1, under the supervisor's variable
    assert (tmp_path / "preempt1.txt").read_text() == "1 1"
    assert (tmp_path / "preempt0.txt").read_text() == "0 1"


def test_cohort_options_name_the_next_slice(tmp_path):
    r = _launch(["--elastic", "--heartbeat", SCRIPT, "preempt",
                 str(tmp_path)])
    assert r.returncode != 0 and "second slice of ROADMAP A10" in r.stderr


def test_spawn_sets_the_contract_and_devices(tmp_path):
    ctx = dist.spawn(W.record_env, args=(str(tmp_path),), nprocs=3,
                     gpus="0,0,0", backend="gloo", timeout=60)
    assert all(p.exitcode == 0 for p in ctx.processes)
    recs = []
    for rank in range(3):
        with open(tmp_path / f"spawn{rank}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    eps = recs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 3
    for rank, rec in enumerate(recs):
        assert rec == {"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": "3",
                       "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
                       "PADDLE_CURRENT_ENDPOINT": eps[rank],
                       "FLAGS_selected_gpus": "0",
                       "PADDLE_DISTRI_BACKEND": "gloo"}


def test_spawn_carries_a_rank_failure_back():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        dist.spawn(W.fail_on, args=(1,), nprocs=2, timeout=60)


def test_spawn_join_times_out():
    with pytest.raises(TimeoutError):
        dist.spawn(W.sleep_for, args=(60,), nprocs=1, timeout=3)


def test_spawn_refuses_a_device_list_of_the_wrong_length():
    with pytest.raises(ValueError, match="one a rank"):
        dist.spawn(W.sleep_for, args=(0,), nprocs=2, gpus="0")


def test_init_parallel_env_refuses_a_world_without_endpoints(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    with pytest.raises(RuntimeError, match="PADDLE_TRAINER_ENDPOINTS"):
        dist.init_parallel_env(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL backend needs CUDA"):
        dist.init_parallel_env(backend="nccl", device="cpu")


def test_init_retries_a_missed_rendezvous_but_not_a_refusal(monkeypatch):
    calls = []

    def refuse(*a, **k):
        calls.append("refuse")
        raise torch.distributed.DistBackendError("Duplicate GPU detected")
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    with pytest.raises(torch.distributed.DistBackendError):
        penv._init_with_retry("gloo", "tcp://127.0.0.1:1", 2, 0,
                              torch.device("cpu"), 5)
    assert calls == ["refuse"]
    calls.clear()

    def late_store(*a, **k):
        calls.append("try")
        if len(calls) == 1:
            raise torch.distributed.DistNetworkError("store not up")
    monkeypatch.setattr(torch.distributed, "init_process_group", late_store)
    penv._init_with_retry("gloo", "tcp://127.0.0.1:1", 2, 0,
                          torch.device("cpu"), 5)
    assert calls == ["try", "try"]


def test_namespace_has_every_name_of_the_jax_packages():
    """Every public name of the JAX package's ``distributed`` and
    ``distributed.fleet`` namespaces is in the port's; the second
    slice's raise naming it when used. ``bootstrap_pre_backend`` has no
    counterpart (JAX's initialization order only)."""
    import paddle_tpu.distributed as jd
    import paddle_tpu.distributed.fleet as jf
    from paddle_tpu_torch.distributed import fleet as pf
    skip = {"bootstrap_pre_backend", "audit_specs", "pipeline_engine",
            "pipeline_parallel", "moe", "sharded_embedding", "fs",
            "annotations", "np"}
    for jmod, pmod in ((jd, dist), (jf, pf)):
        missing = [n for n in dir(jmod) if not n.startswith("_")
                   and n not in skip and not hasattr(pmod, n)]
        assert not missing, (jmod.__name__, missing)
    for name in ("PipelineLayer", "ShardedEmbedding", "MoELayer"):
        with pytest.raises(NotImplementedError, match="second slice"):
            getattr(pf, name)()
    with pytest.raises(NotImplementedError, match="second slice"):
        dist.CohortSupervisor()
