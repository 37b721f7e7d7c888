"""The port's ``TrainEpochRange`` against the JAX package's: the same
restore decisions (corrupt or half-deleted newest epoch, a malformed dir,
orphaned partial epochs, an unhealthy stamp, a ``mark_unhealthy`` that
races an async save), the preemption commit and exit code, the
environment's root and job id, the watchdog armed around each epoch, and
a job killed mid-epoch (``epoch:N:crash`` in a subprocess) that resumes
to the losses of an unbroken run: bitwise within the port, and within
1e-5 of the JAX package's run from the same weights and data."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.incubate.checkpoint import auto_checkpoint as jauto  # noqa: E402,E501
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.distributed.elastic import (  # noqa: E402
    PREEMPTION_EXIT_CODE, PreemptionGuard)
from paddle_tpu_torch.distributed.elastic_runtime import watchdog as twd  # noqa: E402,E501
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as tauto  # noqa: E402,E501
from paddle_tpu_torch.incubate.checkpoint import (  # noqa: E402
    TrainEpochRange, load_sharded, train_epoch_range)
from paddle_tpu_torch.utils.resilience import FAULT_CRASH_EXIT_CODE  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W0 = np.arange(8, dtype=np.float32).reshape(4, 2) / 10 - 0.3
B0 = np.array([0.1, -0.2], np.float32)


def _data(epochs=5):
    rng = np.random.RandomState(5)
    return (rng.randn(epochs, 8, 4).astype(np.float32),
            rng.randn(epochs, 8, 2).astype(np.float32))


def _port_job(tmp_path, name="jobA", epochs=3, **kw):
    net = P.nn.Linear(4, 2, device="cpu")
    net.set_state_dict({"weight": W0, "bias": B0})
    opt = P.optimizer.Adam(learning_rate=0.05, parameters=net.parameters(),
                           device="cpu")
    r = TrainEpochRange(epochs, name, model=net, optimizer=opt,
                        checkpoint_path=str(tmp_path / "auto"), **kw)
    return net, opt, r


def _port_step(net, opt, x, y):
    loss = ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def _run_port(tmp_path, **kw):
    X, Y = _data()
    net, opt, r = _port_job(tmp_path, **kw)
    return net, opt, r, [_port_step(net, opt, X[e], Y[e]) for e in r]


def _flip_last_byte(d):
    p = os.path.join(d, "shards_0.npz")
    with open(p, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_resume_restores_state_and_epoch(tmp_path):
    net, opt, r, losses = _run_port(tmp_path)
    assert len(losses) == 3 and r.restored_epoch == -1
    net2, opt2, r2 = _port_job(tmp_path)
    assert r2.restored_epoch == 2 and list(r2) == []
    assert torch.equal(net2.weight, net.weight)
    assert opt2._global_step == opt._global_step == 3
    for k, v in opt.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(opt2.state_dict()[k], v), k


@pytest.mark.parametrize("damage", ["corrupt", "half_deleted"])
def test_damaged_newest_epoch_falls_back(tmp_path, damage):
    _run_port(tmp_path)
    job = str(tmp_path / "auto" / "jobA")
    if damage == "corrupt":
        _flip_last_byte(os.path.join(job, "epoch_2"))
    else:
        os.remove(os.path.join(job, "epoch_2", "shards_0.npz"))
    with pytest.warns(UserWarning, match="not intact"):
        _, _, r2 = _port_job(tmp_path)
    assert r2.restored_epoch == 1


def test_malformed_dir_and_orphans(tmp_path):
    job = tmp_path / "auto" / "jobA"
    job.mkdir(parents=True)
    (job / "epoch_2.tmp_partial").mkdir()
    _run_port(tmp_path, keep_last=1)
    assert (job / "epoch_2.tmp_partial").exists()
    assert sorted(os.listdir(job)) == ["epoch_2", "epoch_2.tmp_partial",
                                       "status.json"]
    (job / "epoch_7").mkdir()
    _, _, r2 = _port_job(tmp_path, keep_last=1)
    assert r2.restored_epoch == 2 and not (job / "epoch_7").exists()


def test_unhealthy_stamped_epoch_is_skipped(tmp_path):
    _run_port(tmp_path)
    r = _port_job(tmp_path)[2]
    r.mark_unhealthy(2, reason="diverged")
    with pytest.warns(UserWarning, match="unhealthy"):
        _, _, r2 = _port_job(tmp_path)
    assert r2.restored_epoch == 1


def test_mark_unhealthy_racing_an_async_save(tmp_path):
    X, Y = _data()
    net, opt, r = _port_job(tmp_path, epochs=2, async_save=True)
    for e in r:
        _port_step(net, opt, X[e], Y[e])
        r.mark_unhealthy(e, reason=f"late verdict {e}")
    job = str(tmp_path / "auto" / "jobA")
    for e in (0, 1):
        stamp = tauto.read_health_stamp(os.path.join(job, f"epoch_{e}"))
        assert stamp["healthy"] is False, (e, stamp)
    assert r._pending_unhealthy == {}


def test_preempted_range_commits_and_exits_with_resume_code(tmp_path):
    guard = PreemptionGuard(install=False)
    X, Y = _data()
    net, opt, r = _port_job(tmp_path, name="jobP", epochs=5,
                            preemption_guard=guard)
    done = []
    with pytest.raises(SystemExit) as ei:
        for e in r:
            _port_step(net, opt, X[e], Y[e])
            done.append(e)
            if e == 1:
                guard.preempt()
    assert ei.value.code == PREEMPTION_EXIT_CODE and done == [0, 1]
    _, _, r2 = _port_job(tmp_path, name="jobP", epochs=5)
    assert r2.restored_epoch == 1


def test_environment_root_and_job_id(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("PADDLE_JOB_ID", "edl_job")
    for mod in (tauto, jauto):
        assert mod._default_root() == str(tmp_path)
        assert mod._job_id() == "edl_job"
    r = train_epoch_range(2, save_checkpoint_inter=1)
    assert r.name == "edl_job" and r._dir == str(tmp_path / "edl_job")
    assert list(r) == [0, 1]
    assert tauto.TrainEpochRange(2).restored_epoch == 1
    for name in ("epoch_3", "epoch_x", "epoch_", "ep_3", "epoch_2.tmp"):
        assert tauto._epoch_no(name) == jauto._epoch_no(name)


def test_watchdog_is_armed_around_each_epoch(tmp_path):
    armed = []

    class Spy(twd.StepWatchdog):
        def arm(self, step=None):
            armed.append(("arm", step))
            super().arm(step)

        def disarm(self):
            armed.append(("disarm", None))
            return super().disarm()

    wd = Spy(60.0)
    try:
        _run_port(tmp_path, epochs=2, step_watchdog=wd)
    finally:
        wd.stop()
    assert armed[:4] == [("arm", 0), ("disarm", None), ("arm", 1),
                         ("disarm", None)]


KILL_SCRIPT = """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[3])
    import test_torch_auto_checkpoint as t
    import paddle_tpu_torch as P
    root, log = sys.argv[1], sys.argv[2]
    X, Y = t._data()
    net, opt, r = t._port_job(__import__("pathlib").Path(root), epochs=5)
    for e in r:
        loss = t._port_step(net, opt, X[e], Y[e])
        with open(log, "a") as f:
            f.write(f"{e} {loss!r}\\n")
"""


def _losses(log):
    with open(log) as f:
        return [(int(a), float(b)) for a, b in
                (line.split() for line in f)]


def test_kill_and_resume_matches_unbroken_runs(tmp_path):
    script = tmp_path / "kill.py"
    script.write_text(textwrap.dedent(KILL_SCRIPT))
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_TPU_FAULT_SPEC="epoch:4:crash")
    args = [sys.executable, str(script), str(tmp_path / "job"),
            str(tmp_path / "losses.txt"), os.path.join(REPO, "tests")]
    crashed = subprocess.run(args, env=env, capture_output=True, text=True,
                             timeout=120, cwd=REPO)
    assert crashed.returncode == FAULT_CRASH_EXIT_CODE, crashed.stderr
    assert [e for e, _ in _losses(tmp_path / "losses.txt")] == [0, 1, 2]
    env.pop("PADDLE_TPU_FAULT_SPEC")
    resumed = subprocess.run(args, env=env, capture_output=True, text=True,
                             timeout=120, cwd=REPO)
    assert resumed.returncode == 0, resumed.stderr
    got = _losses(tmp_path / "losses.txt")
    assert [e for e, _ in got] == [0, 1, 2, 3, 4]

    # unbroken, in the port: bitwise
    net, opt, r, ref = _run_port(tmp_path / "unbroken", epochs=5)
    assert [v for _, v in got] == ref
    state = load_sharded(str(tmp_path / "job" / "auto" / "jobA" /
                             "epoch_4"), return_tensor=False, device="cpu")
    assert torch.equal(state["model"]["weight"], net.weight.detach())

    # unbroken, in the JAX package, from the same weights and data
    X, Y = _data()
    jnet = jpaddle.nn.Linear(4, 2)
    jnet.set_state_dict({"weight": jpaddle.to_tensor(W0),
                         "bias": jpaddle.to_tensor(B0)})
    jo = jopt.Adam(learning_rate=0.05, parameters=jnet.parameters())
    jr = jauto.TrainEpochRange(5, "jobJ", model=jnet, optimizer=jo,
                               checkpoint_path=str(tmp_path / "jax"))
    jlosses = []
    for e in jr:
        x, y = jpaddle.to_tensor(X[e]), jpaddle.to_tensor(Y[e])
        loss = jpaddle.mean((jnet(x) - y) ** 2)
        loss.backward()
        jo.step()
        jo.clear_grad()
        jlosses.append(float(loss))
    np.testing.assert_allclose(ref, jlosses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               jnet.weight.numpy(), rtol=1e-5, atol=1e-6)
