"""Chaos campaign for the port's async checkpointer, the counterpart of
``tests/test_chaos_checkpoint.py``: a training subprocess (the port's
``TrainEpochRange(async_save=True)`` on the CPU) is hard-killed at each
station of the commit pipeline (``kill_during_commit``: ``os._exit``,
as a SIGKILL looks to the checkpoint), inside the swap window of a
re-save over the same path, and by a real SIGKILL while ``slow_io``
holds the pre-rename window open. After every crash no published
checkpoint is torn, and a plain rerun resumes from the newest intact
commit to a final state bitwise the uninterrupted run's."""
import os
import random
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from paddle_tpu_torch.incubate.checkpoint import (  # noqa: E402
    OLD_SUFFIX, STAGING_SUFFIX, cleanup_stale_staging, load_sharded,
    verify_checkpoint)
from paddle_tpu_torch.utils.resilience import FAULT_CRASH_EXIT_CODE  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the four commit-pipeline stations, in pipeline order
SITES = ("ckpt_fetch", "ckpt_shard_write", "ckpt_pre_rename",
         "ckpt_post_rename")

# 4 epochs, a save every epoch: the first save and the drained last one
# are always processed, so occurrence 1 or 2 of every site fires
TRAIN_SCRIPT = """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange

    ckpt_dir, out_npz = sys.argv[1], sys.argv[2]
    paddle.set_device("cpu")
    paddle.seed(11)
    net = paddle.nn.Linear(4, 2)
    opt = paddle.optimizer.SGD(learning_rate=0.05,
                               parameters=net.parameters(), device="cpu")
    rng = np.random.RandomState(3)
    X = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
    Y = torch.from_numpy(rng.randn(16, 2).astype(np.float32))

    r = TrainEpochRange(4, "job_chaos", model=net, optimizer=opt,
                        checkpoint_path=ckpt_dir, async_save=True,
                        keep_last=8)
    for epoch in r:
        loss = ((net(X) - Y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        print("epoch", epoch, flush=True)

    np.savez(out_npz, **{k: v.detach().numpy()
                         for k, v in net.state_dict().items()})
    print("TRAIN DONE", flush=True)
"""

RESAVE_SCRIPT = """
    import sys
    import torch
    from paddle_tpu_torch.incubate.checkpoint import commit_checkpoint
    path = sys.argv[1]
    commit_checkpoint({"w": torch.arange(4.0)}, path, step=1)
    commit_checkpoint({"w": torch.arange(4.0) * 2}, path, step=2)
    print("RESAVE DONE", flush=True)
"""


def _script(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return str(p)


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k != "PADDLE_TPU_FAULT_SPEC"}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _run(script, ckpt_dir, out_npz, extra_env=None, timeout=120):
    return subprocess.run(
        [sys.executable, script, str(ckpt_dir), str(out_npz)],
        capture_output=True, text=True, timeout=timeout,
        env=_env(extra_env), cwd=REPO)


def _assert_no_torn_survivor(job_dir):
    if not os.path.isdir(job_dir):
        return
    for name in sorted(os.listdir(job_dir)):
        full = os.path.join(job_dir, name)
        if os.path.isdir(full) and name.startswith("epoch_") \
                and not name.endswith(STAGING_SUFFIX):
            verify_checkpoint(full)


def _assert_bit_identical(golden_npz, got_npz):
    a, b = np.load(golden_npz), np.load(got_npz)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        assert np.array_equal(a[k], b[k]), f"{k} diverged after resume"


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """One uninterrupted run: (script path, final-state npz)."""
    root = tmp_path_factory.mktemp("torch_chaos_golden")
    script = _script(root, "train.py", TRAIN_SCRIPT)
    out = str(root / "golden.npz")
    proc = _run(script, root / "ck", out)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    return script, out


@pytest.mark.parametrize("site", SITES)
def test_kill_during_commit_resumes_bit_identical(site, tmp_path, golden):
    script, golden_npz = golden
    occurrence = random.Random(f"chaos-{site}").choice((1, 2))
    ckpt_dir, out = tmp_path / "ck", str(tmp_path / "out.npz")
    crashed = _run(script, ckpt_dir, out, {
        "PADDLE_TPU_FAULT_SPEC": f"{site}:{occurrence}:kill_during_commit"})
    assert crashed.returncode == FAULT_CRASH_EXIT_CODE, (
        site, occurrence, crashed.stdout, crashed.stderr)
    assert f"[FaultInjector] kill_during_commit at {site}" in crashed.stderr
    assert not os.path.exists(out)
    job_dir = str(ckpt_dir / "job_chaos")
    _assert_no_torn_survivor(job_dir)
    resumed = _run(script, ckpt_dir, out)
    assert resumed.returncode == 0, (resumed.stdout, resumed.stderr)
    _assert_bit_identical(golden_npz, out)
    assert not [n for n in os.listdir(job_dir)
                if n.endswith(STAGING_SUFFIX)]


def test_kill_inside_swap_window_recovers_parked_commit(tmp_path):
    script = _script(tmp_path, "resave.py", RESAVE_SCRIPT)
    path = str(tmp_path / "latest")
    crashed = _run(script, path, "unused", {
        "PADDLE_TPU_FAULT_SPEC": "ckpt_swap_window:1:kill_during_commit"})
    assert crashed.returncode == FAULT_CRASH_EXIT_CODE, (
        crashed.stdout, crashed.stderr)
    assert not os.path.isdir(path) and os.path.isdir(path + OLD_SUFFIX)
    cleanup_stale_staging(str(tmp_path))
    verify_checkpoint(path)
    out = load_sharded(path, return_tensor=False, device="cpu")
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0))
    assert not os.path.isdir(path + OLD_SUFFIX)
    assert not os.path.isdir(path + STAGING_SUFFIX)
    ok = _run(script, path, "unused")
    assert ok.returncode == 0, (ok.stdout, ok.stderr)
    out = load_sharded(path, return_tensor=False, device="cpu")
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0) * 2)


def test_external_sigkill_mid_commit_window(tmp_path, golden):
    script, golden_npz = golden
    ckpt_dir, out = tmp_path / "ck", str(tmp_path / "out.npz")
    job_dir = str(ckpt_dir / "job_chaos")
    proc = subprocess.Popen(
        [sys.executable, script, str(ckpt_dir), out],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
        env=_env({"PADDLE_TPU_FAULT_SPEC": "ckpt_pre_rename:1:slow_io",
                  "PADDLE_TPU_FAULT_SLOW_IO_S": "60"}))
    try:
        deadline = time.monotonic() + 60
        staged = None
        while time.monotonic() < deadline:
            if os.path.isdir(job_dir):
                staged = [n for n in os.listdir(job_dir)
                          if n.endswith(STAGING_SUFFIX)]
                if staged:
                    break
            if proc.poll() is not None:
                pytest.fail(f"trainer exited before staging appeared "
                            f"(rc={proc.returncode})")
            time.sleep(0.02)
        assert staged, "never saw a staging dir inside the slow_io window"
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    _assert_no_torn_survivor(job_dir)
    resumed = _run(script, ckpt_dir, out)
    assert resumed.returncode == 0, (resumed.stdout, resumed.stderr)
    _assert_bit_identical(golden_npz, out)
    assert not [n for n in os.listdir(job_dir)
                if n.endswith(STAGING_SUFFIX)]
