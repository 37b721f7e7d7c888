"""The port's ``FaultToleranceCallback`` and ``AnomalyGuardCallback``
under ``Model.fit``, against the JAX package's: the same losses (1e-5)
and snapshots, a NaN step skipped and its epoch's snapshot stamped
unhealthy, the preemption save and exit code, ``async_save`` archives
the JAX package loads, the watchdog armed around each batch, and a fit
hard-killed mid-epoch (``step:N:crash`` in a subprocess) that resumes
from the last committed epoch to losses bitwise an unbroken run's and
within 1e-5 of the JAX package's."""
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
from paddle_tpu.core import monitor as jmon  # noqa: E402
from paddle_tpu.hapi import callbacks as jcb  # noqa: E402
from paddle_tpu.incubate.checkpoint import load_sharded as jload  # noqa: E402
from paddle_tpu.static import InputSpec  # noqa: E402
from paddle_tpu.utils import resilience as jres  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import monitor as tmon  # noqa: E402
from paddle_tpu_torch.distributed.elastic import (  # noqa: E402
    PREEMPTION_EXIT_CODE, PreemptionGuard)
from paddle_tpu_torch.distributed.elastic_runtime import watchdog as twd  # noqa: E402,E501
from paddle_tpu_torch.hapi import callbacks as tcb  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import (  # noqa: E402
    load_sharded, read_health_stamp)
from paddle_tpu_torch.utils import resilience as tres  # noqa: E402
from paddle_tpu_torch.utils.resilience import FAULT_CRASH_EXIT_CODE  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W0 = (np.arange(8, dtype=np.float32).reshape(4, 2) - 4) / 8
B0 = np.array([0.2, -0.1], np.float32)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for mon in (jmon, tmon):
        for k in list(mon.stats_with_prefix("sentinel.")):
            mon.default_registry().reset(k)
    jres._reset_fault_injector_for_tests()
    tres._reset_fault_injector_for_tests()
    yield
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    jres._reset_fault_injector_for_tests()
    tres._reset_fault_injector_for_tests()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", spec)
    jres._reset_fault_injector_for_tests()
    tres._reset_fault_injector_for_tests()


def _batches(n=4):
    rng = np.random.RandomState(0)
    xs = rng.randn(4 * n, 4).astype("float32")
    ys = (xs @ np.ones((4, 2), np.float32) * 0.5).astype("float32")
    return [(xs[i:i + 4], ys[i:i + 4]) for i in range(0, 4 * n, 4)]


class _Losses(tcb.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.ravel(logs["loss"])[0]))


class _JLosses(jcb.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.ravel(logs["loss"])[0]))


def _port_model():
    net = P.nn.Linear(4, 2, device="cpu")
    net.set_state_dict({"weight": W0, "bias": B0})
    opt = P.optimizer.Adam(learning_rate=0.05, parameters=net.parameters(),
                           device="cpu")
    m = P.Model(net, device="cpu")
    m.prepare(opt, torch.nn.functional.mse_loss)
    return m, net, opt


def _jax_model():
    net = jpaddle.nn.Linear(4, 2)
    net.set_state_dict({"weight": jpaddle.to_tensor(W0),
                        "bias": jpaddle.to_tensor(B0)})
    opt = jopt.Adam(learning_rate=0.05, parameters=net.parameters())
    m = jpaddle.Model(net, inputs=[InputSpec([None, 4], "float32")],
                      labels=[InputSpec([None, 2], "float32")])
    m.prepare(opt, jpaddle.nn.loss.MSELoss())
    return m, net, opt


@pytest.mark.parametrize("spec", [None, "grads:3:nan", "grads:6:nan"])
def test_anomaly_guard_fit_agrees(tmp_path, monkeypatch, spec):
    if spec:
        _arm(monkeypatch, spec)
    m, net, opt = _port_model()
    tguard, tl = tcb.AnomalyGuardCallback(save_dir=str(tmp_path / "t")), \
        _Losses()
    m.fit(_batches(), epochs=2, verbose=0, callbacks=[tguard, tl])
    if spec:
        _arm(monkeypatch, spec)
    jm, jnet, jo = _jax_model()
    jguard, jl = jcb.AnomalyGuardCallback(save_dir=str(tmp_path / "j")), \
        _JLosses()
    jm.fit(_batches(), epochs=2, verbose=0, callbacks=[jguard, jl])
    np.testing.assert_allclose(tl.losses, jl.losses, rtol=1e-5)
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               jnet.weight.numpy(), rtol=1e-5, atol=1e-6)
    assert tguard.sentinel.anomalies == jguard.sentinel.anomalies == \
        (1 if spec else 0)
    assert tguard.rollback.steps() == jguard.rollback.steps()
    for s in tguard.rollback.steps():
        a = read_health_stamp(os.path.join(tguard.rollback.path,
                                           f"snap_{s}"))
        b = read_health_stamp(os.path.join(jguard.rollback.path,
                                           f"snap_{s}"))
        assert (a["healthy"], a.get("reason")) == \
            (b["healthy"], b.get("reason"))
    assert tmon.stat_get("sentinel.host_syncs") == \
        jmon.stat_get("sentinel.host_syncs") == 8
    if spec == "grads:3:nan":       # epoch 0 saw it: stamped unhealthy
        assert not read_health_stamp(os.path.join(
            tguard.rollback.path, "snap_4"))["healthy"]
        q = os.listdir(tmp_path / "t" / "quarantine") \
            if os.path.isdir(tmp_path / "t" / "quarantine") else []
        assert q == []              # one anomaly: the skip rung only


def test_fault_tolerance_async_save_loads_in_the_jax_package(tmp_path):
    m, net, opt = _port_model()
    ft = tcb.FaultToleranceCallback(str(tmp_path / "ft"), async_save=True)
    m.fit(_batches(), epochs=2, verbose=0, callbacks=[ft])
    latest = str(tmp_path / "ft" / "latest")
    assert read_health_stamp(latest)["step"] == 1     # the epoch
    ref = jload(latest, return_tensor=False)
    np.testing.assert_array_equal(np.asarray(ref["model"]["weight"]),
                                  net.weight.detach().numpy())
    assert int(ref["optimizer"]["global_step"]) == 8
    m2, net2, opt2 = _port_model()
    ft2 = tcb.FaultToleranceCallback(str(tmp_path / "ft"))
    ft2.set_model(m2)
    ft2.restore()
    assert torch.equal(net2.weight, net.weight)
    assert opt2._global_step == 8


def test_fault_tolerance_sync_save_and_preemption(tmp_path):
    guard = PreemptionGuard(install=False)
    m, net, opt = _port_model()
    ft = tcb.FaultToleranceCallback(str(tmp_path / "ft"), guard=guard)

    class Preempt(tcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 1:
                guard.preempt()

    with pytest.raises(SystemExit) as ei:
        m.fit(_batches(), epochs=2, verbose=0, callbacks=[Preempt(), ft])
    assert ei.value.code == PREEMPTION_EXIT_CODE
    assert sorted(os.listdir(tmp_path / "ft")) == [
        "preempted.pdopt", "preempted.pdparams"]
    m2, net2, _ = _port_model()
    m2.load(str(tmp_path / "ft" / "preempted"))
    assert torch.equal(net2.weight, net.weight)


def test_fault_tolerance_arms_the_watchdog_each_batch(tmp_path):
    calls = []

    class Spy(twd.StepWatchdog):
        def arm(self, step=None):
            calls.append(step)
            super().arm(step)

    wd = Spy(60.0)
    try:
        m, _, _ = _port_model()
        m.fit(_batches(), epochs=1, verbose=0, callbacks=[
            tcb.FaultToleranceCallback(None, step_watchdog=wd)])
    finally:
        wd.stop()
    assert calls == [0, 1, 2, 3] and not wd.armed


KILL_SCRIPT = """
    import os
    import sys
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import test_torch_fault_callbacks as t
    from paddle_tpu_torch.hapi import callbacks as tcb
    from paddle_tpu_torch.incubate.checkpoint import read_health_stamp
    save_dir, log = sys.argv[1], sys.argv[2]
    m, net, opt = t._port_model()
    start = 0
    if os.path.isdir(save_dir + "/latest"):
        start = read_health_stamp(save_dir + "/latest")["step"] + 1

    class FT(tcb.FaultToleranceCallback):
        # the epochs of this run continue the killed run's
        def on_epoch_end(self, epoch, logs=None):
            super().on_epoch_end(epoch + start, logs)

    ft = FT(save_dir, async_save=True)
    if start:
        ft.set_model(m)
        ft.restore()

    class Drain(tcb.Callback):
        # the epoch's commit lands before the next epoch's first step
        def on_epoch_end(self, epoch, logs=None):
            ft._ckpt.wait()

    class Log(tcb.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch + start

        def on_train_batch_end(self, step, logs=None):
            with open(log, "a") as f:
                f.write(f"{self.epoch} {step} "
                        f"{float(np.ravel(logs['loss'])[0])!r}\\n")

    m.fit(t._batches(), epochs=4 - start, verbose=0,
          callbacks=[Log(), ft, Drain()])
"""


def test_kill_and_resume_through_fit(tmp_path):
    script = tmp_path / "kill.py"
    script.write_text(textwrap.dedent(KILL_SCRIPT))
    log = tmp_path / "losses.txt"
    args = [sys.executable, str(script), str(tmp_path / "ft"), str(log),
            os.path.join(REPO, "tests")]
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_TPU_FAULT_SPEC="step:10:crash")
    crashed = subprocess.run(args, env=env, capture_output=True, text=True,
                             timeout=120, cwd=REPO)
    assert crashed.returncode == FAULT_CRASH_EXIT_CODE, crashed.stderr
    assert read_health_stamp(str(tmp_path / "ft" / "latest"))["step"] == 1
    env.pop("PADDLE_TPU_FAULT_SPEC")
    resumed = subprocess.run(args, env=env, capture_output=True, text=True,
                             timeout=120, cwd=REPO)
    assert resumed.returncode == 0, resumed.stderr
    rows = [line.split() for line in open(log)]
    # epochs 0-1 and epoch 2's first two steps, then epochs 2-3 again
    assert [(int(e), int(s)) for e, s, _ in rows][:10] == \
        [(e, s) for e in range(3) for s in range(4)][:10]
    final = {}
    for e, s, v in rows:
        final[(int(e), int(s))] = float(v)
    m, net, opt = _port_model()
    ref = _Losses()
    m.fit(_batches(), epochs=4, verbose=0, callbacks=[ref])
    assert [final[(e, s)] for e in range(4) for s in range(4)] == ref.losses
    state = load_sharded(str(tmp_path / "ft" / "latest"),
                         return_tensor=False, device="cpu")
    assert torch.equal(state["model"]["weight"], net.weight.detach())
    # and the JAX package's unbroken fit from the same weights and data
    jm, jnet, _ = _jax_model()
    jref = _JLosses()
    jm.fit(_batches(), epochs=4, verbose=0, callbacks=[jref])
    np.testing.assert_allclose([final[(e, s)] for e in range(4)
                                for s in range(4)], jref.losses, rtol=1e-5)
