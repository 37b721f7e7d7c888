"""The port's ``distributed.elastic_runtime`` (the step watchdog and the
heartbeat plane's environment contract) against the JAX package's: the
same deadline behaviour under an injected clock, arming from
``PADDLE_TPU_STEP_DEADLINE_S``, the chaos sites ``host_kill`` (exit 43)
and ``collective_hang`` (the watchdog's exit 121 with a flight dump) in
subprocesses, the cohort generation, and the beacon sender refused
naming A10."""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu.distributed.elastic_runtime import heartbeat as jhb
from paddle_tpu.distributed.elastic_runtime import watchdog as jwd
import paddle_tpu_torch.distributed.elastic_runtime as ter
from paddle_tpu_torch.distributed.elastic_runtime import heartbeat as thb
from paddle_tpu_torch.distributed.elastic_runtime import watchdog as twd
from paddle_tpu_torch.utils import resilience as tres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    tres._reset_fault_injector_for_tests()
    yield
    twd._reset_auto_watchdog_for_tests()
    jwd._reset_auto_watchdog_for_tests()
    tres._reset_fault_injector_for_tests()


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(mod):
    """Arm, advance an injected clock, and record what the watchdog does."""
    clock, fired = _Clock(), []
    wd = mod.StepWatchdog(2.0, on_timeout=lambda s, e: fired.append(
        (s, round(e, 3))), clock=clock, poll_s=0.005)
    out = [wd.disarm(), wd.armed]
    wd.arm(1)
    clock.t += 1.5
    out += [wd.armed, wd.disarm(), wd.fired]
    with wd.guard(2):
        clock.t += 0.5
        out.append(wd.armed)
    wd.arm(3)
    clock.t += 2.5
    deadline = time.monotonic() + 10
    while not fired and time.monotonic() < deadline:
        time.sleep(0.01)
    out += [wd.fired, wd.armed, fired]
    wd.stop()
    return out


def test_deadline_behaviour_agrees():
    assert _drive(twd) == _drive(jwd) == [
        None, False, True, 1.5, False, True, True, False, [(3, 2.5)]]


@pytest.mark.parametrize("deadline", [0, -1.0])
def test_zero_deadline_refused_alike(deadline):
    for mod in (jwd, twd):
        with pytest.raises(ValueError, match="positive"):
            mod.StepWatchdog(deadline)


@pytest.mark.parametrize("value,armed", [(None, False), ("0", False),
                                         ("bad", False), ("5", True)])
def test_auto_watchdog_from_the_environment(monkeypatch, value, armed):
    if value is None:
        monkeypatch.delenv(twd.STEP_DEADLINE_VAR, raising=False)
    else:
        monkeypatch.setenv(twd.STEP_DEADLINE_VAR, value)
    got, want = twd.maybe_auto_watchdog(), jwd.maybe_auto_watchdog()
    assert (got is not None) == (want is not None) == armed
    if armed:
        assert got.deadline_s == want.deadline_s == 5.0
        assert twd.maybe_auto_watchdog() is got     # process-wide
        given = twd.StepWatchdog(1.0)
        assert twd.maybe_auto_watchdog(given) is given
    assert twd.STEP_DEADLINE_VAR == jwd.STEP_DEADLINE_VAR


def test_heartbeat_contract(monkeypatch):
    assert (thb.HEARTBEAT_ADDR_VAR, thb.COHORT_GEN_VAR) == \
        (jhb.HEARTBEAT_ADDR_VAR, jhb.COHORT_GEN_VAR)
    for value in ("3", "x", None):
        if value is None:
            monkeypatch.delenv(thb.COHORT_GEN_VAR, raising=False)
        else:
            monkeypatch.setenv(thb.COHORT_GEN_VAR, value)
        assert thb.cohort_generation() == jhb.cohort_generation()
    monkeypatch.delenv(thb.HEARTBEAT_ADDR_VAR, raising=False)
    assert thb.maybe_auto_sender() is None
    monkeypatch.setenv(thb.HEARTBEAT_ADDR_VAR, "127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="A10"):
        thb.maybe_auto_sender()
    monkeypatch.setenv(twd.STEP_DEADLINE_VAR, "5")
    with pytest.raises(NotImplementedError, match="A10"):
        twd.maybe_auto_watchdog()
    assert ter.HOST_LOST_EXIT_CODE == 121


SCRIPT = """
    from paddle_tpu_torch.distributed.elastic_runtime import StepWatchdog
    from paddle_tpu_torch.observability import flight
    wd = StepWatchdog(0.5)
    flight.record_event("before", {})
    for step in range(3):
        with wd.guard(step):
            pass
    print("DONE", flush=True)
"""


@pytest.mark.parametrize("spec,code", [
    ("host_kill:2:crash", 43), ("collective_hang:3:hang", 121), ("", 0)])
def test_chaos_sites_in_a_subprocess(tmp_path, spec, code):
    script = tmp_path / "wd.py"
    script.write_text(textwrap.dedent(SCRIPT))
    env = dict(os.environ, PYTHONPATH=REPO, PADDLE_TPU_FAULT_SPEC=spec,
               PADDLE_TPU_FAULT_HANG_S="30",
               PADDLE_TPU_FLIGHT_DIR=str(tmp_path / "flight"))
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == code, out.stderr
    assert ("DONE" in out.stdout) == (code == 0)
    dumps = os.listdir(tmp_path / "flight") \
        if os.path.isdir(tmp_path / "flight") else []
    assert len(dumps) == (1 if code == 121 else 0)
    if dumps:
        with open(tmp_path / "flight" / dumps[0]) as f:
            lines = [json.loads(line) for line in f]
        assert lines[0]["reason"] == "host_lost_watchdog_step_2_gen_0"
        fired = [r for r in lines
                 if r.get("kind") == "distributed.watchdog_fired"]
        assert fired and fired[0]["step"] == 2
