"""The port's ``utils.resilience`` and ``distributed.elastic`` against the
JAX package's: the same fault specs give the same firing sequences and
the same errors for bad specs; ``retry_call`` with an injected clock,
sleep and RNG gives the same attempts and delays; ``Deadline.from_env``
matches; ``crash`` exits 43 in a subprocess; the preemption guard's flag
and exit codes, handler chaining and uninstalling (also after a third
party re-registered the signal); ``RestartBudget``'s pauses equal under
the same seeded ``random.Random``. Signal tests install first, raise,
and uninstall in ``finally``."""
import os
import random
import signal
import subprocess
import sys

import pytest

from paddle_tpu.distributed import elastic as jel
from paddle_tpu.utils import resilience as jres
from paddle_tpu_torch.distributed import elastic as tel
from paddle_tpu_torch.utils import resilience as tres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = ["", "epoch:3:crash", "epoch:1:raise,load:2:corrupt",
         "grads:2:nan, loss:1:nan ,step:4:slow_io",
         "save:1:corrupt,save:3:disk_full,load:1:torn_write",
         "a:1:x,a:2:y,b:1:z,a:5:w"]
BAD = ["epoch-2-crash", "epoch:0:crash", "epoch:x:crash", "epoch:1:",
       ":1:raise", "a:1:b:c", "epoch:2:crash,epoch:2:raise"]


def _firings(mod, spec, sites, n=6):
    fi = mod.FaultInjector(spec)
    out = [fi.armed()] + [fi.armed(s) for s in sites]
    for _ in range(n):
        for s in sites:
            try:
                out.append(fi.fire(s))
            except mod.FaultInjected as e:
                out.append(("raised", str(e)))
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_same_specs_fire_the_same(spec):
    sites = ["epoch", "load", "grads", "loss", "step", "save", "a", "b",
             "other"]
    if "crash" in spec:
        sites = [s for s in sites if s != "epoch"]
    assert _firings(tres, spec, sites) == _firings(jres, spec, sites)


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_fail_alike(spec):
    with pytest.raises(ValueError) as jerr:
        jres.FaultInjector(spec)
    with pytest.raises(ValueError) as terr:
        tres.FaultInjector(spec)
    assert str(terr.value) == str(jerr.value)


def test_env_spec_and_process_injector(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "op:2:raise")
    tres._reset_fault_injector_for_tests()
    try:
        fi = tres.fault_injector()
        assert fi is tres.fault_injector() and fi.armed("op")
        assert fi.fire("op") is None
        with pytest.raises(tres.FaultInjected, match="op:2"):
            fi.fire("op")
    finally:
        tres._reset_fault_injector_for_tests()
    assert tres.FAULT_CRASH_EXIT_CODE == jres.FAULT_CRASH_EXIT_CODE == 43


def test_crash_action_exits_43_in_a_subprocess():
    code = ("from paddle_tpu_torch.utils.resilience import FaultInjector\n"
            "FaultInjector('boom:2:crash').fire('boom')\n"
            "print('FIRST')\n"
            "FaultInjector('boom:1:kill_during_commit').fire('boom')\n"
            "print('UNREACHABLE')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 43, proc.stderr
    assert "FIRST" in proc.stdout and "UNREACHABLE" not in proc.stdout
    assert "[FaultInjector] kill_during_commit at boom:1" in proc.stderr


class _Clock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _retry_trace(mod, fails, seed, deadline_s=None, **kw):
    clock = _Clock()
    rng = random.Random(seed)
    calls, retries = [], []

    def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise OSError(f"transient {len(calls)}")
        return x * 2

    deadline = (mod.Deadline(deadline_s, clock=clock)
                if deadline_s is not None else None)
    try:
        out = mod.retry_call(fn, (21,), sleep=clock.sleep, rng=rng.random,
                             deadline=deadline,
                             on_retry=lambda a, e, p: retries.append(
                                 (a, str(e), p)), **kw)
    except mod.RetryError as e:
        out = ("RetryError", str(e), repr(e.__cause__))
    return out, calls, clock.sleeps, retries


@pytest.mark.parametrize("fails,seed,deadline_s,kw", [
    (0, 0, None, {}),
    (2, 1, None, {}),
    (5, 2, None, dict(max_attempts=4)),
    (6, 3, None, dict(max_attempts=8, backoff=0.1, multiplier=3.0,
                      max_backoff=1.0, jitter=0.5)),
    (9, 4, 2.0, dict(max_attempts=20, backoff=0.5)),
    (1, 5, None, dict(retry_on=(ValueError,))),
])
def test_retry_call_attempts_and_delays_match(fails, seed, deadline_s, kw):
    if kw.get("retry_on") == (ValueError,):
        for mod in (jres, tres):
            with pytest.raises(OSError):
                _retry_trace(mod, fails, seed, **kw)
        return
    assert _retry_trace(tres, fails, seed, deadline_s, **kw) == \
        _retry_trace(jres, fails, seed, deadline_s, **kw)


def test_retry_decorator_and_deadlines(monkeypatch):
    clock = _Clock()
    n = []

    @tres.retry(max_attempts=3, backoff=1.0, sleep=clock.sleep,
                rng=lambda: 0.5)
    def flaky():
        n.append(1)
        if len(n) < 3:
            raise RuntimeError("again")
        return "ok"

    assert flaky() == "ok" and clock.sleeps == [1.0, 2.0]
    assert flaky.__name__ == "flaky"
    for raw, default in (("2.5", None), ("", 7.0), (None, None)):
        if raw is None:
            monkeypatch.delenv("DEADLINE_TEST_S", raising=False)
        else:
            monkeypatch.setenv("DEADLINE_TEST_S", raw)
        c = _Clock()
        t = tres.Deadline.from_env("DEADLINE_TEST_S", default, clock=c)
        j = jres.Deadline.from_env("DEADLINE_TEST_S", default, clock=c)
        assert t.seconds == j.seconds
        c.t = 3.0
        assert t.remaining() == j.remaining()
        assert t.expired() == j.expired()
    d = tres.Deadline(1.0, clock=c)
    c.t += 2.0
    with pytest.raises(tres.DeadlineExceeded, match="op exceeded"):
        d.check("op")
    from paddle_tpu_torch.serving.request import Deadline
    assert Deadline is tres.Deadline


def test_exit_codes_and_supervisor_env(monkeypatch):
    for name in ("PREEMPTION_EXIT_CODE", "DIVERGENCE_EXIT_CODE",
                 "HOST_LOST_EXIT_CODE", "ELASTIC_ENV_VAR"):
        assert getattr(tel, name) == getattr(jel, name)
    assert (tel.PREEMPTION_EXIT_CODE, tel.DIVERGENCE_EXIT_CODE,
            tel.HOST_LOST_EXIT_CODE) == (117, 119, 121)
    monkeypatch.delenv("PADDLE_TPU_ELASTIC", raising=False)
    assert not tel.under_elastic_supervisor()
    assert tel.maybe_auto_guard(None) is None
    g = tel.PreemptionGuard(install=False)
    assert tel.maybe_auto_guard(g) is g
    monkeypatch.setenv("PADDLE_TPU_ELASTIC", "1")
    auto = tel.maybe_auto_guard(None)
    try:
        assert isinstance(auto, tel.PreemptionGuard) and auto._installed
    finally:
        auto.uninstall()


def test_sigterm_sets_the_flag_and_the_exit_code():
    prev = signal.getsignal(signal.SIGTERM)
    g = tel.PreemptionGuard()
    try:
        assert not g.preempted and g._installed
        signal.raise_signal(signal.SIGTERM)
        assert g.preempted and g.should_stop()
        saved = []
        with pytest.raises(SystemExit) as ei:
            g.exit_if_preempted(save_fn=lambda: saved.append(1))
        assert ei.value.code == 117 and saved == [1]
    finally:
        g.uninstall()
        signal.signal(signal.SIGTERM, prev)
    assert signal.getsignal(signal.SIGTERM) == prev
    quiet = tel.PreemptionGuard(install=False)
    quiet.exit_if_preempted(save_fn=lambda: pytest.fail("must not save"))
    quiet.preempt()
    assert quiet.preempted


def test_chained_handlers_run_in_order_and_uninstall():
    order = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: order.append("base"))
    first = tel.ChainedSignalHandler(lambda s, f: order.append("first"),
                                     signals=(signal.SIGUSR1,)).install()
    second = tel.ChainedSignalHandler(lambda s, f: order.append("second"),
                                      signals=(signal.SIGUSR1,)).install()
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert order == ["second", "first", "base"]
        assert first.installed and second.installed
        second.uninstall()
        first.uninstall()
        assert not first.installed
        order.clear()
        signal.raise_signal(signal.SIGUSR1)
        assert order == ["base"]
    finally:
        second.uninstall()
        first.uninstall()
        signal.signal(signal.SIGUSR1, prev)


def test_uninstall_leaves_a_third_party_reregistration_alone():
    original = signal.getsignal(signal.SIGUSR1)

    def third_party(signum, frame):
        pass

    for mod in (tel, jel):
        g = mod.PreemptionGuard(signals=(signal.SIGUSR1,))
        try:
            signal.signal(signal.SIGUSR1, third_party)
            g.uninstall()
            assert signal.getsignal(signal.SIGUSR1) is third_party
        finally:
            signal.signal(signal.SIGUSR1, original)


def test_installing_off_the_main_thread_is_a_no_op():
    import threading
    out = []
    th = threading.Thread(target=lambda: out.append(
        tel.ChainedSignalHandler(lambda s, f: None).install().installed))
    th.start()
    th.join(10)
    assert out == [False]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_restart_budget_pauses_match(seed):
    kw = dict(max_restarts=4, backoff=0.5, cap=3.0)
    j = jel.RestartBudget(rng=random.Random(seed), **kw)
    t = tel.RestartBudget(rng=random.Random(seed), **kw)
    seq_j, seq_t = [], []
    for b, seq in ((j, seq_j), (t, seq_t)):
        for _ in range(6):
            ok = b.try_consume()
            seq.append((ok, b.used, b.remaining,
                        b.pause() if ok else None))
    assert seq_t == seq_j
    assert repr(t) == repr(j)
    for pause in (p for _, _, _, p in seq_t if p is not None):
        assert 0.4 <= pause <= 3.6
