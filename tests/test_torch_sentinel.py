"""The port's numerical sentinel against the JAX package's: the loss-spike
detector gives identical z-scores on one seeded stream; the policy
ladder, the config's checks and the probe agree; quarantine dumps read
across packages; and a port ``Sentinel`` on the port's optimizer and a
JAX one on the JAX package's, on the same small network and NumPy data
with NaN injected at the same steps (``grads:N:nan``, ``loss:N:nan``)
and a loss spike, give the same ``AnomalyReport``s (step, reasons,
action, ``rolled_back_to``), losses within 1e-5 and parameters within
1e-5, through skip, quarantine, rollback (with ``lr_rescale``), a
tolerance of 2 and ``check_every``."""
import math
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as jpaddle  # noqa: E402
from paddle_tpu import sentinel as jsen  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.core import monitor as jmon  # noqa: E402
from paddle_tpu.utils import resilience as jres  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import sentinel as tsen  # noqa: E402
from paddle_tpu_torch.core import monitor as tmon  # noqa: E402
from paddle_tpu_torch.utils import resilience as tres  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
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


# -- detector and policy ----------------------------------------------------
def _loss_stream(n=200):
    rng = np.random.default_rng(7)
    s = list(2.0 + 0.1 * rng.standard_normal(n))
    for i in (30, 31, 90, 150):
        s[i] *= 5.0
    s[60], s[61], s[120] = math.nan, math.inf, -0.5
    return s


@pytest.mark.parametrize("kw", [dict(), dict(alpha=0.2, z_threshold=3.0,
                                             warmup_steps=5),
                                dict(alpha=1.0, warmup_steps=0)])
def test_detector_identical_z_scores(kw):
    j, t = jsen.LossSpikeDetector(**kw), tsen.LossSpikeDetector(**kw)
    for v in _loss_stream():
        assert t.update(v) == j.update(v)
        assert (t.mean, t.std, t.warmed_up) == (j.mean, j.std, j.warmed_up)
    assert t.state_dict() == j.state_dict()
    t2 = tsen.LossSpikeDetector(**kw)
    t2.load_state_dict(j.state_dict())
    assert t2.zscore(3.0) == j.zscore(3.0)
    t.reset()
    assert t.mean is None and t.zscore(9.0) == 0.0


@pytest.mark.parametrize("kw", [dict(alpha=0.0), dict(alpha=1.5),
                                dict(z_threshold=0.0)])
def test_detector_validation_alike(kw):
    for mod in (jsen, tsen):
        with pytest.raises(ValueError):
            mod.LossSpikeDetector(**kw)


@pytest.mark.parametrize("ladder,tol", [(tsen.DEFAULT_LADDER, 1),
                                        (("skip_step", "halt"), 2),
                                        (("rollback",), 3)])
def test_policy_rungs_alike(ladder, tol):
    j, t = jsen.PolicyEngine(ladder, tol), tsen.PolicyEngine(ladder, tol)
    assert [t.decide(n) for n in range(12)] == \
        [j.decide(n) for n in range(12)]
    assert tsen.ACTIONS == jsen.ACTIONS
    assert tsen.DEFAULT_LADDER == jsen.DEFAULT_LADDER


@pytest.mark.parametrize("kw", [dict(ladder=("boom",)), dict(ladder=()),
                                dict(check_every=0), dict(tolerance=0)])
def test_config_validation_alike(kw):
    for mod in (jsen, tsen):
        with pytest.raises(ValueError):
            mod.SentinelConfig(**kw)
    assert tsen.SentinelConfig().halt_exit_code == \
        jsen.SentinelConfig().halt_exit_code == 119


# -- the probe --------------------------------------------------------------
@pytest.mark.parametrize("case", ["finite", "nan_grad", "inf_grad",
                                  "neg_inf_grad", "inf_loss", "no_loss",
                                  "bf16"])
def test_probe_agrees(case):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal((3, 4)).astype(np.float32),
             rng.standard_normal(5).astype(np.float32)]
    loss = 1.25
    if case == "nan_grad":
        grads[1][2] = np.nan
    elif case == "inf_grad":
        grads[0][1, 1] = np.inf
    elif case == "neg_inf_grad":
        grads[0][0, 0] = -np.inf
    elif case == "inf_loss":
        loss = np.inf
    elif case == "no_loss":
        loss = None
    tg = [torch.from_numpy(g) for g in grads]
    if case == "bf16":
        tg = [g.to(torch.bfloat16) for g in tg]
    import jax.numpy as jnp
    want = jsen.StepGuard().probe([jnp.asarray(g) for g in grads], loss)
    guard = tsen.StepGuard()
    got = guard.probe(tg, None if loss is None else torch.tensor(
        loss, dtype=torch.float32))
    assert got == want
    # a float loss goes through the guard's device scalar, no copy
    assert guard.probe(tg, loss) == want
    assert tmon.stat_get("sentinel.host_syncs") == 2
    assert tmon.stat_get("sentinel.checks") == 2


def test_probe_is_one_program_a_gradient_signature():
    guard = tsen.StepGuard()
    g = [torch.ones(3), torch.ones(2, 2)]
    for _ in range(3):
        assert guard.probe(g, 1.0) == (True, 1.0)
    g2 = [torch.ones(3), torch.full((2, 2), math.nan)]
    assert guard.probe(g2, 1.0) == (False, 1.0)   # copied into the inputs
    assert len(guard._probes) == 1
    prog = next(iter(guard._probes.values()))
    assert prog.trace_counter["traces"] == 1
    assert guard.probe([torch.ones(4)], None) == (True, None)
    assert len(guard._probes) == 2


def test_poison_fills_in_place():
    net = P.nn.Linear(3, 2, device="cpu")
    opt = P.optimizer.SGD(parameters=net.parameters(), device="cpu")
    for p in net.parameters():
        p.grad = torch.zeros_like(p)
    ptrs = [p.grad.data_ptr() for p in net.parameters()]
    tsen.poison_grads(opt)
    assert [p.grad.data_ptr() for p in net.parameters()] == ptrs
    assert all(torch.isnan(p.grad).all() for p in net.parameters())
    assert math.isnan(tsen.poison_loss(None))
    assert torch.isnan(tsen.poison_loss(torch.ones(()))).item()


# -- quarantine ---------------------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quarantine_dumps_read_across(tmp_path, writer):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    y = rng.integers(0, 5, (4,)).astype(np.int64)
    root = str(tmp_path / "q")
    if writer == "jax":
        import jax.numpy as jnp
        w, r = jsen, tsen
        batch = ([jpaddle.to_tensor(x)], [jnp.asarray(y)])
    else:
        w, r = tsen, jsen
        batch = ([P.to_tensor(x, place="cpu")], [torch.from_numpy(y)])
    d = w.quarantine_batch(root, 7, batch, ["non_finite"], loss=2.5, z=1.5)
    assert d == os.path.join(root, "step_7")
    assert w.quarantine_batch(root, 7, batch, ["again"]) == d
    meta, arrays = r.read_quarantine(d)
    assert (meta["step"], meta["reasons"], meta["loss"], meta["z"]) == \
        (7, ["non_finite"], 2.5, 1.5)
    np.testing.assert_array_equal(arrays["x0"], x)
    np.testing.assert_array_equal(arrays["y0"], y.astype(arrays["y0"].dtype))
    assert meta["inputs"]["x0"] == {"shape": [4, 3], "dtype": "float32"}
    # the cap, the metadata-only entry and the unset root
    assert w.quarantine_batch(root, 8, None, ["x"], max_entries=2)
    assert w.quarantine_batch(root, 9, None, ["x"], max_entries=2) is None
    assert r.read_quarantine(os.path.join(root, "step_8"))[1] == {}
    assert w.quarantine_batch(None, 1, batch, ["x"]) is None


# -- the sentinel, both packages ------------------------------------------
W0 = (np.arange(12, dtype=np.float32).reshape(6, 2) - 6) / 10
B0 = np.array([0.05, -0.1], np.float32)
STEPS = 12


def _data():
    rng = np.random.RandomState(42)
    xs = rng.randn(STEPS, 8, 6).astype(np.float32)
    ys = rng.randn(STEPS, 8, 2).astype(np.float32)
    ys[9] *= 40.0                               # a loss spike at step 9
    return xs, ys


def _job(pkg, tmp_path, cfg_kw, with_rb=True):
    sen = jsen if pkg == "jax" else tsen
    if pkg == "jax":
        net = jpaddle.nn.Linear(6, 2)
        net.set_state_dict({"weight": jpaddle.to_tensor(W0),
                            "bias": jpaddle.to_tensor(B0)})
        opt = jopt.SGD(learning_rate=0.1, parameters=net.parameters())
    else:
        net = P.nn.Linear(6, 2, device="cpu")
        net.set_state_dict({"weight": W0, "bias": B0})
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=net.parameters(),
                              device="cpu")
    rb = sen.CheckpointRollback(str(tmp_path / pkg / "snaps"), model=net,
                                optimizer=opt) if with_rb else None
    cfg = sen.SentinelConfig(quarantine_dir=str(tmp_path / pkg / "q"),
                             **cfg_kw)
    return net, opt, rb, sen.Sentinel(cfg, optimizer=opt, rollback=rb)


def _run(pkg, tmp_path, cfg_kw, snap_at=(1, 5), unhealthy=()):
    net, opt, rb, s = _job(pkg, tmp_path, cfg_kw)
    xs, ys = _data()
    reports, losses, lrs, zs = [], [], [], []
    for i in range(STEPS):
        if pkg == "jax":
            x, y = jpaddle.to_tensor(xs[i]), jpaddle.to_tensor(ys[i])
            loss = jpaddle.mean((net(x) - y) ** 2)
        else:
            x, y = torch.from_numpy(xs[i]), torch.from_numpy(ys[i])
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        s.observe(loss=loss, batch=([x], [y]))
        opt.step()
        opt.clear_grad()
        r = s.last_report
        # the spike's z is formatted into its reason: compared apart
        reports.append((r.step, r.anomalous,
                        [re.sub(r"z=[-0-9.e+]+", "z", v) for v in r.reasons],
                        r.action, r.rolled_back_to))
        zs.append(r.z)
        losses.append(r.loss if r.loss is None or math.isfinite(r.loss)
                      else str(r.loss))
        lrs.append(opt.get_lr())
        if i in snap_at:
            rb.snapshot(i, healthy=i not in unhealthy)
    w = net.weight.numpy() if pkg == "jax" else net.weight.detach().numpy()
    q = sorted(os.listdir(tmp_path / pkg / "q")) \
        if os.path.isdir(tmp_path / pkg / "q") else []
    return reports, losses, lrs, w, q, s.anomalies, zs


SCENARIOS = {
    "skip": (dict(ladder=("skip_step",), warmup_steps=10_000),
             "grads:3:nan,loss:7:nan"),
    "ladder": (dict(ladder=("skip_step", "quarantine_batch", "rollback"),
                    warmup_steps=10_000, lr_rescale=0.5),
               "grads:3:nan,grads:4:nan,grads:5:nan,grads:8:nan"),
    "tolerance2": (dict(ladder=("skip_step", "rollback"), tolerance=2,
                        warmup_steps=10_000),
                   "grads:3:nan,grads:4:nan,grads:5:nan"),
    "spike": (dict(ladder=("skip_step", "quarantine_batch"),
                   warmup_steps=3, z_threshold=3.0),
              "grads:11:nan"),
    "check_every": (dict(ladder=("skip_step",), check_every=2,
                         warmup_steps=10_000),
                    "grads:3:nan,grads:4:nan"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sentinel_reports_agree(name, tmp_path, monkeypatch):
    cfg_kw, spec = SCENARIOS[name]
    _arm(monkeypatch, spec)
    with _nullwarn():
        j = _run("jax", tmp_path, cfg_kw)
        t = _run("port", tmp_path, cfg_kw)
    assert t[0] == j[0]                          # the reports
    assert any(r[1] for r in t[0])
    np.testing.assert_allclose(
        [v for v in t[1] if not isinstance(v, str)],
        [v for v in j[1] if not isinstance(v, str)], rtol=1e-5)
    assert [v for v in t[1] if isinstance(v, str)] == \
        [v for v in j[1] if isinstance(v, str)]
    assert t[2] == j[2]                          # the lr after each step
    np.testing.assert_allclose(t[3], j[3], rtol=1e-5, atol=1e-5)
    assert t[4] == j[4] and t[5] == j[5]         # quarantine, anomalies
    assert [z is None for z in t[6]] == [z is None for z in j[6]]
    np.testing.assert_allclose([z for z in t[6] if z is not None],
                               [z for z in j[6] if z is not None],
                               rtol=1e-5, atol=1e-6)
    assert tmon.stat_get("sentinel.host_syncs") == \
        jmon.stat_get("sentinel.host_syncs")
    for k in ("sentinel.nan_steps", "sentinel.skipped_steps",
              "sentinel.rollbacks", "sentinel.spike_steps",
              "sentinel.quarantined"):
        assert tmon.stat_get(k) == jmon.stat_get(k), k


class _nullwarn:
    """Warnings the scenarios raise on purpose (a rollback with nothing
    healthy yet) are the same in both packages; keep them out of the
    way."""

    def __enter__(self):
        import warnings
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("ignore")

    def __exit__(self, *a):
        return self._cm.__exit__(*a)


def test_rollback_skips_unhealthy_and_restores_in_place(tmp_path):
    net, opt, rb, s = _job("port", tmp_path,
                           dict(ladder=("rollback",), warmup_steps=10_000))
    x, y = torch.ones(8, 6), torch.zeros(8, 2)

    def one(poison=False):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        if poison:
            tsen.poison_grads(opt)
        s.observe(loss=loss)
        opt.step()
        opt.clear_grad()

    one()
    rb.snapshot(0)
    w0 = net.weight.detach().clone()
    ptr = net.weight.data_ptr()
    one()
    rb.snapshot(1)
    rb.mark_unhealthy(1, reason="post-hoc divergence discovery")
    one(poison=True)
    assert s.last_report.rolled_back_to == 0
    assert torch.equal(net.weight.detach(), w0)
    assert net.weight.data_ptr() == ptr          # copied in place
    assert tmon.stat_get("sentinel.rollbacks") == 1
    assert opt._global_step == 1


def test_rollback_gc_keeps_unhealthy_out_of_budget(tmp_path):
    net, opt, rb, s = _job("port", tmp_path, dict(), with_rb=False)
    rb = tsen.CheckpointRollback(str(tmp_path / "snaps"), model=net,
                                 optimizer=opt, keep_last=2)
    for i in range(5):
        rb.snapshot(i, healthy=i != 1)
    assert rb.steps() == [1, 3, 4]
    rb = tsen.CheckpointRollback(str(tmp_path / "asnaps"), model=net,
                                 optimizer=opt, keep_last=1,
                                 async_save=True)
    for i in range(3):
        rb.snapshot(i)
    rb.mark_unhealthy(2, reason="late")
    assert rb.restore_newest_healthy() == 1
    assert rb.steps() == [1, 2]


def test_detach_restores_the_unguarded_step(tmp_path):
    net, opt, rb, s = _job("port", tmp_path, dict(ladder=("skip_step",)),
                           with_rb=False)
    assert opt._sentinel is s
    s.detach()
    assert opt._sentinel is None
    loss = (net(torch.ones(2, 6)) ** 2).mean()
    loss.backward()
    tsen.poison_grads(opt)
    opt.step()
    assert torch.isnan(net.weight).all()
