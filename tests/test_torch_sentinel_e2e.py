"""End-to-end counterparts of ``tests/test_sentinel_e2e.py`` for the port:

- a NaN injected under ``skip_step`` leaves parameters and moments
  bitwise those of a run that skipped that update by hand, in the dygraph
  loop and through ``Model.train_batch``'s sentinel route (the captured
  gradients program, ``.grad`` bound to its buffers, the eager step);
- one host sync a guarded step over a whole run (``sentinel.host_syncs``);
- a ``rollback`` restores the newest healthy snapshot in place (the
  program's next call reads it) and training completes;
- ``halt`` exits with ``DIVERGENCE_EXIT_CODE`` in a subprocess and
  leaves a flight dump (the supervisor half waits for A10's launcher);
- an AST scan, standing for the JAX package's PTA002 check, finds
  exactly one host fetch in the sentinel's hot modules, in ``guard.py``.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import sentinel  # noqa: E402
from paddle_tpu_torch.core import monitor  # noqa: E402
from paddle_tpu_torch.distributed.elastic import DIVERGENCE_EXIT_CODE  # noqa: E402,E501
from paddle_tpu_torch.utils import resilience  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAN_STEP = 3          # 1-based fire count == 0-based sentinel step 2
TOTAL_STEPS = 8


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    resilience._reset_fault_injector_for_tests()
    for k in list(monitor.stats_with_prefix("sentinel.")):
        monitor.default_registry().reset(k)
    yield
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    resilience._reset_fault_injector_for_tests()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", spec)
    resilience._reset_fault_injector_for_tests()


def _data():
    rng = np.random.RandomState(42)
    return (rng.randn(TOTAL_STEPS, 8, 6).astype("float32"),
            rng.randn(TOTAL_STEPS, 8, 2).astype("float32"))


def _net():
    P.seed(0)
    return P.nn.Sequential(P.nn.Linear(6, 16, device="cpu"), P.nn.Tanh(),
                           P.nn.Linear(16, 2, device="cpu"))


def _job(ladder, tmp_path=None, guarded=True, **cfg_kw):
    net = _net()
    opt = P.optimizer.AdamW(learning_rate=0.01, parameters=net.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0),
                            device="cpu")
    rb = None
    if tmp_path is not None:
        rb = sentinel.CheckpointRollback(str(tmp_path / "snaps"), model=net,
                                         optimizer=opt)
    cfg_kw.setdefault("warmup_steps", 10_000)
    s = sentinel.Sentinel(sentinel.SentinelConfig(ladder=ladder, **cfg_kw),
                          optimizer=opt if guarded else None, rollback=rb)
    return net, opt, rb, s


def _state(net, opt):
    out = {k: v.detach().clone() for k, v in net.state_dict().items()}
    out.update({k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in opt.state_dict().items()})
    return out


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _dygraph(net, opt, s=None, skip_at=None, snapshot_rb=None,
             snapshot_at=None):
    xs, ys = _data()
    losses = []
    for i in range(TOTAL_STEPS):
        x, y = torch.from_numpy(xs[i]), torch.from_numpy(ys[i])
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        if s is not None:
            s.observe(loss=loss, batch=([x], [y]))
        if i == skip_at:
            opt.clear_grad()        # the reference run: drop this update
        else:
            opt.step()
            opt.clear_grad()
        losses.append(float(loss.detach()))
        if snapshot_rb is not None and i == snapshot_at:
            snapshot_rb.snapshot(i)
    return losses


def test_injected_nan_skip_is_bitwise_a_manual_skip(monkeypatch):
    _arm(monkeypatch, f"grads:{NAN_STEP}:nan")
    net_a, opt_a, _, s = _job(("skip_step",))
    losses_a = _dygraph(net_a, opt_a, s)
    _arm(monkeypatch, "")
    assert monitor.stat_get("sentinel.nan_steps") == 1
    assert monitor.stat_get("sentinel.skipped_steps") == 1
    assert opt_a._global_step == TOTAL_STEPS - 1
    net_b, opt_b, _, _ = _job(("skip_step",), guarded=False)
    losses_b = _dygraph(net_b, opt_b, skip_at=NAN_STEP - 1)
    _assert_bitwise(_state(net_a, opt_a), _state(net_b, opt_b))
    assert losses_a == losses_b and all(np.isfinite(losses_a))


def test_one_host_sync_per_guarded_step_over_a_run():
    net, opt, _, s = _job(("skip_step",))
    _dygraph(net, opt, s)
    assert monitor.stat_get("sentinel.host_syncs") == TOTAL_STEPS


def test_rollback_restores_last_healthy_and_completes(tmp_path,
                                                      monkeypatch):
    _arm(monkeypatch, f"grads:{NAN_STEP}:nan")
    net, opt, rb, s = _job(("rollback",), tmp_path=tmp_path)
    losses = _dygraph(net, opt, s, snapshot_rb=rb, snapshot_at=1)
    assert all(np.isfinite(losses))
    assert monitor.stat_get("sentinel.rollbacks") == 1
    assert rb.steps() == [1]


# -- through Model.train_batch's sentinel route -------------------------------
def _model(guard_ladder=None, tmp_path=None):
    net = _net()
    opt = P.optimizer.AdamW(learning_rate=0.01, parameters=net.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0),
                            device="cpu")
    s = rb = None
    if guard_ladder is not None:
        if tmp_path is not None:
            rb = sentinel.CheckpointRollback(str(tmp_path / "msnaps"),
                                             model=net, optimizer=opt)
        s = sentinel.Sentinel(sentinel.SentinelConfig(
            ladder=guard_ladder, warmup_steps=10_000), optimizer=opt,
            rollback=rb)
    m = P.Model(net, device="cpu")
    m.prepare(opt, torch.nn.functional.mse_loss)   # takes a guarded opt
    return m, net, opt, s, rb


def test_model_route_skip_is_bitwise_a_manual_skip(monkeypatch):
    xs, ys = _data()
    _arm(monkeypatch, f"grads:{NAN_STEP}:nan")
    m, net, opt, s, _ = _model(("skip_step",))
    losses_a = [m.train_batch([xs[i]], [ys[i]])[0]
                for i in range(TOTAL_STEPS)]
    _arm(monkeypatch, "")
    ts = m._train_step_fn
    assert ts["grads_fn"].trace_counter["traces"] == 1
    assert ts["fn"].trace_counter["traces"] == 0    # the fused step: never
    assert monitor.stat_get("sentinel.host_syncs") == TOTAL_STEPS
    assert monitor.stat_get("sentinel.skipped_steps") == 1
    assert opt._global_step == TOTAL_STEPS - 1
    assert all(p.grad is None for p in net.parameters())
    # the run that skipped batch K's update by hand (guarded, no fault)
    m2, net2, opt2, _, _ = _model(("skip_step",))
    losses_b = []
    for i in range(TOTAL_STEPS):
        if i == NAN_STEP - 1:
            losses_b.append(m2.train_batch([xs[i]], [ys[i]],
                                           update=False)[0])
            opt2.clear_grad()
        else:
            losses_b.append(m2.train_batch([xs[i]], [ys[i]])[0])
    _assert_bitwise(_state(net, opt), _state(net2, opt2))
    assert losses_a == losses_b


def test_model_route_binds_grads_to_the_program_buffers(monkeypatch):
    xs, ys = _data()
    m, net, opt, s, _ = _model(("skip_step",))
    seen = []
    real = s.approve_step

    def spy(o):
        seen.append([p.grad.data_ptr() for p in net.parameters()])
        return real(o)

    s.approve_step = spy
    for i in range(3):
        m.train_batch([xs[i]], [ys[i]])
    assert seen[0] == seen[1] == seen[2]       # the same buffers each step
    probe = next(iter(s.guard._probes.values()))
    assert probe.trace_counter["traces"] == 1


def test_model_route_rollback_copies_in_place(tmp_path, monkeypatch):
    xs, ys = _data()
    m, net, opt, s, rb = _model(("rollback",), tmp_path=tmp_path)
    m.train_batch([xs[0]], [ys[0]])
    rb.snapshot(0)
    snap = _state(net, opt)
    ptrs = [p.data_ptr() for p in net.parameters()]
    m.train_batch([xs[1]], [ys[1]])
    _arm(monkeypatch, "grads:1:nan")
    m.train_batch([xs[2]], [ys[2]])            # NaN -> rollback to snap 0
    _arm(monkeypatch, "")
    assert s.last_report.rolled_back_to == 0
    _assert_bitwise(_state(net, opt), snap)
    assert [p.data_ptr() for p in net.parameters()] == ptrs
    assert opt._global_step == 1
    loss, _ = m.train_batch([xs[3]], [ys[3]])  # training completes
    assert np.isfinite(loss) and opt._global_step == 2


def test_train_batches_and_train_loop_do_not_consult_the_sentinel():
    xs, ys = _data()
    m, net, opt, s, _ = _model(("skip_step",))
    m.train_batches(xs[:3], ys[:3])
    m.train_loop(xs[:3], ys[:3])
    assert monitor.stat_get("sentinel.host_syncs") == 0
    assert opt._global_step == 6


HALT_SCRIPT = """
    import sys
    import numpy as np
    import torch
    import paddle_tpu_torch as P
    from paddle_tpu_torch import sentinel
    from paddle_tpu_torch.observability import flight
    flight.arm()
    net = P.nn.Linear(4, 2, device="cpu")
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=net.parameters(),
                          device="cpu")
    sentinel.Sentinel(sentinel.SentinelConfig(
        ladder=("halt",), quarantine_dir=sys.argv[1]), optimizer=opt)
    m = P.Model(net, device="cpu")
    m.prepare(opt, torch.nn.functional.mse_loss)
    x = np.ones((2, 4), np.float32)
    m.fit([(x, np.zeros((2, 2), np.float32))] * 3, verbose=0)
    print("NOT HALTED", flush=True)
"""


def test_halt_exits_with_the_divergence_code(tmp_path):
    script = tmp_path / "halt.py"
    script.write_text(textwrap.dedent(HALT_SCRIPT))
    flight_dir = tmp_path / "flight"
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_TPU_FAULT_SPEC="grads:2:nan",
               PADDLE_TPU_FLIGHT_DIR=str(flight_dir))
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "q")],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == DIVERGENCE_EXIT_CODE, (out.stdout, out.stderr)
    assert "NOT HALTED" not in out.stdout
    assert "[sentinel] halting at step 1" in out.stderr
    dumps = os.listdir(flight_dir)
    assert len(dumps) == 1
    with open(flight_dir / dumps[0]) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["reason"] == "sentinel_halt"
    events = [r for r in lines if r.get("kind") == "sentinel"]
    assert [(e["action"], e["step"]) for e in events] == [("halt", 1)]
    assert sorted(os.listdir(tmp_path / "q")) == ["step_1"]


#: the sentinel's step-path modules (quarantine and rollback run only
#: after an anomaly)
HOT = ("guard.py", "policy.py", "detector.py")
FETCHES = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _fetches(path):
    tree = ast.parse(open(path).read(), filename=path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            f = node.func
            if f.attr in FETCHES or (
                    f.attr in ("asarray", "array") and
                    isinstance(f.value, ast.Name) and f.value.id == "np"):
                out.append((os.path.basename(path), node.lineno, f.attr))
    return out


def test_one_host_fetch_in_the_hot_modules():
    root = os.path.join(REPO, "paddle_tpu_torch", "sentinel")
    found = [f for name in HOT for f in _fetches(os.path.join(root, name))]
    assert len(found) == 1 and found[0][0] == "guard.py" and \
        found[0][2] == "tolist", found


def test_model_route_eager_lane_equals_the_program_lane(monkeypatch):
    """The sentinel route inside ``disable_graphs()`` (no program bound,
    the gradients as the function returns them) gives the program lane's
    losses and state, a NaN skipped in both."""
    from paddle_tpu_torch.core import graphs
    xs, ys = _data()
    lanes = []
    for eager in (False, True):
        _arm(monkeypatch, f"grads:{NAN_STEP}:nan")
        m, net, opt, s, _ = _model(("skip_step",))
        with graphs.disable_graphs() if eager else _nullcontext():
            losses = [m.train_batch([xs[i]], [ys[i]])[0]
                      for i in range(TOTAL_STEPS)]
        lanes.append((losses, _state(net, opt), s.anomalies))
    _arm(monkeypatch, "")
    (la, sa, aa), (lb, sb, ab) = lanes
    assert la == lb and aa == ab == 1
    _assert_bitwise(sa, sb)


def _nullcontext():
    import contextlib
    return contextlib.nullcontext()
