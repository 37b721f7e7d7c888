"""The dynamic-batching serving ``Engine`` of the port: the tiny YOLOv3
detector served through both packages' engines with the same requests
(dets equal as in ``test_torch_yolov3.py``, the same batches, rows and
cache misses), and the engine's own contract on a trivial model: drain,
hard kill, admission pause, oversize split and reject, deadlines, and
the parts that are not ported yet."""
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.serving.cache import ExecutableCache as JCache  # noqa: E402
from paddle_tpu.serving.engine import Engine as JEngine  # noqa: E402
from paddle_tpu.serving.engine import EngineConfig as JConfig  # noqa: E402
from paddle_tpu.vision.models import YOLOv3 as JYOLOv3  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.serving import (EngineDraining,  # noqa: E402
                                      EngineKilled, RequestTooLarge)
from paddle_tpu_torch.serving.buckets import BucketSpec  # noqa: E402
from paddle_tpu_torch.serving.cache import ExecutableCache  # noqa: E402
from paddle_tpu_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from paddle_tpu_torch.vision.models import YOLOv3  # noqa: E402

TINY = dict(num_classes=4, width_mult=0.125)
#: rows per request: 5 is wider than the largest bucket (split 4 + 1)
ROWS = [1, 1, 5, 2, 1, 3]
CFG = dict(batch_buckets=(2, 4), max_batch=4, max_batch_delay=0.5)


def _requests(seed=0, size=64):
    rng = np.random.default_rng(seed)
    reqs = []
    for n in ROWS:
        img = rng.random((n, 3, size, size), dtype=np.float32)
        hw = rng.integers(size // 2, size + 1, (n, 2)).astype(np.int32)
        reqs.append([img, hw])
    return reqs


def test_yolov3_served_by_both_engines_agrees():
    """The JAX side runs forward and decode under ``jit.to_static``, the
    port eagerly under ``inference_mode``. The head convs' weights are
    scaled up so that scores spread out: at the init's scale many scores
    differ by ~1e-6, under the two packages' rounding gap, and rows of
    nearly equal score would swap."""
    paddle.seed(7)
    jm = JYOLOv3(**TINY)
    jm.eval()
    sd = {k: np.asarray(v.numpy()) * (8.0 if k.startswith("yolo_out")
                                      else 1.0)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict(sd)
    tm = YOLOv3(**TINY, device="cpu", seed=3).eval()
    tm.load_state_dict(framework_io.state_dict_from_reference(sd, "cpu"),
                       strict=True)
    jserve = paddle.jit.to_static(lambda img, hw: jm.decode(jm(img), hw))

    def jfn(img, hw):
        dets, counts = jserve(paddle.to_tensor(img), paddle.to_tensor(hw))
        return np.asarray(dets.numpy()), np.asarray(counts.numpy())

    def tfn(img, hw):
        with torch.inference_mode():
            return tm.decode(tm(img), hw)

    reqs = _requests()
    jeng = JEngine(jfn, JConfig(**CFG), registry=JStatRegistry(),
                   cache=JCache())
    teng = Engine(tfn, EngineConfig(**CFG), cache=ExecutableCache(),
                  device="cpu")
    try:
        jres = [f.result(300) for f in jeng.submit_many(reqs)]
        tres = [f.result(300) for f in teng.submit_many(reqs)]
        jst, tst = jeng.stats(), teng.stats()
    finally:
        jeng.drain(60)
        teng.drain(60)
    for n, (jd, jc), (td, tc) in zip(ROWS, jres, tres):
        assert td.shape == jd.shape == (n, 100, 6)
        assert tc.dtype == np.int32
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td[..., 0], jd[..., 0])
        np.testing.assert_allclose(td[..., 1:], jd[..., 1:], rtol=1e-5,
                                   atol=1e-4)
    assert (np.concatenate([r[1] for r in tres]) > 0).all()
    for key in ("serving.batches", "serving.rows", "serving.completed",
                "serving.oversize_splits", "serving.coalesced_batches"):
        assert tst["stats"][key] == jst["stats"][key], key
    assert tst["stats"]["serving.batches"] == 4
    assert tst["executable_cache"]["misses"] == \
        jst["executable_cache"]["misses"] == 2


# -- the engine's contract on a trivial model ---------------------------------

def _double(x):
    return x * 2


def _engine(fn=_double, **kw):
    cfg = dict(batch_buckets=(1, 2, 4), max_batch=4, max_batch_delay=0.01)
    cfg.update(kw)
    return Engine(fn, EngineConfig(**cfg), cache=ExecutableCache(),
                  device="cpu")


def test_rows_come_back_in_order_and_padding_is_sliced_off():
    seen = []

    def fn(x):
        seen.append(tuple(x.shape))
        assert x.device.type == "cpu" and isinstance(x, torch.Tensor)
        return x * 2, x.sum(dim=1)

    eng = _engine(fn, max_batch_delay=0.2)
    xs = [np.full((n, 3), i, np.float32) for i, n in enumerate([1, 2, 6])]
    outs = [f.result(30) for f in eng.submit_many([[x] for x in xs])]
    eng.drain(30)
    for x, (dbl, s) in zip(xs, outs):
        np.testing.assert_array_equal(dbl, x * 2)
        np.testing.assert_array_equal(s, x.sum(axis=1))
    assert all(shape[0] in (1, 2, 4) for shape in seen)
    st = eng.stats()["stats"]
    assert st["serving.oversize_splits"] == 1 and st["serving.rows"] == 9


def test_drain_resolves_every_future_and_refuses_new_work():
    eng = _engine()
    futs = eng.submit_many([[np.ones((1, 2), np.float32)]] * 5)
    inflight = eng.drain(30)
    assert all(f.done() for f in futs) and all(f.done() for f in inflight)
    with pytest.raises(EngineDraining):
        eng.submit([np.ones((1, 2), np.float32)])


def test_kill_fails_queued_and_inflight_requests():
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    eng = _engine(slow, max_batch_delay=0.0)
    futs = [eng.submit([np.ones((4, 2), np.float32)]) for _ in range(3)]
    time.sleep(0.2)                      # the worker holds the first batch
    records = eng.kill("test")
    gate.set()
    phases = sorted(r["phase"] for r in records)
    assert phases == ["inflight", "queued", "queued"]
    for f in futs[1:]:
        with pytest.raises(EngineKilled):
            f.result(10)
    assert eng.was_killed
    with pytest.raises(EngineKilled):
        eng.submit([np.ones((1, 2), np.float32)])
    # the batch the worker held runs to its end (as in the JAX package,
    # the worker polls the kill flag between batches)
    np.testing.assert_array_equal(futs[0].result(10)[0], np.ones((4, 2)))
    assert eng._stopped.wait(10)


def test_pause_and_resume_admission():
    eng = _engine()
    eng.pause_admission()
    assert eng.admission_paused
    with pytest.raises(EngineDraining, match="paused"):
        eng.submit([np.ones((1, 2), np.float32)])
    eng.resume_admission()
    out = eng.submit([np.ones((1, 2), np.float32)]).result(30)
    np.testing.assert_array_equal(out[0], 2 * np.ones((1, 2)))
    assert eng.stats()["stats"]["serving.rejected_paused"] == 1
    eng.drain(30)


def test_oversize_reject_and_deadline():
    eng = _engine(oversize_policy="reject")
    with pytest.raises(RequestTooLarge):
        eng.submit([np.ones((5, 2), np.float32)])
    eng.drain(30)
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    eng = _engine(slow, max_batch_delay=0.0)
    first = eng.submit([np.ones((4, 2), np.float32)])
    late = eng.submit([np.ones((1, 2), np.float32)], deadline=0.05)
    time.sleep(0.2)
    gate.set()
    first.result(10)
    with pytest.raises(TimeoutError):      # DeadlineExceeded
        late.result(10)
    eng.drain(30)


def test_unported_parts_raise_and_cuda_is_the_default(monkeypatch):
    eng = _engine()
    with pytest.raises(NotImplementedError, match="A8"):
        eng.arm_preemption()
    with pytest.raises(NotImplementedError, match="A8"):
        eng.install_drain_signal_handler()
    eng.drain(30)
    with pytest.raises(NotImplementedError, match="A11"):
        Engine("model_prefix", device="cpu")
    with pytest.raises(TypeError):
        Engine(object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(_double)


def test_bucket_spec_matches_jax():
    from paddle_tpu.serving.buckets import BucketSpec as JBucketSpec
    for kw in (dict(batch_buckets=(4, 1, 2)), dict(max_batch=12),
               dict(batch_buckets=(2,), seq_buckets=(8, 16))):
        j, t = JBucketSpec(**kw), BucketSpec(**kw)
        assert t.batch_buckets == j.batch_buckets
        assert t.seq_buckets == j.seq_buckets
        for rows in range(0, 14):
            assert t.batch_bucket_for(rows) == j.batch_bucket_for(rows)
        for seq in (None, 3, 9, 17):
            assert t.seq_bucket_for(seq) == j.seq_bucket_for(seq)
