"""YOLOv3 training in the port against the JAX package: ``yolov3_loss``
(loss and input gradient at 1e-5 in float32, on random heads and on the
cases that stress its gathers and scatter: gt boxes sharing a cell, no
gt box at all, label smoothing), ``YOLOv3Loss`` and the tiny detector of
``tests/test_yolov3_e2e.py`` (width 0.125, 4 classes, 64x64, 6 gt slots)
trained through ``Model.train_batch`` with bench.py's Momentum.

The train curve is held in float64 in both packages (``jax_enable_x64``
around the JAX side, restored after), as ``test_torch_resnet.py`` does:
in float32 the tiny detector's curve is ill-conditioned (BN over the 2x2
maps of 2 images at the last stage). Measured on the CPU with this
file's batch at lr 1e-3: the float32 curves of the two packages part by
1.4e-7, 6.7e-6, 3.7e-4, 7.3e-3 and 2.7e-2 at steps 1-5, the float64
ones by at most 3.2e-8 over 8 steps (6.5e-12 at step 4). So float64
holds the BN statistics after the first step at 1e-9 and an 8-step curve
at 1e-4; the float32 and O1 first steps are in
``test_torch_yolov3_first_steps.py``, which shares this file's
helpers."""
import contextlib

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.vision.models import YOLOv3 as JYOLOv3  # noqa: E402
from paddle_tpu.vision.models import YOLOv3Loss as JYOLOv3Loss  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.ops.detection import yolov3_loss  # noqa: E402
from paddle_tpu_torch.vision.models import YOLOv3, YOLOv3Loss  # noqa: E402

TOL = 1e-5
CURVE_TOL = 1e-4
F64_TOL = 1e-9
TINY = dict(num_classes=4, width_mult=0.125, num_max_boxes=6)
STEPS = 8

# one scale of the loss, as tests/test_detection_ops.py:158-173 sets it
ANCHORS = [10, 13, 16, 30, 33, 23]
MASK = [0, 1, 2]
N, H, W, C, B = 2, 4, 4, 3, 5


def _head(seed=3, scale=0.1):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, 3 * (5 + C), H, W) * scale).astype(np.float32)


def _gt(kind="boxes"):
    """gt boxes of one of the cases: the reference test's three boxes,
    three boxes on one (anchor, cell) beside a fourth on another, or
    none (every slot padding)."""
    gt_box = np.zeros((N, B, 4), np.float32)
    gt_label = np.zeros((N, B), np.int64)
    if kind == "boxes":
        gt_box[0, 0] = [0.5, 0.5, 0.2, 0.3]
        gt_label[0, 0] = 1
        gt_box[1, 0] = [0.25, 0.25, 0.1, 0.1]
        gt_box[1, 1] = [0.75, 0.75, 0.3, 0.2]
        gt_label[1, 1] = 2
    elif kind == "shared_cell":
        gt_box[0, 0] = [0.55, 0.55, 0.2, 0.3]
        gt_box[0, 1] = [0.6, 0.6, 0.22, 0.28]
        gt_box[0, 3] = [0.57, 0.52, 0.21, 0.3]
        gt_label[0, :4] = [1, 2, 0, 1]
        gt_box[1, 0] = [0.3, 0.7, 0.3, 0.25]
        gt_box[1, 2] = [0.3, 0.7, 0.3, 0.25]
        gt_label[1, 2] = 2
    return gt_box, gt_label


def _jax_loss(x, gt_box, gt_label, weights, **kw):
    xt = paddle.to_tensor(x, stop_gradient=False)
    loss = jops.yolov3_loss(xt, paddle.to_tensor(gt_box),
                            paddle.to_tensor(gt_label), ANCHORS, MASK, C,
                            ignore_thresh=0.7, downsample_ratio=32, **kw)
    paddle.sum(loss * paddle.to_tensor(weights)).backward()
    return loss.numpy(), xt.grad.numpy()


def _port_loss(x, gt_box, gt_label, weights, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    loss = yolov3_loss(xt, torch.from_numpy(gt_box),
                       torch.from_numpy(gt_label), ANCHORS, MASK, C,
                       ignore_thresh=0.7, downsample_ratio=32, **kw)
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), xt.grad.numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# -- yolov3_loss --------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("boxes", {}), ("shared_cell", {}), ("none", {}),
    ("boxes", {"use_label_smooth": True}),
    ("shared_cell", {"gt_score": np.ones((N, B), np.float32)})],
    ids=["boxes", "shared_cell", "all_padding", "label_smooth", "gt_score"])
def test_loss_and_gradient_match_jax(kind, kw):
    """Loss per image and the gradient of a weighted sum, at 1e-5 (of
    the largest): three gt boxes on one cell gather one prediction three
    times and set its objectness target once (scatter-max)."""
    x = _head()
    gt_box, gt_label = _gt(kind)
    weights = np.array([0.7, 1.3], np.float32)
    if "gt_score" in kw:
        jkw = dict(kw, gt_score=paddle.to_tensor(kw["gt_score"]))
        tkw = dict(kw, gt_score=torch.from_numpy(kw["gt_score"]))
    else:
        jkw = tkw = kw
    jl, jg = _jax_loss(x, gt_box, gt_label, weights, **jkw)
    tl, tg = _port_loss(x, gt_box, gt_label, weights, **tkw)
    assert tl.shape == (N,)
    _close(tl, jl)
    _close(tg, jg)


def test_shared_cell_gradient_is_the_sum_of_the_boxes():
    """The deterministic gather's backward adds the gradients of the gt
    boxes on one cell, as indexing's backward does: on the x/y/w/h and
    class channels (which only the gathers reach) the gradient with all
    boxes is the sum of the gradients with each box alone."""
    x = torch.from_numpy(_head())
    gt_box, gt_label = (torch.from_numpy(a) for a in _gt("shared_cell"))

    def grad(boxes):
        xr = x.clone().requires_grad_()
        loss = yolov3_loss(xr, boxes, gt_label, ANCHORS, MASK, C, 0.7, 32)
        return torch.autograd.grad(loss.sum(), xr)[0]
    each = torch.zeros_like(x)
    for b in range(B):
        alone = torch.zeros_like(gt_box)
        alone[:, b] = gt_box[:, b]
        each += grad(alone)
    per = 5 + C
    gathered = [a * per + c for a in range(3) for c in range(per) if c != 4]
    np.testing.assert_allclose(grad(gt_box)[:, gathered].numpy(),
                               each[:, gathered].numpy(), rtol=0, atol=1e-5)


def test_loss_finite_positive_and_grad():
    """tests/test_detection_ops.py:175-188 on the port."""
    x = torch.from_numpy(_head()).requires_grad_()
    gt_box, gt_label = (torch.from_numpy(a) for a in _gt())
    loss = yolov3_loss(x, gt_box, gt_label, ANCHORS, MASK, C,
                       ignore_thresh=0.7, downsample_ratio=32)
    assert tuple(loss.shape) == (2,)
    assert torch.isfinite(loss).all() and (loss > 0).all()
    loss.sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_perfect_prediction_low_loss():
    """tests/test_detection_ops.py:190-208 on the port: quiet predictions
    with no gt box cost far less than random ones."""
    gt_box, gt_label = _gt()
    rand_loss = yolov3_loss(
        torch.from_numpy(_head(0, 3.0)), torch.from_numpy(gt_box),
        torch.from_numpy(gt_label), ANCHORS, MASK, C, ignore_thresh=0.7,
        downsample_ratio=32).sum()
    quiet_loss = yolov3_loss(
        torch.full((N, 3 * (5 + C), H, W), -8.0),
        torch.zeros(N, B, 4), torch.zeros(N, B, dtype=torch.int64),
        ANCHORS, MASK, C, ignore_thresh=0.7, downsample_ratio=32).sum()
    assert quiet_loss < rand_loss * 0.05


# -- the tiny detector through Model.train_batch ------------------------------

def _batch(rng, n, s, num_max_boxes=6, num_classes=4):
    """tests/test_yolov3_e2e.py:22-33."""
    img = rng.rand(n, 3, s, s).astype(np.float32)
    gt_box = np.zeros((n, num_max_boxes, 4), np.float32)
    gt_label = np.zeros((n, num_max_boxes), np.int64)
    for i in range(n):
        for b in range(rng.randint(1, 3)):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            w, h = rng.uniform(0.1, 0.3, 2)
            gt_box[i, b] = [cx, cy, w, h]
            gt_label[i, b] = rng.randint(0, num_classes)
    return img, gt_box, gt_label


def _train_batch():
    return _batch(np.random.RandomState(0), 2, 64)


@contextlib.contextmanager
def _jax_float64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _jax_tiny():
    paddle.seed(7)
    jm = JYOLOv3(**TINY)
    return jm, {k: np.array(v._data) for k, v in jm.state_dict().items()}


def _jax_model(jm, lr=1e-3):
    m = paddle.Model(jm)
    m.prepare(jopt.Momentum(learning_rate=lr, momentum=0.9,
                            parameters=jm.parameters()), JYOLOv3Loss(jm))
    return m


def _port_model(arrays, dtype=torch.float32, lr=1e-3, sgd=False):
    tm = YOLOv3(**TINY, device="cpu", seed=1)
    tm.load_state_dict(P.state_dict_from_reference(arrays, "cpu"),
                       strict=True)
    tm = tm.to(dtype)
    opt = topt.SGD(learning_rate=lr, parameters=tm.parameters(),
                   device="cpu") if sgd else topt.Momentum(
        learning_rate=lr, momentum=0.9, parameters=tm.parameters(),
        device="cpu")
    m = P.Model(tm, device="cpu")
    m.prepare(opt, YOLOv3Loss(tm))
    return m, tm


@pytest.fixture(scope="module")
def f64_reference():
    """The JAX package's tiny detector in float64: an 8-step Momentum
    curve, and the BN statistics after its first step."""
    jm, arrays = _jax_tiny()
    img, gt_box, gt_label = _train_batch()
    with _jax_float64():
        jm.astype("float64")
        m = _jax_model(jm)
        args = ([img.astype(np.float64)], [gt_box.astype(np.float64),
                                           gt_label])
        losses = [m.train_batch(*args)[0]]
        stats = {k: np.array(v._data) for k, v in jm.named_buffers()}
        losses += [m.train_batch(*args)[0] for _ in range(STEPS - 1)]
    return dict(arrays=arrays, stats=stats, losses=losses,
                batch=(img, gt_box, gt_label))


def test_float64_train_curve_matches_jax(f64_reference):
    ref = f64_reference
    m, tm = _port_model(ref["arrays"], torch.float64)
    img, gt_box, gt_label = ref["batch"]
    args = ([img.astype(np.float64)], [gt_box.astype(np.float64), gt_label])
    losses = [m.train_batch(*args)[0]]
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref["stats"][n], rtol=F64_TOL,
                                   atol=F64_TOL, err_msg=n)
    losses += [m.train_batch(*args)[0] for _ in range(STEPS - 1)]
    rel = np.abs(np.subtract(losses, ref["losses"])) / np.abs(ref["losses"])
    assert rel.max() < CURVE_TOL, (losses, ref["losses"])
    assert losses[-1] < losses[0] * 0.8
    assert m._train_step_fn["fn"].trace_counter["traces"] == 1


def test_model_loss_equals_yolov3_loss_head():
    """``YOLOv3.loss`` and ``YOLOv3Loss`` are the same sum of the three
    scales' batch means."""
    _, arrays = _jax_tiny()
    _, tm = _port_model(arrays)
    img, gt_box, gt_label = (torch.from_numpy(a) for a in
                             _batch(np.random.RandomState(4), 2, 64))
    outs = tm(img)
    head = YOLOv3Loss(tm)(*outs, gt_box, gt_label)
    by_model = tm.loss(outs, gt_box, gt_label)
    assert torch.equal(head, by_model)
    want = sum(yolov3_loss(o, gt_box, gt_label, tm.anchors, mask, 4,
                           tm.ignore_thresh, ds).mean()
               for o, mask, ds in zip(outs, tm.anchor_masks,
                                      tm.downsamples))
    torch.testing.assert_close(head, want, rtol=1e-6, atol=0)


def test_bucketed_multiscale_one_program_per_bucket():
    """tests/test_yolov3_e2e.py::test_bucketed_multiscale_no_recompile on
    the port: two sizes trained in turn build two steps, each traced
    once, and every later step of a size reuses its program."""
    _, arrays = _jax_tiny()
    m, _ = _port_model(arrays, sgd=True)
    builds = []
    orig = m._build_train_step

    def counting(sig):
        builds.append(sig)
        return orig(sig)
    m._build_train_step = counting
    rng = np.random.RandomState(1)
    batches = {s: _batch(rng, 1, s) for s in (64, 96)}
    for step in range(6):
        img, gt_box, gt_label = batches[(64, 96)[step % 2]]
        loss, _ = m.train_batch([img], [gt_box, gt_label])
        assert np.isfinite(loss)
    assert len(builds) == 2 and len(m._train_fns) == 2
    assert [ts["fn"].trace_counter["traces"]
            for ts in m._train_fns.values()] == [1, 1]
