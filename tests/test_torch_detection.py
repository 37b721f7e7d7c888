"""Greedy NMS (B5) and the detection ops of the YOLOv3 serving path: the
port's plain NMS against the JAX package's Pallas kernel in interpret
mode and against its ``lax.scan`` form, and ``yolo_box``,
``iou_similarity``, ``box_clip`` and ``multiclass_nms`` against the JAX
package on the same numpy inputs. Masks, labels and counts must be
equal; scores and boxes agree at rtol 1e-5. The CUDA kernel is held
against its plain version in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.ops import custom as jcustom  # noqa: E402
from paddle_tpu.ops import detection as jdet  # noqa: E402
import paddle_tpu_torch.ops as tops  # noqa: E402
from paddle_tpu_torch.ops import custom as tcustom  # noqa: E402
from paddle_tpu_torch.ops import detection as tdet  # noqa: E402

RTOL = 1e-5


def _boxes(rng, m, scale=100.0):
    xy = rng.random((m, 2), dtype=np.float32) * scale
    wh = 1.0 + rng.random((m, 2), dtype=np.float32) * scale / 4
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _nms_problems(seed, p_n, k, kind):
    """iou [P, k, k], valid [P, k] int32, thr [P]: IoU of random boxes
    (symmetric), a random matrix (asymmetric), or boxes with NaN
    entries; some rows invalid."""
    rng = np.random.default_rng(seed)
    if kind == "asymmetric":
        iou = rng.random((p_n, k, k), dtype=np.float32)
    else:
        iou = np.stack([np.asarray(jdet._pairwise_iou(
            jnp.asarray(b), jnp.asarray(b)))
            for b in (_boxes(rng, k) for _ in range(p_n))])
        if kind == "nan":
            iou[rng.random(iou.shape) < 0.1] = np.nan
    valid = (rng.random((p_n, k)) < 0.85).astype(np.int32)
    thr = rng.uniform(0.2, 0.7, p_n).astype(np.float32)
    return iou, valid, thr


def _plain(iou, valid, thr, eta=1.0):
    return tcustom.greedy_nms(torch.from_numpy(iou), torch.from_numpy(valid),
                              torch.from_numpy(thr), eta).numpy()


@pytest.mark.parametrize("k", [1, 16, 64])
@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_nms_plain_matches_pallas_interpret(k, kind):
    iou, valid, thr = _nms_problems(k, 4, k, kind)
    kernel = jax.vmap(lambda a, v, t: jcustom.pallas_greedy_nms(
        a, v, t, interpret=True, unroll=1))
    ref = np.asarray(kernel(jnp.asarray(iou), jnp.asarray(valid),
                            jnp.asarray(thr)[:, None]))
    got = _plain(iou, valid, thr)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def _scan_reference(iou, valid, thr, eta):
    """The step body of ``_greedy_nms_mask`` (``paddle_tpu/ops/
    detection.py``) run by ``lax.scan`` on given IoU matrices, which
    may be asymmetric or hold NaN; the function itself builds its IoU
    from boxes (``test_greedy_nms_mask_matches_jax_k400``)."""
    out = []
    for a, v, t in zip(iou, valid, thr):
        k = a.shape[0]
        a = jnp.asarray(a)
        ok = jnp.asarray(v != 0)

        def step(carry, i, a=a, ok=ok, k=k):
            kept, th = carry
            sup = jnp.any(kept & (a[:, i] > th) & (jnp.arange(k) < i))
            keep_i = ok[i] & ~sup
            if eta < 1.0:
                th = jnp.where(keep_i & (th > 0.5), th * eta, th)
            return (kept.at[i].set(keep_i), th), keep_i

        (kept, _), _ = jax.lax.scan(
            step, (jnp.zeros(k, bool), jnp.asarray(t, jnp.float32)),
            jnp.arange(k))
        out.append(np.asarray(kept).astype(np.int32))
    return np.stack(out)


@pytest.mark.parametrize("eta", [1.0, 0.9])
@pytest.mark.parametrize("kind", ["symmetric", "asymmetric", "nan"])
def test_nms_plain_matches_scan_k400(eta, kind):
    iou, valid, thr = _nms_problems(400, 3, 400, kind)
    thr[:] = 0.45 if eta == 1.0 else 0.9
    np.testing.assert_array_equal(_plain(iou, valid, thr, eta),
                                  _scan_reference(iou, valid, thr, eta))


@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_greedy_nms_mask_matches_jax_k400(eta):
    """The whole ``_greedy_nms_mask`` (stable top-k, IoU, scan) against
    the JAX function on 600 candidates, with tied scores."""
    rng = np.random.default_rng(7)
    boxes = _boxes(rng, 600)
    scores = rng.random(600).astype(np.float32)
    scores[::7] = scores[3]                      # exact ties
    kept_j, order_j, top_j = jdet._greedy_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), 0.45, 0.05, 400,
        nms_eta=eta)
    kept_t, order_t, top_t = tdet._greedy_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 0.05, 400,
        nms_eta=eta)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(top_t.numpy(), np.asarray(top_j))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))


def test_adaptive_eta_is_not_a_push_scan():
    """With eta < 1 the threshold in force at step i applies to every
    earlier kept box: box 2 overlaps box 0 by 0.6, under the first
    threshold 0.7 but over 0.7 * 0.8 = 0.56, in force once box 1 is
    kept."""
    iou = np.zeros((1, 3, 3), np.float32)
    iou[0, 0, 2] = 0.6
    valid = np.ones((1, 3), np.int32)
    thr = np.array([0.7], np.float32)
    np.testing.assert_array_equal(_plain(iou, valid, thr, 0.8), [[1, 1, 0]])
    np.testing.assert_array_equal(_scan_reference(iou, valid, thr, 0.8),
                                  [[1, 1, 0]])
    np.testing.assert_array_equal(_plain(iou, valid, thr, 1.0), [[1, 1, 1]])


def test_greedy_nms_checks_its_inputs():
    iou = torch.zeros(2, 3, 3)
    valid = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not agree"):
        tcustom.greedy_nms(iou, valid, torch.zeros(3))
    with pytest.raises(ValueError, match="takes iou"):
        tcustom.greedy_nms(iou[0], valid, torch.zeros(2))
    with pytest.raises(ValueError, match="unsupported device"):
        tcustom.greedy_nms(iou.to("meta"), valid.to("meta"),
                           torch.zeros(2, device="meta"))


def test_register_op_and_kernel_op():
    name = "_test_torch_cube"
    if not hasattr(tops, name):
        tcustom.register_op(name, lambda a: a * a * a)
    x = torch.tensor([2.0], requires_grad=True)
    getattr(tops, name)(x).backward()
    assert x.grad.item() == pytest.approx(12.0)
    with pytest.raises(ValueError, match="already"):
        tcustom.register_op(name, lambda a: a)
    kname = "_test_torch_greedy_nms"
    if not hasattr(tops, kname):
        tcustom.register_kernel_op(kname, tcustom.greedy_nms)
    iou, valid, thr = _nms_problems(3, 2, 8, "symmetric")
    got = getattr(tops, kname)(torch.from_numpy(iou),
                               torch.from_numpy(valid),
                               torch.from_numpy(thr)).numpy()
    np.testing.assert_array_equal(got, _plain(iou, valid, thr))
    with pytest.raises(ValueError, match="several devices"):
        getattr(tops, kname)(torch.from_numpy(iou),
                             torch.from_numpy(valid).to("meta"),
                             torch.from_numpy(thr))


# -- detection ops ------------------------------------------------------------

def _jt(a):
    return paddle.to_tensor(a)


@pytest.mark.parametrize("clip,scale_x_y", [(True, 1.0), (False, 1.05)])
def test_yolo_box_matches_jax(clip, scale_x_y):
    rng = np.random.default_rng(1)
    n, a_n, c_n, h, w = 2, 3, 5, 6, 8
    x = rng.standard_normal((n, a_n * (5 + c_n), h, w)).astype(np.float32)
    img = np.array([[96, 128], [50, 70]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23]
    kw = dict(anchors=anchors, class_num=c_n, conf_thresh=0.4,
              downsample_ratio=16, clip_bbox=clip, scale_x_y=scale_x_y)
    jb, js = jdet.yolo_box(_jt(x), _jt(img), **kw)
    tb, ts = tdet.yolo_box(torch.from_numpy(x), torch.from_numpy(img), **kw)
    np.testing.assert_allclose(tb.numpy(), jb.numpy(), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=RTOL, atol=1e-6)
    # conf below the threshold zeroes boxes and scores alike
    assert (ts.numpy() == 0).all(axis=-1).any()
    np.testing.assert_array_equal(ts.numpy() == 0, js.numpy() == 0)


@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity_matches_jax(normalized):
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 9, 10.0), _boxes(rng, 7, 10.0)
    a[0] = a[1]                                  # identical boxes
    b[0] = [5, 5, 5, 5]                          # zero area when normalized
    ref = jdet.iou_similarity(_jt(a), _jt(b), box_normalized=normalized)
    got = tdet.iou_similarity(torch.from_numpy(a), torch.from_numpy(b),
                              box_normalized=normalized)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=1e-7)


def test_box_clip_matches_jax():
    rng = np.random.default_rng(3)
    boxes = (rng.standard_normal((2, 5, 4)) * 40 + 20).astype(np.float32)
    info = np.array([30.0, 50.0, 1.0], np.float32)
    ref = jdet.box_clip(_jt(boxes), _jt(info))
    got = tdet.box_clip(torch.from_numpy(boxes), torch.from_numpy(info))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _nms_inputs(seed, n=2, c_n=4, m=60, ties=False):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, m, 50.0) for _ in range(n)])
    scores = rng.random((n, c_n, m)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = 0.0     # yolo_box's zeroed rows
    if ties:
        # equal valid scores across candidates and classes: the order of
        # equal scores decides which box survives
        scores[:, :, ::5] = 0.625
        scores[:, 1] = scores[:, 0]
        boxes[:, 1::2] = boxes[:, ::2][:, :boxes[:, 1::2].shape[1]]
    return boxes, scores


def _assert_dets_equal(got, ref):
    (go, gc), (ro, rc) = got, ref
    go, gc = go.numpy(), gc.numpy()
    ro, rc = ro.numpy(), rc.numpy()
    assert gc.dtype == np.int32 and rc.dtype == np.int32
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_array_equal(go[..., 0], ro[..., 0])      # labels
    np.testing.assert_allclose(go[..., 1:], ro[..., 1:], rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("case", [
    dict(background_label=0),
    dict(background_label=-1, keep_top_k=500, nms_top_k=80),
    dict(background_label=2, nms_eta=0.9, nms_threshold=0.7),
    dict(background_label=-1, normalized=False, keep_top_k=7),
    dict(background_label=-1, ties=True),
    dict(background_label=1, ties=True, nms_top_k=20),
], ids=["bg0", "keep_more_than_candidates", "eta", "pixel_top7",
        "ties", "ties_top20"])
def test_multiclass_nms_matches_jax(case):
    case = dict(case)
    boxes, scores = _nms_inputs(11, ties=case.pop("ties", False))
    kw = dict(score_threshold=0.05, nms_top_k=40, keep_top_k=30,
              nms_threshold=0.3)
    kw.update(case)
    ref = jdet.multiclass_nms(_jt(boxes), _jt(scores), **kw)
    got = tdet.multiclass_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores), **kw)
    _assert_dets_equal(got, ref)
    out, counts = got
    assert out.shape == (2, kw["keep_top_k"], 6)
    pad = out.numpy()[np.arange(out.shape[1])[None] >= counts.numpy()[:, None]]
    assert (pad[:, 0] == -1).all() and (pad[:, 1:] == 0).all()
