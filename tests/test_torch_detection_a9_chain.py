"""The Faster R-CNN chain ``anchor_generator`` -> ``generate_proposals``
-> ``collect_fpn_proposals`` -> ``distribute_fpn_proposals`` ->
``roi_align`` -> ``box_coder`` -> ``multiclass_nms`` at a small size
against the JAX package on the CPU, both packages fed the same head
outputs (spread, so no scores near-tie: ROADMAP C4), and the
position-sensitive poolings (``psroi_pool``,
``deformable_psroi_pooling``) by ``check_against_jax``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from test_torch_a9_table import (DET_CASES, FRCNN, detect,  # noqa: E402
                                 frcnn_inputs, roi_features, rpn_to_rois)
from test_torch_detection_a9 import (BESIDE_CHAIN, _cpu,  # noqa: E402,F401
                                     check_against_jax)
from test_torch_op_table import _np_of  # noqa: E402


@pytest.mark.parametrize("case", [c for c in DET_CASES
                                  if c.name in BESIDE_CHAIN], ids=repr)
def test_position_sensitive_pooling_matches_jax(case):
    check_against_jax(case)


def _run_chain(m, feats, scores, deltas, im, cfg, classes=5, seed=6):
    t = m.to_tensor
    rois, rois_num = rpn_to_rois(m, [t(f) for f in feats],
                                 [t(s) for s in scores],
                                 [t(d) for d in deltas], t(im), cfg)
    pooled = roi_features(m, [t(f) for f in feats[:4]], rois, rois_num, cfg)
    r = rois.shape[0]
    rng = np.random.default_rng(seed)
    logits = rng.permutation(r * (classes + 1)).reshape(
        r, classes + 1).astype(np.float32) / (r * (classes + 1)) * 12 - 6
    box_d = rng.uniform(-0.5, 0.5, (r, 4)).astype(np.float32)
    out, counts = detect(m, rois, t(logits), t(box_d),
                         t(np.asarray(cfg["box_variances"], np.float32)),
                         im.shape[0], cfg)
    return [_np_of(v) for v in (rois, pooled, out, counts)]


def test_faster_rcnn_chain_matches_jax():
    """The chain at a small size (2 images of 64 x 80, FPN width 4, 40
    proposals a level, 24 kept, 5 classes): rois and detections' boxes
    and scores at 1e-5, kept sets and counts equal, pooled features at
    1e-5."""
    cfg = dict(FRCNN, pre_nms_top_n=40, post_nms_top_n=24, keep_top_k=20,
               refer_scale=32)
    inputs = frcnn_inputs()
    got = _run_chain(P, *inputs, cfg)
    ref = _run_chain(J, *inputs, cfg)
    for name, a, b in zip(("rois", "pooled", "detections", "counts"), got,
                          ref):
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(
                1.0, float(np.abs(b).max())), err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[3].min() > 0
    # every level of P2-P5 receives rois
    w = got[0][:, 2] - got[0][:, 0]
    h = got[0][:, 3] - got[0][:, 1]
    lvl = np.floor(np.log2(np.sqrt(np.maximum(w * h, 1e-12)) / 32 + 1e-8))
    assert len(set(np.clip(lvl + 4, 2, 5).tolist())) >= 3


