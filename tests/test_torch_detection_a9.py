"""The rest of the detection ops (``ops/detection.py``: prior and anchor
boxes, box coding, the RPN and the FPN, the RoI poolings, matching and
assignment, ``smooth_l1``, ``matrix_nms``) against the JAX package on
the CPU: every case of ``DET_CASES`` (``tests/test_torch_a9_table.py``)
through both packages on the same seeded inputs, outputs at 1e-5
(masks, indices and counts bitwise) and the gradient of a seeded
cotangent at 1e-4 where the op is differentiable, with the op names the
AMP handler sees (:func:`check_against_jax`); the RoI poolings are in
``test_torch_detection_a9_roi.py`` and the Faster R-CNN chain in
``test_torch_detection_a9_chain.py``, split for time. Here also the
batching of ``generate_proposals``' greedy scans into one NMS call and
the host read of ``rois_num``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops import detection as tdet  # noqa: E402
from test_torch_a9_table import DET_CASES, frcnn_inputs  # noqa: E402
from test_torch_op_table import assert_case_close, run_case  # noqa: E402
from test_torch_ops_math import recording_amp_names  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def check_against_jax(case):
    tnames, jnames = [], []
    got = run_case(P, case, around_op=lambda: recording_amp_names(
        P, tnames))
    ref = run_case(J, case, around_op=lambda: recording_amp_names(
        J, jnames))
    assert_case_close(case, got, ref, "port vs JAX")
    assert tnames == jnames, (case, tnames, jnames)


#: the RoI poolings (``test_torch_detection_a9_roi.py``) and the cases
#: held beside the chain (``test_torch_detection_a9_chain.py``)
ROI = ("roi_align_adaptive", "roi_align_zero_unaligned",
       "roi_align_ratio2_border", "roi_align_past_tap_cap", "roi_pool",
       "prroi_pool")
BESIDE_CHAIN = ("psroi_pool", "deformable_psroi_pooling")


@pytest.mark.parametrize("case", [c for c in DET_CASES if c.name not in
                                  ROI + BESIDE_CHAIN], ids=repr)
def test_detection_op_matches_jax(case):
    check_against_jax(case)


def test_generate_proposals_scans_every_image_in_one_nms_call(monkeypatch):
    """``generate_proposals`` over N images calls the greedy NMS once with
    N problems (one B5 launch on the card)."""
    calls = []
    real = tdet.greedy_nms

    def counting(iou, valid, thr, eta):
        calls.append(tuple(iou.shape))
        return real(iou, valid, thr, eta)
    monkeypatch.setattr(tdet, "greedy_nms", counting)
    feats, scores, deltas, im = frcnn_inputs(n=3)
    anc, var = P.ops.anchor_generator(
        torch.from_numpy(feats[0]), anchor_sizes=[32.0],
        aspect_ratios=[0.5, 1.0, 2.0], variances=[1.0] * 4, stride=[4.0] * 2)
    rois, sc, num = P.ops.generate_proposals(
        torch.from_numpy(scores[0]), torch.from_numpy(deltas[0]),
        torch.from_numpy(im), anc, var, pre_nms_top_n=30,
        post_nms_top_n=10, nms_thresh=0.7, min_size=0.0)
    assert calls == [(3, 30, 30)]
    assert tuple(rois.shape) == (3, 10, 4) and num.dtype == torch.int32


def test_roi_ops_read_rois_num_on_the_host_and_refuse_a_capture(
        monkeypatch):
    """``rois_num`` is read on the host (the JAX package's LoD
    replacement), which a CUDA graph capture cannot do."""
    from paddle_tpu_torch.ops import dispatch
    monkeypatch.setattr(dispatch, "capturing", lambda: True)
    x = torch.zeros(2, 1, 4, 4)
    r = torch.tensor([[0.0, 0.0, 2.0, 2.0]] * 2)
    with pytest.raises(ValueError, match="rois_num"):
        P.ops.roi_align(x, r, 2, rois_num=torch.tensor([1, 1]))


def test_detection_names_in_the_reference_namespaces():
    """Every name of the JAX package's ``ops/detection.py`` in the port's
    module, its ``ops`` namespace and its top level, as the reference
    exports them."""
    from paddle_tpu.ops import detection as jdet
    names = [n for n in dir(jdet) if not n.startswith("_") and callable(
        getattr(jdet, n)) and getattr(getattr(jdet, n), "__module__",
                                      "") == jdet.__name__]
    for name in names:
        assert hasattr(tdet, name), name
        if hasattr(J.ops, name):
            assert getattr(P.ops, name) is getattr(tdet, name), name
        if hasattr(J, name):
            assert getattr(P, name) is getattr(tdet, name), name
    assert set(jdet.__all__) <= set(tdet.__all__)
