"""The RoI poolings of ``ops/detection.py`` (``roi_align`` at
``sampling_ratio`` -1, 0 and 2 with rois across the border and bins past
the 8-tap cap, ``roi_pool``, ``prroi_pool``) against the JAX package on
the CPU, forward at 1e-5 and gradient at 1e-4
(``test_torch_detection_a9.py::check_against_jax``)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from paddle_tpu_torch.ops import detection as tdet  # noqa: E402
from test_torch_a9_table import DET_CASES  # noqa: E402
from test_torch_detection_a9 import (ROI, _cpu,  # noqa: E402,F401
                                     check_against_jax)


@pytest.mark.parametrize("case", [c for c in DET_CASES if c.name in ROI],
                         ids=repr)
def test_roi_op_matches_jax(case):
    check_against_jax(case)


def test_roi_align_past_the_tap_cap_keeps_eight_taps():
    """A bin wider than 8 pixels takes 8 taps an axis (the JAX package's
    cap), not ``ceil(bin)``: on a ramp along x the average of 8 evenly
    spaced taps is the bin's centre."""
    x = torch.arange(40, dtype=torch.float32).repeat(1, 1, 40, 1)
    rois = torch.tensor([[0.5, 0.5, 32.5, 32.5]])
    out = tdet.roi_align(x, rois, 2, sampling_ratio=-1)
    # bins of 16 pixels starting at 0 and 16: centres 8 and 24
    np.testing.assert_allclose(out[0, 0].numpy(), [[8.0, 24.0]] * 2,
                               rtol=1e-6)




def test_roi_align_in_a_capture_runs_the_whole_grid_to_the_same_values(
        monkeypatch):
    """Outside a capture ``roi_align`` skips the tap positions no roi
    uses (each would add exact zeros); inside one it runs the whole
    static grid: the same values, bit for bit."""
    from paddle_tpu_torch.ops import dispatch
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 3, 40, 44)).astype(
        np.float32))
    xy = rng.uniform(-4, 30, (6, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(1, 12, (6, 2))], 1).astype(np.float32))
    eager = tdet.roi_align(x, rois, 3, sampling_ratio=0)
    monkeypatch.setattr(tdet, "capturing", lambda: True)
    assert dispatch.capturing is not tdet.capturing
    assert torch.equal(tdet.roi_align(x, rois, 3, sampling_ratio=0), eager)
