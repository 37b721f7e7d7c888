"""The tiny YOLOv3 of ``tests/test_yolov3_e2e.py`` trained through
``Model.train_batch``: its first float32 steps and its first O1 bfloat16
step against the JAX package's, with the batch, weights and helpers of
``test_torch_yolov3_train.py`` (which holds the loss and the float64
curve). The float32 curves of the two packages part by 1.4e-7 at step
1 and 6.7e-6 at step 2 (then 3.7e-4: the curve is ill-conditioned, see
that file), so the first loss holds at 1e-5 and the second at 1e-4.
Under O1 the head outputs reach the loss in bfloat16 in both packages
(``yolov3_loss`` is in no AMP list) and the first loss holds at 2e-2."""
import numpy as np
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu_torch import amp  # noqa: E402
from test_torch_yolov3_train import (CURVE_TOL, TOL, _jax_model,  # noqa: E402
                                     _jax_tiny, _port_model, _train_batch)

AMP_TOL = 2e-2


def test_float32_first_steps_match_jax():
    """The first float32 losses (BN in train mode, its statistics moved
    in place by the step): 1e-5, then 1e-4."""
    jm, arrays = _jax_tiny()
    img, gt_box, gt_label = _train_batch()
    jmod = _jax_model(jm)
    jl = [jmod.train_batch([img], [gt_box, gt_label])[0] for _ in range(2)]
    m, tm = _port_model(arrays)
    tl = [m.train_batch([img], [gt_box, gt_label])[0] for _ in range(2)]
    assert abs(tl[0] - jl[0]) / abs(jl[0]) < TOL, (tl, jl)
    assert abs(tl[1] - jl[1]) / abs(jl[1]) < CURVE_TOL, (tl, jl)
    moved = [n for n, b in tm.named_buffers() if n.endswith("_mean")
             and np.abs(b.numpy() - arrays[n]).max() > 0]
    assert moved, "BN running statistics did not move"


def test_o1_bfloat16_first_loss_matches_jax():
    """Under O1 the head convolutions give bfloat16 and the loss takes it
    as it comes; the first loss within 2e-2 of the JAX package's O1
    loss, the step's weights stay float32."""
    jm, arrays = _jax_tiny()
    img, gt_box, gt_label = _train_batch()
    jmod = _jax_model(jm)
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
        jl = jmod.train_batch([img], [gt_box, gt_label])[0]
    m, tm = _port_model(arrays)
    seen = []
    tm.yolo_out2.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
    try:
        with amp.auto_cast():
            tl = m.train_batch([img], [gt_box, gt_label])[0]
    finally:
        assert not amp.is_auto_cast_enabled()
    assert seen == [torch.bfloat16]
    assert abs(tl - jl) / abs(jl) < AMP_TOL, (tl, jl)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
