"""The port's ``metric`` against the JAX package's on the same NumPy
inputs (distinct logits, so the order among ties never matters):
``Accuracy`` top-k with index, ``[N, 1]`` and one-hot labels and the 3-D
count (hits over every position divided by the batch, the reference's
``c.shape[0]`` rows), ``Precision``, ``Recall``, ``Auc``, the functional
``accuracy``, and ``DetectionMAP`` in both AP versions, with and without
``difficult`` boxes, values equal."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from paddle_tpu import metric as jm  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu_torch import metric as tm  # noqa: E402


def _logits(shape, seed=0):
    # a permutation per row: distinct values
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape[:-1]))
    rows = np.stack([rng.permutation(shape[-1]) for _ in range(n)])
    return (rows.reshape(shape) / shape[-1]).astype(np.float32)


def _accuracy_pair(topk, pred, label, batches=3):
    ja, ta = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    outs = []
    for b in range(batches):
        p, lab = pred[b], label[b]
        jr = ja.update(ja.compute(Tensor(jnp.asarray(p)),
                                  Tensor(jnp.asarray(lab))))
        tr = ta.update(ta.compute(torch.from_numpy(p),
                                  torch.from_numpy(lab)))
        outs.append((jr, tr))
    return ja, ta, outs


@pytest.mark.parametrize("label_kind", ["index", "n1", "onehot"])
@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
def test_accuracy_matches_jax(label_kind, topk):
    pred = _logits((3, 16, 10))
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 10, (3, 16))
    label = {"index": idx, "n1": idx[..., None],
             "onehot": np.eye(10, dtype=np.float32)[idx]}[label_kind]
    ja, ta, outs = _accuracy_pair(topk, pred, label)
    for jr, tr in outs:
        np.testing.assert_array_equal(tr, jr)
    assert ta.accumulate() == ja.accumulate()
    assert ta.name() == ja.name()
    assert ta.total == ja.total and ta.count == ja.count


def test_accuracy_three_d_counts_rows_not_positions():
    """For [B, S, V] predictions the hits over all B * S positions are
    divided by B, as in the reference (a value above 1 is possible)."""
    pred = _logits((2, 4, 6, 9), seed=2)
    label = np.argmax(pred, -1)             # every position a top-1 hit
    ja, ta, outs = _accuracy_pair((1,), pred, label, batches=2)
    for jr, tr in outs:
        np.testing.assert_array_equal(tr, jr)
    assert ta.accumulate() == ja.accumulate() == 6.0
    assert ta.count == [8]


def test_accuracy_compute_returns_the_host_mask():
    a = tm.Accuracy(topk=(1, 2))
    mask = a.compute(torch.tensor([[0.1, 0.5, 0.4], [0.6, 0.3, 0.1]]),
                     torch.tensor([2, 0]))
    assert isinstance(mask, np.ndarray) and mask.shape == (2, 2)
    a.update(mask)
    assert a.accumulate() == [0.5, 1.0]


def test_precision_recall_auc_match_jax():
    rng = np.random.default_rng(3)
    pairs = [(jm.Precision(), tm.Precision()), (jm.Recall(), tm.Recall()),
             (jm.Auc(), tm.Auc()), (jm.Auc(num_thresholds=15),
                                    tm.Auc(num_thresholds=15))]
    for _ in range(3):
        preds = rng.random(40).astype(np.float32)
        labels = (rng.random(40) < 0.4).astype(np.int64)
        for j, t in pairs:
            j.update(preds, labels)
            t.update(torch.from_numpy(preds), torch.from_numpy(labels))
    two_col = rng.random((10, 2)).astype(np.float32)
    pairs[2][0].update(two_col, labels[:10])
    pairs[2][1].update(two_col, labels[:10])
    for j, t in pairs:
        assert t.accumulate() == pytest.approx(j.accumulate(), abs=1e-12)
        assert t.name() == j.name()
    assert tm.Auc().accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy_matches_jax(k):
    pred = _logits((32, 7), seed=4)
    label = np.random.default_rng(4).integers(0, 7, (32, 1))
    want = float(np.asarray(jm.accuracy(Tensor(jnp.asarray(pred)),
                                        Tensor(jnp.asarray(label)),
                                        k=k)._data))
    got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
    assert got.dtype == torch.float32 and float(got) == want


def _detections(seed, n=3, k=12, b=5, classes=4):
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, b, 4), np.float32)
    gl = np.zeros((n, b), np.int64)
    dif = np.zeros((n, b), np.int64)
    dets = np.full((n, k, 6), -1.0, np.float32)
    counts = np.zeros(n, np.int64)
    for i in range(n):
        m = rng.integers(1, b + 1)
        xy = rng.random((m, 2)) * 50
        wh = rng.random((m, 2)) * 30 + 5
        gt[i, :m] = np.concatenate([xy, xy + wh], 1)
        gl[i, :m] = rng.integers(0, classes, m)
        dif[i, :m] = rng.random(m) < 0.3
        c = rng.integers(1, k + 1)
        counts[i] = c
        src = rng.integers(0, m, c)
        jitter = rng.normal(0, 3, (c, 4))
        dets[i, :c, 2:] = gt[i, src] + jitter
        dets[i, :c, 0] = np.where(rng.random(c) < 0.8, gl[i, src],
                                  rng.integers(0, classes, c))
        dets[i, :c, 1] = rng.permutation(c) / c + 0.01
    return dets, counts, gt, gl, dif


@pytest.mark.parametrize("difficult", [False, True])
@pytest.mark.parametrize("evaluate_difficult", [False, True])
@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_matches_jax(ap_version, evaluate_difficult,
                                   difficult):
    kw = dict(overlap_threshold=0.5, evaluate_difficult=evaluate_difficult,
              ap_version=ap_version)
    j, t = jm.DetectionMAP(4, **kw), tm.DetectionMAP(4, **kw)
    for seed in range(3):
        dets, counts, gt, gl, dif = _detections(seed)
        d = dif if difficult else None
        j.update(dets, counts, gt, gl, d)
        t.update(torch.from_numpy(dets), torch.from_numpy(counts),
                 torch.from_numpy(gt), torch.from_numpy(gl),
                 None if d is None else torch.from_numpy(d))
    assert 0.0 < t.accumulate() <= 1.0
    assert t.accumulate() == j.accumulate()
    t.reset()
    assert t.accumulate() == 0.0
    with pytest.raises(ValueError):
        tm.DetectionMAP(4, ap_version="voc")
