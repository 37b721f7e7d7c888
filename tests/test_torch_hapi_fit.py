"""``Model.fit``/``evaluate``/``predict`` of the port over its own
``io.Dataset`` and ``io.DataLoader``, with metrics and the compiled eval
and predict programs, against the JAX package's ``paddle.Model``: a LeNet
(28x28, 10 classes) with ``Accuracy(topk=(1, 2))`` and Momentum, and
bench.py's BERT MLM head at its CPU config with Lamb, weights carried by
``state_dict_from_reference``, the same NumPy data and ``np.random.seed``
(the shuffles draw from NumPy's global generator in both packages).
Per-step losses at 1e-4, metric values equal, ``evaluate`` logs equal
(loss at 1e-5), stacked ``predict`` outputs at 1e-5; metrics attached
after a first step recompile with predictions; ``train_batches`` and
``train_loop`` refuse metrics; one eval program per signature and form;
``summary`` totals equal; ``VisualDL`` writes the logs."""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.io as jio  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import metric as jmetric  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.hapi.callbacks import Callback as JCallback  # noqa: E402
from paddle_tpu.models import bert as jbert  # noqa: E402
from paddle_tpu.nn.layer_base import Layer  # noqa: E402
from paddle_tpu.vision.models import LeNet as JLeNet  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch import metric as tmetric  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.core.graphs import disable_graphs  # noqa: E402
from paddle_tpu_torch.hapi.callbacks import Callback, VisualDL  # noqa: E402
from paddle_tpu_torch.models import bert as tbert  # noqa: E402
from paddle_tpu_torch.vision.models import LeNet as TLeNet  # noqa: E402

CURVE_TOL = 1e-4
TOL = 1e-5
N, BATCH = 48, 16
BERT_CFG = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                intermediate_size=128, max_position_embeddings=64,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _images(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, (n, 1)).astype(np.int64))


class JArrays(jio.Dataset):
    def __init__(self, *arrays):
        self.arrays = arrays

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


class TArrays(tio.Dataset):
    def __init__(self, *arrays):
        self.arrays = arrays

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


def _arrays(jnet):
    return {k: np.array(v._data) for k, v in jnet.state_dict().items()}


def _losses(cb_base):
    class Rec(cb_base):
        def __init__(self):
            super().__init__()
            self.logs = []

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs))
    return Rec()


def _lenet_pair(metrics=True):
    paddle.seed(0)
    jnet = JLeNet()
    jm = paddle.Model(jnet)
    jm.prepare(jopt.Momentum(0.05, 0.9, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(),
               metrics=jmetric.Accuracy(topk=(1, 2)) if metrics else None)
    tnet = TLeNet(device="cpu", seed=None)
    tnet.load_state_dict(P.state_dict_from_reference(_arrays(jnet), "cpu"))
    tm = P.Model(tnet, device="cpu")
    tm.prepare(topt.Momentum(0.05, 0.9, parameters=tnet.parameters(),
                             device="cpu"),
               tnn.CrossEntropyLoss(),
               metrics=tmetric.Accuracy(topk=(1, 2)) if metrics else None)
    return jm, tm


def _as_input(kind, pkg, arrays, shuffle):
    ds = (JArrays if pkg == "jax" else TArrays)(*arrays)
    if kind == "dataset":
        return ds
    if pkg == "jax":
        return jio.DataLoader(ds, batch_size=BATCH, shuffle=shuffle)
    return tio.DataLoader(ds, batch_size=BATCH, shuffle=shuffle,
                          device="cpu")


def _assert_logs_equal(got, want, what):
    assert got.keys() == want.keys(), (what, got, want)
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        if k == "loss":
            np.testing.assert_allclose(g, w, rtol=TOL, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["dataset", "loader"])
def test_lenet_fit_evaluate_predict_match_jax(kind):
    jm, tm = _lenet_pair()
    x, y = _images(0)
    ex, ey = _images(1, 32)
    out = {}
    for pkg, m, cb in (("jax", jm, _losses(JCallback)),
                       ("torch", tm, _losses(Callback))):
        np.random.seed(7)
        m.fit(_as_input(kind, pkg, (x, y), True),
              _as_input(kind, pkg, (ex, ey), False), batch_size=BATCH,
              epochs=2, verbose=0, callbacks=[cb])
        ev = m.evaluate(_as_input(kind, pkg, (ex, ey), False),
                        batch_size=BATCH, verbose=0)
        pred = m.predict(_as_input(kind, pkg, (ex,), False),
                         batch_size=BATCH, stack_outputs=True)
        out[pkg] = (cb.logs, ev, pred)
    (jl, jev, jpred), (tl, tev, tpred) = out["jax"], out["torch"]
    assert len(tl) == len(jl) == 2 * N // BATCH
    jloss = np.array([d["loss"] for d in jl])
    tloss = np.array([d["loss"] for d in tl])
    assert (np.abs(tloss - jloss) / np.abs(jloss)).max() < CURVE_TOL
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(t["acc_top1"], j["acc_top1"])
    _assert_logs_equal(tev, jev, "evaluate")
    assert set(tev) == {"loss", "acc_top1"}
    assert len(tpred) == 1 and tpred[0].shape == (32, 10)
    np.testing.assert_allclose(tpred[0], jpred[0], rtol=TOL, atol=TOL)


def test_fit_over_a_multiprocess_loader_matches_single_process():
    """Two worker processes feed the same batches, in order, as the
    single-process loader (shuffled from the same NumPy seed), so fit's
    losses are bit-equal."""
    x, y = _images(0)
    runs = []
    for workers in (0, 2):
        _, tm = _lenet_pair(metrics=False)
        cb = _losses(Callback)
        np.random.seed(3)
        loader = tio.DataLoader(TArrays(x, y), batch_size=BATCH,
                                shuffle=False, num_workers=workers,
                                timeout=30, device="cpu")
        tm.fit(loader, epochs=1, verbose=0, callbacks=[cb])
        runs.append([d["loss"] for d in cb.logs])
        if workers:
            assert loader.stats["queue"] == 0
            assert loader.stats["shm"] + loader.stats["queue"] == 3
    assert runs[0] == runs[1]


def test_metrics_attached_after_prepare_recompile_with_predictions():
    """Mirrors the reference's ``TestMetricsAfterPrepareRecompiles``."""
    net = TLeNet(device="cpu", seed=0)
    m = P.Model(net, device="cpu")
    opt = topt.SGD(learning_rate=0.1, parameters=net.parameters(),
                   device="cpu")
    m.prepare(opt, tnn.CrossEntropyLoss())
    x, y = _images(0, 8)
    assert m.train_batch([x], [y])[1] == []
    m.prepare(opt, tnn.CrossEntropyLoss(), metrics=tmetric.Accuracy())
    loss, mets = m.train_batch([x], [y])
    assert mets and mets[0] is not None
    assert m._train_sig[3] is True


@pytest.mark.parametrize("how", ["train_batches", "train_loop"])
def test_multi_step_paths_refuse_metrics(how):
    net = TLeNet(device="cpu", seed=0)
    m = P.Model(net, device="cpu")
    m.prepare(topt.SGD(0.1, parameters=net.parameters(), device="cpu"),
              tnn.CrossEntropyLoss(), metrics=tmetric.Accuracy())
    x, y = _images(0, 8)
    with pytest.raises(ValueError, match="detach metrics"):
        getattr(m, how)([x[None]], [y[None]])


def test_one_eval_program_per_signature_and_form_and_eager_lane():
    jm, tm = _lenet_pair()
    x, y = _images(2, 16)
    for _ in range(3):
        loss, mets = tm.eval_batch([x], [y])
    assert len(tm._eval_fns) == 1
    ef = next(iter(tm._eval_fns.values()))
    assert ef["fn"].trace_counter["traces"] == 1
    tm.eval_batch([x[:8]], [y[:8]])
    tm.predict_batch([x])
    tm.predict_batch([x])
    assert len(tm._eval_fns) == 3
    jloss, jmets = jm.eval_batch([x], [y])
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    np.testing.assert_array_equal(mets[0], jmets[0])
    # the eager lane runs the same function
    with disable_graphs():
        eloss, emets = tm.eval_batch([x], [y])
        epred = tm.predict_batch([x])
    assert eloss == loss
    np.testing.assert_array_equal(emets[0], mets[0])
    np.testing.assert_array_equal(epred.numpy(), tm.predict_batch([x])
                                  .numpy())
    # prepare drops the programs
    tm.prepare(tm._optimizer, tm._loss, metrics=tm._metrics)
    assert len(tm._eval_fns) == 0


def test_eval_reads_weights_changed_in_place_and_predict_returns_copies():
    _, tm = _lenet_pair(metrics=False)
    x, _ = _images(4, 16)
    a = tm.predict_batch([x])
    with torch.no_grad():
        for p in tm.network.parameters():
            p.mul_(0.5)
    b = tm.predict_batch([x])
    assert not torch.equal(a, b)
    with disable_graphs():
        np.testing.assert_array_equal(b.numpy(),
                                      tm.predict_batch([x]).numpy())


def _summary_totals(capsys, fn):
    out = fn()
    capsys.readouterr()
    return out


def test_summary_totals_match_jax(capsys):
    jm, tm = _lenet_pair()
    assert _summary_totals(capsys, tm.summary) == \
        _summary_totals(capsys, jm.summary)
    jnet, tnet = _bert_pair()
    assert _summary_totals(capsys, lambda: P.summary(tnet)) == \
        _summary_totals(capsys, lambda: paddle.summary(jnet))


def test_visualdl_writes_the_train_logs(tmp_path):
    _, tm = _lenet_pair()
    x, y = _images(0, 32)
    np.random.seed(0)
    tm.fit(TArrays(x, y), batch_size=BATCH, epochs=1, verbose=0,
           callbacks=[VisualDL(str(tmp_path))])
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert set(recs[0]) == {"step", "loss", "acc_top1"}


# -- bench.py's BERT MLM head with Lamb ---------------------------------------

class JMLM(Layer):
    def __init__(self):
        super().__init__()
        self.bert = jbert.BertModel(jbert.BertConfig(**BERT_CFG))
        self.head = jnn.Linear(BERT_CFG["hidden_size"],
                               BERT_CFG["vocab_size"])

    def forward(self, ids):
        return self.head(self.bert(ids)[0])


class JFlatCE(Layer):
    def forward(self, logits, labels):
        v = logits.shape[-1]
        return jnn.functional.cross_entropy(
            jops.reshape(logits, [-1, v]), jops.reshape(labels, [-1]))


class TMLM(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bert = tbert.BertModel(tbert.BertConfig(**BERT_CFG),
                                    device="cpu", seed=None)
        self.head = tnn.Linear(BERT_CFG["hidden_size"],
                               BERT_CFG["vocab_size"], device="cpu")

    def forward(self, ids):
        return self.head(self.bert(ids)[0])


class TFlatCE(torch.nn.Module):
    def forward(self, logits, labels):
        v = logits.shape[-1]
        return tnn.functional.cross_entropy(logits.reshape(-1, v),
                                            labels.reshape(-1))


def _bert_pair():
    paddle.seed(0)
    jnet = JMLM()
    tnet = TMLM()
    tnet.load_state_dict(P.state_dict_from_reference(_arrays(jnet), "cpu"))
    return jnet, tnet


def test_bert_lamb_fit_and_evaluate_over_a_loader_match_jax():
    jnet, tnet = _bert_pair()
    jm = paddle.Model(jnet)
    jm.prepare(jopt.Lamb(1e-3, lamb_weight_decay=0.01,
                         parameters=jnet.parameters()), JFlatCE())
    tm = P.Model(tnet, device="cpu")
    tm.prepare(topt.Lamb(1e-3, lamb_weight_decay=0.01,
                         parameters=tnet.parameters(), device="cpu"),
               TFlatCE())
    ids = np.random.RandomState(5).randint(
        0, BERT_CFG["vocab_size"], (12, 16)).astype(np.int64)
    out = {}
    for pkg, m, cb in (("jax", jm, _losses(JCallback)),
                       ("torch", tm, _losses(Callback))):
        np.random.seed(11)
        ds = (JArrays if pkg == "jax" else TArrays)(ids, ids)
        loader = jio.DataLoader(ds, batch_size=4, shuffle=True) \
            if pkg == "jax" else tio.DataLoader(ds, batch_size=4,
                                                shuffle=True, device="cpu")
        m.fit(loader, epochs=2, verbose=0, callbacks=[cb])
        out[pkg] = ([d["loss"] for d in cb.logs],
                    m.evaluate(ds, batch_size=6, verbose=0))
    (jl, jev), (tl, tev) = out["jax"], out["torch"]
    assert len(tl) == 6
    rel = np.abs(np.array(tl) - jl) / np.abs(jl)
    assert rel.max() < CURVE_TOL, (tl, jl)
    _assert_logs_equal(tev, jev, "evaluate")
