"""BERT/ERNIE of the port against the JAX package's at bench.py's CPU
config (vocab 1000, hidden 64, 2 layers, 2 heads, FFN 128, 64 positions;
``[2, 16]`` ids), dropout 0, weights carried by
``state_dict_from_reference``: ``BertModel``'s sequence and pooled
outputs with and without ``attention_mask`` and ``token_type_ids`` (eval
and train mode) at 1e-5, the classification head and the ERNIE aliases,
bench.py's MLM head (``BertModel`` + a vocabulary ``Linear``, flattened
cross entropy) trained 10 ``Model.train_batch`` steps with AdamW (lr
1e-4, weight decay 0.01) at 1e-4, with the weights after them, the
pooler's included (it gets no gradient and AdamW only decays it), 3 O1
bfloat16 steps at 2e-2, and the port's flash lane (the plain version of
B1 on the CPU) against its dense lane."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.models import bert as jbert  # noqa: E402
from paddle_tpu.nn.layer_base import Layer  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import bert as tbert  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

TOL = 1e-5
CURVE_TOL = 1e-4
AMP_TOL = 2e-2
# bench.py's CPU config (:138-141), dropout 0
CFG = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
SHAPE = (2, 16)


def _ids(seed=0, hi=CFG["vocab_size"]):
    return np.random.RandomState(seed).randint(0, hi, SHAPE).astype(np.int32)


def _arrays(jnet):
    return {k: np.array(v._data) for k, v in jnet.state_dict().items()}


def _carry(jnet, tnet):
    tnet.load_state_dict(P.state_dict_from_reference(_arrays(jnet), "cpu"),
                         strict=True)
    return tnet


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else \
        t.detach().numpy()


def _bert_pair(cls_j=None, cls_t=None, cfg=CFG, **kw):
    paddle.seed(0)
    jnet = (cls_j or jbert.BertModel)(jbert.BertConfig(**cfg), **kw)
    tnet = (cls_t or tbert.BertModel)(tbert.BertConfig(**cfg), device="cpu",
                                      seed=None, **kw)
    return jnet, _carry(jnet, tnet)


# -- forwards -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("mask,types", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["plain", "mask", "token_types", "both"])
def test_bert_model_matches_jax(mask, types, mode):
    jnet, tnet = _bert_pair()
    getattr(jnet, mode)()
    getattr(tnet, mode)()
    ids = _ids()
    kw_j, kw_t = {}, {}
    if mask:
        m = np.ones(SHAPE, np.int32)
        m[0, 11:] = 0
        m[1, 5:] = 0
        kw_j["attention_mask"] = paddle.to_tensor(m)
        kw_t["attention_mask"] = torch.from_numpy(m)
    if types:
        tt = np.zeros(SHAPE, np.int32)
        tt[:, 8:] = 1
        kw_j["token_type_ids"] = paddle.to_tensor(tt)
        kw_t["token_type_ids"] = torch.from_numpy(tt)
    jseq, jpool = jnet(paddle.to_tensor(ids), **kw_j)
    with torch.no_grad():
        tseq, tpool = tnet(torch.from_numpy(ids), **kw_t)
    np.testing.assert_allclose(_np(tseq), _np(jseq), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(tpool), _np(jpool), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["bert", "ernie"])
def test_classification_head_and_ernie_aliases_match_jax(kind):
    if kind == "bert":
        jnet, tnet = _bert_pair(jbert.BertForSequenceClassification,
                                tbert.BertForSequenceClassification,
                                num_classes=3)
        hi = CFG["vocab_size"]
    else:
        small = dict(CFG)
        small.pop("vocab_size")
        paddle.seed(0)
        jnet = jbert.ErnieForSequenceClassification(
            jbert.ErnieConfig(**small), num_classes=3)
        tnet = _carry(jnet, tbert.ErnieForSequenceClassification(
            tbert.ErnieConfig(**small), num_classes=3, device="cpu",
            seed=None))
        assert tnet.bert.config.vocab_size == 18000
        assert isinstance(tbert.ErnieModel(tbert.ErnieConfig(**small),
                                           device="cpu"), tbert.BertModel)
        hi = 18000
    jnet.eval()
    tnet.eval()
    ids = _ids(1, hi)
    m = np.ones(SHAPE, np.int32)
    m[1, 9:] = 0
    jout = jnet(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(m))
    with torch.no_grad():
        tout = tnet(torch.from_numpy(ids), attention_mask=torch.from_numpy(m))
    assert tuple(tout.shape) == (SHAPE[0], 3)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=TOL, atol=TOL)


def test_flash_lane_matches_dense_in_eval():
    """No mask, eval: ``"auto"`` takes the flash lane (B1's plain version
    on the CPU; on the card the kernel) at head dim 32, non-causal; the
    dense lane gives the same outputs."""
    _, tnet = _bert_pair()
    tnet.eval()
    ids = torch.from_numpy(_ids(2))
    before = tfa.flash_attention_fwd.launches
    with torch.no_grad():
        flash = tnet(ids)
        for layer in tnet.encoder.layers:
            layer.self_attn.attn_impl = "dense"
        dense = tnet(ids)
    assert tfa.flash_attention_fwd.launches == before     # CPU: plain lane
    for a, b in zip(flash, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


# -- bench.py's MLM head through Model.train_batch ----------------------------

class JMLMHead(Layer):
    """bench.py's ``MLMHead`` (``:143-151``)."""

    def __init__(self):
        super().__init__()
        self.bert = jbert.BertModel(jbert.BertConfig(**CFG))
        self.head = jnn.Linear(CFG["hidden_size"], CFG["vocab_size"])

    def forward(self, ids):
        seq_out, _ = self.bert(ids)
        return self.head(seq_out)


class JFlatCE(Layer):
    """bench.py's ``FlatCE`` (``:153-158``)."""

    def forward(self, logits, labels):
        v = logits.shape[-1]
        return jnn.functional.cross_entropy(
            jops.reshape(logits, [-1, v]), jops.reshape(labels, [-1]))


class TMLMHead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bert = tbert.BertModel(tbert.BertConfig(**CFG), device="cpu",
                                    seed=None)
        self.head = tnn.Linear(CFG["hidden_size"], CFG["vocab_size"],
                               device="cpu")

    def forward(self, ids):
        seq_out, _ = self.bert(ids)
        return self.head(seq_out)


class TFlatCE(torch.nn.Module):
    def forward(self, logits, labels):
        v = logits.shape[-1]
        return tnn.functional.cross_entropy(logits.reshape(-1, v),
                                            labels.reshape(-1))


def _mlm(pkg):
    if pkg == "jax":
        paddle.seed(0)
        net = JMLMHead()
        opt = jopt.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                         weight_decay=0.01)
        m = paddle.Model(net)
        m.prepare(opt, JFlatCE())
        return m, net
    net = TMLMHead()
    opt = topt.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                     weight_decay=0.01, device="cpu")
    m = P.Model(net, device="cpu")
    m.prepare(opt, TFlatCE())
    return m, net


@pytest.fixture(scope="module")
def mlm_reference():
    """The JAX side: 10 fp32 AdamW steps and the weights after them, and 3
    O1 bfloat16 steps from the same weights."""
    ids = _ids(3)
    labels = ids.astype(np.int64)
    m, net = _mlm("jax")
    arrays = _arrays(net)
    losses = [m.train_batch([ids], [labels])[0] for _ in range(10)]
    after = _arrays(net)
    m, _ = _mlm("jax")
    with jamp.auto_cast():
        o1 = [m.train_batch([ids], [labels])[0] for _ in range(3)]
    return dict(arrays=arrays, losses=losses, after=after, o1=o1, ids=ids,
                labels=labels)


def _port_mlm(ref):
    m, net = _mlm("torch")
    net.load_state_dict(P.state_dict_from_reference(ref["arrays"], "cpu"),
                        strict=True)
    return m, net


def test_mlm_ten_step_adamw_curve_matches_jax(mlm_reference):
    ref = mlm_reference
    m, net = _port_mlm(ref)
    losses = [m.train_batch([ref["ids"]], [ref["labels"]])[0]
              for _ in range(10)]
    rel = np.abs(np.array(losses) - ref["losses"]) / np.abs(ref["losses"])
    assert rel.max() < CURVE_TOL, (losses, ref["losses"])
    assert losses[-1] < losses[0]
    top = max(np.abs(v).max() for v in ref["after"].values())
    for k, v in net.state_dict().items():
        if k.endswith("k_proj.bias"):
            # its gradient is zero but for rounding (softmax ignores a
            # shift shared by all keys), and Adam (eps 1e-8) moves it by a
            # rounding-driven fraction of lr, differently per package
            continue
        np.testing.assert_allclose(v.numpy(), ref["after"][k], rtol=0,
                                   atol=1e-5 * top, err_msg=k)
    # the pooler reached no loss: only the decoupled decay moved it
    for k in ("bert.pooler.dense.weight", "bert.pooler.dense.bias"):
        want = ref["arrays"][k] * (1 - 1e-4 * 0.01) ** 10
        np.testing.assert_allclose(net.state_dict()[k].numpy(), want,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(net.state_dict()[k].numpy(),
                                   ref["after"][k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_mlm_o1_curve_matches_jax(mlm_reference):
    ref = mlm_reference
    m, net = _port_mlm(ref)
    with amp.auto_cast():
        losses = [m.train_batch([ref["ids"]], [ref["labels"]])[0]
                  for _ in range(3)]
    rel = np.abs(np.array(losses) - ref["o1"]) / np.abs(ref["o1"])
    assert rel.max() < AMP_TOL, (losses, ref["o1"])
    assert all(p.dtype == torch.float32 for p in net.parameters())
