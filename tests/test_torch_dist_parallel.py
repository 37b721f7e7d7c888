"""Data, tensor and ZeRO parallelism at world 4 (four gloo ranks on the
CPU, started through the port's ``spawn``), held against the JAX
package: ``__graft_entry__.dryrun_multichip``'s dp2 x mp2 GPT (vocab 128,
hidden 64, 2 layers, 4 heads, seq 16, 3 AdamW steps through
``Model.train_batch``, parameters laid out by ``tp_partition_specs``,
the batch by ``shard_batch``), the same model through ``fleet``, the
``mp_layers`` forward and gradients, ``DataParallel`` and the ZeRO levels
against one process, and ``LocalSGDOptimizer``. The JAX side runs on
conftest's virtual CPU devices, as ``tests/test_fleet_tp_sharding.py``
runs it. AdamW's epsilon is 1e-6 in both packages, as in
``tests/test_torch_hapi_train.py``: ``k_proj.bias``'s gradient is zero up
to rounding, and with the default 1e-8 Adam moves it by a
rounding-driven fraction of lr that differs between the packages."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.models import gpt as jgpt

import torch_dist_worlds as W

torch.set_num_threads(2)

N = 4
EPS = 1e-6
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=256, max_position_embeddings=16,
               hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _np(t):
    return np.array(t._data if hasattr(t, "_data") else t)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    paddle.seed(0)
    jnet = JGPT(JGPTConfig(**GPT_CFG))
    gpt_w = {k: _np(v) for k, v in jnet.state_dict().items()}
    f = np.float32
    return {
        "gpt_cfg": GPT_CFG, "gpt_w": gpt_w, "eps": EPS,
        "ids": rng.randint(0, 128, (4, 16)).astype(np.int32),
        "layers": {
            "col": {"weight": rng.randn(16, 8).astype(f) * .3,
                    "bias": rng.randn(8).astype(f) * .1},
            "row": {"weight": rng.randn(8, 16).astype(f) * .3,
                    "bias": rng.randn(16).astype(f) * .1},
            "emb": {"weight": rng.randn(32, 16).astype(f) * .3},
            "x": rng.randn(4, 16).astype(f),
            "ids": rng.randint(0, 32, (4,)),
            "labels": rng.randint(0, 16, (4,))},
        "zero": {"0.weight": rng.randn(8, 16).astype(f) * .3,
                 "0.bias": rng.randn(16).astype(f) * .1,
                 "2.weight": rng.randn(16, 4).astype(f) * .3,
                 "2.bias": rng.randn(4).astype(f) * .1},
        "zx": rng.randn(8, 8).astype(f), "zy": rng.randn(8, 4).astype(f)}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    return W.run_world("parallel", tmp_path_factory.mktemp("par"),
                       inputs=inputs)


@pytest.fixture(scope="module")
def jax_dryrun(inputs):
    """dryrun_multichip's step on a dp2 x mp2 mesh of 4 CPU devices."""
    mesh = jdist.build_mesh({"dp": 2, "mp": 2}, jax.devices()[:N])
    jdist.set_mesh(mesh)
    try:
        net = JGPT(JGPTConfig(**GPT_CFG))
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in inputs["gpt_w"].items()})
        specs = jgpt.tp_partition_specs(net)
        for name, p in net.named_parameters():
            jdist.shard_tensor(p, JP(*specs[name]), mesh)
        opt = jopt.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                         weight_decay=0.01, epsilon=EPS)
        m = paddle.Model(net)
        m.prepare(opt, JCrit())
        x = jdist.shard_batch(paddle.to_tensor(inputs["ids"]), mesh)
        losses = [float(np.asarray(m.train_batch([x], [x])[0]))
                  for _ in range(3)]
        params = {k: _np(v) for k, v in net.state_dict().items()}
    finally:
        jdist.set_mesh(None)
    return losses, params


def test_ranks_import_no_jax(world):
    assert [r["_imported"] for r in world] == [[]] * N


@pytest.mark.parametrize("lane", ["dryrun", "fleet"])
def test_dp2_mp2_gpt_losses_match_jax(world, jax_dryrun, lane):
    ref, _ = jax_dryrun
    for r in world:
        np.testing.assert_allclose(r[f"{lane}_losses"], ref, rtol=0,
                                   atol=1e-5)
    assert ref[-1] < ref[0]


def test_dp2_mp2_gpt_gathered_params_match_jax(world, jax_dryrun):
    _, ref = jax_dryrun
    for r in world:
        got = r["dryrun_params"]
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_dp2_mp2_gpt_layout_is_the_tp_plan(world):
    pl = world[0]["placements"]
    assert pl["gpt.word_embeddings.weight"] == "(Replicate(), Shard(dim=0))"
    assert pl["gpt.decoder.layers.0.self_attn.q_proj.weight"] == \
        "(Replicate(), Shard(dim=1))"
    assert pl["gpt.decoder.layers.0.self_attn.out_proj.weight"] == \
        "(Replicate(), Shard(dim=0))"
    assert pl["gpt.decoder.layers.0.norm1.weight"] == \
        "(Replicate(), Replicate())"
    assert world[0]["dryrun_lane"] == "cpu"
    assert world[0]["fleet_mode"] == "model"


def test_mp_layers_match_jax(world, inputs):
    lw = inputs["layers"]
    mesh = jdist.build_mesh({"dp": 2, "mp": 2}, jax.devices()[:N])
    jdist.set_mesh(mesh)
    try:
        col = jfleet.ColumnParallelLinear(16, 8, gather_output=False)
        row = jfleet.RowParallelLinear(8, 16, input_is_parallel=True)
        emb = jfleet.VocabParallelEmbedding(32, 16)
        for layer, key in ((col, "col"), (row, "row"), (emb, "emb")):
            layer.set_state_dict({k: paddle.to_tensor(v)
                                  for k, v in lw[key].items()})
        x = paddle.to_tensor(lw["x"], stop_gradient=False)
        h = emb(paddle.to_tensor(lw["ids"]))
        y = row(col(x + h))
        ce = jfleet.ParallelCrossEntropy()(y, paddle.to_tensor(lw["labels"]))
        ce.backward()
        grads = [_np(x.grad)] + [_np(p.grad) for p in
                                 list(col.parameters())
                                 + list(row.parameters())
                                 + list(emb.parameters())]
        y_ref, ce_ref = _np(y), float(_np(ce))
    finally:
        jdist.set_mesh(None)
    for r in world:
        np.testing.assert_allclose(r["mp_out"], y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["mp_loss"], ce_ref, rtol=1e-5)
        assert len(r["mp_grads"]) == len(grads)
        for g, gr in zip(r["mp_grads"], grads):
            np.testing.assert_allclose(g, gr, rtol=1e-5,
                                       atol=1e-5 * np.abs(gr).max())
    assert world[0]["mp_col_out_placements"] == "(Replicate(), Shard(dim=1))"


def _jax_mlp(inputs, steps=3):
    """The MLP with replicated AdamW on one JAX device: losses, params and
    the first gradients."""
    import paddle_tpu.nn as jnn
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    net.set_state_dict({k: paddle.to_tensor(v)
                        for k, v in inputs["zero"].items()})
    loss = jnn.MSELoss()(net(paddle.to_tensor(inputs["zx"])),
                         paddle.to_tensor(inputs["zy"]))
    loss.backward()
    grads = [_np(p.grad) for p in net.parameters()]
    for p in net.parameters():
        p.clear_grad()
    opt = jopt.AdamW(learning_rate=1e-2, parameters=net.parameters())
    m = paddle.Model(net)
    m.prepare(opt, jnn.MSELoss())
    losses = [float(np.asarray(m.train_batch(
        [paddle.to_tensor(inputs["zx"])],
        [paddle.to_tensor(inputs["zy"])])[0])) for _ in range(steps)]
    return losses, {k: _np(v) for k, v in net.state_dict().items()}, grads


@pytest.fixture(scope="module")
def jax_mlp(inputs):
    return _jax_mlp(inputs)


@pytest.mark.parametrize("level", ["none", "os", "os_g", "p_g_os"])
def test_zero_levels_match_replicated_adamw(world, jax_mlp, level):
    losses, params, _ = jax_mlp
    for r in world:
        np.testing.assert_allclose(r[f"zero_{level}_losses"], losses,
                                   rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(r[f"zero_{level}_params"][k], v,
                                       rtol=0, atol=1e-5, err_msg=k)
        want = "(Replicate(),)" if level == "none" else "(Shard(dim=0),)"
        assert r[f"zero_{level}_state_placements"] == want


@pytest.mark.parametrize("wire", ["dense", "bf16", "int8"])
def test_data_parallel_matches_one_process(world, jax_mlp, wire):
    _, _, grads = jax_mlp
    # dense: the global-mean gradients; the bf16 wire rounds the partial
    # sums to bfloat16, the int8 wire is held to its quantization bound
    tol = {"dense": 1e-6, "bf16": 8e-3, "int8": 3e-2}[wire]
    for r in world:
        for g, gr in zip(r[f"dp_{wire}_grads"], grads):
            np.testing.assert_allclose(g, gr, rtol=0,
                                       atol=tol * np.abs(gr).max() + 1e-7)
    # every rank holds the same reduced gradients
    for r in world[1:]:
        for a, b in zip(r[f"dp_{wire}_grads"], world[0][f"dp_{wire}_grads"]):
            np.testing.assert_array_equal(a, b)


def test_data_parallel_refuses_a_batch_that_does_not_divide(world):
    for r in world:
        assert r["dp_odd_batch"] == ("DataParallel: a batch of 3 rows does "
                                     "not divide over the dp degree 4")


def test_local_sgd_averages_every_k_steps(world, inputs):
    w0 = inputs["zero"]["0.weight"][:, :4].astype(np.float64)
    ws = [w0.copy() for _ in range(N)]
    bs = [np.zeros(4) for _ in range(N)]
    want = []
    for t in range(1, 5):
        for r in range(N):
            x = inputs["zx"][r * 2:(r + 1) * 2].astype(np.float64)
            y = x @ ws[r] + bs[r]
            dy = 2 * y / y.size
            ws[r] = ws[r] - 0.1 * x.T @ dy
            bs[r] = bs[r] - 0.1 * dy.sum(0)
        if (t - 1) % 2 == 0:
            wm, bm = sum(ws) / N, sum(bs) / N
            ws, bs = [wm.copy() for _ in ws], [bm.copy() for _ in bs]
        want.append([w.copy() for w in ws])
    for r in range(N):
        for t in range(4):
            np.testing.assert_allclose(world[r]["localsgd"][t],
                                       want[t][r], rtol=1e-5, atol=1e-6)


def test_train_loop_refuses_a_model_on_a_mesh(world):
    for r in world:
        assert "DTensor shards" in r["train_loop_refusal"]
