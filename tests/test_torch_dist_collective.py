"""The port's collectives, topology, strategy and env contract at world 4
(four gloo ranks on the CPU, started through the port's ``spawn``),
held against the JAX package's on its 4-device CPU mesh (conftest's
virtual devices, ``shard_map``), as ``tests/test_distributed.py`` and
``tests/test_compressed_allreduce.py`` run it. The ranks import neither
JAX nor the JAX package (``torch_dist_worlds.py``)."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy

import torch_dist_worlds as W

torch.set_num_threads(2)

N = 4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(N, 8).astype(np.float32),
            "grad": rng.randn(N, 256).astype(np.float32),
            "w": (rng.randn(16, 4) * 0.1).astype(np.float32),
            "xs": rng.randn(16, 16).astype(np.float32),
            "ys": rng.randn(16, 4).astype(np.float32),
            "w_p2p": rng.randn(N, 8).astype(np.float32)}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    return W.run_world("collectives", tmp_path_factory.mktemp("coll"),
                       inputs=inputs)


@pytest.fixture
def dp4():
    mesh = jdist.build_mesh({"dp": N}, jax.devices()[:N])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(None)


def _spmd(fn, x, out_spec=P("dp")):
    return np.asarray(jax.shard_map(fn, mesh=jdist.get_mesh(),
                                    in_specs=P("dp"), out_specs=out_spec,
                                    check_vma=False)(
        jnp.asarray(x.reshape(-1))))


def _by_rank(world, key):
    return [r[key] for r in world]


def test_ranks_import_no_jax(world):
    assert [r["_imported"] for r in world] == [[]] * N
    assert [r["_rank"] for r in world] == list(range(N))


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce(world, inputs, dp4, op):
    jop = getattr(JC.ReduceOp, op.upper())
    ref = _spmd(lambda v: JC.all_reduce(v, op=jop), inputs["x"]).reshape(N, 8)
    for r, got in enumerate(_by_rank(world, f"all_reduce_{op}")):
        np.testing.assert_allclose(got, ref[r], rtol=1e-6, atol=1e-6)


def test_all_reduce_over_a_rank_subgroup(world, inputs, dp4):
    g = JC.new_group([0, 2])
    ref = _spmd(lambda v: JC.all_reduce(v, group=g), inputs["x"]) \
        .reshape(N, 8)
    for r, got in enumerate(_by_rank(world, "all_reduce_subgroup")):
        np.testing.assert_allclose(got, ref[r], rtol=1e-6)
    # non-members keep their input
    np.testing.assert_array_equal(world[1]["all_reduce_subgroup"],
                                  inputs["x"][1])


@pytest.mark.parametrize("sub", [False, True])
def test_broadcast(world, inputs, dp4, sub):
    g = JC.new_group([0, 2]) if sub else None
    ref = _spmd(lambda v: JC.broadcast(v, 2, group=g),
                inputs["x"]).reshape(N, 8)
    key = "broadcast_subgroup" if sub else "broadcast"
    for r, got in enumerate(_by_rank(world, key)):
        np.testing.assert_array_equal(got, ref[r])


def test_reduce_to_dst(world, inputs, dp4):
    ref = _spmd(lambda v: JC.reduce(v, 1), inputs["x"]).reshape(N, 8)
    for r, got in enumerate(_by_rank(world, "reduce")):
        np.testing.assert_allclose(got, ref[r], rtol=1e-6)


def test_all_gather(world, inputs, dp4):
    ref = _spmd(lambda v: JC.all_gather(None, v), inputs["x"], P())
    for r in world:
        np.testing.assert_array_equal(r["all_gather"], ref)
        np.testing.assert_array_equal(np.stack(r["all_gather_list"]), ref)


def test_all_gather_over_a_rank_subgroup(world, inputs, dp4):
    g = JC.new_group([0, 2])
    ref = _spmd(lambda v: JC.all_gather(None, v, group=g), inputs["x"], P())
    for r in (0, 2):
        np.testing.assert_array_equal(world[r]["all_gather_subgroup"], ref)


def test_reduce_scatter(world, inputs, dp4):
    ref = _spmd(lambda v: JC.reduce_scatter(None, v), inputs["x"]) \
        .reshape(N, 2)
    for r, got in enumerate(_by_rank(world, "reduce_scatter")):
        np.testing.assert_allclose(got, ref[r], rtol=1e-6)


def test_alltoall(world, inputs, dp4):
    ref = _spmd(lambda v: JC.alltoall(v), inputs["x"]).reshape(N, 8)
    for r, got in enumerate(_by_rank(world, "alltoall")):
        np.testing.assert_array_equal(got, ref[r])


def test_p2p_exchange(world, inputs, dp4):
    ref = _spmd(lambda v: JC.p2p_exchange(v, src=1, dst=3),
                inputs["x"]).reshape(N, 8)
    for r, got in enumerate(_by_rank(world, "p2p_exchange")):
        np.testing.assert_array_equal(got, ref[r])


def test_send_recv_scatter_and_objects(world, inputs):
    x = inputs["x"]
    for r in range(N):
        want = x[0] * 10 if r == 3 else x[r]
        np.testing.assert_array_equal(world[r]["send_recv"], want)
        np.testing.assert_array_equal(world[r]["scatter"],
                                      np.full(8, r + 1.0, np.float32))
        assert world[r]["all_gather_object"] == [
            {"rank": i, "tag": "x" * i} for i in range(N)]


def test_all_reduce_gradient(world, inputs, dp4):
    xv = inputs["x"][:, 0]

    def loss(x):
        def per(v):
            return jax.lax.pmean(jnp.sum(JC.all_reduce(v) ** 2), "dp")
        return jax.shard_map(per, mesh=jdist.get_mesh(), in_specs=P("dp"),
                             out_specs=P())(x)
    ref = np.asarray(jax.grad(loss)(jnp.asarray(xv)))
    got = np.concatenate(_by_rank(world, "all_reduce_grad"))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_p2p_exchange_gradient(world, inputs, dp4):
    w = jnp.asarray(inputs["w_p2p"].reshape(-1))

    def loss(x):
        out = jax.shard_map(lambda v: JC.p2p_exchange(v, src=1, dst=3),
                            mesh=jdist.get_mesh(), in_specs=P("dp"),
                            out_specs=P("dp"))(x)
        return jnp.sum(out * w)
    ref = np.asarray(jax.grad(loss)(jnp.asarray(
        inputs["x"].reshape(-1)))).reshape(N, 8)
    for r, got in enumerate(_by_rank(world, "p2p_grad")):
        np.testing.assert_allclose(got, ref[r], rtol=1e-6)


def test_topology_axis_groups(world, inputs):
    topo = jdist.CommunicateTopology(["data", "pipe", "sharding", "sep",
                                      "model"], [2, 1, 1, 1, 2])
    comm = {"dp": topo.get_comm_list("data"),
            "mp": topo.get_comm_list("model")}
    assert world[0]["mesh"] == (("dp", "mp"), [[0, 1], [2, 3]])
    for r in range(N):
        for axis in ("dp", "mp"):
            group = world[r]["groups"][axis]
            assert group in comm[axis] and r in group
        c = topo.get_coord(r)
        assert world[r]["coords"] == (c[0], c[4])
        x = inputs["x"]
        np.testing.assert_allclose(
            world[r]["all_reduce_mp"],
            sum(x[i] for i in world[r]["groups"]["mp"]), rtol=1e-6)
        np.testing.assert_allclose(
            world[r]["all_reduce_dp"],
            sum(x[i] for i in world[r]["groups"]["dp"]), rtol=1e-6)


def test_compressed_codes_are_bitwise_the_jax_packages(world, inputs):
    for r in range(N):
        q, s = JC._block_quantize_int8(
            jnp.asarray(inputs["grad"][r].reshape(-1, 64)))
        np.testing.assert_array_equal(world[r]["codes"], np.asarray(q))
        np.testing.assert_array_equal(world[r]["scales"], np.asarray(s))


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_compressed_all_reduce(world, inputs, dp4, wire):
    g = JC.new_group(axis="dp")
    ref = _spmd(lambda v: JC.compressed_all_reduce(
        v, op=JC.ReduceOp.AVG, group=g, wire_dtype=wire, block=64),
        inputs["grad"]).reshape(N, 256)
    for r, got in enumerate(_by_rank(world, f"compressed_{wire}")):
        np.testing.assert_allclose(got, ref[r], rtol=1e-6, atol=1e-6)
    # every rank dequantizes the same codes: replicas stay equal
    for r in range(1, N):
        np.testing.assert_array_equal(world[r][f"compressed_{wire}"],
                                      world[0][f"compressed_{wire}"])


def test_compressed_train_step(world, inputs, dp4):
    step = jax.jit(JC.build_compressed_train_step(jdist.get_mesh(),
                                                  block=64))
    w, b = jnp.asarray(inputs["w"]), jnp.zeros(4)
    losses = []
    for _ in range(3):
        w, b, loss = step(w, b, jnp.asarray(inputs["xs"]),
                          jnp.asarray(inputs["ys"]))
        losses.append(float(loss))
    for r in world:
        gw, gb, gl = r["train_step"]
        np.testing.assert_allclose(gw, np.asarray(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gb, np.asarray(b), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gl, losses, rtol=1e-5)


def test_wire_bytes_match():
    from paddle_tpu_torch.distributed import collective as C
    for n, w, wire in ((10_000, 4, "int8"), (10_000, 8, "bf16"),
                       (257, 2, "int8")):
        assert C.compressed_allreduce_wire_bytes(n, w, wire) == \
            JC.compressed_allreduce_wire_bytes(n, w, wire)
        assert C.dense_allreduce_wire_bytes(n, w) == \
            JC.dense_allreduce_wire_bytes(n, w)


def test_strategy_json_round_trip(world, tmp_path):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    st = JStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    st.compressed_allreduce = True
    assert json.loads(world[0]["strategy_json"]) == json.loads(st.to_json())
    port = DistributedStrategy.from_json(st.to_json())
    path = tmp_path / "s.json"
    port.save_to_prototxt(str(path))
    back = DistributedStrategy()
    back.load_from_prototxt(str(path))
    assert back == port and back.mesh_axes() == st.mesh_axes()
    with pytest.raises(AttributeError):
        port.not_a_field = 1


def test_env_contract_read_by_init_parallel_env(world):
    eps = world[0]["env"][3]
    assert len(eps) == N and len(set(eps)) == N
    for r in range(N):
        rank, size, cur, endpoints, dev = world[r]["env"]
        assert (rank, size, cur, endpoints, dev) == (r, N, eps[r], eps, r)


def test_staged_functional_collectives(world, inputs):
    """The host path DTensor's collectives take in a gloo world of CUDA
    ranks gives each collective's value."""
    x = inputs["x"]
    for r in range(N):
        got = world[r]["staged_functional"]
        np.testing.assert_allclose(got["all_reduce"], x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["all_gather_into_tensor"],
                                      x.reshape(-1))
        np.testing.assert_allclose(got["reduce_scatter_tensor"],
                                   x.sum(0)[2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_array_equal(
            got["all_to_all_single"],
            np.concatenate([x[i][2 * r:2 * r + 2] for i in range(N)]))
        np.testing.assert_array_equal(got["broadcast"], x[2])


def test_world_of_one_is_the_identity():
    import paddle_tpu_torch.distributed as dist
    t = torch.tensor([1.0, 2.0])
    assert dist.all_reduce(t) is t
    np.testing.assert_array_equal(t.numpy(), [1.0, 2.0])
    assert dist.all_gather(None, t).shape == (1, 2)
    dist.barrier()
    dist.wait(t)
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
