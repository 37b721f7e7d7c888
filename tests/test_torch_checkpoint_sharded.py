"""The port's ``incubate.checkpoint.sharded`` against the JAX package's:
archives written by either package load in the other (float32, ints,
0-d arrays, scalars, nested dicts, a multi-shard archive from a JAX CPU
mesh), health stamps read across, ``verify_checkpoint`` raises the same
error type in the same cases (corrupt, missing, torn, orphan shard, bad
JSON; format 1 loads), ``newest_healthy_checkpoint`` and
``swap_eligible`` agree, and the refusals name ROADMAP A10. C11: the
port round-trips bfloat16 and reads a JAX-written bfloat16 archive bit
for bit, while the JAX package's own loader still fails on it."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

torch.set_num_threads(2)

from paddle_tpu.incubate.checkpoint import sharded as jsh  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import sharded as tsh  # noqa: E402
from paddle_tpu_torch.utils import resilience as tres  # noqa: E402


def _state(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "nested": {"b": rng.standard_normal(4).astype(np.float32),
                       "ids": rng.integers(0, 9, (2, 3)).astype(np.int32),
                       "deep": {"s": np.float32(2.5)}},
            "step": 7, "lr": 0.125, "name": "gpt", "flag": True,
            "none": None}


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    data = getattr(tree, "_data", tree)
    if isinstance(data, torch.Tensor):
        return data.numpy()
    if hasattr(data, "shape"):
        return np.asarray(data)
    return data


def _assert_tree_equal(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
        return
    if isinstance(want, np.ndarray) or np.isscalar(want) and \
            isinstance(want, np.generic):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).shape == np.asarray(want).shape
        return
    assert got == want and type(got) is type(want)


def _torch_state(state):
    if isinstance(state, dict):
        return {k: _torch_state(v) for k, v in state.items()}
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state.copy())
    if isinstance(state, np.generic):
        return torch.tensor(state)
    return state


def test_jax_archive_loads_in_the_port(tmp_path):
    state = _state(np.random.default_rng(0))
    jsh.save_sharded(state, str(tmp_path / "ck"))
    out = tsh.load_sharded(str(tmp_path / "ck"), device="cpu")
    assert isinstance(out["w"], tsh.Tensor)
    _assert_tree_equal(_as_numpy(out), state)


def test_port_archive_loads_in_the_jax_package(tmp_path):
    state = _state(np.random.default_rng(1))
    tsh.save_sharded(_torch_state(state), str(tmp_path / "ck"))
    out = jsh.load_sharded(str(tmp_path / "ck"), return_tensor=False)
    _assert_tree_equal(_as_numpy(out), state)
    # the metadata is the JAX package's shape for a single-device array
    with open(tmp_path / "ck" / "metadata_0.json") as f:
        port_meta = json.load(f)
    jsh.save_sharded(state, str(tmp_path / "ref"))
    with open(tmp_path / "ref" / "metadata_0.json") as f:
        ref_meta = json.load(f)
    assert port_meta["entries"] == ref_meta["entries"]
    assert port_meta["format"] == ref_meta["format"] == 2
    with open(tmp_path / "ck" / "scalars.json") as f:
        port_scalars = json.load(f)
    with open(tmp_path / "ref" / "scalars.json") as f:
        assert port_scalars == json.load(f)


def test_multi_shard_mesh_archive_reassembles_in_the_port(tmp_path):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                             ("dp", "mp"))
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    y = np.arange(16, dtype=np.int32)
    arrs = {"x": jax.device_put(x, NamedSharding(mesh, PartitionSpec(
                "dp", "mp"))),
            "y": jax.device_put(y, NamedSharding(mesh, PartitionSpec(
                ("dp", "mp"))))}
    jsh.save_sharded(arrs, str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "metadata_0.json") as f:
        entries = json.load(f)["entries"]
    assert len(entries["x"]["shards"]) == 8
    out = tsh.load_sharded(str(tmp_path / "ck"), device="cpu",
                           return_tensor=False)
    np.testing.assert_array_equal(out["x"].numpy(), x)
    np.testing.assert_array_equal(out["y"].numpy(), y)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_health_stamps_read_across(tmp_path, writer):
    d = str(tmp_path / "ck")
    jsh.save_sharded({"a": np.zeros(2, np.float32)}, d)
    w, r = (jsh, tsh) if writer == "jax" else (tsh, jsh)
    assert r.read_health_stamp(d) == {"healthy": True}
    w.write_health_stamp(d, False, step=4, reason="diverged")
    stamp = r.read_health_stamp(d)
    assert (stamp["healthy"], stamp["step"], stamp["reason"]) == \
        (False, 4, "diverged")
    assert r.swap_eligible(d)[0] is False
    assert r.newest_healthy_checkpoint(str(tmp_path)) is None


def _corrupt(d):
    p = os.path.join(d, "shards_0.npz")
    with open(p, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def _missing(d):
    os.remove(os.path.join(d, "shards_0.npz"))


def _torn(d):
    os.remove(os.path.join(d, "metadata_0.json"))


def _orphan(d):
    with open(os.path.join(d, "shards_3.npz"), "wb") as f:
        f.write(b"stray")


def _bad_json(d):
    with open(os.path.join(d, "metadata_0.json"), "w") as f:
        f.write("{not json")


def _no_dir(d):
    import shutil
    shutil.rmtree(d)


@pytest.mark.parametrize("damage", [_corrupt, _missing, _torn, _orphan,
                                    _bad_json, _no_dir],
                         ids=["corrupt", "missing", "torn", "orphan_shard",
                              "bad_json", "not_a_dir"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_verify_checkpoint_raises_alike(tmp_path, damage, writer):
    d = str(tmp_path / "ck")
    state = {"a": np.arange(6, dtype=np.float32)}
    if writer == "jax":
        jsh.save_sharded(state, d)
    else:
        tsh.save_sharded(_torch_state(state), d)
    damage(d)
    errors = []
    for mod in (jsh, tsh):
        with pytest.raises(mod.CheckpointIntegrityError) as e:
            mod.verify_checkpoint(d)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(tsh.CheckpointIntegrityError):
        tsh.load_sharded(d, device="cpu")
    assert tsh.newest_healthy_checkpoint(str(tmp_path)) is None


def test_format_1_loads_in_both(tmp_path):
    d = str(tmp_path / "ck")
    jsh.save_sharded({"a": np.arange(4, dtype=np.float32)}, d)
    mp = os.path.join(d, "metadata_0.json")
    with open(mp) as f:
        doc = json.load(f)
    with open(mp, "w") as f:
        json.dump(doc["entries"], f)          # a bare format-1 map
    for mod in (jsh, tsh):
        mod.verify_checkpoint(d)
    out = tsh.load_sharded(d, device="cpu", return_tensor=False)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4))


def test_injected_load_corruption_is_caught(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tsh.save_sharded({"a": torch.ones(3)}, d)
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "load:1:corrupt")
    tres._reset_fault_injector_for_tests()
    try:
        with pytest.raises(tsh.CheckpointIntegrityError):
            tsh.load_sharded(d, device="cpu")
    finally:
        monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC")
        tres._reset_fault_injector_for_tests()
    out = tsh.load_sharded(d, device="cpu", verify=False)
    assert out["a"].shape == [3]


def test_newest_healthy_and_swap_eligible_agree(tmp_path):
    root = str(tmp_path)
    for step in (100, 200, 300):
        tsh.save_sharded({"w": torch.full((2,), float(step))},
                         os.path.join(root, f"step_{step}"))
    tsh.write_health_stamp(os.path.join(root, "step_300"), False,
                           reason="nan")
    os.makedirs(os.path.join(root, "step_400.tmp"))
    jsh.save_sharded({"w": np.zeros(2, np.float32)},
                     os.path.join(root, "step_500.old"))
    with pytest.warns(UserWarning):
        want = jsh.newest_healthy_checkpoint(root)
    with pytest.warns(UserWarning):
        got = tsh.newest_healthy_checkpoint(root)
    assert got == want == os.path.join(root, "step_200")
    for name in ("step_100", "step_300", "step_400.tmp", "step_500.old",
                 "nothing"):
        p = os.path.join(root, name)
        assert tsh.swap_eligible(p) == jsh.swap_eligible(p)


def test_bfloat16_round_trips_in_the_port(tmp_path):
    d = str(tmp_path / "ck")
    w = torch.randn(3, 4).to(torch.bfloat16)
    h = torch.randn(5).to(torch.float16)
    tsh.save_sharded({"w": w, "h": h, "z": torch.tensor(1.5)}, d)
    with np.load(os.path.join(d, "shards_0.npz")) as z:
        assert z["w|0"].dtype == np.dtype("V2")   # the JAX package's blob
        assert z["h|0"].dtype == np.float16
    out = tsh.load_sharded(d, device="cpu", return_tensor=False)
    assert out["w"].dtype == torch.bfloat16 and out["h"].dtype == \
        torch.float16
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(out["h"], h)
    assert out["z"].shape == () and float(out["z"]) == 1.5


def test_jax_bfloat16_archive_loads_bit_exact_in_the_port(tmp_path):
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(3)
    w32 = rng.standard_normal((4, 6)).astype(np.float32)
    w = jnp.asarray(w32).astype(jnp.bfloat16)
    h = jnp.asarray(w32[0]).astype(jnp.float16)
    jsh.save_sharded({"w": w, "h": h}, d)
    out = tsh.load_sharded(d, device="cpu", return_tensor=False)
    want_bits = np.asarray(w).view(np.int16)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(out["h"].numpy(), np.asarray(h))


def test_c11_the_jax_loader_still_fails_on_its_own_bfloat16(tmp_path):
    """ROADMAP C11, kept in view: the JAX package writes bfloat16 as raw
    ``|V2`` blobs and cannot assign them into ``np.zeros(shape,
    "bfloat16")``; the port reads the same archive (above). When this
    starts passing, C11 is fixed in the JAX package."""
    d = str(tmp_path / "ck")
    jsh.save_sharded({"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)},
                     d)
    with pytest.raises(ValueError, match="No cast function"):
        jsh.load_sharded(d)
    # a port-written bfloat16 archive meets the same failure there
    tsh.save_sharded({"w": torch.arange(6.).to(torch.bfloat16)},
                     str(tmp_path / "p"))
    with pytest.raises(ValueError, match="No cast function"):
        jsh.load_sharded(str(tmp_path / "p"))


def test_refusals_name_a10(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tsh.save_sharded({"a": torch.ones(2)}, d)
    with pytest.raises(NotImplementedError, match="A10"):
        tsh.load_sharded(d, mesh=object(), device="cpu")
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="A10"):
        tsh.save_sharded({"a": torch.ones(2)}, d)


def test_load_defaults_to_cuda(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tsh.save_sharded({"a": torch.ones(2)}, d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.load_sharded(d)


def test_async_saver_owns_its_snapshot(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.arange(5.)
    saver = tsh.AsyncSaver()
    done = []
    saver.save({"x": x, "k": 3}, d, on_done=lambda: done.append(1))
    x.add_(100.)                   # an in-place update after save()
    saver.wait()
    out = tsh.load_sharded(d, device="cpu", return_tensor=False)
    assert done == [1] and out["k"] == 3
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(5.))
