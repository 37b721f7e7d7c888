"""Sequence parallelism at world 4 (four gloo ranks on the CPU, started
through the port's ``spawn``): ``ring_attention`` and
``ring_flash_attention`` at sp4 and dp2 x sp2, causal and not, float32,
outputs and the gradients of ``sum(out * do)`` held against the JAX
package's rings on its CPU mesh (the flash ring in Pallas interpret
mode, as ``tests/test_ring_flash_backward.py`` runs it), and a ring of
one against plain flash attention. On the CPU the port's flash ring runs
the kernels' plain versions (B1-B3 launch on the card: chip_smoke phase
34 and ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.fleet import sequence_parallel as jsp

import torch_dist_worlds as W

torch.set_num_threads(2)

N = 4
LAYOUTS = {"sp4": ({"sp": 4}, None), "dp2sp2": ({"dp": 2, "sp": 2}, "dp")}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return {"qkvd": [(rng.randn(2, 2, 64, 16) * 0.5).astype(np.float32)
                     for _ in range(4)]}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    return W.run_world("ring", tmp_path_factory.mktemp("ring"),
                       inputs=inputs)


def _jax_ring(fn, inputs, layout, causal):
    axes, batch = LAYOUTS[layout]
    mesh = jdist.build_mesh(axes, jax.devices()[:N])
    jdist.set_mesh(mesh)
    try:
        q, k, v, do = (jnp.asarray(a) for a in inputs["qkvd"])

        def loss(q, k, v):
            out = fn(q, k, v, mesh=mesh, axis="sp", causal=causal,
                     batch_axes=batch)
            return jnp.sum(out * do), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
        return [np.asarray(out)] + [np.asarray(g) for g in grads]
    finally:
        jdist.set_mesh(None)


def test_ranks_import_no_jax(world):
    assert [r["_imported"] for r in world] == [[]] * N


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["dense", "flash"])
def test_ring_matches_jax(world, inputs, layout, causal, kind):
    fn = jsp.ring_attention if kind == "dense" else jsp.ring_flash_attention
    ref = _jax_ring(fn, inputs, layout, causal)
    key = f"{layout}_{kind}_{'causal' if causal else 'full'}"
    for r in world:
        np.testing.assert_allclose(r[key][0], ref[0], rtol=0, atol=1e-5)
    # each rank's gradient holds its own rows; their sum is the global one
    for i, name in enumerate("qkv", start=1):
        got = sum(r[key][i] for r in world)
        np.testing.assert_allclose(got, ref[i], rtol=0,
                                   atol=1e-4 * max(np.abs(ref[i]).max(), 1),
                                   err_msg=f"d{name}")


def test_ring_of_one_is_plain_flash(world):
    for r in world:
        got, plain = r["sp1"]
        np.testing.assert_array_equal(got, plain)


def test_flash_ring_matches_dense_ring(world):
    for r in world:
        for layout in LAYOUTS:
            for mask in ("full", "causal"):
                d = r[f"{layout}_dense_{mask}"]
                f = r[f"{layout}_flash_{mask}"]
                np.testing.assert_allclose(f[0], d[0], rtol=0, atol=1e-5)
