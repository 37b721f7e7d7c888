"""The port package stands alone: it imports neither jax nor paddle_tpu,
and its entry points refuse to fall back to the CPU without being asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch.core.device import resolve_device  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_no_jax_in_subprocess():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models\n"
        "import paddle_tpu_torch.serving.llm.paged\n"
        "import paddle_tpu_torch.ops.flash_attention\n"
        "import paddle_tpu_torch.ops.paged_attention\n"
        "import paddle_tpu_torch.hapi, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.nn.clip, paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.core.generator\n"
        "import paddle_tpu_torch.ops.custom, paddle_tpu_torch.ops.detection\n"
        "import paddle_tpu_torch.vision, paddle_tpu_torch.serving.engine\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.ops.math\n"
        "import paddle_tpu_torch.profiler, paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.distributed.elastic\n"
        "import paddle_tpu_torch.utils.resilience\n"
        "import paddle_tpu_torch.core.tensor, paddle_tpu_torch.core.dtypes\n"
        "import paddle_tpu_torch.core.flags, paddle_tpu_torch.core.errors\n"
        "import paddle_tpu_torch.core.autograd_engine\n"
        "import paddle_tpu_torch.ops.dispatch, paddle_tpu_torch.ops.creation\n"
        "import paddle_tpu_torch.autograd, paddle_tpu_torch.tensor\n"
        "import paddle_tpu_torch.nn.layer_base\n"
        "import paddle_tpu_torch.ops.segment, paddle_tpu_torch.ops.sequence\n"
        "import paddle_tpu_torch.ops.beam, paddle_tpu_torch.ops.crf\n"
        "import paddle_tpu_torch.ops.control_flow\n"
        "import paddle_tpu_torch.ops.extras, paddle_tpu_torch.incubate\n"
        "import paddle_tpu_torch.nn.functional.sampled\n"
        "import paddle_tpu_torch.nn.beam_decode\n"
        "import paddle_tpu_torch.nn.container, paddle_tpu_torch.nn.utils\n"
        "import paddle_tpu_torch.nn.layers_common\n"
        "import paddle_tpu_torch.nn.layers_activation\n"
        "import paddle_tpu_torch.nn.utils_weight_norm\n"
        "import paddle_tpu_torch.nn.functional.conv\n"
        "import paddle_tpu_torch.nn.functional.pooling\n"
        "import paddle_tpu_torch.vision.models.mobilenet\n"
        "import paddle_tpu_torch.nn.rnn, paddle_tpu_torch.reader\n"
        "import paddle_tpu_torch.vision.transforms.functional\n"
        "import paddle_tpu_torch.vision.datasets, paddle_tpu_torch.text\n"
        "import paddle_tpu_torch.distributed.dataset\n"
        "import paddle_tpu_torch.incubate.checkpoint\n"
        "import paddle_tpu_torch.incubate.checkpoint.async_ckpt\n"
        "import paddle_tpu_torch.incubate.checkpoint.auto_checkpoint\n"
        "import paddle_tpu_torch.sentinel, paddle_tpu_torch.sentinel.guard\n"
        "import paddle_tpu_torch.sentinel.policy\n"
        "import paddle_tpu_torch.sentinel.rollback\n"
        "import paddle_tpu_torch.sentinel.quarantine\n"
        "import paddle_tpu_torch.distributed.elastic_runtime.watchdog\n"
        "import paddle_tpu_torch.distributed.elastic_runtime.heartbeat\n"
        "import paddle_tpu_torch.serving.replica\n"
        "import paddle_tpu_torch.serving.router\n"
        "import paddle_tpu_torch.serving.fleet\n"
        "import paddle_tpu_torch.serving.fleet.migrate\n"
        "import paddle_tpu_torch.serving.fleet.swap\n"
        "import paddle_tpu_torch.serving.fleet.autoscaler\n"
        "import paddle_tpu_torch.serving.fleet.replay\n"
        "import paddle_tpu_torch.serving.http\n"
        "import paddle_tpu_torch.serving.__main__\n"
        "import paddle_tpu_torch.tuner, paddle_tpu_torch.tuner.runner\n"
        "import paddle_tpu_torch.distributed.env\n"
        "import paddle_tpu_torch.distributed.collective\n"
        "import paddle_tpu_torch.distributed.mesh\n"
        "import paddle_tpu_torch.distributed.topology\n"
        "import paddle_tpu_torch.distributed.parallel\n"
        "import paddle_tpu_torch.distributed.sharding\n"
        "import paddle_tpu_torch.distributed.spawn_impl\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.distributed.utils\n"
        "import paddle_tpu_torch.distributed.cloud_utils\n"
        "import paddle_tpu_torch.distributed.fleet.strategy\n"
        "import paddle_tpu_torch.distributed.fleet.mp_layers\n"
        "import paddle_tpu_torch.distributed.fleet.sequence_parallel\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a9_modules_pull_in_no_jax_pil_or_reference():
    """The input pipeline's modules (``vision``, its transforms, datasets,
    image IO and ops, ``text``, ``reader``, the bulk datasets) import
    neither jax, nor the JAX package, nor PIL (which the machine with the
    card lacks): PIL is imported only inside a call that decodes."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.vision.transforms\n"
        "import paddle_tpu_torch.vision.transforms.det_transforms\n"
        "import paddle_tpu_torch.vision.datasets\n"
        "import paddle_tpu_torch.vision.image, paddle_tpu_torch.vision.ops\n"
        "import paddle_tpu_torch.vision, paddle_tpu_torch.text\n"
        "import paddle_tpu_torch.text.datasets, paddle_tpu_torch.reader\n"
        "import paddle_tpu_torch.distributed.dataset\n"
        "import paddle_tpu_torch.nn.rnn, paddle_tpu_torch.ops.detection\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'PIL'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        GPTForCausalLM(GPTConfig(vocab_size=8, hidden_size=32, num_layers=1,
                                 num_heads=1, max_position_embeddings=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.to_tensor([1.0])


def test_resolve_device_cpu_and_unknown():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert paddle_tpu_torch.resolve_device is resolve_device


def _tiny_model():
    cfg = GPTConfig(vocab_size=32, hidden_size=32, num_layers=1,
                    num_heads=1, max_position_embeddings=16,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    return GPTForCausalLM(cfg, device="cpu").eval()


@pytest.mark.parametrize("kw,engine_kw,exc,match", [
    # int8 KV and weights are ported: these cases construct and serve
    # (exc None)
    (dict(kv_layout="slot", kv_dtype="int8"), {}, None, None),
    # prefix reuse and speculation are ported: the reference's own gates
    # remain, a spec engine without a draft and a paged engine given a
    # host store, and the config's refusal of either knob over int8 KV
    (dict(kv_layout="paged", page_size=4, spec_k=2), {}, ValueError,
     "draft_model"),
    (dict(kv_layout="paged", page_size=4, prefix_cache=True),
     dict(prefix_store="store"), NotImplementedError, "prefix_cache=True"),
    (dict(kv_layout="paged", page_size=4, kv_dtype="int8"), {}, None,
     None),
    (dict(kv_layout="paged", page_size=4, weight_dtype="int8"), {}, None,
     None),
    (dict(kv_layout="slot", spec_k=2), {}, ValueError, "draft_model"),
    (dict(kv_layout="slot", kv_dtype="int8", prefix_cache=True), {},
     ValueError, "prefix_cache requires a dense KV cache"),
    (dict(kv_layout="paged", page_size=4, kv_dtype="int8", spec_k=2),
     dict(draft_model="draft"), ValueError,
     "speculative decoding .* requires a dense KV cache"),
    (dict(measure_mfu=True), {}, None, None),
    # speculation over int8 weights, which the reference takes and then
    # fails in its verify, and a shared store over int8 KV (the
    # reference's gate) are refused at construction
    (dict(kv_layout="slot", weight_dtype="int8", spec_k=2),
     dict(draft_model="draft"), ValueError, "weight_dtype='float32'"),
    (dict(kv_layout="paged", page_size=4, weight_dtype="int8", spec_k=2),
     dict(draft_model="draft"), ValueError, "weight_dtype='float32'"),
    (dict(kv_layout="slot", kv_dtype="int8"), dict(prefix_store="store"),
     ValueError, "dense KV cache"),
], ids=["slot", "spec", "prefix", "int8_kv", "int8_weights",
        "slot_spec_without_draft", "prefix_int8", "spec_int8", "mfu",
        "spec_int8_weights", "paged_spec_int8_weights",
        "shared_store_int8_kv"])
def test_later_slice_knobs_raise(kw, engine_kw, exc, match):
    from paddle_tpu_torch.serving.llm import PrefixStore
    model = _tiny_model()
    objs = {"store": PrefixStore(), "draft": model}
    engine_kw = {k: objs[v] for k, v in engine_kw.items()}
    if exc is None:
        eng = LLMEngine(model, LLMEngineConfig(max_seq=16, warmup=False,
                                               **kw), **engine_kw)
        try:
            out = eng.generate([3, 1, 4], max_new_tokens=4)
        finally:
            eng.drain(timeout=60)
        assert len(out["tokens"]) == 4
        if kw.get("measure_mfu"):
            st = eng.stats()["stats"]
            assert st["serving.llm.decode_flops_per_tick"] > 0
            assert st["serving.llm.mfu"] > 0
        assert eng.decoder.weight_dtype == kw.get("weight_dtype", "float32")
        assert eng._batcher.kv.quantized == (kw.get("kv_dtype") == "int8")
        return
    with pytest.raises(exc, match=match):
        LLMEngine(model, LLMEngineConfig(max_seq=16, warmup=False, **kw),
                  **engine_kw)


@pytest.mark.parametrize("knob,exc,match", [
    ("while_loop_in_capture", NotImplementedError, "trip count"),
    ("class_center_sample_group", NotImplementedError, "A10"),
    ("static_cond", NotImplementedError, "A11"),
    ("static_while_loop", NotImplementedError, "A11"),
    ("segment_without_num_segments_in_capture", ValueError, "num_segments"),
    ("sequence_pad_without_maxlen_in_capture", ValueError, "capture"),
])
def test_structured_knobs_raise(monkeypatch, knob, exc, match):
    """The structured half's refusals: what a capture cannot run, the
    model-parallel group of ``class_center_sample`` and control flow in a
    static Program."""
    import numpy as np
    from paddle_tpu_torch.ops import dispatch
    P = paddle_tpu_torch
    x = P.to_tensor(np.zeros((3, 2), np.float32), place="cpu")
    n = P.to_tensor(np.array([1, 2]), place="cpu")
    if knob.endswith("in_capture"):
        monkeypatch.setattr(dispatch, "capturing", lambda: True)
    if knob.startswith("static"):
        monkeypatch.setattr(dispatch, "in_dygraph_mode", lambda: False)
    call = {
        "while_loop_in_capture": lambda: P.ops.while_loop(
            lambda v: v.sum() < 1.0, lambda v: [v + 1.0], [x]),
        "class_center_sample_group": lambda: P.nn.functional.
        class_center_sample(n, 4, 2, group="mp"),
        "static_cond": lambda: P.ops.cond(True, lambda: x, lambda: x),
        "static_while_loop": lambda: P.ops.while_loop(
            lambda v: False, lambda v: [v], [x]),
        "segment_without_num_segments_in_capture": lambda: P.incubate.
        segment_sum(x, P.to_tensor(np.array([0, 0, 1]), place="cpu")),
        "sequence_pad_without_maxlen_in_capture": lambda: P.ops.
        sequence_pad(x, 0.0, length=n),
    }[knob]
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.parametrize("knob,exc,match", [
    ("conv2d_transpose_output_size", NotImplementedError, "never reads"),
    ("conv3d_transpose_output_size", NotImplementedError, "never reads"),
    ("avg_pool2d_divisor_override", NotImplementedError, "never reads"),
    ("avg_pool3d_divisor_override", NotImplementedError, "never reads"),
    ("mobilenet_v1_pretrained", RuntimeError, "network"),
    ("mobilenet_v2_pretrained", RuntimeError, "network"),
    ("mobilenet_v3_large_pretrained", RuntimeError, "network"),
    ("mobilenet_v3_small_pretrained", RuntimeError, "network"),
])
def test_a3_knobs_raise(knob, exc, match):
    """The rest of the nn layers' refusals: ``output_size`` of the
    transposed convolutions and ``divisor_override`` of the average
    pools, which the JAX package takes and never reads, and the
    MobileNets' ``pretrained=True`` (no network), as the JAX package's."""
    F = paddle_tpu_torch.nn.functional
    models = paddle_tpu_torch.vision.models
    x = torch.zeros(1, 2, 4, 4)
    call = {
        "conv2d_transpose_output_size": lambda: F.conv2d_transpose(
            x, torch.zeros(2, 2, 3, 3), output_size=[6, 6]),
        "conv3d_transpose_output_size": lambda: F.conv3d_transpose(
            x[None], torch.zeros(2, 2, 1, 3, 3), output_size=[1, 6, 6]),
        "avg_pool2d_divisor_override": lambda: F.avg_pool2d(
            x, 2, divisor_override=4),
        "avg_pool3d_divisor_override": lambda: F.avg_pool3d(
            x[None], 2, divisor_override=8),
    }.get(knob) or (lambda: getattr(models, knob[:-len("_pretrained")])(
        pretrained=True))
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.parametrize("knob,exc,match", [
    ("router_model_axes", NotImplementedError, "A10"),
    ("replica_mesh", NotImplementedError, "A10"),
    ("predictor_replica_factory", NotImplementedError, "A11"),
    ("fleet_autoscaler_beyond_shells", ValueError, "replica shells"),
    ("http_predict_bfloat16", ValueError, "NumPy has no bfloat16"),
    ("router_without_cuda", RuntimeError, "device='cpu'"),
])
def test_fleet_knobs_raise(monkeypatch, knob, exc, match):
    """The fleet's refusals: model-parallel replicas (a mesh, the
    router's ``model_axes``), inference-artifact replicas, an autoscaler
    asked for more replicas than the router's shells, a ``bfloat16``
    input to the HTTP ``/predict`` (NumPy has none without ``ml_dtypes``),
    and a router on no device where CUDA is absent (the port asks for
    CUDA unless told ``device="cpu"``)."""
    import types
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.serving import Replica, Router, RouterConfig
    from paddle_tpu_torch.serving import http, predictor_replica_factory
    from paddle_tpu_torch.serving.fleet import SLO, Autoscaler
    if knob == "router_without_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "router_model_axes": lambda: Router(
            lambda r: None, RouterConfig(kind="llm",
                                         model_axes={"model": 2}),
            device="cpu"),
        "replica_mesh": lambda: Replica(0, lambda r: None, device="cpu",
                                        mesh=object()),
        "predictor_replica_factory": lambda: predictor_replica_factory(
            "/nonexistent/model"),
        "fleet_autoscaler_beyond_shells": lambda: Autoscaler(
            types.SimpleNamespace(replicas=[0], registry=StatRegistry()),
            SLO(max_replicas=2)),
        "http_predict_bfloat16": lambda: http._np_dtype("bfloat16"),
        "router_without_cuda": lambda: Router(
            lambda r: None, RouterConfig(kind="llm")),
    }[knob]
    with pytest.raises(exc, match=match):
        call()
