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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
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


@pytest.mark.parametrize("kw", [
    dict(kv_layout="slot", kv_dtype="int8"),
    dict(kv_layout="paged", page_size=4, spec_k=2),
    dict(kv_layout="paged", page_size=4, prefix_cache=True),
    dict(kv_layout="paged", page_size=4, kv_dtype="int8"),
    dict(kv_layout="paged", page_size=4, weight_dtype="int8"),
], ids=["slot", "spec", "prefix", "int8_kv", "int8_weights"])
def test_later_slice_knobs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine(_tiny_model(), LLMEngineConfig(max_seq=16, warmup=False,
                                                 **kw))
