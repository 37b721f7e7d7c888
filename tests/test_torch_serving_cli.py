"""The port's CLI (``python -m paddle_tpu_torch.serving``) against the
JAX package's (``tests/test_serving_http.py``'s CLI case read as the
spec): ``_parse_int_list`` alike, ``serve-llm --device cpu --port 0``
in a subprocess over a state dict the JAX package's ``framework_io.save``
wrote, its tokens (plain and streamed) equal to the JAX ``LLMEngine``'s
on those weights, the machine-readable port line, and a SIGTERM that
ends in "drained, bye" and exit 0, for one engine and for a router of
two replicas under ``--autoscale``; ``serve --model`` (an inference
artifact, A11) and ``--model-parallel 2`` (A10) exit non-zero naming
their queue items. Tiny model (vocab 64, hidden 32, 2 layers, 4
heads)."""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework_io as jframework_io  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.__main__ import \
    _parse_int_list as j_parse_int_list  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu_torch.serving.__main__ import (_parse_int_list,  # noqa: E402
                                               main)

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128)
FLAGS = ["--vocab-size", "64", "--hidden-size", "32", "--num-layers", "2",
         "--num-heads", "4", "--max-positions", "128", "--num-slots", "2",
         "--max-seq", "64", "--prefill-buckets", "8,16,32",
         "--max-new-tokens", "6", "--no-warmup"]
ENGINE = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32),
              default_max_new_tokens=6, warmup=False)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 2], [11, 40, 3, 9, 9, 1, 0, 5,
                                                 62, 17, 33])


@pytest.mark.parametrize("raw", ["1,2,8", "", " 4 , 16,", "1024"])
def test_parse_int_list_equals_the_reference(raw):
    assert _parse_int_list(raw) == j_parse_int_list(raw)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A state dict written by the JAX package's ``framework_io.save``
    (spread weights: the init's greedy tokens repeat), and the JAX slot
    engine's greedy tokens on it."""
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL, hidden_dropout_prob=0.0,
                         attention_dropout_prob=0.0))
    jm.eval()
    rng = np.random.default_rng(0)
    sd = {k: (rng.standard_normal(v.shape) * (0.3 if v.ndim > 1 else 0.1)
              + (1.0 if v.ndim == 1 and "norm" in k
                 and k.endswith("weight") else 0.0)).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict(sd)
    path = str(tmp_path_factory.mktemp("cli") / "gpt.pdparams")
    jframework_io.save(jm.state_dict(), path)
    eng = JLLMEngine(jm, JConfig(**ENGINE), registry=JStatRegistry())
    try:
        want = [eng.submit(p).result(timeout=120)["tokens"] for p in PROMPTS]
    finally:
        eng.drain(timeout=60)
    return path, want


class _Served:
    """``python -m paddle_tpu_torch.serving`` in a subprocess, its stdout
    read on a thread until the machine-readable port line."""

    def __init__(self, args):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving", *args],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        self.out = []
        self.port = None
        deadline = time.monotonic() + 120
        while self.port is None:
            line = self.lines.get(timeout=max(1, deadline - time.monotonic()))
            assert line is not None, "".join(self.out)
            if line.startswith("PADDLE_TPU_SERVING_PORT="):
                self.port = int(line.split("=", 1)[1])
        self.url = f"http://127.0.0.1:{self.port}"

    def _read(self):
        for line in self.proc.stdout:
            self.out.append(line)
            self.lines.put(line.strip())
        self.lines.put(None)

    def stop(self):
        """SIGTERM; returns (exit code, everything printed)."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(30)
        while self.lines.get(timeout=30) is not None:
            pass
        return code, "".join(self.out)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _healthz(url):
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("extra", [[], ["--replicas", "2", "--autoscale",
                                        "--autoscale-interval-s", "0.1"]],
                         ids=["engine", "router_autoscaled"])
def test_serve_llm_on_the_references_weights(saved, extra):
    path, want = saved
    srv = _Served(["serve-llm", "--device", "cpu", "--port", "0",
                   "--state-dict", path, *FLAGS, *extra])
    try:
        code, body = _healthz(srv.url)
        assert code == 200 and body["status"] == "ok"
        for prompt, toks in zip(PROMPTS, want):
            plain = json.loads(_post(f"{srv.url}/generate",
                                     {"prompt": prompt}))
            assert plain["tokens"] == toks
            lines = [json.loads(ln) for ln in _post(
                f"{srv.url}/generate", {"prompt": prompt, "stream": True}
            ).splitlines() if ln]
            assert [ln["token"] for ln in lines[:-1]] == toks
            assert lines[-1]["done"] is True
        # the child's own kernel launches: none on the CPU
        with urllib.request.urlopen(f"{srv.url}/statsz", timeout=30) as r:
            launched = json.loads(r.read())["kernel_launches"]
        assert launched == dict.fromkeys(
            ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "paged_attention", "greedy_nms"), 0)
    finally:
        code, out = srv.stop()
    assert code == 0, out
    assert "paddle_tpu_torch.serving: drained, bye" in out
    assert "LLM listening on" in out and "device=cpu" in out
    if extra:
        assert "autoscaler on (1..2 replicas" in out


@pytest.mark.parametrize("argv,label", [
    (["serve", "--model", "/nonexistent/x", "--device", "cpu"], "A11"),
    (["serve", "--model", "/nonexistent/x", "--replicas", "2",
      "--device", "cpu"], "A11"),
    (["serve-llm", "--model-parallel", "2", "--device", "cpu", *FLAGS],
     "A10"),
])
def test_unported_features_exit_nonzero_naming_their_queue(capsys, argv,
                                                           label):
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert f"queue {label}" in err and err.startswith(
        "paddle_tpu_torch.serving: ")
