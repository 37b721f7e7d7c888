"""The port's HTTP front door (``paddle_tpu_torch.serving.http``) against
the JAX package's (its ``tests/test_serving_http.py``, the HTTP cases of
``tests/test_llm_serving.py`` and ``tests/test_llm_disagg.py`` read as
specs): the JAX server over JAX engines and the port's server over port
engines get the same requests on loopback sockets. ``/generate`` tokens
are equal for greedy slot and paged engines and a router of two paged
replicas, NDJSON streams line for line apart from ``req_ms``,
``/predict`` outputs within 1e-5, the 400/404/503/504 codes and the
draining 503s equal, and ``/statsz`` keys and ``/metricsz`` families
cover the reference's. ``"bfloat16"`` inputs to ``/predict`` are a named
400 on the port (NumPy has no bfloat16 without ``ml_dtypes``). Tiny
model (vocab 64, hidden 32, 2 layers, 4 heads), spread weights carried
by ``framework_io.state_dict_from_reference``; every port engine on the
CPU."""
import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving import Engine as JEngine  # noqa: E402
from paddle_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from paddle_tpu.serving.http import make_server as jmake_server  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu.serving.router import Router as JRouter  # noqa: E402
from paddle_tpu.serving.router import RouterConfig as JRouterConfig  # noqa: E402
from paddle_tpu.serving.router import \
    llm_replica_factory as jllm_replica_factory  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.observability.metrics import CONTENT_TYPE  # noqa: E402
from paddle_tpu_torch.serving import Engine, EngineConfig  # noqa: E402
from paddle_tpu_torch.serving.http import make_server  # noqa: E402
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig)
from paddle_tpu_torch.serving.router import (Router,  # noqa: E402
                                             RouterConfig,
                                             llm_replica_factory)

#: the port's hand-written kernels, by their wrappers' names
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "paged_attention", "greedy_nms")
MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
SLOT = dict(num_slots=2, max_seq=64, max_queue=64, warmup=False,
            default_max_new_tokens=6)
LAYOUTS = {"slot": SLOT, "paged": dict(SLOT, kv_layout="paged",
                                       page_size=8)}
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 2], [11, 40, 3, 9, 9, 1, 0, 5,
                                                 62, 17, 33])


def _spread(sd):
    rng = np.random.default_rng(0)
    out = {}
    for k, v in sd.items():
        a = rng.standard_normal(v.shape).astype(np.float32)
        out[k] = (a * 0.3 if v.ndim > 1 else a * 0.1 + (
            1.0 if "norm" in k and k.endswith("weight") else 0.0)
        ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    sd = _spread(jm.state_dict())
    jm.set_state_dict(sd)
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(sd, "cpu"),
                       strict=True)
    return jm, pm


@contextlib.contextmanager
def _served(mk, *engine, **mounts):
    httpd = mk(*(engine or (None,)), port=0, **mounts)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(30)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(url, payload=None):
    if payload is None:
        code, _, body = _get(url)
    else:
        code, body = _post(url, payload)
    return code, json.loads(body)


def _ndjson(url, payload):
    code, body = _post(url, dict(payload, stream=True))
    assert code == 200
    return [json.loads(ln) for ln in body.splitlines() if ln]


def _families(text):
    return {ln.split()[2] for ln in text.decode().splitlines()
            if ln.startswith("# TYPE ")}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def llm_pair(request, weights):
    """The same greedy engine in both packages behind each package's
    server: (layout, JAX url, port url, JAX engine, port engine)."""
    jm, pm = weights
    cfg = LAYOUTS[request.param]
    jeng = JLLMEngine(jm, JConfig(**cfg), registry=JStatRegistry())
    teng = LLMEngine(pm, LLMEngineConfig(**cfg), registry=StatRegistry())
    try:
        with _served(jmake_server, llm_engine=jeng) as jurl, \
                _served(make_server, llm_engine=teng) as turl:
            yield request.param, jurl, turl, jeng, teng
    finally:
        jeng.drain(timeout=60)
        teng.drain(timeout=60)


@pytest.mark.parametrize("prompt,new", [(PROMPTS[0], 6), (PROMPTS[1], 9),
                                        (PROMPTS[2], 1), (PROMPTS[0], None)])
def test_generate_tokens_equal_the_reference(llm_pair, prompt, new):
    _, jurl, turl, _, _ = llm_pair
    payload = {"prompt": prompt, "max_new_tokens": new}
    jc, jb = _json(f"{jurl}/generate", payload)
    tc, tb = _json(f"{turl}/generate", payload)
    assert jc == tc == 200
    assert tb["tokens"] == jb["tokens"]
    assert tb["finish_reason"] == jb["finish_reason"] == "length"
    assert len(tb["tokens"]) == (new or SLOT["default_max_new_tokens"])
    assert tb["req_ms"] > 0


def test_stream_lines_equal_the_reference_and_the_plain_tokens(llm_pair):
    _, jurl, turl, _, _ = llm_pair
    for prompt in PROMPTS:
        payload = {"prompt": prompt, "max_new_tokens": 7}
        jl, tl = (_ndjson(f"{u}/generate", payload) for u in (jurl, turl))
        assert tl[-1].pop("req_ms") > 0
        jl[-1].pop("req_ms")
        assert tl == jl
        assert tl[-1] == {"done": True, "finish_reason": "length"}
        plain = _json(f"{turl}/generate", payload)[1]["tokens"]
        assert [ln["token"] for ln in tl[:-1]] == plain


def test_eos_stops_both_alike(llm_pair):
    _, jurl, turl, _, _ = llm_pair
    first = _json(f"{jurl}/generate", {"prompt": PROMPTS[0],
                                       "max_new_tokens": 6})[1]["tokens"]
    payload = {"prompt": PROMPTS[0], "max_new_tokens": 6,
               "eos_token_id": first[2]}
    jb, tb = (_json(f"{u}/generate", payload)[1] for u in (jurl, turl))
    assert (tb["tokens"], tb["finish_reason"]) == \
        (jb["tokens"], jb["finish_reason"])
    assert tb["finish_reason"] == "stop"


@pytest.mark.parametrize("method,path,payload", [
    ("POST", "/generate", {"nope": 1}),
    ("POST", "/generate", {"prompt": [1, 2], "top_k": 10_000}),
    ("POST", "/generate", {"prompt": [1, 2], "max_new_tokens": 0}),
    ("POST", "/generate", {"prompt": [i % 64 for i in range(100)]}),
    ("POST", "/generate", {"prompt": [1, 2], "deadline_s": 1e-9}),
    ("POST", "/predict", {"inputs": [[[1.0]]]}),
    ("POST", "/nope", {}),
    ("GET", "/nope", None),
])
def test_status_codes_equal_the_reference(llm_pair, method, path, payload):
    """400 (bad body, bad sampling), 503 (an oversize prompt, /predict
    with no classifier), 504 (a deadline already past) and 404."""
    _, jurl, turl, _, _ = llm_pair
    codes = []
    for url in (jurl, turl):
        if method == "GET":
            codes.append(_get(f"{url}{path}")[0])
        else:
            codes.append(_post(f"{url}{path}", payload)[0])
    assert codes[0] == codes[1] and codes[0] in (400, 404, 503, 504)


def test_healthz_statsz_metricsz_cover_the_reference(llm_pair):
    layout, jurl, turl, jeng, teng = llm_pair
    for url in (jurl, turl):
        assert _json(f"{url}/generate", {"prompt": PROMPTS[0]})[0] == 200
    jh, th = _json(f"{jurl}/healthz"), _json(f"{turl}/healthz")
    assert th == jh == (200, {"status": "ok", "role": "mixed"})
    js, ts = _json(f"{jurl}/statsz")[1], _json(f"{turl}/statsz")[1]
    assert set(ts) == set(js) | {"kernel_launches"} == \
        {"llm", "kernel_launches"}
    # the port's own key: its kernels' launches, none on the CPU
    assert ts["kernel_launches"] == dict.fromkeys(KERNELS, 0)
    assert set(js["llm"]) <= set(ts["llm"])
    assert set(js["llm"]["histograms"]) <= set(ts["llm"]["histograms"])
    assert ts["llm"]["stats"]["serving.llm.tokens_generated"] > 0
    jcode, jtype, jtext = _get(f"{jurl}/metricsz")
    tcode, ttype, ttext = _get(f"{turl}/metricsz")
    assert jcode == tcode == 200 and jtype == ttype == CONTENT_TYPE
    assert "paddle_tpu_serving_llm_tokens_generated_total" in \
        _families(ttext)
    # the reference's families that these engines' stats make (an engine
    # family each package names alike)
    common = {f for f in _families(jtext)
              if f.startswith("paddle_tpu_serving_llm_")}
    missing = common - _families(ttext)
    assert not missing, missing


def _llm_engines(weights, **kw):
    jm, pm = weights
    cfg = dict(SLOT, **kw)
    return (JLLMEngine(jm, JConfig(**cfg), registry=JStatRegistry()),
            LLMEngine(pm, LLMEngineConfig(**cfg), registry=StatRegistry()))


def test_llm_healthz_role_and_draining_503(weights):
    jeng, teng = _llm_engines(weights, role="decode")
    try:
        with _served(jmake_server, llm_engine=jeng) as jurl, \
                _served(make_server, llm_engine=teng) as turl:
            assert _json(f"{turl}/healthz") == _json(f"{jurl}/healthz") \
                == (200, {"status": "ok", "role": "decode"})
            for eng in (jeng, teng):
                eng.begin_drain()
                eng._stopped.wait(30)
            assert _json(f"{turl}/healthz") == _json(f"{jurl}/healthz") \
                == (503, {"status": "draining"})
            jc = _post(f"{jurl}/generate", {"prompt": [1, 2]})[0]
            tc, body = _post(f"{turl}/generate", {"prompt": [1, 2]})
            assert tc == jc == 503 and b"drain" in body
    finally:
        jeng.drain(timeout=60)
        teng.drain(timeout=60)


# -- /predict over a classifier Engine ----------------------------------------

def _jdouble(*arrays):
    return [np.asarray(a) * 2 for a in arrays]


def _tdouble(*tensors):
    return [t * 2 for t in tensors]


@pytest.fixture()
def classifiers():
    cfg = dict(max_batch=8, max_batch_delay=0.005)
    jeng = JEngine(_jdouble, JEngineConfig(**cfg), registry=JStatRegistry())
    teng = Engine(_tdouble, EngineConfig(**cfg), registry=StatRegistry(),
                  device="cpu")
    try:
        with _served(jmake_server, jeng) as jurl, \
                _served(make_server, teng) as turl:
            yield jurl, turl, jeng, teng
    finally:
        jeng.drain()
        teng.drain()


@pytest.mark.parametrize("payload", [
    {"inputs": [[[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]]},
    {"inputs": [[[1, 2], [3, 4]]], "dtypes": ["int32"]},
    {"inputs": [[[0.1, -2.5, 3.25]], [[7.0]]]},
    {"inputs": [np.random.default_rng(3).standard_normal((5, 4)).tolist()],
     "dtypes": ["float64"]},
])
def test_predict_equals_the_reference(classifiers, payload):
    jurl, turl, _, _ = classifiers
    (jc, jb), (tc, tb) = (_json(f"{u}/predict", payload)
                          for u in (jurl, turl))
    assert jc == tc == 200
    assert tb["shapes"] == jb["shapes"]
    for t, j in zip(tb["outputs"], jb["outputs"]):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    assert tb["req_ms"] > 0


@pytest.mark.parametrize("method,path,payload", [
    ("POST", "/predict", {"wrong_key": []}),
    ("POST", "/predict", {"inputs": [[1.0]], "dtypes": ["nodtype"]}),
    ("POST", "/predict", {"inputs": [[1.0]], "deadline_s": 1e-9}),
    ("POST", "/generate", {"prompt": [1]}),
    ("POST", "/nope", {}),
    ("GET", "/nope", None),
])
def test_predict_status_codes_equal_the_reference(classifiers, method, path,
                                                  payload):
    jurl, turl, _, _ = classifiers
    codes = [(_get(f"{u}{path}")[0] if method == "GET"
              else _post(f"{u}{path}", payload)[0]) for u in (jurl, turl)]
    assert codes[0] == codes[1] and codes[0] in (400, 404, 503, 504)


def test_predict_bfloat16_is_a_named_400(classifiers):
    """The deliberate difference: the reference answers a ``bfloat16``
    input (NumPy knows the name through ``ml_dtypes`` in the JAX
    process); the port refuses it by name, whatever is installed."""
    jurl, turl, _, _ = classifiers
    payload = {"inputs": [[[1.5, 2.0]]], "dtypes": ["bfloat16"]}
    assert _post(f"{jurl}/predict", payload)[0] == 200
    code, body = _json(f"{turl}/predict", payload)
    assert code == 400 and "bfloat16" in body["error"]
    assert "bad request" in body["error"]


def test_predict_statsz_and_draining(classifiers):
    jurl, turl, jeng, teng = classifiers
    for url in (jurl, turl):
        for _ in range(3):
            assert _post(f"{url}/predict", {"inputs": [[[1.0, 1.0]]]})[0] \
                == 200
    js, ts = _json(f"{jurl}/statsz")[1], _json(f"{turl}/statsz")[1]
    assert set(js) <= set(ts)
    assert ts["stats"]["serving.completed"] == js["stats"][
        "serving.completed"] == 3
    assert ts["histograms"]["serving.latency_ms"]["count"] == 3
    assert ts["draining"] is False
    for eng in (jeng, teng):
        eng.begin_drain()
        eng._stopped.wait(10)
    assert _json(f"{turl}/healthz") == _json(f"{jurl}/healthz") == \
        (503, {"status": "draining"})
    jc = _post(f"{jurl}/predict", {"inputs": [[[1.0]]]})[0]
    tc, body = _post(f"{turl}/predict", {"inputs": [[[1.0]]]})
    assert tc == jc == 503 and b"drain" in body


# -- a router of two paged replicas -------------------------------------------

def test_router_generate_health_stats_metrics(weights):
    jm, pm = weights
    cfg = LAYOUTS["paged"]
    jr = JRouter(jllm_replica_factory(lambda r: jm, JConfig(**cfg)),
                 JRouterConfig(num_replicas=2, kind="llm",
                               health_interval=0.05),
                 registry=JStatRegistry())
    tr = Router(llm_replica_factory(lambda r: pm, LLMEngineConfig(**cfg)),
                RouterConfig(num_replicas=2, kind="llm",
                             health_interval=0.05),
                registry=StatRegistry(), device="cpu")
    try:
        with _served(jmake_server, router=jr) as jurl, \
                _served(make_server, router=tr) as turl:
            for prompt in PROMPTS:
                payload = {"prompt": prompt, "max_new_tokens": 5}
                jb = _json(f"{jurl}/generate", payload)[1]
                tb = _json(f"{turl}/generate", payload)[1]
                assert tb["tokens"] == jb["tokens"]
                tl = _ndjson(f"{turl}/generate", payload)
                assert [ln["token"] for ln in tl[:-1]] == jb["tokens"]
            (jc, jh), (tc, th) = (_json(f"{u}/healthz")
                                  for u in (jurl, turl))
            assert jc == tc == 200 and th["status"] == jh["status"] == "ok"
            assert set(jh) <= set(th) and th["kind"] == "llm"
            assert len(th["replicas"]) == 2
            ts = _json(f"{turl}/statsz")[1]
            assert set(ts) == set(_json(f"{jurl}/statsz")[1]) | \
                {"kernel_launches"} == {"router", "kernel_launches"}
            assert ts["kernel_launches"] == dict.fromkeys(KERNELS, 0)
            assert set(ts["router"]["replicas"]) == {"0", "1"}
            assert ts["router"]["total_dispatched"] == 2 * len(PROMPTS)
            text = _get(f"{turl}/metricsz")[2]
            fams = _families(text)
            assert "paddle_tpu_serving_router_dispatched_total" in fams
            for rid in (0, 1):
                assert (f"paddle_tpu_serving_llm_replica{rid}_"
                        f"tokens_generated_total") in fams
            assert b'replica="0"' in text and b'replica="1"' in text
            assert _families(_get(f"{jurl}/metricsz")[2]) <= fams
            assert _post(f"{turl}/predict", {"inputs": [[1.0]]})[0] == 503
            for r in (jr, tr):
                r.begin_drain()
            assert _json(f"{turl}/healthz")[0] == \
                _json(f"{jurl}/healthz")[0] == 503
            assert _json(f"{turl}/healthz")[1]["status"] == "draining"
    finally:
        jr.drain(timeout=60)
        tr.drain(timeout=60)
