"""Stdlib-only HTTP front door over an :class:`Engine`, an
:class:`~paddle_tpu_torch.serving.llm.LLMEngine` and/or a
:class:`~paddle_tpu_torch.serving.router.Router` (counterpart of
``paddle_tpu/serving/http.py``; the same routes, payloads, status codes
and streaming format).

Endpoints:
  * ``POST /predict`` — body ``{"inputs": [nested-list, ...],
    "dtypes": ["float32", ...] (optional), "deadline_s": float (optional)}``;
    responds ``{"outputs": [...], "shapes": [...], "req_ms": float}``.
    The inputs are NumPy arrays, as the engine takes them; ``"bfloat16"``
    is refused with a 400 that names it (NumPy has no bfloat16 of its
    own: send float32 and cast inside the model).
  * ``POST /generate`` — body ``{"prompt": [token ids],
    "max_new_tokens": int, "do_sample": bool, "temperature": float,
    "top_k": int, "eos_token_id": int, "deadline_s": float,
    "stream": bool}``. Non-streaming responds ``{"tokens": [...],
    "finish_reason": "stop"|"length", "req_ms": float}``; with
    ``"stream": true`` the body is newline-delimited JSON — one
    ``{"token": t}`` line per generated token as the decode tick produces
    it, then a final ``{"done": true, "finish_reason": ...}`` line (the
    response is close-delimited, so readers consume until EOF).
  * ``GET /healthz`` — ``{"status": "ok"|"draining"}`` (503 while any
    mounted engine drains); a router answers with its aggregate, an LLM
    engine adds its ``role``.
  * ``GET /statsz`` — the engine's stats payload, with the LLM engine's
    under ``"llm"`` and the router's under ``"router"``; the port adds
    ``"kernel_launches"``, this process's launches of each hand-written
    kernel (:func:`paddle_tpu_torch.ops.kernel_launches`).
  * ``GET /metricsz`` — the same registries in Prometheus text exposition
    (format 0.0.4, :func:`~paddle_tpu_torch.observability.metrics.
    render_prometheus`).

Threading model: ``ThreadingHTTPServer`` handles each connection on its
own thread; handlers block on the request future (or the token stream),
while each engine's single worker thread does the batching — concurrent
POSTs are what gives the batchers something to coalesce. The server
itself touches no tensor: the engines own the device.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from ..ops import kernel_launches
from .request import DeadlineExceeded, ServingError


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, engine, quiet: bool = True, llm_engine=None,
                 router=None):
        if engine is None and llm_engine is None and router is None:
            raise ValueError("need an engine, an llm_engine, or a router")
        self.engine = engine
        self.llm_engine = llm_engine
        # a Router routes /predict (kind="classifier") or /generate
        # (kind="llm") across its replicas; /healthz and /statsz expose
        # the aggregate and the per-replica views
        self.router = router
        self.quiet = quiet
        super().__init__(addr, _Handler)


def _np_dtype(name) -> np.dtype:
    """The NumPy dtype of a ``/predict`` input. ``bfloat16`` is refused by
    name: NumPy knows it only through ``ml_dtypes``, which the port does
    not use, so the answer never depends on what else is installed."""
    if str(name) == "bfloat16":
        raise ValueError(
            "dtype 'bfloat16' is not taken by /predict: inputs are NumPy "
            "arrays, and NumPy has no bfloat16; send float32 and cast in "
            "the model")
    return np.dtype(name)


class _Handler(BaseHTTPRequestHandler):
    # the mounted engines are found through self.server

    def log_message(self, fmt, *args):
        if not self.server.quiet:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send_json(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        engine = self.server.engine
        llm = self.server.llm_engine
        router = self.server.router
        if self.path == "/healthz":
            draining = any(e.draining for e in (engine, llm, router)
                           if e is not None)
            if router is not None:
                agg = router.healthz()
                # degraded still serves (some replica is admissible);
                # draining/unhealthy means stop routing here
                code = 200 if agg["status"] in ("ok", "degraded") else 503
                if draining:
                    agg["status"] = "draining"
                    code = 503
                self._send_json(code, agg)
            elif draining:
                self._send_json(503, {"status": "draining"})
            else:
                payload = {"status": "ok"}
                if llm is not None:
                    # disaggregated fleets route by this (prefill/decode/
                    # mixed); load balancers can match phase to role
                    payload["role"] = llm.role
                self._send_json(200, payload)
        elif self.path == "/statsz":
            payload = engine.stats() if engine is not None else {}
            if llm is not None:
                payload["llm"] = llm.stats()
            if router is not None:
                payload["router"] = router.stats()
            payload["kernel_launches"] = kernel_launches()
            self._send_json(200, payload)
        elif self.path == "/metricsz":
            self._do_metricsz(engine, llm, router)
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _do_metricsz(self, engine, llm, router=None):
        """Prometheus text exposition of every mounted engine's registry,
        each distinct registry once (a router adds its own and every
        replica engine's; per-replica series carry ``replica`` labels)."""
        from ..observability.metrics import CONTENT_TYPE, render_prometheus
        regs = []
        for e in (engine, llm):
            if e is not None and all(e.registry is not r for r in regs):
                regs.append(e.registry)
        if router is not None:
            for reg in router.registries():
                if all(reg is not r for r in regs):
                    regs.append(reg)
        body = "".join(render_prometheus(r) for r in regs).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_payload(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def do_POST(self):
        if self.path == "/predict":
            self._do_predict()
        elif self.path == "/generate":
            self._do_generate()
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _do_predict(self):
        engine = self.server.engine
        router = self.server.router
        if engine is None and router is not None \
                and router.kind == "classifier":
            engine = router   # Router.submit has the Engine.submit shape
        if engine is None:
            self._send_json(503, {"error": "no classifier engine mounted"})
            return
        t0 = time.monotonic()
        try:
            payload = self._read_payload()
            raw_inputs = payload["inputs"]
            dtypes = payload.get("dtypes") or ["float32"] * len(raw_inputs)
            arrays = [np.asarray(a, dtype=_np_dtype(d))
                      for a, d in zip(raw_inputs, dtypes)]
            fut = engine.submit(arrays, deadline=payload.get("deadline_s"))
            outs = fut.result(timeout=payload.get("timeout_s", 60.0))
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        except DeadlineExceeded as e:
            self._send_json(504, {"error": str(e)})
            return
        except ServingError as e:
            self._send_json(503, {"error": str(e)})
            return
        self._send_json(200, {
            "outputs": [o.tolist() for o in outs],
            "shapes": [list(o.shape) for o in outs],
            "req_ms": (time.monotonic() - t0) * 1000.0,
        })

    def _do_generate(self):
        llm = self.server.llm_engine
        router = self.server.router
        if llm is None and router is not None and router.kind == "llm":
            llm = router      # Router.submit forwards LLMEngine.submit kwargs
        if llm is None:
            self._send_json(503, {"error": "no LLM engine mounted"})
            return
        t0 = time.monotonic()
        try:
            payload = self._read_payload()
            stream = bool(payload.get("stream", False))
            req = llm.submit(
                payload["prompt"],
                max_new_tokens=payload.get("max_new_tokens"),
                do_sample=bool(payload.get("do_sample", False)),
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                eos_token_id=payload.get("eos_token_id"),
                deadline=payload.get("deadline_s"),
                stream=stream)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        except ServingError as e:
            self._send_json(503, {"error": str(e)})
            return
        timeout = payload.get("timeout_s", 120.0)
        if not stream:
            try:
                out = req.result(timeout=timeout)
            except DeadlineExceeded as e:
                self._send_json(504, {"error": str(e)})
                return
            except ServingError as e:
                self._send_json(503, {"error": str(e)})
                return
            self._send_json(200, {
                "tokens": out["tokens"],
                "finish_reason": out["finish_reason"],
                "req_ms": (time.monotonic() - t0) * 1000.0,
            })
            return
        # streaming: NDJSON, close-delimited (no Content-Length)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.end_headers()

        def _line(obj):
            self.wfile.write((json.dumps(obj) + "\n").encode("utf-8"))
            self.wfile.flush()

        try:
            for tok in req.iter_tokens(timeout=timeout):
                _line({"token": int(tok)})
            _line({"done": True, "finish_reason": req.finish_reason,
                   "req_ms": (time.monotonic() - t0) * 1000.0})
        except Exception as e:  # mid-stream failure -> error line
            try:
                _line({"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass  # client went away; nothing left to tell it


def make_server(engine, host: str = "127.0.0.1", port: int = 8500,
                quiet: bool = True, llm_engine=None,
                router=None) -> ServingHTTPServer:
    """Bind (port 0 picks a free one; see ``server.server_address``)."""
    return ServingHTTPServer((host, port), engine, quiet=quiet,
                             llm_engine=llm_engine, router=router)


def serve_forever(engine, host: str = "127.0.0.1", port: int = 8500,
                  quiet: bool = False,
                  ready_cb: Optional[Callable] = None, llm_engine=None,
                  router=None):
    """Blocking serve loop; shuts the listener down once every mounted
    engine's drain completes (queue flushed, in-flight sequences done)."""
    httpd = make_server(engine, host, port, quiet=quiet,
                        llm_engine=llm_engine, router=router)
    if ready_cb is not None:
        ready_cb(httpd)

    def _watch_drain():
        for e in (engine, llm_engine, router):
            if e is not None:
                e._stopped.wait()
        httpd.shutdown()

    threading.Thread(target=_watch_drain, daemon=True).start()
    try:
        httpd.serve_forever(poll_interval=0.2)
    finally:
        httpd.server_close()
