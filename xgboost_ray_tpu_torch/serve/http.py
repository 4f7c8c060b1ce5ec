"""Threaded stdlib HTTP front-end for online inference.

Port of ``xgboost_ray_tpu/serve/http.py`` (``ServeHandle`` ``:198``,
``create_server`` ``:300``) for one replica. Endpoints (JSON in/out):

* ``POST /predict`` — body ``{"data": [[...], ...], "kind": "value"}``;
  responds ``{"predictions": [...], "model_version": v, "latency_ms": t}``.
  ``kind`` is ``value | margin | leaf``; ``contribs`` (SHAP) answers 501.
* ``POST /models`` — hot-swap: body ``{"path": "..."}`` (a saved model) or
  ``{"model_json": {...}}``; drains in-flight batches, responds
  ``{"model_version": v}``.
* ``GET /healthz`` — 200 ``{"status": "ok", "model_version": v}`` when
  serving; 503 with ``status`` ``no_model`` / ``draining`` / ``degraded``
  (consecutive-predictor-failure breaker open).
* ``GET /metrics`` — the ``ServeMetrics.snapshot()`` dict; with
  ``?format=prometheus`` the same counters as Prometheus text.

Error codes: 400 on a feature-count mismatch, a bad kind or a bad body;
503 before any model; 429 when the queue is over ``max_queue_rows``.
Each HTTP request runs on its own thread (``ThreadingHTTPServer``, with a
listen backlog of ``LISTEN_BACKLOG`` connections); the threads meet in the
microbatcher, which turns them into padded batches.
The replica pool (``n_replicas > 1``) is a later slice.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from xgboost_ray_tpu_torch.serve.batcher import (
    MicroBatcher,
    OverloadedError,
    ShuttingDownError,
)
from xgboost_ray_tpu_torch.serve.metrics import ServeMetrics
from xgboost_ray_tpu_torch.serve.predictor import SERVED_KINDS, compile_count
from xgboost_ray_tpu_torch.serve.registry import ModelRegistry, NoModelError


#: pending connections the listening socket holds. socketserver's default
#: of 5 is exceeded whenever more clients connect at once than the accept
#: loop takes in (it shares the GIL with the handler threads), and the
#: kernel then resets connections: 16 closed-loop clients were enough.
LISTEN_BACKLOG = 1024


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = LISTEN_BACKLOG


class _Handler(BaseHTTPRequestHandler):
    # set by the server factory
    serve_handle: "ServeHandle" = None

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw.decode("utf-8"))

    def _reply_text(self, code: int, body: str, content_type: str) -> None:
        raw = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # noqa: N802 - http.server API
        from urllib.parse import parse_qs, urlparse

        h = self.serve_handle
        parsed = urlparse(self.path)
        if parsed.path == "/metrics":
            fmt = parse_qs(parsed.query).get("format", ["json"])[0]
            if fmt == "prometheus":
                self._reply_text(
                    200, h.metrics.prometheus_text(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif fmt == "json":
                self._reply(200, h.metrics.snapshot())
            else:
                self._reply(400, {"error": f"unknown format {fmt!r}; "
                                           f"one of json|prometheus"})
            return
        if self.path == "/healthz":
            # 503 is reserved for the take-me-out-of-rotation states:
            # draining (graceful shutdown), no model yet, and degraded
            # (consecutive-predictor-failure breaker open). Requests still
            # flow while degraded so one success can close the breaker.
            if h.draining:
                self._reply(503, {"status": "draining"})
            elif not h.registry.has_model:
                self._reply(503, {"status": "no_model"})
            elif h.batcher.breaker_open:
                self._reply(503, {
                    "status": "degraded",
                    "consecutive_predictor_failures":
                        h.batcher.consecutive_failures(),
                    "model_version": h.registry.version,
                })
            else:
                self._reply(200, {
                    "status": "ok", "model_version": h.registry.version,
                })
            return
        self._reply(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):  # noqa: N802 - http.server API
        h = self.serve_handle
        try:
            doc = self._read_json()
        except (ValueError, UnicodeDecodeError) as exc:
            self._reply(400, {"error": f"bad JSON body: {exc}"})
            return
        if self.path == "/predict":
            self._do_predict(h, doc)
            return
        if self.path == "/models":
            self._do_models(h, doc)
            return
        self._reply(404, {"error": f"unknown path {self.path!r}"})

    def _do_predict(self, h: "ServeHandle", doc: dict) -> None:
        t0 = time.monotonic()
        if h.draining:
            # graceful shutdown step 1: stop ACCEPTING before draining
            self._reply(503, {"error": "endpoint is draining"})
            return
        data = doc.get("data")
        if data is None:
            self._reply(400, {"error": "missing 'data'"})
            return
        kind = doc.get("kind", "value")
        try:
            x = np.asarray(data, np.float32)
            if x.ndim == 1:
                x = x[None, :]
            if x.ndim != 2:
                raise ValueError(f"'data' must be [rows, features]; got "
                                 f"ndim={x.ndim}")
            # feature-count validation happens in the batcher against the
            # LEASED model (hot-swap safe); its ValueError maps to 400 below
            result, version = h.batcher.submit(x, kind)
        except OverloadedError as exc:
            # shed counted once, in the batcher, when the cap rejected it
            self._reply(429, {"error": str(exc)})
            return
        except (NoModelError, ShuttingDownError) as exc:
            self._reply(503, {"error": str(exc)})
            return
        except NotImplementedError as exc:
            self._reply(501, {"error": str(exc)})
            return
        except (ValueError, TypeError) as exc:
            h.metrics.observe_error()
            self._reply(400, {"error": str(exc)})
            return
        except TimeoutError as exc:
            h.metrics.observe_error()
            self._reply(504, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - CUDA/runtime failures etc.
            # anything marshalled out of the batch (device runtime errors,
            # a racing shutdown) must still produce a structured response,
            # not a dropped connection
            h.metrics.observe_error()
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {
            "predictions": np.asarray(result).tolist(),
            "model_version": version,
            "kind": kind,
            "latency_ms": round((time.monotonic() - t0) * 1000.0, 3),
        })

    def _do_models(self, h: "ServeHandle", doc: dict) -> None:
        model = doc.get("path") or doc.get("model_json")
        if model is None:
            self._reply(400, {"error": "body must carry 'path' or "
                                       "'model_json'"})
            return
        try:
            version = h.registry.load(model)
        except (OSError, ValueError, TypeError, KeyError) as exc:
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        except NotImplementedError as exc:
            self._reply(501, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - build/warmup failures
            # a kernel build error must produce a structured 500, not a
            # dropped connection
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {"model_version": version})


class ServeHandle:
    """One serving endpoint: registry + batcher + metrics + HTTP server,
    on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        model=None,
        host: str = "127.0.0.1",
        port: int = 0,
        device=None,
        max_batch: int = 256,
        max_delay_ms: float = 2.0,
        min_bucket: int = 8,
        warm_kinds: tuple = SERVED_KINDS,
        max_queue_rows: int = 0,
        breaker_threshold: int = 5,
        n_replicas: int = 1,
        layout: str = "heap",
    ):
        if n_replicas > 1:
            raise NotImplementedError(
                f"n_replicas={n_replicas}: the replica pool (serve/pool.py) "
                f"is not supported by xgboost_ray_tpu_torch yet (ROADMAP "
                f"queue A14)."
            )
        self._draining = False
        self.metrics = ServeMetrics(recompile_count_fn=compile_count)
        self.registry = ModelRegistry(
            device=device,
            min_bucket=min_bucket,
            layout=layout,
            warm_kinds=warm_kinds,
            warm_max_batch=max_batch,
            metrics=self.metrics,
        )
        # the two steps that can fail (port bind, bad model) run BEFORE the
        # batcher spawns its flusher thread, so a raising __init__ leaks no
        # thread the caller has no handle to shut down
        handler = type("_BoundHandler", (_Handler,), {"serve_handle": self})
        self._httpd = _Server((host, port), handler)
        self._server_thread: Optional[threading.Thread] = None
        try:
            if model is not None:
                self.registry.load(model)
            self.batcher = MicroBatcher(
                self.registry,
                max_batch=max_batch,
                max_delay_ms=max_delay_ms,
                metrics=self.metrics,
                max_queue_rows=max_queue_rows,
                breaker_threshold=breaker_threshold,
            )
        except BaseException:
            self._httpd.server_close()
            raise
        self.metrics.queue_depth_fn = self.batcher.queue_depth
        self.metrics.breaker_fn = lambda: {
            "breaker_open": int(self.batcher.breaker_open),
            "consecutive_predictor_failures":
                self.batcher.consecutive_failures(),
        }

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def draining(self) -> bool:
        return self._draining

    def start(self) -> "ServeHandle":
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._server_thread.start()
        return self

    def shutdown(self, drain_timeout_s: float = 5.0) -> None:
        """Graceful: stop accepting (503 on new /predict), drain queued and
        in-flight batches, then close the server and the batcher."""
        self._draining = True
        self.batcher.drain(drain_timeout_s)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._server_thread is not None:
            self._server_thread.join(5.0)
        self.batcher.shutdown()


def create_server(model=None, host: str = "127.0.0.1", port: int = 0,
                  **config) -> ServeHandle:
    """Build and start a serving endpoint; returns its ``ServeHandle``
    (``.url`` for clients, ``.registry.load()`` for hot-swaps,
    ``.shutdown()`` when done)."""
    return ServeHandle(model=model, host=host, port=port, **config).start()
