"""Online serving of the port (``xgboost_ray_tpu_torch.serve``) on the CPU.

Mirrors ``tests/test_serve.py``: the bucket ladder equals the JAX
package's; served outputs are bitwise equal to ``booster.predict`` on the
same device for value, margin and leaf, in both forest layouts, directly
and over HTTP (padding rows cannot leak into real rows: the walk is
row-independent); concurrent submitters coalesce into batches; a hot swap
under load drops and mixes no response; ``train(serve_registry=...)``
publishes; the HTTP error codes; the ``/metrics`` fields; and no kernel
build after warmup (``compile_count()``; on the CPU there is no build at
all, the card test of the same counter is ``chip_smoke.py``'s serve
phase). Everything runs with ``device="cpu"`` on loopback servers.
"""

import json
import pickle
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.serve.predictor import bucket_rows as jax_bucket_rows
from xgboost_ray_tpu_torch import serve
from xgboost_ray_tpu_torch.serve.predictor import bucket_rows

CPU = "cpu"
RP = tx.RayParams(num_actors=2)
SERVED = ("value", "margin", "leaf")


def _train_binary(seed=0, eta=0.3, rounds=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(300, 6).astype(np.float32)
    x[rng.rand(300, 6) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1]) > 0).astype(
        np.float32)
    bst = tx.train(
        {"objective": "binary:logistic", "max_depth": 3, "eta": eta,
         "seed": seed},
        tx.RayDMatrix(x, y), rounds, ray_params=RP, device=CPU,
    )
    return bst, x


@pytest.fixture(scope="module")
def binary_model():
    return _train_binary(seed=0)


@pytest.fixture(scope="module")
def binary_model_b():
    # same shape as binary_model, different trees: the retrain-and-swap case
    return _train_binary(seed=1, eta=0.05)


def _ref(bst, q, kind):
    kw = {"value": {}, "margin": {"output_margin": True},
          "leaf": {"pred_leaf": True}}[kind]
    return bst.predict(q, device=CPU, **kw)


def _post(url, path, doc, timeout=30.0):
    req = urllib.request.Request(
        url + path, json.dumps(doc).encode("utf-8"),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, path, timeout=30.0):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_bucket_rows_equal_to_jax():
    table = [(n, mb, d) for n in (0, 1, 5, 8, 9, 17, 100, 255, 256, 257, 1000)
             for mb in (1, 8, 16) for d in (1, 2, 3, 8)]
    for n, mb, d in table:
        assert bucket_rows(n, mb, d) == jax_bucket_rows(n, mb, d), (n, mb, d)
    assert bucket_rows(1, 8) == 8 and bucket_rows(9, 8) == 16
    assert bucket_rows(100, 8) == 128
    # idempotent: the warmup enumeration hits exactly the live buckets
    live = {bucket_rows(n, 8) for n in range(1, 257)}
    assert all(bucket_rows(b, 8) == b for b in live)


@pytest.mark.parametrize("layout", serve.LAYOUTS)
def test_served_bitwise_equal_to_batch_predict(binary_model, layout):
    bst, x = binary_model
    pred = serve.CompiledPredictor(bst, device=CPU, layout=layout)
    for n in (1, 5, 37):
        q = x[:n]
        for kind in SERVED:
            got, bucket = pred.predict_with_bucket(q, kind)
            ref = _ref(bst, q, kind)
            assert got.dtype == ref.dtype and np.array_equal(got, ref), (
                kind, n)
            assert bucket == bucket_rows(n, 8)
    # the bucket buffers are reused: a later call does not change an
    # earlier result
    first = pred.predict(x[:5], "margin")
    pred.predict(x[5:10], "margin")
    assert np.array_equal(first, _ref(bst, x[:5], "margin"))
    with pytest.raises(NotImplementedError, match="A15"):
        pred.predict(x[:3], "contribs")
    with pytest.raises(ValueError, match="output kind"):
        pred.predict(x[:3], "nope")
    with pytest.raises(ValueError, match="feature shape mismatch"):
        pred.predict(x[:3, :4], "value")


@pytest.mark.parametrize("layout", serve.LAYOUTS)
def test_served_bitwise_through_http(binary_model, layout):
    bst, x = binary_model
    h = serve.create_server(bst, max_batch=64, max_delay_ms=1.0, device=CPU,
                            layout=layout)
    try:
        q = np.nan_to_num(x[:9])  # JSON has no NaN
        for kind in SERVED:
            status, r = _post(h.url, "/predict",
                              {"data": q.tolist(), "kind": kind})
            assert status == 200 and r["model_version"] == 1
            ref = _ref(bst, q, kind)
            got = np.asarray(r["predictions"], ref.dtype)
            assert np.array_equal(got, ref), kind
    finally:
        h.shutdown()


def test_many_concurrent_clients_no_connection_reset(binary_model):
    """More clients connect at once than socketserver's default listen
    backlog of 5 holds: every request is answered, none is reset."""
    bst, x = binary_model
    q = np.nan_to_num(x)
    h = serve.create_server(bst, max_batch=256, max_delay_ms=1.0, device=CPU)
    assert h._httpd.request_queue_size == serve.http.LISTEN_BACKLOG >= 64
    start = threading.Barrier(64)
    errors, answered = [], []

    def client(i):
        start.wait()
        for j in range(4):
            lo = (i * 7 + j) % (len(q) - 3)
            try:
                _, r = _post(h.url, "/predict", {"data": q[lo:lo + 3].tolist()})
                answered.append(len(r["predictions"]))
            except Exception as exc:  # noqa: BLE001 - the test counts them
                errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(64)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        h.shutdown()
    assert errors == [] and answered == [3] * 256


def test_no_builds_after_warmup_and_same_shape_swap(binary_model,
                                                    binary_model_b):
    bst_a, x = binary_model
    bst_b, _ = binary_model_b
    assert bst_a.signature() == bst_b.signature()
    pred = serve.CompiledPredictor(bst_a, device=CPU)
    pred.warmup(kinds=SERVED, max_batch=64)
    c0 = serve.compile_count()
    rng = np.random.RandomState(0)
    for i in range(60):
        n = int(rng.randint(1, 65))
        pred.predict(x[:n], SERVED[i % 3])
    assert serve.compile_count() == c0
    reg = serve.ModelRegistry(device=CPU, warm_kinds=("value",),
                              warm_max_batch=32)
    reg.load(bst_a)
    reg.load(bst_b)
    assert serve.compile_count() == c0
    with reg.lease() as entry:
        got = entry.predictor.predict(x[:7], "value")
    assert np.array_equal(got, _ref(bst_b, x[:7], "value"))


def test_microbatcher_coalesces_concurrent_requests(binary_model):
    bst, x = binary_model
    metrics = serve.ServeMetrics()
    reg = serve.ModelRegistry(device=CPU, warm_kinds=("value",),
                              warm_max_batch=64)
    reg.load(bst)
    batcher = serve.MicroBatcher(reg, max_batch=64, max_delay_ms=50.0,
                                 metrics=metrics)
    try:
        results = [None] * 8
        barrier = threading.Barrier(8)

        def client(i):
            barrier.wait()
            results[i] = batcher.submit(x[i * 3: i * 3 + 3], "value")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
        for i, (out, version) in enumerate(results):
            assert version == 1
            assert np.array_equal(out, _ref(bst, x[i * 3: i * 3 + 3], "value"))
        snap = metrics.snapshot()
        assert snap["requests"] == 8
        # 8 near-simultaneous requests within one 50 ms window coalesce
        assert snap["batches"] < 8
        assert snap["mean_batch_rows"] > 3
        with pytest.raises(NotImplementedError, match="A15"):
            batcher.submit(x[:2], "contribs")
    finally:
        batcher.shutdown()


def test_oversized_request_and_padding_accounting(binary_model):
    bst, x = binary_model
    metrics = serve.ServeMetrics()
    reg = serve.ModelRegistry(device=CPU, warm_kinds=())
    reg.load(bst, warm=False)
    batcher = serve.MicroBatcher(reg, max_batch=16, max_delay_ms=1.0,
                                 metrics=metrics)
    try:
        batcher.submit(x[:5], "value")  # bucket 8 -> 3 padded rows
        snap = metrics.snapshot()
        assert snap["batches"] == 1
        assert snap["padding_waste"] == pytest.approx(3 / 8)
        out, _ = batcher.submit(x[:100], "leaf")  # > max_batch rows
        assert np.array_equal(out, _ref(bst, x[:100], "leaf"))
    finally:
        batcher.shutdown()


def test_hot_swap_under_load_no_dropped_or_mixed(binary_model, binary_model_b):
    bst_a, x = binary_model
    bst_b, _ = binary_model_b
    q = np.nan_to_num(x[:4])
    ref = {1: _ref(bst_a, q, "value"), 2: _ref(bst_b, q, "value")}
    h = serve.create_server(bst_a, max_batch=32, max_delay_ms=1.0, device=CPU)
    errors, responses = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                status, r = _post(h.url, "/predict", {"data": q.tolist()})
                with lock:
                    responses.append((status, r["model_version"],
                                      np.asarray(r["predictions"], np.float32)))
            except Exception as exc:  # noqa: BLE001 - recorded as a failure
                with lock:
                    errors.append(repr(exc))

    threads = [threading.Thread(target=client) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # more thread switches inside the swap
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert h.registry.load(bst_b) == 2  # drains in-flight, then flips
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(30.0)
        sys.setswitchinterval(interval)
        h.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(responses) > 10
    versions = {v for _, v, _ in responses}
    assert versions <= {1, 2} and 2 in versions
    for status, v, pred in responses:  # nothing mixed: bitwise per version
        assert status == 200
        assert np.array_equal(pred, ref[v]), v
    assert h.metrics.snapshot()["model_swaps"] == 1


def test_train_publishes_into_serve_registry():
    rng = np.random.RandomState(2)
    x = rng.randn(200, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    reg = serve.ModelRegistry(device=CPU, warm_kinds=())
    extra = {}
    bst = tx.train({"objective": "binary:logistic", "max_depth": 2},
                   tx.RayDMatrix(x, y), 2, ray_params=RP, device=CPU,
                   serve_registry=reg, additional_results=extra)
    assert reg.version == 1 and extra["serve_model_version"] == 1
    with reg.lease() as entry:
        got = entry.predictor.predict(x[:5], "value")
    assert np.array_equal(got, _ref(bst, x[:5], "value"))


def test_registry_loads_path_json_bytes_and_refuses_xgb_json(binary_model,
                                                             tmp_path):
    bst, x = binary_model
    path = tmp_path / "model.json"
    bst.save_model(str(path))
    reg = serve.ModelRegistry(device=CPU, warm_kinds=())
    for model in (str(path), path.read_text(), json.loads(path.read_text()),
                  pickle.dumps(bst)):
        reg.load(model, warm=False)
        with reg.lease() as entry:
            got = entry.predictor.predict(x[:6], "margin")
        assert np.array_equal(got, _ref(bst, x[:6], "margin"))
    assert reg.version == 4
    with pytest.raises(NotImplementedError, match="xgb_export"):
        serve.coerce_model({"learner": {"gradient_booster": {"name": "gbtree"}}})
    with pytest.raises(TypeError):
        serve.coerce_model(pickle.dumps({"not": "a booster"}))
    with pytest.raises(ValueError, match="neither"):
        serve.coerce_model("{not json")


def test_healthz_metrics_and_no_build_after_warmup(binary_model):
    bst, x = binary_model
    h = serve.ServeHandle(max_batch=32, max_delay_ms=1.0, device=CPU).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(h.url, "/healthz")
        assert ei.value.code == 503  # no model yet
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(h.url, "/predict", {"data": x[:2].tolist()})
        assert ei.value.code == 503
        h.registry.load(bst)  # warms every bucket up to max_batch
        c0 = serve.compile_count()
        status, doc = _get(h.url, "/healthz")
        assert (status, doc["status"], doc["model_version"]) == (200, "ok", 1)
        q = np.nan_to_num(x)
        for n in (4, 4, 1, 17, 32):
            _post(h.url, "/predict", {"data": q[:n].tolist()})
        status, m = _get(h.url, "/metrics")
        assert status == 200
        for key in ("qps", "queue_depth", "latency_p50_ms", "latency_p95_ms",
                    "latency_p99_ms", "padding_waste", "recompile_count",
                    "requests", "rows", "batches", "model_swaps", "errors",
                    "shed", "mean_batch_rows", "breaker_open"):
            assert key in m, key
        assert m["requests"] == 5 and m["rows"] == 58
        assert 0.0 <= m["padding_waste"] < 1.0
        assert m["latency_p99_ms"] >= m["latency_p50_ms"] > 0.0
        assert serve.compile_count() == c0
        with urllib.request.urlopen(h.url + "/metrics?format=prometheus") as r:
            text = r.read().decode()
        assert "rxgb_serve_requests_total 5" in text
    finally:
        h.shutdown()


def test_http_error_codes(binary_model, binary_model_b, tmp_path):
    bst, x = binary_model
    h = serve.create_server(bst, max_batch=32, max_delay_ms=1.0, device=CPU)
    q = np.nan_to_num(x)
    try:
        for doc, frag in [
            ({"data": q[:2, :3].tolist()}, "shape mismatch"),
            ({"data": q[:2].tolist(), "kind": "nope"}, "output kind"),
            ({}, "missing 'data'"),
        ]:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(h.url, "/predict", doc)
            assert ei.value.code == 400
            assert frag in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(h.url, "/predict", {"data": q[:2].tolist(), "kind": "contribs"})
        assert ei.value.code == 501
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(h.url, "/nope")
        assert ei.value.code == 404
        # hot swap over HTTP, and a missing path
        path = tmp_path / "next.json"
        binary_model_b[0].save_model(str(path))
        status, r = _post(h.url, "/models", {"path": str(path)})
        assert (status, r["model_version"]) == (200, 2)
        status, r = _post(h.url, "/predict", {"data": q[:3].tolist()})
        assert r["model_version"] == 2
        assert np.array_equal(np.asarray(r["predictions"], np.float32),
                              _ref(binary_model_b[0], q[:3], "value"))
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(h.url, "/models", {"path": str(tmp_path / "missing.json")})
        assert ei.value.code == 400
    finally:
        h.shutdown()
    with pytest.raises(NotImplementedError, match="n_replicas"):
        serve.create_server(bst, n_replicas=2, device=CPU)
    with pytest.raises(ValueError, match="layout"):
        serve.create_server(bst, layout="nope", device=CPU)


def test_overload_sheds_with_429(binary_model):
    bst, x = binary_model
    h = serve.create_server(bst, max_batch=8, max_delay_ms=200.0, device=CPU,
                            max_queue_rows=4)
    q = np.nan_to_num(x)
    try:
        codes = []
        lock = threading.Lock()

        def client():
            try:
                status, _ = _post(h.url, "/predict", {"data": q[:3].tolist()})
            except urllib.error.HTTPError as exc:
                status = exc.code
            with lock:
                codes.append(status)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert 429 in codes and 200 in codes
        assert h.metrics.snapshot()["shed"] >= 1
    finally:
        h.shutdown()
