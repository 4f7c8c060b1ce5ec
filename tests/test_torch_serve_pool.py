"""Serving scale-out of the port (``serve/pool.py``, ``serve/autoscale.py``,
``serve/canary.py``, ``obs/trace.py``) on the CPU.

``tests/test_serve_pool.py``'s scenarios re-aimed at the port with
``device="cpu"``: both forest layouts serve every kind (``contribs`` too)
bitwise equal to ``booster.predict``; a publish warms all four kinds; the
router dispatches bitwise across replicas, admission-controls, answers
with ``NoReplicasError`` when none is left, survives a replica killed under
load with no client error (the route -> death -> rejoin story read back
from the trace alone), drains on scale-down; the autoscaler's up/down
cycle and its queue-depth trigger read back from the trace; a canary on
shuffled labels rolls back and a ``refresh``-ed candidate is promoted,
counted in the serve metrics; and every timeline validates against the
trace schema and the JAX package's event names.
"""

import threading
import time

import numpy as np
import pytest

import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.obs import TRACE_NAMES as JAX_TRACE_NAMES
from xgboost_ray_tpu_torch import obs, serve

CPU = "cpu"
RP = tx.RayParams(num_actors=1)
REFS = {"value": {}, "margin": {"output_margin": True},
        "leaf": {"pred_leaf": True}, "contribs": {"pred_contribs": True}}


def _train_binary(seed=0, eta=0.3, rounds=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(300, 6).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    bst = tx.train({"objective": "binary:logistic", "max_depth": 3,
                    "eta": eta, "seed": seed}, tx.RayDMatrix(x, y), rounds,
                   ray_params=RP, device=CPU)
    return bst, x, y


@pytest.fixture(scope="module")
def binary_model():
    return _train_binary(seed=0)


@pytest.fixture(scope="module")
def multiclass_model():
    rng = np.random.RandomState(3)
    x = rng.randn(240, 5).astype(np.float32)
    y = (np.abs(x[:, 0]) + x[:, 1] > 0.6).astype(np.float32) + (
        x[:, 2] > 0.8).astype(np.float32)
    bst = tx.train({"objective": "multi:softprob", "num_class": 3,
                    "max_depth": 3, "eta": 0.3}, tx.RayDMatrix(x, y), 3,
                   ray_params=RP, device=CPU)
    return bst, x


@pytest.fixture()
def tracer():
    """A fresh tracer installed as the process default, so the serve
    plane's events land where the test reads them back."""
    tr = obs.Tracer(capacity=4096, enabled=True, trace_dir="", rank=0)
    old = obs.get_tracer()
    obs.set_default_tracer(tr)
    yield tr
    obs.set_default_tracer(old if old.enabled else None)


def _names(tracer):
    return [r["name"] for r in tracer.records()]


def _ref(bst, q, kind):
    return bst.predict(q, device=CPU, **REFS[kind])


# ---------------------------------------------------------------------------
# layouts: every kind bitwise, publish warms all four kinds
# ---------------------------------------------------------------------------


def test_node_array_bitwise_parity_binary(binary_model):
    bst, x, _ = binary_model
    heap = serve.CompiledPredictor(bst, device=CPU)
    na = serve.CompiledPredictor(bst, device=CPU, layout="node_array")
    q = x[:37].copy()
    q[3, 0] = np.nan  # NaN routes by default_left in both layouts
    q[11, 2] = np.nan
    for n in (1, 9, 37):
        for kind in serve.KINDS:
            a = np.asarray(heap.predict(q[:n], kind))
            b = np.asarray(na.predict(q[:n], kind))
            assert a.dtype == b.dtype and np.array_equal(a, b), (kind, n)
            assert np.array_equal(a, _ref(bst, q[:n], kind)), (kind, n)


def test_node_array_bitwise_parity_multiclass(multiclass_model):
    bst, x = multiclass_model
    heap = serve.CompiledPredictor(bst, device=CPU)
    na = serve.CompiledPredictor(bst, device=CPU, layout="node_array")
    q = x[:21]
    for kind in serve.KINDS:
        a = np.asarray(heap.predict(q, kind))
        assert np.array_equal(a, np.asarray(na.predict(q, kind))), kind
        assert np.array_equal(a, _ref(bst, q, kind)), kind


def test_replica_spinup_shares_shap_tables_and_builds_nothing(binary_model):
    bst, x, _ = binary_model
    first = serve.CompiledPredictor(bst, device=CPU, layout="node_array")
    first.warmup(kinds=serve.KINDS, max_batch=64)
    c0 = serve.compile_count()
    second = serve.CompiledPredictor(bst, device=CPU, layout="node_array")
    for kind in serve.KINDS:
        second.predict(x[:13], kind)
    assert serve.compile_count() == c0
    # the model's SHAP tables are built once per device and shared
    assert second._shap[0] is first._shap[0]


def test_invalid_layout_rejected(binary_model):
    bst, _, _ = binary_model
    with pytest.raises(ValueError, match="layout"):
        serve.CompiledPredictor(bst, device=CPU, layout="bfs")


def test_publish_warms_all_four_kinds(binary_model):
    bst, x, _ = binary_model
    reg = serve.ModelRegistry(device=CPU, warm_max_batch=64)
    assert reg.warm_kinds == serve.KINDS
    reg.load(bst)
    with reg.lease() as entry:
        for kind in serve.KINDS:
            assert (64, kind) in entry.predictor._buffers, kind
        c0 = serve.compile_count()
        for kind in serve.KINDS:
            entry.predictor.predict(x[:9], kind)
    assert serve.compile_count() == c0


def test_publish_warm_skips_contribs_without_node_stats(binary_model):
    import copy

    bst, x, _ = binary_model
    old = copy.deepcopy(bst)
    old._has_node_stats = False
    reg = serve.ModelRegistry(device=CPU)
    reg.load(old)  # the all-kinds warm skips contribs rather than raising
    with reg.lease() as entry:
        entry.predictor.predict(x[:4], "value")
        with pytest.raises(ValueError, match="contributions"):
            entry.predictor.predict(x[:4], "contribs")


# ---------------------------------------------------------------------------
# router: dispatch, admission control, replica loss
# ---------------------------------------------------------------------------


def _make_router(bst, n_replicas=2, layout="heap", **kw):
    metrics = serve.ServeMetrics(recompile_count_fn=serve.compile_count)
    reg = serve.ModelRegistry(device=CPU, layout=layout, warm_max_batch=64,
                              metrics=metrics)
    reg.load(bst)
    router = serve.Router(reg, n_replicas=n_replicas, metrics=metrics,
                          max_batch=64, max_delay_ms=1.0, layout=layout,
                          device=CPU, **kw)
    metrics.replica_count_fn = router.live_replicas
    return router, metrics


def test_router_serves_bit_identical_across_replicas(binary_model, tracer):
    bst, x, _ = binary_model
    router, metrics = _make_router(bst, n_replicas=2)
    try:
        for kind in serve.KINDS:
            ref = _ref(bst, x[:8], kind)
            for _ in range(3):
                out, version = router.submit(x[:8], kind)
                assert version == 1 and np.array_equal(np.asarray(out), ref)
        assert metrics.snapshot()["replicas"] == 2
    finally:
        router.shutdown()
    routes = [r for r in tracer.records() if r["name"] == "serve.route"]
    assert len(routes) == 12
    assert {r["attrs"]["replica"] for r in routes} <= {0, 1}
    recs = tracer.records()
    assert not obs.validate_trace_records(recs, known_names=obs.TRACE_NAMES)
    assert obs.TRACE_NAMES == JAX_TRACE_NAMES


def test_router_admission_control_rejects_and_counts(binary_model, tracer):
    bst, x, _ = binary_model
    router, metrics = _make_router(bst, n_replicas=2, max_queue_rows=4)
    try:
        with pytest.raises(serve.OverloadedError):
            router.submit(x[:8], "value")  # 8 rows > cap 4
        assert metrics.admission_rejects == 1
        assert metrics.snapshot()["admission_rejects"] == 1
        out, _ = router.submit(x[:2], "value")
        assert out.shape[0] == 2
    finally:
        router.shutdown()


def test_router_no_replicas_is_503_surface(binary_model):
    bst, x, _ = binary_model
    router, _ = _make_router(bst, n_replicas=1)
    try:
        router.kill(0)
        with pytest.raises(serve.NoReplicasError):
            router.submit(x[:2], "value")
        router.rejoin()
        out, _ = router.submit(x[:2], "value")
        assert out.shape[0] == 2
    finally:
        router.shutdown()


def test_no_replicas_over_http_is_503(binary_model):
    import json
    import urllib.error
    import urllib.request

    bst, x, _ = binary_model
    h = serve.create_server(bst, n_replicas=2, device=CPU, max_batch=32)
    try:
        for slot in h.batcher.replica_slots():
            h.batcher.kill(slot)
        req = urllib.request.Request(
            h.url + "/predict",
            json.dumps({"data": x[:2].tolist()}).encode("utf-8"),
            {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
    finally:
        h.shutdown()


def test_replica_kill_mid_load_sheds_capacity_not_availability(
        binary_model, tracer):
    """Kill a replica while clients hammer the router: no request fails
    (the dead replica's queue is sent to the survivor), and the timeline
    alone tells route -> death -> rejoin."""
    bst, x, _ = binary_model
    router, _ = _make_router(bst, n_replicas=2)
    q = x[:4]
    ref = _ref(bst, q, "value")
    errors, ok = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                out, version = router.submit(q, "value", timeout=30.0)
                with lock:
                    ok.append((version, np.asarray(out)))
            except Exception as exc:  # noqa: BLE001 - recorded as failure
                with lock:
                    errors.append(repr(exc))

    def wait_for(n, deadline_s=60.0):
        deadline = time.monotonic() + deadline_s
        while len(ok) < n:
            assert not errors, errors[:3]
            assert time.monotonic() < deadline, f"stalled at {len(ok)}/{n}"
            time.sleep(0.002)

    threads = [threading.Thread(target=client) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        wait_for(20)
        victim = router.replica_slots()[0]
        router.kill(victim)
        wait_for(60)
        new_slot = router.rejoin()
        wait_for(90)
    finally:
        stop.set()
        for t in threads:
            t.join(30.0)
        router.shutdown()
    assert not errors, errors[:3]
    assert len(ok) >= 90
    for version, out in ok:
        assert version == 1 and np.array_equal(out, ref)
    recs = [(r["name"], r.get("attrs", {})) for r in tracer.records()
            if r["name"].startswith("serve.")]
    kill_at = next(i for i, (n, a) in enumerate(recs)
                   if n == "serve.replica_down" and a.get("reason") == "killed")
    rejoin_at = next(i for i, (n, a) in enumerate(recs)
                     if n == "serve.replica_up" and a.get("reason") == "rejoin")
    assert kill_at < rejoin_at
    assert recs[kill_at][1]["replica"] == victim
    assert recs[kill_at][1]["live"] == 1
    assert recs[rejoin_at][1] == {"replica": new_slot, "reason": "rejoin",
                                  "live": 2}
    before = {a["replica"] for n, a in recs[:kill_at] if n == "serve.route"}
    between = {a["replica"] for n, a in recs[kill_at:rejoin_at]
               if n == "serve.route"}
    after = {a["replica"] for n, a in recs[rejoin_at:] if n == "serve.route"}
    assert victim in before
    assert victim not in between and victim not in after
    assert between
    assert new_slot in after


def test_scale_down_drains_before_stopping(binary_model):
    bst, x, _ = binary_model
    router, _ = _make_router(bst, n_replicas=3)
    try:
        assert router.live_replicas() == 3
        assert router.scale_to(1, reason="scale_down") == 1
        out, _ = router.submit(x[:4], "value")
        assert out.shape[0] == 4
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------


def test_autoscaler_cycle_reconstructible_from_timeline(binary_model, tracer):
    bst, _, _ = binary_model
    router, metrics = _make_router(bst, n_replicas=1)
    scaler = serve.AutoScaler(router, metrics, min_replicas=1, max_replicas=2,
                              p99_high_ms=50.0, p99_low_ms=5.0, up_after=2,
                              down_after=3)
    try:
        for _ in range(10):
            metrics.observe_request(0.2, 1)  # 200 ms: p99 over the bar
        assert scaler.tick() == 0  # one hot tick is not enough
        assert scaler.tick() == 1
        assert router.live_replicas() == 2
        assert scaler.tick() == 0  # hot, but at max_replicas
        metrics.reset()
        for _ in range(10):
            metrics.observe_request(0.0005, 1)
        assert scaler.tick() == 0
        assert scaler.tick() == 0
        assert scaler.tick() == -1
        assert router.live_replicas() == 1
    finally:
        router.shutdown()
    scale = [r["attrs"] for r in tracer.records()
             if r["name"] == "serve.scale"]
    assert [e["direction"] for e in scale] == ["up", "down"]
    up, down = scale
    assert (up["from_replicas"], up["to_replicas"]) == (1, 2)
    assert up["reason"] == "p99_high" and up["p99_ms"] > 50.0
    assert (down["from_replicas"], down["to_replicas"]) == (2, 1)
    assert down["reason"] == "idle" and down["p99_ms"] < 5.0
    live = 0
    for r in tracer.records():
        if r["name"] == "serve.replica_up":
            live += 1
            assert r["attrs"]["live"] == live
        elif r["name"] == "serve.replica_down":
            live -= 1
            assert r["attrs"]["live"] == live
    assert live == 0
    assert not obs.validate_trace_records(tracer.records(),
                                          known_names=obs.TRACE_NAMES)


def test_autoscaler_queue_depth_trigger(binary_model):
    bst, _, _ = binary_model
    router, metrics = _make_router(bst, n_replicas=1)
    scaler = serve.AutoScaler(router, metrics, max_replicas=2, queue_high=1,
                              up_after=1, p99_high_ms=1e9)
    try:
        router.queue_depth = lambda: 3  # a stuck backlog
        assert scaler.tick() == 1
        assert router.live_replicas() == 2
    finally:
        del router.queue_depth
        router.shutdown()


def test_autoscaler_thread_starts_and_stops(binary_model):
    bst, _, _ = binary_model
    router, metrics = _make_router(bst, n_replicas=1)
    scaler = serve.AutoScaler(router, metrics, interval_s=0.01)
    try:
        assert scaler.start() is scaler
        time.sleep(0.05)
        scaler.stop()
        assert scaler._thread is None
        with pytest.raises(ValueError, match="min_replicas"):
            serve.AutoScaler(router, metrics, min_replicas=3, max_replicas=2)
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# canary publish
# ---------------------------------------------------------------------------


def test_canary_bad_candidate_rolls_back(binary_model, tracer):
    bst, x, y = binary_model
    metrics = serve.ServeMetrics()
    reg = serve.ModelRegistry(device=CPU, metrics=metrics)
    ctl = serve.CanaryController(reg, metrics=metrics)
    verdict = ctl.publish(bst, x[:100], y[:100])
    assert verdict == {"promoted": True, "version": 1, "reason": "cold_start"}
    rng = np.random.RandomState(7)
    bad = tx.train({"objective": "binary:logistic", "max_depth": 3,
                    "eta": 0.3}, tx.RayDMatrix(x, rng.permutation(y)), 4,
                   ray_params=RP, device=CPU)
    ref = _ref(bst, x[:9], "value")
    verdict = ctl.publish(bad, x[:100], y[:100], shadow_x=x[:16])
    assert verdict["promoted"] is False
    assert verdict["reason"] == "metric_regression"
    assert verdict["version"] == 1
    assert verdict["candidate_metric"] > verdict["gate"]
    assert verdict["shadow_mean_abs_delta"] > 0
    assert reg.version == 1
    with reg.lease() as entry:
        assert np.array_equal(entry.predictor.predict(x[:9], "value"), ref)
    assert metrics.canary_rollbacks == 1 and metrics.canary_promotions == 1
    names = _names(tracer)
    assert "serve.shadow" in names and "serve.rollback" in names
    assert names.index("serve.shadow") < names.index("serve.rollback")


def test_canary_good_candidate_promotes(binary_model, tracer):
    bst, x, y = binary_model
    metrics = serve.ServeMetrics()
    reg = serve.ModelRegistry(device=CPU, metrics=metrics)
    ctl = serve.CanaryController(reg, metrics=metrics)
    ctl.publish(bst, x[:100], y[:100])
    refreshed = serve.refresh(
        bst, {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3},
        tx.RayDMatrix(x, y), 2, ray_params=RP, device=CPU)
    assert refreshed.num_trees > bst.num_trees
    verdict = ctl.publish(refreshed, x[:100], y[:100])
    assert verdict["promoted"] is True and verdict["reason"] == "gate_pass"
    assert verdict["candidate_metric"] <= verdict["gate"]
    assert verdict["version"] == reg.version == 2
    with reg.lease() as entry:
        assert np.array_equal(entry.predictor.predict(x[:9], "value"),
                              _ref(refreshed, x[:9], "value"))
    assert metrics.canary_promotions == 2 and metrics.canary_rollbacks == 0
    snap = metrics.snapshot()
    assert snap["canary_promotions"] == 2 and snap["canary_rollbacks"] == 0
    assert "serve.promote" in _names(tracer)


def test_binary_logloss_matches_definition():
    y = np.array([0, 1, 1, 0], np.float32)
    p = np.array([0.1, 0.8, 0.6, 0.0], np.float32)
    pc = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
    want = -np.mean(y * np.log(pc) + (1 - y) * np.log(1 - pc))
    assert serve.binary_logloss(y, p) == pytest.approx(want, rel=1e-12)


def test_tracer_ring_buffer_jsonl_and_recovery_time(tmp_path):
    tr = obs.Tracer(capacity=3, enabled=True, trace_dir=str(tmp_path),
                    rank=0)
    with tr.span("round", round=0) as attrs:
        attrs["rows"] = 5
        tr.event("failure.detected")
    tr.event("recovered")
    tr.event("serve.route", replica=1)
    recs = tr.records()
    assert len(recs) == 3 and tr.dropped == 1  # the oldest dropped
    assert not obs.validate_trace_records(recs, known_names=obs.TRACE_NAMES)
    assert obs.validate_trace_records([{"kind": "event", "name": "nope",
                                        "ts": 0.0, "seq": 1}],
                                      known_names=obs.TRACE_NAMES)
    assert tr.export_jsonl(str(tmp_path / "t.jsonl")) == 3
    lines = (tmp_path / "trace-rank0.jsonl").read_text().splitlines()
    assert len(lines) == 4  # streamed at emission, before the ring dropped
    full = [{"kind": "event", "name": "failure.detected", "ts": 1.0,
             "seq": 1},
            {"kind": "event", "name": "recovered", "ts": 3.5, "seq": 2}]
    assert obs.recovery_time_s(full) == 2.5
    tr.close()
    inner = obs.Tracer(enabled=True, trace_dir="")
    with obs.use_tracer(inner):
        obs.get_tracer().event("serve.scale")
    assert [r["name"] for r in inner.records()] == ["serve.scale"]
