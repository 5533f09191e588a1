"""Observability of the torch port against the JAX package: the metrics
registry (instruments, snapshots, merge rules, quantiles), the span
tracer and its Chrome trace, the exposition (Prometheus text, the HTTP
endpoint on an ephemeral port, snapshot files) and the ``torch.profiler``
hooks. The registry and the tracer are pure Python in both packages, so
the same calls must give equal snapshots, texts and files; a snapshot or
a trace written by either package loads in the other."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.serve.server import ServerMetrics

torch.set_num_threads(1)


def _exercise(o):
    """The same calls on one package's registry; returns the registry."""
    reg = o.MetricsRegistry()
    reg.counter("serve.requests").inc()
    reg.counter("serve.requests").inc(4)
    reg.counter("curvature.folds").inc(2)
    reg.gauge("serve.queue_depth").set(3)
    reg.gauge("curvature.downdate_margin").set(0.25)
    reg.gauge("curvature.condest").set(12.5)
    h = reg.histogram("serve.request_latency_s")
    for v in (3e-6, 1e-3, 0.5, 2.0, 1e3):
        h.observe(v)
    reg.histogram("custom", buckets=[1.0, 2.0]).observe(1.5)
    return reg


def test_registry_snapshot_equals_jax():
    t, j = _exercise(tobs).snapshot(), _exercise(jobs).snapshot()
    assert t == j
    assert tobs.default_buckets() == jobs.default_buckets()
    assert len(t["histograms"]["serve.request_latency_s"]["counts"]) == 28
    reg = _exercise(tobs)
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert tobs.registry() is tobs.registry()


def test_merge_and_quantiles_equal_jax():
    """Counters add, histograms add bucket by bucket, gauges add except
    the max (``_age``, ``condest``, ``verdict`` …) and min (``_margin``)
    suffixes; quantiles are bucket upper bounds, nan when empty, inf in
    the overflow bucket."""
    a = _exercise(tobs).snapshot()
    b = _exercise(jobs).snapshot()
    b["gauges"].update({"curvature.downdate_margin": 0.01,
                        "curvature.condest": 40.0,
                        "serve.queue_oldest_age_s": 2.0,
                        "health.verdict": 1.0})
    a["gauges"].update({"serve.queue_oldest_age_s": 5.0,
                        "health.verdict": 0.0})
    t, j = tobs.merge([a, b, {}]), jobs.merge([a, b, {}])
    assert t == j
    g = t["gauges"]
    assert (g["curvature.downdate_margin"], g["curvature.condest"],
            g["serve.queue_oldest_age_s"], g["health.verdict"],
            g["serve.queue_depth"]) == (0.01, 40.0, 5.0, 1.0, 6.0)
    hist = t["histograms"]["serve.request_latency_s"]
    for q in (0.0, 0.1, 0.5, 0.8, 0.99, 1.0):
        assert tobs.quantile(hist, q) == jobs.quantile(hist, q)
    assert tobs.quantile(hist, 1.0) == float("inf")
    assert np.isnan(tobs.quantile({"count": 0, "counts": [], "bounds": []},
                                  0.5))
    bad = {"histograms": {"custom": {"bounds": [9.0], "counts": [0, 0],
                                     "sum": 0.0, "count": 0}}}
    with pytest.raises(ValueError, match="bucket bounds differ"):
        tobs.merge([a, bad])


def test_prometheus_text_equals_jax():
    snap = _exercise(tobs).snapshot()
    text = tobs.prometheus_text(snap)
    assert text == jobs.prometheus_text(snap)
    assert "# TYPE serve_requests counter\nserve_requests 5" in text
    assert 'serve_request_latency_s_bucket{le="+Inf"} 5' in text


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshot_files_load_in_the_other_package(direction, tmp_path):
    """``write_snapshot`` (health report embedded) from one package; the
    other reads the JSON and merges it with its own snapshot."""
    path = str(tmp_path / "snap" / "m.json")
    writer, reader = (tobs, jobs) if direction == "port_to_jax" \
        else (jobs, tobs)
    reg = _exercise(writer)
    mon = writer.HealthMonitor(reg)
    mon.evaluate()
    writer.write_snapshot(path, reg.snapshot(), health=mon.report())
    with open(path) as f:
        doc = json.load(f)
    assert doc["health"]["verdict"] == "ok"
    merged = reader.merge([doc, _exercise(reader).snapshot()])
    assert merged["counters"]["serve.requests"] == 10
    assert merged["histograms"]["serve.request_latency_s"]["count"] == 10


def test_http_endpoint_serves_metrics_json_and_health():
    reg = _exercise(tobs)
    mon = tobs.HealthMonitor(reg)
    srv, port = tobs.start_metrics_server(
        reg, port=0, extra_snapshots=lambda: [_exercise(jobs).snapshot()],
        health=mon.report)
    try:
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10) \
            .read().decode()
        assert "serve_requests 10" in text         # merged with the extra
        doc = json.loads(urllib.request.urlopen(base + "/metrics.json",
                                                timeout=10).read())
        assert doc["health"]["verdict"] == "ok"
        assert doc["counters"]["curvature.folds"] == 4
        rep = json.loads(urllib.request.urlopen(base + "/health",
                                                timeout=10).read())
        assert rep == mon.report()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()


def test_tracer_spans_export_and_ingest_in_jax(tmp_path):
    """Spans (timed and added), the pending drain, the Chrome trace file;
    the JAX tracer ingests the port's spans and exports them unchanged,
    and the port's ingests that export."""
    tr = tobs.Tracer(pid=7)
    with tr.span("fold", cat="adapt", trace="t1", args={"k": 2}):
        pass
    tr.add("device_solve", cat="solve", ts_us=1.0, dur_us=2.0, tid=3)
    drained = tr.drain()
    assert [e["name"] for e in drained] == ["fold", "device_solve"]
    assert tr.drain() == []
    ev = tr.events()[0]
    assert (ev["ph"], ev["pid"], ev["args"]) == ("X", 7, {"k": 2,
                                                         "trace": "t1"})
    path = str(tmp_path / "t.json")
    assert tr.export(path) == 2
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"] == \
        tr.events()
    jt = jobs.Tracer(pid=9)
    jt.ingest(doc["traceEvents"])
    assert jt.export(str(tmp_path / "j.json")) == 2
    assert jt.events() == tr.events()
    with open(tmp_path / "j.json") as f:          # and back
        back = tobs.Tracer()
        back.ingest(json.load(f)["traceEvents"])
    assert back.events() == tr.events() and back.drain() == []
    bounded = tobs.Tracer(max_events=3)
    for i in range(5):
        bounded.add(f"s{i}", ts_us=float(i), dur_us=1.0)
    assert [e["name"] for e in bounded.events()] == ["s2", "s3", "s4"]


def test_server_metrics_report_like_jax():
    """``ServerMetrics(registry=, prefix=)`` records into the same series,
    with the same counts, as the reference's."""
    from repro.serve.server import ServerMetrics as JServerMetrics
    regs = []
    for cls, o in ((ServerMetrics, tobs), (JServerMetrics, jobs)):
        reg = o.MetricsRegistry()
        m = cls(window=2, registry=reg, prefix="serve")
        for i in range(3):
            m.record(1.0 + i, 1.5 + i, 10, queue_s=0.1 if i else None)
        assert m.served == 3 and len(m.latencies_s()) == 2
        regs.append(reg.snapshot())
    assert regs[0] == regs[1]
    assert regs[0]["counters"] == {"serve.requests": 3, "serve.tokens": 30}
    assert regs[0]["histograms"]["serve.queue_wait_s"]["count"] == 2


def test_profile_hooks_write_a_chrome_trace(tmp_path):
    """``ProfileHooks`` on ``torch.profiler``: a labelled range a solve and
    one Chrome trace at ``stop``; without a directory, no-ops."""
    off = tobs.ProfileHooks(None)
    off.start()
    with off.step(step=0):
        pass
    off.stop()
    assert off.trace_path is None
    hooks = tobs.ProfileHooks(str(tmp_path / "prof"))
    hooks.start()
    for i in range(2):
        with hooks.step(step=i):
            torch.ones(64, 64) @ torch.ones(64, 64)
    hooks.stop()
    with open(hooks.trace_path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"coalesced_solve#0", "coalesced_solve#1"} <= names
    hooks.stop()                      # stopping twice is a no-op
