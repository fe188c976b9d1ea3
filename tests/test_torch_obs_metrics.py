"""The port's observability copies (``repro_torch.obs``) against the
reference's (``repro.obs``).

The same scripted operations go through both packages' metrics
registries, histograms, slow-query logs and exporters; the snapshots,
the Prometheus text, the percentiles and the files written must be
equal.  The port's primitives keep the reference's thread-safety
contract, and its HTTP endpoint serves on a free port.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs


def _script(obs):
    """One scripted run of every primitive; returns the registry."""
    reg = obs.MetricsRegistry()
    reg.counter("serve.cache.hits").inc(5)
    reg.counter("serve.cache.hits").inc()
    reg.counter("serve.tier.label.seconds").inc(0.125)
    reg.gauge("serve.epoch").set(3)
    lab = reg.labeled("serve.batch.flushes")
    lab.inc("deadline", 2)
    lab.inc("full")
    reg.labeled("serve.batch.occupancy").inc(64, 3)
    reg.array_counter("serve.frag_traffic", 6).add(
        np.array([0, 2, 0, 7, 1, 0], np.int64))
    h = reg.histogram("serve.request.latency_s")
    rng = np.random.default_rng(5)
    for x in rng.lognormal(-6.0, 1.0, 2000):
        h.observe(float(x))
    reg.histogram("coarse", growth=1.5, max_buckets=16).observe(1e9)
    return reg


def test_registry_snapshot_and_prometheus_equal_reference():
    treg, jreg = _script(tobs), _script(jobs)
    assert treg.names() == jreg.names()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus() == jreg.prometheus()
    json.dumps(treg.snapshot())


@pytest.mark.parametrize("q", [0, 1, 50, 95, 99, 99.9, 100])
def test_histogram_percentiles_equal_reference(q):
    th = _script(tobs).histogram("serve.request.latency_s")
    jh = _script(jobs).histogram("serve.request.latency_s")
    assert th.percentile(q) == jh.percentile(q)
    assert th.summary(scale=1e3) == jh.summary(scale=1e3)


def test_histogram_since_window_equals_reference():
    out = []
    for obs in (tobs, jobs):
        h = obs.Histogram("lat")
        rng = np.random.default_rng(7)
        for x in rng.uniform(1e-3, 2e-3, 300):
            h.observe(float(x))
        h0 = h.freeze()
        for x in rng.uniform(5e-2, 9e-2, 400):
            h.observe(float(x))
        win = h.since(h0)
        out.append((win.count, win.sum, win.min, win.max,
                    [win.percentile(q) for q in (50, 95, 99)],
                    h.since(h.freeze()).count))
    assert out[0] == out[1]


def test_registry_type_conflict_raises():
    reg = tobs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")
    with pytest.raises(ValueError):
        tobs.Histogram("bad", growth=1.0)


def test_registry_concurrent_increments_exact():
    """N threads on shared counters, labels and histograms lose no
    update (each join bounded)."""
    reg = tobs.MetricsRegistry()
    n_threads, n_iter = 8, 2000
    barrier = threading.Barrier(n_threads)

    def work(tid):
        barrier.wait(timeout=30)
        c, lab, h = (reg.counter("c"), reg.labeled("lab"),
                     reg.histogram("h"))
        for i in range(n_iter):
            c.inc()
            lab.inc(tid % 3)
            h.observe(1e-3 * (1 + (i % 7)))

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    total = n_threads * n_iter
    assert reg.counter("c").value == total
    assert reg.labeled("lab").total == total
    assert reg.histogram("h").count == total


def test_slow_query_log_equals_reference():
    logs = [tobs.SlowQueryLog(n=3), jobs.SlowQueryLog(n=3)]
    for log in logs:
        for i, lat in enumerate([0.01, 0.5, 0.02, 0.3, 0.001, 0.4]):
            log.offer(lat, {"s": i, "t": i + 1, "tier": "planner"})
    assert logs[0].records() == logs[1].records()
    assert [r["latency_ms"] for r in logs[0].records()] == [500.0, 400.0,
                                                            300.0]
    assert logs[0].offered == 6


def test_snapshot_files_equal_reference(tmp_path):
    """write_snapshot's JSON (but its clock) and .prom sidecar, and the
    exporter's final write on stop, as the reference writes them."""
    texts = []
    for name, obs in (("port", tobs), ("ref", jobs)):
        reg = _script(obs)
        path = tmp_path / name / "metrics.json"
        path.parent.mkdir()
        snap = obs.write_snapshot(str(path), reg, extra={"run": "t"})
        on_disk = json.loads(path.read_text())
        assert snap["metrics"] == on_disk["metrics"]
        on_disk.pop("unix_time")
        exp = obs.MetricsExporter(reg, str(path), interval_s=60.0,
                                  extra=lambda: {"slow": []}).start()
        reg.counter("serve.cache.hits").inc(1)
        exp.stop()
        assert exp.writes >= 1
        final = json.loads(path.read_text())
        assert final["metrics"]["serve.cache.hits"] == 7
        final.pop("unix_time")
        texts.append((on_disk, final,
                      path.with_suffix(".prom").read_text()))
    assert texts[0] == texts[1]


def test_chrome_trace_roundtrip_equals_reference(tmp_path):
    tr = tobs.Tracer(enabled=True)
    with tr.span("a", k=1):
        with tr.span("b"):
            pass
    events = tr.events()
    tobs.write_chrome_trace(str(tmp_path / "port.json"), events)
    jobs.write_chrome_trace(str(tmp_path / "ref.json"), events)
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "ref.json").read_text())
    assert tobs.load_chrome_trace(str(tmp_path / "port.json")) == events
    lines = (tmp_path / "port.json").read_text().splitlines()
    (tmp_path / "trunc.json").write_text("\n".join(lines[:-1]))
    assert (tobs.load_chrome_trace(str(tmp_path / "trunc.json"))
            == jobs.load_chrome_trace(str(tmp_path / "trunc.json"))
            == events[:-1])


def test_metrics_http_server_on_a_free_port():
    reg = _script(tobs)
    srv = tobs.MetricsServer(reg, port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            prom = r.read().decode()
        assert prom == reg.prometheus()
        assert "serve_cache_hits 6" in prom
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            js = json.loads(r.read())
        assert js["metrics"] == json.loads(json.dumps(reg.snapshot()))
    finally:
        srv.stop()
