"""The harness on the CPU at a small size, end to end: sound runs of each
cell come out correct, and each fault the cells can have, planted in the
timed path, makes ``correct`` false."""
import numpy as np
import pytest

import portbench_small as small

from repro_torch.core import dist_engine

MIXES = {"uniform": [{"kind": "uniform"}],
         "walk": [{"kind": "walk", "steps": 6}],
         "mixed": [{"kind": "zipf", "a": 1.2, "share": 1},
                   {"kind": "walk", "steps": 3, "share": 1},
                   {"kind": "uniform", "share": 2}]}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("kind", ["batch", "paths"])
def test_sound_run_is_correct(kind, mix):
    res = small.run(kind, pairs=MIXES[mix])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "setup_compiled"}
    assert list(res)[-4] == "checks"        # then the private keys
    assert res["setup_compiled"] is False and res["_compiled"] == []


@pytest.mark.parametrize("kind,rate", [("batch", "queries_per_s"),
                                       ("paths", "paths_per_s")])
def test_untraced_run_reports_its_end_to_end_metrics(kind, rate):
    res = small.run(kind, seconds=2.0)
    m = res["metrics"]
    assert set(m) == {"setup_s", rate}
    assert m[rate]["value"] > 0 and m["setup_s"]["value"] > 0
    assert res["_e2e"][rate] == m[rate]["value"]


def test_traced_run_reads_the_builds_and_the_spans():
    res = small.run("paths", seconds=2.0, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["build.device_s"]["value"] > 0 and m["build.host_s"]["value"] > 0
    assert 0 < m["paths.unwind_share"]["value"] < 100
    # no card: the device readers find nothing and say nothing
    assert "device.idle_share.batch" not in m
    assert "busy_s" not in res["device"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    real = dist_engine.QueryPlanner.query

    def half(self, s, t, **kw):
        out = real(self, s, t, **kw)
        h = out.size // 2
        out[h:] = out[:h].mean() if h else out[h:]
        return out
    monkeypatch.setattr(dist_engine.QueryPlanner, "query", half)
    res = small.run("batch")
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] > 0


def test_answer_altered_where_produced_is_caught(monkeypatch):
    real_cross = dist_engine.serve_cross

    def cross(*a, **kw):
        return real_cross(*a, **kw) + 1.0
    monkeypatch.setattr(dist_engine, "serve_cross", cross)
    res = small.run("batch", check=64)
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] > 0


def test_path_altered_where_produced_is_caught(monkeypatch):
    from repro_torch.core import paths

    real = paths.PathUnwinder.unwind_many

    def altered(self, s, t, dist, wit):
        out = real(self, s, t, dist, wit)
        return [p[:1] + p[2:] if p is not None and len(p) > 2 else p
                for p in out]
    monkeypatch.setattr(paths.PathUnwinder, "unwind_many", altered)
    res = small.run("paths")
    assert not res["correct"]
    assert res["checks"]["bad_paths"]["value"] > 0


def test_results_are_the_same_for_a_seed():
    a = small.run("batch", seed=2**31 + 5, seconds=0.5)
    b = small.run("batch", seed=2**31 + 5, seconds=0.5)
    assert a["checks"] == b["checks"] and a["correct"]
    assert np.isfinite(a["metrics"]["queries_per_s"]["value"])
