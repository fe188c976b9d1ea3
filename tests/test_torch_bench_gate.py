"""The port's perf gate (``repro_torch.launch.bench_gate``) on the CPU.

The cases of ``tests/test_bench_gate.py`` run on the port's copy: the
fresh measurement is compared to the median of the last N *committed*
records of the same config, so the fresh record must never be able to
join its own baseline, and a malformed committed record must fail
loudly instead of silently shrinking (or unit-mixing) the window.  The
committed history is the port's ``BENCH_torch_serve.json`` (card
records only).  Beside them: the port's helpers give the reference's
windows and messages on the same record lists; ``device_name`` keeps
CPU and card histories apart; and the gate runs end to end on the CPU
against a temporary history (no history passes; the fresh record as
history passes at 1.0 and fails at ``--inject-slowdown 10``).
"""
import importlib.util
import os

import pytest

from repro_torch.launch import bench_gate
from repro_torch.perflog import read_records

ROOT = os.path.join(os.path.dirname(__file__), "..")
_SPEC = importlib.util.spec_from_file_location(
    "ref_bench_gate", os.path.join(ROOT, "scripts", "bench_gate.py"))
ref_gate = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref_gate)

MATCH = {"section": "serve", "graph": "road4000", "mode": "planner"}
H100 = "NVIDIA H100 80GB HBM3"


def _rec(us, **over):
    rec = {"section": "serve", "graph": "road4000", "mode": "planner",
           "us_per_query": us}
    rec.update(over)
    return rec


def test_window_selects_matching_tail():
    recs = ([_rec(9.0 + i) for i in range(8)]
            + [_rec(99.0, mode="fused"),          # different config
               _rec(50.0, section="serve_live",   # different section
                    mode="planner")])
    win = bench_gate.history_window(recs, MATCH, "us_per_query", 5)
    assert win == [12.0, 13.0, 14.0, 15.0, 16.0]


def test_missing_section_fails_loudly():
    recs = [_rec(9.0), {"graph": "road4000", "us_per_query": 9.0}]
    with pytest.raises(SystemExit, match="section"):
        bench_gate.history_window(recs, MATCH, "us_per_query", 5)


def test_matching_record_without_metric_fails_loudly():
    """A record matching every identity key but carrying no numeric
    metric is a half-written entry, not a smaller window."""
    broken = _rec(9.0)
    del broken["us_per_query"]
    with pytest.raises(SystemExit, match="numeric"):
        bench_gate.history_window([_rec(9.0), broken], MATCH,
                                  "us_per_query", 5)
    # bool is not a measurement either (isinstance(True, int) holds)
    with pytest.raises(SystemExit, match="numeric"):
        bench_gate.history_window([_rec(True)], MATCH,
                                  "us_per_query", 5)


def test_missing_graph_fails_loudly():
    """A committed record with a section but no graph key cannot be
    attributed to a scale; it must not silently drop out of any graph's
    window."""
    broken = _rec(9.0)
    del broken["graph"]
    with pytest.raises(SystemExit, match="graph"):
        bench_gate.history_window([_rec(9.0), broken], MATCH,
                                  "us_per_query", 5)


def test_graph_scales_never_mix():
    """road64k records must be invisible to the road4000 window (and
    vice versa)."""
    recs = ([_rec(1.2 + i) for i in range(4)]
            + [_rec(11.9, graph="road64k"), _rec(12.4, graph="road64k")])
    win = bench_gate.history_window(recs, MATCH, "us_per_query", 5)
    assert win == [1.2, 2.2, 3.2, 4.2]
    win64 = bench_gate.history_window(
        recs, {**MATCH, "graph": "road64k"}, "us_per_query", 5)
    assert win64 == [11.9, 12.4]


def test_live_and_offline_sections_never_mix():
    """serve_live p99 records (ms) must be invisible to the offline
    µs/query window and vice versa."""
    recs = [_rec(9.0),
            {"section": "serve_live", "graph": "road4000",
             "mode": "planner", "us_per_query": 9.0, "p99_ms": 30.0}]
    off = bench_gate.history_window(recs, MATCH, "us_per_query", 5)
    assert off == [9.0]
    live = bench_gate.history_window(
        recs, {"section": "serve_live", "graph": "road4000"},
        "p99_ms", 5)
    assert live == [30.0]


def test_fresh_equals_history_rejected(tmp_path):
    """The fresh records file must not alias the committed history —
    else the fresh record joins its own median baseline and the gate
    can never fail."""
    p = tmp_path / "BENCH.json"
    p.write_text("[]")
    with pytest.raises(SystemExit, match="median baseline"):
        bench_gate.ensure_distinct_files(str(p), str(p))
    # a relative-path alias is still the same file
    rel = os.path.relpath(str(p))
    with pytest.raises(SystemExit, match="median baseline"):
        bench_gate.ensure_distinct_files(rel, str(p))
    bench_gate.ensure_distinct_files(str(tmp_path / "fresh.json"),
                                     str(p))    # distinct: fine


def test_fresh_serve_live_requires_tier_fields():
    """A fresh serve_live record missing a per-tier counter fails
    loudly; a complete record passes."""
    full = {f: 0 for f in bench_gate.TIER_FIELDS}
    bench_gate.require_tier_fields(full)            # no raise
    for f in bench_gate.TIER_FIELDS:
        broken = dict(full)
        del broken[f]
        with pytest.raises(SystemExit, match=f):
            bench_gate.require_tier_fields(broken)


def test_fresh_serve_live_requires_hist_fields():
    """A fresh serve_live record must carry histogram-derived latency
    percentiles: all of HIST_FIELDS present AND latency_source ==
    'histogram'.  Missing fields or a sampled-path fallback fail
    loudly."""
    full = {"p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0,
            "latency_source": "histogram", "latency_n": 100}
    bench_gate.require_hist_fields(full)            # no raise
    for f in bench_gate.HIST_FIELDS:
        broken = dict(full)
        del broken[f]
        with pytest.raises(SystemExit, match="histogram"):
            bench_gate.require_hist_fields(broken)
    # present-but-degraded: the report fell back to the sampled path
    with pytest.raises(SystemExit, match="sampled"):
        bench_gate.require_hist_fields(
            {**full, "latency_source": "sampled"})


def test_host_build_window_keyed_section_graph():
    """host_build records gate on wall seconds keyed (section, graph,
    card): serve records (µs/query units) and other graphs' host builds
    must both be invisible to the window."""
    hb = {"section": "host_build", "graph": "road4000", "wall_s": 0.1,
          "device_name": H100}
    recs = [_rec(9.0), hb,
            {**hb, "graph": "road64k", "wall_s": 4.3},
            {**hb, "wall_s": 0.12}]
    win = bench_gate.history_window(
        recs, {"section": "host_build", "graph": "road4000",
               "device_name": H100}, "wall_s", 5)
    assert win == [0.1, 0.12]


def test_host_build_record_without_wall_s_fails_loudly():
    """A matching host_build record with no numeric wall_s is a
    half-written entry — loud failure, not a smaller window."""
    broken = {"section": "host_build", "graph": "road4000",
              "build_workers": 2}
    with pytest.raises(SystemExit, match="numeric"):
        bench_gate.history_window(
            [broken], {"section": "host_build", "graph": "road4000"},
            "wall_s", 5)


def _gate_configs(recs):
    """The gate's match of each section, for every card in ``recs``."""
    cards = sorted({r.get("device_name") for r in recs})
    for card in cards:
        key = {"graph": "road4000", "device_name": card}
        yield ({"section": "serve", "mode": "planner", "backend": "cuda",
                "batch_size": 1024, **key}, "us_per_query")
        live = {"backend": "cuda", "mix": "zipf", "rate_qps": 500.0,
                **key}
        yield ({"section": "serve_live", "cache": "on", "refresh": "on",
                **live}, "p99_ms")
        for metric in ("refresh_max_s", "max_serving_gap_ms"):
            yield ({"section": "serve_refresh", "pipelined": True, **live},
                   metric)
        yield ({"section": "host_build", **key}, "wall_s")


def test_committed_history_is_gate_clean():
    """The repo's own BENCH_torch_serve.json must stay loud-failure-free
    for every config the gate queries, with at least 5 records in each
    window; it holds card records only, each with the card's name and
    power limit beside its numbers."""
    recs = read_records(os.path.join(ROOT, "BENCH_torch_serve.json"))
    assert recs, "committed history unreadable"
    for rec in recs:
        assert rec["backend"] == "cuda", rec
        assert rec["device_name"] not in ("cpu", None), rec
        assert isinstance(rec["power_limit_w"], float), rec
    for match, metric in _gate_configs(recs):
        win = bench_gate.history_window(recs, match, metric, 5)
        assert len(win) == 5, (match, metric, win)


# the same record lists through both packages' helpers: equal windows,
# or SystemExit with the same message
_PARITY_CASES = [
    ([_rec(9.0 + i) for i in range(8)] + [_rec(99.0, mode="fused")],
     MATCH, "us_per_query", 5),
    ([_rec(9.0), {"graph": "road4000", "us_per_query": 9.0}],
     MATCH, "us_per_query", 5),
    ([_rec(9.0), {"section": "serve", "us_per_query": 9.0}],
     MATCH, "us_per_query", 5),
    ([_rec(9.0), {"section": "serve", "graph": "road4000",
                  "mode": "planner"}], MATCH, "us_per_query", 5),
    ([_rec(True)], MATCH, "us_per_query", 5),
    (["not a record"], MATCH, "us_per_query", 5),
    ([_rec(1.0), _rec(2.0, graph="road64k"), _rec(3.0)],
     {**MATCH, "graph": "road64k"}, "us_per_query", 3),
    ([{"section": "host_build", "graph": "road4000", "wall_s": 0.2,
       "build_workers": w} for w in (1, 2, 2)],
     {"section": "host_build", "graph": "road4000"}, "wall_s", 2),
    ([], MATCH, "us_per_query", 5),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except SystemExit as e:
        return ("exit", str(e))


@pytest.mark.parametrize("case", range(len(_PARITY_CASES)))
def test_history_window_matches_reference(case):
    recs, match, metric, last = _PARITY_CASES[case]
    assert _outcome(bench_gate.history_window, recs, match, metric,
                    last) == _outcome(ref_gate.history_window, recs,
                                      match, metric, last)


def test_field_checks_and_aliasing_match_reference(tmp_path):
    assert bench_gate.TIER_FIELDS == ref_gate.TIER_FIELDS
    assert bench_gate.HIST_FIELDS == ref_gate.HIST_FIELDS
    full_tier = {f: 0 for f in ref_gate.TIER_FIELDS}
    full_hist = {"p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0,
                 "latency_source": "histogram", "latency_n": 100}
    tier_cases = [full_tier] + [
        {k: v for k, v in full_tier.items() if k != f}
        for f in ref_gate.TIER_FIELDS] + [{}]
    hist_cases = [full_hist, {**full_hist, "latency_source": "sampled"},
                  {**full_hist, "latency_source": None}] + [
        {k: v for k, v in full_hist.items() if k != f}
        for f in ref_gate.HIST_FIELDS] + [{}]
    for rec in tier_cases:
        assert _outcome(bench_gate.require_tier_fields, rec) == \
            _outcome(ref_gate.require_tier_fields, rec)
    for rec in hist_cases:
        assert _outcome(bench_gate.require_hist_fields, rec) == \
            _outcome(ref_gate.require_hist_fields, rec)
    p = tmp_path / "h.json"
    p.write_text("[]")
    for fresh in (str(p), os.path.relpath(str(p)),
                  str(tmp_path / "f.json")):
        assert _outcome(bench_gate.ensure_distinct_files, fresh, str(p)) \
            == _outcome(ref_gate.ensure_distinct_files, fresh, str(p))


def test_device_name_keeps_cpu_and_card_apart():
    """A CPU record and a card record of one config land in different
    windows, as do two card models: the gate's match carries
    ``device_name`` beside ``backend``."""
    recs = [_rec(4.3, backend="cpu", device_name="cpu"),
            _rec(1.2, backend="cuda", device_name=H100),
            _rec(5.1, backend="cpu", device_name="cpu"),
            _rec(2.9, backend="cuda", device_name="NVIDIA A100-SXM4-40GB"),
            _rec(1.3, backend="cuda", device_name=H100)]
    card = bench_gate.history_window(
        recs, {**MATCH, "backend": "cuda", "device_name": H100},
        "us_per_query", 5)
    assert card == [1.2, 1.3]
    cpu = bench_gate.history_window(
        recs, {**MATCH, "backend": "cpu", "device_name": "cpu"},
        "us_per_query", 5)
    assert cpu == [4.3, 5.1]


def test_defaults_are_the_reference_ci_invocation_on_the_card():
    """Run on the card by default, against the port's own committed
    history, at the reference CI's road4000 configurations."""
    args = bench_gate.parse_args([])
    assert args.device == "cuda"
    assert os.path.basename(args.history) == "BENCH_torch_serve.json"
    assert os.path.basename(args.fresh) == "bench_gate_fresh_torch.json"
    assert (args.nodes, args.batches, args.batch_size, args.validate,
            args.mode, args.last, args.rate, args.live_seconds, args.mix,
            args.live_update_batches, args.build_workers) == (
        4000, 3, 1024, 16, "planner", 5, 500.0, 3.0, "zipf", 1, 2)


_E2E = ["--device", "cpu", "--nodes", "600", "--batches", "5",
        "--batch-size", "64"]


def test_gate_end_to_end_on_cpu(tmp_path, capsys, monkeypatch):
    """The gate's serve section on the CPU: with no history it passes
    and says so; with its fresh record as the history it passes at 1.0
    and fails (exit 1) at ``--inject-slowdown 10``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # one small serve
    monkeypatch.delenv("BENCH_GATE_FACTOR", raising=False)
    hist, fresh = tmp_path / "history.json", tmp_path / "fresh.json"
    argv = _E2E + ["--history", str(hist), "--fresh", str(fresh)]
    assert bench_gate.main(argv) == 0
    out = capsys.readouterr().out
    assert "PASS [us_per_query] (no committed history" in out
    recs = read_records(str(fresh))
    assert [r["section"] for r in recs] == ["host_build", "serve"]
    assert recs[1]["device_name"] == "cpu" and recs[1]["mismatches"] == 0
    fresh.rename(hist)
    assert bench_gate.main(argv) == 0
    out = capsys.readouterr().out
    assert "median of last 1 committed records" in out
    assert "PASS [us_per_query]" in out
    assert bench_gate.main(argv + ["--inject-slowdown", "10"]) == 1
    out = capsys.readouterr().out
    assert "INJECTED 10.0x slowdown" in out and "FAIL" in out
