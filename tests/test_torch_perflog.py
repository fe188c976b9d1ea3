"""The port's ``perflog`` and ``serve --json``, on the CPU.

The cases of ``tests/test_perflog.py`` run on the port's copy (append,
read and ``latest`` round trip; a corrupt, non-list or empty file reads
as an empty history and is started afresh; the update loop's records,
the ``refresh`` section of ``serve --json``, with their keys and an
epoch equal to its scratch rebuild).  A history written by either
package's module is read by the other's, and appends from both land in
one history.  ``serve --json PATH`` appends the run's records and
prints the previous one of each section; without ``--json`` it writes
nothing.
"""
import argparse
import json

import pytest

from repro import perflog as jperflog
from repro_torch import perflog
from repro_torch.core.dist_engine import EpochedEngine
from repro_torch.core.graph import road_like
from repro_torch.launch import serve


def test_roundtrip_and_latest(tmp_path):
    p = str(tmp_path / "bench.json")
    assert perflog.read_records(p) == []
    assert perflog.latest(p) is None
    perflog.append_records(p, [{"section": "serve", "graph": "g1",
                                "us_per_query": 10.0}])
    perflog.append_records(p, [{"section": "serve", "graph": "g2",
                                "us_per_query": 20.0},
                               {"section": "refresh", "graph": "g1",
                                "refresh_s": 0.5}])
    recs = perflog.read_records(p)
    assert len(recs) == 3
    assert recs[0]["graph"] == "g1"
    assert perflog.latest(p, section="serve")["graph"] == "g2"
    assert perflog.latest(p, section="serve",
                          graph="g1")["us_per_query"] == 10.0
    assert perflog.latest(p, section="nope") is None
    with open(p) as f:
        assert json.load(f) == recs


@pytest.mark.parametrize("content", [
    "{not json at all",                       # corrupt
    '{"a": 1}',                               # valid JSON, not a list
    "",                                       # empty file
])
def test_corrupt_file_degrades_to_empty(tmp_path, content):
    p = str(tmp_path / "bench.json")
    with open(p, "w") as f:
        f.write(content)
    assert perflog.read_records(p) == []
    assert perflog.latest(p, section="serve") is None
    perflog.append_records(p, [{"section": "serve"}])
    assert perflog.read_records(p) == [{"section": "serve"}]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_histories_cross_between_the_packages(tmp_path, writer):
    p = str(tmp_path / "bench.json")
    first, other = ((jperflog, perflog) if writer == "reference"
                    else (perflog, jperflog))
    first.append_records(p, [{"section": "serve", "graph": "g",
                              "us": 1.0}])
    assert other.read_records(p) == first.read_records(p)
    other.append_records(p, [{"section": "serve", "graph": "g", "us": 2.0}])
    for mod in (perflog, jperflog):
        assert [r["us"] for r in mod.read_records(p)] == [1.0, 2.0]
        assert mod.latest(p, section="serve", graph="g")["us"] == 2.0


def test_update_loop_record_shape():
    """The port's update loop: one ``refresh`` record an update batch
    through ``serve.records``, with the keys the history relies on and
    array-exact parity between refresh and scratch rebuild."""
    g = road_like(300, seed=21)
    engine = EpochedEngine(g, device="cpu")
    args = argparse.Namespace(nodes=300, graph=None, seed=21,
                              batch_size=32, validate=8, update_batches=1,
                              update_frac=0.03)
    recs = serve.records(args, {"refresh": serve.update_loop(engine, args)})
    assert len(recs) == 1
    rec = recs[0]
    assert {"section", "graph", "device", "epoch", "update_frac",
            "apply_s", "refresh_s", "scratch_pipeline_s",
            "scratch_reweight_s", "refresh_over_scratch",
            "refresh_over_reweight", "post_refresh_mismatches",
            "scratch_match", "serve_batch_ms", "n_updates", "dirty_frags",
            "dirty_frag_frac", "dirty_pieces", "decrease_only",
            "stage_timings"} <= set(rec)
    assert {"classify", "frag_fw", "super_fw", "hub", "pieces"} \
        <= set(rec["stage_timings"])
    assert (rec["section"], rec["graph"], rec["epoch"]) == (
        "refresh", "road300", 1)
    assert rec["post_refresh_mismatches"] == 0
    assert rec["scratch_match"] is True
    assert json.dumps(rec)


def test_serve_json_appends_and_prints_the_previous(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--nodes", "400", "--batches", "1",
            "--batch-size", "16", "--validate", "4"]
    assert serve.parse_args(argv).json == ""
    assert serve.main(argv) == 0
    assert list(tmp_path.iterdir()) == []          # default: no history
    hist = str(tmp_path / "h" / "serve.json")
    (tmp_path / "h").mkdir()
    assert serve.main(argv + ["--json", hist]) == 0
    assert "previous serve record: None" in capsys.readouterr().out
    assert serve.main(argv + ["--json", hist, "--paths"]) == 0
    out = capsys.readouterr().out
    recs = perflog.read_records(hist)
    assert [r["section"] for r in recs] == ["host_build", "serve",
                                            "host_build", "serve",
                                            "serve_paths"]
    assert f"previous serve record: {json.dumps(recs[1])}" in out
    assert f"previous host_build record: {json.dumps(recs[0])}" in out
    assert recs[3]["graph"] == "road400" and recs[3]["mode"] == "planner"
    assert recs[4]["mismatches"] == 0
