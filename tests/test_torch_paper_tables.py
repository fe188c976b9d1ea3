"""The port's paper tables (``repro_torch.paper``) against the
reference's harness (``benchmarks/paper_tables.py``, unchanged) on the
CPU, at small sizes.

The reference runs at the port's sizes by monkeypatching its
``_graphs`` (the graphs are ``road_like(n, seed=n)`` in both).  Every
column but the timing ones (``time_s``, ``prep_s``, ``us_per_query``,
``*_s``, the live latencies) must be equal, and the header rows
identical:

* Tables I, III-VI and Exp-4 at (400, 700) nodes: every row;
* Exp-5 at 400: the ``grid_distance_queries`` buckets, the (bucket,
  algo) row keys, and each bucket's ``disland-batched`` answers ==
  the reference's ``serve_step`` == Dijkstra;
* Exp-7: ``dirty_frag_frac``, ``decrease_only`` and ``match`` (== 1);
* Exp-8: ``mean_hops`` and ``exact`` (== 1);
* Exp-9 (one rate, 1 s a cell, cache on, refresh on and off): the
  reference's columns, ``oracle_bad == 0``;
* Exp-10 at road2000: ``n``, ``S``, ``levels``, ``nsf``, ``S2``, the
  overlay bytes and ``oracle_bad`` (== 0), and the ``host_build`` row's
  graph and workers;
* the runner: ``_perf_records`` == ``benchmarks.run._perf_records`` on
  one row a section; ``--json`` appends, no ``--json`` writes nothing;
  ``# <fn> took`` lines.
"""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import paper_tables as ref_tables  # noqa: E402
from benchmarks import run as ref_run  # noqa: E402
from repro.core.device_engine import build_device_index as ref_build_dix  # noqa: E402
from repro.core.device_engine import serve_step as ref_serve_step  # noqa: E402
from repro.core.graph import road_like as ref_road_like  # noqa: E402
from repro.core.supergraph import build_index as ref_build_index  # noqa: E402
from repro.data.queries import grid_distance_queries as ref_grid  # noqa: E402
from repro_torch.core import dijkstra  # noqa: E402
from repro_torch.core.graph import road_like  # noqa: E402
from repro_torch.data.queries import grid_distance_queries  # noqa: E402
from repro_torch.paper import run as port_run  # noqa: E402
from repro_torch.paper import tables  # noqa: E402

torch.set_num_threads(1)

HOST_SIZES = (400, 700)
EXP_SIZES = (400,)

#: timing columns by header name (never compared)
TIMED = {"time_s", "prep_s", "us_per_query", "refresh_s", "reweight_s",
         "pipeline_s", "ratio_vs_pipeline", "build_s", "device_s",
         "wall_s", "achieved_qps", "p50_ms", "p99_ms", "hit_rate",
         "mean_occ", "max_gap_ms", "stale_resp", "epochs"}


def _ref_graphs(sizes):
    def graphs(_sizes=None):
        for n in sizes:
            yield (f"road{n // 1000}k" if n >= 1000 else f"road{n}",
                   ref_road_like(n, seed=n))
    return graphs


def _untimed(rows):
    """Rows with every timing column blanked (by its header's name)."""
    out, header = [], None
    for row in rows:
        parts = row.split(",")
        if parts[1] == "graph":
            header = parts
            out.append(parts)
            continue
        out.append(["" if header[i] in TIMED else p
                    for i, p in enumerate(parts)])
    return out


def _run_both(monkeypatch, name, sizes, **kw):
    monkeypatch.setattr(ref_tables, "_graphs", _ref_graphs(sizes))
    want, got = [], []
    getattr(ref_tables, name)(want)
    getattr(tables, name)(got, sizes=sizes, **kw)
    return got, want


@pytest.mark.parametrize("name", [
    "table1_landmark_overhead", "table3_agents", "table4_partitions",
    "table5_hybrid_covers", "table6_super_graphs", "exp4_preprocessing"])
def test_host_table_rows_equal_the_reference(name, monkeypatch):
    got, want = _run_both(monkeypatch, name, HOST_SIZES)
    assert got[0] == want[0]
    assert len(got) == len(want) > 1
    assert _untimed(got) == _untimed(want)


def test_exp5_buckets_row_keys_and_batched_answers(monkeypatch):
    answers: dict = {}
    got, want = _run_both(monkeypatch, "exp5_query_latency", EXP_SIZES,
                          device="cpu", answers=answers)
    assert got[0] == want[0]
    assert ([r.split(",")[1:4] for r in got[1:]]
            == [r.split(",")[1:4] for r in want[1:]])
    n = EXP_SIZES[0]
    g, g_ref = road_like(n, seed=n), ref_road_like(n, seed=n)
    buckets = grid_distance_queries(g, n_per_set=40, n_sets=6, seed=1)
    ref_buckets = ref_grid(g_ref, n_per_set=40, n_sets=6, seed=1)
    assert list(buckets) == list(ref_buckets)
    assert all(np.array_equal(buckets[b], ref_buckets[b]) for b in buckets)
    assert sorted(answers) == [f"Q{b}" for b in buckets]
    rdix = ref_build_dix(ref_build_index(g_ref))
    ref_step = jax.jit(lambda s, t: ref_serve_step(rdix, s, t))
    for b, pairs in buckets.items():
        pairs_got, served = answers[f"Q{b}"]
        assert np.array_equal(pairs_got, pairs)
        ref = np.asarray(ref_step(
            jnp.asarray(pairs[:, 0], jnp.int32),
            jnp.asarray(pairs[:, 1], jnp.int32)))
        oracle = np.asarray([dijkstra.pair(g, int(s), int(t))
                             for s, t in pairs], np.float32)
        assert np.array_equal(served, ref)
        assert np.array_equal(served, oracle)


def test_exp7_refresh_matches_the_reference(monkeypatch):
    got, want = _run_both(monkeypatch, "exp7_incremental_refresh",
                          EXP_SIZES, device="cpu")
    assert got[0] == want[0]
    assert len(got) == len(want) == 4
    # graph, round, update_frac, dirty_frag_frac, decrease_only, match
    cols = (1, 2, 3, 4, 5, 10)
    assert ([[r.split(",")[i] for i in cols] for r in got[1:]]
            == [[r.split(",")[i] for i in cols] for r in want[1:]])
    assert all(r.split(",")[10] == "1" for r in got[1:])


def test_exp8_paths_match_the_reference(monkeypatch):
    got, want = _run_both(monkeypatch, "exp8_path_reconstruction",
                          EXP_SIZES, device="cpu")
    assert got[0] == want[0]
    # graph, algo, mean_hops, exact
    cols = (1, 2, 4, 5)
    assert ([[r.split(",")[i] for i in cols] for r in got[1:]]
            == [[r.split(",")[i] for i in cols] for r in want[1:]])
    assert [r.split(",")[5] for r in got[1:]] == ["1", "1", "1"]


class _HeaderOnly(Exception):
    pass


def test_exp9_columns_and_epoch_oracle(monkeypatch):
    """The reference's header (its run stopped right after writing it)
    and two port cells, each 0 bad against its epochs' oracle."""
    def stop(_sizes=None):
        raise _HeaderOnly
        yield
    monkeypatch.setattr(ref_tables, "_graphs", stop)
    want: list = []
    with pytest.raises(_HeaderOnly):
        ref_tables.exp9_sustained_load(want)
    got: list = []
    tables.exp9_sustained_load(got, sizes=EXP_SIZES, device="cpu",
                               rates=(300.0,), caches=(True,),
                               refreshes=(True, False), seconds=1.0)
    assert got[0] == want[0]
    header = got[0].split(",")
    rows = [dict(zip(header, r.split(","))) for r in got[1:]]
    assert [(r["rate_qps"], r["cache"], r["refresh"]) for r in rows] == [
        ("300", "1", "1"), ("300", "1", "0")]
    assert all(r["oracle_bad"] == "0" for r in rows)
    assert int(rows[0]["epochs"]) >= 1 and rows[1]["epochs"] == "1"


def test_exp10_structure_matches_the_reference(monkeypatch):
    monkeypatch.setenv("EXP10_GRAPHS", "road2000")
    want: list = []
    ref_tables.exp10_scale(want)
    monkeypatch.delenv("EXP10_GRAPHS")
    got: list = []
    tables.exp10_scale(got, graphs="road2000", device="cpu")
    assert got[:2] == want[:2]
    header = got[0].split(",")
    keep = [header.index(c) for c in (
        "graph", "n", "S", "levels", "nsf", "S2", "overlay_bytes",
        "overlay_dense_bytes", "oracle_bad")]
    row = {r.split(",")[0]: r.split(",") for r in got[2:]}
    ref_row = {r.split(",")[0]: r.split(",") for r in want[2:]}
    assert [row["exp10"][i] for i in keep] == [
        ref_row["exp10"][i] for i in keep]
    assert row["exp10"][header.index("oracle_bad")] == "0"
    assert row["host_build"][:3] == ref_row["host_build"][:3]


_FIXTURE_ROWS = [
    "exp5,graph,bucket,algo,us_per_query",
    "exp5,road6k,Q3,disland-batched,12.25",
    "exp5,road6k,Q1,ch,0.0",
    "exp8,road2k,serve-paths,76.1,20.4,1",
    "exp9,road2k,500,1,0,498,2.1,6.3,0.612,0.011,1,0,27.7,0",
    "exp10,road64k,61927,4613,3,6,2139,150000000,170000000,41.2,60.1,"
    "15.20,12.44,0",
    "host_build,road64k,1,41.2031",
    "exp7,road2k,1,0.02,0.111,0,0.036,0.061,0.112,0.319,1",
    "table3,road1k,950,120,0.126,300,0.316,0.02",
    "# exp5_query_latency took 3.2s",
]


def test_perf_records_equal_the_reference():
    assert port_run._perf_records(_FIXTURE_ROWS) == \
        ref_run._perf_records(_FIXTURE_ROWS)
    assert len(port_run._perf_records(_FIXTURE_ROWS)) == 7


def test_runner_json_appends_only_when_asked(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("EXP10_GRAPHS", "road2000")
    monkeypatch.chdir(tmp_path)
    assert port_run.main(["--only", "exp10", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert os.listdir(tmp_path) == []
    assert out[0].startswith("exp10,graph,n,S,levels")
    assert any(line.startswith("# exp10_scale took ") for line in out)
    assert out[-1].startswith("# total ")
    hist = tmp_path / "hist.json"
    for n in (2, 4):
        port_run.main(["--only", "exp10", "--device", "cpu", "--json",
                       str(hist)])
        recs = json.loads(hist.read_text())
        assert len(recs) == n
    assert [r["section"] for r in recs] == ["host_build", "exp10_scale"] * 2
    assert recs[1]["oracle_bad"] == 0 and recs[1]["graph"] == "road2000"


def test_runner_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.main(["--only", "table3"])
