"""The port's examples, the serve CLI's scale gates, the dry-run report
and the observability A/B, on the CPU.

* Each example (``repro_torch.examples``) runs with ``device="cpu"`` at
  reduced sizes and exits 0; the live examples report 0 mismatches
  against their epochs' Dijkstra oracle.
* ``serve --expect-hierarchy``/``--max-s2-ratio`` pass and fail where
  the reference's do, with the same messages: each case runs the
  port's build (``serve.build``) and the reference's ``_build_engine``
  on the same overlay record (the reference's engine and
  ``_overlay_record`` stand-ins hand it the port's, so only the gates
  differ); the refusal outside ``--mode planner`` is the reference's;
  the port's CLI exits 1 on a failed gate.
* ``launch.dryrun_report`` renders two records made by ``run_cell``.
* ``obs.overhead`` runs one short A/B and appends its record.
"""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.launch import serve as ref_serve
from repro_torch.examples import (elastic_failover, live_serving,
                                  live_traffic, quickstart,
                                  serve_roadgraph, train_lm)
from repro_torch.launch import dryrun, dryrun_report, serve
from repro_torch.obs import overhead

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_on_cpu(capsys):
    assert quickstart.main(device="cpu", nodes=900) == 0
    out = capsys.readouterr().out
    assert "(== serve_step)" in out and "== served distance" in out


def test_serve_roadgraph_on_cpu(capsys):
    assert serve_roadgraph.main(["--device", "cpu", "--nodes", "900",
                                 "--batches", "1", "--batch-size", "64",
                                 "--validate", "8"]) == 0
    assert "validation: 0 mismatches of 8" in capsys.readouterr().out


def test_train_lm_two_steps_on_cpu(tmp_path, capsys):
    assert train_lm.main(["--device", "cpu", "--steps", "2", "--ckpt",
                          str(tmp_path)]) == 0
    assert "loss: first=" in capsys.readouterr().out
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())


def test_live_traffic_on_cpu(capsys):
    assert live_traffic.main(device="cpu", nodes=900, waves=2) == 0
    out = capsys.readouterr().out
    assert out.count("0 mismatches") == 3 and "demo OK" in out


def test_live_serving_on_cpu(capsys):
    assert live_serving.main(device="cpu", nodes=900, requests=600) == 0
    out = capsys.readouterr().out
    assert "0 mismatches — live-serving demo OK" in out


def test_elastic_failover_on_cpu(capsys):
    assert elastic_failover.main(device="cpu") == 0
    assert ("failed at step 25, resumed from 20, finished 40"
            in capsys.readouterr().out)


# ---- serve's scale gates ------------------------------------------------
#: road_like(1400, 23) at 3 levels: S = 238, S2 = 81 (ratio 0.340)
_HIER = ["--nodes", "1400", "--seed", "23", "--hierarchy-levels", "3"]
_DENSE = ["--nodes", "900", "--hierarchy-levels", "1"]


def _port_gate(monkeypatch, argv):
    """(SystemExit message or None, overlay record) of the port's build
    with ``argv``."""
    args = serve.parse_args(["--device", "cpu", *argv])
    seen = {}
    inner = serve._scale_gates

    def spy(a, ov):
        seen["ov"] = ov
        return inner(a, ov)
    monkeypatch.setattr(serve, "_scale_gates", spy)
    try:
        serve.build(args)
        msg = None
    except SystemExit as e:
        msg = str(e)
    return msg, seen["ov"]


def _ref_gate(monkeypatch, argv, ov):
    """SystemExit message or None of the reference's ``_build_engine``
    on the overlay record ``ov``."""
    dix = SimpleNamespace(frag_apsp=torch.zeros(1), d_super=torch.zeros(1))
    engine = SimpleNamespace(ix=SimpleNamespace(timings={}), dix=dix)
    monkeypatch.setattr(ref_serve, "EpochedEngine",
                        lambda *a, **k: engine)
    monkeypatch.setattr(ref_serve, "_overlay_record", lambda e: dict(ov))
    args = serve.parse_args(["--device", "cpu", *argv])
    args.json = ""
    try:
        ref_serve._build_engine(args)
        return None
    except SystemExit as e:
        return str(e)


@pytest.mark.parametrize("argv,fails", [
    (_HIER + ["--expect-hierarchy", "3", "--max-s2-ratio", "0.5"], False),
    (_HIER + ["--expect-hierarchy", "2"], True),
    (_HIER + ["--max-s2-ratio", "0.3"], True),
    (_DENSE + ["--expect-hierarchy", "1", "--max-s2-ratio", "0.3"], False),
    (_DENSE + ["--expect-hierarchy", "3"], True),
], ids=["pass_3", "depth", "s2_ratio", "dense_pass", "dense_depth"])
def test_scale_gates_match_the_reference(argv, fails, monkeypatch, capsys):
    msg, ov = _port_gate(monkeypatch, argv)
    port_out = capsys.readouterr().out
    want = _ref_gate(monkeypatch, argv, ov)
    ref_out = capsys.readouterr().out
    assert msg == want
    assert (msg is not None) == fails
    ok = [ln for ln in port_out.splitlines() if ln.startswith("S2/S ratio")]
    assert ok == [ln for ln in ref_out.splitlines()
                  if ln.startswith("S2/S ratio")]
    if "0.5" in argv:
        assert ok == ["S2/S ratio 0.340 <= 0.5 (ok)"]


def test_expect_hierarchy_refused_outside_planner(monkeypatch, capsys):
    argv = ["--expect-hierarchy", "3", "--mode", "fused"]
    with pytest.raises(SystemExit) as port:
        serve.parse_args(["--device", "cpu", *argv])
    port_err = capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as ref:
        ref_serve.main()
    ref_err = capsys.readouterr().err
    assert port.value.code == ref.value.code == 2
    assert (port_err.strip().splitlines()[-1].split("error: ")[1]
            == ref_err.strip().splitlines()[-1].split("error: ")[1]
            == "--expect-hierarchy requires --mode planner")


def test_serve_cli_exits_1_on_a_failed_gate():
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *_HIER, "--batches", "1", "--batch-size", "16", "--validate", "4",
         "--expect-hierarchy", "2"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 1
    assert out.stderr.strip().splitlines()[-1] == (
        "expected hierarchy_levels=2, built 3 (S=238)")


# ---- the dry-run report and the observability A/B -------------------------
def test_dryrun_report_renders_run_cell_records(tmp_path, capsys):
    for mesh in ("single", "multipod"):
        assert dryrun.run_cell("dimenet", "molecule", mesh,
                               str(tmp_path))["ok"]
    assert dryrun_report.main(["--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith("| dimenet | molecule |")]
    assert len(rows) == 4
    assert rows[0].split(" | ")[2:7] == ["multipod", "OK",
                                         rows[0].split(" | ")[4], "-", "-"]
    assert rows[1].split(" | ")[2:4] == ["single", "OK"]
    recs = dryrun_report.load(str(tmp_path))
    frac = recs[("dimenet", "molecule", "single")]["roofline"][
        "roofline_fraction"]
    assert rows[2].endswith(f"| {frac:.4f} |")
    assert rows[3].count("|") == 6


def test_obs_overhead_ab_on_cpu(tmp_path):
    hist = tmp_path / "h.json"
    assert overhead.main(["--device", "cpu", "--nodes", "600", "--seconds",
                          "0.5", "--repeats", "1", "--rate", "400",
                          "--budget", "1.0", "--json", str(hist)]) == 0
    (rec,) = json.loads(hist.read_text())
    assert rec["section"] == "obs_overhead" and rec["backend"] == "cpu"
    assert rec["n_requests"] == 200 and rec["qps_off"] > 0
