"""The port's serve records against the reference's, on the CPU.

For the same stage timings the port's ``host_build`` record equals the
reference's ``_host_build_record`` but for the device keys (``backend``,
``device_name``, ``power_limit_w``): ``wall_s`` sums the same stages and
leaves out the port's own ``host_build_s`` total.  On small CPU runs of
both serve CLIs (a planner run with ``--paths`` and one update round,
and a ``--live`` run with one refresh round) every port record has all
the keys of the reference's record of its section, and the device keys
besides.
"""
import argparse
import json
import os
import subprocess
import sys
import types

import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve
from repro_torch.perflog import read_records

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEVICE_KEYS = ("backend", "device_name", "power_limit_w")

#: the two runs of each CLI: every section the serve CLIs write
RUNS = (["--nodes", "400", "--batches", "1", "--batch-size", "32",
         "--validate", "4", "--paths", "--update-batches", "1"],
        ["--nodes", "400", "--live", "--rate", "200", "--live-seconds",
         "1", "--live-update-batches", "1", "--validate", "4"])
SECTIONS = {"host_build", "serve", "serve_paths", "refresh", "serve_live",
            "serve_refresh"}


@pytest.mark.parametrize("workers", (1, 2))
def test_host_build_record_equals_reference(workers):
    stages = {"compDRAs": 0.0123456, "shrink_graph": 0.00081,
              "partition": 0.00931, "fragments": 0.0022,
              "hybrid_covers": 0.02051, "super_graph": 0.00117}
    args = argparse.Namespace(nodes=4000, graph=None,
                              build_workers=workers)
    want = jserve._host_build_record(args, dict(stages))[0]
    timings = dict(stages, host_build_s=sum(stages.values()),
                   reweighted=True)
    got = serve.host_build_record(args, timings, "cpu")
    assert got["backend"] == "cpu" and got["device_name"] == "cpu"
    assert "power_limit_w" not in got
    strip = ("backend", "device_name")
    assert {k: v for k, v in got.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}
    assert got["wall_s"] == round(sum(round(v, 4) for v in stages.values()),
                                  4)


def test_power_limit_read_once_from_nvidia_smi(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(
            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"
                   "NVIDIA H100 80GB HBM3, 500.00 W\n")
    serve._power_limit_w.cache_clear()
    monkeypatch.setattr(serve.subprocess, "run", fake_run)
    try:
        assert serve._power_limit_w(0) == 700.0
        assert serve._power_limit_w(1) == 500.0
        assert serve._power_limit_w(0) == 700.0
        assert len(calls) == 2
        assert calls[0] == ["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]
        assert serve._power_limit_w(5) is None
    finally:
        serve._power_limit_w.cache_clear()


def _reference_records(path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        ROOT, "src"))
    for argv in RUNS:
        subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv,
                        "--json", path], check=True, cwd=ROOT, env=env,
                       capture_output=True, timeout=600)
    return read_records(path)


def test_port_records_carry_every_reference_key(tmp_path):
    ref = _reference_records(str(tmp_path / "ref.json"))
    path = str(tmp_path / "port.json")
    for argv in RUNS:
        assert serve.main(["--device", "cpu", *argv, "--json", path]) == 0
    port = read_records(path)
    assert {r["section"] for r in ref} == SECTIONS
    assert {r["section"] for r in port} == SECTIONS
    for section in SECTIONS:
        want = set().union(*(r.keys() for r in ref
                             if r["section"] == section))
        for rec in (r for r in port if r["section"] == section):
            missing = want - set(rec)
            assert not missing, (section, sorted(missing))
            assert rec["backend"] == "cpu" == rec["device_name"], rec
            assert json.dumps(rec)
    builds = [r for r in port if r["section"] == "host_build"]
    assert len(builds) == 2
    for rec in builds:
        stages = [v for k, v in rec.items()
                  if k.startswith("stage_") and k.endswith("_s")]
        assert "stage_host_build_s" not in rec
        assert rec["wall_s"] == round(sum(stages), 4)
