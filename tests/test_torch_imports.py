"""The port stands alone: no JAX, nothing of the reference package.

Importing every ``repro_torch`` module in a fresh interpreter leaves
``jax`` and ``repro``/``repro.*`` out of ``sys.modules`` (matched by
exact name: ``repro_torch`` itself starts with "repro"), and
``chip_smoke.py`` imports neither (AST scan).  A spawned cover worker
of the parallel host build imports no torch.  The serve CLI runs end to
end on the CPU (offline and ``--live``), and ``chip_smoke.py`` refuses
to report without a card or without the repository around it.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.obs.export import load_chrome_trace

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "repro")
             or n.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _is_forbidden(name: str) -> bool:
    return (name in ("jax", "jaxlib", "repro")
            or name.startswith(("jax.", "jaxlib.", "repro.")))


def test_port_modules_import_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("repro_torch.core.device_engine", "repro_torch.core.dist_engine",
              "repro_torch.core.paths", "repro_torch.kernels.ops",
              "repro_torch.kernels.label_merge", "repro_torch.kernels._build",
              "repro_torch.launch.serve", "repro_torch.convert",
              "repro_torch.serving", "repro_torch.serving.cache",
              "repro_torch.serving.scheduler",
              "repro_torch.serving.runtime", "repro_torch.serving.loadgen",
              "repro_torch.obs.metrics", "repro_torch.obs.export",
              "repro_torch.data.queries"):
        assert m in res["modules"]


_WORKER_PROBE = r"""
import sys

from repro_torch.core.graph import road_like
from repro_torch.core.landmarks import hybrid_cover
from repro_torch.core.supergraph import build_index


def probe_cover(fg, boundary_local, use_cost_model):
    bad = sorted(n for n in ("torch", "jax", "repro") if n in sys.modules)
    if bad:
        raise RuntimeError(f"cover worker imported {bad}")
    return hybrid_cover(fg, boundary_local, use_cost_model)


if __name__ == "__main__":
    ix = build_index(road_like(900), build_workers=2, cover_fn=probe_cover)
    print("covers", sum(f.cover is not None for f in ix.fragments),
          len(ix.fragments))
"""


def test_spawned_cover_worker_imports_no_torch(tmp_path):
    """The pool's workers are spawned; what one imports to compute a
    cover (the host build's chain, numpy only) holds no torch."""
    script = tmp_path / "probe.py"
    script.write_text(_WORKER_PROBE)
    out = subprocess.run([sys.executable, str(script)], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    _, done, total = out.stdout.split()
    assert done == total and int(total) > 1


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py"] + list((SRC / "repro_torch").rglob("*.py"))),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    bad = sorted(n for n in _imports(path) if _is_forbidden(n))
    assert bad == [], bad


def test_serve_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--nodes", "900", "--batches", "1", "--batch-size", "64",
         "--validate", "16"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "validation: 0 mismatches of 16" in out.stdout
    assert "us/query" in out.stdout


def test_serve_cli_paths_on_cpu():
    """--paths unwinds witness-mode answers and validates them (exit 0
    only with 0 mismatches)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--nodes", "900", "--batches", "1", "--batch-size", "64",
         "--validate", "16", "--paths", "--path-batch-size", "48"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "paths: 48 unwound" in out.stdout
    assert "path validation: 0 mismatches of 16" in out.stdout
    assert "us/path" in out.stdout


def test_serve_cli_live_on_cpu(tmp_path):
    """--live with concurrent refresh rounds, the hub tier, a parallel
    host build held to the serial one, metrics and a trace: exit 0 with
    0 mismatches, more than one epoch served, and files that parse."""
    metrics, trace_out = tmp_path / "m.json", tmp_path / "t.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--nodes", "900", "--live", "--rate", "500", "--live-seconds", "1",
         "--live-update-batches", "2", "--hub-budget", "64",
         "--build-workers", "2", "--check-build-parity", "--validate", "64",
         "--metrics-out", str(metrics), "--trace-out", str(trace_out)],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "build parity: workers=2 == serial" in out.stdout
    assert "live validation: 0 mismatches of 64" in out.stdout
    recs = {r["section"]: r for r in (
        json.loads(line) for line in out.stdout.splitlines()
        if line.startswith('{"section"'))}
    live = recs["serve_live"]
    assert live["oracle_bad"] == 0 and live["epochs_served"] > 1
    assert live["n_requests"] == 500 and live["refresh_rounds"] == 2
    assert (live["cache_hits"] + live["label_hits"]
            + live["planner_dispatches"]) == 500
    assert recs["serve_refresh"]["refresh_rounds"] == 2
    snap = json.loads(metrics.read_text())
    assert snap["metrics"]["serve.batch.flushed_requests"] == 500
    assert "serve_batch_flushed_requests 500" in (
        metrics.with_suffix(".prom").read_text())
    names = {e["name"] for e in load_chrome_trace(str(trace_out))}
    assert {"serve.flush", "serve.request", "refresh.round",
            "build.device_engine", "build.hybrid_covers"} <= names


def test_serve_cli_rejects_live_flag_misuse():
    for argv, msg in ((["--live", "--paths"], "--paths is not supported"),
                      (["--hub-budget", "8"], "--hub-budget requires"),
                      (["--live", "--hot-tier", "0.5"], "--hot-tier requires"),
                      (["--metrics-out", "x.json"], "--metrics-out")):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", *argv], env=_env(), capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 2 and msg in out.stderr, out.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
