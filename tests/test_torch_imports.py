"""The port stands alone: no JAX, nothing of the reference package.

Importing every ``repro_torch`` module in a fresh interpreter leaves
``jax`` and ``repro``/``repro.*`` out of ``sys.modules`` (matched by
exact name: ``repro_torch`` itself starts with "repro"), and
``chip_smoke.py`` imports neither (AST scan).  The serve CLI runs end to
end on the CPU, and ``chip_smoke.py`` refuses to report without a card
or without the repository around it.
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
              "repro_torch.launch.serve", "repro_torch.convert"):
        assert m in res["modules"]


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
