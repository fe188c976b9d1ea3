"""BENCHMARK.json against its required form, every file it names found
by name, and the benchmark's imports: nothing under bench/ loads JAX or
the JAX package, and the reference loads nothing of the program."""
import ast
import json
import re
from pathlib import Path

import pytest

import portbench_small  # noqa: F401
from portbench import harness

BENCH = Path(__file__).resolve().parents[1]
MAN = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in MAN["workloads"])) \
        == len(MAN["workloads"])
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] == 1
    assert len(json.dumps(MAN)) < 64 * 1024


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in MAN["workloads"]]
    for w in cells:
        reported = [m for m in MAN["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert [m for m in MAN["per_layer"]
                if w in m.get("workloads", cells)]
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_its_files_by_name(w):
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    loop = harness.module("loops", traffic["loop"])
    assert callable(loop.warm) and callable(loop.drive)
    assert traffic["entry"] in ("query", "query_path")
    assert config["name"] == w["config"]
    spec = [c for c in MAN["configs"] if c["name"] == w["config"]][0]
    assert (BENCH.parent / spec["file"]).is_file()
    assert set(spec["reduced"]) <= set(config) and \
        config["reduced"] == spec["reduced"]
    for trace in (False, True):
        for m in harness.metrics_of(MAN, w["name"], trace):
            assert callable(harness.reader(m["name"]))


def test_every_config_is_used_and_has_a_file_of_its_own():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("bench/") for f in files)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "portbench", "torch"}


def test_the_name_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core.graph", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.core.graph", "jax.numpy", "jaxlib", "flax"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def test_metric_readers_load_by_name_and_skip_what_they_cannot_read():
    empty = {"build": {"device": {}, "host": {}}}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert harness.reader(m["name"])(empty) is None


def test_each_rate_is_read_only_for_its_entry():
    ctx = {"batch_ends": [0.5, 1.0], "batch_size": 16, "t0": 0.0,
           "t_end": 2.0}
    q = harness.reader("queries_per_s")
    p = harness.reader("paths_per_s")
    assert q(dict(ctx, entry="query")) == 16.0
    assert p(dict(ctx, entry="query")) is None
    assert p(dict(ctx, entry="query_path")) == 16.0
    assert q(dict(ctx, entry="query_path")) is None


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
