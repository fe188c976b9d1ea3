"""One run of one cell: set up the deployment, measure it for the window,
check what it answered against the plain reference, print one result line.

Everything that belongs to a cell is found by name:
``BENCHMARK.json`` names the cell's configuration and traffic mix;
``bench/configs/<config>.json`` holds the deployment, ``bench/traffic/<mix>
.json`` the traffic's parameters, ``bench/loops/<loop>.py`` the loop that
drives the traffic's ``loop`` (``warm(run)``, ``drive(run)``), and
``bench/metrics/<metric>.py`` the reader of each metric, end-to-end and
per-layer (``read(ctx)``, None where it finds nothing to read).

The program under test is ``repro_torch`` (``src/`` of the checkout); the
benchmark hands it the graph, the hub set and the query pairs made here
from ``--seed`` (``portbench.gen``), and the reference gets the same.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import checks, gen, tracing

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
OUT = BENCH / "out"
# top-level modules that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run profiles this many seconds from the window's open
TRACE_SECONDS = 5.0
# where the program's kernels and the run's compile caches land: a file
# new there after set-up means this run compiled
BUILD_DIRS = (ROOT / "src" / "repro_torch" / "csrc" / "build",
              OUT / "torch_extensions", OUT / "triton")


# -- the manifest and the files it names ----------------------------------
def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py``, loaded by its path."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``read(ctx)`` of ``bench/metrics/<metric>.py``."""
    return module("metrics", metric).read


def metrics_of(man: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: end-to-end ones untraced, per-layer traced."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def built_files() -> set:
    return {p for d in BUILD_DIRS if d.is_dir() for p in d.rglob("*")
            if p.is_file()}


# -- the deployment --------------------------------------------------------
class Inputs:
    """What the benchmark makes from the configuration and the seed: the
    graph, the Zipf pool with the hub set from its head."""

    def __init__(self, config: dict, seed: int):
        gcfg = config["graph"]
        self.graph = gen.road_like(gcfg["n_target"], seed=gcfg["seed"])
        hub = config["hub_tier"]
        self.pool = gen.zipf_pool(self.graph.n, hub["pool"],
                                  gen.rng(seed, gen.POOL))
        self.hubs = gen.hub_selection(self.pool, hub["budget"])


def port_graph(edges: gen.Edges):
    from repro_torch.core.graph import Graph

    return Graph.from_edges(edges.n, edges.edge_u, edges.edge_v,
                            edges.edge_w)


def build_engine(config: dict, traffic: dict, inputs: Inputs, device):
    from repro_torch.core.dist_engine import EpochedEngine

    ix = config["index"]
    return EpochedEngine(
        port_graph(inputs.graph), device=device,
        hierarchy_levels=ix["hierarchy_levels"], hub_nodes=inputs.hubs,
        build_workers=ix["build_workers"], warm_refresh=False,
        paths=traffic["entry"] == "query_path")


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """State of one run shared by its loop, its checks and its readers."""

    def __init__(self, traffic, inputs, engine, device, seed, seconds,
                 trace):
        self.traffic, self.inputs = traffic, inputs
        self.engine, self.device = engine, device
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.spans = tracing.Spans()
        self.dtrace = None
        self.ctx: dict = {"entry": traffic["entry"]}
        self.twoside_calls: list = []
        self.t0 = self.t_end = None

    def pairs(self, stream: int):
        """count -> [count, 2] pairs of the traffic's mix, drawn in order
        from the run's ``stream``."""
        r = gen.rng(self.seed, stream)
        g, pool, mix = self.inputs.graph, self.inputs.pool, \
            self.traffic["pairs"]
        return lambda count: gen.pairs(mix, g, pool, count, r)

    def maybe_stop_trace(self, now: float) -> None:
        """Ends the traced window ``TRACE_SECONDS`` after the open."""
        if self.dtrace is not None and self.dtrace.t_stop is None \
                and now >= self.t0 + min(self.seconds, TRACE_SECONDS):
            self.dtrace.stop()

    def open_window(self) -> None:
        gc.collect()
        sync(self.device)
        if self.dtrace is not None:
            self.dtrace.mark_start()
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + self.seconds


# -- correctness -----------------------------------------------------------
def check(run: Run, res: dict, *, workers: int = 0,
          served=None) -> checks.Check:
    """The comparison with the reference: a sample of the window's answers,
    drawn from the seed, and every path the window returned.  ``served``
    replaces the program's answers (the control puts the reference's own
    there)."""
    ck = checks.Check()
    g = run.inputs.graph
    want_n = run.traffic["check"]
    total = len(res["dists"])
    idx = np.sort(gen.rng(run.seed, gen.SAMPLE).choice(
        total, size=min(want_n, total), replace=False))
    pairs = res["pairs"][idx]
    got = res["dists"][idx] if served is None else served(pairs)
    want = checks.exact(g.n, g.edge_u, g.edge_v, g.edge_w, pairs,
                        workers=workers)
    checks.compare(ck, got, want)
    ck.at_least("checked", int(idx.size), min(want_n, total))
    if "paths" in res:
        road = checks.roadref.Road(g.n, g.edge_u, g.edge_v, g.edge_w)
        bad = sum(bool(checks.roadref.path_fault(road, int(s), int(t), p,
                                                 float(d)))
                  for (s, t), p, d in zip(res["pairs"], res["paths"],
                                          res["dists"]))
        ck.at_most("bad_paths", bad, 0)
    return ck


# -- the run ---------------------------------------------------------------
def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_proc: float, device: str = "cuda", man: dict | None = None,
             config: dict | None = None, traffic: dict | None = None,
             ref_workers: int = 6, log=print) -> dict:
    """One run of ``workload`` -> the result record (its keys in order,
    ``checks`` last).  ``config``/``traffic`` override the named files
    (the tests run small ones on the CPU)."""
    import torch

    man = manifest() if man is None else man
    wl = cell(man, workload)
    config = load_json("configs", wl["config"]) if config is None \
        else config
    traffic = load_json("traffic", wl["traffic"]) if traffic is None \
        else traffic
    loop = module("loops", traffic["loop"])
    dev = torch.device(device)
    before = built_files()
    inputs = Inputs(config, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    engine = build_engine(config, traffic, inputs, dev)
    run = Run(traffic, inputs, engine, dev, seed, seconds, trace)
    loop.warm(run)
    if trace:
        _instrument_twoside(run)
        if dev.type == "cuda":
            run.dtrace = tracing.DeviceTrace(
                OUT / "traces" / f"{workload}-{seed}.json")
            run.dtrace.start()
    sync(dev)
    setup_s = time.perf_counter() - t_proc
    compiled = sorted(str(p.relative_to(ROOT))
                      for p in built_files() - before)
    res = loop.drive(run)
    sync(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    if run.dtrace is not None:
        run.dtrace.stop()
    device_rec = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", "count": 1, "memory_peak_bytes": peak}
    ctx = run.ctx
    ctx.update(setup_s=setup_s, t0=run.t0, t_end=run.t_end,
               spans=run.spans)
    breakdown = None
    if trace:
        _trace_context(run)
        if "device" in ctx:
            device_rec["busy_s"] = ctx["device"]["busy_s"]
            device_rec["window_s"] = ctx["device"]["window_s"]
            breakdown = ctx["device"]["breakdown"]
    metrics = {}
    for m in metrics_of(man, workload, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    e2e = {m["name"]: reader(m["name"])(ctx)
           for m in metrics_of(man, workload, False)}
    # the program's state goes before the reference runs
    run.twoside_calls.clear()
    del engine, run.engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ck = time.perf_counter()
    ck = check(run, res, workers=ref_workers)
    log(f"reference check: {time.perf_counter() - t_ck:.1f} s",
        file=sys.stderr)
    out = {"correct": ck.correct, "attempted": int(len(res["dists"])),
           "failed": 0, "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # the first run in a checkout builds the program's kernels in its
    # set-up: its setup_s is not a steady one
    out["setup_compiled"] = bool(compiled)
    out["checks"] = ck.items
    out["_check_lines"] = ck.lines()
    out["_e2e"] = e2e
    out["_compiled"] = compiled
    return out


def _instrument_twoside(run: Run) -> None:
    """In the traced run, keep the operands of the first calls of kernel
    2's entry inside the traced window (references only: nothing is copied
    or counted on the timed path)."""
    from repro_torch.kernels import ops

    real = ops.minplus_twoside_grouped
    limit = 32

    def recorded(*args, **kwargs):
        if run.t0 is not None and len(run.twoside_calls) < limit and (
                run.dtrace is None or run.dtrace.t_stop is None):
            run.twoside_calls.append(args)
        return real(*args, **kwargs)
    ops.minplus_twoside_grouped = recorded
    run.ctx["restore_twoside"] = lambda: setattr(
        ops, "minplus_twoside_grouped", real)


def _trace_context(run: Run) -> None:
    """What the per-layer readers read besides the spans: the build
    timings, the device trace's summary and kernel 2's work."""
    from . import roofline

    ctx = run.ctx
    ctx.pop("restore_twoside", lambda: None)()
    eng = run.engine
    ctx["build"] = {"device": dict(eng.plan.build_timings),
                    "host": dict(eng.ix.timings)}
    if run.dtrace is None:
        return
    tr = run.dtrace.read()
    ops = tr["ops"]
    print(f"trace: {tr['counts']}; {len(ops)} device ops in the traced "
          f"window of {tr['t_stop'] - tr['t_start']:.3f} s"
          + (f", first at +{ops[0][2] - tr['t_start']:.4f} s, last "
             f"ends at +{ops[-1][3] - tr['t_start']:.4f} s" if ops
             else ""), file=sys.stderr)
    names = tracing.port_kernel_names(ROOT / "src" / "repro_torch")
    ctx["device"] = tracing.summarise(tr, run.spans, names)
    ctx["device"].update(t_start=tr["t_start"], t_stop=tr["t_stop"])
    # kernel 2: bound and device seconds of the recorded calls, matched
    # in launch order with the trace's kernel-2 launches
    k2 = [o for o in ops if o[1] == "kernel"
          and tracing.base_name(o[0]) in roofline.TWOSIDE_KERNELS]
    bound = dev_s = 0.0
    pos = matched = 0
    for args in run.twoside_calls:
        launched = roofline.twoside_launches(args)
        got = k2[pos:pos + len(launched)]
        if [tracing.base_name(o[0]) for o in got] != launched:
            break
        pos += len(launched)
        nbytes, cells = roofline.grouped_work(args)
        bound += roofline.bound_s(nbytes, 2.0 * cells)
        dev_s += sum(o[3] - o[2] for o in got)
        matched += 1
    ctx["twoside"] = {"calls": matched, "bound_s": bound,
                      "device_s": dev_s}
