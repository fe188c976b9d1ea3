"""Dry run of every (architecture x input shape) cell on the production
meshes: the port's counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --workers 6

For each cell, ``cells.build_cell`` runs on ``make_production_mesh()``
(the ``meta`` device at each of the 256 or 512 positions) and
``opanalysis.analyze`` runs the step once on ``meta``: shapes only,
nothing allocated, no card needed.  Records land in
``<out>/<arch>__<shape>__<mesh>.json`` (default ``experiments/
dryrun_torch/``, git-ignored), one a cell, skipped when present unless
``--force``, so a sweep resumes; ``--workers N`` runs the cells in N
spawned processes.  Importing the module sets no environment variable.

A record holds the reference's keys where the port has an analogue:

  * ``lower_s``: seconds of the step's ``meta`` run under the analysis
    (the port's trace; the reference's lowering);
  * ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: per
    device, exact from the shardings (each dimension split over the
    mesh axes its spec names, rounded up); an output leaf that is an
    argument leaf (a donated buffer updated in place) keeps the
    argument's sharding, any other output is counted replicated, since
    the port chooses no output sharding;
  * ``memory.temp_size_in_bytes_global``: the peak bytes of the
    storages the step creates (``Analysis.peak_live_bytes``) at the
    global shapes.  The port has no SPMD partitioner: no per-device
    temporary size, and no fit, is claimed (``memory.temp_scope``);
  * ``analysis``: ``dot_flops`` and ``hbm_bytes_measured`` are the
    global counts split evenly over the mesh (``..._global`` beside
    them), ``cpu_copy_bytes`` the dtype and device copies (global),
    ``unknown_trip_counts`` 0, ``collective_bytes`` the per-device
    bytes of the port's own collectives (the sharded GNN forwards' halo
    gathers, their backward reduce-scatters and the loss psums; the
    collectives an SPMD partitioner would insert for the other cells are
    not modelled), ``hbm_bytes_model`` the analytic traffic model
    (``traffic.py``);
  * ``model_flops``, ``notes``, and ``roofline`` (``compute_s`` from
    the per-device matmul FLOPs, ``memory_s`` from the traffic model,
    ``collective_s``, ``dominant``, ``model_vs_hlo_flops`` (model
    FLOPs over the dispatched matmul FLOPs), ``step_time_bound_s``,
    ``roofline_fraction``).

The reference's ``compile_s``, ``hlo_bytes``, ``cost_xla`` and
``memory.generated_code_size_in_bytes`` / ``total_device_bytes`` have
no analogue (no compiler, no per-device temporaries) and are absent;
``n_ops`` (ops dispatched) is the port's own.

The roofline's constants are the spec sheet of the card this port
targets (``CARD``), not a measurement; the link rate between hosts of
a 256- or 512-card cluster is an assumption about a cluster this
repository never ran on (``LINK_BW_ASSUMED``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback

import torch

from ..checkpoint.manager import tree_leaves
from ..configs import get_arch, list_archs
from . import opanalysis, traffic
from .cells import build_cell
from .mesh import make_production_mesh

#: the spec sheet behind the roofline (NVIDIA's H100 SXM data sheet,
#: dense rates, at the full 700 W power limit)
CARD = "NVIDIA H100 80GB HBM3, 700 W (spec sheet)"
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s a card
HBM_BW = 3.35e12           # HBM bytes/s a card
#: ASSUMPTION: one 400 Gb/s InfiniBand NDR port a card between hosts
LINK_BW_ASSUMED = 50e9


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def _local_bytes(t, spec, sizes: dict) -> int:
    """Bytes of one device's block of ``t`` under partition ``spec``."""
    n = t.element_size()
    for i, dim in enumerate(t.shape):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n


def _pairs(arg, shard, out: list) -> list:
    """(tensor, NamedSharding) leaves of an argument tree and its
    sharding tree."""
    if isinstance(arg, torch.Tensor):
        out.append((arg, shard))
    elif isinstance(arg, dict):
        for k in arg:
            _pairs(arg[k], shard[k], out)
    elif isinstance(arg, (list, tuple)):
        for a, s in zip(arg, shard):
            _pairs(a, s, out)
    elif dataclasses.is_dataclass(arg):
        for f in dataclasses.fields(arg):
            _pairs(getattr(arg, f.name), getattr(shard, f.name), out)
    return out


def _memory(bundle, out, sizes: dict) -> dict:
    """Per-device argument and output bytes from the shardings."""
    pairs = _pairs(bundle.args, bundle.in_shardings, [])
    spec_of = {id(t): s.spec for t, s in pairs}
    arg = sum(_local_bytes(t, s.spec, sizes) for t, s in pairs)
    outs = {id(t): t for t in tree_leaves(out)
            if isinstance(t, torch.Tensor)}
    res = sum(_local_bytes(t, spec_of.get(i, ()), sizes)
              for i, t in outs.items())
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": res}


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             outdir: str, force: bool = False) -> dict:
    path = os.path.join(outdir, f"{arch_id}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    multi = mesh_kind == "multipod"
    mesh = make_production_mesh(multi_pod=multi)
    n_chips = mesh.size
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "n_chips": n_chips, "ok": False}
    try:
        bundle = build_cell(arch_id, shape_name, mesh)
        t0 = time.perf_counter()
        ana, out = opanalysis.analyze_with_output(bundle.fn, *bundle.args)
        rec["lower_s"] = time.perf_counter() - t0
        sizes = _sizes(mesh)
        rec["memory"] = _memory(bundle, out, sizes)
        del out
        rec["memory"]["temp_size_in_bytes_global"] = ana.peak_live_bytes
        rec["memory"]["temp_scope"] = (
            "global step: no SPMD partitioner, so no per-device "
            "temporary size or fit is claimed")
        spec = get_arch(arch_id)
        bytes_model = traffic.analytic_bytes(
            spec, spec.shape(shape_name), n_chips,
            tp=sizes.get("model", 1))
        rec["analysis"] = {
            "dot_flops": ana.flops / n_chips,
            "dot_flops_global": ana.flops,
            "hbm_bytes_measured": ana.bytes / n_chips,
            "hbm_bytes_measured_global": ana.bytes,
            "cpu_copy_bytes": ana.copy_bytes,
            "unknown_trip_counts": ana.unknown_trips,
            "collective_bytes": ana.collectives,
            "collective_counts": ana.collective_counts,
            "hbm_bytes_model": bytes_model,
            "n_ops": ana.n_ops,
        }
        rec["model_flops"] = bundle.model_flops
        rec["notes"] = bundle.notes
        rec["roofline"] = {
            "card": CARD,
            "compute_s": ana.flops / n_chips / PEAK_FLOPS,
            "memory_s": bytes_model / HBM_BW,
            "collective_s": ana.collective_bytes / LINK_BW_ASSUMED,
        }
        terms = {k: v for k, v in rec["roofline"].items() if k != "card"}
        rec["roofline"]["dominant"] = max(terms, key=terms.get)
        rec["roofline"]["model_vs_hlo_flops"] = (
            bundle.model_flops / ana.flops if ana.flops else float("nan"))
        step_s = max(terms.values())
        ideal_s = bundle.model_flops / (n_chips * PEAK_FLOPS)
        rec["roofline"]["step_time_bound_s"] = step_s
        rec["roofline"]["roofline_fraction"] = (
            ideal_s / step_s if step_s > 0 else float("nan"))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001: a cell's failure is recorded
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else "FAIL"
    print(f"[{status}] {arch_id} x {shape_name} x {mesh_kind} "
          f"run={rec.get('lower_s', 0):.1f}s {rec.get('error', '')}",
          flush=True)
    return rec


def _run_one(job) -> dict:
    return run_cell(*job)


def all_cells() -> list:
    return [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]


def sweep(cells, meshes, outdir: str, *, force: bool = False,
          workers: int = 1) -> list:
    """``run_cell`` over ``cells`` x ``meshes`` -> the records, in that
    order; with ``workers`` > 1 in that many spawned processes (the
    largest cells, the LM train steps, first)."""
    jobs = [(a, s, mk, outdir, force) for a, s in cells for mk in meshes]
    if workers <= 1:
        return [run_cell(*j) for j in jobs]
    order = sorted(range(len(jobs)),
                   key=lambda i: jobs[i][1] != "train_4k")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        recs = pool.map(_run_one, [jobs[i] for i in order], chunksize=1)
    out = [None] * len(jobs)
    for i, rec in zip(order, recs):
        out[i] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    recs = sweep(cells, meshes, args.out, force=args.force,
                 workers=args.workers)
    n_ok = sum(bool(r["ok"]) for r in recs)
    print(f"done: {n_ok}/{len(recs)} cells OK", flush=True)
    return 0 if n_ok == len(recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
