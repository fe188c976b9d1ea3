#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card, ``nvcc`` and the repository checkout around this
file; without a card (or without the checkout) it exits non-zero and
prints no result.  Phases, each of which must pass:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, in parallel) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card,
     array-equal, on integer-valued float32 inputs with ~20% +inf at
     shapes that are not tile multiples (and all-+inf blocks), timing
     kernel and plain version with CUDA events;
  3. a small end-to-end reference: road_like(900) built and served on
     the card equals the same run on the CPU (plain versions), table
     for table and answer for answer;
  4. the main path at road4000 through ``repro_torch.launch.serve``:
     host build, device build, planner warmup, 5 batches of 1024,
     64 answers validated against Dijkstra (0 mismatches); every
     kernel's launch counter is zeroed just before and read just after;
  5. the same at road64k (dense overlay, S ~ 4.6k), 32 validated;
  6. the ``kernels`` JSON line (launches from the road4000 run, times
     and bounds from phase 2), the card's name and power limit from
     nvidia-smi, and the ``{"ok": true, ...}`` line last.

Details of every case go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM bandwidth and float32 rate outside the
# tensor cores ((min,+) has no tensor-core form)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()                                       # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _int_inf(shape, rng, inf_frac=0.2):
    import numpy as np
    x = rng.integers(0, 100, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over cells where either is finite; a cell that is
    +inf on one side only counts as inf."""
    import torch
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def _check_fw(cases, out):
    import numpy as np
    import torch
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import ops
    for label, b, n, all_inf in cases:
        rng = np.random.default_rng(b * 7919 + n)
        d_np = _int_inf((b, n, n), rng)
        d_np[list(all_inf)] = np.inf
        d = torch.from_numpy(d_np).cuda()
        kernel = (fw.fw_next_smem_cuda if n <= fw.SMEM_MAX_N
                  else fw.fw_next_global_cuda)
        got = kernel(d)
        want = ops.fw_batch_next(d, force="ref")
        torch.cuda.synchronize()
        dist_ok = torch.equal(got[0], want[0])
        nxt_ok = torch.equal(got[1], want[1])
        err = _max_abs_err(got[0], want[0])
        big = n > 1000
        ms = _time_ms(lambda: kernel(d), 2 if big else 10)
        plain_ms = _time_ms(lambda: ops.fw_batch_next(d, force="ref"),
                            1 if big else 3)
        bound, by = _bound_ms(12.0 * b * n * n, 2.0 * b * n ** 3)
        rec = {"case": label, "kernel": kernel.__name__, "b": b, "n": n,
               "dist_equal": dist_ok, "nxt_equal": nxt_ok,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by}
        print(f"  {label}: {rec}")
        out.append(rec)
        if not (dist_ok and nxt_ok):
            raise AssertionError(f"{label}: kernel != plain version")


def _check_twoside(cases, out):
    import numpy as np
    import torch
    from repro_torch.kernels import minplus_twoside as ts
    from repro_torch.kernels import ops
    for label, q, k, inf_frac in cases:
        rng = np.random.default_rng(q * 31 + k)
        rows, d, rowt = (torch.from_numpy(_int_inf(s, rng, f)).cuda()
                         for s, f in (((q, k), inf_frac), ((k, k), 0.2),
                                      ((q, k), 0.2)))
        got = ts.minplus_twoside_cuda(rows, d, rowt)
        want = ops.minplus_twoside(rows, d, rowt, force="ref")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = _max_abs_err(got, want)
        ms = _time_ms(lambda: ts.minplus_twoside_cuda(rows, d, rowt), 10)
        plain_ms = _time_ms(
            lambda: ops.minplus_twoside(rows, d, rowt, force="ref"), 2)
        # work this data needs: (q, x, y) triples whose three terms are
        # all finite (the +inf ones cannot move a min), 2 ops each
        fin = [torch.isfinite(x).double() for x in (rows, d, rowt)]
        triples = float(((fin[0] @ fin[1]) * fin[2]).sum())
        nbytes = 4.0 * (rows.numel() + d.numel() + rowt.numel() + q)
        bound, by = _bound_ms(nbytes, 2.0 * triples)
        rec = {"case": label, "kernel": "minplus_twoside_cuda", "q": q,
               "k": k, "equal": ok, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "finite_triples": triples}
        print(f"  {label}: {rec}")
        out.append(rec)
        if not ok:
            raise AssertionError(f"{label}: kernel != plain version")


def _reset_counts():
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import minplus_twoside as ts
    fw.fw_next_smem_cuda.launches = 0
    fw.fw_next_global_cuda.launches = 0
    ts.minplus_twoside_cuda.launches = 0


def _read_counts() -> dict:
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import minplus_twoside as ts
    return {"fw_next_smem": fw.fw_next_smem_cuda.launches,
            "fw_next_global": fw.fw_next_global_cuda.launches,
            "minplus_twoside": ts.minplus_twoside_cuda.launches}


def _small_reference() -> dict:
    """road_like(900) on the card == the same build and serve on the CPU
    (plain versions): every field, and every answer (== Dijkstra)."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import build_device_index
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.graph import road_like
    from repro_torch.core.supergraph import build_index
    g = road_like(900, seed=0)
    ix = build_index(g)
    on_card = build_device_index(ix, device="cuda", hierarchy_levels=1)
    on_cpu = build_device_index(ix, device="cpu", hierarchy_levels=1)
    a = convert.device_index_to_numpy(on_card)
    b = convert.device_index_to_numpy(on_cpu)
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    rng = np.random.default_rng(7)
    s, t = rng.integers(0, g.n, 256), rng.integers(0, g.n, 256)
    got = QueryPlanner(on_card).query(s, t)
    want = QueryPlanner(on_cpu).query(s, t)
    oracle = np.array([dijkstra.pair(g, int(x), int(y))
                       for x, y in zip(s[:64], t[:64])], np.float32)
    res = {"fields_differ": bad,
           "answers_equal": bool(np.array_equal(got, want)),
           "dijkstra_equal": bool(np.array_equal(got[:64], oracle))}
    print(f"  road_like(900) card vs cpu: {res}")
    if bad or not res["answers_equal"] or not res["dijkstra_equal"]:
        raise AssertionError(f"card and CPU builds disagree: {res}")
    return res


def _main_path(graph: str, validate: int) -> dict:
    from repro_torch.launch import serve
    args = serve.parse_args(["--graph", graph, "--batches", "5",
                             "--batch-size", "1024", "--validate",
                             str(validate), "--device", "cuda"])
    _reset_counts()
    res = serve.run(args)
    res["launches"] = _read_counts()
    print(f"  {graph} launches: {res['launches']}")
    if res["mismatches"] or not res["answers_finite"]:
        raise AssertionError(f"{graph}: {res['mismatches']} mismatches, "
                             f"answers finite: {res['answers_finite']}")
    zero = [k for k, v in res["launches"].items() if v <= 0]
    if zero:
        raise AssertionError(f"{graph}: kernels never launched: {zero}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    report: dict = {"phases": {}}
    fw_cases: list = []
    ts_cases: list = []

    def phase(name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            report[name] = fn()
            ok = True
        except Exception:                      # report, go on, fail at end
            traceback.print_exc()
            ok = False
        report["phases"][name] = {"ok": ok,
                                  "s": time.perf_counter() - t0}
        print(f"== {name}: {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

    def build():
        took = _build.build()
        for name in _build.SOURCES:
            log = _build.lib_path(name).with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "registers" in line or "smem" in line:
                        print(f"  ptxas {name}: {line.strip()}")
        print(f"  kernel build seconds: {took}")
        return took

    phase("build", build)
    print("kernel checks: tolerance exact (torch.equal on dist, nxt and "
          "out); integer-valued inputs keep every sum below 2**24")
    phase("fw_kernel", lambda: _check_fw([
        ("smem b=36 n=128", 36, 128, ()),
        ("smem b=8 n=8 all-inf blocks", 8, 8, (1, 5)),
        ("global b=1 n=4613", 1, 4613, ()),
        ("global b=4 n=496 all-inf block", 4, 496, (2,)),
    ], fw_cases))
    phase("twoside_kernel", lambda: _check_twoside([
        ("q=16 S+1=480", 16, 480, 0.2),
        ("q=1024 S+1=480", 1024, 480, 0.2),
        ("q=16 S+1=4614", 16, 4614, 0.2),
        ("q=1024 S+1=4614", 1024, 4614, 0.2),
        ("q=64 S+1=480 all-inf rows", 64, 480, 1.0),
    ], ts_cases))
    phase("small_reference", _small_reference)
    phase("road4000", lambda: _main_path("road4000", 64))
    phase("road64k", lambda: _main_path("road64k", 32))

    report["fw_cases"], report["ts_cases"] = fw_cases, ts_cases
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    report["card"] = card
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=str))
    failed = [k for k, v in report["phases"].items() if not v["ok"]]
    if failed or not card:
        print(f"chip_smoke: FAILED phases {failed}"
              + ("" if card else "; nvidia-smi gave no card"),
              file=sys.stderr)
        return 1

    def pick(cases, label):
        return next(c for c in cases if c["case"] == label)

    launches = report["road4000"]["launches"]
    rows = [
        ("fw_next_smem", pick(fw_cases, "smem b=36 n=128"),
         "src/repro_torch/csrc/fw_next.cu",
         "src/repro/kernels/floyd_warshall.py:97"),
        ("fw_next_global", pick(fw_cases, "global b=1 n=4613"),
         "src/repro_torch/csrc/fw_next.cu",
         "src/repro/kernels/floyd_warshall.py:97"),
        ("minplus_twoside", pick(ts_cases, "q=1024 S+1=4614"),
         "src/repro_torch/csrc/minplus_twoside.cu",
         "src/repro/kernels/minplus_twoside.py:89"),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": None,
        "shape": c["case"],
    } for name, c, source, replaces in rows]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
