#!/usr/bin/env python3
"""Pick the launch shape of kernel 7, the hub-label merge.

    PYTHONPATH=src python3 scripts/label_merge_tune.py [--cols 4 8 16]

Needs one NVIDIA card and ``nvcc``.  Builds ``csrc/label_merge.cu`` once
per count of columns a thread loads in a pass (``-DLM_COLS=<c>``,
otherwise the port's own flags) into the git-ignored build directory,
then on ``chip_smoke.py``'s indexed cases (``MERGE_ROWS_CASES``) and on
the dense entry at q = 1,024 (W = 480, 1,712, 4,661) times every team
size (32-256 threads a query) with the table out of L2 (copies cycled,
as ``chip_smoke._merge_rows_times``), by the profiler's device time,
after checking the answer array-equal to the plain version; the indexed
cases of the default build (``label_merge.COLS``) also with 4-byte loads
only (``vec`` = 0).  Prints one JSON line per case, each build's ptxas
report, the team ``label_merge.team`` picks beside the fastest, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TEAMS = (32, 64, 128, 256)
DENSE = ((1024, 480), (1024, 1712), (1024, 4661))


def _build(cols: int):
    """(command, output path) of one variant's nvcc run."""
    from repro_torch.kernels import _build as b
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = b.BUILD_DIR / f"label_merge-tune-c{cols}.so"
    return [b.nvcc(), *b.NVCC_FLAGS, f"-DLM_COLS={cols}", "-o", str(out),
            str(b.CSRC / "label_merge.cu")], out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.label_merge_rows.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.label_merge.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.label_merge_rows.restype = lib.label_merge.restype = ctypes.c_int
    return lib


def _cases():
    """(label, entry, inputs, plain answer): the indexed cases on the
    card and the dense ones (their rows gathered from a table)."""
    import numpy as np
    from chip_smoke import MERGE_ROWS_CASES, _merge_rows_inputs
    from repro_torch.kernels import ops
    out = []
    for label, q, w, h, kind in MERGE_ROWS_CASES:
        rows, ids_s, ids_t = _merge_rows_inputs(
            q, w, h, kind, np.random.default_rng(q * 7 + w))
        out.append((label, "rows", (rows, ids_s, ids_t),
                    ops.label_merge_rows(rows, ids_s, ids_t, force="ref")))
    for q, w in DENSE:
        rows, ids_s, ids_t = _merge_rows_inputs(
            q, w, 2049, "random", np.random.default_rng(q + w))
        labs, labt = rows[ids_s.long()], rows[ids_t.long()]
        out.append((f"dense q={q} W={w}", "dense", (labs, labt),
                    ops.label_merge(labs, labt, force="ref")))
    return out


def _runner(lib, entry, inputs, team, vec, copies):
    """fn() launching ``entry`` of ``lib`` on the next of ``copies``
    (copies of ``inputs``' tables), and the output it writes."""
    import torch
    q = inputs[1].shape[0] if entry == "rows" else inputs[0].shape[0]
    w = inputs[0].shape[1]
    out = torch.empty(q, dtype=torch.float32, device=inputs[0].device)
    lg = team.bit_length() - 1
    turn = iter(range(1 << 30))

    def fn():
        c = copies[next(turn) % len(copies)]
        stream = torch.cuda.current_stream().cuda_stream
        if entry == "rows":
            err = lib.label_merge_rows(c[0].data_ptr(), c[1].data_ptr(),
                                       c[2].data_ptr(), out.data_ptr(), q,
                                       w, lg, vec, stream)
        else:
            err = lib.label_merge(c[0].data_ptr(), c[1].data_ptr(),
                                  out.data_ptr(), q, w, lg, stream)
        if err:
            raise RuntimeError(f"label_merge {entry}: CUDA error {err}")
    return fn, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cols", type=int, nargs="+", default=[4, 8, 16])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("label_merge_tune: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _COLD_BYTES, WINDOWS, _device_ms
    from repro_torch.kernels import label_merge as lm
    procs = {c: _build(c) for c in args.cols}
    running = {v: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
               for v, (cmd, _out) in procs.items()}
    libs = {}
    for v, proc in running.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas cols={v}: {line.strip()}")
        if proc.returncode:
            print(f"  build cols={v} failed:\n{log}")
            continue
        libs[v] = _load(procs[v][1])
    for label, entry, inputs, want in _cases():
        nbytes = sum(4 * x.numel() for x in inputs if x.is_floating_point())
        n = min(1024, max(2, -(-_COLD_BYTES // nbytes)))
        copies = [tuple(x.clone() if x.is_floating_point() else x
                        for x in inputs) for _ in range(n)]
        q = inputs[1].shape[0] if entry == "rows" else inputs[0].shape[0]
        rec = {"case": label, "entry": entry, "q": q,
               "w": inputs[0].shape[1], "copies": n,
               "team_picked": lm.team(q, inputs[0].shape[1]), "ms": {}}
        for cols, lib in libs.items():
            for vec in ((1, 0) if cols == lm.COLS and entry == "rows"
                        else (1,)):
                for team in TEAMS:
                    fn, out = _runner(lib, entry, inputs, team, vec, copies)
                    fn()
                    torch.cuda.synchronize()
                    key = f"cols={cols} vec={vec} team={team}"
                    if not torch.equal(out, want):
                        rec["ms"][key] = "NOT EQUAL"
                        continue
                    rec["ms"][key] = _device_ms(fn, 20)
        timed = {k: v for k, v in rec["ms"].items() if isinstance(v, float)}
        rec["fastest"] = min(timed, key=timed.get) if timed else None
        rec["picked_ms"] = rec["ms"].get(
            f"cols={lm.COLS} vec=1 team={rec['team_picked']}")
        print(json.dumps(rec), flush=True)
        del copies
        torch.cuda.empty_cache()
    print(json.dumps({"profiler_windows": WINDOWS}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
