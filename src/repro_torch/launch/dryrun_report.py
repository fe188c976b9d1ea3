"""The dry-run and roofline tables of the port's dry-run records: a copy
of ``experiments/make_report.py`` over ``launch/dryrun.py``'s records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_report \\
        [--dir experiments/dryrun_torch] > tables.md

Three tables, as the reference prints them: the dry-run matrix (status
and memory a cell), the roofline of the single-pod mesh, and the
multi-pod collective deltas.  Two columns of the matrix have no
analogue in the port's records and print ``-``: ``compile s`` (the port
compiles nothing; ``launch/dryrun.py``'s docstring) and ``fit GB
(args+temp)`` (the port has no SPMD partitioner, so it claims no
per-device temporary size and no fit; its global peak is in the
records as ``memory.temp_size_in_bytes_global``).  The roofline's
``model/HLO flops`` column is the model FLOPs over the matmul FLOPs the
port dispatched (``roofline.model_vs_hlo_flops``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

DEFAULT_DIR = os.path.join("experiments", "dryrun_torch")


def load(directory: str = DEFAULT_DIR) -> dict:
    """{(arch, shape, mesh): record} of every record in ``directory``."""
    recs = {}
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def render(recs: dict) -> list[str]:
    """The report's lines."""
    out = ["## Dry-run matrix (status, per-device memory)\n",
           "| arch | shape | mesh | ok | lower s | compile s | "
           "fit GB (args+temp) | notes |",
           "|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        if r["ok"]:
            out.append(f"| {a} | {s} | {m} | OK | {r['lower_s']:.1f} | "
                       f"- | - | {r.get('notes', '')} |")
        else:
            out.append(f"| {a} | {s} | {m} | **FAIL** | | | | "
                       f"{r.get('error', '')[:60]} |")
    out += ["", "## Roofline (single-pod, 256 chips; terms in "
            "seconds/step)\n",
            "| arch | shape | compute | memory | collective | dominant | "
            "model/HLO flops | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    rows = []
    for (a, s, m), r in sorted(recs.items()):
        if m != "single" or not r["ok"]:
            continue
        ro = r["roofline"]
        rows.append((ro["roofline_fraction"], a, s, ro))
    for frac, a, s, ro in sorted(rows, reverse=True):
        out.append(f"| {a} | {s} | {ro['compute_s']:.4f} | "
                   f"{ro['memory_s']:.4f} | {ro['collective_s']:.4f} | "
                   f"{ro['dominant'].replace('_s', '')} | "
                   f"{ro['model_vs_hlo_flops']:.3f} | {frac:.4f} |")
    out += ["", "## Multi-pod deltas (512 chips vs 256; collective "
            "term)\n",
            "| arch | shape | coll_s single | coll_s multipod | "
            "pod-axis overhead |",
            "|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        if m != "single" or not r["ok"]:
            continue
        r2 = recs.get((a, s, "multipod"))
        if not r2 or not r2["ok"]:
            continue
        c1 = r["roofline"]["collective_s"]
        c2 = r2["roofline"]["collective_s"]
        ovh = (c2 - c1) / c1 if c1 > 0 else float("nan")
        out.append(f"| {a} | {s} | {c1:.4f} | {c2:.4f} | {ovh:+.1%} |")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DEFAULT_DIR,
                    help="directory of the dry-run records")
    args = ap.parse_args(argv)
    print("\n".join(render(load(args.dir))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
