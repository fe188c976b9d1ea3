"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``src/repro_torch``.  It builds the
cell's deployment from ``--seed``, warms up the cell's own shapes, measures
for ``--seconds``, checks what the timed path answered against the plain
reference in ``bench/reference/``, and prints the result as the last line of
its standard output (the compared numbers, each beside its limit, are the
last lines of its standard error; ``setup_compiled`` says whether set-up
built kernels, as the first run in a checkout does).  It exits with 2 and prints no result
without a CUDA card, and with 3 if JAX or the JAX package got loaded.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _env() -> None:
    """Every cache a run may write, at fixed paths inside the checkout
    (the program's own kernel builds go to src/repro_torch/csrc/build/)."""
    out = BENCH / "out"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(out / sub)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    from portbench import harness

    man = harness.manifest()
    wl = harness.cell(man, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_proc=T_PROC, man=man)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    lines = res.pop("_check_lines")
    e2e = res.pop("_e2e")
    compiled = res.pop("_compiled")
    if compiled:
        print(f"set-up compiled {len(compiled)} file(s), so its setup_s is "
              f"not a steady one: {', '.join(compiled)}", file=sys.stderr)
    print(f"end to end: {e2e}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
