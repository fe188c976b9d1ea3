"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed in bfloat16, the precision
below the float32 the configurations state.  It has to come out as not
correct on every seed.

    python3 bench/tools/control.py --workload NAME --seeds 1,2,3 [--workers 6]

builds the cell's inputs from each seed at the cell's own size, answers the
queries a run would check with the bfloat16 reference, and prints, for each
seed, the numbers compared beside their limits as one JSON line.
"""
import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from portbench import checks, gen, harness  # noqa: E402


def control(config: dict, traffic: dict, seed: int, *,
            workers: int = 0) -> checks.Check:
    """The check of one run in which the bfloat16 reference answered the
    first ``check`` pairs of the run's pair stream."""
    inputs = harness.Inputs(config, seed)
    run = harness.Run(traffic, inputs, None, None, seed, 0.0, False)
    g = inputs.graph

    def served(pairs):
        return checks.exact(g.n, g.edge_u, g.edge_v, g.edge_w, pairs,
                            workers=workers, bf16=True)
    k = traffic["check"]
    res = {"pairs": run.pairs(gen.PAIRS)(k), "dists": [0.0] * k}
    return harness.check(run, res, workers=workers, served=served)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    wl = harness.cell(harness.manifest(), args.workload)
    config = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    for seed in (int(x) for x in args.seeds.split(",")):
        ck = control(config, traffic, seed, workers=args.workers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ck.correct, "checks": ck.items}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
