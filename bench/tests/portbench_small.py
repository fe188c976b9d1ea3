"""Small stand-ins of the benchmark's cells for the CPU tests: the cells'
own configuration and traffic files with the graph, the hub tier, the
batch and the sample cut so that a run takes seconds on the CPU, where the
program runs its plain versions."""
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH.parent / "src", BENCH, BENCH / "reference"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import harness  # noqa: E402

CELLS = {"batch": "road64k-batch-uniform", "paths": "road64k-paths-uniform"}


def small(kind: str, *, check: int = 8, pairs=None) -> tuple:
    """(workload, config, traffic) of the road64k cell ``kind``, on
    road_like(1400, seed 23) at 3 levels with 64 hub nodes; ``pairs``
    replaces the traffic's mix."""
    wl = CELLS[kind]
    cell = harness.cell(harness.manifest(), wl)
    config = harness.load_json("configs", cell["config"])
    config["graph"] = {"generator": "road_like", "n_target": 1400,
                       "seed": 23}
    config["hub_tier"].update(budget=64, pool=256)
    traffic = harness.load_json("traffic", cell["traffic"])
    traffic["check"] = check
    if kind == "batch":
        traffic["batch"] = 64
    if pairs is not None:
        traffic["pairs"] = pairs
    return wl, config, traffic


def run(kind: str, seed: int = 7, seconds: float = 2.0, *,
        trace: bool = False, check: int = 8, pairs=None) -> dict:
    """One run of the small cell on the CPU -> the result record.  The
    program runs on one thread, so that test workers side by side do not
    oversubscribe the cores and starve the window."""
    import torch

    wl, config, traffic = small(kind, check=check, pairs=pairs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(wl, seed, seconds, trace,
                                t_proc=time.perf_counter(), device="cpu",
                                config=config, traffic=traffic,
                                ref_workers=0, log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(threads)
