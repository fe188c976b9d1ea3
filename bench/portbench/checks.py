"""The comparison that decides ``correct``: what the timed path answered,
held against the plain reference (``bench/reference/roadref.py``) on the
inputs the benchmark handed to both.

Every number compared has a limit; an exact comparison has the limit 0.
``Check`` collects them, and ``correct`` is true only when each holds.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np

REF_DIR = Path(__file__).resolve().parents[1] / "reference"
if str(REF_DIR) not in sys.path:
    sys.path.insert(0, str(REF_DIR))

import roadref  # noqa: E402  (the reference, beside the benchmark)


class Check:
    """Numbers compared, each with its limit: ``at_most`` or ``at_least``."""

    def __init__(self):
        self.items: dict = {}

    def at_most(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": value, "limit": limit, "must": "<="}

    def at_least(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": value, "limit": limit, "must": ">="}

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] if c["must"] == "<="
                   else c["value"] >= c["limit"]
                   for c in self.items.values())

    def lines(self) -> list:
        return [f"check {k}: {c['value']} (must be {c['must']} "
                f"{c['limit']})" for k, c in self.items.items()]


# -- exact answers, in worker processes ------------------------------------
_W: dict = {}


def _init(n, eu, ev, w):
    _W["road"] = roadref.Road(n, eu, ev, w)


def _solve(task):
    pairs, bf16 = task
    return roadref.exact(_W["road"], pairs, bf16=bf16)


def exact(n: int, eu, ev, w, pairs, *, workers: int = 0,
          bf16: bool = False) -> np.ndarray:
    """Reference distances of ``pairs`` ([q, 2]) on the graph of edges
    (eu, ev) weighing ``w``.  ``workers`` > 0 spreads the searches over
    that many spawned processes, which are stopped before this returns."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    step = max(1, math.ceil(len(pairs) / max(1, workers)))
    tasks = [(pairs[a:a + step], bf16) for a in range(0, len(pairs), step)]
    if workers <= 0:
        _init(n, eu, ev, w)
        try:
            res = [_solve(t) for t in tasks]
        finally:
            _W.clear()
    else:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(workers, initializer=_init,
                      initargs=(n, eu, ev, w)) as pool:
            res = pool.map(_solve, tasks, chunksize=1)
            pool.close()
            pool.join()
    return np.concatenate(res) if res else np.empty(0)


def compare(check: Check, served, want, *, prefix: str = "") -> None:
    """Exact comparison of served distances with the reference's: the
    count that differ (+inf against a finite value included) and the
    largest finite gap, both with the limit 0."""
    served = np.asarray(served, np.float64)
    want = np.asarray(want, np.float64)
    differ = ~((served == want) | (np.isinf(served) & np.isinf(want)
                                   & (np.sign(served) == np.sign(want))))
    both = np.isfinite(served) & np.isfinite(want)
    gap = float(np.abs(served[both] - want[both]).max()) if both.any() \
        else 0.0
    check.at_most(prefix + "mismatches", int(differ.sum()), 0)
    check.at_most(prefix + "max_gap", gap, 0)
