"""Closed loop: back-to-back batches of the traffic's pairs through the
entry its file names (``EpochedEngine.query`` or ``.query_path``) until the
window closes.

Traffic parameters read here: ``entry``, ``batch`` (pairs a batch) and
``pairs`` (the mix, ``portbench.gen.pairs``).  In a traced run the
benchmark's spans cover each batch (named by the entry), each planner
bucket it dispatches (``planner.<case>``, ``witness.<case>``), and, for
paths, the unwinder's call (``unwind``).
"""
import time

import numpy as np

from portbench import gen


def warm(run) -> None:
    """Every planner bucket a batch can fill; for paths, one batch through
    the entry, which also builds the unwinder."""
    eng = run.engine
    eng.warmup(run.traffic["batch"])
    if run.traffic["entry"] == "query_path":
        p = run.pairs(gen.WARM)(run.traffic["batch"])
        eng.query_path(p[:, 0], p[:, 1])


def _instrument(run, entry: str):
    eng = run.engine
    pl = eng.planner
    for fns, prefix in ((pl._fns, "planner."), (pl._wfns, "witness.")):
        for case in list(fns):
            fns[case] = run.spans.wrap(prefix + case, fns[case])
    if entry == "query_path":
        uw = eng.unwinder()
        uw.unwind_many = run.spans.wrap("unwind", uw.unwind_many)
    return run.spans.wrap(entry, getattr(eng, entry))


def drive(run) -> dict:
    """-> {"pairs", "dists", and for paths "paths": one array a path} of
    every batch the window started, the one that straddles its close
    included (its answers are checked; the rates count only the batches
    that completed inside the window); ``run.ctx`` gets their completion
    times (``batch_ends``) and size (``batch_size``)."""
    entry = run.traffic["entry"]
    bs = run.traffic["batch"]
    call = _instrument(run, entry) if run.trace \
        else getattr(run.engine, entry)
    source = run.pairs(gen.PAIRS)
    pairs, dists, paths, ends = [], [], [], []
    run.open_window()
    while True:
        p = source(bs)
        out = call(p[:, 0], p[:, 1])
        now = time.perf_counter()
        run.maybe_stop_trace(now)
        pairs.append(p)
        if entry == "query_path":
            d, ps = out
            paths.extend(None if q is None else np.asarray(q, np.int32)
                         for q in ps)
        else:
            d = out
        dists.append(d)
        ends.append(now)
        if now > run.t_end:
            break
    run.ctx.update(batch_ends=ends, batch_size=bs)
    res = {"pairs": np.concatenate(pairs), "dists": np.concatenate(dists)}
    if entry == "query_path":
        res["paths"] = paths
    return res
