"""Reads that wait on the card per path in the host unwinder: Σ ``syncs`` /
Σ ``paths`` of the program's ``paths.unwind`` events in the traced window
(each ``PathUnwinder.unwind_many`` call; a read is a ``_host`` copy, a
``_dist_block`` or an ``.item()`` of the walk)."""
from portbench import spans


def read(ctx):
    evs = spans.window_events(ctx)
    if evs is None:
        return None
    syncs = paths = 0
    for n, _a, _b, args in evs:
        if n == "paths.unwind":
            syncs += args["syncs"]
            paths += args["paths"]
    return syncs / paths if paths else None
