"""Route decisions per read of the card in the host unwinder: Σ ``routes``
/ Σ ``passes`` of the program's ``paths.unwind`` events in the traced
window (each ``PathUnwinder.unwind_many`` call decides the batch's
hierarchical routes a grouping level at a time, one read a level pass).
A program whose events carry no ``routes`` gives nothing."""
from portbench import spans


def read(ctx):
    evs = spans.window_events(ctx)
    if evs is None:
        return None
    routes = passes = 0
    for n, _a, _b, args in evs:
        if n == "paths.unwind" and "routes" in args:
            routes += args["routes"]
            passes += args["passes"]
    return routes / passes if passes else None
