"""Share of the host unwinder's time spent in reads that wait on the card:
Σ ``sync_s`` / Σ duration of the program's ``paths.unwind`` events in the
traced window."""
from portbench import spans


def read(ctx):
    evs = spans.window_events(ctx)
    if evs is None:
        return None
    waited = total = 0.0
    for n, a, b, args in evs:
        if n == "paths.unwind":
            waited += args["sync_s"]
            total += b - a
    return 100.0 * waited / total if total > 0 else None
