"""Share of the planner's bucket slots that hold filler queries: Σ
(``padded`` - ``queries``) / Σ ``padded`` over the program's
``planner.bucket`` spans of the traced window's ``serve.batch`` spans (each
bucket is padded to a power of two with (0, 0) pairs, which the card serves
as it serves real ones)."""
from portbench import spans


def read(ctx):
    evs = spans.window_events(ctx)
    if evs is None:
        return None
    ids = spans.batches(evs)
    padded = real = 0
    for n, _a, _b, args in evs:
        if n == "planner.bucket" and args.get("batch") in ids:
            padded += args["padded"]
            real += args["queries"]
    return 100.0 * (padded - real) / padded if padded else None
