"""The planner's own host milliseconds per 1,000 queries: the self time of
the program's ``serve.batch`` spans in the traced window (each span's
duration less its ``serve.program`` and ``planner.readback`` children, the
programs' enqueue and the blocking copies of their outputs), over their
queries.  What is left is bucketing, padding and staging, and the
scatter of the answers."""
from portbench import spans

CHILDREN = ("serve.program", "planner.readback")


def read(ctx):
    evs = spans.window_events(ctx)
    if evs is None:
        return None
    ids = spans.batches(evs)
    queries = sum(q for q, _a, _b in ids.values())
    if not queries:
        return None
    busy = sum(b - a for _q, a, b in ids.values())
    busy -= sum(b - a for n, a, b, args in evs
                if n in CHILDREN and args.get("batch") in ids)
    return 1e3 * busy / (queries / 1e3)
