"""Share of the planner's buckets that replayed a CUDA graph: the program's
``planner.bucket`` spans of the traced window's ``serve.batch`` spans whose
``graph`` tag is "replay", over all of them (the others say "capture", a
graph captured first, or "eager").  None where the window holds no bucket,
or no bucket carries the tag (a program without the graph path)."""
from portbench import spans


def read(ctx):
    evs = spans.window_events(ctx)
    if evs is None:
        return None
    ids = spans.batches(evs)
    tags = [args.get("graph") for n, _a, _b, args in evs
            if n == "planner.bucket" and args.get("batch") in ids]
    if all(g is None for g in tags):
        return None
    return 100.0 * sum(g == "replay" for g in tags) / len(tags)
