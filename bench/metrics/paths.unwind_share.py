"""Share of the path batches' host time spent in the host unwinder: the
benchmark's spans around ``PathUnwinder.unwind_many`` over its spans around
``EpochedEngine.query_path``, whose other call is the planner's witness
batch, over the whole window."""


def read(ctx):
    sp = ctx.get("spans")
    if sp is None:
        return None
    lo, hi = ctx["t0"], ctx["t_end"]
    total = sp.seconds("query_path", lo, hi)
    return 100.0 * sp.seconds("unwind", lo, hi) / total if total else None
