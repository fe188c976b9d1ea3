"""Queries answered per second: the queries of the batches through
``EpochedEngine.query`` that completed inside the window, over the
window's length."""
from portbench import stats


def read(ctx):
    if ctx.get("entry") != "query" or ctx.get("batch_ends") is None:
        return None
    ends = ctx["batch_ends"]
    return stats.rate([ctx["batch_size"]] * len(ends), ends, ctx["t0"],
                      ctx["t_end"])
