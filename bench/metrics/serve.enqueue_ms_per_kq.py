"""Host milliseconds per 1,000 queries spent issuing the serve programs'
torch ops: the program's ``serve.program`` spans (the call of a planner
bucket's program, which returns before the card is done) of the traced
window's ``serve.batch`` spans, over their queries."""
from portbench import spans


def read(ctx):
    return spans.per_kquery(ctx, "serve.program",
                            lambda a, b, args: 1e3 * (b - a))
