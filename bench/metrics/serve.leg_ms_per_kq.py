"""Card milliseconds of the same-group legs per 1,000 queries: Σ
``device_ms`` of the program's ``serve.leg`` spans (``_hier_leg``,
``_hier_leg_w``, one a level) of the traced window's ``serve.batch`` spans,
over their queries.  Each interval runs from the card reaching the span's
first work to it finishing the last: where the host launches more slowly
than the card runs (road64k), it includes those waits.  None on the CPU,
where the spans carry no card time."""
from portbench import spans


def read(ctx):
    return spans.per_kquery(ctx, "serve.leg",
                            lambda a, b, args: args.get("device_ms"))
