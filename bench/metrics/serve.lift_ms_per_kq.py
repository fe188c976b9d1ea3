"""Card milliseconds of the lifts per 1,000 queries: Σ ``device_ms`` of the
program's ``serve.lift`` spans (``_lift_compact`` at each level and side,
``_lift_res``, ``_lift_src_of``) of the traced window's ``serve.batch``
spans, over their queries.  Each interval runs from the card reaching the
span's first work to it finishing the last: where the host launches more
slowly than the card runs (road64k), it includes those waits.  None on the
CPU, where the spans carry no card time."""
from portbench import spans


def read(ctx):
    return spans.per_kquery(ctx, "serve.lift",
                            lambda a, b, args: args.get("device_ms"))
