"""Share of the traced window in which no operation ran on the card:
1 - (union of kernel, copy and set intervals) / window."""


def read(ctx):
    dev = ctx.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
