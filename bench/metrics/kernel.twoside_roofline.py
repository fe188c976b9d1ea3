"""Kernel 2's share of its roofline: the least time its calls could take
(bytes at the HBM rate or operations at the float32 rate, whichever is
larger, from the work their operands need: ``portbench.roofline``) over
the device time of their launches, for the calls the traced run recorded,
matched in launch order with the trace."""


def read(ctx):
    k2 = ctx.get("twoside")
    if not k2 or not k2["calls"] or k2["device_s"] <= 0:
        return None
    return 100.0 * k2["bound_s"] / k2["device_s"]
