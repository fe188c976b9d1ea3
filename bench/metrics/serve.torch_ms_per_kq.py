"""Device milliseconds per 1,000 queries spent in kernels that are not the
port's hand-written ones (plain-torch gathers, reductions and elementwise
kernels of the lifts and legs), over the traced window, which holds whole
batches only."""


def read(ctx):
    dev = ctx.get("device")
    ends = ctx.get("batch_ends")
    if not dev or not ends:
        return None
    lo, hi = dev["t_start"], dev["t_stop"]
    q = ctx["batch_size"] * sum(lo <= t <= hi for t in ends)
    return 1e3 * dev["torch_kernel_s"] / (q / 1e3) if q else None
