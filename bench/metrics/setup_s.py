"""Seconds from the process's start to the window's open: imports, the
graph, the host and device builds, and the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.get("setup_s")
