"""The program's own spans inside a traced window: the events of the port's
tracer (``repro_torch.obs.trace``), which records while the traced run's
``torch.profiler`` session runs, put back on the host clock through the
tracer's ``origin``.

A program without those spans (no ``origin``, or nothing recorded) gives
None, as does a window from which the tracer dropped events.
"""
from __future__ import annotations


def window_events(ctx) -> list | None:
    """[(name, t0, t1, args)] of the program's events that lie inside
    the traced window ``ctx["device"]["t_start"]``-``["t_stop"]`` (host
    clock), or None where there is no window, the tracer has no
    ``origin`` or dropped events."""
    dev = ctx.get("device")
    if not dev:
        return None
    from repro_torch.obs import trace

    tr = trace.get_tracer()
    origin = getattr(tr, "origin", None)
    if origin is None or tr.dropped:
        return None
    lo, hi = dev["t_start"], dev["t_stop"]
    out = []
    for e in tr.events():
        a = origin + e["ts"] * 1e-6
        b = a + e["dur"] * 1e-6
        if lo <= a and b <= hi:
            out.append((e["name"], a, b, e["args"]))
    return out


def batches(evs: list) -> dict:
    """{batch id: (queries, t0, t1)} of the window's ``serve.batch``
    spans."""
    return {args["batch"]: (args["queries"], a, b)
            for name, a, b, args in evs if name == "serve.batch"}


def per_kquery(ctx, name: str, value) -> float | None:
    """Σ ``value(t0, t1, args)`` (milliseconds) of the ``name`` spans of
    the window's serve batches, per 1,000 of their queries; None where
    the window holds no batch, or no span gives a value."""
    evs = window_events(ctx)
    if evs is None:
        return None
    ids = batches(evs)
    queries = sum(q for q, _a, _b in ids.values())
    vals = [value(a, b, args) for n, a, b, args in evs
            if n == name and args.get("batch") in ids]
    vals = [v for v in vals if v is not None]
    if not queries or not vals:
        return None
    return sum(vals) / (queries / 1e3)
