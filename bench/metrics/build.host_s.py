"""Seconds of the host build (core/supergraph.py): ``ix.timings
["host_build_s"]``, or the sum of its stages where the build streamed into
the engine and left that key out (as launch/serve.py reads it)."""


def read(ctx):
    t = ctx["build"]["host"]
    if "host_build_s" in t:
        return float(t["host_build_s"])
    return float(sum(t.values())) if t else None
