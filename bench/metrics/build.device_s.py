"""Seconds of the device build: the sum of ``plan.build_timings``, each
stage of ``build_device_index_with_plan`` ending in a synchronise."""


def read(ctx):
    bt = ctx["build"]["device"]
    return float(sum(bt.values())) if bt else None
