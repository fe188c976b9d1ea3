"""The reader of ``serve.graph_share`` on a synthetic tracer buffer and
traced window: the share of the window's planner buckets tagged
``graph`` = "replay"; nothing where no bucket carries the tag (a program
without the graph path) or there is no window; and on the CPU, where the
program runs every bucket eagerly, 0."""
import pytest

import portbench_small  # noqa: F401
from portbench import harness
from repro_torch.obs import trace

READ = harness.reader("serve.graph_share")


def _buffer(monkeypatch, tags):
    """A tracer in the program's place: one batch a tag list inside the
    window [10, 20] s (host clock), one bucket a tag (None: untagged), and
    one batch of four replayed buckets after the window."""
    tr = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "_DEFAULT", tr)
    o = tr.origin
    for bid, (a, batch) in enumerate(((11.0, tags), (21.0, ["replay"] * 4))):
        tr.event("serve.batch", o + a, o + a + 1.0, batch=bid,
                 queries=1024, witness=False)
        for i, g in enumerate(batch):
            b0 = o + a + 0.1 + 0.2 * i
            args = {} if g is None else {"graph": g}
            tr.event("planner.bucket", b0, b0 + 0.1, batch=bid,
                     case=f"c{i}", queries=100, padded=128, **args)
    return {"device": {"t_start": o + 10.0, "t_stop": o + 20.0}}


@pytest.mark.parametrize("tags, share", [
    (["replay"] * 4, 100.0),
    (["replay", "replay", "capture", "eager"], 50.0),
    (["eager", "capture"], 0.0),
    ([None, None], None),
    ([], None),
])
def test_share_of_replayed_buckets(monkeypatch, tags, share):
    ctx = _buffer(monkeypatch, tags)
    got = READ(ctx)
    assert got == (None if share is None else pytest.approx(share))
    assert READ({}) is None


def test_the_cpu_replays_nothing(monkeypatch):
    """The program's own spans: on the CPU every bucket runs eagerly."""
    import time

    import numpy as np
    from repro_torch.core.dist_engine import EpochedEngine
    from repro_torch.core.graph import road_like

    g = road_like(600, seed=1)
    eng = EpochedEngine(g, device="cpu", hierarchy_levels=1,
                        warm_refresh=False)
    rng = np.random.default_rng(1)
    tr = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "_DEFAULT", tr)
    t0 = time.perf_counter()
    eng.query(rng.integers(0, g.n, 64), rng.integers(0, g.n, 64))
    ctx = {"device": {"t_start": t0, "t_stop": time.perf_counter()}}
    assert READ(ctx) == 0.0
