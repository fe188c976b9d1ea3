"""The planner's CUDA graphs on the card (``core/graphs.py``).

No JAX here (the card's machine has none).  On road4000 (the dense
overlay) and on ``road_like(2500, 3)`` at 3 levels (resident rows: every
planner case reachable), each warmed at a batch of 1,024 with the witness
programs: every graph, at every case and padded size 16-1,024, replays
array-equal to its program run eagerly on the same padded pair, outputs
and pads alike; so do the graphs of a refresh epoch (``apply_updates``),
whose publish captures none: its first batches capture the keys they
use, a warm-up the rest; batches through the planner equal an eager
planner's, distances and witnesses.  A replay adds to the kernel
wrappers' ``.launches`` what its program run eagerly adds.  With the tracer recording, every
replayed ``serve.lift`` and ``serve.leg`` span carries its card interval
(inside the batch's host span) and every leg its ``passed`` count.
Skips without a card; on one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graph_replay_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.dist_engine import EpochedEngine, QueryPlanner
from repro_torch.core.graph import road_like, traffic_updates
from repro_torch.obs import trace

BATCH = 1024
GRAPHS = {"road4000": (4000, 0, 1), "road2500_l3": (2500, 3, 3)}
_BUILT: dict = {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _release_engines():
    """The engines (and their graphs) go with the module, before the
    next module's card tests run."""
    yield
    _BUILT.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _engine(name):
    if name not in _BUILT:
        n, seed, levels = GRAPHS[name]
        g = road_like(n, seed=seed)
        eng = EpochedEngine(g, device="cuda", hierarchy_levels=levels,
                            warm_refresh=False, paths=True)
        eng.warmup(BATCH)
        _BUILT[name] = (g, eng)
    return _BUILT[name]


def _graphs(pl, dix=None) -> dict:
    """{(kind, case, size): graph} of ``dix``'s epoch (default: the
    planner's current one); empty where it has no graph set."""
    gs = pl._graph_set(pl.dix if dix is None else dix)
    return {} if gs is None else gs.graphs


def _eager(dix) -> QueryPlanner:
    """A planner of ``dix`` that runs every bucket eagerly (no graph
    stream, as on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "new_stream", lambda device: None)
        return QueryPlanner(dix, paths=True)


def _pool(g, seed, n=40000):
    """Uniform pairs and pairs of nearby node ids (same DRA, same
    fragment)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, g.n, n)
    near = np.clip(s[n // 2:] + rng.integers(-3, 4, n - n // 2), 0, g.n - 1)
    return s, np.concatenate([rng.integers(0, g.n, n // 2), near])


def _padded(planner, g, case, m, seed):
    """A padded pair of bucket size ``m`` (real queries of ``case`` in its
    first half and one more, (0, 0) after) -> (s, t) int64 [m]."""
    s, t = _pool(g, seed)
    idx = planner.plan(s, t)[case]
    n = min(idx.size, m // 2 + 1)
    sp = np.zeros(m, np.int64)
    tp = np.zeros(m, np.int64)
    sp[:n] = s[idx[:n]]
    tp[:n] = t[idx[:n]]
    return sp, tp


def _check_every_graph(g, eng, seed):
    pl = eng.planner
    gs = pl._graph_set(eng.dix)
    keys = sorted(_graphs(pl))
    cases = [c for c in QueryPlanner.CASES
             if c != "cross_res" or eng.dix.res_rows.shape[0] > 1]
    assert {(k, c) for k, c, _m in keys} == {(k, c) for k in "dw"
                                              for c in cases}
    assert {m for _k, _c, m in keys} == set(pl.bucket_sizes(BATCH))
    for kind, case, m in keys:
        bg = _graphs(pl)[(kind, case, m)]
        sp, tp = _padded(pl, g, case, m, seed + m)
        bg.host_in_np[0] = sp
        bg.host_in_np[1] = tp
        bg.launch()
        gs.wait()
        fns = pl._fns if kind == "d" else pl._wfns
        want = fns[case](eng.dix, torch.from_numpy(sp).cuda(),
                         torch.from_numpy(tp).cuda())
        want = want if isinstance(want, tuple) else (want,)
        assert len(want) == len(bg.host_out_np)
        for h, w in zip(bg.host_out_np, want):
            np.testing.assert_array_equal(h, w.cpu().numpy(),
                                          err_msg=str((kind, case, m)))


def _check_batches(g, eng, seed):
    eager = _eager(eng.dix)
    s, t = _pool(g, seed)
    before = eng.planner.graph_counts["replay"]
    for n in (1, 17, 300, BATCH):
        sb, tb = s[n:2 * n], t[n:2 * n]
        want = eager.query(sb, tb)
        want_d, want_w = eager.query_witness(sb, tb)
        # twice: in a new epoch the first captures, the second replays
        for _ in range(2):
            np.testing.assert_array_equal(eng.query(sb, tb), want)
            d, w = eng.planner.query_witness(sb, tb)
            np.testing.assert_array_equal(d, want_d)
            np.testing.assert_array_equal(w, want_w)
    assert eng.planner.graph_counts["replay"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_replay_equals_eager_at_every_case_and_size(cuda_device, name):
    g, eng = _engine(name)
    _check_every_graph(g, eng, seed=1)
    _check_batches(g, eng, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_replay_equals_eager_after_a_published_epoch(cuda_device, name):
    g, eng = _engine(name)
    old = eng.dix
    keys = set(_graphs(eng.planner))
    captured = eng.planner.graph_counts["captured"]
    u, v, w = traffic_updates(eng.g, 0.02, seed=5)
    eng.apply_updates(u, v, w)
    assert eng.dix is not old
    assert _graphs(eng.planner) == {}
    assert _graphs(eng.planner, old) == {}
    assert eng.planner.graph_counts["captured"] == captured
    before = eng.planner.graph_counts["capture"]
    _check_batches(eng.g, eng, seed=4)
    assert eng.planner.graph_counts["capture"] > before
    assert set(_graphs(eng.planner)) <= keys
    eng.warmup(BATCH)
    assert set(_graphs(eng.planner)) == keys
    assert eng.planner.graph_counts["captured"] == captured + len(keys)
    _check_every_graph(eng.g, eng, seed=3)


@pytest.mark.cuda
def test_replayed_spans_carry_card_time_and_passed(cuda_device):
    g, eng = _engine("road2500_l3")
    s, t = _pool(g, 6)
    s, t = s[:BATCH], t[:BATCH]
    eng.query(s, t)
    tr = trace.get_tracer()
    tr.clear()
    tr.enable()
    try:
        for _ in range(3):
            eng.query(s, t)
        evs = tr.drain()
    finally:
        tr.enable(False)
        tr.clear()
    buckets = [e for e in evs if e["name"] == "planner.bucket"]
    assert buckets and all(e["args"]["graph"] == "replay" for e in buckets)
    batches = {e["args"]["batch"]: e for e in evs
               if e["name"] == "serve.batch"}
    assert len(batches) == 3
    spans = [e for e in evs if e["name"] in ("serve.lift", "serve.leg")]
    assert {e["name"] for e in spans} == {"serve.lift", "serve.leg"}
    for e in spans:
        args = e["args"]
        assert args["device_ms"] > 0, e
        if e["name"] == "serve.leg":
            assert isinstance(args["passed"], int)
            assert 0 <= args["passed"] <= BATCH
        b = batches[args["batch"]]
        # the card ran the span's work inside its batch's host span
        assert b["ts"] <= args["device_ts"]
        assert (args["device_ts"] + 1e3 * args["device_ms"]
                <= b["ts"] + b["dur"])
    # each batch's spans ran one after another, in bucket and capture
    # order (one stream)
    for bid in batches:
        mine = [e["args"] for e in spans if e["args"]["batch"] == bid]
        for a, b in zip(mine, mine[1:]):
            assert b["device_ts"] >= a["device_ts"] + 1e3 * a["device_ms"] \
                - 1.0, (a, b)


def _counters() -> dict:
    """{name: kernel wrapper} of every wrapper that counts its launches."""
    from repro_torch.kernels import (floyd_warshall, gather_minplus,
                                     label_merge, minplus, minplus_twoside)
    return {f"{m.__name__}.{k}": f
            for m in (floyd_warshall, gather_minplus, label_merge, minplus,
                      minplus_twoside)
            for k, f in vars(m).items()
            if callable(f) and hasattr(f, "launches")}


def _launched(call) -> dict:
    """{wrapper name: launches counted} while ``call()`` runs."""
    counters = _counters()
    before = {k: f.launches for k, f in counters.items()}
    call()
    torch.cuda.synchronize()
    return {k: f.launches - before[k] for k, f in counters.items()
            if f.launches != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_replay_counts_the_launches_it_runs(cuda_device, name):
    _g, eng = _engine(name)
    pl = eng.planner
    gathers = 0
    for (kind, case, m), bg in sorted(_graphs(pl).items()):
        fns = pl._fns if kind == "d" else pl._wfns
        z = torch.zeros(m, dtype=torch.int64, device="cuda")
        eager = _launched(lambda: fns[case](eng.dix, z, z))
        assert _launched(bg.launch) == eager, (kind, case, m)
        gathers += sum(n for k, n in eager.items() if "gather_minplus" in k)
    # the 3-level graph's lifts and legs are gather kernels
    assert gathers > 0 or GRAPHS[name][2] == 1
