"""The path unwinder's level passes on the card, at road64k scale
(``road_like(64000, seed 0)`` at 3 levels, the benchmark's road64k-l3 index
without its hub tier).

No JAX here (the card's machine has none).  Batches of 16 uniform pairs,
as the benchmark's paths cell sends them, unwind with the card in
``torch.cuda.set_sync_debug_mode("error")`` but for the one read of each
level pass (``PathUnwinder._wait``): deciding a level's routes makes no
other call that waits on the card.  While the tracer records, each batch's
``paths.unwind`` event counts one read a pass (``syncs`` == ``passes``),
at most one pass a grouping level.  Every path is, node for node, the one
the reference's route derivation gives: ``repro/core/paths.py``'s
``_route`` and ``_dist_block`` (per pair and level, numpy gather cubes on
the host) rewritten here without JAX and run on CPU copies of the
unwinder's tables; its weights sum to the served distance.  Skips without
a card; on one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paths_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dist_engine import EpochedEngine
from repro_torch.core.graph import road_like
from repro_torch.core.paths import path_weight
from repro_torch.obs import trace

BATCH = 16
_BUILT: dict = {}


@pytest.fixture
def road64k():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if "eng" not in _BUILT:
        g = road_like(64000, seed=0)
        eng = EpochedEngine(g, device="cuda", hierarchy_levels=3,
                            warm_refresh=False, paths=True)
        _BUILT["eng"] = (g, eng)
    return _BUILT["eng"]


def _batches(g, eng, n, seed):
    """n batches of BATCH uniform pairs with their served witnesses."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s, t = rng.integers(0, g.n, BATCH), rng.integers(0, g.n, BATCH)
        out.append((s, t, *eng.planner.query_witness(s, t)))
    return out


class _Reference:
    """The reference's route derivation on CPU copies of an unwinder's
    tables: per pair, at each grouping level, the same-group closure
    against the best lift over the groups' valid boundary slots through
    the distance block one level up (the reference's gather cube), first
    minimum of np.argmin; -> {level: (a slot, b slot)} where it lifts."""

    def __init__(self, uw):
        self.hier = uw.hier
        self.cls = [c.cpu().numpy() for c in uw.sf_closure]
        self.row = [r.cpu().numpy() for r in uw.l2row]
        self.d2 = uw.d2.cpu().numpy()

    def block(self, lvl, xs, ys):
        xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
        if lvl == len(self.hier) + 1:
            return self.d2[np.ix_(xs, ys)]
        inf = np.float32(np.inf)
        if xs.size == 0 or ys.size == 0:
            return np.full((xs.size, ys.size), inf, np.float32)
        h = self.hier[lvl - 1]
        sfx, px = h.sf_of[xs], h.pos_in_sf[xs]
        sfy, py = h.sf_of[ys], h.pos_in_sf[ys]
        out = np.where(sfx[:, None] == sfy[None, :],
                       self.cls[lvl - 1][sfx[:, None], px[:, None],
                                         py[None, :]], inf)
        row = self.row[lvl - 1]
        rx = np.where(h.bnd2_valid[sfx], row[sfx, px], inf)
        ry = np.where(h.bnd2_valid[sfy], row[sfy, py], inf)
        ix = np.where(h.bnd2_valid[sfx], h.bnd2_sid[sfx], 0)
        iy = np.where(h.bnd2_valid[sfy], h.bnd2_sid[sfy], 0)
        u, inv = np.unique(np.concatenate([ix.ravel(), iy.ravel()]),
                           return_inverse=True)
        mix = inv[:ix.size].reshape(ix.shape)
        miy = inv[ix.size:].reshape(iy.shape)
        b = self.block(lvl + 1, u, u)
        x2 = np.min(rx[:, :, None] + b[mix], axis=1)
        return np.minimum(out, np.min(x2[:, miy] + ry[None, :, :], axis=2))

    def lifts(self, x, y):
        out = {}
        for lvl in range(1, len(self.hier) + 1):
            h = self.hier[lvl - 1]
            sfx, sfy = int(h.sf_of[x]), int(h.sf_of[y])
            px, py = int(h.pos_in_sf[x]), int(h.pos_in_sf[y])
            va = (self.cls[lvl - 1][sfx, px, py] if sfx == sfy
                  else np.float32(np.inf))
            vx = np.nonzero(h.bnd2_valid[sfx])[0]
            vy = np.nonzero(h.bnd2_valid[sfy])[0]
            vb = np.float32(np.inf)
            if vx.size and vy.size:
                row = self.row[lvl - 1]
                tot = (row[sfx, px, vx][:, None]
                       + self.block(lvl + 1, h.bnd2_sid[sfx, vx],
                                    h.bnd2_sid[sfy, vy])
                       + row[sfy, py, vy][None, :])
                ai, bi = np.unravel_index(int(np.argmin(tot)), tot.shape)
                vb = tot[ai, bi]
            assert np.isfinite(va) or np.isfinite(vb)
            if va <= vb:
                break
            a, b = int(vx[ai]), int(vy[bi])
            out[lvl] = (a, b)
            x, y = int(h.bnd2_sid[sfx, a]), int(h.bnd2_sid[sfy, b])
        return out


@pytest.mark.cuda
def test_level_passes_read_the_card_once_a_level(road64k, monkeypatch):
    g, eng = road64k
    uw = eng.unwinder()
    levels = len(uw.hier)
    assert levels == 2
    batches = _batches(g, eng, 7, seed=11)
    uw.unwind_many(*batches[0])          # builds the kernels' libraries
    wait = uw._wait

    def read_outside(read, *args):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return wait(read, *args)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(uw, "_wait", read_outside)
    tr = trace.get_tracer()
    tr.clear()
    tr.enable()
    outs = []
    try:
        for b in batches[1:]:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(uw.unwind_many(*b))
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        tr.enable(False)
    evs = [e["args"] for e in tr.events() if e["name"] == "paths.unwind"]
    tr.clear()
    assert len(evs) == len(outs) == 6
    for args in evs:
        assert args["syncs"] == args["passes"]
        assert 1 <= args["passes"] <= levels
        assert args["passes"] <= args["routes"] <= BATCH * args["passes"]
    for (s, t, dist, _wit), paths in zip(batches[1:], outs):
        for a, b, d, p in zip(s, t, dist, paths):
            assert p[0] == a and p[-1] == b
            assert path_weight(g, p) == float(d)


@pytest.mark.cuda
def test_paths_are_the_reference_routes_node_for_node(road64k, monkeypatch):
    g, eng = road64k
    uw = eng.unwinder()
    ref = _Reference(uw)
    batches = _batches(g, eng, 3, seed=12)
    got = [uw.unwind_many(*b) for b in batches]

    def reference_routes(x, y):
        return [ref.lifts(int(a), int(b)) for a, b in zip(x, y)], 0, 0

    monkeypatch.setattr(uw, "_decide_routes", reference_routes)
    want = [uw.unwind_many(*b) for b in batches]
    lifted = 0
    for (s, t, dist, wit), gp, wp in zip(batches, got, want):
        assert gp == wp
        for a, b, d, p in zip(s, t, dist, gp):
            assert path_weight(g, p) == float(d)
        x, y = wit[wit >= 0] // uw.s1, wit[wit >= 0] % uw.s1
        lifted += sum(bool(ref.lifts(int(a), int(b))) for a, b in zip(x, y))
    assert lifted > 0
