# Copied from src/repro/core/paths.py; keep the two in step.  The port
# reads its torch index tables through _host (a CPU numpy copy) where
# the reference calls np.asarray.  On hierarchical epochs it derives the
# overlay routes of a whole batch a grouping level at a time
# (``_decide_routes``): each level's distance blocks and argmins are
# enqueued on the index's device for every pair of the batch from one
# upload and read back in one read, and only then are the paths walked
# on the host; the nodes of every path are the reference's.  While the
# tracer records it counts those reads (``_wait``), its route decisions
# and its level passes.
"""Host-side exact path reconstruction over the witness tables
(DESIGN.md §10).

The device index answers *distances* with (min,+) algebra; every
tropical reduction also records its argmin:

  * ``frag_next``  — first hop of each intra-fragment shortest path,
  * ``piece_next`` — the same for each DRA piece (flat layout shared
    with ``piece_flat``),
  * ``super_next`` — first hop through the SUPER overlay closure,
  * the serve-path combine returns the winning boundary pair (b1, b2)
    packed into an int32 witness (``serve_step_w`` and friends).

``PathUnwinder`` walks those tables back to a concrete node sequence.
Every super-overlay hop is overlay-*adjacent* by the successor-matrix
invariant, so it resolves to either an E_B slot (a real graph edge
between two boundary nodes) or a fragment boundary-clique slot, which
recursively unwinds through that fragment's ``frag_next``.  No graph
search runs anywhere — unwinding is pure table chasing, O(path length).

Exactness: each table's successor entries are argmins of the exact
distance recurrences, so the unwound edge sequence sums to exactly the
served distance (integer weights make f32/f64 agreement bitwise; the
differential harness in tests/test_torch_paths.py enforces equality
against both ``serve_step`` and host Dijkstra).

Epoch discipline: an unwinder snapshots the arrays it needs at
construction, so it stays internally consistent even while the engine
publishes new epochs; pair it with witnesses served by the *same*
epoch's index (one unwinder per index, as ``launch/serve.py --paths``
builds it).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from ..obs import trace
from . import hierarchy
from .device_engine import (WIT_LOCAL, WIT_NONE, WIT_PIECE, BuildPlan,
                            DeviceIndex, _overlay_size,
                            overlay_slot_table)


_INF = float("inf")


def _host(x) -> np.ndarray:
    """A device tensor as a host numpy array."""
    return x.cpu().numpy()


class _Stage:
    """Host index arrays gathered for one copy to the card: ``add``
    keeps an array (as int64) and returns its handle, ``load`` copies
    them all in one non-blocking upload from pinned memory and returns
    their device views, indexed by handle."""

    def __init__(self):
        self.parts: list = []

    def add(self, a) -> int:
        self.parts.append(np.asarray(a, np.int64))
        return len(self.parts) - 1

    def load(self, dev: torch.device) -> list:
        sizes = [a.size for a in self.parts]
        buf = torch.empty(sum(sizes), dtype=torch.int64,
                          pin_memory=dev.type == "cuda")
        if self.parts:
            np.concatenate([a.ravel() for a in self.parts],
                           out=buf.numpy())
        flat = buf.to(dev, non_blocking=True)
        return [f.view(a.shape) for f, a in zip(flat.split(sizes),
                                                self.parts)]


class _Ragged:
    """The flat layout of one row-major [n[p], m[p]] block a problem p,
    back to back: its offsets staged in a ``_Stage``, each element's
    problem and coordinates computed on the card from them."""

    def __init__(self, st: _Stage, n, m):
        n, m = np.asarray(n, np.int64), np.asarray(m, np.int64)
        end = np.cumsum(n * m)
        self.size = int(end[-1]) if end.size else 0
        self.h = [st.add(a) for a in (end, end - n * m, m, np.cumsum(n) - n,
                                      np.cumsum(m) - m)]

    def coords(self, v: list):
        """(problem, row, column) of every element."""
        end, start, m = (v[k] for k in self.h[:3])
        e = torch.arange(self.size, device=end.device)
        p = torch.searchsorted(end, e, right=True)
        loc = e - start[p]
        i = loc // m[p]
        return p, i, loc - i * m[p]

    def rows(self, v: list):
        """Each element's row and column as indices into the
        problems' concatenated row and column ids."""
        p, i, j = self.coords(v)
        return v[self.h[3]][p] + i, v[self.h[4]][p] + j


class PathUnwinder:
    """Walk witness tables from one epoch's (DeviceIndex, BuildPlan).

    Everything read from ``plan`` here is *structure* (piece registry,
    fragment/boundary lookups, SUPER slot topology), which weight
    updates never mutate — so a snapshot stays valid across refreshes.
    The one weight-dependent host table, the overlay slot provenance,
    travels WITH the index epoch (``dix.host_ov_slot``, written by the
    build/refresh stages); the plan-derived fallback below is for
    standalone indices that never saw a refresh.

    Hierarchical epochs (DESIGN.md §12/§13) have no dense
    ``super_next``; the overlay walk x -> y is instead *derived* here
    from the per-level snapshots (each level's group closures + the
    top closure): the winning route is recomputed over the per-pair
    candidate sets — the distance blocks as (min,+) products and the
    argmin on the index's device, for every pair of a batch at once, a
    grouping level at a time (``_decide_routes``), exact because every
    table entry is the same f32 the device served — and then expanded
    level by level on the host (``_walk_route`` recursing down the
    ladder) until every hop is overlay-adjacent, at which point the
    ordinary slot expansion below takes over.
    """

    def __init__(self, dix: DeviceIndex, plan: BuildPlan):
        self.plan = plan
        self.s1 = _overlay_size(dix)                 # S + 1
        # per thread: [reads, seconds] of the walk's waits on the card
        # while the tracer records (``_wait``), else absent
        self._waits = threading.local()
        # device tables, snapshotted to host numpy
        self.agent_of = _host(dix.agent_of)
        self.piece_gid = _host(dix.piece_gid)
        self.pos_in_piece = _host(dix.pos_in_piece)
        self.frag_next = _host(dix.frag_next)
        self.piece_next = _host(dix.piece_next)
        self.super_next = _host(dix.super_next)
        self.hier = plan.hier if len(dix.sf_of) else None
        if self.hier is not None:
            # per-grouping-level tables (lists indexed by lvl - 1): the
            # successor tables snapshotted to the host for the walks; the
            # distance tables stay on the index's device, where the
            # distance blocks are computed (no refresh writes a tensor of
            # a published epoch, so holding them pins this epoch)
            self.sf_next = [_host(a) for a in dix.sf_next]
            self.d2_next = _host(dix.d2_next)
            self.sf_closure = list(dix.sf_closure)
            self.l2row = list(dix.l2row)
            self.d2 = dix.d2
            self.dev = dix.d2.device
            self.valid_t = [torch.as_tensor(h.bnd2_valid).to(self.dev)
                            for h in self.hier]
            # per level and group: its valid boundary slots, and the
            # next-level ids its slots reach with each slot's index
            # among them (an invalid slot reaches id 0), as
            # np.unique(..., return_inverse=True) gives them; structure,
            # so a level pass sizes and scatters its blocks from the
            # host without reading the card
            self.vslots = [[np.nonzero(v)[0] for v in h.bnd2_valid]
                           for h in self.hier]
            self.next_ids = [
                [np.unique(k, return_inverse=True) for k in
                 np.where(h.bnd2_valid, h.bnd2_sid, 0).astype(np.int64)]
                for h in self.hier]
            self._sides: dict = {}            # ``_side``'s cache
            l2s = getattr(dix, "host_l2_slot", None)
            self.l2_slot = (list(l2s) if l2s is not None
                            else [hierarchy.l2_slot_map(h)
                                  for h in self.hier])
        # position -> original id, per fragment (inverse of the plan's
        # frag_of/pos_in_frag lookups)
        k, maxf = plan.k, plan.maxf
        self.frag_nodes = np.full((k, maxf), -1, np.int64)
        hot = np.nonzero(plan.frag_of >= 0)[0]
        self.frag_nodes[plan.frag_of[hot], plan.pos_in_frag[hot]] = hot
        # super id -> (home fragment, position, original id)
        S = plan.S
        self.super_frag = np.full(S, -1, np.int64)
        self.super_pos = np.zeros(S, np.int64)
        fi_idx, b_idx = np.nonzero(plan.bvalid)
        sid = plan.bnd_super[fi_idx, b_idx]
        self.super_frag[sid] = fi_idx
        self.super_pos[sid] = plan.bpos[fi_idx, b_idx]
        self.super_node = np.where(
            self.super_frag >= 0,
            self.frag_nodes[self.super_frag, self.super_pos], -1)
        # winning slot per overlay adjacency pair, paired with this
        # dix's overlay-closure epoch (see class docstring); dense
        # epochs carry the [S, S] table, hierarchical epochs the
        # sparse SlotMap (sub-quadratic host memory)
        ov = getattr(dix, "host_ov_slot", None)
        if ov is None:
            ov = (hierarchy.ov_slot_map(plan) if self.hier is not None
                  else overlay_slot_table(plan))
        self.ov_slot = ov

    def _slot_of(self, a: int, b: int) -> int:
        """Winning level-1 slot for overlay adjacency (a, b), -1 if
        none — dense-table or sparse-map lookup, whichever this epoch
        carries."""
        if isinstance(self.ov_slot, hierarchy.SlotMap):
            return self.ov_slot.lookup(a, b)
        return int(self.ov_slot[a, b])

    # ---- table walks ---------------------------------------------------
    def _frag_walk(self, fi: int, pa: int, pb: int) -> List[int]:
        """Original-id node sequence of the fragment-internal shortest
        path from position pa to pb (inclusive ends)."""
        nxt = self.frag_next[fi]
        seq = [pa]
        u = pa
        while u != pb:
            u = int(nxt[u, pb])
            if u < 0 or len(seq) > nxt.shape[0]:
                raise RuntimeError(
                    f"inconsistent frag_next walk (frag {fi}, "
                    f"{pa}->{pb})")
            seq.append(u)
        return [int(self.frag_nodes[fi, p]) for p in seq]

    def _piece_walk(self, gid: int, pa: int, pb: int) -> List[int]:
        plan = self.plan
        cap = int(plan.piece_cap[gid])
        base = int(plan.piece_base[gid])
        nxt = self.piece_next[base:base + cap * cap].reshape(cap, cap)
        members = plan.piece_members[gid]
        seq = [pa]
        u = pa
        while u != pb:
            u = int(nxt[u, pb])
            if u < 0 or len(seq) > cap:
                raise RuntimeError(
                    f"inconsistent piece_next walk (piece {gid}, "
                    f"{pa}->{pb})")
            seq.append(u)
        return [int(members[p]) for p in seq]

    def _leg_to_agent(self, s: int) -> List[int]:
        """s -> its agent, inside s's piece ([s] when s IS an agent or a
        trivial node)."""
        gid = int(self.piece_gid[s])
        if gid < 0:
            return [int(s)]
        return self._piece_walk(gid, int(self.pos_in_piece[s]),
                                int(self.plan.piece_agent_pos[gid]))

    def _super_walk(self, x: int, y: int) -> List[int]:
        """Overlay-adjacent super-id sequence x -> y on a dense epoch:
        a super_next chase."""
        seq = [x]
        u = x
        while u != y:
            u = int(self.super_next[u, y])
            if u < 0 or len(seq) > self.s1:
                raise RuntimeError(
                    f"inconsistent super_next walk ({x}->{y})")
            seq.append(u)
        return seq

    def _wait(self, read, *args):
        """``read(*args)``, a read that waits on the card; counted and
        timed while ``unwind_many`` traces."""
        w = getattr(self._waits, "acc", None)
        if w is None:
            return read(*args)
        t0 = time.perf_counter()
        try:
            return read(*args)
        finally:
            w[0] += 1
            w[1] += time.perf_counter() - t0

    # ---- hierarchical overlay walks (DESIGN.md §12/§13) ----------------
    # id/level vocabulary: "level-1 ids" are super (overlay) ids;
    # grouping level lvl (hier[lvl - 1]) groups level-lvl ids and its
    # group boundaries form the level-(lvl + 1) id space; the top
    # (lvl == len(hier) + 1) ids index the d2 closure.

    def _sf_walk(self, lvl: int, sf: int, pa: int, pb: int) -> List[int]:
        """Level-``lvl`` id sequence of the within-group shortest path
        from group-local position pa to pb (inclusive ends); every hop
        is level-``lvl``-adjacent by the successor-matrix invariant,
        one level up from _frag_walk."""
        h = self.hier[lvl - 1]
        nxt = self.sf_next[lvl - 1][sf]
        seq = [pa]
        u = pa
        while u != pb:
            u = int(nxt[u, pb])
            if u < 0 or len(seq) > nxt.shape[0]:
                raise RuntimeError(
                    f"inconsistent sf_next walk (lvl {lvl}, sf {sf}, "
                    f"{pa}->{pb})")
            seq.append(u)
        return [int(h.sf_members[sf, p]) for p in seq]

    def _l2_walk(self, c: int, d: int) -> List[int]:
        """Top-level-adjacent id sequence c -> d from d2_next."""
        seq = [c]
        u = c
        while u != d:
            u = int(self.d2_next[u, d])
            if u < 0 or len(seq) > self.d2_next.shape[0]:
                raise RuntimeError(
                    f"inconsistent d2_next walk ({c}->{d})")
            seq.append(u)
        return seq

    def _dist_block(self, lvl: int, xs, ys) -> np.ndarray:
        """[len(xs), len(ys)] exact distances between level-``lvl``
        ids from the epoch snapshots: the d2 closure at the top, else
        min(same-group closure, lift through the group boundary one
        level up) — the same recurrence the device combine evaluates.
        Integer edge weights keep every f32 sum exact, so an argmin
        over this block always reproduces a servable route.  Computed
        on the index's device (``_dist_block_t``), returned on the
        host."""
        return _host(self._dist_block_t(
            lvl, torch.as_tensor(np.asarray(xs, np.int64)),
            torch.as_tensor(np.asarray(ys, np.int64))))

    def _dist_block_t(self, lvl: int, xs: torch.Tensor,
                      ys: torch.Tensor) -> torch.Tensor:
        """``_dist_block`` on the index's device: the one problem of a
        ``_plan_block``."""
        st = _Stage()
        run = self._plan_block(st, lvl, [_host(xs).astype(np.int64)],
                               [_host(ys).astype(np.int64)])
        return run(st.load(self.dev))[0]

    def _plan_block(self, st: "_Stage", lvl: int, xs: list, ys: list):
        """Plan the distance blocks [len(xs[p]), len(ys[p])] between
        level-``lvl`` ids (int64 arrays) of each problem p, staging in
        ``st`` every index they take (structure, known on the host, so
        nothing is read from the card); returns ``run(v)``, which
        enqueues them on the index's device from the stage's device
        views ``v`` and returns each problem's block.

        Where the reference closes one level up the whole [U, U] block
        of both sides' boundary ids U and contracts it through a
        [|xs|, mb2, |U|] gather cube (O(S^3) host memory at road250k's
        depth), a problem here closes only [x side's ids, y side's ids]
        one level up (its problem of the next level's plan) and
        contracts it as two (min,+) products (``ops.minplus``) of its
        own boundary rows scattered to those ids: the same candidates,
        so the same exact values, and no problem's products grow with
        another's."""
        nx, ny = [a.size for a in xs], [a.size for a in ys]
        xc, yc = np.concatenate(xs), np.concatenate(ys)
        if lvl == len(self.hier) + 1:
            hx, hy = st.add(xc), st.add(yc)

            def top(v):
                return [self.d2.index_select(0, a).index_select(1, b)
                        for a, b in zip(v[hx].split(nx), v[hy].split(ny))]
            return top
        h = self.hier[lvl - 1]
        el = _Ragged(st, nx, ny)
        hs = [st.add(a) for a in (h.sf_of[xc], h.pos_in_sf[xc],
                                  h.sf_of[yc], h.pos_in_sf[yc])]
        ax, side_x = self._plan_side(st, lvl, xs, hs[0], hs[1], False)
        ay, side_y = self._plan_side(st, lvl, ys, hs[2], hs[3], True)
        up = self._plan_block(st, lvl + 1, ax, ay)
        cls = self.sf_closure[lvl - 1]
        shapes = list(zip(nx, [a.size for a in ax], [a.size for a in ay],
                          ny))

        def run(v):
            xr, yr = el.rows(v)
            sx, px, sy, py = (v[k] for k in hs)
            a, b = sx[xr], sy[yr]
            out = torch.where(a == b, cls[a, px[xr], py[yr]], _INF)
            rx, ryt = side_x(v), side_y(v)
            vb = []
            ox = oy = 0
            for (m, k, n, q), blk in zip(shapes, up(v)):
                if m and q:
                    t = ops.minplus(rx[ox:ox + m * k].view(m, k), blk)
                    vb.append(ops.minplus(
                        t, ryt[oy:oy + n * q].view(n, q)).view(-1))
                ox, oy = ox + m * k, oy + n * q
            d = torch.minimum(out, torch.cat(vb)) if vb else out
            return [f.view(m, q) for f, (m, _k, _n, q) in
                    zip(d.split([m * q for m, _k, _n, q in shapes]), shapes)]
        return run

    def _plan_side(self, st: "_Stage", lvl: int, xs: list, hsf: int,
                   hpos: int, transpose: bool):
        """One side of a ``_plan_block`` at grouping level ``lvl`` ->
        (each problem's next-level ids, as ``_side`` gives them;
        ``run(v)``, which scatters each problem's rows to its ids by
        min, [len(xs[p]), |ids|] row-major or its transpose, back to
        back in one flat tensor).  ``hsf``, ``hpos``: the handles of the
        staged groups and group-local positions of the concatenated
        ``xs``."""
        out, cols, grp, base, stride = [], [], [], [], []
        size = g0 = 0
        for x in xs:
            u, c, rel = self._side(lvl, x)
            n = x.size
            out.append(u)
            cols.append(c)
            grp.append(g0 + rel)
            i = np.arange(n, dtype=np.int64)
            base.append(size + (i if transpose else i * u.size))
            stride.append(np.full(n, n if transpose else 1, np.int64))
            size, g0 = size + n * u.size, g0 + c.shape[0]
        hc, hg, hb, hd = (st.add(np.concatenate(a))
                          for a in (cols, grp, base, stride))
        valid, row = self.valid_t[lvl - 1], self.l2row[lvl - 1]

        def run(v):
            s, p = v[hsf], v[hpos]
            vals = torch.where(valid[s], row[s, p], _INF)
            dest = v[hb][:, None] + v[hc][v[hg]] * v[hd][:, None]
            return torch.full((size,), _INF, device=self.dev).scatter_reduce_(
                0, dest.view(-1), vals.view(-1), "amin")
        return out, run

    def _side(self, lvl: int, x: np.ndarray):
        """One problem's side at grouping level ``lvl`` -> (the next-level
        ids its rows reach: the union of their groups' ``next_ids``,
        sorted; each of those groups' slot -> column map, [groups, mb];
        each row's group among them).  Structure, cached by the ids
        ``x``: on a route's path each is a function of one group, so the
        cache stays as small as the hierarchy."""
        key = (lvl, x.tobytes())
        hit = self._sides.get(key)
        if hit is None:
            nid = self.next_ids[lvl - 1]
            gs, rel = np.unique(self.hier[lvl - 1].sf_of[x],
                                return_inverse=True)
            u = np.unique(np.concatenate(
                [np.zeros(0, np.int64)] + [nid[g][0] for g in gs]))
            cols = np.array([np.searchsorted(u, nid[g][0])[nid[g][1]]
                             for g in gs], np.int64)
            hit = self._sides[key] = (
                u, cols.reshape(gs.size, self.hier[lvl - 1].mb2), rel)
        return hit

    def _decide(self, lvl: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """The level-``lvl`` route of every pair (x[p], y[p]) of
        level-``lvl`` ids, as the reference derives each: same-group
        closure ``va`` (+inf across groups) against the best lift
        ``vb`` = min over the groups' valid boundary slots (a, b) of
        (row(x, a) + block(a, b)) + row(y, b), in float32, its argmin
        the first minimum in row-major order of (a, b), as np.argmin's.
        One upload, everything enqueued, then one read (``_wait``):
        -> int64 [len(x), 4] of (va <= vb, a's index among x's group's
        valid slots, b's among y's, whether either is finite)."""
        h = self.hier[lvl - 1]
        sfx, px = h.sf_of[x].astype(np.int64), h.pos_in_sf[x].astype(np.int64)
        sfy, py = h.sf_of[y].astype(np.int64), h.pos_in_sf[y].astype(np.int64)
        vx = [self.vslots[lvl - 1][g] for g in sfx]
        vy = [self.vslots[lvl - 1][g] for g in sfy]
        st = _Stage()
        block = self._plan_block(
            st, lvl + 1,
            [h.bnd2_sid[g, v].astype(np.int64) for g, v in zip(sfx, vx)],
            [h.bnd2_sid[g, v].astype(np.int64) for g, v in zip(sfy, vy)])
        el = _Ragged(st, [v.size for v in vx], [v.size for v in vy])
        n = len(x)
        mx = max(1, max(v.size for v in vx))
        my = max(1, max(v.size for v in vy))
        slots = []
        for vs, m in ((vx, mx), (vy, my)):
            pad = np.zeros((n, m), np.int64)
            for p, v in enumerate(vs):
                pad[p, :v.size] = v
            slots.append(pad)
        hd = [st.add(a) for a in (sfx, px, sfy, py, *slots,
                                  [v.size for v in vx], [v.size for v in vy])]
        v = st.load(self.dev)
        sx, qx, sy, qy, ix, iy, nx, ny = (v[k] for k in hd)
        cls, row = self.sf_closure[lvl - 1], self.l2row[lvl - 1]
        va = torch.where(sx == sy, cls[sx, qx, qy], _INF)
        ar = torch.where(torch.arange(mx, device=self.dev) < nx[:, None],
                         row[sx[:, None], qx[:, None], ix], _INF)
        br = torch.where(torch.arange(my, device=self.dev) < ny[:, None],
                         row[sy[:, None], qy[:, None], iy], _INF)
        p, i, j = el.coords(v)
        blk = torch.full((n * mx * my,), _INF, device=self.dev).scatter_(
            0, (p * mx + i) * my + j,
            torch.cat([b.reshape(-1) for b in block(v)])).view(n, mx, my)
        tot = ((ar[:, :, None] + blk) + br[:, None, :]).view(n, -1)
        k = tot.argmin(1)
        vb = tot.gather(1, k[:, None])[:, 0]
        res = torch.stack([(va <= vb).long(), k // my, k % my,
                           (va.isfinite() | vb.isfinite()).long()], 1)
        return self._wait(_host, res)

    def _decide_routes(self, x: np.ndarray, y: np.ndarray):
        """Phase 1 of ``unwind_many``: the hierarchical route of every
        overlay pair (x[p], y[p]), decided a grouping level at a time for
        all pairs still climbing (``_decide``: one read a level) ->
        (per pair {level: (a slot, b slot)} of the levels where its route
        lifts through its groups' boundaries, route decisions, level
        passes)."""
        lifts = [{} for _ in range(len(x))]
        todo = np.arange(len(x))
        x, y = np.asarray(x, np.int64), np.asarray(y, np.int64)
        routes = passes = 0
        for lvl in range(1, len(self.hier) + 1):
            if not todo.size:
                break
            res = self._decide(lvl, x, y)
            routes, passes = routes + todo.size, passes + 1
            bad = np.nonzero(res[:, 3] == 0)[0]
            if bad.size:
                raise RuntimeError(f"unreachable level-{lvl} route "
                                   f"{x[bad[0]]}->{y[bad[0]]}")
            up = np.nonzero(res[:, 0] == 0)[0]
            h, vs = self.hier[lvl - 1], self.vslots[lvl - 1]
            sfx, sfy = h.sf_of[x[up]], h.sf_of[y[up]]
            a = np.array([vs[g][i] for g, i in zip(sfx, res[up, 1])],
                         np.int64)
            b = np.array([vs[g][i] for g, i in zip(sfy, res[up, 2])],
                         np.int64)
            for k, p in enumerate(todo[up]):
                lifts[p][lvl] = (int(a[k]), int(b[k]))
            todo = todo[up]
            x, y = (h.bnd2_sid[sfx, a].astype(np.int64),
                    h.bnd2_sid[sfy, b].astype(np.int64))
        return lifts, routes, passes

    def _expand_hop(self, lvl: int, a: int, b: int) -> List[int]:
        """One level-``lvl`` adjacency hop -> level-(lvl-1) ids AFTER
        a's node (cross slot: the far endpoint of the underlying
        level-(lvl-1) adjacency; clique slot: the within-group walk
        one level down)."""
        h = self.hier[lvl - 2]
        slot = self.l2_slot[lvl - 2].lookup(a, b)
        if slot < 0:
            raise RuntimeError(
                f"no level-{lvl} slot for hop {a}->{b}")
        ov = int(h.l2_ov_slot[slot])
        if ov >= 0:               # cross slot: one hop one level down
            if lvl == 2:
                su = int(self.plan.sup_src[ov])
                sv = int(self.plan.sup_dst[ov])
            else:
                hh = self.hier[lvl - 3]
                su, sv = int(hh.l2_src[ov]), int(hh.l2_dst[ov])
            return [sv] if int(h.sid2_of[su]) == a else [su]
        sf = int(h.l2_sf[slot])
        if int(h.l2_src[slot]) == a:
            pa, pb = int(h.l2_pu[slot]), int(h.l2_pv[slot])
        else:
            pa, pb = int(h.l2_pv[slot]), int(h.l2_pu[slot])
        return self._sf_walk(lvl - 1, sf, pa, pb)[1:]

    def _walk_route(self, lvl: int, x: int, y: int,
                    lifts: dict) -> List[int]:
        """Level-``lvl``-adjacent id sequence x -> y along the route
        ``_decide_routes`` decided (``lifts``: the boundary slots of the
        levels where it lifts; elsewhere it stays in x's group), the
        upper leg expanded hop by hop.  At the top it is a plain
        d2_next chase."""
        if lvl == len(self.hier) + 1:
            return self._l2_walk(x, y)
        h = self.hier[lvl - 1]
        sfx, sfy = int(h.sf_of[x]), int(h.sf_of[y])
        px, py = int(h.pos_in_sf[x]), int(h.pos_in_sf[y])
        if lvl not in lifts:
            return self._sf_walk(lvl, sfx, px, py)
        a_slot, b_slot = lifts[lvl]
        seq = self._sf_walk(lvl, sfx, px, int(h.bnd2_pos[sfx, a_slot]))
        up = self._walk_route(lvl + 1, int(h.bnd2_sid[sfx, a_slot]),
                              int(h.bnd2_sid[sfy, b_slot]), lifts)
        for u2, v2 in zip(up, up[1:]):
            seq += self._expand_hop(lvl + 1, u2, v2)
        seq += self._sf_walk(lvl, sfy, int(h.bnd2_pos[sfy, b_slot]),
                             py)[1:]
        return seq

    def _expand_super_hop(self, a: int, b: int) -> List[int]:
        """One overlay adjacency hop -> original node ids AFTER a's
        node (E_B slot: the neighbour; clique slot: the intra-fragment
        path)."""
        plan = self.plan
        slot = self._slot_of(a, b)
        if slot < 0:
            raise RuntimeError(f"no overlay slot for super hop {a}->{b}")
        fi = int(plan.sup_fi[slot])
        if fi < 0:                      # E_B: a real boundary-boundary edge
            return [int(self.super_node[b])]
        if a == int(plan.sup_src[slot]):
            pa, pb = int(plan.sup_pu[slot]), int(plan.sup_pv[slot])
        else:
            pa, pb = int(plan.sup_pv[slot]), int(plan.sup_pu[slot])
        return self._frag_walk(fi, pa, pb)[1:]

    def _unwind(self, s: int, t: int, dist: float, wit: int,
                sup: Optional[List[int]]) -> Optional[List[int]]:
        """``unwind`` on the host, given the overlay walk ``sup`` of a
        packed witness on a hierarchical epoch (on a dense epoch, None:
        the super_next chase)."""
        if s == t:
            return [s]
        if not np.isfinite(dist) or wit == WIT_NONE:
            return None
        us, ut = int(self.agent_of[s]), int(self.agent_of[t])
        if us == ut:                                   # case 1
            if wit == WIT_PIECE:
                gid = int(self.piece_gid[s])
                return self._piece_walk(gid, int(self.pos_in_piece[s]),
                                        int(self.pos_in_piece[t]))
            leg_s = self._leg_to_agent(s)              # WIT_VIA_AGENT
            leg_t = self._leg_to_agent(t)
            return leg_s + leg_t[::-1][1:]
        # case 2: s -> u_s -> (middle) -> u_t -> t
        plan = self.plan
        fs, ft = int(plan.frag_of[us]), int(plan.frag_of[ut])
        ps, pt = int(plan.pos_in_frag[us]), int(plan.pos_in_frag[ut])
        path = self._leg_to_agent(s)
        if wit == WIT_LOCAL:
            path += self._frag_walk(fs, ps, pt)[1:]
        else:                                          # packed (x, y)
            x, y = wit // self.s1, wit % self.s1
            path += self._frag_walk(fs, ps, int(self.super_pos[x]))[1:]
            if sup is None:
                sup = self._super_walk(x, y)
            for a, b in zip(sup, sup[1:]):
                path += self._expand_super_hop(a, b)
            path += self._frag_walk(ft, int(self.super_pos[y]), pt)[1:]
        leg_t = self._leg_to_agent(t)
        return path + leg_t[::-1][1:]

    def _unwind_all(self, s, t, dist, wit):
        """-> (paths, route decisions, level passes) of ``unwind_many``.
        Phase 1 decides on the card the hierarchical route of every
        packed witness of the batch (``_decide_routes``); phase 2 walks
        the host tables and reads nothing from the card."""
        s, t, wit = (np.asarray(a, np.int64).reshape(-1)
                     for a in (s, t, wit))
        dist = np.asarray(dist).reshape(-1)
        sup, routes, passes = {}, 0, 0
        if self.hier is not None:
            packed = np.nonzero(
                (s != t) & np.isfinite(dist) & (wit != WIT_NONE)
                & (wit != WIT_LOCAL)
                & (self.agent_of[s] != self.agent_of[t]))[0]
            if packed.size:
                x, y = wit[packed] // self.s1, wit[packed] % self.s1
                lifts, routes, passes = self._decide_routes(x, y)
                sup = {int(i): self._walk_route(1, int(a), int(b), lf)
                       for i, a, b, lf in zip(packed, x, y, lifts)}
        out = [self._unwind(int(a), int(b), d, int(w), sup.get(i))
               for i, (a, b, d, w) in enumerate(zip(s, t, dist, wit))]
        return out, routes, passes

    # ---- public API ----------------------------------------------------
    def unwind(self, s: int, t: int, dist: float,
               wit: int) -> Optional[List[int]]:
        """(s, t, served distance, served witness) -> node sequence of
        an exact shortest path, or None when t is unreachable: the
        ``unwind_many`` of one."""
        return self.unwind_many([s], [t], [dist], [wit])[0]

    def unwind_many(self, s, t, dist, wit) -> List[Optional[List[int]]]:
        """The node sequence of each (s, t, served distance, served
        witness), or None where t is unreachable.  On a hierarchical
        epoch the batch's routes are decided a grouping level at a time
        on the card, with one read a level, before any path is walked.
        While the tracer records, the call is one ``paths.unwind``
        event: ``paths``, ``nodes`` (of the paths found), ``syncs`` /
        ``sync_s``, the reads that wait on the card (one a level pass)
        and the host seconds spent in them, ``routes``, the route
        decisions summed over the levels, and ``passes``, the level
        passes."""
        if not trace.recording():
            return self._unwind_all(s, t, dist, wit)[0]
        acc = self._waits.acc = [0, 0.0]
        t0 = time.perf_counter()
        try:
            out, routes, passes = self._unwind_all(s, t, dist, wit)
        finally:
            self._waits.acc = None
        trace.event("paths.unwind", t0, time.perf_counter(),
                    paths=len(out),
                    nodes=sum(len(p) for p in out if p is not None),
                    syncs=acc[0], sync_s=acc[1], routes=routes,
                    passes=passes)
        return out


def unwind_path(dix: DeviceIndex, plan: BuildPlan, s: int, t: int,
                dist: float, wit: int) -> Optional[List[int]]:
    """One-shot convenience around PathUnwinder (build the unwinder
    once and reuse it when serving many queries)."""
    return PathUnwinder(dix, plan).unwind(s, t, dist, wit)


def path_weight(g, path: Sequence[int]) -> float:
    """Sum of edge weights along ``path``, validating every consecutive
    pair is a real edge of ``g``.  Raises ValueError on a broken hop —
    the differential tests lean on this to reject 'plausible' paths."""
    path = list(path)
    if len(path) <= 1:
        return 0.0
    u = np.asarray(path[:-1])
    v = np.asarray(path[1:])
    eid = g.edge_ids(u, v)
    if (eid < 0).any():
        bad = int(np.nonzero(eid < 0)[0][0])
        raise ValueError(
            f"path hop ({path[bad]}, {path[bad + 1]}) is not an edge")
    return float(g.edge_w[eid].sum())
