# Copied from src/repro/core/paths.py; keep the two in step.  The port
# reads its torch index tables through _host (a CPU numpy copy) where
# the reference calls np.asarray, computes the hierarchical distance
# blocks on the index's device (``_dist_block_t``), and, while the
# tracer records, counts the walk's waits on the card (``_wait``).
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
    candidate sets — the distance blocks as (min,+) products on the
    index's device, the argmin on the host, exact because every table
    entry is the same f32 the device served — and
    then expanded level by level (``_route`` recursing down the
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
            self.hier_t = [tuple(torch.as_tensor(a).to(self.dev) for a in (
                h.sf_of.astype(np.int64), h.pos_in_sf.astype(np.int64),
                h.bnd2_valid, h.bnd2_sid.astype(np.int64)))
                for h in self.hier]
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
        # sparse OvSlotMap (sub-quadratic host memory)
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
        """Overlay-adjacent super-id sequence x -> y: a super_next
        chase on dense epochs, the derived hierarchical route on
        hierarchical epochs."""
        if self.hier is not None:
            return self._route(1, x, y)
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
        dev = self.dev
        return self._dist_block_t(
            lvl, torch.as_tensor(np.asarray(xs, np.int64), device=dev),
            torch.as_tensor(np.asarray(ys, np.int64), device=dev)
        ).cpu().numpy()

    def _dist_block_t(self, lvl: int, xs: torch.Tensor,
                      ys: torch.Tensor) -> torch.Tensor:
        """``_dist_block`` on the index's device.  Where the reference
        closes one level up the whole [U, U] block of both sides'
        boundary ids U and contracts it through a [|xs|, mb2, |U|]
        gather cube (O(S^3) host memory at road250k's depth), this
        closes only [x side's ids, y side's ids] one level up and
        contracts it as two (min,+) products (``ops.minplus``) of the
        boundary rows scattered to those ids: the same candidates, so
        the same exact values."""
        if lvl == len(self.hier) + 1:
            return self.d2[xs][:, ys]
        if xs.numel() == 0 or ys.numel() == 0:
            return torch.full((xs.numel(), ys.numel()), _INF,
                              dtype=torch.float32, device=self.dev)
        sf_of, pos_in_sf, valid, sid = self.hier_t[lvl - 1]
        sfx, px = sf_of[xs], pos_in_sf[xs]
        sfy, py = sf_of[ys], pos_in_sf[ys]
        cls = self.sf_closure[lvl - 1]
        same = sfx[:, None] == sfy[None, :]
        out = torch.where(same, cls[sfx[:, None], px[:, None], py[None, :]],
                          _INF)
        if valid.shape[1] == 0:
            return out
        row = self.l2row[lvl - 1]

        def side(sf, p):
            # boundary rows scattered to their next-level ids: [n, |ids|]
            ok = valid[sf]
            r = torch.where(ok, row[sf, p], _INF)
            ids, inv = torch.unique(torch.where(ok, sid[sf], 0),
                                    return_inverse=True)
            dense = torch.full((r.shape[0], ids.numel()), _INF,
                               dtype=torch.float32, device=self.dev)
            return ids, dense.scatter_reduce_(1, inv, r, reduce="amin")

        ax, rx = side(sfx, px)
        ay, ry = side(sfy, py)
        b = self._dist_block_t(lvl + 1, ax, ay)
        vb = ops.minplus(ops.minplus(rx, b), ry.t().contiguous())
        return torch.minimum(out, vb)

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

    def _route(self, lvl: int, x: int, y: int) -> List[int]:
        """Level-``lvl``-adjacent id sequence x -> y through the
        hierarchy: re-derive the winning route (same-group closure vs
        lift through the group boundary one level up) from the epoch
        snapshots, then expand the upper leg hop by hop.  At the top
        it is a plain d2_next chase."""
        if lvl == len(self.hier) + 1:
            return self._l2_walk(x, y)
        h = self.hier[lvl - 1]
        sfx, sfy = int(h.sf_of[x]), int(h.sf_of[y])
        px, py = int(h.pos_in_sf[x]), int(h.pos_in_sf[y])
        va = np.float32(
            self._wait(self.sf_closure[lvl - 1][sfx, px, py].item)
            if sfx == sfy else np.inf)
        vx = np.nonzero(h.bnd2_valid[sfx])[0]
        vy = np.nonzero(h.bnd2_valid[sfy])[0]
        vb = np.float32(np.inf)
        if vx.size and vy.size:
            a_row = self._wait(_host, self.l2row[lvl - 1][sfx, px])[vx]
            b_row = self._wait(_host, self.l2row[lvl - 1][sfy, py])[vy]
            d_blk = self._wait(self._dist_block, lvl + 1,
                               h.bnd2_sid[sfx, vx], h.bnd2_sid[sfy, vy])
            tot = a_row[:, None] + d_blk + b_row[None, :]
            ai, bi = np.unravel_index(int(np.argmin(tot)), tot.shape)
            vb = tot[ai, bi]
        if not (np.isfinite(va) or np.isfinite(vb)):
            raise RuntimeError(
                f"unreachable level-{lvl} route {x}->{y}")
        if va <= vb:
            return self._sf_walk(lvl, sfx, px, py)
        a_slot, b_slot = int(vx[ai]), int(vy[bi])
        seq = self._sf_walk(lvl, sfx, px, int(h.bnd2_pos[sfx, a_slot]))
        up = self._route(lvl + 1, int(h.bnd2_sid[sfx, a_slot]),
                         int(h.bnd2_sid[sfy, b_slot]))
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

    # ---- public API ----------------------------------------------------
    def unwind(self, s: int, t: int, dist: float,
               wit: int) -> Optional[List[int]]:
        """(s, t, served distance, served witness) -> node sequence of
        an exact shortest path, or None when t is unreachable."""
        s, t, wit = int(s), int(t), int(wit)
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
            sup = self._super_walk(x, y)
            for a, b in zip(sup, sup[1:]):
                path += self._expand_super_hop(a, b)
            path += self._frag_walk(ft, int(self.super_pos[y]), pt)[1:]
        leg_t = self._leg_to_agent(t)
        return path + leg_t[::-1][1:]

    def unwind_many(self, s, t, dist, wit) -> List[Optional[List[int]]]:
        """``unwind`` of each (s, t, dist, wit).  While the tracer
        records, the call is one ``paths.unwind`` event: ``paths``,
        ``nodes`` (of the paths found), and ``syncs`` / ``sync_s``, the
        walk's reads that wait on the card (``_host``, ``_dist_block``,
        ``.item()``) and the host seconds spent in them."""
        args = (np.asarray(s), np.asarray(t), np.asarray(dist),
                np.asarray(wit))
        if not trace.recording():
            return [self.unwind(a, b, d, w) for a, b, d, w in zip(*args)]
        acc = self._waits.acc = [0, 0.0]
        t0 = time.perf_counter()
        try:
            out = [self.unwind(a, b, d, w) for a, b, d, w in zip(*args)]
        finally:
            self._waits.acc = None
        trace.event("paths.unwind", t0, time.perf_counter(),
                    paths=len(out),
                    nodes=sum(len(p) for p in out if p is not None),
                    syncs=acc[0], sync_s=acc[1])
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
