"""N-level SUPER overlay hierarchy, on PyTorch.

Port of ``repro/core/hierarchy.py``.  The dense overlay closure
(``device_engine.super_stage``) is O(S^2) memory and O(S^3) work in the
boundary count S; the hierarchy keeps every per-level closure small.
One *grouping level* takes an overlay (S nodes, a slot list with
min-merged weights) and

  1. groups its *units* (fragments at level 1, groups of the previous
     level above that) into super-fragments with the multilevel
     partitioner on the unit quotient graph, then an exact
     next-boundary FM pass (numpy, copied from the reference);
  2. closes each group's induced overlay subgraph with the batched
     witness FW kernel (``ops.fw_batch_next``) at one pow2-padded tile
     shape [nsf, m2, m2] (``sf_stage``);
  3. emits the next overlay: the boundary nodes (incident to a
     cross-group slot) with cross slots plus per-group boundary cliques
     whose weights are gathered from the group closures
     (``hier_weights``).

``plan_hierarchy`` stacks levels until the remaining boundary is small
enough to close densely: the top closure ``d2`` (``l2_stage``, the
blocked FW of ``ops.fw_apsp``), whose first-hop witnesses come from
``first_hops`` on the same device.  ``hierarchy_levels = 1 + len(levels)``.
A refresh whose top slot weights only went down re-closes the top with
``l2_decrease_stage`` (a bounded (min,+) relaxation on the host, its
witnesses re-derived on the index's device) instead.

The host-side planner and weight caches are numpy, copied from the
reference and marked with their source lines there; keep the two in
step.  The device stages are torch on the caller's ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..kernels import ops
from ..obs import trace
from . import padding
from .graph import Graph
from .partition import partition_bgp

INF = np.float32(np.inf)
_INF = float("inf")                  # the same +inf for torch calls

# copied from src/repro/core/hierarchy.py:68
#: Boundary size above which ``hierarchy_levels="auto"`` adds another
#: grouping level instead of closing densely.  Road graphs near the
#: threshold are fine either way; road4000 (S ~ 600) stays dense
#: (bit-identical to the pre-hierarchy index), road64k (S ~ 7000)
#: gets as many levels as it takes to bring the top under this.
AUTO_THRESHOLD = 1024

#: Hard cap on hierarchy depth ("auto" and explicit): each level's
#: boundary shrinks geometrically, so depth beyond this is a planner
#: bug, not a bigger graph.
MAX_LEVELS = 5


def _sync(device: torch.device) -> None:
    """Wait for the card's current stream, so a stage's wall time covers
    its kernels (and only its own: a refresh on its own stream does not
    wait for a serving thread's batches)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# copied from src/repro/core/hierarchy.py:81
@dataclasses.dataclass
class HierPlan:
    """Host-side structure of ONE grouping level, carried on BuildPlan
    as an element of ``.hier`` (a list, bottom level first).

    Field names keep their two-level spelling — "sf" is this level's
    group, "l2"/"2" is this level's *next* overlay — but every array is
    per-level: at level 1 the units are fragments and the overlay nodes
    are the level-1 boundary set; at level l+1 the units are level-l
    groups and the nodes are level-l boundary slots.  Like the rest of
    the plan, everything except the weight caches (``sf_adj``,
    ``l2_w``) is weight-invariant structure; a refresh mutates only
    those caches and regathers everything else.
    """

    nsf: int                 # group count at this level
    m2: int                  # pow2-padded max overlay nodes per group
    mb2: int                 # padded max next-level boundary slots/group
    S2: int                  # next-level boundary node count
    sf_of_frag: np.ndarray   # int32 [k] unit -> group
    sf_of: np.ndarray        # int32 [S] overlay node -> group
    pos_in_sf: np.ndarray    # int32 [S] position inside its group
    sf_members: np.ndarray   # int64 [nsf, m2] slot -> overlay id (-1)
    # intra-group slot addressing (this level's overlay slots)
    slot_sf: np.ndarray      # int32 [Es] owning group (-1: crosses)
    slot_p2u: np.ndarray     # int32 [Es] group-local endpoints (-1)
    slot_p2v: np.ndarray
    sf_adj: np.ndarray       # f32 [nsf, m2, m2] weight cache
    # next-level boundary registry
    bnd2_ids: np.ndarray     # int64 [S2] overlay ids, sorted
    sid2_of: np.ndarray      # int64 [S] overlay id -> next-level id (-1)
    bnd2_pos: np.ndarray     # int32 [nsf, mb2] group-local positions
    bnd2_valid: np.ndarray   # bool [nsf, mb2]
    bnd2_sid: np.ndarray     # int32 [nsf, mb2] next id (S2 sentinel)
    # next-level slots (fixed structure, derived weights)
    l2_src: np.ndarray       # int32 [E2] next-level ids
    l2_dst: np.ndarray
    l2_w: np.ndarray         # f32 [E2] weight cache
    l2_sf: np.ndarray        # int32 [E2] owning group (cliques; -1 cross)
    l2_pu: np.ndarray        # int32 [E2] group-local gather coords
    l2_pv: np.ndarray
    l2_ov_slot: np.ndarray   # int64 [E2] slot id in THIS level's slot
    #                          list (cross slots; -1 for cliques)

    def overlay_bytes(self) -> int:
        """Device bytes of this level's tables (closure + witness +
        rows); the top dense closure is accounted by
        ``hier_overlay_stats``."""
        nsf1 = self.nsf + 1
        return (2 * nsf1 * self.m2 * self.m2 * 4      # sf_closure + next
                + nsf1 * self.m2 * self.mb2 * 4)      # l2row


# ---------------------------------------------------------------------------
# structure assembly (weight-invariant)
# ---------------------------------------------------------------------------
# copied from src/repro/core/hierarchy.py:137
def _frag_of_sid(plan) -> np.ndarray:
    """Home fragment of every overlay node (each boundary node belongs
    to exactly one fragment of the level-1 partition)."""
    out = -np.ones(plan.S, dtype=np.int64)
    fi_idx, b_idx = np.nonzero(plan.bvalid)
    out[plan.bnd_super[fi_idx, b_idx]] = fi_idx
    return out



# copied from src/repro/core/hierarchy.py:146
def _refine_boundary(labels: np.ndarray, unit_of: np.ndarray,
                     na: np.ndarray, nb: np.ndarray,
                     bcount: np.ndarray, gamma2: int,
                     passes: int = 8) -> np.ndarray:
    """Exact next-boundary FM over unit moves.

    The multilevel partitioner below optimizes the cross-slot edge cut
    (a good proxy: every cross-group slot makes both endpoints boundary
    nodes).  This final pass optimizes the real objective: for each
    candidate move of unit ``f`` to an adjacent group, the gain is the
    exact change in the number of overlay nodes incident to a
    cross-group slot, evaluated over the only nodes a move of ``f``
    can affect (f's own cross-adjacent nodes and their cross
    neighbours).  Greedy positive-gain moves under the gamma2 budget,
    until a pass moves nothing.

    ``na, nb``: node endpoints of the cross-UNIT slots (intra-unit
    slots can never cross groups — units move atomically).
    """
    labels = labels.copy()
    k = labels.size
    if k == 0 or na.size == 0:
        return labels
    nfrag = int(labels.max()) + 1
    sizes = np.zeros(nfrag, dtype=np.int64)
    np.add.at(sizes, labels, bcount)
    # node -> units reachable via one cross slot; unit -> affected nodes
    adj: dict[int, list] = {}
    touch: List[set] = [set() for _ in range(k)]
    for a, b in zip(na.tolist(), nb.tolist()):
        ua, ub = int(unit_of[a]), int(unit_of[b])
        adj.setdefault(a, []).append(ub)
        adj.setdefault(b, []).append(ua)
        touch[ua].update((a, b))
        touch[ub].update((a, b))

    def n_boundary(nodes) -> int:
        c = 0
        for x in nodes:
            lx = labels[unit_of[x]]
            for u in adj[x]:
                if labels[u] != lx:
                    c += 1
                    break
        return c

    for _ in range(passes):
        moved = 0
        for f in range(k):
            nodes = touch[f]
            if not nodes:
                continue
            lf = int(labels[f])
            cand = sorted({int(labels[unit_of[x]]) for x in nodes})
            base = n_boundary(nodes)
            best_l, best_gain = lf, 0
            for lg in cand:
                if lg == lf or sizes[lg] + bcount[f] > gamma2:
                    continue
                labels[f] = lg
                gain = base - n_boundary(nodes)
                labels[f] = lf
                if gain > best_gain:
                    best_l, best_gain = lg, gain
            if best_l != lf:
                sizes[lf] -= bcount[f]
                sizes[best_l] += bcount[f]
                labels[f] = best_l
                moved += 1
        if moved == 0:
            break
    return labels



# copied from src/repro/core/hierarchy.py:220
def _group_units(S: int, unit_of: np.ndarray, k: int,
                 src: np.ndarray, dst: np.ndarray,
                 gamma2: int, seed: int = 0) -> np.ndarray:
    """Group this level's units into super-fragments, minimizing the
    next-level boundary size.

    The unit quotient graph (nodes = units, node weight = overlay-node
    count, edge weight = cross-unit slot multiplicity) goes through
    the SAME multilevel partitioner as the level-1 node partition —
    heavy-edge-matching coarsening, Prim-style initial growth, FM
    uncoarsening (``partition_bgp`` with per-unit node weights and
    ``cut_weights=True``: here one quotient edge stands for its slot
    multiplicity, so the weighted cut IS the boundary proxy) — and
    then ``_refine_boundary`` trades the edge-cut proxy for the exact
    objective.  Deterministic and purely topological, so a weight
    update can never move a unit between groups: the same refresh
    stability the level-1 partition provides one level down.
    """
    if k == 0:
        return np.empty(0, dtype=np.int64)
    bcount = np.bincount(unit_of, minlength=k).astype(np.int64)
    cross = unit_of[src] != unit_of[dst]
    na, nb = src[cross].astype(np.int64), dst[cross].astype(np.int64)
    fu, fv = unit_of[na], unit_of[nb]
    lo = np.minimum(fu, fv).astype(np.int64)
    hi = np.maximum(fu, fv).astype(np.int64)
    if lo.size:
        key = lo * k + hi
        uniq, cnt = np.unique(key, return_counts=True)
        qlo, qhi = uniq // k, uniq % k
        qg = Graph.from_edges(k, qlo, qhi, cnt.astype(np.float64))
    else:
        qg = Graph.from_edges(k, [], [], [])
    part = partition_bgp(qg, gamma2, seed=seed, node_w=bcount,
                         cut_weights=True)
    labels = _refine_boundary(part.labels, unit_of, na, nb, bcount,
                              gamma2)
    uniq, inv = np.unique(labels, return_inverse=True)
    return inv.astype(np.int64)



# copied from src/repro/core/hierarchy.py:261
def _default_gamma2(S: int) -> int:
    """Per-group overlay-node budget.  Balances the per-level closures:
    the next boundary shrinks like the group perimeter (S2 ~ S/sqrt(f)
    for f units per group), so groups must be LARGE enough that the
    next level stays small, while the batched per-group FW (nsf * m2^3)
    stays tractable — ~S^(2/3) is where those costs meet.  The budget
    is snapped to ~94% of the pow2 tile size it implies, so the padded
    [nsf, m2, m2] batch runs nearly full instead of wasting up to half
    its closure memory on padding."""
    m2_target = padding.pow2(
        max(48, int(round(2.0 * max(S, 1) ** (2.0 / 3.0)))), floor=8)
    return max(48, int(0.94 * m2_target))



# copied from src/repro/core/hierarchy.py:275
def plan_one_level(S: int, unit_of: np.ndarray, k: int,
                   src: np.ndarray, dst: np.ndarray,
                   gamma2: int, seed: int = 0) -> HierPlan:
    """Assemble one grouping level over an overlay of ``S`` nodes with
    slot list ``(src, dst)`` and unit assignment ``unit_of`` (no device
    work)."""
    sf_of_frag = _group_units(S, unit_of, k, src, dst, gamma2,
                              seed=seed)
    nsf = int(sf_of_frag.max()) + 1 if sf_of_frag.size else 0
    sf_of = sf_of_frag[unit_of].astype(np.int32)

    # members (overlay-id order within each group) + positions
    pos_in_sf = np.zeros(S, dtype=np.int32)
    sf_sizes = np.bincount(sf_of, minlength=nsf)
    m2 = padding.pow2(int(sf_sizes.max()) if nsf else 1, floor=8)
    sf_members = np.full((nsf, m2), -1, dtype=np.int64)
    for s in range(nsf):
        ids = np.nonzero(sf_of == s)[0]
        sf_members[s, :ids.size] = ids
        pos_in_sf[ids] = np.arange(ids.size, dtype=np.int32)

    # slot addressing: intra-group slots scatter into sf_adj, the rest
    # cross groups and become next-level edges
    su, sv = src, dst
    sfu, sfv = sf_of[su], sf_of[sv]
    intra = sfu == sfv
    slot_sf = np.where(intra, sfu, -1).astype(np.int32)
    slot_p2u = np.where(intra, pos_in_sf[su], -1).astype(np.int32)
    slot_p2v = np.where(intra, pos_in_sf[sv], -1).astype(np.int32)
    sf_adj = np.full((nsf, m2, m2), INF, dtype=np.float32)

    # next-level boundary: overlay nodes incident to a cross-group slot
    is_b2 = np.zeros(S, dtype=bool)
    is_b2[su[~intra]] = True
    is_b2[sv[~intra]] = True
    bnd2_ids = np.nonzero(is_b2)[0].astype(np.int64)
    S2 = bnd2_ids.size
    sid2_of = -np.ones(S, dtype=np.int64)
    sid2_of[bnd2_ids] = np.arange(S2)
    b2_per_sf = [bnd2_ids[sf_of[bnd2_ids] == s] for s in range(nsf)]
    mb2 = padding.pad_to(max((b.size for b in b2_per_sf), default=1))
    bnd2_pos = np.zeros((nsf, mb2), dtype=np.int32)
    bnd2_valid = np.zeros((nsf, mb2), dtype=bool)
    bnd2_sid = np.full((nsf, mb2), S2, dtype=np.int32)
    for s, ids in enumerate(b2_per_sf):
        nb = ids.size
        bnd2_pos[s, :nb] = pos_in_sf[ids]
        bnd2_valid[s, :nb] = True
        bnd2_sid[s, :nb] = sid2_of[ids]

    # next-level slot list: cross slots keep their provenance into
    # THIS level's slot list, per-group boundary cliques get derived
    # weights (hier_weights)
    l2_src = [sid2_of[su[~intra]].astype(np.int32)]
    l2_dst = [sid2_of[sv[~intra]].astype(np.int32)]
    n_cross = int((~intra).sum())
    l2_sf = [np.full(n_cross, -1, np.int32)]
    l2_pu = [np.full(n_cross, -1, np.int32)]
    l2_pv = [np.full(n_cross, -1, np.int32)]
    l2_ov = [np.nonzero(~intra)[0].astype(np.int64)]
    for s, ids in enumerate(b2_per_sf):
        if ids.size < 2:
            continue
        ii, jj = np.triu_indices(ids.size, k=1)
        l2_src.append(sid2_of[ids[ii]].astype(np.int32))
        l2_dst.append(sid2_of[ids[jj]].astype(np.int32))
        l2_sf.append(np.full(ii.size, s, np.int32))
        l2_pu.append(pos_in_sf[ids[ii]].astype(np.int32))
        l2_pv.append(pos_in_sf[ids[jj]].astype(np.int32))
        l2_ov.append(np.full(ii.size, -1, np.int64))

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.empty(0, dtype))

    l2_src = cat(l2_src, np.int32)
    return HierPlan(
        nsf=nsf, m2=m2, mb2=mb2, S2=S2,
        sf_of_frag=sf_of_frag.astype(np.int32), sf_of=sf_of,
        pos_in_sf=pos_in_sf, sf_members=sf_members,
        slot_sf=slot_sf, slot_p2u=slot_p2u, slot_p2v=slot_p2v,
        sf_adj=sf_adj,
        bnd2_ids=bnd2_ids, sid2_of=sid2_of, bnd2_pos=bnd2_pos,
        bnd2_valid=bnd2_valid, bnd2_sid=bnd2_sid,
        l2_src=l2_src, l2_dst=cat(l2_dst, np.int32),
        l2_w=np.full(l2_src.size, INF, np.float32),
        l2_sf=cat(l2_sf, np.int32),
        l2_pu=cat(l2_pu, np.int32), l2_pv=cat(l2_pv, np.int32),
        l2_ov_slot=cat(l2_ov, np.int64),
    )



# copied from src/repro/core/hierarchy.py:367
def plan_hierarchy(plan, *, levels="auto",
                   gamma2: Optional[int] = None) -> List[HierPlan]:
    """Stack grouping levels over ``plan``'s overlay (no device work).

    ``levels="auto"`` keeps adding grouping levels while the remaining
    boundary exceeds AUTO_THRESHOLD (so the top dense closure stays
    small), up to MAX_LEVELS total; an integer asks for exactly that
    many total hierarchy levels (``len(result) = levels - 1``), ending
    early only when a level's boundary empties or collapses to one
    group — the returned depth is the authoritative one.  ``gamma2``
    overrides the first level's group budget (tests); deeper levels
    use the size-derived default, floored so a group averages >= ~2.2
    units: deeper units are whole previous-level groups, so without
    that floor most units exceed the budget, land solo, and the
    boundary stops shrinking.  Under "auto" a level is dropped (and
    the stack stops below it) when it fails to shrink the boundary by
    >= 5% — highway-dense graphs hit a floor set by long-range edges
    — or when its group closures (nsf * m2^2) would cost more memory
    than just closing the remaining boundary densely; stacking such
    levels only adds closure memory and lift hops.  An explicit
    integer depth is honored as requested (differential tests rely on
    exact depths).
    """
    out: List[HierPlan] = []
    S = plan.S
    unit_of = _frag_of_sid(plan)
    k = plan.k
    src, dst = plan.sup_src, plan.sup_dst
    while True:
        if gamma2 is not None and not out:
            g2 = gamma2
        else:
            g2 = _default_gamma2(S)
            if out:
                g2 = max(g2, int(np.ceil(2.2 * S / max(k, 1))))
        h = plan_one_level(S, unit_of, k, src, dst, g2,
                           seed=len(out))
        out.append(h)
        if h.S2 == 0 or h.nsf <= 1:
            break
        if levels == "auto":
            if len(out) > 1 and (
                    h.S2 > 0.95 * S
                    or h.nsf * h.m2 ** 2 >= (S + 1) ** 2):
                # no progress, or the level's group closures cost more
                # memory than just closing this boundary densely:
                # stop below it
                out.pop()
                break
            if h.S2 <= AUTO_THRESHOLD or len(out) >= MAX_LEVELS - 1:
                break
        elif len(out) >= int(levels) - 1:
            break
        S = h.S2
        unit_of = h.sf_of[h.bnd2_ids].astype(np.int64)
        k = h.nsf
        src, dst = h.l2_src.astype(np.int64), h.l2_dst.astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# weight caches (derived; the refresh path re-runs these on dirt)
# ---------------------------------------------------------------------------
# copied from src/repro/core/hierarchy.py:430
def sf_adj_fill(hier: HierPlan, w: np.ndarray,
                sfs: Optional[np.ndarray] = None) -> None:
    """(Re)build the intra-group adjacency blocks from this level's
    current slot weights ``w`` (``plan.sup_w`` at level 1, the previous
    level's ``l2_w`` above), min-merging parallel slots.  ``sfs=None``:
    every block; otherwise only the listed ones (their blocks are reset
    first, so a slot that stopped being the min is forgotten)."""
    intra = hier.slot_sf >= 0
    if sfs is None:
        hier.sf_adj[:] = INF
        sel = intra
    else:
        hier.sf_adj[sfs] = INF
        sel = intra & np.isin(hier.slot_sf, sfs)
    s = hier.slot_sf[sel]
    pu = hier.slot_p2u[sel]
    pv = hier.slot_p2v[sel]
    ws = np.asarray(w)[sel].astype(np.float32)
    np.minimum.at(hier.sf_adj, (s, pu, pv), ws)
    np.minimum.at(hier.sf_adj, (s, pv, pu), ws)



# copied from src/repro/core/hierarchy.py:452
def hier_weights(hier: HierPlan, blocks: np.ndarray, src_w: np.ndarray,
                 sfs: Optional[np.ndarray] = None) -> None:
    """Fill this level's next-overlay slot weights: clique slots gather
    from the group closure ``blocks`` (never stored authoritatively —
    the same derived-state rule as ``device_engine.super_weights``),
    cross slots copy their source slot's current weight from ``src_w``
    (this level's slot weight vector).

    ``sfs=None``: blocks is the full [nsf, m2, m2] closure, every slot
    is rewritten.  Otherwise blocks holds only the listed groups' rows
    and only their clique slots are rewritten (cross slots are always
    rewritten — they are O(cross) cheap and depend only on src_w).
    """
    if sfs is None:
        mask = hier.l2_sf >= 0
        local = hier.l2_sf[mask]
    else:
        mask = np.isin(hier.l2_sf, sfs)
        sf_to_row = -np.ones(hier.nsf, dtype=np.int64)
        sf_to_row[sfs] = np.arange(len(sfs))
        local = sf_to_row[hier.l2_sf[mask]]
    hier.l2_w[mask] = blocks[local, hier.l2_pu[mask], hier.l2_pv[mask]]
    cross = hier.l2_ov_slot >= 0
    hier.l2_w[cross] = np.asarray(src_w)[hier.l2_ov_slot[cross]]



# ---------------------------------------------------------------------------
# device stages (mirror frag_stage / super_stage)
# ---------------------------------------------------------------------------
def _pad_sentinel(dist: torch.Tensor, nxt: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Append the all-INF / all--1 sentinel block (index nsf) so padded
    gathers through ``sf_of`` need no masking."""
    d_s = torch.full((1,) + tuple(dist.shape[1:]), _INF, dtype=dist.dtype,
                     device=dist.device)
    n_s = torch.full((1,) + tuple(nxt.shape[1:]), -1, dtype=nxt.dtype,
                     device=nxt.device)
    return torch.cat([dist, d_s]), torch.cat([nxt, n_s])


def l2row_from(closure: torch.Tensor, bnd2_pos: np.ndarray,
               bnd2_valid: np.ndarray) -> torch.Tensor:
    """Per-member next-boundary rows, the hierarchy analog of the
    fragment ``brow`` table: l2row[sf, p, b] = closure distance from
    the member at position p to the group's b-th next-boundary slot."""
    nsf, m2, _ = closure.shape
    dev = closure.device
    idx = to_device(bnd2_pos, dev).long()[:, None, :].expand(
        nsf, m2, bnd2_pos.shape[1])
    rows = torch.gather(closure, 2, idx)
    return torch.where(to_device(bnd2_valid, dev)[:, None, :], rows, _INF)


def sf_stage(hier: HierPlan, device: torch.device, *, force=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level stage: batched witness FW over every group's induced
    overlay subgraph at the one pow2 tile shape [nsf, m2, m2] ->
    (sf_closure, sf_next, l2row), sentinel block appended."""
    closure, nxt = ops.fw_batch_next(to_device(hier.sf_adj, device),
                                     force=force)
    rows = l2row_from(closure, hier.bnd2_pos, hier.bnd2_valid)
    closure, nxt = _pad_sentinel(closure, nxt)
    r_s = torch.full((1,) + tuple(rows.shape[1:]), _INF,
                     dtype=rows.dtype, device=rows.device)
    return closure, nxt, torch.cat([rows, r_s])


def l2_overlay(hier: HierPlan) -> np.ndarray:
    """Dense [S2, S2] next-level adjacency from the slot list (parallel
    slots min-merged, diag 0) — the per-level twin of super_overlay.
    Copied from the reference (:516), returning the host array."""
    S2 = hier.S2
    m = np.full((S2, S2), INF, np.float32)
    np.minimum.at(m, (hier.l2_src, hier.l2_dst), hier.l2_w)
    np.minimum.at(m, (hier.l2_dst, hier.l2_src), hier.l2_w)
    np.fill_diagonal(m, 0.0)
    return m


#: ``first_hops`` chunks its rows so the [c, n, m] candidate cube holds at
#: most this many elements (256 MiB of float32 at the cap)
FIRST_HOPS_CUBE = 1 << 26


# the contract of src/repro/core/hierarchy.py:527, in torch
def first_hops(adj: torch.Tensor, dist: torch.Tensor,
               rows=None, cols=None) -> torch.Tensor:
    """Canonical first-hop witnesses from (adjacency, exact closure).

    next[i, j] = the smallest k != i with adj[i, k] finite and
    adj[i, k] + dist[k, j] == dist[i, j]; -1 on the diagonal and for
    unreachable pairs.  A pure function of the two tables — independent
    of which kernel (or incremental relaxation) produced ``dist`` — so
    the scratch build and every refresh path derive bit-identical
    witness tables, extending the refresh == rebuild contract to
    ``d2_next``.  Positive edge weights make the chase strictly
    decrease dist[., j], so it always terminates.  ``rows``/``cols``
    (index arrays or tensors) restrict the output block (the decrease
    fast path re-derives only the rows/columns whose inputs changed).

    Runs on the device of ``dist`` (``adj`` is moved there) and returns
    an int32 [rows, cols] tensor there.  Integer weights keep every
    float32 sum exact, so the equality test is exact.  The smallest k
    is ``amin`` of ``where(ok, k, n)``; rows go in chunks so the
    [c, n, m] candidate cube stays under ``FIRST_HOPS_CUBE``.
    """
    dev = dist.device
    n = dist.shape[0]
    rows = (torch.arange(n, device=dev) if rows is None
            else torch.as_tensor(rows, dtype=torch.int64).to(dev))
    cols = (torch.arange(n, device=dev) if cols is None
            else torch.as_tensor(cols, dtype=torch.int64).to(dev))
    a = adj.to(device=dev, dtype=torch.float32).clone()
    a.fill_diagonal_(_INF)                       # k == i never witnesses
    dc = dist[:, cols]                           # [n, m] candidate tails
    out = torch.empty((rows.numel(), cols.numel()), dtype=torch.int32,
                      device=dev)
    k = torch.arange(n, dtype=torch.int32, device=dev).view(1, n, 1)
    chunk = max(1, FIRST_HOPS_CUBE // max(1, n * cols.numel()))
    for i0 in range(0, rows.numel(), chunk):
        ri = rows[i0:i0 + chunk]
        tgt = dist[ri][:, cols]                  # [c, m]
        # a hop through an +inf edge sums to +inf, which equals only an
        # unreachable target, and those are masked to -1 below
        ok = (a[ri][:, :, None] + dc[None, :, :]) == tgt[:, None, :]
        hop = torch.where(ok, k, n).amin(dim=1)  # [c, m]
        out[i0:i0 + chunk] = torch.where(
            (hop < n) & torch.isfinite(tgt), hop, -1)
    return out


def l2_stage(hier: HierPlan, device: torch.device, *, force=None,
             timings: Optional[dict] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top stage: dense closure of the LAST level's boundary set ->
    (d2, d2_next) with the +inf sentinel row/col appended.  The closure
    runs through ``ops.fw_apsp`` (the blocked FW kernels on the card);
    witnesses come from ``first_hops`` on the closed distances, on the
    same device, rather than a kernel's pivot-order-dependent
    tie-breaks, so any exact closure schedule gives the same table.
    ``timings`` (when given) receives the seconds of the closure
    (``l2_fw``) and of ``first_hops``, each synchronised."""
    S2 = hier.S2
    with trace.span("hierarchy.l2_stage", S2=int(S2)):
        d2 = torch.full((S2 + 1, S2 + 1), _INF, dtype=torch.float32,
                        device=device)
        d2_next = torch.full((S2 + 1, S2 + 1), -1, dtype=torch.int32,
                             device=device)
        if S2 == 0 or hier.l2_src.size == 0:
            return d2, d2_next
        adj = to_device(l2_overlay(hier), device)
        with trace.timed("hierarchy.l2_fw", timings, "l2_fw", S2=int(S2)):
            d2[:S2, :S2] = ops.fw_apsp(adj, force=force)
            _sync(device)
        with trace.timed("hierarchy.first_hops", timings, "first_hops",
                         S2=int(S2)):
            d2_next[:S2, :S2] = first_hops(adj, d2[:S2, :S2])
            _sync(device)
        return d2, d2_next


# copied from src/repro/core/hierarchy.py:586
#: decrease fast path bail-out: above this fraction of S2 touched, the
#: r x r seed closure + [S2, r, S2] relaxation stops beating full FW
DECREASE_MAX_FRAC = 8


# copied from src/repro/core/hierarchy.py:590 (the relaxation in host
# numpy, as there; the witnesses on the index's device)
def l2_decrease_stage(hier: HierPlan, d2_old: torch.Tensor,
                      d2_next_old: torch.Tensor,
                      changed_slots: np.ndarray
                      ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """Decrease-only incremental top closure.

    Precondition (checked by the caller): every slot in
    ``changed_slots`` carries a weight <= its previous one and no other
    slot changed.  Then with U = the changed slots' endpoints and
    M* = the closed [r, r] block of min(old closure on U, new changed
    weights), the exact new closure is

        D_new = min(D_old, D_old[:, U] (x) M* (x) D_old[U, :])

    — candidates never undershoot (every old path survives a decrease
    with weight >= its new true distance), and any strictly shorter new
    path splits at its first/last changed-edge endpoints, both in U, so
    the three-factor contraction reaches it.  Witnesses re-derive via
    ``first_hops`` only on the rows/columns whose adjacency row or
    closure column changed; everything else carries over.

    The old epoch's tables are read and never written: the result is a
    new sentinel-padded (d2, d2_next) pair on ``d2_old``'s device (the
    witnesses derived there), or None when the touched endpoint set is too large for the
    fast path to pay (the caller falls back to the full ``l2_stage``).
    """
    S2 = hier.S2
    u_ids = np.unique(np.concatenate(
        [hier.l2_src[changed_slots], hier.l2_dst[changed_slots]]
    )).astype(np.int64)
    r = int(u_ids.size)
    if r == 0 or r > max(16, S2 // DECREASE_MAX_FRAC):
        return None
    with trace.span("hierarchy.l2_decrease_stage", S2=int(S2), r=r):
        d_old = d2_old.cpu().numpy()[:S2, :S2]
        # seed block: old closure restricted to U, min-merged with the NEW
        # changed-slot weights, then closed by a tiny r x r FW
        m = d_old[np.ix_(u_ids, u_ids)].copy()
        pos = np.full(S2, -1, np.int64)
        pos[u_ids] = np.arange(r)
        pa = pos[hier.l2_src[changed_slots]]
        pb = pos[hier.l2_dst[changed_slots]]
        wc = hier.l2_w[changed_slots].astype(np.float32)
        np.minimum.at(m, (pa, pb), wc)
        np.minimum.at(m, (pb, pa), wc)
        np.fill_diagonal(m, 0.0)
        for k in range(r):
            np.minimum(m, m[:, k, None] + m[None, k, :], out=m)
        # two-sided relaxation, chunked so [c, r, S2] stays ~64 MiB
        left = d_old[:, u_ids]                        # [S2, r]
        right = d_old[u_ids, :]                       # [r, S2]
        lm = np.min(left[:, :, None] + m[None, :, :], axis=1)  # [S2, r]
        d_new = d_old.copy()
        chunk = max(1, (1 << 24) // max(1, r * S2))
        for i0 in range(0, S2, chunk):
            cand = np.min(lm[i0:i0 + chunk, :, None] + right[None, :, :],
                          axis=1)
            np.minimum(d_new[i0:i0 + chunk], cand,
                       out=d_new[i0:i0 + chunk])
        # canonical witnesses on the changed rows/columns only (D stays
        # symmetric, so changed rows == changed columns)
        touched = np.union1d(
            u_ids, np.nonzero((d_new != d_old).any(axis=1))[0])
        dev = d2_old.device
        d2 = torch.full((S2 + 1, S2 + 1), _INF, dtype=torch.float32,
                        device=dev)
        d2[:S2, :S2] = to_device(d_new, dev)          # fresh tensors
        d2_next = d2_next_old.clone()
        adj = to_device(l2_overlay(hier), dev)
        t_dev = to_device(touched, dev)
        d_dev = d2[:S2, :S2]
        d2_next[t_dev, :S2] = first_hops(adj, d_dev, rows=t_dev)
        rest = np.setdiff1d(np.arange(S2, dtype=np.int64), touched)
        if rest.size and touched.size:
            r_dev = to_device(rest, dev)
            d2_next[r_dev[:, None], t_dev[None, :]] = first_hops(
                adj, d_dev, rows=r_dev, cols=t_dev)
        return d2, d2_next


# ---------------------------------------------------------------------------
# slot provenance for path unwinding (per-epoch host sidecars)
# ---------------------------------------------------------------------------
# copied from src/repro/core/hierarchy.py:672
class SlotMap:
    """Sparse winning-slot lookup for an overlay slot list.

    A dense [n, n] slot table is exactly the quadratic host object the
    hierarchy exists to avoid, so hierarchical epochs carry this
    sorted-key map instead: O(slots) memory, O(log slots) lookup.
    Parallel slots resolve to the lightest (the same rule as the
    overlay adjacency min-merge and the dense ``overlay_slot_table``).
    """

    def __init__(self, src: np.ndarray, dst: np.ndarray,
                 w: np.ndarray, stride: int):
        a = np.concatenate([src, dst]).astype(np.int64)
        b = np.concatenate([dst, src]).astype(np.int64)
        ww = np.concatenate([w, w])
        slot = np.concatenate(
            [np.arange(src.size, dtype=np.int64)] * 2)
        key = a * stride + b
        order = np.lexsort((ww, key))
        key, slot = key[order], slot[order]
        first = np.ones(key.size, dtype=bool)
        first[1:] = key[1:] != key[:-1]
        self.stride = stride
        self.keys = key[first]
        self.slots = slot[first]

    def lookup(self, a: int, b: int) -> int:
        """Winning slot id for the adjacency (a, b), -1 if the pair is
        not adjacent."""
        key = a * self.stride + b
        i = int(np.searchsorted(self.keys, key))
        if i < self.keys.size and self.keys[i] == key:
            return int(self.slots[i])
        return -1


# copied from src/repro/core/hierarchy.py:708
def ov_slot_map(plan) -> SlotMap:
    """Level-1 slot provenance (the sparse overlay_slot_table)."""
    return SlotMap(plan.sup_src, plan.sup_dst, plan.sup_w, plan.S + 1)


def l2_slot_map(hier: HierPlan) -> SlotMap:
    """One level's next-overlay slot provenance (cross + clique slots,
    min-merged)."""
    return SlotMap(hier.l2_src, hier.l2_dst, hier.l2_w, hier.S2 + 1)


# copied from src/repro/core/hierarchy.py:724
def hier_overlay_stats(levels: List[HierPlan], S: int) -> dict:
    """Shape/memory summary for perf records and the serve driver.
    ``nsf``/``m2``/``S2`` keep their historical (first-level) meaning
    so exp10 records stay comparable; ``S_top``/``levels_S2`` carry the
    full ladder."""
    h0, htop = levels[0], levels[-1]
    dense = 2 * (S + 1) * (S + 1) * 4            # d_super + super_next
    total = (sum(h.overlay_bytes() for h in levels)
             + 2 * (htop.S2 + 1) ** 2 * 4)       # d2 + d2_next
    return {
        "hierarchy_levels": 1 + len(levels),
        "S": S,
        "nsf": h0.nsf,
        "m2": h0.m2,
        "S2": h0.S2,
        "S_top": htop.S2,
        "levels_S2": [h.S2 for h in levels],
        "overlay_bytes": total,
        "overlay_dense_bytes": dense,
    }
