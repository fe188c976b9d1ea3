"""Device DISLAND engine on PyTorch.

Port of ``repro/core/device_engine.py``: the dense overlay
(``hierarchy_levels=1``), the N-level overlay hierarchy with its
resident pre-lifted rows, the hub-label tier, the witness (path) serve
mode, and the incremental refresh (``refresh_index``).  Every query
becomes gathers plus (min,+) algebra over padded tensors.

Offline (``build_device_index_with_plan``, device-resident products):
  * per-fragment dense APSP        [k, maxf, maxf]   (witness FW kernel)
  * boundary-row table             [k, maxf, mb]     (node -> boundary)
  * the overlay closure, either
      - dense: SUPER boundary x boundary APSP [S+1, S+1] (witness FW), or
      - hierarchical: per level, group closures [ng+1, m2, m2] (witness
        FW) and next-boundary rows, then the TOP closure d2 (blocked FW
        kernels) and, for hot level-1 groups, rows pre-lifted to the
        top boundary (``res_rows``)
  * per-piece APSP, flattened      [sum_b P_b*mp_b^2] (+ per-node
    base/stride so one gather answers any same-piece query)
  * per-node lookup vectors        agent/fragment/piece ids + positions
  * optionally, hub labels         [H+1, W] per labeled agent (hub_stage)

Refresh (``refresh_index``): a batch of edge-weight updates re-runs
exactly the stages it dirties (the dirty fragments', groups' and
pieces' witness FW, the overlay or top closure, resident rows, hub
labels) into a new ``DeviceIndex`` that shares every unchanged tensor
with the old one and writes none of them, so the old epoch can go on
serving; the result is array-equal to a scratch build on the new
weights.

Online (``serve_step``, or the planner's per-case programs):
  dist(s,t) = same-DRA answer                                (case 1)
            | d(s,u_s) + min(local, combine) + d(u_t,t)      (case 2)
  combine = min_{b1,b2} row_s[b1] + D_overlay[b1,b2] + row_t[b2],
computed without a [q, mb, mb] block.  On the card the compact
(top-level) boundary rows are contracted through their id tables by the
grouped ``minplus_twoside`` CUDA kernel (``ops.minplus_twoside_grouped``:
only the closure cells the rows can reach, where the reference scatters
them over the whole closure for its TPU kernel), and the hierarchy's
lifts and same-group legs, whose rows read the closures through slot
ids, run as one ``gather_minplus`` kernel each (``ops.gather_minplus``,
``ops.gather_minplus_twoside``); elsewhere chunked gathers keep the
peak intermediate at [q, c, width] (``_chunk``).
``serve_one_to_all`` answers one source against every node through the
``minplus`` kernel.  The ``*_w`` programs return a witness beside each
distance (the winning overlay pair from the ``minplus_twoside_argmin``
kernel on the card), which ``paths.PathUnwinder`` expands into a node
sequence; ``serve_hub`` answers hub-gated pairs with one
``label_merge_rows`` of two label rows, read through their row ids.

Everything is exact: integer weights make every float32 (min,+) sum
exactly representable, so every table and answer is bit-for-bit the
reference package's.  Tensors keep the reference's dtypes (int32 ids,
float32 distances, bool masks); gathers widen indices to int64 where
they use them.

Differences from the reference that its semantics force on PyTorch:
JAX clamps out-of-range gathers and wraps -1, while ``torch`` gathers
need in-range indices, so every index that JAX masks only *after* a
gather is masked *before* it here (a fragment id of -1 in
``serve_cross``, ``serve_cross_res`` and ``serve_one_to_all``, the piece
index in ``_same_dra_dist``).  The hierarchical tables keep every
sentinel in range by construction (``sf_of[S_l]`` is the sentinel
group, ``sf_members`` pads with S_l, ``bnd2_sid`` with S_{l+1},
``res_of_frag`` uses R for cold groups).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import scatter_rows as _scatter_rows
from ..obs import trace
from . import graphs, hierarchy, padding
from .hierarchy import _sync
from .supergraph import DislandIndex

INF = np.float32(np.inf)
_INF = float("inf")                  # the same +inf for torch calls
PIECE_BUCKETS = (8, 32, 128, 512, 2048)

_pad_to = padding.pad_to
_to = hierarchy.to_device


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  Raises when CUDA is asked for and absent; there
    is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def _dummy(shape, fill, dtype):
    return lambda: torch.full(shape, fill, dtype=dtype)


@dataclasses.dataclass
class DeviceIndex:
    """The reference's ``DeviceIndex``: same names, dtypes, shapes and
    dummies.  The dummy defaults are built on
    the CPU; the build passes every field on its own device."""
    # per-node lookups [n]
    agent_of: torch.Tensor          # int32
    dist_to_agent: torch.Tensor     # f32
    frag_of: torch.Tensor           # int32 (fragment of each *shrink* node)
    pos_in_frag: torch.Tensor       # int32
    piece_gid: torch.Tensor         # int32 global piece id (-1 if none)
    pos_in_piece: torch.Tensor      # int32
    piece_base: torch.Tensor        # int32 offset of piece block in flat
    piece_stride: torch.Tensor      # int32 row stride (= padded piece size)
    # fragments
    frag_apsp: torch.Tensor         # f32 [k, maxf, maxf]
    frag_next: torch.Tensor         # int32 [k, maxf, maxf] FW first hop (-1)
    brow: torch.Tensor              # f32 [k, maxf, mb] node->boundary rows
    bpos: torch.Tensor              # int32 [k, mb] boundary position in frag
    bvalid: torch.Tensor            # bool [k, mb]
    bnd_super: torch.Tensor         # int32 [k, mb] super id (S = sentinel)
    # super graph (dense overlay; a [1, 1] dummy on hierarchical builds)
    d_super: torch.Tensor           # f32 [S+1, S+1] (+inf sentinel row/col)
    super_next: torch.Tensor        # int32 [S+1, S+1] overlay first hop (-1)
    # pieces: every bucketed APSP tensor, flattened end to end
    piece_flat: torch.Tensor        # f32 [sum_b P_b * mp_b * mp_b]
    piece_next: torch.Tensor        # int32, same layout as piece_flat (-1)
    # hierarchical overlay: one tuple entry per grouping level, bottom
    # first, empty at hierarchy_levels=1; d2/d2_next hold the TOP
    # (last level's boundary) closure.  Serving dispatches on len(sf_of).
    sf_of: tuple = ()        # int32 [S_l+1] each (group count = sentinel)
    pos_in_sf: tuple = ()    # int32 [S_l+1]
    sf_members: tuple = ()   # int32 [ng+1, m2] (S_l = pad)
    sf_closure: tuple = ()   # f32 [ng+1, m2, m2]
    sf_next: tuple = ()      # int32 [ng+1, m2, m2]
    l2row: tuple = ()        # f32 [ng+1, m2, mb2]
    bnd2_sid: tuple = ()     # int32 [ng+1, mb2] (S_{l+1} = pad)
    d2: torch.Tensor = dataclasses.field(          # f32 [S_top+1, S_top+1]
        default_factory=_dummy((1, 1), _INF, torch.float32))
    d2_next: torch.Tensor = dataclasses.field(     # int32 [S_top+1, S_top+1]
        default_factory=_dummy((1, 1), -1, torch.int32))
    # resident pre-lifted rows: for each hot level-1 group, its members'
    # exact confined distances to every TOP boundary node; row R is the
    # all-INF sentinel, res_of_frag maps every fragment to its group's
    # row (R when cold)
    res_rows: torch.Tensor = dataclasses.field(    # f32 [R+1, m2, S_top+1]
        default_factory=_dummy((1, 1, 1), _INF, torch.float32))
    res_of_frag: torch.Tensor = dataclasses.field(  # int32 [k]
        default_factory=_dummy((1,), 0, torch.int32))
    # fragment -> TOP-level group (the gather layout contracts only
    # against each endpoint's own top-group boundary columns)
    topgrp_of_frag: torch.Tensor = dataclasses.field(  # int32 [k]
        default_factory=_dummy((1,), 0, torch.int32))
    # hub labels: row hub_of_agent[a] of hub_rows is agent a's exact
    # overlay distance to every TOP closure coordinate (dense indices:
    # every SUPER node); the last row is the all-INF sentinel, which
    # unlabeled agents map to
    hub_rows: torch.Tensor = dataclasses.field(     # f32 [H+1, W]
        default_factory=_dummy((1, 1), _INF, torch.float32))
    hub_of_agent: torch.Tensor = dataclasses.field(  # int32 [n]
        default_factory=_dummy((1,), 0, torch.int32))
    # host sidecars.  host_ov_slot: winning SUPER slot per overlay pair
    # (dense: the [S, S] table; hierarchical: a hierarchy.SlotMap),
    # host_l2_slot: one SlotMap per grouping level (path unwinding);
    # host_res_frag (fragment -> resident row, -1 cold) and
    # host_topgrp_frag (fragment -> TOP group): the planner's cross_res
    # and hub gates; host_hub_agent (agent -> label row, -1 unlabeled):
    # the hub gate
    host_ov_slot: object = None
    host_l2_slot: Optional[list] = None
    host_res_frag: Optional[np.ndarray] = None
    host_topgrp_frag: Optional[np.ndarray] = None
    host_hub_agent: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.agent_of.device

    @property
    def hierarchy_levels(self) -> int:
        return 1 + len(self.sf_of)


#: every tensor field with its dtype (convert.py checks against these)
FIELD_DTYPES = {
    "agent_of": torch.int32, "dist_to_agent": torch.float32,
    "frag_of": torch.int32, "pos_in_frag": torch.int32,
    "piece_gid": torch.int32, "pos_in_piece": torch.int32,
    "piece_base": torch.int32, "piece_stride": torch.int32,
    "frag_apsp": torch.float32, "frag_next": torch.int32,
    "brow": torch.float32, "bpos": torch.int32, "bvalid": torch.bool,
    "bnd_super": torch.int32, "d_super": torch.float32,
    "super_next": torch.int32, "piece_flat": torch.float32,
    "piece_next": torch.int32, "d2": torch.float32, "d2_next": torch.int32,
    "res_rows": torch.float32, "res_of_frag": torch.int32,
    "topgrp_of_frag": torch.int32, "hub_rows": torch.float32,
    "hub_of_agent": torch.int32,
}

#: every per-level tuple field with its dtype (empty tuples when dense)
TUPLE_FIELD_DTYPES = {
    "sf_of": torch.int32, "pos_in_sf": torch.int32,
    "sf_members": torch.int32, "sf_closure": torch.float32,
    "sf_next": torch.int32, "l2row": torch.float32,
    "bnd2_sid": torch.int32,
}


# ---------------------------------------------------------------------------
# offline build, staged
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BuildPlan:
    """Host-side skeleton of the device index (copied from the
    reference, numpy only): the weight caches (``frag_adj``, ``sup_w``),
    the fixed SUPER edge-list *structure* with per-slot provenance, and
    the piece registry."""

    n: int
    k: int
    maxf: int
    mb: int
    S: int
    # per-node host lookups
    agent_of: np.ndarray
    frag_of: np.ndarray          # original id -> fragment (-1: represented)
    pos_in_frag: np.ndarray
    piece_gid: np.ndarray
    pos_in_piece: np.ndarray
    # fragments
    frag_adj: np.ndarray         # f32 [k, maxf, maxf] current weights
    bpos: np.ndarray
    bvalid: np.ndarray
    bnd_super: np.ndarray
    # SUPER edge slots (undirected, compact ids; structure is fixed)
    sup_src: np.ndarray          # int32 [Es]
    sup_dst: np.ndarray          # int32 [Es]
    sup_w: np.ndarray            # f32 [Es] current weights
    sup_fi: np.ndarray           # int32 [Es] owning fragment (-1: E_B)
    sup_pu: np.ndarray           # int32 [Es] frag-local gather row
    sup_pv: np.ndarray           # int32 [Es] frag-local gather col
    eb_key: np.ndarray           # int64 sorted lo*n+hi keys of E_B slots
    eb_slot: np.ndarray          # int64 slot per key
    # piece registry (gid order)
    piece_members: List[np.ndarray]   # sorted original ids, incl. agent
    piece_agent: np.ndarray           # int32 [P]
    piece_agent_pos: np.ndarray       # int32 [P]
    piece_cap: np.ndarray             # int32 [P] padded size
    piece_base: np.ndarray            # int64 [P] offset into piece_flat
    # overlay hierarchy: 1 = dense d_super closure, N >= 2 = per-group
    # closures at N-1 grouping levels (``hier``, one HierPlan per level,
    # bottom first) + dense TOP boundary closure
    hierarchy_levels: int = 1
    hier: "List[hierarchy.HierPlan] | None" = None
    # resident pre-lift budget in MiB (0 disables)
    resident_mb: float = 0.0
    # pinned hub-label node set (None: no hub tier)
    hub_nodes: Optional[np.ndarray] = None
    # per-stage wall times of the build that produced this plan
    build_timings: "dict | None" = None

    @property
    def n_pieces(self) -> int:
        return len(self.piece_members)


def make_build_plan(ix: DislandIndex) -> BuildPlan:
    """Stage 0: host-side structure assembly (no device work).

    The device SUPER overlay is rebuilt here from first principles: its
    node universe is exactly the boundary nodes, E_B slots are the
    cross-fragment shrink edges, and each fragment contributes its full
    boundary-to-boundary clique whose weights are *gathered from
    frag_apsp* (``super_weights``), never stored authoritatively.
    """
    g = ix.g
    n = g.n
    k = len(ix.fragments)

    # ---- fragments + boundary universe ---------------------------------
    maxf = _pad_to(max((f.graph.n for f in ix.fragments), default=1))
    mb = _pad_to(max((f.boundary_local.size for f in ix.fragments),
                     default=1))
    frag_adj = np.full((k, maxf, maxf), INF, dtype=np.float32)
    frag_of = -np.ones(n, dtype=np.int32)
    pos_in_frag = np.zeros(n, dtype=np.int32)
    bpos = np.zeros((k, mb), dtype=np.int32)
    bvalid = np.zeros((k, mb), dtype=bool)
    bnd_ids = np.unique(np.concatenate(
        [f.nodes[f.boundary_local] for f in ix.fragments]
        or [np.empty(0, np.int64)]))
    S = bnd_ids.size
    bnd_super = np.full((k, mb), S, dtype=np.int32)
    super_id_of = -np.ones(n, dtype=np.int64)
    super_id_of[bnd_ids] = np.arange(S)
    for fi, f in enumerate(ix.fragments):
        fg = f.graph
        frag_of[f.nodes] = fi
        pos_in_frag[f.nodes] = np.arange(f.nodes.size)
        frag_adj[fi, fg.edge_u, fg.edge_v] = fg.edge_w.astype(np.float32)
        frag_adj[fi, fg.edge_v, fg.edge_u] = fg.edge_w.astype(np.float32)
        nb = f.boundary_local.size
        bpos[fi, :nb] = f.boundary_local
        bvalid[fi, :nb] = True
        bnd_super[fi, :nb] = super_id_of[f.nodes[f.boundary_local]]

    # ---- SUPER edge slots: E_B in shrink edge order, then per-fragment
    # cliques row-major ----------------------------------------------------
    shrink = ix.shrink
    lab = ix.partition.labels
    cross = lab[shrink.edge_u] != lab[shrink.edge_v]
    ou = ix.shrink_ids[shrink.edge_u[cross]].astype(np.int64)
    ov = ix.shrink_ids[shrink.edge_v[cross]].astype(np.int64)
    ek = np.minimum(ou, ov) * n + np.maximum(ou, ov)
    es = np.arange(ou.size, dtype=np.int64)
    src_parts = [super_id_of[ou].astype(np.int32)]
    dst_parts = [super_id_of[ov].astype(np.int32)]
    w_parts = [shrink.edge_w[cross].astype(np.float32)]
    fi_parts = [np.full(ou.size, -1, dtype=np.int32)]
    pu_parts = [np.full(ou.size, -1, dtype=np.int32)]
    pv_parts = [np.full(ou.size, -1, dtype=np.int32)]
    for fi, f in enumerate(ix.fragments):
        bl = f.boundary_local
        ids = super_id_of[f.nodes[bl]]
        ii, jj = np.triu_indices(bl.size, k=1)
        src_parts.append(ids[ii].astype(np.int32))
        dst_parts.append(ids[jj].astype(np.int32))
        w_parts.append(np.full(ii.size, INF, dtype=np.float32))
        fi_parts.append(np.full(ii.size, fi, dtype=np.int32))
        pu_parts.append(bl[ii].astype(np.int32))
        pv_parts.append(bl[jj].astype(np.int32))
    order = np.argsort(ek)

    # ---- piece registry + per-node lookups ------------------------------
    piece_gid = -np.ones(n, dtype=np.int32)
    pos_in_piece = np.zeros(n, dtype=np.int32)
    piece_members: List[np.ndarray] = []
    piece_agent: List[int] = []
    piece_agent_pos: List[int] = []
    piece_cap: List[int] = []
    for a in ix.dras.agents:
        for piece in a.pieces:
            cap = next(c for c in PIECE_BUCKETS if piece.size <= c)
            ids = np.unique(np.asarray(piece, dtype=np.int32))
            gid = len(piece_members)
            piece_members.append(ids)
            piece_agent.append(int(a.agent))
            piece_agent_pos.append(int(np.searchsorted(ids, a.agent)))
            piece_cap.append(cap)
            # the agent belongs to many pieces: leave its lookup at -1 so
            # case-1 logic falls through to the exact ds+dt formula
            inner = ids != a.agent
            piece_gid[ids[inner]] = gid
            pos_in_piece[ids[inner]] = np.nonzero(inner)[0]
    # flat layout: bucket-major (all cap-8 blocks, then cap-32, ...),
    # bucket-local order = gid order — matches piece_stage's batching
    cap_arr = np.asarray(piece_cap, dtype=np.int64)
    piece_base = np.zeros(len(piece_members), dtype=np.int64)
    off = 0
    for cap in PIECE_BUCKETS:
        for gid in np.nonzero(cap_arr == cap)[0]:
            piece_base[gid] = off
            off += cap * cap

    return BuildPlan(
        n=n, k=k, maxf=maxf, mb=mb, S=S,
        agent_of=ix.dras.agent_of.astype(np.int32),
        frag_of=frag_of, pos_in_frag=pos_in_frag,
        piece_gid=piece_gid, pos_in_piece=pos_in_piece,
        frag_adj=frag_adj, bpos=bpos, bvalid=bvalid, bnd_super=bnd_super,
        sup_src=np.concatenate(src_parts).astype(np.int32),
        sup_dst=np.concatenate(dst_parts).astype(np.int32),
        sup_w=np.concatenate(w_parts).astype(np.float32),
        sup_fi=np.concatenate(fi_parts).astype(np.int32),
        sup_pu=np.concatenate(pu_parts).astype(np.int32),
        sup_pv=np.concatenate(pv_parts).astype(np.int32),
        eb_key=ek[order], eb_slot=es[order],
        piece_members=piece_members,
        piece_agent=np.asarray(piece_agent, dtype=np.int32),
        piece_agent_pos=np.asarray(piece_agent_pos, dtype=np.int32),
        piece_cap=cap_arr.astype(np.int32),
        piece_base=piece_base,
    )


def _brow_from(frag_apsp: torch.Tensor, bpos: np.ndarray,
               bvalid: np.ndarray) -> torch.Tensor:
    """Boundary-row table: brow[f, p, b] = dist(node at position p,
    boundary slot b), +inf on padded slots."""
    k, maxf, _ = frag_apsp.shape
    dev = frag_apsp.device
    idx = _to(bpos, dev).long()[:, None, :].expand(k, maxf, bpos.shape[1])
    brow = torch.gather(frag_apsp, 2, idx)
    return torch.where(_to(bvalid, dev)[:, None, :], brow, _INF)


def frag_stage(plan: BuildPlan, device: torch.device, *, force=None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1: batched witness FW over every fragment ->
    (apsp, brow, next)."""
    frag_apsp, frag_next = ops.fw_batch_next(_to(plan.frag_adj, device),
                                             force=force)
    return (frag_apsp, _brow_from(frag_apsp, plan.bpos, plan.bvalid),
            frag_next)


def super_weights(plan: BuildPlan, blocks: np.ndarray,
                  frags: np.ndarray | None = None) -> None:
    """Fill the enforced SUPER slot weights by gathering from fragment
    APSP ``blocks`` (the Upsilon weights are *derived* state, never
    stored authoritatively).

    ``frags=None``: blocks is the full [k, maxf, maxf] table, fill every
    enforced slot.  Otherwise blocks holds only the listed fragments'
    rows, and only their slots are rewritten.
    """
    if frags is None:
        mask = plan.sup_fi >= 0
        local = plan.sup_fi[mask]
    else:
        mask = np.isin(plan.sup_fi, frags)
        fi_to_row = -np.ones(plan.k, dtype=np.int64)
        fi_to_row[frags] = np.arange(len(frags))
        local = fi_to_row[plan.sup_fi[mask]]
    plan.sup_w[mask] = blocks[local, plan.sup_pu[mask], plan.sup_pv[mask]]


def super_overlay(plan: BuildPlan) -> np.ndarray:
    """Dense [S, S] overlay adjacency from the slot list (parallel
    slots min-merged, diag 0)."""
    S = plan.S
    m = np.full((S, S), INF, np.float32)
    np.minimum.at(m, (plan.sup_src, plan.sup_dst), plan.sup_w)
    np.minimum.at(m, (plan.sup_dst, plan.sup_src), plan.sup_w)
    np.fill_diagonal(m, 0.0)
    return m


def overlay_slot_table(plan: BuildPlan) -> np.ndarray:
    """Winning slot id per overlay adjacency pair [S, S] (-1: none).

    Writes slots in descending weight order so the last (= lightest)
    write wins, matching super_overlay's min-merge of parallel slots.
    Carried on the DeviceIndex as the ``host_ov_slot`` sidecar for path
    unwinding.
    """
    ov = np.full((plan.S, plan.S), -1, np.int32)
    if plan.sup_w.size:
        order = np.argsort(plan.sup_w, kind="stable")[::-1]
        src, dst = plan.sup_src[order], plan.sup_dst[order]
        ov[src, dst] = order
        ov[dst, src] = order
    return ov


def super_stage(plan: BuildPlan, device: torch.device, *, force=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: SUPER APSP — dense witness FW closure of the boundary
    overlay -> (d_super, super_next), with an +inf sentinel row and
    column at index S."""
    S = plan.S
    d_super = torch.full((S + 1, S + 1), _INF, dtype=torch.float32,
                         device=device)
    super_next = torch.full((S + 1, S + 1), -1, dtype=torch.int32,
                            device=device)
    if S == 0 or plan.sup_src.size == 0:
        return d_super, super_next
    d_s, n_s = ops.fw_next(_to(super_overlay(plan), device), force=force)
    d_super[:S, :S] = d_s
    super_next[:S, :S] = n_s
    return d_super, super_next


def _piece_adjs(g, plan: BuildPlan, gids, cap: int) -> np.ndarray:
    """[len(gids), cap, cap] adjacency of the pieces ``gids`` (bucket
    ``cap``): each piece's induced subgraph in its sorted members'
    order, as ``g.subgraph(plan.piece_members[gid])`` gives it (the
    reference builds it so, one piece at a time: an O(m) pass a piece,
    minutes at road250k's 24,707 pieces), from one pass over the edge
    list.  A piece's members are its inner nodes (``piece_gid`` == gid)
    and its agent, so an edge lies in the piece of either endpoint's
    ``piece_gid`` when both endpoints are members there."""
    gids = np.asarray(gids, np.int64)
    adj = np.full((gids.size, cap, cap), INF, dtype=np.float32)
    slot = np.full(plan.piece_cap.size, -1, np.int64)
    slot[gids] = np.arange(gids.size)
    u, v = g.edge_u.astype(np.int64), g.edge_v.astype(np.int64)
    w = g.edge_w.astype(np.float32)
    gu, gv = plan.piece_gid[u], plan.piece_gid[v]
    # the piece of u's piece_gid, then of v's where it differs
    for gid in (gu, np.where(gv != gu, gv, -1)):
        safe = np.maximum(gid, 0)
        agent = plan.piece_agent[safe]
        in_u = (gu == gid) | (u == agent)
        in_v = (gv == gid) | (v == agent)
        e = np.nonzero((gid >= 0) & in_u & in_v & (slot[safe] >= 0))[0]
        apos = plan.piece_agent_pos[safe[e]]
        pu = np.where(gu[e] == gid[e], plan.pos_in_piece[u[e]], apos)
        pv = np.where(gv[e] == gid[e], plan.pos_in_piece[v[e]], apos)
        adj[slot[safe[e]], pu, pv] = w[e]
        adj[slot[safe[e]], pv, pu] = w[e]
    return adj


def _fw_bucket(adjs: np.ndarray, device: torch.device, *,
               force=None) -> tuple[np.ndarray, np.ndarray]:
    """Batched witness FW over equally-padded piece matrices ->
    (dist blocks, next blocks) on the host.  The reference rounds a
    refresh's batch up to a power of two with +inf matrices
    (src/repro/core/device_engine.py:487-490) so XLA compiles O(log P)
    batch shapes; the CUDA kernels take any batch and FW is independent
    across it, so build and refresh both run exactly the matrices they
    need."""
    out, nxt = ops.fw_batch_next(_to(adjs, device), force=force)
    out = out.cpu().numpy()
    # +inf padding only ever ADDS (inf + inf = inf, never inf - inf), so
    # no NaN can arise; a kernel regression here must fail the build
    # loudly, not surface as serving mismatches three layers up
    if np.isnan(out).any():
        raise FloatingPointError(
            "piece FW produced NaN (inf-padding arithmetic regressed?)")
    return out, nxt.cpu().numpy()


def piece_stage(plan: BuildPlan, g, device: torch.device, *, force=None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Stage 3: per-piece APSP, size-bucketed batched FW, flattened end
    to end into the single piece_flat gather table, plus the
    identically laid out first-hop table piece_next."""
    total = int(sum(int(c) * int(c) for c in plan.piece_cap))
    flat = np.full(max(total, 1), INF, dtype=np.float32)
    nflat = np.full(max(total, 1), -1, dtype=np.int32)
    for cap in PIECE_BUCKETS:
        gids = np.nonzero(plan.piece_cap == cap)[0]
        if gids.size == 0:
            continue
        blocks, nexts = _fw_bucket(_piece_adjs(g, plan, gids, cap), device,
                                   force=force)
        for gid, block, nxt in zip(gids, blocks, nexts):
            base = plan.piece_base[gid]
            flat[base:base + cap * cap] = block.reshape(-1)
            nflat[base:base + cap * cap] = nxt.reshape(-1)
    return flat, nflat


def hier_super_stage(plan: BuildPlan, device: torch.device, *,
                     force=None) -> dict:
    """Stage 2, hierarchical: close the overlay as an N-level partition
    hierarchy instead of one dense FW.

    Per grouping level, bottom first: fill the level's group adjacency
    from its source overlay's current slot weights (level 1 gathers
    ``plan.sup_w``; level l > 1 the previous level's derived ``l2_w``),
    run the batched witness FW once at the pow2 tile shape
    [nsf, m2, m2] (``hierarchy.sf_stage``), then gather the NEXT
    overlay's clique weights from those closures.  Only the top boundary
    set closes densely (``hierarchy.l2_stage`` -> d2).  Returns the
    DeviceIndex field dict (per-level tuples) plus the host-side
    provenance sidecars (one SlotMap per level).  Per-level FW seconds
    (``sf_stage_l<i>``), the top closure (``l2_fw``) and ``first_hops``
    (on the card, as the closure) land in ``plan.build_timings``.
    """
    levels = plan.hier
    bt = plan.build_timings
    per: dict = {name: [] for name in TUPLE_FIELD_DTYPES}
    l2_slots = []
    w = plan.sup_w
    for li, h in enumerate(levels):
        hierarchy.sf_adj_fill(h, w)
        with trace.timed("build.sf_stage", bt, f"sf_stage_l{li + 1}",
                         nsf=h.nsf, m2=h.m2):
            sf_closure, sf_next, l2row = hierarchy.sf_stage(h, device,
                                                            force=force)
            blocks = sf_closure[:h.nsf].cpu().numpy()
        hierarchy.hier_weights(h, blocks, w)
        Sl = h.sf_of.shape[0]                    # this overlay's size
        sf_of = np.concatenate([h.sf_of, [h.nsf]]).astype(np.int32)
        pos_in_sf = np.concatenate([h.pos_in_sf, [0]]).astype(np.int32)
        members = np.where(h.sf_members < 0, Sl,
                           h.sf_members).astype(np.int32)
        members = np.concatenate(
            [members, np.full((1, h.m2), Sl, np.int32)])
        bnd2_sid = np.concatenate(
            [h.bnd2_sid, np.full((1, h.mb2), h.S2, np.int32)])
        per["sf_of"].append(_to(sf_of, device))
        per["pos_in_sf"].append(_to(pos_in_sf, device))
        per["sf_members"].append(_to(members, device))
        per["sf_closure"].append(sf_closure)
        per["sf_next"].append(sf_next)
        per["l2row"].append(l2row)
        per["bnd2_sid"].append(_to(bnd2_sid, device))
        l2_slots.append(hierarchy.l2_slot_map(h))
        w = h.l2_w
    d2, d2_next = hierarchy.l2_stage(levels[-1], device, force=force,
                                     timings=bt)
    fields = {name: tuple(v) for name, v in per.items()}
    fields["d2"] = d2
    fields["d2_next"] = d2_next
    return {
        "fields": fields,
        "ov_slot": hierarchy.ov_slot_map(plan),
        "l2_slot": l2_slots,
    }


def _compose_minplus(U: torch.Tensor, M: torch.Tensor,
                     chunk: int = 32) -> torch.Tensor:
    """out[i, j] = min_b U[i, b] + M[b, j], chunked over b so the peak
    intermediate stays [m2, chunk, mb'] (build-time helper for the
    resident pre-lift; runs once per hot group per build)."""
    out = torch.full((U.shape[0], M.shape[1]), _INF, dtype=U.dtype,
                     device=U.device)
    for i in range(0, U.shape[1], chunk):
        out = torch.minimum(out, (U[:, i:i + chunk, None]
                                  + M[None, i:i + chunk, :]).amin(dim=1))
    return out


def resident_stage(plan: BuildPlan, fields: dict) -> dict | None:
    """Stage 2b: resident pre-lifted rows.

    For each hot level-1 group g (top traffic mass, capped by
    ``plan.resident_mb``), compose the per-level lift chain once:

      U_g[p, c] = min over (a_1, ..., a_{L-1}) of
                  l2row[0][g, p, a_1] + l2row[1][g_2, pos(a_1), a_2]
                  + ... (+ sentinel-masked at every step)

    scattered to dense top coordinates: the exact confined distance
    from every member position p to every TOP boundary node c.  A hot
    cross-top-group query then runs ONE fused minplus_twoside against
    d2 instead of L per-level lifts; exact because a route between
    different top groups must touch the top boundary, and its prefix up
    to the first top contact stays hierarchically confined.

    Returns the DeviceIndex field dict plus the planner's host sidecars,
    or None when disabled or degenerate.
    """
    levels = plan.hier
    if not levels or plan.resident_mb <= 0:
        return None
    h0 = levels[0]
    stp1 = int(fields["d2"].shape[0])
    if h0.nsf == 0 or stp1 <= 1:
        return None
    # traffic-mass proxy: original graph nodes per level-1 group
    frag_nodes = np.bincount(plan.frag_of[plan.frag_of >= 0].astype(
        np.int64), minlength=plan.k)
    mass = np.zeros(h0.nsf, dtype=np.int64)
    np.add.at(mass, h0.sf_of_frag.astype(np.int64), frag_nodes)
    per_sf = h0.m2 * stp1 * 4
    cap = int(plan.resident_mb * (1 << 20)) // max(per_sf, 1)
    if cap <= 0:
        return None
    hot = np.sort(np.argsort(-mass, kind="stable")[:min(cap, h0.nsf)])
    l2rows = fields["l2row"]
    dev = l2rows[0].device
    sids = [x.cpu().numpy() for x in fields["bnd2_sid"]]
    poss = [x.cpu().numpy() for x in fields["pos_in_sf"]]
    L = len(l2rows)
    rows_out = []
    for g in hot.tolist():
        U, ids = _group_chain(levels, l2rows, sids, poss, g)
        cols = _to(ids, dev).long()[None, :].expand(U.shape[0], -1)
        rows_out.append(torch.full((U.shape[0], stp1), _INF,
                                   dtype=U.dtype, device=dev
                                   ).scatter_reduce_(1, cols, U, "amin"))
    R = len(rows_out)
    res_rows = torch.stack(rows_out + [torch.full(
        (h0.m2, stp1), _INF, dtype=torch.float32, device=dev)])
    rmap = np.full(h0.nsf, R, np.int32)
    rmap[hot] = np.arange(R, dtype=np.int32)
    res_of_frag = rmap[h0.sf_of_frag.astype(np.int64)]
    top = topgrp_of_frag(levels)
    return {
        "fields": {"res_rows": res_rows,
                   "res_of_frag": _to(res_of_frag, dev),
                   "topgrp_of_frag": _to(top.astype(np.int32), dev)},
        # planner sidecars: fragment -> resident row (-1: cold) and
        # fragment -> TOP group (the exactness gate)
        "res_frag": np.where(res_of_frag < R, res_of_frag,
                             -1).astype(np.int32),
        "topgrp_frag": top,
    }


def topgrp_of_frag(levels) -> np.ndarray:
    """fragment -> TOP group of a hierarchy plan (int32): the exactness
    gate of the cross_res bucket and of the hub tier."""
    top = levels[0].sf_of_frag.astype(np.int64)
    for li in range(1, len(levels)):
        top = levels[li].sf_of_frag.astype(np.int64)[top]
    return top.astype(np.int32)


def hub_agents(plan: BuildPlan) -> np.ndarray:
    """The agents the hub tier labels, in label-row order (by fragment,
    then agent): the agents of ``plan.hub_nodes`` that lie in a
    fragment.  Empty without hub nodes.  Host data only, so the tier's
    gate (``dist_engine.hub_gate``) can be computed before, or without,
    a device build."""
    nodes = plan.hub_nodes
    if nodes is None or len(nodes) == 0:
        return np.zeros(0, np.int64)
    agents = np.unique(plan.agent_of[np.asarray(nodes, np.int64)]
                       .astype(np.int64))
    agents = agents[plan.frag_of[agents] >= 0]
    return agents[np.lexsort((agents, plan.frag_of[agents]))]


def _group_chain(levels, l2rows, sids, poss, g: int
                 ) -> tuple[torch.Tensor, np.ndarray]:
    """(U, ids): level-1 group g's confined member rows composed up the
    per-level lift ladder (resident_stage's loop, kept compact), and the
    TOP ids of U's columns."""
    U = l2rows[0][g]
    ids = sids[0][g]
    dev = U.device
    gg = g
    for li in range(1, len(l2rows)):
        sent = levels[li - 1].S2
        gg = int(levels[li].sf_of_frag[gg])
        M = l2rows[li][gg][_to(poss[li][ids], dev).long()]
        M = torch.where(_to(ids != sent, dev)[:, None], M, _INF)
        U = _compose_minplus(U, M)
        ids = sids[li][gg]
    return U, ids


def hub_stage(plan: BuildPlan, fields: dict) -> dict | None:
    """Stage 2c: hub labels for the hub-label tier.

    For every agent of a node in ``plan.hub_nodes`` (fragment-batched),
    compose its label row, the exact overlay distance from the agent to
    every TOP closure coordinate:

      lab[a, y] = min_{j, x} brow[f, p_a, j] + chain_f[j, x] + d2[x, y]

    where ``chain_f`` is the per-level confined lift ladder the resident
    rows pre-compose, restricted to fragment f's boundary slots, and the
    trailing d2 contraction closes the row over the whole top boundary.
    Dense indices skip the ladder: lab[a] = brow row (min,+) d_super.
    Every leg is a (min,+) product over tables the build already holds.

    Exact for endpoints in different TOP groups (dense: different
    fragments): their route must touch the top boundary, so
    min_y lab_s[y] + lab_t[y] equals the planner's two-sided combine.
    Same-top-group pairs fall through to the planner.  Returns the
    DeviceIndex field dict plus the planner's host sidecars, or None
    when there is no hub set or no labeled agent.
    """
    # fragment-batched construction; (fragment, agent) order is the
    # label row order
    agents = hub_agents(plan)
    if agents.size == 0:
        return None
    brow = fields["brow"]
    dev = brow.device
    levels = plan.hier
    frag_a = plan.frag_of[agents]
    pos_a = plan.pos_in_frag[agents]
    H = int(agents.size)
    rows_out = []
    topgrp_frag = None
    if levels:
        h0 = levels[0]
        l2rows, d2 = fields["l2row"], fields["d2"]
        sids = [x.cpu().numpy() for x in fields["bnd2_sid"]]
        poss = [x.cpu().numpy() for x in fields["pos_in_sf"]]
        width = int(d2.shape[0])
        chains: dict = {}
        for f in np.unique(frag_a).tolist():
            sel = frag_a == f
            g = int(h0.sf_of_frag[f])
            if g not in chains:
                chains[g] = _group_chain(levels, l2rows, sids, poss, g)
            U, ids = chains[g]
            Z = U[_to(poss[0][plan.bnd_super[f]], dev).long()]  # [mb, w]
            Z = torch.where(_to(plan.bvalid[f], dev)[:, None], Z, _INF)
            conf = _compose_minplus(brow[f][_to(pos_a[sel], dev).long()], Z)
            # sentinel ids land on d2's +inf row: absorbing, no mask
            rows_out.append(_compose_minplus(conf,
                                             d2[_to(ids, dev).long()]))
        topgrp_frag = topgrp_of_frag(levels)
    else:
        d_super = fields["d_super"]
        width = int(d_super.shape[0])
        for f in np.unique(frag_a).tolist():
            sel = frag_a == f
            M = d_super[_to(plan.bnd_super[f], dev).long()]   # [mb, S+1]
            M = torch.where(_to(plan.bvalid[f], dev)[:, None], M, _INF)
            rows_out.append(_compose_minplus(
                brow[f][_to(pos_a[sel], dev).long()], M))
    hub_rows = torch.cat(rows_out + [torch.full(
        (1, width), _INF, dtype=torch.float32, device=dev)])
    hmap = np.full(plan.n, H, np.int32)          # sentinel row for all
    hmap[agents] = np.arange(H, dtype=np.int32)
    hub_agent = np.full(plan.n, -1, np.int32)    # planner gate sidecar
    hub_agent[agents] = np.arange(H, dtype=np.int32)
    return {
        "fields": {"hub_rows": hub_rows, "hub_of_agent": _to(hmap, dev)},
        "hub_agent": hub_agent,
        # fragment -> TOP group, the hierarchical exactness gate: hub
        # serving must not depend on the resident stage having run
        "topgrp_frag": topgrp_frag,
    }


def hub_base_fields(plan: BuildPlan, src, brow) -> dict:
    """The hub_stage input dict: ``src`` maps a field name to its
    current tensor, ``brow`` is the fragment boundary-row table."""
    base = {"brow": brow}
    if plan.hierarchy_levels >= 2:
        base.update({name: src(name) for name in
                     ("l2row", "bnd2_sid", "pos_in_sf", "d2")})
    else:
        base["d_super"] = src("d_super")
    return base


def resolve_hierarchy_levels(S: int, hierarchy_levels) -> int:
    """Normalize the ``hierarchy_levels`` build knob as the reference
    does: "auto" switches off the dense overlay once S crosses
    hierarchy.AUTO_THRESHOLD (the planner then deepens on its own until
    the top closure fits); explicit 1..MAX_LEVELS is honored (1 on an
    empty overlay; the depth plan_hierarchy builds is authoritative)."""
    if hierarchy_levels == "auto":
        hierarchy_levels = 2 if S > hierarchy.AUTO_THRESHOLD else 1
    try:
        lv = int(hierarchy_levels)
    except (TypeError, ValueError):
        raise ValueError(
            f"hierarchy_levels must be an int or 'auto': "
            f"{hierarchy_levels!r}")
    if not 1 <= lv <= hierarchy.MAX_LEVELS:
        raise ValueError(
            f"hierarchy_levels must be in 1..{hierarchy.MAX_LEVELS} "
            f"or 'auto': {hierarchy_levels!r}")
    if lv > 1 and S == 0:
        return 1
    return lv


def _node_piece_addressing(plan: BuildPlan) -> tuple[np.ndarray,
                                                     np.ndarray]:
    """Per-node (piece_base, piece_stride) vectors from the registry."""
    base = np.zeros(plan.n, dtype=np.int32)
    stride = np.zeros(plan.n, dtype=np.int32)
    hot = plan.piece_gid >= 0
    gid = plan.piece_gid[hot]
    base[hot] = plan.piece_base[gid]
    stride[hot] = plan.piece_cap[gid]
    return base, stride


#: default resident pre-lift budget (MiB) when ``resident_mb="auto"``
#: on a hierarchical index, sized so every road64k-scale group fits
RESIDENT_MB_AUTO = 64.0


def _dummies(device: torch.device) -> dict:
    """The defaulted tensor fields' dummies (hierarchical and hub tables:
    the values of a dense build without hubs), on ``device``."""
    return {f.name: f.default_factory().to(device)
            for f in dataclasses.fields(DeviceIndex)
            if f.default_factory is not dataclasses.MISSING}


def build_device_index_with_plan(
        ix: DislandIndex, *, device=None, force=None,
        hierarchy_levels: int | str = "auto",
        resident_mb: float | str = "auto", hub_nodes=None
        ) -> tuple[DeviceIndex, BuildPlan]:
    """Full from-scratch build on ``device`` (default ``cuda``).  Each
    stage's wall time, kernels included, lands in ``plan.build_timings``.

    ``hierarchy_levels`` picks the overlay closure: 1 = the dense
    [S+1, S+1] witness FW, N in 2..5 = the N-level partition hierarchy,
    "auto" = hierarchical once S crosses ``hierarchy.AUTO_THRESHOLD``,
    deepening until the top closure fits under it.  ``resident_mb``
    budgets the resident pre-lifted rows on hierarchical indices
    ("auto" = RESIDENT_MB_AUTO; 0 disables).  ``hub_nodes`` pins the
    hub-label tier's node set (None or empty: no hub tier).
    """
    dev = resolve_device(device)
    bt: dict = {}
    with trace.timed("build.plan", bt, "plan"):
        plan = make_build_plan(ix)
        if hub_nodes is not None and len(hub_nodes):
            plan.hub_nodes = np.asarray(hub_nodes, np.int64)
        lv = resolve_hierarchy_levels(plan.S, hierarchy_levels)
        if lv >= 2:
            plan.hier = hierarchy.plan_hierarchy(
                plan,
                levels="auto" if hierarchy_levels == "auto" else lv)
            # the planner may stop early on degenerate levels (or
            # deepen, under "auto"): the built depth is authoritative
            plan.hierarchy_levels = 1 + len(plan.hier)
            plan.resident_mb = (RESIDENT_MB_AUTO if resident_mb == "auto"
                                else float(resident_mb))
    plan.build_timings = bt
    with trace.timed("build.frag_stage", bt, "frag_stage", k=plan.k):
        frag_apsp, brow, frag_next = frag_stage(plan, dev, force=force)
        super_weights(plan, frag_apsp.cpu().numpy())
        _sync(dev)
    fields = _dummies(dev)
    hres = rres = None
    if plan.hierarchy_levels >= 2:
        with trace.timed("build.hier_super_stage", bt, "super_stage",
                         levels=plan.hierarchy_levels):
            hres = hier_super_stage(plan, dev, force=force)
            fields.update(hres["fields"])
            _sync(dev)
        with trace.timed("build.resident_stage", bt, "resident_stage"):
            rres = resident_stage(plan, fields)
            if rres is not None:
                fields.update(rres["fields"])
            _sync(dev)
        d_super = torch.full((1, 1), _INF, dtype=torch.float32, device=dev)
        super_next = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
    else:
        with trace.timed("build.super_stage", bt, "super_stage", S=plan.S):
            d_super, super_next = super_stage(plan, dev, force=force)
            _sync(dev)
    with trace.timed("build.hub_stage", bt, "hub_stage"):
        hub = hub_stage(plan, hub_base_fields(
            plan, {**fields, "d_super": d_super}.__getitem__, brow))
        if hub is not None:
            fields.update(hub["fields"])
        _sync(dev)
    with trace.timed("build.piece_stage", bt, "piece_stage",
                     pieces=plan.n_pieces):
        piece_flat, piece_next = piece_stage(plan, ix.g, dev, force=force)
    base, stride = _node_piece_addressing(plan)
    dix = DeviceIndex(
        **fields,
        agent_of=_to(plan.agent_of, dev),
        dist_to_agent=_to(ix.dras.dist_to_agent.astype(np.float32), dev),
        frag_of=_to(plan.frag_of, dev),
        pos_in_frag=_to(plan.pos_in_frag, dev),
        piece_gid=_to(plan.piece_gid, dev),
        pos_in_piece=_to(plan.pos_in_piece, dev),
        piece_base=_to(base, dev),
        piece_stride=_to(stride, dev),
        frag_apsp=frag_apsp,
        frag_next=frag_next,
        brow=brow,
        bpos=_to(plan.bpos, dev),
        bvalid=_to(plan.bvalid, dev),
        bnd_super=_to(plan.bnd_super, dev),
        d_super=d_super,
        super_next=super_next,
        piece_flat=_to(piece_flat, dev),
        piece_next=_to(piece_next, dev),
    )
    # host sidecars: slot provenance for the overlay closure this index
    # was built with (dense: the [S, S] table; hierarchical: the sparse
    # SlotMap plus one per level), and the planner's cross_res gate
    if hres is not None:
        dix.host_ov_slot = hres["ov_slot"]
        dix.host_l2_slot = hres["l2_slot"]
        if rres is not None:
            dix.host_res_frag = rres["res_frag"]
            dix.host_topgrp_frag = rres["topgrp_frag"]
    else:
        dix.host_ov_slot = overlay_slot_table(plan)
    if hub is not None:
        dix.host_hub_agent = hub["hub_agent"]
        if hub["topgrp_frag"] is not None and dix.host_topgrp_frag is None:
            # hierarchical index without resident rows: the hub gate
            # still needs the fragment -> TOP group map
            dix.host_topgrp_frag = hub["topgrp_frag"]
    return dix, plan


def build_device_index(ix: DislandIndex, *, device=None, force=None,
                       hierarchy_levels: int | str = "auto",
                       resident_mb: float | str = "auto",
                       hub_nodes=None) -> DeviceIndex:
    """Assemble padded tensors on the host, run the device stages."""
    return build_device_index_with_plan(
        ix, device=device, force=force,
        hierarchy_levels=hierarchy_levels, resident_mb=resident_mb,
        hub_nodes=hub_nodes)[0]


# ---------------------------------------------------------------------------
# incremental refresh (paper §IV/§V locality).  A refresh never writes a
# tensor of the index it starts from: that epoch may still be serving, so
# every changed table is a new tensor (``index_copy`` or a fresh build),
# and the unchanged ones are shared by reference with the new epoch.
# ---------------------------------------------------------------------------
def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# copied from src/repro/core/device_engine.py:973
def index_fields_equal(a, b, names) -> dict:
    """Per-field array equality between two indices, tuple-field aware
    (per-level fields compare leaf by leaf).  Either index may live on
    any device, or be the reference package's."""
    out = {}
    for name in names:
        la, lb = _leaves(getattr(a, name)), _leaves(getattr(b, name))
        out[name] = (len(la) == len(lb) and all(
            np.array_equal(_host(x), _host(y)) for x, y in zip(la, lb)))
    return out


#: the host sidecars an epoch carries beside its tensors
SIDECARS = ("host_ov_slot", "host_l2_slot", "host_res_frag",
            "host_topgrp_frag", "host_hub_agent")


def _sidecar_equal(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(_sidecar_equal(p, q) for p, q in zip(x, y)))
    if hasattr(x, "slots"):                       # a SlotMap
        return (hasattr(y, "slots") and x.stride == y.stride
                and np.array_equal(x.keys, y.keys)
                and np.array_equal(x.slots, y.slots))
    return np.array_equal(np.asarray(x), np.asarray(y))


def sidecars_equal(a, b) -> dict:
    """Per-sidecar equality between two indices (``SIDECARS``; a
    SlotMap compares by stride, keys and slots).  The reference sets a
    sidecar as an attribute only when it has one, so an absent one reads
    as None."""
    return {name: _sidecar_equal(getattr(a, name, None),
                                 getattr(b, name, None))
            for name in SIDECARS}


def warmup_refresh(plan: BuildPlan, device: torch.device, *,
                   force=None) -> None:
    """Launch the witness FW once at each shape a refresh batches: a
    fragment, a piece of each bucket in use, a group of each level, so
    kernel loads and first-launch costs land here and not inside a live
    ``refresh_index``.  The reference compiles its pow2 batch shapes
    here (src/repro/core/device_engine.py:988); the port runs unpadded
    batches, whose kernels take any batch size."""
    shapes = {(1, plan.maxf, plan.maxf)}
    shapes |= {(1, int(cap), int(cap)) for cap in np.unique(plan.piece_cap)}
    shapes |= {(1, h.m2, h.m2) for h in plan.hier or ()}
    for shp in sorted(shapes):
        ops.fw_batch_next(torch.full(shp, _INF, dtype=torch.float32,
                                     device=device), force=force)
    _sync(device)


# copied from src/repro/core/device_engine.py:1010
@dataclasses.dataclass
class UpdateClass:
    """A weight-update batch classified against the index structure.

    The paper's decomposition localizes every weight change: an edge is
    (i) inside one DRA piece, (ii) inside one fragment, and/or (iii) an
    E_B SUPER slot — nothing else.  Same-fragment boundary-boundary
    edges hit (ii) and (iii) simultaneously.
    """

    dirty_frags: np.ndarray      # fragment ids
    frag_fi: np.ndarray          # per same-fragment update
    frag_pu: np.ndarray
    frag_pv: np.ndarray
    frag_w: np.ndarray
    eb_slots: np.ndarray         # per E_B update
    eb_w: np.ndarray
    dirty_gids: np.ndarray       # piece ids
    n_inert: int                 # edges touching no served structure


# copied from src/repro/core/device_engine.py:1031
def classify_updates(plan: BuildPlan, u, v, w) -> UpdateClass:
    """Map (u, v, new_w) updates onto dirty fragments / slots / pieces."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    gid_u = plan.piece_gid[u]
    gid_v = plan.piece_gid[v]
    piece_m = (gid_u >= 0) | (gid_v >= 0)
    gid = np.where(gid_u >= 0, gid_u, gid_v)
    # structural invariant (paper Props 3-9): a represented node's only
    # neighbours are its piece co-members and its agent
    other_gid = np.where(gid_u >= 0, gid_v, gid_u)
    other = np.where(gid_u >= 0, v, u)
    safe_gid = np.where(piece_m, gid, 0)
    ok = (~piece_m | (other_gid == gid)
          | (other == plan.piece_agent[safe_gid]))
    if not ok.all():
        bad = np.nonzero(~ok)[0][0]
        raise ValueError(
            f"edge ({int(u[bad])}, {int(v[bad])}) crosses piece "
            "boundaries; index structure does not admit it")
    # same-fragment updates (frag_adj entries)
    fu = plan.frag_of[u]
    fv = plan.frag_of[v]
    frag_m = ~piece_m & (fu >= 0) & (fu == fv)
    # E_B slots (covers cross-fragment edges AND same-fragment edges
    # whose endpoints are both boundary)
    key = np.minimum(u, v) * plan.n + np.maximum(u, v)
    if plan.eb_key.size:
        pos = np.clip(np.searchsorted(plan.eb_key, key), 0,
                      plan.eb_key.size - 1)
        eb_m = ~piece_m & (plan.eb_key[pos] == key)
        slots = plan.eb_slot[pos]
    else:
        eb_m = np.zeros(u.size, dtype=bool)
        slots = np.zeros(u.size, dtype=np.int64)
    inert = int((~piece_m & ~frag_m & ~eb_m).sum())
    return UpdateClass(
        dirty_frags=np.unique(fu[frag_m]).astype(np.int64),
        frag_fi=fu[frag_m],
        frag_pu=plan.pos_in_frag[u[frag_m]],
        frag_pv=plan.pos_in_frag[v[frag_m]],
        frag_w=w[frag_m],
        eb_slots=slots[eb_m],
        eb_w=w[eb_m],
        dirty_gids=np.unique(gid[piece_m]).astype(np.int64),
        n_inert=inert,
    )


# copied from src/repro/core/device_engine.py:1081
@dataclasses.dataclass
class RefreshStats:
    """What one refresh_index call touched.  ``timings`` holds each
    stage's seconds (classify, frag_fw, super_fw, hub, pieces) and the
    total, each ending in a device synchronise."""

    n_updates: int
    n_dirty_frags: int
    n_frags: int
    n_dirty_pieces: int
    n_pieces: int
    n_eb_slots: int
    n_inert: int
    total_increase: float
    decrease_only: bool          # no weight rose (jam-clear batch)
    timings: dict
    # how the top closure was produced: "carry" (no overlay delta),
    # "decrease" (bounded relaxation fast path), "full_fw", "dense"
    top_closure: str = "carry"

    @property
    def dirty_frag_frac(self) -> float:
        return self.n_dirty_frags / max(self.n_frags, 1)

    def as_record(self) -> dict:
        return {
            "n_updates": self.n_updates,
            "dirty_frags": f"{self.n_dirty_frags}/{self.n_frags}",
            "dirty_frag_frac": round(self.dirty_frag_frac, 4),
            "dirty_pieces": f"{self.n_dirty_pieces}/{self.n_pieces}",
            "decrease_only": self.decrease_only,
            "top_closure": self.top_closure,
            "refresh_s": round(self.timings.get("total", 0.0), 4),
            "stage_timings": {
                k: round(v, 4)
                for k, v in sorted(self.timings.items())
                if k != "total"},
        }


def refresh_frag_stage(plan: BuildPlan, frag_apsp: torch.Tensor,
                       brow: torch.Tensor, frag_next: torch.Tensor,
                       upd: UpdateClass, *, force=None
                       ) -> tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor, np.ndarray]:
    """Re-run the witness FW on the dirty fragment subset only ->
    (frag_apsp, brow, frag_next, the dirty blocks on the host).

    FW is independent across the batch, so the dirty rows come out
    bit-identical to a full-batch from-scratch run, distances and first
    hops alike.  The reference pads the dirty set to a power of two by
    repeating its first id (src/repro/core/device_engine.py:1141-1149)
    so XLA compiles O(log k) programs; the CUDA kernels take any batch,
    so the port runs the dirty set as it is, and its scatter has no
    duplicate index.  The scatters are ``index_copy``: new tensors, the
    serving epoch's stay as they were.
    """
    plan.frag_adj[upd.frag_fi, upd.frag_pu, upd.frag_pv] = upd.frag_w
    plan.frag_adj[upd.frag_fi, upd.frag_pv, upd.frag_pu] = upd.frag_w
    dirty = upd.dirty_frags
    if dirty.size == 0:
        return frag_apsp, brow, frag_next, np.empty(
            (0, plan.maxf, plan.maxf), np.float32)
    dev = frag_apsp.device
    idx = _to(dirty, dev)
    blocks, nexts = ops.fw_batch_next(_to(plan.frag_adj[dirty], dev),
                                      force=force)
    br = _brow_from(blocks, plan.bpos[dirty], plan.bvalid[dirty])
    return (frag_apsp.index_copy(0, idx, blocks),
            brow.index_copy(0, idx, br),
            frag_next.index_copy(0, idx, nexts), blocks.cpu().numpy())


def refresh_hier_stage(plan: BuildPlan, dix: DeviceIndex,
                       changed_slots: np.ndarray, undo: dict, *,
                       force=None) -> dict:
    """Hierarchical twin of the dense overlay re-close: cascade the
    dirty-slot delta up the level ladder (copied from
    src/repro/core/device_engine.py:1159).

    At each level, a changed source slot dirties either one group's
    adjacency block (both endpoints inside it: re-close those groups'
    witness FW tiles, unpadded, as ``refresh_frag_stage`` explains) or a
    cross slot (a direct next-level weight copy).  The *observed*
    next-level weight delta (l2_w before vs after) is what propagates:
    the cascade stops at the first level whose boundary weights came out
    unchanged, and every deeper table plus the top closure carries over
    by reference.  A top reached by decreases only is re-closed by
    ``hierarchy.l2_decrease_stage`` where it pays, else by the full
    ``hierarchy.l2_stage``.  ``undo`` is filled with per-level rollback
    snapshots of the weight caches BEFORE any mutation, so a failure
    later in the refresh can restore them.
    """
    levels = plan.hier
    dev = dix.device
    closures = list(dix.sf_closure)
    nexts = list(dix.sf_next)
    rows_t = list(dix.l2row)
    l2_slots = list(dix.host_l2_slot)
    undo["levels"] = []
    cur = changed_slots
    w_src = plan.sup_w
    d2, d2_next = dix.d2, dix.d2_next
    dirty_top = False
    top_closure = "carry"
    lw_old = np.empty(0, np.float32)
    for li, h in enumerate(levels):
        sl = h.slot_sf[cur]
        sfs = np.unique(sl[sl >= 0]).astype(np.int64)
        lw_old = h.l2_w.copy()
        undo["levels"].append({"hier": h, "sfs": sfs,
                               "sf_adj": h.sf_adj[sfs].copy(),
                               "l2_w": lw_old})
        if sfs.size:
            hierarchy.sf_adj_fill(h, w_src, sfs=sfs)
            idx = _to(sfs, dev)
            with trace.span("refresh.sf_fw", level=li + 1,
                            groups=int(sfs.size)):
                blocks, nx = ops.fw_batch_next(_to(h.sf_adj[sfs], dev),
                                               force=force)
                closures[li] = closures[li].index_copy(0, idx, blocks)
                nexts[li] = nexts[li].index_copy(0, idx, nx)
                r = hierarchy.l2row_from(blocks, h.bnd2_pos[sfs],
                                         h.bnd2_valid[sfs])
                rows_t[li] = rows_t[li].index_copy(0, idx, r)
                host_blocks = blocks.cpu().numpy()      # synchronises
            hierarchy.hier_weights(h, host_blocks, w_src, sfs=sfs)
        else:
            # only cross-group slots changed at this level: no FW, just
            # the O(cross) next-level weight copy
            hierarchy.hier_weights(
                h, np.empty((0, h.m2, h.m2), np.float32), w_src, sfs=sfs)
        l2_slots[li] = hierarchy.l2_slot_map(h)
        nxt_changed = np.nonzero(h.l2_w != lw_old)[0].astype(np.int64)
        if nxt_changed.size == 0:
            # the next overlay's weights are untouched: closures AND
            # witnesses above this level are still exact, carry them
            break
        cur = nxt_changed
        w_src = h.l2_w
    else:
        dirty_top = True
    if dirty_top:
        # decrease-only fast path: when every changed top slot weight
        # went DOWN, a bounded (min,+) relaxation seeded from the old
        # closure is exact; any increase, or a too-large touched set,
        # falls back to the full closure
        h = levels[-1]
        fast = None
        if cur.size and bool(np.all(h.l2_w[cur] <= lw_old[cur])):
            fast = hierarchy.l2_decrease_stage(h, d2, d2_next, cur)
        if fast is not None:
            d2, d2_next = fast
            top_closure = "decrease"
        else:
            d2, d2_next = hierarchy.l2_stage(h, dev, force=force)
            top_closure = "full_fw"
    return {
        "fields": {"sf_closure": tuple(closures),
                   "sf_next": tuple(nexts), "l2row": tuple(rows_t),
                   "d2": d2, "d2_next": d2_next},
        "ov_slot": hierarchy.ov_slot_map(plan),
        "l2_slot": l2_slots,
        "top_closure": top_closure,
    }


def refresh_piece_stage(plan: BuildPlan, g_new, dirty_gids: np.ndarray,
                        piece_flat: np.ndarray, piece_next: np.ndarray,
                        dist_to_agent: np.ndarray, device: torch.device, *,
                        force=None) -> None:
    """Recompute only the dirty pieces, writing their APSP + witness
    blocks into the host copies of the flat tables and re-deriving
    dist-to-agent for their members from the agent's APSP row (paths
    from a represented node to its agent never leave the piece, Props
    3-9).  Copied from src/repro/core/device_engine.py:1257, the batches
    unpadded (``_fw_bucket``)."""
    for cap in PIECE_BUCKETS:
        gids = [g for g in dirty_gids if plan.piece_cap[g] == cap]
        if not gids:
            continue
        blocks, nexts = _fw_bucket(_piece_adjs(g_new, plan, gids, cap),
                                   device, force=force)
        for gid, block, nxt in zip(gids, blocks, nexts):
            base = plan.piece_base[gid]
            piece_flat[base:base + cap * cap] = block.reshape(-1)
            piece_next[base:base + cap * cap] = nxt.reshape(-1)
            members = plan.piece_members[gid]
            inner = members != plan.piece_agent[gid]
            dist_to_agent[members[inner]] = block[
                plan.piece_agent_pos[gid], np.nonzero(inner)[0]]


def refresh_index(dix: DeviceIndex, plan: BuildPlan, g_new, u, v, w, *,
                  w_old=None, force=None
                  ) -> tuple[DeviceIndex, RefreshStats]:
    """Incremental index maintenance on ``dix``'s device (copied from
    src/repro/core/device_engine.py:1282).

    Locality is inherited from the paper's decomposition: a DRA touches
    the rest of G only at its agent (§IV, Props 3-9), so a DRA-internal
    edge dirties exactly one piece; fragments meet only at boundary
    nodes (§V-A), so an intra-fragment edge dirties one fragment's APSP
    plus its boundary-clique Upsilon weights; a cross-fragment edge is
    one E_B overlay slot (§V-A).  Given a batch of edge-weight updates
    (u, v, new_w) against the graph the plan currently reflects, this
    re-runs exactly the dirtied build stages:

      a. batched witness FW on the dirty fragments only,
      b. SUPER slot weights regathered from the new fragment APSP +
         direct E_B writes, then the overlay re-closed (dense: the
         witness FW; hierarchical: ``refresh_hier_stage``, then the
         resident rows re-lifted) — skipped entirely when no overlay
         weight changed,
      c. hub labels re-derived when the overlay moved or a labeled
         fragment is dirty, carried otherwise,
      d. dirty piece APSP blocks rewritten into host copies of
         piece_flat / piece_next, with member dist-to-agent re-derived
         from the agent row, and copied back to the device,
      e. a new DeviceIndex assembled from the results, every host
         sidecar set to the new epoch's (the reference's ``replace()``
         drops them; here the dataclass would copy the old ones).

    No tensor of ``dix`` is written, so it can go on serving while this
    runs.  ``g_new`` must be the post-update graph
    (``Graph.with_edge_weights``); the plan's weight caches are mutated
    to match, so consecutive refreshes compose, and an exception
    anywhere mid-refresh rolls the caches back (``frag_adj``, ``sup_w``,
    per level ``sf_adj`` and ``l2_w``).  ``w_old`` (the updated edges'
    previous weights) classifies the batch direction in the stats.
    Every stage recomputes from true weights, so the result is
    array-equal to ``build_device_index(reweight_index(ix, g_new))``.
    Each stage's seconds end in a device synchronise.
    """
    dev = dix.device
    timings: dict = {}
    t_all = time.perf_counter()

    with trace.timed("refresh.classify", timings, "classify",
                     n_updates=len(u)):
        upd = classify_updates(plan, u, v, w)

    frag_w_before = plan.frag_adj[upd.frag_fi, upd.frag_pu,
                                  upd.frag_pv].copy()
    sup_w_before = plan.sup_w.copy()
    hier_undo: dict = {}
    try:
        with trace.timed("refresh.frag_fw", timings, "frag_fw",
                         dirty=int(upd.dirty_frags.size)):
            frag_apsp, brow, frag_next, blocks = refresh_frag_stage(
                plan, dix.frag_apsp, dix.brow, dix.frag_next, upd,
                force=force)
            _sync(dev)

        # ---- SUPER: regather dirty slot weights, re-close overlay ---
        with trace.timed("refresh.super_fw", timings, "super_fw"):
            touched = np.isin(plan.sup_fi, upd.dirty_frags)
            touched_slots = np.concatenate(
                [np.nonzero(touched)[0], upd.eb_slots]).astype(np.int64)
            slot_w_old = sup_w_before[touched_slots]
            if upd.dirty_frags.size:
                super_weights(plan, blocks, frags=upd.dirty_frags)
            plan.sup_w[upd.eb_slots] = upd.eb_w
            slot_w_new = plan.sup_w[touched_slots]
            changed = slot_w_old != slot_w_new
            hier_fields: dict = {}
            d_super, super_next = dix.d_super, dix.super_next
            ov_slot, l2_slot = dix.host_ov_slot, dix.host_l2_slot
            res_frag, topgrp_frag = dix.host_res_frag, dix.host_topgrp_frag
            top_closure = "carry"
            if changed.any():
                if plan.hierarchy_levels >= 2:
                    hres = refresh_hier_stage(plan, dix,
                                              touched_slots[changed],
                                              hier_undo, force=force)
                    hier_fields = dict(hres["fields"])
                    ov_slot = hres["ov_slot"]
                    l2_slot = hres["l2_slot"]
                    top_closure = hres["top_closure"]
                    # re-lift the resident rows against the refreshed
                    # per-level tables (the build's own stage, so
                    # refresh == rebuild stays array-equal)
                    with trace.span("refresh.resident"):
                        rres = resident_stage(plan, {
                            name: hier_fields.get(name, getattr(dix, name))
                            for name in ("l2row", "bnd2_sid", "pos_in_sf",
                                         "d2")})
                    if rres is not None:
                        hier_fields.update(rres["fields"])
                        res_frag = rres["res_frag"]
                        topgrp_frag = rres["topgrp_frag"]
                else:
                    d_super, super_next = super_stage(plan, dev,
                                                      force=force)
                    ov_slot = overlay_slot_table(plan)
                    top_closure = "dense"
            # else: no overlay weight changed, so the closure and its
            # witnesses (and the per-level tables, the resident rows and
            # the slot provenance) are still exact and carry over
            _sync(dev)

        # ---- hub labels ----------------------------------------------
        # a label folds a brow leg with the overlay closure, so it is
        # stale iff the closure moved (changed.any()) OR a labeled
        # fragment's boundary rows did (dirty_frags); otherwise every
        # input is unchanged and carrying the rows is bit-identical to
        # recomputing them
        with trace.timed("refresh.hub", timings, "hub"):
            hub_fields: dict = {}
            hub_agent = dix.host_hub_agent
            if plan.hub_nodes is not None and len(plan.hub_nodes):
                hub_frags = np.unique(plan.frag_of[
                    plan.agent_of[plan.hub_nodes].astype(np.int64)])
                if changed.any() or np.intersect1d(
                        upd.dirty_frags, hub_frags).size:
                    hub = hub_stage(plan, hub_base_fields(
                        plan,
                        lambda name: d_super if name == "d_super"
                        else hier_fields.get(name, getattr(dix, name)),
                        brow))
                    if hub is not None:
                        hub_fields = hub["fields"]
                        hub_agent = hub["hub_agent"]
                        if topgrp_frag is None:
                            # hierarchical epoch without resident rows:
                            # the hub gate's TOP-group map
                            topgrp_frag = hub["topgrp_frag"]
            _sync(dev)

        # ---- pieces + dist-to-agent, through host copies -------------
        with trace.timed("refresh.pieces", timings, "pieces",
                         dirty=int(upd.dirty_gids.size)):
            if upd.dirty_gids.size:
                piece_flat = dix.piece_flat.cpu().numpy().copy()
                piece_next = dix.piece_next.cpu().numpy().copy()
                dist_to_agent = dix.dist_to_agent.cpu().numpy().copy()
                refresh_piece_stage(plan, g_new, upd.dirty_gids,
                                    piece_flat, piece_next,
                                    dist_to_agent, dev, force=force)
                piece_flat_t = _to(piece_flat, dev)
                piece_next_t = _to(piece_next, dev)
                dist_t = _to(dist_to_agent, dev)
            else:
                piece_flat_t = dix.piece_flat
                piece_next_t = dix.piece_next
                dist_t = dix.dist_to_agent
            _sync(dev)
    except BaseException:
        # roll the weight caches back: the caller never published a new
        # epoch, so the plan must keep describing the old one
        plan.frag_adj[upd.frag_fi, upd.frag_pu,
                      upd.frag_pv] = frag_w_before
        plan.frag_adj[upd.frag_fi, upd.frag_pv,
                      upd.frag_pu] = frag_w_before
        plan.sup_w[:] = sup_w_before
        for lv in hier_undo.get("levels", []):
            lv["hier"].sf_adj[lv["sfs"]] = lv["sf_adj"]
            lv["hier"].l2_w[:] = lv["l2_w"]
        raise

    # batch direction: against the edges' previous weights when the
    # caller provides them; the overlay delta alone cannot see
    # piece-internal changes
    if w_old is not None:
        delta = np.asarray(w, np.float64) - np.asarray(w_old, np.float64)
        total_increase = float(np.maximum(0.0, delta).sum())
    else:
        fin = np.isfinite(slot_w_old) & np.isfinite(slot_w_new)
        total_increase = float(np.maximum(
            0.0, slot_w_new[fin] - slot_w_old[fin]).sum())

    timings["total"] = time.perf_counter() - t_all
    trace.event("refresh.apply", t_all, t_all + timings["total"],
                n_updates=len(u), top_closure=top_closure,
                dirty_frags=int(upd.dirty_frags.size))
    new_dix = dataclasses.replace(
        dix, frag_apsp=frag_apsp, frag_next=frag_next, brow=brow,
        d_super=d_super, super_next=super_next,
        piece_flat=piece_flat_t, piece_next=piece_next_t,
        dist_to_agent=dist_t, **hier_fields, **hub_fields,
        host_ov_slot=ov_slot, host_l2_slot=l2_slot,
        host_res_frag=res_frag, host_topgrp_frag=topgrp_frag,
        host_hub_agent=hub_agent)
    stats = RefreshStats(
        n_updates=int(np.asarray(u).size),
        n_dirty_frags=int(upd.dirty_frags.size), n_frags=plan.k,
        n_dirty_pieces=int(upd.dirty_gids.size),
        n_pieces=plan.n_pieces,
        n_eb_slots=int(upd.eb_slots.size), n_inert=upd.n_inert,
        total_increase=total_increase,
        decrease_only=total_increase == 0.0, timings=timings,
        top_closure=top_closure)
    return new_dix, stats


# ---------------------------------------------------------------------------
# online serving
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# witness conventions (copied from src/repro/core/device_engine.py:1505):
# the *_w programs return (dist, wit) with wit int32 per query:
#   same-DRA bucket:  WIT_PIECE (same-piece table won) or WIT_VIA_AGENT
#   cross buckets:    x * (S+1) + y, the winning SUPER boundary pair,
#                     or WIT_LOCAL (intra-fragment path won)
#   any bucket:       WIT_NONE when the distance is +inf
# paths.PathUnwinder turns (s, t, wit) into a node sequence by walking
# frag_next / piece_next / super_next (per-level tables when
# hierarchical).  The packed pair fits int32 up to S+1 = 46,340.
# ---------------------------------------------------------------------------
WIT_NONE = -1       # unreachable; nothing to unwind
WIT_LOCAL = -2      # case 2, intra-fragment path beat the SUPER combine
WIT_VIA_AGENT = 0   # case 1, s -> agent -> t
WIT_PIECE = 1       # case 1, same-piece direct path


def _same_dra_w(dix: DeviceIndex, s, t, ds, dt):
    """Case 1: same agent -> (dist, piece_won).  Same piece -> one flat
    gather; else via agent.  The piece index is masked before the gather
    (it is only meaningful where both ends lie in one piece)."""
    gid_s = dix.piece_gid[s]
    same_piece = (gid_s >= 0) & (gid_s == dix.piece_gid[t])
    d_via_agent = ds + dt
    idx = (dix.piece_base[s].long()
           + dix.pos_in_piece[s].long() * dix.piece_stride[s].long()
           + dix.pos_in_piece[t].long())
    d_piece = dix.piece_flat[torch.where(same_piece, idx, 0)]
    out = torch.where(same_piece, torch.minimum(d_piece, d_via_agent),
                      d_via_agent)
    return out, same_piece & (d_piece <= d_via_agent)


def _same_dra_dist(dix: DeviceIndex, s, t, ds, dt):
    """Case 1 distances (``_same_dra_w`` without the witness)."""
    return _same_dra_w(dix, s, t, ds, dt)[0]


def _first_min(x: torch.Tensor, dim: int):
    """(min along ``dim``, the smallest index at the min): the
    reference's min-of-where argmin, whose tie rule the witnesses
    follow."""
    m = x.amin(dim=dim)
    shape = [1] * x.dim()
    shape[dim] = -1
    iota = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    return m, torch.where(x == m.unsqueeze(dim), iota,
                          x.shape[dim]).amin(dim=dim)


def _carry_min(best, besti, block, offset: int):
    """Fold one chunk into a running (min, argmin) over dim 1 of
    ``block``, whose index 0 is ``offset`` overall: the smallest index
    wins inside the chunk and the carried best is replaced only on a
    strict <, so the smallest index overall wins whatever the chunk
    width."""
    cand, loc = _first_min(block, 1)
    better = cand < best
    return (torch.where(better, cand, best),
            torch.where(better, offset + loc, besti))


def _layout(device: torch.device, force, layout) -> str:
    """The combine layout: "scatter" (the reference's name for its fused
    twoside kernel path; the distance programs run
    ``ops.minplus_twoside_grouped`` on the compact rows there, the
    witness programs the argmin kernel on scattered rows) or "gather"
    (chunked gathers of the closure).  None picks "scatter" where
    ``ops`` would run the kernel and "gather" elsewhere, as the
    reference picks by its ``force``."""
    if layout is None:
        return "scatter" if ops.use_kernel(device, force) else "gather"
    if layout not in ("scatter", "gather"):
        raise ValueError(f"layout must be None, 'scatter' or 'gather': "
                         f"{layout!r}")
    return layout


#: bytes one chunk's gathered block [q, c, width] may take on the card
_CHUNK_BYTES = 64 << 20


def _chunk(row: torch.Tensor, width: int) -> int:
    """Columns of ``row`` [q, mb] per step of the chunked gather loops.
    The CPU keeps the reference's 8, which bounds its intermediates; on
    the card (and on ``meta``, which stands for it in the dry runs) each
    step costs a handful of launches whatever its size, so a step takes
    as many columns (a multiple of 8) as keep the gathered [q, c, width]
    block under _CHUNK_BYTES.  The chunking only regroups a min, so
    every width gives the same bits."""
    q, mb = row.shape
    if row.device.type not in ("cuda", "meta"):
        return min(8, mb)
    c = _CHUNK_BYTES // max(1, 4 * q * width) // 8 * 8
    return max(min(8, mb), min(mb, c))


def _overlay_size(dix: DeviceIndex) -> int:
    """S + 1: the sentinel super id + 1.  Hierarchical indices carry it
    as the bottom sf_of's length (their d_super is a [1, 1] dummy);
    dense indices as d_super's side."""
    return (dix.sf_of[0].shape[0] if len(dix.sf_of)
            else dix.d_super.shape[0])


def _hier_leg(dix: DeviceIndex, li: int, row_s, unit_s, row_t, unit_t,
              tab, top, *, force=None):
    """Same-group leg at grouping level ``li``: min over slot pairs
    (i, j) in the SAME level-li group of
    row_s[i] + sf_closure[li][g, pos_i, pos_j] + row_t[j], the slots of
    each side those of its table row tab[unit]
    (``ops.gather_minplus_twoside``: on the card one kernel, which
    answers +inf without reading the closure where the sides' groups
    differ; elsewhere the gather chunked over the s-axis (``_chunk``), so
    the gathered block stays [q, c, width]).  Traced as ``serve.leg``
    (``level`` li + 1) with its card time; while the tracer records, and
    in every captured bucket graph, it also carries ``passed``, the
    queries whose sides share the level's group (``top``: both sides'
    next-level units, s first), a 0-d tensor read with the tracer's
    events (a graph's, after each replay)."""
    tags = {}
    if trace.recording():
        q = row_s.shape[0]
        tags["passed"] = (top[:q] == top[q:]).sum()
    with trace.span("serve.leg", device=row_s.device, level=li + 1, **tags):
        return ops.gather_minplus_twoside(
            row_s, unit_s, row_t, unit_t, tab, dix.sf_of[li],
            dix.pos_in_sf[li], dix.sf_closure[li],
            chunk=_chunk(row_s, row_t.shape[1]), force=force)


def _lift_compact(dix: DeviceIndex, li: int, row, unit, tab, *,
                  force=None):
    """Lift compact boundary rows one level: out[r, j] = min_b
    row[r, b] + l2row[li][grp_b, pos_b, j], the slots of row r those of
    its table row tab[unit[r]].  All valid slots of one row share one
    group per level (groups nest), so the output stays COMPACT: its
    next-level ids are that group's bnd2_sid row, read by the caller.
    ``ops.gather_minplus``: one kernel on the card; elsewhere chunked
    (``_chunk``) so the gathered block stays [q, c, mb'].  Traced as
    ``serve.lift`` (``level`` li + 1, ``kind`` "compact") with its card
    time."""
    l2 = dix.l2row[li]
    with trace.span("serve.lift", device=row.device, level=li + 1,
                    kind="compact"):
        return ops.gather_minplus(row, unit, tab, dix.pos_in_sf[li], l2,
                                  gof=dix.sf_of[li],
                                  chunk=_chunk(row, l2.shape[2]),
                                  force=force)


def _scatter_top(dix: DeviceIndex, row, ids):
    """Scatter a compact top-level row into dense d2 coordinates."""
    return _scatter_rows(row, ids, dix.d2.shape[0])


def _top_mid_gather(dix: DeviceIndex, row_s, ids_s, row_t, ids_t):
    """Contract compact top rows against d2 without scattering:

      mid = min_{x,y} row_s[x] + d2[ids_s[x], ids_t[y]] + row_t[y]

    The scattered row is +inf outside its own top-group boundary
    columns, so gathering d2 at just [ids_s x ids_t] equals scatter +
    full minplus_twoside.  Sentinel slots carry id S_top, which indexes
    d2's +inf row/col.  Chunked with the largest of 24/16/8 that
    divides the (pad_to-8) width, as the reference."""
    q, mb = row_s.shape
    c = next(cc for cc in (24, 16, 8, mb) if mb % cc == 0)
    acc = torch.full((q, row_t.shape[1]), _INF, dtype=row_s.dtype,
                     device=row_s.device)
    for i in range(0, mb, c):
        blk = dix.d2[ids_s[:, i:i + c, None], ids_t[:, None, :]]
        acc = torch.minimum(acc,
                            (row_s[:, i:i + c, None] + blk).amin(dim=1))
    return (acc + row_t).amin(dim=1)


def _combine_mid_h(dix: DeviceIndex, row_s, fs, row_t, ft, *,
                   force=None, layout=None):
    """Hierarchical combine of the boundary rows of fragments fs and ft:

      mid = min_{x,y} row_s[x] + OD(x, y) + row_t[y]

    where OD decomposes per level: either both sides sit in the same
    level-l group (its closure answers exactly: the va legs), or the
    route crosses every level's boundary and the TOP closure answers
    against both rows lifted level by level (the vb leg).  Both sides
    travel as one [2q, width] row block (s first), so each lift is one
    call; a side's slots at each level are those of one table row, its
    unit's (level 1: ``bnd_super[f]``; above: the previous level's group
    boundary ``bnd2_sid``).  The scatter layout contracts both compact
    top rows through their TOP group's ``bnd2_sid`` row
    (``ops.minplus_twoside_grouped``: the grouped kernel on the card,
    scatter + dense contraction as its plain version); the gather layout
    gathers only each side's own top-group columns of d2
    (``_top_mid_gather``).  Both give the same bits."""
    layout = _layout(row_s.device, force, layout)
    q = row_s.shape[0]
    rows = torch.cat([row_s, row_t])
    units = torch.cat([fs, ft])
    tab = dix.bnd_super
    va = None
    for li in range(len(dix.sf_of)):
        # slot 0 is valid-first by construction, so its group IS the
        # side's group and the lifted row's unit (sentinel-only rows land
        # on the sentinel group, whose bnd2_sid row is all-sentinel and
        # whose rows are +inf)
        top = dix.sf_of[li][tab[:, 0].long()].long()[units]
        leg = _hier_leg(dix, li, rows[:q], units[:q], rows[q:], units[q:],
                        tab, top, force=force)
        va = leg if va is None else torch.minimum(va, leg)
        rows = _lift_compact(dix, li, rows, units, tab, force=force)
        units, tab = top, dix.bnd2_sid[li]
    if layout == "scatter":
        # kernel 2 stays a Python call at every replay of a bucket graph
        # (graphs.host_call), so each call is seen with its operands
        vb = graphs.host_call(ops, "minplus_twoside_grouped")(
            rows[:q], units[:q], tab, dix.d2, rows[q:], units[q:], tab,
            force=force)
    else:
        vb = _top_mid_gather(dix, rows[:q], tab[units[:q]].long(), rows[q:],
                             tab[units[q:]].long())
    return torch.minimum(va, vb)


def _combine_mid(dix: DeviceIndex, row_s, fs, row_t, ft, *, force=None,
                 layout=None):
    """combine = min_{b1,b2} row_s[b1] + D_super[bs[b1], bt[b2]]
    + row_t[b2] without a [q, mb, mb] intermediate, for the boundary
    rows of fragments fs and ft (bs, bt = their ``bnd_super`` rows).

    Hierarchical indices (non-empty ``sf_of``) route to
    ``_combine_mid_h``.  ``layout`` picks one of the reference's two
    layouts (``_layout``): "scatter" contracts the compact boundary rows
    against D_super through their super ids, each query its own table
    row (``ops.minplus_twoside_grouped``: the grouped CUDA kernel on the
    card; on the CPU its plain version, which scatter-mins the rows into
    SUPER coordinates and runs the dense contraction); "gather" chunks
    the b1 axis (``_chunk``) so the gathered block stays [q, c, mb].
    """
    if len(dix.sf_of):
        return _combine_mid_h(dix, row_s, fs, row_t, ft, force=force,
                              layout=layout)
    bs, bt = dix.bnd_super[fs], dix.bnd_super[ft]
    if _layout(row_s.device, force, layout) == "scatter":
        qi = torch.arange(row_s.shape[0], device=row_s.device)
        return graphs.host_call(ops, "minplus_twoside_grouped")(
            row_s, qi, bs, dix.d_super, row_t, qi, bt, force=force)
    q, mb = row_s.shape
    c = _chunk(row_s, mb)
    bs, bt = bs.long(), bt.long()
    acc = torch.full((q, mb), _INF, dtype=row_s.dtype,
                     device=row_s.device)
    for i in range(0, mb, c):
        blk = dix.d_super[bs[:, i:i + c, None], bt[:, None, :]]  # [q,c,mb]
        cand = (row_s[:, i:i + c, None] + blk).amin(dim=1)
        acc = torch.minimum(acc, cand)
    return (acc + row_t).amin(dim=1)


def serve_same_dra(dix: DeviceIndex, s: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Planner bucket 1: both endpoints in the same DRA."""
    s, t = s.long(), t.long()
    ds, dt = dix.dist_to_agent[s], dix.dist_to_agent[t]
    out = _same_dra_dist(dix, s, t, ds, dt)
    return torch.where(s == t, 0.0, out)


def _ends(dix: DeviceIndex, s, t):
    """Endpoint lookups of the cross programs: (ds, dt, fs, ft, ps, pt,
    valid).  A fragment id of -1 (an agent outside every fragment) is
    clamped to 0 before any gather, and ``valid`` marks where neither
    was -1: the callers mask those answers to +inf after, where the
    reference lets JAX wrap the -1 and masks only after."""
    us, ut = dix.agent_of[s].long(), dix.agent_of[t].long()
    fs, ft = dix.frag_of[us].long(), dix.frag_of[ut].long()
    return (dix.dist_to_agent[s], dix.dist_to_agent[t], fs.clamp(min=0),
            ft.clamp(min=0), dix.pos_in_frag[us].long(),
            dix.pos_in_frag[ut].long(), (fs >= 0) & (ft >= 0))


def serve_cross(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
                with_local: bool, force=None, layout=None) -> torch.Tensor:
    """Planner buckets 2/3: endpoints in different DRAs.  with_local
    folds in the intra-fragment distance (same-fragment bucket only)."""
    s, t = s.long(), t.long()
    ds, dt, fs, ft, ps, pt, valid = _ends(dix, s, t)
    row_s = dix.brow[fs, ps]                     # [q, mb]
    row_t = dix.brow[ft, pt]
    mid = _combine_mid(dix, row_s, fs, row_t, ft, force=force,
                       layout=layout)
    if with_local:
        mid = torch.minimum(mid, torch.where(
            fs == ft, dix.frag_apsp[fs, ps, pt], _INF))
    d = ds + mid + dt
    return torch.where(valid, d, _INF)


def serve_step(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
               force=None, layout=None) -> torch.Tensor:
    """Batched exact distance queries: s, t integer [q] -> f32 [q].

    The monolithic program (every case for every query); the query
    planner in dist_engine.py runs the per-case programs instead.
    """
    s, t = s.long(), t.long()
    us, ut = dix.agent_of[s], dix.agent_of[t]
    d_cross = serve_cross(dix, s, t, with_local=True, force=force,
                          layout=layout)
    d_same = serve_same_dra(dix, s, t)
    out = torch.where(us == ut, d_same, d_cross)
    return torch.where(s == t, 0.0, out)


# ---------------------------------------------------------------------------
# witness (path) serve mode: the *_w programs (encoding above WIT_NONE).
# Every chunked loop carries a running argmin (``_carry_min``) whose tie
# rule does not depend on the chunk width.
# ---------------------------------------------------------------------------
def _hier_leg_w(dix: DeviceIndex, li: int, row_s, ids_s, grp_s, pos_s,
                row_t, ids_t, grp_t, pos_t):
    """_hier_leg carrying its argmin -> (va, xa, ya), the winning pair
    as level-li overlay ids (traced as ``serve.leg``, as _hier_leg)."""
    q, mbs = row_s.shape
    mbt = row_t.shape[1]
    c = _chunk(row_s, mbt)
    clo = dix.sf_closure[li]
    dev = row_s.device
    with trace.span("serve.leg", device=dev, level=li + 1):
        acc = torch.full((q, mbt), _INF, dtype=row_s.dtype, device=dev)
        accb = torch.full((q, mbt), -1, dtype=torch.long, device=dev)
        for i in range(0, mbs, c):
            g_c, p_c = grp_s[:, i:i + c, None], pos_s[:, i:i + c, None]
            blk = clo[g_c, p_c, pos_t[:, None, :]]          # [q, c, mbt]
            same = g_c == grp_t[:, None, :]
            acc, accb = _carry_min(acc, accb, torch.where(
                same, row_s[:, i:i + c, None] + blk, _INF), i)
        va, pos_tw = _first_min(acc + row_t, 1)
        pos_sw = accb.gather(1, pos_tw[:, None]).clamp(0, mbs - 1)
        return (va, ids_s.gather(1, pos_sw)[:, 0],
                ids_t.gather(1, pos_tw[:, None])[:, 0])


def _lift_src_of(dix: DeviceIndex, li: int, row, ids, grp, pos, wc):
    """Witness recovery for one lift: the level-li id whose lifted
    contribution achieved the next-level row at target id ``wc``
    (``_lift_compact``'s chunked schedule carrying a running argmin; an
    exact float32 re-comparison).  Traced as ``serve.lift`` (``kind``
    "src_of")."""
    q, mb = row.shape
    l2 = dix.l2row[li]
    c = _chunk(row, l2.shape[2])
    with trace.span("serve.lift", device=row.device, level=li + 1,
                    kind="src_of"):
        best = torch.full((q,), _INF, dtype=row.dtype, device=row.device)
        besti = torch.zeros((q,), dtype=torch.long, device=row.device)
        for i in range(0, mb, c):
            g_c = grp[:, i:i + c]
            l2_c = l2[g_c, pos[:, i:i + c]]                  # [q, c, mb']
            hit = dix.bnd2_sid[li][g_c] == wc[:, None, None]
            best, besti = _carry_min(best, besti, torch.where(
                hit, row[:, i:i + c, None] + l2_c, _INF).amin(dim=2), i)
        return ids.gather(1, besti[:, None])[:, 0]


def _combine_mid_h_w(dix: DeviceIndex, row_s, bs, row_t, bt, *,
                     force=None):
    """Witness variant of _combine_mid_h -> (mid, wx, wy): the winning
    level-1 SUPER pair under the hierarchical overlay metric.  Each
    same-group leg carries its argmin; the top leg takes the winning
    boundary pair from ``ops.minplus_twoside_argmin`` on the scattered
    top rows (the kernel on the card, in every layout) and resolves it
    back down the ladder: at each level the winning id comes from that
    level's same-group leg if it won, else it is un-lifted one level by
    re-finding the row entry whose lift achieved it."""
    L = len(dix.sf_of)
    q = row_s.shape[0]
    ids_s, ids_t = bs.long(), bt.long()
    # the lifts' table rows: each query's own boundary ids at level 1,
    # its side's previous-level group boundary above
    unit_s = unit_t = torch.arange(q, device=row_s.device)
    tab_s, tab_t = bs, bt
    states, vas, legx, legy = [], [], [], []
    for li in range(L):
        grp_s = dix.sf_of[li][ids_s].long()
        pos_s = dix.pos_in_sf[li][ids_s].long()
        grp_t = dix.sf_of[li][ids_t].long()
        pos_t = dix.pos_in_sf[li][ids_t].long()
        states.append((row_s, ids_s, grp_s, pos_s, row_t, ids_t, grp_t,
                       pos_t))
        va, xa, ya = _hier_leg_w(dix, li, row_s, ids_s, grp_s, pos_s,
                                 row_t, ids_t, grp_t, pos_t)
        vas.append(va)
        legx.append(xa)
        legy.append(ya)
        row_s = _lift_compact(dix, li, row_s, unit_s, tab_s, force=force)
        row_t = _lift_compact(dix, li, row_t, unit_t, tab_t, force=force)
        unit_s, unit_t = grp_s[:, 0].contiguous(), grp_t[:, 0].contiguous()
        tab_s = tab_t = dix.bnd2_sid[li]
        ids_s = dix.bnd2_sid[li][unit_s].long()
        ids_t = dix.bnd2_sid[li][unit_t].long()
    mid, wc, wd = ops.minplus_twoside_argmin(
        _scatter_top(dix, row_s, ids_s), dix.d2,
        _scatter_top(dix, row_t, ids_t), force=force)
    for va in vas:
        mid = torch.minimum(mid, va)
    # winner selection, lowest level first (a same-group leg beats the
    # lifted leg on a tie)
    taken = torch.zeros((q,), dtype=torch.bool, device=row_s.device)
    wins = []
    for va in vas:
        w = (va == mid) & ~taken
        taken = taken | w
        wins.append(w)
    cur_x, cur_y = wc.long(), wd.long()
    for li in range(L - 1, -1, -1):
        r_s, i_s, g_s, p_s, r_t, i_t, g_t, p_t = states[li]
        dx = _lift_src_of(dix, li, r_s, i_s, g_s, p_s, cur_x)
        dy = _lift_src_of(dix, li, r_t, i_t, g_t, p_t, cur_y)
        cur_x = torch.where(wins[li], legx[li], dx)
        cur_y = torch.where(wins[li], legy[li], dy)
    fin = torch.isfinite(mid)
    return mid, torch.where(fin, cur_x, -1), torch.where(fin, cur_y, -1)


def _combine_mid_w(dix: DeviceIndex, row_s, bs, row_t, bt, *, force=None,
                   layout=None):
    """Witness variant of _combine_mid -> (mid, wx, wy): (wx, wy) is the
    winning SUPER boundary pair in super ids (-1 where mid is +inf).
    The same two layouts as the distance path: "scatter" runs
    ``ops.minplus_twoside_argmin`` on the scattered rows (the smallest
    y, then x, in super ids), "gather" the chunked gather carrying its
    argmin (the smallest t-slot, then s-slot); hierarchical indices
    route to _combine_mid_h_w."""
    if len(dix.sf_of):
        return _combine_mid_h_w(dix, row_s, bs, row_t, bt, force=force)
    bs, bt = bs.long(), bt.long()
    if _layout(row_s.device, force, layout) == "scatter":
        s1 = dix.d_super.shape[0]
        mid, wx, wy = ops.minplus_twoside_argmin(
            _scatter_rows(row_s, bs, s1), dix.d_super,
            _scatter_rows(row_t, bt, s1), force=force)
        return mid, wx.long(), wy.long()
    q, mb = row_s.shape
    c = _chunk(row_s, mb)
    acc = torch.full((q, mb), _INF, dtype=row_s.dtype, device=row_s.device)
    accb = torch.full((q, mb), -1, dtype=torch.long, device=row_s.device)
    for i in range(0, mb, c):
        blk = dix.d_super[bs[:, i:i + c, None], bt[:, None, :]]  # [q,c,mb]
        acc, accb = _carry_min(acc, accb, row_s[:, i:i + c, None] + blk, i)
    mid, pos_t = _first_min(acc + row_t, 1)
    pos_s = accb.gather(1, pos_t[:, None]).clamp(0, mb - 1)
    fin = torch.isfinite(mid)
    wx = torch.where(fin, bs.gather(1, pos_s)[:, 0], -1)
    wy = torch.where(fin, bt.gather(1, pos_t[:, None])[:, 0], -1)
    return mid, wx, wy


def serve_same_dra_w(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """serve_same_dra in witness mode -> (dist, wit) with wit in
    {WIT_PIECE, WIT_VIA_AGENT, WIT_NONE}."""
    s, t = s.long(), t.long()
    out, piece_won = _same_dra_w(dix, s, t, dix.dist_to_agent[s],
                                 dix.dist_to_agent[t])
    out = torch.where(s == t, 0.0, out)
    wit = torch.where(piece_won, WIT_PIECE, WIT_VIA_AGENT)
    wit = torch.where(torch.isfinite(out), wit, WIT_NONE)
    return out, wit.to(torch.int32)


def serve_cross_w(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
                  with_local: bool, force=None, layout=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """serve_cross in witness mode -> (dist, wit): wit is the packed
    winning SUPER pair x * (S+1) + y, WIT_LOCAL when the intra-fragment
    path won (same-fragment bucket only), WIT_NONE when unreachable.
    Fragment ids of -1 are clamped before the gathers (``_ends``)."""
    s, t = s.long(), t.long()
    ds, dt, fs, ft, ps, pt, valid = _ends(dix, s, t)
    row_s = dix.brow[fs, ps]                     # [q, mb]
    row_t = dix.brow[ft, pt]
    mid, wx, wy = _combine_mid_w(dix, row_s, dix.bnd_super[fs], row_t,
                                 dix.bnd_super[ft], force=force,
                                 layout=layout)
    wit = wx * _overlay_size(dix) + wy
    if with_local:
        local = torch.where(fs == ft, dix.frag_apsp[fs, ps, pt], _INF)
        wit = torch.where(local <= mid, WIT_LOCAL, wit)
        mid = torch.minimum(mid, local)
    d = torch.where(valid, ds + mid + dt, _INF)
    wit = torch.where(torch.isfinite(d), wit, WIT_NONE)
    return d, wit.to(torch.int32)


def serve_step_w(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
                 force=None, layout=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """serve_step in witness mode -> (dist, wit).  The witness namespace
    is per case (same-DRA flags or packed SUPER pairs); the unwinder
    re-derives the case from agent_of."""
    s, t = s.long(), t.long()
    d_cross, w_cross = serve_cross_w(dix, s, t, with_local=True,
                                     force=force, layout=layout)
    d_same, w_same = serve_same_dra_w(dix, s, t)
    same = dix.agent_of[s] == dix.agent_of[t]
    out = torch.where(same, d_same, d_cross)
    return (torch.where(s == t, 0.0, out),
            torch.where(same, w_same, w_cross))


def serve_hub(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
              force=None) -> torch.Tensor:
    """The hub-label tier: one ``ops.label_merge_rows`` over the label
    table through each endpoint's row id (the two label rows are read
    where they lie, never gathered into [q, W] copies).  The answer is
    exact only on pairs whose agents are both labeled and in different
    TOP groups (dense: different fragments), so callers gate with the
    planner's ``hub_mask`` first, as ``serving/runtime.py`` does.  Off
    the gate, a pair with an unlabeled agent reads the all-INF sentinel
    row and gets +inf; a labeled pair the gate rejects (same TOP group,
    same fragment) gets a finite answer, the length of a real path
    through the top boundary: never below the true distance, but
    possibly above it.  The row ids are looked up by agent, never by
    fragment id; a fragment id of -1 only masks the answer to +inf."""
    s, t = s.long(), t.long()
    us, ut = dix.agent_of[s].long(), dix.agent_of[t].long()
    valid = (dix.frag_of[us] >= 0) & (dix.frag_of[ut] >= 0)
    mid = ops.label_merge_rows(dix.hub_rows, dix.hub_of_agent[us],
                               dix.hub_of_agent[ut], force=force)
    d = dix.dist_to_agent[s] + mid + dix.dist_to_agent[t]
    return torch.where(valid, d, _INF)


def _lift_res(dix: DeviceIndex, row, frag, grp, *, force=None):
    """Resident lift of the boundary rows of fragments ``frag``,
    restricted to the d2 column ids of their TOP groups ``grp`` (the
    lifted row is +inf outside an endpoint's own top-group boundary
    columns): rs[q, c] = min_b row[q, b] + res_rows[res_of_frag[f],
    pos_b, bnd2_sid[-1][g, c]], the whole per-level lift ladder collapsed
    into one product against the pre-composed rows
    (``ops.gather_minplus``: one kernel on the card; elsewhere chunked
    gathers, ``_chunk``).  Traced as ``serve.lift`` (``level`` 1,
    ``kind`` "res")."""
    top = dix.bnd2_sid[-1]
    with trace.span("serve.lift", device=row.device, level=1, kind="res"):
        return ops.gather_minplus(row, frag, dix.bnd_super, dix.pos_in_sf[0],
                                  dix.res_rows, ugrp=dix.res_of_frag,
                                  cunit=grp, ctab=top,
                                  chunk=_chunk(row, top.shape[1]),
                                  force=force)


def serve_cross_res(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
                    force=None, layout=None) -> torch.Tensor:
    """Planner bucket 4: the resident fast path for hot cross-top-group
    queries.  Both endpoints' fragments must be in RESIDENT level-1
    groups and in DIFFERENT top-level groups (the planner guarantees
    both): then the route must touch the top boundary, every confined
    prefix is pre-composed in res_rows, and the whole combine is one
    contraction against d2 of rows lifted only to each endpoint's own
    top-group boundary columns (the lifted row is +inf elsewhere):
    ``ops.minplus_twoside_grouped`` through the TOP groups' ``bnd2_sid``
    rows in the scatter layout, ``_top_mid_gather`` in the gather
    layout.  A fragment id of -1 is clamped before the gathers and its
    answer masked to +inf, as in ``serve_cross``."""
    s, t = s.long(), t.long()
    ds, dt, fs_c, ft_c, ps, pt, valid = _ends(dix, s, t)
    row_s = dix.brow[fs_c, ps]                   # [q, mb]
    row_t = dix.brow[ft_c, pt]
    top = dix.bnd2_sid[-1]
    grp_s = dix.topgrp_of_frag[fs_c].long()
    grp_t = dix.topgrp_of_frag[ft_c].long()
    rs = _lift_res(dix, row_s, fs_c, grp_s, force=force)
    rt = _lift_res(dix, row_t, ft_c, grp_t, force=force)
    if _layout(row_s.device, force, layout) == "scatter":
        mid = graphs.host_call(ops, "minplus_twoside_grouped")(
            rs, grp_s, top, dix.d2, rt, grp_t, top, force=force)
    else:
        mid = _top_mid_gather(dix, rs, top[grp_s].long(), rt,
                              top[grp_t].long())
    d = ds + mid + dt
    return torch.where(valid, d, _INF)


def _overlay_row_h(dix: DeviceIndex, rs: torch.Tensor, *,
                   force=None) -> torch.Tensor:
    """Exact overlay distances from a scattered source row rs [S+1] to
    EVERY overlay node, through the hierarchy: ascend the ladder
    (within-group (min,+) against the group closures + boundary lift per
    level), one vector (x) matrix product against the top closure
    (``ops.minplus``, the kernel on the card), then descend (lift back
    through each level's rows, min-merged with that level's
    within-group leg)."""
    L = len(dix.sf_of)
    r = rs
    withins = []
    for li in range(L):
        members = dix.sf_members[li].long()      # [ng+1, m2] (S_l pad)
        rm = r[members]                          # [ng+1, m2]
        withins.append((rm[:, :, None] + dix.sf_closure[li]).amin(dim=1))
        lift = (rm[:, :, None] + dix.l2row[li]).amin(dim=1)
        np1 = (dix.sf_of[li + 1].shape[0] if li + 1 < L
               else dix.d2.shape[0])
        r = torch.full((np1,), _INF, dtype=rs.dtype, device=rs.device)
        r.scatter_reduce_(0, dix.bnd2_sid[li].long().reshape(-1),
                          lift.reshape(-1), "amin")
    z = ops.minplus(r[None, :], dix.d2, force=force)[0]   # [S_top+1]
    for li in range(L - 1, -1, -1):
        back = z[dix.bnd2_sid[li].long()]        # [ng+1, mb2]
        via = (dix.l2row[li] + back[:, None, :]).amin(dim=2)
        out = torch.minimum(withins[li], via)    # [ng+1, m2]
        z = torch.full((dix.sf_of[li].shape[0],), _INF, dtype=rs.dtype,
                       device=rs.device)
        z.scatter_reduce_(0, dix.sf_members[li].long().reshape(-1),
                          out.reshape(-1), "amin")
    return z


def serve_one_to_all(dix: DeviceIndex, s, *, force=None) -> torch.Tensor:
    """Exact distances from one source to EVERY node: [n].

    Scatter the source boundary row into overlay coordinates, one
    vector (x) matrix (min,+) product against the overlay closure (the
    ``minplus`` kernel on the card; per level on hierarchical indices),
    then a per-node gather combine.  A fragment id of -1 (source or
    target) is clamped before the gathers and its cross-DRA answers
    masked to +inf, where the reference wraps the -1 and masks after.
    """
    dev = dix.device
    s = torch.as_tensor(s, dtype=torch.long, device=dev).reshape(())
    n = dix.agent_of.shape[0]
    us = dix.agent_of[s].long()
    ds = dix.dist_to_agent[s]
    fs = dix.frag_of[us].long()
    fs_c = fs.clamp(min=0)
    ps = dix.pos_in_frag[us].long()
    row_s = dix.brow[fs_c, ps]                           # [mb]
    bs = dix.bnd_super[fs_c].long()                      # [mb]
    rs = torch.full((_overlay_size(dix),), _INF, dtype=row_s.dtype,
                    device=dev).scatter_reduce_(0, bs, row_s, "amin")
    if len(dix.sf_of):
        x = _overlay_row_h(dix, rs, force=force)         # [S+1]
    else:
        x = ops.minplus(rs[None, :], dix.d_super, force=force)[0]
    # per-target combine (sentinel slots hit x's +inf entry)
    tt = torch.arange(n, dtype=torch.long, device=dev)
    ut = dix.agent_of.long()
    dt = dix.dist_to_agent
    ft = dix.frag_of[ut].long()
    ft_c = ft.clamp(min=0)
    ptv = dix.pos_in_frag[ut].long()
    row_t = dix.brow[ft_c, ptv]                          # [n, mb]
    mid = (x[dix.bnd_super[ft_c].long()] + row_t).amin(dim=1)   # [n]
    local = torch.where(ft == fs, dix.frag_apsp[ft_c, ps, ptv], _INF)
    d_cross = ds + torch.minimum(mid, local) + dt
    d_cross = torch.where((fs >= 0) & (ft >= 0), d_cross, _INF)
    d_same = _same_dra_dist(dix, s.expand(n), tt, ds.expand(n), dt)
    out = torch.where(us == ut, d_same, d_cross)
    return torch.where(tt == s, 0.0, out)
