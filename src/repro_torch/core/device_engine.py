"""Device DISLAND engine on PyTorch: the dense-overlay main path.

Port of the dense subset of ``repro/core/device_engine.py``
(``hierarchy_levels=1``, no hub labels, no resident rows): every query
becomes gathers plus (min,+) algebra over padded tensors.

Offline (``build_device_index_with_plan``, device-resident products):
  * per-fragment dense APSP        [k, maxf, maxf]   (witness FW kernel)
  * boundary-row table             [k, maxf, mb]     (node -> boundary)
  * SUPER boundary x boundary APSP [S+1, S+1]        (dense witness FW)
  * per-piece APSP, flattened      [sum_b P_b*mp_b^2] (+ per-node
    base/stride so one gather answers any same-piece query)
  * per-node lookup vectors        agent/fragment/piece ids + positions

Online (``serve_step``, or the planner's per-case programs):
  dist(s,t) = same-DRA answer                                (case 1)
            | d(s,u_s) + min(local, combine) + d(u_t,t)      (case 2)
  combine = min_{b1,b2} row_s[b1] + D_super[b1,b2] + row_t[b2],
computed without a [q, mb, mb] block: on the card the boundary rows are
scattered into SUPER coordinates and contracted by the fused
``minplus_twoside`` CUDA kernel; on the CPU an x-chunked gather keeps
the peak intermediate at [q, 8, mb].

Everything is exact: integer weights make every float32 (min,+) sum
exactly representable, so every table and answer is bit-for-bit the
reference package's.  Tensors keep the reference's dtypes (int32 ids,
float32 distances, bool masks); gathers widen indices to int64 where
they use them.

Differences from the reference that its semantics force on PyTorch:
JAX clamps out-of-range gathers and wraps -1, while ``torch`` gathers
need in-range indices, so every index that JAX masks only *after* a
gather is masked *before* it here (``serve_cross`` with a fragment id
of -1, the piece index in ``_same_dra_dist``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..kernels import ops
from ..obs import trace
from . import padding
from .supergraph import DislandIndex

INF = np.float32(np.inf)
_INF = float("inf")                  # the same +inf for torch calls
PIECE_BUCKETS = (8, 32, 128, 512, 2048)
#: ``hierarchy_levels="auto"`` closes the overlay densely up to this
#: many boundary nodes (the reference's hierarchy.AUTO_THRESHOLD)
AUTO_THRESHOLD = 1024
#: the reference's hierarchy.MAX_LEVELS: the range the knob accepts
MAX_LEVELS = 5

_pad_to = padding.pad_to


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


def _sync(device: torch.device) -> None:
    """Wait for the card, so a stage's wall time covers its kernels."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclasses.dataclass
class DeviceIndex:
    """The dense-path fields of the reference's ``DeviceIndex``, same
    names, dtypes and shapes."""
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
    # super graph (dense overlay)
    d_super: torch.Tensor           # f32 [S+1, S+1] (+inf sentinel row/col)
    super_next: torch.Tensor        # int32 [S+1, S+1] overlay first hop (-1)
    # pieces: every bucketed APSP tensor, flattened end to end
    piece_flat: torch.Tensor        # f32 [sum_b P_b * mp_b * mp_b]
    piece_next: torch.Tensor        # int32, same layout as piece_flat (-1)
    # host sidecar: winning SUPER slot per overlay pair (path unwinding)
    host_ov_slot: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.agent_of.device


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
    "piece_next": torch.int32,
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


def super_weights(plan: BuildPlan, blocks: np.ndarray) -> None:
    """Fill every enforced SUPER slot weight by gathering from the full
    fragment APSP table ``blocks`` [k, maxf, maxf] (the Upsilon weights
    are *derived* state, never stored authoritatively)."""
    mask = plan.sup_fi >= 0
    plan.sup_w[mask] = blocks[plan.sup_fi[mask], plan.sup_pu[mask],
                              plan.sup_pv[mask]]


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


def _piece_adj(g, members: np.ndarray, cap: int) -> np.ndarray:
    sub, _ids = g.subgraph(members)
    adj = np.full((cap, cap), INF, dtype=np.float32)
    adj[sub.edge_u, sub.edge_v] = sub.edge_w.astype(np.float32)
    adj[sub.edge_v, sub.edge_u] = sub.edge_w.astype(np.float32)
    return adj


def _fw_bucket(adjs: List[np.ndarray], device: torch.device, *,
               force=None) -> tuple[np.ndarray, np.ndarray]:
    """Batched witness FW over equally-padded piece matrices ->
    (dist blocks, next blocks) on the host."""
    out, nxt = ops.fw_batch_next(_to(np.stack(adjs), device), force=force)
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
        adjs = [_piece_adj(g, plan.piece_members[gid], cap)
                for gid in gids]
        blocks, nexts = _fw_bucket(adjs, device, force=force)
        for gid, block, nxt in zip(gids, blocks, nexts):
            base = plan.piece_base[gid]
            flat[base:base + cap * cap] = block.reshape(-1)
            nflat[base:base + cap * cap] = nxt.reshape(-1)
    return flat, nflat


def resolve_hierarchy_levels(S: int, hierarchy_levels) -> int:
    """Normalize the ``hierarchy_levels`` build knob as the reference
    does: "auto" closes densely up to AUTO_THRESHOLD boundary nodes,
    explicit 1..MAX_LEVELS is honored (1 on an empty overlay)."""
    if hierarchy_levels == "auto":
        hierarchy_levels = 2 if S > AUTO_THRESHOLD else 1
    try:
        lv = int(hierarchy_levels)
    except (TypeError, ValueError):
        raise ValueError(
            f"hierarchy_levels must be an int or 'auto': "
            f"{hierarchy_levels!r}")
    if not 1 <= lv <= MAX_LEVELS:
        raise ValueError(
            f"hierarchy_levels must be in 1..{MAX_LEVELS} or 'auto': "
            f"{hierarchy_levels!r}")
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


def build_device_index_with_plan(
        ix: DislandIndex, *, device=None, force=None,
        hierarchy_levels: int | str = "auto", hub_nodes=None
        ) -> tuple[DeviceIndex, BuildPlan]:
    """Full from-scratch build of the dense-overlay index on ``device``
    (default ``cuda``).  Each stage's wall time, kernels included, lands
    in ``plan.build_timings``.

    The port closes the overlay densely only: ``hierarchy_levels`` that
    resolves above 1 (the N-level hierarchy) and ``hub_nodes`` (the
    hub-label tier) raise ``NotImplementedError`` until those slices of
    ROADMAP.md are ported.
    """
    if hub_nodes is not None and len(hub_nodes):
        raise NotImplementedError(
            "hub_nodes: the hub-label tier is not ported yet (ROADMAP.md, "
            "hub-label slice); build without it")
    dev = resolve_device(device)
    bt: dict = {}
    with trace.timed("build.plan", bt, "plan"):
        plan = make_build_plan(ix)
        lv = resolve_hierarchy_levels(plan.S, hierarchy_levels)
        if lv != 1:
            raise NotImplementedError(
                f"hierarchy_levels={hierarchy_levels!r} resolves to {lv} "
                f"levels at S={plan.S}: the N-level overlay hierarchy is "
                f"not ported yet (ROADMAP.md, hierarchy slice); pass "
                f"hierarchy_levels=1 for the dense overlay")
    plan.build_timings = bt
    with trace.timed("build.frag_stage", bt, "frag_stage", k=plan.k):
        frag_apsp, brow, frag_next = frag_stage(plan, dev, force=force)
        super_weights(plan, frag_apsp.cpu().numpy())
        _sync(dev)
    with trace.timed("build.super_stage", bt, "super_stage", S=plan.S):
        d_super, super_next = super_stage(plan, dev, force=force)
        _sync(dev)
    with trace.timed("build.piece_stage", bt, "piece_stage",
                     pieces=plan.n_pieces):
        piece_flat, piece_next = piece_stage(plan, ix.g, dev, force=force)
    base, stride = _node_piece_addressing(plan)
    dix = DeviceIndex(
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
        host_ov_slot=overlay_slot_table(plan),
    )
    return dix, plan


def build_device_index(ix: DislandIndex, *, device=None, force=None,
                       hierarchy_levels: int | str = "auto"
                       ) -> DeviceIndex:
    """Assemble padded tensors on the host, run the device stages."""
    return build_device_index_with_plan(
        ix, device=device, force=force,
        hierarchy_levels=hierarchy_levels)[0]


# ---------------------------------------------------------------------------
# online serving
# ---------------------------------------------------------------------------
def _same_dra_dist(dix: DeviceIndex, s, t, ds, dt):
    """Case 1: same agent.  Same piece -> one flat gather; else via
    agent.  The piece index is masked before the gather (it is only
    meaningful where both ends lie in one piece)."""
    gid_s = dix.piece_gid[s]
    same_piece = (gid_s >= 0) & (gid_s == dix.piece_gid[t])
    d_via_agent = ds + dt
    idx = (dix.piece_base[s].long()
           + dix.pos_in_piece[s].long() * dix.piece_stride[s].long()
           + dix.pos_in_piece[t].long())
    d_piece = dix.piece_flat[torch.where(same_piece, idx, 0)]
    return torch.where(same_piece, torch.minimum(d_piece, d_via_agent),
                       d_via_agent)


def _combine_mid(dix: DeviceIndex, row_s, bs, row_t, bt, *, force=None,
                 layout=None):
    """combine = min_{b1,b2} row_s[b1] + D_super[bs[b1], bt[b2]]
    + row_t[b2] without a [q, mb, mb] intermediate.

    ``layout`` picks one of the reference's two layouts:
    "scatter" scatter-mins the boundary rows into SUPER coordinates
    (one O(q*mb) scatter each) and runs the fused two-sided contraction
    against D_super (``ops.minplus_twoside``: the CUDA kernel on the
    card, its plain version on the CPU); "gather" chunks the b1 axis so
    the gathered block never exceeds [q, 8, mb].  None picks "scatter"
    where ``ops`` would run the kernel and "gather" elsewhere, as the
    reference picks by its ``force``.
    """
    if layout is None:
        layout = ("scatter" if ops.use_kernel(row_s.device, force)
                  else "gather")
    if layout == "scatter":
        q, s1 = row_s.shape[0], dix.d_super.shape[0]
        rs = torch.full((q, s1), _INF, dtype=row_s.dtype,
                        device=row_s.device)
        rs.scatter_reduce_(1, bs.long(), row_s, "amin")
        rt = torch.full((q, s1), _INF, dtype=row_t.dtype,
                        device=row_t.device)
        rt.scatter_reduce_(1, bt.long(), row_t, "amin")
        return ops.minplus_twoside(rs, dix.d_super, rt, force=force)
    if layout != "gather":
        raise ValueError(f"layout must be None, 'scatter' or 'gather': "
                         f"{layout!r}")
    q, mb = row_s.shape
    c = min(8, mb)                       # mb is padded to a multiple of 8
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


def serve_cross(dix: DeviceIndex, s: torch.Tensor, t: torch.Tensor, *,
                with_local: bool, force=None, layout=None) -> torch.Tensor:
    """Planner buckets 2/3: endpoints in different DRAs.  with_local
    folds in the intra-fragment distance (same-fragment bucket only).

    A fragment id of -1 (an agent outside every fragment) is clamped to
    0 before the gathers and its answer masked to +inf after, where the
    reference lets JAX wrap the -1 and masks only after."""
    s, t = s.long(), t.long()
    us, ut = dix.agent_of[s].long(), dix.agent_of[t].long()
    ds, dt = dix.dist_to_agent[s], dix.dist_to_agent[t]
    fs, ft = dix.frag_of[us].long(), dix.frag_of[ut].long()
    valid = (fs >= 0) & (ft >= 0)
    fs_c, ft_c = fs.clamp(min=0), ft.clamp(min=0)
    ps, pt = dix.pos_in_frag[us].long(), dix.pos_in_frag[ut].long()
    row_s = dix.brow[fs_c, ps]                   # [q, mb]
    row_t = dix.brow[ft_c, pt]
    mid = _combine_mid(dix, row_s, dix.bnd_super[fs_c], row_t,
                       dix.bnd_super[ft_c], force=force, layout=layout)
    if with_local:
        mid = torch.minimum(mid, torch.where(
            fs == ft, dix.frag_apsp[fs_c, ps, pt], _INF))
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
