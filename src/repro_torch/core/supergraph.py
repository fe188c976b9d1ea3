# Copied from src/repro/core/supergraph.py (numpy only); keep the two in step.
"""SUPER graphs (paper §V-A) and the full DISLAND preprocessing pipeline.

Preprocessing (paper §VI-A, Fig. 7):
  1. compDRAs -> maximal agents + DRAs (agents.py)
  2. per-DRA agent->node distances (stored in DRAResult)
  3. shrink graph G[A]
  4. BGP partition of the shrink graph into fragments of ~ c*floor(sqrt n)
  5. per-fragment hybrid landmark cover over the boundary nodes
  6. SUPER graph assembly: boundary nodes + landmarks; cross-fragment
     original edges + per-fragment enforced edges (weights = local
     shortest distances Upsilon).

Everything here is host-side numpy (one-shot, linear-ish); the *products*
are padded tensors the device engine consumes (device_engine.py).

The build is explicit stage functions over a ``HostBuildPlan`` with a
``build_workers`` knob: per-fragment covers run process-parallel over a
shared read-only CSR, and ``start_build``/``HostBuild.finish`` expose
the structural index *before* the covers land so the device build can
overlap them (the device stages never read covers; only
``_assemble_super`` does).  ``build_workers <= 1`` runs the covers
serially in fragment order (``cover_stage``), and every parallel build
is array-equal to that serial one (``index_arrays_equal``).
``reweight_index`` gives the same structure new weights: the
from-scratch oracle of the incremental refresh
(``device_engine.refresh_index``).

The module and everything it imports are numpy and the standard
library only, so a cover worker never imports torch on its own.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Callable, List, Optional

import numpy as np

from ..obs import trace
from .agents import DRAResult, compute_dras
from .graph import Graph, SharedGraph
from .landmarks import HybridCover, hybrid_cover
from .partition import PartitionResult, partition_bgp

#: the reference forks where it can (``src/repro/core/supergraph.py:53``);
#: the port spawns: the pool may start after the parent holds a CUDA
#: context and runs other threads (a serving flusher, a refresh), and a
#: child forked from a multithreaded parent can deadlock on a lock
#: another thread held at the fork.  A spawned worker imports this
#: module (numpy only) and, where the parent's main module is a file or
#: a package module, that module too: run from the serve CLI, each
#: worker imports torch once at start.
_MP_START = "spawn"


@dataclasses.dataclass
class Fragment:
    nodes: np.ndarray        # original node ids in this fragment
    graph: Graph             # induced subgraph (local ids)
    boundary_local: np.ndarray
    cover: Optional[HybridCover]   # local ids; None until cover_stage


@dataclasses.dataclass
class SuperGraph:
    graph: Graph             # SUPER graph over compact ids
    node_ids: np.ndarray     # compact id -> original node id
    id_of: dict              # original node id -> compact id


@dataclasses.dataclass
class DislandIndex:
    """All auxiliary structures DISLAND query answering needs."""
    g: Graph
    dras: DRAResult
    shrink: Graph
    shrink_ids: np.ndarray       # shrink-local -> original id
    shrink_id_of: np.ndarray     # original -> shrink-local (-1 if removed)
    partition: PartitionResult   # over shrink-local ids
    fragments: List[Fragment]    # nodes/graph in original/local id spaces
    super_graph: SuperGraph
    frag_of: np.ndarray          # original id -> fragment id (-1 if in DRA)
    timings: dict

    # -- extra-space accounting (paper §VI "Extra space analysis") -------
    def extra_space_edges(self) -> dict:
        agent_edges = sum(a.nodes.size for a in self.dras.agents)
        enforced = sum(f.cover.n_enforced_edges for f in self.fragments)
        cross = int(self.super_graph.graph.m)
        return {
            "agent_dra_edges": agent_edges,
            "super_graph_edges": cross,
            "enforced_edges": enforced,
            "total": agent_edges + cross,
        }


# ---------------------------------------------------------------------------
# staged host build pipeline (DESIGN.md §17)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HostBuildPlan:
    """Host-side staged build state, mirroring the device ``BuildPlan``.

    Each ``*_stage`` function below consumes the fields earlier stages
    filled and writes its own — the dependency order is the field
    order.  All stage wall-times flow through the one span API
    (DESIGN.md §16): the same measurement fills ``timings`` and, when
    tracing is on, the build trace.
    """
    g: Graph
    c: int = 2
    use_cost_model: bool = True
    seed: int = 0
    build_workers: int = 1
    cover_fn: Optional[Callable] = None   # hybrid_cover override (tests)
    timings: dict = dataclasses.field(default_factory=dict)
    # stage products
    dras: Optional[DRAResult] = None
    shrink: Optional[Graph] = None
    shrink_ids: Optional[np.ndarray] = None
    shrink_id_of: Optional[np.ndarray] = None
    partition: Optional[PartitionResult] = None
    boundary: Optional[np.ndarray] = None          # shrink-local mask
    fragments: Optional[List[Fragment]] = None
    frag_of: Optional[np.ndarray] = None
    super_graph: Optional[SuperGraph] = None


def agents_stage(plan: HostBuildPlan) -> None:
    """compDRAs: maximal agents + DRAs (paper Fig. 6)."""
    with trace.timed("build.compDRAs", plan.timings, "compDRAs",
                     n=plan.g.n):
        plan.dras = compute_dras(plan.g, c=plan.c)


def shrink_stage(plan: HostBuildPlan) -> None:
    """Shrink graph G[A]: drop DRA-represented nodes."""
    with trace.timed("build.shrink_graph", plan.timings, "shrink_graph"):
        shrink_nodes = plan.dras.shrink_nodes()
        plan.shrink, plan.shrink_ids = plan.g.subgraph(shrink_nodes)
        plan.shrink_id_of = -np.ones(plan.g.n, dtype=np.int64)
        plan.shrink_id_of[plan.shrink_ids] = np.arange(
            plan.shrink_ids.size)


def partition_stage(plan: HostBuildPlan) -> None:
    """BGP partition of the shrink graph (gamma ~ c*floor(sqrt n))."""
    with trace.timed("build.partition", plan.timings, "partition"):
        gamma = max(4, plan.c * int(np.floor(np.sqrt(plan.g.n))))
        plan.partition = partition_bgp(plan.shrink, gamma, seed=plan.seed)


def fragment_stage(plan: HostBuildPlan) -> None:
    """Batched fragment extraction; covers stay None until cover_stage.

    After this stage the index is *structurally* complete — everything
    the device build reads exists — which is the streaming handoff
    point: ``HostBuild.structural_index`` hands the device stages their
    input while the covers are still computing.
    """
    with trace.timed("build.fragments", plan.timings, "fragments",
                     k=plan.partition.n_fragments):
        plan.boundary = plan.partition.boundary_mask(plan.shrink)
        frag_of = -np.ones(plan.g.n, dtype=np.int64)
        fragments: List[Fragment] = []
        for i, (fg, fids) in enumerate(
                plan.shrink.extract_fragments(plan.partition.labels)):
            orig = plan.shrink_ids[fids]
            frag_of[orig] = i
            bl = np.nonzero(plan.boundary[fids])[0].astype(np.int32)
            fragments.append(Fragment(nodes=orig, graph=fg,
                                      boundary_local=bl, cover=None))
        plan.fragments = fragments
        plan.frag_of = frag_of


def cover_stage(plan: HostBuildPlan) -> None:
    """Per-fragment hybrid landmark covers, serially in fragment order
    (the ``build_workers <= 1`` route)."""
    fn = plan.cover_fn or hybrid_cover
    with trace.timed("build.hybrid_covers", plan.timings,
                     "hybrid_covers", k=len(plan.fragments), workers=1):
        for f in plan.fragments:
            f.cover = fn(f.graph, f.boundary_local, plan.use_cost_model)


def super_stage(plan: HostBuildPlan) -> None:
    """SUPER graph assembly from the (now complete) covers."""
    with trace.timed("build.super_graph", plan.timings, "super_graph"):
        plan.super_graph = _assemble_super(
            plan.g, plan.shrink, plan.shrink_ids, plan.partition,
            plan.fragments)


# -- worker-side cover computation (copied from
#    src/repro/core/supergraph.py:186-211) ----------------------------------
# Workers attach the shared shrink CSR once (initializer), then each
# task ships only a fragment id and returns only the cover arrays.  The
# worker re-derives its fragment subgraph from the shared CSR — bit-
# identical to the parent's extract_fragments product because
# from_edges canonicalizes — so nothing graph-sized is ever pickled.
_WORKER_STATE: dict = {}


def _cover_worker_init(meta: dict, labels: np.ndarray,
                       boundary: np.ndarray, use_cost_model: bool,
                       cover_fn: Optional[Callable]) -> None:
    shared = Graph.from_shared(meta)
    _WORKER_STATE.update(
        shared=shared, shrink=shared.graph, labels=labels,
        boundary=boundary, use_cost_model=use_cost_model,
        cover_fn=cover_fn or hybrid_cover)


def _cover_worker_task(frag_id: int):
    st = _WORKER_STATE
    loc = np.nonzero(st["labels"] == frag_id)[0].astype(np.int32)
    fg, fids = st["shrink"].subgraph(loc)
    bl = np.nonzero(st["boundary"][fids])[0].astype(np.int32)
    cov = st["cover_fn"](fg, bl, st["use_cost_model"])
    return frag_id, cov.landmarks, cov.landmark_edges, cov.direct_edges


class HostBuild:
    """An in-flight host build: structural stages done, covers pending
    (copied from src/repro/core/supergraph.py:214).

    ``start_build`` runs agents/shrink/partition/fragment stages
    synchronously and (for ``build_workers > 1``) submits every
    fragment cover to a spawned process pool over the shared shrink
    CSR.  ``structural_index`` is then immediately available for the
    device build — its stages never read covers — and ``finish`` joins
    the covers (or, with no pool, runs ``cover_stage``), assembles the
    SUPER graph, and returns the completed index (the same object
    ``structural_index`` returned, covers filled in place).

    Failure contract: if any fragment cover raises, ``finish`` cancels
    all outstanding futures, shuts the pool down, releases the shared
    block, and re-raises the original exception — no orphaned workers,
    no hang.
    """

    def __init__(self, plan: HostBuildPlan, ix: DislandIndex,
                 pool: Optional[ProcessPoolExecutor] = None,
                 futures: Optional[dict] = None,
                 shared: Optional[SharedGraph] = None):
        self.plan = plan
        self._ix = ix
        self._pool = pool
        self._futures = futures
        self._shared = shared
        self._done = False

    def structural_index(self) -> DislandIndex:
        """The index with every device-build input present (covers and
        super_graph still pending — call ``finish`` before using the
        host-side SUPER graph)."""
        return self._ix

    def finish(self) -> DislandIndex:
        """Join covers, assemble the SUPER graph, return the index."""
        if self._done:
            return self._ix
        plan = self.plan
        if self._pool is None:
            cover_stage(plan)
        else:
            with trace.timed("build.hybrid_covers", plan.timings,
                             "hybrid_covers", k=len(plan.fragments),
                             workers=plan.build_workers):
                self._collect_covers()
        super_stage(plan)
        self._ix.super_graph = plan.super_graph
        self._done = True
        return self._ix

    def _collect_covers(self) -> None:
        try:
            for fut in as_completed(self._futures):
                fid, lms, ledges, dedges = fut.result()
                self.plan.fragments[fid].cover = HybridCover(
                    landmarks=lms, landmark_edges=ledges,
                    direct_edges=dedges)
        except BaseException:
            # surface the *original* failure: cancel everything still
            # queued, reap the pool, then re-raise (no hang, no orphans)
            for f in self._futures:
                f.cancel()
            self._pool.shutdown(wait=True, cancel_futures=True)
            raise
        else:
            self._pool.shutdown(wait=True)
        finally:
            self._pool = None
            self._futures = None
            self._shared.close()
            self._shared.unlink()
            self._shared = None


def start_build(g: Graph, c: int = 2, use_cost_model: bool = True,
                seed: int = 0, build_workers: int = 1,
                cover_fn: Optional[Callable] = None) -> HostBuild:
    """Run the structural stages now; kick covers off in the background
    (copied from src/repro/core/supergraph.py:293).

    The returned ``HostBuild`` is the streaming handoff: feed
    ``structural_index()`` to the device build immediately, then call
    ``finish()`` (which blocks on the covers) before the index is used
    host-side.  ``build_workers <= 1`` keeps everything in-process —
    covers then run inside ``finish()``, still after the device build
    had a chance to start.
    """
    plan = HostBuildPlan(g=g, c=c, use_cost_model=use_cost_model,
                         seed=seed, build_workers=build_workers,
                         cover_fn=cover_fn)
    agents_stage(plan)
    shrink_stage(plan)
    partition_stage(plan)
    fragment_stage(plan)
    ix = DislandIndex(
        g=g, dras=plan.dras, shrink=plan.shrink,
        shrink_ids=plan.shrink_ids, shrink_id_of=plan.shrink_id_of,
        partition=plan.partition, fragments=plan.fragments,
        super_graph=None, frag_of=plan.frag_of, timings=plan.timings)
    nfrag = plan.partition.n_fragments
    if build_workers > 1 and nfrag > 1:
        shared = plan.shrink.to_shared()
        try:
            pool = ProcessPoolExecutor(
                max_workers=min(build_workers, nfrag),
                mp_context=mp.get_context(_MP_START),
                initializer=_cover_worker_init,
                initargs=(shared.meta, plan.partition.labels,
                          plan.boundary, use_cost_model, cover_fn))
            futures = {pool.submit(_cover_worker_task, i): i
                       for i in range(nfrag)}
        except BaseException:
            shared.close()
            shared.unlink()
            raise
        return HostBuild(plan, ix, pool=pool, futures=futures,
                         shared=shared)
    return HostBuild(plan, ix)


def build_index(g: Graph, c: int = 2, use_cost_model: bool = True,
                seed: int = 0, build_workers: int = 1,
                cover_fn: Optional[Callable] = None) -> DislandIndex:
    """Run the full preprocessing module (paper Fig. 7): serially with
    ``build_workers <= 1``, else with the covers in a process pool."""
    return start_build(g, c=c, use_cost_model=use_cost_model, seed=seed,
                       build_workers=build_workers,
                       cover_fn=cover_fn).finish()


# copied from src/repro/core/supergraph.py:347
def _graph_equal(a: Graph, b: Graph) -> bool:
    return (a.n == b.n and a.m == b.m
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.weights, b.weights)
            and np.array_equal(a.edge_u, b.edge_u)
            and np.array_equal(a.edge_v, b.edge_v)
            and np.array_equal(a.edge_w, b.edge_w))


# copied from src/repro/core/supergraph.py:357
def index_arrays_equal(a: DislandIndex, b: DislandIndex) -> dict:
    """Field-wise array equality of two host indices.  Returns
    ``{field: bool}``; callers assert ``all(...values())`` so a failure
    names the diverging field."""
    out = {}
    da, db = a.dras, b.dras
    out["dras.arrays"] = (
        np.array_equal(da.agent_of, db.agent_of)
        and np.array_equal(da.dist_to_agent, db.dist_to_agent)
        and np.array_equal(da.piece_of, db.piece_of)
        and da.threshold == db.threshold)
    out["dras.agents"] = (
        len(da.agents) == len(db.agents)
        and all(x.agent == y.agent
                and len(x.pieces) == len(y.pieces)
                and all(np.array_equal(p, q)
                        for p, q in zip(x.pieces, y.pieces))
                and np.array_equal(x.nodes, y.nodes)
                and np.array_equal(x.dist_to_agent, y.dist_to_agent)
                and np.array_equal(x.piece_of, y.piece_of)
                for x, y in zip(da.agents, db.agents)))
    out["shrink"] = (_graph_equal(a.shrink, b.shrink)
                     and np.array_equal(a.shrink_ids, b.shrink_ids)
                     and np.array_equal(a.shrink_id_of, b.shrink_id_of))
    out["partition"] = (
        a.partition.n_fragments == b.partition.n_fragments
        and np.array_equal(a.partition.labels, b.partition.labels))
    out["frag_of"] = np.array_equal(a.frag_of, b.frag_of)
    frag_ok = cov_ok = len(a.fragments) == len(b.fragments)
    for fa, fb in zip(a.fragments, b.fragments):
        frag_ok = (frag_ok and np.array_equal(fa.nodes, fb.nodes)
                   and _graph_equal(fa.graph, fb.graph)
                   and np.array_equal(fa.boundary_local,
                                      fb.boundary_local))
        if (fa.cover is None) != (fb.cover is None):
            cov_ok = False
        elif fa.cover is not None:
            ca, cb = fa.cover, fb.cover
            cov_ok = (cov_ok
                      and np.array_equal(ca.landmarks, cb.landmarks)
                      and np.array_equal(ca.landmark_edges,
                                         cb.landmark_edges)
                      and np.array_equal(ca.direct_edges,
                                         cb.direct_edges))
    out["fragments"] = frag_ok
    out["covers"] = cov_ok
    sa, sb = a.super_graph, b.super_graph
    if sa is None or sb is None:
        out["super_graph"] = sa is None and sb is None
    else:
        out["super_graph"] = (
            _graph_equal(sa.graph, sb.graph)
            and np.array_equal(sa.node_ids, sb.node_ids)
            and sa.id_of == sb.id_of)
    return out


# copied from src/repro/core/supergraph.py:418
def reweight_index(ix: DislandIndex, g_new: Graph) -> DislandIndex:
    """Same index *structure*, new edge weights.

    Weight updates never change cut nodes, BCCs, DRAs, fragments, or
    the SUPER node universe — all are purely topological — so a live
    traffic batch only invalidates the weight-dependent products.  This
    rebuilds exactly those on the host: per-DRA agent distances, the
    shrink/fragment subgraph weights.  Covers and the SUPER graph are
    carried over structurally; their cached enforced-edge *distances*
    are stale, which the device build never reads (it regathers Upsilon
    weights from the fragment APSP, device_engine.super_weights) — use
    ``build_index(g_new)`` if a fully-consistent host index is needed.

    ``build_device_index(reweight_index(ix, g_new))`` is therefore the
    from-scratch reference the incremental ``refresh_index`` path is
    held against, array for array.
    """
    from .agents import _sssp_within

    if g_new.n != ix.g.n or g_new.m != ix.g.m:
        raise ValueError("reweight_index requires identical topology")
    dist_to_agent = ix.dras.dist_to_agent.copy()
    agents = []
    for a in ix.dras.agents:
        allp = np.unique(np.concatenate(a.pieces))
        dmap = _sssp_within(g_new, a.agent, allp)
        d = np.array([dmap.get(int(x), np.inf) for x in a.nodes])
        agents.append(dataclasses.replace(a, dist_to_agent=d))
        dist_to_agent[a.nodes] = d
    dras = dataclasses.replace(ix.dras, agents=agents,
                               dist_to_agent=dist_to_agent)

    shrink, shrink_ids = g_new.subgraph(ix.shrink_ids)
    fragments = []
    for i, f in enumerate(ix.fragments):
        loc = ix.partition.fragment_nodes(i)
        fg, _fids = shrink.subgraph(loc)
        fragments.append(dataclasses.replace(f, graph=fg))

    return dataclasses.replace(
        ix, g=g_new, dras=dras, shrink=shrink, fragments=fragments,
        timings=dict(ix.timings, reweighted=True))


def _assemble_super(g: Graph, shrink: Graph, shrink_ids: np.ndarray,
                    part: PartitionResult,
                    fragments: List[Fragment]) -> SuperGraph:
    """SUPER graph: boundary nodes + landmarks, E_B + enforced edges.

    One vectorized pass: per-source edge arrays (E_B, per-fragment
    landmark + direct edges, all mapped to original ids) concatenate
    into a single edge list; the member universe is their endpoints
    plus every boundary node; local ids fall out of one searchsorted.
    """
    eu_parts: List[np.ndarray] = []
    ev_parts: List[np.ndarray] = []
    ew_parts: List[np.ndarray] = []
    member_parts: List[np.ndarray] = []
    # E_B: original (shrink) edges with both endpoints boundary
    boundary = part.boundary_mask(shrink)
    both = boundary[shrink.edge_u] & boundary[shrink.edge_v]
    eu_parts.append(shrink_ids[shrink.edge_u[both]].astype(np.int64))
    ev_parts.append(shrink_ids[shrink.edge_v[both]].astype(np.int64))
    ew_parts.append(shrink.edge_w[both].astype(np.float64))
    # enforced edges per fragment (local ids -> original ids)
    for f in fragments:
        fmap = f.nodes
        member_parts.append(np.asarray(fmap[f.boundary_local],
                                       dtype=np.int64))
        for rows in (f.cover.landmark_edges, f.cover.direct_edges):
            if not len(rows):
                continue
            ou = fmap[rows[:, 0].astype(np.int64)].astype(np.int64)
            ov = fmap[rows[:, 1].astype(np.int64)].astype(np.int64)
            keep = ou != ov
            eu_parts.append(ou[keep])
            ev_parts.append(ov[keep])
            ew_parts.append(rows[keep, 2].astype(np.float64))
    eu = np.concatenate(eu_parts)
    ev = np.concatenate(ev_parts)
    ew = np.concatenate(ew_parts)
    node_ids = np.unique(np.concatenate(member_parts + [eu, ev]))
    id_of = {int(v): i for i, v in enumerate(node_ids)}
    if eu.size:
        lu = np.searchsorted(node_ids, eu).astype(np.int32)
        lv = np.searchsorted(node_ids, ev).astype(np.int32)
        sg = Graph.from_edges(node_ids.size, lu, lv, ew)
    else:
        sg = Graph.from_edges(max(node_ids.size, 0), [], [], [])
    return SuperGraph(graph=sg, node_ids=node_ids, id_of=id_of)
