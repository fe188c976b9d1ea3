"""Query planner: the host-side front end of the port's serve path.

Port of ``repro/core/dist_engine.py:QueryPlanner``.  It buckets each
incoming batch by case (same-DRA / same-fragment / cross-fragment, and
on hierarchical indices with resident rows the cross_res fast path) and
runs one program per bucket, so same-DRA queries never pay for the
overlay combine and cross-fragment queries never touch the piece
tables.  Each bucket is padded to a power of two with (0, 0) filler
queries, exactly as the reference pads, so a bucket runs at one of
O(log batch) shapes.  ``query_witness`` runs the witness programs of
the same buckets (distances plus the witnesses ``paths.PathUnwinder``
expands).  The planner also fronts the hub-label tier: ``hub_mask``
gates the pairs both of whose agents carry labels (and whose route must
touch the top boundary), ``query_hub`` answers them with one label
merge; it is not a planner case, and ``query`` stays the reference the
merge must equal.

Owned invariants: ``plan()``'s buckets cover every query exactly once;
``set_index`` publishes an epoch's host maps as one tuple keyed by the
index object, and every entry point takes ``dix=`` to pin one epoch, so
a publish that lands mid-batch cannot mix one epoch's tensors with
another's sidecars.

On a card the planner replays each bucket's program as a CUDA graph
(``core/graphs.py``): one graph per (index object, kind, case, padded
size), captured at ``warmup`` for every size a batch can fill, and
otherwise at a key's first use in an epoch once the key has run before
(a published epoch's, at their first batches; a shape's very first run
is eager, so no kernel is built or loaded inside a capture).  A batch
stages each bucket's padded pair in pinned host memory, replays, copies
the outputs back without blocking, and waits once, after its last
bucket.  A pinned epoch whose graphs were dropped, a batch that finds
another thread replaying, and the CPU run the programs eagerly.

``EpochedEngine`` serves batched queries while it absorbs live
edge-weight updates: ``apply_updates`` runs the incremental refresh
(``device_engine.refresh_index``) beside the serving epoch, on a CUDA
stream of its own, and publishes its result as the next one with a
single pointer swap.

``serve_sharded``/``serve_jit`` serve a batch split over the devices of
a ``launch.mesh.Mesh``, each shard through ``serve_step`` against a
replica of the index; ``fw_fragments_sharded`` and
``super_apsp_sharded`` split the offline build's fragment APSP and SUPER
APSP the same way.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from .. import convert
from ..kernels import ops
from ..obs import trace
from . import graphs, padding, refresh_pipeline, sssp
from .device_engine import (DeviceIndex, RefreshStats, _sync,
                            build_device_index_with_plan, refresh_index,
                            resolve_device, serve_cross, serve_cross_res,
                            serve_cross_w, serve_hub, serve_same_dra,
                            serve_same_dra_w, serve_step, warmup_refresh)
from .paths import PathUnwinder
from .supergraph import DislandIndex, start_build

if TYPE_CHECKING:
    from ..launch.mesh import Mesh

_pad_pow2 = padding.pad_pow2


def hub_gate(s, t, agent_of: np.ndarray, frag_of: np.ndarray,
             hub_agent: np.ndarray | None, topgrp: np.ndarray | None, *,
             hierarchical: bool) -> np.ndarray:
    """The hub tier's exactness gate over host maps (``QueryPlanner.
    hub_mask`` on an epoch's sidecars): True where s != t, both agents
    lie in different fragments and carry labels (``hub_agent >= 0``),
    and on hierarchical indices (``hierarchical``) the fragments lie in
    different TOP groups (``topgrp``), so every route touches the top
    boundary the labels enumerate."""
    s = np.asarray(s, np.int64)
    t = np.asarray(t, np.int64)
    if hub_agent is None:
        return np.zeros(s.shape, bool)
    us, ut = agent_of[s], agent_of[t]
    fs, ft = frag_of[us], frag_of[ut]
    ok = ((s != t) & (fs >= 0) & (ft >= 0) & (fs != ft)
          & (hub_agent[us] >= 0) & (hub_agent[ut] >= 0))
    if hierarchical:
        # same-top-group routes may never touch the top boundary
        if topgrp is None:
            return np.zeros(s.shape, bool)
        ok &= (topgrp[np.where(ok, fs, 0)]
               != topgrp[np.where(ok, ft, 0)])
    return ok


class QueryPlanner:
    """Bucket a query batch by case and dispatch per-case programs on
    the index's device.  ``force`` and ``layout`` pass through to the
    cross-fragment programs (``device_engine._combine_mid``), the
    resident program (``serve_cross_res``) and their witness versions;
    ``paths`` makes ``warmup`` run the witness programs too.  On a card
    the buckets replay CUDA graphs (module docstring); ``graph_counts``
    counts buckets by how they ran (``replay``, ``capture``: captured,
    then replayed; ``eager``) and the graphs captured (``captured``,
    warm-up's included)."""

    CASES = ("same_dra", "same_frag", "cross_frag", "cross_res")

    def __init__(self, dix: DeviceIndex, *, force=None, layout=None,
                 paths: bool = False):
        self._fns = {
            "same_dra": serve_same_dra,
            "same_frag": functools.partial(
                serve_cross, with_local=True, force=force, layout=layout),
            "cross_frag": functools.partial(
                serve_cross, with_local=False, force=force, layout=layout),
            # resident fast path: both endpoints in pre-lifted hot
            # groups of *different* top-level groups, so the whole query
            # is one contraction against the top closure
            "cross_res": functools.partial(
                serve_cross_res, force=force, layout=layout),
        }
        # witness programs; cross_res maps to the full-lift witness
        # program, as in the reference: the resident rows re-associate
        # the (min,+) sums, so an argmin over them may disagree with the
        # unwinder's exact re-find (distances are equal anyway)
        cross_w = functools.partial(serve_cross_w, with_local=False,
                                    force=force, layout=layout)
        self._wfns = {
            "same_dra": serve_same_dra_w,
            "same_frag": functools.partial(
                serve_cross_w, with_local=True, force=force, layout=layout),
            "cross_frag": cross_w,
            "cross_res": cross_w,
        }
        # the hub-label tier's program (not a planner case)
        self._hub_fn = functools.partial(serve_hub, force=force)
        self.paths = paths
        self.last_counts: dict = {}
        self.graph_counts = dict.fromkeys(
            ("replay", "capture", "eager", "captured"), 0)
        # graphs: one stream, and one thread at a time capturing or
        # replaying on it; (kind, case, size) keys run at least once
        self._graph_stream = graphs.new_stream(dix.device)
        self._graph_lock = threading.Lock()
        self._seen: set = set()
        self._epoch_graphs: tuple = (None, None)
        self.set_index(dix)

    def set_index(self, dix: DeviceIndex) -> None:
        """Publish an index epoch: later calls without ``dix`` serve it.
        Its membership maps (host copies of ``agent_of`` and
        ``frag_of``) and its cross_res and hub sidecars are cached as ONE
        tuple keyed by the index object, replaced in a single
        assignment, so a call pinned to an epoch (``dix=``) buckets and
        gates with that epoch's maps even when a publish lands between
        the pin and the dispatch.  With graphs, the new epoch's (index,
        set) tuple, its set still empty, replaces the old one, whose
        graphs go with it; the new epoch's are captured at their first
        batches (``_replay_batch``), so the publish waits for no
        capture."""
        if self._graph_stream is None:
            self._epoch_graphs = (dix, None)
        else:
            gs = graphs.GraphSet(dix, self._graph_stream)
            with self._graph_lock:
                # the old set is freed here, under the lock, where no
                # capture runs (a batch holds a set only while it holds
                # the lock): freeing its pinned buffers records events on
                # the stream a capture would be using
                self._epoch_graphs = (dix, gs)
        self.dix = dix
        self._maps = self._host_maps(dix)

    def _graph_set(self, dix: DeviceIndex):
        """The graph set of ``dix``'s epoch while it is the published one
        (None on the CPU, or once a publish replaced it)."""
        cached = self._epoch_graphs      # one read of the published tuple
        return cached[1] if cached[0] is dix else None

    def _capture(self, gs, key: tuple):
        kind, case, _size = key
        fns = self._fns if kind == "d" else self._wfns
        bg = gs.capture(key, fns[case])
        self.graph_counts["captured"] += 1
        return bg

    @staticmethod
    def _host_maps(dix: DeviceIndex) -> tuple:
        return (dix, dix.agent_of.cpu().numpy(), dix.frag_of.cpu().numpy(),
                dix.host_res_frag, dix.host_topgrp_frag, dix.host_hub_agent)

    def _maps_of(self, dix: DeviceIndex | None) -> tuple:
        """(dix, agent_of, frag_of, res_frag, topgrp, hub_agent) of
        ``dix`` (default: the current epoch): the cached tuple when it
        was taken from this very index object, else derived from
        ``dix`` itself (an epoch pinned before the latest publish)."""
        cached = self._maps          # one read of the published tuple
        if dix is None or cached[0] is dix:
            return cached
        return self._host_maps(dix)

    @staticmethod
    def bucket_sizes(batch_size: int) -> list[int]:
        """The padded (pow2) bucket sizes a batch of ``batch_size`` can
        produce — exactly the shapes ``warmup`` runs."""
        m = _pad_pow2(1)
        sizes = []
        while m <= _pad_pow2(batch_size):
            sizes.append(m)
            m *= 2
        return sizes

    def warmup(self, batch_size: int) -> None:
        """Run every sub-program once at every padded bucket size a
        batch of ``batch_size`` can produce, so kernel builds and
        first-launch costs land here and not in the timed serve path."""
        dev = self.dix.device
        z = torch.zeros(max(self.bucket_sizes(batch_size)),
                        dtype=torch.int64, device=dev)
        # the resident program only runs on indices that carry real
        # pre-lifted rows (the cold dummy is (1, 1, 1)); its bucket is
        # provably empty otherwise
        has_res = self.dix.res_rows.shape[0] > 1
        progs = [("d", case, fn) for case, fn in self._fns.items()
                 if has_res or case != "cross_res"]
        if self.paths:
            progs += [("w", case, fn) for case, fn in self._wfns.items()
                      if has_res or case != "cross_res"]
        # the hub program runs only on indices with real label rows (the
        # dummy is (1, 1)); it is no planner bucket, so never a graph
        if self.dix.hub_rows.shape[0] > 1:
            progs.append(("hub", None, self._hub_fn))
        sizes = self.bucket_sizes(batch_size)
        for _kind, _case, fn in progs:
            for size in sizes:
                fn(self.dix, z[:size], z[:size])
        keys = [(kind, case, size) for kind, case, _fn in progs
                if kind != "hub" for size in sizes]
        self._seen.update(keys)
        with self._graph_lock:
            gs = self._graph_set(self.dix)
            for key in keys if gs is not None else ():
                if key not in gs.graphs:
                    self._capture(gs, key)
            gs = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def plan(self, s: np.ndarray, t: np.ndarray,
             dix: DeviceIndex | None = None) -> dict:
        """-> {case: index array} partition of the batch, bucketed by
        ``dix``'s own maps (default: the current epoch)."""
        _dix, agent_of, frag_of, res_frag, topgrp, _hub = self._maps_of(dix)
        us, ut = agent_of[s], agent_of[t]
        fs, ft = frag_of[us], frag_of[ut]
        case1 = us == ut
        case2 = ~case1 & (fs == ft)
        case3 = ~case1 & ~case2
        if res_frag is not None and topgrp is not None:
            # hot split of cross_frag: both fragments pre-lifted AND in
            # different top-level groups (the exactness gate for the
            # resident rows: nested grouping means different top groups
            # imply different groups at every level)
            valid = (fs >= 0) & (ft >= 0)
            fs_v, ft_v = np.where(valid, fs, 0), np.where(valid, ft, 0)
            hot = (case3 & valid & (res_frag[fs_v] >= 0)
                   & (res_frag[ft_v] >= 0) & (topgrp[fs_v] != topgrp[ft_v]))
            case3 = case3 & ~hot
        else:
            hot = np.zeros(s.shape, bool)
        return {
            "same_dra": np.nonzero(case1)[0],
            "same_frag": np.nonzero(case2)[0],
            "cross_frag": np.nonzero(case3)[0],
            "cross_res": np.nonzero(hot)[0],
        }

    def hub_mask(self, s, t, dix: DeviceIndex | None = None) -> np.ndarray:
        """Host-side gate of the hub-label tier: True where both
        endpoints' agents are labeled and the exactness gate holds:
        s != t, different fragments, and on hierarchical indices
        different TOP groups (only then must every route touch the top
        boundary the labels enumerate).  Everything else goes to the
        planner.  Gates with ``dix``'s labels (default: the current
        epoch's)."""
        dix, agent_of, frag_of, _res, topgrp, hub_agent = self._maps_of(dix)
        return hub_gate(s, t, agent_of, frag_of, hub_agent, topgrp,
                        hierarchical=len(dix.sf_of) > 0)

    def query_hub(self, s, t, *, dix: DeviceIndex | None = None
                  ) -> np.ndarray:
        """The label merge for hub_mask-gated pairs: one pow2-padded
        program (``ops.label_merge_rows`` over the label table's row
        ids), no planner buckets.  On gated pairs the answers equal
        ``query``'s, so callers gate with ``hub_mask`` first, as
        ``serving/runtime.py`` does.  Off the gate, a pair with an
        unlabeled agent gets +inf; a labeled pair the gate rejects (in
        one TOP group, say) gets a finite answer, the length of a real
        path through the top boundary: never below the true distance,
        but possibly above it.  An index without labels answers +inf, as
        the reference's sentinel row does.  ``dix`` pins the epoch
        (default: the current one)."""
        dix = self.dix if dix is None else dix
        s = np.asarray(s, np.int64)
        t = np.asarray(t, np.int64)
        if s.size == 0 or dix.hub_rows.shape[0] == 1:
            return np.full(s.shape, np.inf, np.float32)
        m = _pad_pow2(s.size)
        sp = np.zeros(m, np.int64)
        tp = np.zeros(m, np.int64)
        sp[:s.size] = s
        tp[:t.size] = t
        dev = dix.device
        res = self._hub_fn(dix, torch.from_numpy(sp).to(dev),
                           torch.from_numpy(tp).to(dev))
        return res.cpu().numpy()[:s.size]

    def _dispatch(self, fns, s, t, outs, dix=None) -> None:
        """Partition (s, t), pad each bucket to a power of two with
        (0, 0) filler queries, run its sub-program from ``fns`` on the
        index's device and scatter every output into the matching array
        of ``outs``.  ``dix`` pins the epoch; by default the current
        one, read ONCE, so a publish between two buckets cannot split a
        batch across epochs.  Where the epoch has a graph set and no
        other thread replays, the buckets replay their graphs
        (``_replay_batch``); else each runs eagerly.

        While the tracer records, the call is one ``serve.batch`` scope
        (its ``batch`` id tags every span below it): ``planner.plan``
        around the bucketing, and per non-empty bucket a
        ``planner.bucket`` (``case``, ``queries``, ``padded``, and
        ``graph``: "replay", "capture" or "eager") holding
        ``serve.program``, the call that issues the program's work (a
        replay, or the program's torch ops), and, for an eager bucket,
        ``planner.readback``, the blocking copies of its outputs to the
        host; a replayed batch has one ``planner.readback`` after its
        last bucket, the one wait.  What the batch's span holds beyond
        those two is the planner's own host work: bucketing, padding and
        staging, scatter."""
        dix = self.dix if dix is None else dix
        with trace.scope("serve.batch", "batch", queries=int(s.size),
                         witness=fns is self._wfns):
            with trace.span("planner.plan"):
                plan = self.plan(s, t, dix)
            self.last_counts = {c: int(ix.size) for c, ix in plan.items()}
            if (self._graph_stream is not None
                    and self._graph_lock.acquire(blocking=False)):
                # the set is held only under the lock (see set_index)
                try:
                    gs = self._graph_set(dix)
                    if gs is not None:
                        self._replay_batch(gs, fns, plan, s, t, outs, dix)
                        return
                finally:
                    gs = None
                    self._graph_lock.release()
            for case, idx in plan.items():
                if idx.size:
                    self._eager_bucket(fns[case], case, idx, s, t, outs,
                                       dix)

    def _eager_bucket(self, fn, case, idx, s, t, outs, dix) -> None:
        """One bucket through its program, its outputs read back (a
        blocking copy) and scattered."""
        m = _pad_pow2(idx.size)
        with trace.span("planner.bucket", case=case, queries=int(idx.size),
                        padded=m, graph="eager"):
            sp = np.zeros(m, np.int64)
            tp = np.zeros(m, np.int64)
            sp[:idx.size] = s[idx]
            tp[:idx.size] = t[idx]
            sd = torch.from_numpy(sp).to(dix.device)
            td = torch.from_numpy(tp).to(dix.device)
            with trace.span("serve.program"):
                res = fn(dix, sd, td)
            if len(outs) == 1:
                res = (res,)
            with trace.span("planner.readback"):
                host = [r.cpu().numpy() for r in res]
            for out, h in zip(outs, host):
                out[idx] = h[:idx.size]
        self.graph_counts["eager"] += 1

    def _replay_batch(self, gs, fns, plan, s, t, outs, dix) -> None:
        """The buckets of one batch through ``gs``'s graphs, largest
        first (the card starts on the most work while the host issues
        the rest): each one's padded pair staged in its graph's pinned
        input, replayed and copied out without a wait; one wait after the
        last, then the scatter.  A key never run before runs eagerly (and
        is captured at its next use); one run before but not captured in
        this epoch is captured here first."""
        kind = "w" if fns is self._wfns else "d"
        done = []
        for case, idx in sorted(plan.items(), key=lambda ci: -ci[1].size):
            n = idx.size
            if n == 0:
                continue
            m = _pad_pow2(n)
            key = (kind, case, m)
            bg = gs.graphs.get(key)
            if bg is None and key not in self._seen:
                self._eager_bucket(fns[case], case, idx, s, t, outs, dix)
                self._seen.add(key)
                continue
            how = "replay" if bg is not None else "capture"
            with trace.span("planner.bucket", case=case, queries=int(n),
                            padded=m, graph=how):
                if bg is None:
                    bg = self._capture(gs, key)
                h = bg.host_in_np
                h[0, :n] = s[idx]
                h[1, :n] = t[idx]
                h[:, n:] = 0
                with trace.span("serve.program"):
                    t0 = time.perf_counter()
                    bg.launch()
                    t1 = time.perf_counter()
            done.append((idx, bg, t0, t1))
            self.graph_counts[how] += 1
        if not done:
            return
        with trace.span("planner.readback"):
            gs.wait()
        if trace.recording():
            for _idx, bg, t0, t1 in done:
                trace.replayed(bg.spans, t0, t1, dix.device)
        for idx, bg, _t0, _t1 in done:
            for out, h in zip(outs, bg.host_out_np):
                out[idx] = h[:idx.size]

    def __call__(self, s, t) -> np.ndarray:
        return self.query(s, t)

    def query(self, s, t, *, dix: DeviceIndex | None = None) -> np.ndarray:
        """Planner-bucketed batched distances (float32 on the host).
        ``dix`` pins the epoch (default: the current one)."""
        s = np.asarray(s, np.int64)
        t = np.asarray(t, np.int64)
        out = np.full(s.shape, np.inf, np.float32)
        self._dispatch(self._fns, s, t, (out,), dix=dix)
        return out

    def query_witness(self, s, t, *, dix: DeviceIndex | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Planner-bucketed witness serving -> (dist, wit) on the host,
        float32 and int32 (the WIT_* / packed-pair encoding of
        ``device_engine``).  Self-queries get distance 0 and WIT_NONE
        (the unwinder answers s == t before it reads the witness).
        ``dix`` pins the epoch (``EpochedEngine.query_path`` pairs it
        with the same epoch's unwinder)."""
        s = np.asarray(s, np.int64)
        t = np.asarray(t, np.int64)
        out = np.full(s.shape, np.inf, np.float32)
        wit = np.full(s.shape, -1, np.int32)
        self._dispatch(self._wfns, s, t, (out, wit), dix=dix)
        same = s == t
        out[same] = 0.0
        wit[same] = -1
        return out, wit


# ---------------------------------------------------------------------------
# epoch-swapped serving over a live-updating index
# ---------------------------------------------------------------------------
class EpochedEngine:
    """Serve batched queries while absorbing live edge-weight updates
    (copied from src/repro/core/dist_engine.py:337).

    Double-buffered epochs: queries run against the current DeviceIndex,
    which no refresh writes; ``apply_updates`` runs
    ``device_engine.refresh_index`` beside it, waits for the card, and
    publishes the result as epoch e+1 with a single planner pointer
    swap.  A batch pinned to epoch e finishes on it: its tensors stay
    alive as long as something references them.

    The index is built on ``device`` (default ``cuda``; ``"cpu"`` runs
    the plain PyTorch versions) unless ``ix`` is given, through the
    host build's streaming handoff (``supergraph.start_build``): with
    ``build_workers > 1`` the fragment covers run in a spawned process
    pool while the device build's kernels run on the structural index,
    and ``finish`` joins them before the engine returns.  ``force``
    passes through to the planner's programs and the refresh's kernels.
    With ``warm_refresh`` (default) the engine launches each refresh
    shape once (``warmup_refresh``) and runs the delta path on a no-op
    batch (``_warm_refresh_path``) before it returns, so the first live
    refresh pays no kernel load; a run that applies no update can skip
    it.
    """

    def __init__(self, g, *, c: int = 2, seed: int = 0, device=None,
                 force=None, ix: DislandIndex | None = None,
                 warm_refresh: bool = True, paths: bool = False,
                 hierarchy_levels: int | str = "auto",
                 resident_mb: float | str = "auto", hub_nodes=None,
                 build_workers: int = 1):
        self.g = g
        self.device = resolve_device(device)
        host_build = None
        if ix is None:
            host_build = start_build(g, c=c, seed=seed,
                                     build_workers=build_workers)
            ix = host_build.structural_index()
        self.ix = ix
        try:
            self.dix, self.plan = build_device_index_with_plan(
                self.ix, device=self.device, force=force,
                hierarchy_levels=hierarchy_levels,
                resident_mb=resident_mb, hub_nodes=hub_nodes)
        finally:
            # joins (or reaps) the cover workers even when the device
            # build failed: no orphaned pool, no leaked shared block
            if host_build is not None:
                host_build.finish()
        self.planner = QueryPlanner(self.dix, force=force, paths=paths)
        self.epoch = 0
        # one-tuple publish (epoch, dix, graph, staleness): snapshot()
        # readers get a mutually consistent quadruple with a single
        # reference read, never a torn mix of two epochs
        self._published = (0, self.dix, self.g, refresh_pipeline.FRESH)
        self.force = force
        self.last_stats: RefreshStats | None = None
        # (dix, PathUnwinder) pair, replaced as one tuple (unwinder())
        self._unwinder: tuple | None = None
        self._lock = threading.Lock()
        # every refresh runs on this stream (apply_updates): a serving
        # thread's batches, on its own current stream, never queue
        # behind a refresh's kernels
        self._refresh_stream = (torch.cuda.Stream(self.device)
                                if self.device.type == "cuda" else None)
        if warm_refresh:
            warmup_refresh(self.plan, self.device, force=force)
            self._warm_refresh_path()

    def _warm_refresh_path(self) -> None:
        """Run the full delta path once with a no-op update batch
        (existing edges re-assigned their current weights): classification,
        the fragment and piece FW batches and their scatters, without
        changing any distance; the result is dropped."""
        plan = self.plan
        g = self.g
        fa = plan.frag_of
        picks: list = []
        # one edge in each of up to 8 distinct fragments ...
        m_frag = (fa[g.edge_u] >= 0) & (fa[g.edge_u] == fa[g.edge_v])
        e_frag = np.nonzero(m_frag)[0]
        if e_frag.size:
            _, first = np.unique(fa[g.edge_u[e_frag]], return_index=True)
            picks += list(e_frag[first[:8]])
        # ... and one edge in a piece of each bucket size in use
        gid_e = np.where(plan.piece_gid[g.edge_u] >= 0,
                         plan.piece_gid[g.edge_u],
                         plan.piece_gid[g.edge_v])
        e_piece = np.nonzero(gid_e >= 0)[0]
        if e_piece.size:
            _, first = np.unique(plan.piece_cap[gid_e[e_piece]],
                                 return_index=True)
            picks += list(e_piece[first])
        if not picks:
            return
        idx = np.asarray(sorted(set(picks)))
        refresh_index(self.dix, plan, g, g.edge_u[idx], g.edge_v[idx],
                      g.edge_w[idx], force=self.force)

    def query(self, s, t) -> np.ndarray:
        """Planner-bucketed batched queries on the current epoch."""
        return self.planner(s, t)

    def snapshot(self) -> tuple:
        """Atomic ``(epoch, dix, graph, staleness)`` read of the
        published state: a reader can pin an epoch for a whole batch
        (serve against ``dix``, validate against ``graph``) without a
        lock and without ever seeing epoch e's number next to epoch
        e+1's tensors."""
        return self._published

    def unwinder(self, dix: DeviceIndex | None = None) -> PathUnwinder:
        """A PathUnwinder paired with ``dix`` (default: the current
        epoch), cached by index identity, so repeated query_path calls
        within one epoch reuse the snapshot and a concurrent publish can
        never pair witnesses with another epoch's tables."""
        dix = self.dix if dix is None else dix
        cached = self._unwinder          # one read: (dix, uw)
        if cached is not None and cached[0] is dix:
            return cached[1]
        uw = PathUnwinder(dix, self.plan)
        # publish as one tuple and return the local instance, never the
        # slot: a concurrent publish may overwrite the slot in between
        self._unwinder = (dix, uw)
        return uw

    def query_path(self, s, t) -> tuple[np.ndarray, list]:
        """Batched exact shortest paths -> (dist [q] f32, paths):
        paths[i] is the node sequence s_i -> t_i whose edge weights sum
        to exactly dist[i], or None when t_i is unreachable.  The epoch
        is pinned once: witnesses and unwinder bind to the same index,
        so an apply_updates landing mid-call cannot tear them apart."""
        dix = self.planner.dix
        dist, wit = self.planner.query_witness(s, t, dix=dix)
        uw = self.unwinder(dix)
        return dist, uw.unwind_many(s, t, dist, wit)

    def warmup(self, batch_size: int) -> None:
        self.planner.warmup(batch_size)

    def apply_updates(self, u, v, w, *,
                      staleness: "refresh_pipeline.Staleness | None"
                      = None) -> RefreshStats:
        """Absorb a weight-update batch and publish the next epoch.

        Serving continues on the old epoch until the final swap; the
        lock only serializes concurrent updaters, never readers.
        ``staleness`` is the recency descriptor a staged caller
        (``refresh_pipeline.RefreshPipeline``) attaches to the published
        epoch; a direct call publishes a complete one.

        On the card the refresh runs on the engine's refresh stream, so
        its kernels never sit in front of a serving batch, and every
        synchronise inside it (``RefreshStats`` are completed seconds)
        waits for that stream alone.  The new epoch's tensors are
        allocated on the refresh stream and read on the serving
        threads' streams without ``record_stream``: a serving batch
        holds its pinned index until the batch's answers are copied to
        the host, which waits for every kernel that read it, so no block
        of an epoch returns to the refresh stream's pool while a serving
        kernel may still read it.
        """
        stream = (torch.cuda.stream(self._refresh_stream)
                  if self._refresh_stream is not None
                  else contextlib.nullcontext())
        with self._lock, stream:
            w_old = self.g.edge_w[self.g.edge_ids(u, v)]
            g_new = self.g.with_edge_weights(u, v, w)
            new_dix, stats = refresh_index(self.dix, self.plan, g_new,
                                           u, v, w, w_old=w_old,
                                           force=self.force)
            # an epoch publishes fully computed: readers must never
            # wait on kernels still running behind the swap
            _sync(self.device)
            self.g = g_new
            self.dix = new_dix
            self.planner.set_index(new_dix)
            self.epoch += 1
            if staleness is None:
                prev = self._published[3]
                sub = max(prev.submitted, prev.watermark) + 1
                staleness = refresh_pipeline.Staleness(
                    watermark=sub, submitted=sub)
            self._published = (self.epoch, new_dix, g_new, staleness)
            self.last_stats = stats
            return stats


# ---------------------------------------------------------------------------
# sharded serving and offline build (src/repro/core/dist_engine.py:514-576)
# on one controller over a ``launch.mesh.Mesh``, as ``shard_map`` runs: each
# shard's program launches on its device, shards that share a device run
# one after another there, and the parts come back in order on the mesh's
# first device.  Serving is pure data parallel over a replicated index, so
# no shard talks to another.
# ---------------------------------------------------------------------------
def _replicas(dix: DeviceIndex, devices) -> dict:
    """One index per distinct device of ``devices``: ``dix`` itself on
    its own device, a copy (carried across as numpy arrays) on any
    other."""
    reps: dict = {}
    for dev in devices:
        if dev in reps:
            continue
        rep = dix if dev == dix.device else convert.device_index_from_numpy(
            convert.device_index_to_numpy(dix), dev)
        if rep.device != dev:
            raise RuntimeError(f"replica of the index landed on "
                               f"{rep.device}, not on {dev}")
        reps[dev] = rep
    return reps


def _gather(parts: list, out_device: torch.device,
            empty: torch.Tensor) -> torch.Tensor:
    """The shards' results concatenated in shard order on
    ``out_device`` (``empty``, moved there, when no shard had work)."""
    if not parts:
        return empty.to(out_device)
    return torch.cat([p.to(out_device) for p in parts])


def serve_jit(mesh: "Mesh", dix: DeviceIndex, *,
              batch_axes=None):
    """The sharded serve step with its index placed once: replicas of
    ``dix`` on the devices of ``batch_axes`` (default: every axis), and a
    ``step(s, t)`` that serves a batch as ``serve_sharded`` does.

    The counterpart of the reference's ``jax.jit`` with explicit
    replicated and batch shardings.  The reference also lowers that step
    ahead of time from ``ShapeDtypeStruct``s (its dry runs); eager torch
    has no analogue: the step runs only on real tensors."""
    devices = mesh.shard_devices(batch_axes or mesh.axis_names)
    reps = _replicas(dix, devices)
    out_device = mesh.devices[0]

    def step(s, t) -> torch.Tensor:
        s, t = torch.as_tensor(s), torch.as_tensor(t)
        if s.dim() != 1 or s.shape != t.shape:
            raise ValueError(f"s and t must be [q] alike, got "
                             f"{tuple(s.shape)} and {tuple(t.shape)}")
        # every shard launches before any result is read back
        parts = [serve_step(reps[dev], s_i.to(dev), t_i.to(dev))
                 for dev, s_i, t_i in zip(
                     devices, torch.tensor_split(s, len(devices)),
                     torch.tensor_split(t, len(devices)))
                 if s_i.numel()]
        return _gather(parts, out_device, torch.empty(0))

    return step


def serve_sharded(mesh: "Mesh", dix: DeviceIndex, s, t, *,
                  batch_axes=None) -> torch.Tensor:
    """Batched queries sharded over ``batch_axes`` (default: every axis):
    s, t integer [q] -> f32 [q] in query order on ``mesh.devices[0]``.

    Each shard runs ``device_engine.serve_step`` on its device against a
    replica of ``dix`` (``dix`` itself on its own device, a copy
    elsewhere).  JAX needs the batch to divide the mesh; the port takes
    any q, 0 included: ``torch.tensor_split`` gives the first q % shards
    shards one query more, and a shard with no query launches nothing."""
    return serve_jit(mesh, dix, batch_axes=batch_axes)(s, t)


def fw_fragments_sharded(mesh: "Mesh", frag_adj,
                         axis: str = "data") -> torch.Tensor:
    """Offline per-fragment APSP with the fragment batch sharded:
    ``frag_adj`` [k, n, n] float32 (a tensor, or ``BuildPlan.frag_adj``)
    split over ``axis``, each part closed by ``ops.fw_batch`` (kernel 3
    on the card) on its device, the parts gathered on
    ``mesh.devices[0]``."""
    devices = mesh.shard_devices((axis,))
    adj = torch.as_tensor(frag_adj)
    parts = [ops.fw_batch(part.to(dev))
             for dev, part in zip(devices,
                                  torch.tensor_split(adj, len(devices)))
             if part.shape[0]]
    return _gather(parts, mesh.devices[0], adj[:0])


def super_apsp_sharded(mesh: "Mesh", src, dst, w, n_super: int,
                       axis: str = "data") -> torch.Tensor:
    """Offline SUPER APSP [n_super, n_super]: the Bellman-Ford sources
    ``arange(n_super)`` split over ``axis``, the directed edge list
    (each undirected edge passed both ways) replicated to each device,
    ``sssp.apsp_from_sources`` on each part, the rows gathered on
    ``mesh.devices[0]``."""
    devices = mesh.shard_devices((axis,))
    sources = torch.arange(n_super, dtype=torch.int32)
    edges: dict = {}
    parts = []
    for dev, part in zip(devices,
                         torch.tensor_split(sources, len(devices))):
        if not part.numel():
            continue
        if dev not in edges:
            edges[dev] = [torch.as_tensor(x).to(dev) for x in (src, dst, w)]
        parts.append(sssp.apsp_from_sources(*edges[dev], part.to(dev),
                                            n=n_super))
    return _gather(parts, mesh.devices[0],
                   torch.empty((0, n_super), dtype=torch.float32))
