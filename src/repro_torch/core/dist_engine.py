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

``EpochedEngine`` serves batched queries while it absorbs live
edge-weight updates: ``apply_updates`` runs the incremental refresh
(``device_engine.refresh_index``) beside the serving epoch, on a CUDA
stream of its own, and publishes its result as the next one with a
single pointer swap.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from . import padding, refresh_pipeline
from .device_engine import (DeviceIndex, RefreshStats, _sync,
                            build_device_index_with_plan, refresh_index,
                            resolve_device, serve_cross, serve_cross_res,
                            serve_cross_w, serve_hub, serve_same_dra,
                            serve_same_dra_w, warmup_refresh)
from .paths import PathUnwinder
from .supergraph import DislandIndex, start_build

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
    ``paths`` makes ``warmup`` run the witness programs too."""

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
        self.set_index(dix)

    def set_index(self, dix: DeviceIndex) -> None:
        """Publish an index epoch: later calls without ``dix`` serve it.
        Its membership maps (host copies of ``agent_of`` and
        ``frag_of``) and its cross_res and hub sidecars are cached as ONE
        tuple keyed by the index object, replaced in a single
        assignment, so a call pinned to an epoch (``dix=``) buckets and
        gates with that epoch's maps even when a publish lands between
        the pin and the dispatch."""
        self.dix = dix
        self._maps = self._host_maps(dix)

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
        fns = [fn for case, fn in self._fns.items()
               if has_res or case != "cross_res"]
        if self.paths:
            fns += [fn for case, fn in self._wfns.items()
                    if has_res or case != "cross_res"]
        # the hub program runs only on indices with real label rows (the
        # dummy is (1, 1))
        if self.dix.hub_rows.shape[0] > 1:
            fns.append(self._hub_fn)
        for fn in fns:
            for size in self.bucket_sizes(batch_size):
                fn(self.dix, z[:size], z[:size])
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
        program (two label gathers and ``ops.label_merge``), no planner
        buckets.  A mis-gated pair gets +inf, never a wrong distance;
        on gated pairs the answers equal ``query``'s.  An index without
        labels answers +inf, as the reference's sentinel row does.
        ``dix`` pins the epoch (default: the current one)."""
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
        batch across epochs."""
        dix = self.dix if dix is None else dix
        plan = self.plan(s, t, dix)
        self.last_counts = {c: int(ix.size) for c, ix in plan.items()}
        for case, idx in plan.items():
            if idx.size == 0:
                continue
            m = _pad_pow2(idx.size)
            sp = np.zeros(m, np.int64)
            tp = np.zeros(m, np.int64)
            sp[:idx.size] = s[idx]
            tp[:idx.size] = t[idx]
            res = fns[case](dix, torch.from_numpy(sp).to(dix.device),
                            torch.from_numpy(tp).to(dix.device))
            if len(outs) == 1:
                res = (res,)
            for out, r in zip(outs, res):
                out[idx] = r.cpu().numpy()[:idx.size]

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
