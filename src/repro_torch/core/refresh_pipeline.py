# Copied from src/repro/core/refresh_pipeline.py (numpy only); keep the two in step.
"""Pipelined prioritized refresh over the port's ``EpochedEngine``.

``refresh_index`` is exact but monolithic: one apply_updates call holds
the engine's refresh lock for the whole re-close, so a big batch leaves
the published epoch increasingly stale with no bound or visibility.
This module stages that work instead:

  UpdateQueue      update-coalescing queue (one slot per undirected
                   edge, last write wins) with batch sequence numbers.
  RefreshPipeline  partitions the pooled updates into per-group work
                   items, orders them by serving traffic, and applies
                   each through the engine's ordinary apply_updates —
                   publishing an intermediate epoch after every item.
  Staleness        the descriptor attached to each published epoch:
                   which batches it fully reflects (watermark), which
                   groups are still pending.

Exactness: each work item advances the engine's graph by exactly its
own edges, so every staged epoch is the true index of a well-defined
intermediate graph — staleness bounds *recency*, never correctness —
and the final epoch of a drain equals the monolithic refresh, which is
array-equal to a from-scratch rebuild (tests/test_torch_refresh.py).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..obs import trace


@dataclasses.dataclass(frozen=True)
class Staleness:
    """Recency descriptor of one published epoch.

    ``watermark``: every update batch with sequence <= this is fully
    reflected.  ``submitted``: the newest batch sequence the queue had
    accepted when this epoch's drain was planned (edges from batches in
    (watermark, submitted] may be partially applied).
    ``pending_updates`` / ``pending_groups``: coalesced edges and
    level-1 groups still queued behind this epoch.
    """

    watermark: int = 0
    submitted: int = 0
    pending_updates: int = 0
    pending_groups: Tuple[int, ...] = ()

    @property
    def complete(self) -> bool:
        return (self.pending_updates == 0 and not self.pending_groups
                and self.watermark >= self.submitted)

    @property
    def lag_batches(self) -> int:
        return max(0, self.submitted - self.watermark)

    def as_record(self) -> dict:
        return {
            "watermark": self.watermark,
            "submitted": self.submitted,
            "lag_batches": self.lag_batches,
            "pending_updates": self.pending_updates,
            "pending_groups": len(self.pending_groups),
            "complete": self.complete,
        }


#: the descriptor a freshly built (never refreshed) engine publishes
FRESH = Staleness()


class UpdateQueue:
    """Update-coalescing queue.

    One slot per undirected edge; a later submit of the same edge
    overwrites the earlier weight (only the newest weight can matter —
    the pipeline serves exact distances per epoch, not history).
    ``submit`` returns the batch sequence number for staleness
    accounting; ``take`` atomically drains the pool.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: dict = {}
        self.submitted = 0

    def submit(self, u, v, w) -> int:
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        w = np.asarray(w, np.float64)
        lo = np.minimum(u, v)
        hi = np.maximum(u, v)
        with self._lock:
            for a, b, x in zip(lo, hi, w):
                self._pending[(int(a), int(b))] = float(x)
            self.submitted += 1
            return self.submitted

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """-> (u, v, w, submitted): the pooled edges and the newest
        batch sequence they cover, atomically."""
        with self._lock:
            items = self._pending
            self._pending = {}
            sub = self.submitted
        if not items:
            e = np.empty(0, np.int64)
            return e, e.copy(), np.empty(0, np.float64), sub
        keys = np.asarray(list(items.keys()), np.int64).reshape(-1, 2)
        w = np.asarray(list(items.values()), np.float64)
        return keys[:, 0], keys[:, 1], w, sub


class RefreshPipeline:
    """Traffic-prioritized staged refresh over an EpochedEngine.

    ``traffic``: optional zero-arg callable returning per-fragment
    serving counts (a serving runtime's frag_traffic); the busiest groups
    re-close first so hot queries see fresh weights earliest.  Without
    it, groups order by their pending-edge count (most dirt first).
    ``max_items``: cap on work items per drain — the lowest-priority
    tail merges into one item so epoch churn stays bounded.

    ``plan`` stages the queue into work items; ``step`` applies one
    item (one intermediate epoch); ``drain`` runs plan + steps to
    completion.  Serving never waits on the whole pool: between steps
    the engine publishes a consistent epoch tagged with how far behind
    it is.
    """

    def __init__(self, engine, *,
                 traffic: Optional[Callable[[], np.ndarray]] = None,
                 max_items: int = 8) -> None:
        self.engine = engine
        self.queue = UpdateQueue()
        self.traffic = traffic
        self.max_items = max(1, int(max_items))
        self.watermark = 0
        self._lock = threading.Lock()
        self._items: List[tuple] = []
        self._submitted_at_plan = 0

    # ---- update intake --------------------------------------------------
    def submit(self, u, v, w) -> int:
        """Queue a weight-update batch; returns its sequence number."""
        return self.queue.submit(u, v, w)

    # ---- work-item planning ---------------------------------------------
    def _owner_group(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Level-1 group owning each edge's re-close work: piece edges
        route to the piece agent's fragment, same-fragment edges to
        that fragment, cross-fragment (E_B) edges to the
        higher-numbered endpoint fragment; fragments then map through
        ``sf_of_frag`` when the plan is hierarchical (each fragment IS
        the group on dense plans)."""
        plan = self.engine.plan
        gu, gv = plan.piece_gid[u], plan.piece_gid[v]
        gid = np.where(gu >= 0, gu, gv)
        agent_frag = plan.frag_of[
            plan.piece_agent[np.clip(gid, 0, None)]]
        frag = np.where(gid >= 0, agent_frag,
                        np.maximum(plan.frag_of[u], plan.frag_of[v]))
        frag = np.clip(frag, 0, None).astype(np.int64)
        if plan.hier:
            return plan.hier[0].sf_of_frag[frag].astype(np.int64)
        return frag

    def plan(self) -> int:
        """Stage the queued pool into prioritized work items; no-op if
        items from a previous plan are still pending.  Returns the
        number of pending items."""
        with self._lock:
            if self._items:
                return len(self._items)
            u, v, w, sub = self.queue.take()
            self._submitted_at_plan = sub
            if u.size == 0:
                return 0
            grp = self._owner_group(u, v)
            groups = np.unique(grp)
            weight = np.zeros(groups.size, np.float64)
            if self.traffic is not None:
                per_frag = np.asarray(self.traffic(), np.float64)
                plan = self.engine.plan
                frag2grp = (plan.hier[0].sf_of_frag[:plan.k]
                            if plan.hier else np.arange(plan.k))
                for gi, gval in enumerate(groups):
                    weight[gi] = per_frag[
                        np.asarray(frag2grp) == gval].sum()
            else:
                for gi, gval in enumerate(groups):
                    weight[gi] = float((grp == gval).sum())
            # busiest first; group id breaks ties deterministically
            order = np.lexsort((groups, -weight))
            ordered = groups[order]
            head = ordered[:self.max_items - 1]
            tail = ordered[self.max_items - 1:]
            chunks = [np.asarray([g]) for g in head]
            if tail.size:
                chunks.append(tail)
            for gs in chunks:
                sel = np.isin(grp, gs)
                self._items.append(
                    (tuple(int(g) for g in gs),
                     (u[sel], v[sel], w[sel])))
            return len(self._items)

    # ---- execution ------------------------------------------------------
    def step(self):
        """Apply ONE planned work item and publish its epoch (tagged
        with what is still pending).  Returns the RefreshStats of the
        applied item, or None when nothing is planned."""
        with self._lock:
            if not self._items:
                return None
            item = self._items.pop(0)
            _groups, (u, v, w) = item
            rest = self._items
            # count BOTH the planned remainder and anything submitted
            # to the queue since this plan — a batch arriving mid-drain
            # must keep the published descriptor incomplete
            pending_updates = sum(it[1][0].size for it in rest) \
                + len(self.queue)
            pending_groups = tuple(
                g for it in rest for g in it[0])
            last = not rest
            sub = self._submitted_at_plan
            desc = Staleness(
                watermark=sub if last else self.watermark,
                submitted=max(sub, self.queue.submitted),
                pending_updates=int(pending_updates),
                pending_groups=pending_groups)
        try:
            with trace.span("refresh.item", groups=len(_groups),
                            n_updates=int(u.size),
                            pending=int(pending_updates)):
                stats = self.engine.apply_updates(u, v, w,
                                                  staleness=desc)
        except BaseException:
            # the engine rolled its caches back and published nothing:
            # put the item back so the pool is never silently dropped
            with self._lock:
                self._items.insert(0, item)
            raise
        if last:
            with self._lock:
                self.watermark = sub
        return stats

    def drain(self) -> list:
        """Plan the queued pool and apply every work item in priority
        order; returns the per-item RefreshStats list."""
        stats = []
        self.plan()
        while True:
            st = self.step()
            if st is None:
                break
            stats.append(st)
        return stats

    def pending_items(self) -> int:
        with self._lock:
            return len(self._items)
