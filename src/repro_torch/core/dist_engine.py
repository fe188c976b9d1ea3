"""Query planner: the host-side front end of the port's serve path.

Port of ``repro/core/dist_engine.py:QueryPlanner`` for dense-overlay
indices.  It buckets each incoming batch by case (same-DRA /
same-fragment / cross-fragment) and runs one program per bucket, so
same-DRA queries never pay for the SUPER combine and cross-fragment
queries never touch the piece tables.  Each bucket is padded to a power
of two with (0, 0) filler queries, exactly as the reference pads, so a
bucket runs at one of O(log batch) shapes.

Owned invariant: ``plan()``'s buckets cover every query exactly once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import padding
from .device_engine import DeviceIndex, serve_cross, serve_same_dra

_pad_pow2 = padding.pad_pow2


class QueryPlanner:
    """Bucket a query batch by case and dispatch per-case programs on
    the index's device.  ``force`` and ``layout`` pass through to the
    cross-fragment programs (``device_engine._combine_mid``)."""

    CASES = ("same_dra", "same_frag", "cross_frag")

    def __init__(self, dix: DeviceIndex, *, force=None, layout=None):
        self._fns = {
            "same_dra": serve_same_dra,
            "same_frag": functools.partial(
                serve_cross, with_local=True, force=force, layout=layout),
            "cross_frag": functools.partial(
                serve_cross, with_local=False, force=force, layout=layout),
        }
        self.last_counts: dict = {}
        self.set_index(dix)

    def set_index(self, dix: DeviceIndex) -> None:
        """Serve from ``dix``; ``plan`` buckets with host copies of its
        membership maps, taken once here."""
        self.dix = dix
        self._agent_of = dix.agent_of.cpu().numpy()
        self._frag_of = dix.frag_of.cpu().numpy()

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
        for fn in self._fns.values():
            for size in self.bucket_sizes(batch_size):
                fn(self.dix, z[:size], z[:size])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def plan(self, s: np.ndarray, t: np.ndarray) -> dict:
        """-> {case: index array} partition of the batch."""
        us, ut = self._agent_of[s], self._agent_of[t]
        fs, ft = self._frag_of[us], self._frag_of[ut]
        case1 = us == ut
        case2 = ~case1 & (fs == ft)
        case3 = ~case1 & ~case2
        return {
            "same_dra": np.nonzero(case1)[0],
            "same_frag": np.nonzero(case2)[0],
            "cross_frag": np.nonzero(case3)[0],
        }

    def _dispatch(self, s, t, out) -> None:
        """Partition (s, t), pad each bucket to a power of two with
        (0, 0) filler queries, run its sub-program on the index's
        device and scatter the answers into ``out``."""
        dix = self.dix
        plan = self.plan(s, t)
        self.last_counts = {c: int(ix.size) for c, ix in plan.items()}
        for case, idx in plan.items():
            if idx.size == 0:
                continue
            m = _pad_pow2(idx.size)
            sp = np.zeros(m, np.int64)
            tp = np.zeros(m, np.int64)
            sp[:idx.size] = s[idx]
            tp[:idx.size] = t[idx]
            res = self._fns[case](dix, torch.from_numpy(sp).to(dix.device),
                                  torch.from_numpy(tp).to(dix.device))
            out[idx] = res.cpu().numpy()[:idx.size]

    def __call__(self, s, t) -> np.ndarray:
        return self.query(s, t)

    def query(self, s, t) -> np.ndarray:
        """Planner-bucketed batched distances (float32 on the host)."""
        s = np.asarray(s, np.int64)
        t = np.asarray(t, np.int64)
        out = np.full(s.shape, np.inf, np.float32)
        self._dispatch(s, t, out)
        return out
