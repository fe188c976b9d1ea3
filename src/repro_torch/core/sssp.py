"""Batched multi-source shortest paths on the device: Bellman-Ford in
torch.

Port of ``repro/core/sssp.py``.  The reference relaxes an edge list in
dense sweeps, one ``segment_min`` per sweep under ``lax.while_loop``.
That is not a Pallas kernel, and the port runs it as plain torch: one
sweep gathers ``dist[:, src] + w`` into an [S, E] candidate block and
min-reduces it into ``dist`` over the flat ids ``dst + s*n`` with
``scatter_reduce_(..., "amin")``; a host loop repeats the sweep until a
fixpoint or ``max_iters`` sweeps.  S sources relax at once, in chunks of
sources whose candidate block stays under ``CHUNK_BYTES``.

All functions take *directed* edge arrays; undirected graphs pass each
edge twice.  +inf marks unreachable; padding edges can use src=dst=0,
w=+inf (they never relax anything).  With integer weights every sum is
exact in float32, so the result is independent of the order of the
min-reduction and equal to the reference's.
"""
from __future__ import annotations

import torch

#: bytes a chunk's working set may take (read at call time): per
#: (source, edge) cell the float32 candidate and the int64 flat id
#: (12 bytes)
CHUNK_BYTES = 1 << 30
_CELL_BYTES = 12
#: sweeps between two fixpoint tests: each test waits for the device, and
#: a sweep past the fixpoint changes nothing
CHECK_EVERY = 4


def _sweeps(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
            dist: torch.Tensor, n: int, max_iters: int) -> torch.Tensor:
    """Relax one chunk of sources [c, n] to its fixpoint, or for at most
    ``max_iters`` sweeps."""
    c = dist.shape[0]
    flat = (dst[None, :] + torch.arange(c, device=dist.device)[:, None] * n
            ).reshape(-1)
    it = 0
    while it < max_iters:
        before = dist
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            cand = dist[:, src].add_(w).reshape(-1)
            dist = dist.reshape(-1).scatter_reduce(
                0, flat, cand, "amin", include_self=True).reshape(c, n)
            it += 1
        # min-relaxation never raises a value: no change over the last
        # sweeps means no change in any of them
        if torch.equal(dist, before):
            break
    return dist


def bellman_ford(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 init_dist: torch.Tensor, *, n: int,
                 max_iters: int | None = None) -> torch.Tensor:
    """Batched BF: init_dist [S, n] -> fixpoint distances [S, n], on
    ``init_dist``'s device.

    One sweep: dist[s, v] <- min(dist[s, v],
                                 min_{(u,v,w) in E} dist[s, u] + w).
    Sources relax in chunks of rows of at most ``CHUNK_BYTES`` of
    candidate cells (at least one row), each chunk to its own fixpoint
    (``max_iters`` sweeps at most, default n: the longest simple path).
    """
    s_dim = init_dist.shape[0]
    if max_iters is None:
        max_iters = n
    dev = init_dist.device
    src = src.to(dev, torch.long)
    dst = dst.to(dev, torch.long)
    w = w.to(dev, torch.float32)
    if s_dim == 0:
        return init_dist.clone()
    rows = max(1, CHUNK_BYTES // (_CELL_BYTES * max(1, src.numel())))
    return torch.cat([_sweeps(src, dst, w, init_dist[i:i + rows], n,
                              max_iters)
                      for i in range(0, s_dim, rows)])


def sources_init(sources: torch.Tensor, n: int) -> torch.Tensor:
    """[S, n] init matrix on ``sources``' device: 0 at each source,
    +inf elsewhere."""
    s_dim = sources.shape[0]
    init = torch.full((s_dim, n), float("inf"), dtype=torch.float32,
                      device=sources.device)
    init[torch.arange(s_dim, device=sources.device), sources.long()] = 0.0
    return init


def apsp_from_sources(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                      sources: torch.Tensor, *, n: int) -> torch.Tensor:
    """Distances from each of ``sources`` to every node: [S, n], on
    ``sources``' device."""
    return bellman_ford(src, dst, w, sources_init(sources, n), n=n)


# ---------------------------------------------------------------------------
# A measured negative result worth keeping (copied from the reference's
# src/repro/core/sssp.py:78-92, DESIGN.md §9; its times are the
# reference's, on the CPU through XLA): warm-starting
# the SUPER overlay refresh through this BF — init = the old d_super,
# valid whenever no weight increased, since min-relaxation only lowers
# values — was implemented and benchmarked for the incremental-refresh
# path, and LOST to simply re-closing the dense overlay with the
# blocked FW kernel.  Two independent reasons, both structural:
#   * the segment_min sweep above is scatter-bound on CPU-XLA (~750ms
#     per sweep at S=625/13k edges, x ~28 sweeps from scratch), and a
#     warm init still needs several sweeps;
#   * a *dense* warm sweep min(d, d (x) M) costs S^3 — i.e. one sweep
#     already costs as much as the entire FW closure (~60ms at S=625),
#     so warm-starting can never come out ahead on a clique-dense
#     overlay.
# The edge-list BF above remains the right tool for large sparse
# inputs (it is what the sharded offline build uses); the overlay
# refresh lives in device_engine.super_stage.
# ---------------------------------------------------------------------------
