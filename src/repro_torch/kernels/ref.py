"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro/kernels/ref.py``: the CPU path runs these, the
tests hold them equal to the reference's jnp oracles, and on the card
``ops`` runs them only under ``force="ref"`` so the hand-written kernels
can be compared with them.  Every function is exact on integer-valued
float32 inputs (sums stay below 2**24), so "equal" means array-equal.
"""
from __future__ import annotations

import torch


def fw_next_init(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(diag-zeroed distances, first-hop successor init) for witness FW.

    nxt[..., i, j] = j where (i, j) is a direct edge, -1 elsewhere
    (including the diagonal).  Works on [n, n] and [b, n, n].
    """
    n = d.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    d0 = torch.where(eye, torch.zeros((), dtype=d.dtype, device=d.device),
                     d)
    cols = torch.arange(n, dtype=torch.int32, device=d.device).expand(
        d.shape)
    nxt0 = torch.where(torch.isfinite(d0) & ~eye, cols,
                       torch.full((), -1, dtype=torch.int32,
                                  device=d.device))
    return d0, nxt0


def fw_batch_next_ref(d: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Witness-carrying Floyd-Warshall over a batch [b, n, n].

    Strict-improvement updates in serial pivot order, exactly the
    recurrence of ``repro.kernels.ref.fw_next_ref``: dist is the APSP
    matrix, nxt[b, i, j] the first hop of a shortest i -> j path (-1
    when j is unreachable or i == j).
    """
    mat, nxt = fw_next_init(d)
    for k in range(d.shape[-1]):
        cand = mat[:, :, k:k + 1] + mat[:, k:k + 1, :]
        better = cand < mat
        mat = torch.where(better, cand, mat)
        nxt = torch.where(better, nxt[:, :, k:k + 1], nxt)
    return mat, nxt


def fw_next_ref(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Witness-carrying Floyd-Warshall on one [n, n] matrix."""
    dist, nxt = fw_batch_next_ref(d[None])
    return dist[0], nxt[0]


def minplus_twoside_ref(rows: torch.Tensor, d: torch.Tensor,
                        rowt: torch.Tensor, *, chunk: int = 16
                        ) -> torch.Tensor:
    """out[q] = min_{x,y} rows[q,x] + d[x,y] + rowt[q,y].

    x-chunked so the peak intermediate is [q, chunk, k2], never the
    full [q, k1, k2] cube.
    """
    q, k1 = rows.shape
    acc = torch.full((q, d.shape[1]), float("inf"), dtype=rows.dtype,
                     device=rows.device)
    for i in range(0, k1, chunk):
        cand = (rows[:, i:i + chunk, None]
                + d[None, i:i + chunk, :]).amin(dim=1)
        acc = torch.minimum(acc, cand)
    return (acc + rowt).amin(dim=1)


def minplus_twoside_argmin_ref(rows: torch.Tensor, d: torch.Tensor,
                               rowt: torch.Tensor, *, chunk: int = 16
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Witness-tracking twoside contraction -> (out, wx, wy), int32
    witnesses with out[q] = rows[q, wx] + d[wx, wy] + rowt[q, wy] where
    out[q] is finite and wx = wy = -1 where it is +inf.

    The same x-chunked schedule as ``minplus_twoside_ref``, carrying
    the winning x per (q, y) cell.  Tie rule, which the CUDA kernel
    reproduces: the smallest y among the cells at the minimum, then the
    smallest x for that y (the smallest chunk-local x inside a chunk; a
    later chunk replaces the carried x only on a strict improvement)."""
    q, k1 = rows.shape
    k2 = d.shape[1]
    dev = rows.device
    acc = torch.full((q, k2), float("inf"), dtype=rows.dtype, device=dev)
    accx = torch.full((q, k2), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :, None]
    for i in range(0, k1, chunk):
        cube = rows[:, i:i + chunk, None] + d[None, i:i + chunk, :]
        cand = cube.amin(dim=1)
        hit = cube == cand[:, None, :]
        loc = torch.where(hit, iota[:, :cube.shape[1]], k1).amin(dim=1)
        better = cand < acc
        acc = torch.where(better, cand, acc)
        accx = torch.where(better, i + loc, accx)
    tmp = acc + rowt                                   # [q, k2]
    out = tmp.amin(dim=1)
    ycol = torch.arange(k2, dtype=torch.int32, device=dev)[None, :]
    wy = torch.where(tmp == out[:, None], ycol, k2).amin(dim=1)
    fin = torch.isfinite(out)
    wy = torch.where(fin, wy, -1)
    wx = torch.where(fin, accx.gather(1, wy.clamp(min=0).long()[:, None])[:, 0],
                     -1)
    return out, wx.to(torch.int32), wy.to(torch.int32)


def label_merge_ref(labs: torch.Tensor, labt: torch.Tensor) -> torch.Tensor:
    """out[q] = min_j labs[q, j] + labt[q, j] (hub-label merge)."""
    return (labs + labt).amin(dim=1)


def minplus_ref(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 16
                ) -> torch.Tensor:
    """C[i, j] = min_k A[i, k] + B[k, j] (tropical GEMM).

    k-chunked so the peak intermediate is [m, chunk, n]; min does not
    depend on order, so the result equals the unchunked oracle.
    """
    m, k = a.shape
    out = torch.full((m, b.shape[1]), float("inf"), dtype=a.dtype,
                     device=a.device)
    for i in range(0, k, chunk):
        out = torch.minimum(out, (a[:, i:i + chunk, None]
                                  + b[None, i:i + chunk, :]).amin(dim=1))
    return out


def minplus_accum_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    """min(C, A (x) B)."""
    return torch.minimum(c, minplus_ref(a, b))


def fw_batch_ref(d: torch.Tensor) -> torch.Tensor:
    """Distance-only Floyd-Warshall over a batch [b, n, n]: diagonal
    forced to 0, then the serial pivot recurrence of
    ``repro.kernels.ref.fw_ref``."""
    n = d.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    mat = torch.where(eye, torch.zeros((), dtype=d.dtype, device=d.device),
                      d)
    for k in range(n):
        mat = torch.minimum(mat, mat[:, :, k:k + 1] + mat[:, k:k + 1, :])
    return mat


def fw_ref(d: torch.Tensor) -> torch.Tensor:
    """Floyd-Warshall APSP on one [n, n] matrix (diag forced to 0)."""
    return fw_batch_ref(d[None])[0]
