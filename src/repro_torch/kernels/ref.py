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


def fw_batch_next_blocked_ref(d: torch.Tensor, block: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocked schedule of the ``fw_next_blocked`` CUDA kernel, in
    plain torch, for the CPU tests: array-equal to ``fw_batch_next_ref``
    in dist and nxt (the plain version of the function stays that one).

    Per k-block K = [s, e): phases 1+2 run the pivot tile P = D[K, K],
    the row band D[K, :] and the column band D[:, K] serially over
    k in K, each from its state at step k-1, and snapshot column k of the
    column band (C, CN) and row k of the row band (R) at step k.  Phase
    3 updates every other cell with the first strict minimum over k in K
    of C[i, k] + R[k, j], taking CN[i, k] as its first hop (D wins ties).
    Exact because step k never changes row k or column k (diagonal 0,
    nonnegative weights, strict <), so the snapshots are what the serial
    recurrence reads at step k.
    """
    mat, nxt = fw_next_init(d)
    n = d.shape[-1]
    for s in range(0, n, block):
        e = min(s + block, n)
        piv, pivn = mat[:, s:e, s:e], nxt[:, s:e, s:e]
        rowb, rowbn = mat[:, s:e, :], nxt[:, s:e, :]
        colb, colbn = mat[:, :, s:e], nxt[:, :, s:e]
        cs, cns, rs = [], [], []
        for kk in range(e - s):
            cs.append(colb[:, :, kk])
            cns.append(colbn[:, :, kk])
            rs.append(rowb[:, kk, :])
            cand = piv[:, :, kk:kk + 1] + piv[:, kk:kk + 1, :]
            better = cand < piv
            piv2 = torch.where(better, cand, piv)
            pivn2 = torch.where(better, pivn[:, :, kk:kk + 1], pivn)
            cand = piv[:, :, kk:kk + 1] + rowb[:, kk:kk + 1, :]
            better = cand < rowb
            rowb = torch.where(better, cand, rowb)
            rowbn = torch.where(better, pivn[:, :, kk:kk + 1], rowbn)
            cand = colb[:, :, kk:kk + 1] + piv[:, kk:kk + 1, :]
            better = cand < colb
            colb = torch.where(better, cand, colb)
            colbn = torch.where(better, colbn[:, :, kk:kk + 1], colbn)
            piv, pivn = piv2, pivn2
        for c, cn, r in zip(cs, cns, rs):          # phase 3, k ascending
            cand = c[:, :, None] + r[:, None, :]
            better = cand < mat
            mat = torch.where(better, cand, mat)
            nxt = torch.where(better, cn[:, :, None], nxt)
        mat, nxt = mat.clone(), nxt.clone()
        mat[:, s:e, :], nxt[:, s:e, :] = rowb, rowbn
        mat[:, :, s:e], nxt[:, :, s:e] = colb, colbn
        mat[:, s:e, s:e], nxt[:, s:e, s:e] = piv, pivn
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


def _argmin_acc(rows: torch.Tensor, d: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(acc, accx) [q, k2]: acc = min_x rows[q, x] + d[x, y] and accx the
    smallest x at that minimum (-1 where it is +inf), x-chunked."""
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
    return acc, accx


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
    k2 = d.shape[1]
    acc, accx = _argmin_acc(rows, d, chunk)
    tmp = acc + rowt                                   # [q, k2]
    out = tmp.amin(dim=1)
    ycol = torch.arange(k2, dtype=torch.int32, device=rows.device)[None, :]
    wy = torch.where(tmp == out[:, None], ycol, k2).amin(dim=1)
    fin = torch.isfinite(out)
    wy = torch.where(fin, wy, -1)
    wx = torch.where(fin, accx.gather(1, wy.clamp(min=0).long()[:, None])[:, 0],
                     -1)
    return out, wx.to(torch.int32), wy.to(torch.int32)


def minplus_twoside_argmin_split_ref(rows: torch.Tensor, d: torch.Tensor,
                                     rowt: torch.Tensor, *, splits: int,
                                     y_tile: int = 64, x_tile: int = 32
                                     ) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The ``minplus_twoside_argmin`` CUDA kernel's partials and finish,
    in plain torch, for the CPU tests: array-equal to
    ``minplus_twoside_argmin_ref``.

    The x range is cut into ``splits`` contiguous runs of whole x-tiles;
    each (y-tile, split) writes one partial per query: its minimum and
    the packed witness y * k1 + x of the smallest y at it, then that y's
    smallest x inside the split.  The finish takes the minimum over the
    partials and, among those at it, the smallest packed witness: the
    smallest y, then its smallest x, since x ascends within a split and
    the splits are disjoint x ranges."""
    q, k1 = rows.shape
    k2 = d.shape[1]
    tiles = -(-k1 // x_tile)
    per = max(1, -(-tiles // splits)) * x_tile
    ycol = torch.arange(k2, dtype=torch.int64, device=rows.device)
    parts, wits = [], []
    for x0 in range(0, max(k1, 1), per):
        acc, accx = _argmin_acc(rows[:, x0:x0 + per], d[x0:x0 + per],
                                x_tile)
        v = acc + rowt
        for y0 in range(0, k2, y_tile):
            vt = v[:, y0:y0 + y_tile]
            m = vt.amin(dim=1)
            y = torch.where(vt == m[:, None], ycol[y0:y0 + y_tile],
                            k2).amin(dim=1)
            x = x0 + accx.gather(1, y.clamp(max=k2 - 1)[:, None])[:, 0]
            parts.append(m)
            wits.append(y * k1 + x)
    part, wit = torch.stack(parts, 1), torch.stack(wits, 1)
    out = part.amin(dim=1)
    w = torch.where(part == out[:, None], wit,
                    torch.iinfo(torch.int64).max).amin(dim=1)
    fin = torch.isfinite(out)
    k1c = max(k1, 1)
    return (out, torch.where(fin, w % k1c, -1).to(torch.int32),
            torch.where(fin, w // k1c, -1).to(torch.int32))


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
