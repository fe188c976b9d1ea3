"""Plain PyTorch versions of the main path's kernels.

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
