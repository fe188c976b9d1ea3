"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``, with PyTorch's device model in
place of JAX's backend query.  The tensor decides:

  * a CUDA tensor runs the kernel (``force="ref"`` runs the plain
    version instead, so a caller can hold the two against each other on
    the card);
  * a CPU tensor runs the plain version; ``force="kernel"`` on a CPU
    tensor raises, since a CUDA kernel has no CPU or interpret mode;
  * a ``meta`` tensor takes the card's route without a card: each op
    returns, as empty ``meta`` tensors, the outputs the CUDA wrapper
    allocates (its workspace allocated beside them and dropped, as on
    the card), and launches nothing.  The dry runs
    (``launch/dryrun*.py``) count a step's memory this way;
    ``force="ref"`` on ``meta`` runs the plain version instead.

No path falls back from the kernel to the plain version: a kernel that
fails to build or launch raises.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from . import ref as _ref
from . import gather_minplus as _gm
from .floyd_warshall import (blocked_scratch_bytes, dist_out, fw_batch_cuda,
                             fw_batch_next_cuda, fw_blocked, next_buffers,
                             route as fw_route)
from .label_merge import label_merge_cuda, label_merge_rows_cuda, merge_out
from .minplus import (minplus_accum_cuda, minplus_accum_into_cuda,
                      minplus_accum_panels_cuda, minplus_cuda, product_out)
from .minplus_twoside import (argmin_buffers, argmin_outputs,
                              grouped_buffers, minplus_twoside_argmin_cuda,
                              minplus_twoside_cuda,
                              minplus_twoside_grouped_cuda)

Force = Optional[Literal["kernel", "ref"]]


def use_kernel(device: torch.device | str, force: Force = None) -> bool:
    """The dispatch decision for tensors on ``device``: True where the
    card's route runs (a CUDA or a ``meta`` device)."""
    if force not in (None, "kernel", "ref"):
        raise ValueError(f"force must be None, 'kernel' or 'ref': "
                         f"{force!r}")
    if force == "ref":
        return False
    if torch.device(device).type in ("cuda", "meta"):
        return True
    if force == "kernel":
        raise ValueError(f"force='kernel' needs CUDA tensors; got "
                         f"{device} (the CUDA kernels have no CPU mode)")
    return False


def _route(x: torch.Tensor, force: Force) -> str:
    """"kernel", "meta" (the kernel's allocations, nothing launched) or
    "ref" for an op on ``x``'s device."""
    if not use_kernel(x.device, force):
        return "ref"
    return "meta" if x.device.type == "meta" else "kernel"


def fw_batch_next(d: torch.Tensor, *, force: Force = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Witness-carrying batched APSP over [b, n, n] -> (dist, nxt);
    nxt[b, i, j] = first hop of a shortest i -> j path (-1: unreachable
    or diagonal)."""
    r = _route(d, force)
    if r == "meta":
        b, n = d.shape[0], d.shape[-1]
        blocked = fw_route(n)[0] == "fw_next_blocked"
        dist, nxt, _ = next_buffers(
            d, blocked_scratch_bytes(b, n) if blocked else 0)
        return dist, nxt
    if r == "kernel":
        return fw_batch_next_cuda(d)
    return _ref.fw_batch_next_ref(d)


def fw_next(d: torch.Tensor, *, force: Force = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Witness-carrying APSP for a single [n, n] matrix (a batch of one)."""
    dist, nxt = fw_batch_next(d[None], force=force)
    return dist[0], nxt[0]


def minplus_twoside(rows: torch.Tensor, d: torch.Tensor,
                    rowt: torch.Tensor, *, force: Force = None
                    ) -> torch.Tensor:
    """Fused two-sided contraction: out[q] = min_{x,y} rows[q,x]
    + d[x,y] + rowt[q,y], never forming the [q, x, y] cube."""
    r = _route(rows, force)
    if r == "meta":
        return grouped_buffers(rows.shape[0], rows.shape[1], rowt.shape[1],
                               1, 1, rows.device)[3]
    if r == "kernel":
        return minplus_twoside_cuda(rows, d, rowt)
    return _ref.minplus_twoside_ref(rows, d, rowt)


def minplus_twoside_grouped(row_s: torch.Tensor, gs: torch.Tensor,
                            tab_s: torch.Tensor, d: torch.Tensor,
                            row_t: torch.Tensor, gt: torch.Tensor,
                            tab_t: torch.Tensor, *, force: Force = None
                            ) -> torch.Tensor:
    """The twoside contraction of compact rows through their id tables:
    out[q] = min_{i,j} row_s[q,i] + d[tab_s[gs[q],i], tab_t[gt[q],j]]
    + row_t[q,j], equal to scattering each row at its ids and running
    ``minplus_twoside`` on the dense rows."""
    r = _route(row_s, force)
    if r == "meta":
        return grouped_buffers(row_s.shape[0], row_s.shape[1],
                               row_t.shape[1], tab_s.shape[0],
                               tab_t.shape[0], row_s.device)[3]
    if r == "kernel":
        return minplus_twoside_grouped_cuda(row_s, gs, tab_s, d, row_t, gt,
                                            tab_t)
    return _ref.minplus_twoside_grouped_ref(row_s, gs, tab_s, d, row_t, gt,
                                            tab_t)


def gather_minplus(row: torch.Tensor, unit: torch.Tensor,
                   tab: torch.Tensor, pof: torch.Tensor, m: torch.Tensor, *,
                   gof=None, ugrp=None, cunit=None, ctab=None,
                   chunk: int = 8, force: Force = None) -> torch.Tensor:
    """The hierarchy's lift: out[r, j] = min_b row[r, b] + m[group_b,
    pos_b, c_j], slot b of row r being id = tab[unit[r], b] at (gof[id],
    pof[id]) (or (ugrp[unit[r]], pof[id])), c_j = j (or ctab[cunit[r],
    j]); never forming the [R, K, W] block.  ``chunk``: slots a step of
    the plain version (the kernel does not read it)."""
    r = _route(row, force)
    if r == "meta":
        width = m.shape[2] if ctab is None else ctab.shape[1]
        return _gm.store_buffers(*row.shape, tab.shape[0], width,
                                 ctab is not None, row.device)[1]
    if r == "kernel":
        return _gm.gather_minplus_cuda(row, unit, tab, pof, m, gof=gof,
                                       ugrp=ugrp, cunit=cunit, ctab=ctab)
    return _ref.gather_minplus_ref(row, unit, tab, pof, m, gof=gof,
                                   ugrp=ugrp, cunit=cunit, ctab=ctab,
                                   chunk=chunk)


def gather_minplus_twoside(row_s: torch.Tensor, unit_s: torch.Tensor,
                           row_t: torch.Tensor, unit_t: torch.Tensor,
                           tab: torch.Tensor, gof: torch.Tensor,
                           pof: torch.Tensor, m: torch.Tensor, *,
                           chunk: int = 8, force: Force = None
                           ) -> torch.Tensor:
    """The hierarchy's same-group leg: out[q] = min over slot pairs
    (i, j) of one group of row_s[q, i] + m[g_i, pos_i, pos_j] + row_t[q,
    j], the slots those of tab[unit_s[q]] and tab[unit_t[q]].  The kernel
    answers +inf without reading ``m`` where the two slot-0 groups
    differ, which equals the plain version where every slot with a finite
    row entry lies in its side's slot-0 group (the hierarchy's rows do).
    ``chunk``: slots a step of the plain version."""
    r = _route(row_s, force)
    if r == "meta":
        return _gm.twoside_buffers(*row_s.shape, tab.shape[0],
                                   row_s.device)[1]
    if r == "kernel":
        return _gm.gather_minplus_twoside_cuda(row_s, unit_s, row_t, unit_t,
                                               tab, gof, pof, m)
    return _ref.gather_minplus_twoside_ref(row_s, unit_s, row_t, unit_t, tab,
                                           gof, pof, m, chunk=chunk)


def minplus_twoside_argmin(rows: torch.Tensor, d: torch.Tensor,
                           rowt: torch.Tensor, *, force: Force = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Witness-returning twoside contraction -> (out, wx, wy): the
    winning (x, y) pair beside each minimum (the smallest y, then the
    smallest x), -1 where out is +inf."""
    r = _route(rows, force)
    if r == "meta":
        return argmin_outputs(argmin_buffers(rows.shape[0], rows.shape[1],
                                             d.shape[1], rows.device)[3])
    if r == "kernel":
        return minplus_twoside_argmin_cuda(rows, d, rowt)
    return _ref.minplus_twoside_argmin_ref(rows, d, rowt)


def label_merge(labs: torch.Tensor, labt: torch.Tensor, *,
                force: Force = None) -> torch.Tensor:
    """Hub-label merge: out[q] = min_j labs[q, j] + labt[q, j]."""
    r = _route(labs, force)
    if r == "meta":
        return merge_out(labs)
    if r == "kernel":
        return label_merge_cuda(labs, labt)
    return _ref.label_merge_ref(labs, labt)


def label_merge_rows(rows: torch.Tensor, ids_s: torch.Tensor,
                     ids_t: torch.Tensor, *, force: Force = None
                     ) -> torch.Tensor:
    """Hub-label merge through the label table's row ids: out[i] =
    min_j rows[ids_s[i], j] + rows[ids_t[i], j] (rows [H+1, W], ids
    int32 [q]), equal to ``label_merge(rows[ids_s], rows[ids_t])``
    without the two [q, W] gathers."""
    r = _route(rows, force)
    if r == "meta":
        return merge_out(ids_s)
    if r == "kernel":
        return label_merge_rows_cuda(rows, ids_s, ids_t)
    return _ref.label_merge_rows_ref(rows, ids_s, ids_t)


def minplus(a: torch.Tensor, b: torch.Tensor, *, force: Force = None
            ) -> torch.Tensor:
    """Tropical GEMM: C[i, j] = min_k A[i, k] + B[k, j]."""
    r = _route(a, force)
    if r == "meta":
        return product_out(a, b)
    if r == "kernel":
        return minplus_cuda(a, b)
    return _ref.minplus_ref(a, b)


def minplus_accum(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                  force: Force = None) -> torch.Tensor:
    """min(C, A (x) B), in a new tensor."""
    r = _route(a, force)
    if r == "meta":
        return product_out(a, b)
    if r == "kernel":
        return minplus_accum_cuda(c, a, b)
    return _ref.minplus_accum_ref(c, a, b)


def minplus_accum_into(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       *, skip_rows=(0, 0), skip_cols=(0, 0),
                       force: Force = None) -> torch.Tensor:
    """min(C, A (x) B) written into the view C, but for rows in
    [skip_rows) and columns in [skip_cols); on the card A and B may
    share C's memory only in its skipped cells, as in the blocked FW's
    phase 3 (``minplus_accum_into_cuda``)."""
    r = _route(a, force)
    if r == "meta":
        return c                       # in place: nothing allocated
    if r == "kernel":
        return minplus_accum_into_cuda(c, a, b, skip_rows=skip_rows,
                                       skip_cols=skip_cols)
    return _ref.minplus_accum_into_ref(c, a, b, skip_rows=skip_rows,
                                       skip_cols=skip_cols)


def minplus_accum_panels(row, col, *, skip_cols=(0, 0), skip_rows=(0, 0),
                         force: Force = None) -> None:
    """The blocked FW's phase 2 in one call: ``minplus_accum_into`` on the
    row panel ``row`` = (c, a, b) with ``skip_cols`` and on the column
    panel ``col`` with ``skip_rows``, where the row panel's C may be its
    B and the column panel's C its A (``minplus_accum_panels_cuda``)."""
    r = _route(row[0], force)
    if r == "kernel":
        minplus_accum_panels_cuda(row, col, skip_cols=skip_cols,
                                  skip_rows=skip_rows)
    elif r == "ref":                   # meta: in place, nothing allocated
        _ref.minplus_accum_panels_ref(row, col, skip_cols=skip_cols,
                                      skip_rows=skip_rows)


def fw_batch(d: torch.Tensor, *, out: torch.Tensor | None = None,
             force: Force = None) -> torch.Tensor:
    """Distance-only batched APSP over [b, n, n] (diagonal forced to 0),
    into ``out`` when given (which may be ``d``).  On the card (kernel
    3, ``fw_batch_cuda``) in registers up to n = 128, by the batched
    blocked schedule in place on the output above; either way the
    output is all it allocates, as on ``meta``."""
    r = _route(d, force)
    if r == "meta":
        return dist_out(d) if out is None else out
    if r == "kernel":
        return fw_batch_cuda(d, out)
    dist = _ref.fw_batch_ref(d)
    return dist if out is None else out.copy_(dist)


def fw_apsp(d: torch.Tensor, *, block: int | None = None,
            force: Force = None) -> torch.Tensor:
    """APSP for a single [n, n] matrix: on the card the blocked 3-phase
    schedule (``floyd_warshall.fw_blocked``: ``fw_blocked_into`` on one
    padded matrix, the case b = 1 of kernel 3's route above n = 128)
    over kernels ``fw_batch``, ``minplus_accum_panels`` and
    ``minplus_accum_into``, in k-blocks of ``block`` (at most 128 there;
    default ``floyd_warshall.apsp_block(n)``); the single-pivot plain
    version ``fw_ref`` on the CPU (as the reference's CPU path runs)."""
    if use_kernel(d.device, force):
        return fw_blocked(d, block=block, force=force)
    return _ref.fw_ref(d)
