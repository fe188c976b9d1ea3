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


def scatter_rows(row: torch.Tensor, ids: torch.Tensor, width: int
                 ) -> torch.Tensor:
    """Scatter-min compact rows [q, m] at column ids [q, m] into dense
    [q, width] rows (+inf elsewhere)."""
    out = torch.full((row.shape[0], width), float("inf"), dtype=row.dtype,
                     device=row.device)
    return out.scatter_reduce_(1, ids.long(), row, "amin")


def minplus_twoside_grouped_ref(row_s: torch.Tensor, gs: torch.Tensor,
                                tab_s: torch.Tensor, d: torch.Tensor,
                                row_t: torch.Tensor, gt: torch.Tensor,
                                tab_t: torch.Tensor) -> torch.Tensor:
    """out[q] = min_{i,j} row_s[q,i] + d[tab_s[gs[q],i], tab_t[gt[q],j]]
    + row_t[q,j]: each compact row scattered at its ids (scatter-min, so
    duplicate ids keep their smaller entry), then the dense
    ``minplus_twoside_ref``, which is what the serve path computed
    before it contracted compact rows."""
    gs, gt = gs.long(), gt.long()
    return minplus_twoside_ref(scatter_rows(row_s, tab_s[gs], d.shape[0]),
                               d,
                               scatter_rows(row_t, tab_t[gt], d.shape[1]))


def minplus_twoside_grouped_warp_ref(row_s: torch.Tensor, gs: torch.Tensor,
                                     tab_s: torch.Tensor, d: torch.Tensor,
                                     row_t: torch.Tensor, gt: torch.Tensor,
                                     tab_t: torch.Tensor) -> torch.Tensor:
    """The grouped kernel's warp regime in plain torch, for the CPU
    tests: per query, acc[j] = min_i row_s[i] + d[ids_s[i], ids_t[j]]
    over its own gathered ms x mt block of d, then min_j acc + row_t."""
    ids_s, ids_t = tab_s[gs.long()].long(), tab_t[gt.long()].long()
    blk = d[ids_s[:, :, None], ids_t[:, None, :]]          # [q, ms, mt]
    return ((row_s[:, :, None] + blk).amin(dim=1) + row_t).amin(dim=1)


def minplus_twoside_grouped_split_ref(row_s: torch.Tensor, gs: torch.Tensor,
                                      tab_s: torch.Tensor, d: torch.Tensor,
                                      row_t: torch.Tensor, gt: torch.Tensor,
                                      tab_t: torch.Tensor, *, splits: int,
                                      order: bool = True, q_tile: int = 64,
                                      y_tile: int = 64, x_tile: int = 32
                                      ) -> torch.Tensor:
    """The grouped kernel's tiles regime in plain torch, for the CPU
    tests: array-equal to ``minplus_twoside_grouped_ref``.

    With ``order`` the queries are grouped by the key gs * Gt + gt (the
    kernel's counting order leaves the order within a key free; this
    model keeps it), else they keep theirs; each tile of ``q_tile``
    queries is cut into segments (runs) of equal (gs, gt),
    and for each x split (contiguous runs of whole x tiles) every
    segment contracts the whole tile's rows, the other segments' queries
    as +inf, against its pair's gathered d block into one accumulator.
    Each (y tile, split) then writes one partial per query at its
    original index, and the finish takes the min over the partials."""
    q, ms = row_s.shape
    mt = row_t.shape[1]
    gs, gt = gs.long(), gt.long()
    perm = (torch.argsort(gt + tab_t.shape[0] * gs, stable=True) if order
            else torch.arange(q))
    per = max(1, -(-(-(-ms // x_tile)) // splits)) * x_tile
    ytiles = -(-mt // y_tile)
    inf = float("inf")
    part = torch.full((q, ytiles * splits), inf, dtype=row_s.dtype)
    for q0 in range(0, q, q_tile):
        idx = perm[q0:q0 + q_tile]
        pair = torch.stack([gs[idx], gt[idx]], 1)
        starts = [0] + [i for i in range(1, idx.numel())
                        if not torch.equal(pair[i], pair[i - 1])]
        bounds = list(zip(starts, starts[1:] + [idx.numel()]))
        for s, x0 in enumerate(range(0, max(ms, 1), per)):
            acc = torch.full((idx.numel(), mt), inf, dtype=row_s.dtype)
            for a, b in bounds:
                xs = tab_s[gs[idx[a]], x0:x0 + per].long()
                blk = d[xs[:, None], tab_t[gt[idx[a]]].long()[None, :]]
                rows = torch.full((idx.numel(), xs.numel()), inf,
                                  dtype=row_s.dtype)
                rows[a:b] = row_s[idx[a:b], x0:x0 + per]
                acc = torch.minimum(acc, (rows[:, :, None]
                                          + blk[None]).amin(dim=1))
            v = acc + row_t[idx]
            for yt in range(ytiles):
                part[idx, yt * splits + s] = v[:, yt * y_tile:
                                               (yt + 1) * y_tile].amin(dim=1)
    return part.amin(dim=1)


def _slots(unit: torch.Tensor, tab: torch.Tensor, pof: torch.Tensor,
           gof=None, ugrp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(group, pos) [R, K] int64 of each row's slots, id = tab[unit[r],
    b]: (gof[id], pof[id]), or (ugrp[unit[r]], pof[id])."""
    unit = unit.long()
    ids = tab[unit].long()
    pos = pof[ids].long()
    if ugrp is None:
        return gof[ids].long(), pos
    return ugrp[unit].long()[:, None].expand_as(pos), pos


def gather_minplus_ref(row: torch.Tensor, unit: torch.Tensor,
                       tab: torch.Tensor, pof: torch.Tensor,
                       m: torch.Tensor, *, gof=None, ugrp=None, cunit=None,
                       ctab=None, chunk: int = 8) -> torch.Tensor:
    """out[r, j] = min_b row[r, b] + m[group_b, pos_b, c_j] (``_slots``;
    c_j = j, or ctab[cunit[r], j]), chunked over b so the peak
    intermediate is [R, chunk, W]: the serve programs' lifts as chunked
    gathers, which the chunk width only regroups."""
    grp, pos = _slots(unit, tab, pof, gof, ugrp)
    cols = None if ctab is None else ctab[cunit.long()].long()
    width = m.shape[2] if cols is None else cols.shape[1]
    acc = torch.full((row.shape[0], width), float("inf"), dtype=row.dtype,
                     device=row.device)
    for i in range(0, row.shape[1], chunk):
        g_c, p_c = grp[:, i:i + chunk], pos[:, i:i + chunk]
        if cols is None:
            blk = m[g_c, p_c]                               # [R, c, W]
        else:
            blk = m[g_c[:, :, None], p_c[:, :, None], cols[:, None, :]]
        acc = torch.minimum(acc, (row[:, i:i + chunk, None] + blk).amin(1))
    return acc


def gather_minplus_twoside_ref(row_s: torch.Tensor, unit_s: torch.Tensor,
                               row_t: torch.Tensor, unit_t: torch.Tensor,
                               tab: torch.Tensor, gof: torch.Tensor,
                               pof: torch.Tensor, m: torch.Tensor, *,
                               chunk: int = 8) -> torch.Tensor:
    """out[q] = min over slot pairs (i, j) in the SAME group of
    row_s[q, i] + m[g_i, pos_i, pos_j] + row_t[q, j], the slots those of
    tab[unit_s[q]] and tab[unit_t[q]] (``_slots``), chunked over i so the
    peak intermediate is [q, chunk, K]: the hierarchy's same-group leg."""
    grp_s, pos_s = _slots(unit_s, tab, pof, gof)
    grp_t, pos_t = _slots(unit_t, tab, pof, gof)
    acc = torch.full(row_t.shape, float("inf"), dtype=row_s.dtype,
                     device=row_s.device)
    for i in range(0, row_s.shape[1], chunk):
        g_c, p_c = grp_s[:, i:i + chunk, None], pos_s[:, i:i + chunk, None]
        blk = m[g_c, p_c, pos_t[:, None, :]]                # [q, c, K]
        same = g_c == grp_t[:, None, :]
        cand = torch.where(same, row_s[:, i:i + chunk, None] + blk,
                           float("inf"))
        acc = torch.minimum(acc, cand.amin(dim=1))
    return (acc + row_t).amin(dim=1)


def _by_key(keys: torch.Tensor, q_tile: int) -> list:
    """The tiles regimes' order: the rows with a key (>= 0) grouped by
    key, each key's run cut into tiles of at most ``q_tile`` rows."""
    tiles = []
    for k in torch.unique(keys[keys >= 0]).tolist():
        rows = torch.nonzero(keys == k)[:, 0]
        tiles += [rows[i:i + q_tile] for i in range(0, rows.numel(), q_tile)]
    return tiles


def gather_minplus_model(row, unit, tab, pof, m, *, gof=None, ugrp=None,
                         q_tile: int = 64, x_tile: int = 32
                         ) -> torch.Tensor:
    """The store kernel's tiles schedule in plain torch, for the CPU
    tests (identity columns): the rows grouped by unit in tiles of
    ``q_tile``; each tile walks the slots ``x_tile`` at a time, skips a
    slot tile whose rows are all +inf, and contracts the rest against its
    unit's closure rows, gathered once for the tile."""
    R, K = row.shape
    inf = float("inf")
    out = torch.full((R, m.shape[2]), inf, dtype=row.dtype)
    for rows in _by_key(unit.long(), q_tile):
        grp, pos = _slots(unit[rows[:1]], tab, pof, gof, ugrp)
        acc = out[rows]
        for x0 in range(0, K, x_tile):
            rt = row[rows, x0:x0 + x_tile]
            if torch.isinf(rt).all():
                continue
            blk = m[grp[0, x0:x0 + x_tile], pos[0, x0:x0 + x_tile]]
            acc = torch.minimum(acc, (rt[:, :, None] + blk[None]).amin(1))
        out[rows] = acc
    return out


def gather_minplus_twoside_model(row_s, unit_s, row_t, unit_t, tab, gof,
                                 pof, m, *, q_tile: int = 64,
                                 x_tile: int = 32) -> torch.Tensor:
    """The twoside kernel's schedule in plain torch, for the CPU tests:
    +inf, without reading ``m``, for the queries whose two slot-0 groups
    differ; the others grouped by (unit_s, unit_t) in tiles of
    ``q_tile`` (1: the warp regime's one query at a time), each tile's
    closure block gathered once with the same-group mask applied where it
    is staged (+inf in the cells of two groups), all-+inf slot tiles
    skipped, then + row_t and the min over the columns."""
    Q, K = row_s.shape
    inf = float("inf")
    us, ut = unit_s.long(), unit_t.long()
    g0 = gof[tab[:, 0].long()]
    keys = torch.where(g0[us] == g0[ut], us * tab.shape[0] + ut, -1)
    out = torch.full((Q,), inf, dtype=row_s.dtype)
    for rows in _by_key(keys, q_tile):
        grp_s, pos_s = _slots(us[rows[:1]], tab, pof, gof)
        grp_t, pos_t = _slots(ut[rows[:1]], tab, pof, gof)
        blk = torch.where(grp_s[0, :, None] == grp_t[0, None, :],
                          m[grp_s[0, :, None], pos_s[0, :, None],
                            pos_t[0, None, :]], inf)
        acc = torch.full((rows.numel(), K), inf, dtype=row_s.dtype)
        for x0 in range(0, K, x_tile):
            rt = row_s[rows, x0:x0 + x_tile]
            if torch.isinf(rt).all():
                continue
            acc = torch.minimum(acc, (rt[:, :, None]
                                      + blk[None, x0:x0 + x_tile]).amin(1))
        out[rows] = (acc + row_t[rows]).amin(dim=1)
    return out


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


def label_merge_rows_ref(rows: torch.Tensor, ids_s: torch.Tensor,
                         ids_t: torch.Tensor) -> torch.Tensor:
    """out[i] = min_j rows[ids_s[i], j] + rows[ids_t[i], j]: the two
    label rows gathered, then ``label_merge_ref``."""
    return label_merge_ref(rows[ids_s.long()], rows[ids_t.long()])


def minplus_ref(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 16
                ) -> torch.Tensor:
    """C[i, j] = min_k A[i, k] + B[k, j] (tropical GEMM), over the last
    two dimensions: A [..., m, k], B [..., k, n], leading (batch)
    dimensions broadcast.

    k-chunked so the peak intermediate is [..., m, chunk, n]; min does
    not depend on order, so the result equals the unchunked oracle.
    """
    m, k = a.shape[-2:]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = torch.full((*lead, m, b.shape[-1]), float("inf"), dtype=a.dtype,
                     device=a.device)
    for i in range(0, k, chunk):
        out = torch.minimum(out, (a[..., :, i:i + chunk, None]
                                  + b[..., None, i:i + chunk, :]
                                  ).amin(dim=-2))
    return out


def minplus_gemv_ref(a: torch.Tensor, b: torch.Tensor, *, strip: int,
                     slices: int) -> torch.Tensor:
    """The ``minplus_gemv`` CUDA kernel's schedule in plain torch, for the
    CPU tests: array-equal to ``minplus_ref``.

    N is cut into strips of ``strip`` columns and K into ``slices``
    k-slices of ceil(K / slices) rows (the last ones short or empty);
    each (k-slice, strip) block writes the partial minimum over its rows
    (+inf for an empty slice), and the combine takes the minimum over a
    strip's k-slices (the kernel folds them through its cluster's shared
    memory)."""
    m, k = a.shape
    n = b.shape[1]
    ks = -(-k // slices)
    inf = torch.full((m, 1), float("inf"), dtype=a.dtype, device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    for c0 in range(0, n, strip):
        parts = []
        for s in range(slices):
            k0, k1 = min(k, s * ks), min(k, s * ks + ks)
            blk = b[k0:k1, c0:c0 + strip]
            parts.append((a[:, k0:k1, None] + blk[None]).amin(dim=1)
                         if k1 > k0 else inf.expand(m, blk.shape[1]))
        out[:, c0:c0 + strip] = torch.stack(parts).amin(dim=0)
    return out


def minplus_accum_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    """min(C, A (x) B)."""
    return torch.minimum(c, minplus_ref(a, b))


def minplus_accum_into_ref(c: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, *, skip_rows=(0, 0),
                           skip_cols=(0, 0)) -> torch.Tensor:
    """The in-place kernel ``minplus_accum_into_cuda`` in plain torch:
    c[i, j] = min(c[i, j], (a (x) b)[i, j]) written into the view c (a
    matrix, or a batch of them with a and b alike), but for rows in
    [skip_rows) and columns in [skip_cols), which keep their values.
    The product is formed before anything is written, which is what the
    kernels' race-free aliasing gives (c may share memory with a and b
    in its skipped cells, and in ``minplus_accum_panels_cuda`` be the
    same window as the panel operand)."""
    new = minplus_accum_ref(c, a, b)
    m, n = c.shape[-2:]
    keep = torch.zeros((m, n), dtype=torch.bool, device=c.device)
    keep[skip_rows[0]:skip_rows[1]] = True
    keep[:, skip_cols[0]:skip_cols[1]] = True
    c.copy_(torch.where(keep, c, new))
    return c


def minplus_accum_panels_ref(row, col, *, skip_cols=(0, 0),
                             skip_rows=(0, 0)) -> None:
    """The two-panel kernel ``minplus_accum_panels_cuda`` in plain torch:
    ``minplus_accum_into_ref`` on the row panel (c, a, b) with its
    skipped columns, then on the column panel with its skipped rows (the
    kernel runs them at once; they write disjoint cells and neither
    writes what the other reads, so the order does not matter)."""
    minplus_accum_into_ref(*row, skip_cols=skip_cols)
    minplus_accum_into_ref(*col, skip_rows=skip_rows)


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
