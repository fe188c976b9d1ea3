"""Gathered-row tropical products: the CUDA kernels' Python wrappers.

``csrc/gather_minplus.cu`` runs the lifts and the same-group legs of the
overlay hierarchy's distance ladder (``core/device_engine.py``) without
materialising a [rows, slots, columns] block.  A row's slot ids come
from one table row, chosen by the row's unit (``id = tab[unit[r], b]``),
and each slot reads the closure ``M`` [G, m2, N] at (group, pos) =
(``gof[id]``, ``pof[id]``), or (``ugrp[unit[r]]``, ``pof[id]``):

* ``gather_minplus_cuda`` (the store epilogue, the lifts):
  ``out[r, j] = min_b row[r, b] + M[group, pos, c_j]`` with c_j = j or
  ``ctab[cunit[r], j]``;
* ``gather_minplus_twoside_cuda`` (the legs): ``out[q] = min_{i,j}
  row_s[q, i] + [gof[a_i] == gof[b_j]] M[gof[a_i], pof[a_i], pof[b_j]]
  + row_t[q, j]`` with a = tab[us[q]], b = tab[ut[q]], +inf without a
  read where the two slot-0 groups differ.

``plan`` picks the regime from the shapes alone: tiles of rows grouped
by key on the card, but one warp per row where the keys outnumber
``ORDER_KEYS``, or where rows of at most ``WARP_MAX`` slots share a unit
fewer than ``UNIT_ROWS`` times on average (level 1's fragments).  Plain
versions: ``ref.gather_minplus_ref`` and
``ref.gather_minplus_twoside_ref``.  Each wrapper's ``.launches`` counts
its calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .minplus_twoside import _check_tensor

_VP = ctypes.c_void_p
_INT = ctypes.c_int
#: rows of at most this many slots take one warp per row where they
#: share a unit fewer than UNIT_ROWS times on average: a 64-row tile
#: would hold mostly empty slots.  Wider rows take the tiles at any batch
#: size, since one warp a row reads every closure cell once per row (on
#: the H100, 17.6 ms against the tiles' well under 1 ms for 48 rows of
#: 2,056 slots: PERF.md)
WARP_MAX = 128
UNIT_ROWS = 16
#: most keys the counting order takes (GO_KEYS)
ORDER_KEYS = 4096
#: rows per tile of the tiles regime (TA_BQ)
Q_TILE = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather_minplus")
    if lib.gather_minplus_store.argtypes is None:
        lib.gather_minplus_store.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP, _INT, _VP, _VP,
            _INT, _VP, _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _VP]
        lib.gather_minplus_store.restype = _INT
        lib.gather_minplus_twoside.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _VP,
            _INT, _INT, _INT, _VP, _VP, _VP, _VP]
        lib.gather_minplus_twoside.restype = _INT
    return lib


def plan(rows: int, slots: int, units: int, keys: int) -> str:
    """The regime of a product over ``rows`` rows of ``slots`` slots whose
    units come from ``units`` table rows, ordered by ``keys`` keys (the
    store: the units; the twoside: their pairs): "tiles" where the keys
    fit the order and the rows are wider than WARP_MAX or share a unit
    UNIT_ROWS times on average; else "warp"."""
    if keys <= ORDER_KEYS and (slots > WARP_MAX
                               or rows >= UNIT_ROWS * units):
        return "tiles"
    return "warp"


def max_tiles(rows: int, keys: int) -> int:
    """Most 64-row tiles the order can cut ``rows`` rows over ``keys``
    keys into: a key's run of c rows takes ceil(c / 64)."""
    return -(-rows // Q_TILE) + min(keys, rows)


def buffers(regime: str, out_shape, rows: int, keys: int, device) -> tuple:
    """What a wrapper allocates -> (out float32, work): in the warp
    regime ``work`` is None; in the tiles regime one int32 buffer of the
    tile table (2 a tile, first: 8-byte pairs), the order (``rows``) and
    the tile count.  Shared by the CUDA wrappers and ``ops``' meta
    route."""
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if regime == "warp":
        return out, None
    return out, torch.empty(2 * max_tiles(rows, keys) + rows + 1,
                            dtype=torch.int32, device=device)


def store_buffers(rows: int, slots: int, units: int, width: int,
                  cols: bool, device) -> tuple:
    """The store's regime (one warp a row wherever the columns come
    through a table) and ``buffers`` -> (regime, out [rows, width],
    work)."""
    regime = "warp" if cols else plan(rows, slots, units, units)
    return (regime, *buffers(regime, (rows, width), rows, units, device))


def twoside_buffers(q: int, slots: int, units: int, device) -> tuple:
    """The twoside's regime (keyed by unit pairs) and ``buffers`` ->
    (regime, out [q], work)."""
    keys = units * units
    regime = plan(q, slots, units, keys)
    return (regime, *buffers(regime, (q,), q, keys, device))


def _work_ptrs(work, rows: int) -> tuple:
    """(order, tile table, tile count) addresses in ``work``."""
    if work is None:
        return 0, 0, 0
    base = work.data_ptr()
    end = base + 4 * (work.numel() - 1)
    return end - 4 * rows, base, end


def _check(kernel: str, specs) -> None:
    """Raise unless every (name, tensor, dtype, dims) that is not None is
    a contiguous tensor of that type on the first one's CUDA device."""
    dev = specs[0][1].device
    for name, x, dtype, dim in specs:
        if x is not None:
            _check_tensor(kernel, name, x, dev, dtype, dim)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gather_minplus_cuda(row: torch.Tensor, unit: torch.Tensor,
                        tab: torch.Tensor, pof: torch.Tensor,
                        m: torch.Tensor, *, gof=None, ugrp=None, cunit=None,
                        ctab=None) -> torch.Tensor:
    """row [R, K] float32, unit [R] int64, tab [U, K], pof and gof
    [S + 1] (or ugrp [U] in gof's place), int32; m [G, m2, N] float32;
    cunit [R] int64 and ctab [Uc, W] int32 (both, or neither: identity
    columns, W = N); all contiguous on one CUDA device -> out [R, W] with
    out[r, j] = min_b row[r, b] + m[group, pof[id], c_j], id =
    tab[unit[r], b]; array-equal to ``ref.gather_minplus_ref``.  Ids,
    units and groups must lie in range: they stay on the card, so only
    shapes and types are checked.  Launches: one kernel (warp regime),
    or the order and the tiles."""
    kernel = "gather_minplus"
    _check(kernel, (("row", row, torch.float32, 2),
                    ("unit", unit, torch.int64, 1),
                    ("tab", tab, torch.int32, 2),
                    ("pof", pof, torch.int32, 1),
                    ("m", m, torch.float32, 3),
                    ("gof", gof, torch.int32, 1),
                    ("ugrp", ugrp, torch.int32, 1),
                    ("cunit", cunit, torch.int64, 1),
                    ("ctab", ctab, torch.int32, 2)))
    R, K = row.shape
    U = tab.shape[0]
    width = m.shape[2] if ctab is None else ctab.shape[1]
    if ((gof is None) == (ugrp is None) or (cunit is None) != (ctab is None)
            or unit.shape[0] != R or tab.shape[1] != K
            or (ugrp is not None and ugrp.shape[0] != U)
            or (cunit is not None and cunit.shape[0] != R)):
        raise ValueError(
            f"{kernel} kernel: shapes row {tuple(row.shape)}, unit "
            f"{tuple(unit.shape)}, tab {tuple(tab.shape)}, m "
            f"{tuple(m.shape)}, gof/ugrp and cunit/ctab (one of each pair "
            f"for the groups, both or neither for the columns) do not chain")
    regime, out, work = store_buffers(R, K, U, width, ctab is not None,
                                      row.device)
    perm, tiles, nt = _work_ptrs(work, R)
    vec = width % 4 == 0 and m.data_ptr() % 16 == 0
    ptr = [0 if x is None else x.data_ptr()
           for x in (row, unit, tab, gof, ugrp, pof, m, cunit, ctab)]
    with torch.cuda.device(row.device):
        err = _lib().gather_minplus_store(
            *ptr[:6], K, m.shape[1], ptr[6], m.shape[2], ptr[7], ptr[8],
            width, out.data_ptr(), R, regime == "tiles", U,
            max_tiles(R, U), vec, perm, tiles, nt, _stream(row.device))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    gather_minplus_cuda.launches += 1
    return out


gather_minplus_cuda.launches = 0


def gather_minplus_twoside_cuda(row_s: torch.Tensor, unit_s: torch.Tensor,
                                row_t: torch.Tensor, unit_t: torch.Tensor,
                                tab: torch.Tensor, gof: torch.Tensor,
                                pof: torch.Tensor, m: torch.Tensor
                                ) -> torch.Tensor:
    """row_s, row_t [Q, K] float32, unit_s, unit_t [Q] int64, tab [U, K],
    gof, pof [S + 1] int32, m [G, m2, m2] float32, all contiguous on one
    CUDA device -> out [Q]: the same-group twoside product (module
    docstring), +inf where the slot-0 groups of tab[unit_s[q]] and
    tab[unit_t[q]] differ; array-equal to ``ref.gather_minplus_twoside_ref``
    where every slot with a finite row entry lies in its side's slot-0
    group (the hierarchy's rows do).  Launches: one kernel (warp regime),
    or the order and the tiles."""
    kernel = "gather_minplus_twoside"
    _check(kernel, (("row_s", row_s, torch.float32, 2),
                    ("unit_s", unit_s, torch.int64, 1),
                    ("row_t", row_t, torch.float32, 2),
                    ("unit_t", unit_t, torch.int64, 1),
                    ("tab", tab, torch.int32, 2),
                    ("gof", gof, torch.int32, 1),
                    ("pof", pof, torch.int32, 1),
                    ("m", m, torch.float32, 3)))
    Q, K = row_s.shape
    U = tab.shape[0]
    if (row_t.shape != (Q, K) or unit_s.shape[0] != Q
            or unit_t.shape[0] != Q or tab.shape[1] != K
            or m.shape[1] != m.shape[2]):
        raise ValueError(
            f"{kernel} kernel: shapes row_s {tuple(row_s.shape)}, row_t "
            f"{tuple(row_t.shape)}, units {tuple(unit_s.shape)} "
            f"{tuple(unit_t.shape)}, tab {tuple(tab.shape)}, m "
            f"{tuple(m.shape)} do not chain")
    regime, out, work = twoside_buffers(Q, K, U, row_s.device)
    perm, tiles, nt = _work_ptrs(work, Q)
    with torch.cuda.device(row_s.device):
        err = _lib().gather_minplus_twoside(
            row_s.data_ptr(), unit_s.data_ptr(), row_t.data_ptr(),
            unit_t.data_ptr(), tab.data_ptr(), gof.data_ptr(),
            pof.data_ptr(), K, m.shape[1], U, m.data_ptr(), out.data_ptr(),
            Q, regime == "tiles", max_tiles(Q, U * U), perm, tiles, nt,
            _stream(row_s.device))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    gather_minplus_twoside_cuda.launches += 1
    return out


gather_minplus_twoside_cuda.launches = 0
