"""Two-sided tropical contractions: the CUDA kernels' Python wrappers.

Ports of ``repro/kernels/minplus_twoside.py``:

* ``minplus_twoside_pallas``, the distance combine, as the grouped
  kernel ``csrc/minplus_twoside.cu`` (plain version
  ``ref.minplus_twoside_grouped_ref``):

      out[q] = min_{i, j} row_s[q, i] + d[tab_s[gs[q], i], tab_t[gt[q], j]]
                          + row_t[q, j]

  which contracts compact boundary rows through their id tables instead
  of scattering them over the whole closure (``minplus_twoside_cuda``
  runs the dense form min_{x,y} rows + d + rowt as its case of one group
  and identity tables).  ``grouped_plan`` picks the regime from the
  shapes: one warp per query for rows of at most ``WARP_MAX`` entries or
  when queries rarely share a table pair, else tiles over the queries
  grouped by table pair (a counting sort on the card when there are 2
  to ``ORDER_KEYS`` pairs), with x split across blocks until the grid
  holds about ``GROUPED_BLOCKS`` (``grouped_splits``) and the min over
  the partials on the card.
* ``minplus_twoside_argmin_pallas`` (kernel
  ``csrc/minplus_twoside_argmin.cu``, plain version
  ``ref.minplus_twoside_argmin_ref``), which also returns the winning
  (x, y), on dense rows.

Each wrapper's ``.launches`` counts its calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_INT = ctypes.c_int
#: y columns per block (TS_BY, TA_BY in the .cu files): the partials'
#: width is ceil(K2 / Y_TILE)
Y_TILE = 64
#: queries per block and x depth per tile of the tiled kernels (TA_BQ,
#: TA_BX)
Q_TILE = 64
X_TILE = 32
#: two waves of blocks on the card's 132 SMs: below it the witness
#: kernel splits x across blocks
TWO_WAVES = 264
#: blocks the grouped kernel's tiles aim for: four waves of two blocks
#: on each SM (104 registers a thread).  A sweep of splits on the H100
#: (PERF.md) found the time within ~10% of its best from about there;
#: the witness kernel's two-wave rule left up to 1.5x
GROUPED_BLOCKS = 1056
#: rows of at most this many entries always take the grouped kernel's
#: warp-per-query regime
WARP_MAX = 64
#: most table pairs (Gs * Gt) the grouped kernel's counting order takes
#: (TO_KEYS); with more, the queries keep their order
ORDER_KEYS = 4096


def _lib() -> ctypes.CDLL:
    lib = _build.load("minplus_twoside")
    if lib.minplus_twoside_grouped_warp.argtypes is None:
        lib.minplus_twoside_grouped_warp.argtypes = [
            _VP, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _INT, _VP, _INT,
            _VP]
        lib.minplus_twoside_grouped_warp.restype = _INT
        lib.minplus_twoside_grouped_tiles.argtypes = [
            _VP, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _VP, _INT, _INT, _INT,
            _VP, _VP, _VP, _INT, _INT, _VP]
        lib.minplus_twoside_grouped_tiles.restype = _INT
    return lib


def _lib_argmin() -> ctypes.CDLL:
    lib = _build.load("minplus_twoside_argmin")
    if lib.minplus_twoside_argmin.argtypes is None:
        lib.minplus_twoside_argmin.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
            _VP]
        lib.minplus_twoside_argmin.restype = _INT
    return lib


def _check_tensor(kernel: str, name: str, x: torch.Tensor,
                  device: torch.device, dtype: torch.dtype, dim: int
                  ) -> None:
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{kernel} kernel: {name} must be a CUDA tensor "
                         f"on {device}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel} kernel: {name} must be {dtype}, got "
                        f"{x.dtype}")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be contiguous with "
                         f"{dim} dimensions, got {tuple(x.shape)}")


def _check(kernel: str, rows: torch.Tensor, d: torch.Tensor,
           rowt: torch.Tensor) -> tuple[int, int, int]:
    """Raise unless rows [q, k1], d [k1, k2], rowt [q, k2] are contiguous
    float32 matrices on one CUDA device; -> (q, k1, k2)."""
    for name, x in (("rows", rows), ("d", d), ("rowt", rowt)):
        _check_tensor(kernel, name, x, rows.device, torch.float32, 2)
    q, k1 = rows.shape
    if d.shape[0] != k1 or rowt.shape != (q, d.shape[1]):
        raise ValueError(f"{kernel} kernel: shapes {tuple(rows.shape)}, "
                         f"{tuple(d.shape)}, {tuple(rowt.shape)} do not "
                         f"chain")
    return q, k1, d.shape[1]


def grouped_plan(q: int, ms: int, mt: int, gs_rows: int, gt_rows: int
                 ) -> tuple[str, bool, int]:
    """The grouped kernel's launch, from the shapes alone -> (regime,
    order, x-splits): "warp" (one warp per query, one launch) when both
    rows have at most WARP_MAX entries, or when there are more table
    pairs than queries or than ORDER_KEYS (a table row per query, say:
    a 64-query tile would walk up to 64 one-query segments); else
    "tiles", whose queries are first grouped by table pair on the card
    when there are 2 or more pairs, with ``grouped_splits`` over the row
    entries."""
    pairs = gs_rows * gt_rows
    if max(ms, mt) <= WARP_MAX or pairs > min(q, ORDER_KEYS):
        return "warp", False, 1
    return "tiles", pairs > 1, grouped_splits(q, ms, mt)


def grouped_splits(q: int, ms: int, mt: int) -> int:
    """x-splits of the grouped kernel's tiles: runs of whole x-tiles,
    each as long as splitting into k runs makes them, where k (at most
    one per x-tile) brings the (y-tile, q-tile, k) grid to
    GROUPED_BLOCKS; never an empty run."""
    tiles = -(-mt // Y_TILE) * -(-q // Q_TILE)
    xt = max(1, -(-ms // X_TILE))
    per = -(-xt // min(xt, -(-GROUPED_BLOCKS // max(tiles, 1))))
    return -(-xt // per)


def grouped_buffers(q: int, ms: int, mt: int, ns: int, nt: int, device
                    ) -> tuple:
    """The grouped kernel's launch (``grouped_plan``) and what its
    wrapper allocates -> (regime, order, splits, out [q] float32, buf):
    in the warp regime ``out`` alone (``buf`` None); in the tiles regime
    one scratch buffer ``buf``, the order (int64) first, then the
    answers (``out``, a view) and the partials (float32).  Shared by the
    CUDA wrapper and ``ops``' meta route."""
    regime, order, splits = grouped_plan(q, ms, mt, ns, nt)
    if regime == "warp":
        return (regime, order, splits,
                torch.empty(q, dtype=torch.float32, device=device), None)
    parts = -(-mt // Y_TILE) * splits
    buf = torch.empty(4 * q * (3 + parts), dtype=torch.uint8, device=device)
    return regime, order, splits, buf[8 * q:].view(torch.float32)[:q], buf


def _grouped(row_s, gs, tab_s, d, row_t, gt, tab_t) -> torch.Tensor:
    """Launch the grouped kernel; ``gs``/``gt`` None is table row 0 for
    every query, ``tab_s``/``tab_t`` None the identity table."""
    kernel = "minplus_twoside_grouped"
    dev = row_s.device
    for name, x, dtype, dim in (
            ("row_s", row_s, torch.float32, 2), ("d", d, torch.float32, 2),
            ("row_t", row_t, torch.float32, 2),
            ("gs", gs, torch.int64, 1), ("gt", gt, torch.int64, 1),
            ("tab_s", tab_s, torch.int32, 2),
            ("tab_t", tab_t, torch.int32, 2)):
        if x is not None:
            _check_tensor(kernel, name, x, dev, dtype, dim)
    q, ms = row_s.shape
    mt = row_t.shape[1]
    k1, k2 = d.shape
    if (row_t.shape[0] != q
            or any(g is not None and g.shape[0] != q for g in (gs, gt))
            or (tab_s.shape[1] if tab_s is not None else k1) != ms
            or (tab_t.shape[1] if tab_t is not None else k2) != mt):
        raise ValueError(
            f"{kernel} kernel: shapes row_s {tuple(row_s.shape)}, gs "
            f"{None if gs is None else tuple(gs.shape)}, tab_s "
            f"{None if tab_s is None else tuple(tab_s.shape)}, d "
            f"{tuple(d.shape)}, row_t {tuple(row_t.shape)}, gt "
            f"{None if gt is None else tuple(gt.shape)}, tab_t "
            f"{None if tab_t is None else tuple(tab_t.shape)} do not chain")
    ns = 1 if tab_s is None else tab_s.shape[0]
    nt = 1 if tab_t is None else tab_t.shape[0]
    regime, order, splits, out, buf = grouped_buffers(q, ms, mt, ns, nt,
                                                      dev)
    ptr = [0 if x is None else x.data_ptr()
           for x in (row_s, gs, tab_s, d, row_t, gt, tab_t)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if regime == "warp":
            err = _lib().minplus_twoside_grouped_warp(
                ptr[0], ptr[1], ptr[2], ms, ptr[3], k2, ptr[4], ptr[5],
                ptr[6], mt, out.data_ptr(), q, stream)
        else:
            err = _lib().minplus_twoside_grouped_tiles(
                ptr[0], ptr[1], ptr[2], ms, ptr[3], k2, ptr[4], ptr[5],
                ptr[6], mt, nt, ns * nt if order else 1, buf.data_ptr(),
                out.data_ptr() + 4 * q, out.data_ptr(), q, splits, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    return out


def minplus_twoside_grouped_cuda(row_s: torch.Tensor, gs: torch.Tensor,
                                 tab_s: torch.Tensor, d: torch.Tensor,
                                 row_t: torch.Tensor, gt: torch.Tensor,
                                 tab_t: torch.Tensor) -> torch.Tensor:
    """row_s [q, ms], row_t [q, mt], d [k1, k2] (float32), gs, gt [q]
    (int64), tab_s [Gs, ms], tab_t [Gt, mt] (int32 ids into d's rows and
    columns), all contiguous on one CUDA device -> out [q] with
    out[q] = min_{i,j} row_s[q,i] + d[tab_s[gs[q],i], tab_t[gt[q],j]]
    + row_t[q,j]; array-equal to ``ref.minplus_twoside_grouped_ref``.
    Groups and ids must lie in range (gs < Gs, ids < k1; likewise the t
    side): they stay on the card, so the wrapper checks only shapes and
    types, as the serve programs build them in range.
    Launches: the kernel (warp regime), or the grouping order (when
    ``grouped_plan`` says so), the kernel and its finish (tiles)."""
    out = _grouped(row_s, gs, tab_s, d, row_t, gt, tab_t)
    minplus_twoside_grouped_cuda.launches += 1
    return out


minplus_twoside_grouped_cuda.launches = 0


def minplus_twoside_cuda(rows: torch.Tensor, d: torch.Tensor,
                         rowt: torch.Tensor) -> torch.Tensor:
    """rows [q, k1], d [k1, k2], rowt [q, k2] (float32, contiguous, on
    one CUDA device) -> out [q]: the grouped kernel with one group and
    identity tables."""
    out = _grouped(rows, None, None, d, rowt, None, None)
    minplus_twoside_cuda.launches += 1
    return out


minplus_twoside_cuda.launches = 0


def x_splits(q: int, k1: int, k2: int) -> int:
    """x-splits of the witness kernel: 1 while the (y-tile, q-tile) grid
    fills two waves, else as many contiguous runs of whole x-tiles as
    keep the grid within two waves (never an empty run)."""
    tiles = -(-k2 // Y_TILE) * -(-q // Q_TILE)
    xt = max(1, -(-k1 // X_TILE))
    per = -(-xt // max(1, min(xt, TWO_WAVES // max(tiles, 1))))
    return -(-xt // per)


def argmin_buffers(q: int, k1: int, k2: int, device) -> tuple:
    """What the witness kernel's wrapper allocates -> (splits, parts,
    scratch, res): ``x_splits``, the partials' count, one scratch buffer
    (packed witnesses int64 first, then values) and the int32 [3, q]
    result.  Shared by the CUDA wrapper and ``ops``' meta route."""
    splits = x_splits(q, k1, k2)
    parts = q * -(-k2 // Y_TILE) * splits
    scratch = torch.empty(12 * parts, dtype=torch.uint8, device=device)
    res = torch.empty((3, q), dtype=torch.int32, device=device)
    return splits, parts, scratch, res


def argmin_outputs(res: torch.Tensor) -> tuple:
    """(out float32 [q], wx [q], wy [q]): the rows of the int32 [3, q]
    result, out viewed as float32."""
    out, wx, wy = res.unbind(0)
    return out.view(torch.float32), wx, wy


def minplus_twoside_argmin_cuda(rows: torch.Tensor, d: torch.Tensor,
                                rowt: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """rows [q, k1], d [k1, k2], rowt [q, k2] (float32, contiguous, on
    one CUDA device) -> (out [q], wx [q], wy [q]), int32 witnesses, -1
    where out is +inf; array-equal to ``ref.minplus_twoside_argmin_ref``
    (the smallest y at the minimum, then its smallest x).  Two launches
    (partials, then the finish on the card); out, wx and wy are rows of
    one int32 [3, q] buffer, out viewed as float32."""
    q, k1, k2 = _check("minplus_twoside_argmin", rows, d, rowt)
    splits, parts, scratch, res = argmin_buffers(q, k1, k2, rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        base = scratch.data_ptr()
        err = _lib_argmin().minplus_twoside_argmin(
            rows.data_ptr(), d.data_ptr(), rowt.data_ptr(), base + 8 * parts,
            base, res[0].data_ptr(), res[1].data_ptr(), res[2].data_ptr(),
            q, k1, k2, splits, stream)
    if err != 0:
        raise RuntimeError(f"minplus_twoside_argmin launch failed: CUDA "
                           f"error {err}")
    minplus_twoside_argmin_cuda.launches += 1
    return argmin_outputs(res)


minplus_twoside_argmin_cuda.launches = 0
