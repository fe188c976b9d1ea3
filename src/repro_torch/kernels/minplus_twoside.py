"""Fused two-sided tropical contraction: the CUDA kernels' Python wrappers.

Ports of ``repro/kernels/minplus_twoside.py``:
``minplus_twoside_pallas`` (kernel ``csrc/minplus_twoside.cu``, plain
version ``ref.minplus_twoside_ref``)

    out[q] = min_{x, y} rows[q, x] + d[x, y] + rowt[q, y]

and ``minplus_twoside_argmin_pallas`` (kernel
``csrc/minplus_twoside_argmin.cu``, plain version
``ref.minplus_twoside_argmin_ref``), which also returns the winning
(x, y).  The distance kernel writes one partial per (query, 64-wide y
tile) and the wrapper finishes with a min over those partials, as the
Pallas version leaves its final cross-lane min outside the kernel.  The
witness kernel splits x across blocks when the grid is small
(``x_splits``) and finishes on the card, so its wrapper is allocations
and one call.  Each wrapper's ``.launches`` counts its calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
#: y columns per block (TS_BY and TA_BY in the .cu files): the
#: partials' width is ceil(K2 / Y_TILE)
Y_TILE = 64
#: queries per block and x depth per tile of the witness kernel (TA_BQ,
#: TA_BX)
Q_TILE = 64
X_TILE = 32
#: two waves of blocks on the card's 132 SMs: below it the witness
#: kernel splits x across blocks
TWO_WAVES = 264


def _lib() -> ctypes.CDLL:
    lib = _build.load("minplus_twoside")
    if lib.minplus_twoside.argtypes is None:
        lib.minplus_twoside.argtypes = [_VP, _VP, _VP, _VP, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, _VP]
        lib.minplus_twoside.restype = ctypes.c_int
    return lib


def _lib_argmin() -> ctypes.CDLL:
    lib = _build.load("minplus_twoside_argmin")
    if lib.minplus_twoside_argmin.argtypes is None:
        lib.minplus_twoside_argmin.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]
        lib.minplus_twoside_argmin.restype = ctypes.c_int
    return lib


def _check(kernel: str, rows: torch.Tensor, d: torch.Tensor,
           rowt: torch.Tensor) -> tuple[int, int, int]:
    """Raise unless rows [q, k1], d [k1, k2], rowt [q, k2] are contiguous
    float32 matrices on one CUDA device; -> (q, k1, k2)."""
    for name, x in (("rows", rows), ("d", d), ("rowt", rowt)):
        if not x.is_cuda or x.device != rows.device:
            raise ValueError(f"{kernel} kernel: {name} must be a CUDA "
                             f"tensor on {rows.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel: {name} must be float32, "
                            f"got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be a "
                             f"contiguous matrix, got {tuple(x.shape)}")
    q, k1 = rows.shape
    if d.shape[0] != k1 or rowt.shape != (q, d.shape[1]):
        raise ValueError(f"{kernel} kernel: shapes {tuple(rows.shape)}, "
                         f"{tuple(d.shape)}, {tuple(rowt.shape)} do not "
                         f"chain")
    return q, k1, d.shape[1]


def minplus_twoside_cuda(rows: torch.Tensor, d: torch.Tensor,
                         rowt: torch.Tensor) -> torch.Tensor:
    """rows [q, k1], d [k1, k2], rowt [q, k2] (float32, contiguous, on
    one CUDA device) -> out [q]."""
    q, k1, k2 = _check("minplus_twoside", rows, d, rowt)
    part = torch.empty((q, -(-k2 // Y_TILE)), dtype=torch.float32,
                       device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().minplus_twoside(rows.data_ptr(), d.data_ptr(),
                                     rowt.data_ptr(), part.data_ptr(), q,
                                     k1, k2, stream)
    if err != 0:
        raise RuntimeError(f"minplus_twoside launch failed: CUDA error "
                           f"{err}")
    minplus_twoside_cuda.launches += 1
    return part.amin(dim=1)


minplus_twoside_cuda.launches = 0


def x_splits(q: int, k1: int, k2: int) -> int:
    """x-splits of the witness kernel: 1 while the (y-tile, q-tile) grid
    fills two waves, else as many contiguous runs of whole x-tiles as
    keep the grid within two waves (never an empty run)."""
    tiles = -(-k2 // Y_TILE) * -(-q // Q_TILE)
    xt = max(1, -(-k1 // X_TILE))
    per = -(-xt // max(1, min(xt, TWO_WAVES // max(tiles, 1))))
    return -(-xt // per)


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
    splits = x_splits(q, k1, k2)
    parts = q * -(-k2 // Y_TILE) * splits
    # one scratch buffer: packed witnesses (int64) first, then values
    scratch = torch.empty(12 * parts, dtype=torch.uint8, device=rows.device)
    res = torch.empty((3, q), dtype=torch.int32, device=rows.device)
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
    out, wx, wy = res.unbind(0)
    return out.view(torch.float32), wx, wy


minplus_twoside_argmin_cuda.launches = 0
