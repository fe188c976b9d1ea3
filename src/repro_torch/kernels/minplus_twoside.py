"""Fused two-sided tropical contraction: the CUDA kernels' Python wrappers.

Ports of ``repro/kernels/minplus_twoside.py``:
``minplus_twoside_pallas`` (kernel ``csrc/minplus_twoside.cu``, plain
version ``ref.minplus_twoside_ref``)

    out[q] = min_{x, y} rows[q, x] + d[x, y] + rowt[q, y]

and ``minplus_twoside_argmin_pallas`` (kernel
``csrc/minplus_twoside_argmin.cu``, plain version
``ref.minplus_twoside_argmin_ref``), which also returns the winning
(x, y).  Each kernel writes one partial per (query, 64-wide y tile);
the wrapper finishes with a min over those partials, as the Pallas
versions leave their final cross-lane min outside the kernel.  Each
wrapper's ``.launches`` counts its calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
#: y columns per block (TS_BY and TA_BY in the .cu files): the
#: partials' width is ceil(K2 / Y_TILE)
Y_TILE = 64


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
            _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _VP]
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


def minplus_twoside_argmin_cuda(rows: torch.Tensor, d: torch.Tensor,
                                rowt: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """rows [q, k1], d [k1, k2], rowt [q, k2] (float32, contiguous, on
    one CUDA device) -> (out [q], wx [q], wy [q]), int32 witnesses, -1
    where out is +inf; array-equal to ``ref.minplus_twoside_argmin_ref``
    (the smallest y at the minimum, then its smallest x)."""
    q, k1, k2 = _check("minplus_twoside_argmin", rows, d, rowt)
    tiles = -(-k2 // Y_TILE)
    part = torch.empty((q, tiles), dtype=torch.float32, device=rows.device)
    pwit = torch.empty((q, tiles), dtype=torch.int64, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib_argmin().minplus_twoside_argmin(
            rows.data_ptr(), d.data_ptr(), rowt.data_ptr(), part.data_ptr(),
            pwit.data_ptr(), q, k1, k2, stream)
    if err != 0:
        raise RuntimeError(f"minplus_twoside_argmin launch failed: CUDA "
                           f"error {err}")
    minplus_twoside_argmin_cuda.launches += 1
    out = part.amin(dim=1)
    # among the tiles at the minimum the smallest packed y * k1 + x is
    # the smallest y, then its x
    wit = torch.where(part == out[:, None], pwit,
                      torch.iinfo(torch.int64).max).amin(dim=1)
    fin = torch.isfinite(out)
    k1c = max(k1, 1)
    wx = torch.where(fin, wit % k1c, -1).to(torch.int32)
    wy = torch.where(fin, wit // k1c, -1).to(torch.int32)
    return out, wx, wy


minplus_twoside_argmin_cuda.launches = 0
