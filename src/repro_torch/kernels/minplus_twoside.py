"""Fused two-sided tropical contraction: the CUDA kernel's Python wrapper.

Port of ``repro/kernels/minplus_twoside.py:minplus_twoside_pallas``; the
kernel is ``csrc/minplus_twoside.cu`` and its plain version is
``ref.minplus_twoside_ref``:

    out[q] = min_{x, y} rows[q, x] + d[x, y] + rowt[q, y]

The kernel writes one partial minimum per (query, 64-wide y tile); the
wrapper finishes with a min over those partials, as the Pallas version
leaves its final cross-lane min outside the kernel.  ``.launches``
counts the calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
#: y columns per block (TS_BY in the .cu): the partials' width is
#: ceil(K2 / Y_TILE)
Y_TILE = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("minplus_twoside")
    if lib.minplus_twoside.argtypes is None:
        lib.minplus_twoside.argtypes = [_VP, _VP, _VP, _VP, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, _VP]
        lib.minplus_twoside.restype = ctypes.c_int
    return lib


def minplus_twoside_cuda(rows: torch.Tensor, d: torch.Tensor,
                         rowt: torch.Tensor) -> torch.Tensor:
    """rows [q, k1], d [k1, k2], rowt [q, k2] (float32, contiguous, on
    one CUDA device) -> out [q]."""
    for name, x in (("rows", rows), ("d", d), ("rowt", rowt)):
        if not x.is_cuda or x.device != rows.device:
            raise ValueError(f"minplus_twoside kernel: {name} must be a "
                             f"CUDA tensor on {rows.device}, got "
                             f"{x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"minplus_twoside kernel: {name} must be "
                            f"float32, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"minplus_twoside kernel: {name} must be a "
                             f"contiguous matrix, got {tuple(x.shape)}")
    q, k1 = rows.shape
    if d.shape[0] != k1 or rowt.shape != (q, d.shape[1]):
        raise ValueError(f"minplus_twoside kernel: shapes {tuple(rows.shape)}"
                         f", {tuple(d.shape)}, {tuple(rowt.shape)} do not "
                         f"chain")
    k2 = d.shape[1]
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
