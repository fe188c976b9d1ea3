"""Hub-label merge: the CUDA kernel's Python wrapper.

Port of ``repro/kernels/label_merge.py:label_merge_pallas``; the kernel
is ``csrc/label_merge.cu`` and its plain version is
``ref.label_merge_ref``:

    out[q] = min_j labs[q, j] + labt[q, j]

the hub-label tier's O(W) combine of two gathered label rows.
``.launches`` counts the calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("label_merge")
    if lib.label_merge.argtypes is None:
        lib.label_merge.argtypes = [_VP, _VP, _VP, ctypes.c_int,
                                    ctypes.c_int, _VP]
        lib.label_merge.restype = ctypes.c_int
    return lib


def merge_out(labs: torch.Tensor) -> torch.Tensor:
    """The [q] float32 output ``label_merge_cuda`` allocates (shared with
    ``ops``' meta route)."""
    return torch.empty((labs.shape[0],), dtype=torch.float32,
                       device=labs.device)


def label_merge_cuda(labs: torch.Tensor, labt: torch.Tensor) -> torch.Tensor:
    """labs, labt [q, W] (float32, contiguous, on one CUDA device) ->
    out [q]."""
    for name, x in (("labs", labs), ("labt", labt)):
        if not x.is_cuda or x.device != labs.device:
            raise ValueError(f"label_merge kernel: {name} must be a CUDA "
                             f"tensor on {labs.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"label_merge kernel: {name} must be float32, "
                            f"got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"label_merge kernel: {name} must be a "
                             f"contiguous matrix, got {tuple(x.shape)}")
    if labs.shape != labt.shape:
        raise ValueError(f"label_merge kernel: shapes {tuple(labs.shape)} "
                         f"and {tuple(labt.shape)} differ")
    q, w = labs.shape
    out = merge_out(labs)
    with torch.cuda.device(labs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().label_merge(labs.data_ptr(), labt.data_ptr(),
                                 out.data_ptr(), q, w, stream)
    if err != 0:
        raise RuntimeError(f"label_merge launch failed: CUDA error {err}")
    label_merge_cuda.launches += 1
    return out


label_merge_cuda.launches = 0
