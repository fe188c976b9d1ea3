"""Tropical (min,+) matrix product: the CUDA kernels' Python wrappers.

Port of ``repro/kernels/minplus.py``: ``minplus_pallas`` and
``minplus_accum_pallas`` become the two C entries of ``csrc/minplus.cu``,
with plain versions ``ref.minplus_ref`` and ``ref.minplus_accum_ref``:

    minplus_cuda(a, b)          = min_k a[i, k] + b[k, j]
    minplus_accum_cuda(c, a, b) = min(c, minplus_cuda(a, b))

Both always allocate their output, so ``c`` may be the same tensor as
``b`` (the blocked Floyd-Warshall's phase 2 passes one row panel as
both).  Each wrapper counts its calls in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("minplus")
    if lib.minplus.argtypes is None:
        lib.minplus.argtypes = [_VP, _VP, _VP, _I, _I, _I, _VP]
        lib.minplus_accum.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _VP]
        lib.minplus.restype = lib.minplus_accum.restype = ctypes.c_int
    return lib


def _check(kernel: str, ref: torch.Tensor, **mats: torch.Tensor) -> None:
    for name, x in mats.items():
        if not x.is_cuda or x.device != ref.device:
            raise ValueError(f"{kernel} kernel: {name} must be a CUDA "
                             f"tensor on {ref.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel: {name} must be float32, "
                            f"got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be a "
                             f"contiguous matrix, got {tuple(x.shape)}")


def _shapes(kernel: str, a: torch.Tensor, b: torch.Tensor
            ) -> tuple[int, int, int]:
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"{kernel} kernel: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    return m, n, k


def _run(entry: str, out: torch.Tensor, *ptrs, m: int, n: int,
         k: int) -> None:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(*ptrs, out.data_ptr(), m, n, k,
                                     stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k], b [k, n] (float32, contiguous, one CUDA device) ->
    c [m, n] = a (x) b."""
    _check("minplus", a, a=a, b=b)
    m, n, k = _shapes("minplus", a, b)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _run("minplus", out, a.data_ptr(), b.data_ptr(), m=m, n=n, k=k)
    minplus_cuda.launches += 1
    return out


def minplus_accum_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    """c [m, n], a [m, k], b [k, n] -> min(c, a (x) b) in a new tensor."""
    _check("minplus_accum", a, c=c, a=a, b=b)
    m, n, k = _shapes("minplus_accum", a, b)
    if tuple(c.shape) != (m, n):
        raise ValueError(f"minplus_accum kernel: c is {tuple(c.shape)}, "
                         f"expected {(m, n)}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _run("minplus_accum", out, c.data_ptr(), a.data_ptr(), b.data_ptr(),
         m=m, n=n, k=k)
    minplus_accum_cuda.launches += 1
    return out


minplus_cuda.launches = 0
minplus_accum_cuda.launches = 0
