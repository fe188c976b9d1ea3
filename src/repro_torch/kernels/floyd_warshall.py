"""Batched witness Floyd-Warshall: the CUDA kernel's Python wrapper.

Port of ``repro/kernels/floyd_warshall.py:fw_batch_next_pallas``; the
kernel is ``csrc/fw_next.cu`` and its plain version is
``ref.fw_batch_next_ref``.  ``d[b, n, n]`` (float32, +inf = no edge)
-> ``(dist, nxt)``, array-equal to the plain version in both outputs.

Two launch shapes, chosen by n: ``fw_next_smem`` keeps a whole matrix in
shared memory (one block per matrix, n <= 160: fragments and piece
buckets at road4000), ``fw_next_global`` runs one launch per pivot over
the batch in device memory (larger fragments, the SUPER overlay, the
large piece buckets).  Each wrapper counts its calls in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_SIG = [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP]
#: largest n the shared-memory variant takes (FW_SMEM_MAX_N in the .cu):
#: 160 * 160 cells * 8 bytes = 200 KB of the 227 KB a block may use
SMEM_MAX_N = 160


def _lib() -> ctypes.CDLL:
    lib = _build.load("fw_next")
    if lib.fw_next_smem.argtypes is None:
        for fn in (lib.fw_next_smem, lib.fw_next_global):
            fn.argtypes = _SIG
            fn.restype = ctypes.c_int
    return lib


def _check(d: torch.Tensor) -> tuple[int, int]:
    if not d.is_cuda:
        raise ValueError(f"fw_next kernel needs a CUDA tensor, got "
                         f"{d.device}")
    if d.dtype != torch.float32:
        raise TypeError(f"fw_next kernel takes float32, got {d.dtype}")
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"fw_next kernel takes [b, n, n], got "
                         f"{tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("fw_next kernel takes a contiguous tensor")
    return d.shape[0], d.shape[1]


def _launch(entry: str, d: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    b, n = _check(d)
    dist = torch.empty_like(d)
    nxt = torch.empty(d.shape, dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(d.data_ptr(), dist.data_ptr(),
                                     nxt.data_ptr(), b, n, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return dist, nxt


def fw_next_smem_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Shared-memory variant: one block per matrix, n <= SMEM_MAX_N."""
    if d.shape[-1] > SMEM_MAX_N:
        raise ValueError(f"fw_next_smem takes n <= {SMEM_MAX_N}, got "
                         f"{d.shape[-1]}")
    out = _launch("fw_next_smem", d)
    fw_next_smem_cuda.launches += 1
    return out


def fw_next_global_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Device-memory variant: one launch per pivot, any n."""
    out = _launch("fw_next_global", d)
    fw_next_global_cuda.launches += 1
    return out


fw_next_smem_cuda.launches = 0
fw_next_global_cuda.launches = 0


def fw_batch_next_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Batched witness APSP on the card, variant chosen by n."""
    if d.shape[-1] <= SMEM_MAX_N:
        return fw_next_smem_cuda(d)
    return fw_next_global_cuda(d)
