"""Batched Floyd-Warshall: the CUDA kernels' Python wrappers, and the
blocked APSP schedule built on them.

Witness FW, port of ``repro/kernels/floyd_warshall.py:
fw_batch_next_pallas``: the kernel is ``csrc/fw_next.cu`` and its plain
version ``ref.fw_batch_next_ref``.  ``d[b, n, n]`` (float32, +inf = no
edge) -> ``(dist, nxt)``, array-equal to the plain version in both
outputs.  Two launch shapes on the main path, chosen by n:
``fw_next_smem`` keeps a whole matrix in shared memory (one block per
matrix, taken up to n = SMEM_DISPATCH_N: the small piece buckets),
``fw_next_blocked`` runs the exact blocked schedule (two launches per
k-block of 32 pivots over the batch, ``ref.fw_batch_next_blocked_ref``
models it) for the fragments, the SUPER overlay, the hierarchy's
group closures and the large piece buckets.  ``fw_next_global``, one
launch per pivot, left the main path with the blocked variant and stays
callable so the two can be timed side by side.

Distance-only FW, port of ``fw_batch_pallas``: the kernel is
``csrc/fw_dist.cu`` (shared memory up to n = 240, one launch per pivot
above) and its plain version ``ref.fw_batch_ref``.

``fw_blocked`` is the 3-phase blocked APSP of ``fw_blocked`` in the
reference: phase 1 through ``ops.fw_batch``, phases 2/3 through
``ops.minplus_accum``.  Each kernel wrapper counts its calls in
``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_SIG = [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP]
_SIG_DIST = [_VP, _VP, ctypes.c_int, ctypes.c_int, _VP]
#: largest n the shared-memory variant takes (FW_SMEM_MAX_N in the .cu):
#: 160 * 160 cells * 8 bytes = 200 KB of the 227 KB a block may use
SMEM_MAX_N = 160
#: largest n dispatched to the shared-memory variant: on the H100 it beat
#: the blocked one at n = 64 and below and lost at n = 128 and 160
#: (``chip_smoke.py`` times both at each of those shapes)
SMEM_DISPATCH_N = 64
#: the same for distance-only FW (FWD_SMEM_MAX_N in fw_dist.cu):
#: 240 * 240 cells * 4 bytes = 225 KB
DIST_SMEM_MAX_N = 240


def _lib() -> ctypes.CDLL:
    lib = _build.load("fw_next")
    if lib.fw_next_smem.argtypes is None:
        for fn in (lib.fw_next_smem, lib.fw_next_global):
            fn.argtypes = _SIG
            fn.restype = ctypes.c_int
        lib.fw_next_blocked.argtypes = [_VP, _VP, _VP, _VP, ctypes.c_int,
                                        ctypes.c_int, _VP]
        lib.fw_next_blocked.restype = ctypes.c_int
        lib.fw_next_blocked_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fw_next_blocked_scratch.restype = ctypes.c_size_t
    return lib


def _dist_lib() -> ctypes.CDLL:
    lib = _build.load("fw_dist")
    if lib.fw_dist_smem.argtypes is None:
        for fn in (lib.fw_dist_smem, lib.fw_dist_global):
            fn.argtypes = _SIG_DIST
            fn.restype = ctypes.c_int
    return lib


def _check(d: torch.Tensor, kernel: str = "fw_next") -> tuple[int, int]:
    if not d.is_cuda:
        raise ValueError(f"{kernel} kernel needs a CUDA tensor, got "
                         f"{d.device}")
    if d.dtype != torch.float32:
        raise TypeError(f"{kernel} kernel takes float32, got {d.dtype}")
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"{kernel} kernel takes [b, n, n], got "
                         f"{tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError(f"{kernel} kernel takes a contiguous tensor")
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


def fw_next_blocked_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Blocked variant: 1 + 2 * ceil(n / 32) launches, any n; scratch
    from ``torch.empty`` (the kernel allocates nothing)."""
    b, n = _check(d)
    lib = _lib()
    dist = torch.empty_like(d)
    nxt = torch.empty(d.shape, dtype=torch.int32, device=d.device)
    scratch = torch.empty(lib.fw_next_blocked_scratch(b, n),
                          dtype=torch.uint8, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fw_next_blocked(d.data_ptr(), dist.data_ptr(),
                                  nxt.data_ptr(), scratch.data_ptr(), b, n,
                                  stream)
    if err != 0:
        raise RuntimeError(f"fw_next_blocked launch failed: CUDA error "
                           f"{err}")
    fw_next_blocked_cuda.launches += 1
    return dist, nxt


fw_next_smem_cuda.launches = 0
fw_next_global_cuda.launches = 0
fw_next_blocked_cuda.launches = 0


def fw_batch_next_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Batched witness APSP on the card, variant chosen by n."""
    if d.shape[-1] <= SMEM_DISPATCH_N:
        return fw_next_smem_cuda(d)
    return fw_next_blocked_cuda(d)


def fw_batch_cuda(d: torch.Tensor) -> torch.Tensor:
    """Batched distance-only APSP on the card: [b, n, n] -> dist, the
    shared-memory variant up to n = DIST_SMEM_MAX_N, one launch per
    pivot above."""
    b, n = _check(d, "fw_dist")
    entry = "fw_dist_smem" if n <= DIST_SMEM_MAX_N else "fw_dist_global"
    dist = torch.empty_like(d)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_dist_lib(), entry)(d.data_ptr(), dist.data_ptr(),
                                          b, n, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    fw_batch_cuda.launches += 1
    return dist


fw_batch_cuda.launches = 0


def fw_blocked(d: torch.Tensor, *, block: int = 128, force=None
               ) -> torch.Tensor:
    """3-phase blocked Floyd-Warshall for one [n, n] matrix, the
    reference's ``fw_blocked`` step for step.

    Pads to a block multiple with +inf (diagonal 0).  Per k-block:
      phase 1: FW on the diagonal block D[kk]            (ops.fw_batch)
      phase 2: D[k, *] = min(D[k, *], D[kk] (x) D[k, *]);
               D[*, k] = min(D[*, k], D[*, k] (x) D[kk]) (ops.minplus_accum)
      phase 3: D = min(D, D[*, k] (x) D[k, *])          (ops.minplus_accum)
    The ops dispatch follows the tensor: CUDA kernels on the card, the
    plain versions on the CPU.
    """
    from . import ops                  # ops imports this module
    n = d.shape[0]
    np_ = -(-n // block) * block
    pad = torch.full((np_, np_), float("inf"), dtype=d.dtype,
                     device=d.device)
    pad[:n, :n] = d
    pad.fill_diagonal_(0.0)
    for s in range(0, np_, block):
        e = s + block
        dkk = ops.fw_batch(pad[None, s:e, s:e].contiguous(), force=force)[0]
        pad[s:e, s:e] = dkk
        row = ops.minplus_accum(pad[s:e], dkk, pad[s:e], force=force)
        pad[s:e] = row
        col = pad[:, s:e].contiguous()
        col = ops.minplus_accum(col, col, dkk, force=force)
        pad[:, s:e] = col
        pad = ops.minplus_accum(pad, col, row, force=force)
    return pad[:n, :n].contiguous()
