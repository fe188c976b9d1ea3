"""Hub-label merge: the CUDA kernel's Python wrappers.

Port of ``repro/kernels/label_merge.py:label_merge_pallas``; the kernel
is ``csrc/label_merge.cu``, one template with two entries:

    label_merge_cuda(labs, labt)              out[i] = min_j labs[i, j]
                                                            + labt[i, j]
    label_merge_rows_cuda(rows, ids_s, ids_t) out[i] = min_j rows[ids_s[i], j]
                                                            + rows[ids_t[i], j]

the hub-label tier's O(W) combine of two label rows: the first on rows
already gathered (the Pallas function's signature), the second through
the label table's int32 row ids, as ``serve_hub`` calls it, so that the
[q, W] gathers are never written.  Plain versions: ``ref.label_merge_ref``
and ``ref.label_merge_rows_ref``.  Each wrapper counts its launches in
``.launches``; ``empty_launch_cuda`` launches an empty kernel, the fixed
cost the merge's time is read beside.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int

#: threads a block (LM_BLOCK in csrc/label_merge.cu)
BLOCK = 256
#: columns of each row a thread loads in a pass (LM_COLS)
COLS = 16
#: threads an H100 holds at once at the kernel's 64 registers a thread:
#: 132 SMs x 4 blocks of BLOCK
FILL_THREADS = 132 * 4 * BLOCK


def team(q: int, w: int) -> int:
    """Threads that merge one query, a power of two from 32 to BLOCK:
    enough that one pass of COLS columns a thread covers the row, halved
    while the q teams would not all be resident at once
    (``FILL_THREADS``), never below a warp.  On an H100 this was within
    3% of the fastest team size at every case
    ``scripts/label_merge_tune.py`` times (PERF.md)."""
    t = 32
    while t < BLOCK and t * COLS < w:
        t *= 2
    while t > 32 and q * t > FILL_THREADS:
        t //= 2
    return t


def _lib() -> ctypes.CDLL:
    lib = _build.load("label_merge")
    if lib.label_merge.argtypes is None:
        lib.label_merge_rows.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                         _VP]
        lib.label_merge_empty.argtypes = [_I, _VP]
        lib.label_merge_rows.restype = ctypes.c_int
        lib.label_merge_empty.restype = ctypes.c_int
        lib.label_merge.restype = ctypes.c_int
        lib.label_merge.argtypes = [_VP, _VP, _VP, _I, _I, _I, _VP]
    return lib


def merge_out(x: torch.Tensor) -> torch.Tensor:
    """The [q] float32 output of a merge whose first operand is ``x``
    (``labs`` [q, W], or ``ids_s`` [q]), on its device: what both
    wrappers allocate, shared with ``ops``' meta route."""
    return torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)


def _check(name: str, x: torch.Tensor, dev: torch.device,
           dtype: torch.dtype, dim: int) -> None:
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"label_merge kernel: {name} must be a CUDA "
                         f"tensor on {dev}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"label_merge kernel: {name} must be {dtype}, "
                        f"got {x.dtype}")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"label_merge kernel: {name} must be contiguous "
                         f"with {dim} dimension(s), got {tuple(x.shape)}")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def label_merge_cuda(labs: torch.Tensor, labt: torch.Tensor) -> torch.Tensor:
    """labs, labt [q, W] (float32, contiguous, on one CUDA device) ->
    out [q]."""
    for name, x in (("labs", labs), ("labt", labt)):
        _check(name, x, labs.device, torch.float32, 2)
    if labs.shape != labt.shape:
        raise ValueError(f"label_merge kernel: shapes {tuple(labs.shape)} "
                         f"and {tuple(labt.shape)} differ")
    q, w = labs.shape
    out = merge_out(labs)
    if q == 0:
        return out
    with torch.cuda.device(labs.device):
        _raise_on(_lib().label_merge(
            labs.data_ptr(), labt.data_ptr(), out.data_ptr(), q, w,
            team(q, w).bit_length() - 1, _stream(labs.device)),
            "label_merge")
    label_merge_cuda.launches += 1
    return out


def label_merge_rows_cuda(rows: torch.Tensor, ids_s: torch.Tensor,
                          ids_t: torch.Tensor) -> torch.Tensor:
    """rows [H+1, W] (float32, contiguous), ids_s, ids_t [q] (int32
    row ids in [0, H]; not checked on the card, which would cost a
    synchronise), all on one CUDA device -> out [q]."""
    dev = rows.device
    _check("rows", rows, dev, torch.float32, 2)
    for name, x in (("ids_s", ids_s), ("ids_t", ids_t)):
        _check(name, x, dev, torch.int32, 1)
    if ids_s.shape != ids_t.shape:
        raise ValueError(f"label_merge kernel: ids of {ids_s.shape[0]} "
                         f"and {ids_t.shape[0]} queries")
    q, w = ids_s.shape[0], rows.shape[1]
    out = merge_out(ids_s)
    if q == 0:
        return out
    with torch.cuda.device(dev):
        _raise_on(_lib().label_merge_rows(
            rows.data_ptr(), ids_s.data_ptr(), ids_t.data_ptr(),
            out.data_ptr(), q, w, team(q, w).bit_length() - 1, 1,
            _stream(dev)), "label_merge_rows")
    label_merge_rows_cuda.launches += 1
    return out


def empty_launch_cuda(blocks: int, device: torch.device | str = "cuda"
                      ) -> None:
    """One empty kernel on ``blocks`` blocks of BLOCK threads (not on any
    path: the launch's fixed cost, timed beside the merge)."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        _raise_on(_lib().label_merge_empty(blocks, _stream(dev)),
                  "label_merge_empty")


label_merge_cuda.launches = 0
label_merge_rows_cuda.launches = 0
