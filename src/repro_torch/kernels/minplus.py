"""Tropical (min,+) matrix product: the CUDA kernels' Python wrappers.

Port of ``repro/kernels/minplus.py``: ``minplus_pallas`` and
``minplus_accum_pallas`` become C entries of ``csrc/minplus.cu``, with
plain versions ``ref.minplus_ref`` and ``ref.minplus_accum_ref``:

    minplus_cuda(a, b)          = min_k a[i, k] + b[k, j]
    minplus_accum_cuda(c, a, b) = min(c, minplus_cuda(a, b))

``minplus_cuda`` takes the entry ``route`` names for the shape: the
GEMV kernel for a few rows (one-to-all's vector x matrix product; its
k-split schedule is modelled by ``ref.minplus_gemv_ref``), the
accumulate tiles without C_in above.

Both allocate their output, so ``c`` may be the same tensor as ``b``.
A third wrapper runs the accumulating kernel in place, on strided views:

    minplus_accum_into_cuda(c, a, b, skip_rows=, skip_cols=)
        c[i, j] = min(c[i, j], (a (x) b)[i, j]), but for the skipped
        rows and columns

which is how the blocked Floyd-Warshall's phase 3 updates its matrix
where it lies, and a fourth runs phase 2's two panels in one launch:

    minplus_accum_panels_cuda(row, col, skip_cols=, skip_rows=)
        minplus_accum_into_cuda(*row, skip_cols=skip_cols) and
        minplus_accum_into_cuda(*col, skip_rows=skip_rows), where the
        row panel's c may be its b and the column panel's c its a

(``csrc/minplus.cu`` states when the views may alias; plain versions
``ref.minplus_accum_into_ref`` and ``ref.minplus_accum_panels_ref``).
The two in-place wrappers take matrices [m, n] or batches [b, m, n] of
them (the blocked FW over a batch of matrices), one launch either way.
Each wrapper counts its launches in ``.launches`` (``_build.count_launch``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int


#: most rows of A the GEMV entry takes (MG_MAX_M in csrc/minplus.cu)
GEMV_MAX_M = 8
#: k-slices of a GEMV strip (MG_SLICES): the blocks of one cluster
GEMV_SLICES = 8
#: strip widths the GEMV entry is built for, narrow first
GEMV_STRIPS = (32, 128)
#: GEMV blocks that fill the card: 2 per SM of an H100's 132
GEMV_BLOCKS = 264


def route(m: int, k: int, n: int) -> tuple[str, int]:
    """The entry of ``csrc/minplus.cu`` that computes an [m, k] x [k, n]
    product, and its strip width: ("minplus_gemv", sw) for m <=
    GEMV_MAX_M, sw the widest of GEMV_STRIPS whose strips times
    GEMV_SLICES still reach GEMV_BLOCKS (else the narrowest), so that B
    is streamed by enough blocks; ("minplus_tiles", 0) above."""
    if m > GEMV_MAX_M:
        return "minplus_tiles", 0
    for sw in reversed(GEMV_STRIPS):
        if -(-n // sw) * GEMV_SLICES >= GEMV_BLOCKS:
            return "minplus_gemv", sw
    return "minplus_gemv", GEMV_STRIPS[0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("minplus")
    if lib.minplus_gemv.argtypes is None:
        lib.minplus_gemv.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I, _VP]
        lib.minplus_tiles.argtypes = [_VP, _VP, _VP, _I, _I, _I, _VP]
        lib.minplus_accum.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _VP]
        lib.minplus_gemv.restype = lib.minplus_tiles.restype = ctypes.c_int
        lib.minplus_accum.restype = ctypes.c_int
        ll = ctypes.c_longlong
        lib.minplus_accum_ld.argtypes = [_VP, ll, _VP, ll, _VP, ll, _VP, ll,
                                         _I, _I, _I, _I, _I, _I, _I, _I, ll,
                                         ll, ll, _VP]
        lib.minplus_accum_ld.restype = ctypes.c_int
        lib.minplus_accum_panels.argtypes = (
            [_VP, ll, _VP, ll, _VP, ll, _I, _I, _I, _I, _I, ll, ll, ll] * 2
            + [_I, _VP])
        lib.minplus_accum_panels.restype = ctypes.c_int
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
    (m, k), (k2, n) = a.shape[-2:], b.shape[-2:]
    if k != k2:
        raise ValueError(f"{kernel} kernel: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    return m, n, k


def _run(entry: str, out: torch.Tensor, *ptrs, m: int, n: int,
         k: int, extra=()) -> None:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(*ptrs, out.data_ptr(), m, n, k,
                                     *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def product_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The [m, n] float32 output ``minplus_cuda`` and
    ``minplus_accum_cuda`` allocate for a [m, k] x [k, n] product (shared
    with ``ops``' meta route)."""
    return torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                       device=a.device)


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k], b [k, n] (float32, contiguous, one CUDA device) ->
    c [m, n] = a (x) b, through the entry ``route`` names."""
    _check("minplus", a, a=a, b=b)
    m, n, k = _shapes("minplus", a, b)
    name, sw = route(m, k, n)
    out = product_out(a, b)
    _run(name, out, a.data_ptr(), b.data_ptr(), m=m, n=n, k=k,
         extra=(sw,) if name == "minplus_gemv" else ())
    _build.count_launch(minplus_cuda)
    return out


def minplus_accum_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    """c [m, n], a [m, k], b [k, n] -> min(c, a (x) b) in a new tensor."""
    _check("minplus_accum", a, c=c, a=a, b=b)
    m, n, k = _shapes("minplus_accum", a, b)
    if tuple(c.shape) != (m, n):
        raise ValueError(f"minplus_accum kernel: c is {tuple(c.shape)}, "
                         f"expected {(m, n)}")
    out = product_out(a, b)
    _run("minplus_accum", out, c.data_ptr(), a.data_ptr(), b.data_ptr(),
         m=m, n=n, k=k)
    _build.count_launch(minplus_accum_cuda)
    return out


#: a panel of at most this many rows (columns) is one tile high (wide)
#: in ``minplus_accum_panels`` (csrc/minplus.cu), so C may alias B (A)
#: there up to it
PANEL = 128


class Job(NamedTuple):
    """One in-place product as the C entries take it: device addresses
    and leading dimensions (elements) of c (which is also c_in), a and
    b, the sizes c [m, n], a [m, k], b [k, n], and the number of
    matrices with each operand's batch stride (elements; 0 for one)."""
    c: int
    ldc: int
    a: int
    lda: int
    b: int
    ldb: int
    m: int
    n: int
    k: int
    batch: int = 1
    bsc: int = 0
    bsa: int = 0
    bsb: int = 0


def _job(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> Job:
    """The Job of views c, a, b: matrices, or batches of them."""
    batch = c.shape[0] if c.dim() == 3 else 1

    def bs(x):
        return x.stride(0) if x.dim() == 3 and batch > 1 else 0
    return Job(c=c.data_ptr(), ldc=c.stride(-2), a=a.data_ptr(),
               lda=a.stride(-2), b=b.data_ptr(), ldb=b.stride(-2),
               m=c.shape[-2], n=c.shape[-1], k=a.shape[-1], batch=batch,
               bsc=bs(c), bsa=bs(a), bsb=bs(b))


def launch_into(job: Job, skip_rows, skip_cols, stream: int) -> None:
    """One launch of ``minplus_accum_ld`` (the one place that packs its C
    arguments): the launch site of ``minplus_accum_into_cuda``, which
    checks its views first, and of the blocked schedule, whose windows
    are checked by construction (``floyd_warshall.fw_blocked``).
    Counts the launch."""
    (r0, r1), (c0, c1) = skip_rows, skip_cols
    err = _lib().minplus_accum_ld(job.c, job.ldc, job.a, job.lda, job.b,
                                  job.ldb, job.c, job.ldc, job.m, job.n,
                                  job.k, r0, r1, c0, c1, job.batch, job.bsa,
                                  job.bsb, job.bsc, stream)
    if err != 0:
        raise RuntimeError(f"minplus_accum_ld launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(minplus_accum_into_cuda)


def launch_panels(row: Job, skip_cols, col: Job, skip_rows,
                  stream: int) -> None:
    """One launch of ``minplus_accum_panels`` (the one place that packs
    its C arguments): the launch site of ``minplus_accum_panels_cuda``
    and of the blocked schedule.  The two jobs cover the same matrices
    (the row job's ``batch``).  Counts the launch."""
    err = _lib().minplus_accum_panels(
        row.c, row.ldc, row.a, row.lda, row.b, row.ldb, row.m, row.n,
        row.k, *skip_cols, row.bsc, row.bsa, row.bsb, col.c, col.ldc, col.a,
        col.lda, col.b, col.ldb, col.m, col.n, col.k, *skip_rows, col.bsc,
        col.bsa, col.bsb, row.batch, stream)
    if err != 0:
        raise RuntimeError(f"minplus_accum_panels launch failed: CUDA "
                           f"error {err}")
    _build.count_launch(minplus_accum_panels_cuda)


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The first and last byte addresses a view's elements start at."""
    lo = t.data_ptr()
    return lo, lo + 4 * sum((n - 1) * st for n, st in zip(t.shape,
                                                         t.stride()))


def _overlap(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the memory spans of two views intersect."""
    (a0, a1), (b0, b1) = _span(x), _span(y)
    return a0 <= b1 and b0 <= a1


def _same_slots(c: torch.Tensor, x: torch.Tensor) -> bool:
    """For batches c, x [bt, ., .]: whether matrix z of x can share
    memory only with matrix z of c: one batch stride, and c[0] and x[0]
    together within one stride's span, so that the matrices of the two
    lie in the same disjoint slots."""
    if c.stride(0) != x.stride(0):
        return False
    (a0, a1), (b0, b1) = _span(c[0]), _span(x[0])
    return max(a1, b1) + 4 - min(a0, b0) <= 4 * c.stride(0)


def _skipped(c: torch.Tensor, x: torch.Tensor, skip_rows, skip_cols
             ) -> bool:
    """Whether x is a window of c (same row stride) whose every cell lies
    in c's skipped rows or in its skipped columns."""
    ld = c.stride(0)
    off = (x.data_ptr() - c.data_ptr()) // 4
    if x.stride(0) != ld or off < 0:
        return False
    r, col = divmod(off, ld)
    if col + x.shape[1] > ld:
        return False
    return ((skip_rows[0] <= r and r + x.shape[0] <= skip_rows[1])
            or (skip_cols[0] <= col and col + x.shape[1] <= skip_cols[1]))


def _check_views(kernel: str, c: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> tuple[int, int, int]:
    """(m, n, k) of views c [m, n], a [m, k], b [k, n], or of three
    batches [bt, ...] of as many such matrices: float32 on c's CUDA
    device, unit column stride."""
    for name, x in (("c", c), ("a", a), ("b", b)):
        if not x.is_cuda or x.device != c.device:
            raise ValueError(f"{kernel} kernel: {name} must be a CUDA "
                             f"tensor on {c.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel: {name} must be float32, "
                            f"got {x.dtype}")
        if (x.dim() not in (2, 3) or x.dim() != c.dim()
                or (x.shape[-1] > 1 and x.stride(-1) != 1)):
            raise ValueError(f"{kernel} kernel: {name} must be a matrix "
                             f"(or a batch of them, as c is) with unit "
                             f"column stride")
    if c.dim() == 3 and not c.shape[0] == a.shape[0] == b.shape[0]:
        raise ValueError(f"{kernel} kernel: batches of {c.shape[0]}, "
                         f"{a.shape[0]} and {b.shape[0]} matrices")
    m, n, k = _shapes(kernel, a, b)
    if tuple(c.shape[-2:]) != (m, n):
        raise ValueError(f"{kernel} kernel: c is {tuple(c.shape)}, "
                         f"expected {(m, n)} matrices")
    return m, n, k


def _same_window(c: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether x starts where c does with c's row stride."""
    return x.data_ptr() == c.data_ptr() and x.stride(0) == c.stride(0)


def _check_alias(kernel: str, c: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, skip_rows, skip_cols, panel: str = ""
                 ) -> None:
    """Refuses a or b sharing c's memory beyond c's skipped cells, but
    for the panel operand ``panel`` ("a" or "b"), which may be the same
    window as c (``csrc/minplus.cu`` says why each case is race-free).
    Batches are held to it matrix by matrix: an operand that shares c's
    memory must lie in c's batch slots (``_same_slots``), and its first
    matrix is then checked against c's."""
    if c.dim() == 3:
        for name, x in (("a", a), ("b", b)):
            if c.shape[0] > 1 and _overlap(c, x) and not _same_slots(c, x):
                raise ValueError(f"{kernel} kernel: {name} shares c's "
                                 f"memory across the matrices of the "
                                 f"batch")
        c, a, b = c[0], a[0], b[0]
    for name, x in (("a", a), ("b", b)):
        if (not _overlap(c, x) or _skipped(c, x, skip_rows, skip_cols)
                or (name == panel and _same_window(c, x))):
            continue
        also = ", nor is it the same window as c" if name == panel else ""
        raise ValueError(f"{kernel} kernel: c shares {name}'s memory "
                         f"beyond c's skipped cells{also}")


def minplus_accum_into_cuda(c: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, *, skip_rows=(0, 0),
                            skip_cols=(0, 0)) -> torch.Tensor:
    """c [m, n], a [m, k], b [k, n]: float32 views on one CUDA device
    with unit column stride, or batches [bt, ...] of such views (one
    launch for all).  Writes min(c, a (x) b) into c in place, but for
    rows in [skip_rows) and columns in [skip_cols), and returns c.  a
    and b may share memory with c only in c's skipped cells (the blocked
    schedule's phase 3: its bands); phase 2's aliased panels go through
    ``minplus_accum_panels_cuda``."""
    _check_views("minplus_accum_into", c, a, b)
    _check_alias("minplus_accum_into", c, a, b, skip_rows, skip_cols)
    with torch.cuda.device(c.device):
        launch_into(_job(c, a, b), skip_rows, skip_cols,
                    torch.cuda.current_stream().cuda_stream)
    return c


def minplus_accum_panels_cuda(row, col, *, skip_cols=(0, 0),
                              skip_rows=(0, 0)) -> None:
    """Phase 2 of the blocked FW in one launch (matrices or batches of
    them, as in ``minplus_accum_into_cuda``): ``row`` = (c, a, b) with
    at most PANEL rows gets ``minplus_accum_into_cuda(*row,
    skip_cols=skip_cols)``, ``col`` = (c, a, b) with at most PANEL
    columns ``minplus_accum_into_cuda(*col, skip_rows=skip_rows)``.  In
    ``row`` b may be the same window as c, in ``col`` a; anything else
    shares c's memory only in its skipped cells.  The two must write
    disjoint cells and neither may write what the other reads (the row
    panel and the column panel of one pivot tile, its cells skipped in
    both)."""
    (rm, _, _), (_, qn, _) = (_check_views("minplus_accum_panels", *job)
                              for job in (row, col))
    if row[0].shape[:-2] != col[0].shape[:-2]:
        raise ValueError("minplus_accum_panels kernel: the row and column "
                         "panels must cover the same matrices")
    if rm > PANEL or qn > PANEL:
        raise ValueError(f"minplus_accum_panels kernel: the row panel has "
                         f"{rm} rows, the column panel {qn} columns; at "
                         f"most {PANEL} each")
    _check_alias("minplus_accum_panels", *row, (0, 0), skip_cols, "b")
    _check_alias("minplus_accum_panels", *col, skip_rows, (0, 0), "a")
    with torch.cuda.device(row[0].device):
        launch_panels(_job(*row), skip_cols, _job(*col), skip_rows,
                      torch.cuda.current_stream().cuda_stream)


minplus_cuda.launches = 0
minplus_accum_cuda.launches = 0
minplus_accum_into_cuda.launches = 0
minplus_accum_panels_cuda.launches = 0
