"""Batched Floyd-Warshall: the CUDA kernels' Python wrappers, and the
blocked APSP schedule built on them.

Witness FW, port of ``repro/kernels/floyd_warshall.py:
fw_batch_next_pallas``: the kernel is ``csrc/fw_next.cu`` and its plain
version ``ref.fw_batch_next_ref``.  ``d[b, n, n]`` (float32, +inf = no
edge) -> ``(dist, nxt)``, array-equal to the plain version in both
outputs.  Two launch shapes on the main path, chosen by n (``route``):
``fw_next_reg`` keeps every matrix in registers up to n = REG_MAX_N
(the small piece buckets: a row a lane, 4 matrices a warp, up to n = 8;
a quarter row a thread, one block a matrix, up to 32; a 4 x 4 tile a
thread, one block a matrix, up to 64),
``fw_next_blocked`` runs the exact blocked schedule (two launches per
k-block of 32 pivots over the batch, ``ref.fw_batch_next_blocked_ref``
models it) for the fragments, the SUPER overlay, the hierarchy's
group closures and the large piece buckets.  ``fw_next_global``, one
launch per pivot, left the main path with the blocked variant and stays
callable so the two can be timed side by side.

Distance-only FW, port of ``fw_batch_pallas``, with plain version
``ref.fw_batch_ref``: ``fw_batch_cuda`` holds each matrix in one
block's registers up to n = DIST_REG_MAX_N (``fw_dist_reg`` in
``csrc/fw_dist.cu``, one launch), and above it runs the blocked
schedule below over the whole batch at once, in place on its output
(``fw_dist_blocked_cuda``: 3 launches a k-block of DIST_BLOCK pivots).
``fw_dist_smem_cuda`` (a matrix in one block's shared memory, n <= 240)
and ``fw_dist_global_cuda`` (one launch a pivot), which that route
replaced, stay callable so that the two can be timed beside it.

``fw_blocked_into`` is the 3-phase blocked APSP of ``fw_blocked`` in the
reference, run in place on a matrix or on every matrix of a batch at
once: phase 1 through ``ops.fw_batch`` on the diagonal tiles, phase 2
through ``ops.minplus_accum_panels`` and phase 3 through
``ops.minplus_accum_into`` on views of the matrices.  It is the one
blocked distance schedule: kernel 3's route above n = 128 runs it on a
batch, ``fw_blocked`` (``ops.fw_apsp``, the hierarchy's top closure) on
one padded matrix.  Each kernel wrapper counts its launches in
``.launches``; ``fw_batch_cuda`` counts ``fw_dist_reg``'s (the blocked
schedule's phase 1 included), ``fw_dist_blocked_cuda`` its calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_SIG = [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP]
_SIG_DIST = [_VP, _VP, ctypes.c_int, ctypes.c_int, _VP]
#: padded n of the register variant's shapes (``fw_next_reg`` in the
#: .cu): a row a lane at 8, a quarter row a thread at 32, a 4 x 4 tile a
#: thread at 64 (the piece buckets are 8 and 32); the blocked variant
#: takes every n above REG_MAX_N (the shared-memory variant the register
#: one replaced beat the blocked one at n <= 64 and lost above)
REG_SHAPES = (8, 32, 64)
REG_MAX_N = REG_SHAPES[-1]
#: largest n of the distance-only shared-memory variant (FWD_SMEM_MAX_N
#: in fw_dist.cu): 240 * 240 cells * 4 bytes = 225 KB
DIST_SMEM_MAX_N = 240
#: largest n of the distance-only register variant (FWD_REG_MAX_N);
#: kernel 3 runs the blocked schedule above it
DIST_REG_MAX_N = 128
#: k-block width of kernel 3's blocked route: 64 pivots, the register
#: tile of ``fw_dist_reg`` at n = 64 (timed against 128 at road64k's
#: fragments [130, 496, 496] by ``scripts/kernel_ab.py --fwdist``,
#: PERF.md)
DIST_BLOCK = 64
#: k-block widths of the blocked APSP: 64 up to n = APSP_WIDE_N, 128
#: above.  Timed at n = 1,711 and 4,661 by ``scripts/kernel_ab.py
#: --fwapsp`` (PERF.md): 64 won at 1,711 (its phase 1 is 4x cheaper a
#: k-block), 128 at 4,661 (phase 3 on the wide matrix dominates)
APSP_BLOCKS = (64, 128)
APSP_WIDE_N = 2048


def apsp_block(n: int) -> int:
    """The k-block width the blocked APSP takes for an [n, n] matrix."""
    return APSP_BLOCKS[0] if n <= APSP_WIDE_N else APSP_BLOCKS[1]


def route(n: int) -> tuple[str, int]:
    """The entry of ``csrc/fw_next.cu`` that runs a batch of [n, n]
    matrices on the main path, and the padded n it takes: ("fw_next_reg",
    the smallest of REG_SHAPES >= n) up to REG_MAX_N, else
    ("fw_next_blocked", n)."""
    for np_ in REG_SHAPES:
        if n <= np_:
            return "fw_next_reg", np_
    return "fw_next_blocked", n


def _lib() -> ctypes.CDLL:
    lib = _build.load("fw_next")
    if lib.fw_next_global.argtypes is None:
        lib.fw_next_global.argtypes = _SIG
        lib.fw_next_global.restype = ctypes.c_int
        lib.fw_next_reg.argtypes = [_VP, _VP, _VP, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, _VP]
        lib.fw_next_reg.restype = ctypes.c_int
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
        ll = ctypes.c_longlong
        lib.fw_dist_reg.argtypes = [_VP, _VP, ctypes.c_int, ctypes.c_int, ll,
                                    ll, ll, ll, _VP]
        lib.fw_dist_reg.restype = ctypes.c_int
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


#: k-block of the blocked witness FW (FWB_B in fw_next.cu's default
#: build)
FWB_B = 32


def blocked_scratch_bytes(b: int, n: int) -> int:
    """Bytes of scratch ``fw_next_blocked`` takes for b matrices of n
    nodes at the default k-block (``fw_next_blocked_scratch`` in the
    .cu): C^T, CN^T and R [b, B, n] and the closed pivot tile f32 + i32
    [b, B, B]."""
    return b * (3 * FWB_B * n + 2 * FWB_B * FWB_B) * 4


def next_buffers(d: torch.Tensor, scratch_bytes: int = 0) -> tuple:
    """What the witness FW's wrappers allocate -> (dist, nxt, scratch):
    dist like d, nxt int32, and ``scratch_bytes`` of scratch (None for
    0).  Shared by the CUDA wrappers and ``ops``' meta route."""
    dist = torch.empty_like(d)
    nxt = torch.empty(d.shape, dtype=torch.int32, device=d.device)
    scratch = (torch.empty(scratch_bytes, dtype=torch.uint8,
                           device=d.device) if scratch_bytes else None)
    return dist, nxt, scratch


def dist_out(d: torch.Tensor) -> torch.Tensor:
    """The output ``fw_batch_cuda`` allocates when given none (shared
    with ``ops``' meta route)."""
    return torch.empty_like(d, memory_format=torch.contiguous_format)


def _launch(entry: str, d: torch.Tensor, *extra: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    b, n = _check(d)
    dist, nxt, _ = next_buffers(d)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(d.data_ptr(), dist.data_ptr(),
                                     nxt.data_ptr(), b, n, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return dist, nxt


def fw_next_reg_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                torch.Tensor]:
    """Register variant: every matrix in registers, n <= REG_MAX_N."""
    entry, np_ = route(d.shape[-1])
    if entry != "fw_next_reg":
        raise ValueError(f"fw_next_reg takes n <= {REG_MAX_N}, got "
                         f"{d.shape[-1]}")
    out = _launch(entry, d, np_)
    _build.count_launch(fw_next_reg_cuda)
    return out


def fw_next_global_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Device-memory variant: one launch per pivot, any n."""
    out = _launch("fw_next_global", d)
    _build.count_launch(fw_next_global_cuda)
    return out


def fw_next_blocked_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Blocked variant: 1 + 2 * ceil(n / 32) launches, any n; scratch
    from ``torch.empty`` (the kernel allocates nothing)."""
    b, n = _check(d)
    lib = _lib()
    dist, nxt, scratch = next_buffers(d, lib.fw_next_blocked_scratch(b, n))
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fw_next_blocked(d.data_ptr(), dist.data_ptr(),
                                  nxt.data_ptr(), scratch.data_ptr(), b, n,
                                  stream)
    if err != 0:
        raise RuntimeError(f"fw_next_blocked launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(fw_next_blocked_cuda)
    return dist, nxt


fw_next_reg_cuda.launches = 0
fw_next_global_cuda.launches = 0
fw_next_blocked_cuda.launches = 0


def fw_batch_next_cuda(d: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Batched witness APSP on the card, variant chosen by n
    (``route``)."""
    if route(d.shape[-1])[0] == "fw_next_reg":
        return fw_next_reg_cuda(d)
    return fw_next_blocked_cuda(d)


def _check_rows(d: torch.Tensor, kernel: str) -> tuple[int, int]:
    """[b, n, n] float32 on the card whose rows are contiguous (any row
    and batch strides)."""
    if not d.is_cuda:
        raise ValueError(f"{kernel} kernel needs a CUDA tensor, got "
                         f"{d.device}")
    if d.dtype != torch.float32:
        raise TypeError(f"{kernel} kernel takes float32, got {d.dtype}")
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"{kernel} kernel takes [b, n, n], got "
                         f"{tuple(d.shape)}")
    if d.shape[2] > 1 and d.stride(2) != 1:
        raise ValueError(f"{kernel} kernel takes rows with unit stride")
    return d.shape[0], d.shape[1]


def fw_batch_cuda(d: torch.Tensor, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Batched distance-only APSP on the card: [b, n, n] -> dist, into
    ``out`` when given (which may be ``d`` itself) else a new tensor
    (``dist_out``).  ``d`` and ``out`` may be strided views whose rows
    are contiguous.  Up to n = DIST_REG_MAX_N each matrix sits in one
    block's registers (``fw_dist_reg``, one launch, as the blocked
    schedule's diagonal tiles are run); above it the blocked schedule
    runs over all b matrices at once, in place on ``out``
    (``fw_dist_blocked_cuda``).  A failed build or launch raises."""
    b, n = _check_rows(d, "fw_dist")
    if out is None:
        out = dist_out(d)
    elif _check_rows(out, "fw_dist") != (b, n) or out.device != d.device:
        raise ValueError(f"fw_dist kernel: out is {tuple(out.shape)} on "
                         f"{out.device}, expected {tuple(d.shape)} on "
                         f"{d.device}")
    if n > DIST_REG_MAX_N:
        return fw_dist_blocked_cuda(d, out)
    with torch.cuda.device(d.device):
        launch_dist_reg(d.data_ptr(), out.data_ptr(), b, n,
                        ld_in=d.stride(1), ld_out=out.stride(1),
                        bs_in=d.stride(0), bs_out=out.stride(0),
                        stream=torch.cuda.current_stream().cuda_stream)
    return out


def fw_dist_blocked_cuda(d: torch.Tensor, out: torch.Tensor
                         ) -> torch.Tensor:
    """Kernel 3 above DIST_REG_MAX_N (``fw_batch_cuda`` checks the
    operands and calls this): ``d`` copied into ``out`` (unless it is
    ``out``), then ``fw_blocked_into`` on ``out`` in k-blocks of
    DIST_BLOCK, every matrix of the batch at once: per k-block one
    ``fw_dist_reg`` launch over the b pivot tiles, one
    ``minplus_accum_panels`` over the 2 b panels and one
    ``minplus_accum_ld`` over the rest of every matrix.  No padding and
    no scratch: the last k-block is short and the kernels mask the
    ragged edge.  Counts its calls; the three kernels count their
    launches on their own wrappers."""
    if not (out.data_ptr() == d.data_ptr() and out.stride() == d.stride()):
        out.copy_(d)
    _blocked_cuda(out, blocked_steps(d.shape[-1], DIST_BLOCK), DIST_BLOCK)
    _build.count_launch(fw_dist_blocked_cuda)
    return out


def _dist_baseline(entry: str, d: torch.Tensor, out) -> torch.Tensor:
    _check(d, entry)
    if out is None:
        out = dist_out(d)
    elif out.shape != d.shape or not out.is_contiguous():
        raise ValueError(f"{entry} kernel: out must be contiguous "
                         f"{tuple(d.shape)}, got {tuple(out.shape)}")
    with torch.cuda.device(d.device):
        err = getattr(_dist_lib(), entry)(
            d.data_ptr(), out.data_ptr(), d.shape[0], d.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def fw_dist_smem_cuda(d: torch.Tensor, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The shared-memory variant of kernel 3 (one block a matrix, n <=
    DIST_SMEM_MAX_N, contiguous operands): off the route since the
    blocked one took n above 128, kept to be timed beside it."""
    if d.shape[-1] > DIST_SMEM_MAX_N:
        raise ValueError(f"fw_dist_smem takes n <= {DIST_SMEM_MAX_N}, got "
                         f"{d.shape[-1]}")
    out = _dist_baseline("fw_dist_smem", d, out)
    _build.count_launch(fw_dist_smem_cuda)
    return out


def fw_dist_global_cuda(d: torch.Tensor, out: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The per-pivot variant of kernel 3 (an init launch, then one a
    pivot, any n, contiguous operands): off the route since the blocked
    one, kept to be timed beside it."""
    out = _dist_baseline("fw_dist_global", d, out)
    _build.count_launch(fw_dist_global_cuda)
    return out


def launch_dist_reg(din: int, dout: int, b: int, n: int, *, ld_in: int,
                    ld_out: int, bs_in: int, bs_out: int,
                    stream: int) -> None:
    """One launch of ``fw_dist_reg`` (the one place that packs its C
    arguments: device addresses, row and batch strides in elements):
    the launch site of ``fw_batch_cuda`` at n <= DIST_REG_MAX_N and of
    the blocked schedule.  Counts the launch."""
    err = _dist_lib().fw_dist_reg(din, dout, b, n, ld_in, ld_out, bs_in,
                                  bs_out, stream)
    if err != 0:
        raise RuntimeError(f"fw_dist_reg launch failed: CUDA error {err}")
    _build.count_launch(fw_batch_cuda)


fw_batch_cuda.launches = 0
fw_dist_blocked_cuda.launches = 0
fw_dist_smem_cuda.launches = 0
fw_dist_global_cuda.launches = 0


def blocked_steps(n: int, block: int):
    """The launches of the blocked schedule on an [n, n] matrix (each
    matrix of a batch alike), in order, each operand a window (row, col,
    rows, cols) of the matrix.  Per k-block K = [s, e), e = min(s +
    block, n) (the last one short where block does not divide n):
      ("fw", tile):                           phase 1 on the pivot tile;
      ("p2", (c, a, b), skip_cols, (c, a, b), skip_rows):
          phase 2, the row panel (C = B, the pivot columns skipped) and
          the column panel (C = A, the pivot rows skipped) at once;
      ("mp", c, a, b, skip_rows, skip_cols):  phase 3 on the whole
          matrix, the band skipped."""
    for s in range(0, n, block):
        e = min(s + block, n)
        w = e - s
        piv, row, col = (s, s, w, w), (s, 0, w, n), (0, s, n, w)
        yield ("fw", piv)
        yield ("p2", (row, piv, row), (s, e), (col, col, piv), (s, e))
        yield ("mp", (0, 0, n, n), col, row, (s, e), (s, e))


def fw_blocked_into(x: torch.Tensor, *, block: int, force=None
                    ) -> torch.Tensor:
    """The 3-phase blocked Floyd-Warshall in place on x, one [n, n]
    matrix or every matrix of a batch [b, n, n] at once, in k-blocks of
    ``block`` pivots (at most 128 on the card); returns x.  Per k-block
    K = [s, e), with P = D[K, K] (of each matrix):
      phase 1: P = FW(P), in place, diagonal 0           (ops.fw_batch)
      phase 2: D[K, *] = min(D[K, *], P (x) D[K, *]), columns K kept;
               D[*, K] = min(D[*, K], D[*, K] (x) P), rows K kept
                                              (ops.minplus_accum_panels)
      phase 3: D = min(D, D[*, K] (x) D[K, *]), rows and columns K kept
                                                (ops.minplus_accum_into)
    The kept cells are the reference's fixed points: a closed P gives
    min(P, P (x) P) = P, and after phase 2 the bands are closed under
    phase 3, so on integer-valued input (exact sums) this equals the
    serial reference, which rewrites them.  A diagonal cell is first
    read as a pivot's, in its own phase 1, which sets it to 0, so x
    needs no zeroed diagonal: the result is the reference's.  The
    launches are ``blocked_steps``: on the card they go straight to the
    kernels' launch sites (``_card_launches``), elsewhere through
    ``ops`` (the plain versions) on views of the same windows, so the
    CPU tests hold the windows the card's pointers are computed from.
    On ``meta`` nothing is launched or allocated."""
    from . import ops                  # ops imports this module
    steps = blocked_steps(x.shape[-1], block)
    if x.device.type == "meta" and force != "ref":
        return x
    if ops.use_kernel(x.device, force):
        _blocked_cuda(x, steps, block)
        return x

    def view(w):
        return x[..., w[0]:w[0] + w[2], w[1]:w[1] + w[3]]
    for step in steps:
        if step[0] == "fw":
            tile = view(step[1])
            tile = tile if tile.dim() == 3 else tile[None]
            ops.fw_batch(tile, out=tile, force=force)
        elif step[0] == "p2":
            _, row, skip_c, col, skip_r = step
            ops.minplus_accum_panels(
                tuple(map(view, row)), tuple(map(view, col)),
                skip_cols=skip_c, skip_rows=skip_r, force=force)
        else:
            _, c, a, b, skip_r, skip_c = step
            ops.minplus_accum_into(view(c), view(a), view(b),
                                   skip_rows=skip_r, skip_cols=skip_c,
                                   force=force)
    return x


def fw_blocked(d: torch.Tensor, *, block: int | None = None, force=None
               ) -> torch.Tensor:
    """The reference's ``fw_blocked`` for one [n, n] matrix: padded to a
    multiple of ``block`` (default ``apsp_block(n)``) with +inf,
    diagonal 0, allocated once (the padded rows keep the card's loads
    16 bytes wide at any n), closed by ``fw_blocked_into`` in place, the
    [n, n] corner returned."""
    n = d.shape[0]
    block = block or apsp_block(n)
    np_ = -(-n // block) * block
    pad = torch.full((np_, np_), float("inf"), dtype=d.dtype,
                     device=d.device)
    pad[:n, :n] = d
    pad.fill_diagonal_(0.0)
    fw_blocked_into(pad, block=block, force=force)
    return pad[:n, :n].contiguous()


def _card_launches(x: torch.Tensor, steps):
    """The launches of ``steps`` on x (a matrix [n, n] or a batch
    [b, n, n]) as the card's launch sites take them, every operand's
    address computed from its window (row r, column c: r * ld + c
    elements into each matrix), with x's row stride ld and batch stride
    (0 for one matrix):
      ("fw", address, b, rows, ld, batch stride)   ``launch_dist_reg``
      ("p2", row Job, skip_cols, col Job, skip_rows)  ``launch_panels``
      ("mp", Job, skip_rows, skip_cols)               ``launch_into``"""
    from .minplus import Job
    x3 = x if x.dim() == 3 else x[None]
    b, ld = x3.shape[0], x3.stride(1)
    bs = x3.stride(0) if b > 1 else 0
    base = x3.data_ptr()

    def ptr(w):
        return base + 4 * (w[0] * ld + w[1])

    def job(c, a, bb):
        return Job(c=ptr(c), ldc=ld, a=ptr(a), lda=ld, b=ptr(bb), ldb=ld,
                   m=c[2], n=c[3], k=a[3], batch=b, bsc=bs, bsa=bs, bsb=bs)
    for step in steps:
        if step[0] == "fw":
            yield ("fw", ptr(step[1]), b, step[1][2], ld, bs)
        elif step[0] == "p2":
            _, row, skip_c, col, skip_r = step
            yield ("p2", job(*row), skip_c, job(*col), skip_r)
        else:
            _, c, a, bb, skip_r, skip_c = step
            yield ("mp", job(c, a, bb), skip_r, skip_c)


def _blocked_cuda(x: torch.Tensor, steps, block: int) -> None:
    """The blocked schedule's launches on the card (``_card_launches``),
    with no tensor view or check a launch: every window lies inside
    each matrix of x, the matrices do not overlap, and the aliasing is
    the one ``csrc/minplus.cu`` allows."""
    from .minplus import PANEL, launch_into, launch_panels
    if block > min(PANEL, DIST_REG_MAX_N):
        raise ValueError(f"fw_blocked on the card takes block <= "
                         f"{min(PANEL, DIST_REG_MAX_N)}, got {block}")
    x3 = x if x.dim() == 3 else x[None]
    b, n = _check_rows(x3, "fw_blocked")
    if b > 1 and x3.stride(0) < (n - 1) * x3.stride(1) + n:
        raise ValueError("fw_blocked: the matrices of the batch overlap")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in _card_launches(x, steps):
            if launch[0] == "fw":
                _, p, bt, w, ld, bs = launch
                launch_dist_reg(p, p, bt, w, ld_in=ld, ld_out=ld, bs_in=bs,
                                bs_out=bs, stream=stream)
            elif launch[0] == "p2":
                launch_panels(*launch[1:], stream)
            else:
                launch_into(*launch[1:], stream)
