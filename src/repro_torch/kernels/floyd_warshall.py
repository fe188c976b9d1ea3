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

Distance-only FW, port of ``fw_batch_pallas``: the kernel is
``csrc/fw_dist.cu`` (each matrix in one block's registers up to n =
128, in shared memory up to n = 240, one launch per pivot above) and its
plain version ``ref.fw_batch_ref``.

``fw_blocked`` is the 3-phase blocked APSP of ``fw_blocked`` in the
reference, run in place on one padded matrix: phase 1 through
``ops.fw_batch`` on the diagonal tile, phase 2 through
``ops.minplus_accum_panels`` and phase 3 through
``ops.minplus_accum_into`` on views of the matrix.  Each kernel wrapper
counts its launches in ``.launches``; ``fw_batch_cuda`` counts the
distance-only FW's register and shared-memory variants, and
``fw_dist_global_cuda``, which it calls above n = 240, the per-pivot
one.
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
#: largest n of the distance-only register variant (FWD_REG_MAX_N)
DIST_REG_MAX_N = 128
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
    fw_next_reg_cuda.launches += 1
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
    dist, nxt, scratch = next_buffers(d, lib.fw_next_blocked_scratch(b, n))
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
    ``out`` when given (which may be ``d`` itself) else a new tensor.
    Up to n = DIST_REG_MAX_N each matrix sits in one block's registers
    and ``d`` and ``out`` may be strided views (rows contiguous), as the
    blocked schedule's diagonal tile is; above that ``d`` and ``out``
    are contiguous, the shared-memory variant takes n <= DIST_SMEM_MAX_N
    and one launch a pivot the rest."""
    b, n = _check_rows(d, "fw_dist")
    if out is None:
        out = dist_out(d)
    elif _check_rows(out, "fw_dist") != (b, n) or out.device != d.device:
        raise ValueError(f"fw_dist kernel: out is {tuple(out.shape)} on "
                         f"{out.device}, expected {tuple(d.shape)} on "
                         f"{d.device}")
    if n > DIST_REG_MAX_N and not (d.is_contiguous()
                                   and out.is_contiguous()):
        raise ValueError(f"fw_dist kernel takes contiguous tensors above "
                         f"n = {DIST_REG_MAX_N}")
    if n > DIST_SMEM_MAX_N:
        return fw_dist_global_cuda(d, out)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if n <= DIST_REG_MAX_N:
            launch_dist_reg(d.data_ptr(), out.data_ptr(), b, n,
                            ld_in=d.stride(1), ld_out=out.stride(1),
                            bs_in=d.stride(0), bs_out=out.stride(0),
                            stream=stream)
            return out
        err = _dist_lib().fw_dist_smem(d.data_ptr(), out.data_ptr(), b, n,
                                       stream)
    if err != 0:
        raise RuntimeError(f"fw_dist_smem launch failed: CUDA error {err}")
    fw_batch_cuda.launches += 1
    return out


def fw_dist_global_cuda(d: torch.Tensor, out: torch.Tensor
                        ) -> torch.Tensor:
    """The per-pivot variant of kernel 3 (one launch a pivot, any n):
    ``fw_batch_cuda``'s route above DIST_SMEM_MAX_N, which checks the
    operands (contiguous [b, n, n] float32 on one card) and calls this.
    Its launches are counted here, apart from the other variants'."""
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _dist_lib().fw_dist_global(d.data_ptr(), out.data_ptr(),
                                         d.shape[0], d.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"fw_dist_global launch failed: CUDA error "
                           f"{err}")
    fw_dist_global_cuda.launches += 1
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
    fw_batch_cuda.launches += 1


fw_batch_cuda.launches = 0
fw_dist_global_cuda.launches = 0


def blocked_steps(np_: int, block: int):
    """The launches of the blocked schedule on a padded [np_, np_]
    matrix, in order, each operand a window (row, col, rows, cols) of
    the matrix.  Per k-block K = [s, e):
      ("fw", tile):                           phase 1 on the pivot tile;
      ("p2", (c, a, b), skip_cols, (c, a, b), skip_rows):
          phase 2, the row panel (C = B, the pivot columns skipped) and
          the column panel (C = A, the pivot rows skipped) at once;
      ("mp", c, a, b, skip_rows, skip_cols):  phase 3 on the whole
          matrix, the band skipped."""
    for s in range(0, np_, block):
        e = s + block
        piv, row, col = (s, s, block, block), (s, 0, block, np_), \
            (0, s, np_, block)
        yield ("fw", piv)
        yield ("p2", (row, piv, row), (s, e), (col, col, piv), (s, e))
        yield ("mp", (0, 0, np_, np_), col, row, (s, e), (s, e))


def fw_blocked(d: torch.Tensor, *, block: int | None = None, force=None
               ) -> torch.Tensor:
    """3-phase blocked Floyd-Warshall for one [n, n] matrix, the
    reference's ``fw_blocked`` schedule, in place on one padded matrix,
    in k-blocks of ``block`` (default ``apsp_block(n)``).

    Pads to a block multiple with +inf (diagonal 0), allocated once.
    Per k-block K = [s, e), with P = D[K, K]:
      phase 1: P = FW(P), in place                     (ops.fw_batch)
      phase 2: D[K, *] = min(D[K, *], P (x) D[K, *]), columns K kept;
               D[*, K] = min(D[*, K], D[*, K] (x) P), rows K kept
                                              (ops.minplus_accum_panels)
      phase 3: D = min(D, D[*, K] (x) D[K, *]), rows and columns K kept
                                                (ops.minplus_accum_into)
    The kept cells are the reference's fixed points: a closed P gives
    min(P, P (x) P) = P, and after phase 2 the bands are closed under
    phase 3, so on integer-valued input (exact sums) this equals the
    reference, which rewrites them.  The launches are
    ``blocked_steps``: on the card they go straight to the kernels'
    launch sites (block <= 128, so each phase-2 panel fits one tile's
    rows or columns), on the CPU through ``ops`` (the plain versions) on
    views of the same windows, so the CPU tests hold the windows the
    card's pointers are computed from.
    """
    from . import ops                  # ops imports this module
    n = d.shape[0]
    block = block or apsp_block(n)
    np_ = -(-n // block) * block
    pad = torch.full((np_, np_), float("inf"), dtype=d.dtype,
                     device=d.device)
    pad[:n, :n] = d
    pad.fill_diagonal_(0.0)
    steps = blocked_steps(np_, block)
    if pad.device.type == "meta" and force != "ref":
        pass                       # in place on the card: nothing allocated
    elif ops.use_kernel(pad.device, force):
        _blocked_cuda(pad, steps, block)
    else:
        def view(w):
            return pad[w[0]:w[0] + w[2], w[1]:w[1] + w[3]]
        for step in steps:
            if step[0] == "fw":
                tile = view(step[1])[None]
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
    return pad[:n, :n].contiguous()


def _blocked_cuda(pad: torch.Tensor, steps, block: int) -> None:
    """The blocked schedule's launches on the card: each step's operands
    computed from its windows (element offset row * np + col into
    ``pad``) and handed to the kernels' launch sites, with no tensor
    view or check a launch, since every window lies inside ``pad`` and
    the aliasing is the one ``csrc/minplus.cu`` allows."""
    from .minplus import PANEL, Job, launch_into, launch_panels
    if block > min(PANEL, DIST_REG_MAX_N):
        raise ValueError(f"fw_blocked on the card takes block <= "
                         f"{min(PANEL, DIST_REG_MAX_N)}, got {block}")
    _check_rows(pad[None], "fw_blocked")
    if not pad.is_contiguous():
        raise ValueError("fw_blocked: the padded matrix must be contiguous")
    np_ = pad.shape[0]
    base = pad.data_ptr()

    def ptr(w):
        return base + 4 * (w[0] * np_ + w[1])

    def job(c, a, b):
        return Job(c=ptr(c), ldc=np_, a=ptr(a), lda=np_, b=ptr(b), ldb=np_,
                   m=c[2], n=c[3], k=a[3])
    with torch.cuda.device(pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in steps:
            if step[0] == "fw":
                p = ptr(step[1])
                launch_dist_reg(p, p, 1, block, ld_in=np_, ld_out=np_,
                                bs_in=np_ * np_, bs_out=np_ * np_,
                                stream=stream)
            elif step[0] == "p2":
                _, row, skip_c, col, skip_r = step
                launch_panels(job(*row), skip_c, job(*col), skip_r, stream)
            else:
                _, c, a, b, skip_r, skip_c = step
                launch_into(job(c, a, b), skip_r, skip_c, stream)
