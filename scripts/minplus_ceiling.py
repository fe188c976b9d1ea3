#!/usr/bin/env python3
"""Measure the issue ceiling of the (min,+) micro-tile's inner step.

    PYTHONPATH=src python3 scripts/minplus_ceiling.py

Needs one NVIDIA card and ``nvcc``.  Builds a small CUDA source of its
own (below; the port's flags) in a temporary directory and times the
8 x 4 register micro-tile of ``csrc/twoside_tiles.cuh`` -- 256 threads,
a 64 x 64 output tile a block, three 16-byte shared loads per x, 32
independent accumulators a thread -- over one resident 32-deep shared
tile, in these forms of the step acc = min(acc, r + d):

* ``f32_add_min``: float32, ``fminf(acc, r + d)`` (FADD + FMNMX), the
  tile kernels' step before they took the three-way min;
* ``i32_dpx``: int32, ``__viaddmin_s32(r, d, acc)`` (one DPX
  instruction, VIADDMNMX, on sm_90); +inf is the key 2**30 - 1;
* ``i32_add_min``: int32, ``min(r + d, acc)`` (IADD + IMNMX, unless
  the compiler fuses them);
* ``f32_add_bits_min3``: float32 adds, two x at a time into one
  three-way int32 min of the bit patterns (``__vimin3_s32``), the tile
  kernels' step;

and two instruction probes, one instruction a triple and no result
check: ``probe_fmnmx`` (FMNMX alone) and ``probe_fadd`` (FADD alone).
The probes read what the loop around the step allows: the three shared
loads per x stay in it, so ``probe_fadd`` stops well below FADD's
nominal rate.  This loop ranks the forms otherwise than the kernels do
(it reads DPX above the three-way min, the kernels the reverse, and
their float pair runs ~1.35x faster than this one's): its ratios say
what the step costs here, and the kernels' own times (``chip_smoke.py``
against a checkout of the commit before) decide.

Each form runs at 8 and 16 resident warps an SM (one and two blocks of
256 threads on each SM the card reports).  Per case it prints one JSON line:
triples/s from CUDA events over the launches, triples per SM-clock from
the blocks' own ``clock64`` intervals (per SM: its blocks' triples over
the span from their first start to their last end), the SM clock that
``nvidia-smi`` read while the launches ran and the triples per
SM-clock that clock gives, and whether the tile's result equals the
plain version.  Then each form's rate over the float pair's at each
residency, the opcodes of each form's kernel (``cuobjdump -sass``, whose
whole listing goes to ``chiprun_out/minplus_ceiling.sass``), and the
card's name and power limit.  Writes the lines to
``chiprun_out/minplus_ceiling.jsonl`` as well; exits 1 if a form's
result differs from the plain version.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FORMS = ("f32_add_min", "i32_dpx", "i32_add_min", "f32_add_bits_min3",
         "probe_fmnmx", "probe_fadd")
PROBES = (4, 5)                 # one instruction a triple, no result check
INT_TILES = (1, 2)              # forms whose tiles hold int32 keys
INF_BITS = 0x7F800000           # +inf's bits, the three-way min's start
TRIPLES_PER_TILE = 64 * 64 * 32
SENTINEL = 2**30 - 1
REPS = 4096                     # passes over the tile a launch, 16 warps/SM
LAUNCHES = 40

SOURCE = r"""
#include <cuda_runtime.h>

#define BQ 64
#define BY 64
#define BX 32
#define MQ 8
#define MY 4
#define TY (BY / MY)
#define THREADS 256

// Step<F>::two(acc, r0, d0, r1, d1): acc after the triples of two x,
// r0 + d0 and r1 + d1, in form F; T is the tiles' type, A the acc's.
template <int F> struct Step;
template <> struct Step<0> {                 // f32_add_min
  typedef float T;
  typedef float A;
  static __device__ __forceinline__ A two(A a, T r0, T d0, T r1, T d1) {
    return fminf(fminf(a, r0 + d0), r1 + d1);
  }
};
template <> struct Step<1> {                 // i32_dpx
  typedef int T;
  typedef int A;
  static __device__ __forceinline__ A two(A a, T r0, T d0, T r1, T d1) {
    return __viaddmin_s32(r1, d1, __viaddmin_s32(r0, d0, a));
  }
};
template <> struct Step<2> {                 // i32_add_min
  typedef int T;
  typedef int A;
  static __device__ __forceinline__ A two(A a, T r0, T d0, T r1, T d1) {
    return min(r1 + d1, min(r0 + d0, a));
  }
};
template <> struct Step<3> {                 // f32_add_bits_min3
  typedef float T;
  typedef int A;
  static __device__ __forceinline__ A two(A a, T r0, T d0, T r1, T d1) {
    return __vimin3_s32(a, __float_as_int(r0 + d0), __float_as_int(r1 + d1));
  }
};
// instruction probes, not (min,+) steps: one FMNMX, or one FADD, a triple
template <> struct Step<4> {                 // probe_fmnmx
  typedef float T;
  typedef float A;
  static __device__ __forceinline__ A two(A a, T r0, T d0, T r1, T d1) {
    return fminf(fminf(a, r0), r1);
  }
};
template <> struct Step<5> {                 // probe_fadd
  typedef float T;
  typedef float A;
  static __device__ __forceinline__ A two(A a, T r0, T d0, T r1, T d1) {
    return (a + r0) + r1;
  }
};

template <class T> struct Vec4;
template <> struct Vec4<float> { typedef float4 V; };
template <> struct Vec4<int> { typedef int4 V; };

template <int F>
__global__ void __launch_bounds__(THREADS)
ceiling(const void* __restrict__ rg, const void* __restrict__ dg,
        const void* __restrict__ init, void* __restrict__ out,
        long long* __restrict__ clk, int reps) {
  typedef typename Step<F>::T T;
  typedef typename Step<F>::A A;
  typedef typename Vec4<T>::V T4;
  __shared__ __align__(16) T rs[BX][BQ];
  __shared__ __align__(16) T ds[BX][BY];
  for (int i = threadIdx.x; i < BX * BQ; i += THREADS) {
    (&rs[0][0])[i] = ((const T*)rg)[i];
    (&ds[0][0])[i] = ((const T*)dg)[i];
  }
  const A a0 = *(const A*)init;
  __syncthreads();
  const int ty = threadIdx.x % TY, tq = threadIdx.x / TY;
  A acc[MQ][MY];
#pragma unroll
  for (int a = 0; a < MQ; ++a)
#pragma unroll
    for (int b = 0; b < MY; ++b)   // the probes' accumulators differ
      acc[a][b] = F < 4 ? a0 : a0 + (A)(a * MY + b);
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 2
    for (int xx = 0; xx < BX; xx += 2) {
      T rv[2][MQ], dv[2][MY];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T4 r0 = *reinterpret_cast<const T4*>(&rs[xx + h][tq * MQ]);
        const T4 r1 = *reinterpret_cast<const T4*>(&rs[xx + h][tq * MQ + 4]);
        const T4 dq = *reinterpret_cast<const T4*>(&ds[xx + h][ty * MY]);
        rv[h][0] = r0.x; rv[h][1] = r0.y; rv[h][2] = r0.z; rv[h][3] = r0.w;
        rv[h][4] = r1.x; rv[h][5] = r1.y; rv[h][6] = r1.z; rv[h][7] = r1.w;
        dv[h][0] = dq.x; dv[h][1] = dq.y; dv[h][2] = dq.z; dv[h][3] = dq.w;
      }
#pragma unroll
      for (int a = 0; a < MQ; ++a)
#pragma unroll
        for (int b = 0; b < MY; ++b)
          acc[a][b] = Step<F>::two(acc[a][b], rv[0][a], dv[0][b], rv[1][a],
                                   dv[1][b]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    clk[blockIdx.x * 3] = t0;
    clk[blockIdx.x * 3 + 1] = clock64();
    clk[blockIdx.x * 3 + 2] = sm;
  }
  A* o = (A*)out + (size_t)blockIdx.x * BQ * BY;
#pragma unroll
  for (int a = 0; a < MQ; ++a)
#pragma unroll
    for (int b = 0; b < MY; ++b)
      o[(tq * MQ + a) * BY + ty * MY + b] = acc[a][b];
}

#define LAUNCH(F)                                                     \
  ceiling<F><<<blocks, THREADS, 0, st>>>(rg, dg, init, out,           \
                                         (long long*)clk, reps)

extern "C" int ceiling_run(int form, const void* rg, const void* dg,
                           const void* init, void* out, void* clk,
                           int blocks, int reps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    case 5: LAUNCH(5); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def _build(where: Path):
    from repro_torch.kernels import _build as b
    src = where / "minplus_ceiling.cu"
    src.write_text(SOURCE)
    out = where / "minplus_ceiling.so"
    subprocess.run([b.nvcc(), *b.NVCC_FLAGS, "-o", str(out), str(src)],
                   capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ceiling_run.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci, vp]
    lib.ceiling_run.restype = ci
    return lib, out


def _sass_opcodes(lib_path: Path) -> dict[str, dict[str, int]]:
    """Opcode counts of each form's kernel in the compiled library."""
    from repro_torch.kernels import _build as b
    tool = Path(b.nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        return {"error": {res.stderr.strip()[:200]: 1}}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "minplus_ceiling.sass").write_text(res.stdout)
    counts: dict[str, Counter] = {}
    cur = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : \S*ceilingILi(\d)E", line)
        if m:
            cur = counts.setdefault(FORMS[int(m.group(1))], Counter())
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_.]+)?\b", line)
        if cur is not None and m:
            cur[m.group(1)] += 1
    keep = ("FADD", "FMNMX", "VIADDMNMX", "IMNMX", "VIMNMX", "VIMNMX3",
            "LDS")
    return {f: {k: v for k, v in sorted(c.items()) if k in keep}
            for f, c in counts.items()}


def _sm_clock_mhz() -> float | None:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(res.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("minplus_ceiling: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as where:
        lib, lib_path = _build(Path(where))
        ops = {"sass_opcodes": _sass_opcodes(lib_path)}
        return _run(lib, ops)


def _run(lib, ops: dict) -> int:
    import numpy as np
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    r = rng.integers(0, 2**23, (32, 64))
    d = rng.integers(0, 2**23, (32, 64))
    r_inf = rng.random(r.shape) < 0.2
    d_inf = rng.random(d.shape) < 0.2
    rf, df = r.astype(np.float32), d.astype(np.float32)
    rf[r_inf] = np.inf
    df[d_inf] = np.inf
    plain = np.min(rf[:, :, None] + df[:, None, :], axis=0)   # [q, y]
    ri, di = r.astype(np.int32), d.astype(np.int32)
    ri[r_inf] = SENTINEL
    di[d_inf] = SENTINEL
    f_tiles = (torch.from_numpy(rf).to(dev), torch.from_numpy(df).to(dev))
    i_tiles = (torch.from_numpy(ri).to(dev), torch.from_numpy(di).to(dev))
    inits = {0: torch.tensor([np.inf], dtype=torch.float32, device=dev)}
    for form in PROBES:
        inits[form] = torch.tensor([0.0], dtype=torch.float32, device=dev)
    for form in INT_TILES:
        inits[form] = torch.tensor([SENTINEL], dtype=torch.int32,
                                   device=dev)
    inits[3] = torch.tensor([INF_BITS], dtype=torch.int32, device=dev)
    lines = []
    speed: dict[tuple[int, str], float] = {}
    for warps in (8, 16):
        blocks = sms * warps // 8
        reps = REPS * 16 // warps
        for form, name in enumerate(FORMS):
            rg, dg = i_tiles if form in INT_TILES else f_tiles
            init = inits[form]
            out = torch.empty((blocks, 64, 64), dtype=init.dtype, device=dev)
            clk = torch.zeros((blocks, 3), dtype=torch.int64, device=dev)

            def launch():
                err = lib.ceiling_run(form, rg.data_ptr(), dg.data_ptr(),
                                      init.data_ptr(), out.data_ptr(),
                                      clk.data_ptr(), blocks, reps, stream)
                if err:
                    raise RuntimeError(f"ceiling_run: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            got = out[0].cpu().numpy()
            if form in INT_TILES:
                back = np.where(got >= SENTINEL, np.inf,
                                got.astype(np.float32))
            else:
                back = got.view(np.float32)
            equal = None if form in PROBES else bool(
                np.array_equal(back, plain))
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(LAUNCHES):
                launch()
            t1.record()
            mhz = _sm_clock_mhz()          # read while the launches run
            torch.cuda.synchronize()
            secs = t0.elapsed_time(t1) / 1e3 / LAUNCHES
            triples = blocks * TRIPLES_PER_TILE * reps
            per_s = triples / secs
            c = clk.cpu().numpy()          # the last launch's blocks
            per_sm = []
            for sm in np.unique(c[:, 2]):
                mine = c[c[:, 2] == sm]
                span = mine[:, 1].max() - mine[:, 0].min()
                per_sm.append(len(mine) * TRIPLES_PER_TILE * reps / span)
            rec = {"form": name, "warps_per_sm": warps, "blocks": blocks,
                   "reps": reps, "equal_plain": equal,
                   "ms_per_launch": secs * 1e3, "triples_per_s": per_s,
                   "triples_per_sm_clock_clock64": float(np.mean(per_sm)),
                   "sms_seen": int(len(per_sm)), "sm_clock_mhz": mhz,
                   "triples_per_sm_clock_smi":
                       per_s / (sms * mhz * 1e6) if mhz else None}
            speed[(warps, name)] = per_s
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    for warps in (8, 16):
        rec = {"warps_per_sm": warps, "ratio_to_f32_add_min": {
            f: speed[(warps, f)] / speed[(warps, "f32_add_min")]
            for f in FORMS[1:]}}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    lines.append(ops)
    print(json.dumps(ops), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = {"card": smi.stdout.strip(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    lines.append(card)
    print(json.dumps(card), flush=True)
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    with open(outdir / "minplus_ceiling.jsonl", "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    return 0 if all(r.get("equal_plain") is not False for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
