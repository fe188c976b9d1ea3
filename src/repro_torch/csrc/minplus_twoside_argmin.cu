// Witness-carrying two-sided tropical contraction for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/minplus_twoside.py:
// minplus_twoside_argmin_pallas (_twoside_argmin_kernel), the combine
// of the witness (path) serve mode:
//   out[q] = min_{x, y} rows[q, x] + d[x, y] + rowt[q, y]
// plus the winning pair (x, y), with rows [Q, K1], d [K1, K2],
// rowt [Q, K2] (float32, +inf absorbing), never forming the cube.
//
// Tie rule (that of the plain version ref.minplus_twoside_argmin_ref):
// among the cells at the minimum the smallest y wins, then the smallest
// x for that y.  The Pallas kernel takes the smallest packed x*K2p + y
// instead; both witnesses achieve the same minimum.
//
// Two launches, no host-side finish:
//  * twoside_argmin_kernel: grid (y-tiles of 64, q-tiles of 64,
//    x-splits).  Each block walks its contiguous x range through
//    32-deep tiles twice.  Pass 1 keeps an 8 x 4 register micro-tile
//    per thread of acc[q, y] = min_x rows + d: an add a cell and a
//    three-way min of the bits per two cells, with no winning x carried
//    beside every cell.
//    After adding rowt the block reduces its y-tile on (value, y): per
//    query the smallest y* at its minimum, and acc[q, y*].  Pass 2 walks
//    the same tiles again and finds, per query, the smallest x of the
//    range with rows[q, x] + d[x, y*] == acc[q, y*] (the same add, so
//    the same bits), stopping once every query has its x.  That is the
//    x a strict-< ascending scan would have kept, so the block writes
//    one partial value and one packed witness y * K1 + x (int64) per
//    (q, y-tile, x-split).
//  * twoside_argmin_finish: one warp per query takes the minimum over
//    the partials and, among those at it, the smallest packed witness:
//    y-tiles are disjoint y ranges and x-splits disjoint x ranges, so
//    that is the smallest y, then its smallest x.  It writes out f32 and
//    wx, wy int32 (-1 where out is +inf).
// ref.minplus_twoside_argmin_split_ref models the partials and finish.
//
// What the design does about the serve path's shapes:
//  * small grids: the caller splits x when q-tiles x y-tiles is under
//    two waves (264 blocks on 132 SMs), so a 16-query bucket still
//    fills the card;
//  * mostly-+inf rows (scattered boundary rows, a few finite entries a
//    row): each staged 64 x 32 rows tile is voted on with
//    __syncthreads_or; a tile with no finite entry skips its d tile load
//    and its loop (uniform across the block), in both passes;
//  * the loop: d tiles double-buffered with cp.async so the next tile's
//    load overlaps this tile's loop; rows tiles are stored transposed,
//    so a thread's 8 queries and 4 y columns are three float4 shared
//    loads per x.
//
// The walk, its staging schedule and the pass-1 loop are the ones of
// twoside_tiles.cuh, shared with the distance kernel
// (minplus_twoside.cu); this file stages dense rows and d tiles.
//
// Bound on this card: as minplus_twoside.cu, 2 float32 operations per
// finite (q, x, y) triple outside the tensor cores, bound by operations
// at the serve path's shapes; pass 1 issues 1.5 instructions a cell,
// pass 2 a compare per (query, x) up to the witness and a second read
// of the d tiles.
//
// Exact: integer-valued inputs keep every sum below 2**24, so the
// values and the equalities the tie rule compares are the plain
// version's bits; pass 1's int32 min of the sums' bits is the bits of
// their float min for the non-negative inputs every caller passes
// (twoside_tiles.cuh).  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "twoside_tiles.cuh"

// Stage rows[q0 + 0..63, x0 + 0..31] into rs (plain loads, consecutive
// threads on consecutive queries so the transposed stores are
// conflict-free); returns whether this thread saw a finite entry.
__device__ __forceinline__ int stage_rows(float (*rs)[TA_BQ],
                                          const float* __restrict__ rows,
                                          int Q, int K1, int q0, int x0,
                                          int xb) {
  const float inf = __int_as_float(0x7f800000);
  int fin = 0;
#pragma unroll
  for (int m = 0; m < TA_BQ * TA_BX / TA_THREADS; ++m) {
    const int c = threadIdx.x + m * TA_THREADS;
    const int qq = c % TA_BQ, xx = c / TA_BQ;
    const int q = q0 + qq, x = x0 + xx;
    const float v = (q < Q && x < xb) ? rows[(size_t)q * K1 + x] : inf;
    rs[xx][qq] = v;
    fin |= v != inf;
  }
  return fin;
}

// Start the copy of d[x0 + 0..31, y0 + 0..63] into ds (cp.async; the
// ragged edge is stored as +inf directly).
__device__ __forceinline__ void stage_d(float (*ds)[TA_BY],
                                        const float* __restrict__ d, int K2,
                                        int x0, int xb, int y0) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int m = 0; m < TA_BX * TA_BY / TA_THREADS; ++m) {
    const int c = threadIdx.x + m * TA_THREADS;
    const int xx = c / TA_BY, yy = c % TA_BY;
    const int x = x0 + xx, y = y0 + yy;
    if (x < xb && y < K2) {
      cp_async4(&ds[xx][yy], d + (size_t)x * K2 + y);
    } else {
      ds[xx][yy] = inf;
    }
  }
}

__global__ void __launch_bounds__(TA_THREADS)
twoside_argmin_kernel(const float* __restrict__ rows,
                      const float* __restrict__ d,
                      const float* __restrict__ rowt,
                      float* __restrict__ part,
                      long long* __restrict__ pwit, int Q, int K1, int K2,
                      int xper) {
  __shared__ __align__(16) TaTiles sm;
  __shared__ float s_m[TA_BQ], s_t[TA_BQ];
  __shared__ int s_y[TA_BQ];
  const int ty = threadIdx.x % TA_TY;      // y lane
  const int tq = threadIdx.x / TA_TY;      // q lane
  const int q0 = blockIdx.y * TA_BQ;
  const int y0 = blockIdx.x * TA_BY;
  const int xa = blockIdx.z * xper;
  const int xb = min(K1, xa + xper);
  const float inf = __int_as_float(0x7f800000);

  // pass 1: acc[q, y] = min over the x range of rows + d
  float acc[TA_MQ][TA_MY];
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) acc[a][b] = inf;
  const auto rows_at = [&](int buf, int x0) {
    return stage_rows(sm.rs[buf], rows, Q, K1, q0, x0, xb);
  };
  const auto d_at = [&](int buf, int x0) {
    stage_d(sm.ds[buf], d, K2, x0, xb, y0);
  };
  ta_walk_x(sm, xa, xb, rows_at, d_at,
            [&](const float (*rs)[TA_BQ], const float (*ds)[TA_BY], int) {
              ta_minplus_tile(acc, rs, ds, tq, ty);
              return false;
            });

  // add rowt; per query the smallest y at the block's minimum, with the
  // acc value there (what pass 2 looks for)
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a) {
    const int q = q0 + tq * TA_MQ + a;
    float m = inf, mt = inf;
    int my = 0x7fffffff;
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) {       // ascending y, strict <
      const int y = y0 + ty * TA_MY + b;
      if (q < Q && y < K2) {
        const float v = acc[a][b] + rowt[(size_t)q * K2 + y];
        if (v < m) {
          m = v;
          my = y;
          mt = acc[a][b];
        }
      }
    }
#pragma unroll
    for (int off = TA_TY / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const int oy = __shfl_xor_sync(0xffffffffu, my, off);
      const float ot = __shfl_xor_sync(0xffffffffu, mt, off);
      if (om < m || (om == m && oy < my)) {
        m = om;
        my = oy;
        mt = ot;
      }
    }
    if (ty == 0) {
      s_m[tq * TA_MQ + a] = m;
      s_y[tq * TA_MQ + a] = my;
      s_t[tq * TA_MQ + a] = mt;
    }
  }
  __syncthreads();

  // pass 2: per query, the smallest x of the range with
  // rows[q, x] + d[x, y*] == acc[q, y*] (the same add, so the same bits),
  // walking the tiles again until every query has its x
  const int qq = threadIdx.x;
  bool found = true;
  int fx = -1, ys = 0;
  float tgt = inf;
  if (qq < TA_BQ) {
    found = q0 + qq >= Q || s_m[qq] == inf;
    ys = s_y[qq] - y0;
    tgt = s_t[qq];
  }
  if (!__syncthreads_and(found)) {
    ta_walk_x(sm, xa, xb, rows_at, d_at,
              [&](const float (*rs)[TA_BQ], const float (*ds)[TA_BY],
                  int x0) {
                if (!found) {
                  for (int xx = 0; xx < TA_BX; ++xx) {
                    if (rs[xx][qq] + ds[xx][ys] == tgt) {
                      fx = x0 + xx;
                      found = true;
                      break;
                    }
                  }
                }
                return __syncthreads_and(found) != 0;
              });
  }
  if (qq < TA_BQ && q0 + qq < Q) {
    const size_t o = (size_t)(q0 + qq) * (gridDim.x * gridDim.z) +
                     (size_t)blockIdx.x * gridDim.z + blockIdx.z;
    part[o] = s_m[qq];
    pwit[o] = (long long)s_y[qq] * (long long)K1 + (long long)fx;
  }
}

#define TF_WARPS 4

__global__ void __launch_bounds__(TF_WARPS * 32)
twoside_argmin_finish(const float* __restrict__ part,
                      const long long* __restrict__ pwit,
                      float* __restrict__ out, int* __restrict__ wx,
                      int* __restrict__ wy, int Q, int P, int K1) {
  const int q = blockIdx.x * TF_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= Q) return;                      // uniform across the warp
  float m = __int_as_float(0x7f800000);
  long long w = 0x7fffffffffffffffLL;
  for (int p = lane; p < P; p += 32) {
    const float v = part[(size_t)q * P + p];
    const long long pw = pwit[(size_t)q * P + p];
    if (v < m || (v == m && pw < w)) {
      m = v;
      w = pw;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const long long ow = __shfl_xor_sync(0xffffffffu, w, off);
    if (om < m || (om == m && ow < w)) {
      m = om;
      w = ow;
    }
  }
  if (lane == 0) {
    const bool fin = m != __int_as_float(0x7f800000);
    out[q] = m;
    wx[q] = fin ? (int)(w % K1) : -1;
    wy[q] = fin ? (int)(w / K1) : -1;
  }
}

extern "C" {

// rows f32 [Q, K1], d f32 [K1, K2], rowt f32 [Q, K2] -> out f32 [Q],
// wx, wy int32 [Q].  part f32 and pwit int64, each
// [Q, ceil(K2 / TA_BY) * splits], are scratch.  splits >= 1 cuts the x
// range into contiguous runs of whole 32-deep tiles.
int minplus_twoside_argmin(const void* rows, const void* d,
                           const void* rowt, void* part, void* pwit,
                           void* out, void* wx, void* wy, int Q, int K1,
                           int K2, int splits, void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ytiles = (K2 + TA_BY - 1) / TA_BY;
  const int xtiles = (K1 + TA_BX - 1) / TA_BX;
  const int xper = ((xtiles + splits - 1) / splits) * TA_BX;
  if (ytiles > 0) {
    const dim3 grid(ytiles, (Q + TA_BQ - 1) / TA_BQ, splits);
    twoside_argmin_kernel<<<grid, TA_THREADS, 0, st>>>(
        (const float*)rows, (const float*)d, (const float*)rowt,
        (float*)part, (long long*)pwit, Q, K1, K2, xper);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  twoside_argmin_finish<<<(Q + TF_WARPS - 1) / TF_WARPS, TF_WARPS * 32, 0,
                          st>>>((const float*)part, (const long long*)pwit,
                                (float*)out, (int*)wx, (int*)wy, Q,
                                ytiles * splits, K1 > 0 ? K1 : 1);
  return (int)cudaGetLastError();
}

}  // extern "C"
