// Grouped two-sided tropical contraction for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/minplus_twoside.py:
// minplus_twoside_pallas (_twoside_kernel), the cross-fragment combine
// of the serve path, in the form the serve path holds its operands:
//   out[q] = min_{i, j} row_s[q, i] + d[tab_s[gs[q], i], tab_t[gt[q], j]]
//                       + row_t[q, j]
// with compact boundary rows row_s [Q, ms] and row_t [Q, mt] (float32,
// +inf absorbing), their id tables tab_s [Gs, ms] and tab_t [Gt, mt]
// (int32 ids into d's rows and columns), per-query table rows gs, gt
// (int64) and the closure d [K1, K2].  Null tables are the identity
// (ms == K1, id = i) and null groups are row 0: the dense contraction
// min_{x,y} rows + d + rowt is the case of one group and identity
// tables.
//
// Why this differs from the TPU design: the Pallas kernel streams dense
// rows, so the reference scatters each compact row over the whole
// closure and sweeps all of it, a regular grid the TPU's matrix tiling
// wants.  A scattered row is +inf outside its own ids, so nearly all of
// that sweep adds +inf: 32 x 32 of 480 x 480 cells per query at
// road4000, 592 x 592 of 1,712 x 1,712 at road64k's top level.  On the
// H100 the closure sits in the 50 MB L2, so this kernel gathers d
// through the id tables and contracts only the cells the rows can
// reach.  Two regimes, picked by the wrapper from the shapes alone:
//  * twoside_grouped_warp (ms, mt <= 64: level-1 fragment rows; or
//    more table pairs than queries, or than the order takes: queries
//    that rarely share a pair): one warp per query.  For each 64-wide
//    chunk of the columns a lane holds j = lane and lane + 32; for each
//    row entry i (32 at a time, broadcast by shuffle) it reads its
//    columns' cells of d row tab_s[i] from L2, keeps acc[j] = min_i
//    row + d, adds row_t, and the warp reduces.  One launch, no
//    scratch.
//  * twoside_grouped_tiles (wider rows shared by many queries: the top
//    level, dense rows):
//    twoside_group_order first groups the queries by their table pair
//    (a counting sort on the key gs * Gt + gt in one block, when there
//    are 2 to 4,096 keys; the order within a key is free, since every
//    answer is written at its query's own index); a block takes
//    64 consecutive ordered queries x a 64-wide j tile x a run of
//    32-deep i tiles (split across blocks until the grid holds about
//    four waves of two blocks an SM: the wrapper's grouped_splits).
//    For each segment of its queries that share (gs, gt) it stages rows
//    (the other queries' as +inf) and the d tile gathered through that
//    pair's id rows, 4-byte cp.async, double-buffered, and runs the
//    8 x 4 micro-tile of twoside_tiles.cuh (an add a cell and a
//    three-way min of the bits per two cells; all-+inf rows tiles
//    skipped).  Each block writes one partial per (query, j tile, i
//    split) at the query's original index, and
//    twoside_min_finish takes the min over them on the card: no
//    un-permute pass.
//
// Bound on this card: 2 float32 operations (add, min) per cell
// (q, i, j) these inputs need, Q * ms * mt, at 67 TFLOP/s outside the
// tensor cores ((min,+) has no tensor-core form).  On sm_90 the min
// bounds the loop, not the add: the tiles regime issues 1.5 instructions
// a cell (FADD, half a VIMNMX3), the warp regime 2 (FADD, FMNMX).  The
// tiles regime issues its micro-tile over every segment of a block, so
// queries of other segments cost cells that are +inf by construction.
// Bytes (rows once, the reached cells of d once) are far below that at
// the serve shapes.
//
// Exact: the function is scatter-min of each row at its ids, then the
// dense contraction, re-associated: fl(min(a, b) + c) == min(fl(a + c),
// fl(b + c)) for any floats (rounding is monotone), so duplicate ids,
// sentinel ids (d's +inf row or column) and the order of the minima give
// the plain version's bits; integer-valued inputs keep every sum below
// 2**24 besides.  The tiles regime's int32 min of the sums' bits is the
// bits of their float min for the non-negative inputs every caller
// passes (twoside_tiles.cuh).  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include "twoside_tiles.cuh"

#define TW_WARPS 8    // queries (warps) per block of the warp regime
#define TF_WARPS 8    // queries (warps) per block of the finish
#define TO_THREADS 1024
#define TO_KEYS 4096  // table pairs the counting order takes

__global__ void __launch_bounds__(TW_WARPS * 32)
twoside_grouped_warp(const float* __restrict__ row_s,
                     const long long* __restrict__ gs,
                     const int* __restrict__ tab_s, int ms,
                     const float* __restrict__ d, int K2,
                     const float* __restrict__ row_t,
                     const long long* __restrict__ gt,
                     const int* __restrict__ tab_t, int mt,
                     float* __restrict__ out, int Q) {
  const int q = blockIdx.x * TW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= Q) return;                      // uniform across the warp
  const float inf = __int_as_float(0x7f800000);
  const size_t bs = (size_t)(gs ? gs[q] : 0) * ms;
  const size_t bt = (size_t)(gt ? gt[q] : 0) * mt;
  // out-of-range columns read column 0 (a valid address) and are
  // cancelled by their +inf row_t; loads are unconditional so that the
  // unrolled loop keeps several in flight
  float m = inf;
  for (int c0 = 0; c0 < mt; c0 += 64) {
    float t[2], acc[2] = {inf, inf};
    int y[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = c0 + lane + 32 * h;
      t[h] = j < mt ? row_t[(size_t)q * mt + j] : inf;
      y[h] = j < mt ? (tab_t ? tab_t[bt + j] : j) : 0;
    }
    for (int i0 = 0; i0 < ms; i0 += 32) {
      const int i = i0 + lane;
      const float r = i < ms ? row_s[(size_t)q * ms + i] : inf;
      const int x = i < ms ? (tab_s ? tab_s[bs + i] : i) : 0;
      const int n = min(32, ms - i0);
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float rv = __shfl_sync(0xffffffffu, r, k);
        const float* drow = d + (size_t)__shfl_sync(0xffffffffu, x, k) * K2;
        acc[0] = fminf(acc[0], rv + __ldg(drow + y[0]));
        acc[1] = fminf(acc[1], rv + __ldg(drow + y[1]));
      }
    }
    m = fminf(m, fminf(acc[0] + t[0], acc[1] + t[1]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[q] = m;
}

__global__ void __launch_bounds__(TA_THREADS, 2)
twoside_grouped_tiles(const float* __restrict__ row_s,
                      const long long* __restrict__ gs,
                      const int* __restrict__ tab_s, int ms,
                      const float* __restrict__ d, int K2,
                      const float* __restrict__ row_t,
                      const long long* __restrict__ gt,
                      const int* __restrict__ tab_t, int mt,
                      const long long* __restrict__ perm,
                      float* __restrict__ part, int Q, int xper) {
  __shared__ __align__(16) TaTiles sm;
  __shared__ int s_q[TA_BQ];             // original query (-1 past Q)
  __shared__ int s_gs[TA_BQ], s_gt[TA_BQ];
  __shared__ int s_xid[2][TA_BX];        // d row ids of a staged i tile
  const int ty = threadIdx.x % TA_TY;    // j lane of the micro-tile
  const int tq = threadIdx.x / TA_TY;    // q lane of the micro-tile
  const int q0 = blockIdx.y * TA_BQ;
  const int y0 = blockIdx.x * TA_BY;
  const int xa = blockIdx.z * xper;
  const int xb = min(ms, xa + xper);
  const int nq = min(TA_BQ, Q - q0);
  const float inf = __int_as_float(0x7f800000);
  if (threadIdx.x < TA_BQ) {
    const int p = q0 + threadIdx.x;
    int oq = -1, a = 0, b = 0;
    if (p < Q) {
      oq = perm ? (int)perm[p] : p;
      a = gs ? (int)gs[oq] : 0;
      b = gt ? (int)gt[oq] : 0;
    }
    s_q[threadIdx.x] = oq;
    s_gs[threadIdx.x] = a;
    s_gt[threadIdx.x] = b;
  }
  __syncthreads();

  float acc[TA_MQ][TA_MY];
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) acc[a][b] = inf;

  // the staging loops give every thread one query (rows) and one j
  // column (d) of the tile: 256 threads, 64 of each
  const int sq = threadIdx.x % TA_BQ;
  const int sy = threadIdx.x % TA_BY;
  for (int sa = 0; sa < nq;) {           // segments: runs of equal (gs, gt)
    const int g_s = s_gs[sa], g_t = s_gt[sa];
    int sb = sa + 1;
    while (sb < nq && s_gs[sb] == g_s && s_gt[sb] == g_t) ++sb;
    const bool mine = sq >= sa && sq < sb;
    const float* rrow = row_s + (size_t)(mine ? s_q[sq] : 0) * ms;
    const int* xtab = tab_s ? tab_s + (size_t)g_s * ms : nullptr;
    const int j = y0 + sy;
    const int ycol = j < mt ? (tab_t ? tab_t[(size_t)g_t * mt + j] : j) : -1;
    const auto rows_at = [&](int buf, int x0) {
      if (threadIdx.x < TA_BX) {
        const int x = x0 + threadIdx.x;
        s_xid[buf][threadIdx.x] = x < xb ? (xtab ? xtab[x] : x) : 0;
      }
      int fin = 0;
#pragma unroll
      for (int m = 0; m < TA_BQ * TA_BX / TA_THREADS; ++m) {
        const int xx = threadIdx.x / TA_BQ + m * (TA_THREADS / TA_BQ);
        const int x = x0 + xx;
        const float v = (mine && x < xb) ? rrow[x] : inf;
        sm.rs[buf][xx][sq] = v;
        fin |= v != inf;
      }
      return fin;
    };
    const auto d_at = [&](int buf, int x0) {   // after the vote: s_xid set
#pragma unroll
      for (int m = 0; m < TA_BX * TA_BY / TA_THREADS; ++m) {
        const int xx = threadIdx.x / TA_BY + m * (TA_THREADS / TA_BY);
        if (x0 + xx < xb && ycol >= 0) {
          cp_async4(&sm.ds[buf][xx][sy],
                    d + (size_t)s_xid[buf][xx] * K2 + ycol);
        } else {
          sm.ds[buf][xx][sy] = inf;
        }
      }
    };
    ta_walk_x(sm, xa, xb, rows_at, d_at,
              [&](const float (*rs)[TA_BQ], const float (*ds)[TA_BY], int) {
                ta_minplus_tile(acc, rs, ds, tq, ty);
                return false;
              });
    sa = sb;
  }

  // + row_t, then the min over this block's j tile: per thread over its
  // 4 columns, then across the 16 lanes that share its queries
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a) {
    const int oq = s_q[tq * TA_MQ + a];
    float m = inf;
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) {
      const int jj = y0 + ty * TA_MY + b;
      if (oq >= 0 && jj < mt)
        m = fminf(m, acc[a][b] + row_t[(size_t)oq * mt + jj]);
    }
#pragma unroll
    for (int off = TA_TY / 2; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (ty == 0 && oq >= 0)
      part[(size_t)oq * (gridDim.x * gridDim.z) +
           (size_t)blockIdx.x * gridDim.z + blockIdx.z] = m;
  }
}

// perm = the queries grouped by key gs * nt + gt (nkeys <= TO_KEYS): one
// block counts the keys, scans the counts (4 keys a thread, then across
// the block) and places each query at its key's next slot.
__global__ void __launch_bounds__(TO_THREADS)
twoside_group_order(const long long* __restrict__ gs,
                    const long long* __restrict__ gt, int nt, int nkeys,
                    int Q, long long* __restrict__ perm) {
  __shared__ int cnt[TO_KEYS];
  __shared__ int warp_sum[TO_THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int k = tid; k < TO_KEYS; k += TO_THREADS) cnt[k] = 0;
  __syncthreads();
  for (int q = tid; q < Q; q += TO_THREADS)
    atomicAdd(&cnt[(int)(gs[q] * nt + gt[q])], 1);
  __syncthreads();
  constexpr int per = TO_KEYS / TO_THREADS;
  int mine[per], sum = 0;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    mine[i] = sum;
    sum += cnt[tid * per + i];
  }
  int incl = sum;                        // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    warp_sum[lane] = w;                  // inclusive, per warp
  }
  __syncthreads();
  const int base = incl - sum + (warp ? warp_sum[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < per; ++i) cnt[tid * per + i] = base + mine[i];
  __syncthreads();
  for (int q = tid; q < Q; q += TO_THREADS)
    perm[atomicAdd(&cnt[(int)(gs[q] * nt + gt[q])], 1)] = q;
}

__global__ void __launch_bounds__(TF_WARPS * 32)
twoside_min_finish(const float* __restrict__ part, float* __restrict__ out,
                   int Q, int P) {
  const int q = blockIdx.x * TF_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= Q) return;                      // uniform across the warp
  float m = __int_as_float(0x7f800000);
  for (int p = lane; p < P; p += 32) m = fminf(m, part[(size_t)q * P + p]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[q] = m;
}

extern "C" {

// Warp regime: out f32 [Q].  gs, gt int64 [Q] or null (row 0);
// tab_s int32 [Gs, ms], tab_t int32 [Gt, mt] or null (identity).
int minplus_twoside_grouped_warp(const void* row_s, const void* gs,
                                 const void* tab_s, int ms, const void* d,
                                 int K2, const void* row_t, const void* gt,
                                 const void* tab_t, int mt, void* out, int Q,
                                 void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  twoside_grouped_warp<<<(Q + TW_WARPS - 1) / TW_WARPS, TW_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
      (const float*)row_s, (const long long*)gs, (const int*)tab_s, ms,
      (const float*)d, K2, (const float*)row_t, (const long long*)gt,
      (const int*)tab_t, mt, (float*)out, Q);
  return (int)cudaGetLastError();
}

// Tiles regime: as above, plus the table rows nt of tab_t and
// nkeys = Gs * Gt table pairs (2..TO_KEYS: the queries are grouped by
// pair first; otherwise they keep their order), perm int64 [Q] and
// part f32 [Q, ceil(mt / 64) * splits] scratch; splits >= 1 cuts the i
// range into contiguous runs of whole 32-deep tiles.
int minplus_twoside_grouped_tiles(const void* row_s, const void* gs,
                                  const void* tab_s, int ms, const void* d,
                                  int K2, const void* row_t, const void* gt,
                                  const void* tab_t, int mt, int nt,
                                  int nkeys, void* perm, void* part,
                                  void* out, int Q, int splits,
                                  void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (splits < 1 || nkeys > TO_KEYS) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool order = nkeys > 1;
  if (order) {
    twoside_group_order<<<1, TO_THREADS, 0, st>>>(
        (const long long*)gs, (const long long*)gt, nt, nkeys, Q,
        (long long*)perm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int ytiles = (mt + TA_BY - 1) / TA_BY;
  const int xtiles = (ms + TA_BX - 1) / TA_BX;
  const int xper = ((xtiles + splits - 1) / splits) * TA_BX;
  if (ytiles > 0) {
    const dim3 grid(ytiles, (Q + TA_BQ - 1) / TA_BQ, splits);
    twoside_grouped_tiles<<<grid, TA_THREADS, 0, st>>>(
        (const float*)row_s, (const long long*)gs, (const int*)tab_s, ms,
        (const float*)d, K2, (const float*)row_t, (const long long*)gt,
        (const int*)tab_t, mt, order ? (const long long*)perm : nullptr,
        (float*)part, Q, xper);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  twoside_min_finish<<<(Q + TF_WARPS - 1) / TF_WARPS, TF_WARPS * 32, 0, st>>>(
      (const float*)part, (float*)out, Q, ytiles * splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
