// Gathered-row tropical products of the overlay hierarchy's distance
// ladder for Hopper (sm_90a): the lifts and the same-group legs of
// core/device_engine.py (_lift_compact, _lift_res, _hier_leg).
//
// Replaces no Pallas kernel: the reference runs these steps as XLA
// gathers of the closures ([q, c, width] blocks, reduced by jnp.min), and
// the port ran them as chunked torch gathers, each step a handful of
// launches that write and read back a [q, c, width] block in device
// memory.  One template serves both:
//
//   out[r, j] = min_b row[r, b] + M[g(r, b), p(r, b), c(r, j)]
//
// Every slot id of a row comes from one table row, chosen by the row's
// unit: id = tab[unit[r], b] (at level 1 a fragment's boundary, above it
// the previous level's group boundary).  The slot's closure row is
// (g, p) = (gof[id], pof[id]), or (ugrp[unit[r]], pof[id]) for the
// resident rows, whose group is the unit's.  Two epilogues:
//  * store (the lifts): out[r, j] for c(r, j) = j (identity columns: M's
//    rows are contiguous, so staged with 16-byte copies), or
//    c(r, j) = ctab[cunit[r], j] (_lift_res: a top group's columns).
//  * twoside (the legs): out[q] = min_{i,j} row_s[q, i] +
//    [gof[a_i] == gof[b_j]] M[gof[a_i], pof[a_i], pof[b_j]] + row_t[q, j]
//    with a = tab[us[q]], b = tab[ut[q]]: the plain version's per-pair
//    "same group" mask, applied where the closure tile is staged.  A query
//    whose two slot-0 groups differ gets +inf without reading M: exact
//    because every slot with a finite row entry lies in its side's slot-0
//    group and sentinel slots carry +inf (groups nest; pinned by a test).
//
// Two regimes, picked by the wrapper from the widths and the number of
// units alone (kernels/gather_minplus.py ``plan``):
//  * warp (rows of at most 128 slots over few rows a unit: level 1, where
//    a unit is one of up to hundreds of fragments; the resident lift;
//    more keys than the order takes): one warp per row or query (the
//    store: and 256-column chunk).  Each lane holds output columns (the
//    store: 8 of 256; the twoside: 2 of every 64), the warp walks the
//    row's finite entries only (a ballot; +inf entries add +inf) and
//    broadcasts each entry and its closure row by shuffle.  Every row
//    reads its own closure cells, so wide rows take the tiles at any
//    batch size.
//  * tiles (wider rows, or many rows a unit; at most 4,096 keys):
//    gmp_order groups the rows by key (the unit; for the
//    twoside the (us, ut) pair of the queries whose slot-0 groups agree,
//    the others answered +inf there) with a counting sort in one block and
//    cuts each key's run into tiles of at most 64 rows; a block takes one
//    tile x 64 output columns and walks the slots in 32-deep tiles through
//    twoside_tiles.cuh (rows staged transposed with a vote, the closure
//    tile gathered through the key's slot rows by cp.async, double
//    buffered; all-+inf rows tiles skipped; the 8 x 4 micro-tile, an
//    add a cell and a three-way min of the bits per two cells).  A tile
//    holds one key, so the staged closure tile serves all of its rows.
//    The store writes its 64 x 64 outputs; the twoside adds row_t,
//    takes the min over its columns and folds it into out[q] with an
//    atomic min (out starts at +inf, set by gmp_order); a twoside block
//    whose t-rows are +inf over its columns returns at once.
//
// Bound on this card: 2 float32 operations (add, min) per (row, slot,
// column) cell the inputs need, at 67 TFLOP/s outside the tensor cores
// ((min,+) has no tensor-core form).  road250k's batch of 1,024 queries
// lifts 2 x (96 x 1,072 + 1,072 x 1,624 + 1,624 x 2,056 + 2,056 x 2,336)
// cells a query and legs 96^2 + 1,072^2 + 1,624^2 + 2,056^2 (of which
// the queries that pass the slot-0 test need about 3.0M): ~0.7 ms of
// operations a batch.  Bytes: the rows once and, in the tiles regime,
// each key's gathered closure rows once per 64-row tile, from L2 (a
// level's closure is 96-168 MB; one key's slots read 0.4-19 MB of it).
// What the design does about it: nothing of size [rows, slots, columns]
// reaches device memory; one launch a step (two with the order) where
// the chunked gathers took ~5 per 8-column step; +inf slots and padded
// columns cost no arithmetic in either regime.
//
// Exact: each output is a min of fl(row + M) sums (twoside: fl(that min
// + row_t), as the plain version associates it), and min is exact and
// order-free, so any grouping of the slots and any order of the minima
// give the plain version's bits.  The tiles regime takes its min on the
// sums' bit patterns as int32, the same bits for the non-negative inputs
// every caller passes (twoside_tiles.cuh).  The atomic min orders floats
// by their value (-0.0 below +0.0, which the non-negative serve inputs
// never produce).  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include "twoside_tiles.cuh"

#define GW_WARPS 8      // rows (warps) per block of the warp regimes
#define GW_COLS 8       // output columns a lane holds in the store warp
#define GO_THREADS 1024
#define GO_KEYS 4096    // keys the counting order takes

// Where a unit's slots read the closure: slot b of unit u is overlay id
// tab[u * K + b], at closure row (group, pos).
struct Slots {
  const int* tab;   // [U, K]
  const int* gof;   // [S + 1] group of an id (null: ugrp)
  const int* ugrp;  // [U] group of all of a unit's slots (null: gof)
  const int* pof;   // [S + 1] position of an id in its group
  int K;
  int m2;
};

__device__ __forceinline__ int slot_group(const Slots& s, int u, int id) {
  return s.ugrp ? s.ugrp[u] : s.gof[id];
}

// the closure row of slot b of unit u: group * m2 + pos
__device__ __forceinline__ long long slot_row(const Slots& s, int u, int b) {
  const int id = s.tab[(size_t)u * s.K + b];
  return (long long)slot_group(s, u, id) * s.m2 + s.pof[id];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// min by value for any non-NaN floats: non-negative ones order as signed
// ints, negative ones in reverse as unsigned ints
__device__ __forceinline__ void atomic_min_float(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

// Store, warp regime: one warp per row r and 256-column chunk
// (blockIdx.y); out [R, W].
__global__ void __launch_bounds__(GW_WARPS * 32)
gmp_store_warp(const float* __restrict__ row,
               const long long* __restrict__ unit, Slots sl,
               const float* __restrict__ M, int ldm,
               const long long* __restrict__ cunit,
               const int* __restrict__ ctab, int W, float* __restrict__ out,
               int R) {
  const int r = blockIdx.x * GW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;                      // uniform across the warp
  const float inf = __int_as_float(0x7f800000);
  const int u = (int)unit[r];
  const int K = sl.K;
  const int* crow =
      ctab ? ctab + (size_t)(cunit ? cunit[r] : 0) * W : nullptr;
  const int c0 = blockIdx.y * 32 * GW_COLS;
  // columns past W read column 0 (a valid address) and are not stored
  int col[GW_COLS];
  float acc[GW_COLS];
#pragma unroll
  for (int k = 0; k < GW_COLS; ++k) {
    const int j = c0 + lane + 32 * k;
    col[k] = j < W ? (crow ? crow[j] : j) : 0;
    acc[k] = inf;
  }
  for (int b0 = 0; b0 < K; b0 += 32) {
    const int b = b0 + lane;
    const float v = b < K ? row[(size_t)r * K + b] : inf;
    const long long rr = v != inf ? slot_row(sl, u, b) : 0;
    unsigned live = __ballot_sync(0xffffffffu, v != inf);
    while (live) {                       // the finite entries, in order
      const int k = __ffs(live) - 1;
      live &= live - 1;
      const float rv = __shfl_sync(0xffffffffu, v, k);
      const float* mrow =
          M + (size_t)__shfl_sync(0xffffffffu, rr, k) * ldm;
#pragma unroll
      for (int kk = 0; kk < GW_COLS; ++kk)
        acc[kk] = fminf(acc[kk], rv + __ldg(mrow + col[kk]));
    }
  }
#pragma unroll
  for (int kk = 0; kk < GW_COLS; ++kk) {
    const int j = c0 + lane + 32 * kk;
    if (j < W) out[(size_t)r * W + j] = acc[kk];
  }
}

// Twoside, warp regime: one warp per query q; out [Q].
__global__ void __launch_bounds__(GW_WARPS * 32)
gmp_twoside_warp(const float* __restrict__ row_s,
                 const long long* __restrict__ us,
                 const float* __restrict__ row_t,
                 const long long* __restrict__ ut, Slots sl,
                 const float* __restrict__ M, float* __restrict__ out,
                 int Q) {
  const int q = blockIdx.x * GW_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= Q) return;                      // uniform across the warp
  const float inf = __int_as_float(0x7f800000);
  const int K = sl.K, m2 = sl.m2;
  const int u_s = (int)us[q], u_t = (int)ut[q];
  const int* tab_s = sl.tab + (size_t)u_s * K;
  const int* tab_t = sl.tab + (size_t)u_t * K;
  if (sl.gof[tab_s[0]] != sl.gof[tab_t[0]]) {   // different groups
    if (lane == 0) out[q] = inf;
    return;
  }
  float m = inf;
  for (int c0 = 0; c0 < K; c0 += 64) {
    float t[2];
    int yc[2], yg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = c0 + lane + 32 * h;
      t[h] = j < K ? row_t[(size_t)q * K + j] : inf;
      const int id = tab_t[j < K ? j : 0];
      yc[h] = sl.pof[id];
      yg[h] = sl.gof[id];
    }
    if (!__any_sync(0xffffffffu, t[0] != inf || t[1] != inf)) continue;
    float acc[2] = {inf, inf};
    for (int i0 = 0; i0 < K; i0 += 32) {
      const int i = i0 + lane;
      const float v = i < K ? row_s[(size_t)q * K + i] : inf;
      int g = -1, p = 0;
      if (v != inf) {
        const int id = tab_s[i];
        g = sl.gof[id];
        p = sl.pof[id];
      }
      unsigned live = __ballot_sync(0xffffffffu, v != inf);
      while (live) {
        const int k = __ffs(live) - 1;
        live &= live - 1;
        const float rv = __shfl_sync(0xffffffffu, v, k);
        const int gk = __shfl_sync(0xffffffffu, g, k);
        const float* mrow =
            M + ((size_t)gk * m2 + __shfl_sync(0xffffffffu, p, k)) * m2;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          acc[h] = fminf(acc[h],
                         rv + (gk == yg[h] ? __ldg(mrow + yc[h]) : inf));
      }
    }
    m = fminf(m, fminf(acc[0] + t[0], acc[1] + t[1]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[q] = m;
}

// The tiles regimes' order.  Key of row r: ka[r] (store), or
// ka[r] * nb + kb[r] where the slot-0 groups of tab rows ka[r] and kb[r]
// agree and none otherwise (twoside; out[r] = +inf for every r there).
// perm = the keyed rows grouped by key (a counting sort in one block;
// the order within a key is free); tiles = for each key, runs of at most
// TA_BQ consecutive rows of perm as (first, count); ntiles = their
// number.
__device__ __forceinline__ int order_key(const long long* ka,
                                         const long long* kb, int nb,
                                         const int* tab, const int* gof,
                                         int K, int r) {
  const int a = (int)ka[r];
  if (!kb) return a;
  const int b = (int)kb[r];
  if (gof[tab[(size_t)a * K]] != gof[tab[(size_t)b * K]]) return -1;
  return a * nb + b;
}

__global__ void __launch_bounds__(GO_THREADS)
gmp_order(const long long* __restrict__ ka, const long long* __restrict__ kb,
          int nb, const int* __restrict__ tab, const int* __restrict__ gof,
          int K, int R, int* __restrict__ perm, int2* __restrict__ tiles,
          int* __restrict__ ntiles, float* __restrict__ out) {
  __shared__ int cnt[GO_KEYS];
  __shared__ long long warp_sum[GO_THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int k = tid; k < GO_KEYS; k += GO_THREADS) cnt[k] = 0;
  __syncthreads();
  for (int r = tid; r < R; r += GO_THREADS) {
    const int k = order_key(ka, kb, nb, tab, gof, K, r);
    if (k >= 0) atomicAdd(&cnt[k], 1);
    if (out) out[r] = __int_as_float(0x7f800000);
  }
  __syncthreads();
  // one exclusive scan of (rows << 32 | tiles) over the keys, 4 a thread
  constexpr int per = GO_KEYS / GO_THREADS;
  long long mine[per], sum = 0;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    mine[i] = sum;
    const int c = cnt[tid * per + i];
    sum += ((long long)c << 32) | ((c + TA_BQ - 1) / TA_BQ);
  }
  long long incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    warp_sum[lane] = w;                    // inclusive, per warp
  }
  __syncthreads();
  const long long base = incl - sum + (warp ? warp_sum[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < per; ++i) {
    const int k = tid * per + i;
    const int c = cnt[k];
    const long long at = base + mine[i];
    const int first = (int)(at >> 32), t0 = (int)(at & 0xffffffff);
    for (int t = 0; t * TA_BQ < c; ++t)
      tiles[t0 + t] = make_int2(first + t * TA_BQ, min(TA_BQ, c - t * TA_BQ));
    cnt[k] = first;
  }
  if (tid == GO_THREADS - 1) {
    const long long all = base + sum;
    *ntiles = (int)(all & 0xffffffff);
  }
  __syncthreads();
  for (int r = tid; r < R; r += GO_THREADS) {
    const int k = order_key(ka, kb, nb, tab, gof, K, r);
    if (k >= 0) perm[atomicAdd(&cnt[k], 1)] = r;
  }
}

// Store, tiles regime (identity columns): block (column tile, row tile);
// out [R, W], M's rows W long.  vec: W and M's address allow 16-byte
// copies and stores.
__global__ void __launch_bounds__(TA_THREADS, 2)
gmp_store_tiles(const float* __restrict__ row,
                const long long* __restrict__ unit, Slots sl,
                const float* __restrict__ M, int W, int vec,
                float* __restrict__ out, const int* __restrict__ perm,
                const int2* __restrict__ tiles,
                const int* __restrict__ ntiles) {
  __shared__ __align__(16) TaTiles sm;
  __shared__ int s_q[TA_BQ];               // row of each tile slot (-1: none)
  __shared__ long long s_rid[2][TA_BX];    // closure rows of a staged tile
  if ((int)blockIdx.y >= *ntiles) return;  // uniform across the block
  const int2 tl = tiles[blockIdx.y];
  const int ty = threadIdx.x % TA_TY;
  const int tq = threadIdx.x / TA_TY;
  const int y0 = blockIdx.x * TA_BY;
  const int K = sl.K;
  const float inf = __int_as_float(0x7f800000);
  if (threadIdx.x < TA_BQ)
    s_q[threadIdx.x] = threadIdx.x < tl.y ? perm[tl.x + threadIdx.x] : -1;
  __syncthreads();
  const int u = (int)unit[s_q[0]];

  float acc[TA_MQ][TA_MY];
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) acc[a][b] = inf;

  const int sq = threadIdx.x % TA_BQ;
  const bool mine = s_q[sq] >= 0;
  const float* rrow = row + (size_t)(mine ? s_q[sq] : 0) * K;
  const auto rows_at = [&](int buf, int x0) {
    if (threadIdx.x < TA_BX) {
      const int x = x0 + threadIdx.x;
      s_rid[buf][threadIdx.x] = x < K ? slot_row(sl, u, x) : 0;
    }
    int fin = 0;
#pragma unroll
    for (int m = 0; m < TA_BQ * TA_BX / TA_THREADS; ++m) {
      const int xx = threadIdx.x / TA_BQ + m * (TA_THREADS / TA_BQ);
      const int x = x0 + xx;
      const float v = (mine && x < K) ? rrow[x] : inf;
      sm.rs[buf][xx][sq] = v;
      fin |= v != inf;
    }
    return fin;
  };
  const auto d_at = [&](int buf, int x0) {   // after the vote: s_rid set
    if (vec) {
#pragma unroll
      for (int m = 0; m < TA_BX * TA_BY / 4 / TA_THREADS; ++m) {
        const int idx = threadIdx.x + m * TA_THREADS;
        const int xx = idx / (TA_BY / 4), c = idx % (TA_BY / 4) * 4;
        float* dst = &sm.ds[buf][xx][c];
        if (x0 + xx < K && y0 + c < W)
          cp_async16(dst, M + s_rid[buf][xx] * W + y0 + c);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(inf, inf, inf, inf);
      }
    } else {
      const int sy = threadIdx.x % TA_BY;
#pragma unroll
      for (int m = 0; m < TA_BX * TA_BY / TA_THREADS; ++m) {
        const int xx = threadIdx.x / TA_BY + m * (TA_THREADS / TA_BY);
        if (x0 + xx < K && y0 + sy < W)
          cp_async4(&sm.ds[buf][xx][sy], M + s_rid[buf][xx] * W + y0 + sy);
        else
          sm.ds[buf][xx][sy] = inf;
      }
    }
  };
  ta_walk_x(sm, 0, K, rows_at, d_at,
            [&](const float (*rs)[TA_BQ], const float (*ds)[TA_BY], int) {
              ta_minplus_tile(acc, rs, ds, tq, ty);
              return false;
            });

  const int j0 = y0 + ty * TA_MY;
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a) {
    const int oq = s_q[tq * TA_MQ + a];
    if (oq < 0 || j0 >= W) continue;
    float* o = out + (size_t)oq * W + j0;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    } else {
#pragma unroll
      for (int b = 0; b < TA_MY; ++b)
        if (j0 + b < W) o[b] = acc[a][b];
    }
  }
}

// Twoside, tiles regime: block (column tile, query tile of one (us, ut)
// key); out [Q] already +inf (gmp_order), folded by atomic min.
__global__ void __launch_bounds__(TA_THREADS, 2)
gmp_twoside_tiles(const float* __restrict__ row_s,
                  const long long* __restrict__ us,
                  const float* __restrict__ row_t,
                  const long long* __restrict__ ut, Slots sl,
                  const float* __restrict__ M, float* __restrict__ out,
                  const int* __restrict__ perm,
                  const int2* __restrict__ tiles,
                  const int* __restrict__ ntiles) {
  __shared__ __align__(16) TaTiles sm;
  __shared__ int s_q[TA_BQ];
  __shared__ long long s_rid[2][TA_BX];
  __shared__ int s_grp[2][TA_BX];          // group of a staged slot (-1: past K)
  if ((int)blockIdx.y >= *ntiles) return;  // uniform across the block
  const int2 tl = tiles[blockIdx.y];
  const int ty = threadIdx.x % TA_TY;
  const int tq = threadIdx.x / TA_TY;
  const int y0 = blockIdx.x * TA_BY;
  const int K = sl.K, m2 = sl.m2;
  const float inf = __int_as_float(0x7f800000);
  if (threadIdx.x < TA_BQ)
    s_q[threadIdx.x] = threadIdx.x < tl.y ? perm[tl.x + threadIdx.x] : -1;
  __syncthreads();
  // nothing to add where every t-row is +inf over this column tile
  int tfin = 0;
#pragma unroll
  for (int m = 0; m < TA_BQ * TA_BY / TA_THREADS; ++m) {
    const int idx = threadIdx.x + m * TA_THREADS;
    const int oq = s_q[idx / TA_BY], j = y0 + idx % TA_BY;
    tfin |= oq >= 0 && j < K && row_t[(size_t)oq * K + j] != inf;
  }
  if (!__syncthreads_or(tfin)) return;
  const int u_s = (int)us[s_q[0]], u_t = (int)ut[s_q[0]];
  const int* tab_s = sl.tab + (size_t)u_s * K;

  float acc[TA_MQ][TA_MY];
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) acc[a][b] = inf;

  // this thread's staging column: its t-slot's closure column and group
  const int sy = threadIdx.x % TA_BY;
  int ycol = -1, ygrp = -2;
  if (y0 + sy < K) {
    const int id = sl.tab[(size_t)u_t * K + y0 + sy];
    ycol = sl.pof[id];
    ygrp = sl.gof[id];
  }
  const int sq = threadIdx.x % TA_BQ;
  const bool mine = s_q[sq] >= 0;
  const float* rrow = row_s + (size_t)(mine ? s_q[sq] : 0) * K;
  const auto rows_at = [&](int buf, int x0) {
    if (threadIdx.x < TA_BX) {
      const int x = x0 + threadIdx.x;
      int g = -1;
      long long rid = 0;
      if (x < K) {
        const int id = tab_s[x];
        g = sl.gof[id];
        rid = (long long)g * m2 + sl.pof[id];
      }
      s_grp[buf][threadIdx.x] = g;
      s_rid[buf][threadIdx.x] = rid;
    }
    int fin = 0;
#pragma unroll
    for (int m = 0; m < TA_BQ * TA_BX / TA_THREADS; ++m) {
      const int xx = threadIdx.x / TA_BQ + m * (TA_THREADS / TA_BQ);
      const int x = x0 + xx;
      const float v = (mine && x < K) ? rrow[x] : inf;
      sm.rs[buf][xx][sq] = v;
      fin |= v != inf;
    }
    return fin;
  };
  const auto d_at = [&](int buf, int x0) {   // after the vote: slots set
#pragma unroll
    for (int m = 0; m < TA_BX * TA_BY / TA_THREADS; ++m) {
      const int xx = threadIdx.x / TA_BY + m * (TA_THREADS / TA_BY);
      if (x0 + xx < K && s_grp[buf][xx] == ygrp)
        cp_async4(&sm.ds[buf][xx][sy], M + s_rid[buf][xx] * m2 + ycol);
      else
        sm.ds[buf][xx][sy] = inf;
    }
  };
  ta_walk_x(sm, 0, K, rows_at, d_at,
            [&](const float (*rs)[TA_BQ], const float (*ds)[TA_BY], int) {
              ta_minplus_tile(acc, rs, ds, tq, ty);
              return false;
            });

  // + row_t, the min over this block's columns (per thread over its 4,
  // then across the 16 lanes that share its queries), folded into out
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a) {
    const int oq = s_q[tq * TA_MQ + a];
    float m = inf;
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) {
      const int j = y0 + ty * TA_MY + b;
      if (oq >= 0 && j < K)
        m = fminf(m, acc[a][b] + row_t[(size_t)oq * K + j]);
    }
#pragma unroll
    for (int off = TA_TY / 2; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (ty == 0 && oq >= 0 && m != inf) atomic_min_float(out + oq, m);
  }
}

extern "C" {

// Store: row f32 [R, K], unit int64 [R], tab int32 [U, K], gof int32
// [S + 1] or null (then ugrp int32 [U]), pof int32 [S + 1], M f32 with
// rows ldm long (closure row g * m2 + p), cunit int64 [R] and ctab int32
// [Uc, W] or null (identity columns, W <= ldm), out f32 [R, W].  tiles:
// nkeys = U keys (<= GO_KEYS), identity columns only, perm int32 [R],
// tl int2 [maxt] with maxt >= ceil(R / 64) + min(U, R), nt int32 [1].
int gather_minplus_store(const void* row, const void* unit, const void* tab,
                         const void* gof, const void* ugrp, const void* pof,
                         int K, int m2, const void* M, int ldm,
                         const void* cunit, const void* ctab, int W,
                         void* out, int R, int tiles, int nkeys, int maxt,
                         int vec, void* perm, void* tl, void* nt,
                         void* stream) {
  if (R <= 0 || W <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const Slots sl{(const int*)tab, (const int*)gof, (const int*)ugrp,
                 (const int*)pof, K, m2};
  if (!tiles) {
    const dim3 grid((R + GW_WARPS - 1) / GW_WARPS,
                    (W + 32 * GW_COLS - 1) / (32 * GW_COLS));
    gmp_store_warp<<<grid, GW_WARPS * 32, 0, st>>>(
        (const float*)row, (const long long*)unit, sl, (const float*)M, ldm,
        (const long long*)cunit, (const int*)ctab, W, (float*)out, R);
    return (int)cudaGetLastError();
  }
  if (ctab || ldm != W || nkeys > GO_KEYS || maxt < 1)
    return (int)cudaErrorInvalidValue;
  gmp_order<<<1, GO_THREADS, 0, st>>>(
      (const long long*)unit, nullptr, 0, nullptr, nullptr, K, R,
      (int*)perm, (int2*)tl, (int*)nt, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TA_BY - 1) / TA_BY, maxt);
  gmp_store_tiles<<<grid, TA_THREADS, 0, st>>>(
      (const float*)row, (const long long*)unit, sl, (const float*)M, W, vec,
      (float*)out, (const int*)perm, (const int2*)tl, (const int*)nt);
  return (int)cudaGetLastError();
}

// Twoside: row_s, row_t f32 [Q, K], us, ut int64 [Q], tab int32 [U, K],
// gof, pof int32 [S + 1], M f32 [G * m2, m2], out f32 [Q].  tiles:
// U * U keys (<= GO_KEYS), perm int32 [Q], tl int2 [maxt] with
// maxt >= ceil(Q / 64) + min(U * U, Q), nt int32 [1].
int gather_minplus_twoside(const void* row_s, const void* us,
                           const void* row_t, const void* ut,
                           const void* tab, const void* gof, const void* pof,
                           int K, int m2, int U, const void* M, void* out,
                           int Q, int tiles, int maxt, void* perm, void* tl,
                           void* nt, void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const Slots sl{(const int*)tab, (const int*)gof, nullptr, (const int*)pof,
                 K, m2};
  if (!tiles) {
    gmp_twoside_warp<<<(Q + GW_WARPS - 1) / GW_WARPS, GW_WARPS * 32, 0,
                       st>>>((const float*)row_s, (const long long*)us,
                             (const float*)row_t, (const long long*)ut, sl,
                             (const float*)M, (float*)out, Q);
    return (int)cudaGetLastError();
  }
  if ((long long)U * U > GO_KEYS || maxt < 1)
    return (int)cudaErrorInvalidValue;
  gmp_order<<<1, GO_THREADS, 0, st>>>(
      (const long long*)us, (const long long*)ut, U, (const int*)tab,
      (const int*)gof, K, Q, (int*)perm, (int2*)tl, (int*)nt, (float*)out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K + TA_BY - 1) / TA_BY, maxt);
  gmp_twoside_tiles<<<grid, TA_THREADS, 0, st>>>(
      (const float*)row_s, (const long long*)us, (const float*)row_t,
      (const long long*)ut, sl, (const float*)M, (float*)out,
      (const int*)perm, (const int2*)tl, (const int*)nt);
  return (int)cudaGetLastError();
}

}  // extern "C"
