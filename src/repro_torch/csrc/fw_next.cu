// Batched witness-carrying Floyd-Warshall for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/floyd_warshall.py:
// fw_batch_next_pallas (_fw_next_block_kernel).  For every matrix of a
// batch d[b, n, n] (float32, +inf = no edge) it writes
//   dist[b, i, j] = shortest i -> j distance (diagonal forced to 0),
//   nxt[b, i, j]  = first hop of a shortest i -> j path
//                   (-1: unreachable or i == j),
// array-equal to repro_torch/kernels/ref.py:fw_batch_next_ref.  The
// callers compare nxt tables array for array, so every variant
// reproduces the serial pivot order and the strict "<" of the
// reference, ties included.
//
// The invariant every variant rests on: the diagonal is 0 and every
// weight is nonnegative, so during pivot k neither row k, nor column k,
// nor nxt[:, k] changes (cand = d[i][k] + 0 is never < d[i][k]).
// Updating in place is therefore exact: every cell (i, j) is written
// only by the thread that owns it, and one barrier (or one launch
// boundary) between pivots reproduces the reference's functional update.
//
// Two launch shapes:
//  * fw_next_reg: every matrix in registers, n <= 64 (below).
//  * fw_next_blocked: an init pass, then two launches per k-block
//    K = [s, s + B) over all b matrices (B = FWB_B); any n.
//
// The blocked schedule.  The textbook 3-phase blocked FW (close the
// pivot tile, then the bands against the closed tile, then the rest
// against the finished bands) gives the same distances but other first
// hops on ties: a cell outside the bands then sees the bands as they
// stand after all of K, not as the serial recurrence sees them at step
// k, and a tied path through a later pivot can win where the serial
// order kept an earlier one.  Snapshots make it exact.  Pivot k reads
// only row k and column k as they stood at step k-1, and (invariant
// above) they do not change at step k.  So
//  * phases 1+2 (fw_blocked_band_kernel, one launch): each band tile
//    (the K rows x a column tile, or a row tile x the K columns) loads
//    the pivot tile beside it into shared memory and runs the B pivots
//    of K over both in order, a barrier between pivots, so every band
//    cell reads the pivot tile at its own step.  At step k the column
//    band writes its column k with its first hops (C, CN) and the row
//    band its row k (R): the values the serial recurrence reads there.
//    The row band's pivot-column tile writes the closed pivot tile to
//    scratch; every other band tile writes itself back in place (the
//    pivot tile, which all blocks read, is not written in this launch).
//  * phase 3 (fw_blocked_cross_kernel, one launch): every cell outside
//    the bands takes the first strict minimum over k in K (ascending) of
//    C[i, k] + R[k, j], with CN[i, k] as its first hop; D wins ties.
//    That is a (min,+) product with an argmin carry: a 64 x 64 output
//    tile per block, an 8 x 4 register micro-tile of distance and
//    witness per thread, C^T, CN^T and R staged through shared memory
//    (the whole depth K fits at once, so overlap of loads and compute
//    comes from the other blocks resident on the SM).  A tile whose staged C or R
//    is all +inf cannot change and is skipped.  The same block copies
//    the closed pivot tile from scratch into place.
// Scratch (allocated by the caller, fw_next_blocked_scratch bytes):
// C^T f32 [b, B, n], CN^T i32 [b, B, n], R f32 [b, B, n] (transposed, so
// both the snapshot writes and phase 3's loads are coalesced), and the
// closed pivot tile f32 + i32 [b, B, B].
//
// Bound on this card: the function moves 12 bytes a cell (read d, write
// dist and nxt) and does 2 operations per cell and pivot (add, compare),
// so at n >= ~20 it is bound by operations (float32, no tensor-core
// form for (min,+)).  The blocked variant issues 4 instructions per cell
// and pivot in phase 3 (add, compare, two selects: the witness) and
// re-reads and re-writes dist and nxt once per k-block (16 bytes a cell
// every n / B pivots); its
// phases 1+2 are B serial steps over 2 B x B tiles per block.
//
// The register variant (fw_next_reg, the piece buckets: [6211, 8, 8]
// and [75, 32, 32] at road64k, [407, 8, 8] and [6, 32, 32] at
// road4000).  The function moves 12 bytes a cell and does 2 operations
// per cell and pivot, so at n = 8 it is bound by bytes (1.4 us for
// road64k's 6,211 pieces) and at n = 32 the n pivots are a serial chain
// per matrix.  The first port held a matrix in shared memory, one
// thread a cell, a block barrier a pivot, a runtime division and three
// shared accesses per cell and pivot.  Here the cells live in registers
// and only row k crosses threads:
//  * n <= 8 (fw_next_warp_kernel): a warp holds 4 matrices, one row a
//    lane, so d[i][k] and nxt[i][k] are the lane's own registers at a
//    static index (the pivot loop is unrolled).  Row k goes through a
//    per-warp shared strip, double-buffered by the parity of k: lane
//    k + 1 publishes its row right after its pivot-k update, and one
//    __syncwarp closes the pivot.  No block barrier, no division in the
//    loop.  Loads and stores are coalesced: the warp copies its
//    matrices (contiguous, 1 KB at n = 8) through a shared buffer with
//    rows padded to NP + 4 floats, so the lanes' row reads are free of
//    bank conflicts.
//  * 8 < n <= 32 (fw_next_split_kernel): the same with 4 lanes a row
//    (8 columns each) and one block of 4 warps a matrix: a warp alone
//    would issue 128 instructions a pivot at n = 32.  d[i][k] and
//    nxt[i][k] come from the row's lane that owns column k by shuffle;
//    one block barrier a pivot.
//  * 32 < n <= 64 (fw_next_tile_kernel): one block of 256 threads a
//    matrix, each thread a 4 x 4 tile of dist and nxt: the register-tile
//    body of fw_reg_tile.cuh, which fw_dist.cu's fw_dist_reg shares,
//    with the witness carried (the owners of column k + 1 publish its
//    first hops too), one barrier a pivot.
// All three read row k (and column k) as they stood before pivot k, which
// the invariant above makes the same as during it.

// Plain IEEE float adds only: built without --use_fast_math, and
// inf + x stays inf, so no NaN can arise from the +inf padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fw_reg_tile.cuh"

#define FW_TILE 32
#define FWR_WARPS 4                // warps a block of fw_next_warp_kernel
// k-block width B, pivots per k-block.  The band phases cost ~4 n^2 b B
// cell updates against phase 3's n^3 b, a wider block halves phase 3's
// dist/nxt passes: measured on the H100, 32 beat 64 at every shape of
// the main path, n = 4,613 included (scripts/fw_blocked_tune.py builds
// other widths with -DFWB_B).
#ifndef FWB_B
#define FWB_B 32
#endif
#define FWB_P 64                   // phase-3 output tile, rows and cols
#define FWB_RM 8                   // phase-3 rows per thread
#define FWB_CM 4                   // phase-3 cols per thread
#define FWB_P3_THREADS ((FWB_P / FWB_RM) * (FWB_P / FWB_CM))

__device__ __forceinline__ void init_cell(float v, int i, int j,
                                          float* d, int* nx) {
  if (i == j) v = 0.0f;
  *d = v;
  *nx = (i != j && isfinite(v)) ? j : -1;
}

// One matrix row a lane: d[i][:] and its first hops in registers.
// NP: padded n (8), G = 32 / NP matrices a warp.  EXACT: n ==
// NP and the pointers 16-byte aligned (float4 copies, constant shifts).
template <int NP, bool EXACT>
__global__ void __launch_bounds__(FWR_WARPS * 32)
fw_next_warp_kernel(const float* __restrict__ din, float* __restrict__ dout,
                    int* __restrict__ nout, long long b, int n_arg) {
  constexpr int G = 32 / NP;                // matrices a warp
  constexpr int P = NP + 4;                 // padded row pitch (floats)
  constexpr int MS = NP * P;                // staged floats a matrix
  __shared__ __align__(16) float stage[FWR_WARPS][G * MS];
  __shared__ __align__(16) float rowk[FWR_WARPS][2][G][NP];
  const float inf = __int_as_float(0x7f800000);
  const int n = EXACT ? NP : n_arg;
  const int nn = n * n;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / NP, i = lane % NP;
  const long long m0 = ((long long)blockIdx.x * FWR_WARPS + w) * G;
  if (m0 >= b) return;                      // the whole warp
  const int gc = (int)min((long long)G, b - m0);   // live matrices
  const int total = gc * nn;
  const size_t off = (size_t)m0 * nn;
  float* st = stage[w];

  // the warp's matrices, contiguous in memory -> padded rows
  if (EXACT) {
    const float4* src = reinterpret_cast<const float4*>(din + off);
    for (int e = lane; e < total / 4; e += 32) {
      const int f = 4 * e, mg = f / nn, rem = f % nn;
      *reinterpret_cast<float4*>(&st[mg * MS + rem / NP * P + rem % NP]) =
          src[e];
    }
  } else {
    for (int f = lane; f < total; f += 32) {
      const int mg = f / nn, rem = f - mg * nn, r = rem / n;
      st[mg * MS + r * P + (rem - r * n)] = din[off + f];
    }
  }
  __syncwarp();
  const bool live = g < gc && i < n;
  float* row = st + g * MS + i * P;
  float d[NP];
  int nx[NP];
#pragma unroll
  for (int q = 0; q < NP; q += 4) {
    const float4 v = live ? *reinterpret_cast<const float4*>(row + q)
                          : make_float4(inf, inf, inf, inf);
    d[q] = v.x; d[q + 1] = v.y; d[q + 2] = v.z; d[q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {            // init_cell, padding +inf
    float v = j < n ? d[j] : inf;
    if (live && j == i) v = 0.0f;
    d[j] = v;
    nx[j] = (j != i && isfinite(v)) ? j : -1;
  }

  float (*rk)[G][NP] = rowk[w];
#define FWR_PUBLISH(BUF)                                                  \
  do {                                                                   \
    _Pragma("unroll") for (int q = 0; q < NP; q += 4)                    \
      *reinterpret_cast<float4*>(&rk[BUF][g][q]) =                       \
          make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);               \
  } while (0)
  if (i == 0) FWR_PUBLISH(0);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (k < n) {                            // uniform: n is the warp's
      const float dik = d[k];               // unchanged at pivot k
      const int nik = nx[k];
      const float* r = rk[k & 1][g];
#pragma unroll
      for (int q = 0; q < NP; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + q);
        const float dk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float cand = dik + dk[t];
          const bool better = cand < d[q + t];
          d[q + t] = better ? cand : d[q + t];
          nx[q + t] = better ? nik : nx[q + t];
        }
      }
      if (k + 1 < n && i == k + 1) FWR_PUBLISH((k + 1) & 1);
      __syncwarp();
    }
  }
#undef FWR_PUBLISH

  // dist, then the first hops, back through the padded rows
  int* sti = reinterpret_cast<int*>(st);
  int* rowi = reinterpret_cast<int*>(row);
  for (int pass = 0; pass < 2; ++pass) {
    if (live) {
#pragma unroll
      for (int q = 0; q < NP; q += 4) {
        if (pass == 0)
          *reinterpret_cast<float4*>(row + q) =
              make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);
        else
          *reinterpret_cast<int4*>(rowi + q) =
              make_int4(nx[q], nx[q + 1], nx[q + 2], nx[q + 3]);
      }
    }
    __syncwarp();
    if (EXACT) {
      int4* dst = pass == 0 ? reinterpret_cast<int4*>(dout + off)
                            : reinterpret_cast<int4*>(nout + off);
      for (int e = lane; e < total / 4; e += 32) {
        const int f = 4 * e, mg = f / nn, rem = f % nn;
        dst[e] = *reinterpret_cast<const int4*>(
            &sti[mg * MS + rem / NP * P + rem % NP]);
      }
    } else {
      int* dst = pass == 0 ? reinterpret_cast<int*>(dout + off) : nout + off;
      for (int f = lane; f < total; f += 32) {
        const int mg = f / nn, rem = f - mg * nn, r = rem / n;
        dst[f] = sti[mg * MS + r * P + (rem - r * n)];
      }
    }
    __syncwarp();
  }
}

// n <= NP = 32: one block a matrix, Q threads a row, each W = NP / Q
// columns of it in registers (a single warp a matrix is held back by its
// issue rate: 4 instructions a cell, 32 cells a lane and pivot).  The Q
// threads of a row are adjacent lanes, so d[i][k] and nxt[i][k] come
// from the one of them that owns column k by two shuffles at a static
// register index; row k goes through a double-buffered shared strip,
// one block barrier a pivot.
template <int NP, int Q, bool EXACT>
__global__ void __launch_bounds__(NP * Q)
fw_next_split_kernel(const float* __restrict__ din, float* __restrict__ dout,
                     int* __restrict__ nout, int n_arg) {
  constexpr int W = NP / Q;                 // columns a thread
  constexpr int T = NP * Q;                 // threads a matrix
  constexpr int P = NP + 4;                 // padded row pitch (floats)
  static_assert(32 % Q == 0 && W % 4 == 0, "a row's threads share a warp");
  __shared__ __align__(16) float st[NP * P];
  __shared__ __align__(16) float rowk[2][NP];
  const float inf = __int_as_float(0x7f800000);
  const int n = EXACT ? NP : n_arg;
  const int nn = n * n;
  const int i = threadIdx.x / Q, j0 = (threadIdx.x % Q) * W;
  const int lane = threadIdx.x % 32;
  const size_t off = (size_t)blockIdx.x * nn;

  if (EXACT) {
    const float4* src = reinterpret_cast<const float4*>(din + off);
    for (int e = threadIdx.x; e < nn / 4; e += T) {
      const int f = 4 * e;
      *reinterpret_cast<float4*>(&st[f / NP * P + f % NP]) = src[e];
    }
  } else {
    for (int f = threadIdx.x; f < nn; f += T) {
      const int r = f / n;
      st[r * P + (f - r * n)] = din[off + f];
    }
  }
  __syncthreads();
  const bool live = i < n;
  float* row = st + i * P + j0;
  float d[W];
  int nx[W];
#pragma unroll
  for (int q = 0; q < W; q += 4) {
    const float4 v = live ? *reinterpret_cast<const float4*>(row + q)
                          : make_float4(inf, inf, inf, inf);
    d[q] = v.x; d[q + 1] = v.y; d[q + 2] = v.z; d[q + 3] = v.w;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {             // init_cell, padding +inf
    const int j = j0 + w;
    float v = j < n ? d[w] : inf;
    if (live && j == i) v = 0.0f;
    d[w] = v;
    nx[w] = (j != i && isfinite(v)) ? j : -1;
  }
#define FWS_PUBLISH(BUF)                                                  \
  do {                                                                   \
    _Pragma("unroll") for (int q = 0; q < W; q += 4)                     \
      *reinterpret_cast<float4*>(&rowk[BUF][j0 + q]) =                   \
          make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);               \
  } while (0)
  if (i == 0) FWS_PUBLISH(0);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (k < n) {                            // uniform
      // column k of this row, unchanged at pivot k, from its owner
      const int src = (lane & ~(Q - 1)) | (k / W);
      const float dik = __shfl_sync(0xffffffffu, d[k % W], src);
      const int nik = __shfl_sync(0xffffffffu, nx[k % W], src);
      const float* r = &rowk[k & 1][j0];
#pragma unroll
      for (int q = 0; q < W; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + q);
        const float dk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float cand = dik + dk[t];
          const bool better = cand < d[q + t];
          d[q + t] = better ? cand : d[q + t];
          nx[q + t] = better ? nik : nx[q + t];
        }
      }
      if (k + 1 < n && i == k + 1) FWS_PUBLISH((k + 1) & 1);
      __syncthreads();
    }
  }
#undef FWS_PUBLISH

  int* sti = reinterpret_cast<int*>(st);
  int* rowi = reinterpret_cast<int*>(row);
  for (int pass = 0; pass < 2; ++pass) {
    if (live) {
#pragma unroll
      for (int q = 0; q < W; q += 4) {
        if (pass == 0)
          *reinterpret_cast<float4*>(row + q) =
              make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);
        else
          *reinterpret_cast<int4*>(rowi + q) =
              make_int4(nx[q], nx[q + 1], nx[q + 2], nx[q + 3]);
      }
    }
    __syncthreads();
    if (EXACT) {
      int4* dst = pass == 0 ? reinterpret_cast<int4*>(dout + off)
                            : reinterpret_cast<int4*>(nout + off);
      for (int e = threadIdx.x; e < nn / 4; e += T) {
        const int f = 4 * e;
        dst[e] = *reinterpret_cast<const int4*>(&sti[f / NP * P + f % NP]);
      }
    } else {
      int* dst = pass == 0 ? reinterpret_cast<int*>(dout + off) : nout + off;
      for (int f = threadIdx.x; f < nn; f += T) {
        const int r = f / n;
        dst[f] = sti[r * P + (f - r * n)];
      }
    }
    __syncthreads();
  }
}

// One block a matrix, n <= NP: thread (ty, tx) holds rows ty RM ..,
// columns tx 4 .. of dist and nxt (fw_reg_tile.cuh).
template <int NP, int RM>
__global__ void __launch_bounds__((NP / RM) * (NP / FWT_RN))
fw_next_tile_kernel(const float* __restrict__ din, float* __restrict__ dout,
                    int* __restrict__ nout, int n) {
  const size_t base = (size_t)blockIdx.x * n * n;
  fw_reg_tile<NP, RM, true>(din + base, n, dout + base, nout + base, n, n);
}

template <int NP>
static void warp_launch(const float* din, float* dout, int* nout, int b,
                        int n, bool exact, cudaStream_t s) {
  constexpr int per_block = FWR_WARPS * (32 / NP);
  const int blocks = (b + per_block - 1) / per_block;
  if (exact)
    fw_next_warp_kernel<NP, true><<<blocks, FWR_WARPS * 32, 0, s>>>(
        din, dout, nout, b, n);
  else
    fw_next_warp_kernel<NP, false><<<blocks, FWR_WARPS * 32, 0, s>>>(
        din, dout, nout, b, n);
}

__global__ void fw_next_init_kernel(const float* __restrict__ din,
                                    float* __restrict__ dout,
                                    int* __restrict__ nout, int n) {
  const int j = blockIdx.x * FW_TILE + threadIdx.x;
  const int i = blockIdx.y * FW_TILE + threadIdx.y;
  if (i >= n || j >= n) return;
  const size_t c = (size_t)blockIdx.z * n * n + (size_t)i * n + j;
  init_cell(din[c], i, j, &dout[c], &nout[c]);
}

// Phases 1+2 of k-block [s, s + kb), kb = min(B, n - s).  blockIdx.x < T:
// row band tile t = blockIdx.x (rows K x cols [tB, tB + B)); else column
// band tile t = blockIdx.x - T (rows [tB, tB + B) x cols K).
// blockIdx.y: the matrix.  B * B / 4 threads: each owns 4 cells of the
// pivot tile and the same 4 of the band tile (one column e, rows 4 apart
// by B / 4), kept in registers and mirrored to shared memory when they
// change, since other threads read row and column kk there.
template <int B>
__global__ void __launch_bounds__(B * B / 4)
fw_blocked_band_kernel(float* __restrict__ d, int* __restrict__ nx,
                       float* __restrict__ ct, int* __restrict__ cnt,
                       float* __restrict__ rt, float* __restrict__ pd,
                       int* __restrict__ pn, int n, int s, int T) {
  constexpr int W = B + 1;              // padded pitch: conflict-free columns
  constexpr int AS = B / 4;             // rows between a thread's cells
  extern __shared__ unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);      // pivot tile [B][W]
  int* PN = reinterpret_cast<int*>(P + B * W);
  float* Q = reinterpret_cast<float*>(PN + B * W);  // band tile [B][W]
  int* QN = reinterpret_cast<int*>(Q + B * W);
  const float inf = __int_as_float(0x7f800000);
  const int bb = blockIdx.y;
  const size_t base = (size_t)bb * n * n;
  const size_t sb = (size_t)bb * B * n;
  const bool rowband = blockIdx.x < T;
  const int t = rowband ? blockIdx.x : blockIdx.x - T;
  const bool pivot_tile = t * B == s;
  const int kb = min(B, n - s);
  const int r0 = rowband ? s : t * B;
  const int c0 = rowband ? t * B : s;
  const int e = threadIdx.x % B, a0 = threadIdx.x / B;
  float pv[4], qv[4];
  int pnv[4], qnv[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int a = a0 + m * AS;
    bool in = a < kb && e < kb;
    size_t g = base + (size_t)(s + a) * n + (s + e);
    pv[m] = in ? d[g] : inf;
    pnv[m] = in ? nx[g] : -1;
    const int i = r0 + a, j = c0 + e;
    in = i < n && j < n;
    g = base + (size_t)i * n + j;
    qv[m] = in ? d[g] : inf;
    qnv[m] = in ? nx[g] : -1;
    P[a * W + e] = pv[m];
    PN[a * W + e] = pnv[m];
    Q[a * W + e] = qv[m];
    QN[a * W + e] = qnv[m];
  }
  __syncthreads();
  for (int kk = 0; kk < kb; ++kk) {
    // snapshots: row / column kk as the serial recurrence reads them
    // at step s + kk (unchanged by that step)
    if (threadIdx.x < B) {
      const int x = threadIdx.x, g = t * B + x;
      if (g < n) {
        if (rowband) {
          rt[sb + (size_t)kk * n + g] = Q[kk * W + x];
        } else {
          ct[sb + (size_t)kk * n + g] = Q[x * W + kk];
          cnt[sb + (size_t)kk * n + g] = QN[x * W + kk];
        }
      }
    }
    const float pke = P[kk * W + e];
    const float qke = Q[kk * W + e];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int a = a0 + m * AS;
      const float pak = P[a * W + kk];
      float cand = pak + pke;
      if (cand < pv[m]) {
        pv[m] = cand;
        pnv[m] = PN[a * W + kk];
        P[a * W + e] = cand;
        PN[a * W + e] = pnv[m];
      }
      cand = rowband ? pak + qke : Q[a * W + kk] + pke;
      if (cand < qv[m]) {
        qv[m] = cand;
        qnv[m] = rowband ? PN[a * W + kk] : QN[a * W + kk];
        Q[a * W + e] = cand;
        QN[a * W + e] = qnv[m];
      }
    }
    __syncthreads();
  }
  if (pivot_tile && !rowband) return;     // the row band's copy writes it
  const size_t pb = (size_t)bb * B * B;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int a = a0 + m * AS;
    if (pivot_tile) {                      // closed pivot tile to scratch
      pd[pb + a * B + e] = qv[m];
      pn[pb + a * B + e] = qnv[m];
      continue;
    }
    const int i = r0 + a, j = c0 + e;
    if (i < n && j < n) {
      d[base + (size_t)i * n + j] = qv[m];
      nx[base + (size_t)i * n + j] = qnv[m];
    }
  }
}

// Phase 3 of k-block [s, s + kb): grid (col tiles, row tiles, matrix).
// Thread (tr, tc) owns rows i0 + 8 tr + a (a < 8) and columns
// j0 + tc + 16 b (b < 4): coalesced dist/nxt loads and stores, float4
// loads of C^T and CN^T, conflict-free loads of R.
template <int B>
__global__ void __launch_bounds__(FWB_P3_THREADS)
fw_blocked_cross_kernel(float* __restrict__ d, int* __restrict__ nx,
                        const float* __restrict__ ct,
                        const int* __restrict__ cnt,
                        const float* __restrict__ rt,
                        const float* __restrict__ pd,
                        const int* __restrict__ pn, int n, int s) {
  constexpr int P = FWB_P, TC = FWB_P / FWB_CM;
  __shared__ __align__(16) float cs[B][P];   // C^T: [k][row]
  __shared__ __align__(16) int cns[B][P];    // CN^T
  __shared__ __align__(16) float rs[B][P];   // R: [k][col]
  const float inf = __int_as_float(0x7f800000);
  const int i0 = blockIdx.y * P, j0 = blockIdx.x * P, bb = blockIdx.z;
  const int kb = min(B, n - s), e = s + kb;
  const size_t base = (size_t)bb * n * n;
  if (i0 < e && i0 + P > s && j0 < e && j0 + P > s) {
    const size_t pb = (size_t)bb * B * B;
    for (int c = threadIdx.x; c < kb * kb; c += blockDim.x) {
      const int i = s + c / kb, j = s + c % kb;
      if (i >= i0 && i < i0 + P && j >= j0 && j < j0 + P) {
        const int o = (i - s) * B + (j - s);
        d[base + (size_t)i * n + j] = pd[pb + o];
        nx[base + (size_t)i * n + j] = pn[pb + o];
      }
    }
  }
  // a tile inside the row or the column band has nothing left to do
  if ((i0 >= s && min(i0 + P, n) <= e) || (j0 >= s && min(j0 + P, n) <= e))
    return;
  const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
  float acc[FWB_RM][FWB_CM];
  int hop[FWB_RM][FWB_CM];
#pragma unroll
  for (int a = 0; a < FWB_RM; ++a) {       // issued before the staging
    const int i = i0 + tr * FWB_RM + a;
#pragma unroll
    for (int b = 0; b < FWB_CM; ++b) {
      const int j = j0 + tc + TC * b;
      const bool in = i < n && j < n;
      acc[a][b] = in ? d[base + (size_t)i * n + j] : inf;
      hop[a][b] = in ? nx[base + (size_t)i * n + j] : -1;
    }
  }
  const size_t sb = (size_t)bb * B * n;
  int fc = 0, fr = 0;
#pragma unroll
  for (int m = 0; m < B * P / FWB_P3_THREADS; ++m) {
    const int c = threadIdx.x + m * FWB_P3_THREADS;
    const int kk = c / P, x = c % P;
    const int i = i0 + x, j = j0 + x;
    const size_t o = sb + (size_t)kk * n;
    const float cv = (kk < kb && i < n) ? ct[o + i] : inf;
    const float rv = (kk < kb && j < n) ? rt[o + j] : inf;
    cs[kk][x] = cv;
    cns[kk][x] = (kk < kb && i < n) ? cnt[o + i] : -1;
    rs[kk][x] = rv;
    fc |= cv != inf;
    fr |= rv != inf;
  }
  fc = __syncthreads_or(fc);
  fr = __syncthreads_or(fr);
  if (!fc || !fr) return;                 // no finite C[i,k] + R[k,j]
  // k ascending, strict <: the first k at the minimum, D wins ties
#pragma unroll 4
  for (int kk = 0; kk < B; ++kk) {
    const float4 c0 = *reinterpret_cast<const float4*>(&cs[kk][tr * FWB_RM]);
    const float4 c1 =
        *reinterpret_cast<const float4*>(&cs[kk][tr * FWB_RM + 4]);
    const int4 n0 = *reinterpret_cast<const int4*>(&cns[kk][tr * FWB_RM]);
    const int4 n1 =
        *reinterpret_cast<const int4*>(&cns[kk][tr * FWB_RM + 4]);
    const float cv[FWB_RM] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z,
                              c1.w};
    const int cn[FWB_RM] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    float rv[FWB_CM];
#pragma unroll
    for (int b = 0; b < FWB_CM; ++b) rv[b] = rs[kk][tc + TC * b];
#pragma unroll
    for (int a = 0; a < FWB_RM; ++a)
#pragma unroll
      for (int b = 0; b < FWB_CM; ++b) {
        const float cand = cv[a] + rv[b];
        const bool better = cand < acc[a][b];
        acc[a][b] = better ? cand : acc[a][b];
        hop[a][b] = better ? cn[a] : hop[a][b];
      }
  }
#pragma unroll
  for (int a = 0; a < FWB_RM; ++a) {
    const int i = i0 + tr * FWB_RM + a;
    if (i >= n || (i >= s && i < e)) continue;
#pragma unroll
    for (int b = 0; b < FWB_CM; ++b) {
      const int j = j0 + tc + TC * b;
      if (j >= n || (j >= s && j < e)) continue;
      d[base + (size_t)i * n + j] = acc[a][b];
      nx[base + (size_t)i * n + j] = hop[a][b];
    }
  }
}

// k-blocks of B pivots over matrices [b0, b0 + bc) of dd / nd (already
// initialised), scratch carved for b matrices.
template <int B>
static cudaError_t fw_blocked_run(float* dd, int* nd, void* scratch, int b,
                                  int bc, int n, cudaStream_t st) {
  const int band_bytes = 4 * B * (B + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fw_blocked_band_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      band_bytes);
  if (err != cudaSuccess) return err;
  const int T = (n + B - 1) / B;
  const int T3 = (n + FWB_P - 1) / FWB_P;
  const size_t bn = (size_t)B * n;
  float* ct = (float*)scratch;
  int* cnt = (int*)(ct + (size_t)b * bn);
  float* rt = (float*)(cnt + (size_t)b * bn);
  float* pd = rt + (size_t)b * bn;
  int* pn = (int*)(pd + (size_t)b * B * B);
  for (int s = 0; s < n; s += B) {
    fw_blocked_band_kernel<B><<<dim3(2 * T, bc), B * B / 4, band_bytes, st>>>(
        dd, nd, ct, cnt, rt, pd, pn, n, s, T);
    fw_blocked_cross_kernel<B><<<dim3(T3, T3, bc), FWB_P3_THREADS, 0, st>>>(
        dd, nd, ct, cnt, rt, pd, pn, n, s);
  }
  return cudaGetLastError();
}

extern "C" {

// din, dout: float32 [b, n, n]; nout: int32 [b, n, n]; n <= np, np the
// padded n of the variant (8: a row a lane; 32: a quarter row a
// thread; 64: a 4 x 4 tile a thread).
int fw_next_reg(const void* din, void* dout, void* nout, int b, int n,
                int np, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > np) return (int)cudaErrorInvalidValue;
  const float* di = (const float*)din;
  float* dd = (float*)dout;
  int* nd = (int*)nout;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool exact = n == np && ((size_t)din | (size_t)dout |
                                 (size_t)nout) % 16 == 0;
  switch (np) {
    case 8: warp_launch<8>(di, dd, nd, b, n, exact, s); break;
    case 32:
      if (exact)
        fw_next_split_kernel<32, 4, true><<<b, 32 * 4, 0, s>>>(di, dd, nd, n);
      else
        fw_next_split_kernel<32, 4, false><<<b, 32 * 4, 0, s>>>(di, dd, nd,
                                                               n);
      break;
    case 64:
      fw_next_tile_kernel<64, 4><<<b, (64 / 4) * (64 / 4), 0, s>>>(
          di, dd, nd, n);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Bytes of scratch fw_next_blocked takes for b matrices of n nodes.
size_t fw_next_blocked_scratch(int b, int n) {
  const size_t B = FWB_B;
  return (size_t)b * (3 * B * n + 2 * B * B) * sizeof(float);
}

// Same contract, any n: init pass, then per k-block of B pivots one
// launch of phases 1+2 and one of phase 3.  scratch: at least
// fw_next_blocked_scratch(b, n) bytes, 16-byte aligned.
int fw_next_blocked(const void* din, void* dout, void* nout, void* scratch,
                    int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (n + FW_TILE - 1) / FW_TILE;
  const size_t nn = (size_t)n * n;
  // gridDim.y and .z are capped at 65535: walk the batch in chunks
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int bc = (b - b0 < 65535) ? b - b0 : 65535;
    const float* di = (const float*)din + b0 * nn;
    float* dd = (float*)dout + b0 * nn;
    int* nd = (int*)nout + b0 * nn;
    fw_next_init_kernel<<<dim3(tiles, tiles, bc), dim3(FW_TILE, FW_TILE), 0,
                          st>>>(di, dd, nd, n);
    const cudaError_t err =
        fw_blocked_run<FWB_B>(dd, nd, scratch, b, bc, n, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
