// Tropical (min,+) matrix product for Hopper (sm_90a), with and
// without accumulation into an existing matrix.
//
// Replaces the Pallas kernels repro/kernels/minplus.py:
//   minplus_pallas (_minplus_kernel):              C = A (x) B
//   minplus_accum_pallas (_minplus_accum_kernel):  C = min(C_in, A (x) B)
// with (A (x) B)[i, j] = min_k A[i, k] + B[k, j], A [M, K], B [K, N],
// C_in and C [M, N], all float32 with +inf absorbing.  The blocked
// Floyd-Warshall (the hierarchy's top closure, one matrix, and kernel
// 3's route above n = 128, a batch of matrices: fw_dist.cu's note) runs
// its phases 2 and 3 through the in-place entries minplus_accum_panels
// and minplus_accum_ld (minplus_accum keeps the fresh-output contract);
// one-to-all serving runs minplus as a vector x matrix product against
// the top (or dense) closure.
//
// What bounds them on the H100: 2 operations per (i, k, j) triple (add,
// min) in float32 outside the tensor cores ((min,+) has no tensor-core
// form) against 4 bytes per element of A, B, C_in and C.  The blocked
// FW's phase 3 (C ~1,7xx^2, K = 64 or 128) is bound by operations; an
// inner loop of nothing but FADD / FMNMX pairs and shared loads has run
// at 7-8e12 triples/s in every (min,+) kernel of this port, well under
// 67 TFLOP/s / 2.  The phase-2 panels (64 or 128 rows x 1,7xx x K and
// the transpose) are small: with 64 x 64 tiles they filled 28 of 132
// SMs, and every block re-reads the whole pivot tile.
//
// minplus_accum (accum_tile): each block owns a BM x BN tile of C,
// walks k through 16-deep tiles of A and B staged by cp.async (16-byte
// copies where the views allow, else 4-byte) with NS tiles in flight,
// and keeps an RM x RN register micro-tile a thread: for phase 3, 4 x 4
// in 64 x 64 tiles (729 blocks of 256 threads at 1,728^2) where K <= 64,
// else 8 x 8 in 128 x 64 tiles (392 blocks of 128 at 1,792^2).  A rows
// are padded to 20 floats, so the float4 reads along k of a quarter
// warp's 8 rows hit 32 banks; the RN columns are float4 groups
// interleaved across the lanes, so a warp's B reads are conflict-free.
// The tile shape follows the matrix: in minplus_accum_ld panels of at
// most 128 rows take 128 x 8 (or 64 x 8) tiles, panels of at most 128
// columns 8 x 128 (8 x 64), each with four k-tiles in flight; anything
// else the phase-3 tiles.  Masked loads read +inf past the ragged edge;
// nothing is padded by copies.  minplus_accum_panels runs phase 2's row
// and column panels in one launch (minplus_panels_kernel), one block
// range each, in tiles that span their panel (64 x 16 and 16 x 64 for
// k-blocks of 64, else 128 x 8 and 8 x 128).
//
// Both in-place entries take a batch: the grid's z axis is the matrix
// (walked in chunks of 65,535), each operand's matrix z at z times its
// batch stride.  A batch (more than one matrix) runs the BATCHED
// instantiation, in which a block skips a k-tile whose staged A or B is
// all +inf: it cannot lower any cell.  Each thread tests the cells it
// copied itself and two block reductions (__syncthreads_or, the first
// also the barrier after the copies) decide for the block; a tile that
// skipped every k-tile reads no C_in and writes nothing.  A batch of
// road fragments (99.6% +inf as it comes in, 32% once closed: sparse
// roads, and the padding of the smaller fragments) saves about 40% of
// its time by it; a warp-vote form of the test and a test of the whole
// tile's panels before the loop were slower (PERF.md).  One matrix (the
// top closure's ops.fw_apsp) runs the instantiation without the batch
// offsets or the test, the code it ran before batches existed: the
// offsets alone made its phase 3 ~12% slower.
//
// In place, with leading dimensions (minplus_accum_ld,
// minplus_accum_panels): the blocked schedule passes views of its
// padded matrix, and C may alias C_in, A and B.  That is race-free only
// where no block writes a cell that another block reads:
//  * phase 2 (minplus_accum_panels), row panel: C = C_in = B = D[K, :],
//    A = D[K, K].  M <= 128 rows and the row tiles are 128 (or 64)
//    high, so one block owns every row of its column tile: B being the
//    same window as C, the block reads B only in its own tile, and it
//    stages all of it before its epilogue writes.  The columns of A
//    (the pivot tile, read by every block) are skipped (skip_c), since
//    min(P, P (x) P) = P for a closed P.
//  * phase 2, column panel: C = C_in = A = D[:, K], B = D[K, K].  N <=
//    128 columns and the column tiles are 128 (or 64) wide, so one
//    block owns every column of its row tile, and the pivot tile's rows
//    are skipped (skip_r).  The two panels share only the pivot tile,
//    which neither writes.
//  * phase 3 (minplus_accum_ld): C = C_in = D, A = D[:, K], B = D[K, :];
//    the band rows and columns are skipped.  They are final after
//    phase 2 (the band of a closed pivot tile is a fixed point of
//    phase 3), and A and B lie wholly inside them, so no block writes
//    what another reads.  minplus_accum_ld picks its tile by shape
//    alone, so it takes no other alias: a panel aliased through it
//    could get tiles that split the panel.
// The wrappers (kernels/minplus.py) check these conditions.
//
// minplus (kernel 5) takes one of two routes, chosen by the caller
// (kernels/minplus.py: route):
//  * m <= MG_MAX_M (one-to-all's m = 1): minplus_gemv_kernel, a vector
//    (or few-row) x matrix product.  Its bound is bytes: B [K, N] is read
//    once across the grid (11.7 MB at road64k's [1,1712]x[1712,1712],
//    3.5 us at 3.35 TB/s), and the first port's 64 x 64 tiles left 63 of
//    64 rows idle on 27 blocks.  Here N is cut into strips of SW columns
//    and K into MG_SLICES k-slices, one block each, the k-slices of a
//    strip forming one thread-block cluster.  A block stages its slice
//    of A [m, k] in shared memory (cp.async, double-buffered chunks of
//    MG_KC rows, read by broadcast) and walks its B rows MG_U at a time
//    per thread, 4 columns a thread (one float4 where N and B allow,
//    else two float2 or four floats, each coalesced), so 4 KB of B a
//    warp is in flight.  Each thread keeps m x 4 minima; the row lanes
//    of a block fold theirs by warp shuffles and shared memory, and the
//    block of rank 0 folds the cluster's k-slices through distributed
//    shared memory and writes C.  One launch, no scratch, no atomics:
//    min is order-free, so the fold is exact for any input, negatives
//    included.
//  * m above it: the accumulate tiles below with no C_in (CIN = false:
//    nothing is read for it).
//
// Exact: integer-valued inputs keep every sum below 2**24, so any
// association order gives the reference's bits.  Built without
// --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "twoside_tiles.cuh"   // cp_async4 and the commit / wait helpers

namespace cg = cooperative_groups;

#define MA_BK 16      // k depth per staged tile

// A rows padded to 20 floats: 16-byte aligned for cp.async, and the
// float4 reads along k of 8 consecutive rows (a quarter warp) hit 32
// distinct banks
#define MA_AS (MA_BK + 4)

// cp.async.wait_group with a compile-time count
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One product C[i, j] = min(C_in[i, j], min_k A[i, k] + B[k, j]) over
// row-major views with leading dimensions (elements), rows in
// [sr0, sr1) and columns in [sc0, sc1) not written.  vec: A, B, lda,
// ldb, K and N (and a BatchJob's batch strides of A and B) all allow
// 16-byte copies.
struct AccumJob {
  const float* cin;
  long long ldcin;
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  float* c;
  long long ldc;
  int M, N, K, sr0, sr1, sc0, sc1, vec;
};

// The same product in each of `batch` matrices, matrix z of each operand
// at z times its batch stride (elements) from the first; C_in shares C's.
// Only the batched kernels take the strides: a one-matrix kernel's
// parameters stay an AccumJob, since 40 bytes more a job made the
// one-matrix APSP ~1% slower (PERF.md).
struct BatchJob : AccumJob {
  long long bsa, bsb, bsc;
  int batch;
};

template <bool BATCHED>
using JobOf = std::conditional_t<BATCHED, BatchJob, AccumJob>;

template <int BM, int BN, int NS>
struct AccumSmem {
  float as[NS][BM][MA_AS];
  float bs[NS][MA_BK][BN];
};

// Tile (bx, by) of job j: BM x BN cells of C.  Thread (tm, tn) owns rows
// tm + r * TM and columns g * 4 * TN + 4 * tn + q.  NS k-tiles are in
// flight (NS - 1 staged ahead of the one computed).  No __restrict__: C
// may alias C_in, A and B (see the note at the top).  CIN = false: C =
// A (x) B, with no C_in read (kernel 5 above MG_MAX_M rows).  BATCHED:
// the tile lies in matrix bz of a batch, and (with CIN) a k-tile whose
// staged A or B is all +inf, which adds nothing to min(C_in, A (x) B),
// is skipped, and a tile that skipped every k-tile leaves C as it is
// (no C_in read, no write).  Without BATCHED the code compiles as the
// one-matrix kernel did before batches existed (the same registers a
// tile shape): offsets, the test or the gating of the arithmetic left
// in a one-matrix build cost it 1-12% (PERF.md).
template <int BM, int BN, int TM, int TN, int NS, bool CIN = true,
          bool BATCHED = false>
__device__ __forceinline__ void accum_tile(const JobOf<BATCHED>& j, int bx,
                                           int by, int bz,
                                           AccumSmem<BM, BN, NS>& sm) {
  constexpr int RM = BM / TM;
  constexpr int RN = BN / TN;
  constexpr int G = RN / 4;
  constexpr int THREADS = TM * TN;
  static_assert(RN % 4 == 0 && BM % TM == 0 && BN % TN == 0, "tile");
  const int M = j.M, N = j.N, K = j.K;
  const int m0 = by * BM;
  const int n0 = bx * BN;
  // a tile whose rows (or columns) are all skipped writes nothing
  if (m0 >= j.sr0 && min(m0 + BM, M) <= j.sr1) return;
  if (n0 >= j.sc0 && min(n0 + BN, N) <= j.sc1) return;
  const int tn = threadIdx.x % TN;
  const int tm = threadIdx.x / TN;
  const float inf = __int_as_float(0x7f800000);
  const float4 inf4 = make_float4(inf, inf, inf, inf);
  const float* a = j.a;
  const float* b = j.b;
  if constexpr (BATCHED) {
    a += bz * j.bsa;
    b += bz * j.bsb;
  }

  auto stage = [&](int buf, int k0) {
    if (j.vec) {
      // 4 consecutive k of a row of A, 4 consecutive n of a row of B a
      // copy; K % 4 == N % 4 == 0, so a copy is wholly in or out
      for (int e = threadIdx.x; e < BM * MA_BK / 4; e += THREADS) {
        const int mm = e / (MA_BK / 4), kk = 4 * (e % (MA_BK / 4));
        const int m = m0 + mm, k = k0 + kk;
        float* dst = &sm.as[buf][mm][kk];
        if (m < M && k < K)
          cp_async16(dst, a + (long long)m * j.lda + k);
        else
          *reinterpret_cast<float4*>(dst) = inf4;
      }
      for (int e = threadIdx.x; e < MA_BK * BN / 4; e += THREADS) {
        const int kk = e / (BN / 4), nn = 4 * (e % (BN / 4));
        const int k = k0 + kk, n = n0 + nn;
        float* dst = &sm.bs[buf][kk][nn];
        if (k < K && n < N)
          cp_async16(dst, b + (long long)k * j.ldb + n);
        else
          *reinterpret_cast<float4*>(dst) = inf4;
      }
      return;
    }
    for (int e = threadIdx.x; e < BM * MA_BK; e += THREADS) {
      const int mm = e / MA_BK, kk = e % MA_BK;
      const int m = m0 + mm, k = k0 + kk;
      float* dst = &sm.as[buf][mm][kk];
      if (m < M && k < K)
        cp_async4(dst, a + (long long)m * j.lda + k);
      else
        *dst = inf;
    }
    for (int e = threadIdx.x; e < MA_BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int k = k0 + kk, n = n0 + nn;
      float* dst = &sm.bs[buf][kk][nn];
      if (k < K && n < N)
        cp_async4(dst, b + (long long)k * j.ldb + n);
      else
        *dst = inf;
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = inf;

  bool touched = !(CIN && BATCHED);   // some k-tile was computed
  const int ntiles = (K + MA_BK - 1) / MA_BK;
  // prologue: tiles 0 .. NS-2, one commit group each (empty past the end)
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) stage(t, t * MA_BK);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t % NS;
    // the buffer of tile t + NS - 1 was last read at tile t - 1, which
    // every thread finished before the barrier that closed it
    if (t + NS - 1 < ntiles) stage((t + NS - 1) % NS, (t + NS - 1) * MA_BK);
    cp_async_commit();
    cp_async_wait_group<NS - 1>();   // tile t landed
    if constexpr (CIN && BATCHED) {
      // whether a cell this thread copied into buffer cur is finite, in
      // A (la) and in B (lb): its own copies, which it sees once its
      // wait returns; the first reduction is also the barrier that shows
      // every thread's copies to the block, and the second follows every
      // read of buffer cur, so a skipped k-tile needs no closing barrier
      int la = 0, lb = 0;
      if (j.vec) {
        for (int e = threadIdx.x; e < BM * MA_BK / 4; e += THREADS) {
          const float4 v = *reinterpret_cast<const float4*>(
              &sm.as[cur][e / (MA_BK / 4)][4 * (e % (MA_BK / 4))]);
          la |= (v.x != inf) | (v.y != inf) | (v.z != inf) | (v.w != inf);
        }
        for (int e = threadIdx.x; e < MA_BK * BN / 4; e += THREADS) {
          const float4 v = *reinterpret_cast<const float4*>(
              &sm.bs[cur][e / (BN / 4)][4 * (e % (BN / 4))]);
          lb |= (v.x != inf) | (v.y != inf) | (v.z != inf) | (v.w != inf);
        }
      } else {
        for (int e = threadIdx.x; e < BM * MA_BK; e += THREADS)
          la |= sm.as[cur][e / MA_BK][e % MA_BK] != inf;
        for (int e = threadIdx.x; e < MA_BK * BN; e += THREADS)
          lb |= sm.bs[cur][e / BN][e % BN] != inf;
      }
      la = __syncthreads_or(la);
      lb = __syncthreads_or(lb);
      if (!(la && lb)) continue;      // uniform
      touched = true;
    } else {
      __syncthreads();
    }
#pragma unroll
    for (int k4 = 0; k4 < MA_BK; k4 += 4) {
      float4 av[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        av[r] =
            *reinterpret_cast<const float4*>(&sm.as[cur][tm + r * TM][k4]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float bv[RN];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              &sm.bs[cur][k4 + jj][g * 4 * TN + 4 * tn]);
          bv[4 * g] = v.x;
          bv[4 * g + 1] = v.y;
          bv[4 * g + 2] = v.z;
          bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float ar = jj == 0 ? av[r].x : jj == 1 ? av[r].y
                         : jj == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int q = 0; q < RN; ++q)
            acc[r][q] = fminf(acc[r][q], ar + bv[q]);
        }
      }
    }
    __syncthreads();          // buffer cur free for tile t + NS
  }
  cp_async_wait_all();
  if (!touched) return;               // uniform: the block's reductions

  float* c = j.c;
  const float* cin = j.cin;
  if constexpr (BATCHED) {
    c += bz * j.bsc;
    if (CIN) cin += bz * j.bsc;
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + tm + r * TM;
    if (m >= M || (m >= j.sr0 && m < j.sr1)) continue;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int n = n0 + (q / 4) * 4 * TN + 4 * tn + q % 4;
      if (n >= N || (n >= j.sc0 && n < j.sc1)) continue;
      c[(long long)m * j.ldc + n] =
          CIN ? fminf(cin[(long long)m * j.ldcin + n], acc[r][q])
              : acc[r][q];
    }
  }
}

// grid (column tiles, row tiles, matrices)
template <int BM, int BN, int TM, int TN, int NS, bool CIN, bool BATCHED>
__global__ void __launch_bounds__(TM * TN)
minplus_accum_kernel(const JobOf<BATCHED> j) {
  __shared__ __align__(16) AccumSmem<BM, BN, NS> sm;
  accum_tile<BM, BN, TM, TN, NS, CIN, BATCHED>(j, blockIdx.x, blockIdx.y,
                                               blockIdx.z, sm);
}

// Phase 2's two panels in one launch: blocks [0, row_blocks) take the
// row panel (one tile high, M <= RBM), the rest the column panel (one
// tile wide, N <= CBN); blockIdx.z is the matrix.  The two write
// disjoint cells and read only their own cells and the pivot tile,
// which neither writes.
template <int RBM, int RBN, int RTM, int RTN, int CBM, int CBN, int CTM,
          int CTN, bool BATCHED>
__global__ void __launch_bounds__(RTM * RTN)
minplus_panels_kernel(const JobOf<BATCHED> row, const JobOf<BATCHED> col,
                      int row_blocks) {
  static_assert(RTM * RTN == CTM * CTN, "one block size");
  __shared__ __align__(16) union {
    AccumSmem<RBM, RBN, 4> r;
    AccumSmem<CBM, CBN, 4> c;
  } sm;
  if ((int)blockIdx.x < row_blocks)
    accum_tile<RBM, RBN, RTM, RTN, 4, true, BATCHED>(row, blockIdx.x, 0,
                                                     blockIdx.z, sm.r);
  else
    accum_tile<CBM, CBN, CTM, CTN, 4, true, BATCHED>(
        col, 0, blockIdx.x - row_blocks, blockIdx.z, sm.c);
}

// A job over `batch` matrices (batch strides in elements; 0 for one).
static BatchJob make_job(const void* cin, long long ldcin, const void* a,
                         long long lda, const void* b, long long ldb,
                         void* c, long long ldc, int M, int N, int K,
                         int sr0, int sr1, int sc0, int sc1, int batch,
                         long long bsa, long long bsb, long long bsc) {
  const int vec = ((size_t)a % 16 == 0) && ((size_t)b % 16 == 0) &&
                  lda % 4 == 0 && ldb % 4 == 0 && bsa % 4 == 0 &&
                  bsb % 4 == 0 && K % 4 == 0 && N % 4 == 0;
  return BatchJob{{(const float*)cin, ldcin, (const float*)a, lda,
                   (const float*)b, ldb, (float*)c, ldc, M, N, K, sr0, sr1,
                   sc0, sc1, vec},
                  bsa, bsb, bsc, batch};
}

// Matrices [b0, b0 + gridDim.z) of j: its pointers moved to matrix b0
// (the grid's z extent is capped at 65,535).
static BatchJob batch_chunk(BatchJob j, int b0) {
  if (j.cin) j.cin += b0 * j.bsc;
  j.a += b0 * j.bsa;
  j.b += b0 * j.bsb;
  j.c += b0 * j.bsc;
  return j;
}

template <int BM, int BN, int TM, int TN, int NS, bool CIN, bool BATCHED>
static int accum_launch(const BatchJob& j, cudaStream_t s) {
  if ((j.M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < j.batch; b0 += 65535) {
    const int bc = (j.batch - b0 < 65535) ? j.batch - b0 : 65535;
    const dim3 grid((j.N + BN - 1) / BN, (j.M + BM - 1) / BM, bc);
    const BatchJob jc = batch_chunk(j, b0);
    const JobOf<BATCHED>& arg = jc;   // one matrix: the AccumJob part
    minplus_accum_kernel<BM, BN, TM, TN, NS, CIN, BATCHED>
        <<<grid, TM * TN, 0, s>>>(arg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The tile a product of this shape takes: panels get narrow tiles and
// four k-tiles in flight, for blocks enough to cover the card and loads
// enough to cover the latency; anything wider than a panel (phase 3)
// 64 x 64 tiles of 4 x 4 for k-blocks of up to 64, 128 x 64 of 8 x 8
// above (PERF.md).
template <bool CIN, bool BATCHED = false>
static int accum_dispatch(const BatchJob& j, cudaStream_t s) {
  if (j.M <= 64) return accum_launch<64, 8, 32, 2, 4, CIN, BATCHED>(j, s);
  if (j.M <= 128) return accum_launch<128, 8, 64, 2, 4, CIN, BATCHED>(j, s);
  if (j.N <= 64) return accum_launch<8, 64, 2, 16, 4, CIN, BATCHED>(j, s);
  if (j.N <= 128) return accum_launch<8, 128, 2, 32, 4, CIN, BATCHED>(j, s);
  if (j.K <= 64) return accum_launch<64, 64, 16, 16, 4, CIN, BATCHED>(j, s);
  return accum_launch<128, 64, 16, 8, 3, CIN, BATCHED>(j, s);
}

template <int RBM, int RBN, int RTM, int RTN, int CBM, int CBN, int CTM,
          int CTN, bool BATCHED>
static int panels_launch(const BatchJob& row, const BatchJob& col,
                         cudaStream_t s) {
  if (row.M > RBM || col.N > CBN) return (int)cudaErrorInvalidValue;
  const int rb = (row.N + RBN - 1) / RBN;
  const int cb = (col.M + CBM - 1) / CBM;
  if (rb + cb == 0) return (int)cudaSuccess;
  for (int b0 = 0; b0 < row.batch; b0 += 65535) {
    const int bc = (row.batch - b0 < 65535) ? row.batch - b0 : 65535;
    const dim3 grid(rb + cb, 1, bc);
    const BatchJob rc = batch_chunk(row, b0), qc = batch_chunk(col, b0);
    const JobOf<BATCHED>&rarg = rc, &qarg = qc;
    minplus_panels_kernel<RBM, RBN, RTM, RTN, CBM, CBN, CTM, CTN, BATCHED>
        <<<grid, RTM * RTN, 0, s>>>(rarg, qarg, rb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Phase 2's tiles: 64 x 16 and 16 x 64 for k-blocks of up to 64, else
// 128 x 8 and 8 x 128.
template <bool BATCHED>
static int panels_dispatch(const BatchJob& row, const BatchJob& col,
                           cudaStream_t s) {
  if (row.M <= 64 && col.N <= 64)
    return panels_launch<64, 16, 32, 4, 16, 64, 8, 16, BATCHED>(row, col, s);
  return panels_launch<128, 8, 64, 2, 8, 128, 4, 32, BATCHED>(row, col, s);
}

#define MG_THREADS 256  // threads a block
#define MG_SLICES 8     // k-slices of a strip: the blocks of one cluster
#define MG_KC 256       // rows of A a staged chunk
#define MG_U 8          // B rows a thread loads before it computes
#define MG_MAX_M 8      // most rows of A the GEMV route takes

// The 4 columns (strip offsets) of column lane cl in a strip of SW
// columns, for V-wide loads: V = 4 one float4, V = 2 two float2 half a
// strip apart, V = 1 four floats CL apart.  Each load instruction of a
// warp reads whole 32-byte sectors.
template <int SW, int V>
__device__ __forceinline__ int mg_col(int cl, int q) {
  constexpr int CL = SW / 4;
  return V == 4 ? 4 * cl + q
       : V == 2 ? (q >> 1) * (SW / 2) + 2 * cl + (q & 1)
                : cl + CL * q;
}

// Row k's 4 columns of this thread, +inf past N (p: B row k + strip).
template <int SW, int V>
__device__ __forceinline__ void mg_load(const float* p, int cl, int room,
                                        float (&v)[4]) {
  const float inf = __int_as_float(0x7f800000);
  if (V == 4) {
    const int c = mg_col<SW, V>(cl, 0);
    const float4 t = c < room ? __ldg(reinterpret_cast<const float4*>(p + c))
                              : make_float4(inf, inf, inf, inf);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if (V == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = mg_col<SW, V>(cl, 2 * h);
      const float2 t = c < room
          ? __ldg(reinterpret_cast<const float2*>(p + c))
          : make_float2(inf, inf);
      v[2 * h] = t.x; v[2 * h + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = mg_col<SW, V>(cl, q);
      v[q] = c < room ? __ldg(p + c) : inf;
    }
  }
}

// A[:, kc : kc + MG_KC] -> as[k][m] by cp.async, +inf past M and k1
template <int MT>
__device__ __forceinline__ void mg_stage(float (*as)[MT], const float* a,
                                         int M, int K, int kc, int k1) {
  const float inf = __int_as_float(0x7f800000);
  for (int e = threadIdx.x; e < MG_KC * MT; e += MG_THREADS) {
    const int r = e / MT, m = e % MT, k = kc + r;
    if (m < M && k < k1)
      cp_async4(&as[r][m], a + (long long)m * K + k);
    else
      as[r][m] = inf;
  }
}

template <int MT, int SW>
union MgSmem {
  float as[2][MG_KC][MT];                     // A chunks, [k][m]
  float part[MG_THREADS / 32][MT][SW];        // a warp's minima
};

// Grid (strips, MG_SLICES), clusters of MG_SLICES blocks along y: block
// (x, y) takes columns [x SW, x SW + SW) and k-slice y.  MT >= M: rows
// of A (past M: +inf, never written).  V: load width (see mg_col).
template <int MT, int SW, int V>
__global__ void __cluster_dims__(1, MG_SLICES, 1) __launch_bounds__(MG_THREADS)
minplus_gemv_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K) {
  constexpr int CL = SW / 4;                  // column lanes
  constexpr int RL = MG_THREADS / CL;         // row lanes
  __shared__ __align__(16) MgSmem<MT, SW> sm;
  const float inf = __int_as_float(0x7f800000);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = threadIdx.x % CL, rl = threadIdx.x / CL;
  const int c0 = blockIdx.x * SW;
  const int room = N - c0;                    // columns left from c0
  const int ks = (K + MG_SLICES - 1) / MG_SLICES;
  const int k0 = min(K, (int)blockIdx.y * ks), k1 = min(K, k0 + ks);
  const int nch = (k1 - k0 + MG_KC - 1) / MG_KC;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = inf;

  if (nch > 0) mg_stage<MT>(sm.as[0], a, M, K, k0, k1);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int kc = k0 + ch * MG_KC;
    const int nr = min(MG_KC, k1 - kc);
    const float* bp = b + (long long)kc * N + c0;
    // this chunk's first B rows go out before the wait on A
    float bv[MG_U][4];
#pragma unroll
    for (int u = 0; u < MG_U; ++u) {
      const int r = rl + u * RL;
      if (r < nr) {
        mg_load<SW, V>(bp + (long long)r * N, cl, room, bv[u]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[u][q] = inf;
      }
    }
    // the other buffer was last read in chunk ch - 1, closed by a barrier
    if (ch + 1 < nch)
      mg_stage<MT>(sm.as[(ch + 1) & 1], a, M, K, kc + MG_KC, k1);
    cp_async_commit();
    cp_async_wait_prev();                     // chunk ch's A landed
    __syncthreads();
    const float (*as)[MT] = sm.as[ch & 1];
    for (int r0 = rl;; r0 += MG_U * RL) {
#pragma unroll
      for (int u = 0; u < MG_U; ++u) {
        const int r = r0 + u * RL;
        if (r < nr) {
          float av[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) av[m] = as[r][m];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[m][q] = fminf(acc[m][q], av[m] + bv[u][q]);
        }
      }
      const int next = r0 + MG_U * RL;
      if (next >= nr) break;                  // uniform per row lane
#pragma unroll
      for (int u = 0; u < MG_U; ++u) {
        const int r = next + u * RL;
        if (r < nr) {
          mg_load<SW, V>(bp + (long long)r * N, cl, room, bv[u]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[u][q] = inf;
        }
      }
    }
    __syncthreads();                          // as[ch & 1] free
  }
  cp_async_wait_all();

  // fold the row lanes of a warp (lanes CL apart share columns)
#pragma unroll
  for (int o = CL; o < 32; o *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[m][q] = fminf(acc[m][q],
                          __shfl_xor_sync(0xffffffffu, acc[m][q], o));
  const int w = threadIdx.x / 32;
  if ((threadIdx.x % 32) < CL) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sm.part[w][m][mg_col<SW, V>(cl, q)] = acc[m][q];
  }
  __syncthreads();
  // then the warps: the block's minima land in part[0]
  for (int e = threadIdx.x; e < MT * SW; e += MG_THREADS) {
    float v = sm.part[0][e / SW][e % SW];
#pragma unroll
    for (int x = 1; x < MG_THREADS / 32; ++x)
      v = fminf(v, sm.part[x][e / SW][e % SW]);
    sm.part[0][e / SW][e % SW] = v;
  }
  // then the cluster's k-slices, read by rank 0 from each block's
  // shared memory; the second sync keeps every block resident until then
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int nb = (int)cluster.num_blocks();
    for (int e = threadIdx.x; e < MT * SW; e += MG_THREADS) {
      const int m = e / SW, x = e % SW;
      if (m >= M || x >= room) continue;
      float v = inf;
      for (int r = 0; r < nb; ++r)
        v = fminf(v, cluster.map_shared_rank(&sm.part[0][0][0], r)[e]);
      c[(long long)m * N + c0 + x] = v;
    }
  }
  cluster.sync();
}

template <int MT, int SW>
static int gemv_launch(const float* a, const float* b, float* c, int M,
                       int N, int K, cudaStream_t s) {
  const dim3 grid((N + SW - 1) / SW, MG_SLICES);
  const bool v4 = N % 4 == 0 && (size_t)b % 16 == 0;
  const bool v2 = N % 2 == 0 && (size_t)b % 8 == 0;
  if (v4)
    minplus_gemv_kernel<MT, SW, 4><<<grid, MG_THREADS, 0, s>>>(a, b, c, M,
                                                               N, K);
  else if (v2)
    minplus_gemv_kernel<MT, SW, 2><<<grid, MG_THREADS, 0, s>>>(a, b, c, M,
                                                               N, K);
  else
    minplus_gemv_kernel<MT, SW, 1><<<grid, MG_THREADS, 0, s>>>(a, b, c, M,
                                                               N, K);
  return (int)cudaGetLastError();
}

// one-to-all's single row, or up to MG_MAX_M rows in one shape
template <int SW>
static int gemv_rows(const float* a, const float* b, float* c, int M, int N,
                     int K, cudaStream_t s) {
  if (M == 1) return gemv_launch<1, SW>(a, b, c, M, N, K, s);
  return gemv_launch<MG_MAX_M, SW>(a, b, c, M, N, K, s);
}

extern "C" {

// a f32 [M, K], b f32 [K, N] (contiguous) -> c f32 [M, N] = a (x) b,
// M <= MG_MAX_M, in strips of sw (32 or 128) columns.
int minplus_gemv(const void* a, const void* b, void* c, int M, int N, int K,
                 int sw, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (M > MG_MAX_M) return (int)cudaErrorInvalidValue;
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  const cudaStream_t s = (cudaStream_t)stream;
  if (sw == 32) return gemv_rows<32>(fa, fb, (float*)c, M, N, K, s);
  if (sw == 128) return gemv_rows<128>(fa, fb, (float*)c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

// The same product, any M, through the accumulate tiles with no C_in.
int minplus_tiles(const void* a, const void* b, void* c, int M, int N,
                  int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const BatchJob j = make_job(nullptr, 0, a, K, b, N, c, N, M, N, K, 0, 0,
                              0, 0, 1, 0, 0, 0);
  return accum_dispatch<false>(j, (cudaStream_t)stream);
}

// c[i, j] = min(cin[i, j], (a (x) b)[i, j]) for i < M, j < N, but for
// rows in [sr0, sr1) and columns in [sc0, sc1), which are left as they
// are, in each of `batch` matrices.  Row-major views with leading
// dimensions ldcin, lda, ldb, ldc and batch strides bsa, bsb, bsc
// (elements; cin's is c's).  c may alias cin (same view), and a and b
// only where every cell of them lies in a skipped row or column of c's
// own matrix (phase 3; the note at the top).  Phase 2's aliased panels go through
// minplus_accum_panels, whose tiles always span their panel.
int minplus_accum_ld(const void* cin, long long ldcin, const void* a,
                     long long lda, const void* b, long long ldb, void* c,
                     long long ldc, int M, int N, int K, int sr0, int sr1,
                     int sc0, int sc1, int batch, long long bsa,
                     long long bsb, long long bsc, void* stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return (int)cudaSuccess;
  const BatchJob j = make_job(cin, ldcin, a, lda, b, ldb, c, ldc, M, N, K,
                              sr0, sr1, sc0, sc1, batch, bsa, bsb, bsc);
  const cudaStream_t s = (cudaStream_t)stream;
  return batch > 1 ? accum_dispatch<true, true>(j, s)
                   : accum_dispatch<true, false>(j, s);
}

// Both panels of phase 2 in one launch, each with minplus_accum_ld's
// arguments, over the same `batch` matrices: the row panel (r*, rM <=
// 128 rows; c may be the same window as b) and the column panel (q*,
// qN <= 128 columns; c may be the same window as a).  Other operands
// may alias c only in its skipped cells.  The two must write disjoint
// cells, neither writing what the other reads.
int minplus_accum_panels(const void* rc, long long ldrc, const void* ra,
                         long long ldra, const void* rb, long long ldrb,
                         int rM, int rN, int rK, int rsc0, int rsc1,
                         long long rbsc, long long rbsa, long long rbsb,
                         const void* qc, long long ldqc, const void* qa,
                         long long ldqa, const void* qb, long long ldqb,
                         int qM, int qN, int qK, int qsr0, int qsr1,
                         long long qbsc, long long qbsa, long long qbsb,
                         int batch, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const BatchJob row = make_job(rc, ldrc, ra, ldra, rb, ldrb, (void*)rc,
                                ldrc, rM > 0 ? rM : 0, rM > 0 ? rN : 0, rK,
                                0, 0, rsc0, rsc1, batch, rbsa, rbsb, rbsc);
  const BatchJob col = make_job(qc, ldqc, qa, ldqa, qb, ldqb, (void*)qc,
                                ldqc, qN > 0 ? qM : 0, qN > 0 ? qN : 0, qK,
                                qsr0, qsr1, 0, 0, batch, qbsa, qbsb, qbsc);
  const cudaStream_t s = (cudaStream_t)stream;
  return batch > 1 ? panels_dispatch<true>(row, col, s)
                   : panels_dispatch<false>(row, col, s);
}

// cin f32 [M, N], a f32 [M, K], b f32 [K, N] (contiguous) -> c =
// min(cin, a (x) b), c a fresh matrix.
int minplus_accum(const void* cin, const void* a, const void* b, void* c,
                  int M, int N, int K, void* stream) {
  return minplus_accum_ld(cin, N, a, K, b, N, c, N, M, N, K, 0, 0, 0, 0, 1,
                          0, 0, 0, stream);
}

}  // extern "C"
