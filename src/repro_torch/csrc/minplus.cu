// Tropical (min,+) matrix product for Hopper (sm_90a), with and
// without accumulation into an existing matrix.
//
// Replaces the Pallas kernels repro/kernels/minplus.py:
//   minplus_pallas (_minplus_kernel):              C = A (x) B
//   minplus_accum_pallas (_minplus_accum_kernel):  C = min(C_in, A (x) B)
// with (A (x) B)[i, j] = min_k A[i, k] + B[k, j], A [M, K], B [K, N],
// C_in and C [M, N], all float32 with +inf absorbing.  The blocked
// Floyd-Warshall of the hierarchy's top closure runs its phases 2 and 3
// through the in-place entries minplus_accum_panels and
// minplus_accum_ld (minplus_accum keeps the fresh-output contract);
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
// minplus (minplus_kernel, kernel 5) keeps the first port's tiling: 64
// x 64 tiles of C, a 4 x 4 micro-tile, synchronous shared-memory
// loads; the m = 1 vector x matrix shape leaves 63 of its 64 rows idle
// (a GEMV-shaped variant is later work).
//
// Exact: integer-valued inputs keep every sum below 2**24, so any
// association order gives the reference's bits.  Built without
// --use_fast_math.

#include <cuda_runtime.h>

#include "twoside_tiles.cuh"   // cp_async4 and the commit / wait helpers

#define MP_BM 64      // rows of C per block
#define MP_BN 64      // columns of C per block
#define MP_BK 32      // k depth per shared-memory tile
#define MP_TM 16      // threads along m
#define MP_TN 16      // threads along n
#define MP_RM (MP_BM / MP_TM)
#define MP_RN (MP_BN / MP_TN)

__global__ void __launch_bounds__(MP_TM * MP_TN)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int M, int N, int K) {
  // A tile, transposed; the +1 keeps the transposing store free of
  // bank conflicts
  __shared__ float as[MP_BK][MP_BM + 1];
  __shared__ float bs[MP_BK][MP_BN];
  const int tn = threadIdx.x % MP_TN;
  const int tm = threadIdx.x / MP_TN;
  const int m0 = blockIdx.y * MP_BM;
  const int n0 = blockIdx.x * MP_BN;
  const float inf = __int_as_float(0x7f800000);

  float acc[MP_RM][MP_RN];
#pragma unroll
  for (int r = 0; r < MP_RM; ++r)
#pragma unroll
    for (int q = 0; q < MP_RN; ++q) acc[r][q] = inf;

  for (int k0 = 0; k0 < K; k0 += MP_BK) {
    // A[m0:m0+BM, k0:k0+BK] -> as[k][m]; consecutive threads read
    // consecutive k of one row
    for (int e = threadIdx.x; e < MP_BM * MP_BK; e += blockDim.x) {
      const int mm = e / MP_BK, kk = e % MP_BK;
      const int m = m0 + mm, k = k0 + kk;
      as[kk][mm] = (m < M && k < K) ? a[(size_t)m * K + k] : inf;
    }
    // B[k0:k0+BK, n0:n0+BN] -> bs[k][n]
    for (int e = threadIdx.x; e < MP_BK * MP_BN; e += blockDim.x) {
      const int kk = e / MP_BN, nn = e % MP_BN;
      const int k = k0 + kk, n = n0 + nn;
      bs[kk][nn] = (k < K && n < N) ? b[(size_t)k * N + n] : inf;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < MP_BK; ++kk) {
      float av[MP_RM], bv[MP_RN];
#pragma unroll
      for (int r = 0; r < MP_RM; ++r) av[r] = as[kk][tm + r * MP_TM];
#pragma unroll
      for (int q = 0; q < MP_RN; ++q) bv[q] = bs[kk][tn + q * MP_TN];
#pragma unroll
      for (int r = 0; r < MP_RM; ++r)
#pragma unroll
        for (int q = 0; q < MP_RN; ++q)
          acc[r][q] = fminf(acc[r][q], av[r] + bv[q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MP_RM; ++r) {
    const int m = m0 + tm + r * MP_TM;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < MP_RN; ++q) {
      const int n = n0 + tn + q * MP_TN;
      if (n >= N) continue;
      c[(size_t)m * N + n] = acc[r][q];
    }
  }
}

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
// ldb, K and N all allow 16-byte copies.
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

template <int BM, int BN, int NS>
struct AccumSmem {
  float as[NS][BM][MA_AS];
  float bs[NS][MA_BK][BN];
};

// Tile (bx, by) of job j: BM x BN cells of C.  Thread (tm, tn) owns rows
// tm + r * TM and columns g * 4 * TN + 4 * tn + q.  NS k-tiles are in
// flight (NS - 1 staged ahead of the one computed).  No __restrict__: C
// may alias C_in, A and B (see the note at the top).
template <int BM, int BN, int TM, int TN, int NS>
__device__ __forceinline__ void accum_tile(const AccumJob& j, int bx,
                                           int by,
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
    __syncthreads();
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

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + tm + r * TM;
    if (m >= M || (m >= j.sr0 && m < j.sr1)) continue;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int n = n0 + (q / 4) * 4 * TN + 4 * tn + q % 4;
      if (n >= N || (n >= j.sc0 && n < j.sc1)) continue;
      j.c[(long long)m * j.ldc + n] =
          fminf(j.cin[(long long)m * j.ldcin + n], acc[r][q]);
    }
  }
}

template <int BM, int BN, int TM, int TN, int NS>
__global__ void __launch_bounds__(TM * TN)
minplus_accum_kernel(const AccumJob j) {
  __shared__ __align__(16) AccumSmem<BM, BN, NS> sm;
  accum_tile<BM, BN, TM, TN, NS>(j, blockIdx.x, blockIdx.y, sm);
}

// Phase 2's two panels in one launch: blocks [0, row_blocks) take the
// row panel (one tile high, M <= RBM), the rest the column panel (one
// tile wide, N <= CBN).  The two write disjoint cells and read only
// their own cells and the pivot tile, which neither writes.
template <int RBM, int RBN, int RTM, int RTN, int CBM, int CBN, int CTM,
          int CTN>
__global__ void __launch_bounds__(RTM * RTN)
minplus_panels_kernel(const AccumJob row, const AccumJob col,
                      int row_blocks) {
  static_assert(RTM * RTN == CTM * CTN, "one block size");
  __shared__ __align__(16) union {
    AccumSmem<RBM, RBN, 4> r;
    AccumSmem<CBM, CBN, 4> c;
  } sm;
  if ((int)blockIdx.x < row_blocks)
    accum_tile<RBM, RBN, RTM, RTN, 4>(row, blockIdx.x, 0, sm.r);
  else
    accum_tile<CBM, CBN, CTM, CTN, 4>(col, 0, blockIdx.x - row_blocks,
                                      sm.c);
}

static AccumJob make_job(const void* cin, long long ldcin, const void* a,
                         long long lda, const void* b, long long ldb,
                         void* c, long long ldc, int M, int N, int K,
                         int sr0, int sr1, int sc0, int sc1) {
  const int vec = ((size_t)a % 16 == 0) && ((size_t)b % 16 == 0) &&
                  lda % 4 == 0 && ldb % 4 == 0 && K % 4 == 0 && N % 4 == 0;
  return AccumJob{(const float*)cin, ldcin, (const float*)a, lda,
                  (const float*)b, ldb, (float*)c, ldc, M, N, K, sr0, sr1,
                  sc0, sc1, vec};
}

template <int BM, int BN, int TM, int TN, int NS>
static int accum_launch(const AccumJob& j, cudaStream_t s) {
  if ((j.M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((j.N + BN - 1) / BN, (j.M + BM - 1) / BM);
  minplus_accum_kernel<BM, BN, TM, TN, NS><<<grid, TM * TN, 0, s>>>(j);
  return (int)cudaGetLastError();
}

template <int RBM, int RBN, int RTM, int RTN, int CBM, int CBN, int CTM,
          int CTN>
static int panels_launch(const AccumJob& row, const AccumJob& col,
                         cudaStream_t s) {
  if (row.M > RBM || col.N > CBN) return (int)cudaErrorInvalidValue;
  const int rb = (row.N + RBN - 1) / RBN;
  const int cb = (col.M + CBM - 1) / CBM;
  if (rb + cb == 0) return (int)cudaSuccess;
  minplus_panels_kernel<RBM, RBN, RTM, RTN, CBM, CBN, CTM, CTN>
      <<<rb + cb, RTM * RTN, 0, s>>>(row, col, rb);
  return (int)cudaGetLastError();
}

extern "C" {

// a f32 [M, K], b f32 [K, N] -> c f32 [M, N] = a (x) b.
int minplus(const void* a, const void* b, void* c, int M, int N, int K,
            void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if ((M + MP_BM - 1) / MP_BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + MP_BN - 1) / MP_BN, (M + MP_BM - 1) / MP_BM);
  minplus_kernel<<<grid, MP_TM * MP_TN, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}

// c[i, j] = min(cin[i, j], (a (x) b)[i, j]) for i < M, j < N, but for
// rows in [sr0, sr1) and columns in [sc0, sc1), which are left as they
// are.  Row-major views with leading dimensions (elements) ldcin, lda,
// ldb, ldc.  c may alias cin (same view), and a and b only where every
// cell of them lies in a skipped row or column of c (phase 3; the note
// at the top).  Phase 2's aliased panels go through
// minplus_accum_panels, whose tiles always span their panel.
int minplus_accum_ld(const void* cin, long long ldcin, const void* a,
                     long long lda, const void* b, long long ldb, void* c,
                     long long ldc, int M, int N, int K, int sr0, int sr1,
                     int sc0, int sc1, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const AccumJob j = make_job(cin, ldcin, a, lda, b, ldb, c, ldc, M, N, K,
                              sr0, sr1, sc0, sc1);
  const cudaStream_t s = (cudaStream_t)stream;
  // panels: narrow tiles and four k-tiles in flight, for blocks enough
  // to cover the card and loads enough to cover the latency
  if (M <= 64) return accum_launch<64, 8, 32, 2, 4>(j, s);
  if (M <= 128) return accum_launch<128, 8, 64, 2, 4>(j, s);
  if (N <= 64) return accum_launch<8, 64, 2, 16, 4>(j, s);
  if (N <= 128) return accum_launch<8, 128, 2, 32, 4>(j, s);
  // anything wider than a panel (phase 3): 64 x 64 tiles of 4 x 4 for
  // k-blocks of up to 64, 128 x 64 of 8 x 8 above (PERF.md)
  if (K <= 64) return accum_launch<64, 64, 16, 16, 4>(j, s);
  return accum_launch<128, 64, 16, 8, 3>(j, s);
}

// Both panels of phase 2 in one launch, each with minplus_accum_ld's
// arguments: the row panel (r*, rM <= 128 rows; c may be the same
// window as b) and the column panel (q*, qN <= 128 columns; c may be
// the same window as a).  Other operands may alias c only in its
// skipped cells.  The two must write disjoint cells, neither writing
// what the other reads.
int minplus_accum_panels(const void* rc, long long ldrc, const void* ra,
                         long long ldra, const void* rb, long long ldrb,
                         int rM, int rN, int rK, int rsc0, int rsc1,
                         const void* qc, long long ldqc, const void* qa,
                         long long ldqa, const void* qb, long long ldqb,
                         int qM, int qN, int qK, int qsr0, int qsr1,
                         void* stream) {
  const AccumJob row = make_job(rc, ldrc, ra, ldra, rb, ldrb, (void*)rc,
                                ldrc, rM > 0 ? rM : 0, rM > 0 ? rN : 0, rK,
                                0, 0, rsc0, rsc1);
  const AccumJob col = make_job(qc, ldqc, qa, ldqa, qb, ldqb, (void*)qc,
                                ldqc, qN > 0 ? qM : 0, qN > 0 ? qN : 0, qK,
                                qsr0, qsr1, 0, 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (row.M <= 64 && col.N <= 64)
    return panels_launch<64, 16, 32, 4, 16, 64, 8, 16>(row, col, s);
  return panels_launch<128, 8, 64, 2, 8, 128, 4, 32>(row, col, s);
}

// cin f32 [M, N], a f32 [M, K], b f32 [K, N] (contiguous) -> c =
// min(cin, a (x) b), c a fresh matrix.
int minplus_accum(const void* cin, const void* a, const void* b, void* c,
                  int M, int N, int K, void* stream) {
  return minplus_accum_ld(cin, N, a, K, b, N, c, N, M, N, K, 0, 0, 0, 0,
                          stream);
}

}  // extern "C"
