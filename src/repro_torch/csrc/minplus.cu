// Tropical (min,+) matrix product for Hopper (sm_90a), with and
// without accumulation into an existing matrix.
//
// Replaces the Pallas kernels repro/kernels/minplus.py:
//   minplus_pallas (_minplus_kernel):              C = A (x) B
//   minplus_accum_pallas (_minplus_accum_kernel):  C = min(C_in, A (x) B)
// with (A (x) B)[i, j] = min_k A[i, k] + B[k, j], A [M, K], B [K, N],
// C_in and C [M, N], all float32 row-major with +inf absorbing.  The
// blocked Floyd-Warshall of the hierarchy's top closure runs its phases
// 2 and 3 through minplus_accum; one-to-all serving runs minplus as a
// vector x matrix product against the top (or dense) closure.
//
// Each block owns a 64 x 64 tile of C.  It walks k through
// shared-memory tiles of A (stored transposed) and B, keeps a 4 x 4
// micro-tile of accumulators per thread in registers, and masks ragged
// edges in the loads: out-of-range cells read as +inf, out-of-range
// outputs are not stored.  Nothing is padded by copies.  The Pallas
// version carries its accumulator across a sequential k grid axis; here
// a loop inside the block takes that axis, so blocks share nothing and
// run in any order.
//
// C is never C_in: the blocked FW's phase 2 passes one array as both
// C_in and B (repro/kernels/floyd_warshall.py:137), so an in-place
// kernel would read B tiles another block had already overwritten.  The
// wrapper always allocates C.
//
// Bound on this card: 2 operations per (i, k, j) triple (add, min) in
// float32 outside the tensor cores ((min,+) has no tensor-core form),
// against 4 bytes per element of A, B, C_in and C: the blocked FW's
// phase 3 (M = N = 1792, K = 128) is bound by operations; the m = 1
// vector x matrix shape is bound by the bytes of B, and this tile
// leaves 63 of its 64 rows idle there (a GEMV-shaped variant is later
// work).
//
// Exact: integer-valued inputs keep every sum below 2**24, so any
// association order gives the reference's bits.  Built without
// --use_fast_math.

#include <cuda_runtime.h>

#define MP_BM 64      // rows of C per block
#define MP_BN 64      // columns of C per block
#define MP_BK 32      // k depth per shared-memory tile
#define MP_TM 16      // threads along m
#define MP_TN 16      // threads along n
#define MP_RM (MP_BM / MP_TM)
#define MP_RN (MP_BN / MP_TN)

template <bool ACCUM>
__global__ void __launch_bounds__(MP_TM * MP_TN)
minplus_kernel(const float* __restrict__ cin, const float* __restrict__ a,
               const float* __restrict__ b, float* __restrict__ c,
               int M, int N, int K) {
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
      const size_t o = (size_t)m * N + n;
      c[o] = ACCUM ? fminf(cin[o], acc[r][q]) : acc[r][q];
    }
  }
}

static int launch(const float* cin, const float* a, const float* b,
                  float* c, int M, int N, int K, void* stream,
                  bool accum) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if ((M + MP_BM - 1) / MP_BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + MP_BN - 1) / MP_BN, (M + MP_BM - 1) / MP_BM);
  const cudaStream_t s = (cudaStream_t)stream;
  if (accum)
    minplus_kernel<true><<<grid, MP_TM * MP_TN, 0, s>>>(cin, a, b, c, M,
                                                        N, K);
  else
    minplus_kernel<false><<<grid, MP_TM * MP_TN, 0, s>>>(cin, a, b, c, M,
                                                         N, K);
  return (int)cudaGetLastError();
}

extern "C" {

// a f32 [M, K], b f32 [K, N] -> c f32 [M, N] = a (x) b.
int minplus(const void* a, const void* b, void* c, int M, int N, int K,
            void* stream) {
  return launch(nullptr, (const float*)a, (const float*)b, (float*)c, M, N,
                K, stream, false);
}

// cin f32 [M, N], a f32 [M, K], b f32 [K, N] -> c = min(cin, a (x) b);
// c must not overlap cin, a or b.
int minplus_accum(const void* cin, const void* a, const void* b, void* c,
                  int M, int N, int K, void* stream) {
  return launch((const float*)cin, (const float*)a, (const float*)b,
                (float*)c, M, N, K, stream, true);
}

}  // extern "C"
