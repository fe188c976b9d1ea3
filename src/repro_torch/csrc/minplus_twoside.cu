// Fused two-sided tropical contraction for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/minplus_twoside.py:
// minplus_twoside_pallas (_twoside_kernel), the cross-fragment combine
// of the serve path:
//   out[q] = min_{x, y} rows[q, x] + d[x, y] + rowt[q, y]
// with rows [Q, K1], d [K1, K2], rowt [Q, K2] (float32, +inf absorbing),
// never forming the [Q, K1, K2] cube.
//
// Each block owns a (q-tile, y-tile) of the output.  It walks x through
// shared-memory tiles of rows and d, keeps acc[q, y] = min_x rows + d in
// registers (a 4 x 4 micro-tile per thread), adds rowt, min-reduces over
// its y-tile, and writes one partial per (q, y-tile).  The caller
// finishes with a min over the partials (as the Pallas version leaves
// its final cross-lane min outside the kernel), so the result does not
// depend on the launch order.  Ragged edges are masked in the loads:
// out-of-range cells read as +inf, out-of-range queries are not stored.
//
// Bound on this card: 2 operations per (q, x, y) triple (add, min) in
// float32 outside the tensor cores ((min,+) has no tensor-core form),
// against 4 bytes per element of the three inputs: bound by operations
// for every shape of the serve path.  The micro-tile gives 16 add+min
// pairs per 8 shared-memory loads.
//
// Exact: integer-valued inputs keep every sum below 2**24, so any
// association order gives the reference's bits.  Built without
// --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#define TS_BQ 64      // queries per block
#define TS_BY 64      // y columns per block
#define TS_BX 32      // x depth per shared-memory tile
#define TS_TQ 16      // threads along q
#define TS_TY 16      // threads along y
#define TS_MQ (TS_BQ / TS_TQ)
#define TS_MY (TS_BY / TS_TY)

__global__ void __launch_bounds__(TS_TQ * TS_TY)
twoside_kernel(const float* __restrict__ rows, const float* __restrict__ d,
               const float* __restrict__ rowt, float* __restrict__ part,
               int Q, int K1, int K2) {
  // rows tile, transposed; the +1 keeps the transposing store free of
  // bank conflicts
  __shared__ float rs[TS_BX][TS_BQ + 1];
  __shared__ float dsm[TS_BX][TS_BY];  // d tile
  const int ty = threadIdx.x % TS_TY;  // y lane
  const int tq = threadIdx.x / TS_TY;  // q lane
  const int q0 = blockIdx.y * TS_BQ;
  const int y0 = blockIdx.x * TS_BY;
  const float inf = __int_as_float(0x7f800000);

  float acc[TS_MQ][TS_MY];
#pragma unroll
  for (int a = 0; a < TS_MQ; ++a)
#pragma unroll
    for (int b = 0; b < TS_MY; ++b) acc[a][b] = inf;

  for (int x0 = 0; x0 < K1; x0 += TS_BX) {
    // rows[q0:q0+BQ, x0:x0+BX] -> rs[x][q]; 256 threads, 2048 cells
    for (int c = threadIdx.x; c < TS_BQ * TS_BX; c += blockDim.x) {
      const int qq = c / TS_BX, xx = c % TS_BX;
      const int q = q0 + qq, x = x0 + xx;
      rs[xx][qq] = (q < Q && x < K1) ? rows[(size_t)q * K1 + x] : inf;
    }
    // d[x0:x0+BX, y0:y0+BY] -> dsm[x][y]
    for (int c = threadIdx.x; c < TS_BX * TS_BY; c += blockDim.x) {
      const int xx = c / TS_BY, yy = c % TS_BY;
      const int x = x0 + xx, y = y0 + yy;
      dsm[xx][yy] = (x < K1 && y < K2) ? d[(size_t)x * K2 + y] : inf;
    }
    __syncthreads();
#pragma unroll 4
    for (int xx = 0; xx < TS_BX; ++xx) {
      float rv[TS_MQ], dv[TS_MY];
#pragma unroll
      for (int a = 0; a < TS_MQ; ++a) rv[a] = rs[xx][tq + a * TS_TQ];
#pragma unroll
      for (int b = 0; b < TS_MY; ++b) dv[b] = dsm[xx][ty + b * TS_TY];
#pragma unroll
      for (int a = 0; a < TS_MQ; ++a)
#pragma unroll
        for (int b = 0; b < TS_MY; ++b)
          acc[a][b] = fminf(acc[a][b], rv[a] + dv[b]);
    }
    __syncthreads();
  }

  // + rowt, then min over this block's y-tile: per thread over its
  // micro-tile columns, then across the TS_TY lanes sharing a q lane
  // (16 consecutive lanes of one warp).
#pragma unroll
  for (int a = 0; a < TS_MQ; ++a) {
    const int q = q0 + tq + a * TS_TQ;
    float m = inf;
#pragma unroll
    for (int b = 0; b < TS_MY; ++b) {
      const int y = y0 + ty + b * TS_TY;
      if (q < Q && y < K2) m = fminf(m, acc[a][b] + rowt[(size_t)q * K2 + y]);
    }
#pragma unroll
    for (int off = TS_TY / 2; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (ty == 0 && q < Q) part[(size_t)q * gridDim.x + blockIdx.x] = m;
  }
}

extern "C" {

int twoside_y_tile() { return TS_BY; }

// rows f32 [Q, K1], d f32 [K1, K2], rowt f32 [Q, K2] ->
// part f32 [Q, ceil(K2 / TS_BY)]; out[q] = min over part[q, :].
int minplus_twoside(const void* rows, const void* d, const void* rowt,
                    void* part, int Q, int K1, int K2, void* stream) {
  if (Q <= 0 || K2 <= 0) return (int)cudaSuccess;
  const dim3 grid((K2 + TS_BY - 1) / TS_BY, (Q + TS_BQ - 1) / TS_BQ);
  twoside_kernel<<<grid, TS_TQ * TS_TY, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)d, (const float*)rowt,
      (float*)part, Q, K1, K2);
  return (int)cudaGetLastError();
}

}  // extern "C"
