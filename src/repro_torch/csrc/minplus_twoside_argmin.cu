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
// Tiling as minplus_twoside.cu: each block owns a (64-query, 64-y) tile,
// walks x through 32-deep shared-memory tiles of rows and d, and keeps a
// 4 x 4 register micro-tile of acc[q, y] = min_x rows + d per thread.
// Beside each acc sits accx, the x that set it; x ascends and only a
// strict < replaces, so accx is the smallest x at the minimum.  After
// adding rowt the block reduces its y-tile on (value, y): per thread
// over its columns (ascending y, strict <), then across the 16 lanes
// that share a q lane with a shuffle that carries (value, y, x) and
// prefers the smaller y on equal values.  It writes one partial value
// and one packed witness y * K1 + x (int64) per (q, y-tile).  The
// caller takes out = min over the partials and, among the partials
// equal to out, the smallest packed witness: y-tiles are disjoint y
// ranges, so that is the smallest y, then its x.
//
// Bound on this card: as minplus_twoside.cu, 2 float32 operations per
// finite (q, x, y) triple outside the tensor cores, bound by operations
// at the serve path's shapes.  The witness costs one compare-select of
// an int per cell next to the min; 16 int witnesses beside the 16 float
// accumulators raise the register count (-Xptxas=-v reports it).
//
// Exact: integer-valued inputs keep every sum below 2**24, so the
// values and the equalities the tie rule compares are the plain
// version's bits.  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#define TA_BQ 64      // queries per block
#define TA_BY 64      // y columns per block
#define TA_BX 32      // x depth per shared-memory tile
#define TA_TQ 16      // threads along q
#define TA_TY 16      // threads along y
#define TA_MQ (TA_BQ / TA_TQ)
#define TA_MY (TA_BY / TA_TY)

__global__ void __launch_bounds__(TA_TQ * TA_TY)
twoside_argmin_kernel(const float* __restrict__ rows,
                      const float* __restrict__ d,
                      const float* __restrict__ rowt,
                      float* __restrict__ part,
                      long long* __restrict__ pwit,
                      int Q, int K1, int K2) {
  __shared__ float rs[TA_BX][TA_BQ + 1];   // rows tile, transposed
  __shared__ float dsm[TA_BX][TA_BY];      // d tile
  const int ty = threadIdx.x % TA_TY;      // y lane
  const int tq = threadIdx.x / TA_TY;      // q lane
  const int q0 = blockIdx.y * TA_BQ;
  const int y0 = blockIdx.x * TA_BY;
  const float inf = __int_as_float(0x7f800000);

  float acc[TA_MQ][TA_MY];
  int accx[TA_MQ][TA_MY];
#pragma unroll
  for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) {
      acc[a][b] = inf;
      accx[a][b] = -1;
    }

  for (int x0 = 0; x0 < K1; x0 += TA_BX) {
    for (int c = threadIdx.x; c < TA_BQ * TA_BX; c += blockDim.x) {
      const int qq = c / TA_BX, xx = c % TA_BX;
      const int q = q0 + qq, x = x0 + xx;
      rs[xx][qq] = (q < Q && x < K1) ? rows[(size_t)q * K1 + x] : inf;
    }
    for (int c = threadIdx.x; c < TA_BX * TA_BY; c += blockDim.x) {
      const int xx = c / TA_BY, yy = c % TA_BY;
      const int x = x0 + xx, y = y0 + yy;
      dsm[xx][yy] = (x < K1 && y < K2) ? d[(size_t)x * K2 + y] : inf;
    }
    __syncthreads();
#pragma unroll 4
    for (int xx = 0; xx < TA_BX; ++xx) {
      float rv[TA_MQ], dv[TA_MY];
#pragma unroll
      for (int a = 0; a < TA_MQ; ++a) rv[a] = rs[xx][tq + a * TA_TQ];
#pragma unroll
      for (int b = 0; b < TA_MY; ++b) dv[b] = dsm[xx][ty + b * TA_TY];
      const int x = x0 + xx;
#pragma unroll
      for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
        for (int b = 0; b < TA_MY; ++b) {
          const float v = rv[a] + dv[b];
          const bool better = v < acc[a][b];    // strict: smallest x
          acc[a][b] = better ? v : acc[a][b];
          accx[a][b] = better ? x : accx[a][b];
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TA_MQ; ++a) {
    const int q = q0 + tq + a * TA_TQ;
    float m = inf;
    int my = 0x7fffffff, mx = -1;
    // this thread's columns, ascending y: strict < keeps the smallest y
#pragma unroll
    for (int b = 0; b < TA_MY; ++b) {
      const int y = y0 + ty + b * TA_TY;
      if (q < Q && y < K2) {
        const float v = acc[a][b] + rowt[(size_t)q * K2 + y];
        if (v < m || (v == m && y < my)) {
          m = v;
          my = y;
          mx = accx[a][b];
        }
      }
    }
    // across the TA_TY lanes sharing this q lane: (value, y) order
#pragma unroll
    for (int off = TA_TY / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const int oy = __shfl_xor_sync(0xffffffffu, my, off);
      const int ox = __shfl_xor_sync(0xffffffffu, mx, off);
      if (om < m || (om == m && oy < my)) {
        m = om;
        my = oy;
        mx = ox;
      }
    }
    if (ty == 0 && q < Q) {
      const size_t o = (size_t)q * gridDim.x + blockIdx.x;
      part[o] = m;
      pwit[o] = (long long)my * (long long)K1 + (long long)mx;
    }
  }
}

extern "C" {

// rows f32 [Q, K1], d f32 [K1, K2], rowt f32 [Q, K2] ->
// part f32 [Q, ceil(K2 / TA_BY)], pwit int64 [same]: per y-tile the
// minimum and its packed witness y * K1 + x (meaningless where the
// partial is +inf).
int minplus_twoside_argmin(const void* rows, const void* d,
                           const void* rowt, void* part, void* pwit, int Q,
                           int K1, int K2, void* stream) {
  if (Q <= 0 || K2 <= 0) return (int)cudaSuccess;
  const dim3 grid((K2 + TA_BY - 1) / TA_BY, (Q + TA_BQ - 1) / TA_BQ);
  twoside_argmin_kernel<<<grid, TA_TQ * TA_TY, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)d, (const float*)rowt,
      (float*)part, (long long*)pwit, Q, K1, K2);
  return (int)cudaGetLastError();
}

}  // extern "C"
