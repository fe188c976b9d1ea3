// Batched distance-only Floyd-Warshall for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/floyd_warshall.py:
// fw_batch_pallas (_fw_block_kernel), phase 1 of the blocked APSP that
// closes the hierarchy's top overlay.  For every matrix of a batch
// d[b, n, n] (float32, +inf = no edge) it writes
//   dist[b, i, j] = shortest i -> j distance (diagonal forced to 0),
// array-equal to repro_torch/kernels/ref.py:fw_batch_ref (distances of
// an exact APSP are unique, and integer weights keep every sum exact).
//
// Updating in place is exact: the diagonal is 0 and every weight is
// nonnegative, so during pivot k neither row k nor column k changes
// (d[i][k] + d[k][k] == d[i][k]).  Every cell is written only by the
// thread that owns it, so one barrier (or one launch boundary) between
// pivots reproduces the reference's functional update.
//
// Two launch shapes:
//  * fw_dist_smem: one block per matrix holds dist (4 bytes a cell) in
//    shared memory for all n pivots; n <= FWD_SMEM_MAX_N.  Threads walk
//    a 32-wide column lane and a row lane, so a warp reads row k and
//    writes row i at consecutive addresses and d[i][k] is a broadcast.
//  * fw_dist_global: an init pass, then one launch per pivot over all b
//    matrices in device memory; any n.
//
// Bound on this card: the function moves 8 bytes a cell (read d, write
// dist) and does 2 operations per cell and pivot (add, compare), so it
// is bound by operations (float32, no tensor-core form for (min,+)).
// The blocked schedule calls it with b = 1 and n = 128: one block on
// one SM, so it runs far from that bound; the phases 2/3 products that
// follow it carry the blocked schedule's work.
//
// Plain IEEE float adds only: built without --use_fast_math, and
// inf + x stays inf, so no NaN can arise from the +inf padding.

#include <cuda_runtime.h>

#define FWD_SMEM_MAX_N 240          // 240 * 240 * 4 B = 225 KB <= 227 KB
#define FWD_TILE 32

__global__ void __launch_bounds__(1024)
fw_dist_smem_kernel(const float* __restrict__ din,
                    float* __restrict__ dout, int n) {
  extern __shared__ float ds[];
  const size_t base = (size_t)blockIdx.x * n * n;
  const int tx = threadIdx.x % 32;          // column lane
  const int ty = threadIdx.x / 32;          // row lane
  const int ny = blockDim.x / 32;
  for (int i = ty; i < n; i += ny)
    for (int j = tx; j < n; j += 32)
      ds[i * n + j] = (i == j) ? 0.0f : din[base + (size_t)i * n + j];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float* rowk = ds + k * n;
    for (int i = ty; i < n; i += ny) {
      const float dik = ds[i * n + k];
      float* rowi = ds + i * n;
      for (int j = tx; j < n; j += 32) {
        const float cand = dik + rowk[j];
        if (cand < rowi[j]) rowi[j] = cand;
      }
    }
    __syncthreads();
  }
  for (int i = ty; i < n; i += ny)
    for (int j = tx; j < n; j += 32)
      dout[base + (size_t)i * n + j] = ds[i * n + j];
}

__global__ void fw_dist_init_kernel(const float* __restrict__ din,
                                    float* __restrict__ dout, int n) {
  const int j = blockIdx.x * FWD_TILE + threadIdx.x;
  const int i = blockIdx.y * FWD_TILE + threadIdx.y;
  if (i >= n || j >= n) return;
  const size_t c = (size_t)blockIdx.z * n * n + (size_t)i * n + j;
  dout[c] = (i == j) ? 0.0f : din[c];
}

__global__ void fw_dist_pivot_kernel(float* __restrict__ d, int n, int k) {
  const int j = blockIdx.x * FWD_TILE + threadIdx.x;
  const int i = blockIdx.y * FWD_TILE + threadIdx.y;
  if (i >= n || j >= n) return;
  const size_t base = (size_t)blockIdx.z * n * n;
  const size_t c = base + (size_t)i * n + j;
  const float cand = d[base + (size_t)i * n + k] + d[base + (size_t)k * n + j];
  if (cand < d[c]) d[c] = cand;
}

extern "C" {

// din, dout: float32 [b, n, n]; n <= FWD_SMEM_MAX_N.
int fw_dist_smem(const void* din, void* dout, int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > FWD_SMEM_MAX_N) return (int)cudaErrorInvalidValue;
  const int bytes = n * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fw_dist_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  // one warp per row lane, at most 32 row lanes and never more than n
  const int threads = 32 * (n < 32 ? n : 32);
  // a batch wider than the grid's x limit is walked in chunks
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int bc = (b - b0 < 65535) ? b - b0 : 65535;
    const size_t off = (size_t)b0 * n * n;
    fw_dist_smem_kernel<<<bc, threads, bytes, (cudaStream_t)stream>>>(
        (const float*)din + off, (float*)dout + off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Same contract, any n: init pass, then one launch per pivot.
int fw_dist_global(const void* din, void* dout, int b, int n,
                   void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n + FWD_TILE - 1) / FWD_TILE;
  const dim3 block(FWD_TILE, FWD_TILE);
  const size_t nn = (size_t)n * n;
  // gridDim.z is capped at 65535: walk the batch in chunks of that many
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int bc = (b - b0 < 65535) ? b - b0 : 65535;
    const dim3 grid(tiles, tiles, bc);
    const float* di = (const float*)din + b0 * nn;
    float* dd = (float*)dout + b0 * nn;
    fw_dist_init_kernel<<<grid, block, 0, s>>>(di, dd, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int k = 0; k < n; ++k) {
      fw_dist_pivot_kernel<<<grid, block, 0, s>>>(dd, n, k);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
