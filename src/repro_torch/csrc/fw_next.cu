// Batched witness-carrying Floyd-Warshall for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/floyd_warshall.py:
// fw_batch_next_pallas (_fw_next_block_kernel).  For every matrix of a
// batch d[b, n, n] (float32, +inf = no edge) it writes
//   dist[b, i, j] = shortest i -> j distance (diagonal forced to 0),
//   nxt[b, i, j]  = first hop of a shortest i -> j path
//                   (-1: unreachable or i == j),
// array-equal to repro_torch/kernels/ref.py:fw_batch_next_ref.  The
// callers compare nxt tables array for array, so the kernels keep the
// serial pivot order and the strict "<" of the reference; a blocked
// 3-phase schedule could break ties differently and is not used.
//
// Updating in place is exact: the diagonal is 0 and every weight is
// nonnegative, so during pivot k neither row k, nor column k, nor
// nxt[:, k] changes (cand = d[i][k] + 0 is never < d[i][k]).  Every
// cell (i, j) is written only by the thread that owns it, so one
// barrier (or one launch boundary) between pivots reproduces the
// reference's functional update.
//
// Two launch shapes:
//  * fw_next_smem: one block per matrix holds dist and nxt (8 bytes a
//    cell) in shared memory for all n pivots; n <= FW_SMEM_MAX_N.
//  * fw_next_global: an init pass, then one launch per pivot over all b
//    matrices in device memory; any n.
//
// Bound on this card: the function moves 12 bytes a cell (read d, write
// dist and nxt) and does 2 operations per cell and pivot (add, compare),
// so at n >= ~20 it is bound by operations (float32, no tensor-core
// form for (min,+)).  The global variant re-reads the matrix once per
// pivot, so it runs at device-memory speed instead; tiling the pivot
// row and column through shared memory is later work.
//
// Plain IEEE float adds only: built without --use_fast_math, and
// inf + x stays inf, so no NaN can arise from the +inf padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FW_SMEM_MAX_N 160          // 160 * 160 * 8 B = 200 KB <= 227 KB
#define FW_SMEM_THREADS 1024
#define FW_TILE 32

__device__ __forceinline__ void init_cell(float v, int i, int j,
                                          float* d, int* nx) {
  if (i == j) v = 0.0f;
  *d = v;
  *nx = (i != j && isfinite(v)) ? j : -1;
}

__global__ void __launch_bounds__(FW_SMEM_THREADS)
fw_next_smem_kernel(const float* __restrict__ din,
                    float* __restrict__ dout, int* __restrict__ nout,
                    int n) {
  extern __shared__ unsigned char smem[];
  float* ds = reinterpret_cast<float*>(smem);
  int* ns = reinterpret_cast<int*>(smem + sizeof(float) * n * n);
  const int nn = n * n;
  const size_t base = (size_t)blockIdx.x * nn;
  for (int c = threadIdx.x; c < nn; c += blockDim.x) {
    init_cell(din[base + c], c / n, c % n, &ds[c], &ns[c]);
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    for (int c = threadIdx.x; c < nn; c += blockDim.x) {
      const int i = c / n;
      const int j = c - i * n;
      const float cand = ds[i * n + k] + ds[k * n + j];
      if (cand < ds[c]) {
        ds[c] = cand;
        ns[c] = ns[i * n + k];
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < nn; c += blockDim.x) {
    dout[base + c] = ds[c];
    nout[base + c] = ns[c];
  }
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

__global__ void fw_next_pivot_kernel(float* __restrict__ d,
                                     int* __restrict__ nx, int n, int k) {
  const int j = blockIdx.x * FW_TILE + threadIdx.x;
  const int i = blockIdx.y * FW_TILE + threadIdx.y;
  if (i >= n || j >= n) return;
  const size_t base = (size_t)blockIdx.z * n * n;
  const size_t c = base + (size_t)i * n + j;
  const size_t ik = base + (size_t)i * n + k;
  const float cand = d[ik] + d[base + (size_t)k * n + j];
  if (cand < d[c]) {
    d[c] = cand;
    nx[c] = nx[ik];
  }
}

extern "C" {

// din, dout: float32 [b, n, n]; nout: int32 [b, n, n]; n <= max_n.
int fw_next_smem(const void* din, void* dout, void* nout, int b, int n,
                 void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > FW_SMEM_MAX_N) return (int)cudaErrorInvalidValue;
  const int bytes = n * n * (int)(sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      fw_next_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  int threads = ((n * n + 31) / 32) * 32;
  if (threads > FW_SMEM_THREADS) threads = FW_SMEM_THREADS;
  fw_next_smem_kernel<<<b, threads, bytes, (cudaStream_t)stream>>>(
      (const float*)din, (float*)dout, (int*)nout, n);
  return (int)cudaGetLastError();
}

// Same contract, any n: init pass, then one launch per pivot.
int fw_next_global(const void* din, void* dout, void* nout, int b, int n,
                   void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n + FW_TILE - 1) / FW_TILE;
  const dim3 block(FW_TILE, FW_TILE);
  const size_t nn = (size_t)n * n;
  // gridDim.z is capped at 65535: walk the batch in chunks of that many
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int bc = (b - b0 < 65535) ? b - b0 : 65535;
    const dim3 grid(tiles, tiles, bc);
    const float* di = (const float*)din + b0 * nn;
    float* dd = (float*)dout + b0 * nn;
    int* nd = (int*)nout + b0 * nn;
    fw_next_init_kernel<<<grid, block, 0, s>>>(di, dd, nd, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int k = 0; k < n; ++k) {
      fw_next_pivot_kernel<<<grid, block, 0, s>>>(dd, nd, n, k);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
