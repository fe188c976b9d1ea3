// Batched distance-only Floyd-Warshall for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/floyd_warshall.py:
// fw_batch_pallas (_fw_block_kernel).  For every matrix of a batch
// d[b, n, n] (float32, +inf = no edge) it writes
//   dist[b, i, j] = shortest i -> j distance (diagonal forced to 0),
// array-equal to repro_torch/kernels/ref.py:fw_batch_ref (distances of
// an exact APSP are unique, and integer weights keep every sum exact).
// The Pallas kernel holds a whole [n, n] matrix in VMEM and runs its n
// pivots there; a Hopper SM holds at most 227 KB, a 240 x 240 matrix.
//
// What bounds it on the H100: the function moves 8 bytes a cell and
// does 2 operations per cell and pivot, so above n ~ 20 it is bound by
// operations (float32; (min,+) has no tensor-core form): 0.4735 ms for
// road64k's fragments [130, 496, 496] at 67 TFLOP/s, ~0.06 us at b = 1,
// n = 128.  The n pivots of a matrix are a serial chain, so one matrix
// on one SM floors at n x (a barrier plus a few dependent
// instructions), and only a blocked schedule spreads a matrix over SMs.
//
// Two routes (kernels/floyd_warshall.py: fw_batch_cuda):
//  * n <= FWD_REG_MAX_N (fw_dist_reg_kernel, one launch): every thread
//    owns a fixed RM x 4 sub-tile of its matrix in registers, the owners
//    of row k and column k publish them into double-buffered shared
//    strips, one __syncthreads a pivot (fw_reg_tile.cuh, which the
//    witness FW's n <= 64 shape shares).  One tile shape a padded n: 32
//    and 64 take RM = 4 (64 and 256 threads), 128 takes RM = 16 (256
//    threads), which ran faster than 512 and 1,024 threads at b = 1,
//    n = 128 (PERF.md).  Input and output take row and batch strides,
//    so it also runs in place on the diagonal tiles of a larger matrix.
//  * above it, the textbook 3-phase blocked FW over all b matrices at
//    once, in place on the output, in k-blocks of B = 64 pivots
//    (DIST_BLOCK; at road64k's fragments 128 ran 17-20% slower: phase 2
//    doubles and phase 1 runs at n = 128).  Per k-block K: phase 1 is
//    fw_dist_reg on the b pivot tiles D[K, K] (one launch, batch
//    strides); phase 2 is minplus.cu's minplus_accum_panels on the row
//    panels D[K, :] and column panels D[:, K] of every matrix (one
//    launch, the matrix on the grid's z axis); phase 3 is minplus.cu's
//    minplus_accum_ld on the rest of every matrix (one launch).  The
//    blocks of both skip a k-tile of an all-+inf panel and leave a tile
//    that skipped all of them unread and unwritten: road64k's fragments
//    are 99.6% +inf as built and 32% once closed (sparse roads, the
//    smaller fragments' padding), and the skip takes ~40% off the
//    route.  3 ceil(n / B) launches: 24 at n = 496.  The same
//    schedule is ops.fw_apsp's on one padded matrix (the hierarchy's
//    top closure).  It is exact without the witness machinery of
//    fw_next.cu's blocked kernel (snapshots, argmin carry): those only
//    make ties pick the serial first hop, and distances have no ties
//    to break.  No padding copy: the last k-block is short and the
//    kernels mask the ragged edge.
//
// Plain IEEE float adds only: built without --use_fast_math, and
// inf + x stays inf, so no NaN can arise from the +inf padding.

#include <cuda_runtime.h>

#include "fw_reg_tile.cuh"

#define FWD_REG_MAX_N 128           // register tiles: padded n of 32, 64, 128

// NP: padded n, a multiple of RM; RM: rows a thread owns.  Threads:
// (NP / RM) row groups x (NP / 4) column lanes.
template <int NP, int RM>
__global__ void __launch_bounds__((NP / RM) * (NP / FWT_RN))
fw_dist_reg_kernel(const float* din, float* dout, int n, long long ldi,
                   long long ldo, long long bsi, long long bso) {
  fw_reg_tile<NP, RM, false>(din + (long long)blockIdx.x * bsi, ldi,
                             dout + (long long)blockIdx.x * bso, nullptr,
                             ldo, n);
}

template <int NP, int RM>
static cudaError_t reg_launch(const float* din, float* dout, int b, int n,
                              long long ldi, long long ldo, long long bsi,
                              long long bso, cudaStream_t s) {
  constexpr int threads = (NP / RM) * (NP / FWT_RN);
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int bc = (b - b0 < 65535) ? b - b0 : 65535;
    fw_dist_reg_kernel<NP, RM><<<bc, threads, 0, s>>>(
        din + (long long)b0 * bsi, dout + (long long)b0 * bso, n, ldi, ldo,
        bsi, bso);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

// din, dout: float32 [b, n, n] with row strides ldi, ldo and batch
// strides bsi, bso (elements; dout may be din, for an in-place update);
// n <= FWD_REG_MAX_N.
int fw_dist_reg(const void* din, void* dout, int b, int n, long long ldi,
                long long ldo, long long bsi, long long bso, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > FWD_REG_MAX_N) return (int)cudaErrorInvalidValue;
  const float* di = (const float*)din;
  float* dd = (float*)dout;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n <= 32)
    err = reg_launch<32, 4>(di, dd, b, n, ldi, ldo, bsi, bso, s);
  else if (n <= 64)
    err = reg_launch<64, 4>(di, dd, b, n, ldi, ldo, bsi, bso, s);
  else
    err = reg_launch<128, 16>(di, dd, b, n, ldi, ldo, bsi, bso, s);
  return (int)err;
}

}  // extern "C"
