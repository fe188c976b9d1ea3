// Hub-label merge for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/label_merge.py:
// label_merge_pallas (_merge_kernel), the combine of the hub-label tier:
//   out[q] = min_j labs[q, j] + labt[q, j]
// with labs, labt [Q, W] float32 (+inf absorbing).
//
// One warp per query row, the warps grid-strided over the rows.  Each
// lane walks the row with a stride of 32 (float4 loads, 4 columns a
// lane, where W is a multiple of 4 and both arrays are 16-byte aligned;
// single floats otherwise), adds the two labels and keeps a running
// min; a __shfl_xor_sync min across the warp finishes the row and lane
// 0 stores it.  W = 0 gives +inf.
//
// Bound on this card: bytes.  The merge reads 8 * Q * W bytes and
// writes 4 * Q for Q * W adds and mins, far below the float32 rate; the
// design keeps every load coalesced and 16 bytes wide and reads each
// label once.
//
// Exact: minima commute, and each sum is one IEEE add of integer-valued
// floats below 2**24, so any order gives the plain version's bits.
// Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LM_WARPS 8    // warps (rows in flight) per block

template <bool VEC>
__global__ void __launch_bounds__(LM_WARPS * 32)
label_merge_kernel(const float* __restrict__ labs,
                   const float* __restrict__ labt, float* __restrict__ out,
                   int Q, int W) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * LM_WARPS + threadIdx.x / 32;
  const int nwarps = gridDim.x * LM_WARPS;
  for (int q = warp; q < Q; q += nwarps) {
    const float* a = labs + (size_t)q * W;
    const float* b = labt + (size_t)q * W;
    float m = inf;
    if (VEC) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* b4 = reinterpret_cast<const float4*>(b);
      for (int j = lane; j < W / 4; j += 32) {
        const float4 u = a4[j], v = b4[j];
        m = fminf(m, fminf(fminf(u.x + v.x, u.y + v.y),
                           fminf(u.z + v.z, u.w + v.w)));
      }
    } else {
      for (int j = lane; j < W; j += 32) m = fminf(m, a[j] + b[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) out[q] = m;
  }
}

extern "C" {

// labs, labt f32 [Q, W] -> out f32 [Q].
int label_merge(const void* labs, const void* labt, void* out, int Q, int W,
                void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  const bool vec = (W % 4 == 0) && ((uintptr_t)labs % 16 == 0) &&
                   ((uintptr_t)labt % 16 == 0);
  // enough blocks to fill the card; the warps stride over the rest
  int blocks = (Q + LM_WARPS - 1) / LM_WARPS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec)
    label_merge_kernel<true><<<blocks, LM_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        (const float*)labs, (const float*)labt, (float*)out, Q, W);
  else
    label_merge_kernel<false><<<blocks, LM_WARPS * 32, 0,
                                (cudaStream_t)stream>>>(
        (const float*)labs, (const float*)labt, (float*)out, Q, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
