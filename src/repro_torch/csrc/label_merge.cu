// Hub-label merge for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/label_merge.py:66,
// label_merge_pallas (_merge_kernel), the combine of the hub-label tier:
//   out[i] = min_j A_i[j] + B_i[j]
// over two float32 label rows of W entries each (+inf absorbing).  One
// template (label_merge_kernel<Rows>) finds the two rows of query i in
// one of two ways:
//   * dense (label_merge): A_i, B_i = row i of labs and labt [Q, W], the
//     Pallas function's own signature;
//   * indexed (label_merge_rows): A_i, B_i = rows[ids_s[i]] and
//     rows[ids_t[i]] of the label table rows [H+1, W] through int32 row
//     ids, so the hub tier never writes the [Q, W] gathers: a pad or a
//     repeated agent re-reads its row (from L2, or L1 within a block)
//     instead of a copy of it.
//
// Bound on this card: bytes.  Indexed: the distinct rows ids_s and ids_t
// reach, plus 8Q for the ids and 4Q for the output; dense: 8QW + 4Q.
// The 2QW adds and mins are far below the float32 rate.
//
// Design.  A team of T threads (a power of two, 32..256, so whole warps)
// merges one query, and a block of 256 threads holds 256 / T teams.  In a
// pass each thread issues all its loads (LM_COLS = 16 columns of each
// row: 4 float4s, or 16 single floats, T columns or float4s apart, so
// that every warp load is one coalesced span) before it adds and mins
// them: the loads of a pass are in flight together, and bytes, not a
// load's latency, set the time.  The wrapper (kernels/label_merge.py:team)
// gives a query enough threads that one pass covers its row, halved while
// the Q teams would not all be resident at once (4 blocks an SM at this
// kernel's 64 registers): a batch of 1,024 at W = 4,661 gets 4 warps a
// query, one wave of ~31 warps an SM, and a live flush (Q <= 256) at that
// width a whole block a query.  scripts/label_merge_tune.py times every
// team size at 4, 8 and 16 columns a pass (PERF.md).
//
// Any W, any row alignment.  A row starts at r * W * 4 bytes, so where
// W % 4 != 0 (road250k's W = 4,661) its phase mod 16 bytes depends on r.
// Where a query's two rows share a phase, the pass runs float4 loads
// between scalar edges (a head up to the 16-byte boundary, a tail past
// the last whole float4); where they do not, it runs the unrolled 4-byte
// loads (coalesced, 128 bytes a warp load).  `vec` = 0 forces the 4-byte
// loads everywhere, for timing the two against each other.  A query
// whose two rows are one row (the (0, 0) pads of a padded batch) reads
// it once.  A warp shuffle min, then a shared-memory min over the team's
// warps, finishes the query; no atomics.  W = 0 gives +inf.
//
// Exact: minima commute, and each sum is one IEEE add of integer-valued
// floats below 2**24, so any order gives the plain version's bits.
// Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LM_BLOCK 256   // threads a block
#ifndef LM_COLS        // columns of each row a thread loads in a pass (a
#define LM_COLS 16     // multiple of 4; scripts/label_merge_tune.py
#endif                 // builds other values)

struct DenseRows {     // row i of labs and of labt [Q, W]
  const float* s;
  const float* t;
  __device__ __forceinline__ const float* a(int i, int W) const {
    return s + (size_t)i * W;
  }
  __device__ __forceinline__ const float* b(int i, int W) const {
    return t + (size_t)i * W;
  }
};

struct IndexedRows {   // rows[ids_s[i]] and rows[ids_t[i]] of rows [H+1, W]
  const float* rows;
  const int* ids_s;
  const int* ids_t;
  __device__ __forceinline__ const float* a(int i, int W) const {
    return rows + (size_t)__ldg(ids_s + i) * W;
  }
  __device__ __forceinline__ const float* b(int i, int W) const {
    return rows + (size_t)__ldg(ids_t + i) * W;
  }
};

__device__ __forceinline__ float lm_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ float min4(float4 u, float4 v) {
  return fminf(fminf(u.x + v.x, u.y + v.y), fminf(u.z + v.z, u.w + v.w));
}

// This thread's share (tt of a team of T) of min_j a[j] + b[j], j < n,
// 4 bytes a load.
__device__ __forceinline__ float merge_scalar(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              bool same, int n, int tt,
                                              int T) {
  const float inf = lm_inf();
  float m = inf;
  for (int j0 = tt; j0 < n; j0 += LM_COLS * T) {
    float x[LM_COLS], y[LM_COLS];
#pragma unroll
    for (int u = 0; u < LM_COLS; ++u) {
      const int j = j0 + u * T;
      x[u] = j < n ? __ldg(a + j) : inf;
    }
#pragma unroll
    for (int u = 0; u < LM_COLS; ++u) {
      const int j = j0 + u * T;
      y[u] = same ? x[u] : (j < n ? __ldg(b + j) : inf);
    }
#pragma unroll
    for (int u = 0; u < LM_COLS; ++u) m = fminf(m, x[u] + y[u]);
  }
  return m;
}

// The same over n4 float4s of 16-byte aligned a and b.
__device__ __forceinline__ float merge_vec(const float4* __restrict__ a,
                                           const float4* __restrict__ b,
                                           bool same, int n4, int tt,
                                           int T) {
  constexpr int U = LM_COLS / 4;
  const float inf = lm_inf();
  const float4 inf4 = make_float4(inf, inf, inf, inf);
  float m = inf;
  for (int k0 = tt; k0 < n4; k0 += U * T) {
    float4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * T;
      x[u] = k < n4 ? __ldg(a + k) : inf4;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * T;
      y[u] = same ? x[u] : (k < n4 ? __ldg(b + k) : inf4);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) m = fminf(m, min4(x[u], y[u]));
  }
  return m;
}

template <class Rows>
__global__ void __launch_bounds__(LM_BLOCK)
label_merge_kernel(Rows rows, float* __restrict__ out, int Q, int W,
                   int team_log2, int vec) {
  __shared__ float part[LM_BLOCK / 32];
  const int T = 1 << team_log2;
  const int tt = threadIdx.x & (T - 1);
  const int q = blockIdx.x * (LM_BLOCK >> team_log2)
                + (threadIdx.x >> team_log2);
  float m = lm_inf();
  if (q < Q) {                           // uniform over the team
    const float* a = rows.a(q, W);
    const float* b = rows.b(q, W);
    const bool same = a == b;
    const unsigned pa = (unsigned)((uintptr_t)a & 15);
    if (vec && pa == (unsigned)((uintptr_t)b & 15)) {
      const int head = min(W, (int)(((16u - pa) & 15u) >> 2));
      if (tt < head) m = __ldg(a + tt) + __ldg(b + tt);
      const int n4 = (W - head) >> 2;
      m = fminf(m, merge_vec(reinterpret_cast<const float4*>(a + head),
                             reinterpret_cast<const float4*>(b + head),
                             same, n4, tt, T));
      const int done = head + 4 * n4;
      if (tt < W - done)
        m = fminf(m, __ldg(a + done + tt) + __ldg(b + done + tt));
    } else {
      m = merge_scalar(a, b, same, W, tt, T);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = m;
  __syncthreads();
  if (tt == 0 && q < Q) {                // warp is the team's first
    for (int k = 1; k < (T >> 5); ++k) m = fminf(m, part[warp + k]);
    out[q] = m;
  }
}

__global__ void label_merge_empty_kernel() {}

template <class Rows>
static int launch(Rows rows, void* out, int Q, int W, int team_log2,
                  int vec, void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (W < 0 || team_log2 < 5 || team_log2 > 8)
    return (int)cudaErrorInvalidValue;
  const int per_block = LM_BLOCK >> team_log2;
  const int blocks = (Q + per_block - 1) / per_block;
  label_merge_kernel<Rows><<<blocks, LM_BLOCK, 0, (cudaStream_t)stream>>>(
      rows, (float*)out, Q, W, team_log2, vec);
  return (int)cudaGetLastError();
}

extern "C" {

// labs, labt f32 [Q, W] -> out f32 [Q]; a team of 1 << team_log2 threads
// a query.
int label_merge(const void* labs, const void* labt, void* out, int Q, int W,
                int team_log2, void* stream) {
  return launch(DenseRows{(const float*)labs, (const float*)labt}, out, Q,
                W, team_log2, 1, stream);
}

// rows f32 [H+1, W], ids_s, ids_t int32 [Q] in [0, H] -> out f32 [Q].
int label_merge_rows(const void* rows, const void* ids_s, const void* ids_t,
                     void* out, int Q, int W, int team_log2, int vec,
                     void* stream) {
  return launch(IndexedRows{(const float*)rows, (const int*)ids_s,
                            (const int*)ids_t},
                out, Q, W, team_log2, vec, stream);
}

// An empty kernel on `blocks` blocks of LM_BLOCK threads: the fixed cost
// of a launch, which the merge's time is read beside.
int label_merge_empty(int blocks, void* stream) {
  label_merge_empty_kernel<<<blocks, LM_BLOCK, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
