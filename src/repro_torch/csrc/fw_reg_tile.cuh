// Register-tile Floyd-Warshall of one matrix a block, shared by the
// distance-only kernel (fw_dist.cu: fw_dist_reg, n <= 128) and the
// witness kernel (fw_next.cu: fw_next_reg's 32 < n <= 64 shape,
// WITNESS = true, the first hops carried beside the distances).
//
// Every thread owns a fixed RM x 4 sub-tile of the matrix in registers
// (rows ty*RM.., columns tx*4..; a warp is one row group), and with
// WITNESS the same cells' first hops.  At pivot k the owners of row k
// and of column k publish them (column k's first hops too) into a
// shared-memory strip pair, double-buffered by the parity of k; every
// thread reads its RM column entries (broadcast within the warp) and its
// 4 row entries (one float4) and updates its cells.  Right after its
// update at pivot k a thread publishes row/column k + 1 if it owns them,
// into the other buffer, so each pivot needs one __syncthreads: nobody
// reads that buffer before the barrier, and the buffer it overwrites was
// last read before the previous barrier.  The pivot loop is unrolled by
// RM, so the owner's register index (k % RM, k % 4) is static and
// nothing spills.  The strips hold row k and column k as they were
// before pivot k, which (diagonal 0, weights nonnegative) are the values
// they keep during pivot k: the update is the reference's functional
// one, min(D, D[:, k] + D[k, :]), cell for cell, and with WITNESS a cell
// takes column k's first hop only on a strict "<", as the serial
// reference does.
//
// Input and output take row strides (the first hops share the output's),
// so the blocked APSP runs the distance-only form in place on the
// diagonal tile of its padded matrix: each thread reads all its cells
// before it writes any, and no two threads share a cell (no __restrict__).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FWT_RN 4                    // columns a thread owns

// One matrix, n <= NP.  NP: padded n, a multiple of RM; RM: rows a
// thread owns, a multiple of 4.  Threads: (NP / RM) row groups x
// (NP / 4) column lanes, the block's.  src: row stride ldi; dst and (with
// WITNESS) hops: row stride ldo.
template <int NP, int RM, bool WITNESS>
__device__ __forceinline__ void fw_reg_tile(const float* src, long long ldi,
                                            float* dst, int* hops,
                                            long long ldo, int n) {
  constexpr int RN = FWT_RN;
  constexpr int TX = NP / RN;         // column lanes
  static_assert(RM % 4 == 0 && NP % RM == 0, "row tile");
  __shared__ __align__(16) float rowk[2][NP];
  __shared__ __align__(16) float colk[2][NP];
  __shared__ __align__(16) int colnk[2][WITNESS ? NP : 4];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const float inf = __int_as_float(0x7f800000);

  float acc[RM][RN];
  int hop[RM][RN];                    // first hops, WITNESS only
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty * RM + r;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = tx * RN + c;
      const bool in = i < n && j < n;
      const float v = in ? (i == j ? 0.0f : src[(long long)i * ldi + j])
                         : inf;
      acc[r][c] = v;
      if constexpr (WITNESS) hop[r][c] = (i != j && isfinite(v)) ? j : -1;
    }
  }
  // row k + 1 lives in row group (k + 1) / RM at register row
  // (k + 1) % RM, column k + 1 in lane (k + 1) / 4 at register column
  // (k + 1) % 4; the unrolled loop below makes both register indices
  // constants
#define FWT_PUBLISH(K, RR, CC, BUF)                                      \
  do {                                                                  \
    if (ty == (K) / RM)                                                 \
      *reinterpret_cast<float4*>(&rowk[BUF][tx * RN]) = make_float4(    \
          acc[RR][0], acc[RR][1], acc[RR][2], acc[RR][3]);              \
    if (tx == (K) / RN) {                                               \
      _Pragma("unroll") for (int q = 0; q < RM; q += 4) {               \
        *reinterpret_cast<float4*>(&colk[BUF][ty * RM + q]) =           \
            make_float4(acc[q][CC], acc[q + 1][CC], acc[q + 2][CC],     \
                        acc[q + 3][CC]);                                \
        if constexpr (WITNESS)                                          \
          *reinterpret_cast<int4*>(&colnk[BUF][ty * RM + q]) =          \
              make_int4(hop[q][CC], hop[q + 1][CC], hop[q + 2][CC],     \
                        hop[q + 3][CC]);                                \
      }                                                                 \
    }                                                                   \
  } while (0)

  // pivots past n see an all-+inf row and column and change nothing
  const int kend = (n + RM - 1) / RM * RM;
  FWT_PUBLISH(0, 0, 0, 0);
  __syncthreads();
  for (int kb = 0; kb < kend; kb += RM) {
#pragma unroll
    for (int u = 0; u < RM; ++u) {
      const int k = kb + u;
      const int buf = u & 1;          // kb is even, so k & 1 == u & 1
      float cv[RM];
      int cn[RM];
#pragma unroll
      for (int q = 0; q < RM; q += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(&colk[buf][ty * RM + q]);
        cv[q] = t.x;
        cv[q + 1] = t.y;
        cv[q + 2] = t.z;
        cv[q + 3] = t.w;
        if constexpr (WITNESS) {
          const int4 h =
              *reinterpret_cast<const int4*>(&colnk[buf][ty * RM + q]);
          cn[q] = h.x;
          cn[q + 1] = h.y;
          cn[q + 2] = h.z;
          cn[q + 3] = h.w;
        }
      }
      const float4 rv4 = *reinterpret_cast<const float4*>(&rowk[buf][tx * RN]);
      const float rv[RN] = {rv4.x, rv4.y, rv4.z, rv4.w};
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const float cand = cv[r] + rv[c];
          if constexpr (WITNESS) {
            const bool better = cand < acc[r][c];
            acc[r][c] = better ? cand : acc[r][c];
            hop[r][c] = better ? cn[r] : hop[r][c];
          } else {
            acc[r][c] = fminf(acc[r][c], cand);
          }
        }
      if (k + 1 < kend)
        FWT_PUBLISH(k + 1, (u + 1) % RM, (u + 1) % RN, buf ^ 1);
      __syncthreads();
    }
  }
#undef FWT_PUBLISH
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty * RM + r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = tx * RN + c;
      if (j < n) {
        dst[(long long)i * ldo + j] = acc[r][c];
        if constexpr (WITNESS) hops[(long long)i * ldo + j] = hop[r][c];
      }
    }
  }
}
