// Tile machinery shared by the two-sided tropical contractions
// (minplus_twoside.cu, minplus_twoside_argmin.cu) and the gathered lifts
// and legs (gather_minplus.cu): a block owns 64 queries x 64 y columns
// and walks its x range through 32-deep shared-memory tiles,
// double-buffered with cp.async, keeping acc[q, y] = min_x rows[q, x] +
// d[x, y] in an 8 x 4 register micro-tile per thread (256 threads).
//
// The walk does not know how a tile is staged: the caller hands it two
// stagers, so the dense witness kernel, the grouped distance kernel
// (rows gathered through a query order, d gathered through id tables)
// and the gathered kernels share the schedule, the all-+inf skip and the
// inner loop.
//
// The inner step takes two x at a time: two float32 adds (FADD) and one
// three-way int32 min of acc and the two sums' bit patterns (VIMNMX3,
// __vimin3_s32), half a min a cell where fminf takes one.  On sm_90 the
// min, not the add, bounds the loop: FADD + FMNMX and FADD + IMNMX run
// at the same rate, and one VIADDMNMX (DPX) a cell on int32 keys, which
// need converting, gains less in these kernels (PERF.md, section 6).
// Exact for non-negative float32 and +inf, which every caller passes
// (distances): their bit patterns order as int32 as the floats do, so
// the int32 min of the bits is the bits of fminf's result.  A negative
// operand would not be (its bits order in reverse).

#pragma once

#include <cuda_runtime.h>

#define TA_BQ 64      // queries per block
#define TA_BY 64      // y columns per block
#define TA_BX 32      // x depth per shared-memory tile
#define TA_MQ 8       // queries per thread
#define TA_MY 4       // y columns per thread
#define TA_TQ (TA_BQ / TA_MQ)
#define TA_TY (TA_BY / TA_MY)
#define TA_THREADS (TA_TQ * TA_TY)

struct TaTiles {
  float rs[2][TA_BX][TA_BQ];   // rows tiles, transposed: [x][q]
  float ds[2][TA_BX][TA_BY];   // d tiles: [x][y]
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Walk the x-tiles of [xa, xb) in order, double-buffered: the rows tile
// of t + 1 is staged (stage_rows(buf, x0) -> "this thread saw a finite
// entry") and voted on, and its d tile's copy started (stage_d(buf,
// x0)), before tile t is handed to body(rs, ds, x0).  A tile whose rows
// are all +inf is neither loaded nor handed over.  body returns a
// block-uniform "stop".
template <class StageRows, class StageD, class Body>
__device__ __forceinline__ void ta_walk_x(TaTiles& sm, int xa, int xb,
                                          StageRows&& stage_rows,
                                          StageD&& stage_d, Body&& body) {
  const int ntiles = xb > xa ? (xb - xa + TA_BX - 1) / TA_BX : 0;
  int live = 0;
  if (ntiles > 0) {
    live = __syncthreads_or(stage_rows(0, xa));
    if (live) stage_d(0, xa);
  }
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    const int x0 = xa + t * TA_BX;
    int next = 0;
    if (t + 1 < ntiles) {
      next = __syncthreads_or(stage_rows(cur ^ 1, x0 + TA_BX));
      if (next) stage_d(cur ^ 1, x0 + TA_BX);
    }
    cp_async_commit();
    if (live) {
      cp_async_wait_prev();   // tile t landed (t + 1 may be in flight)
      __syncthreads();
      const bool stop = body(sm.rs[cur], sm.ds[cur], x0);
      __syncthreads();        // buffers free for the prefetch after next
      if (stop) break;
    }
    live = next;
  }
  cp_async_wait_all();
  __syncthreads();
}

// One staged tile into the micro-tile: acc[a][b] = min(acc, rows + d)
// for this thread's 8 queries (tq) and 4 y columns (ty), three float4
// shared loads per x; per two x an add each and one three-way min of the
// bits a cell (non-negative operands: the note above).
__device__ __forceinline__ void ta_minplus_tile(float (&acc)[TA_MQ][TA_MY],
                                                const float (*rs)[TA_BQ],
                                                const float (*ds)[TA_BY],
                                                int tq, int ty) {
#pragma unroll 2
  for (int xx = 0; xx < TA_BX; xx += 2) {
    float rv[2][TA_MQ], dv[2][TA_MY];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 r0 =
          *reinterpret_cast<const float4*>(&rs[xx + h][tq * TA_MQ]);
      const float4 r1 =
          *reinterpret_cast<const float4*>(&rs[xx + h][tq * TA_MQ + 4]);
      const float4 dq =
          *reinterpret_cast<const float4*>(&ds[xx + h][ty * TA_MY]);
      rv[h][0] = r0.x; rv[h][1] = r0.y; rv[h][2] = r0.z; rv[h][3] = r0.w;
      rv[h][4] = r1.x; rv[h][5] = r1.y; rv[h][6] = r1.z; rv[h][7] = r1.w;
      dv[h][0] = dq.x; dv[h][1] = dq.y; dv[h][2] = dq.z; dv[h][3] = dq.w;
    }
#pragma unroll
    for (int a = 0; a < TA_MQ; ++a)
#pragma unroll
      for (int b = 0; b < TA_MY; ++b)
        acc[a][b] = __int_as_float(__vimin3_s32(
            __float_as_int(acc[a][b]), __float_as_int(rv[0][a] + dv[0][b]),
            __float_as_int(rv[1][a] + dv[1][b])));
  }
}
