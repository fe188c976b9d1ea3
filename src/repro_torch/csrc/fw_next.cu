// Batched witness-carrying Floyd-Warshall for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/floyd_warshall.py:
// fw_batch_next_pallas (_fw_next_block_kernel).  For every matrix of a
// batch d[b, n, n] (float32, +inf = no edge) it writes
//   dist[b, i, j] = shortest i -> j distance (diagonal forced to 0),
//   nxt[b, i, j]  = first hop of a shortest i -> j path
//                   (-1: unreachable or i == j),
// array-equal to repro_torch/kernels/ref.py:fw_batch_next_ref.  The
// callers compare nxt tables array for array, so every variant
// reproduces the serial pivot order and the strict "<" of the
// reference, ties included.
//
// The invariant every variant rests on: the diagonal is 0 and every
// weight is nonnegative, so during pivot k neither row k, nor column k,
// nor nxt[:, k] changes (cand = d[i][k] + 0 is never < d[i][k]).
// Updating in place is therefore exact: every cell (i, j) is written
// only by the thread that owns it, and one barrier (or one launch
// boundary) between pivots reproduces the reference's functional update.
//
// Three launch shapes:
//  * fw_next_smem: one block per matrix holds dist and nxt (8 bytes a
//    cell) in shared memory for all n pivots; n <= FW_SMEM_MAX_N.
//  * fw_next_global: an init pass, then one launch per pivot over all b
//    matrices in device memory; any n.  Off the main path since the
//    blocked variant; kept to time the two side by side.
//  * fw_next_blocked: an init pass, then two launches per k-block
//    K = [s, s + B) over all b matrices (B = FWB_B); any n.
//
// The blocked schedule.  The textbook 3-phase blocked FW (close the
// pivot tile, then the bands against the closed tile, then the rest
// against the finished bands) gives the same distances but other first
// hops on ties: a cell outside the bands then sees the bands as they
// stand after all of K, not as the serial recurrence sees them at step
// k, and a tied path through a later pivot can win where the serial
// order kept an earlier one.  Snapshots make it exact.  Pivot k reads
// only row k and column k as they stood at step k-1, and (invariant
// above) they do not change at step k.  So
//  * phases 1+2 (fw_blocked_band_kernel, one launch): each band tile
//    (the K rows x a column tile, or a row tile x the K columns) loads
//    the pivot tile beside it into shared memory and runs the B pivots
//    of K over both in order, a barrier between pivots, so every band
//    cell reads the pivot tile at its own step.  At step k the column
//    band writes its column k with its first hops (C, CN) and the row
//    band its row k (R): the values the serial recurrence reads there.
//    The row band's pivot-column tile writes the closed pivot tile to
//    scratch; every other band tile writes itself back in place (the
//    pivot tile, which all blocks read, is not written in this launch).
//  * phase 3 (fw_blocked_cross_kernel, one launch): every cell outside
//    the bands takes the first strict minimum over k in K (ascending) of
//    C[i, k] + R[k, j], with CN[i, k] as its first hop; D wins ties.
//    That is a (min,+) product with an argmin carry: a 64 x 64 output
//    tile per block, an 8 x 4 register micro-tile of distance and
//    witness per thread, C^T, CN^T and R staged through shared memory
//    (the whole depth K fits at once, so overlap of loads and compute
//    comes from the other blocks resident on the SM).  A tile whose staged C or R
//    is all +inf cannot change and is skipped.  The same block copies
//    the closed pivot tile from scratch into place.
// Scratch (allocated by the caller, fw_next_blocked_scratch bytes):
// C^T f32 [b, B, n], CN^T i32 [b, B, n], R f32 [b, B, n] (transposed, so
// both the snapshot writes and phase 3's loads are coalesced), and the
// closed pivot tile f32 + i32 [b, B, B].
//
// Bound on this card: the function moves 12 bytes a cell (read d, write
// dist and nxt) and does 2 operations per cell and pivot (add, compare),
// so at n >= ~20 it is bound by operations (float32, no tensor-core
// form for (min,+)).  The blocked variant issues 4 instructions per cell
// and pivot in phase 3 (add, compare, two selects: the witness) and
// re-reads and re-writes dist and nxt once per k-block (16 bytes a cell
// every n / B pivots, against every pivot for fw_next_global); its
// phases 1+2 are B serial steps over 2 B x B tiles per block.
//
// Plain IEEE float adds only: built without --use_fast_math, and
// inf + x stays inf, so no NaN can arise from the +inf padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FW_SMEM_MAX_N 160          // 160 * 160 * 8 B = 200 KB <= 227 KB
#define FW_SMEM_THREADS 1024
#define FW_TILE 32
// k-block width B, pivots per k-block.  The band phases cost ~4 n^2 b B
// cell updates against phase 3's n^3 b, a wider block halves phase 3's
// dist/nxt passes: measured on the H100, 32 beat 64 at every shape of
// the main path, n = 4,613 included (scripts/fw_blocked_tune.py builds
// other widths with -DFWB_B).
#ifndef FWB_B
#define FWB_B 32
#endif
#define FWB_P 64                   // phase-3 output tile, rows and cols
#define FWB_RM 8                   // phase-3 rows per thread
#define FWB_CM 4                   // phase-3 cols per thread
#define FWB_P3_THREADS ((FWB_P / FWB_RM) * (FWB_P / FWB_CM))

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

// Phases 1+2 of k-block [s, s + kb), kb = min(B, n - s).  blockIdx.x < T:
// row band tile t = blockIdx.x (rows K x cols [tB, tB + B)); else column
// band tile t = blockIdx.x - T (rows [tB, tB + B) x cols K).
// blockIdx.y: the matrix.  B * B / 4 threads: each owns 4 cells of the
// pivot tile and the same 4 of the band tile (one column e, rows 4 apart
// by B / 4), kept in registers and mirrored to shared memory when they
// change, since other threads read row and column kk there.
template <int B>
__global__ void __launch_bounds__(B * B / 4)
fw_blocked_band_kernel(float* __restrict__ d, int* __restrict__ nx,
                       float* __restrict__ ct, int* __restrict__ cnt,
                       float* __restrict__ rt, float* __restrict__ pd,
                       int* __restrict__ pn, int n, int s, int T) {
  constexpr int W = B + 1;              // padded pitch: conflict-free columns
  constexpr int AS = B / 4;             // rows between a thread's cells
  extern __shared__ unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);      // pivot tile [B][W]
  int* PN = reinterpret_cast<int*>(P + B * W);
  float* Q = reinterpret_cast<float*>(PN + B * W);  // band tile [B][W]
  int* QN = reinterpret_cast<int*>(Q + B * W);
  const float inf = __int_as_float(0x7f800000);
  const int bb = blockIdx.y;
  const size_t base = (size_t)bb * n * n;
  const size_t sb = (size_t)bb * B * n;
  const bool rowband = blockIdx.x < T;
  const int t = rowband ? blockIdx.x : blockIdx.x - T;
  const bool pivot_tile = t * B == s;
  const int kb = min(B, n - s);
  const int r0 = rowband ? s : t * B;
  const int c0 = rowband ? t * B : s;
  const int e = threadIdx.x % B, a0 = threadIdx.x / B;
  float pv[4], qv[4];
  int pnv[4], qnv[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int a = a0 + m * AS;
    bool in = a < kb && e < kb;
    size_t g = base + (size_t)(s + a) * n + (s + e);
    pv[m] = in ? d[g] : inf;
    pnv[m] = in ? nx[g] : -1;
    const int i = r0 + a, j = c0 + e;
    in = i < n && j < n;
    g = base + (size_t)i * n + j;
    qv[m] = in ? d[g] : inf;
    qnv[m] = in ? nx[g] : -1;
    P[a * W + e] = pv[m];
    PN[a * W + e] = pnv[m];
    Q[a * W + e] = qv[m];
    QN[a * W + e] = qnv[m];
  }
  __syncthreads();
  for (int kk = 0; kk < kb; ++kk) {
    // snapshots: row / column kk as the serial recurrence reads them
    // at step s + kk (unchanged by that step)
    if (threadIdx.x < B) {
      const int x = threadIdx.x, g = t * B + x;
      if (g < n) {
        if (rowband) {
          rt[sb + (size_t)kk * n + g] = Q[kk * W + x];
        } else {
          ct[sb + (size_t)kk * n + g] = Q[x * W + kk];
          cnt[sb + (size_t)kk * n + g] = QN[x * W + kk];
        }
      }
    }
    const float pke = P[kk * W + e];
    const float qke = Q[kk * W + e];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int a = a0 + m * AS;
      const float pak = P[a * W + kk];
      float cand = pak + pke;
      if (cand < pv[m]) {
        pv[m] = cand;
        pnv[m] = PN[a * W + kk];
        P[a * W + e] = cand;
        PN[a * W + e] = pnv[m];
      }
      cand = rowband ? pak + qke : Q[a * W + kk] + pke;
      if (cand < qv[m]) {
        qv[m] = cand;
        qnv[m] = rowband ? PN[a * W + kk] : QN[a * W + kk];
        Q[a * W + e] = cand;
        QN[a * W + e] = qnv[m];
      }
    }
    __syncthreads();
  }
  if (pivot_tile && !rowband) return;     // the row band's copy writes it
  const size_t pb = (size_t)bb * B * B;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int a = a0 + m * AS;
    if (pivot_tile) {                      // closed pivot tile to scratch
      pd[pb + a * B + e] = qv[m];
      pn[pb + a * B + e] = qnv[m];
      continue;
    }
    const int i = r0 + a, j = c0 + e;
    if (i < n && j < n) {
      d[base + (size_t)i * n + j] = qv[m];
      nx[base + (size_t)i * n + j] = qnv[m];
    }
  }
}

// Phase 3 of k-block [s, s + kb): grid (col tiles, row tiles, matrix).
// Thread (tr, tc) owns rows i0 + 8 tr + a (a < 8) and columns
// j0 + tc + 16 b (b < 4): coalesced dist/nxt loads and stores, float4
// loads of C^T and CN^T, conflict-free loads of R.
template <int B>
__global__ void __launch_bounds__(FWB_P3_THREADS)
fw_blocked_cross_kernel(float* __restrict__ d, int* __restrict__ nx,
                        const float* __restrict__ ct,
                        const int* __restrict__ cnt,
                        const float* __restrict__ rt,
                        const float* __restrict__ pd,
                        const int* __restrict__ pn, int n, int s) {
  constexpr int P = FWB_P, TC = FWB_P / FWB_CM;
  __shared__ __align__(16) float cs[B][P];   // C^T: [k][row]
  __shared__ __align__(16) int cns[B][P];    // CN^T
  __shared__ __align__(16) float rs[B][P];   // R: [k][col]
  const float inf = __int_as_float(0x7f800000);
  const int i0 = blockIdx.y * P, j0 = blockIdx.x * P, bb = blockIdx.z;
  const int kb = min(B, n - s), e = s + kb;
  const size_t base = (size_t)bb * n * n;
  if (i0 < e && i0 + P > s && j0 < e && j0 + P > s) {
    const size_t pb = (size_t)bb * B * B;
    for (int c = threadIdx.x; c < kb * kb; c += blockDim.x) {
      const int i = s + c / kb, j = s + c % kb;
      if (i >= i0 && i < i0 + P && j >= j0 && j < j0 + P) {
        const int o = (i - s) * B + (j - s);
        d[base + (size_t)i * n + j] = pd[pb + o];
        nx[base + (size_t)i * n + j] = pn[pb + o];
      }
    }
  }
  // a tile inside the row or the column band has nothing left to do
  if ((i0 >= s && min(i0 + P, n) <= e) || (j0 >= s && min(j0 + P, n) <= e))
    return;
  const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
  float acc[FWB_RM][FWB_CM];
  int hop[FWB_RM][FWB_CM];
#pragma unroll
  for (int a = 0; a < FWB_RM; ++a) {       // issued before the staging
    const int i = i0 + tr * FWB_RM + a;
#pragma unroll
    for (int b = 0; b < FWB_CM; ++b) {
      const int j = j0 + tc + TC * b;
      const bool in = i < n && j < n;
      acc[a][b] = in ? d[base + (size_t)i * n + j] : inf;
      hop[a][b] = in ? nx[base + (size_t)i * n + j] : -1;
    }
  }
  const size_t sb = (size_t)bb * B * n;
  int fc = 0, fr = 0;
#pragma unroll
  for (int m = 0; m < B * P / FWB_P3_THREADS; ++m) {
    const int c = threadIdx.x + m * FWB_P3_THREADS;
    const int kk = c / P, x = c % P;
    const int i = i0 + x, j = j0 + x;
    const size_t o = sb + (size_t)kk * n;
    const float cv = (kk < kb && i < n) ? ct[o + i] : inf;
    const float rv = (kk < kb && j < n) ? rt[o + j] : inf;
    cs[kk][x] = cv;
    cns[kk][x] = (kk < kb && i < n) ? cnt[o + i] : -1;
    rs[kk][x] = rv;
    fc |= cv != inf;
    fr |= rv != inf;
  }
  fc = __syncthreads_or(fc);
  fr = __syncthreads_or(fr);
  if (!fc || !fr) return;                 // no finite C[i,k] + R[k,j]
  // k ascending, strict <: the first k at the minimum, D wins ties
#pragma unroll 4
  for (int kk = 0; kk < B; ++kk) {
    const float4 c0 = *reinterpret_cast<const float4*>(&cs[kk][tr * FWB_RM]);
    const float4 c1 =
        *reinterpret_cast<const float4*>(&cs[kk][tr * FWB_RM + 4]);
    const int4 n0 = *reinterpret_cast<const int4*>(&cns[kk][tr * FWB_RM]);
    const int4 n1 =
        *reinterpret_cast<const int4*>(&cns[kk][tr * FWB_RM + 4]);
    const float cv[FWB_RM] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z,
                              c1.w};
    const int cn[FWB_RM] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    float rv[FWB_CM];
#pragma unroll
    for (int b = 0; b < FWB_CM; ++b) rv[b] = rs[kk][tc + TC * b];
#pragma unroll
    for (int a = 0; a < FWB_RM; ++a)
#pragma unroll
      for (int b = 0; b < FWB_CM; ++b) {
        const float cand = cv[a] + rv[b];
        const bool better = cand < acc[a][b];
        acc[a][b] = better ? cand : acc[a][b];
        hop[a][b] = better ? cn[a] : hop[a][b];
      }
  }
#pragma unroll
  for (int a = 0; a < FWB_RM; ++a) {
    const int i = i0 + tr * FWB_RM + a;
    if (i >= n || (i >= s && i < e)) continue;
#pragma unroll
    for (int b = 0; b < FWB_CM; ++b) {
      const int j = j0 + tc + TC * b;
      if (j >= n || (j >= s && j < e)) continue;
      d[base + (size_t)i * n + j] = acc[a][b];
      nx[base + (size_t)i * n + j] = hop[a][b];
    }
  }
}

// k-blocks of B pivots over matrices [b0, b0 + bc) of dd / nd (already
// initialised), scratch carved for b matrices.
template <int B>
static cudaError_t fw_blocked_run(float* dd, int* nd, void* scratch, int b,
                                  int bc, int n, cudaStream_t st) {
  const int band_bytes = 4 * B * (B + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fw_blocked_band_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      band_bytes);
  if (err != cudaSuccess) return err;
  const int T = (n + B - 1) / B;
  const int T3 = (n + FWB_P - 1) / FWB_P;
  const size_t bn = (size_t)B * n;
  float* ct = (float*)scratch;
  int* cnt = (int*)(ct + (size_t)b * bn);
  float* rt = (float*)(cnt + (size_t)b * bn);
  float* pd = rt + (size_t)b * bn;
  int* pn = (int*)(pd + (size_t)b * B * B);
  for (int s = 0; s < n; s += B) {
    fw_blocked_band_kernel<B><<<dim3(2 * T, bc), B * B / 4, band_bytes, st>>>(
        dd, nd, ct, cnt, rt, pd, pn, n, s, T);
    fw_blocked_cross_kernel<B><<<dim3(T3, T3, bc), FWB_P3_THREADS, 0, st>>>(
        dd, nd, ct, cnt, rt, pd, pn, n, s);
  }
  return cudaGetLastError();
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

// Bytes of scratch fw_next_blocked takes for b matrices of n nodes.
size_t fw_next_blocked_scratch(int b, int n) {
  const size_t B = FWB_B;
  return (size_t)b * (3 * B * n + 2 * B * B) * sizeof(float);
}

// Same contract, any n: init pass, then per k-block of B pivots one
// launch of phases 1+2 and one of phase 3.  scratch: at least
// fw_next_blocked_scratch(b, n) bytes, 16-byte aligned.
int fw_next_blocked(const void* din, void* dout, void* nout, void* scratch,
                    int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (n + FW_TILE - 1) / FW_TILE;
  const size_t nn = (size_t)n * n;
  // gridDim.y and .z are capped at 65535: walk the batch in chunks
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int bc = (b - b0 < 65535) ? b - b0 : 65535;
    const float* di = (const float*)din + b0 * nn;
    float* dd = (float*)dout + b0 * nn;
    int* nd = (int*)nout + b0 * nn;
    fw_next_init_kernel<<<dim3(tiles, tiles, bc), dim3(FW_TILE, FW_TILE), 0,
                          st>>>(di, dd, nd, n);
    const cudaError_t err =
        fw_blocked_run<FWB_B>(dd, nd, scratch, b, bc, n, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
