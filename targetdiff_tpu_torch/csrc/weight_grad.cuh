// Weight-gradient products of the attention backwards (pass_bwd.cuh) for
// Hopper (sm_90a): out = X^T Y over M rows, X [M][ldx] (its first P
// columns), Y [M][ldy] (its first Q columns), float32 in and out.
//
// Replaces: the parameter-gradient products that the TPU kernels form in
// their own bodies, targetdiff_tpu/ops/pallas/edge_layer_vjp.py:_cdotg (dw2,
// used at :131 and :156, accumulated across the grid at :335) and those of
// block_vjp.py:_block_bwd_kernel (:17-19). Here they run over the per-edge
// and per-node rows that edge_bwd_kernel and node_bwd_kernel write: the
// second layers and the RBF / edge-type table over edges, w_node and the
// query MLP's second layer over nodes.
//
// What bounds it: bytes. A second layer's product at the B=32 train step
// reads 2 x 425,984 x 128 floats (0.44 GB) for 14 GFLOP, ~32 FLOP per byte,
// under the ~150 at which the TF32 tensor cores would bound it. The kernel
// itself is bound by its instruction issue (the splits, the float32 adds,
// three mma per product), ~2x from that bound (PERF.md).
//
// Design. A block computes one 128x128 output tile of one row chunk's
// partial product with 8 warps of 64x32. Tiles of 32 rows of X and Y come
// by cp.async (16-byte copies; rows past the chunk and columns past P or Q
// are zero-filled) into a ring of three stages, so the loads of the next
// rows overlap the products on the current ones. Shared rows are padded to
// 136 floats: X is stored [m][p] and read as A = X^T in m16n8k8 fragments,
// conflict-free, as Y is read as B. The products are mma.sync.m16n8k8 TF32
// in three terms: x = hi + lo, hi = x and lo = x - hi each rounded to TF32
// as cvt.rna rounds (to nearest, ties away from zero), lo*hi + hi*lo +
// hi*hi (~2^-21 per term, float32-grade). TF32 keeps float32's exponent:
// the operands are gradients spanning many decades, and no per-row scale
// factors out of a sum over rows, so fp16 (tc_common.cuh) would lose them.
// Each k-step's three terms are summed into a zeroed fragment, which is then
// added to the float32 accumulator: the long sum over a chunk's rows is
// rounded to nearest by the FP32 pipes, never carried in the tensor cores'
// accumulator (carried there, the sums missed float64 by 4.5e-5 to 9.3e-5
// of their terms' root-sum-square on the card: PERF.md). A warp skips the 16-row and 8-column pieces of its tile that lie
// past P or Q (P = 84 for the table, Q = 16 for h2x's w2v); a warp whose
// pieces are all live runs its k-steps without those checks.
//
// Determinism: the chunks depend on (M, P, Q) only (wg_chunk_rows), each
// block's order is fixed, and reduce_kernel sums the partials in ascending
// chunk order, so two runs give the same bits.
//
// Alignment: every operand base and leading dimension, P and Q, must be a
// multiple of 16 bytes (4 floats); weight_grad refuses anything else.
//
// bf16 (kBf16, the bf16 training variant: edge_layer_vjp.py _cdotg at
// cd=bf16): the same tiles, ring and chunks, X and Y rounded to bf16 where
// their fragments are formed, each 16-row k-step one bf16
// mma.sync.m16n8k16 accumulated in the mma's float32 accumulator (bf16
// keeps float32's exponent: no range to lose), and the same fixed-order
// reduce_kernel flush.
#pragma once

#include "block_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr long long kPartialCap = 1 << 22;  // floats of split-reduction scratch
constexpr int kWgTile = 128;                // output tile, P and Q
constexpr int kWgRows = 32;                 // rows of X and Y per stage
constexpr int kWgStages = 3;
constexpr int kWgLd = kWgTile + 8;          // padded shared row
constexpr int kWgStageFloats = 2 * kWgRows * kWgLd;
constexpr int kWgSmem = kWgStages * kWgStageFloats * (int)sizeof(float);
constexpr int kWgMT = 4, kWgNT = 4;         // a warp's 16-row m-tiles, 8-column n-tiles
constexpr long long kWgBlocks = 2 * 132;    // two blocks on each of the card's 132 SMs
constexpr long long kWgMinRows = 256;       // rows per chunk at least

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero, on the 13 low mantissa bits. An integer add and mask
// take two instructions where cvt.rna takes four (its checks for Inf and
// NaN), and they are a share of the kernel's instruction issue.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each TF32 (rna_tf32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile, TF32 operands, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [m0, m0 + kWgRows) of the block's X and Y columns into s:
// 32 rows x 32 16-byte pieces of each, four of each per thread.
__device__ __forceinline__ void wg_stage(float* s, const float* __restrict__ X, int ldx,
                                         const float* __restrict__ Y, int ldy, long long m0,
                                         long long me, int xcols, int ycols, int t) {
#pragma unroll
  for (int u = 0; u < kWgRows * kWgTile / 4 / kThreads; ++u) {
    const int i = t + u * kThreads;
    const int r = i >> 5, c = (i & 31) * 4;
    const long long m = m0 + r;
    const bool vx = m < me && c < xcols, vy = m < me && c < ycols;
    cp_async16_zfill(s + r * kWgLd + c, vx ? X + m * ldx + c : X, vx);
    cp_async16_zfill(s + (kWgRows + r) * kWgLd + c, vy ? Y + m * ldy + c : Y, vy);
  }
}

// One 16-row k-step of a warp's tiles in bf16: acc[i][j] += A B, A = X^T and
// B = Y rounded to bf16 (rows k0 + 2 tig, + 1 and those 8 rows down).
template <bool kFull>
__device__ __forceinline__ void wg_kstep_bf16(float (&acc)[kWgMT][kWgNT][4], const float* sx,
                                              const float* sy, int k0, int tig, int mt, int nt) {
  const float* xr = sx + (k0 + 2 * tig) * kWgLd;
  const float* yr = sy + (k0 + 2 * tig) * kWgLd;
  uint32_t b[kWgNT][2];  // B (k x n): rows (2 tig, 2 tig + 1), (2 tig + 8, 2 tig + 9) of column gid
#pragma unroll
  for (int j = 0; j < kWgNT; ++j) {
    b[j][0] = bf16_pair(yr[j * 8], yr[kWgLd + j * 8]);
    b[j][1] = bf16_pair(yr[8 * kWgLd + j * 8], yr[9 * kWgLd + j * 8]);
  }
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
    if (!kFull && i >= mt) break;
    // A = X^T (m x k): rows gid, gid + 8 x columns (2 tig, 2 tig + 1), the same + 8
    const uint32_t a[4] = {bf16_pair(xr[i * 16], xr[kWgLd + i * 16]),
                           bf16_pair(xr[i * 16 + 8], xr[kWgLd + i * 16 + 8]),
                           bf16_pair(xr[8 * kWgLd + i * 16], xr[9 * kWgLd + i * 16]),
                           bf16_pair(xr[8 * kWgLd + i * 16 + 8], xr[9 * kWgLd + i * 16 + 8])};
#pragma unroll
    for (int j = 0; j < kWgNT; ++j) {
      if (!kFull && j >= nt) break;
      mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
}

// One 8-row k-step of a warp's tiles: acc[i][j] += the three-term product
// of its A = X^T and B = Y fragments, summed from zero first. kFull: every
// m-tile and n-tile of the warp is live (no checks against mt, nt).
template <bool kFull>
__device__ __forceinline__ void wg_kstep(float (&acc)[kWgMT][kWgNT][4], const float* sx,
                                         const float* sy, int k0, int tig, int mt, int nt) {
  const float* xr = sx + (k0 + tig) * kWgLd;
  const float* yr = sy + (k0 + tig) * kWgLd;
  uint32_t bh[kWgNT][2], bl[kWgNT][2];  // B (k x n): (tig, gid) and (tig + 4, gid)
#pragma unroll
  for (int j = 0; j < kWgNT; ++j) {
    split_tf32(yr[j * 8], bh[j][0], bl[j][0]);
    split_tf32(yr[4 * kWgLd + j * 8], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
    if (!kFull && i >= mt) break;
    // A = X^T (m x k): (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4)
    uint32_t ah[4], al[4];
    split_tf32(xr[i * 16], ah[0], al[0]);
    split_tf32(xr[i * 16 + 8], ah[1], al[1]);
    split_tf32(xr[4 * kWgLd + i * 16], ah[2], al[2]);
    split_tf32(xr[4 * kWgLd + i * 16 + 8], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kWgNT; ++j) {
      if (!kFull && j >= nt) break;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, al, bh[j][0], bh[j][1]);
      mma_tf32(d, ah, bl[j][0], bl[j][1]);
      mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += d[c];
    }
  }
}

// partial[z] = X[rows of chunk z]^T Y[rows of chunk z] for the tile
// (blockIdx.x, blockIdx.y) of the [P][Q] output; kBf16: bf16 products.
template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 2)
weight_grad_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y, int ldy,
                   long long M, int P, int Q, long long chunk, float* __restrict__ partial) {
  constexpr int MT = kWgMT, NT = kWgNT;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int p0 = blockIdx.x * kWgTile, q0 = blockIdx.y * kWgTile;
  const long long mb = blockIdx.z * chunk;
  const long long me = mb + chunk < M ? mb + chunk : M;
  const int nk = (int)((me - mb + kWgRows - 1) / kWgRows);
  const int xcols = P - p0, ycols = Q - q0;
  X += p0;
  Y += q0;
  // the warp's 64x32 piece of the tile (2 x 4 warps), its live 16-row m-tiles
  // and 8-column n-tiles
  const int wp = warp / 4 * (MT * 16), wq = warp % 4 * (NT * 8);
  const int mt = min(max((xcols - wp + 15) / 16, 0), MT);
  const int nt = min(max((ycols - wq + 7) / 8, 0), NT);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) wg_stage(smem + s * kWgStageFloats, X, ldx, Y, ldy, mb + s * kWgRows, me,
                         xcols, ycols, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int next = kt + kWgStages - 1;
    if (next < nk) wg_stage(smem + (next % kWgStages) * kWgStageFloats, X, ldx, Y, ldy,
                            mb + (long long)next * kWgRows, me, xcols, ycols, t);
    cp_async_commit();
    if (mt == 0 || nt == 0) continue;
    const float* sx = smem + (kt % kWgStages) * kWgStageFloats + wp + gid;
    const float* sy = smem + (kt % kWgStages) * kWgStageFloats + kWgRows * kWgLd + wq +
                      gid;
    if constexpr (kBf16) {
      if (mt == MT && nt == NT) {
#pragma unroll
        for (int k0 = 0; k0 < kWgRows; k0 += 16) wg_kstep_bf16<true>(acc, sx, sy, k0, tig, mt, nt);
      } else {
#pragma unroll
        for (int k0 = 0; k0 < kWgRows; k0 += 16)
          wg_kstep_bf16<false>(acc, sx, sy, k0, tig, mt, nt);
      }
    } else if (mt == MT && nt == NT) {
#pragma unroll
      for (int k0 = 0; k0 < kWgRows; k0 += 8) wg_kstep<true>(acc, sx, sy, k0, tig, mt, nt);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kWgRows; k0 += 8) wg_kstep<false>(acc, sx, sy, k0, tig, mt, nt);
    }
  }
  cp_async_wait<0>();

  // C fragment: (gid, 2 tig .. 2 tig + 1) and (gid + 8, the same); Q is even
  float* out = partial + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = p0 + wp + i * 16 + gid, q = q0 + wq + j * 8 + 2 * tig;
      if (q >= Q) continue;
      if (p < P)
        *reinterpret_cast<float2*>(out + (size_t)p * Q + q) = make_float2(acc[i][j][0],
                                                                          acc[i][j][1]);
      if (p + 8 < P)
        *reinterpret_cast<float2*>(out + (size_t)(p + 8) * Q + q) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// out[i] = sum over z of partial[z][i], z ascending.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int S, long long n, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += partial[(size_t)z * n + i];
    out[i] = s;
  }
}

int grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return (int)(g < 4096 ? g : 4096);
}

// Rows per chunk of a weight-gradient product over M rows of `tiles` output
// tiles of n floats: about kWgBlocks blocks in all (one wave), at least
// kWgMinRows rows, a multiple of kWgRows, and the partials within
// kPartialCap.
long long wg_chunk_rows(long long M, long long tiles, long long n) {
  long long s = (kWgBlocks + tiles - 1) / tiles;
  if (s > kPartialCap / n) s = kPartialCap / n;
  long long rows = (M + s - 1) / s;
  if (rows < kWgMinRows) rows = kWgMinRows;
  return (rows + kWgRows - 1) / kWgRows * kWgRows;
}

bool aligned16(const void* p, int ld) {
  return ((uintptr_t)p & 15) == 0 && ld % 4 == 0;
}

// out [P][Q] = X^T Y; partial holds kPartialCap floats. kBf16: bf16 products.
template <bool kBf16 = false>
int weight_grad(const float* X, int ldx, const float* Y, int ldy, long long M, int P, int Q,
                float* out, float* partial, cudaStream_t s) {
  if (M <= 0 || P <= 0 || Q <= 0 || P % 4 || Q % 4 || P > ldx || Q > ldy ||
      (long long)P * Q > kPartialCap ||
      !aligned16(X, ldx) || !aligned16(Y, ldy))
    return (int)cudaErrorInvalidValue;
  // the dynamic shared memory of the ring, set once per process (one device)
  static const int attr = (int)cudaFuncSetAttribute(
      weight_grad_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (attr) return attr;
  const int tp = (P + kWgTile - 1) / kWgTile, tq = (Q + kWgTile - 1) / kWgTile;
  const long long chunk = wg_chunk_rows(M, (long long)tp * tq, (long long)P * Q);
  const long long S = (M + chunk - 1) / chunk;
  weight_grad_kernel<kBf16><<<dim3(tp, tq, (unsigned)S), kThreads, kWgSmem, s>>>(
      X, ldx, Y, ldy, M, P, Q, chunk, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_kernel<<<grid_for((long long)P * Q), kThreads, 0, s>>>(partial, (int)S,
                                                                (long long)P * Q, out);
  return (int)cudaGetLastError();
}

}  // namespace
