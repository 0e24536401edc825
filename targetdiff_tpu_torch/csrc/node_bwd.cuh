// The query MLP's backward and the node projections' input gradient of one
// attention pass (pass_bwd.cuh run_pass, once per pass) for Hopper (sm_90a).
//
// Replaces: the query MLP's backward inside the TPU's fused backward,
// targetdiff_tpu/ops/pallas/edge_layer_vjp.py:_node_mlp_bwd (called by
// block_vjp.py:_block_bwd_kernel at :312 and :446), and the node
// projections' input gradient dh += dproj w_node^T there.
//
// Per row n of the pass, from the row buffer (row stride W):
//   d qa = dq w_q2^T                           dq at column off_dq, [H]
//   dy   = d qa where LN(q1) scale + bias > 0, q1 the query MLP's first layer
//   dq1  = the LayerNorm backward of dy        -> rowbuf[n][4H, 5H)
//   (dy * LN(q1), dy)                          -> rowbuf[n][off_qln, + 2H)
//   qa   = relu(LN(q1) scale + bias)           -> qa[n] (for w_q2's gradient)
//   dh[n] += dproj[n] w_node^T, dproj = rowbuf[n][0, 5H)
//
// What bounds it: bytes. A row reads dq, dproj[0, 4H), q1 and dh and writes
// dq1, the LayerNorm partials, qa and dh, ~6 KB, for 2 (128 + 640) 128 FLOP
// of products: ~32 FLOP per byte, under the ~150 at which the TF32 tensor
// cores would bound it (82 MB, 0.025 ms at the B=32 train step's 13,312
// rows). This kernel is bound instead by its three mma.sync per product
// term: one term instead of three takes 0.09 ms per launch to 0.057, the
// operands' TF32 splits cost 0.014 (PERF.md §6, node_ew_variants.py).
//
// Design. A block takes a tile of TM rows (64; 32 where 64-row tiles would
// leave SMs idle: node_bwd_tile) with 8 warps, each a piece of 32 rows by
// TM / 2 columns of the [TM][H] outputs. Both products stream their A and B
// operands through one ring of cp.async stages, 32 k-columns a stage: d qa
// over dq and w_q2T (4 stages), then dh over dproj and w_nodeT (20 stages),
// so the weights are read once per tile from L2, not once per 8 rows as an
// FMA kernel with per-row loops does, and the first stages of the second
// product load while the LayerNorm backward runs. That backward takes the d
// qa tile from shared memory, a warp per row, and leaves dq1 there as the
// last 128 k-columns of the second product's A (dproj's first 512 come from
// the row buffer). The products are mma.sync.m16n8k8 TF32 in three terms
// (weight_grad.cuh split_tf32: lo*hi + hi*lo + hi*hi, ~2^-21 per term,
// float32-grade): the A operands are gradients with no range to scale into
// fp16. Each 8-deep k-step's three terms are summed from zero and added to
// the float32 accumulator, k ascending: a fixed order, so two runs give the
// same bits.
//
// bf16 (kBf16, the bf16 training variant, edge_layer_vjp.py _cdot at
// cd=bf16): the same tiles and ring, each 16-deep k-step one bf16
// mma.sync.m16n8k16 on operands rounded to bf16 where their fragments are
// formed (dq, dproj, dq1; w_q2^T, w_node^T), accumulated in the mma's float32
// accumulator; the LayerNorm backward and dh's sum stay float32.
#pragma once

#include "block_common.cuh"
#include "tc_common.cuh"
#include "weight_grad.cuh"

// node_bwd_kernel launches made by launch_node_bwd in this process, from
// every entry that runs it (td_node_bwd_launches reads it): the wrappers
// count the launches made, not the passes they asked for.
inline long long node_bwd_launch_count = 0;
// the same of the bf16 instantiation (td_node_bwd_bf16_launches)
inline long long node_bwd_bf16_launch_count = 0;

namespace {

constexpr int kNbK = 32;             // k-columns per stage: four m16n8k8 k-steps
constexpr int kNbStages = 3;
constexpr int kNbLdA = kNbK + 4;     // padded A row of a stage: conflict-free fragments
constexpr int kNbLdB = H + 8;        // padded B row of a stage
constexpr int kNbLdQ = H + 4;        // padded row of the d qa / dq1 tile
constexpr int kNbQSlices = H / kNbK;         // stages of the first product (k = H)
constexpr int kNbPSlices = 4 * H / kNbK;     // stages of dproj[0, 4H) from the row buffer
constexpr int kNbSlices = kNbQSlices + H5 / kNbK;  // all stages: d qa, then dh

template <int TM>
struct NodeBwdTile {
  static constexpr int kWarpsM = TM / 32;             // warps along the rows (2 or 1)
  static constexpr int kNT = H / 8 / (8 / kWarpsM);   // a warp's 8-column n-tiles (4 or 2)
  static constexpr int kStageFloats = TM * kNbLdA + kNbK * kNbLdB;
  static constexpr int kSmem = (kNbStages * kStageFloats + TM * kNbLdQ) * (int)sizeof(float);
};

// Stage slice s of the two products into st: the A rows of the tile (slices
// below kNbQSlices: dq; then dproj[0, 4H); none from there on: dq1 is in
// shared memory) and the 32 B rows (w_q2T, then w_nodeT). Rows past `rows`
// are zero-filled.
template <int TM>
__device__ __forceinline__ void nb_stage(float* st, int s, const float* __restrict__ rowbuf,
                                         int W, int off_dq, const float* __restrict__ w_q2T,
                                         const float* __restrict__ w_nodeT, long long n0,
                                         long long rows, int t) {
  if (s < kNbQSlices + kNbPSlices) {
    const int col = s < kNbQSlices ? off_dq + kNbK * s : kNbK * (s - kNbQSlices);
#pragma unroll
    for (int u = t; u < TM * kNbK / 4; u += kThreads) {
      const int r = u / (kNbK / 4), c = 4 * (u % (kNbK / 4));
      const bool v = n0 + r < rows;
      cp_async16_zfill(st + r * kNbLdA + c, v ? rowbuf + (n0 + r) * W + col + c : rowbuf, v);
    }
  }
  const float* B = s < kNbQSlices ? w_q2T + kNbK * s * H : w_nodeT + kNbK * (s - kNbQSlices) * H;
  float* sb = st + TM * kNbLdA;
#pragma unroll
  for (int u = t; u < kNbK * H / 4; u += kThreads) {
    const int r = u / (H / 4), c = 4 * (u % (H / 4));
    cp_async16_zfill(sb + r * kNbLdB + c, B + r * H + c, true);
  }
}

// One 32-deep slice of a warp's product: acc += A B over four k-steps, each
// the three-term TF32 product summed from zero. a: the warp's first A row
// (row stride lda) at the slice's first column; b: the slice's first B row at
// the warp's first column (row stride kNbLdB). One k-step at a time: unrolled,
// the 64-row tile's loads in flight spilled (56 bytes) for no gain in time
// (node_ew_variants.py `node_unroll2`; PERF.md). kBf16: two 16-deep k-steps,
// one bf16 product each, the operands rounded to bf16 as pairs.
template <int NT, bool kBf16 = false>
__device__ __forceinline__ void nb_slice(float (&acc)[2][NT][4], const float* a, int lda,
                                         const float* b, int g, int tig) {
  if constexpr (kBf16) {
#pragma unroll 1
    for (int k0 = 0; k0 < kNbK; k0 += 16) {
      // A: rows g, g + 8 x columns (2 tig, 2 tig + 1), the same + 8, of each m-tile
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = a + (16 * mt + g) * lda + k0 + 2 * tig;
        af[mt][0] = bf16_pair(ar[0], ar[1]);
        af[mt][1] = bf16_pair(ar[8 * lda], ar[8 * lda + 1]);
        af[mt][2] = bf16_pair(ar[8], ar[9]);
        af[mt][3] = bf16_pair(ar[8 * lda + 8], ar[8 * lda + 9]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B (k x n): rows (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9) of column g
        const float* br = b + (k0 + 2 * tig) * kNbLdB + 8 * nt + g;
        const uint32_t b0 = bf16_pair(br[0], br[kNbLdB]);
        const uint32_t b1 = bf16_pair(br[8 * kNbLdB], br[9 * kNbLdB]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    return;
  }
#pragma unroll 1
  for (int k0 = 0; k0 < kNbK; k0 += 8) {
    // A: (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4) of each m-tile
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* ar = a + (16 * mt + g) * lda + k0 + tig;
      split_tf32(ar[0], ah[mt][0], al[mt][0]);
      split_tf32(ar[8 * lda], ah[mt][1], al[mt][1]);
      split_tf32(ar[4], ah[mt][2], al[mt][2]);
      split_tf32(ar[8 * lda + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B (k x n): (tig, g) and (tig + 4, g)
      const float* br = b + (k0 + tig) * kNbLdB + 8 * nt + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(br[0], bh0, bl0);
      split_tf32(br[4 * kNbLdB], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, al[mt], bh0, bh1);
        mma_tf32(d, ah[mt], bl0, bl1);
        mma_tf32(d, ah[mt], bh0, bh1);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += d[c];
      }
    }
  }
}

template <int TM, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 2)
node_bwd_kernel(const float* __restrict__ q1, const float* __restrict__ q_ln,
                const float* __restrict__ w_q2T, const float* __restrict__ w_nodeT,
                long long rows, int W, int off_dq, int off_qln, float* __restrict__ rowbuf,
                float* __restrict__ qa, float* __restrict__ dh) {
  using T = NodeBwdTile<TM>;
  constexpr int NT = T::kNT;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem + kNbStages * T::kStageFloats;  // [TM][kNbLdQ]: d qa, then dq1
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  const long long n0 = (long long)blockIdx.x * TM;
  const int wr = warp / (8 / T::kWarpsM) * 32;         // the warp's first row of the tile
  const int wc = warp % (8 / T::kWarpsM) * (8 * NT);   // and first column

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kNbStages - 1; ++s) {
    nb_stage<TM>(smem + s * T::kStageFloats, s, rowbuf, W, off_dq, w_q2T, w_nodeT, n0, rows, t);
    cp_async_commit();
  }
  for (int s = 0; s < kNbSlices; ++s) {
    cp_async_wait<kNbStages - 2>();
    __syncthreads();  // slice s landed for every thread; slice s - 1's stage is free
    const int next = s + kNbStages - 1;
    if (next < kNbSlices)
      nb_stage<TM>(smem + next % kNbStages * T::kStageFloats, next, rowbuf, W, off_dq, w_q2T,
                   w_nodeT, n0, rows, t);
    cp_async_commit();
    const float* st = smem + s % kNbStages * T::kStageFloats;
    const float* b = st + TM * kNbLdA + wc;
    if (s < kNbQSlices + kNbPSlices)
      nb_slice<NT, kBf16>(acc, st + wr * kNbLdA, kNbLdA, b, g, tig);
    else  // dq1, the last H k-columns of dproj, from shared memory
      nb_slice<NT, kBf16>(acc, sq + wr * kNbLdQ + kNbK * (s - kNbQSlices - kNbPSlices), kNbLdQ,
                          b, g, tig);
    if (s != kNbQSlices - 1) continue;

    // d qa done: to the tile, then the query MLP's LayerNorm + ReLU backward
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          *reinterpret_cast<float2*>(sq + (wr + 16 * mt + 8 * hf + g) * kNbLdQ + wc + 8 * nt +
                                     2 * tig) =
              make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
          acc[mt][nt][2 * hf] = acc[mt][nt][2 * hf + 1] = 0.f;
        }
    __syncthreads();
    for (int r = warp; r < TM; r += kThreads / 32) {  // a warp per row
      const long long n = n0 + r;
      const bool live = n < rows;
      float v[4], zh[4], dy[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) v[q4] = live ? q1[n * H + lane + 32 * q4] : 0.f;
      float mean, rstd;
      ln_stats(v, mean, rstd);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int c = lane + 32 * q4;
        zh[q4] = (v[q4] - mean) * rstd;
        const float y = zh[q4] * q_ln[c] + q_ln[H + c];
        dy[q4] = y > 0.f ? sq[r * kNbLdQ + c] : 0.f;
        if (live) {
          qa[n * H + c] = fmaxf(y, 0.f);
          rowbuf[n * W + off_qln + c] = dy[q4] * zh[q4];
          rowbuf[n * W + off_qln + H + c] = dy[q4];
        }
        const float dzh = dy[q4] * q_ln[c];
        m1 += dzh;
        m2 += dzh * zh[q4];
      }
      m1 = warp_sum(m1) * (1.f / H);
      m2 = warp_sum(m2) * (1.f / H);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int c = lane + 32 * q4;
        const float dq1 = rstd * (dy[q4] * q_ln[c] - m1 - zh[q4] * m2);
        sq[r * kNbLdQ + c] = dq1;
        if (live) rowbuf[n * W + 4 * H + c] = dq1;
      }
    }
    // the next slice's barrier orders these dq1 stores before their reads
  }
  cp_async_wait<0>();

  // dh += dproj w_node^T; C fragment: (g, 2 tig .. 2 tig + 1), (g + 8, the same)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long n = n0 + wr + 16 * mt + 8 * hf + g;
      if (n >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float2* o = reinterpret_cast<float2*>(dh + n * H + wc + 8 * nt + 2 * tig);
        const float2 cur = *o;
        *o = make_float2(cur.x + acc[mt][nt][2 * hf], cur.y + acc[mt][nt][2 * hf + 1]);
      }
    }
}

// The row tile node_bwd_kernel takes for `rows` rows: 64, or 32 where 64-row
// tiles would not give each of the card's SMs a block. On the H100 (132
// SMs) 32-row tiles take 0.0355 device ms at 2,432 and 2,560 rows against
// 0.0573 for 64-row ones, and at 13,312 rows 0.1112 against 0.0898
// (node_ew_variants.py node_tile32 / node_tile64; PERF.md §6).
int node_bwd_tile(long long rows, int& tile) {
  static int n_sm = 0;
  if (int err = sm_count(node_bwd_kernel<64>, NodeBwdTile<64>::kSmem, n_sm)) return err;
  tile = (rows + 63) / 64 >= n_sm ? 64 : 32;
  return 0;
}

template <int TM, bool kBf16 = false>
int launch_node_bwd_tile(const float* q1, const float* q_ln, const float* w_q2T,
                         const float* w_nodeT, long long rows, int W, int off_dq, int off_qln,
                         float* rowbuf, float* qa, float* dh, cudaStream_t s) {
  // the ring's dynamic shared memory, set once per process (one device)
  static const int attr = (int)cudaFuncSetAttribute(
      node_bwd_kernel<TM, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      NodeBwdTile<TM>::kSmem);
  if (attr) return attr;
  node_bwd_kernel<TM, kBf16>
      <<<(unsigned)((rows + TM - 1) / TM), kThreads, NodeBwdTile<TM>::kSmem, s>>>(
          q1, q_ln, w_q2T, w_nodeT, rows, W, off_dq, off_qln, rowbuf, qa, dh);
  return (int)cudaGetLastError();
}

// node_bwd_kernel over `rows` rows of the row buffer (row stride W, dq at
// column off_dq, the LayerNorm partials written at off_qln). The row
// buffer's rows and the weights are read 16 bytes at a time: their bases, W
// and off_dq must be multiples of 16 bytes. kBf16: the bf16 instantiation,
// counted in node_bwd_bf16_launch_count.
template <bool kBf16 = false>
int launch_node_bwd(const float* q1, const float* q_ln, const float* w_q2T, const float* w_nodeT,
                    long long rows, int W, int off_dq, int off_qln, float* rowbuf, float* qa,
                    float* dh, cudaStream_t s) {
  if (rows <= 0 || W % 4 || off_dq % 4 || off_dq + H > W || off_qln + 2 * H > W ||
      ((uintptr_t)rowbuf & 15) || ((uintptr_t)w_q2T & 15) || ((uintptr_t)w_nodeT & 15) ||
      ((uintptr_t)dh & 7))
    return (int)cudaErrorInvalidValue;
  int tile = 0;
  int err = node_bwd_tile(rows, tile);
  if (err) return err;
  err = tile == 64 ? launch_node_bwd_tile<64, kBf16>(q1, q_ln, w_q2T, w_nodeT, rows, W, off_dq,
                                                     off_qln, rowbuf, qa, dh, s)
                   : launch_node_bwd_tile<32, kBf16>(q1, q_ln, w_q2T, w_nodeT, rows, W, off_dq,
                                                     off_qln, rowbuf, qa, dh, s);
  if (!err) ++(kBf16 ? node_bwd_bf16_launch_count : node_bwd_launch_count);
  return err;
}

// What the card makes of node_bwd_kernel's tile of TM rows: info[4] =
// {shared memory bytes per block, blocks per SM, registers per thread, local
// (spill) bytes per thread}.
template <int TM, bool kBf16 = false>
int node_bwd_info(int* info) {
  cudaFuncAttributes fa;
  int err = (int)cudaFuncSetAttribute(node_bwd_kernel<TM, kBf16>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      NodeBwdTile<TM>::kSmem);
  if (!err) err = (int)cudaFuncGetAttributes(&fa, node_bwd_kernel<TM, kBf16>);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], node_bwd_kernel<TM, kBf16>,
                                                             kThreads, NodeBwdTile<TM>::kSmem);
  if (err) return err;
  info[0] = NodeBwdTile<TM>::kSmem + (int)fa.sharedSizeBytes;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace
