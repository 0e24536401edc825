// Per-node projections of one attention pass for Hopper (sm_90a):
//   ni = h W[:, 0:256] + b,  nj = h W[:, 256:512],  q1 = h W[:, 512:640] + b,
//   q = LN_ReLU(q1) w_q2 + b_q2,
// W = w_node [128 x 640] (columns k.h_i | v.h_i | k.h_j | v.h_j | q's first
// layer, b zero on nj as packed), q1 optional (the backward's recompute).
// The edge kernels then never multiply h per edge.
//
// Replaces: the node part of targetdiff_tpu/ops/pallas/block_denoiser.py:
// _block_kernel and of targetdiff_tpu/ops/pallas/edge_layer.py:_x2h_kernel /
// _h2x_kernel (there fused into the edge kernels). It serves every caller:
// both passes of the inference and the train-mode block, both per-layer
// forwards and the backward's recompute (pass_bwd.cuh).
//
// What bounds it on this card: 2 x 128 x 768 FLOP per row of dense products
// against 512 + 1,536 + 1,536 bytes of h, ni|nj and q: at a few thousand rows
// both the bytes (~2 us at kNN B=4) and the TF32-rate products (~1 us) are
// tiny, so latency and the weights' traffic decide. The previous kernel ran
// on the FMA pipes with 8 rows per block, re-reading all 327 KB of W from L2
// for every 8 rows.
//
// Design:
//  * A block takes one 64-row tile and one 128-column slice of W (k_i, v_i,
//    k_j, v_j or q), staged once in shared memory as fp16 (hi, lo) mma
//    fragments, so W is read once per 64 rows and slice. 256 threads, eight
//    warps in a 2 x 4 grid of 32 x 32 tiles (tc_common.cuh: tile_mma), two
//    blocks per SM (~98 KB of shared memory each).
//  * Tensor cores at float32 grade: three-term fp16 products. h is the
//    residual stream, not a LayerNorm output, so fp16's range (65504) is not
//    guaranteed: each row of h is scaled by the power of two that brings its
//    largest |h| into [2^14, 2^15) before the split (exact) and its products
//    are scaled back, so any row from |h| ~ 1e-30 to ~1e38 keeps ~2^-21
//    relative to its largest entry. (A three-term TF32 split needs no
//    scaling but twice the mma instructions.) The q slice's block then
//    applies LayerNorm + ReLU to its q1 tile and runs the 128 x 128 w_q2
//    product the same way (a LayerNorm output: no scaling).
//  * bf16 (kBf16, the sampling path's default precision): the same tiles
//    with one bf16 product per mma (tc_common.cuh): h rows (scaled as above,
//    exact) and the LayerNorm outputs rounded to bf16, w_node and w_q2
//    packed as bf16; biases, LayerNorm and the outputs float32.
//  * Source-only rows. With row0 > 0 the rows below row0 of each complex
//    get only nj: the k_i, v_i and q slices cover rows [row0, N) of each
//    complex, their outputs elsewhere left as they were. The h2x pass reads
//    ni and q only on its destination (ligand) rows, nj on every row.
#pragma once

#include "tc_common.cuh"

namespace {

constexpr int kNodeRows = 64;      // rows per block
constexpr int kNodeThreads = 256;  // 8 warps: a 2 x 4 grid of 32 x 32 tiles

struct NodeSmem {
  uint4 w[kKSteps][kNTiles][32];         // one 128-column slice of W (then w_q2), stage_frags
  alignas(16) float a[kNodeRows][kLdz];  // the h tile as fp16 (hi, lo) pairs; then q1, its LN
  float unscale[kNodeRows];              // 2^-(e + 8): a row's products back to h W
};

// The exponent e that brings a row's largest |h|, mx, into [2^14, 2^15);
// 0 for a row of zeros (or a non-finite mx), bounded so that 2^e and
// 2^-(e + 8) stay normal floats.
__device__ __forceinline__ int row_exponent(float mx) {
  if (!(mx > 0.f && mx <= 3.4e38f)) return 0;
  int ex;
  frexpf(mx, &ex);  // mx = f 2^ex, f in [0.5, 1)
  return max(-100, min(100, 15 - ex));
}

__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

template <bool kBf16>
__global__ void __launch_bounds__(kNodeThreads, 2)
node_kernel(const float* __restrict__ h, int B, int N, int row0, PassParams p,
            float* __restrict__ ni, float* __restrict__ nj, float* __restrict__ q,
            float* __restrict__ q1) {
  extern __shared__ __align__(16) unsigned char node_smem_raw[];
  NodeSmem& s = *reinterpret_cast<NodeSmem*>(node_smem_raw);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group

  // blocks: the q slice's tiles, then k_i and v_i (rows [row0, N) of each
  // complex), then k_j and v_j (every row)
  const int nd = N - row0;
  const long long rows_dst = (long long)B * nd, rows_all = (long long)B * N;
  const int tiles_dst = (int)((rows_dst + kNodeRows - 1) / kNodeRows);
  const int tiles_all = (int)((rows_all + kNodeRows - 1) / kNodeRows);
  int slice, tile, bid = blockIdx.x;
  if (bid < tiles_dst) {
    slice = 4;
    tile = bid;
  } else if (bid < 3 * tiles_dst) {
    slice = (bid - tiles_dst) / tiles_dst;
    tile = (bid - tiles_dst) % tiles_dst;
  } else {
    bid -= 3 * tiles_dst;
    slice = 2 + bid / tiles_all;
    tile = bid % tiles_all;
  }
  const bool all_rows = slice == 2 || slice == 3;
  const long long nrows = all_rows ? rows_all : rows_dst;
  auto node_of = [&](int r) -> long long {  // node b*N + i of the tile's row r; -1 past the end
    const long long u = (long long)tile * kNodeRows + r;
    if (u >= nrows) return -1;
    return all_rows ? u : u / nd * N + row0 + u % nd;
  };

  // the h tile: warp w holds rows w + 8 i, four values a lane; their loads
  // fly while the slice of W is staged
  float v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long n = node_of(warp + 8 * i);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[i][c] = n >= 0 ? h[n * H + lane + 32 * c] : 0.f;
  }
  stage_frags<kBf16>(&s.w[0][0][0], weights<kBf16>(p.w_node) + slice * H, H5, kNTiles, t,
                     kNodeThreads);
  // each row times 2^e (exact), split into fp16 (hi, lo) pairs
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) mx = fmaxf(mx, fabsf(v[i][c]));
    const int e = row_exponent(warp_max(mx));
    const float f = pow2(e);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[i][c] *= f;
    store_split_row<kBf16>(reinterpret_cast<uint32_t*>(s.a[warp + 8 * i]), v[i], lane);
    if (lane == 0) s.unscale[warp + 8 * i] = pow2(-e - 8);
  }
  __syncthreads();

  // warp (mw, nw): rows 32 mw + 16 mt + g (+8), columns 32 nw + 8 nt + 2 tig (+1)
  const int mw = warp >> 2, nw = warp & 3;
  float acc[2][4][4] = {};
  tile_mma<4, kBf16>(acc, &s.a[32 * mw][0], &s.w[0][4 * nw][0], kNTiles, lane);
  const float* bias = p.b_node + slice * H;
  if (slice < 4) {
    float* dst = (slice < 2 ? ni : nj) + (slice & 1) * H;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 32 * mw + 16 * mt + 8 * hf + g;
        const long long n = node_of(r);
        if (n < 0) continue;
        const float us = s.unscale[r];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = 32 * nw + 8 * nt + 2 * tig;
          *reinterpret_cast<float2*>(dst + n * H2 + c) =
              make_float2(fmaf(acc[mt][nt][2 * hf], us, bias[c]),
                          fmaf(acc[mt][nt][2 * hf + 1], us, bias[c + 1]));
        }
      }
    return;
  }

  // the q slice: q1 into the tile (and out, if asked), LayerNorm + ReLU,
  // then the w_q2 product
  __syncthreads();  // every warp is done with the h tile and W
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 32 * mw + 16 * mt + 8 * hf + g;
      const long long n = node_of(r);
      const float us = s.unscale[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * nw + 8 * nt + 2 * tig;
        const float2 y = make_float2(fmaf(acc[mt][nt][2 * hf], us, bias[c]),
                                     fmaf(acc[mt][nt][2 * hf + 1], us, bias[c + 1]));
        *reinterpret_cast<float2*>(&s.a[r][c]) = y;
        if (q1 != nullptr && n >= 0) *reinterpret_cast<float2*>(q1 + n * H + c) = y;
      }
    }
  stage_frags<kBf16>(&s.w[0][0][0], weights<kBf16>(p.w_q2), H, kNTiles, t, kNodeThreads);
  __syncthreads();
  ln_split_rows<kBf16>(&s.a[0][0], warp, 8, p.q_ln, p.q_ln + H, lane);
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = 32 * nw + 8 * nt + 2 * tig;
    const float b0 = kWScale * p.b_q2[c], b1 = kWScale * p.b_q2[c + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] = acc[mt][nt][2] = b0;
      acc[mt][nt][1] = acc[mt][nt][3] = b1;
    }
  }
  tile_mma<4, kBf16>(acc, &s.a[32 * mw][0], &s.w[0][4 * nw][0], kNTiles, lane);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long n = node_of(32 * mw + 16 * mt + 8 * hf + g);
      if (n < 0) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * nw + 8 * nt + 2 * tig;
        *reinterpret_cast<float2*>(q + n * H + c) =
            make_float2(acc[mt][nt][2 * hf] * (1.f / kWScale),
                        acc[mt][nt][2 * hf + 1] * (1.f / kWScale));
      }
    }
}

// ni, nj, q (and q1, if not null) of the B x N rows of h; with row0 > 0 the
// rows below row0 of each complex get only nj. kBf16: bf16 products, p's
// w_node and w_q2 bf16.
template <bool kBf16 = false>
int launch_node(const float* h, int B, int N, int row0, const PassParams& p, float* ni, float* nj,
                float* q, float* q1, cudaStream_t s) {
  if (B <= 0 || N <= 0 || row0 < 0 || row0 >= N) return (int)cudaErrorInvalidValue;
  static const int attr = (int)cudaFuncSetAttribute(
      node_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(NodeSmem));
  if (attr) return attr;
  const long long tiles_dst = ((long long)B * (N - row0) + kNodeRows - 1) / kNodeRows;
  const long long tiles_all = ((long long)B * N + kNodeRows - 1) / kNodeRows;
  const long long grid = 3 * tiles_dst + 2 * tiles_all;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  node_kernel<kBf16><<<(unsigned)grid, kNodeThreads, sizeof(NodeSmem), s>>>(h, B, N, row0, p, ni,
                                                                            nj, q, q1);
  return (int)cudaGetLastError();
}

}  // namespace
