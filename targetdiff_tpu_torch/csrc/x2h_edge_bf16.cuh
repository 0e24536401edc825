// The bf16 x2h edge pass for Hopper (sm_90a) on warpgroup tensor-core
// products (wgmma): for every destination row i,
//   out[i] = h[i] + sum_k alpha_ik * e_w,ik * v_ik,
// alpha the per-head softmax of q_i . k_ik / sqrt(8) over the row's valid
// edges (a row without one keeps h[i] exactly), k and v the edge MLPs: the
// first layer [edge type (4, one-hot) | type x RBF (4 x 20)] @ [w_et; w_rbf]
// plus the node projections ni_i + nj_j (node_proj.cuh), LayerNorm + ReLU,
// then the 128x128 second layer.
//
// Replaces, in their bf16 form (dtype=bf16, the sampling path's default):
// the x2h pass of targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel
// and targetdiff_tpu/ops/pallas/edge_layer.py:_x2h_kernel. It serves every
// bf16 x2h caller through launch_x2h<true> (x2h_edge.cuh): the inference
// block (td_block_x2h_bf16), the per-layer x2h (td_x2h_layer_bf16) and the
// bf16 train-mode forward (td_block_train_fwd_bf16).
//
// Precision: the bf16 plain version's rounding points and no others. The
// product operands are bf16 (the RBF features rounded where the producer
// writes them, the LayerNorm outputs where they become the second layer's A
// fragments, the weights as packed); every product is exact and summed in
// float32 on the tensor cores; ni, nj, the biases, the LayerNorms, the
// softmax, e_w and h stay float32.
//
// What bounds it on this card: per live edge ~115k FLOP of dense products
// (the two 96-deep first-layer halves and the two 128x128 second layers, at
// the bf16 tensor-core rate), ~1 KB of float32 nj gathered from L2, and the
// LayerNorms and softmax on the FMA pipes. The earlier bf16 instantiation
// of x2h_edge.cuh's kernel spent 41% of its time on the first layer's 20
// RBF terms on the FMA pipes, 16% on LayerNorms through shared memory and
// 21% on the per-chunk softmax and its barriers. This one is bound by its consumers'
// latency: the nj gather, the products' waits and the register work
// between them, with two 64-slot tiles in flight per SM (PERF.md §6).
//
// Design (its pieces shared with the bf16 h2x pass in edge_mma.cuh):
//  * Persistent blocks, one per SM, three warpgroups: two consumers and a
//    producer. Both tables are staged once per block as bf16 wgmma B
//    operands (K-major, 8x8 core matrices, no swizzle): the first layer
//    [w_et; w_rbf] of each half (96 x 128, 24 KB) and the second layers
//    (128 x 128, 32 KB each).
//  * Rows are dealt round-robin to the grid's consumers (all B x N rows,
//    or a row list: rows order[0, *count), the sampler's dependency cone,
//    cone.cu, the count read on the device; the rows off the list are not
//    written); a consumer takes its rows' live chunks (32 slots with a
//    valid edge) two at a time, a 64-slot tile (two rows, or two chunks of
//    one row at K > 32; a dead chunk costs nothing). Its two producer warps, alternating tiles, walk
//    the same rows 32 at a time, copy h to out for a row without a live
//    chunk, and fill a two-stage ring per consumer on mbarriers: per slot
//    its source, e_w and validity, the tile's A operand [one-hot type | type
//    x RBF | 0] in bf16 (64 x 96), and each chunk's ni and q rows
//    (cp.async).
//  * A consumer warpgroup runs each half (k, then v): the first layer as 6
//    wgmma m64n128k16 from shared memory; meanwhile each thread loads nj of
//    its two slots' sources (float32, straight into the accumulator's
//    layout: no shared-memory ring for it, whose 32 KB a half-tile would not
//    fit beside the tables and stages) and adds ni; then LayerNorm + ReLU on
//    the accumulator registers with quad shuffles, rounded to bf16 as the A
//    fragments of the second layer (8 wgmma m64n128k16, A from registers).
//  * Softmax by 16-slot warp partials: the k half's logits are reduced over
//    the quad (reduce-scatter), each warp keeps per head its slots' max,
//    exp-sum and e_w-weighted probabilities; the v half's weighted values
//    are reduced over the warp's slots by a reduce-scatter. One named
//    barrier a tile; then thread c of the consumer merges the four warp
//    partials in slot order into channel c's running row state (max,
//    denominator, value sum: an online softmax across a row's tiles, any
//    K <= kMaxLayerK) and writes h + sum / denominator at the row's last
//    chunk.
// Every sum runs in a fixed order and no atomic decides one: two launches
// give the same bits. A barrier wait that does not end traps (the launch
// fails) instead of hanging the card.
#pragma once

#include "edge_mma.cuh"

namespace {

constexpr int kMmaConsumers = 2;            // consumer warpgroups per block
constexpr int kMmaStages = 2;               // ring stages per consumer
constexpr int kMmaThreads = 128 * (kMmaConsumers + 1);
constexpr int kFeeders = 4 / kMmaConsumers;  // producer warps per consumer, alternating tiles
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kMmaConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register split fits the SM");
// each producer warp owns the stages of its tiles: an mbarrier's parity tells
// only two consecutive phases apart
static_assert(kMmaStages % kFeeders == 0, "a consumer's stages are dealt to its producer warps");

// One ring stage: a tile's first-layer A operand and its slots.
struct X2hTile {
  static constexpr bool kRel = false;
  alignas(128) unsigned char a[kMmaTile * kT1K * 2];  // bf16, kmajor_off(slot, feature, kSboT1)
  int src[kMmaTile];                                   // source node b*N + j; -1 invalid
  float ew[kMmaTile];                                  // e_w; 0 invalid
  float ni[2][H2];                                     // each chunk's row: ni (k|v) and q
  float q[2][H];
  long long row[2];                                    // each chunk's destination row; -1 none
  unsigned valid[2];                                   // each chunk's valid slots
  int first[2], last[2];                               // the chunk is its row's first / last
};

struct X2hMmaSmem {
  alignas(128) unsigned char w2[2][H * H * 2];     // k|v second layer, B[n][k] = w2[k][n]
  alignas(128) unsigned char t1[2][H * kT1K * 2];  // k|v first-layer table, B[n][k]
  X2hTile tile[kMmaConsumers][kMmaStages];
  float pw[kMmaConsumers][4][16][NH];              // e_w * exp(logit - warp max), per warp
  float xm[kMmaConsumers][2][4][NH];               // warp partials, double-buffered by tile:
  float xs[kMmaConsumers][2][4][NH];               //   max, exp-sum,
  float xv[kMmaConsumers][2][4][H];                //   weighted values
  float ln[2][H2];                                 // kv_ln: scale, bias of k|v
  float b2[2][H];                                  // second-layer biases of k, v
  unsigned long long full[kMmaConsumers][kMmaStages], empty[kMmaConsumers][kMmaStages];
};

// Both halves' tables as wgmma B operands (edge_mma.cuh), the LayerNorm and
// the biases, by the block's threads.
__device__ __forceinline__ void stage_x2h_tables(X2hMmaSmem& s, const PassParams& p, int t) {
  stage_edge_tables(s.t1, s.w2[0], s.w2[1], H, p, t, kMmaThreads);
  for (int c = t; c < 2 * H2; c += kMmaThreads) s.ln[c / H2][c % H2] = p.kv_ln[c];
  for (int c = t; c < 2 * H; c += kMmaThreads) s.b2[c / H][c % H] = (c < H ? p.b2k : p.b2v)[c % H];
}

// Producer warp pw (0..3) of the block: it feeds consumer pw / kFeeders the
// tiles j with j % kFeeders == pw % kFeeders, into ring stage j %
// kMmaStages. Walk position u is row u, or order[u] for u < *count with a
// row list. A consumer's producer warps walk the same rows, 32 at a time
// (lane i reads the live chunks of the window's row i); the first copies h
// to out for rows without a live chunk. A tile's slots are loaded before its
// stage is waited for; each chunk's ni and q rows are copied with cp.async.
// The tile after the last is an end marker (no chunk).
__device__ __forceinline__ void x2h_producer(X2hMmaSmem& s, const float* __restrict__ h,
                                             const EdgeInputs& in, const float* __restrict__ qn,
                                             int B, int N, int K, const int* __restrict__ order,
                                             const int* __restrict__ count,
                                             float* __restrict__ out, int pw, int lane) {
  const int c = pw / kFeeders, q = pw % kFeeders;
  if (c >= kMmaConsumers) return;
  const auto node = [order](long long u) { return order ? (long long)order[u] : u; };
  const auto dead = [&](long long bn) {  // h to out for a row without a live chunk
    if (q == 0)
      reinterpret_cast<float4*>(out + bn * H)[lane] =
          reinterpret_cast<const float4*>(h + bn * H)[lane];
  };
  ChunkWalk<decltype(node)> walk{in.nmask, node, count ? (long long)*count : (long long)B * N,
                                 (long long)kMmaConsumers * gridDim.x,
                                 (long long)kMmaConsumers * blockIdx.x + c, K, lane};
  walk.start(dead);
  for (int j = 0;; ++j) {
    const LiveChunk a = walk.next(dead), b = walk.next(dead);
    if (j % kFeeders != q) {
      if (a.row < 0) break;
      continue;
    }
    const int st = j % kMmaStages;
    fill_tile(s.tile[c][st], in, qn, N, K, a, b, &s.empty[c][st], ((j / kMmaStages) & 1) ^ 1,
              &s.full[c][st], lane);
    if (a.row < 0) break;  // the end marker
  }
}

// Consumer warpgroup c (thread wt of 128): the tiles of its rows, in order.
__device__ __forceinline__ void x2h_consumer(X2hMmaSmem& s, const float* __restrict__ h,
                                             const EdgeInputs& in, float* __restrict__ out, int c,
                                             int wt) {
  const int w = wt >> 5, lane = wt & 31, g = lane >> 2, tig = lane & 3;
  const int pos = w >> 1;      // the chunk of the warp's 16 slots
  const int m0 = 16 * w + g;   // the thread's slots m0 and m0 + 8 (accumulator rows)
  const int hh = wt >> 3;      // the merge's head (thread wt merges channel wt)
  // the merge thread's running state of its channel: max, denominator, value sum
  float m_run = -INFINITY, d_run = 0.f, o_run = 0.f;
  float acc[64];
  for (int j = 0;; ++j) {
    const int st = j % kMmaStages, buf = j & 1;
    X2hTile& T = s.tile[c][st];
    mbar_wait(&s.full[c][st], (j / kMmaStages) & 1);
    const long long rows[2] = {T.row[0], T.row[1]};
    if (rows[0] < 0) break;
    const int first[2] = {T.first[0], T.first[1]}, last[2] = {T.last[0], T.last[1]};
    const long long crow = rows[pos];
    const unsigned vmask = T.valid[pos];
    const int src[2] = {T.src[m0], T.src[m0 + 8]};
    const float ew[2] = {T.ew[m0], T.ew[m0 + 8]};
    const bool valid[2] = {((vmask >> (m0 & 31)) & 1u) != 0, ((vmask >> ((m0 + 8) & 31)) & 1u) != 0};
    const uint64_t da = mma_desc(T.a, kSboT1);
    float2 qv[NH];  // q of the chunk's row, the thread's columns 8 nt + 2 tig (+1)
    float2 ns[2][H / 8];  // the half's ni + nj of rows m0, m0 + 8

#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      // first layer: [type | type x RBF] of the tile's 64 slots times the half's table
      first_layer_mma(acc, da, s.t1[kv]);
      // meanwhile the half's ni + nj, and q
      node_sums(ns, in, crow < 0 ? nullptr : T.ni[pos], src, kv, tig);
      if (kv == 0) {
#pragma unroll
        for (int nt = 0; nt < H / 8; ++nt)
          qv[nt] = crow < 0 ? make_float2(0.f, 0.f)
                            : *reinterpret_cast<const float2*>(&T.q[pos][8 * nt + 2 * tig]);
      }
      wgmma_wait0();
      fence_acc(acc);
      if (kv == 1) mbar_arrive(&s.empty[c][st]);  // the tile's A operand and slots are read
      add_node_sums(acc, ns);
      uint32_t fr[H / 16][4];
      ln_relu_frags(fr, acc, s.ln, kv, tig);

      // second layer, A from registers; + bias
      {
        const uint64_t db = mma_desc(s.w2[kv], kSboW2);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < H / 16; ++ks) wgmma_rs(acc, fr[ks], desc_ks(db, ks), ks);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
      }
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(&s.b2[kv][8 * nt + 2 * tig]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * nt + 2 * r] += bias.x;
          acc[4 * nt + 2 * r + 1] += bias.y;
        }
      }

      if (kv == 0) {
        softmax_partials(acc, qv, valid, ew, s.pw[c][w], s.xm[c][buf][w], s.xs[c][buf][w], g,
                         tig);
      } else {
        // the warp's slots' e_w * p * v summed over its 16 slots: the
        // thread's 32 channel sums reduce-scattered over the 8 row groups
        __syncwarp();
        float pr[2][NH];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < NH / 4; ++i) {
            const float4 v4 = *reinterpret_cast<const float4*>(&s.pw[c][w][g + 8 * r][4 * i]);
            pr[r][4 * i] = v4.x;
            pr[r][4 * i + 1] = v4.y;
            pr[r][4 * i + 2] = v4.z;
            pr[r][4 * i + 3] = v4.w;
          }
        float part[NH][2];
#pragma unroll
        for (int nt = 0; nt < NH; ++nt)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            part[nt][jj] = pr[0][nt] * acc[4 * nt + jj] + pr[1][nt] * acc[4 * nt + 2 + jj];
        const bool b16 = (lane & 16) != 0, b8 = (lane & 8) != 0, b4 = (lane & 4) != 0;
        float p1[8][2], p2[4][2], p3[2][2];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float keep = b16 ? part[i + 8][jj] : part[i][jj];
            const float send = b16 ? part[i][jj] : part[i + 8][jj];
            p1[i][jj] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float keep = b8 ? p1[i + 4][jj] : p1[i][jj];
            const float send = b8 ? p1[i][jj] : p1[i + 4][jj];
            p2[i][jj] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float keep = b4 ? p2[i + 2][jj] : p2[i][jj];
            const float send = b4 ? p2[i][jj] : p2[i + 2][jj];
            p3[i][jj] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
          }
        const int base = (b16 ? 8 : 0) + (b8 ? 4 : 0) + (b4 ? 2 : 0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(&s.xv[c][buf][w][8 * (base + i) + 2 * tig]) =
              make_float2(p3[i][0], p3[i][1]);
      }
    }

    // merge the four warp partials in slot order into the row state; a
    // row's last chunk writes out = h + sums / denominator
    asm volatile("bar.sync %0, %1;" ::"r"(1 + c), "r"(128) : "memory");
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (rows[p] < 0) continue;
      if (first[p]) {
        m_run = -INFINITY;
        d_run = 0.f;
        o_run = 0.f;
      }
#pragma unroll
      for (int ww = 2 * p; ww < 2 * p + 2; ++ww) {
        const float mw = s.xm[c][buf][ww][hh];
        if (mw == -INFINITY) continue;  // no valid slot among the warp's 16
        const float mn = fmaxf(m_run, mw), a = expf(m_run - mn), b = expf(mw - mn);
        d_run = fmaf(d_run, a, s.xs[c][buf][ww][hh] * b);
        o_run = fmaf(o_run, a, s.xv[c][buf][ww][wt] * b);
        m_run = mn;
      }
      if (last[p]) out[rows[p] * H + wt] = h[rows[p] * H + wt] + o_run / fmaxf(d_run, 1e-16f);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
x2h_edge_mma_kernel(const float* __restrict__ h, EdgeInputs in, const float* __restrict__ qn,
                    PassParams p, int B, int N, int K, const int* __restrict__ order,
                    const int* __restrict__ count, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char x2h_mma_smem_raw[];
  X2hMmaSmem& s = *reinterpret_cast<X2hMmaSmem*>(x2h_mma_smem_raw);
  const int t = threadIdx.x;
  stage_x2h_tables(s, p, t);
  if (t == 0) {
    for (int c = 0; c < kMmaConsumers; ++c)
      for (int st = 0; st < kMmaStages; ++st) {
        mbar_init(&s.full[c][st], 1);
        mbar_init(&s.empty[c][st], 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();  // the staged tables, for the products
  __syncthreads();
  // warpgroups 0 .. kMmaConsumers - 1 consume, the last produces; the two
  // paths do not meet again
  const int wg = t >> 7;
  if (wg == kMmaConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    x2h_producer(s, h, in, qn, B, N, K, order, count, out, (t & 127) >> 5, t & 31);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    x2h_consumer(s, h, in, out, wg, t & 127);
  }
}

// out = x2h(h) with bf16 products, for any K <= kMaxLayerK, on every row or
// (order non-null) on the rows order[0, *count).
int launch_x2h_mma(const float* h, const EdgeInputs& in, const float* q, const PassParams& p,
                   int B, int N, int K, const int* order, const int* count, float* out,
                   cudaStream_t s) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxLayerK) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (int err = sm_count(x2h_edge_mma_kernel, (int)sizeof(X2hMmaSmem), n_sm)) return err;
  const long long units = ((long long)B * N + kMmaConsumers - 1) / kMmaConsumers;
  const int grid = (int)(units < n_sm ? units : n_sm);
  x2h_edge_mma_kernel<<<grid, kMmaThreads, sizeof(X2hMmaSmem), s>>>(h, in, q, p, B, N, K, order,
                                                                    count, out);
  return (int)cudaGetLastError();
}

}  // namespace
