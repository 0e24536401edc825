// The bf16 h2x edge pass for Hopper (sm_90a) on warpgroup tensor-core
// products (wgmma): for every destination row i >= row0 of each complex,
//   out[i] = x[i] + mask_ligand[i] * (1/16) sum_h S_h / D_h,
//   D_h = sum_k exp(l_ikh - m_h),  S_h = sum_k exp(l_ikh - m_h) e_w,ik v_ikh rel_ik,
// l the logits q_i . k_ik / sqrt(8) per head over the row's valid edges (a
// row without one keeps x[i] exactly), k (128 wide) and v (16 wide: one per
// head) the edge MLPs: the first layer [edge type (4, one-hot) | type x RBF
// (4 x 20)] @ [w_et; w_rbf] plus the node projections ni_i + nj_j
// (node_proj.cuh), LayerNorm + ReLU, then the second layer; rel = x_i - x_j.
//
// Replaces, in their bf16 form (dtype=bf16, the sampling path's default):
// the h2x pass of targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel
// and targetdiff_tpu/ops/pallas/edge_layer.py:_h2x_kernel. It serves every
// bf16 h2x caller through launch_h2x<true> (h2x_edge.cuh): the inference
// block (td_block_h2x_bf16), the per-layer h2x (td_h2x_layer_bf16) and the
// bf16 train-mode forward (td_block_train_fwd_bf16).
//
// Precision: the bf16 plain version's rounding points and no others. The
// product operands are bf16 (the RBF features rounded where the producer
// writes them, the LayerNorm outputs where they become the second layer's A
// fragments, the weights as packed); every product is exact and summed in
// float32 on the tensor cores; ni, nj, the biases, the LayerNorms, the
// logits, the softmax partials, e_w, rel and x stay float32.
//
// What bounds it on this card: per live edge ~87k FLOP of dense products
// (the two 96-deep first-layer halves, the 128x128 k and the 128x16 v second
// layers, at the bf16 tensor-core rate) and ~1 KB of float32 nj gathered
// from L2; the work is the ligand rows' alone (128 rows at kNN B=4, 3,200 at
// B=100). Measured, it is bound by its consumers' latency: the LayerNorms,
// the v product's wait, the nj gather and warp 0's merge follow one another
// with two tiles in flight per SM (PERF.md §6); at B=4 a consumer has one
// tile, and the table staging overlaps the producer's first. The float32
// design it replaces in bf16 (h2x_edge.cuh) ran the first layer's 20 RBF
// terms on the FMA pipes, the LayerNorms through shared memory, 32-slot
// mma.sync products and block-wide barriers every 8 rows.
//
// Design (x2h_edge_bf16.cuh's, through edge_mma.cuh):
//  * Persistent blocks, one per SM, three warpgroups: two consumers and a
//    producer. The consumers stage the layer's tables once per block as bf16
//    wgmma B operands (K-major, 8x8 core matrices, no swizzle; 16-byte loads
//    transposed in registers) while the producer fills its first tiles: the
//    first layer [w_et; w_rbf] of each half (96 x 128), w2k (128 x 128), w2v
//    (128 x 16).
//  * The rows [row0, N) of every complex are dealt round-robin to the
//    grid's consumers; a consumer takes its rows' live chunks two at a time
//    as 64-slot tiles (two rows, or two chunks of one row at K > 32). Its
//    two producer warps, alternating tiles, copy x to out for a row without
//    a live chunk and fill a two-stage ring per consumer on mbarriers: per
//    slot its source, e_w, validity and rel = x_dst - x_src (float32, 0 in
//    invalid slots), the tile's A operand [one-hot type | type x RBF | 0]
//    in bf16 (64 x 96), each chunk's ni and q rows (cp.async).
//  * A consumer warpgroup runs the k half (the first layer as 6 wgmma
//    m64n128k16, ni + nj added in the accumulator's layout, LayerNorm +
//    ReLU on the registers rounded to bf16 A fragments, 8 wgmma m64n128k16
//    for the second layer + b2k, the logits and per warp of 16 slots each
//    head's max, exp-sum and pw = e_w exp(l - max)), then the v half (the
//    same first layer and LayerNorm; the second layer as 8 wgmma m64n16k16
//    with A from registers + b2v), and per warp and head sum_slots pw v rel
//    as a 3-vector, reduce-scattered over the warp in a fixed order.
//  * One named barrier a tile; then warp 0 (lane h and h + 16: head h)
//    merges the four warp partials in slot order into the row's running
//    state (max, denominator, 3-vector: an online softmax across a row's
//    tiles, any K <= kMaxLayerK) and at the row's last chunk writes
//    x + mask (1/16) sum_h S_h / D_h.
//  * A consumer takes both halves of its tiles. The other deal, the two
//    consumers of a block on the k and the v half of one tile at once
//    (h2x_bf16_variants.py `paired`), is faster at B=4 and slower at B=100.
// Every sum runs in a fixed order and no atomic decides one: two launches
// give the same bits. A barrier wait that does not end traps (the launch
// fails) instead of hanging the card.
#pragma once

#include "edge_mma.cuh"

namespace {

constexpr int kH2xConsumers = 2;             // consumer warpgroups per block
constexpr int kH2xStages = 2;                // ring stages per consumer
constexpr int kH2xMmaThreads = 128 * (kH2xConsumers + 1);
constexpr int kH2xStagers = 128 * kH2xConsumers;  // the consumers stage the tables
constexpr int kH2xStagedBar = 1 + kH2xConsumers;  // their named barrier once staged
constexpr int kH2xFeeders = 4 / kH2xConsumers;  // producer warps per consumer, alternating tiles
// the producer writes each slot's 20 RBF features: at x2h's 56 registers it
// spilled 608 bytes, at 128 nothing spills (PERF.md §6)
constexpr int kH2xProducerRegs = 128, kH2xConsumerRegs = 184;
static_assert(kH2xConsumers * 128 * kH2xConsumerRegs + 128 * kH2xProducerRegs <= 65536,
              "the register split fits the SM");
// each producer warp owns the stages of its tiles: an mbarrier's parity tells
// only two consecutive phases apart
static_assert(kH2xStages % kH2xFeeders == 0, "a consumer's stages are dealt to its producer warps");

// One ring stage: a tile's first-layer A operand and its slots.
struct H2xTile {
  static constexpr bool kRel = true;
  alignas(128) unsigned char a[kMmaTile * kT1K * 2];  // bf16, kmajor_off(slot, feature, kSboT1)
  int src[kMmaTile];                                   // source node b*N + j; -1 invalid
  float ew[kMmaTile];                                  // e_w; 0 invalid
  float rel[kMmaTile][3];                              // x_dst - x_src; 0 invalid
  float ni[2][H2];                                     // each chunk's row: ni (k|v) and q
  float q[2][H];
  long long row[2];                                    // each chunk's destination row; -1 none
  unsigned valid[2];                                   // each chunk's valid slots
  int first[2], last[2];                               // the chunk is its row's first / last
};

struct H2xMmaSmem {
  alignas(128) unsigned char w2k[H * H * 2];       // k second layer, B[n][k] = w2k[k][n]
  alignas(128) unsigned char w2v[NH * H * 2];      // v second layer, B[n][k] = w2v[k][n]
  alignas(128) unsigned char t1[2][H * kT1K * 2];  // k|v first-layer table, B[n][k]
  H2xTile tile[kH2xConsumers][kH2xStages];
  float pw[kH2xConsumers][4][16][NH];              // e_w * exp(logit - warp max), per warp
  float xm[kH2xConsumers][2][4][NH];               // warp partials, double-buffered by tile:
  float xs[kH2xConsumers][2][4][NH];               //   max, exp-sum,
  float xv[kH2xConsumers][2][4][NH][3];            //   sum of pw v rel
  float ln[2][H2];                                 // kv_ln: scale, bias of k|v
  float b2k[H], b2v[NH];                           // second-layer biases
  unsigned long long full[kH2xConsumers][kH2xStages], empty[kH2xConsumers][kH2xStages];
};

// The layer's tables as wgmma B operands (edge_mma.cuh), the LayerNorm and
// the biases, by the consumers' threads t of kH2xStagers.
__device__ __forceinline__ void stage_h2x_tables(H2xMmaSmem& s, const PassParams& p, int t) {
  stage_edge_tables(s.t1, s.w2k, s.w2v, NH, p, t, kH2xStagers);
  for (int c = t; c < 2 * H2; c += kH2xStagers) s.ln[c / H2][c % H2] = p.kv_ln[c];
  for (int c = t; c < H; c += kH2xStagers) s.b2k[c] = p.b2k[c];
  for (int c = t; c < NH; c += kH2xStagers) s.b2v[c] = p.b2v[c];
}

// Producer warp pw (0..3) of the block: it feeds consumer pw / kH2xFeeders
// the tiles j with j % kH2xFeeders == pw % kH2xFeeders, into ring stage j %
// kH2xStages. A consumer's producer warps walk the same rows u of [0, B (N -
// row0)) (node u / (N - row0) N + row0 + u % (N - row0)); the first copies x
// to out for rows without a live chunk. The tile after the last is an end
// marker (no chunk).
__device__ __forceinline__ void h2x_producer(H2xMmaSmem& s, const EdgeInputs& in,
                                             const float* __restrict__ qn, int B, int N, int K,
                                             int row0, float* __restrict__ out, int pw, int lane) {
  const int c = pw / kH2xFeeders, q = pw % kH2xFeeders;
  if (c >= kH2xConsumers) return;
  const int nd = N - row0;
  const auto node = [=](long long u) { return u / nd * N + row0 + u % nd; };
  const auto dead = [&](long long bn) {  // x to out for a row without a live chunk
    if (q == 0 && lane < 3) out[3 * bn + lane] = in.x[3 * bn + lane];
  };
  ChunkWalk<decltype(node)> walk{in.nmask, node, (long long)B * nd,
                                 (long long)kH2xConsumers * gridDim.x,
                                 (long long)kH2xConsumers * blockIdx.x + c, K, lane};
  walk.start(dead);
  for (int j = 0;; ++j) {
    const LiveChunk a = walk.next(dead), b = walk.next(dead);
    if (j % kH2xFeeders != q) {
      if (a.row < 0) break;
      continue;
    }
    const int st = j % kH2xStages;
    fill_tile(s.tile[c][st], in, qn, N, K, a, b, &s.empty[c][st], ((j / kH2xStages) & 1) ^ 1,
              &s.full[c][st], lane);
    if (a.row < 0) break;  // the end marker
  }
}

// The v half's sums over the warp's 16 slots (rows m0, m0 + 8: v their 16
// values, b2v not yet added; pw their e_w exp(l - max); rel their rel) of
// pw v rel per head: the thread's 12 (head, coordinate) sums of heads 8 nt
// + 2 tig + jj reduce-scattered over the 8 row groups into xv[head][0..2].
__device__ __forceinline__ void value_partials(const float (&v)[8], const float* b2v,
                                               const float (*pw)[NH], const float (&rel)[2][3],
                                               float (*xv)[3], int lane) {
  const int g = lane >> 2, tig = lane & 3;
  float f[12];  // f[3 i + cc]: head 8 (i >> 1) + 2 tig + (i & 1), coordinate cc
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nt = i >> 1, jj = i & 1, hh = 8 * nt + 2 * tig + jj;
    const float bias = b2v[hh];
    const float w0 = pw[g][hh] * (v[4 * nt + jj] + bias);
    const float w1 = pw[g + 8][hh] * (v[4 * nt + 2 + jj] + bias);
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) f[3 * i + cc] = fmaf(w0, rel[0][cc], w1 * rel[1][cc]);
  }
  const bool b16 = (lane & 16) != 0, b8 = (lane & 8) != 0;
  float p1[6], p2[3];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float keep = b16 ? f[k + 6] : f[k], send = b16 ? f[k] : f[k + 6];
    p1[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float keep = b8 ? p1[k + 3] : p1[k], send = b8 ? p1[k] : p1[k + 3];
    p2[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) p2[k] += __shfl_xor_sync(0xffffffffu, p2[k], 4);
  if ((lane & 4) == 0) {  // f[3 i ..], i = 2 b16 + b8
    const int i = (b16 ? 2 : 0) + (b8 ? 1 : 0), hh = 8 * (i >> 1) + 2 * tig + (i & 1);
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) xv[hh][cc] = p2[cc];
  }
}

// Consumer warpgroup c (thread wt of 128): the tiles of its rows, in order.
__device__ __forceinline__ void h2x_consumer(H2xMmaSmem& s, const EdgeInputs& in,
                                             float* __restrict__ out, int c, int wt) {
  const int w = wt >> 5, lane = wt & 31, g = lane >> 2, tig = lane & 3;
  const int pos = w >> 1;      // the chunk of the warp's 16 slots
  const int m0 = 16 * w + g;   // the thread's slots m0 and m0 + 8 (accumulator rows)
  const int hh = lane & (NH - 1);  // the merge's head (warp 0)
  // warp 0's running state of head hh: max, denominator, 3-vector sum
  float m_run = -INFINITY, d_run = 0.f, o_run[3] = {0.f, 0.f, 0.f};
  float acc[64];
  for (int j = 0;; ++j) {
    const int st = j % kH2xStages, buf = j & 1;
    H2xTile& T = s.tile[c][st];
    mbar_wait(&s.full[c][st], (j / kH2xStages) & 1);
    const long long rows[2] = {T.row[0], T.row[1]};
    if (rows[0] < 0) break;
    const int first[2] = {T.first[0], T.first[1]}, last[2] = {T.last[0], T.last[1]};
    const long long crow = rows[pos];
    const unsigned vmask = T.valid[pos];
    const int src[2] = {T.src[m0], T.src[m0 + 8]};
    const float ew[2] = {T.ew[m0], T.ew[m0 + 8]};
    const bool valid[2] = {((vmask >> (m0 & 31)) & 1u) != 0, ((vmask >> ((m0 + 8) & 31)) & 1u) != 0};
    float rel[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) rel[r][cc] = T.rel[m0 + 8 * r][cc];
    const uint64_t da = mma_desc(T.a, kSboT1);
    float2 ns[2][H / 8];  // the half's ni + nj of rows m0, m0 + 8
    uint32_t fr[H / 16][4];

    // the k half: first layer, meanwhile ni + nj; LayerNorm + ReLU
    first_layer_mma(acc, da, s.t1[0]);
    node_sums(ns, in, crow < 0 ? nullptr : T.ni[pos], src, 0, tig);
    wgmma_wait0();
    fence_acc(acc);
    add_node_sums(acc, ns);
    ln_relu_frags(fr, acc, s.ln, 0, tig);
    {
      // second layer, A from registers, meanwhile q; + b2k; softmax partials
      const uint64_t db = mma_desc(s.w2k, kSboW2);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) wgmma_rs(acc, fr[ks], desc_ks(db, ks), ks);
      wgmma_commit();
      float2 qv[NH];  // q of the chunk's row, the thread's columns 8 nt + 2 tig (+1)
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
        qv[nt] = crow < 0 ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(&T.q[pos][8 * nt + 2 * tig]);
      wgmma_wait0();
      fence_acc(acc);
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(&s.b2k[8 * nt + 2 * tig]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * nt + 2 * r] += bias.x;
          acc[4 * nt + 2 * r + 1] += bias.y;
        }
      }
      softmax_partials(acc, qv, valid, ew, s.pw[c][w], s.xm[c][buf][w], s.xs[c][buf][w], g, tig);
    }

    // the v half: first layer, meanwhile ni + nj; LayerNorm + ReLU; the 16
    // wide second layer; the warp's sums of pw v rel
    first_layer_mma(acc, da, s.t1[1]);
    node_sums(ns, in, crow < 0 ? nullptr : T.ni[pos], src, 1, tig);
    wgmma_wait0();
    fence_acc(acc);
    mbar_arrive(&s.empty[c][st]);  // the tile's A operand and slots are read
    add_node_sums(acc, ns);
    ln_relu_frags(fr, acc, s.ln, 1, tig);
    {
      float v[8];
      const uint64_t db = mma_desc(s.w2v, kSboW2);
      fence_acc(v);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) wgmma_rs16(v, fr[ks], desc_ks(db, ks), ks);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(v);
      __syncwarp();  // pw of the warp's slots
      value_partials(v, s.b2v, s.pw[c][w], rel, s.xv[c][buf][w], lane);
    }

    // warp 0 merges the four warp partials in slot order into the row
    // state; a row's last chunk writes out = x + mask (1/16) sum_h S_h / D_h
    asm volatile("bar.sync %0, %1;" ::"r"(1 + c), "r"(128) : "memory");
    if (w != 0) continue;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (rows[p] < 0) continue;
      if (first[p]) {
        m_run = -INFINITY;
        d_run = 0.f;
        o_run[0] = o_run[1] = o_run[2] = 0.f;
      }
#pragma unroll
      for (int ww = 2 * p; ww < 2 * p + 2; ++ww) {
        const float mw = s.xm[c][buf][ww][hh];
        if (mw == -INFINITY) continue;  // no valid slot among the warp's 16
        const float mn = fmaxf(m_run, mw), a = expf(m_run - mn), b = expf(mw - mn);
        d_run = fmaf(d_run, a, s.xs[c][buf][ww][hh] * b);
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) o_run[cc] = fmaf(o_run[cc], a, s.xv[c][buf][ww][hh][cc] * b);
        m_run = mn;
      }
      if (last[p]) {
        const float inv = 1.f / fmaxf(d_run, 1e-16f);
        float dx[3];
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          dx[cc] = o_run[cc] * inv;
#pragma unroll
          for (int off = NH / 2; off > 0; off >>= 1)
            dx[cc] += __shfl_xor_sync(0xffffffffu, dx[cc], off);
        }
        if (lane == 0) {
          const long long bn = rows[p];
          const float gate = in.mlig[bn] ? 1.f : 0.f;
#pragma unroll
          for (int cc = 0; cc < 3; ++cc)
            out[3 * bn + cc] = in.x[3 * bn + cc] + gate * (dx[cc] * (1.f / NH));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kH2xMmaThreads, 1)
h2x_edge_mma_kernel(EdgeInputs in, const float* __restrict__ qn, PassParams p, int B, int N,
                    int K, int row0, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char h2x_mma_smem_raw[];
  H2xMmaSmem& s = *reinterpret_cast<H2xMmaSmem*>(h2x_mma_smem_raw);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int c = 0; c < kH2xConsumers; ++c)
      for (int st = 0; st < kH2xStages; ++st) {
        mbar_init(&s.full[c][st], 1);
        mbar_init(&s.empty[c][st], 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // warpgroups 0 .. kH2xConsumers - 1 consume, the last produces; the two
  // paths do not meet again. The producer fills its first tiles while the
  // consumers stage the tables.
  const int wg = t >> 7;
  if (wg == kH2xConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kH2xProducerRegs));
    h2x_producer(s, in, qn, B, N, K, row0, out, (t & 127) >> 5, t & 31);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kH2xConsumerRegs));
    stage_h2x_tables(s, p, t);
    fence_proxy_async();  // the staged tables, for the products
    asm volatile("bar.sync %0, %1;" ::"r"(kH2xStagedBar), "r"(kH2xStagers) : "memory");
    h2x_consumer(s, in, out, wg, t & 127);
  }
}

// The rows [row0, N) of each complex of out = h2x(x) with bf16 products,
// for any K <= kMaxLayerK.
int launch_h2x_mma(const EdgeInputs& in, const float* q, const PassParams& p, int B, int N, int K,
                   int row0, float* out, cudaStream_t s) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxLayerK || row0 < 0 || row0 >= N)
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (int err = sm_count(h2x_edge_mma_kernel, (int)sizeof(H2xMmaSmem), n_sm)) return err;
  const long long units = ((long long)B * (N - row0) + kH2xConsumers - 1) / kH2xConsumers;
  const int grid = (int)(units < n_sm ? units : n_sm);
  h2x_edge_mma_kernel<<<grid, kH2xMmaThreads, sizeof(H2xMmaSmem), s>>>(in, q, p, B, N, K, row0,
                                                                        out);
  return (int)cudaGetLastError();
}

}  // namespace
