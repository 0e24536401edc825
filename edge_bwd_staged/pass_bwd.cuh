// A design of the training backward's pass that was measured and not taken:
// targetdiff_tpu_torch/csrc/pass_bwd.cuh with edge_bwd_kernel's second layers
// staged once per cluster of blocks in shared memory. edge_bwd_variants.py
// `staged_cluster8` builds a copy of the package with this file and
// block_common.cuh in place of the package's and times it beside the
// package's kernel (PERF.md §6 gives the result: slower).
//
// edge_bwd_kernel here: persistent blocks of 256 threads (thread t on k|v
// channel t) in clusters of eight, two blocks per SM at K <= 32, each taking
// its next destination row from an atomic counter, one row at a time. The
// cluster stages the pass's second layers once: block r holds k-step r of
// w2k and w2v as the products' fp16 (hi, lo) mma B fragments (stage_frags'
// split) and rows [C r / 8, + C / 8) of their float32 transposes for the
// transposed products; the other blocks read them through distributed
// shared memory. To leave room for that share and two rows per SM, a row
// keeps only its normalised first layer (the activations are formed where
// they are read), the transposed products write d a in place of d k|d v,
// and d rbf's partials are summed half of the warps at a time. Every sum
// keeps the package kernel's order: the outputs are bitwise equal to it.
#pragma once

#include <cooperative_groups.h>

#include "block_common.cuh"
#include "node_bwd.cuh"
#include "node_proj.cuh"
#include "tc_common.cuh"
#include "weight_grad.cuh"

// Gradient outputs of one layer's pass, laid out as PassParams; tab is the
// [4R + 4][2H] table of w_rbf ([4][R][2H]) followed by w_et ([4][2H]).
struct PassGrads {
  float* w_node;
  float* b_node;
  float* q_ln;
  float* w_q2;
  float* b_q2;
  float* tab;
  float* kv_ln;
  float* w2k;
  float* b2k;
  float* w2v;
  float* b2v;
};

// Transposed copies of one layer's pass weights (the last two unused here).
struct PassT {
  const float* w_nodeT;  // [5H][H]
  const float* w_q2T;    // [H][H]
  const float* w2kT;     // [H][H]
  const float* w2vT;     // [V][H]
};

// Dynamic shared memory of edge_bwd_kernel (bwd_smem).
extern __shared__ __align__(16) float td_edge_bwd_smem[];

namespace {

constexpr int FE = 4 * R + 4;   // edge-feature row: rbf x type | type
constexpr int kAdjMaxN = 4096;  // nodes per complex for adj_kernel
constexpr int kSmemPerBlock = 232448;  // shared memory one block may take (sm_90)
constexpr int kSmemPerSM = 233472;     // shared memory of one SM, 1 KB of it reserved per block
constexpr int kBwdCluster = 8;  // blocks of edge_bwd_kernel sharing one staged copy
constexpr int kBlockKSteps = kKSteps / kBwdCluster;  // k-steps of the second layers per block
constexpr int kLdt = H + 8;     // padded float32 row of a staged W2^T: conflict-free loads
constexpr int kLdc = H2 + 8;    // padded row of the products' k|v output: conflict-free C stores
constexpr int kLdd = H2 + 4;    // padded row of dk|dv and dz: conflict-free TF32 A fragments
// floats of edge_bwd_kernel's chunk buffer: the recompute's split activations
// [2][KC][kLdz], then its output k|v [KC][kLdc]; dk|dv, da, dz [KC][kLdd]
constexpr int kChunkBuf = 2 * KC * kLdz;
static_assert(kChunkBuf >= KC * kLdc && kChunkBuf >= KC * kLdd, "chunk buffer too small");
// The d rbf product D [KC][kDrbfCols] = dz [KC][2H] [W_ta | W_ta+2]: 32 k-steps
// of m16n8k8, 5 n-tiles; its staged B fragments, both destination kinds
constexpr int kDrbfCols = 2 * R;
constexpr int kDrbfKSteps = H2 / 8;
constexpr int kDrbfNTiles = kDrbfCols / 8;
constexpr int kRbfFrags = 2 * kDrbfKSteps * kDrbfNTiles * 32;
constexpr int kWarps = kThreads / 32;
static_assert(kDrbfCols % 8 == 0 && kDrbfKSteps % kWarps == 0, "d rbf tiling");
static_assert(kWarps / 2 * KC * kDrbfCols <= KC * H2, "half the d rbf partials exceed zh");
static_assert(kKSteps % kBwdCluster == 0, "a block stages whole k-steps");

// Row-buffer layout of one pass (V = value width): per node
// [dproj 5H | kv_ln scale 2H, bias 2H | b2k H, b2v V | dq H | q_ln scale H, bias H].
__host__ __device__ constexpr int off_kvln() { return H5; }
__host__ __device__ constexpr int off_db2() { return H5 + 2 * H2; }
__host__ __device__ constexpr int off_dq(int V) { return off_db2() + H + V; }
__host__ __device__ constexpr int off_qln(int V) { return off_dq(V) + H; }
__host__ __device__ constexpr int row_width(int V) { return off_qln(V) + 2 * H; }

struct EdgeBwdArgs {
  const float* h;  // [B*N][H] the pass's input h
  EdgeInputs in;   // x = the pass's input x
  const float* q;  // [B*N][H]
  PassParams p;
  int B, N, K, row0;
  const float* dh;  // [B*N][H] x2h: cotangent of the pass output
  float* dx;        // [B*N][3] in place: h2x reads it as the cotangent
  float* dew;       // [B*N][K] accumulated
  float* rowbuf;    // [B*N][row_width(V)]
  float* A;         // [Ep][2H] post-LN k|v activations
  float* dKV;       // [Ep][H + V] gradients of k|v
  float* dZ;        // [Ep][2H] gradients of the first layer's output
  float* F;         // [Ep][FE] edge-feature rows
  float* drel;      // [Ep][3]
  const uint4* rbff;  // w_rbf as staged by stage_rbf_kernel
  int* next;          // the next row to take
};

// What edge_bwd_kernel keeps of the chunk beside its buffers.
struct BwdChunk {
  EdgeGeometry g;
  float rstd[KC][2];
  float drbf[KC][R];
  float drel[KC][3];
  float gx[3];  // h2x: mask_ligand * d x_out of this row
  float dx[3];  // the row's d x with the chunks' d rel added
  float dot[NH];
};

// Floats of a block's share of the staged second layers (V = H or NH): its
// k-steps of w2k and w2v as mma B fragments, [kBlockKSteps][H / 8][32] and
// [kBlockKSteps][V / 8][32] uint4, then its rows of w2k^T [H / kBwdCluster]
// [kLdt] and of w2v^T [V / kBwdCluster][kLdt].
__host__ __device__ constexpr int w2_floats(bool h2x) {
  return 4 * 32 * kBlockKSteps * (H + (h2x ? NH : H)) / 8 +
         (H + (h2x ? NH : H)) / kBwdCluster * kLdt;
}

// Dynamic shared memory of edge_bwd_kernel: the block's share of the
// second layers, the normalised first layer [KC][2H], the chunk buffer, the
// chunk's BwdChunk and per edge of the row alpha and P (and, for h2x, v)
// [KP][NH], e_w and the h2x gate [KP], KP = K rounded up to chunks.
__host__ __device__ constexpr int bwd_smem(int K, bool h2x) {
  return (int)sizeof(float) * (w2_floats(h2x) + KC * H2 + kChunkBuf +
                               (K + KC - 1) / KC * KC * (NH * (h2x ? 3 : 2) + 2)) +
         (int)sizeof(BwdChunk);
}
static_assert(bwd_smem(kMaxLayerK, false) <= kSmemPerBlock, "edge_bwd_kernel too large");
static_assert(2 * (bwd_smem(kMaxBlockK, false) + 1024) <= kSmemPerSM,
              "two blocks per SM at the whole-block backward's K");

// B fragment (b0 hi, b1 hi, b0 lo, b1 lo; TF32, split_tf32) of k-step ks,
// n-tile nt of the d rbf product for one destination kind (ta: 0 ligand, 1
// protein row) and lane: B[k][j] = w_rbf[j < R ? ta : ta + 2][j % R][k],
// b0 = B[8 ks + tig][8 nt + g], b1 = B[8 ks + tig + 4][8 nt + g].
__device__ __forceinline__ uint4 rbf_frag(const float* __restrict__ w_rbf, int ta, int ks,
                                          int nt, int lane) {
  const int j = 8 * nt + (lane >> 2);
  const float* w = w_rbf + ((j < R ? ta : ta + 2) * R + j % R) * H2 + 8 * ks + (lane & 3);
  uint32_t h0, l0, h1, l1;
  split_tf32(w[0], h0, l0);
  split_tf32(w[4], h1, l1);
  return make_uint4(h0, h1, l0, l1);
}

// Both kinds' fragments of w_rbf ([4][R][2H]) in global memory:
// frags[((ta * kDrbfKSteps + ks) * kDrbfNTiles + nt) * 32 + lane].
__global__ void __launch_bounds__(kThreads)
stage_rbf_kernel(const float* __restrict__ w_rbf, uint4* __restrict__ frags) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= kRbfFrags) return;
  const int per_kind = kDrbfKSteps * kDrbfNTiles * 32;
  frags[u] = rbf_frag(w_rbf, u / per_kind, u % per_kind / (kDrbfNTiles * 32),
                      u / 32 % kDrbfNTiles, u % 32);
}

// The d rbf product's B fragment of (ks, nt) for the row's kind ta, as staged.
__device__ __forceinline__ uint4 drbf_frag(const uint4* frags, const float* w_rbf, int ta, int ks,
                                           int nt, int lane) {
  return frags[((ta * kDrbfKSteps + ks) * kDrbfNTiles + nt) * 32 + lane];
}

// d rbf of the chunk's n slots, block-wide: drbf[e][r] = dz[e] . w_rbf[type e][r]
// for e < n. A destination row's edges have two types, ta (ligand source) and
// ta + 2, so the chunk's d rbf is one product D [KC][2R] = dz [KC][2H]
// [W_ta | W_ta+2] (W_t[c][r] = w_rbf[t][r][c]), of which slot e takes the R
// columns of its type. Warp w forms the partial product over k-steps
// [4 w, 4 w + 4) (channels 32 w ..) of both 16-row m-tiles (the second only
// when n > 16) and all five n-tiles: three TF32 mma.sync per term (dz is a
// gradient: no range to scale into fp16), each k-step's three summed from zero
// and added in float32 (as weight_grad.cuh). The partials are summed in warp
// order, a fixed order, half of the warps' at a time through red [kWarps /
// 2][KC][2R] (the free zh buffer). dz: the chunk buffer, row stride kLdd.
// Starts at a barrier (red aliases what the block read before) and ends at
// one.
__device__ __forceinline__ void drbf_chunk(float (*drbf)[R], float* red, const float (*dz)[kLdd],
                                           const uint4* frags, const float* w_rbf,
                                           const int* et, int ta, int n, int t) {
  constexpr int kSteps = kDrbfKSteps / kWarps;
  constexpr int kHalf = kWarps / 2;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  const int mts = n > 16 ? 2 : 1;
  __syncthreads();
  float acc[2][kDrbfNTiles][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDrbfNTiles; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  // one k-step at a time: unrolled, the B fragments in flight spilled (PERF.md)
#pragma unroll 1
  for (int i = 0; i < kSteps; ++i) {
    const int ks = warp * kSteps + i;
    uint4 b[kDrbfNTiles];
#pragma unroll
    for (int nt = 0; nt < kDrbfNTiles; ++nt) b[nt] = drbf_frag(frags, w_rbf, ta, ks, nt, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= mts) continue;
      // A: (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)
      const float* ar = &dz[16 * mt + g][8 * ks + tig];
      uint32_t ah[4], al[4];
      split_tf32(ar[0], ah[0], al[0]);
      split_tf32(ar[8 * kLdd], ah[1], al[1]);
      split_tf32(ar[4], ah[2], al[2]);
      split_tf32(ar[8 * kLdd + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < kDrbfNTiles; ++nt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, al, b[nt].x, b[nt].y);
        mma_tf32(d, ah, b[nt].z, b[nt].w);
        mma_tf32(d, ah, b[nt].x, b[nt].y);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += d[c];
      }
    }
  }
#pragma unroll 1
  for (int round = 0; round < 2; ++round) {
    if (warp / kHalf == round) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= mts) continue;
#pragma unroll
        for (int nt = 0; nt < kDrbfNTiles; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(red + ((warp % kHalf) * KC + 16 * mt + 8 * hf + g) *
                                                 kDrbfCols + 8 * nt + 2 * tig) =
                make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
    }
    __syncthreads();
    for (int u = t; u < n * R; u += kThreads) {
      const int e = u / R, r = u % R;
      const float* col = red + e * kDrbfCols + (et[e] == ta ? 0 : R) + r;
      float s = round ? drbf[e][r] : 0.f;
#pragma unroll
      for (int w = 0; w < kHalf; ++w) s += col[w * KC * kDrbfCols];
      drbf[e][r] = s;
    }
    __syncthreads();
  }
}

// The second layers as a cluster stages them: block r holds k-steps
// [kBlockKSteps r, + kBlockKSteps) of w2k and w2v as the products' fp16
// (hi, lo) B fragments times kWScale (stage_frags' split), and rows [C r /
// kBwdCluster, + C / kBwdCluster) of their float32 transposes for the
// backward's transposed products, read by the other blocks through
// distributed shared memory.
// A block's k-steps of the 128-deep weight W (leading dimension ldw, first
// row its first k-step's) times kWScale as mma B fragments, as stage_frags
// stages all of them: dst[(ks * ntiles + nt) * 32 + lane].
__device__ __forceinline__ void stage_block_frags(uint4* dst, const float* __restrict__ W, int ldw,
                                                  int ntiles, int t) {
  for (int u = t; u < kBlockKSteps * ntiles * 32; u += kThreads) {
    const int ks = u / (ntiles * 32), nt = u / 32 % ntiles, fl = u % 32;
    const float* w = W + (16 * ks + 2 * (fl & 3)) * ldw + 8 * nt + (fl >> 2);
    __half hi[4], lo[4];  // rows 0, 1, 8, 9 of the k-step (from 2 tig)
#pragma unroll
    for (int f = 0; f < 4; ++f) split_f16(kWScale * w[((f & 1) + 8 * (f >> 1)) * ldw], hi[f], lo[f]);
    dst[u] = make_uint4(f16_pair(hi[0], hi[1]), f16_pair(hi[2], hi[3]), f16_pair(lo[0], lo[1]),
                        f16_pair(lo[2], lo[3]));
  }
}

template <int V>
struct StagedW2 {
  static constexpr int kFv = 4 * 32 * kBlockKSteps * H / 8;  // floats before each share
  static constexpr int kTk = kFv + 4 * 32 * kBlockKSteps * V / 8;
  static constexpr int kTv = kTk + H / kBwdCluster * kLdt;
  // this block's share: w2k's and w2v's fragments, rows of w2k^T and w2v^T
  static __device__ __forceinline__ uint4* fk() {
    return reinterpret_cast<uint4*>(td_edge_bwd_smem);
  }
  static __device__ __forceinline__ uint4* fv() {
    return reinterpret_cast<uint4*>(td_edge_bwd_smem + kFv);
  }
  static __device__ __forceinline__ float* tk() { return td_edge_bwd_smem + kTk; }
  static __device__ __forceinline__ float* tv() { return td_edge_bwd_smem + kTv; }
  // the lane's B fragments of k-step ks, n-tile nt at [nt * 32]
  static __device__ __forceinline__ const uint4* k_frags(int ks, int lane) {
    return cooperative_groups::this_cluster().map_shared_rank(fk(), ks / kBlockKSteps) +
           ks % kBlockKSteps * kNTiles * 32 + lane;
  }
  static __device__ __forceinline__ const uint4* v_frags(int ks, int lane) {
    return cooperative_groups::this_cluster().map_shared_rank(fv(), ks / kBlockKSteps) +
           ks % kBlockKSteps * (V / 8) * 32 + lane;
  }
  // row c (output channel c) of w2k^T, of w2v^T
  static __device__ __forceinline__ const float* tk_row(int c) {
    constexpr int rows = H / kBwdCluster;
    return cooperative_groups::this_cluster().map_shared_rank(tk(), c / rows) + c % rows * kLdt;
  }
  static __device__ __forceinline__ const float* tv_row(int c) {
    constexpr int rows = V / kBwdCluster;
    return cooperative_groups::this_cluster().map_shared_rank(tv(), c / rows) + c % rows * kLdt;
  }
};

// The chunk's second layers on the tensor cores, block-wide, ending at a
// barrier: out[e][half H + cc] = b[cc] + sum_m a[e][half H + m] W[m][cc] for
// every slot e and the halves below `halves` (1: k only, 2: k and v), written
// to buf [KC][kLdc] (k: columns [0, H), v: [H, H + V)). The activations a =
// relu(zh * scale + bias) of the n live slots (0 past them) go to buf as fp16
// (hi, lo) column pairs (row stride kLdz) first. Warp w runs the 32 x 32 tile
// of half w / 4, channels 32 (w % 4) .. (h2x's 16-wide v: warp 4 alone, two
// n-tiles), three fp16 products per term as the forward kernels compute k and
// v, on the cluster's staged fragments. Every sum has a fixed order.
template <int V>
__device__ __forceinline__ void second_layers(const float (*zh)[H2], float* buf,
                                              const PassParams& p, int n, int halves, int t) {
  constexpr int kVT = V < 32 ? V / 8 : 4;  // n-tiles of a v warp's tile
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  for (int pr = warp; pr < halves * KC; pr += kWarps) {  // (half, slot) rows
    const int half = pr / KC, e = pr % KC;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cl = half * H + lane + 32 * q;
      v[q] = e < n ? ln_out(zh[e][cl], p.kv_ln, cl) : 0.f;
    }
    store_split_row(reinterpret_cast<uint32_t*>(buf + pr * kLdz), v, lane);
  }
  __syncthreads();
  const int half = warp >> 2, qd = warp & 3;
  const bool mine = half < halves && 32 * qd < (half ? V : H);
  const int nts = half ? kVT : 4;
  float acc[2][4][4];
  if (mine) {
    const float* bias = (half ? p.b2v : p.b2k) + 32 * qd + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nts) continue;
      const float b0 = kWScale * bias[8 * nt], b1 = kWScale * bias[8 * nt + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][nt][0] = acc[mt][nt][2] = b0;
        acc[mt][nt][1] = acc[mt][nt][3] = b1;
      }
    }
    const float* as = buf + half * KC * kLdz;
#pragma unroll 2
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t ahi[2][4], alo[2][4];  // a0..a3: rows g, g + 8 x columns 2 tig, 2 tig + 8
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint2 pr = *reinterpret_cast<const uint2*>(
              as + (16 * mt + g + 8 * (f & 1)) * kLdz + 16 * ks + 2 * tig + 8 * (f >> 1));
          ahi[mt][f] = pr.x;
          alo[mt][f] = pr.y;
        }
      const uint4* wf = (half ? StagedW2<V>::v_frags(ks, lane) : StagedW2<V>::k_frags(ks, lane)) +
                        4 * qd * 32;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= nts) continue;
        const uint4 f = wf[nt * 32];  // (b0 hi, b1 hi, b0 lo, b1 lo)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_f16(acc[mt][nt], alo[mt], f.x, f.y);
          mma_f16(acc[mt][nt], ahi[mt], f.z, f.w);
          mma_f16(acc[mt][nt], ahi[mt], f.x, f.y);
        }
      }
    }
  }
  __syncthreads();  // every tile has read the split activations
  if (mine) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nts) continue;
      const int col = half * H + 32 * qd + 8 * nt + 2 * tig;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(buf + (16 * mt + 8 * hf + g) * kLdc + col) =
              make_float2(acc[mt][nt][2 * hf] * (1.f / kWScale),
                          acc[mt][nt][2 * hf + 1] * (1.f / kWScale));
    }
  }
  __syncthreads();
}

template <bool kH2X>
__global__ void __cluster_dims__(kBwdCluster, 1, 1) __launch_bounds__(kThreads, 2)
edge_bwd_kernel(EdgeBwdArgs a) {
  constexpr int V = kH2X ? NH : H;
  constexpr int W = row_width(V);
  const int N = a.N, K = a.K, row0 = a.row0;
  const int nchunk = (K + KC - 1) / KC, KP = nchunk * KC;
  const PassParams& p = a.p;
  float* smem = td_edge_bwd_smem;
  float(*s_zh)[H2] = reinterpret_cast<float(*)[H2]>(smem + w2_floats(kH2X));  // zh; d rbf partials
  float* s_buf = smem + w2_floats(kH2X) + KC * H2;              // second_layers' operands, k|v
  float(*s_d)[kLdd] = reinterpret_cast<float(*)[kLdd]>(s_buf);  // dk|dv, then da, then dz
  BwdChunk& s = *reinterpret_cast<BwdChunk*>(s_buf + kChunkBuf);
  float(*s_alpha)[NH] = reinterpret_cast<float(*)[NH]>(&s + 1);  // logits, alpha
  float(*s_P)[NH] = s_alpha + KP;  // d alpha = e_w * P, d e_w = sum_h alpha P
  float(*s_v)[NH] = s_P + KP;      // h2x: the values
  float* s_w = reinterpret_cast<float*>(s_P + KP) + (kH2X ? KP * NH : 0);  // e_w
  float* s_sdir = s_w + KP;        // h2x: s_e = mean_h(alpha e_w v)

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const bool is_k = t < H;
  const int cc = is_k ? t : t - H;
  // this block's share of both second layers (StagedW2)
  using W2 = StagedW2<V>;
  {
    const int rank = (int)cooperative_groups::this_cluster().block_rank();
    const int ks0 = kBlockKSteps * rank;
    stage_block_frags(W2::fk(), p.w2k + 16 * ks0 * H, H, kNTiles, t);
    stage_block_frags(W2::fv(), p.w2v + 16 * ks0 * V, V, V / 8, t);
    for (int u = t; u < H / kBwdCluster * H; u += kThreads) {  // w2k^T[c][m] = w2k[m][c]
      const int c = u / H, m = u % H;
      W2::tk()[c * kLdt + m] = p.w2k[m * H + H / kBwdCluster * rank + c];
    }
    for (int u = t; u < V / kBwdCluster * H; u += kThreads) {
      const int c = u / H, m = u % H;
      W2::tv()[c * kLdt + m] = p.w2v[m * V + V / kBwdCluster * rank + c];
    }
    cooperative_groups::this_cluster().sync();  // every share is staged
  }

  const int rows = a.B * (N - row0);
  __shared__ int s_row;
  for (;;) {
    if (t == 0) s_row = atomicAdd(a.next, 1);
    __syncthreads();
    const int row = s_row;
    if (row >= rows) break;
    const int b = row / (N - row0);
    const int bn = b * N + row0 + row % (N - row0);
    const long long eb = (long long)row * K;  // first pass-local edge of the row
    // the row's inputs and the values it adds to, loaded before its first
    // barrier
    const float qc = is_k ? a.q[(long long)bn * H + cc] : 0.f;
    const float gc = (!kH2X && !is_k) ? a.dh[(long long)bn * H + cc] : 0.f;
    const int ta = a.in.mlig[bn] ? 0 : 1;  // the row's edge types: ta, ta + 2
    const float dew0 = t < K ? a.dew[(long long)bn * K + t] : 0.f;
    if (t < 3) {
      const float dx0 = a.dx[3 * bn + t];
      s.dx[t] = dx0;
      if (kH2X) s.gx[t] = ta == 0 ? dx0 : 0.f;
    }

    // ---- pass 1: logits and P of every edge (h2x: and v) ----
    bool live0 = false, any = false;
    float acc[KC];
    for (int ch = 0; ch < nchunk; ++ch) {
      const int e0 = ch * KC;
      const bool live = edge_chunk(s.g, s_zh, s.rstd, a.in, p, b, bn, N, K, e0, t);
      if (ch == 0) live0 = live;
      any |= live;
      if (t < KC) s_w[e0 + t] = s.g.w[t];
      if (live) {
        second_layers<V>(s_zh, s_buf, p, min(KC, K - e0), 2, t);
#pragma unroll
        for (int e = 0; e < KC; ++e) acc[e] = s_buf[e * kLdc + t];
        if (is_k) {
          head_logits(acc, qc, s.g.valid, s_alpha + e0, cc);
        } else if (!kH2X) {  // value channel cc, warps 4-7; heads are 8-lane groups
#pragma unroll
          for (int e = 0; e < KC; ++e) {
            float pv = gc * acc[e];
            pv += __shfl_xor_sync(0xffffffffu, pv, 4);
            pv += __shfl_xor_sync(0xffffffffu, pv, 2);
            pv += __shfl_xor_sync(0xffffffffu, pv, 1);
            if (cc % DH == 0) s_P[e0 + e][cc / DH] = pv;
          }
        } else if (cc < NH) {  // value channels 0..NH-1: lanes 0..NH-1 of warp 4
#pragma unroll
          for (int e = 0; e < KC; ++e) {
            const float ds = (s.gx[0] * s.g.rel[e][0] + s.gx[1] * s.g.rel[e][1] +
                              s.gx[2] * s.g.rel[e][2]) * (1.f / NH);
            s_v[e0 + e][cc] = acc[e];
            s_P[e0 + e][cc] = ds * acc[e];
          }
        }
      } else {
        for (int u = t; u < KC * NH; u += kThreads) {
          const int e = e0 + u / NH, hh = u % NH;
          s_alpha[e][hh] = -INFINITY;
          s_P[e][hh] = 0.f;
          if (kH2X) s_v[e][hh] = 0.f;
        }
      }
      __syncthreads();
    }
    if (!any) {  // no valid edge: zero gradient, zero rows for the products below
      for (long long u = t; u < (long long)K * H2; u += kThreads) {
        a.A[eb * H2 + u] = 0.f;
        a.dZ[eb * H2 + u] = 0.f;
      }
      for (long long u = t; u < (long long)K * (H + V); u += kThreads)
        a.dKV[eb * (H + V) + u] = 0.f;
      for (long long u = t; u < (long long)K * FE; u += kThreads) a.F[eb * FE + u] = 0.f;
      for (long long u = t; u < (long long)K * 3; u += kThreads) a.drel[eb * 3 + u] = 0.f;
      continue;
    }
    row_softmax(s_alpha, K, KP, t);
    __syncthreads();

    // ---- d e_w, the softmax dot per head, h2x gates ----
    if (t < K) {  // K <= kMaxLayerK == kThreads: one edge per thread
      float d = 0.f, sv = 0.f;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        d += s_alpha[t][hh] * s_P[t][hh];
        if (kH2X) sv += s_alpha[t][hh] * s_v[t][hh];
      }
      a.dew[(long long)bn * K + t] = dew0 + d;
      if (kH2X) s_sdir[t] = sv * s_w[t] * (1.f / NH);
    }
    for (int hh = warp; hh < NH; hh += kWarps) {
      float sm = 0.f;
      for (int e = lane; e < K; e += 32) sm += s_alpha[e][hh] * s_w[e] * s_P[e][hh];
      sm = warp_sum(sm);
      if (lane == 0) s.dot[hh] = sm;
    }
    __syncthreads();

    // ---- pass 2: each chunk backward ----
    // The row buffer starts at zero: a row's first live chunk stores 0 plus
    // its sums, later chunks add theirs.
    float* rb = a.rowbuf + (long long)bn * W;
    const float scale = rsqrtf((float)DH);
    float dq = 0.f;
    bool summed = false;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int e0 = ch * KC;
      const int n = min(KC, K - e0);
      const long long ec = eb + e0;  // the chunk's first pass-local edge
      bool live = live0;
      if (nchunk > 1) {
        live = edge_chunk(s.g, s_zh, s.rstd, a.in, p, b, bn, N, K, e0, t);
        if (live) second_layers<V>(s_zh, s_buf, p, n, 1, t);
      }
      if (!live) {  // zero gradient: zero rows for the products below
        for (int u = t; u < n * H2; u += kThreads) {
          a.A[ec * H2 + u] = 0.f;
          a.dZ[ec * H2 + u] = 0.f;
        }
        for (int u = t; u < n * (H + V); u += kThreads) a.dKV[ec * (H + V) + u] = 0.f;
        for (int u = t; u < n * FE; u += kThreads) a.F[ec * FE + u] = 0.f;
        for (int u = t; u < n * 3; u += kThreads) a.drel[ec * 3 + u] = 0.f;
        continue;
      }
      for (int u = t; u < n * H2; u += kThreads)
        a.A[ec * H2 + u] = ln_out(s_zh[u / H2][u % H2], p.kv_ln, u % H2);

      // softmax backward -> dk (and dq); dv. k is second_layers' output,
      // still in the chunk buffer (pass 1's when the row has one chunk): read
      // there, not kept in registers across the passes, so that no register
      // array stays live through the recompute's first layer and d rbf.
      const int head = cc / DH;
      if (is_k) {
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          const float al = s_alpha[e0 + e][head];
          const float dl = al * (s_w[e0 + e] * s_P[e0 + e][head] - s.dot[head]) * scale;
          dq += dl * s_buf[e * kLdc + cc];
        }
      }
      __syncthreads();  // k is read: dk|dv overwrite it
      if (is_k) {
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          const float al = s_alpha[e0 + e][head];
          const float dl = al * (s_w[e0 + e] * s_P[e0 + e][head] - s.dot[head]) * scale;
          s_d[e][cc] = dl * qc;
        }
      } else if (!kH2X) {
#pragma unroll
        for (int e = 0; e < KC; ++e) s_d[e][H + cc] = gc * s_alpha[e0 + e][head] * s_w[e0 + e];
      } else if (cc < NH) {
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          const float ds = (s.gx[0] * s.g.rel[e][0] + s.gx[1] * s.g.rel[e][1] +
                            s.gx[2] * s.g.rel[e][2]) * (1.f / NH);
          s_d[e][H + cc] = ds * s_alpha[e0 + e][cc] * s_w[e0 + e];
        }
      }
      __syncthreads();

      // second layers backward: da = d @ W2^T, in place of dk|dv
      for (int u = t; u < n * (H + V); u += kThreads) {
        const int e = u / (H + V), cl = u % (H + V);
        a.dKV[(ec + e) * (H + V) + cl] = s_d[e][cl];
      }
      if (t < H + V) {
        float sm = 0.f;
        for (int e = 0; e < n; ++e) sm += s_d[e][t];
        rb[off_db2() + t] = (summed ? rb[off_db2() + t] : 0.f) + sm;
      }
      {
        // column cc of W2^T (input channel cc of the second layer)
        const int C = is_k ? H : V;
        const int doff = is_k ? 0 : H;
#pragma unroll
        for (int e = 0; e < KC; ++e) acc[e] = 0.f;
        for (int cl = 0; cl < C; cl += 4) {
          float wr[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wr[j] = (is_k ? W2::tk_row(cl + j) : W2::tv_row(cl + j))[cc];
          const float w0 = wr[0], w1 = wr[1], w2 = wr[2], w3 = wr[3];
#pragma unroll
          for (int e = 0; e < KC; ++e) {
            const float4 d4 = *reinterpret_cast<const float4*>(&s_d[e][doff + cl]);
            acc[e] += d4.x * w0 + d4.y * w1 + d4.z * w2 + d4.w * w3;
          }
        }
        __syncthreads();  // every thread has read dk|dv
#pragma unroll
        for (int e = 0; e < KC; ++e) s_d[e][t] = acc[e];
      }
      __syncthreads();

      // per-channel kv LayerNorm partials, dy = relu'(y) da
      {
        const float lsc = p.kv_ln[t], lbi = p.kv_ln[H2 + t];
        float dsc = 0.f, dbi = 0.f;
        for (int e = 0; e < n; ++e) {
          const float zh = s_zh[e][t];
          const float y = zh * lsc + lbi;
          const float dy = y > 0.f ? s_d[e][t] : 0.f;
          dsc += dy * zh;
          dbi += dy;
        }
        float* r = rb + off_kvln() + t;
        r[0] = (summed ? r[0] : 0.f) + dsc;
        r[H2] = (summed ? r[H2] : 0.f) + dbi;
      }
      __syncthreads();

      // LayerNorm + ReLU backward per (edge, half), in place: da -> dz
      for (int pair = warp; pair < 2 * n; pair += kWarps) {
        const int e = pair >> 1, half = pair & 1;
        const float* lsc = p.kv_ln + half * H;
        const float* lbi = p.kv_ln + H2 + half * H;
        float dy[4], zh[4], m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int cl = half * H + lane + 32 * q4;
          const int cs = lane + 32 * q4;
          zh[q4] = s_zh[e][cl];
          const float y = zh[q4] * lsc[cs] + lbi[cs];
          dy[q4] = y > 0.f ? s_d[e][cl] : 0.f;
          const float dzh = dy[q4] * lsc[cs];
          m1 += dzh;
          m2 += dzh * zh[q4];
        }
        m1 = warp_sum(m1) * (1.f / H);
        m2 = warp_sum(m2) * (1.f / H);
        const float rstd = s.rstd[e][half];
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int cs = lane + 32 * q4;
          s_d[e][half * H + cs] = rstd * (dy[q4] * lsc[cs] - m1 - zh[q4] * m2);
        }
      }
      __syncthreads();

      // d ni per channel; per-edge rows
      {
        float dn = 0.f;
        for (int e = 0; e < n; ++e) dn += s_d[e][t];
        rb[t] = (summed ? rb[t] : 0.f) + dn;
      }
      for (int u = t; u < n * H2; u += kThreads) a.dZ[ec * H2 + u] = s_d[u / H2][u % H2];
      for (int u = t; u < n * FE; u += kThreads) {
        const int e = u / FE, f = u % FE;
        const int et = s.g.et[e];
        float v;
        if (f < 4 * R) v = (f / R == et) ? s.g.rbf[e][f % R] : 0.f;
        else v = (f - 4 * R == et) ? 1.f : 0.f;
        a.F[(ec + e) * FE + f] = v;
      }
      // d rbf on the tensor cores; its partials take the free zh buffer
      drbf_chunk(s.drbf, &s_zh[0][0], s_d, a.rbff, p.w_rbf, s.g.et, ta, n, t);

      // geometry: d dist -> d rel (x_dst gets +, x_src gets - in gather_kernel)
      if (t < KC) {
        float d3[3] = {0.f, 0.f, 0.f};
        if (t < n) {
          const float dist = s.g.dist[t];
          float dd = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r)
            dd += s.drbf[t][r] * 2.f * a.in.coeff * (dist - a.in.offsets[r]) * s.g.rbf[t][r];
          const float f = dd / fmaxf(dist, 1e-16f);
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) {
            d3[k3] = f * s.g.rel[t][k3] + (kH2X ? s.gx[k3] * s_sdir[e0 + t] : 0.f);
            a.drel[(ec + t) * 3 + k3] = d3[k3];
          }
        }
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) s.drel[t][k3] = d3[k3];
      }
      __syncthreads();
      if (t < 3) {
        float sm = 0.f;
        for (int e = 0; e < n; ++e) sm += s.drel[e][t];
        s.dx[t] += sm;
      }
      summed = true;
      __syncthreads();  // the next chunk overwrites the chunk buffers
    }
    if (is_k) rb[off_dq(V) + cc] = dq;
    if (t < 3) a.dx[3 * bn + t] = s.dx[t];
  }
  cooperative_groups::this_cluster().sync();  // no block leaves while others read its quarter
}

// The kernel's shared-memory limit raised to its largest K on the first call,
// and the most clusters of it the card holds at once.
template <bool kH2X>
int edge_bwd_prepare(int* clusters) {
  static int held = 0;
  if (held == 0) {
    int err = (int)cudaFuncSetAttribute(edge_bwd_kernel<kH2X>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        bwd_smem(kMaxLayerK, kH2X));
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kBwdCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bwd_smem(kMaxBlockK, kH2X);
    if ((err = (int)cudaOccupancyMaxActiveClusters(&held, edge_bwd_kernel<kH2X>, &cfg))) return err;
    if (held <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  *clusters = held;
  return 0;
}

// edge_bwd_kernel on a grid of as many clusters as the card holds at K <= 32
// (fewer for fewer rows).
template <bool kH2X>
int launch_edge_bwd(const EdgeBwdArgs& a, cudaStream_t s) {
  int clusters = 0;
  if (int err = edge_bwd_prepare<kH2X>(&clusters)) return err;
  const long long rows = (long long)a.B * (a.N - a.row0);
  const long long want = (rows + kBwdCluster - 1) / kBwdCluster;
  const int grid = kBwdCluster * (int)(want < clusters ? want : clusters);
  edge_bwd_kernel<kH2X><<<grid, kThreads, bwd_smem(a.K, kH2X), s>>>(a);
  return (int)cudaGetLastError();
}

// Inverse adjacency of one pass, one block per complex: off [N+1] and list
// [(N - row0) * K] group the valid edges whose destination lies in
// [row0, N) by source, each group ascending by pass-local edge id.
__global__ void __launch_bounds__(1024)
adj_kernel(const int64_t* __restrict__ idx, const bool* __restrict__ nmask, int N, int K,
           int row0, int* __restrict__ off_all, int* __restrict__ list_all) {
  __shared__ int s_cnt[kAdjMaxN];
  __shared__ int s_off[kAdjMaxN + 1];
  const int t = threadIdx.x;
  const long long b = blockIdx.x;
  const int E = (N - row0) * K;
  int* off = off_all + b * (N + 1);
  int* list = list_all + b * E;
  for (int j = t; j < N; j += blockDim.x) s_cnt[j] = 0;
  __syncthreads();
  for (int u = t; u < E; u += blockDim.x) {
    const long long e = (b * N + row0) * K + u;
    if (nmask[e]) atomicAdd(&s_cnt[idx[e]], 1);
  }
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int j = 0; j < N; ++j) {
      s_off[j] = run;
      run += s_cnt[j];
    }
    s_off[N] = run;
  }
  __syncthreads();
  for (int j = t; j <= N; j += blockDim.x) off[j] = s_off[j];
  for (int j = t; j < N; j += blockDim.x) s_cnt[j] = 0;
  __syncthreads();
  for (int u = t; u < E; u += blockDim.x) {
    const long long e = (b * N + row0) * K + u;
    if (nmask[e]) {
      const int j = (int)idx[e];
      list[s_off[j] + atomicAdd(&s_cnt[j], 1)] = u;
    }
  }
  __syncthreads();
  for (int j = t; j < N; j += blockDim.x) {  // insertion sort: a fixed order per source
    int* seg = list + s_off[j];
    const int n = s_off[j + 1] - s_off[j];
    for (int u = 1; u < n; ++u) {
      const int v = seg[u];
      int w = u - 1;
      while (w >= 0 && seg[w] > v) {
        seg[w + 1] = seg[w];
        --w;
      }
      seg[w + 1] = v;
    }
  }
}

// Source side of one pass, one block per (source node, complex):
// rowbuf[2H, 4H) = sum of its edges' dz rows (d nj), dx -= sum of their d rel.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ off_all, const int* __restrict__ list_all, int N, int K,
              int rows_pass, const float* __restrict__ dZ, const float* __restrict__ drel,
              float* __restrict__ rowbuf, int W, float* __restrict__ dx) {
  const int t = threadIdx.x;
  const long long b = blockIdx.y;
  const int j = blockIdx.x;
  const long long bn = b * N + j;
  const int* off = off_all + b * (N + 1);
  const int* list = list_all + b * (long long)rows_pass * K;
  const long long ebase = b * (long long)rows_pass * K;
  const int beg = off[j], end = off[j + 1];
  float s = 0.f;
  for (int u = beg; u < end; ++u) s += dZ[(ebase + list[u]) * H2 + t];
  rowbuf[bn * W + H2 + t] = s;
  if (t < 3) {
    float r = 0.f;
    for (int u = beg; u < end; ++u) r += drel[(ebase + list[u]) * 3 + t];
    dx[3 * bn + t] -= r;
  }
}

// partial[z][c] = sum of Y[m][c] over the rows of chunk z.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ Y, int ldy, long long M, int Q, long long chunk,
              float* __restrict__ partial) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= Q) return;
  const long long mb = blockIdx.y * chunk;
  const long long me = mb + chunk < M ? mb + chunk : M;
  float s = 0.f;
  for (long long m = mb; m < me; ++m) s += Y[m * ldy + c];
  partial[(size_t)blockIdx.y * Q + c] = s;
}

// Number of row chunks for a split reduction over M rows of `tiles` output
// tiles of n floats: enough blocks for the card, >= 256 rows per chunk, and
// partials within the scratch.
long long chunks_for(long long M, long long tiles, long long n) {
  long long s = (M + 255) / 256;
  const long long target = (528 + tiles - 1) / tiles;
  if (s > target) s = target;
  if (s > kPartialCap / n) s = kPartialCap / n;
  return s < 1 ? 1 : s;
}

int colsum(const float* Y, int ldy, long long M, int Q, float* out, float* partial,
           cudaStream_t s) {
  const int tq = (Q + kThreads - 1) / kThreads;
  const long long S = chunks_for(M, tq, Q);
  const long long chunk = (M + S - 1) / S;
  colsum_kernel<<<dim3(tq, (unsigned)S), kThreads, 0, s>>>(Y, ldy, M, Q, chunk, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_kernel<<<grid_for(Q), kThreads, 0, s>>>(partial, (int)S, Q, out);
  return (int)cudaGetLastError();
}

struct Workspace {
  float *ni, *nj, *q, *q1, *qa, *rowbuf, *A, *dKV, *dZ, *F, *drel, *vec, *partial;
  uint4* rbff;  // stage_rbf_kernel's fragments
  int* next;    // edge_bwd_kernel's row counter
  int *off_x, *list_x, *off_h, *list_h;
};

void carve(float* w, int* iw, long long B, long long N, long long K, long long nl, Workspace* ws,
           long long* floats, long long* ints) {
  const long long BN = B * N, Ep = B * N * K;
  long long o = 0;
  auto take = [&](long long n) {
    float* ptr = w ? w + o : nullptr;
    o += (n + 3) / 4 * 4;
    return ptr;
  };
  ws->ni = take(BN * H2);
  ws->nj = take(BN * H2);
  ws->q = take(BN * H);
  ws->q1 = take(BN * H);
  ws->qa = take(BN * H);
  ws->rowbuf = take(BN * row_width(H));
  ws->A = take(Ep * H2);
  ws->dKV = take(Ep * H2);
  ws->dZ = take(Ep * H2);
  ws->F = take(Ep * FE);
  ws->drel = take(Ep * 3);
  ws->vec = take(row_width(H));
  ws->partial = take(kPartialCap);
  ws->rbff = reinterpret_cast<uint4*>(take(kRbfFrags * 4));
  *floats = o;
  long long io = 0;
  auto itake = [&](long long n) {
    int* ptr = iw ? iw + io : nullptr;
    io += n;
    return ptr;
  };
  ws->next = itake(4);
  ws->off_x = itake(B * (N + 1));
  ws->list_x = itake(B * N * K);
  ws->off_h = itake(B * (N + 1));
  ws->list_h = itake(B * nl * K);
  *ints = io;
}

template <bool kH2X>
int run_pass(const float* h, const EdgeInputs& in0, const PassParams& p, const PassT& pt,
             const PassGrads& g, int B, int N, int K, int row0, const int* off, const int* list,
             float* dh, float* dx, float* dew, const Workspace& ws, cudaStream_t s) {
  constexpr int V = kH2X ? NH : H;
  constexpr int W = row_width(V);
  const long long BN = (long long)B * N;
  const long long Ep = (long long)B * (N - row0) * K;
  int err = (int)cudaMemsetAsync(ws.rowbuf, 0, BN * W * sizeof(float), s);
  if (err) return err;
  if ((err = launch_node(h, 1, (int)BN, 0, p, ws.ni, ws.nj, ws.q, ws.q1, s))) return err;

  stage_rbf_kernel<<<(kRbfFrags + kThreads - 1) / kThreads, kThreads, 0, s>>>(p.w_rbf, ws.rbff);
  if ((err = (int)cudaGetLastError())) return err;

  EdgeInputs in = in0;
  in.ni = ws.ni;
  in.nj = ws.nj;
  if ((err = (int)cudaMemsetAsync(ws.next, 0, sizeof(int), s))) return err;
  const EdgeBwdArgs a{h, in, ws.q, p, B, N, K, row0, dh, dx, dew, ws.rowbuf, ws.A, ws.dKV,
                      ws.dZ, ws.F, ws.drel, ws.rbff, ws.next};
  if ((err = launch_edge_bwd<kH2X>(a, s))) return err;
  gather_kernel<<<dim3(N, B), kThreads, 0, s>>>(off, list, N, K, N - row0, ws.dZ, ws.drel,
                                                ws.rowbuf, W, dx);
  if ((err = (int)cudaGetLastError())) return err;
  err = launch_node_bwd(ws.q1, p.q_ln, pt.w_q2T, pt.w_nodeT, BN, W, off_dq(V), off_qln(V),
                        ws.rowbuf, ws.qa, dh, s);
  if (err) return err;

  const struct {
    const float *X, *Y;
    int ldx, ldy;
    long long M;
    int P, Q;
    float* out;
  } products[] = {{ws.A, ws.dKV, H2, H + V, Ep, H, H, g.w2k},
                  {ws.A + H, ws.dKV + H, H2, H + V, Ep, H, V, g.w2v},
                  {ws.F, ws.dZ, FE, H2, Ep, FE, H2, g.tab},
                  {h, ws.rowbuf, H, W, BN, H, H5, g.w_node},
                  {ws.qa, ws.rowbuf + off_dq(V), H, W, BN, H, H, g.w_q2}};
  for (const auto& pr : products) {
    err = weight_grad(pr.X, pr.ldx, pr.Y, pr.ldy, pr.M, pr.P, pr.Q, pr.out, ws.partial, s);
    if (err) return err;
  }
  if ((err = colsum(ws.rowbuf, W, BN, W, ws.vec, ws.partial, s))) return err;
  const struct {
    float* dst;
    int off, n;
  } segs[] = {{g.b_node, 0, H5},          {g.kv_ln, off_kvln(), 2 * H2},
              {g.b2k, off_db2(), H},      {g.b2v, off_db2() + H, V},
              {g.b_q2, off_dq(V), H},     {g.q_ln, off_qln(V), 2 * H}};
  for (const auto& sg : segs) {
    err = (int)cudaMemcpyAsync(sg.dst, ws.vec + sg.off, sg.n * sizeof(float),
                               cudaMemcpyDeviceToDevice, s);
    if (err) return err;
  }
  return 0;
}

// Inverse adjacency of the destination rows [row0, N) of every complex.
int build_adjacency(const int64_t* idx, const bool* nmask, int B, int N, int K, int row0,
                    int* off, int* list, cudaStream_t s) {
  adj_kernel<<<B, 1024, 0, s>>>(idx, nmask, N, K, row0, off, list);
  return (int)cudaGetLastError();
}

}  // namespace
