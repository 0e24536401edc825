// One attention pass's backward, shared by the whole-block backward
// (block_vjp.cu) and the per-layer backwards (edge_layer_vjp.cu): the exact
// VJP of the x2h and h2x edge passes (x2h_edge.cuh, h2x_edge.cuh) for
// any K up to kMaxLayerK, float32.
//
// Once per backward, before its passes (the caller's):
//   stage_w2_kernel stages every pass's second layers w2k, w2v times 2^8 as
//                   fp16 (hi, lo) mma B fragments (tc_common.cuh:
//                   stage_frags), 64 KB each, and their float32 transposes,
//                   64 KB each, one region a pass, read by every
//                   edge_bwd_kernel block from L2; bf16: w2k, w2v and their
//                   transposes as 8-byte bf16 fragments (stage_frags16), 32
//                   KB each. One launch for all the passes.
// Per pass (run_pass):
//   node_kernel     (node_proj.cuh) recomputes the per-node projections ni,
//                   nj, q (and q's first-layer output q1) of the pass on
//                   every row.
//   stage_rbf_kernel stages the RBF table w_rbf as TF32 (hi, lo) B fragments
//                   of the d rbf product, one layout per destination kind
//                   (types 0|2 and 1|3), 80 KB each.
//   edge_bwd_kernel one block per destination row. Pass 1 walks the row's
//                   edges in chunks of 32, recomputing the forward (geometry,
//                   first layer, LayerNorm, second layers) for the logits
//                   and P = d alpha / e_w of every edge, kept in shared
//                   memory; after the row softmax, pass 2 walks the chunks
//                   again backward: softmax, second layers (transposed
//                   weights: transposed_layers, on the tensor cores),
//                   LayerNorm+ReLU, the RBF table and the geometry. With
//                   one chunk (K <= 32) pass 2 reuses pass 1's
//                   activations; with more it recomputes the chunk and its
//                   k. The recompute's first layer applies each thread's
//                   columns of the row's two RBF type tables, loaded once
//                   per chunk; its second layers run on the tensor cores
//                   (second_layers: three fp16 products per term,
//                   float32-grade, as in the forward kernels), and so do
//                   the transposed second layers (three-term TF32) and d
//                   rbf (drbf_chunk: one three-term TF32 product per chunk
//                   over the row's two type tables); the rest runs on the
//                   float32 pipes. It writes per-row sums (the
//                   destination projection's gradient, dq, bias and
//                   LayerNorm partials) to a row
//                   buffer, and per-edge rows (post-LN activations, their
//                   output gradients, the first layer's gradient dz, the
//                   edge-feature row and d rel) for the passes below; d e_w
//                   and the destination's d x in place. A chunk without a
//                   valid edge has exactly zero gradient: its rows are
//                   written as zeros and its work skipped.
//   gather_kernel   the source side, deterministic: an inverse adjacency
//                   (edges grouped by source, ascending, built once per
//                   backward by build_adjacency's counting sort) sums each
//                   source's dz rows into its d nj and subtracts its d rel
//                   rows from its d x.
//   node_bwd_kernel the query MLP's backward and dh += dproj @ w_node^T
//                   (node_bwd.cuh): row tiles, both products on the tensor
//                   cores (three-term TF32), the weights read once per tile.
//   weight_grad     weight gradients X^T Y (second layers over edges, RBF
//                   and edge-type tables over edges, w_node and q's second
//                   layer over nodes) on the tensor cores (weight_grad.cuh),
//                   split over row chunks into partial tiles that
//                   reduce_kernel sums in a fixed order; bias and LayerNorm
//                   gradients are column sums of the row buffer.
// Every sum has a fixed order, so the result is deterministic.
#pragma once

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

// Transposed copies of one layer's pass weights for the node kernel's
// backward products (node_bwd.cuh).
struct PassT {
  const float* w_nodeT;  // [5H][H]
  const float* w_q2T;    // [H][H]
};

// build_adjacency calls that launched, by every entry of the library.
inline long long adj_build_count = 0;

// stage_w2_kernel launches so far in this process, by instantiation (float32,
// bf16), by every entry of the library.
inline long long stage_w2_launch_count[2] = {0, 0};

namespace {

constexpr int FE = 4 * R + 4;   // edge-feature row: rbf x type | type
constexpr int kAdjMaxN = 4096;  // nodes per complex for the inverse adjacency

// Edges per tile of the inverse adjacency's counting sort (build_adjacency):
// at least 512 and at least N, a multiple of 32, so that the per-tile
// counts (N a tile) never outnumber the edges by more than N.
int adj_tile_edges(int N) { return ((N > 512 ? N : 512) + 31) / 32 * 32; }

// Scratch ints build_adjacency takes after a pass's lists of E edges each.
long long adj_scratch_ints(long long B, long long N, long long E) {
  const long long T = adj_tile_edges((int)N);
  return B * ((E + T - 1) / T) * N;
}
constexpr int kW2Frags = kKSteps * kNTiles * 32;  // B fragments of a staged 128x128 weight
// uint4 of stage_w2_kernel's output (Workspace::w2f): float32 w2k, w2v
// fragments and their float32 transposes ([H][H] + [V][H] floats)
constexpr int kW2Staged = 4 * kW2Frags;
constexpr int kLdc = H2 + 8;    // padded row of the products' k|v output: conflict-free C stores
constexpr int kLdd = H2 + 4;    // padded row of dk|dv and dz: conflict-free TF32 A fragments
// floats of edge_bwd_kernel's third chunk buffer: dk|dv then dz [KC][kLdd], or
// the recompute's split activations [2][KC][kLdz], then its output [KC][kLdc]
constexpr int kChunkBuf = 2 * KC * kLdz;
static_assert(kChunkBuf >= KC * kLdc && kChunkBuf >= KC * kLdd, "third chunk buffer too small");
// The d rbf product D [KC][kDrbfCols] = dz [KC][2H] [W_ta | W_ta+2]: 32 k-steps
// of m16n8k8, 5 n-tiles; its staged B fragments, both destination kinds
constexpr int kDrbfCols = 2 * R;
constexpr int kDrbfKSteps = H2 / 8;
constexpr int kDrbfNTiles = kDrbfCols / 8;
constexpr int kRbfFrags = 2 * kDrbfKSteps * kDrbfNTiles * 32;
constexpr int kWarps = kThreads / 32;
static_assert(kDrbfCols % 8 == 0 && kDrbfKSteps % kWarps == 0, "d rbf tiling");
static_assert(kWarps * KC * kDrbfCols <= 2 * KC * H2, "d rbf partials exceed two chunk buffers");

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
  PassT pt;
  int N, K, row0;
  const float* dh;  // [B*N][H] x2h: cotangent of the pass output
  float* dx;        // [B*N][3] in place: h2x reads it as the cotangent
  float* dew;       // [B*N][K] accumulated
  float* rowbuf;    // [B*N][row_width(V)]
  float* A;         // [Ep][2H] post-LN k|v activations
  float* dKV;       // [Ep][H + V] gradients of k|v
  float* dZ;        // [Ep][2H] gradients of the first layer's output
  float* F;         // [Ep][FE] edge-feature rows
  float* drel;      // [Ep][3]
  const uint4* w2f;   // the pass's region of stage_w2_kernel's fragments
  const uint4* rbff;  // w_rbf as staged by stage_rbf_kernel
};

// Dynamic shared memory of edge_bwd_kernel: two [KC][2H] chunk buffers and
// a third of kChunkBuf floats, then per edge of the row alpha and P (and,
// for h2x, v) [KP][NH], e_w and the h2x gate [KP], KP = K rounded up to
// chunks.
__host__ __device__ constexpr int bwd_smem(int K, bool h2x) {
  return (2 * KC * H2 + kChunkBuf + (K + KC - 1) / KC * KC * (NH * (h2x ? 3 : 2) + 2)) *
         (int)sizeof(float);
}

// Stages B [16 ksteps][8 ntiles], B[k][n] = W[k sk + n sn] (bf16 weights),
// times scale as 8-byte m16n8k16 B fragments by threads t of nthreads:
// dst[(ks * ntiles + nt) * 32 + lane] = (b0, b1), bf16 pairs, b0 = (B[16 ks +
// 2 tig][8 nt + g], B[16 ks + 2 tig + 1][..]), b1 the same 8 rows down, the
// lower k in the lower half: stage_frags<true>'s words without its two zero
// words.
__device__ __forceinline__ void stage_frags16(uint2* dst, const __nv_bfloat16* __restrict__ W,
                                              int sk, int sn, int ksteps, int ntiles, float scale,
                                              int t, int nthreads) {
  const int per = ksteps * ntiles * 32;
  for (int u = t; u < per; u += nthreads) {
    const int ks = u / (ntiles * 32), nt = u / 32 % ntiles, fl = u % 32;
    const __nv_bfloat16* w = W + (16 * ks + 2 * (fl & 3)) * sk + (8 * nt + (fl >> 2)) * sn;
    dst[u] = make_uint2(bf16_pair(scale * wload(w), scale * wload(w + sk)),
                        bf16_pair(scale * wload(w + 8 * sk), scale * wload(w + 9 * sk)));
  }
}

// The second layers of a pass as mma B fragments in global memory, f (one
// region of kW2Staged uint4 a pass). Float32: w2k, w2v times kWScale as
// stage_frags lays them out, [kKSteps][kNTiles][32] and [kKSteps][V / 8][32]
// uint4 at f and f + kW2Frags, then their float32 transposes w2k^T [H][H] and
// w2v^T [V][H] from f + 2 kW2Frags (the transposed product splits them into
// TF32 (hi, lo) where it reads them). kBf16, from the bf16 weights, four
// regions of kW2Frags uint2 (stage_frags16): w2k, w2v times kWScale as B
// (B[k][n] = W[k][n]), then their transposes, [H / 16][kNTiles][32] and
// [V / 16][kNTiles][32].
//
// stage_w2_kernel stages every pass of a backward in one launch (block_bwd
// stages all 2L passes before its layer loop; a per-layer backward and
// tprod stage their one pass with the same kernel). Block (slice, weight,
// pass) takes rows [32 slice, 32 slice + 32) of w2k (weight 0) or w2v (1):
// it reads them once, 16 bytes a thread along the rows, into shared memory
// (rows padded to H + 1 floats), and writes from there the fragments of
// those rows' two k-steps and their columns of the transposes, consecutive
// threads on consecutive words. The words are those of stage_frags /
// stage_frags16 at the same weights.
constexpr int kMaxStagePasses = 64;  // passes of one stage_w2_kernel launch
constexpr int kStageRows = 32;       // rows of a weight a block stages

// The second layers of up to kMaxStagePasses passes, a kernel parameter (1.25
// KB): w2k [H][H] and w2v [H][V] (bf16 in the bf16 instantiation, 16-byte
// aligned), V = H (x2h) or NH (h2x).
struct W2Batch {
  const float* w2k[kMaxStagePasses];
  const float* w2v[kMaxStagePasses];
  int V[kMaxStagePasses];
};

template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads) stage_w2_kernel(W2Batch b, uint4* __restrict__ f) {
  constexpr int ld = H + 1;  // transposed reads of consecutive rows hit consecutive banks
  __shared__ float w[kStageRows][ld];
  const int t = threadIdx.x, wi = blockIdx.y, pass = blockIdx.z;
  const int r0 = blockIdx.x * kStageRows, cols = wi ? b.V[pass] : H;
  const float* src = wi ? b.w2v[pass] : b.w2k[pass];
  f += (size_t)pass * kW2Staged;
  if constexpr (kBf16) {
    const __nv_bfloat16* W = reinterpret_cast<const __nv_bfloat16*>(src) + (size_t)r0 * cols;
    for (int u = t; u < kStageRows * cols / 8; u += kThreads) {
      const int r = u / (cols / 8), c = u % (cols / 8) * 8;
      const uint4 q = *reinterpret_cast<const uint4*>(W + r * cols + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
      for (int i = 0; i < 8; ++i) w[r][c + i] = __bfloat162float(e[i]);
    }
  } else {
    const float* W = src + (size_t)r0 * cols;
    for (int u = t; u < kStageRows * cols / 4; u += kThreads) {
      const int r = u / (cols / 4), c = u % (cols / 4) * 4;
      const float4 q = *reinterpret_cast<const float4*>(W + r * cols + c);
      w[r][c] = q.x;
      w[r][c + 1] = q.y;
      w[r][c + 2] = q.z;
      w[r][c + 3] = q.w;
    }
  }
  __syncthreads();
  // B = W kWScale: the k-steps r0 / 16 and r0 / 16 + 1 of region wi
  const int nt_w = cols / 8, base = r0 / 16 * nt_w * 32;
  for (int u = t; u < 2 * nt_w * 32; u += kThreads) {
    const int ks = u / (nt_w * 32), nt = u / 32 % nt_w, lane = u % 32;
    const float* s = &w[16 * ks + 2 * (lane & 3)][8 * nt + (lane >> 2)];
    if constexpr (kBf16) {
      reinterpret_cast<uint2*>(f)[wi * kW2Frags + base + u] =
          make_uint2(bf16_pair(kWScale * s[0], kWScale * s[ld]),
                     bf16_pair(kWScale * s[8 * ld], kWScale * s[9 * ld]));
    } else {
      __half hi[4], lo[4];  // rows 0, 1, 8, 9 of the k-step (from 2 tig)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_f16(kWScale * s[((q & 1) + 8 * (q >> 1)) * ld], hi[q], lo[q]);
      f[wi * kW2Frags + base + u] = make_uint4(f16_pair(hi[0], hi[1]), f16_pair(hi[2], hi[3]),
                                               f16_pair(lo[0], lo[1]), f16_pair(lo[2], lo[3]));
    }
  }
  if constexpr (kBf16) {
    // region 2 + wi, B[k][n] = W[n][k]: every k-step, the n-tiles r0 / 8 .. + 4
    uint2* dst = reinterpret_cast<uint2*>(f) + (2 + wi) * kW2Frags;
    for (int u = t; u < cols / 16 * 4 * 32; u += kThreads) {
      const int ks = u / 128, nt = u / 32 % 4, lane = u % 32;
      const float* s = &w[8 * nt + (lane >> 2)][16 * ks + 2 * (lane & 3)];
      dst[(ks * kNTiles + r0 / 8 + nt) * 32 + lane] =
          make_uint2(bf16_pair(s[0], s[1]), bf16_pair(s[8], s[9]));
    }
  } else {
    // wt[c][m] = W[m][c] for the slice's rows m, k then v
    float* wt = reinterpret_cast<float*>(f + 2 * kW2Frags) + wi * H * H;
    for (int u = t; u < cols * kStageRows; u += kThreads) {
      const int c = u / kStageRows, m = u % kStageRows;
      wt[c * H + r0 + m] = w[m][c];
    }
  }
}

// Stages `passes` passes' second layers (w2k[i], w2v[i], V[i]) into f + i
// kW2Staged, kMaxStagePasses passes a launch; counted in
// stage_w2_launch_count. Refuses weights that are not 16-byte aligned.
template <bool kBf16 = false>
int stage_w2(int passes, const float* const* w2k, const float* const* w2v, const int* V, uint4* f,
             cudaStream_t s) {
  for (int p0 = 0; p0 < passes; p0 += kMaxStagePasses) {
    const int n = passes - p0 < kMaxStagePasses ? passes - p0 : kMaxStagePasses;
    W2Batch b{};
    for (int i = 0; i < n; ++i) {
      b.w2k[i] = w2k[p0 + i];
      b.w2v[i] = w2v[p0 + i];
      b.V[i] = V[p0 + i];
      if (((uintptr_t)b.w2k[i] | (uintptr_t)b.w2v[i]) & 15 || (b.V[i] != H && b.V[i] != NH))
        return (int)cudaErrorInvalidValue;
    }
    stage_w2_kernel<kBf16><<<dim3(H / kStageRows, 2, n), kThreads, 0, s>>>(
        b, f + (size_t)p0 * kW2Staged);
    if (int err = (int)cudaGetLastError()) return err;
    ++stage_w2_launch_count[kBf16];
  }
  return 0;
}

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

// The bf16 d rbf product (drbf_chunk<true>): 16-deep k-steps of m16n8k16.
constexpr int kDrbfKSteps16 = H2 / 16;
constexpr int kRbfFrags16 = 2 * kDrbfKSteps16 * kDrbfNTiles * 32;
static_assert(kRbfFrags16 <= kRbfFrags && kDrbfKSteps16 % kWarps == 0, "bf16 d rbf tiling");

// stage_rbf_kernel's bf16 form, from the bf16 w_rbf: frags[((ta *
// kDrbfKSteps16 + ks) * kDrbfNTiles + nt) * 32 + lane] = (b0, b1, 0, 0),
// bf16 pairs, b0 = (B[16 ks + 2 tig][8 nt + g], B[16 ks + 2 tig + 1][..]),
// b1 the same 8 rows down, B[k][j] = w_rbf[j < R ? ta : ta + 2][j % R][k].
__global__ void __launch_bounds__(kThreads)
stage_rbf16_kernel(const __nv_bfloat16* __restrict__ w_rbf, uint4* __restrict__ frags) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= kRbfFrags16) return;
  const int per_kind = kDrbfKSteps16 * kDrbfNTiles * 32;
  const int ta = u / per_kind, ks = u % per_kind / (kDrbfNTiles * 32);
  const int nt = u / 32 % kDrbfNTiles, lane = u % 32;
  const int j = 8 * nt + (lane >> 2);
  const __nv_bfloat16* w =
      w_rbf + ((j < R ? ta : ta + 2) * R + j % R) * H2 + 16 * ks + 2 * (lane & 3);
  frags[u] = make_uint4(bf16_pair(wload(w), wload(w + 1)), bf16_pair(wload(w + 8), wload(w + 9)),
                        0u, 0u);
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
// and added in float32 (as weight_grad.cuh). The partials go to red
// [kWarps][KC][2R] and are summed in warp order, a fixed order. dz: the
// third chunk buffer, row stride kLdd. Starts at a barrier (red may alias
// what the block read before) and ends at one.
// bf16 (kBf16): 16-deep k-steps, each one bf16 mma.sync.m16n8k16 on dz rounded
// to bf16 and the bf16 table's fragments (stage_rbf16_kernel), accumulated in
// the mma's float32 accumulator; the same partials and warp-order sum.
template <bool kBf16 = false>
__device__ __forceinline__ void drbf_chunk(float (*drbf)[R], float* red, const float (*dz)[kLdd],
                                           const uint4* frags, const float* w_rbf,
                                           const int* et, int ta, int n, int t) {
  constexpr int kSteps = kDrbfKSteps / kWarps;
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
  if constexpr (kBf16) {
    constexpr int kSteps16 = kDrbfKSteps16 / kWarps;
#pragma unroll 1
    for (int i = 0; i < kSteps16; ++i) {
      const int ks = warp * kSteps16 + i;
      uint2 b[kDrbfNTiles];
#pragma unroll
      for (int nt = 0; nt < kDrbfNTiles; ++nt) {
        const uint4 f = frags[((ta * kDrbfKSteps16 + ks) * kDrbfNTiles + nt) * 32 + lane];
        b[nt] = make_uint2(f.x, f.y);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= mts) continue;
        // A: rows g, g + 8 x columns (2 tig, 2 tig + 1), the same + 8
        const float* ar = &dz[16 * mt + g][16 * ks + 2 * tig];
        const uint32_t a[4] = {bf16_pair(ar[0], ar[1]), bf16_pair(ar[8 * kLdd], ar[8 * kLdd + 1]),
                               bf16_pair(ar[8], ar[9]),
                               bf16_pair(ar[8 * kLdd + 8], ar[8 * kLdd + 9])};
#pragma unroll
        for (int nt = 0; nt < kDrbfNTiles; ++nt) mma_bf16(acc[mt][nt], a, b[nt].x, b[nt].y);
      }
    }
  } else {
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
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= mts) continue;
#pragma unroll
    for (int nt = 0; nt < kDrbfNTiles; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(red + (warp * KC + 16 * mt + 8 * hf + g) * kDrbfCols +
                                   8 * nt + 2 * tig) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
  }
  __syncthreads();
  for (int u = t; u < n * R; u += kThreads) {
    const int e = u / R, r = u % R;
    const float* col = red + e * kDrbfCols + (et[e] == ta ? 0 : R) + r;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += col[w * KC * kDrbfCols];
    drbf[e][r] = s;
  }
  __syncthreads();
}

// The chunk's second layers on the tensor cores, block-wide, ending at a
// barrier: out[e] = b[cc] + sum_m a[e][half H + m] W[m][cc] for every slot e,
// in thread t = half H + cc (k: threads [0, H), v: [H, H + V)), for the
// halves below `halves` (1: k only, 2: k and v). The float32 activations a
// stay as they are (the A rows); their fp16 (hi, lo) column pairs go to buf
// (row stride kLdz). Warp w runs the 32 x 32 tile of half w / 4, channels
// 32 (w % 4) .. (h2x's 16-wide v: warp 4 alone, two n-tiles), three fp16
// products per term on the staged fragments wk, wv (tile_mma), as the
// forward kernels compute k and v; the C fragments return through buf (row
// stride kLdc) to each channel's thread (every thread's out is written: a
// thread past the computed halves gets stale words it does not read) and stay
// in buf, out[e] = buf[e * kLdc + t], until the block writes buf again. Every
// sum has a fixed order. kBf16: bf16 pairs and one bf16 product per term on
// the 8-byte bf16 fragments (stage_w2_kernel<true>), as the bf16 forward
// kernels. f: stage_w2_kernel's fragments.
template <int V, bool kBf16 = false>
__device__ __forceinline__ void second_layers(float (&out)[KC], const float (*a)[H2], float* buf,
                                              const uint4* f, const PassParams& p, int halves,
                                              int t) {
  constexpr int kVT = V < 32 ? V / 8 : 4;  // n-tiles of a v warp's tile
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  for (int pr = warp; pr < halves * KC; pr += kThreads / 32) {  // (half, slot) rows
    const int half = pr / KC, e = pr % KC;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = a[e][half * H + lane + 32 * q];
    store_split_row<kBf16>(reinterpret_cast<uint32_t*>(buf + pr * kLdz), v, lane);
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
    if constexpr (kBf16) {
      const uint2* w = reinterpret_cast<const uint2*>(f) + half * kW2Frags + 4 * qd * 32;
      if (half) tile_mma<kVT, true>(acc, as, w, V / 8, lane);
      else tile_mma<4, true>(acc, as, w, kNTiles, lane);
    } else {
      if (half) tile_mma<kVT>(acc, as, f + kW2Frags + 4 * qd * 32, V / 8, lane);
      else tile_mma<4>(acc, as, f + 4 * qd * 32, kNTiles, lane);
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
#pragma unroll
  for (int e = 0; e < KC; ++e) out[e] = buf[e * kLdc + t];
  __syncthreads();  // every thread has its out
}

// One warp's 32 x 32 tile of a transposed second layer of depth C (C = H,
// or V for h2x's v half): acc[mt][nt] = sum_c d[16 mt + .][c] W2[n0 + 8 nt +
// .][c] in tile_mma's C-fragment layout, d the half's columns (row stride
// kLdd). Float32: w the staged W2^T [C][H] from the tile's first column,
// three TF32 m16n8k8 products per term (small terms first; d and W2^T split
// on the fly), each k-step's three summed from zero and added in float32,
// k-steps ascending (as drbf_chunk, weight_grad.cuh). kBf16: w the staged
// fragments of the tile's n-tiles (stage_w2_kernel<true>: n-tile stride 32,
// k-step stride kNTiles * 32), one bf16 m16n8k16 product per k-step on d as
// rounded in place, accumulated in the mma. One k-step's operands at a time
// (unrolled, they spilled more).
template <int C, bool kBf16>
__device__ __forceinline__ void transposed_tile(float (&acc)[2][4][4], const float* d,
                                                const std::conditional_t<kBf16, uint2, float>* w,
                                                int lane) {
  const int g = lane >> 2, tig = lane & 3;
  if constexpr (kBf16) {
#pragma unroll 1
    for (int ks = 0; ks < C / 16; ++ks) {
      uint2 b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = w[(ks * kNTiles + nt) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A: rows g, g + 8 x columns (2 tig, 2 tig + 1), the same + 8
        const float* ar = d + (16 * mt + g) * kLdd + 16 * ks + 2 * tig;
        const uint32_t a[4] = {bf16_pair(ar[0], ar[1]), bf16_pair(ar[8 * kLdd], ar[8 * kLdd + 1]),
                               bf16_pair(ar[8], ar[9]),
                               bf16_pair(ar[8 * kLdd + 8], ar[8 * kLdd + 9])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt].x, b[nt].y);
      }
    }
  } else {
    const float* wt = w + tig * H + g;  // b0 = W2^T[8 ks + tig][8 nt + g], b1 4 rows down
#pragma unroll 1
    for (int ks = 0; ks < C / 8; ++ks) {
      uint4 b[4];  // (b0 hi, b1 hi, b0 lo, b1 lo)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(wt[8 * ks * H + 8 * nt], b[nt].x, b[nt].z);
        split_tf32(wt[(8 * ks + 4) * H + 8 * nt], b[nt].y, b[nt].w);
      }
      // A: (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ah[4], al[4];
        const float* ar = d + (16 * mt + g) * kLdd + 8 * ks + tig;
        split_tf32(ar[0], ah[0], al[0]);
        split_tf32(ar[8 * kLdd], ah[1], al[1]);
        split_tf32(ar[4], ah[2], al[2]);
        split_tf32(ar[8 * kLdd + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, al, b[nt].x, b[nt].y);
          mma_tf32(p, ah, b[nt].z, b[nt].w);
          mma_tf32(p, ah, b[nt].x, b[nt].y);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] += p[c];
        }
      }
    }
  }
}

// The chunk's second layers backward on the tensor cores, block-wide with no
// barrier: da[e][half H + m] = sum_c d[e][half H + c] W2[m][c] for every slot
// e, half 0 (k: W2 = w2k, c < H) and half 1 (v: W2 = w2v, c < V); the JAX
// kernel's da = _cdot(dout, w2.T) (edge_layer_vjp.py:130). d: dk|dv in the
// third chunk buffer (row stride kLdd; bf16: rounded in place). Warp w runs
// the 32 x 32 tile of half w / 4, channels m in 32 (w % 4) .. (h2x's v half:
// 16 deep), and writes it to da straight from its C fragments (through the
// third buffer at a padded stride was slower: PERF.md). f:
// stage_w2_kernel's fragments.
template <int V, bool kBf16>
__device__ __forceinline__ void transposed_layers(float (*da)[H2], const float (*d)[kLdd],
                                                  const uint4* f, int t) {
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  const int half = warp >> 2, n0 = 32 * (warp & 3);
  const float* dhalf = &d[0][half * H];
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  if constexpr (kBf16) {
    const uint2* w = reinterpret_cast<const uint2*>(f) + (2 + half) * kW2Frags + n0 / 8 * 32;
    if (half) transposed_tile<V, true>(acc, dhalf, w, lane);
    else transposed_tile<H, true>(acc, dhalf, w, lane);
  } else {
    const float* w = reinterpret_cast<const float*>(f + 2 * kW2Frags) + half * H * H + n0;
    if (half) transposed_tile<V, false>(acc, dhalf, w, lane);
    else transposed_tile<H, false>(acc, dhalf, w, lane);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(&da[16 * mt + 8 * hf + g][half * H + n0 + 8 * nt + 2 * tig]) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
}

// kBf16: the VJP of the bf16 forward kernels (JAX's bf16 training variant,
// targetdiff_tpu/ops/pallas/edge_layer_vjp.py _cdot / _cdotg): its recompute
// is the bf16 forward (edge_chunk<true>, second_layers<V, true>), and the
// transposed second layers and d rbf take bf16 operands (d rounded in
// place, W2^T as staged, dz and the bf16 table), summed in float32;
// LayerNorm, softmax, the geometry and every sum over edges stay float32, d
// dist from the float32 RBF features.
template <bool kH2X, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 2) edge_bwd_kernel(EdgeBwdArgs a) {
  constexpr int V = kH2X ? NH : H;
  constexpr int W = row_width(V);
  const int N = a.N, K = a.K, row0 = a.row0;
  const int nchunk = (K + KC - 1) / KC, KP = nchunk * KC;
  extern __shared__ __align__(16) float smem[];
  float(*s_a)[H2] = reinterpret_cast<float(*)[H2]>(smem);               // a, then da, then dy
  float(*s_zh)[H2] = reinterpret_cast<float(*)[H2]>(smem + KC * H2);     // normalised z
  float* s_buf = smem + 2 * KC * H2;                                      // second_layers' operands
  float(*s_d)[kLdd] = reinterpret_cast<float(*)[kLdd]>(s_buf);           // dk|dv, then dz
  float(*s_alpha)[NH] = reinterpret_cast<float(*)[NH]>(s_buf + kChunkBuf);  // logits, alpha
  float(*s_P)[NH] = s_alpha + KP;  // d alpha = e_w * P, d e_w = sum_h alpha P
  float(*s_v)[NH] = s_P + KP;      // h2x: the values
  float* s_w = reinterpret_cast<float*>(s_P + KP) + (kH2X ? KP * NH : 0);  // e_w
  float* s_sdir = s_w + KP;        // h2x: s_e = mean_h(alpha e_w v)
  __shared__ EdgeGeometry s_g;
  __shared__ float s_rstd[KC][2];
  __shared__ float s_drbf[KC][R];
  __shared__ float s_drel[KC][3];
  __shared__ float s_gx[3];  // h2x: mask_ligand * d x_out of this row
  __shared__ float s_dot[NH];

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const long long b = blockIdx.y;
  const long long bn = b * N + row0 + blockIdx.x;
  const long long eb = (b * (N - row0) + blockIdx.x) * K;  // first pass-local edge of the row
  const PassParams& p = a.p;
  float* rb = a.rowbuf + bn * W;
  const bool is_k = t < H;
  const int cc = is_k ? t : t - H;
  const float qc = is_k ? a.q[bn * H + cc] : 0.f;
  const float gc = (!kH2X && !is_k) ? a.dh[bn * H + cc] : 0.f;
  const int ta = a.in.mlig[bn] ? 0 : 1;  // the row's edge types: ta, ta + 2
  if (kH2X && t < 3) s_gx[t] = a.in.mlig[bn] ? a.dx[3 * bn + t] : 0.f;

  // ---- pass 1: logits and P of every edge (h2x: and v) ----
  float acc[KC];
  bool live0 = false;
  for (int c = 0; c < nchunk; ++c) {
    const int e0 = c * KC;
    const bool live = edge_chunk<kBf16>(s_g, s_a, s_zh, s_rstd, a.in, p, b, bn, N, K, e0, t);
    if (c == 0) live0 = live;
    if (t < KC) s_w[e0 + t] = s_g.w[t];
    if (live) {
      second_layers<V, kBf16>(acc, s_a, s_buf, a.w2f, p, 2, t);
      if (is_k) {
        head_logits(acc, qc, s_g.valid, s_alpha + e0, cc);
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
          const float ds = (s_gx[0] * s_g.rel[e][0] + s_gx[1] * s_g.rel[e][1] +
                            s_gx[2] * s_g.rel[e][2]) * (1.f / NH);
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
  row_softmax(s_alpha, K, KP, t);
  __syncthreads();

  // ---- d e_w, the softmax dot per head, h2x gates ----
  for (int e = t; e < K; e += kThreads) {
    float d = 0.f, sv = 0.f;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      d += s_alpha[e][hh] * s_P[e][hh];
      if (kH2X) sv += s_alpha[e][hh] * s_v[e][hh];
    }
    a.dew[bn * K + e] += d;
    if (kH2X) s_sdir[e] = sv * s_w[e] * (1.f / NH);
  }
  for (int hh = warp; hh < NH; hh += kThreads / 32) {
    float s = 0.f;
    for (int e = lane; e < K; e += 32) s += s_alpha[e][hh] * s_w[e] * s_P[e][hh];
    s = warp_sum(s);
    if (lane == 0) s_dot[hh] = s;
  }
  __syncthreads();

  // ---- pass 2: each chunk backward ----
  const float scale = rsqrtf((float)DH);
  for (int c = 0; c < nchunk; ++c) {
    const int e0 = c * KC;
    const int n = min(KC, K - e0);
    const long long ec = eb + e0;  // the chunk's first pass-local edge
    bool live = live0;
    if (nchunk > 1) {
      live = edge_chunk<kBf16>(s_g, s_a, s_zh, s_rstd, a.in, p, b, bn, N, K, e0, t);
      if (live) second_layers<V, kBf16>(acc, s_a, s_buf, a.w2f, p, 1, t);
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
    for (int u = t; u < n * H2; u += kThreads) a.A[ec * H2 + u] = s_a[u / H2][u % H2];

    // softmax backward -> dk (and dq); dv. k is second_layers' output, still
    // in the third chunk buffer (pass 1's when the row has one chunk): read
    // there, not kept in registers across the passes, so that no register
    // array stays live through the recompute's first layer and d rbf; dq
    // goes to the row buffer chunk by chunk, for the same reason.
    const int head = cc / DH;
    if (is_k) {
      float dq = 0.f;
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        const float al = s_alpha[e0 + e][head];
        const float dl = al * (s_w[e0 + e] * s_P[e0 + e][head] - s_dot[head]) * scale;
        dq += dl * s_buf[e * kLdc + cc];
      }
      rb[off_dq(V) + cc] += dq;
    }
    __syncthreads();  // k is read: dk|dv overwrite it
    if (is_k) {
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        const float al = s_alpha[e0 + e][head];
        const float dl = al * (s_w[e0 + e] * s_P[e0 + e][head] - s_dot[head]) * scale;
        s_d[e][cc] = dl * qc;
      }
    } else if (!kH2X) {
#pragma unroll
      for (int e = 0; e < KC; ++e) s_d[e][H + cc] = gc * s_alpha[e0 + e][head] * s_w[e0 + e];
    } else if (cc < NH) {
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        const float ds = (s_gx[0] * s_g.rel[e][0] + s_gx[1] * s_g.rel[e][1] +
                          s_gx[2] * s_g.rel[e][2]) * (1.f / NH);
        s_d[e][H + cc] = ds * s_alpha[e0 + e][cc] * s_w[e0 + e];
      }
    }
    __syncthreads();

    // second layers backward: da = d @ W2^T
    if constexpr (kBf16) {
      // d's bias gradient in float32, then d rounded to bf16 in place (the
      // product's operand; its weight gradient rounds it alike)
      if (t < H + V) {
        float s = 0.f;
        for (int e = 0; e < n; ++e) s += s_d[e][t];
        rb[off_db2() + t] += s;
#pragma unroll 4
        for (int e = 0; e < KC; ++e) s_d[e][t] = round_bf16(s_d[e][t]);
      }
      __syncthreads();
    }
    for (int u = t; u < n * (H + V); u += kThreads) {
      const int e = u / (H + V), cl = u % (H + V);
      a.dKV[(ec + e) * (H + V) + cl] = s_d[e][cl];
    }
    if (!kBf16 && t < H + V) {
      float s = 0.f;
      for (int e = 0; e < n; ++e) s += s_d[e][t];
      rb[off_db2() + t] += s;
    }
    transposed_layers<V, kBf16>(s_a, s_d, a.w2f, t);
    __syncthreads();

    // LayerNorm + ReLU backward per (edge, half): dy -> s_a, dz -> s_d
    for (int pair = warp; pair < 2 * n; pair += kThreads / 32) {
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
        dy[q4] = y > 0.f ? s_a[e][cl] : 0.f;
        s_a[e][cl] = dy[q4];
        const float dzh = dy[q4] * lsc[cs];
        m1 += dzh;
        m2 += dzh * zh[q4];
      }
      m1 = warp_sum(m1) * (1.f / H);
      m2 = warp_sum(m2) * (1.f / H);
      const float rstd = s_rstd[e][half];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int cs = lane + 32 * q4;
        s_d[e][half * H + cs] = rstd * (dy[q4] * lsc[cs] - m1 - zh[q4] * m2);
      }
    }
    __syncthreads();

    // per-channel sums: kv LayerNorm partials, d ni; per-edge rows
    {
      const int cl = t;  // kThreads == 2H
      float dsc = 0.f, dbi = 0.f, dn = 0.f;
      for (int e = 0; e < n; ++e) {
        dsc += s_a[e][cl] * s_zh[e][cl];
        dbi += s_a[e][cl];
        dn += s_d[e][cl];
      }
      rb[off_kvln() + cl] += dsc;
      rb[off_kvln() + H2 + cl] += dbi;
      rb[cl] += dn;
    }
    for (int u = t; u < n * H2; u += kThreads) a.dZ[ec * H2 + u] = s_d[u / H2][u % H2];
    for (int u = t; u < n * FE; u += kThreads) {
      const int e = u / FE, f = u % FE;
      const int et = s_g.et[e];
      float v;
      if (f < 4 * R) v = (f / R == et) ? s_g.rbf[e][f % R] : 0.f;
      else v = (f - 4 * R == et) ? 1.f : 0.f;
      a.F[(ec + e) * FE + f] = v;
    }
    // d rbf on the tensor cores; its partials take the free s_a and s_zh
    drbf_chunk<kBf16>(s_drbf, &s_a[0][0], s_d, a.rbff, p.w_rbf, s_g.et, ta, n, t);

    // geometry: d dist -> d rel (x_dst gets +, x_src gets - in gather_kernel)
    if (t < KC) {
      float d3[3] = {0.f, 0.f, 0.f};
      if (t < n) {
        const float dist = s_g.dist[t];
        float dd = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if constexpr (kBf16) {
            // s_g.rbf holds the rounded features; d dist takes the float32 ones
            const float d = dist - a.in.offsets[r];
            dd += s_drbf[t][r] * 2.f * a.in.coeff * d * expf(a.in.coeff * d * d);
          } else {
            dd += s_drbf[t][r] * 2.f * a.in.coeff * (dist - a.in.offsets[r]) * s_g.rbf[t][r];
          }
        }
        const float f = dd / fmaxf(dist, 1e-16f);
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) {
          d3[k3] = f * s_g.rel[t][k3] + (kH2X ? s_gx[k3] * s_sdir[e0 + t] : 0.f);
          a.drel[(ec + t) * 3 + k3] = d3[k3];
        }
      }
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3) s_drel[t][k3] = d3[k3];
    }
    __syncthreads();
    if (t < 3) {
      float s = 0.f;
      for (int e = 0; e < n; ++e) s += s_drel[e][t];
      a.dx[3 * bn + t] += s;
    }
    __syncthreads();  // the next chunk overwrites the chunk buffers
  }
}

// transposed_layers alone, for its time and its check against float64: over
// E edges in chunks of KC, one block a chunk, da [E][2H] = [d_k w2k^T | d_v
// w2v^T] for d [E][H + V] (kBf16: d rounded to bf16 as edge_bwd_kernel rounds
// it), with d and da staged through shared memory as edge_bwd_kernel holds
// them (kTprodSmem bytes). Not a path of the program: its wrapper is
// block_vjp.transposed_product_cuda.
constexpr int kTprodSmem = (KC * H2 + kChunkBuf) * (int)sizeof(float);

template <int V, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
tprod_kernel(const float* __restrict__ d, long long E, const uint4* f, float* __restrict__ da) {
  extern __shared__ __align__(16) float smem[];
  float(*s_da)[H2] = reinterpret_cast<float(*)[H2]>(smem);
  float(*s_d)[kLdd] = reinterpret_cast<float(*)[kLdd]>(smem + KC * H2);
  const int t = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * KC;
  const int n = (int)(E - e0 < KC ? E - e0 : KC);
  for (int u = t; u < KC * (H + V); u += kThreads) {
    const int e = u / (H + V), c = u % (H + V);
    const float v = e < n ? d[(e0 + e) * (H + V) + c] : 0.f;
    s_d[e][c] = kBf16 ? round_bf16(v) : v;
  }
  __syncthreads();
  transposed_layers<V, kBf16>(s_da, s_d, f, t);
  __syncthreads();
  for (int u = t; u < n * H2; u += kThreads) da[e0 * H2 + u] = s_da[u / H2][u % H2];
}

// Inverse adjacency of one pass: off [N+1] and list [(N - row0) * K] of
// each complex group the valid edges whose destination lies in [row0, N)
// by source, each group ascending by pass-local edge id u = (i - row0) K + k
// (gather_kernel sums in that order). A stable counting sort whose order no
// atomic decides, over tiles of adj_tile_edges(N) edges, one warp each:
//   adj_count_kernel  each tile's valid edges per source (cnt [B][tiles][N]);
//   adj_scan_kernel   one block per complex: the exclusive scan of cnt in
//                     (source, tile) order, a block scan per 512 sources,
//                     into each tile's start per source, and off;
//   adj_place_kernel  each tile writes its valid edges at its starts, in
//                     ascending u: 32 edges a step, each edge's rank among
//                     the step's edges of its source from __match_any_sync.
// Bound: reading idx and nmask (9 bytes an edge) and writing list; cnt,
// N ints a tile, never outnumbers the edges.
constexpr int kAdjWarps = 4;          // tiles (one warp each) per block
constexpr int kAdjSteps = 8;          // 32-edge steps whose sources a warp loads at once
constexpr int kAdjScanThreads = 512;  // adj_scan_kernel's block

// The sources of edges s0 + 32 q + lane (q < kAdjSteps) of a pass's slots
// from e0, -1 where masked or at u1 and past: every load issued before any
// is used.
__device__ __forceinline__ void adj_sources(int (&src)[kAdjSteps], const int64_t* __restrict__ idx,
                                            const bool* __restrict__ nmask, long long e0, int s0,
                                            int u1, int lane) {
  bool m[kAdjSteps];
  int64_t v[kAdjSteps];
#pragma unroll
  for (int q = 0; q < kAdjSteps; ++q) {
    const int u = s0 + 32 * q + lane;
    m[q] = u < u1 ? nmask[e0 + u] : false;
    v[q] = u < u1 ? idx[e0 + u] : 0;
  }
#pragma unroll
  for (int q = 0; q < kAdjSteps; ++q) src[q] = m[q] ? (int)v[q] : -1;
}

__global__ void __launch_bounds__(kAdjWarps * 32)
adj_count_kernel(const int64_t* __restrict__ idx, const bool* __restrict__ nmask, int N, int K,
                 int row0, int T, int nt, int* __restrict__ cnt) {
  extern __shared__ int s_adj[];  // [kAdjWarps][N]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kAdjWarps + warp;
  if (t >= nt) return;  // whole warp; the block never synchronises
  const long long b = blockIdx.y;
  const int E = (N - row0) * K;
  const long long e0 = (b * N + row0) * K;
  int* c = s_adj + warp * N;
  for (int j = lane; j < N; j += 32) c[j] = 0;
  __syncwarp();
  const int u1 = min(t * T + T, E);
  for (int s0 = t * T; s0 < u1; s0 += 32 * kAdjSteps) {
    int src[kAdjSteps];
    adj_sources(src, idx, nmask, e0, s0, u1, lane);
#pragma unroll
    for (int q = 0; q < kAdjSteps; ++q)
      if (src[q] >= 0) atomicAdd(&c[src[q]], 1);  // a count: order-free
  }
  __syncwarp();
  int* out = cnt + (b * nt + t) * N;
  for (int j = lane; j < N; j += 32) out[j] = c[j];
}

__global__ void __launch_bounds__(kAdjScanThreads)
adj_scan_kernel(int N, int nt, int* __restrict__ cnt_all, int* __restrict__ off_all) {
  __shared__ int s_warp[kAdjScanThreads / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;
  int* cnt = cnt_all + b * nt * N;
  int* off = off_all + b * (N + 1);
  int carry = 0;  // edges of the sources before this round's
  for (int j0 = 0; j0 < N; j0 += kAdjScanThreads) {
    const int j = j0 + tid;
    int tot = 0;
    if (j < N) {
#pragma unroll 8
      for (int t = 0; t < nt; ++t) tot += cnt[t * N + j];
    }
    int x = tot;  // inclusive scan over the round's sources
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, s);
      if (lane >= s) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kAdjScanThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, s);
        if (lane >= s) w += y;
      }
      if (lane < kAdjScanThreads / 32) s_warp[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    if (j < N) {
      int run = carry + (warp ? s_warp[warp - 1] : 0) + x - tot;
      off[j] = run;
      for (int t0 = 0; t0 < nt; t0 += 8) {  // eight tiles' loads in flight
        int v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = t0 + q < nt ? cnt[(t0 + q) * N + j] : 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (t0 + q < nt) cnt[(t0 + q) * N + j] = run;
          run += v[q];
        }
      }
    }
    carry += s_warp[kAdjScanThreads / 32 - 1];
    __syncthreads();  // s_warp is rewritten by the next round
  }
  if (tid == 0) off[N] = carry;
}

__global__ void __launch_bounds__(kAdjWarps * 32)
adj_place_kernel(const int64_t* __restrict__ idx, const bool* __restrict__ nmask, int N, int K,
                 int row0, int T, int nt, const int* __restrict__ cnt, int* __restrict__ list_all) {
  extern __shared__ int s_adj[];  // [kAdjWarps][N]: the next free slot of each source
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kAdjWarps + warp;
  if (t >= nt) return;  // whole warp; the block never synchronises
  const long long b = blockIdx.y;
  const int E = (N - row0) * K;
  const long long e0 = (b * N + row0) * K;
  int* next = s_adj + warp * N;
  const int* start = cnt + (b * nt + t) * N;
  for (int j = lane; j < N; j += 32) next[j] = start[j];
  __syncwarp();
  int* list = list_all + b * E;
  const unsigned below = (1u << lane) - 1u;
  const int u1 = min(t * T + T, E);
  for (int s0 = t * T; s0 < u1; s0 += 32 * kAdjSteps) {
    int src[kAdjSteps];
    adj_sources(src, idx, nmask, e0, s0, u1, lane);
#pragma unroll
    for (int q = 0; q < kAdjSteps; ++q) {
      const int j = src[q];
      const unsigned peers = __match_any_sync(0xffffffffu, j);
      if (j >= 0) list[next[j] + __popc(peers & below)] = s0 + 32 * q + lane;
      __syncwarp();
      if (j >= 0 && lane == __ffs(peers) - 1) next[j] += __popc(peers);
      __syncwarp();
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
  return reduce_partials(partial, (int)S, Q, out, s);
}

struct Workspace {
  float *ni, *nj, *q, *q1, *qa, *rowbuf, *A, *dKV, *dZ, *F, *drel, *vec, *partial;
  uint4* w2f;  // stage_w2_kernel's fragments, kW2Staged uint4 a staged pass
  uint4* rbff;  // stage_rbf_kernel's fragments
  int *off_x, *list_x, *off_h, *list_h;
};

// The workspace of a backward over B complexes of N nodes, K neighbours and nl
// ligand rows that stages `passes` passes' second layers.
void carve(float* w, int* iw, long long B, long long N, long long K, long long nl, int passes,
           Workspace* ws, long long* floats, long long* ints) {
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
  ws->w2f = reinterpret_cast<uint4*>(take((long long)passes * kW2Staged * 4));
  ws->rbff = reinterpret_cast<uint4*>(take(kRbfFrags * 4));
  *floats = o;
  long long io = 0;
  auto itake = [&](long long n) {
    int* ptr = iw ? iw + io : nullptr;
    io += n;
    return ptr;
  };
  ws->off_x = itake(B * (N + 1));
  ws->list_x = itake(B * N * K + adj_scratch_ints(B, N, N * K));
  ws->off_h = itake(B * (N + 1));
  ws->list_h = itake(B * nl * K + adj_scratch_ints(B, N, nl * K));
  *ints = io;
}

// w2f: the pass's second layers as stage_w2<kBf16> staged them. kBf16: the
// bf16 instantiations (p's product weights bf16, pt float32 and rounded where
// they are read); the gather, the column sums, the reductions and the
// adjacency are shared.
template <bool kH2X, bool kBf16 = false>
int run_pass(const float* h, const EdgeInputs& in0, const PassParams& p, const PassT& pt,
             const PassGrads& g, int B, int N, int K, int row0, const int* off, const int* list,
             float* dh, float* dx, float* dew, const uint4* w2f, const Workspace& ws,
             cudaStream_t s) {
  constexpr int V = kH2X ? NH : H;
  constexpr int W = row_width(V);
  const long long BN = (long long)B * N;
  const long long Ep = (long long)B * (N - row0) * K;
  int err = (int)cudaMemsetAsync(ws.rowbuf, 0, BN * W * sizeof(float), s);
  if (err) return err;
  if ((err = launch_node<kBf16>(h, 1, (int)BN, 0, p, ws.ni, ws.nj, ws.q, ws.q1, s))) return err;

  if constexpr (kBf16)
    stage_rbf16_kernel<<<(kRbfFrags16 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(p.w_rbf), ws.rbff);
  else
    stage_rbf_kernel<<<(kRbfFrags + kThreads - 1) / kThreads, kThreads, 0, s>>>(p.w_rbf,
                                                                                ws.rbff);
  if ((err = (int)cudaGetLastError())) return err;

  EdgeInputs in = in0;
  in.ni = ws.ni;
  in.nj = ws.nj;
  EdgeBwdArgs a{h, in, ws.q, p, pt, N, K, row0, dh, dx, dew, ws.rowbuf, ws.A, ws.dKV, ws.dZ,
                ws.F, ws.drel, w2f, ws.rbff};
  // the largest dynamic shared memory any K takes, set once per process (one device)
  static const int attr = (int)cudaFuncSetAttribute(
      edge_bwd_kernel<kH2X, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem(kMaxLayerK, kH2X));
  if (attr) return attr;
  edge_bwd_kernel<kH2X, kBf16><<<dim3(N - row0, B), kThreads, bwd_smem(K, kH2X), s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  gather_kernel<<<dim3(N, B), kThreads, 0, s>>>(off, list, N, K, N - row0, ws.dZ, ws.drel,
                                                ws.rowbuf, W, dx);
  if ((err = (int)cudaGetLastError())) return err;
  err = launch_node_bwd<kBf16>(ws.q1, p.q_ln, pt.w_q2T, pt.w_nodeT, BN, W, off_dq(V), off_qln(V),
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
    err = weight_grad<kBf16>(pr.X, pr.ldx, pr.Y, pr.ldy, pr.M, pr.P, pr.Q, pr.out, ws.partial,
                             s);
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

// Inverse adjacency of the destination rows [row0, N) of every complex:
// off [B][N+1], list [B][(N - row0) K], then adj_scratch_ints(B, N,
// (N - row0) K) ints of scratch after list. Counted in adj_build_count.
int build_adjacency(const int64_t* idx, const bool* nmask, int B, int N, int K, int row0,
                    int* off, int* list, cudaStream_t s) {
  const int E = (N - row0) * K, T = adj_tile_edges(N), nt = (E + T - 1) / T;
  int* cnt = list + (size_t)B * E;
  const int smem = kAdjWarps * N * (int)sizeof(int);
  int err = 0;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(adj_count_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err)
      err = (int)cudaFuncSetAttribute(adj_place_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  const dim3 grid((nt + kAdjWarps - 1) / kAdjWarps, B);
  adj_count_kernel<<<grid, kAdjWarps * 32, smem, s>>>(idx, nmask, N, K, row0, T, nt, cnt);
  adj_scan_kernel<<<B, kAdjScanThreads, 0, s>>>(N, nt, cnt, off);
  adj_place_kernel<<<grid, kAdjWarps * 32, smem, s>>>(idx, nmask, N, K, row0, T, nt, cnt, list);
  err = (int)cudaGetLastError();
  if (!err) ++adj_build_count;
  return err;
}

}  // namespace
