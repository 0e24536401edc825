// Shared pieces of the attention passes' forward kernels (node_proj.cuh,
// x2h_edge.cuh, h2x_edge.cuh; tc_common.cuh holds their tensor-core parts)
// and of their backward (pass_bwd.cuh): the released TargetDiff widths, the
// packed weights of one layer's pass, and the device code the backward
// recomputes the forward with (per-edge geometry, the edge MLPs' first layer
// and LayerNorm, the attention logits and the masked softmax over a row's
// edges; its second layers run on tc_common.cuh's products).
//
// A destination row's K edges are processed in chunks of KC = 32: one chunk
// of edges lives in shared memory and registers at a time, so any K up to
// kMaxLayerK works. A chunk without a valid edge is skipped: it contributes
// nothing (its attention weights are exactly zero), and the hybrid graph's
// rows keep their valid edges first, so most of their masked slots fall in
// skipped chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H = 128;          // hidden width
constexpr int H2 = 2 * H;       // k|v first-layer width
constexpr int H5 = 5 * H;       // node projection width
constexpr int NH = 16;          // heads
constexpr int DH = H / NH;      // head width (8)
constexpr int R = 20;           // RBF knots
constexpr int KC = 32;          // edges per chunk
constexpr int kMaxBlockK = 32;  // neighbours per row, whole-block entry points
constexpr int kMaxLayerK = 256; // neighbours per row, per-layer entry points
constexpr int kThreads = 256;
constexpr float kLnEps = 1e-5f;

}  // namespace

// One layer's weights for one pass, float32, [in, out] row-major. Packed by
// targetdiff_tpu_torch/ops/kernels/block_denoiser.py:_pack_pass.
struct PassParams {
  const float* w_node;  // [H][5H]
  const float* b_node;  // [5H]
  const float* q_ln;    // [2][H] scale, bias
  const float* w_q2;    // [H][H]
  const float* b_q2;    // [H]
  const float* w_rbf;   // [4][R][2H] edge type x knot x (k|v)
  const float* w_et;    // [4][2H]
  const float* kv_ln;   // [2][2H] scale, bias of k|v
  const float* w2k;     // [H][H]
  const float* b2k;     // [H]
  const float* w2v;     // [H][V], V = H (x2h) or NH (h2x)
  const float* b2v;     // [V]
};

// The graph and node inputs every edge kernel reads.
struct EdgeInputs {
  const float* x;        // [B*N][3]
  const int64_t* idx;    // [B*N][K]
  const bool* nmask;     // [B*N][K]
  const bool* mlig;      // [B*N]
  const float* ew;       // [B*N][K]
  const float* ni;       // [B*N][2H] destination projections
  const float* nj;       // [B*N][2H] source projections
  const float* offsets;  // [R]
  float coeff;
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// LayerNorm statistics of one 128-wide row held as 4 values per lane
// (channel lane + 32 q); two-pass mean and variance, eps 1e-5.
__device__ __forceinline__ void ln_stats(const float (&v)[4], float& mean, float& rstd) {
  mean = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.f / H);
  float sq = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) sq += (v[q] - mean) * (v[q] - mean);
  rstd = rsqrtf(warp_sum(sq) * (1.f / H) + kLnEps);
}

// LayerNorm + ReLU of one 128-wide row in place (4 values per lane).
__device__ __forceinline__ void ln_relu_row(float (&v)[4], const float* scale, const float* bias,
                                            int lane) {
  float mean, rstd;
  ln_stats(v, mean, rstd);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    v[q] = fmaxf((v[q] - mean) * rstd * scale[c] + bias[c], 0.f);
  }
}

// One chunk of the edges of destination node bn (complex b): slot s holds
// edge e0 + s with its source, edge type (0 l->l, 1 l->p, 2 p->l, 3 p->p by
// (src, dst) ligand), validity, edge weight, rel = x_dst - x_src,
// dist = sqrt(|rel|^2 + 1e-16) and its RBF features. Slots past the row's K
// edges are inert (invalid, zero weight and geometry).
struct EdgeGeometry {
  float rbf[KC][R];
  float rel[KC][3];
  float dist[KC];
  float w[KC];
  int j[KC];
  int et[KC];
  bool valid[KC];
};

// Threads [0, KC) of the block fill slot t; the caller synchronises. bf16
// (kBf16): the RBF features are stored rounded to bf16, the first layer's
// product operands (the forward kernels round them so).
template <bool kBf16 = false>
__device__ __forceinline__ void load_edges(EdgeGeometry& g, const EdgeInputs& in, long long b,
                                           long long bn, int N, int K, int e0, int t) {
  if (t >= KC) return;
  if (e0 + t < K) {
    const long long e = bn * K + e0 + t;
    const long long jn = b * N + in.idx[e];
    const bool src_lig = in.mlig[jn], dst_lig = in.mlig[bn];
    g.j[t] = (int)(jn - b * N);
    g.et[t] = src_lig ? (dst_lig ? 0 : 1) : (dst_lig ? 2 : 3);
    g.valid[t] = in.nmask[e];
    g.w[t] = in.ew[e];
    const float* x = in.x;
    const float rx = x[3 * bn] - x[3 * jn], ry = x[3 * bn + 1] - x[3 * jn + 1],
                rz = x[3 * bn + 2] - x[3 * jn + 2];
    g.rel[t][0] = rx;
    g.rel[t][1] = ry;
    g.rel[t][2] = rz;
    const float dist = sqrtf(rx * rx + ry * ry + rz * rz + 1e-16f);
    g.dist[t] = dist;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = dist - in.offsets[r];
      if constexpr (kBf16)
        g.rbf[t][r] = __bfloat162float(__float2bfloat16_rn(expf(in.coeff * d * d)));
      else
        g.rbf[t][r] = expf(in.coeff * d * d);
    }
  } else {
    g.j[t] = 0;
    g.et[t] = 3;
    g.valid[t] = false;
    g.w[t] = 0.f;
    g.rel[t][0] = g.rel[t][1] = g.rel[t][2] = 0.f;
    g.dist[t] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) g.rbf[t][r] = 0.f;
  }
}

// First layer of k|v for the chunk's n live slots: thread c of 2H writes
// z[e][c] = ni_i + nj_src + w_et[type] + sum_r rbf_r w_rbf[type][r], r
// ascending (0 for e >= n). A destination row's edges have two types, ta
// (ligand source) and ta + 2 (protein source): one type at a time, the
// thread loads its column of that type's table into registers once per
// chunk and applies it to the slots of that type (both types' columns at
// once, selected per slot, spilled more and ran slower: PERF.md). bf16
// (kBf16): w_rbf and w_et are bf16 weights (tc_common.cuh WeightT), g's RBF
// features rounded to bf16 (load_edges<true>).
template <bool kBf16 = false>
__device__ __forceinline__ void first_layer(float (*z)[H2], const EdgeGeometry& g,
                                            const EdgeInputs& in, const PassParams& p,
                                            long long b, long long bn, int N, int n, int c) {
  const int ta = in.mlig[bn] ? 0 : 1;
  const float zi = in.ni[bn * H2 + c];
  for (int e = n; e < KC; ++e) z[e][c] = 0.f;
  for (int ty = ta; ty < 4; ty += 2) {
    float w[R], wet;
    if constexpr (kBf16) {
      const __nv_bfloat16* w_rbf = reinterpret_cast<const __nv_bfloat16*>(p.w_rbf);
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = __bfloat162float(w_rbf[(ty * R + r) * H2 + c]);
      wet = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.w_et)[ty * H2 + c]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = p.w_rbf[(ty * R + r) * H2 + c];
      wet = p.w_et[ty * H2 + c];
    }
    for (int e = 0; e < n; ++e) {
      if (g.et[e] != ty) continue;
      float v = zi + in.nj[(b * N + g.j[e]) * H2 + c] + wet;
#pragma unroll
      for (int r = 0; r < R; ++r) v += g.rbf[e][r] * w[r];
      z[e][c] = v;
    }
  }
}

// LayerNorm + ReLU of each (edge, k|v half) row of z in place, a warp per
// row, for the first n edges. With zhat non-null, also keeps the normalised
// rows (before scale and bias) and their 1/std for the backward.
__device__ __forceinline__ void ln_relu_edges(float (*z)[H2], const float* kv_ln, int n,
                                              float (*zhat)[H2], float (*rstd_out)[2], int t) {
  const int warp = t >> 5, lane = t & 31;
  for (int pair = warp; pair < 2 * n; pair += kThreads / 32) {
    const int e = pair >> 1, half = pair & 1;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = z[e][half * H + lane + 32 * q];
    float mean, rstd;
    ln_stats(v, mean, rstd);
    const float* scale = kv_ln + half * H;
    const float* bias = kv_ln + H2 + half * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      const float zh = (v[q] - mean) * rstd;
      if (zhat != nullptr) zhat[e][half * H + c] = zh;
      z[e][half * H + c] = fmaxf(zh * scale[c] + bias[c], 0.f);
    }
    if (zhat != nullptr && lane == 0) rstd_out[e][half] = rstd;
  }
}

// Loads chunk e0 of row bn and, when it holds a valid edge, computes its
// post-LayerNorm first-layer activations into z (and zhat / rstd, if given).
// Block-wide; returns whether the chunk holds a valid edge (the same on
// every thread). A chunk without one is left as loaded: its attention
// weights are zero, so it contributes nothing. kBf16: the bf16 forward's
// first layer (load_edges<true>, first_layer<true>).
template <bool kBf16 = false>
__device__ __forceinline__ bool edge_chunk(EdgeGeometry& g, float (*z)[H2], float (*zhat)[H2],
                                           float (*rstd)[2], const EdgeInputs& in,
                                           const PassParams& p, long long b, long long bn, int N,
                                           int K, int e0, int t) {
  load_edges<kBf16>(g, in, b, bn, N, K, e0, t);
  if (!__syncthreads_or(t < KC && g.valid[t])) return false;
  const int n = min(KC, K - e0);
  first_layer<kBf16>(z, g, in, p, b, bn, N, n, t);
  __syncthreads();
  ln_relu_edges(z, p.kv_ln, n, zhat, rstd, t);
  __syncthreads();
  return true;
}

// Attention logits of one chunk for a k-channel thread (threads [0, H),
// whole warps): k[e] holds channel cc of k for each slot; lanes with
// cc % DH == 0 store q.k / sqrt(dh) of their head to logit[e][head], or
// -inf for an invalid slot.
__device__ __forceinline__ void head_logits(const float (&k)[KC], float qc, const bool* valid,
                                            float (*logit)[NH], int cc) {
  const float scale = rsqrtf((float)DH);
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    float l = k[e] * qc;
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    if (cc % DH == 0) logit[e][cc / DH] = valid[e] ? l * scale : -INFINITY;
  }
}

// In place, logits [KP][NH] -> attention weights: per head a max-shifted
// softmax over the row's K edges; invalid edges (-inf) get 0, a row without
// a valid edge all 0, and slots [K, KP) 0. A warp per head, block-wide.
__device__ __forceinline__ void row_softmax(float (*a)[NH], int K, int KP, int t) {
  const int warp = t >> 5, lane = t & 31;
  for (int hh = warp; hh < NH; hh += kThreads / 32) {
    float mx = -INFINITY;
    for (int e = lane; e < K; e += 32) mx = fmaxf(mx, a[e][hh]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int e = lane; e < K; e += 32) {
      const float v = mx == -INFINITY ? 0.f : expf(a[e][hh] - mx);
      a[e][hh] = v;
      den += v;
    }
    const float inv = 1.f / fmaxf(warp_sum(den), 1e-16f);
    for (int e = lane; e < KP; e += 32) a[e][hh] = e < K ? a[e][hh] * inv : 0.f;
  }
}

}  // namespace
