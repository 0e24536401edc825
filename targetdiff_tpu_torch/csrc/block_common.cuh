// Shared pieces of the block-denoiser forward (block_denoiser.cu) and its
// whole-block backward (block_vjp.cu): the released TargetDiff widths, the
// packed weights of one layer's pass, and the device code both recompute
// identically (node projections, per-edge geometry, the edge MLPs' first
// layer and LayerNorm, the second layers, the masked softmax over K).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H = 128;        // hidden width
constexpr int H2 = 2 * H;     // k|v first-layer width
constexpr int H5 = 5 * H;     // node projection width
constexpr int NH = 16;        // heads
constexpr int DH = H / NH;    // head width (8)
constexpr int R = 20;         // RBF knots
constexpr int KMAX = 32;      // max neighbours per row
constexpr int kThreads = 256;
constexpr int kNodes = 8;     // nodes per node_kernel block
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

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
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

// Per-node projections of one pass: ni = h @ [k.h_i | v.h_i] + b1,
// nj = h @ [k.h_j | v.h_j], q = MLP_q(h). q1 (optional, may be null) receives
// the query MLP's first-layer output before its LayerNorm.
__global__ void __launch_bounds__(kThreads)
node_kernel(const float* __restrict__ h, int rows, PassParams p, float* __restrict__ ni,
            float* __restrict__ nj, float* __restrict__ q, float* __restrict__ q1) {
  __shared__ float s_h[kNodes][H];
  __shared__ float s_q[kNodes][H];
  const int t = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kNodes;
  for (int u = t; u < kNodes * H; u += kThreads) {
    const int nn = u / H, c = u % H;
    s_h[nn][c] = (n0 + nn < rows) ? h[(n0 + nn) * H + c] : 0.f;
  }
  __syncthreads();
  for (int col = t; col < H5; col += kThreads) {
    float acc[kNodes];
    const float bias = p.b_node[col];
#pragma unroll
    for (int nn = 0; nn < kNodes; ++nn) acc[nn] = bias;
    for (int m = 0; m < H; ++m) {
      const float w = p.w_node[m * H5 + col];
#pragma unroll
      for (int nn = 0; nn < kNodes; ++nn) acc[nn] += s_h[nn][m] * w;
    }
#pragma unroll
    for (int nn = 0; nn < kNodes; ++nn) {
      const long long n = n0 + nn;
      if (col >= 4 * H) {
        s_q[nn][col - 4 * H] = acc[nn];
        if (q1 != nullptr && n < rows) q1[n * H + col - 4 * H] = acc[nn];
      } else if (n < rows) {
        if (col < H2) ni[n * H2 + col] = acc[nn];
        else nj[n * H2 + col - H2] = acc[nn];
      }
    }
  }
  __syncthreads();
  {
    const int warp = t >> 5, lane = t & 31;  // kThreads / 32 == kNodes
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = s_q[warp][lane + 32 * c];
    ln_relu_row(v, p.q_ln, p.q_ln + H, lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) s_q[warp][lane + 32 * c] = v[c];
  }
  __syncthreads();
  if (t < H) {
    float acc[kNodes];
#pragma unroll
    for (int nn = 0; nn < kNodes; ++nn) acc[nn] = p.b_q2[t];
    for (int m = 0; m < H; ++m) {
      const float w = p.w_q2[m * H + t];
#pragma unroll
      for (int nn = 0; nn < kNodes; ++nn) acc[nn] += s_q[nn][m] * w;
    }
#pragma unroll
    for (int nn = 0; nn < kNodes; ++nn)
      if (n0 + nn < rows) q[(n0 + nn) * H + t] = acc[nn];
  }
}

// The K edges of destination node bn (complex b): source, edge type
// (0 l->l, 1 l->p, 2 p->l, 3 p->p by (src, dst) ligand), validity, edge
// weight, rel = x_dst - x_src, dist = sqrt(|rel|^2 + 1e-16) and its RBF
// features. Slots K..KMAX-1 are inert (invalid, zero geometry). Threads
// [0, KMAX) of the block; the caller synchronises.
struct EdgeGeometry {
  float rbf[KMAX][R];
  float rel[KMAX][3];
  float dist[KMAX];
  float w[KMAX];
  int j[KMAX];
  int et[KMAX];
  bool valid[KMAX];
};

__device__ __forceinline__ void load_edges(EdgeGeometry& g, const float* __restrict__ x,
                                           const int64_t* __restrict__ idx,
                                           const bool* __restrict__ nmask,
                                           const bool* __restrict__ mlig,
                                           const float* __restrict__ ew,
                                           const float* __restrict__ offsets, float coeff,
                                           long long b, long long bn, int N, int K, int t) {
  if (t >= KMAX) return;
  if (t < K) {
    const long long e = bn * K + t;
    const long long jn = b * N + idx[e];
    const bool src_lig = mlig[jn], dst_lig = mlig[bn];
    g.j[t] = (int)(jn - b * N);
    g.et[t] = src_lig ? (dst_lig ? 0 : 1) : (dst_lig ? 2 : 3);
    g.valid[t] = nmask[e];
    g.w[t] = ew[e];
    const float rx = x[3 * bn] - x[3 * jn], ry = x[3 * bn + 1] - x[3 * jn + 1],
                rz = x[3 * bn + 2] - x[3 * jn + 2];
    g.rel[t][0] = rx;
    g.rel[t][1] = ry;
    g.rel[t][2] = rz;
    const float dist = sqrtf(rx * rx + ry * ry + rz * rz + 1e-16f);
    g.dist[t] = dist;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = dist - offsets[r];
      g.rbf[t][r] = expf(coeff * d * d);
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

// First layer of k|v for every edge slot: thread c of 2H writes
// z[e][c] = ni_i + nj_src + w_et[type] + sum_r rbf_r w_rbf[type][r] (0 for e >= K).
__device__ __forceinline__ void first_layer(float (*z)[H2], const EdgeGeometry& g,
                                            const float* __restrict__ ni,
                                            const float* __restrict__ nj, const PassParams& p,
                                            long long b, long long bn, int N, int K, int c) {
  const float zi = ni[bn * H2 + c];
  for (int e = 0; e < KMAX; ++e) {
    float v = 0.f;
    if (e < K) {
      const int et = g.et[e];
      v = zi + nj[(b * N + g.j[e]) * H2 + c] + p.w_et[et * H2 + c];
      const float* wr = p.w_rbf + (size_t)et * R * H2 + c;
#pragma unroll
      for (int r = 0; r < R; ++r) v += g.rbf[e][r] * wr[r * H2];
    }
    z[e][c] = v;
  }
}

// LayerNorm + ReLU of each (edge, k|v half) row of z in place, a warp per
// row. With zhat non-null, also keeps the normalised rows (before scale and
// bias) and their 1/std for the backward.
__device__ __forceinline__ void ln_relu_edges(float (*z)[H2], const float* kv_ln, int K,
                                              float (*zhat)[H2], float (*rstd_out)[2], int t) {
  const int warp = t >> 5, lane = t & 31;
  for (int pair = warp; pair < 2 * K; pair += kThreads / 32) {
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

// Second layer of one output channel cc for all KMAX edge slots:
// out[e] = bias + sum_m a[e][zoff + m] W[m][cc] (W is [H][ldw]).
__device__ __forceinline__ void second_layer(float (&out)[KMAX], const float (*a)[H2], int zoff,
                                             const float* __restrict__ W, int ldw, float bias,
                                             int cc) {
#pragma unroll
  for (int e = 0; e < KMAX; ++e) out[e] = bias;
  for (int m = 0; m < H; m += 4) {
    const float w0 = W[(m + 0) * ldw + cc], w1 = W[(m + 1) * ldw + cc],
                w2 = W[(m + 2) * ldw + cc], w3 = W[(m + 3) * ldw + cc];
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      const float4 z4 = *reinterpret_cast<const float4*>(&a[e][zoff + m]);
      out[e] += z4.x * w0 + z4.y * w1 + z4.z * w2 + z4.w * w3;
    }
  }
}

// Attention weights of one head for a k-channel thread (threads [0, H), whole
// warps): k[e] holds channel cc of k for every edge; on return it holds
// alpha[e] of the channel's head (a max-shifted softmax over the valid
// edges; 0 for invalid ones, all 0 when the row has none), and lanes with
// cc % DH == 0 store it to alpha_out[e][head].
__device__ __forceinline__ void head_softmax(float (&k)[KMAX], float qc, const bool* valid,
                                             float (*alpha_out)[NH], int cc) {
  const float scale = rsqrtf((float)DH);
#pragma unroll
  for (int e = 0; e < KMAX; ++e) {
    float l = k[e] * qc;
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    k[e] = l * scale;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < KMAX; ++e)
    if (valid[e]) mx = fmaxf(mx, k[e]);
  float den = 0.f;
#pragma unroll
  for (int e = 0; e < KMAX; ++e) {
    k[e] = valid[e] ? expf(k[e] - mx) : 0.f;
    den += k[e];
  }
  const float inv = 1.f / fmaxf(den, 1e-16f);
#pragma unroll
  for (int e = 0; e < KMAX; ++e) k[e] *= inv;
  if (cc % DH == 0) {
#pragma unroll
    for (int e = 0; e < KMAX; ++e) alpha_out[e][cc / DH] = k[e];
  }
}

}  // namespace
