// Shared pieces of the attention-pass forward (block_denoiser.cu,
// edge_layer.cu) and its backward (pass_bwd.cuh): the released TargetDiff
// widths, the packed weights of one layer's pass, the device code every
// kernel recomputes identically (node projections, per-edge geometry, the
// edge MLPs' first layer and LayerNorm, the second layers, the attention
// logits and the masked softmax over a row's edges), and the h2x edge
// kernel. The x2h edge kernel is x2h_edge.cuh.
//
// A destination row's K edges are processed in chunks of KC = 32: one chunk
// of edges lives in shared memory and registers at a time, and the row's
// per-edge attention logits (then weights) sit in a [K][heads] shared array,
// so any K up to kMaxLayerK works. A chunk without a valid edge is skipped:
// it contributes nothing (its attention weights are exactly zero), and the
// hybrid graph's rows keep their valid edges first, so most of their masked
// slots fall in skipped chunks.
#pragma once

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
constexpr int kNodes = 8;       // nodes per node_kernel block
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

// Threads [0, KC) of the block fill slot t; the caller synchronises.
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
// z[e][c] = ni_i + nj_src + w_et[type] + sum_r rbf_r w_rbf[type][r] (0 for e >= n).
__device__ __forceinline__ void first_layer(float (*z)[H2], const EdgeGeometry& g,
                                            const EdgeInputs& in, const PassParams& p,
                                            long long b, long long bn, int N, int n, int c) {
  const float zi = in.ni[bn * H2 + c];
  for (int e = 0; e < KC; ++e) {
    float v = 0.f;
    if (e < n) {
      const int et = g.et[e];
      v = zi + in.nj[(b * N + g.j[e]) * H2 + c] + p.w_et[et * H2 + c];
      const float* wr = p.w_rbf + (size_t)et * R * H2 + c;
#pragma unroll
      for (int r = 0; r < R; ++r) v += g.rbf[e][r] * wr[r * H2];
    }
    z[e][c] = v;
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
// weights are zero, so it contributes nothing.
__device__ __forceinline__ bool edge_chunk(EdgeGeometry& g, float (*z)[H2], float (*zhat)[H2],
                                           float (*rstd)[2], const EdgeInputs& in,
                                           const PassParams& p, long long b, long long bn, int N,
                                           int K, int e0, int t) {
  load_edges(g, in, b, bn, N, K, e0, t);
  if (!__syncthreads_or(t < KC && g.valid[t])) return false;
  const int n = min(KC, K - e0);
  first_layer(z, g, in, p, b, bn, N, n, t);
  __syncthreads();
  ln_relu_edges(z, p.kv_ln, n, zhat, rstd, t);
  __syncthreads();
  return true;
}

// Second layer of one output channel cc for all KC edge slots:
// out[e] = bias + sum_m a[e][zoff + m] W[m][cc] (W is [H][ldw]).
__device__ __forceinline__ void second_layer(float (&out)[KC], const float (*a)[H2], int zoff,
                                             const float* __restrict__ W, int ldw, float bias,
                                             int cc) {
#pragma unroll
  for (int e = 0; e < KC; ++e) out[e] = bias;
  for (int m = 0; m < H; m += 4) {
    const float w0 = W[(m + 0) * ldw + cc], w1 = W[(m + 1) * ldw + cc],
                w2 = W[(m + 2) * ldw + cc], w3 = W[(m + 3) * ldw + cc];
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const float4 z4 = *reinterpret_cast<const float4*>(&a[e][zoff + m]);
      out[e] += z4.x * w0 + z4.y * w1 + z4.z * w2 + z4.w * w3;
    }
  }
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

// Attention weights of one head for a k-channel thread when the row has a
// single chunk (threads [0, H), whole warps): k[e] holds channel cc of k for
// every slot; on return it holds alpha[e] of the channel's head (a
// max-shifted softmax over the valid slots; 0 for invalid ones, all 0 when
// the row has none), and lanes with cc % DH == 0 store it to
// alpha_out[e][head]. Registers only: the weights of head_logits +
// row_softmax without their shared-memory round trip.
__device__ __forceinline__ void head_softmax(float (&k)[KC], float qc, const bool* valid,
                                             float (*alpha_out)[NH], int cc) {
  const float scale = rsqrtf((float)DH);
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    float l = k[e] * qc;
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    k[e] = l * scale;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < KC; ++e)
    if (valid[e]) mx = fmaxf(mx, k[e]);
  float den = 0.f;
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    k[e] = valid[e] ? expf(k[e] - mx) : 0.f;
    den += k[e];
  }
  const float inv = 1.f / fmaxf(den, 1e-16f);
#pragma unroll
  for (int e = 0; e < KC; ++e) k[e] *= inv;
  if (cc % DH == 0) {
#pragma unroll
    for (int e = 0; e < KC; ++e) alpha_out[e][cc / DH] = k[e];
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

// Dynamic shared memory of h2x_edge_kernel: the row's attention weights.
__host__ __device__ constexpr int edge_smem(int K) {
  return (K + KC - 1) / KC * KC * NH * (int)sizeof(float);
}

// The h2x attention sub-layer for one destination row per block (blockIdx.x
// = row - row0, blockIdx.y = complex): writes out = x + mask_ligand *
// sum_k mean_h(alpha * e_w * v) * rel on rows from row0. kOneChunk (K <= 32):
// one pass, k and v together and the softmax in registers. Otherwise pass 1
// walks the chunks for the logits, and after the row softmax pass 2
// recomputes each chunk's values and sums them. (The x2h pass has its own
// kernel, x2h_edge.cuh.)
template <bool kOneChunk>
__global__ void __launch_bounds__(kThreads)
h2x_edge_kernel(EdgeInputs in, const float* __restrict__ qn, PassParams p, int N, int K, int row0,
                float* __restrict__ out) {
  constexpr int V = NH;  // value width
  __shared__ __align__(16) float s_z[KC][H2];
  __shared__ EdgeGeometry s_g;
  extern __shared__ float smem_alpha[];
  float(*s_alpha)[NH] = reinterpret_cast<float(*)[NH]>(smem_alpha);  // [KP][NH]

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const long long b = blockIdx.y;
  const long long bn = b * N + row0 + blockIdx.x;
  const int nchunk = kOneChunk ? 1 : (K + KC - 1) / KC;

  // threads [0, H) own k channel t, threads [H, H + V) value channel t - H
  const bool is_k = t < H;
  const int cc = is_k ? t : t - H;
  const bool active = is_k || cc < V;
  const float qc = is_k ? qn[bn * H + cc] : 0.f;
  float acc[KC];
  bool live0 = false;
  if (kOneChunk) {  // k and v together, the softmax in registers
    live0 = edge_chunk(s_g, s_z, nullptr, nullptr, in, p, b, bn, N, K, 0, t);
    if (live0 && active) {
      if (is_k) {
        second_layer(acc, s_z, 0, p.w2k, H, p.b2k[cc], cc);
        head_softmax(acc, qc, s_g.valid, s_alpha, cc);
      } else {
        second_layer(acc, s_z, H, p.w2v, V, p.b2v[cc], cc);
      }
    }
  } else {  // the logits of every chunk, then the row softmax
    for (int c = 0; c < nchunk; ++c) {
      const int e0 = c * KC;
      const bool live = edge_chunk(s_g, s_z, nullptr, nullptr, in, p, b, bn, N, K, e0, t);
      if (live && is_k) {
        second_layer(acc, s_z, 0, p.w2k, H, p.b2k[cc], cc);
        head_logits(acc, qc, s_g.valid, s_alpha + e0, cc);
      } else if (!live && is_k && cc % DH == 0) {
        for (int e = 0; e < KC; ++e) s_alpha[e0 + e][cc / DH] = -INFINITY;
      }
      __syncthreads();
    }
    row_softmax(s_alpha, K, nchunk * KC, t);
  }
  __syncthreads();

  float d0 = 0.f, d1 = 0.f, d2 = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const int e0 = c * KC;
    bool live = live0;
    if (!kOneChunk) {
      live = edge_chunk(s_g, s_z, nullptr, nullptr, in, p, b, bn, N, K, e0, t);
      if (live && !is_k && active) second_layer(acc, s_z, H, p.w2v, V, p.b2v[cc], cc);
    }
    if (live && warp == H / 32) {  // value channels 0..NH-1 are lanes 0..NH-1
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        float g = cc < NH ? s_alpha[e0 + e][cc] * s_g.w[e] * acc[e] : 0.f;
        g = warp_sum(g) * (1.f / NH);
        d0 += g * s_g.rel[e][0];
        d1 += g * s_g.rel[e][1];
        d2 += g * s_g.rel[e][2];
      }
    }
    if (!kOneChunk) __syncthreads();  // the next chunk overwrites s_g and s_z
  }

  if (warp == H / 32 && lane == 0) {
    const float* x = in.x;
    const float gate = in.mlig[bn] ? 1.f : 0.f;
    out[3 * bn] = x[3 * bn] + gate * d0;
    out[3 * bn + 1] = x[3 * bn + 1] + gate * d1;
    out[3 * bn + 2] = x[3 * bn + 2] + gate * d2;
  }
}

int launch_h2x(const EdgeInputs& in, const float* q, const PassParams& p, int B, int N, int K,
               int row0, float* out, cudaStream_t s) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxLayerK || row0 < 0 || row0 >= N)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N - row0, B);
  if (K <= KC) {
    h2x_edge_kernel<true><<<grid, kThreads, edge_smem(K), s>>>(in, q, p, N, K, row0, out);
  } else {
    // the largest dynamic shared memory any K takes, set once per process (one device)
    static const int attr = (int)cudaFuncSetAttribute(
        h2x_edge_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        edge_smem(kMaxLayerK));
    if (attr) return attr;
    h2x_edge_kernel<false><<<grid, kThreads, edge_smem(K), s>>>(in, q, p, N, K, row0, out);
  }
  return (int)cudaGetLastError();
}

int launch_node(const float* h, int rows, const PassParams& p, float* ni, float* nj, float* q,
                float* q1, cudaStream_t s) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  node_kernel<<<(rows + kNodes - 1) / kNodes, kThreads, 0, s>>>(h, rows, p, ni, nj, q, q1);
  return (int)cudaGetLastError();
}

}  // namespace
