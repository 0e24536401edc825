// Block-denoiser kernels for Hopper (sm_90a): all layers of one
// UniTransformerO2 block (released TargetDiff widths: hidden 128, 16 heads,
// 20 RBF knots, K <= 32 neighbours), float32 throughout.
//
// Replaces: targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel
// (block_denoiser), inference mode with every tile live. It computes what
// that kernel computes, not its TPU encodings: neighbours are read with
// native gathers instead of one-hot matmuls, and the softmax over K is
// max-shifted instead of clipped.
//
// What bounds it: per layer and complex the x2h edge MLPs cost about
// N*K*37k multiply-adds (two 128x128 second layers per edge dominate; the
// first layers collapse to per-node projections plus a 20-row table lookup
// per edge), about 0.7 GFLOP at N = 608, K = 32. Device memory traffic is
// small (node rows and weights, both L2-resident), so the kernels are bound
// by the float32 FMA pipes and the shared-memory operand reads feeding them.
//
// Design, per block:
//   ew_kernel    once: the global edge-weight MLP on block-start distances
//                (a warp per edge).
//   node_kernel  per pass: h @ [k.h_i | v.h_i | k.h_j | v.h_j | q1] plus the
//                query MLP's LayerNorm and second layer (8 nodes per block),
//                so the edge kernels never multiply h per edge.
//   edge_kernel  per pass: one block per destination row. It builds the K
//                edges' geometry and RBF features, sums the first layer
//                from the node projections (gathering the source's) and the
//                edge-type table, applies LayerNorm+ReLU, runs both second
//                layers from shared memory with every thread holding all K
//                edges of one output channel in registers, then the
//                per-head softmax over K by shuffles and the weighted sum.
//                x2h writes h' for every row; h2x runs on the ligand rows
//                (the tail of the composed layout) and writes x'.
// All intermediates of an edge stay in shared memory or registers; only the
// [B, N, K] edge weights and the per-node projections reach device memory.

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

struct EwParams {
  const float* w1;  // [R][H]
  const float* b1;  // [H]
  const float* ln;  // [2][H]
  const float* w2;  // [H]
  const float* b2;  // [1]
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm + ReLU of one 128-wide row held as 4 values per lane
// (channel lane + 32 q); two-pass mean and variance, eps 1e-5.
__device__ __forceinline__ void ln_relu_row(float (&v)[4], const float* scale, const float* bias,
                                            int lane) {
  const float mean = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.f / H);
  float sq = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) sq += (v[q] - mean) * (v[q] - mean);
  const float rstd = rsqrtf(warp_sum(sq) * (1.f / H) + kLnEps);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    v[q] = fmaxf((v[q] - mean) * rstd * scale[c] + bias[c], 0.f);
  }
}

// Global edge weights: e_w = sigmoid(w2 . relu(LN(rbf(d0) @ w1 + b1)) + b2)
// for every edge of the block-start graph; one warp per edge.
__global__ void __launch_bounds__(kThreads)
ew_kernel(const float* __restrict__ x, const int64_t* __restrict__ idx, int N, int K,
          long long E, const float* __restrict__ offsets, float coeff, EwParams p,
          float* __restrict__ ew) {
  __shared__ float s_w1[R * H];
  __shared__ float s_off[R];
  for (int t = threadIdx.x; t < R * H; t += kThreads) s_w1[t] = p.w1[t];
  if (threadIdx.x < R) s_off[threadIdx.x] = offsets[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float b2 = p.b2[0];
  for (long long e = (long long)blockIdx.x * (kThreads / 32) + warp; e < E;
       e += (long long)gridDim.x * (kThreads / 32)) {
    const long long bn = e / K;        // destination node b*N + i
    const long long b = bn / N;
    const long long jn = b * N + idx[e];
    const float dx = x[3 * bn] - x[3 * jn], dy = x[3 * bn + 1] - x[3 * jn + 1],
                dz = x[3 * bn + 2] - x[3 * jn + 2];
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz + 1e-16f);
    float z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] = p.b1[lane + 32 * q];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = dist - s_off[r];
      const float rbf = expf(coeff * d * d);
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] += rbf * s_w1[r * H + lane + 32 * q];
    }
    ln_relu_row(z, p.ln, p.ln + H, lane);
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) part += z[q] * p.w2[lane + 32 * q];
    const float logit = warp_sum(part) + b2;
    if (lane == 0) ew[e] = 1.f / (1.f + expf(-logit));
  }
}

// Per-node projections of one pass: ni = h @ [k.h_i | v.h_i] + b1,
// nj = h @ [k.h_j | v.h_j], q = MLP_q(h).
__global__ void __launch_bounds__(kThreads)
node_kernel(const float* __restrict__ h, int rows, PassParams p, float* __restrict__ ni,
            float* __restrict__ nj, float* __restrict__ q) {
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

// One attention sub-layer for one destination row per block (blockIdx.x =
// row - row0, blockIdx.y = complex). kH2X = false: x2h, writes
// out = h + attention average of v (all rows). kH2X = true: h2x, writes
// out = x + mask_ligand * sum_k mean_h(alpha * e_w * v) * rel (rows from row0).
template <bool kH2X>
__global__ void __launch_bounds__(kThreads)
edge_kernel(const float* __restrict__ h, const float* __restrict__ x,
            const int64_t* __restrict__ idx, const bool* __restrict__ nmask,
            const bool* __restrict__ mlig, const float* __restrict__ ew,
            const float* __restrict__ ni, const float* __restrict__ nj,
            const float* __restrict__ qn, const float* __restrict__ offsets, float coeff,
            PassParams p, int N, int K, int row0, float* __restrict__ out) {
  constexpr int V = kH2X ? NH : H;  // value width
  __shared__ __align__(16) float s_z[KMAX][H2];
  __shared__ float s_rbf[KMAX][R];
  __shared__ float s_rel[KMAX][3];
  __shared__ float s_w[KMAX];
  __shared__ int s_j[KMAX];
  __shared__ int s_et[KMAX];
  __shared__ bool s_valid[KMAX];
  __shared__ float s_alpha[KMAX][NH];

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const long long b = blockIdx.y;
  const long long bn = b * N + row0 + blockIdx.x;

  // edge geometry, type and RBF features
  if (t < KMAX) {
    if (t < K) {
      const long long e = bn * K + t;
      const long long jn = b * N + idx[e];
      const bool src_lig = mlig[jn], dst_lig = mlig[bn];
      s_j[t] = (int)(jn - b * N);
      s_et[t] = src_lig ? (dst_lig ? 0 : 1) : (dst_lig ? 2 : 3);
      s_valid[t] = nmask[e];
      s_w[t] = ew[e];
      const float rx = x[3 * bn] - x[3 * jn], ry = x[3 * bn + 1] - x[3 * jn + 1],
                  rz = x[3 * bn + 2] - x[3 * jn + 2];
      s_rel[t][0] = rx;
      s_rel[t][1] = ry;
      s_rel[t][2] = rz;
      const float dist = sqrtf(rx * rx + ry * ry + rz * rz + 1e-16f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = dist - offsets[r];
        s_rbf[t][r] = expf(coeff * d * d);
      }
    } else {
      s_j[t] = 0;
      s_et[t] = 3;
      s_valid[t] = false;
      s_w[t] = 0.f;
      s_rel[t][0] = s_rel[t][1] = s_rel[t][2] = 0.f;
    }
  }
  __syncthreads();

  // first layer of k|v: channel c = t of 2H
  {
    const int c = t;
    const float zi = ni[bn * H2 + c];
    for (int e = 0; e < KMAX; ++e) {
      float z = 0.f;
      if (e < K) {
        const int et = s_et[e];
        z = zi + nj[(b * N + s_j[e]) * H2 + c] + p.w_et[et * H2 + c];
        const float* wr = p.w_rbf + (size_t)et * R * H2 + c;
#pragma unroll
        for (int r = 0; r < R; ++r) z += s_rbf[e][r] * wr[r * H2];
      }
      s_z[e][c] = z;
    }
  }
  __syncthreads();

  // LayerNorm + ReLU per (edge, k|v half): a warp per row of 128
  for (int pair = warp; pair < 2 * K; pair += kThreads / 32) {
    const int e = pair >> 1, half = pair & 1;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = s_z[e][half * H + lane + 32 * q];
    ln_relu_row(v, p.kv_ln + half * H, p.kv_ln + H2 + half * H, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) s_z[e][half * H + lane + 32 * q] = v[q];
  }
  __syncthreads();

  // second layers: threads [0, H) compute k channel t, threads [H, H + V)
  // value channel t - H, each for all KMAX edges
  const bool is_k = t < H;
  const int cc = is_k ? t : t - H;
  const bool active = is_k || cc < V;
  float acc[KMAX];
  if (active) {
    const float* W = is_k ? p.w2k : p.w2v;
    const int ldw = is_k ? H : V;
    const int zoff = is_k ? 0 : H;
    const float bias = is_k ? p.b2k[cc] : p.b2v[cc];
#pragma unroll
    for (int e = 0; e < KMAX; ++e) acc[e] = bias;
    for (int m = 0; m < H; m += 4) {
      const float w0 = W[(m + 0) * ldw + cc], w1 = W[(m + 1) * ldw + cc],
                  w2 = W[(m + 2) * ldw + cc], w3 = W[(m + 3) * ldw + cc];
#pragma unroll
      for (int e = 0; e < KMAX; ++e) {
        const float4 z4 = *reinterpret_cast<const float4*>(&s_z[e][zoff + m]);
        acc[e] += z4.x * w0 + z4.y * w1 + z4.z * w2 + z4.w * w3;
      }
    }
  }

  // logits q.k / sqrt(dh) per head (8-lane groups), max-shifted softmax over K
  if (is_k) {  // warps 0-3, whole warps
    const float qc = qn[bn * H + cc];
    const float scale = rsqrtf((float)DH);
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      float l = acc[e] * qc;
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      acc[e] = l * scale;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < KMAX; ++e)
      if (s_valid[e]) mx = fmaxf(mx, acc[e]);
    float den = 0.f;
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      acc[e] = s_valid[e] ? expf(acc[e] - mx) : 0.f;
      den += acc[e];
    }
    const float inv = 1.f / fmaxf(den, 1e-16f);
    if (cc % DH == 0) {
#pragma unroll
      for (int e = 0; e < KMAX; ++e) s_alpha[e][cc / DH] = acc[e] * inv;
    }
  }
  __syncthreads();

  if (!kH2X) {
    if (!is_k) {
      const int head = cc / DH;
      float o = 0.f;
#pragma unroll
      for (int e = 0; e < KMAX; ++e) o += s_alpha[e][head] * s_w[e] * acc[e];
      out[bn * H + cc] = h[bn * H + cc] + o;
    }
  } else if (warp == H / 32) {  // value channels 0..NH-1 are lanes 0..NH-1
    float d0 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll
    for (int e = 0; e < KMAX; ++e) {
      float g = cc < NH ? s_alpha[e][cc] * s_w[e] * acc[e] : 0.f;
      g = warp_sum(g) * (1.f / NH);
      d0 += g * s_rel[e][0];
      d1 += g * s_rel[e][1];
      d2 += g * s_rel[e][2];
    }
    if (lane == 0) {
      const float gate = mlig[bn] ? 1.f : 0.f;
      out[3 * bn] = x[3 * bn] + gate * d0;
      out[3 * bn + 1] = x[3 * bn + 1] + gate * d1;
      out[3 * bn + 2] = x[3 * bn + 2] + gate * d2;
    }
  }
}

template <bool kH2X>
int launch_edge(const float* h, const float* x, const int64_t* idx, const bool* nmask,
                const bool* mlig, const float* ew, const float* ni, const float* nj,
                const float* q, const float* offsets, float coeff, PassParams p, int B, int N,
                int K, int row0, float* out, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > KMAX || row0 < 0 || row0 >= N)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N - row0, B);
  edge_kernel<kH2X><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, N, K, row0, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int td_block_ew(const float* x, const int64_t* idx, int B, int N, int K,
                           const float* offsets, float coeff, EwParams p, float* ew,
                           void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long E = (long long)B * N * K;
  const long long want = (E + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(want < 65535 ? want : 65535);
  ew_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, idx, N, K, E, offsets, coeff, p,
                                                         ew);
  return (int)cudaGetLastError();
}

extern "C" int td_block_node(const float* h, int rows, PassParams p, float* ni, float* nj,
                             float* q, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  node_kernel<<<(rows + kNodes - 1) / kNodes, kThreads, 0, (cudaStream_t)stream>>>(h, rows, p,
                                                                                   ni, nj, q);
  return (int)cudaGetLastError();
}

extern "C" int td_block_x2h(const float* h, const float* x, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* ni, const float* nj, const float* q,
                            const float* offsets, float coeff, PassParams p, int B, int N,
                            int K, int row0, float* h_out, void* stream) {
  return launch_edge<false>(h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K,
                            row0, h_out, stream);
}

extern "C" int td_block_h2x(const float* h, const float* x, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* ni, const float* nj, const float* q,
                            const float* offsets, float coeff, PassParams p, int B, int N,
                            int K, int row0, float* x_out, void* stream) {
  return launch_edge<true>(h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K,
                           row0, x_out, stream);
}
