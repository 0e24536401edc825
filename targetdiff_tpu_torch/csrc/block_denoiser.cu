// Block-denoiser kernels for Hopper (sm_90a): all layers of one
// UniTransformerO2 block (released TargetDiff widths: hidden 128, 16 heads,
// 20 RBF knots, K <= 32 neighbours), float32 (the second layers
// and node projections as three-term fp16 tensor-core products,
// float32-accurate).
//
// Replaces: targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel
// (block_denoiser) with every tile live, in inference mode (the edge-weight
// MLP in the kernel) and in train mode (edge weights given, per-layer
// checkpoints of h and x written for the backward, block_vjp.cu). It computes what
// that kernel computes, not its TPU encodings: neighbours are read with
// native gathers instead of one-hot matmuls, and the softmax over K is
// max-shifted instead of clipped.
//
// What bounds it: per layer and complex the x2h edge MLPs cost about
// N*K*76k FLOP, 65.5k of them the two 128x128 second layers per edge (the
// first layers collapse to per-node projections plus a 20-row table lookup
// per edge), about 0.7 GFLOP at N = 608, K = 32. Device memory traffic is
// small (node rows and weights, both L2-resident). Every dense product runs
// on the tensor cores as three-term fp16 products, float32-grade
// (tc_common.cuh).
//
// Design, per block:
//   ew_kernel    once: the global edge-weight MLP on block-start distances
//                (a warp per edge).
//   node_kernel  per pass (node_proj.cuh): h @ [k.h_i | v.h_i | k.h_j | v.h_j
//                | q1] plus the query MLP's LayerNorm and second layer, a
//                64-row tile and one 128-column slice of w_node per block,
//                so the edge kernels never multiply h per edge. For the h2x
//                pass the protein rows get only their source projections.
//   x2h_edge_kernel  per layer (x2h_edge.cuh, shared with the per-layer
//                kernels of edge_layer.cu): persistent blocks with both
//                second layers staged in shared memory, four pipelines per
//                block each taking one row's chunk of 32 edges per step as
//                the M of the tensor-core products, an online softmax over a
//                row's chunks; writes h' for every row.
//   h2x_edge_kernel  per layer (h2x_edge.cuh): persistent blocks whose four
//                pipelines take (ligand row, live chunk) units, each
//                yielding per-head softmax partials; a warp per row merges
//                them in chunk order and writes x' on the ligand tail.
// All intermediates of an edge stay in shared memory or registers; only the
// [B, N, K] edge weights and the per-node projections reach device memory.
// Train mode (td_block_train_fwd) drives the same node and edge kernels over
// all layers from the host side of this file, writing layer l's output
// straight into checkpoint slot l + 1.

#include "block_common.cuh"
#include "h2x_edge.cuh"
#include "node_proj.cuh"
#include "x2h_edge.cuh"

struct EwParams {
  const float* w1;  // [R][H]
  const float* b1;  // [H]
  const float* ln;  // [2][H]
  const float* w2;  // [H]
  const float* b2;  // [1]
};

namespace {

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
  return launch_node(h, 1, rows, 0, p, ni, nj, q, nullptr, (cudaStream_t)stream);
}

// The node projections of B complexes of N rows where the rows below row0 of
// each complex need only nj (the h2x pass: row0 = N - n_ligand); q1 may be
// null.
extern "C" int td_block_node_rows(const float* h, int B, int N, int row0, PassParams p, float* ni,
                                  float* nj, float* q, float* q1, void* stream) {
  return launch_node(h, B, N, row0, p, ni, nj, q, q1, (cudaStream_t)stream);
}

// The x2h edge pass alone (any K <= kMaxLayerK; the block path passes K <= 32).
// x2h updates every row: row0 must be 0 (the argument keeps the entry's
// signature that of td_block_h2x and of earlier builds).
extern "C" int td_block_x2h(const float* h, const float* x, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* ni, const float* nj, const float* q,
                            const float* offsets, float coeff, PassParams p, int B, int N,
                            int K, int row0, float* h_out, void* stream) {
  if (row0 != 0) return (int)cudaErrorInvalidValue;
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  return launch_x2h(h, in, q, p, B, N, K, h_out, (cudaStream_t)stream);
}

// The h2x edge pass alone on the rows [row0, N) of each complex (any
// K <= kMaxLayerK; the block path passes K <= 32). ni and q are read on those
// rows only, nj on every row.
extern "C" int td_block_h2x(const float* x, const int64_t* idx, const bool* nmask,
                            const bool* mlig, const float* ew, const float* ni, const float* nj,
                            const float* q, const float* offsets, float coeff, PassParams p,
                            int B, int N, int K, int row0, float* x_out, void* stream) {
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  return launch_h2x(in, q, p, B, N, K, row0, x_out, (cudaStream_t)stream);
}

// Train-mode forward of all L layers. hck [L+1][B][N][H] and xck
// [L+1][B][N][3] receive h and x before layer 0 (slot 0) and after each
// layer l (slot l + 1); ew [B][N][K] is given. ni, nj [B*N][2H] and q
// [B*N][H] are scratch. x2h / h2x hold L PassParams each (host memory).
extern "C" int td_block_train_fwd(const float* h0, const float* x0, const int64_t* idx,
                                  const bool* nmask, const bool* mlig, const float* ew,
                                  const float* offsets, float coeff, const PassParams* x2h,
                                  const PassParams* h2x, int L, int B, int N, int K,
                                  int n_ligand, float* ni, float* nj, float* q, float* hck,
                                  float* xck, void* stream) {
  if (L <= 0 || B <= 0 || N <= 0 || K <= 0 || K > kMaxBlockK || n_ligand <= 0 || n_ligand > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t hsz = (size_t)B * N * H, xsz = (size_t)B * N * 3;
  int err = (int)cudaMemcpyAsync(hck, h0, hsz * sizeof(float), cudaMemcpyDeviceToDevice, s);
  // every x slot starts as x0: h2x writes only the ligand tail, protein rows never move
  for (int l = 0; l <= L && err == 0; ++l)
    err = (int)cudaMemcpyAsync(xck + l * xsz, x0, xsz * sizeof(float), cudaMemcpyDeviceToDevice,
                               s);
  const int row0 = N - n_ligand;
  for (int l = 0; l < L && err == 0; ++l) {
    const float* h_in = hck + l * hsz;
    float* h_mid = hck + (l + 1) * hsz;
    const EdgeInputs in{xck + l * xsz, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
    err = launch_node(h_in, B, N, 0, x2h[l], ni, nj, q, nullptr, s);
    if (err == 0) err = launch_x2h(h_in, in, q, x2h[l], B, N, K, h_mid, s);
    if (err == 0) err = launch_node(h_mid, B, N, row0, h2x[l], ni, nj, q, nullptr, s);
    if (err == 0) err = launch_h2x(in, q, h2x[l], B, N, K, row0, xck + (l + 1) * xsz, s);
  }
  return err;
}
