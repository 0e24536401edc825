// Block-denoiser kernels for Hopper (sm_90a): all layers of one
// UniTransformerO2 block (released TargetDiff widths: hidden 128, 16 heads,
// 20 RBF knots, K <= 32 neighbours), float32 (the second layers
// and node projections as three-term fp16 tensor-core products,
// float32-accurate), or bf16 (the *_bf16 entry points: the sampling path's
// default precision, as the JAX kernel's dtype=bf16; every product one
// bf16 tensor-core product with float32 accumulation, weights packed as
// bf16, activations rounded to bf16 where they enter a product, geometry,
// LayerNorm statistics, softmax, h and x float32).
//
// Replaces: targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel
// (block_denoiser) in inference mode (the edge-weight MLP in the kernel;
// every row live, or through the *_list entries the rows of the sampler's
// dependency cone, cone.cu: JAX's need_full_h=False with per-layer tile
// flags, at row granularity) and in train mode (edge weights given,
// per-layer checkpoints of h and x written for the backward, block_vjp.cu,
// every row live). It computes what
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
//                (persistent blocks, 32 slots per warp step, the first layer
//                on the tensor cores as three-term TF32).
//   node_kernel  per pass (node_proj.cuh): h @ [k.h_i | v.h_i | k.h_j | v.h_j
//                | q1] plus the query MLP's LayerNorm and second layer on
//                wgmma, persistent blocks each owning one column group (ni,
//                nj or q) whose weights they stage once, so the edge kernels
//                never multiply h per edge. For the h2x pass the protein
//                rows get only their source projections.
//   x2h_edge_kernel  per layer (x2h_edge.cuh, shared with the per-layer
//                kernels of edge_layer.cu): persistent blocks with both
//                second layers staged in shared memory, four pipelines per
//                block each taking one row's chunk of 32 edges per step as
//                the M of the tensor-core products, an online softmax over a
//                row's chunks; writes h' for every row, or for a row list
//                (the cone's rows of the layer: the node launch before it
//                then covers their sources, the h2x pass's node launch the
//                ligand rows and their sources). The bf16 entries run
//                x2h_edge_mma_kernel instead (x2h_edge_bf16.cuh: a producer
//                warpgroup, two wgmma consumer warpgroups, 64-slot tiles).
//   h2x_edge_kernel  per layer (h2x_edge.cuh): persistent blocks whose four
//                pipelines take (ligand row, live chunk) units, each
//                yielding per-head softmax partials; a warp per row merges
//                them in chunk order and writes x' on the ligand tail. The
//                bf16 entries run h2x_edge_mma_kernel instead
//                (h2x_edge_bf16.cuh: the x2h one's design on the ligand rows).
// All intermediates of an edge stay in shared memory or registers; only the
// [B, N, K] edge weights and the per-node projections reach device memory.
// Train mode (td_block_train_fwd) drives the same node and edge kernels over
// all layers from the host side of this file, writing layer l's output
// straight into checkpoint slot l + 1.

#include "block_common.cuh"
#include "h2x_edge.cuh"
#include "node_proj.cuh"
#include "weight_grad.cuh"
#include "x2h_edge.cuh"

struct EwParams {
  const float* w1;  // [R][H] (bf16 in the bf16 instantiation)
  const float* b1;  // [H]
  const float* ln;  // [2][H]
  const float* w2;  // [H] (bf16 in the bf16 instantiation)
  const float* b2;  // [1]
};

namespace {

// The edge-weight MLP's first layer as the B operand of an m16n8k8 TF32
// product, [kEwK][H]: rows [0, R) w1, row R the bias b1 (its A column is 1),
// the rest zero.
constexpr int kEwK = 24;                  // three 8-deep k-steps
constexpr int kEwKSteps = kEwK / 8;
constexpr int kEwLd = kEwK + 4;           // padded RBF row: conflict-free A fragments
constexpr int kEwWarps = kThreads / 32;
constexpr int kEwNT = H / 8;              // 8-column n-tiles of the first layer's output
constexpr int kEwFrags = kEwKSteps * kEwNT * 32;
static_assert(R < kEwK, "the RBF knots and the bias column fill the k-steps");
// bf16: the RBF row as bf16 pairs (kEwKBf16 / 2 words of the tile row), two
// 16-deep k-steps, the bias added in float32
constexpr int kEwKBf16 = 32;
constexpr int kEwKStepsBf16 = kEwKBf16 / 16;
static_assert(R % 2 == 0 && R <= kEwKBf16 && kEwKBf16 / 2 <= kEwLd, "bf16 RBF rows fit the tile");
static_assert(kEwKStepsBf16 * kEwNT * 32 <= kEwFrags, "bf16 fragments fit the staged array");

// A block's shared memory: the weights, staged once, and per warp its tile of
// 32 edges' RBF rows and their e_w.
struct EwSmem {
  uint4 w1f[kEwFrags];  // (ks, nt, lane): (b0 hi, b1 hi, b0 lo, b1 lo), split_tf32
  float ln_scale[H], ln_bias[H], w2[H];
  float offsets[R];
  float rbf[kEwWarps][32][kEwLd];
  float ew[kEwWarps][32];
};

__device__ __forceinline__ float ew_w1(const EwParams& p, int k, int n) {
  return k < R ? p.w1[k * H + n] : (k == R ? p.b1[n] : 0.f);
}

// Global edge weights: e_w = sigmoid(w2 . relu(LN(rbf(d0) @ w1 + b1)) + b2)
// for every slot of the block-start graph, valid or not.
//
// Replaces: the edge-weight MLP inside targetdiff_tpu/ops/pallas/
// block_denoiser.py:_block_kernel (:319-327); the XLA one is the global
// edge_pred_layer of targetdiff_tpu/models/uni_transformer.py:289-301.
//
// What bounds it: per slot, 2 R H FLOP of the first layer (a dense product,
// at the TF32 tensor-core rate) and ~10 H of LayerNorm, ReLU and the dot
// with w2 (float32 rate), for ~12 bytes of index and output: operations.
//
// Design: persistent blocks, the weights staged once per block (w1 and b1 as
// TF32 hi / lo B fragments, the LayerNorm and w2 as float rows). A warp takes
// 32 slots at a time: lane e computes slot e's distance and its R RBF values
// (each expf once) into its row of the warp's tile, [rbf | 1 | 0...], then
// the warp runs the [32 x kEwK] [kEwK x H] first layer as m16n8k8 TF32
// products in three terms (lo*hi + hi*lo + hi*hi, ~2^-21 per term,
// float32-grade; each k-step summed from zero and added in float32), one
// 16-slot m-tile at a time. Each slot's 128 outputs stay in the C fragments
// of the four lanes of its quad, which reduce the LayerNorm's statistics and
// the w2 dot over the quad by shuffles in a fixed order; the 32 e_w are
// stored together, coalesced. Two runs give the same bits.
//
// bf16 (kBf16): w1 and w2 bf16; the lane's RBF row rounded to bf16 pairs,
// zero-padded to 32 knots, and the first layer one bf16 m16n8k16 product
// per k-step accumulated in float32 onto the bias; the LayerNorm + ReLU
// outputs rounded to bf16 before the float32 dot with w2 (exact products).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
ew_kernel(const float* __restrict__ x, const int64_t* __restrict__ idx, int N, int K,
          long long E, const float* __restrict__ offsets, float coeff, EwParams p,
          float* __restrict__ ew) {
  extern __shared__ __align__(16) unsigned char ew_smem[];
  EwSmem& S = *reinterpret_cast<EwSmem*>(ew_smem);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  if constexpr (kBf16) {
    // (b0, b1, 0, 0): b0 = w1[16 ks + 2 tig (+1)][n], b1 = w1[16 ks + 2 tig + 8 (+9)][n]
    const __nv_bfloat16* w1 = weights<true>(p.w1);
    for (int u = t; u < kEwKStepsBf16 * kEwNT * 32; u += kThreads) {
      const int ks = u / (kEwNT * 32), nt = u / 32 % kEwNT, fl = u % 32;
      const int k = 16 * ks + 2 * (fl & 3), n = 8 * nt + (fl >> 2);
      float w[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int kk = k + (f & 1) + 8 * (f >> 1);
        w[f] = kk < R ? wload(w1 + kk * H + n) : 0.f;
      }
      S.w1f[u] = make_uint4(bf16_pair(w[0], w[1]), bf16_pair(w[2], w[3]), 0u, 0u);
    }
  } else {
    for (int u = t; u < kEwFrags; u += kThreads) {
      const int ks = u / (kEwNT * 32), nt = u / 32 % kEwNT, fl = u % 32;
      const int k = 8 * ks + (fl & 3), n = 8 * nt + (fl >> 2);
      uint32_t h0, l0, h1, l1;
      split_tf32(ew_w1(p, k, n), h0, l0);
      split_tf32(ew_w1(p, k + 4, n), h1, l1);
      S.w1f[u] = make_uint4(h0, h1, l0, l1);
    }
  }
  for (int c = t; c < H; c += kThreads) {
    S.ln_scale[c] = p.ln[c];
    S.ln_bias[c] = p.ln[H + c];
    if constexpr (kBf16)
      S.w2[c] = wload(weights<true>(p.w2) + c);
    else
      S.w2[c] = p.w2[c];
  }
  if (t < R) S.offsets[t] = offsets[t];
  __syncthreads();
  const float b2 = p.b2[0];
  float* tile = &S.rbf[warp][0][0];
  const long long tiles = (E + 31) / 32;
  for (long long tl = (long long)blockIdx.x * kEwWarps + warp; tl < tiles;
       tl += (long long)gridDim.x * kEwWarps) {
    // one lane per slot: its distance and RBF row
    const long long e = tl * 32 + lane;
    float* row = tile + lane * kEwLd;
    if constexpr (kBf16) {
      // [rbf | 0] as bf16 pairs, word w = knots (2 w, 2 w + 1)
      uint32_t* roww = reinterpret_cast<uint32_t*>(row);
      if (e < E) {
        const long long bn = e / K;  // destination node b*N + i
        const long long jn = bn / N * N + idx[e];
        const float dx = x[3 * bn] - x[3 * jn], dy = x[3 * bn + 1] - x[3 * jn + 1],
                    dz = x[3 * bn + 2] - x[3 * jn + 2];
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz + 1e-16f);
#pragma unroll
        for (int r = 0; r < R; r += 2) {
          const float d0 = dist - S.offsets[r], d1 = dist - S.offsets[r + 1];
          roww[r / 2] = bf16_pair(expf(coeff * d0 * d0), expf(coeff * d1 * d1));
        }
      } else {
#pragma unroll
        for (int w = 0; w < R / 2; ++w) roww[w] = 0u;
      }
#pragma unroll
      for (int w = R / 2; w < kEwKBf16 / 2; ++w) roww[w] = 0u;
    } else {
      if (e < E) {
        const long long bn = e / K;  // destination node b*N + i
        const long long jn = bn / N * N + idx[e];
        const float dx = x[3 * bn] - x[3 * jn], dy = x[3 * bn + 1] - x[3 * jn + 1],
                    dz = x[3 * bn + 2] - x[3 * jn + 2];
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz + 1e-16f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d = dist - S.offsets[r];
          row[r] = expf(coeff * d * d);
        }
        row[R] = 1.f;
      } else {
#pragma unroll
        for (int r = 0; r <= R; ++r) row[r] = 0.f;
      }
#pragma unroll
      for (int r = R + 1; r < kEwK; ++r) row[r] = 0.f;
    }
    __syncwarp();

#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      float acc[kEwNT][4];
      if constexpr (kBf16) {
        // bias + rbf w1, one bf16 product per k-step and n-tile
#pragma unroll
        for (int nt = 0; nt < kEwNT; ++nt) {
          const float2 b = *reinterpret_cast<const float2*>(p.b1 + 8 * nt + 2 * tig);
          acc[nt][0] = acc[nt][2] = b.x;
          acc[nt][1] = acc[nt][3] = b.y;
        }
        const uint32_t* tw = reinterpret_cast<const uint32_t*>(tile);
#pragma unroll
        for (int ks = 0; ks < kEwKStepsBf16; ++ks) {
          // A: rows g, g + 8 x words 8 ks + tig (columns 2 tig, +1), + 4 (2 tig + 8, +9)
          const uint32_t* ar = tw + (16 * mt + g) * kEwLd + 8 * ks + tig;
          const uint32_t a[4] = {ar[0], ar[8 * kEwLd], ar[4], ar[8 * kEwLd + 4]};
#pragma unroll
          for (int nt = 0; nt < kEwNT; ++nt) {
            const uint4 wf = S.w1f[(ks * kEwNT + nt) * 32 + lane];
            mma_bf16(acc[nt], a, wf.x, wf.y);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kEwNT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kEwKSteps; ++ks) {
          // A: (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)
          const float* ar = tile + (16 * mt + g) * kEwLd + 8 * ks + tig;
          uint32_t ah[4], al[4];
          split_tf32(ar[0], ah[0], al[0]);
          split_tf32(ar[8 * kEwLd], ah[1], al[1]);
          split_tf32(ar[4], ah[2], al[2]);
          split_tf32(ar[8 * kEwLd + 4], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < kEwNT; ++nt) {
            const uint4 wf = S.w1f[(ks * kEwNT + nt) * 32 + lane];
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, wf.x, wf.y);
            mma_tf32(d, ah, wf.z, wf.w);
            mma_tf32(d, ah, wf.x, wf.y);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[nt][c] += d[c];
          }
        }
      }
      // slots 16 mt + g + 8 hf (hf = 0, 1): columns 8 nt + 2 tig (+1) of
      // their quad's lanes, the same columns for both
      float mean[2], rstd[2], part[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float s = 0.f;
#pragma unroll
        for (int nt = 0; nt < kEwNT; ++nt) s += acc[nt][2 * hf] + acc[nt][2 * hf + 1];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        mean[hf] = s * (1.f / H);
        float sq = 0.f;
#pragma unroll
        for (int nt = 0; nt < kEwNT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float c = acc[nt][2 * hf + j] - mean[hf];
            sq += c * c;
          }
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        rstd[hf] = rsqrtf(sq * (1.f / H) + kLnEps);
      }
#pragma unroll
      for (int nt = 0; nt < kEwNT; ++nt) {
        const int c = 8 * nt + 2 * tig;
        const float2 sc = *reinterpret_cast<const float2*>(&S.ln_scale[c]);
        const float2 bi = *reinterpret_cast<const float2*>(&S.ln_bias[c]);
        const float2 w = *reinterpret_cast<const float2*>(&S.w2[c]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if constexpr (kBf16) {
            const float z0 = fmaxf((acc[nt][2 * hf] - mean[hf]) * rstd[hf] * sc.x + bi.x, 0.f);
            const float z1 =
                fmaxf((acc[nt][2 * hf + 1] - mean[hf]) * rstd[hf] * sc.y + bi.y, 0.f);
            part[hf] += round_bf16(z0) * w.x;
            part[hf] += round_bf16(z1) * w.y;
          } else {
            part[hf] += fmaxf((acc[nt][2 * hf] - mean[hf]) * rstd[hf] * sc.x + bi.x, 0.f) * w.x;
            part[hf] += fmaxf((acc[nt][2 * hf + 1] - mean[hf]) * rstd[hf] * sc.y + bi.y, 0.f) * w.y;
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v = part[hf];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) S.ew[warp][16 * mt + 8 * hf + g] = 1.f / (1.f + expf(-(v + b2)));
      }
    }
    __syncwarp();
    if (e < E) ew[e] = S.ew[warp][lane];
    __syncwarp();  // the tile and e_w are rewritten by the warp's next slots
  }
}

template <bool kBf16>
int block_ew(const float* x, const int64_t* idx, int B, int N, int K, const float* offsets,
             float coeff, const EwParams& p, float* ew, cudaStream_t s) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (int err = sm_count(ew_kernel<kBf16>, (int)sizeof(EwSmem), n_sm)) return err;
  const long long E = (long long)B * N * K;
  const long long want = ((E + 31) / 32 + kEwWarps - 1) / kEwWarps;  // blocks of 8 tiles
  const int grid = (int)(want < 2 * n_sm ? want : 2 * n_sm);
  ew_kernel<kBf16><<<grid, kThreads, sizeof(EwSmem), s>>>(x, idx, N, K, E, offsets, coeff, p, ew);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int block_x2h(const float* h, const float* x, const int64_t* idx, const bool* nmask,
              const bool* mlig, const float* ew, const float* ni, const float* nj, const float* q,
              const float* offsets, float coeff, const PassParams& p, int B, int N, int K,
              int row0, float* h_out, cudaStream_t s) {
  if (row0 != 0) return (int)cudaErrorInvalidValue;
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  return launch_x2h<kBf16>(h, in, q, p, B, N, K, h_out, s);
}

template <bool kBf16>
int block_x2h_list(const float* h, const float* x, const int64_t* idx, const bool* nmask,
                   const bool* mlig, const float* ew, const float* ni, const float* nj,
                   const float* q, const float* offsets, float coeff, const PassParams& p, int B,
                   int N, int K, const int* order, const int* count, float* h_out,
                   cudaStream_t s) {
  if (order == nullptr || count == nullptr) return (int)cudaErrorInvalidValue;
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  return launch_x2h<kBf16>(h, in, q, p, B, N, K, h_out, s, order, count);
}

template <bool kBf16>
int block_h2x(const float* x, const int64_t* idx, const bool* nmask, const bool* mlig,
              const float* ew, const float* ni, const float* nj, const float* q,
              const float* offsets, float coeff, const PassParams& p, int B, int N, int K,
              int row0, float* x_out, cudaStream_t s) {
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  return launch_h2x<kBf16>(in, q, p, B, N, K, row0, x_out, s);
}

}  // namespace

// The entry points below come in pairs: float32, and *_bf16 (bf16 products;
// the packed product weights bf16, see tc_common.cuh).

extern "C" int td_block_ew(const float* x, const int64_t* idx, int B, int N, int K,
                           const float* offsets, float coeff, EwParams p, float* ew,
                           void* stream) {
  return block_ew<false>(x, idx, B, N, K, offsets, coeff, p, ew, (cudaStream_t)stream);
}

extern "C" int td_block_ew_bf16(const float* x, const int64_t* idx, int B, int N, int K,
                                const float* offsets, float coeff, EwParams p, float* ew,
                                void* stream) {
  return block_ew<true>(x, idx, B, N, K, offsets, coeff, p, ew, (cudaStream_t)stream);
}

extern "C" int td_block_node(const float* h, int rows, PassParams p, float* ni, float* nj,
                             float* q, void* stream) {
  return launch_node(h, 1, rows, 0, p, ni, nj, q, nullptr, (cudaStream_t)stream);
}

extern "C" int td_block_node_bf16(const float* h, int rows, PassParams p, float* ni, float* nj,
                                  float* q, void* stream) {
  return launch_node<true>(h, 1, rows, 0, p, ni, nj, q, nullptr, (cudaStream_t)stream);
}

// Node-projection launches made so far in this process, by every entry (the
// blocks, the per-layer passes, the backward's recompute): float32, bf16.
extern "C" long long td_node_launches() { return node_launch_count; }
extern "C" long long td_node_bf16_launches() { return node_bf16_launch_count; }

// The node projections of B complexes of N rows where the rows below row0 of
// each complex need only nj (the h2x pass: row0 = N - n_ligand); q1 may be
// null.
extern "C" int td_block_node_rows(const float* h, int B, int N, int row0, PassParams p, float* ni,
                                  float* nj, float* q, float* q1, void* stream) {
  return launch_node(h, B, N, row0, p, ni, nj, q, q1, (cudaStream_t)stream);
}

extern "C" int td_block_node_rows_bf16(const float* h, int B, int N, int row0, PassParams p,
                                       float* ni, float* nj, float* q, float* q1, void* stream) {
  return launch_node<true>(h, B, N, row0, p, ni, nj, q, q1, (cudaStream_t)stream);
}

// The node projections of a row list (the sampler's dependency cone): ni and
// q of rows order[0, *dst), nj of rows order[0, *src), row numbers b*N + i of
// h's `rows` rows, the counts read on the device; the rest left as they were.
extern "C" int td_block_node_list(const float* h, int rows, const int* order, const int* dst,
                                  const int* src, PassParams p, float* ni, float* nj, float* q,
                                  void* stream) {
  return launch_node_list(h, rows, order, dst, src, p, ni, nj, q, (cudaStream_t)stream);
}

extern "C" int td_block_node_list_bf16(const float* h, int rows, const int* order,
                                       const int* dst, const int* src, PassParams p, float* ni,
                                       float* nj, float* q, void* stream) {
  return launch_node_list<true>(h, rows, order, dst, src, p, ni, nj, q, (cudaStream_t)stream);
}

// The x2h edge pass alone (any K <= kMaxLayerK; the block path passes K <= 32).
// x2h updates every row: row0 must be 0 (the argument keeps the entry's
// signature that of td_block_h2x and of earlier builds).
extern "C" int td_block_x2h(const float* h, const float* x, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* ni, const float* nj, const float* q,
                            const float* offsets, float coeff, PassParams p, int B, int N,
                            int K, int row0, float* h_out, void* stream) {
  return block_x2h<false>(h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K,
                          row0, h_out, (cudaStream_t)stream);
}

extern "C" int td_block_x2h_bf16(const float* h, const float* x, const int64_t* idx,
                                 const bool* nmask, const bool* mlig, const float* ew,
                                 const float* ni, const float* nj, const float* q,
                                 const float* offsets, float coeff, PassParams p, int B, int N,
                                 int K, int row0, float* h_out, void* stream) {
  return block_x2h<true>(h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K,
                         row0, h_out, (cudaStream_t)stream);
}

// The x2h edge pass on a row list, rows order[0, *count) (row numbers b*N +
// i; the count read on the device): the rows off the list are not written.
extern "C" int td_block_x2h_list(const float* h, const float* x, const int64_t* idx,
                                 const bool* nmask, const bool* mlig, const float* ew,
                                 const float* ni, const float* nj, const float* q,
                                 const float* offsets, float coeff, PassParams p, int B, int N,
                                 int K, const int* order, const int* count, float* h_out,
                                 void* stream) {
  return block_x2h_list<false>(h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K,
                               order, count, h_out, (cudaStream_t)stream);
}

extern "C" int td_block_x2h_list_bf16(const float* h, const float* x, const int64_t* idx,
                                      const bool* nmask, const bool* mlig, const float* ew,
                                      const float* ni, const float* nj, const float* q,
                                      const float* offsets, float coeff, PassParams p, int B,
                                      int N, int K, const int* order, const int* count,
                                      float* h_out, void* stream) {
  return block_x2h_list<true>(h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K,
                              order, count, h_out, (cudaStream_t)stream);
}

// The h2x edge pass alone on the rows [row0, N) of each complex (any
// K <= kMaxLayerK; the block path passes K <= 32). ni and q are read on those
// rows only, nj on every row.
extern "C" int td_block_h2x(const float* x, const int64_t* idx, const bool* nmask,
                            const bool* mlig, const float* ew, const float* ni, const float* nj,
                            const float* q, const float* offsets, float coeff, PassParams p,
                            int B, int N, int K, int row0, float* x_out, void* stream) {
  return block_h2x<false>(x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K, row0,
                          x_out, (cudaStream_t)stream);
}

extern "C" int td_block_h2x_bf16(const float* x, const int64_t* idx, const bool* nmask,
                                 const bool* mlig, const float* ew, const float* ni,
                                 const float* nj, const float* q, const float* offsets,
                                 float coeff, PassParams p, int B, int N, int K, int row0,
                                 float* x_out, void* stream) {
  return block_h2x<true>(x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, p, B, N, K, row0,
                         x_out, (cudaStream_t)stream);
}

namespace {

template <bool kBf16>
int block_train_fwd(const float* h0, const float* x0, const int64_t* idx, const bool* nmask,
                    const bool* mlig, const float* ew, const float* offsets, float coeff,
                    const PassParams* x2h, const PassParams* h2x, int L, int B, int N, int K,
                    int n_ligand, float* ni, float* nj, float* q, float* hck, float* xck,
                    void* stream) {
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
    err = launch_node<kBf16>(h_in, B, N, 0, x2h[l], ni, nj, q, nullptr, s);
    if (err == 0) err = launch_x2h<kBf16>(h_in, in, q, x2h[l], B, N, K, h_mid, s);
    if (err == 0) err = launch_node<kBf16>(h_mid, B, N, row0, h2x[l], ni, nj, q, nullptr, s);
    if (err == 0)
      err = launch_h2x<kBf16>(in, q, h2x[l], B, N, K, row0, xck + (l + 1) * xsz, s);
  }
  return err;
}

}  // namespace

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
  return block_train_fwd<false>(h0, x0, idx, nmask, mlig, ew, offsets, coeff, x2h, h2x, L, B, N,
                                K, n_ligand, ni, nj, q, hck, xck, stream);
}

// The train-mode forward of the bf16 training variant (JAX's
// block_layers_trainable at dtype=bf16 drives _block_kernel so): the same
// arguments, x2h / h2x with bf16 product weights; launches the bf16 node, x2h
// and h2x kernels. The checkpoints stay float32.
extern "C" int td_block_train_fwd_bf16(const float* h0, const float* x0, const int64_t* idx,
                                       const bool* nmask, const bool* mlig, const float* ew,
                                       const float* offsets, float coeff, const PassParams* x2h,
                                       const PassParams* h2x, int L, int B, int N, int K,
                                       int n_ligand, float* ni, float* nj, float* q, float* hck,
                                       float* xck, void* stream) {
  return block_train_fwd<true>(h0, x0, idx, nmask, mlig, ew, offsets, coeff, x2h, h2x, L, B, N,
                               K, n_ligand, ni, nj, q, hck, xck, stream);
}
