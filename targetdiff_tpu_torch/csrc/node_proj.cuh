// Per-node projections of one attention pass for Hopper (sm_90a):
//   ni = h W[:, 0:256] + b,  nj = h W[:, 256:512],  q1 = h W[:, 512:640] + b,
//   q = LN_ReLU(q1) w_q2 + b_q2,
// W = w_node [128 x 640] (columns k.h_i | v.h_i | k.h_j | v.h_j | q's first
// layer, b zero on nj as packed), q1 optional (the backward's recompute).
// The edge kernels then never multiply h per edge.
//
// Replaces: the node part of targetdiff_tpu/ops/pallas/block_denoiser.py:
// _block_kernel and of targetdiff_tpu/ops/pallas/edge_layer.py:_x2h_kernel /
// _h2x_kernel (there fused into the edge kernels). It serves every caller:
// both passes of the inference and the train-mode block, both per-layer
// forwards and the backward's recompute (pass_bwd.cuh).
//
// What bounds it on this card: per row 2 x 128 x 768 FLOP of dense products
// against 512 bytes of h read and 2,560 of ni, nj and q written. At kNN B=100
// (60,800 rows) the bytes bound it (~0.056 ms; the writes ~80% of them); at
// B=4 (2,432 rows) they take ~2 us, and latency decides: a block's weight
// staging, its products and its stores follow one another.
//
// Design:
//  * Persistent blocks, each owning one column group: ni (k_i | v_i), nj
//    (k_j | v_j) or q (q's first layer, then w_q2). A block stages its
//    group's two 128 x 128 weights once as wgmma B operands (K-major core
//    matrices, node_stage: 16-byte loads of the row-major pack, transposed
//    in registers), then its warpgroups walk the group's 64-row tiles with
//    the stride of the group's warpgroups (node_deal deals blocks to groups
//    by their tiles; ops/kernels/block_denoiser.py node_walk replays it).
//  * A thread loads its two rows of a tile 16 bytes at a time (k taken in
//    node_k_col order, the weights staged in the same order) and builds its
//    A fragments in registers; each 128-column product is 8 (float32: 24)
//    wgmma m64n128k16 with A from registers, accumulated in float32. The
//    first tile's rows are in flight during the staging, the next tile's
//    during the products.
//  * The q group: q1 = h W + b (out, if asked), LayerNorm + ReLU on the
//    accumulator (a row's 128 values lie in one quad: two shuffles a sum),
//    rounded (bf16) or split (float32) into the A fragments of the w_q2
//    product. Nothing of it goes through shared memory.
//  * float32 at float32 grade: three fp16 terms lo hi + hi lo + hi hi, the
//    weights staged times kWScale as fp16 hi and lo. h is the residual
//    stream, not a LayerNorm output, so fp16's range (65504) is not
//    guaranteed: each row of h is scaled by the power of two that brings its
//    largest |h| into [2^14, 2^15) before the split (exact) and its products
//    are scaled back, so any row from |h| ~ 1e-30 to ~1e38 keeps ~2^-21
//    relative to its largest entry. (A three-term TF32 split needs no
//    scaling but twice the products.) Two warpgroups share a block's 128 KB
//    of weights.
//  * bf16 (kBf16, the sampling path's default precision): one bf16 product,
//    h and the LayerNorm output rounded to bf16 where they become A
//    fragments, w_node and w_q2 as packed (bf16), no row scaling (bf16 has
//    float32's exponent); biases, LayerNorm and the outputs float32. One
//    warpgroup a block, two blocks a SM.
//  * Source-only rows. With row0 > 0 the rows below row0 of each complex
//    get only nj: the ni and q groups walk rows [row0, N) of each complex,
//    their outputs elsewhere left as they were. The h2x pass reads ni and q
//    only on its destination (ligand) rows, nj on every row.
//  * Row lists (NodeRows, the sampler's dependency cone, cone.cu): the ni
//    and q groups walk rows order[0, *dst), nj rows order[0, *src), the
//    counts read on the device; each block deals the card's slots (the
//    blocks it holds at once) to the groups from the counts as node_deal
//    does, on a grid of slots + 3 (a deal's most: each group gets at least
//    one block), the blocks past the deal leaving at once. A row's
//    arithmetic is the same whichever tile or block takes it.
//  * Every output is computed by one warpgroup in a fixed order, without
//    atomics: two launches give the same bits.
#pragma once

#include "tc_common.cuh"

// node projections launched by launch_node in this process, from every entry
// that runs them (td_node_launches, td_node_bf16_launches read them): float32
// and bf16
inline long long node_launch_count = 0;
inline long long node_bf16_launch_count = 0;

namespace {

constexpr int kNodeRows = 64;  // rows of a tile: one warpgroup's wgmma M

// The exponent e that brings a row's largest |h|, mx, into [2^14, 2^15);
// 0 for a row of zeros (or a non-finite mx), bounded so that 2^e and
// 2^-(e + 8) stay normal floats.
__device__ __forceinline__ int row_exponent(float mx) {
  if (!(mx > 0.f && mx <= 3.4e38f)) return 0;
  int ex;
  frexpf(mx, &ex);  // mx = f 2^ex, f in [0.5, 1)
  return max(-100, min(100, 15 - ex));
}

__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

// Bytes between 8-row groups of a staged 128-deep weight: 16 past its 16
// core matrices, so that eight threads writing the same row of neighbouring
// groups' core matrices reach eight different bank quads.
constexpr int kNodeSbo = 2 * kKSteps * 128 + 16;
constexpr int kNodeImg = H / 8 * kNodeSbo;  // one staged 128-column weight: 33,024 bytes

template <bool kBf16>
struct NodeMma {
  static constexpr int kTerms = kBf16 ? 1 : 2;        // staged images a weight: bf16 | fp16 hi, lo
  static constexpr int kWarpgroups = kBf16 ? 1 : 2;   // a block's warpgroups, one tile each at a time
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kBlocksPerSm = kBf16 ? 2 : 1;  // blocks a SM the registers allow for
  struct Smem {
    alignas(128) unsigned char w[kTerms][2][kNodeImg];  // the group's two 128-column weights
    float bias[2][H];                                    // their biases (q: q1's, b_q2)
    float ln[2][H];                                      // q_ln scale, bias (the q group)
  };
};

// The column of h (and row of w_node) that term k of a 128-deep product
// takes: within a 16-deep k-step, a thread's A fragment (columns 2 tig (+1)
// and 2 tig + 8 (+9)) is columns 4 tig .. 4 tig + 3 of h, one 16-byte load.
__host__ __device__ constexpr int node_k_col(int k) {
  return (k & ~15) + 4 * ((k & 7) >> 1) + 2 * ((k >> 3) & 1) + (k & 1);
}

// Stages W[:, 0:128) (128 rows, row-major, leading dimension ldw; taken in
// node_k_col order when kPermute) as a wgmma B operand (B[n][k], K-major
// core matrices, 8-row groups kNodeSbo apart) into img[0] (bf16: as packed)
// or, float32, times kWScale split into fp16 hi (img[0]) and lo (img[1]).
// Unit u of 256 is one core matrix (8 k x 8 columns): its eight rows of W are
// read 16 bytes (float32: 32) at a time, transposed in registers and written
// as eight 16-byte rows. Neighbouring threads take neighbouring column
// groups: coalesced reads, conflict-free writes.
template <bool kBf16, bool kPermute>
__device__ __forceinline__ void node_stage(unsigned char* const (&img)[NodeMma<kBf16>::kTerms],
                                           const WeightT<kBf16>* __restrict__ W, int ldw, int t,
                                           int nthreads) {
  constexpr int kT = NodeMma<kBf16>::kTerms;
  for (int u = t; u < kKSteps * 2 * (H / 8); u += nthreads) {
    const int nb = u % (H / 8), kc = u / (H / 8);
    uint32_t v[kT][8][4];  // [term][k][column pair]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 8 * kc + i;
      const WeightT<kBf16>* w = W + (size_t)(kPermute ? node_k_col(k) : k) * ldw + 8 * nb;
      if constexpr (kBf16) {
        const uint4 x = *reinterpret_cast<const uint4*>(w);
        v[0][i][0] = x.x;
        v[0][i][1] = x.y;
        v[0][i][2] = x.z;
        v[0][i][3] = x.w;
      } else {
        const float4 a = reinterpret_cast<const float4*>(w)[0];
        const float4 b = reinterpret_cast<const float4*>(w)[1];
        const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          __half h0, l0, h1, l1;
          split_f16(kWScale * f[2 * m], h0, l0);
          split_f16(kWScale * f[2 * m + 1], h1, l1);
          v[0][i][m] = f16_pair(h0, h1);
          v[kT - 1][i][m] = f16_pair(l0, l1);
        }
      }
    }
#pragma unroll
    for (int term = 0; term < kT; ++term) {
      unsigned char* cm = img[term] + nb * kNodeSbo + kc * 128;
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // row n of the core matrix: column 8 nb + n, k 8 kc .. + 7
        const unsigned sel = (n & 1) ? 0x7632u : 0x5410u;
        const uint32_t(&c)[8][4] = v[term];
        *reinterpret_cast<uint4*>(cm + 16 * n) = make_uint4(
            __byte_perm(c[0][n >> 1], c[1][n >> 1], sel), __byte_perm(c[2][n >> 1], c[3][n >> 1], sel),
            __byte_perm(c[4][n >> 1], c[5][n >> 1], sel), __byte_perm(c[6][n >> 1], c[7][n >> 1], sel));
      }
    }
  }
}

// acc = a W for the warpgroup's 64 x 128 tile: W the staged weight w[term][half]
// (descriptors), a the A fragments of the 8 k-steps; bf16 one product, float32
// three fp16 terms lo hi + hi lo + hi hi (small terms first).
template <bool kBf16>
__device__ __forceinline__ void node_product(
    float (&acc)[64], const uint32_t (&a)[NodeMma<kBf16>::kTerms][kKSteps][4],
    unsigned char (&w)[NodeMma<kBf16>::kTerms][2][kNodeImg], int half) {
  const uint64_t dh = mma_desc(w[0][half], kNodeSbo);
  fence_acc(acc);
  wgmma_fence();
  if constexpr (kBf16) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) wgmma_rs(acc, a[0][ks], desc_ks(dh, ks), ks);
  } else {
    const uint64_t dl = mma_desc(w[1][half], kNodeSbo);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      wgmma_rs<true>(acc, a[1][ks], desc_ks(dh, ks), ks);
      wgmma_rs<true>(acc, a[0][ks], desc_ks(dl, ks), 1);
      wgmma_rs<true>(acc, a[0][ks], desc_ks(dh, ks), 1);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_acc(acc);
}

// The A fragment registers of k-step ks from a thread's two rows' 16-byte
// pieces x0, x1 (node_k_col order): (row g, k 2 tig (+1)), (row g + 8, the
// same), (row g, k 2 tig + 8 (+9)), (row g + 8, the same). bf16: bf16
// pairs; float32: fp16 hi pairs into a[0], lo pairs into a[1].
template <bool kBf16>
__device__ __forceinline__ void node_frags(uint32_t (&a)[NodeMma<kBf16>::kTerms][kKSteps][4],
                                           int ks, float4 x0, float4 x1) {
  const float f[4][2] = {{x0.x, x0.y}, {x1.x, x1.y}, {x0.z, x0.w}, {x1.z, x1.w}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      a[0][ks][i] = bf16_pair(f[i][0], f[i][1]);
    } else {
      __half h0, l0, h1, l1;
      split_f16(f[i][0], h0, l0);
      split_f16(f[i][1], h1, l1);
      a[0][ks][i] = f16_pair(h0, h1);
      a[NodeMma<kBf16>::kTerms - 1][ks][i] = f16_pair(l0, l1);
    }
  }
}

// acc = acc * us[r] + b[column] on the thread's rows g + 8 r and columns
// 8 nt + 2 tig (+1) of a 64 x 128 accumulator.
__device__ __forceinline__ void node_finish(float (&acc)[64], const float (&us)[2],
                                            const float* b, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * nt + 2 * tig);
      acc[4 * nt + 2 * r] = fmaf(acc[4 * nt + 2 * r], us[r], bb.x);
      acc[4 * nt + 2 * r + 1] = fmaf(acc[4 * nt + 2 * r + 1], us[r], bb.y);
    }
}

// The thread's rows g, g + 8 of a 64 x 128 result (acc) to rows (-1: none)
// of dst, row stride ld floats: columns 8 nt + 2 tig (+1), 8 bytes a store.
// (Staging them through shared memory for 16-byte row stores measured
// slower: node_proj_variants.py.)
__device__ __forceinline__ void node_store(const float (&acc)[64], const long long (&rows)[2],
                                           float* __restrict__ dst, int ld, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < 0) continue;
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt)
      *reinterpret_cast<float2*>(dst + rows[r] * ld + 8 * nt + 2 * tig) =
          make_float2(acc[4 * nt + 2 * r], acc[4 * nt + 2 * r + 1]);
  }
}

// Blocks 0 .. nb0 - 1 take ni's 256 columns (w_node[:, 0:256)), the next nb1
// nj's ([256, 512)), the rest q ([512, 640), then w_q2). A block stages its
// group's two 128-column weights once, then each of its warpgroups walks the
// group's 64-row tiles (ni and q: rows [row0, N) of each complex; nj: every
// row) with the stride of the group's warpgroups.
// A row list: the ni and q groups take rows order[0, *dst), the nj group
// rows order[0, *src) (device counts), slots blocks dealt to them; order
// null: the rows of (B, N, row0).
struct NodeRows {
  const int* order;
  const int* dst;
  const int* src;
  long long slots;
};

// Blocks for each group: as many as give each of a group's warpgroups one
// tile, but no more than the group's share, by tiles, of the blocks the card
// holds at once (`slots`; at least one a group).
__host__ __device__ inline void node_deal(long long tiles_dst, long long tiles_all,
                                          int warpgroups, long long slots, int (&nb)[3]) {
  const long long tiles[3] = {tiles_dst, tiles_all, tiles_dst};
  const long long total = 2 * tiles_dst + tiles_all;
  for (int gi = 0; gi < 3; ++gi) {
    const long long want = (tiles[gi] + warpgroups - 1) / warpgroups;
    long long share = total > 0 ? slots * tiles[gi] / total : 0;
    if (share < 1) share = 1;
    nb[gi] = (int)(want < share ? want : share);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(NodeMma<kBf16>::kThreads, NodeMma<kBf16>::kBlocksPerSm)
node_kernel(const float* __restrict__ h, int B, int N, int row0, PassParams p,
            float* __restrict__ ni, float* __restrict__ nj, float* __restrict__ q,
            float* __restrict__ q1, int nb0, int nb1, NodeRows list) {
  using M = NodeMma<kBf16>;
  constexpr int kT = M::kTerms;
  extern __shared__ __align__(128) unsigned char node_wg_smem_raw[];
  typename M::Smem& s = *reinterpret_cast<typename M::Smem*>(node_wg_smem_raw);
  const int t = threadIdx.x, wg = t >> 7, w = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;

  // the rows of each group: a list's counts, or the complexes' rows
  const int nd = N - row0;
  const long long ndst = list.order ? (long long)*list.dst : (long long)B * nd;
  const long long nsrc = list.order ? (long long)*list.src : (long long)B * N;
  int nb[3] = {nb0, nb1, (int)gridDim.x - nb0 - nb1};
  if (list.order)
    node_deal((ndst + kNodeRows - 1) / kNodeRows, (nsrc + kNodeRows - 1) / kNodeRows,
              M::kWarpgroups, list.slots, nb);
  int grp, j = blockIdx.x, nbg;  // constant indices keep nb in registers
  if (j < nb[0]) {
    grp = 0;
    nbg = nb[0];
  } else if ((j -= nb[0]) < nb[1]) {
    grp = 1;
    nbg = nb[1];
  } else if ((j -= nb[1]) < nb[2]) {
    grp = 2;
    nbg = nb[2];
  } else {
    return;  // past the deal (row lists)
  }
  const long long nrows = grp == 1 ? nsrc : ndst;
  const int tiles = (int)((nrows + kNodeRows - 1) / kNodeRows);
  auto node_of = [&](int tile, int r) -> long long {  // node b*N + i of the tile's row r; -1 past the end
    const long long u = (long long)tile * kNodeRows + r;
    if (u >= nrows) return -1;
    if (list.order) return list.order[u];
    return grp == 1 ? u : u / nd * N + row0 + u % nd;
  };
  // the thread's rows 16 w + g (+ 8) of a tile: columns 16 ks + 4 tig .. + 3
  float4 x[2][kKSteps];
  auto load_rows = [&](int tile) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long n = node_of(tile, 16 * w + g + 8 * r);
      const float4* src = reinterpret_cast<const float4*>(h + (n < 0 ? 0 : n) * H);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        x[r][ks] = n < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : src[4 * ks + tig];
    }
  };

  int tile = j * M::kWarpgroups + wg;
  const int stride = nbg * M::kWarpgroups;
  load_rows(tile);  // in flight while the weights are staged
  {
    const WeightT<kBf16>* wn = weights<kBf16>(p.w_node) + 2 * H * grp;
    unsigned char* w0[kT];
    unsigned char* w1[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      w0[i] = s.w[i][0];
      w1[i] = s.w[i][1];
    }
    node_stage<kBf16, true>(w0, wn, H5, t, M::kThreads);
    if (grp < 2)
      node_stage<kBf16, true>(w1, wn + H, H5, t, M::kThreads);
    else
      node_stage<kBf16, false>(w1, weights<kBf16>(p.w_q2), H, t, M::kThreads);
    for (int c = t; c < 2 * H; c += M::kThreads) {
      s.bias[c / H][c % H] = grp < 2 || c < H ? p.b_node[2 * H * grp + c] : p.b_q2[c - H];
      s.ln[c / H][c % H] = p.q_ln[c];
    }
  }
  fence_proxy_async();  // the staged weights, for the products
  __syncthreads();

  float acc[64];
  for (; tile < tiles; tile += stride) {
    const long long rows[2] = {node_of(tile, 16 * w + g), node_of(tile, 16 * w + g + 8)};
    uint32_t a[kT][kKSteps][4];
    float us[2] = {1.f, 1.f};  // a row's products back to h W (float32: 2^-(e + 8))
    if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) node_frags<kBf16>(a, ks, x[0][ks], x[1][ks]);
    } else {
      // each row times the power of two that brings its largest |h| into
      // [2^14, 2^15) (exact; a row's 128 values lie in its quad)
      float f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
          mx = fmaxf(fmaxf(mx, fmaxf(fabsf(x[r][ks].x), fabsf(x[r][ks].y))),
                     fmaxf(fabsf(x[r][ks].z), fabsf(x[r][ks].w)));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const int e = row_exponent(mx);
        f[r] = pow2(e);
        us[r] = pow2(-e - 8);
      }
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const float4 x0 = x[0][ks], x1 = x[1][ks];
        node_frags<kBf16>(a, ks, make_float4(x0.x * f[0], x0.y * f[0], x0.z * f[0], x0.w * f[0]),
                          make_float4(x1.x * f[1], x1.y * f[1], x1.z * f[1], x1.w * f[1]));
      }
    }
    if (tile + stride < tiles) load_rows(tile + stride);  // in flight during the products

    if (grp < 2) {
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        node_product<kBf16>(acc, a, s.w, half);
        node_finish(acc, us, s.bias[half], tig);
        node_store(acc, rows, (grp == 0 ? ni : nj) + half * H, H2, tig);
      }
      continue;
    }

    // the q group: q1 = h W + b (out, if asked), LayerNorm + ReLU on the
    // accumulator (a row's 128 values lie in its quad), rounded (bf16) or
    // split (float32) as the A fragments of the w_q2 product
    node_product<kBf16>(acc, a, s.w, 0);
    node_finish(acc, us, s.bias[0], tig);
    if (q1 != nullptr) node_store(acc, rows, q1, H, tig);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lsum[4] = {};  // four independent partial sums: short dependency chains
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
        lsum[nt & 3] += acc[4 * nt + 2 * r] + acc[4 * nt + 2 * r + 1];
      float sum = (lsum[0] + lsum[1]) + (lsum[2] + lsum[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum * (1.f / H);
      float sqp[4] = {};
#pragma unroll
      for (int i = 0; i < 2 * (H / 8); ++i) {
        const float dlt = acc[4 * (i >> 1) + 2 * r + (i & 1)] - mean;
        sqp[i & 3] = fmaf(dlt, dlt, sqp[i & 3]);
      }
      float sq = (sqp[0] + sqp[1]) + (sqp[2] + sqp[3]);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      const float rstd = rsqrtf(sq * (1.f / H) + kLnEps);
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        const int c = 8 * nt + 2 * tig;
        const float2 sc = *reinterpret_cast<const float2*>(&s.ln[0][c]);
        const float2 bi = *reinterpret_cast<const float2*>(&s.ln[1][c]);
        const float z0 = fmaxf((acc[4 * nt + 2 * r] - mean) * rstd * sc.x + bi.x, 0.f);
        const float z1 = fmaxf((acc[4 * nt + 2 * r + 1] - mean) * rstd * sc.y + bi.y, 0.f);
        const int i = (nt & 1) * 2 + r;  // k-step nt / 2: columns 2 tig (+1) | 2 tig + 8 (+9)
        if constexpr (kBf16) {
          a[0][nt >> 1][i] = bf16_pair(z0, z1);
        } else {
          __half h0, l0, h1, l1;
          split_f16(z0, h0, l0);
          split_f16(z1, h1, l1);
          a[0][nt >> 1][i] = f16_pair(h0, h1);
          a[kT - 1][nt >> 1][i] = f16_pair(l0, l1);
        }
      }
    }
    node_product<kBf16>(acc, a, s.w, 1);
    const float qs[2] = {kBf16 ? 1.f : 1.f / kWScale, kBf16 ? 1.f : 1.f / kWScale};
    node_finish(acc, qs, s.bias[1], tig);
    node_store(acc, rows, q, H, tig);
  }
}

// The blocks of node_kernel<kBf16> the card holds at once (0: an error,
// in err).
template <bool kBf16>
long long node_slots(int& err) {
  using M = NodeMma<kBf16>;
  static long long slots = 0;
  err = 0;
  if (slots == 0) {
    int n_sm = 0, per_sm = 0;
    if ((err = sm_count(node_kernel<kBf16>, (int)sizeof(typename M::Smem), n_sm))) return 0;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, node_kernel<kBf16>, M::kThreads, sizeof(typename M::Smem))))
      return 0;
    slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  }
  return slots;
}

// ni, nj, q (and q1, if not null) of the B x N rows of h; with row0 > 0 the
// rows below row0 of each complex get only nj. kBf16: bf16 products, p's
// w_node and w_q2 bf16.
template <bool kBf16 = false>
int launch_node(const float* h, int B, int N, int row0, const PassParams& p, float* ni, float* nj,
                float* q, float* q1, cudaStream_t s) {
  using M = NodeMma<kBf16>;
  if (B <= 0 || N <= 0 || row0 < 0 || row0 >= N) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)h | (uintptr_t)p.w_node | (uintptr_t)p.w_q2) & 15)
    return (int)cudaErrorMisalignedAddress;
  int err = 0;
  const long long slots = node_slots<kBf16>(err);
  if (err) return err;
  int nb[3];
  node_deal(((long long)B * (N - row0) + kNodeRows - 1) / kNodeRows,
            ((long long)B * N + kNodeRows - 1) / kNodeRows, M::kWarpgroups, slots, nb);
  node_kernel<kBf16><<<nb[0] + nb[1] + nb[2], M::kThreads, sizeof(typename M::Smem), s>>>(
      h, B, N, row0, p, ni, nj, q, q1, nb[0], nb[1], NodeRows{nullptr, nullptr, nullptr, 0});
  err = (int)cudaGetLastError();
  if (!err) ++(kBf16 ? node_bf16_launch_count : node_launch_count);
  return err;
}

// ni and q of the rows order[0, *dst), nj of the rows order[0, *src) (row
// numbers b*N + i of h's `rows` rows; device counts, *dst <= *src <= rows),
// the rest left as they were.
template <bool kBf16 = false>
int launch_node_list(const float* h, long long rows, const int* order, const int* dst,
                     const int* src, const PassParams& p, float* ni, float* nj, float* q,
                     cudaStream_t s) {
  using M = NodeMma<kBf16>;
  if (rows <= 0 || rows >= (1ll << 31) || !order || !dst || !src)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)h | (uintptr_t)p.w_node | (uintptr_t)p.w_q2) & 15)
    return (int)cudaErrorMisalignedAddress;
  int err = 0;
  const long long slots = node_slots<kBf16>(err);
  if (err) return err;
  node_kernel<kBf16><<<(int)slots + 3, M::kThreads, sizeof(typename M::Smem), s>>>(
      h, 1, (int)rows, 0, p, ni, nj, q, nullptr, 0, 0, NodeRows{order, dst, src, slots});
  err = (int)cudaGetLastError();
  if (!err) ++(kBf16 ? node_bf16_launch_count : node_launch_count);
  return err;
}

}  // namespace
