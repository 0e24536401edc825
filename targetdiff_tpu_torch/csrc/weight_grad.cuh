// Weight-gradient products of the attention backwards (pass_bwd.cuh) for
// Hopper (sm_90a): out = X^T Y over M rows, X [M][ldx] (its first P
// columns), Y [M][ldy] (its first Q columns), float32 in and out.
//
// Replaces: the parameter-gradient products that the TPU kernels form in
// their own bodies, targetdiff_tpu/ops/pallas/edge_layer_vjp.py:_cdotg (dw2,
// used at :131 and :156, accumulated across the grid at :335) and those of
// block_vjp.py:_block_bwd_kernel (:17-19). Here they run over the per-edge
// and per-node rows that edge_bwd_kernel and node_bwd_kernel write: the
// second layers and the RBF / edge-type table over edges, w_node and the
// query MLP's second layer over nodes.
//
// What bounds it: bytes. A second layer's product at the B=32 train step
// reads 2 x 425,984 x 128 floats (0.44 GB) for 14 GFLOP, ~32 FLOP per byte,
// under the ~150 at which the TF32 tensor cores would bound it. The kernel
// itself is bound by its instruction issue (the splits, the float32 adds,
// three mma per product), ~2x from that bound (PERF.md).
//
// Design. A block computes one 128x128 output tile of one row chunk's
// product with 8 warps of 64x32. Tiles of 32 rows of X and Y come
// by cp.async (16-byte copies; rows past the chunk and columns past P or Q
// are zero-filled) into a ring of three stages, so the loads of the next
// rows overlap the products on the current ones. Shared rows are padded to
// 136 floats: X is stored [m][p] and read as A = X^T in m16n8k8 fragments,
// conflict-free, as Y is read as B. The products are mma.sync.m16n8k8 TF32
// in three terms: x = hi + lo, hi = x and lo = x - hi each rounded to TF32
// as cvt.rna rounds (to nearest, ties away from zero), lo*hi + hi*lo +
// hi*hi (~2^-21 per term, float32-grade). TF32 keeps float32's exponent:
// the operands are gradients spanning many decades, and no per-row scale
// factors out of a sum over rows, so fp16 (tc_common.cuh) would lose them.
// Each k-step's three terms are summed into a zeroed fragment, which is then
// added to the float32 accumulator: the long sum over a chunk's rows is
// rounded to nearest by the FP32 pipes, never carried in the tensor cores'
// accumulator (carried there, the sums missed float64 by 4.5e-5 to 9.3e-5
// of their terms' root-sum-square on the card: PERF.md). A warp skips the 16-row and 8-column pieces of its tile that lie
// past P or Q (P = 84 for the table, Q = 16 for h2x's w2v); a warp whose
// pieces are all live runs its k-steps without those checks.
//
// The split-K sum. The blocks of a tile's consecutive chunks form clusters
// of kWgCluster along z (chunks padded with empty ones to a multiple of
// kWgCluster). Block rank r sums rows [r 128 / C, (r + 1) 128 / C) of the
// cluster's tiles: after its k-loop and a cluster.sync() (every ring is
// free) each block stores the accumulator pieces of other ranks' rows into
// those ranks' shared memory (distributed shared memory, one slot a
// sender); after a second cluster.sync() rank r adds, for each of its
// rows' pieces, the C ranks' values in ascending rank order (its own from
// registers, the others from its slots) and writes them as the cluster's
// partial. Each block moves (C - 1) / C of a tile through shared memory
// once. Storing whole tiles and reading each rank's rows from every peer
// (weight_grad_variants.py pull_fold) moves a whole tile twice; its float32
// instantiation spilled 44 bytes and ran ~4% slower, its bf16 one ~1.5%
// faster (PERF.md). So kWgCluster times fewer partials go through device
// memory (a `fast` B=32 step wrote and read ~0.96 GB of them unfolded).
// kWgCluster is 2: clusters of 4 and 8 lost more in
// the product than they saved in the reduction (weight_grad_variants.py,
// PERF.md): the card holds 62 clusters of 4 and 30 of 8 where 66 and 33
// would fill its 264 block slots, so each chunk grows 6-10%, and the h2x
// products' 128 blocks, one an SM without clusters, ran ~1.6x slower. The
// bf16 instantiation, whose products are about twice as fast, lost more to
// the cluster launch (~2 us a launch on the short products) than its fold
// saved: it launches without clusters (kWgClusterBf16 = 1), each chunk's
// partial stored straight to device memory as before clusters.
//
// reduce_kernel then sums the clusters' partials over the whole card:
// block b takes float4 columns [b cw, (b + 1) cw), its thread group g (of
// kRedGroups) the partials [g S' / G, (g + 1) S' / G), ascending from zero,
// 16 bytes a load, and the group sums are added in group order; cw is
// chosen so that every SM gets a block. It is launched as a
// programmatic dependent of the product (griddepcontrol.wait before its first
// read), so its launch overlaps the product's tail; the product after it is
// launched in plain stream order, since all of a pass's reductions share one
// scratch.
//
// Determinism: the chunks depend on (M, P, Q) and the clusters the card
// holds at once (wg_plan; cudaOccupancyMaxActiveClusters, one value for a
// card model), each block's order, each cluster's rank order and the
// reduction's ranges are fixed, and no atomic decides an order, so two runs
// give the same bits. With a cluster of 1 and kRedGroups = 1 the order is the one
// of the design before clusters (each chunk's partial through device memory,
// summed in ascending chunk order from zero).
//
// Alignment: every operand base and leading dimension, P and Q, must be a
// multiple of 16 bytes (4 floats); weight_grad refuses anything else.
//
// bf16 (kBf16, the bf16 training variant: edge_layer_vjp.py _cdotg at
// cd=bf16): the same tiles, ring and chunks, X and Y rounded to bf16 where
// their fragments are formed, each 16-row k-step one bf16
// mma.sync.m16n8k16 accumulated in the mma's float32 accumulator (bf16
// keeps float32's exponent: no range to lose), one partial a chunk (no
// cluster) and the same fixed-order reduce_kernel flush.
#pragma once

#include <cooperative_groups.h>

#include "block_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr long long kPartialCap = 1 << 22;  // floats of split-reduction scratch
constexpr int kWgTile = 128;                // output tile, P and Q
constexpr int kWgRows = 32;                 // rows of X and Y per stage
constexpr int kWgStages = 3;
constexpr int kWgLd = kWgTile + 8;          // padded shared row
constexpr int kWgStageFloats = 2 * kWgRows * kWgLd;
constexpr int kWgSmem = kWgStages * kWgStageFloats * (int)sizeof(float);
constexpr int kWgMT = 4, kWgNT = 4;         // a warp's 16-row m-tiles, 8-column n-tiles
constexpr long long kWgMinRows = 256;       // rows per chunk at least
constexpr int kWgCluster = 2;      // float32: blocks (consecutive chunks) folded in a cluster
constexpr int kWgClusterBf16 = 1;  // bf16: no cluster
template <bool kBf16>
constexpr int kWgClusterOf = kBf16 ? kWgClusterBf16 : kWgCluster;
constexpr int kWgFoldLd = kWgTile + 8;  // padded row of the fold's slots: conflict-free float2
static_assert(kWgTile * kWgFoldLd * (int)sizeof(float) <= kWgSmem, "the tile must fit the ring");
static_assert(kWgTile / kWgCluster % 8 == 0, "a fragment piece's 8 rows belong to one rank");
constexpr int kRedGroups = 8;               // reduce_kernel's ranges of the partials a column

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero, on the 13 low mantissa bits. An integer add and mask
// take two instructions where cvt.rna takes four (its checks for Inf and
// NaN), and they are a share of the kernel's instruction issue.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each TF32 (rna_tf32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile, TF32 operands, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [m0, m0 + kWgRows) of the block's X and Y columns into s:
// 32 rows x 32 16-byte pieces of each, four of each per thread.
__device__ __forceinline__ void wg_stage(float* s, const float* __restrict__ X, int ldx,
                                         const float* __restrict__ Y, int ldy, long long m0,
                                         long long me, int xcols, int ycols, int t) {
#pragma unroll
  for (int u = 0; u < kWgRows * kWgTile / 4 / kThreads; ++u) {
    const int i = t + u * kThreads;
    const int r = i >> 5, c = (i & 31) * 4;
    const long long m = m0 + r;
    const bool vx = m < me && c < xcols, vy = m < me && c < ycols;
    cp_async16_zfill(s + r * kWgLd + c, vx ? X + m * ldx + c : X, vx);
    cp_async16_zfill(s + (kWgRows + r) * kWgLd + c, vy ? Y + m * ldy + c : Y, vy);
  }
}

// One 16-row k-step of a warp's tiles in bf16: acc[i][j] += A B, A = X^T and
// B = Y rounded to bf16 (rows k0 + 2 tig, + 1 and those 8 rows down).
template <bool kFull>
__device__ __forceinline__ void wg_kstep_bf16(float (&acc)[kWgMT][kWgNT][4], const float* sx,
                                              const float* sy, int k0, int tig, int mt, int nt) {
  const float* xr = sx + (k0 + 2 * tig) * kWgLd;
  const float* yr = sy + (k0 + 2 * tig) * kWgLd;
  uint32_t b[kWgNT][2];  // B (k x n): rows (2 tig, 2 tig + 1), (2 tig + 8, 2 tig + 9) of column gid
#pragma unroll
  for (int j = 0; j < kWgNT; ++j) {
    b[j][0] = bf16_pair(yr[j * 8], yr[kWgLd + j * 8]);
    b[j][1] = bf16_pair(yr[8 * kWgLd + j * 8], yr[9 * kWgLd + j * 8]);
  }
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
    if (!kFull && i >= mt) break;
    // A = X^T (m x k): rows gid, gid + 8 x columns (2 tig, 2 tig + 1), the same + 8
    const uint32_t a[4] = {bf16_pair(xr[i * 16], xr[kWgLd + i * 16]),
                           bf16_pair(xr[i * 16 + 8], xr[kWgLd + i * 16 + 8]),
                           bf16_pair(xr[8 * kWgLd + i * 16], xr[9 * kWgLd + i * 16]),
                           bf16_pair(xr[8 * kWgLd + i * 16 + 8], xr[9 * kWgLd + i * 16 + 8])};
#pragma unroll
    for (int j = 0; j < kWgNT; ++j) {
      if (!kFull && j >= nt) break;
      mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
}

// One 8-row k-step of a warp's tiles: acc[i][j] += the three-term product
// of its A = X^T and B = Y fragments, summed from zero first. kFull: every
// m-tile and n-tile of the warp is live (no checks against mt, nt).
template <bool kFull>
__device__ __forceinline__ void wg_kstep(float (&acc)[kWgMT][kWgNT][4], const float* sx,
                                         const float* sy, int k0, int tig, int mt, int nt) {
  const float* xr = sx + (k0 + tig) * kWgLd;
  const float* yr = sy + (k0 + tig) * kWgLd;
  uint32_t bh[kWgNT][2], bl[kWgNT][2];  // B (k x n): (tig, gid) and (tig + 4, gid)
#pragma unroll
  for (int j = 0; j < kWgNT; ++j) {
    split_tf32(yr[j * 8], bh[j][0], bl[j][0]);
    split_tf32(yr[4 * kWgLd + j * 8], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
    if (!kFull && i >= mt) break;
    // A = X^T (m x k): (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4)
    uint32_t ah[4], al[4];
    split_tf32(xr[i * 16], ah[0], al[0]);
    split_tf32(xr[i * 16 + 8], ah[1], al[1]);
    split_tf32(xr[4 * kWgLd + i * 16], ah[2], al[2]);
    split_tf32(xr[4 * kWgLd + i * 16 + 8], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kWgNT; ++j) {
      if (!kFull && j >= nt) break;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, al, bh[j][0], bh[j][1]);
      mma_tf32(d, ah, bl[j][0], bl[j][1]);
      mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += d[c];
    }
  }
}

// The chunk's partial of the block's tile, stored straight to partial[z]
// (no cluster). C fragment: (gid, 2 tig .. 2 tig + 1) and (gid + 8, the
// same); Q is even.
__device__ __forceinline__ void wg_store(const float (&acc)[kWgMT][kWgNT][4], float* partial,
                                         int P, int Q, int p0, int q0, int wp, int wq, int gid,
                                         int tig) {
  float* out = partial + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
#pragma unroll
    for (int j = 0; j < kWgNT; ++j) {
      const int p = p0 + wp + i * 16 + gid, q = q0 + wq + j * 8 + 2 * tig;
      if (q >= Q) continue;
      if (p < P)
        *reinterpret_cast<float2*>(out + (size_t)p * Q + q) = make_float2(acc[i][j][0],
                                                                          acc[i][j][1]);
      if (p + 8 < P)
        *reinterpret_cast<float2*>(out + (size_t)(p + 8) * Q + q) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// The fold of a cluster of C blocks (C consecutive chunks of the tile) into
// one partial, partial[z / C]. C fragment pieces: rows (gid, gid + 8) of
// m-tile i, columns 2 tig .. 2 tig + 1 of n-tile j; a piece of row r is
// summed by rank r / R, which receives it in slot [this rank] of its shared
// memory ([C][R][kWgFoldLd], in the ring).
template <int C>
__device__ __forceinline__ void wg_fold(const float (&acc)[kWgMT][kWgNT][4], float* smem,
                                        float* partial, int P, int Q, int p0, int q0, int wp,
                                        int wq, int gid, int tig) {
  namespace cg = cooperative_groups;
  constexpr int R = kWgTile / C;  // rows of the tile a rank sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every block of the cluster is done with its ring
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wp + i * 16 + gid + 8 * h, owner = r / R;
      if (owner == rank) continue;
      float* row = smem + (rank * R + r - owner * R) * kWgFoldLd + wq + 2 * tig;
#pragma unroll
      for (int j = 0; j < kWgNT; ++j)
        *cluster.map_shared_rank(reinterpret_cast<float2*>(row + j * 8), owner) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
  cluster.sync();  // every piece landed; no shared memory of a peer is touched after this
  // this rank's rows: the ranks' pieces summed in ascending rank order (its
  // own from registers), written as the cluster's partial; pieces past P or Q
  // are dropped
  float* out = partial + (size_t)(blockIdx.z / C) * P * Q;
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wp + i * 16 + gid + 8 * h;
      if (r / R != rank) continue;
      const float* slot = smem + (r - rank * R) * kWgFoldLd + wq + 2 * tig;
      const int p = p0 + r;
#pragma unroll
      for (int j = 0; j < kWgNT; ++j) {
        const float2 own = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        float2 sum = rank == 0 ? own : *reinterpret_cast<const float2*>(slot + j * 8);
#pragma unroll
        for (int k = 1; k < C; ++k) {
          const float2 v = k == rank ? own : *reinterpret_cast<const float2*>(
              slot + k * R * kWgFoldLd + j * 8);
          sum.x += v.x;
          sum.y += v.y;
        }
        const int q = q0 + wq + j * 8 + 2 * tig;
        if (p < P && q < Q) *reinterpret_cast<float2*>(out + (size_t)p * Q + q) = sum;
      }
    }
  }
}

// partial[z] = X[rows of chunk z]^T Y[rows of chunk z] for the tile
// (blockIdx.x, blockIdx.y) of the [P][Q] output; kBf16: bf16 products.
template <bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 2)
weight_grad_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y, int ldy,
                   long long M, int P, int Q, long long chunk, float* __restrict__ partial) {
  constexpr int MT = kWgMT, NT = kWgNT;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int p0 = blockIdx.x * kWgTile, q0 = blockIdx.y * kWgTile;
  const long long mb = blockIdx.z * chunk;
  const long long me = mb + chunk < M ? mb + chunk : M;
  const int nk = me > mb ? (int)((me - mb + kWgRows - 1) / kWgRows) : 0;  // 0: a padding chunk
  const int xcols = P - p0, ycols = Q - q0;
  X += p0;
  Y += q0;
  // the warp's 64x32 piece of the tile (2 x 4 warps), its live 16-row m-tiles
  // and 8-column n-tiles
  const int wp = warp / 4 * (MT * 16), wq = warp % 4 * (NT * 8);
  const int mt = min(max((xcols - wp + 15) / 16, 0), MT);
  const int nt = min(max((ycols - wq + 7) / 8, 0), NT);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) wg_stage(smem + s * kWgStageFloats, X, ldx, Y, ldy, mb + s * kWgRows, me,
                         xcols, ycols, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int next = kt + kWgStages - 1;
    if (next < nk) wg_stage(smem + (next % kWgStages) * kWgStageFloats, X, ldx, Y, ldy,
                            mb + (long long)next * kWgRows, me, xcols, ycols, t);
    cp_async_commit();
    if (mt == 0 || nt == 0) continue;
    const float* sx = smem + (kt % kWgStages) * kWgStageFloats + wp + gid;
    const float* sy = smem + (kt % kWgStages) * kWgStageFloats + kWgRows * kWgLd + wq +
                      gid;
    if constexpr (kBf16) {
      if (mt == MT && nt == NT) {
#pragma unroll
        for (int k0 = 0; k0 < kWgRows; k0 += 16) wg_kstep_bf16<true>(acc, sx, sy, k0, tig, mt, nt);
      } else {
#pragma unroll
        for (int k0 = 0; k0 < kWgRows; k0 += 16)
          wg_kstep_bf16<false>(acc, sx, sy, k0, tig, mt, nt);
      }
    } else if (mt == MT && nt == NT) {
#pragma unroll
      for (int k0 = 0; k0 < kWgRows; k0 += 8) wg_kstep<true>(acc, sx, sy, k0, tig, mt, nt);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kWgRows; k0 += 8) wg_kstep<false>(acc, sx, sy, k0, tig, mt, nt);
    }
  }
  cp_async_wait<0>();
  // the reduction (a programmatic dependent) may start launching
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if constexpr (kWgClusterOf<kBf16> == 1)
    wg_store(acc, partial, P, Q, p0, q0, wp, wq, gid, tig);
  else
    wg_fold<kWgClusterOf<kBf16>>(acc, smem, partial, P, Q, p0, q0, wp, wq, gid, tig);
}

// out[i] = sum over z of partial[z][i] (n floats, n a multiple of 4): block
// b sums float4 columns [b cw, (b + 1) cw), cw = blockDim.x / kRedGroups;
// thread group g = t / cw the partials [g S / G, (g + 1) S / G) ascending
// from zero (G = kRedGroups), then the group sums in group order. Launched
// as a programmatic dependent: it waits for the grid before it (the
// partials' writer) before it reads.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int S, long long n, float* __restrict__ out) {
  __shared__ float4 sums[kThreads];
  const int t = threadIdx.x, cw = blockDim.x / kRedGroups, g = t / cw;
  const long long n4 = n / 4, c = (long long)blockIdx.x * cw + t % cw;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < n4) {
    const float4* p = reinterpret_cast<const float4*>(partial) + c;
    const int z1 = (int)((long long)(g + 1) * S / kRedGroups);
#pragma unroll 4
    for (int z = (int)((long long)g * S / kRedGroups); z < z1; ++z) {
      const float4 v = p[(size_t)z * n4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  sums[t] = s;
  __syncthreads();
  if (t < cw && c < n4) {
#pragma unroll
    for (int k = 1; k < kRedGroups; ++k) {
      const float4 v = sums[k * cw + t];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[c] = s;
  }
}

// out [n] = the sum of S partials [S][n] (reduce_kernel), launched as a
// programmatic dependent of the kernel before it on s; columns a block (cw
// float4) halved from 256 / kRedGroups until every SM gets a block. The
// order of the sum does not depend on cw. n a multiple of 4, partial and out
// 16-byte aligned (its loads and stores are float4): refused otherwise.
int reduce_partials(const float* partial, int S, long long n, float* out, cudaStream_t s) {
  if (n % 4 || ((uintptr_t)partial | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (!n_sm) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
  }
  const long long n4 = n / 4;
  int cw = kThreads / kRedGroups;
  while (cw > 1 && (n4 + cw - 1) / cw < n_sm) cw /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n4 + cw - 1) / cw));
  cfg.blockDim = dim3(cw * kRedGroups);
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, reduce_kernel, partial, S, n, out);
}

// Clusters of C = kWgClusterOf<kBf16> weight_grad_kernel<kBf16> blocks the
// card holds at once (cudaOccupancyMaxActiveClusters; at C = 1, blocks),
// asked once per process (one device) and instantiation; also sets the
// kernel's dynamic shared memory.
template <bool kBf16>
int wg_cluster_wave(int& wave) {
  static int cached = 0, err = 0;
  if (!cached && !err) {
    err = (int)cudaFuncSetAttribute(weight_grad_kernel<kBf16>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, kWgClusterOf<kBf16>);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kWgSmem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = 1;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = kWgClusterOf<kBf16>;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    if (!err) err = (int)cudaOccupancyMaxActiveClusters(&cached, weight_grad_kernel<kBf16>, &cfg);
    if (!err && cached <= 0) err = (int)cudaErrorInvalidConfiguration;
  }
  wave = cached;
  return err;
}

// The split of a weight-gradient product over M rows of `tiles` output
// tiles of n floats: chunk rows a chunk (at least kWgMinRows, a multiple of
// kWgRows) and S chunks, a multiple of the cluster size C (the last cluster
// padded with empty chunks), about one wave of `wave` clusters in all, the
// S / C partials within kPartialCap.
struct WgPlan {
  long long chunk, S;
};

template <int C>
WgPlan wg_plan(long long M, long long tiles, long long n, long long wave) {
  long long s = wave / tiles * C;
  if (s < C) s = C;
  if (s > kPartialCap / n * C) s = kPartialCap / n * C;
  long long rows = (M + s - 1) / s;
  if (rows < kWgMinRows) rows = kWgMinRows;
  rows = (rows + kWgRows - 1) / kWgRows * kWgRows;
  const long long S = (M + rows - 1) / rows;
  return {rows, (S + C - 1) / C * C};
}

bool aligned16(const void* p, int ld) {
  return ((uintptr_t)p & 15) == 0 && ld % 4 == 0;
}

// The split of the product out [P][Q] = X^T Y over M rows (wg_plan) that
// weight_grad<kBf16> takes on this card: plan. Refuses shapes weight_grad
// refuses.
template <bool kBf16>
int wg_plan_for(long long M, int P, int Q, WgPlan& plan) {
  if (M <= 0 || P <= 0 || Q <= 0 || P % 4 || Q % 4 || (long long)P * Q > kPartialCap)
    return (int)cudaErrorInvalidValue;
  int wave = 0;
  if (int err = wg_cluster_wave<kBf16>(wave)) return err;
  const long long tiles = (long long)((P + kWgTile - 1) / kWgTile) * ((Q + kWgTile - 1) / kWgTile);
  plan = wg_plan<kWgClusterOf<kBf16>>(M, tiles, (long long)P * Q, wave);
  return 0;
}

// out [P][Q] = X^T Y; partial holds kPartialCap floats; out and partial
// 16-byte aligned (reduce_kernel's float4). kBf16: bf16 products.
template <bool kBf16 = false>
int weight_grad(const float* X, int ldx, const float* Y, int ldy, long long M, int P, int Q,
                float* out, float* partial, cudaStream_t s) {
  if (P > ldx || Q > ldy || !aligned16(X, ldx) || !aligned16(Y, ldy) ||
      ((uintptr_t)out | (uintptr_t)partial) & 15)
    return (int)cudaErrorInvalidValue;
  constexpr int C = kWgClusterOf<kBf16>;
  WgPlan plan;
  if (int err = wg_plan_for<kBf16>(M, P, Q, plan)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((P + kWgTile - 1) / kWgTile, (Q + kWgTile - 1) / kWgTile, (unsigned)plan.S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = C;
  cfg.attrs = at;
  cfg.numAttrs = C > 1;  // no cluster launch at C = 1
  int err = (int)cudaLaunchKernelEx(&cfg, weight_grad_kernel<kBf16>, X, ldx, Y, ldy, M, P, Q,
                                    plan.chunk, partial);
  if (err) return err;
  return reduce_partials(partial, (int)(plan.S / C), (long long)P * Q, out, s);
}

}  // namespace
