// Tensor-core pieces shared by the Hopper (sm_90a) kernels: the node
// projections (node_proj.cuh), the x2h and h2x edge passes (x2h_edge.cuh,
// h2x_edge.cuh; in bf16 x2h_edge_bf16.cuh, h2x_edge_bf16.cuh) and the backward's recompute of their second layers
// (pass_bwd.cuh).
//
// Precision. Each piece that differs between precisions takes kBf16 (false
// by default, the float32-grade products below): the bf16 instantiations
// are the sampling path's default precision (the JAX package's dtype=bf16).
// There every product is ONE mma.sync.m16n8k16 (the node projections and
// the bf16 x2h pass: wgmma) with bf16 operands and float32 accumulation:
// the weights arrive as bf16 (`WeightT`), activations
// are rounded to bf16 where they are stored as the A operand (one bf16 pair
// per column pair, both words of the pair alike), the RBF features are
// rounded where the chunk's geometry is written; geometry, LayerNorm
// statistics, softmax and the residual stay float32. The weights are staged
// times kWScale in both (exact; bf16 keeps float32's exponent, so it only
// keeps the call sites alike).
//
// Products. Every bar the port is held to is float32, so each dense product
// runs as three fp16 products (mma.sync.m16n8k16; the node projections
// wgmma), lo*hi + hi*lo + hi*hi
// (hi = x rounded to fp16, lo = the remainder rounded again: ~2^-21
// relative, as a three-term TF32 split, with half its mma instructions),
// accumulated in float32. Weights are staged times kWScale = 2^8 (exact) so
// that the lo parts of small weights stay normal fp16 numbers; activations
// are LayerNorm outputs, or rows scaled by a power of two (node_proj.cuh),
// far inside fp16's range. (A bf16 split is ~2^-16: too coarse for the
// training gradients' bars.)
//
// Edge chunks. An edge pass walks a destination row's K edges in chunks of
// KC = 32 slots; a chunk without a valid edge is skipped (exact: its
// attention weights are zero). A pipeline of four warps computes one chunk's
// geometry (chunk_geometry), then per half (k or v) of the edge MLPs
// (chunk_half) gathers the sources' projections nj with cp.async, adds the
// first layer (ni, the edge-type row, the RBF-table sum), applies LayerNorm
// + ReLU and stores the activations as fp16 (hi, lo) column pairs, the A
// operand of tile_mma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "block_common.cuh"

namespace {

constexpr int kLaneThreads = 128;            // 4 warps per pipeline
constexpr int kLdz = H + 8;                  // padded activation row: conflict-free A fragments
constexpr int kKSteps = H / 16;              // 16-deep k-steps of a 128-deep product
constexpr int kNTiles = H / 8;               // 8-wide n-tiles of a 128-wide output (one per head)

// Weights are staged times 2^8 (exact); the products are scaled back.
constexpr float kWScale = 256.f;

// x = hi + lo to ~2^-22: hi is x rounded to fp16, lo the remainder rounded
// (for |x| below fp16's range).
__device__ __forceinline__ void split_f16(float x, __half& hi, __half& lo) {
  hi = __float2half_rn(x);
  lo = __float2half_rn(x - __half2float(hi));
}

__device__ __forceinline__ uint32_t f16_pair(__half lower, __half upper) {
  return (uint32_t)__half_as_ushort(lower) | ((uint32_t)__half_as_ushort(upper) << 16);
}

// d += a b for one m16n8k16 tile, fp16 operands, float32 accumulation.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for one m16n8k16 tile, bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lower, upper) rounded to bf16 as one mma operand register, lower in the
// low half.
__device__ __forceinline__ uint32_t bf16_pair(float lower, float upper) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lower, upper);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The weights' element type of an instantiation. The packed weights'
// pointers (PassParams, EwParams) are float pointers; in a bf16
// instantiation the product weights they point at are bf16
// (ops/kernels/block_denoiser.py packs them so), read through `weights`.
template <bool kBf16>
using WeightT = std::conditional_t<kBf16, __nv_bfloat16, float>;

template <bool kBf16>
__device__ __forceinline__ const WeightT<kBf16>* weights(const float* p) {
  return reinterpret_cast<const WeightT<kBf16>*>(p);
}

__device__ __forceinline__ float wload(const float* p) { return *p; }
__device__ __forceinline__ float wload(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Barrier of one pipeline's threads (named barrier 1 + pipeline).
__device__ __forceinline__ void lane_sync(int l) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + l), "r"(kLaneThreads) : "memory");
}

// Stages the 128-deep weight W[:, 0 .. 8 ntiles) (row-major, leading
// dimension ldw) times kWScale as mma B fragments, split into fp16 hi and lo,
// by threads t of nthreads: dst[(ks * ntiles + nt) * 32 + lane] holds fp16
// pairs (b0 hi, b1 hi, b0 lo, b1 lo), b0 = W[16 ks + 2 tig (+1)][8 nt + g],
// b1 = W[16 ks + 2 tig + 8 (+9)][8 nt + g], the lower k in the lower half.
// W2, when given, is a second weight of the same shape, staged after W in the
// same loop (PERF.md §6 compares one loop with two). bf16: (b0, b1, 0, 0),
// bf16 pairs in the same slots.
template <bool kBf16 = false>
__device__ __forceinline__ void stage_frags(uint4* dst, const WeightT<kBf16>* __restrict__ W,
                                            int ldw, int ntiles, int t, int nthreads,
                                            const WeightT<kBf16>* __restrict__ W2 = nullptr) {
  const int per = kKSteps * ntiles * 32;
#pragma unroll 8
  for (int u = t; u < (W2 ? 2 * per : per); u += nthreads) {
    const int v = u % per, ks = v / (ntiles * 32), nt = v / 32 % ntiles, fl = v % 32;
    const WeightT<kBf16>* w =
        (u < per ? W : W2) + (16 * ks + 2 * (fl & 3)) * ldw + 8 * nt + (fl >> 2);
    if constexpr (kBf16) {
      dst[u] = make_uint4(bf16_pair(kWScale * wload(w), kWScale * wload(w + ldw)),
                          bf16_pair(kWScale * wload(w + 8 * ldw), kWScale * wload(w + 9 * ldw)),
                          0u, 0u);
    } else {
      __half hi[4], lo[4];  // rows 0, 1, 8, 9 of the k-step (from 2 tig)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_f16(kWScale * w[((f & 1) + 8 * (f >> 1)) * ldw], hi[f], lo[f]);
      dst[u] = make_uint4(f16_pair(hi[0], hi[1]), f16_pair(hi[2], hi[3]), f16_pair(lo[0], lo[1]),
                          f16_pair(lo[2], lo[3]));
    }
  }
}

// A row's four values per lane (channel lane + 32 q) stored in place as fp16
// (hi, lo) column pairs: (hi c, hi c+1) at even c, (lo c-1, lo c) at odd c.
// bf16: the pair (c, c+1) rounded to bf16 at both. Warp-wide.
template <bool kBf16 = false>
__device__ __forceinline__ void store_split_row(uint32_t* zrow, const float (&v)[4], int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (kBf16) {
      const float other = __shfl_xor_sync(0xffffffffu, v[q], 1);
      zrow[lane + 32 * q] = (lane & 1) ? bf16_pair(other, v[q]) : bf16_pair(v[q], other);
    } else {
      __half hi, lo;
      split_f16(v[q], hi, lo);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, f16_pair(hi, lo), 1);
      const __half o_hi = __ushort_as_half((unsigned short)(other & 0xffffu));
      const __half o_lo = __ushort_as_half((unsigned short)(other >> 16));
      zrow[lane + 32 * q] = (lane & 1) ? f16_pair(o_lo, lo) : f16_pair(hi, o_hi);
    }
  }
}

// LayerNorm + ReLU of rows r0 + rstep i (i < 8) of z (float, row stride kLdz)
// in place, each stored as fp16 (hi, lo) column pairs (bf16: bf16 pairs).
// Warp-wide: the eight rows' loads are in flight together.
template <bool kBf16 = false>
__device__ __forceinline__ void ln_split_rows(float* z, int r0, int rstep,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias, int lane) {
  float ln_scale[4], ln_bias[4], v[8][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ln_scale[q] = scale[lane + 32 * q];
    ln_bias[q] = bias[lane + 32 * q];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) v[i][q] = z[(r0 + rstep * i) * kLdz + lane + 32 * q];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mean, rstd;
    ln_stats(v[i], mean, rstd);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[i][q] = fmaxf((v[i][q] - mean) * rstd * ln_scale[q] + ln_bias[q], 0.f);
    store_split_row<kBf16>(reinterpret_cast<uint32_t*>(z + (r0 + rstep * i) * kLdz), v[i], lane);
  }
}

// acc += a (W kWScale) for a warp's 32 x 8 NT tile of a 128-deep product,
// three fp16 products (small terms first); bf16: one bf16 product. a: 32
// rows of (hi, lo) column pairs (bf16: bf16 pairs), row stride kLdz; w: the
// staged fragments of the tile's NT n-tiles (in shared or global memory),
// w + (ks * ldn + nt) * 32 for n-tile nt of k-step ks. C fragment:
// acc[mt][nt] holds rows 16 mt + g (0, 1) and 16 mt + g + 8 (2, 3), columns
// 8 nt + 2 tig (+1); n-tiles from NT on are left as they are. Frag: uint4
// (stage_frags), or for bf16 uint2, the 8-byte (b0, b1) fragments without
// stage_frags' two zero words (pass_bwd.cuh: stage_frags16).
template <int NT = 4, bool kBf16 = false, typename Frag = uint4>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4][4], const float* a, const Frag* w,
                                         int ldn, int lane) {
  static_assert(std::is_same_v<Frag, uint4> || kBf16, "8-byte fragments hold bf16 pairs only");
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t ahi[2][4], alo[2][4];  // a0..a3: rows g, g + 8 x columns 2 tig, 2 tig + 8
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* af = a + (16 * mt + g + 8 * (f & 1)) * kLdz + 16 * ks + 2 * tig + 8 * (f >> 1);
        if constexpr (kBf16) {
          ahi[mt][f] = *reinterpret_cast<const uint32_t*>(af);
        } else {
          const uint2 pr = *reinterpret_cast<const uint2*>(af);
          ahi[mt][f] = pr.x;
          alo[mt][f] = pr.y;
        }
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const Frag wf = w[(ks * ldn + nt) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (kBf16) {
          mma_bf16(acc[mt][nt], ahi[mt], wf.x, wf.y);
        } else {
          mma_f16(acc[mt][nt], alo[mt], wf.x, wf.y);
          mma_f16(acc[mt][nt], ahi[mt], wf.z, wf.w);
          mma_f16(acc[mt][nt], ahi[mt], wf.x, wf.y);
        }
      }
    }
  }
}

// One pipeline's chunk: its row, geometry and the activations of one half
// (k or v) of the edge MLPs.
struct EdgeLane {
  alignas(16) float z[KC][kLdz];  // gathered nj, first layer; then fp16 (hi, lo) column pairs
  alignas(16) float rbf[KC][R];
  float ew[KC];
  int src[KC];                    // source node b*N + j
  float pw[KC][NH];               // e_w * exp(logit - max), from the k half
  unsigned valid;                 // valid slots of the chunk
  unsigned tmask[4];              // valid slots of each edge type
  long long row;                  // destination node b*N + i; -1: no row left
  int first, last;
  int lig;                        // the row is a ligand atom
};

// Bit c set when chunk c of row bn holds a valid edge. Warp-wide.
__device__ __forceinline__ unsigned live_chunks(const bool* nmask, long long bn, int K, int lane) {
  unsigned bits = 0;
  for (int e0 = 0, c = 0; e0 < K; e0 += KC, ++c)
    if (__ballot_sync(0xffffffffu, e0 + lane < K && nmask[bn * K + e0 + lane])) bits |= 1u << c;
  return bits;
}

// One slot of a chunk, as loaded from the graph.
struct EdgeSlot {
  bool valid;
  int idx;  // source j within the complex
  float w;  // edge weight
};

// Slot e of destination row bn (none past K or for bn < 0).
__device__ __forceinline__ EdgeSlot load_slot(const EdgeInputs& in, long long bn, int K, int e) {
  EdgeSlot s{false, 0, 0.f};
  if (bn >= 0 && e < K) {
    const long long ei = bn * K + e;
    s.valid = in.nmask[ei];
    s.idx = (int)in.idx[ei];
    s.w = in.ew[ei];
  }
  return s;
}

// The chunk's geometry into L from each lane's slot, warp-wide: source, edge
// weight and RBF features of the valid slots (e_w 0 elsewhere), the valid
// slots of each edge type (0 l->l, 1 l->p, 2 p->l, 3 p->p by (src, dst)
// ligand), whether the row is a ligand atom, and, when rel is given,
// rel = x_dst - x_src (0 in invalid slots). bf16: the RBF features rounded
// to bf16 (the first layer's product operands).
template <bool kBf16 = false>
__device__ __forceinline__ void chunk_geometry(EdgeLane& L, float (*rel)[3], const EdgeInputs& in,
                                               int N, long long bn, const EdgeSlot& s, int lane) {
  int et = 0;
  bool dst_lig = false;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  if (s.valid) {
    const long long jn = bn / N * N + s.idx;
    const bool src_lig = in.mlig[jn];
    dst_lig = in.mlig[bn];
    et = src_lig ? (dst_lig ? 0 : 1) : (dst_lig ? 2 : 3);
    L.src[lane] = (int)jn;
    L.ew[lane] = s.w;
    const float* x = in.x;
    rx = x[3 * bn] - x[3 * jn];
    ry = x[3 * bn + 1] - x[3 * jn + 1];
    rz = x[3 * bn + 2] - x[3 * jn + 2];
    const float dist = sqrtf(rx * rx + ry * ry + rz * rz + 1e-16f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = dist - in.offsets[r];
      if constexpr (kBf16)
        L.rbf[lane][r] = round_bf16(expf(in.coeff * d * d));
      else
        L.rbf[lane][r] = expf(in.coeff * d * d);
    }
  } else {
    L.ew[lane] = 0.f;
  }
  if (rel != nullptr) {
    rel[lane][0] = rx;
    rel[lane][1] = ry;
    rel[lane][2] = rz;
  }
  const unsigned vmask = __ballot_sync(0xffffffffu, s.valid);
  const bool any_lig_dst = __ballot_sync(0xffffffffu, dst_lig) != 0;
#pragma unroll
  for (int ty = 0; ty < 4; ++ty) {
    const unsigned tm = __ballot_sync(0xffffffffu, s.valid && et == ty);
    if (lane == 0) L.tmask[ty] = tm;
  }
  if (lane == 0) {
    L.row = bn;
    L.valid = vmask;
    L.lig = any_lig_dst;
  }
}

// First layer of the slots in `todo` (one edge type) for channel tl of the
// pipeline's half: z[slot][tl] += base + sum_r rbf[slot][r] w[r], two slots
// at a time, each as two partial sums.
__device__ __forceinline__ void first_layer_slots(EdgeLane& L, unsigned todo, const float (&w)[R],
                                                  float base, int tl) {
  while (todo) {
    const int s0 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int s1 = todo ? __ffs(todo) - 1 : s0;
    todo &= todo - 1;
    const float4* f0 = reinterpret_cast<const float4*>(L.rbf[s0]);
    const float4* f1 = reinterpret_cast<const float4*>(L.rbf[s1]);
    float a0 = base + L.z[s0][tl], b0 = 0.f, a1 = base + L.z[s1][tl], b1 = 0.f;
#pragma unroll
    for (int r4 = 0; r4 < R / 4; ++r4) {
      const float4 x0 = f0[r4], x1 = f1[r4];
      a0 = fmaf(x0.x, w[4 * r4], a0);
      b0 = fmaf(x0.y, w[4 * r4 + 1], b0);
      a1 = fmaf(x1.x, w[4 * r4], a1);
      b1 = fmaf(x1.y, w[4 * r4 + 1], b1);
      a0 = fmaf(x0.z, w[4 * r4 + 2], a0);
      b0 = fmaf(x0.w, w[4 * r4 + 3], b0);
      a1 = fmaf(x1.z, w[4 * r4 + 2], a1);
      b1 = fmaf(x1.w, w[4 * r4 + 3], b1);
    }
    L.z[s0][tl] = a0 + b0;
    L.z[s1][tl] = a1 + b1;  // s1 == s0 when one slot was left: the same value
  }
}

// One half (kv: 0 k, 1 v) of the chunk's edge MLPs up to the second layer's
// input, by the pipeline's 128 threads (tl; warp qd; pipeline l), from the
// geometry in L: gather the half of the sources' projections nj (zeros in
// invalid slots) while loading the first layer's node and table columns; the
// first layer z += ni_i + w_et[type] + sum_r rbf_r w_rbf[type][r] of the
// valid slots; LayerNorm + ReLU of the warp's eight slots (qd + 4 i), stored
// as fp16 (hi, lo) column pairs in place (bf16: bf16 pairs; the type table
// and the edge-type rows are bf16 weights). Ends at a pipeline barrier.
template <bool kBf16 = false>
__device__ __forceinline__ void chunk_half(EdgeLane& L, const EdgeInputs& in, const PassParams& p,
                                           long long bn, int kv, int tl, int qd, int lane, int l) {
  const unsigned vmask = L.valid;
  const int ta = L.lig ? 0 : 1;  // the row's edge types: ta (ligand source), ta + 2 (protein)
  for (int u = tl; u < KC * (H / 4); u += kLaneThreads) {
    const int slot = u / (H / 4), piece = u % (H / 4);
    float* dst = &L.z[slot][4 * piece];
    if ((vmask >> slot) & 1u)
      cp_async16(dst, in.nj + (size_t)L.src[slot] * H2 + kv * H + 4 * piece);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int c = kv * H + tl;  // this thread's first-layer channel
  float wa[R], wb[R], base_a, base_b;
  if constexpr (kBf16) {
    const __nv_bfloat16* w_rbf = weights<true>(p.w_rbf);
    const __nv_bfloat16* w_et = weights<true>(p.w_et);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wa[r] = wload(w_rbf + (ta * R + r) * H2 + c);
      wb[r] = wload(w_rbf + ((ta + 2) * R + r) * H2 + c);
    }
    const float zi = in.ni[bn * H2 + c];
    base_a = zi + wload(w_et + ta * H2 + c);
    base_b = zi + wload(w_et + (ta + 2) * H2 + c);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wa[r] = p.w_rbf[(ta * R + r) * H2 + c];
      wb[r] = p.w_rbf[((ta + 2) * R + r) * H2 + c];
    }
    const float zi = in.ni[bn * H2 + c];
    base_a = zi + p.w_et[ta * H2 + c], base_b = zi + p.w_et[(ta + 2) * H2 + c];
  }
  cp_async_wait_all();
  lane_sync(l);

  first_layer_slots(L, L.tmask[ta], wa, base_a, tl);
  first_layer_slots(L, L.tmask[ta + 2], wb, base_b, tl);
  lane_sync(l);

  ln_split_rows<kBf16>(&L.z[0][0], qd, 4, p.kv_ln + kv * H, p.kv_ln + H2 + kv * H, lane);
  lane_sync(l);
}

// Warpgroup products (wgmma, sm_90a only): operands in shared memory as
// K-major 8x8 core matrices without swizzle, accumulators in registers
// (edge_mma.cuh, node_proj.cuh).

// Byte offset of element (row, k) of a K-major wgmma operand without
// swizzle: 8x8 core matrices of 128 contiguous bytes, the K-adjacent ones 128
// bytes apart (the descriptor's leading byte offset), 8-row groups `sbo`
// bytes apart (its stride byte offset).
__host__ __device__ constexpr int kmajor_off(int row, int k, int sbo) {
  return (row >> 3) * sbo + (k >> 3) * 128 + (row & 7) * 16 + (k & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The wgmma descriptor of a K-major, unswizzled operand at p.
__device__ __forceinline__ uint64_t mma_desc(const void* p, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
// A descriptor moved on by k-step ks (16 columns: two core matrices, 256 bytes).
__device__ __forceinline__ uint64_t desc_ks(uint64_t d, int ks) { return d + 16 * ks; }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving the accumulator's reads and writes across
// the asynchronous products.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 64 accumulator registers of a warpgroup's m64n128 tile as asm operands
// %0 .. %63, and their list in the instruction.
#define TD_WGMMA_ACC(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
  "+f"(d[63])
#define TD_WGMMA_REGS                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "      \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B for the warpgroup's 64 x 128 tile, A and B bf16 in shared
// memory (descriptors), float32 accumulation; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TD_WGMMA_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TD_WGMMA_ACC(d)
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// The same with A from registers: a[0..3] the warp's 16 x 16 fragment of
// the k-step (rows g, g + 8 x columns 2 tig (+1), 2 tig + 8 (+9), bf16 pairs;
// kF16: fp16 pairs).
template <bool kF16 = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (kF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " TD_WGMMA_REGS
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : TD_WGMMA_ACC(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TD_WGMMA_REGS
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : TD_WGMMA_ACC(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
        : "memory");
  }
}

// d (+)= A B for the warpgroup's 64 x 16 tile, A from registers as in
// wgmma_rs (bf16 pairs), B bf16 in shared memory (16 x K, K-major): d[4 nt +
// 2 r + i] holds row g + 8 r of the warp's 16, column 8 nt + 2 tig + i.
__device__ __forceinline__ void wgmma_rs16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

// The SMs of the (one) device, with the shared-memory limit of `kernel`
// raised to `smem` bytes on the first call.
template <typename Kernel>
int sm_count(Kernel kernel, int smem, int& n_sm) {
  if (n_sm == 0) {
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    n_sm = sms;
  }
  return 0;
}

}  // namespace
