// The x2h edge pass for Hopper (sm_90a): for every destination row i,
//   out[i] = h[i] + sum_k alpha_ik * e_w,ik * v_ik,
// alpha the per-head max-shifted softmax of q_i . k_ik / sqrt(8) over the
// row's valid edges (a row without one keeps h[i] exactly), k and v the edge
// MLPs: a first layer from the node projections (ni, nj of node_kernel) and
// the edge-type RBF table, LayerNorm + ReLU, then a 128x128 second layer.
//
// Replaces: targetdiff_tpu/ops/pallas/edge_layer.py:_x2h_kernel and the x2h
// pass of targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel. It
// serves every x2h caller: the inference block (td_block_x2h), the train-mode
// block (td_block_train_fwd) and the per-layer x2h (td_x2h_layer).
//
// What bounds it on this card: the two second layers are 65.5k of the ~76k
// FLOP of a live edge. On the float32 FMA pipes (67 TFLOP/s) they held the
// previous kernel near 17 TFLOP/s; here they run on the tensor cores. Every
// bar the port is held to is float32, so each product is three fp16
// products, hi*hi + hi*lo + lo*hi (hi = x rounded to fp16, lo = the
// remainder rounded again: ~2^-21 relative, as a three-term TF32 split;
// the weights are scaled by 2^8 so that their lo parts stay normal),
// accumulated in float32 with the bias: half the mma.sync instructions of a
// three-term TF32 split, and both operands split once, not per product. (A
// bf16 split is ~2^-16: too coarse for the training gradients' bars.)
// What is left on the FMA pipes is the first layer (20 RBF terms per edge
// and channel), the LayerNorms and the softmax; the source rows'
// projections are gathered from L2 (1 KB per live edge).
//
// Design:
//  * Persistent blocks, one per SM: 512 threads, ~220 KB of shared memory.
//    A block stages both second layers once, split into fp16 hi and lo in
//    the order of the mma B fragments, and keeps them for its whole walk: no
//    row reads them again.
//  * Four independent pipelines per block (4 warps each, named barriers),
//    each walking one row at a time, one 32-slot chunk per step: while one
//    runs its products on the tensor cores the others' gathers, first
//    layers and LayerNorms run. Rows are dealt round-robin to the grid's
//    pipelines. A pipeline takes its row's live chunks (those with a valid
//    edge) one per step; a row without one is copied (out = h) and costs no
//    step. Skipping a dead chunk is exact: its attention weights are zero.
//  * One walk with an online softmax: a chunk's k half, then its v half,
//    each from one gather, first-layer and LayerNorm pass into a 17 KB
//    activation buffer. Warp qd owns heads 4 qd .. 4 qd + 3 in both halves,
//    so the running per-head max and denominator and the running weighted
//    value sums stay in its registers. No logits array, no second walk over
//    the chunks.
//  * Per half: all threads gather the sources' projections with cp.async
//    while loading the first layer's node row and the columns of the row's
//    two edge types (a row's sources are ligand or protein); the first
//    layer adds ni, the type table and the RBF sum; LayerNorm + ReLU in
//    place, each value then stored as its fp16 hi and lo, column pairs side
//    by side so that one 8-byte load gives both fragments; then each warp
//    runs a 32 x 32 tile of mma.sync.m16n8k16 fp16 products. Warp 0 takes
//    the next chunk during the v products and writes its geometry (valid
//    slots of each edge type, RBF features) after them.
// Invalid slots keep a zero first layer: finite values, zero weight.
#pragma once

#include <cuda_fp16.h>

#include "block_common.cuh"

namespace {

constexpr int kX2hLanes = 4;                 // pipelines per block, one row each at a time
constexpr int kLaneThreads = 128;            // 4 warps per pipeline
constexpr int kX2hThreads = kX2hLanes * kLaneThreads;
constexpr int kLdz = H + 8;                  // padded activation row: conflict-free A fragments
constexpr int kKSteps = H / 16;              // 16-deep k-steps of a 128-deep product
constexpr int kNTiles = H / 8;               // 8-wide n-tiles of a 128-wide output (one per head)

// One pipeline's chunk: its row, geometry and the activations of one half
// (k or v) of the edge MLPs.
struct X2hLane {
  alignas(16) float z[KC][kLdz];  // gathered nj, first layer; then fp16 (hi, lo) column pairs
  alignas(16) float rbf[KC][R];
  float ew[KC];
  int src[KC];                    // source node b*N + j
  float pw[KC][NH];               // e_w * exp(logit - running max), from the k half
  unsigned valid;                 // valid slots of the chunk
  unsigned tmask[4];              // valid slots of each edge type
  long long row;                  // destination node b*N + i; -1: no row left
  int first, last;
  int lig;                        // the row is a ligand atom
};

struct X2hSmem {
  // k|v second layer times kWScale as mma B fragments per 16-deep k-step,
  // n-tile and lane: fp16 pairs (b0 hi, b1 hi, b0 lo, b1 lo),
  // b0 = W[16 ks + 2 tig (+1)][8 nt + g], b1 = W[16 ks + 2 tig + 8 (+9)][8 nt + g],
  // lower k in the lower half
  uint4 w[2][kKSteps][kNTiles][32];
  X2hLane lane[kX2hLanes];
};

// The second layers are staged times 2^8 (exact) so that the lo parts of
// small weights stay normal fp16 numbers; the products are scaled back.
constexpr float kWScale = 256.f;

// x = hi + lo to ~2^-22: hi is x rounded to fp16, lo the remainder rounded
// (for |x| below fp16's range; the LayerNorm output and 2^8 W are far below).
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

// Bit c set when chunk c of row bn holds a valid edge. Warp-wide.
__device__ __forceinline__ unsigned live_chunks(const bool* nmask, long long bn, int K, int lane) {
  unsigned bits = 0;
  for (int e0 = 0, c = 0; e0 < K; e0 += KC, ++c)
    if (__ballot_sync(0xffffffffu, e0 + lane < K && nmask[bn * K + e0 + lane])) bits |= 1u << c;
  return bits;
}

// First layer of the slots in `todo` (one edge type) for channel tl of the
// pipeline's half: z[slot][tl] += base + sum_r rbf[slot][r] w[r], two slots
// at a time, each as two partial sums.
__device__ __forceinline__ void first_layer_slots(X2hLane& L, unsigned todo, const float (&w)[R],
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

__global__ void __launch_bounds__(kX2hThreads, 1)
x2h_edge_kernel(const float* __restrict__ h, EdgeInputs in, const float* __restrict__ qn,
                PassParams p, int B, int N, int K, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char x2h_smem_raw[];
  X2hSmem& s = *reinterpret_cast<X2hSmem*>(x2h_smem_raw);
  const int t = threadIdx.x, lane = t & 31;
  const int l = t / kLaneThreads, tl = t % kLaneThreads, qd = tl >> 5;  // pipeline, its warp
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  X2hLane& L = s.lane[l];

  // both second layers, split into fp16 hi and lo, as B fragments (16 per
  // thread, their loads in flight together)
#pragma unroll 8
  for (int u = t; u < 2 * kKSteps * kNTiles * 32; u += kX2hThreads) {
    const int kv = u / (kKSteps * kNTiles * 32), ks = u / (kNTiles * 32) % kKSteps,
              nt = u / 32 % kNTiles, fl = u % 32;
    const float* w = (kv ? p.w2v : p.w2k) + (16 * ks + 2 * (fl & 3)) * H + 8 * nt + (fl >> 2);
    __half hi[4], lo[4];  // rows 0, 1, 8, 9 of the k-step (from 2 tig)
#pragma unroll
    for (int f = 0; f < 4; ++f) split_f16(kWScale * w[((f & 1) + 8 * (f >> 1)) * H], hi[f], lo[f]);
    s.w[kv][ks][nt][fl] = make_uint4(f16_pair(hi[0], hi[1]), f16_pair(hi[2], hi[3]),
                                     f16_pair(lo[0], lo[1]), f16_pair(lo[2], lo[3]));
  }
  __syncthreads();  // the weights are read-only from here; the pipelines run on their own

  // warp 0 of each pipeline walks its rows: cursor, its live chunks not yet
  // taken; the next chunk's first-round loads (take) and geometry (settle).
  // Row r is destination node r = b*N + i.
  const long long total = (long long)B * N;
  const long long stride = (long long)gridDim.x * kX2hLanes;
  long long cur = (long long)blockIdx.x * kX2hLanes + l;
  unsigned todo = 0;
  bool fresh = true, advance = false;
  long long nbn = -1;
  bool nvalid = false, nfirst = false, nlast = false;
  int nidx = 0;
  float new_w = 0.f;
  auto next_row = [&]() {
    cur += stride;
    todo = cur < total ? live_chunks(in.nmask, cur, K, lane) : 0;
    fresh = true;
  };
  auto take = [&]() {  // the next live chunk; a row without a valid edge keeps h
    while (cur < total && todo == 0) {
      reinterpret_cast<float4*>(out + cur * H)[lane] =
          reinterpret_cast<const float4*>(h + cur * H)[lane];
      next_row();
    }
    nbn = cur < total ? cur : -1;
    const int e = (cur < total ? (__ffs(todo) - 1) * KC : K) + lane;
    nvalid = false;
    if (e < K) {
      const long long ei = nbn * K + e;
      nvalid = in.nmask[ei];
      nidx = (int)in.idx[ei];
      new_w = in.ew[ei];
    }
    nfirst = fresh;
    nlast = (todo & (todo - 1)) == 0;
    if (cur < total) {
      todo &= todo - 1;
      fresh = false;
      advance = todo == 0;  // past the row's last chunk: settle moves to the next row
    }
  };
  auto settle = [&]() {  // the taken chunk's geometry into L
    int et = 0;
    bool dst_lig = false;
    if (nvalid) {
      const long long jn = nbn / N * N + nidx;
      const bool src_lig = in.mlig[jn];
      dst_lig = in.mlig[nbn];
      et = src_lig ? (dst_lig ? 0 : 1) : (dst_lig ? 2 : 3);
      L.src[lane] = (int)jn;
      L.ew[lane] = new_w;
      const float* x = in.x;
      const float rx = x[3 * nbn] - x[3 * jn], ry = x[3 * nbn + 1] - x[3 * jn + 1],
                  rz = x[3 * nbn + 2] - x[3 * jn + 2];
      const float dist = sqrtf(rx * rx + ry * ry + rz * rz + 1e-16f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = dist - in.offsets[r];
        L.rbf[lane][r] = expf(in.coeff * d * d);
      }
    } else {
      L.ew[lane] = 0.f;
    }
    const unsigned vmask = __ballot_sync(0xffffffffu, nvalid);
    const bool any_lig_dst = __ballot_sync(0xffffffffu, dst_lig) != 0;
#pragma unroll
    for (int ty = 0; ty < 4; ++ty) {
      const unsigned tm = __ballot_sync(0xffffffffu, nvalid && et == ty);
      if (lane == 0) L.tmask[ty] = tm;
    }
    if (lane == 0) {
      L.row = nbn;
      L.valid = vmask;
      L.first = nfirst;
      L.last = nlast;
      L.lig = any_lig_dst;
    }
    if (advance) {
      advance = false;
      next_row();
    }
  };
  if (qd == 0) {
    if (cur < total) todo = live_chunks(in.nmask, cur, K, lane);
    take();
    settle();
  }

  // warp qd owns channels [32 qd, 32 qd + 32) of each half: heads 4 qd .. 4 qd + 3.
  // Registers carry the row across chunks: the running max and denominator
  // of its heads, and the running weighted sums of its v channels.
  float m_run[4] = {}, d_run[4] = {}, o[4][2] = {};

  for (;;) {
    lane_sync(l);  // the chunk's geometry is in L
    const long long bn = L.row;
    if (bn < 0) break;
    const bool first = L.first, last = L.last;
    const unsigned vmask = L.valid;
    const int ta = L.lig ? 0 : 1;  // the row's edge types: ta (ligand source), ta + 2 (protein)
    float sc[4];  // exp(previous max - max) per head, 0 on the row's first chunk

    for (int kv = 0; kv < 2; ++kv) {  // the k half, then the v half of the edge MLPs
      // 2. gather the half of the sources' projections nj (zeros in invalid
      //    slots); meanwhile load the first layer's node and table columns
      for (int u = tl; u < KC * (H / 4); u += kLaneThreads) {
        const int slot = u / (H / 4), piece = u % (H / 4);
        float* dst = &L.z[slot][4 * piece];
        if ((vmask >> slot) & 1u)
          cp_async16(dst, in.nj + (size_t)L.src[slot] * H2 + kv * H + 4 * piece);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const int c = kv * H + tl;  // this thread's first-layer channel
      float wa[R], wb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        wa[r] = p.w_rbf[(ta * R + r) * H2 + c];
        wb[r] = p.w_rbf[((ta + 2) * R + r) * H2 + c];
      }
      const float zi = in.ni[bn * H2 + c];
      const float base_a = zi + p.w_et[ta * H2 + c], base_b = zi + p.w_et[(ta + 2) * H2 + c];
      cp_async_wait_all();
      lane_sync(l);

      // 3. first layer of the valid slots: z += ni_i + w_et[type] + sum_r rbf_r w_rbf[type][r]
      first_layer_slots(L, L.tmask[ta], wa, base_a, tl);
      first_layer_slots(L, L.tmask[ta + 2], wb, base_b, tl);
      lane_sync(l);

      // 4. LayerNorm + ReLU of the warp's eight slots (qd + 4 i), then each
      //    value split into fp16 hi and lo, stored as column pairs in place:
      //    (hi c, hi c+1) at even c, (lo c-1, lo c) at odd c (c = lane + 32 q)
      {
        float ln_scale[4], ln_bias[4], v[8][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ln_scale[q] = p.kv_ln[kv * H + lane + 32 * q];
          ln_bias[q] = p.kv_ln[H2 + kv * H + lane + 32 * q];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) v[i][q] = L.z[qd + 4 * i][lane + 32 * q];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mean, rstd;
          ln_stats(v[i], mean, rstd);
          uint32_t* zrow = reinterpret_cast<uint32_t*>(L.z[qd + 4 * i]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            __half hi, lo;
            split_f16(fmaxf((v[i][q] - mean) * rstd * ln_scale[q] + ln_bias[q], 0.f), hi, lo);
            const uint32_t other = __shfl_xor_sync(0xffffffffu, f16_pair(hi, lo), 1);
            const __half o_hi = __ushort_as_half((unsigned short)(other & 0xffffu));
            const __half o_lo = __ushort_as_half((unsigned short)(other >> 16));
            zrow[lane + 32 * q] = (lane & 1) ? f16_pair(o_lo, lo) : f16_pair(hi, o_hi);
          }
        }
      }
      lane_sync(l);
      // warp 0 takes the next chunk now: its loads fly during the v products
      if (kv == 1 && qd == 0) take();

      // 5. the warp's 32 x 32 tile of the half: bias + z W on the tensor cores,
      //    three fp16 products (small terms first), all times kWScale, then
      //    scaled back (exact). C fragment: acc[mt][nt] holds
      //    rows 16 mt + g (0, 1) and 16 mt + g + 8 (2, 3), channels
      //    32 qd + 8 nt + 2 tig (+1).
      float acc[2][4][4];
      {
        const float* bias = kv ? p.b2v : p.b2k;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float b0 = kWScale * bias[32 * qd + 8 * nt + 2 * tig];
          const float b1 = kWScale * bias[32 * qd + 8 * nt + 2 * tig + 1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            acc[mt][nt][0] = acc[mt][nt][2] = b0;
            acc[mt][nt][1] = acc[mt][nt][3] = b1;
          }
        }
        const float* a = &L.z[0][0];
#pragma unroll 2
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t ahi[2][4], alo[2][4];  // a0..a3: rows g, g + 8 x columns 2 tig, 2 tig + 8
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const uint2 pr = *reinterpret_cast<const uint2*>(
                  a + (16 * mt + g + 8 * (f & 1)) * kLdz + 16 * ks + 2 * tig + 8 * (f >> 1));
              ahi[mt][f] = pr.x;
              alo[mt][f] = pr.y;
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint4 w = s.w[kv][ks][4 * qd + nt][lane];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_f16(acc[mt][nt], alo[mt], w.x, w.y);
              mma_f16(acc[mt][nt], ahi[mt], w.z, w.w);
              mma_f16(acc[mt][nt], ahi[mt], w.x, w.y);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] *= 1.f / kWScale;
      }

      if (kv == 0) {
        // 6. the chunk's logits of the warp's four heads into their running
        //    max and denominator; L.pw = e_w * exp(logit - max) for the v half
        const float* qrow = qn + bn * H + 32 * qd + 2 * tig;
        const float lscale = rsqrtf((float)DH);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float q0 = qrow[8 * nt], q1 = qrow[8 * nt + 1];
          float lg[2][2], mx = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float x = acc[mt][nt][2 * hf] * q0 + acc[mt][nt][2 * hf + 1] * q1;
              x += __shfl_xor_sync(0xffffffffu, x, 1);
              x += __shfl_xor_sync(0xffffffffu, x, 2);
              const int i = 16 * mt + 8 * hf + g;
              lg[mt][hf] = (vmask >> i) & 1u ? x * lscale : -INFINITY;
              mx = fmaxf(mx, lg[mt][hf]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_old = first ? -INFINITY : m_run[nt];
          const float m_new = fmaxf(m_old, mx);  // finite: a live chunk has a valid slot
          float sum = 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = 16 * mt + 8 * hf + g;
              const float pv = expf(lg[mt][hf] - m_new);
              sum += pv;
              if (tig == nt) L.pw[i][4 * qd + nt] = pv * L.ew[i];
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          sc[nt] = expf(m_old - m_new);
          d_run[nt] = first ? sum : fmaf(d_run[nt], sc[nt], sum);
          m_run[nt] = m_new;
        }
        lane_sync(l);  // every warp is done with the k activations before the v gather
      } else {
        // 7. the chunk's weighted values into the running sums; the row's
        //    last chunk writes out = h + sums / denominator
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float part = 0.f;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                part = fmaf(L.pw[16 * mt + 8 * hf + g][4 * qd + nt], acc[mt][nt][2 * hf + j], part);
            part += __shfl_xor_sync(0xffffffffu, part, 4);
            part += __shfl_xor_sync(0xffffffffu, part, 8);
            part += __shfl_xor_sync(0xffffffffu, part, 16);
            o[nt][j] = first ? part : fmaf(o[nt][j], sc[nt], part);
          }
        if (last && g == 0) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int c = 32 * qd + 8 * nt + 2 * tig;
            const float inv = 1.f / fmaxf(d_run[nt], 1e-16f);
            const float2 hv = *reinterpret_cast<const float2*>(h + bn * H + c);
            *reinterpret_cast<float2*>(out + bn * H + c) =
                make_float2(hv.x + o[nt][0] * inv, hv.y + o[nt][1] * inv);
          }
        }
      }
    }
    // warp 0 writes the next chunk's geometry while the others finish their
    // v products, which read only z and registers; the barrier at the top
    // orders the next gather behind them
    if (qd == 0) settle();
  }
}

// out = x2h(h) on every row, for any K <= kMaxLayerK.
int launch_x2h(const float* h, const EdgeInputs& in, const float* q, const PassParams& p, int B,
               int N, int K, float* out, cudaStream_t s) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxLayerK)
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;  // the SMs of the (one) device, with the shared-memory limit raised
  if (n_sm == 0) {
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(x2h_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)sizeof(X2hSmem));
    if (err) return err;
    n_sm = sms;
  }
  const long long steps = ((long long)B * N + kX2hLanes - 1) / kX2hLanes;
  const int grid = (int)(steps < n_sm ? steps : n_sm);
  x2h_edge_kernel<<<grid, kX2hThreads, sizeof(X2hSmem), s>>>(h, in, q, p, B, N, K, out);
  return (int)cudaGetLastError();
}

}  // namespace
