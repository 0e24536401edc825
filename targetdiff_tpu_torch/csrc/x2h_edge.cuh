// The x2h edge pass for Hopper (sm_90a): for every destination row i,
//   out[i] = h[i] + sum_k alpha_ik * e_w,ik * v_ik,
// alpha the per-head max-shifted softmax of q_i . k_ik / sqrt(8) over the
// row's valid edges (a row without one keeps h[i] exactly), k and v the edge
// MLPs: a first layer from the node projections (ni, nj of node_proj.cuh) and
// the edge-type RBF table, LayerNorm + ReLU, then a 128x128 second layer.
//
// Replaces: targetdiff_tpu/ops/pallas/edge_layer.py:_x2h_kernel and the x2h
// pass of targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel. It
// serves every float32 x2h caller: the inference block (td_block_x2h), the
// train-mode block (td_block_train_fwd) and the per-layer x2h (td_x2h_layer);
// the bf16 callers take x2h_edge_bf16.cuh's kernel (launch_x2h<true>).
//
// What bounds it on this card: the two second layers are 65.5k of the ~76k
// FLOP of a live edge. On the float32 FMA pipes (67 TFLOP/s) they held the
// previous kernel near 17 TFLOP/s; here they run on the tensor cores as
// three-term fp16 products, float32-grade (tc_common.cuh), accumulated in
// float32 with the bias. What is left on the FMA pipes is the first layer
// (20 RBF terms per edge and channel), the LayerNorms and the softmax; the
// source rows' projections are gathered from L2 (1 KB per live edge).
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
//    pipelines: all B x N rows, or a row list (rows order[0, *count), the
//    sampler's dependency cone, cone.cu, the count read on the device; the
//    rows off the list are not written). A pipeline takes its row's live
//    chunks (those with a valid edge) one per step; a row without one is
//    copied (out = h) and costs no step. Skipping a dead chunk is exact:
//    its attention weights are zero.
//  * One walk with an online softmax: a chunk's k half, then its v half,
//    each from one gather, first-layer and LayerNorm pass into a 17 KB
//    activation buffer. Warp qd owns heads 4 qd .. 4 qd + 3 in both halves,
//    so the running per-head max and denominator and the running weighted
//    value sums stay in its registers. No logits array, no second walk over
//    the chunks.
//  * Per half (tc_common.cuh: chunk_half): all threads gather the sources'
//    projections with cp.async while loading the first layer's node row and
//    the columns of the row's two edge types (a row's sources are ligand or
//    protein); the first layer adds ni, the type table and the RBF sum;
//    LayerNorm + ReLU in place, each value then stored as its fp16 hi and
//    lo, column pairs side by side so that one 8-byte load gives both
//    fragments; then each warp runs a 32 x 32 tile of mma.sync.m16n8k16
//    fp16 products (tile_mma). Warp 0 takes
//    the next chunk during the v products and writes its geometry (valid
//    slots of each edge type, RBF features) after them.
// Invalid slots keep a zero first layer: finite values, zero weight.
#pragma once

#include "tc_common.cuh"
#include "x2h_edge_bf16.cuh"

namespace {

constexpr int kX2hLanes = 4;                 // pipelines per block, one row each at a time
constexpr int kX2hThreads = kX2hLanes * kLaneThreads;

struct X2hSmem {
  // k|v second layer times kWScale as mma B fragments per 16-deep k-step,
  // n-tile and lane (stage_frags)
  uint4 w[2][kKSteps][kNTiles][32];
  EdgeLane lane[kX2hLanes];
};

__global__ void __launch_bounds__(kX2hThreads, 1)
x2h_edge_kernel(const float* __restrict__ h, EdgeInputs in, const float* __restrict__ qn,
                PassParams p, int B, int N, int K, const int* __restrict__ order,
                const int* __restrict__ count, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char x2h_smem_raw[];
  X2hSmem& s = *reinterpret_cast<X2hSmem*>(x2h_smem_raw);
  const int t = threadIdx.x, lane = t & 31;
  const int l = t / kLaneThreads, tl = t % kLaneThreads, qd = tl >> 5;  // pipeline, its warp
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  EdgeLane& L = s.lane[l];

  // both second layers, split into fp16 hi and lo, as B fragments, in one loop
  stage_frags(&s.w[0][0][0][0], p.w2k, H, kNTiles, t, kX2hThreads, p.w2v);
  __syncthreads();  // the weights are read-only from here; the pipelines run on their own

  // warp 0 of each pipeline walks its rows: cursor, its live chunks not yet
  // taken; the next chunk's slot loads (take) and geometry (settle).
  // Walk position u is destination node u = b*N + i, or order[u] with a
  // row list.
  const long long total = count ? (long long)*count : (long long)B * N;
  const auto node = [order](long long u) { return order ? (long long)order[u] : u; };
  const long long stride = (long long)gridDim.x * kX2hLanes;
  long long cur = (long long)blockIdx.x * kX2hLanes + l;
  unsigned todo = 0;
  bool fresh = true, advance = false;
  long long nbn = -1;
  bool nfirst = false, nlast = false;
  EdgeSlot slot{false, 0, 0.f};
  auto next_row = [&]() {
    cur += stride;
    todo = cur < total ? live_chunks(in.nmask, node(cur), K, lane) : 0;
    fresh = true;
  };
  auto take = [&]() {  // the next live chunk; a row without a valid edge keeps h
    while (cur < total && todo == 0) {
      const long long bn = node(cur);
      reinterpret_cast<float4*>(out + bn * H)[lane] =
          reinterpret_cast<const float4*>(h + bn * H)[lane];
      next_row();
    }
    nbn = cur < total ? node(cur) : -1;
    slot = load_slot(in, nbn, K, (cur < total ? (__ffs(todo) - 1) * KC : K) + lane);
    nfirst = fresh;
    nlast = (todo & (todo - 1)) == 0;
    if (cur < total) {
      todo &= todo - 1;
      fresh = false;
      advance = todo == 0;  // past the row's last chunk: settle moves to the next row
    }
  };
  auto settle = [&]() {  // the taken chunk's geometry into L
    chunk_geometry(L, nullptr, in, N, nbn, slot, lane);
    if (lane == 0) {
      L.first = nfirst;
      L.last = nlast;
    }
    if (advance) {
      advance = false;
      next_row();
    }
  };
  if (qd == 0) {
    if (cur < total) todo = live_chunks(in.nmask, node(cur), K, lane);
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
    float sc[4];  // exp(previous max - max) per head, 0 on the row's first chunk

    for (int kv = 0; kv < 2; ++kv) {  // the k half, then the v half of the edge MLPs
      // gather, first layer, LayerNorm + ReLU into fp16 (hi, lo) pairs
      chunk_half(L, in, p, bn, kv, tl, qd, lane, l);
      // warp 0 takes the next chunk now: its loads fly during the v products
      if (kv == 1 && qd == 0) take();

      // the warp's 32 x 32 tile of the half: bias + z W on the tensor cores,
      // all times kWScale, then scaled back (exact). C fragment: acc[mt][nt]
      // holds rows 16 mt + g (0, 1) and 16 mt + g + 8 (2, 3), channels
      // 32 qd + 8 nt + 2 tig (+1).
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
        tile_mma<4>(acc, &L.z[0][0], &s.w[kv][0][4 * qd][0], kNTiles, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] *= 1.f / kWScale;
      }

      if (kv == 0) {
        // the chunk's logits of the warp's four heads into their running max
        // and denominator; L.pw = e_w * exp(logit - max) for the v half
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
        // the chunk's weighted values into the running sums; the row's last
        // chunk writes out = h + sums / denominator
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

// out = x2h(h) for any K <= kMaxLayerK, on every row or (order non-null)
// on the rows order[0, *count); kBf16: bf16 products, on the wgmma kernel
// of x2h_edge_bf16.cuh.
template <bool kBf16 = false>
int launch_x2h(const float* h, const EdgeInputs& in, const float* q, const PassParams& p, int B,
               int N, int K, float* out, cudaStream_t s, const int* order = nullptr,
               const int* count = nullptr) {
  if ((order == nullptr) != (count == nullptr)) return (int)cudaErrorInvalidValue;
  if constexpr (kBf16) {
    return launch_x2h_mma(h, in, q, p, B, N, K, order, count, out, s);
  } else {
    if (B <= 0 || N <= 0 || K <= 0 || K > kMaxLayerK) return (int)cudaErrorInvalidValue;
    static int n_sm = 0;
    if (int err = sm_count(x2h_edge_kernel, (int)sizeof(X2hSmem), n_sm)) return err;
    const long long steps = ((long long)B * N + kX2hLanes - 1) / kX2hLanes;
    const int grid = (int)(steps < n_sm ? steps : n_sm);
    x2h_edge_kernel<<<grid, kX2hThreads, sizeof(X2hSmem), s>>>(h, in, q, p, B, N, K, order,
                                                                count, out);
    return (int)cudaGetLastError();
  }
}

}  // namespace
