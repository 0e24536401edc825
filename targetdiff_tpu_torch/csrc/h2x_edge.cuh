// The h2x edge pass for Hopper (sm_90a): for every destination row i >= row0
// of each complex,
//   out[i] = x[i] + mask_ligand[i] * sum_k mean_h(alpha_ikh * e_w,ik * v_ikh) * rel_ik,
// alpha the per-head max-shifted softmax of q_i . k_ik / sqrt(8) over the
// row's valid edges, k the 128-wide and v the 16-wide output of the edge
// MLPs (first layer from the node projections and the edge-type RBF table,
// LayerNorm + ReLU, second layer), rel = x_i - x_j. A row without a valid
// edge keeps x[i] exactly.
//
// Replaces: targetdiff_tpu/ops/pallas/edge_layer.py:_h2x_kernel and the h2x
// pass of targetdiff_tpu/ops/pallas/block_denoiser.py:_block_kernel. It
// serves every float32 h2x caller: the inference block (td_block_h2x), the
// train-mode block (td_block_train_fwd) and the per-layer h2x (td_h2x_layer);
// the bf16 callers take h2x_edge_bf16.cuh's kernel (launch_h2x<true>).
//
// What bounds it on this card: the k second layer is 32.8k of the ~50k FLOP
// of a live edge, the v second layer 4.1k; both run on the tensor cores as
// three-term fp16 products, float32-grade (tc_common.cuh). Its work is small
// (the ligand rows alone: 128-256 rows at B=4), so what decides is how many
// independent units fill the card and how long one takes.
//
// Design:
//  * Work unit = (destination row, live 32-slot chunk). A chunk without a
//    valid edge is skipped (exact: its attention weights are zero). A unit
//    yields per-head partials: the chunk's max logit m_h, d_h =
//    sum exp(l - m_h) and the 3-vector S_h = sum exp(l - m_h) e_w v_h rel.
//    One walk: no logits array, no second pass over the chunks.
//  * Persistent blocks, one per SM: 512 threads, four pipelines of four
//    warps (named barriers), ~182 KB of shared memory. A block stages both
//    second layers once (w2k as 16 n-tiles, w2v as 2) as fp16 hi/lo
//    fragments and keeps them for its whole walk.
//  * A block takes rows blockIdx.x + gridDim.x i, up to kBatchRows at a
//    time; the batch's units (its rows in order, each row's live chunks in
//    order) are dealt to the four pipelines in turn, so a row's chunks run
//    side by side. After the batch, one warp per row merges its partials in
//    chunk order (M = max m, D = sum d e^(m - M), S = sum S e^(m - M)) and
//    writes x + mask (sum_h S_h / D_h) / 16. Every sum has a fixed order, so
//    two launches are bitwise equal; nothing leaves the block but x'.
//  * Per unit, as the x2h pass (tc_common.cuh): warp 0 writes the chunk's
//    geometry (and rel); the k half (gather, first layer, LayerNorm + ReLU
//    as fp16 pairs, each warp a 32 x 32 tile of the k product: the logits
//    of its four heads, their max, denominator and e_w exp(l - m)); then the
//    v half, the 32 x 16 product on the tensor cores too (one 16 x 8 tile
//    per warp: 24 mma per warp, against 512 FMA per thread on the FMA
//    pipes, and the fragment staging and the A operand are the k half's),
//    and each warp's weighted sums of its two heads' values times rel.
#pragma once

#include "h2x_edge_bf16.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kH2xLanes = 4;                   // pipelines per block
constexpr int kH2xThreads = kH2xLanes * kLaneThreads;
constexpr int kBatchRows = 8;                  // destination rows a block merges at a time
constexpr int kMaxChunks = kMaxLayerK / KC;    // chunks of a row
constexpr int kVTiles = NH / 8;                // n-tiles of the 16-wide v second layer

// One unit's partials per head: the chunk's max logit m, d = sum exp(l - m)
// and s = sum exp(l - m) e_w v rel over its valid slots.
struct H2xPartial {
  float m[NH];
  float d[NH];
  float s[NH][3];
};

struct H2xLane {
  EdgeLane e;
  float rel[KC][3];    // x_dst - x_src per slot (0 in invalid slots)
  float sv[2][NH][3];  // weighted value sums over slots 0-15 and 16-31
};

struct H2xSmem {
  uint4 wk[kKSteps][kNTiles][32];  // w2k x kWScale, stage_frags
  uint4 wv[kKSteps][kVTiles][32];  // w2v x kWScale
  H2xLane lane[kH2xLanes];
  H2xPartial part[kBatchRows * kMaxChunks];  // by unit of the batch
  long long row[kBatchRows];                  // destination node b*N + i; -1: none
  unsigned bits[kBatchRows];                  // live chunks of each row
  int first_unit[kBatchRows + 1];             // the row's first unit; the batch's count last
};

__global__ void __launch_bounds__(kH2xThreads, 1)
h2x_edge_kernel(EdgeInputs in, const float* __restrict__ qn, PassParams p, int B, int N, int K,
                int row0, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char h2x_smem_raw[];
  H2xSmem& s = *reinterpret_cast<H2xSmem*>(h2x_smem_raw);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int l = t / kLaneThreads, tl = t % kLaneThreads, qd = tl >> 5;  // pipeline, its warp
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  H2xLane& L = s.lane[l];

  // both second layers, split into fp16 hi and lo, as B fragments (the
  // first batch's barriers order them before their use)
  stage_frags(&s.wk[0][0][0], p.w2k, H, kNTiles, t, kH2xThreads);
  stage_frags(&s.wv[0][0][0], p.w2v, NH, kVTiles, t, kH2xThreads);

  const int nd = N - row0;
  const long long rows = (long long)B * nd;
  const long long grid = gridDim.x;
  for (long long base = blockIdx.x; base < rows; base += grid * kBatchRows) {
    // 1. the batch's rows (warp w: row base + grid w) and their live chunks
    if (warp < kBatchRows) {
      const long long u = base + grid * warp;
      const long long bn = u < rows ? u / nd * N + row0 + u % nd : -1;
      const unsigned bits = bn >= 0 ? live_chunks(in.nmask, bn, K, lane) : 0u;
      if (lane == 0) {
        s.row[warp] = bn;
        s.bits[warp] = bits;
      }
    }
    __syncthreads();
    if (t == 0) {
      int n = 0;
      for (int r = 0; r < kBatchRows; ++r) {
        s.first_unit[r] = n;
        n += __popc(s.bits[r]);
      }
      s.first_unit[kBatchRows] = n;
    }
    __syncthreads();

    // 2. pipeline l takes units l, l + 4, ...
    const int nunits = s.first_unit[kBatchRows];
    for (int j = l; j < nunits; j += kH2xLanes) {
      if (qd == 0) {  // the unit's row and chunk; its geometry into L
        int r = 0;
        while (j >= s.first_unit[r + 1]) ++r;
        unsigned bits = s.bits[r];
        for (int k = j - s.first_unit[r]; k > 0; --k) bits &= bits - 1;
        const long long bn = s.row[r];
        chunk_geometry(L.e, L.rel, in, N, bn,
                              load_slot(in, bn, K, (__ffs(bits) - 1) * KC + lane), lane);
      }
      lane_sync(l);  // the chunk's geometry is in L
      const long long bn = L.e.row;
      const unsigned vmask = L.e.valid;
      H2xPartial& P = s.part[j];

      // the k half: warp qd's 32 x 32 tile, channels 32 qd .. (heads 4 qd .. 4 qd + 3)
      chunk_half(L.e, in, p, bn, 0, tl, qd, lane, l);
      {
        float acc[2][4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float b0 = kWScale * p.b2k[32 * qd + 8 * nt + 2 * tig];
          const float b1 = kWScale * p.b2k[32 * qd + 8 * nt + 2 * tig + 1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            acc[mt][nt][0] = acc[mt][nt][2] = b0;
            acc[mt][nt][1] = acc[mt][nt][3] = b1;
          }
        }
        tile_mma<4>(acc, &L.e.z[0][0], &s.wk[0][4 * qd][0], kNTiles, lane);
        // the chunk's logits of the warp's four heads: their max, denominator
        // and L.e.pw = e_w exp(logit - max) for the v half
        const float* qrow = qn + bn * H + 32 * qd + 2 * tig;
        const float lscale = rsqrtf((float)DH);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float q0 = qrow[8 * nt] * (1.f / kWScale), q1 = qrow[8 * nt + 1] * (1.f / kWScale);
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
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));  // finite: the chunk is live
          float sum = 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = 16 * mt + 8 * hf + g;
              const float pv = expf(lg[mt][hf] - mx);
              sum += pv;
              if (tig == nt) L.e.pw[i][4 * qd + nt] = pv * L.e.ew[i];
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          if (lane == 0) {
            P.m[4 * qd + nt] = mx;
            P.d[4 * qd + nt] = sum;
          }
        }
      }
      lane_sync(l);  // every warp is done with the k activations before the v gather

      // the v half: warp qd's 16 x 8 tile, slots 16 mt .., heads 8 nt ..
      chunk_half(L.e, in, p, bn, 1, tl, qd, lane, l);
      {
        const int mt = qd >> 1, nt = qd & 1;
        const float b0 = kWScale * p.b2v[8 * nt + 2 * tig];
        const float b1 = kWScale * p.b2v[8 * nt + 2 * tig + 1];
        float acc[4] = {b0, b1, b0, b1};  // rows 16 mt + g (0, 1), + 8 (2, 3)
        const float* a = &L.e.z[16 * mt][0];
#pragma unroll 4
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float* af = a + (g + 8 * (f & 1)) * kLdz + 16 * ks + 2 * tig + 8 * (f >> 1);
            const uint2 pr = *reinterpret_cast<const uint2*>(af);
            ahi[f] = pr.x;
            alo[f] = pr.y;
          }
          const uint4 wf = s.wv[ks][nt][lane];
          mma_f16(acc, alo, wf.x, wf.y);
          mma_f16(acc, ahi, wf.z, wf.w);
          mma_f16(acc, ahi, wf.x, wf.y);
        }
        // sum over the tile's 16 slots of e_w exp(l - m) v rel, per head
        const int i0 = 16 * mt + g, i1 = i0 + 8;
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          const int hh = 8 * nt + 2 * tig + jh;
          const float w0 = L.e.pw[i0][hh] * (acc[jh] * (1.f / kWScale));
          const float w1 = L.e.pw[i1][hh] * (acc[2 + jh] * (1.f / kWScale));
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float sc = fmaf(w0, L.rel[i0][c], w1 * L.rel[i1][c]);
            sc += __shfl_xor_sync(0xffffffffu, sc, 4);
            sc += __shfl_xor_sync(0xffffffffu, sc, 8);
            sc += __shfl_xor_sync(0xffffffffu, sc, 16);
            if (g == 0) L.sv[mt][hh][c] = sc;
          }
        }
      }
      lane_sync(l);
      if (tl < NH * 3) {
        const int hh = tl / 3, c = tl % 3;
        P.s[hh][c] = L.sv[0][hh][c] + L.sv[1][hh][c];
      }
    }
    __syncthreads();

    // 3. warp w merges row w's partials in chunk order and writes x'
    if (warp < kBatchRows && s.row[warp] >= 0) {
      const long long bn = s.row[warp];
      const int u0 = s.first_unit[warp], u1 = s.first_unit[warp + 1];
      float d[3] = {0.f, 0.f, 0.f};
      if (lane < NH && u1 > u0) {
        float m = -INFINITY;
        for (int u = u0; u < u1; ++u) m = fmaxf(m, s.part[u].m[lane]);
        float den = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
        for (int u = u0; u < u1; ++u) {
          const H2xPartial& pu = s.part[u];
          const float f = expf(pu.m[lane] - m);
          den = fmaf(pu.d[lane], f, den);
          sx = fmaf(pu.s[lane][0], f, sx);
          sy = fmaf(pu.s[lane][1], f, sy);
          sz = fmaf(pu.s[lane][2], f, sz);
        }
        const float inv = 1.f / fmaxf(den, 1e-16f);
        d[0] = sx * inv;
        d[1] = sy * inv;
        d[2] = sz * inv;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = warp_sum(d[c]) * (1.f / NH);
      if (lane == 0) {
        const float gate = in.mlig[bn] ? 1.f : 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) out[3 * bn + c] = in.x[3 * bn + c] + gate * d[c];
      }
    }
    __syncthreads();  // the next batch rewrites row, bits and part
  }
}

// The rows [row0, N) of each complex of out = h2x(x), for any K <= kMaxLayerK;
// kBf16: bf16 products, on the wgmma kernel of h2x_edge_bf16.cuh.
template <bool kBf16 = false>
int launch_h2x(const EdgeInputs& in, const float* q, const PassParams& p, int B, int N, int K,
               int row0, float* out, cudaStream_t s) {
  if constexpr (kBf16) {
    return launch_h2x_mma(in, q, p, B, N, K, row0, out, s);
  } else {
    if (B <= 0 || N <= 0 || K <= 0 || K > kMaxLayerK || row0 < 0 || row0 >= N)
      return (int)cudaErrorInvalidValue;
    static int n_sm = 0;
    if (int err = sm_count(h2x_edge_kernel, (int)sizeof(H2xSmem), n_sm)) return err;
    const long long rows = (long long)B * (N - row0);
    const int grid = (int)(rows < n_sm ? rows : n_sm);
    h2x_edge_kernel<<<grid, kH2xThreads, sizeof(H2xSmem), s>>>(in, q, p, B, N, K, row0, out);
    return (int)cudaGetLastError();
  }
}

}  // namespace
