// The sampler's dependency cone for Hopper (sm_90a): which rows of a block's
// last call each layer must compute when only the ligand outputs are read
// (need_full_h=False).
//
// Replaces: the per-layer liveness half of
// targetdiff_tpu/ops/pallas/block_denoiser.py:compute_tile_flags (num_layers
// = L, the v10 flags _block_kernel skips x2h tiles by), at row granularity:
// the row rule that function's tiles are a superset of.
//
// The rule, per complex. hop(r) = 0 on every ligand-tail row r >= N -
// n_ligand (masked or not); a row s that a row d lists as a valid neighbour
// (an edge d <- s) gets hop(s) = 1 + min hop(d); rows the sweep does not
// reach within L + 1 steps get L + 2. Layer l (0-based) of the block then
// needs h' on the rows with hop <= L - l, and node projections (nj) on the
// rows with hop <= L - l + 1: the sets only shrink with l, so a row left
// stale at one layer is never read again.
//
// Outputs: hop [B*N]; order [B*N], the rows b*N + i sorted by hop, ties by
// row (a stable sort), so that the rows of hop <= k are order[0, counts[k]);
// counts [L + 2], counts[k] = the rows of hop <= k over the batch. Everything
// stays on the device: the block kernels read their row counts from counts.
//
// What bounds it: each row's neighbour list is read once (its K indices and
// mask bytes, ~9 bytes a slot) and hop and order written once; at kNN B=100
// (60,800 rows, K = 32) ~17.8 MB, ~5 us at the memory rate. Its launches
// are latency: L + 1 dependent sweeps, each behind a block barrier.
//
// Design: two launches, one block per complex each.
//  * cone_kernel<false, kCached>: the complex's hops in shared memory.
//    kCached (K <= 32 and the lists fit: up to ~3,400 rows at K = 32) first
//    copies the complex's neighbour lists into shared memory in one pass,
//    every thread's loads independent (slot e: its source as 16 bits, its
//    mask bit into its row's word), so that the sweeps read no device
//    memory; without it a frontier row reads its list from device memory
//    in its sweep. Sweep k = 1 .. L + 1: warp w walks rows w, w + warps,
//    ...; a row on the frontier (hop k - 1) reads its list, one slot a lane,
//    and lowers hop(s) to k at each valid source s (a shared atomicMin:
//    every writer of a sweep writes the same k, and no row of the frontier
//    is written, so the result does not depend on order). Then hop to
//    device memory and the complex's histogram of hops (L + 3 bins).
//  * cone_kernel<true, false>: from every complex's histogram, its first
//    position in each bin (the rows of lower hop over the batch, then the
//    rows of its hop in earlier complexes); then its rows in chunks of the
//    block's threads: a lane's rank among the warp's lanes of its hop
//    (__match_any_sync), the warps' counts scanned in order, and each row
//    written to its place. Block 0 writes counts.
// Every count is an integer sum and no result depends on an atomic's order:
// two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConeThreads = 512;
constexpr int kConeWarps = kConeThreads / 32;
constexpr int kMaxBins = 32;  // hop values 0 .. L + 2: L <= 29
constexpr int kMaxSmem = 232448;

// Shared memory of cone_kernel<false, kCached> for N rows of K slots.
__host__ __device__ constexpr size_t cone_smem(int N, int K, bool cached) {
  return (size_t)(N + kMaxBins) * sizeof(int) +
         (cached ? (size_t)N * sizeof(unsigned) + (size_t)N * K * sizeof(uint16_t) : 0);
}

template <bool kOrder, bool kCached>
__global__ void __launch_bounds__(kConeThreads)
cone_kernel(const int64_t* __restrict__ idx, const bool* __restrict__ nmask, int B, int N, int K,
            int n_ligand, int L, int* __restrict__ hop, int* __restrict__ order,
            int* __restrict__ counts, int* __restrict__ hist) {
  extern __shared__ int cone_smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, b = blockIdx.x;
  const int bins = L + 3, far = L + 2;
  const long long base = (long long)b * N;
  if constexpr (!kOrder) {
    int* hs = cone_smem_raw;  // [N] hop of the complex's rows
    int* hb = hs + N;         // [kMaxBins] its histogram
    unsigned* bits = reinterpret_cast<unsigned*>(hb + kMaxBins);  // kCached: [N] valid slots
    uint16_t* src16 = reinterpret_cast<uint16_t*>(bits + N);       // kCached: [N * K] sources
    for (int i = t; i < N; i += kConeThreads) {
      hs[i] = i >= N - n_ligand ? 0 : far;
      if constexpr (kCached) bits[i] = 0u;
    }
    for (int k = t; k < bins; k += kConeThreads) hb[k] = 0;
    __syncthreads();
    const long long e0 = base * K;
    if constexpr (kCached) {
#pragma unroll 8
      for (int e = t; e < N * K; e += kConeThreads) {
        const int s = (int)idx[e0 + e];
        src16[e] = (uint16_t)s;
        if (nmask[e0 + e] && s >= 0 && s < N) atomicOr(&bits[e / K], 1u << (e % K));
      }
      __syncthreads();
    }
    for (int k = 1; k <= L + 1; ++k) {
      for (int i = warp; i < N; i += kConeWarps) {
        if (hs[i] != k - 1) continue;  // warp-uniform: one row a warp
        if constexpr (kCached) {
          if (lane < K && ((bits[i] >> lane) & 1u)) {
            const int s = src16[i * K + lane];
            if (hs[s] > k) atomicMin(&hs[s], k);
          }
        } else {
          for (int e = lane; e < K; e += 32) {
            const int s = (int)idx[e0 + (long long)i * K + e];
            if (nmask[e0 + (long long)i * K + e] && s >= 0 && s < N && hs[s] > k)
              atomicMin(&hs[s], k);
          }
        }
      }
      __syncthreads();
    }
    for (int i = t; i < N; i += kConeThreads) {
      hop[base + i] = hs[i];
      atomicAdd(&hb[hs[i]], 1);
    }
    __syncthreads();
    for (int k = t; k < bins; k += kConeThreads) hist[(long long)b * bins + k] = hb[k];
  } else {
    // [bins] the rows of each hop in earlier complexes, then over the batch;
    // [bins] this complex's next position in each bin; [warps][bins] a
    // chunk's rows of each hop by warp, then their first positions
    int* before = cone_smem_raw;
    int* total = before + kMaxBins;
    int* next = total + kMaxBins;
    int* wc = next + kMaxBins;
    for (int k = warp; k < bins; k += kConeWarps) {
      int pb = 0, pt = 0;
      for (int bb = lane; bb < B; bb += 32) {
        const int c = hist[(long long)bb * bins + k];
        pt += c;
        if (bb < b) pb += c;
      }
      pb = __reduce_add_sync(0xffffffffu, pb);
      pt = __reduce_add_sync(0xffffffffu, pt);
      if (lane == 0) {
        before[k] = pb;
        total[k] = pt;
      }
    }
    __syncthreads();
    if (t == 0) {
      int run = 0;
      for (int k = 0; k < bins; ++k) {
        next[k] = run + before[k];
        run += total[k];
        if (b == 0 && k <= L + 1) counts[k] = run;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < N; c0 += kConeThreads) {
      const int i = c0 + t;
      const int hv = i < N ? hop[base + i] : -1;
      for (int k = lane; k < bins; k += 32) wc[warp * kMaxBins + k] = 0;
      __syncwarp();
      const unsigned same = __match_any_sync(0xffffffffu, hv);
      const int rank = __popc(same & ((1u << lane) - 1u));
      if (hv >= 0 && rank == 0) wc[warp * kMaxBins + hv] = __popc(same);
      __syncthreads();
      if (t < bins) {  // the warps' counts of bin t in order, into first positions
        int run = next[t];
        for (int w = 0; w < kConeWarps; ++w) {
          const int c = wc[w * kMaxBins + t];
          wc[w * kMaxBins + t] = run;
          run += c;
        }
        next[t] = run;
      }
      __syncthreads();
      if (hv >= 0) order[wc[warp * kMaxBins + hv] + rank] = (int)(base + i);
      __syncthreads();  // wc is rewritten by the next chunk
    }
  }
}

}  // namespace

// hop [B*N], order [B*N], counts [L + 2] and scratch hist [B * (L + 3)], all
// int32 on the device, from idx [B][N][K] int64 and nmask [B][N][K]; ligand
// rows are the last n_ligand of each complex. Two launches on `stream`, no
// host synchronisation.
extern "C" int td_cone(const int64_t* idx, const bool* nmask, int B, int N, int K, int n_ligand,
                       int L, int* hop, int* order, int* counts, int* hist, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || n_ligand <= 0 || n_ligand > N || L <= 0 ||
      L + 3 > kMaxBins || (long long)B * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool cached = K <= 32 && N <= 65536 && cone_smem(N, K, true) <= (size_t)kMaxSmem;
  const size_t smem0 = cone_smem(N, K, cached);
  if (smem0 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto hops = cached ? cone_kernel<false, true> : cone_kernel<false, false>;
  if (smem0 > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(hops, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem0);
    if (e != cudaSuccess) return (int)e;
  }
  hops<<<B, kConeThreads, smem0, s>>>(idx, nmask, B, N, K, n_ligand, L, hop, order, counts, hist);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return (int)e;
  const size_t smem1 = (size_t)(3 + kConeWarps) * kMaxBins * sizeof(int);
  cone_kernel<true, false><<<B, kConeThreads, smem1, s>>>(idx, nmask, B, N, K, n_ligand, L, hop,
                                                          order, counts, hist);
  return (int)cudaGetLastError();
}
