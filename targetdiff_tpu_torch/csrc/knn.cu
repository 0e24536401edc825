// kNN graph kernels for Hopper (sm_90a).
//
// Replaces: targetdiff_tpu/ops/pallas/knn.py:_knn_kernel (knn_graph_pallas).
// For each complex and destination row i they form the squared distances to
// all N columns by the matmul identity |a|^2 + |b|^2 - 2 a.b, rounded
// operation by operation (__fmul_rn / __fadd_rn, no contraction) and clipped
// at 0, set invalid pairs and the self pair to 1e20, and select the K
// nearest in a stable order: nearest first, ties to the lower index
// (torch_cluster knn_graph, flow source_to_target). A row with fewer than K
// valid neighbours fills its masked slots with the lowest-index invalid
// columns, so every index lies in [0, N) (a CUDA gather needs that) and a
// padded row gets 0..K-1, masked. The selection equals a stable sort of the
// row (ops/graph.py knn_graph_exact).
//
// What bounds it: per complex N^2 distances (8 FLOP each) and a selection
// over them, reading 13 bytes per node from device memory: the selection's
// warp shuffles and ballots (most of the time, PERF.md) and, at a few
// complexes per call, one row's chain of them; never device memory.
//
// Design (K <= 32, knn_kernel): one warp per destination row, kRowsPerBlock
// rows per block. The block stages its complex once in shared memory as
// float4 (x, y, z, |p|^2, or -1 where masked) with coalesced loads; the
// blocks of a complex share it through L2. The warp keeps a sorted top-32
// list in registers, one (d2, j) entry per lane in ascending (d2, j) order,
// and walks the columns in batches of 32 (j = 32 t + lane), from the row's
// own batch t = i / 32 on and around: atoms near in index lie near in
// space, so the list starts short. Every comparison is on one 64-bit key,
// d2's bits then j, a total order, so the order of the batches does not
// change the result. A batch is filtered against the list's K-th key with
// a ballot. Few survivors are inserted one by one in lane order, each at
// popc(ballot(entry < candidate)) with the list shifted by __shfl_up_sync
// and the rest rechecked against the new K-th; kMergeAt or more are
// compacted to the first lanes, sorted there by a warp bitonic network 8,
// 16 or 32 lanes wide, and merged with the list (the smaller of entry l and
// survivor 31 - l, then a bitonic merge). Both keep the 32 smallest keys
// seen, so the result is exact. A row takes N / 32 batches and a few merges
// and insertions, against K rounds of N compares.
//
// K > 32 (knn_rounds_kernel): the row's distances in
// shared memory, K rounds of warp argmin with first-index ties and
// knock-out with +inf (knocked-out columns rank after the 1e20 masked
// ones).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // warps (rows) per block of knn_kernel
constexpr int kMergeAt = 4;       // survivors of a batch from which it is sorted and merged
constexpr int kRoundsRows = 8;    // warps (rows) per block of knn_rounds_kernel
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr float kBig = 1e20f;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float pair_d2(float xi, float yi, float zi, float sqi, float xj,
                                         float yj, float zj, float sqj) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(xi, xj), __fmul_rn(yi, yj)), __fmul_rn(zi, zj));
  return fmaxf(__fsub_rn(__fadd_rn(sqi, sqj), __fmul_rn(2.f, cross)), 0.f);
}

// (da, ja) ranks before (db, jb)
__device__ __forceinline__ bool before(float da, int ja, float db, int jb) {
  return da < db || (da == db && ja < jb);
}

// The (d2, j) order as one unsigned key: d2 >= 0 (or -0, taken as +0)
// orders as its bits, j breaks ties; kEmpty ranks after every column.
constexpr uint64_t kEmpty = ~0ull;
__device__ __forceinline__ uint64_t make_key(float d2, int j) {
  return (uint64_t)(__float_as_uint(d2) & 0x7fffffffu) << 32 | (uint32_t)j;
}

// One compare-exchange of a warp bitonic network with partner lane ^ s:
// the lane keeps the smaller key if it lies on the low side of an
// ascending pair (or the high side of a descending one).
__device__ __forceinline__ void bitonic_step(uint64_t& key, int s, bool ascending, int lane) {
  const uint64_t other = __shfl_xor_sync(0xffffffffu, key, s);
  if ((((lane & s) == 0) == ascending) == (other < key)) key = other;
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
knn_kernel(const float* __restrict__ pos, const bool* __restrict__ mask, int N, int K,
           int64_t* __restrict__ idx, bool* __restrict__ nmask) {
  extern __shared__ float4 s_pos[];  // [N]: x, y, z, |p|^2 (-1 where masked)
  const int b = blockIdx.y;
  const float* p = pos + (size_t)b * N * 3;
  const bool* m = mask + (size_t)b * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float x = p[3 * j], y = p[3 * j + 1], z = p[3 * j + 2];
    s_pos[j] = make_float4(x, y, z, m[j] ? sq_norm(x, y, z) : -1.f);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + warp;
  if (i >= N) return;  // whole warp, after the block's only barrier
  const float4 pi = s_pos[i];
  const bool mi = pi.w >= 0.f;
  const float sqi = sq_norm(pi.x, pi.y, pi.z);
  __shared__ uint64_t s_batch[kRowsPerBlock][32];  // a batch's survivors, compacted
  uint64_t* s_put = s_batch[warp];

  uint64_t key = kEmpty;  // the list: entry `lane`, ascending
  uint64_t kth = kEmpty;  // its K-th key
  // the row's own batch first (atoms near in index lie near in space, so
  // the list starts short), then the others in turn; the keys are a total
  // order, so the order of the batches leaves the result as it is
  const int nb = (N + 31) >> 5;
  for (int n = 0, t = i >> 5; n < nb; ++n, t = t + 1 == nb ? 0 : t + 1) {
    const int j = 32 * t + lane;
    uint64_t c = kEmpty;
    if (j < N) {
      const float4 pj = s_pos[j];
      c = make_key((mi && pj.w >= 0.f && j != i)
                       ? pair_d2(pi.x, pi.y, pi.z, sqi, pj.x, pj.y, pj.z, pj.w)
                       : kBig,
                   j);
    }
    unsigned todo = __ballot_sync(0xffffffffu, c < kth);
    const int m = __popc(todo);
    if (m >= kMergeAt) {
      // the survivors to lanes [0, m) in lane order (the others kEmpty),
      // sorted in the first 8, 16 or 32 lanes, and merged with the list
      if ((todo >> lane) & 1u) s_put[__popc(todo & ((1u << lane) - 1u))] = c;
      __syncwarp();
      uint64_t sk = lane < m ? s_put[lane] : kEmpty;
      __syncwarp();
      const int w = m <= 8 ? 8 : m <= 16 ? 16 : 32;
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1) {
        if (k > w) break;
#pragma unroll
        for (int s = k >> 1; s > 0; s >>= 1) bitonic_step(sk, s, (lane & k) == 0, lane);
      }
      const uint64_t rk = __shfl_sync(0xffffffffu, sk, 31 - lane);
      if (rk < key) key = rk;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) bitonic_step(key, s, true, lane);
      kth = __shfl_sync(0xffffffffu, key, K - 1);
    } else {
      while (todo) {  // insert the survivors in lane order
        const int src = __ffs(todo) - 1;
        const uint64_t ck = __shfl_sync(0xffffffffu, c, src);
        const int at = __popc(__ballot_sync(0xffffffffu, key < ck));
        const uint64_t up = __shfl_up_sync(0xffffffffu, key, 1);
        if (lane >= at) key = lane == at ? ck : up;
        kth = __shfl_sync(0xffffffffu, key, K - 1);
        todo &= __ballot_sync(0xffffffffu, c < kth) & ~(1u << src);
      }
    }
  }
  if (lane < K) {
    const size_t o = ((size_t)b * N + i) * K + lane;
    idx[o] = (uint32_t)key;
    nmask[o] = key < make_key(0.5f * kBig, 0);
  }
}

__global__ void __launch_bounds__(kRoundsRows * 32)
knn_rounds_kernel(const float* __restrict__ pos, const bool* __restrict__ mask, int N, int K,
                  int64_t* __restrict__ idx, bool* __restrict__ nmask) {
  extern __shared__ float rows[];  // [kRoundsRows][N]
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRoundsRows + warp;
  if (i >= N) return;  // whole warp; the block never synchronises
  float* row = rows + (size_t)warp * N;
  const float* p = pos + (size_t)b * N * 3;
  const bool* m = mask + (size_t)b * N;

  const float xi = p[3 * i], yi = p[3 * i + 1], zi = p[3 * i + 2];
  const float sqi = sq_norm(xi, yi, zi);
  const bool mi = m[i];
  for (int j = lane; j < N; j += 32) {
    const float xj = p[3 * j], yj = p[3 * j + 1], zj = p[3 * j + 2];
    const float d2 = pair_d2(xi, yi, zi, sqi, xj, yj, zj, sq_norm(xj, yj, zj));
    row[j] = (mi && m[j] && j != i) ? d2 : kBig;
  }
  __syncwarp();

  int64_t* out_idx = idx + ((size_t)b * N + i) * K;
  bool* out_mask = nmask + ((size_t)b * N + i) * K;
  for (int k = 0; k < K; ++k) {
    float best = INFINITY;
    int best_j = N;
    for (int j = lane; j < N; j += 32) {
      const float v = row[j];
      if (v < best) {  // ascending j: the first index wins within a lane
        best = v;
        best_j = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
      if (before(ov, oj, best, best_j)) {
        best = ov;
        best_j = oj;
      }
    }
    // K <= N and one column leaves per round, so a finite column remains
    // and best_j < N here
    if (lane == 0) {
      out_idx[k] = best_j;
      out_mask[k] = best < 0.5f * kBig;
    }
    if ((best_j & 31) == lane) row[best_j] = INFINITY;
    __syncwarp();
  }
}

template <typename Kernel>
int launch(Kernel kernel, int rows_per_block, size_t smem, const float* pos, const bool* mask,
           int B, int N, int K, int64_t* idx, bool* nmask, cudaStream_t stream) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + rows_per_block - 1) / rows_per_block, B);
  kernel<<<grid, rows_per_block * 32, smem, stream>>>(pos, mask, N, K, idx, nmask);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest N the kernel for K neighbours takes (its shared memory).
extern "C" int td_knn_max_nodes(int K) {
  return K <= 32 ? kMaxSmem / (int)sizeof(float4) : kMaxSmem / (kRoundsRows * (int)sizeof(float));
}

extern "C" int td_knn(const float* pos, const bool* mask, int B, int N, int K, int64_t* idx,
                      bool* nmask, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 32)
    return launch(knn_kernel, kRowsPerBlock, (size_t)N * sizeof(float4), pos, mask, B, N, K, idx,
                  nmask, s);
  return launch(knn_rounds_kernel, kRoundsRows, (size_t)kRoundsRows * N * sizeof(float), pos,
                mask, B, N, K, idx, nmask, s);
}
