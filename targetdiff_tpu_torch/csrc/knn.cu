// kNN graph kernel for Hopper (sm_90a).
//
// Replaces: targetdiff_tpu/ops/pallas/knn.py:_knn_kernel (knn_graph_pallas).
// For each complex and destination row i it forms the squared distances to
// all N columns by the matmul identity |a|^2 + |b|^2 - 2 a.b, clipped at 0,
// sets invalid pairs and the self pair to 1e20, and selects the K nearest by
// K rounds of row argmin with first-index tie breaking and knock-out
// (torch_cluster knn_graph, flow source_to_target).
//
// What bounds it: per complex N^2 distances plus K*N^2 compares (N = 608,
// K = 32: 12 M compares), reading only 12 bytes per node from device memory.
// So it is bound by the shared-memory scans of the K argmin rounds and, at a
// few complexes per call, by launch latency, never by device memory.
//
// Design: one warp per destination row, eight rows per block. The row's
// distances live in shared memory (the [B, N, N] matrix never reaches
// device memory); each round every lane scans a strided slice, the warp
// reduces (value, index) pairs with shuffles, and the owning lane knocks
// the winner out with +inf. Knocked-out columns rank after the 1e20 masked
// ones, so a row with fewer than K valid neighbours fills its masked slots
// with the lowest unused indices: every index lies in [0, N), which a CUDA
// gather needs, and the selection equals a stable sort of the row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr float kBig = 1e20f;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
knn_kernel(const float* __restrict__ pos, const bool* __restrict__ mask, int N, int K,
           int64_t* __restrict__ idx, bool* __restrict__ nmask) {
  extern __shared__ float rows[];  // [kRowsPerBlock][N]
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + warp;
  if (i >= N) return;  // whole warp; the block never synchronises
  float* row = rows + (size_t)warp * N;
  const float* p = pos + (size_t)b * N * 3;
  const bool* m = mask + (size_t)b * N;

  const float xi = p[3 * i], yi = p[3 * i + 1], zi = p[3 * i + 2];
  const float sqi = __fadd_rn(__fadd_rn(__fmul_rn(xi, xi), __fmul_rn(yi, yi)), __fmul_rn(zi, zi));
  const bool mi = m[i];
  for (int j = lane; j < N; j += 32) {
    const float xj = p[3 * j], yj = p[3 * j + 1], zj = p[3 * j + 2];
    const float sqj = __fadd_rn(__fadd_rn(__fmul_rn(xj, xj), __fmul_rn(yj, yj)), __fmul_rn(zj, zj));
    const float cross = __fadd_rn(__fadd_rn(__fmul_rn(xi, xj), __fmul_rn(yi, yj)), __fmul_rn(zi, zj));
    const float d2 = fmaxf(__fsub_rn(__fadd_rn(sqi, sqj), __fmul_rn(2.f, cross)), 0.f);
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
      if (ov < best || (ov == best && oj < best_j)) {
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

}  // namespace

extern "C" int td_knn(const float* pos, const bool* mask, int B, int N, int K, int64_t* idx,
                      bool* nmask, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > N) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRowsPerBlock * N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, B);
  knn_kernel<<<grid, kRowsPerBlock * 32, smem, (cudaStream_t)stream>>>(pos, mask, N, K, idx,
                                                                        nmask);
  return (int)cudaGetLastError();
}
