// Per-layer attention kernels for Hopper (sm_90a): one x2h or one h2x
// sub-layer of the UniTransformerO2 (released widths: hidden 128, 16 heads,
// 20 RBF knots), float32 (the second layers and node projections as three-term
// fp16 tensor-core products, float32-accurate) or bf16 (the *_bf16 entry
// points: the sampling path's default precision, one bf16 tensor-core product
// each, the packed product weights bf16; see tc_common.cuh), for any K up to
// kMaxLayerK (256).
//
// Replaces: targetdiff_tpu/ops/pallas/edge_layer.py:_x2h_kernel
// (x2h_attention_layer) and :_h2x_kernel (h2x_attention_layer). They carry
// the paths the whole-block kernels do not take: the hybrid graph (ligand
// rows see every other ligand atom plus their k nearest protein atoms, so
// K = max_ligand - 1 + k, 95 at the sampling CLI's defaults) and the
// per-layer training path. They compute what the TPU kernels compute, not
// their TPU encodings: neighbours are gathered natively (no one-hot matmuls,
// no hi|lo split), the head sums are shuffles instead of [H, heads] matrices,
// and the edge weights come in as an input, as there.
//
// What bounds it: as the block kernels' edge passes, the 128x128 k (and, in
// x2h, v) second layer of every live edge (~66k FLOP per x2h edge, ~37k per
// h2x edge), on the tensor cores as three-term fp16 products; device memory
// moves only node rows, the [B, N, K] graph and the weights.
//
// Design: node_kernel (per-node projections, node_proj.cuh) then the edge
// kernel of the pass, both shared with the whole-block path. x2h:
// x2h_edge_kernel (x2h_edge.cuh), one walk over a row's live chunks of 32
// edges with an online softmax; in bf16 x2h_edge_mma_kernel
// (x2h_edge_bf16.cuh), 64-slot tiles on wgmma. h2x: the projections of the ligand rows and
// the source projections of the others, then h2x_edge_kernel (h2x_edge.cuh),
// (ligand row, live chunk) units merged per row in chunk order; in bf16
// h2x_edge_mma_kernel (h2x_edge_bf16.cuh), the x2h one's tiles on the ligand
// rows. Chunks
// without a valid edge are skipped, which is exact: under the hybrid graph a
// protein row's 32 valid slots come first, so two of its three chunks at
// K = 95 cost nothing.

#include "block_common.cuh"
#include "h2x_edge.cuh"
#include "node_proj.cuh"
#include "x2h_edge.cuh"

namespace {

template <bool kBf16>
int x2h_layer(const float* h, const float* x, const int64_t* idx, const bool* nmask,
              const bool* mlig, const float* ew, const float* offsets, float coeff,
              const PassParams& p, int B, int N, int K, float* ni, float* nj, float* q,
              float* h_out, cudaStream_t s) {
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  int err = launch_node<kBf16>(h, B, N, 0, p, ni, nj, q, nullptr, s);
  if (err == 0) err = launch_x2h<kBf16>(h, in, q, p, B, N, K, h_out, s);
  return err;
}

template <bool kBf16>
int h2x_layer(const float* h, const float* x, const int64_t* idx, const bool* nmask,
              const bool* mlig, const float* ew, const float* offsets, float coeff,
              const PassParams& p, int B, int N, int K, int n_ligand, float* ni, float* nj,
              float* q, float* x_out, cudaStream_t s) {
  if (n_ligand <= 0 || n_ligand > N) return (int)cudaErrorInvalidValue;
  const EdgeInputs in{x, idx, nmask, mlig, ew, ni, nj, offsets, coeff};
  const int row0 = N - n_ligand;
  int err = launch_node<kBf16>(h, B, N, row0, p, ni, nj, q, nullptr, s);
  if (err == 0) err = launch_h2x<kBf16>(in, q, p, B, N, K, row0, x_out, s);
  return err;
}

}  // namespace

// h_out = x2h(h) for every row. ni, nj [B*N][2H] and q [B*N][H] are scratch.
extern "C" int td_x2h_layer(const float* h, const float* x, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* offsets, float coeff, PassParams p, int B, int N,
                            int K, float* ni, float* nj, float* q, float* h_out, void* stream) {
  return x2h_layer<false>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, B, N, K, ni, nj, q,
                          h_out, (cudaStream_t)stream);
}

extern "C" int td_x2h_layer_bf16(const float* h, const float* x, const int64_t* idx,
                                 const bool* nmask, const bool* mlig, const float* ew,
                                 const float* offsets, float coeff, PassParams p, int B, int N,
                                 int K, float* ni, float* nj, float* q, float* h_out,
                                 void* stream) {
  return x2h_layer<true>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, B, N, K, ni, nj, q,
                         h_out, (cudaStream_t)stream);
}

// The ligand tail (the last n_ligand rows) of x_out = h2x(h, x); x_out must
// hold x on entry, and its protein rows are left as they are.
extern "C" int td_h2x_layer(const float* h, const float* x, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* offsets, float coeff, PassParams p, int B, int N,
                            int K, int n_ligand, float* ni, float* nj, float* q, float* x_out,
                            void* stream) {
  return h2x_layer<false>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, B, N, K, n_ligand, ni,
                          nj, q, x_out, (cudaStream_t)stream);
}

extern "C" int td_h2x_layer_bf16(const float* h, const float* x, const int64_t* idx,
                                 const bool* nmask, const bool* mlig, const float* ew,
                                 const float* offsets, float coeff, PassParams p, int B, int N,
                                 int K, int n_ligand, float* ni, float* nj, float* q,
                                 float* x_out, void* stream) {
  return h2x_layer<true>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, B, N, K, n_ligand, ni,
                         nj, q, x_out, (cudaStream_t)stream);
}
