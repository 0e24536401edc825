// Per-layer attention backwards for Hopper (sm_90a): the exact VJP of one
// x2h or one h2x sub-layer (edge_layer.cu), float32, for any K up to
// kMaxLayerK (256), to h, x, the edge weights and the pass's packed weights.
//
// Replaces: targetdiff_tpu/ops/pallas/edge_layer_vjp.py:_x2h_bwd_kernel
// (_x2h_bwd) and :_h2x_bwd_kernel (_h2x_bwd). They compute what those
// kernels compute, not their TPU encodings: neighbours are gathered natively
// instead of through one-hot matmuls, and the scatter of each edge's
// gradient to its source node, which the TPU kernels did with a transposed
// one-hot product, is the deterministic inverse-adjacency gather of
// pass_bwd.cuh (no atomics, so two runs give the same bits).
//
// What bounds it: per live edge the x2h backward recomputes both 128x128
// second layers, multiplies their output gradients back through them and
// forms the weight gradients A^T dY (~230k FLOP per edge; the recompute
// and the weight gradients on the tensor cores, the rest on the float32
// pipes); the h2x one about two thirds of that. Device memory carries the
// per-edge rows between the edge kernel and the weight-gradient products.
//
// Design: one run_pass of pass_bwd.cuh, shared with the whole-block
// backward, after the staging of the pass's second layers (one
// stage_w2_kernel launch) and its inverse adjacency. x2h: dh starts as the
// output cotangent g (the residual), dx and d e_w at zero. h2x: only the
// ligand tail rows have edges; dx starts as g (protein rows keep exactly
// g), dh and d e_w at zero (d e_w stays zero on protein rows).

#include "pass_bwd.cuh"

namespace {

bool layer_shapes_ok(int B, int N, int K) {
  return B > 0 && N > 0 && N <= kAdjMaxN && K > 0 && K <= kMaxLayerK;
}

template <bool kBf16>
int x2h_layer_bwd(const float* h, const float* x, const int64_t* idx, const bool* nmask,
                  const bool* mlig, const float* ew, const float* offsets, float coeff,
                  const PassParams& p, const PassT& pt, const PassGrads& g, int B, int N, int K,
                  const float* gh, float* dh, float* dx, float* dew, float* work,
                  long long work_floats, int* iwork, long long iwork_ints, void* stream) {
  if (!layer_shapes_ok(B, N, K)) return (int)cudaErrorInvalidValue;
  Workspace ws;
  long long nf, ni;
  carve(work, iwork, B, N, K, 1, 1, &ws, &nf, &ni);
  if (nf > work_floats || ni > iwork_ints) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t hsz = (size_t)B * N * H;
  int err = (int)cudaMemcpyAsync(dh, gh, hsz * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (!err) err = (int)cudaMemsetAsync(dx, 0, (size_t)B * N * 3 * sizeof(float), s);
  if (!err) err = (int)cudaMemsetAsync(dew, 0, (size_t)B * N * K * sizeof(float), s);
  if (!err) err = stage_w2<kBf16>(1, &p.w2k, &p.w2v, &H, ws.w2f, s);
  if (!err) err = build_adjacency(idx, nmask, B, N, K, 0, ws.off_x, ws.list_x, s);
  if (err) return err;
  const EdgeInputs in{x, idx, nmask, mlig, ew, nullptr, nullptr, offsets, coeff};
  return run_pass<false, kBf16>(h, in, p, pt, g, B, N, K, 0, ws.off_x, ws.list_x, dh, dx, dew,
                                ws.w2f, ws, s);
}

template <bool kBf16>
int h2x_layer_bwd(const float* h, const float* x, const int64_t* idx, const bool* nmask,
                  const bool* mlig, const float* ew, const float* offsets, float coeff,
                  const PassParams& p, const PassT& pt, const PassGrads& g, int B, int N, int K,
                  int n_ligand, const float* gx, float* dh, float* dx, float* dew, float* work,
                  long long work_floats, int* iwork, long long iwork_ints, void* stream) {
  if (!layer_shapes_ok(B, N, K) || n_ligand <= 0 || n_ligand > N)
    return (int)cudaErrorInvalidValue;
  Workspace ws;
  long long nf, ni;
  carve(work, iwork, B, N, K, n_ligand, 1, &ws, &nf, &ni);
  if (nf > work_floats || ni > iwork_ints) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t xsz = (size_t)B * N * 3;
  const int row0 = N - n_ligand;
  int err = (int)cudaMemsetAsync(dh, 0, (size_t)B * N * H * sizeof(float), s);
  if (!err) err = (int)cudaMemcpyAsync(dx, gx, xsz * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (!err) err = (int)cudaMemsetAsync(dew, 0, (size_t)B * N * K * sizeof(float), s);
  if (!err) err = stage_w2<kBf16>(1, &p.w2k, &p.w2v, &NH, ws.w2f, s);
  if (!err) err = build_adjacency(idx, nmask, B, N, K, row0, ws.off_h, ws.list_h, s);
  if (err) return err;
  const EdgeInputs in{x, idx, nmask, mlig, ew, nullptr, nullptr, offsets, coeff};
  return run_pass<true, kBf16>(h, in, p, pt, g, B, N, K, row0, ws.off_h, ws.list_h, dh, dx, dew,
                               ws.w2f, ws, s);
}

}  // namespace

// The entry points come in pairs: float32, and *_bf16, the VJP of the bf16
// forward (td_x2h_layer_bf16, td_h2x_layer_bf16): p's product weights bf16
// (the forward's pack), pt float32, bf16 products with float32 accumulation
// (pass_bwd.cuh run_pass<kH2X, true>), every output float32.

// VJP of td_x2h_layer: gh [B][N][H] the cotangent of h_out; writes dh, dx
// [B][N][3], dew [B][N][K] and the pass's weight gradients g. work / iwork
// hold td_block_bwd_workspace(B, N, K, 1, 1) floats / ints.
extern "C" int td_x2h_layer_bwd(const float* h, const float* x, const int64_t* idx,
                                const bool* nmask, const bool* mlig, const float* ew,
                                const float* offsets, float coeff, PassParams p, PassT pt,
                                PassGrads g, int B, int N, int K, const float* gh, float* dh,
                                float* dx, float* dew, float* work, long long work_floats,
                                int* iwork, long long iwork_ints, void* stream) {
  return x2h_layer_bwd<false>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, pt, g, B, N, K, gh,
                              dh, dx, dew, work, work_floats, iwork, iwork_ints, stream);
}

extern "C" int td_x2h_layer_bwd_bf16(const float* h, const float* x, const int64_t* idx,
                                     const bool* nmask, const bool* mlig, const float* ew,
                                     const float* offsets, float coeff, PassParams p, PassT pt,
                                     PassGrads g, int B, int N, int K, const float* gh, float* dh,
                                     float* dx, float* dew, float* work, long long work_floats,
                                     int* iwork, long long iwork_ints, void* stream) {
  return x2h_layer_bwd<true>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, pt, g, B, N, K, gh,
                             dh, dx, dew, work, work_floats, iwork, iwork_ints, stream);
}

// VJP of td_h2x_layer on the last n_ligand rows: gx [B][N][3] the cotangent
// of x_out; writes dh, dx, dew and g. work / iwork hold
// td_block_bwd_workspace(B, N, K, n_ligand, 1) floats / ints.
extern "C" int td_h2x_layer_bwd(const float* h, const float* x, const int64_t* idx,
                                const bool* nmask, const bool* mlig, const float* ew,
                                const float* offsets, float coeff, PassParams p, PassT pt,
                                PassGrads g, int B, int N, int K, int n_ligand, const float* gx,
                                float* dh, float* dx, float* dew, float* work,
                                long long work_floats, int* iwork, long long iwork_ints,
                                void* stream) {
  return h2x_layer_bwd<false>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, pt, g, B, N, K,
                              n_ligand, gx, dh, dx, dew, work, work_floats, iwork, iwork_ints,
                              stream);
}

extern "C" int td_h2x_layer_bwd_bf16(const float* h, const float* x, const int64_t* idx,
                                     const bool* nmask, const bool* mlig, const float* ew,
                                     const float* offsets, float coeff, PassParams p, PassT pt,
                                     PassGrads g, int B, int N, int K, int n_ligand,
                                     const float* gx, float* dh, float* dx, float* dew,
                                     float* work, long long work_floats, int* iwork,
                                     long long iwork_ints, void* stream) {
  return h2x_layer_bwd<true>(h, x, idx, nmask, mlig, ew, offsets, coeff, p, pt, g, B, N, K,
                             n_ligand, gx, dh, dx, dew, work, work_floats, iwork, iwork_ints,
                             stream);
}
