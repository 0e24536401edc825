// Whole-block backward for Hopper (sm_90a): the exact VJP of all L layers of
// one UniTransformerO2 block (released widths: hidden 128, 16 heads, 20 RBF
// knots, K <= 32), float32 throughout, from the per-layer checkpoints that
// td_block_train_fwd (block_denoiser.cu) writes.
//
// Replaces: targetdiff_tpu/ops/pallas/block_vjp.py:_block_bwd_kernel
// (_block_bwd), every tile live. It computes what that kernel computes, not
// its TPU encodings: neighbours are gathered natively (no [N*K, N] one-hot
// operand), the parameter gradients that the TPU summed across its
// sequential grid are reduced in a second pass, and the softmax is
// max-shifted, so rows with no valid neighbour get zero attention and zero
// gradient (as the plain masked_neighbor_softmax).
//
// What bounds it: per layer and complex the x2h pass recomputes both
// 128x128 second layers per edge, multiplies their output gradients back
// through them, and forms the weight gradients A^T dY over all edges: about
// N*K*128k multiply-adds, ~1 TFLOP per step at B=32, N=416, K=32, L=9. The
// recompute's second layers, the transposed second layers, d rbf and the
// weight gradients run on the tensor cores, the rest on the float32 pipes;
// with one block per destination row the second layers read their weights
// from L2 in every 32-edge chunk, 128 KB for the recompute and 128 KB for the
// transposed product (bf16: 64 KB each; staged in shared memory instead, they
// leave fewer rows in flight per SM or go through the slower distributed
// shared memory: PERF.md). The RBF table is read once per chunk: 80 KB of
// staged fragments for d rbf, and each thread's column of the row's two type
// tables for the recompute's first layer.
//
// Design: per layer l = L-1 .. 0, first the h2x pass (ligand-tail rows,
// h = hck[l+1], x = xck[l]) then the x2h pass (all rows, h = hck[l]), each
// one run_pass of pass_bwd.cuh (node recompute, edge backward, the
// deterministic source gather, node backward, weight-gradient products);
// the inverse adjacencies of both passes are built once per backward, and
// the 2L passes' second layers are staged by one stage_w2_kernel launch
// before the first pass.
//
// bf16 (td_block_bwd_bf16): the VJP of td_block_train_fwd_bf16, the JAX
// package's bf16 training variant (_block_bwd_kernel at cd=bf16): every
// dense product of both directions on bf16 operands with float32
// accumulation (run_pass<kH2X, true>), the checkpoints, cotangents and
// every gradient float32.

#include <vector>

#include "pass_bwd.cuh"

// Workspace sizes (floats, ints) of a backward at these shapes that stages
// `passes` passes' second layers: 2L for td_block_bwd, 1 for a per-layer
// backward (edge_layer_vjp.cu).
extern "C" void td_block_bwd_workspace(int B, int N, int K, int n_ligand, int passes,
                                       long long* floats, long long* ints) {
  Workspace ws;
  carve(nullptr, nullptr, B, N, K, n_ligand, passes, &ws, floats, ints);
}

namespace {

template <bool kBf16>
int block_bwd(const float* hck, const float* xck, const int64_t* idx, const bool* nmask,
              const bool* mlig, const float* ew, const float* offsets, float coeff,
              const PassParams* x2h, const PassParams* h2x, const PassT* x2hT, const PassT* h2xT,
              const PassGrads* gx2h, const PassGrads* gh2x, int L, int B, int N, int K,
              int n_ligand, const float* gh, const float* gx, float* dh0, float* dx0, float* dew,
              float* work, long long work_floats, int* iwork, long long iwork_ints,
              void* stream) {
  if (L <= 0 || B <= 0 || N <= 0 || N > kAdjMaxN || K <= 0 || K > kMaxBlockK || n_ligand <= 0 ||
      n_ligand > N)
    return (int)cudaErrorInvalidValue;
  Workspace ws;
  long long nf, ni;
  carve(work, iwork, B, N, K, n_ligand, 2 * L, &ws, &nf, &ni);
  if (nf > work_floats || ni > iwork_ints) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t hsz = (size_t)B * N * H, xsz = (size_t)B * N * 3;
  const int row0 = N - n_ligand;
  int err = (int)cudaMemcpyAsync(dh0, gh, hsz * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (!err) err = (int)cudaMemcpyAsync(dx0, gx, xsz * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (!err) err = (int)cudaMemsetAsync(dew, 0, (size_t)B * N * K * sizeof(float), s);
  if (err) return err;
  // every pass's second layers, one launch: x2h[l] at region 2l, h2x[l] at 2l + 1
  std::vector<const float*> w2k(2 * L), w2v(2 * L);
  std::vector<int> V(2 * L);
  for (int l = 0; l < L; ++l) {
    for (int k = 0; k < 2; ++k) {
      const PassParams& p = k ? h2x[l] : x2h[l];
      w2k[2 * l + k] = p.w2k;
      w2v[2 * l + k] = p.w2v;
      V[2 * l + k] = k ? NH : H;
    }
  }
  if ((err = stage_w2<kBf16>(2 * L, w2k.data(), w2v.data(), V.data(), ws.w2f, s))) return err;
  if ((err = build_adjacency(idx, nmask, B, N, K, 0, ws.off_x, ws.list_x, s))) return err;
  if ((err = build_adjacency(idx, nmask, B, N, K, row0, ws.off_h, ws.list_h, s))) return err;
  for (int l = L - 1; l >= 0; --l) {
    const EdgeInputs in{xck + l * xsz, idx, nmask, mlig, ew, nullptr, nullptr, offsets, coeff};
    err = run_pass<true, kBf16>(hck + (l + 1) * hsz, in, h2x[l], h2xT[l], gh2x[l], B, N, K,
                                row0, ws.off_h, ws.list_h, dh0, dx0, dew,
                                ws.w2f + (size_t)(2 * l + 1) * kW2Staged, ws, s);
    if (err) return err;
    err = run_pass<false, kBf16>(hck + l * hsz, in, x2h[l], x2hT[l], gx2h[l], B, N, K, 0,
                                 ws.off_x, ws.list_x, dh0, dx0, dew,
                                 ws.w2f + (size_t)(2 * l) * kW2Staged, ws, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// VJP of td_block_train_fwd. hck [L+1][B][N][H], xck [L+1][B][N][3] are its
// checkpoints; gh [B][N][H], gx [B][N][3] the cotangents of its outputs.
// Writes dh0, dx0, dew [B][N][K] and, per layer, the gradients of both
// passes' packed weights (gx2h / gh2x: L PassGrads each, host memory, as
// x2h / h2x / x2hT / h2xT: L entries each).
extern "C" int td_block_bwd(const float* hck, const float* xck, const int64_t* idx,
                            const bool* nmask, const bool* mlig, const float* ew,
                            const float* offsets, float coeff, const PassParams* x2h,
                            const PassParams* h2x, const PassT* x2hT, const PassT* h2xT,
                            const PassGrads* gx2h, const PassGrads* gh2x, int L, int B, int N,
                            int K, int n_ligand, const float* gh, const float* gx, float* dh0,
                            float* dx0, float* dew, float* work, long long work_floats,
                            int* iwork, long long iwork_ints, void* stream) {
  return block_bwd<false>(hck, xck, idx, nmask, mlig, ew, offsets, coeff, x2h, h2x, x2hT, h2xT,
                          gx2h, gh2x, L, B, N, K, n_ligand, gh, gx, dh0, dx0, dew, work,
                          work_floats, iwork, iwork_ints, stream);
}

// VJP of td_block_train_fwd_bf16: td_block_bwd's arguments, x2h / h2x with
// bf16 product weights (the pack of the forward), x2hT / h2xT float32.
extern "C" int td_block_bwd_bf16(const float* hck, const float* xck, const int64_t* idx,
                                 const bool* nmask, const bool* mlig, const float* ew,
                                 const float* offsets, float coeff, const PassParams* x2h,
                                 const PassParams* h2x, const PassT* x2hT, const PassT* h2xT,
                                 const PassGrads* gx2h, const PassGrads* gh2x, int L, int B,
                                 int N, int K, int n_ligand, const float* gh, const float* gx,
                                 float* dh0, float* dx0, float* dew, float* work,
                                 long long work_floats, int* iwork, long long iwork_ints,
                                 void* stream) {
  return block_bwd<true>(hck, xck, idx, nmask, mlig, ew, offsets, coeff, x2h, h2x, x2hT, h2xT,
                         gx2h, gh2x, L, B, N, K, n_ligand, gh, gx, dh0, dx0, dew, work,
                         work_floats, iwork, iwork_ints, stream);
}

// build_adjacency alone: the inverse adjacency of the destination rows
// [row0, N) of idx / nmask [B][N][K]: off [B][N+1] and list, which holds B
// (N - row0) K ints of lists and then td_adjacency_scratch_ints of scratch.
extern "C" long long td_adjacency_scratch_ints(int B, int N, int K, int row0) {
  return adj_scratch_ints(B, N, (long long)(N - row0) * K);
}

extern "C" int td_adjacency(const int64_t* idx, const bool* nmask, int B, int N, int K, int row0,
                            int* off, int* list, void* stream) {
  if (B <= 0 || N <= 0 || N > kAdjMaxN || K <= 0 || row0 < 0 || row0 >= N)
    return (int)cudaErrorInvalidValue;
  return build_adjacency(idx, nmask, B, N, K, row0, off, list, (cudaStream_t)stream);
}

// build_adjacency calls that launched so far in this process, by every entry.
extern "C" long long td_adj_builds() { return adj_build_count; }

// run_pass's staging of the d rbf product's B fragments alone: frags (16-byte
// aligned) receives kRbfFrags uint4 from w_rbf [4][R][2H] (stage_rbf_kernel).
extern "C" int td_stage_rbf(const float* w_rbf, void* frags, void* stream) {
  if ((uintptr_t)frags & 15) return (int)cudaErrorInvalidValue;
  stage_rbf_kernel<<<(kRbfFrags + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      w_rbf, reinterpret_cast<uint4*>(frags));
  return (int)cudaGetLastError();
}

// The transposed second layers of one pass alone (tprod_kernel), as
// edge_bwd_kernel runs them: da [E][2H] from d [E][H + V] (V = NH if h2x,
// else H), after stage_w2_kernel has staged w2k [H][H] and w2v [H][V] (bf16
// tensors for the _bf16 entry) into frags (td_tprod_frag_bytes, 16-byte
// aligned).
template <bool kBf16>
int tprod(const float* d, long long E, int h2x, const void* w2k, const void* w2v, float* da,
          void* frags, void* stream) {
  if (E <= 0 || ((uintptr_t)frags & 15)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *k = static_cast<const float*>(w2k), *v = static_cast<const float*>(w2v);
  uint4* f = static_cast<uint4*>(frags);
  const int V = h2x ? NH : H;
  int err = stage_w2<kBf16>(1, &k, &v, &V, f, s);
  if (err) return err;
  const unsigned grid = (unsigned)((E + KC - 1) / KC);
  auto launch = [&](auto kernel) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kTprodSmem);
    if (!e) {
      kernel<<<grid, kThreads, kTprodSmem, s>>>(d, E, f, da);
      e = (int)cudaGetLastError();
    }
    return e;
  };
  return h2x ? launch(tprod_kernel<NH, kBf16>) : launch(tprod_kernel<H, kBf16>);
}

extern "C" long long td_tprod_frag_bytes() { return kW2Staged * (long long)sizeof(uint4); }

// stage_w2_kernel alone: the second layers of `passes` passes, w2k[i] [H][H]
// and w2v[i] [H][V[i]] (V[i] = H or NH; bf16 tensors if bf16, 16-byte
// aligned; host arrays of device pointers), staged as run_pass reads them
// into frags + i td_tprod_frag_bytes() bytes (16-byte aligned), as
// td_block_bwd stages its 2L passes. Counted in td_stage_w2_launches.
extern "C" int td_stage_w2(const void* const* w2k, const void* const* w2v, const int* V,
                           int passes, int bf16, void* frags, void* stream) {
  if (passes <= 0 || ((uintptr_t)frags & 15)) return (int)cudaErrorInvalidValue;
  const float* const* k = reinterpret_cast<const float* const*>(w2k);
  const float* const* v = reinterpret_cast<const float* const*>(w2v);
  uint4* f = static_cast<uint4*>(frags);
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? stage_w2<true>(passes, k, v, V, f, s) : stage_w2<false>(passes, k, v, V, f, s);
}

// stage_w2_kernel launches made so far in this process by every entry, of the
// bf16 instantiation if bf16, else of the float32 one.
extern "C" long long td_stage_w2_launches(int bf16) { return stage_w2_launch_count[bf16 != 0]; }

extern "C" int td_tprod(const float* d, long long E, int h2x, const void* w2k, const void* w2v,
                        float* da, void* frags, void* stream) {
  return tprod<false>(d, E, h2x, w2k, w2v, da, frags, stream);
}

extern "C" int td_tprod_bf16(const float* d, long long E, int h2x, const void* w2k,
                             const void* w2v, float* da, void* frags, void* stream) {
  return tprod<true>(d, E, h2x, w2k, w2v, da, frags, stream);
}

// edge_bwd_kernel as run_pass launches it for one pass of K neighbours per row:
// info[4] = {shared memory bytes per block (dynamic and static), blocks per
// SM, registers per thread, local (spill) bytes per thread}.
template <bool kH2X, bool kBf16>
int edge_bwd_info(int K, int* info) {
  cudaFuncAttributes fa;
  int err = (int)cudaFuncSetAttribute(edge_bwd_kernel<kH2X, kBf16>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      bwd_smem(kMaxLayerK, kH2X));
  if (!err) err = (int)cudaFuncGetAttributes(&fa, edge_bwd_kernel<kH2X, kBf16>);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[1], edge_bwd_kernel<kH2X, kBf16>, kThreads, bwd_smem(K, kH2X));
  if (err) return err;
  info[0] = bwd_smem(K, kH2X) + (int)fa.sharedSizeBytes;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  return 0;
}

extern "C" int td_edge_bwd_info(int h2x, int K, int* info) {
  if (K <= 0 || K > kMaxLayerK) return (int)cudaErrorInvalidValue;
  return h2x ? edge_bwd_info<true, false>(K, info) : edge_bwd_info<false, false>(K, info);
}

// The same of the bf16 instantiation (td_block_bwd_bf16, the per-layer
// *_bf16 backwards).
extern "C" int td_edge_bwd_info_bf16(int h2x, int K, int* info) {
  if (K <= 0 || K > kMaxLayerK) return (int)cudaErrorInvalidValue;
  return h2x ? edge_bwd_info<true, true>(K, info) : edge_bwd_info<false, true>(K, info);
}

// The weight-gradient product of run_pass alone (weight_grad.cuh): out [P][Q]
// = X^T Y over M rows of X [M][ldx] (first P columns) and Y [M][ldy] (first
// Q columns); partial holds td_weight_grad_partial_floats() floats. Refuses
// (cudaErrorInvalidValue) bases (out and partial too), leading dimensions,
// P or Q that are not multiples of 16 bytes.
extern "C" long long td_weight_grad_partial_floats() { return kPartialCap; }

extern "C" int td_weight_grad(const float* X, int ldx, const float* Y, int ldy, long long M,
                              int P, int Q, float* out, float* partial, void* stream) {
  return weight_grad(X, ldx, Y, ldy, M, P, Q, out, partial, (cudaStream_t)stream);
}

// The split of the product out [P][Q] = X^T Y over M rows that weight_grad
// takes on this card (weight_grad.cuh wg_plan; bf16: weight_grad<true>):
// info[6] = {partials reduce_kernel sums (S / C), row chunks S, rows a
// chunk, the cluster size C, clusters of weight_grad_kernel the card holds
// at once, kRedGroups}. Refuses the shapes td_weight_grad refuses.
template <bool kBf16>
int weight_grad_partials(long long M, int P, int Q, long long* info) {
  WgPlan plan;
  if (int err = wg_plan_for<kBf16>(M, P, Q, plan)) return err;
  int wave = 0;
  if (int err = wg_cluster_wave<kBf16>(wave)) return err;
  constexpr int C = kWgClusterOf<kBf16>;
  const long long v[6] = {plan.S / C, plan.S, plan.chunk, C, wave, kRedGroups};
  for (int i = 0; i < 6; ++i) info[i] = v[i];
  return 0;
}

extern "C" int td_weight_grad_partials(long long M, int P, int Q, int bf16, long long* info) {
  return bf16 ? weight_grad_partials<true>(M, P, Q, info)
              : weight_grad_partials<false>(M, P, Q, info);
}

// The partials of Q floats that run_pass's column sums of M rows leave to
// reduce_kernel (pass_bwd.cuh colsum).
extern "C" long long td_colsum_partials(long long M, int Q) {
  return chunks_for(M, (Q + kThreads - 1) / kThreads, Q);
}

// reduce_kernel alone: out [n] = the sum of partial [S][n] in its fixed order
// (weight_grad.cuh reduce_partials; no kernel before it to wait for). n a
// multiple of 4, partial and out 16-byte aligned.
extern "C" int td_reduce_partials(const float* partial, int S, long long n, float* out,
                                  void* stream) {
  if (S <= 0 || n <= 0 || ((uintptr_t)partial | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  return reduce_partials(partial, S, n, out, (cudaStream_t)stream);
}

// The same with bf16 products (weight_grad<true>, as run_pass<kH2X, true>).
extern "C" int td_weight_grad_bf16(const float* X, int ldx, const float* Y, int ldy,
                                   long long M, int P, int Q, float* out, float* partial,
                                   void* stream) {
  return weight_grad<true>(X, ldx, Y, ldy, M, P, Q, out, partial, (cudaStream_t)stream);
}

// node_bwd_kernel as run_pass launches it, alone (node_bwd.cuh): over `rows`
// rows of the row buffer rowbuf [rows][W] (dq at column off_dq, dproj in
// columns [0, 4H)), writes dq1 into its columns [4H, 5H) and the query
// LayerNorm partials at off_qln, qa [rows][H], and adds dproj w_node^T to dh
// [rows][H]. w_q2T [H][H] and w_nodeT [5H][H] are the transposed weights.
// Refuses (cudaErrorInvalidValue) rows, W or offsets it does not take, and
// bases that are not 16-byte aligned.
extern "C" int td_node_bwd(const float* q1, const float* q_ln, const float* w_q2T,
                           const float* w_nodeT, long long rows, int W, int off_dq, int off_qln,
                           float* rowbuf, float* qa, float* dh, void* stream) {
  return launch_node_bwd(q1, q_ln, w_q2T, w_nodeT, rows, W, off_dq, off_qln, rowbuf, qa, dh,
                         (cudaStream_t)stream);
}

// td_node_bwd with bf16 products (launch_node_bwd<true>, as run_pass<kH2X,
// true>); the same float32 arguments.
extern "C" int td_node_bwd_bf16(const float* q1, const float* q_ln, const float* w_q2T,
                                const float* w_nodeT, long long rows, int W, int off_dq,
                                int off_qln, float* rowbuf, float* qa, float* dh, void* stream) {
  return launch_node_bwd<true>(q1, q_ln, w_q2T, w_nodeT, rows, W, off_dq, off_qln, rowbuf, qa,
                               dh, (cudaStream_t)stream);
}

// node_bwd_kernel launches made so far in this process, by every entry.
extern "C" long long td_node_bwd_launches() { return node_bwd_launch_count; }

// The same of its bf16 instantiation.
extern "C" long long td_node_bwd_bf16_launches() { return node_bwd_bf16_launch_count; }

// node_bwd_kernel for `rows` rows: info[5] = {rows per tile, shared memory
// bytes per block, blocks per SM, registers per thread, local (spill) bytes
// per thread}.
extern "C" int td_node_bwd_info(long long rows, int* info) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (int err = node_bwd_tile(rows, info[0])) return err;
  return info[0] == 64 ? node_bwd_info<64>(info + 1) : node_bwd_info<32>(info + 1);
}

// The same of the bf16 instantiation.
extern "C" int td_node_bwd_info_bf16(long long rows, int* info) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (int err = node_bwd_tile(rows, info[0])) return err;
  return info[0] == 64 ? node_bwd_info<64, true>(info + 1) : node_bwd_info<32, true>(info + 1);
}
