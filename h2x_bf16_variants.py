#!/usr/bin/env python3
"""Stage split and alternatives of the bf16 h2x edge pass on one NVIDIA GPU:
copies of the kernel with one stage taken out or one design changed, each
timed against the unchanged kernel in one run.

    python3 h2x_bf16_variants.py [--base CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package of
CHECKOUT (this checkout by default) whose CUDA sources are changed by a
string patch (VARIANTS), built and measured as variant_harness.py sets out,
the unchanged kernel first and last. A stage is taken out by skipping its
instruction or loop, so that its cost goes and nothing else changes much;
the results of those copies are wrong and only their times are read. The
variants patch csrc/h2x_edge_bf16.cuh (h2x_edge_mma_kernel) and the pieces it
shares with the bf16 x2h pass in csrc/edge_mma.cuh; with --base a checkout
before that kernel, only "kernel" applies (the earlier bf16 kernel,
h2x_edge_kernel<true> of csrc/h2x_edge.cuh). Each prints one JSON line: the
device ms per launch of the bf16 h2x edge launch alone
(`chip_smoke.pass_launcher`, td_block_h2x_bf16, layer 0 of a flagship model
with seeded random weights) at kNN B=4 and B=100 (N = 608, K = 32: the
example pocket with chip_smoke.LIGAND_SIZES ligands) and of the bf16
per-layer h2x at the hybrid shape (N = 640, K = 95), its CUDA-event ms at
B=100 and, for the unchanged kernel and the other deal, the largest error
over scale against the bf16 plain layer on the ligand rows, whether two
launches agree bitwise and whether ligand-tail rows without a valid edge
keep x bitwise; `-Xptxas -v` of the kernel. The card's name and power limit
come first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

NEW, COMMON = "h2x_edge_bf16.cuh", "edge_mma.cuh"

FIRST_K = "    first_layer_mma(acc, da, s.t1[0]);\n"
FIRST_V = "    first_layer_mma(acc, da, s.t1[1]);\n"
NJ = "      const float2 b = src[r] < 0 ? make_float2(0.f, 0.f)\n"
LN_K = "    ln_relu_frags(fr, acc, s.ln, 0, tig);\n"
LN_V = "    ln_relu_frags(fr, acc, s.ln, 1, tig);\n"
NO_LN = ("#pragma unroll\n    for (int i = 0; i < H / 4; ++i) fr[i >> 2][i & 3] = "
         "__float_as_uint(acc[i]);\n")
K_MMA = "      for (int ks = 0; ks < H / 16; ++ks) wgmma_rs(acc, fr[ks], desc_ks(db, ks), ks);\n"
V_MMA = "      for (int ks = 0; ks < H / 16; ++ks) wgmma_rs16(v, fr[ks], desc_ks(db, ks), ks);\n"
MERGE = "    if (w != 0) continue;\n"
END = "    if (rows[0] < 0) break;\n"
RBF = ("    rb[r] = g.et < 0 ? 0 : __bfloat16_as_ushort(__float2bfloat16_rn(expf(in.coeff * d * "
       "d)));\n")
REGS = "constexpr int kH2xProducerRegs = 128, kH2xConsumerRegs = 184;"

# q of the chunk's row loaded after the k product's wait, not during it
Q_LOAD = """      float2 qv[NH];  // q of the chunk's row, the thread's columns 8 nt + 2 tig (+1)
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
        qv[nt] = crow < 0 ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(&T.q[pos][8 * nt + 2 * tig]);
      wgmma_wait0();
      fence_acc(acc);
"""
Q_LATE = """      wgmma_wait0();
      fence_acc(acc);
      float2 qv[NH];  // q of the chunk's row, the thread's columns 8 nt + 2 tig (+1)
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
        qv[nt] = crow < 0 ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(&T.q[pos][8 * nt + 2 * tig]);
"""


def _rel_smem(s: str) -> str:
    """rel read from the stage in the weighted sums (no registers across
    the tile); the stage is handed back after them."""
    s = patch(s, """    float rel[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) rel[r][cc] = T.rel[m0 + 8 * r][cc];
""", "")
    s = patch(s, "    mbar_arrive(&s.empty[c][st]);  // the tile's A operand and slots are read\n", "")
    return patch(s, "      value_partials(v, s.b2v, s.pw[c][w], rel, s.xv[c][buf][w], lane);\n",
                 """      float rel[2][3];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) rel[r][cc] = T.rel[m0 + 8 * r][cc];
      mbar_arrive(&s.empty[c][st]);
      value_partials(v, s.b2v, s.pw[c][w], rel, s.xv[c][buf][w], lane);
""")


# deal (b): one row stream per block (grid: one block per row up to the
# SMs), one four-stage ring fed by the four producer warps (warp q owns stage
# q); consumer 0 takes every tile's k half, consumer 1 its v half at the same
# time. The v consumer waits on named barrier 4 + buf for the k half's pw and
# partials; the k consumer waits on 6 + buf before it rewrites buffer buf
# (the v consumer's merge of tile j - 2 is done).
PAIRED = r"""
__device__ __forceinline__ void h2x_producer_paired(H2xMmaSmem& s, const EdgeInputs& in,
                                                    const float* __restrict__ qn, int B, int N,
                                                    int K, int row0, float* __restrict__ out,
                                                    int pw, int lane) {
  const int nd = N - row0;
  const auto node = [=](long long u) { return u / nd * N + row0 + u % nd; };
  const auto dead = [&](long long bn) {
    if (pw == 0 && lane < 3) out[3 * bn + lane] = in.x[3 * bn + lane];
  };
  ChunkWalk<decltype(node)> walk{in.nmask, node, (long long)B * nd, (long long)gridDim.x,
                                 (long long)blockIdx.x, K, lane};
  walk.start(dead);
  H2xTile* ring = &s.tile[0][0];
  unsigned long long *full = &s.full[0][0], *empty = &s.empty[0][0];
  for (int j = 0;; ++j) {
    const LiveChunk a = walk.next(dead), b = walk.next(dead);
    if (j % 4 != pw) {
      if (a.row < 0) break;
      continue;
    }
    fill_tile(ring[pw], in, qn, N, K, a, b, &empty[pw], ((j / 4) & 1) ^ 1, &full[pw], lane);
    if (a.row < 0) break;
  }
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void h2x_consumer_paired(H2xMmaSmem& s, const EdgeInputs& in,
                                                    float* __restrict__ out, int c, int wt) {
  const int w = wt >> 5, lane = wt & 31, g = lane >> 2, tig = lane & 3;
  const int pos = w >> 1, m0 = 16 * w + g, hh = lane & (NH - 1);
  float m_run = -INFINITY, d_run = 0.f, o_run[3] = {0.f, 0.f, 0.f};
  float acc[64];
  H2xTile* ring = &s.tile[0][0];
  unsigned long long *full = &s.full[0][0], *empty = &s.empty[0][0];
  for (int j = 0;; ++j) {
    const int st = j % 4, buf = j & 1;
    H2xTile& T = ring[st];
    mbar_wait(&full[st], (j / 4) & 1);
    const long long rows[2] = {T.row[0], T.row[1]};
    if (rows[0] < 0) break;
    const int first[2] = {T.first[0], T.first[1]}, last[2] = {T.last[0], T.last[1]};
    const long long crow = rows[pos];
    const unsigned vmask = T.valid[pos];
    const int src[2] = {T.src[m0], T.src[m0 + 8]};
    const float ew[2] = {T.ew[m0], T.ew[m0 + 8]};
    const bool valid[2] = {((vmask >> (m0 & 31)) & 1u) != 0, ((vmask >> ((m0 + 8) & 31)) & 1u) != 0};
    const uint64_t da = mma_desc(T.a, kSboT1);
    float2 ns[2][H / 8];
    uint32_t fr[H / 16][4];
    first_layer_mma(acc, da, s.t1[c]);
    node_sums(ns, in, crow < 0 ? nullptr : T.ni[pos], src, c, tig);
    wgmma_wait0();
    fence_acc(acc);
    add_node_sums(acc, ns);
    ln_relu_frags(fr, acc, s.ln, c, tig);
    if (c == 0) {
      const uint64_t db = mma_desc(s.w2k, kSboW2);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) wgmma_rs(acc, fr[ks], desc_ks(db, ks), ks);
      wgmma_commit();
      float2 qv[NH];
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
        qv[nt] = crow < 0 ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(&T.q[pos][8 * nt + 2 * tig]);
      wgmma_wait0();
      fence_acc(acc);
      mbar_arrive(&empty[st]);
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(&s.b2k[8 * nt + 2 * tig]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * nt + 2 * r] += bias.x;
          acc[4 * nt + 2 * r + 1] += bias.y;
        }
      }
      if (j >= 2) named_sync(6 + buf, 256);
      softmax_partials(acc, qv, valid, ew, s.pw[buf][w], s.xm[0][buf][w], s.xs[0][buf][w], g,
                       tig);
      named_arrive(4 + buf, 256);
      continue;
    }
    float rel[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) rel[r][cc] = T.rel[m0 + 8 * r][cc];
    mbar_arrive(&empty[st]);
    float v[8];
    {
      const uint64_t db = mma_desc(s.w2v, kSboW2);
      fence_acc(v);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) wgmma_rs16(v, fr[ks], desc_ks(db, ks), ks);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(v);
    }
    named_sync(4 + buf, 256);
    value_partials(v, s.b2v, s.pw[buf][w], rel, s.xv[0][buf][w], lane);
    named_sync(1 + c, 128);
    if (w == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (rows[p] < 0) continue;
        if (first[p]) {
          m_run = -INFINITY;
          d_run = 0.f;
          o_run[0] = o_run[1] = o_run[2] = 0.f;
        }
#pragma unroll
        for (int ww = 2 * p; ww < 2 * p + 2; ++ww) {
          const float mw = s.xm[0][buf][ww][hh];
          if (mw == -INFINITY) continue;
          const float mn = fmaxf(m_run, mw), a = expf(m_run - mn), b = expf(mw - mn);
          d_run = fmaf(d_run, a, s.xs[0][buf][ww][hh] * b);
#pragma unroll
          for (int cc = 0; cc < 3; ++cc)
            o_run[cc] = fmaf(o_run[cc], a, s.xv[0][buf][ww][hh][cc] * b);
          m_run = mn;
        }
        if (last[p]) {
          const float inv = 1.f / fmaxf(d_run, 1e-16f);
          float dx[3];
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            dx[cc] = o_run[cc] * inv;
#pragma unroll
            for (int off = NH / 2; off > 0; off >>= 1)
              dx[cc] += __shfl_xor_sync(0xffffffffu, dx[cc], off);
          }
          if (lane == 0) {
            const long long bn = rows[p];
            const float gate = in.mlig[bn] ? 1.f : 0.f;
#pragma unroll
            for (int cc = 0; cc < 3; ++cc)
              out[3 * bn + cc] = in.x[3 * bn + cc] + gate * (dx[cc] * (1.f / NH));
          }
        }
      }
    }
    named_arrive(6 + buf, 256);
  }
}

"""


def _paired(s: str) -> str:
    s = patch(s, "__global__ void __launch_bounds__(kH2xMmaThreads, 1)\n",
              PAIRED + "__global__ void __launch_bounds__(kH2xMmaThreads, 1)\n")
    s = patch(s, "        mbar_init(&s.empty[c][st], 128);\n", "        mbar_init(&s.empty[c][st], 256);\n")
    s = patch(s, "    h2x_producer(s, in, qn, B, N, K, row0, out, (t & 127) >> 5, t & 31);\n",
              "    h2x_producer_paired(s, in, qn, B, N, K, row0, out, (t & 127) >> 5, t & 31);\n")
    s = patch(s, "    h2x_consumer(s, in, out, wg, t & 127);\n",
              "    h2x_consumer_paired(s, in, out, wg, t & 127);\n")
    return patch(s, "  const long long units = ((long long)B * (N - row0) + kH2xConsumers - 1) / "
                    "kH2xConsumers;\n", "  const long long units = (long long)B * (N - row0);\n")


def new(fn):
    return (NEW, fn)


VARIANTS = {
    "kernel": (None, lambda s: s),
    # one stage out: the consumers only wait for a tile and hand its stage
    # back (the producer's own pace); no first-layer wgmma (both halves); no
    # nj gather; no LayerNorm (the accumulators' bits as the A fragments); no
    # k or v second-layer wgmma; no merge (nothing written for live rows); no
    # RBF expf in the producer
    "producer_only": new(lambda s: patch(s, END, END + "    mbar_arrive(&s.empty[c][st]);\n"
                                                       "    continue;\n")),
    "no_first_layer": new(lambda s: patch(patch(s, FIRST_K, ""), FIRST_V, "")),
    "no_nj": (COMMON, lambda s: patch(s, NJ, "      const float2 b = true ? make_float2(0.f, 0.f)\n")),
    "no_layernorm": new(lambda s: patch(patch(s, LN_K, NO_LN), LN_V, NO_LN)),
    "no_k_product": new(lambda s: patch(s, K_MMA, "")),
    "no_v_product": new(lambda s: patch(s, V_MMA, "")),
    "no_merge": new(lambda s: patch(s, MERGE, "    continue;\n")),
    "no_rbf": (COMMON, lambda s: patch(s, RBF, "    rb[r] = (unsigned short)r;\n")),
    # alternatives: the other deal (b); q loaded after the k product's wait;
    # rel read from the stage in the weighted sums; the register splits
    # (producer / consumers) 40 / 232, 56 / 224 (x2h's), 80 / 208, 96 / 200
    # and 112 / 192
    "paired": new(_paired),
    "q_late": new(lambda s: patch(s, Q_LOAD, Q_LATE)),
    "rel_smem": new(_rel_smem),
    **{f"regs_{a}_{b}": new(lambda s, a=a, b=b: patch(
        s, REGS, f"constexpr int kH2xProducerRegs = {a}, kH2xConsumerRegs = {b};"))
       for a, b in ((40, 232), (56, 224), (80, 208), (96, 200), (112, 192))},
}
CHECKED = ("kernel", "paired", "q_late", "rel_smem", "regs_40_232", "regs_56_224",
           "regs_80_208", "regs_96_200", "regs_112_192")  # variants whose results are right


def make_copy(base: Path, root: Path, name: str) -> Path:
    target, fn = VARIANTS[name]
    return vh.make_copy(base, root, name,
                        None if target is None else lambda csrc: vh.rewrite(csrc / target, fn))


def measure(copy_dir: Path, name: str, out_file=None) -> dict:
    """The variant in `copy_dir`: the bf16 h2x edge launch at kNN B=4 and
    B=100 and the bf16 per-layer h2x at the hybrid shape (N = 640, K = 95:
    chip_smoke.hybrid_setup); for the variants whose results are right also
    the error over scale against the bf16 plain layer, whether two launches
    agree bitwise and whether rows without a valid edge keep x."""
    sys.path.insert(0, str(copy_dir))
    import torch

    import chip_smoke as cs
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    bf16 = torch.bfloat16
    dev = torch.device("cuda:0")
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}
    torch.manual_seed(0)
    model = DiffusionModel(Config(cs.FLAGSHIP), feat.feature_dim, cs.NUM_CLASSES, device=dev,
                           max_protein=cs.MAX_PROTEIN, max_ligand=cs.MAX_LIGAND)
    rn = model.net.refine_net
    out = {"variant": name}

    def errs(label, got, again, want, x, nbh, mlig, n_ligand):
        out[f"{label}_max_over_scale"] = float(
            (got - want)[mlig].abs().max() / want[mlig].abs().max())
        out[f"{label}_bitwise_repeat"] = bool(torch.equal(got, again))
        tail = torch.arange(x.shape[1], device=dev) >= x.shape[1] - n_ligand
        empty = tail & ~nbh.mask.any(-1)
        out[f"{label}_empty_rows_keep_x"] = bool(torch.equal(got[empty], x[empty]))

    with torch.no_grad():
        packed = kblock.pack_block_params(rn, bf16)
        ph = {k: v[:1] for k, v in packed.h2x.items()}
        for label, reps in (("b4", 1), ("b100", 25)):
            h, x, node_mask, mlig = model.net.embed(*cs.pocket_batch(
                torch, dev, pocket, feat.feature_dim, cs.MAX_LIGAND, cs.LIGAND_SIZES * reps, 0))
            nbh = G.knn_graph(x, node_mask, cs.K)
            e_w = rn.edge_weights(x, nbh, bf16)[..., 0]
            hl = cs.pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, ph, cs.MAX_LIGAND,
                                  bf16=True)
            hl.node_rows()
            out[f"{label}_device_ms"] = cs.kernel_device_ms(torch, hl.h2x, "h2x_edge", calls=20)
            if label == "b100":
                out["b100_ms"] = cs.cuda_ms(torch, hl.h2x)
                out["b100_live_edges"] = int(nbh.mask[mlig].sum())
            if name in CHECKED:
                hl.h2x()
                got = hl.xout.clone()
                hl.h2x()
                want = kel.h2x_layer_plain(rn.base_block[0], h, x, nbh, mlig, e_w, bf16)
                errs(label, got, hl.xout, want, x, nbh, mlig, cs.MAX_LIGAND)
            del h, x, node_mask, mlig, nbh, e_w, hl
            torch.cuda.empty_cache()
        hmodel, _, h, x, node_mask, mlig, nbh = cs.hybrid_setup(torch, dev, pocket,
                                                                 feat.feature_dim)
        layer = hmodel.net.refine_net.base_block[0]
        e_w = hmodel.net.refine_net.edge_weights(x, nbh)[..., 0]
        _, hx = kel.pack_layer_params(layer, bf16)

        def run():
            return kel.h2x_layer_cuda(h, x, nbh, mlig, e_w, cs.HYBRID_LIGAND, hx, bf16)

        out["hybrid_device_ms"] = cs.kernel_device_ms(torch, run, "h2x_edge", calls=20)
        if name in CHECKED:
            want = kel.h2x_layer_plain(layer, h, x, nbh, mlig, e_w, bf16)
            errs("hybrid", run(), run(), want, x, nbh, mlig, cs.HYBRID_LIGAND)
    out["ptxas"] = vh.ptxas({"h2x_edge_mma": ("block_denoiser", "h2x_edge_mma_kernel"),
                             "h2x_edge<bf16>": ("block_denoiser", "h2x_edge_kernelILb1")})
    return out


def main(argv) -> int:
    base = vh.REPO
    if argv[:1] == ["--base"]:
        base, argv = Path(argv[1]).resolve(), argv[2:]
    return vh.main(__file__, argv, VARIANTS, lambda root, n: make_copy(base, root, n), measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
