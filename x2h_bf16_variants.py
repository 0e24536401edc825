#!/usr/bin/env python3
"""Stage split of the bf16 x2h edge pass on one NVIDIA GPU: copies of the
kernel with one stage taken out, each timed against the unchanged kernel in
one run.

    python3 x2h_bf16_variants.py [--base CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package of
CHECKOUT (this checkout by default) whose CUDA sources are changed by a
string patch (VARIANTS), built and measured as variant_harness.py sets out,
the unchanged kernel first and last. A stage is taken out by skipping its
loop or its instruction, so that its cost goes and nothing else changes
much; the results of those copies are wrong and only their times are read.
The `mma_*` variants patch the tensor-core x2h kernel of csrc/x2h_edge_bf16
.cuh and the pieces it shares with the bf16 h2x pass in csrc/edge_mma.cuh;
the others the bf16 instantiation of csrc/x2h_edge.cuh's
x2h_edge_kernel (the bf16 kernel before it: give --base a checkout that has
it). Each prints one JSON line: the device ms per launch of the bf16 x2h
edge launch alone (`chip_smoke.pass_launcher`, td_block_x2h_bf16, layer 0
of a flagship model with seeded random weights) at kNN B=4 and B=100 (N =
608, K = 32: the example pocket with chip_smoke.LIGAND_SIZES ligands), its
CUDA-event ms at B=100, and, for the unchanged kernel, the largest error
over scale against the bf16 plain layer on the real rows. The card's name
and power limit come first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

OLD, COMMON, NEW, MMA = "x2h_edge.cuh", "tc_common.cuh", "x2h_edge_bf16.cuh", "edge_mma.cuh"

# the old kernel's stages (tc_common.cuh: chunk_geometry, chunk_half; x2h_edge.cuh)
GATHER = """    if ((vmask >> slot) & 1u)
      cp_async16(dst, in.nj + (size_t)L.src[slot] * H2 + kv * H + 4 * piece);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
"""
FIRST = """  first_layer_slots(L, L.tmask[ta], wa, base_a, tl);
  first_layer_slots(L, L.tmask[ta + 2], wb, base_b, tl);
"""
LN = "  ln_split_rows<kBf16>(&L.z[0][0], qd, 4, p.kv_ln + kv * H, p.kv_ln + H2 + kv * H, lane);\n"
RBF = "        L.rbf[lane][r] = round_bf16(expf(in.coeff * d * d));"
PRODUCTS = "        tile_mma<4, kBf16>(acc, &L.z[0][0], &s.w[kv][0][4 * qd][0], kNTiles, lane);\n"


def old(target, old_text, new_text):
    return (target, lambda s: patch(s, old_text, new_text))


# the wgmma kernel's stages (x2h_edge_bf16.cuh, edge_mma.cuh)
END = "    if (rows[0] < 0) break;\n"
NJ = "      const float2 b = src[r] < 0 ? make_float2(0.f, 0.f)\n"
FIRST_MMA = ("  for (int ks = 0; ks < kT1KSteps; ++ks) wgmma_ss(acc, desc_ks(da, ks), "
             "desc_ks(db, ks), ks);\n")
SECOND_MMA = "        for (int ks = 0; ks < H / 16; ++ks) wgmma_rs(acc, fr[ks], desc_ks(db, ks), ks);\n"
MMA_RBF = ("    rb[r] = g.et < 0 ? 0 : __bfloat16_as_ushort(__float2bfloat16_rn(expf(in.coeff * d * "
           "d)));\n")

REGS = "constexpr int kProducerRegs = 56, kConsumerRegs = 224;"
CONSUMERS = "constexpr int kMmaConsumers = 2;"
STAGES = "constexpr int kMmaStages = 2;"
REGS_232 = "constexpr int kProducerRegs = 40, kConsumerRegs = 232;"
SRC_STORE = "  T.src[m] = (int)g.jn;\n"
PREFETCH_L2 = """  if (g.jn >= 0)
#pragma unroll
    for (int l = 0; l < H2 / 32; ++l)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(in.nj + g.jn * H2 + 32 * l));
"""
NS_LOAD = "      node_sums(ns, in, crow < 0 ? nullptr : T.ni[pos], src, kv, tig);\n"
NS_ADDED = "      add_node_sums(acc, ns);\n"


def _prefetch_v(s: str) -> str:
    s = patch(s, REGS, REGS_232)
    s = patch(s, NS_LOAD, "      if (kv == 0) " + NS_LOAD.strip().replace("kv, tig", "0, tig") + "\n")
    return patch(s, NS_ADDED, NS_ADDED + "      if (kv == 0) "
                 + NS_LOAD.strip().replace("kv, tig", "1, tig") + "\n")


VARIANTS = {
    "kernel": (None, lambda s: s),
    # the wgmma kernel with one stage out: its consumers only wait for a
    # tile and hand its stage back (the producer's own pace), no nj gather,
    # no first-layer or second-layer products (the LayerNorm kept alive),
    # no RBF expf in the producer
    "mma_producer_only": old(NEW, END, END + "    mbar_arrive(&s.empty[c][st]);\n    continue;\n"),
    "mma_no_nj": old(MMA, NJ, "      const float2 b = true ? make_float2(0.f, 0.f)\n"),
    "mma_no_first_layer": old(MMA, FIRST_MMA, ""),
    "mma_no_second_layer": old(NEW, SECOND_MMA, "        for (int ks = 0; ks < H / 16; ++ks)\n"
                               "          for (int i = 0; i < 4; ++i) acc[4 * ks + i] += "
                               "__uint_as_float(fr[ks][i]);\n"),
    "mma_no_rbf": old(MMA, MMA_RBF, "    rb[r] = (unsigned short)r;\n"),
    # alternatives: the register split 40 / 232 (producer / consumers); the
    # producer prefetching each valid slot's nj row into L2; the v half's
    # ni + nj loaded during the k half (with the 40 / 232 split)
    "mma_regs_232": old(NEW, REGS, REGS_232),
    # the register splits that took the bf16 h2x pass's producer out of spill
    # (h2x_bf16_variants.py): 96 / 200 and 128 / 184
    "mma_regs_96_200": old(NEW, REGS, "constexpr int kProducerRegs = 96, kConsumerRegs = 200;"),
    "mma_regs_128_184": old(NEW, REGS, "constexpr int kProducerRegs = 128, kConsumerRegs = 184;"),
    "mma_prefetch_l2": old(MMA, SRC_STORE, PREFETCH_L2 + SRC_STORE),
    "mma_prefetch_v_232": (None, None),
    # three consumer warpgroups (152 registers each), one ring stage and one
    # producer warp each (the shared memory of two stages does not fit)
    "mma_three_consumers": (NEW, lambda s: patch(patch(patch(
        s, CONSUMERS, CONSUMERS.replace("2", "3")), STAGES, STAGES.replace("2", "1")),
        REGS, "constexpr int kProducerRegs = 56, kConsumerRegs = 152;")),
    # x2h_edge.cuh's earlier bf16 instantiation with one stage out
    "no_gather": old(COMMON, GATHER, "    *reinterpret_cast<float4*>(dst) = "
                     "make_float4(0.f, 0.f, 0.f, 0.f);\n"),
    "no_first_layer": old(COMMON, FIRST, ""),
    "no_layernorm": old(COMMON, LN, ""),
    "no_rbf": old(COMMON, RBF, "        L.rbf[lane][r] = d;"),
    "no_products": old(OLD, PRODUCTS, ""),
    # every stage of the edge MLPs out: slot loads, geometry, softmax and
    # value sums left
    "skeleton": (None, None),
}


def _skeleton(csrc: Path) -> None:
    vh.rewrite(csrc / COMMON, lambda s: patch(patch(patch(patch(
        s, GATHER, ""), FIRST, ""), LN, ""), RBF, "        L.rbf[lane][r] = d;"))
    vh.rewrite(csrc / OLD, lambda s: patch(s, PRODUCTS, ""))


def make_copy(base: Path, root: Path, name: str) -> Path:
    target, fn = VARIANTS[name]
    if name == "skeleton":
        return vh.make_copy(base, root, name, _skeleton)
    if name == "mma_prefetch_v_232":
        return vh.make_copy(base, root, name, lambda csrc: vh.rewrite(csrc / NEW, _prefetch_v))
    return vh.make_copy(base, root, name,
                        None if target is None else lambda csrc: vh.rewrite(csrc / target, fn))


def measure(copy_dir: Path, name: str, out_file=None) -> dict:
    """The variant in `copy_dir`: the bf16 x2h edge launch at kNN B=4 and
    B=100 and the bf16 per-layer x2h at the hybrid shape (N = 640, K = 95:
    chip_smoke.hybrid_setup); for the unchanged kernel also its error over
    scale against the bf16 plain layer and whether two launches agree
    bitwise."""
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

    def errs(label, got, again, want, rows):
        d = (got - want)[rows].abs().max() / want[rows].abs().max()
        out[f"{label}_max_over_scale"] = float(d)
        out[f"{label}_bitwise_repeat"] = bool(torch.equal(got, again))

    with torch.no_grad():
        packed = kblock.pack_block_params(rn, bf16)
        px = {k: v[:1] for k, v in packed.x2h.items()}
        for label, reps in (("b4", 1), ("b100", 25)):
            h, x, node_mask, mlig = model.net.embed(*cs.pocket_batch(
                torch, dev, pocket, feat.feature_dim, cs.MAX_LIGAND, cs.LIGAND_SIZES * reps, 0))
            nbh = G.knn_graph(x, node_mask, cs.K)
            e_w = rn.edge_weights(x, nbh, bf16)[..., 0]
            xl = cs.pass_launcher(torch, kblock, h, x, nbh, mlig, e_w, px, cs.MAX_LIGAND,
                                  bf16=True)
            xl.node()
            out[f"{label}_device_ms"] = cs.kernel_device_ms(torch, xl.x2h, "x2h_edge", calls=20)
            if label == "b100":
                out["b100_ms"] = cs.cuda_ms(torch, xl.x2h)
                out["b100_live_edges"] = int(nbh.mask.sum())
            if name == "kernel":
                xl.x2h()
                got = xl.out.clone()
                xl.x2h()
                want = kel.x2h_layer_plain(rn.base_block[0], h, x, nbh, mlig, e_w, bf16)
                errs(label, got, xl.out, want, node_mask)
                empty = ~nbh.mask.any(-1)
                out[f"{label}_empty_rows_keep_h"] = bool(torch.equal(got[empty], h[empty]))
            del h, x, node_mask, mlig, nbh, e_w, xl
            torch.cuda.empty_cache()
        hmodel, _, h, x, node_mask, mlig, nbh = cs.hybrid_setup(torch, dev, pocket,
                                                                 feat.feature_dim)
        layer = hmodel.net.refine_net.base_block[0]
        e_w = hmodel.net.refine_net.edge_weights(x, nbh)[..., 0]
        hx, _ = kel.pack_layer_params(layer, bf16)
        out["hybrid_device_ms"] = cs.kernel_device_ms(
            torch, lambda: kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, hx, bf16), "x2h_edge",
            calls=20)
        if name == "kernel":
            got = kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, hx, bf16)
            again = kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, hx, bf16)
            want = kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, bf16)
            errs("hybrid", got, again, want, node_mask)
            empty = ~nbh.mask.any(-1)
            out["hybrid_empty_rows_keep_h"] = bool(torch.equal(got[empty], h[empty]))
    out["ptxas"] = vh.ptxas({"x2h_edge_mma": ("block_denoiser", "x2h_edge_mma_kernel"),
                             "x2h_edge<bf16>": ("block_denoiser", "x2h_edge_kernelILb1")})
    return out


def main(argv) -> int:
    base = vh.REPO
    if argv[:1] == ["--base"]:
        base, argv = Path(argv[1]).resolve(), argv[2:]
    return vh.main(__file__, argv, VARIANTS, lambda root, n: make_copy(base, root, n), measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
