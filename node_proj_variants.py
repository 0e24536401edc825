#!/usr/bin/env python3
"""Stage split and design alternatives of the node-projection kernel
(node_kernel in targetdiff_tpu_torch/csrc/node_proj.cuh) on one NVIDIA GPU:
copies of the kernel with one stage taken out or one choice changed, each
timed against the unchanged kernel in one run.

    python3 node_proj_variants.py [--base CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package of
CHECKOUT (this checkout by default) whose node_proj.cuh is changed by a
string patch (VARIANTS), built and measured as variant_harness.py sets out,
the unchanged kernel first and last. A stage is taken out by skipping its
loop or its instruction, so that its cost goes and little else changes; the
results of those copies are wrong and only their times are read. The `old_*`
variants patch the earlier kernel (one 64-row tile and one 128-column slice
of w_node a block, mma.sync; give --base a checkout that has it); the others
the persistent wgmma kernel. Only name variants that apply to the base: the
default list is every variant of this checkout's kernel.

Each prints one JSON line: the device ms per launch (torch.profiler) of the
node launch alone (`node_projections_cuda`, layer 0 of a flagship model with
seeded random weights, h the embedding of chip_smoke's kNN batch) in bf16
and in float32, every row (the x2h pass) and with row0 = N - 32 (the h2x
pass), at kNN B=4 (2,432 rows) and B=100 (60,800 rows); for the unchanged
kernel and the alternatives (RIGHT) also its errors (ni, nj and q1 over
scale against float64 of the same operands, q against the plain version of
its precision) and whether two launches agree bitwise; and the kernels'
registers and spills from `-Xptxas -v`. The card's name and power limit come
first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

NODE = "node_proj.cuh"

# the earlier kernel's stages
OLD_STAGE_W = """  stage_frags<kBf16>(&s.w[0][0][0], weights<kBf16>(p.w_node) + slice * H, H5, kNTiles, t,
                     kNodeThreads);
"""
OLD_H_LOAD = "    for (int c = 0; c < 4; ++c) v[i][c] = n >= 0 ? h[n * H + lane + 32 * c] : 0.f;\n"
OLD_SCALE = "    const int e = row_exponent(warp_max(mx));\n"
OLD_FIRST = """  tile_mma<4, kBf16>(acc, &s.a[32 * mw][0], &s.w[0][4 * nw][0], kNTiles, lane);
  const float* bias = p.b_node + slice * H;
"""
OLD_LN = "  ln_split_rows<kBf16>(&s.a[0][0], warp, 8, p.q_ln, p.q_ln + H, lane);\n"
OLD_STAGE_Q2 = ("  stage_frags<kBf16>(&s.w[0][0][0], weights<kBf16>(p.w_q2), H, kNTiles, t, "
                "kNodeThreads);\n")
OLD_SECOND = """  tile_mma<4, kBf16>(acc, &s.a[32 * mw][0], &s.w[0][4 * nw][0], kNTiles, lane);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long n = node_of(32 * mw"""
OLD_STORE_NJ = "          *reinterpret_cast<float2*>(dst + n * H2 + c) =\n"
OLD_STORE_Q = "        *reinterpret_cast<float2*>(q + n * H + c) =\n"
NEVER = "if (acc[mt][nt][0] == 1234.5f) "  # keeps the products alive, stores nothing

# the persistent wgmma kernel's stages
STAGE = """    node_stage<kBf16, true>(w0, wn, H5, t, M::kThreads);
    if (grp < 2)
      node_stage<kBf16, true>(w1, wn + H, H5, t, M::kThreads);
    else
      node_stage<kBf16, false>(w1, weights<kBf16>(p.w_q2), H, t, M::kThreads);
"""
H_LOAD = "        x[r][ks] = n < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : src[4 * ks + tig];\n"
PRODUCTS = ("    for (int ks = 0; ks < kKSteps; ++ks) wgmma_rs(acc, a[0][ks], desc_ks(dh, ks), "
            "ks);\n")
PRODUCTS_F32 = """      wgmma_rs<true>(acc, a[1][ks], desc_ks(dh, ks), ks);
      wgmma_rs<true>(acc, a[0][ks], desc_ks(dl, ks), 1);
      wgmma_rs<true>(acc, a[0][ks], desc_ks(dh, ks), 1);
"""
STORE = "      *reinterpret_cast<float2*>(dst + rows[r] * ld + 8 * nt + 2 * tig) =\n"
NEVER_NEW = "if (acc[0] == 1234.5f) "
SBO = "constexpr int kNodeSbo = 2 * kKSteps * 128 + 16;"
PER_SM = "static constexpr int kBlocksPerSm = kBf16 ? 2 : 1;"
WARPGROUPS = "static constexpr int kWarpgroups = kBf16 ? 1 : 2;"
PREFETCH = "    if (tile + stride < tiles) load_rows(tile + stride);  // in flight during the products\n"
LOOP = "  for (; tile < tiles; tile += stride) {\n"


def old(old_text, new_text):
    return lambda s: patch(s, old_text, new_text)


def _old_no_h(s: str) -> str:
    s = patch(s, OLD_H_LOAD, "    for (int c = 0; c < 4; ++c) v[i][c] = (float)(n + lane + c);\n")
    return patch(s, OLD_SCALE, "    const int e = 0;\n")


VARIANTS = {
    "kernel": lambda s: s,
    # the earlier kernel with one stage out: the w_node slice's staging, the
    # h loads with their row scaling, the row scaling alone, the first
    # product, the q LayerNorm, w_q2's staging, the second product, the
    # global stores
    "old_no_w_staging": old(OLD_STAGE_W, ""),
    "old_no_h_loads": _old_no_h,
    "old_no_row_scaling": old(OLD_SCALE, "    const int e = 0;\n"),
    "old_no_first_product": old(OLD_FIRST, "  const float* bias = p.b_node + slice * H;\n"),
    "old_no_q_layernorm": old(OLD_LN, ""),
    "old_no_wq2_staging": old(OLD_STAGE_Q2, ""),
    "old_no_second_product": old(OLD_SECOND, OLD_SECOND.split("\n", 1)[1]),
    "old_no_stores": lambda s: patch(patch(s, OLD_STORE_NJ, "          " + NEVER + OLD_STORE_NJ.strip()
                                           + "\n"), OLD_STORE_Q,
                                     "        " + NEVER + OLD_STORE_Q.strip() + "\n"),
    # the persistent wgmma kernel with one stage out: the weights' staging,
    # the h loads, the products (bf16 and float32), the stores of ni, nj, q
    # (and q1)
    "no_staging": old(STAGE, ""),
    "no_h_loads": old(H_LOAD, "        x[r][ks] = make_float4(n, tig, ks, 1.f);\n"),
    "no_products": lambda s: patch(patch(s, PRODUCTS, ""), PRODUCTS_F32, ""),
    "no_stores": old(STORE, STORE.replace("*", NEVER_NEW + "*", 1)),
    # the next tile's rows loaded at the top of each tile instead of during
    # the products
    "no_prefetch": lambda s: patch(patch(s, PREFETCH, ""), LOOP, LOOP + "    load_rows(tile);\n"),
    # alternatives: core-matrix groups 2 KB apart (no padding: 8-way bank
    # conflicts in the staging); bf16 at three blocks a SM (170 registers);
    # float32 at one warpgroup a block
    "sbo_2048": old(SBO, SBO.replace(" + 16;", ";")),
    "three_blocks": old(PER_SM, PER_SM.replace("? 2", "? 3")),
    "f32_one_warpgroup": old(WARPGROUPS, WARPGROUPS.replace("kBf16 ? 1 : 2", "1")),
}
DEFAULT = [n for n in VARIANTS if not n.startswith("old_")]
# variants whose results are right: their errors are measured too
RIGHT = ("kernel", "no_prefetch", "sbo_2048", "three_blocks", "f32_one_warpgroup")


def make_copy(base: Path, root: Path, name: str) -> Path:
    return vh.make_copy(base, root, name,
                        lambda csrc: vh.rewrite(csrc / NODE, VARIANTS[name]))


def measure(copy_dir: Path, name: str, out_file=None) -> dict:
    """The variant in `copy_dir`: the node launch alone in bf16 and float32,
    both passes, at kNN B=4 and B=100; for the unchanged kernel also its
    errors and a bitwise repeat."""
    sys.path.insert(0, str(copy_dir))
    import torch

    import chip_smoke as cs
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock

    dev = torch.device("cuda:0")
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}
    torch.manual_seed(0)
    model = DiffusionModel(Config(cs.FLAGSHIP), feat.feature_dim, cs.NUM_CLASSES, device=dev,
                           max_protein=cs.MAX_PROTEIN, max_ligand=cs.MAX_LIGAND)
    rn = model.net.refine_net
    out = {"variant": name}
    with torch.no_grad():
        packs = {"bf16": kblock.pack_pass_params(rn, torch.bfloat16)[0],
                 "f32": kblock.pack_pass_params(rn)[0]}
        packs = {k: {f: v[:1].contiguous() for f, v in st.items()} for k, st in packs.items()}
        for label, reps in (("b4", 1), ("b100", 25)):
            h, _, _, _ = model.net.embed(*cs.pocket_batch(
                torch, dev, pocket, feat.feature_dim, cs.MAX_LIGAND, cs.LIGAND_SIZES * reps, 0))
            N = h.shape[1]
            for prec, st in packs.items():
                for pas, row0 in (("x2h", 0), ("h2x", N - cs.MAX_LIGAND)):
                    out[f"{prec}_{pas}_{label}_device_ms"] = cs.kernel_device_ms(
                        torch, lambda: kblock.node_projections_cuda(h, st, 0, row0), "node_kernel",
                        calls=20)
                if name in RIGHT:
                    out.update({f"{prec}_{label}_{k}": v
                                for k, v in node_errors(torch, kblock, h, st).items()})
            del h
            torch.cuda.empty_cache()
    out["ptxas"] = vh.ptxas({"node<bf16>": ("block_denoiser", "node_kernelILb1"),
                             "node<f32>": ("block_denoiser", "node_kernelILb0")})
    return out


def node_errors(torch, kblock, h, st) -> dict:
    """The node launch's ni and nj over scale against float64 of the same
    operands, q (and q1) against the plain version of its precision, whether
    two launches agree bitwise, and a digest of its outputs (equal digests:
    bitwise equal variants)."""
    import chip_smoke as cs

    H = h.shape[-1]
    got = kblock.node_projections_cuda(h, st, 0, 0, want_q1=True)
    again = kblock.node_projections_cuda(h, st, 0, 0, want_q1=True)
    bf16 = st["w_node"].dtype == torch.bfloat16
    want64 = kblock.node_projections_plain(
        h.double().reshape(-1, H), st if bf16 else {k: v.double() for k, v in st.items()})
    want = kblock.node_projections_plain(h.reshape(-1, H), st) if bf16 else want64
    rel = lambda g, w: float((g.double() - w.double()).abs().max() / w.double().abs().max())  # noqa: E731
    return {"ni_nj_rel": max(rel(got[0], want64[0]), rel(got[1], want64[1])),
            "q_rel": rel(got[2], want[2]), "q1_rel": rel(got[3], want64[3]),
            "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
            "digest": cs.digest(torch, *got)}


def main(argv) -> int:
    base = vh.REPO
    if argv[:1] == ["--base"]:
        base, argv = Path(argv[1]).resolve(), argv[2:]
    return vh.main(__file__, argv or DEFAULT, VARIANTS, lambda root, n: make_copy(base, root, n),
                   measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
