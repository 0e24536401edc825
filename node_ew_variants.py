#!/usr/bin/env python3
"""Variants of the backward's node kernel (node_bwd_kernel in
targetdiff_tpu_torch/csrc/node_bwd.cuh) and of the edge-weight kernel
(ew_kernel in targetdiff_tpu_torch/csrc/block_denoiser.cu) on one NVIDIA GPU:
the mutation checks of their float64 bars and ablations of their designs,
each held against the unchanged kernels in one run.

    python3 node_ew_variants.py [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package whose
node_bwd.cuh or block_denoiser.cu is changed by a string patch (VARIANTS),
built and measured as variant_harness.py sets out, the unchanged kernels
first and last. Each prints one JSON line: for node_bwd_kernel at the shapes
of its passes (NODE_CASES: the B=32 step's 13,312 rows, the B=4 block
backward's 2,432 and the B=4 hybrid per-layer backward's 2,560, each with
the x2h and h2x row buffers) the largest error over scale of its outputs
against float64 (the bar is chip_smoke.NODE_BWD_BAR) and its device ms per
launch; for ew_kernel on chip_smoke.EW_CASES (kNN K = 32 at B = 4 and 100,
hybrid K = 95) the largest error on the valid slots against float64 (the
bar is chip_smoke.EW_TOL) and its device ms per launch; and both kernels'
registers and spills from `-Xptxas -v`; for the unchanged kernels and the
node kernel's mutant also chip_smoke.margins (the gradients of [train-block]
and [layers]' hybrid backwards against float64, bars chip_smoke.BWD64_MEDIAN
and BWD64_BAR). The card's name and power limit come first. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

NODE, EW = "node_bwd.cuh", "block_denoiser.cu"
MARGINS = ("kernel", "one_term_node_bwd")  # variants also held to chip_smoke.margins
# rows and V of the node kernel's cases: the B=32 step's passes, the B=4
# block backward's (N = 608) and the B=4 hybrid per-layer backward's (N = 640)
NODE_CASES = {"x2h_B32": (13312, 128), "h2x_B32": (13312, 16), "block_x2h": (2432, 128),
              "block_h2x": (2432, 16), "layer_x2h": (2560, 128), "layer_h2x": (2560, 16)}

NODE_TERMS = """        mma_tf32(d, al[mt], bh0, bh1);
        mma_tf32(d, ah[mt], bl0, bl1);
"""
EW_TERMS = """            mma_tf32(d, al, wf.x, wf.y);
            mma_tf32(d, ah, wf.z, wf.w);
"""
EW_SUM = """            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, wf.x, wf.y);
            mma_tf32(d, ah, wf.z, wf.w);
            mma_tf32(d, ah, wf.x, wf.y);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[nt][c] += d[c];
"""
EW_MMA_SUM = """            mma_tf32(acc[nt], al, wf.x, wf.y);
            mma_tf32(acc[nt], ah, wf.z, wf.w);
            mma_tf32(acc[nt], ah, wf.x, wf.y);
"""
# the operands' TF32 splits taken out (lo = hi; wrong results, timing only)
NO_SPLIT = """__device__ __forceinline__ void nb_no_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = lo = __float_as_uint(x);
}

"""
NODE_KSTEPS = "#pragma unroll 1\n  for (int k0 = 0; k0 < kNbK; k0 += 8) {"
# the first layer with n-tiles outside and the three k-steps' A fragments
# held in registers
EW_KS_OUTER = """#pragma unroll
        for (int ks = 0; ks < kEwKSteps; ++ks) {
          // A: (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)
          const float* ar = tile + (16 * mt + g) * kEwLd + 8 * ks + tig;
          uint32_t ah[4], al[4];
          split_tf32(ar[0], ah[0], al[0]);
          split_tf32(ar[8 * kEwLd], ah[1], al[1]);
          split_tf32(ar[4], ah[2], al[2]);
          split_tf32(ar[8 * kEwLd + 4], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < kEwNT; ++nt) {
            const uint4 wf = S.w1f[(ks * kEwNT + nt) * 32 + lane];
"""
EW_NT_OUTER = """        uint32_t ahs[kEwKSteps][4], als[kEwKSteps][4];
#pragma unroll
        for (int ks = 0; ks < kEwKSteps; ++ks) {
          const float* ar = tile + (16 * mt + g) * kEwLd + 8 * ks + tig;
          split_tf32(ar[0], ahs[ks][0], als[ks][0]);
          split_tf32(ar[8 * kEwLd], ahs[ks][1], als[ks][1]);
          split_tf32(ar[4], ahs[ks][2], als[ks][2]);
          split_tf32(ar[8 * kEwLd + 4], ahs[ks][3], als[ks][3]);
        }
#pragma unroll
        for (int nt = 0; nt < kEwNT; ++nt) {
#pragma unroll
          for (int ks = 0; ks < kEwKSteps; ++ks) {
            const uint32_t(&ah)[4] = ahs[ks];
            const uint32_t(&al)[4] = als[ks];
            const uint4 wf = S.w1f[(ks * kEwNT + nt) * 32 + lane];
"""


VARIANTS = {
    "kernel": (None, lambda s: s),
    # mutants: one TF32 product per term (hi * hi); the bars must miss them
    "one_term_node_bwd": (NODE, lambda s: patch(s, NODE_TERMS, "")),
    "one_term_ew": (EW, lambda s: patch(s, EW_TERMS, "")),
    # ablations of node_bwd_kernel's design (node_no_split: timing only)
    "node_no_split": (NODE, lambda s: patch(
        s, "// One 32-deep slice of a warp's product", NO_SPLIT + "// One 32-deep slice of a "
        "warp's product").replace("      split_tf32(", "      nb_no_split(").replace(
        "    split_tf32(", "    nb_no_split(")),
    "node_unroll2": (NODE, lambda s: patch(s, NODE_KSTEPS, NODE_KSTEPS.replace(
        "unroll 1\n", "unroll 2\n"))),
    "node_unroll4": (NODE, lambda s: patch(s, NODE_KSTEPS, NODE_KSTEPS.replace(
        "unroll 1\n", "unroll\n"))),
    "node_two_stages": (NODE, lambda s: patch(s, "constexpr int kNbStages = 3;",
                                              "constexpr int kNbStages = 2;")),
    # the node kernel's row tile forced to 32 or to 64 rows at every row count
    "node_tile32": (NODE, lambda s: patch(s, "tile = (rows + 63) / 64 >= n_sm ? 64 : 32;",
                                          "tile = 32;")),
    "node_tile64": (NODE, lambda s: patch(s, "tile = (rows + 63) / 64 >= n_sm ? 64 : 32;",
                                          "tile = 64;")),
    # ablations of ew_kernel's design
    "ew_nt_outer": (EW, lambda s: patch(s, EW_KS_OUTER, EW_NT_OUTER)),
    "ew_ks_unroll1": (EW, lambda s: patch(s, EW_KS_OUTER, EW_KS_OUTER.replace(
        "#pragma unroll\n        for (int ks", "#pragma unroll 1\n        for (int ks"))),
    # the three k-steps' terms accumulated in the mma, no float32 adds
    "ew_mma_accumulator": (EW, lambda s: patch(s, EW_SUM, EW_MMA_SUM)),
    "ew_one_block_per_sm": (EW, lambda s: patch(
        patch(s, "__launch_bounds__(kThreads, 2)\new_kernel(",
              "__launch_bounds__(kThreads, 1)\new_kernel("),
        "want < 2 * n_sm ? want : 2 * n_sm", "want < n_sm ? want : n_sm")),
}


def make_copy(root: Path, name: str) -> Path:
    target, fn = VARIANTS[name]
    return vh.make_copy(vh.REPO, root, name,
                        None if target is None else lambda csrc: vh.rewrite(csrc / target, fn))


def measure(copy_dir: Path, name: str, out_file=None) -> dict:
    """The variant in `copy_dir` on both kernels' shapes."""
    sys.path.insert(0, str(copy_dir))
    import torch

    import chip_smoke as cs
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    node = {}
    for case, (rows, V) in NODE_CASES.items():
        ops = cs.node_bwd_operands(torch, dev, rows, V)
        rowbuf, q1, dh, q_ln, w_q2T, w_nodeT = ops
        with torch.no_grad():
            got = kvjp.node_bwd_cuda(rowbuf.clone(), q1, dh.clone(), q_ln, w_q2T, w_nodeT)
            want = kvjp.node_bwd_plain(*[t.double() for t in ops], relu_mask=got[1] > 0)
            errs = cs.node_bwd_errs(got, want)
            del want
            rb, qa, dhc = got
            node[case] = {
                "err_over_scale": max(v for k, v in errs.items() if k.endswith("_over_scale")),
                "device_ms": cs.kernel_device_ms(torch, lambda: kvjp.node_bwd_cuda(
                    rb, q1, dhc, q_ln, w_q2T, w_nodeT, qa), "node_bwd_kernel", calls=20)}
        del ops, rowbuf, q1, dh, got, rb, qa, dhc
        torch.cuda.empty_cache()
    ew = {}
    for case in cs.EW_CASES:
        rn, x, nbh, packed = cs.ew_case(torch, dev, case)
        with torch.no_grad():
            got = kblock.edge_weights_cuda(x, nbh, packed)
            want = copy.deepcopy(rn).double().edge_weights(x.double(), nbh)[..., 0]
            ew[case] = {
                "err": float((got.double() - want)[nbh.mask].abs().max()),
                "device_ms": cs.kernel_device_ms(torch, lambda: kblock.edge_weights_cuda(
                    x, nbh, packed), "ew_kernel", calls=20)}
        del rn, x, nbh, packed, got, want
        torch.cuda.empty_cache()
    out = {}
    if name in MARGINS:
        from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
        from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom

        feat = FeaturizeProteinAtom()
        data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
        pocket = {"protein_pos": data["protein_pos"],
                  "protein_feat": data["protein_atom_feature"]}
        out["margins"] = cs.margins(torch, dev, pocket, feat.feature_dim, check=False)
    ptxas = vh.ptxas({"node_bwd<64>": ("block_vjp", "node_bwd_kernelILi64"),
                      "node_bwd<32>": ("block_vjp", "node_bwd_kernelILi32"),
                      "ew": ("block_denoiser", "ew_kernel")})
    return {"variant": name, "ptxas": ptxas,
            "node_bwd_worst_err_over_scale": max(v["err_over_scale"] for v in node.values()),
            "ew_worst_err": max(v["err"] for v in ew.values()), "node_bwd": node, "ew": ew,
            **out}


def main(argv) -> int:
    return vh.main(__file__, argv, VARIANTS, make_copy, measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
