#!/usr/bin/env python3
"""Variants of the graph-index kernels on one NVIDIA GPU: the kNN kernel
(knn_kernel in targetdiff_tpu_torch/csrc/knn.cu) and the training backward's
inverse adjacency (build_adjacency's adj_count_kernel, adj_scan_kernel and
adj_place_kernel in csrc/pass_bwd.cuh), ablations of their designs, each
held against the unchanged kernels in one run.

    python3 graph_variants.py [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package whose
knn.cu or pass_bwd.cuh is changed by a string patch (VARIANTS), built and
measured as variant_harness.py sets out, the unchanged kernels first and
last. Each prints one JSON line: for the kNN kernel at chip_smoke's shapes
(the example pocket at B=4 and B=100, [train]'s batch at B=32; K = 32)
whether idx and mask equal knn_graph_exact bit for bit and its device ms
per launch; for the adjacency on [train]'s kNN graph, x2h (row0 =
0) and h2x (row0 = N - 32) passes, whether off and the lists equal
adjacency_plain bit for bit and its device ms per build; and the kernels'
registers and spills from `-Xptxas -v`. The card's name and power limit
come first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

KNN, ADJ = "knn.cu", "pass_bwd.cuh"


def _const(name: str, old: int, new: int):
    return lambda s: patch(s, f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


VARIANTS = {
    "kernel": (None, lambda s: s),
    # knn_kernel: rows (warps) per block, and its batch merge taken from one
    # survivor on, from 8 or 16, or never
    "knn_rows4": (KNN, _const("kRowsPerBlock", 8, 4)),
    "knn_rows16": (KNN, _const("kRowsPerBlock", 8, 16)),
    "knn_merge_always": (KNN, _const("kMergeAt", 4, 1)),
    "knn_insert_only": (KNN, _const("kMergeAt", 4, 33)),
    "knn_merge_at8": (KNN, _const("kMergeAt", 4, 8)),
    "knn_merge_at16": (KNN, _const("kMergeAt", 4, 16)),
    # the batches' distances and filter alone, no selection (timing only)
    "knn_distances_only": (KNN, lambda s: patch(
        s, "unsigned todo = __ballot_sync(0xffffffffu, c < kth);",
        "unsigned todo = __ballot_sync(0xffffffffu, c < kth) & 0u;")),
    # the first version's K argmin rounds at every K
    "knn_rounds": (KNN, lambda s: patch(s, "  if (K <= 32)\n    return launch(knn_kernel,",
                                        "  if (false)\n    return launch(knn_kernel,")),
    # the adjacency: edges per tile and tiles (warps) per block
    "adj_tile256": (ADJ, lambda s: patch(s, "((N > 512 ? N : 512) + 31)",
                                         "((N > 256 ? N : 256) + 31)")),
    "adj_tile1024": (ADJ, lambda s: patch(s, "((N > 512 ? N : 512) + 31)",
                                          "((N > 1024 ? N : 1024) + 31)")),
    "adj_warps1": (ADJ, _const("kAdjWarps", 4, 1)),
    "adj_warps8": (ADJ, _const("kAdjWarps", 4, 8)),
    "adj_steps4": (ADJ, _const("kAdjSteps", 8, 4)),
    "adj_steps16": (ADJ, _const("kAdjSteps", 8, 16)),
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
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    dev = torch.device("cuda:0")
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}
    model = cs.knn_setup(torch, dev, pocket, feat.feature_dim)[0]
    cases = {}
    for label, sizes in (("B4", cs.LIGAND_SIZES), ("B100", cs.LIGAND_SIZES * 25)):
        with torch.no_grad():
            _, x, mask, _ = model.net.embed(*cs.pocket_batch(
                torch, dev, pocket, feat.feature_dim, cs.MAX_LIGAND, sizes, 0))
        cases[label] = (x, mask)
    cases["train"] = cs.train_positions(torch, dev)
    knn = {}
    for label, (x, mask) in cases.items():
        got = kknn.knn_graph_cuda(x, mask, cs.K)
        want = G.knn_graph_exact(x, mask, cs.K)
        knn[label] = {
            "bitwise_equal": bool(torch.equal(got.idx, want.idx)
                                  and torch.equal(got.mask, want.mask)),
            "device_ms": cs.kernel_device_ms(torch, lambda: kknn.knn_graph_cuda(x, mask, cs.K),
                                             "knn_", calls=20)}
        del got, want
    x, mask = cases["train"]
    nbh = kknn.knn_graph_cuda(x, mask, cs.K)
    adj = {}
    for sub, row0 in (("x2h", 0), ("h2x", mask.shape[1] - cs.MAX_LIGAND)):
        off, lst = kvjp.adjacency_cuda(nbh.idx, nbh.mask, row0)
        want_off, want_lst = kvjp.adjacency_plain(nbh.idx, nbh.mask, row0)
        live = torch.arange(lst.shape[1], device=dev)[None] < want_off[:, -1:]
        adj[sub] = {
            "bitwise_equal": bool(torch.equal(off, want_off)
                                  and torch.equal(lst[live], want_lst[live])),
            "device_ms": cs.kernel_device_ms(torch, lambda: kvjp.adjacency_cuda(
                nbh.idx, nbh.mask, row0), "adj_", calls=20)}
    ptxas = vh.ptxas({"knn": ("knn", "knn_kernel"), "knn_rounds": ("knn", "knn_rounds_kernel"),
                      "adj_count": ("block_vjp", "adj_count_kernel"),
                      "adj_scan": ("block_vjp", "adj_scan_kernel"),
                      "adj_place": ("block_vjp", "adj_place_kernel")})
    return {"variant": name, "ptxas": ptxas, "knn": knn, "adjacency": adj}


def main(argv) -> int:
    return vh.main(__file__, argv, VARIANTS, make_copy, measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
