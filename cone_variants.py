#!/usr/bin/env python3
"""Variants of the sampler's dependency-cone kernel (cone_kernel in
targetdiff_tpu_torch/csrc/cone.cu) on one NVIDIA GPU, each held against the
unchanged kernel in one run.

    python3 cone_variants.py [--parent CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package whose
cone.cu, its only CUDA source, is changed by a string patch (VARIANTS),
built and measured as variant_harness.py sets out, the unchanged kernel
first and last; with --parent, CHECKOUT's package (an earlier cone_kernel,
also built from its cone.cu alone) is measured first of all. Each prints one JSON line: at chip_smoke's [cone] shapes (the example
pocket's kNN graph at B=4 and B=100, N = 608, K = 32, L = 9) whether hop,
order and counts equal the plain version bit for bit, the kernel's device
ms per call and launches per call (torch.profiler) and, where the package
has the stamped instantiation, each phase's clock64 cycles (the largest
over the blocks); and the kernels' registers and spills from `-Xptxas -v`.
The card's name and power limit come first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

CONE = "cone.cu"


def _const(name: str, old: int, new: int):
    return lambda s: patch(s, f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


VARIANTS = {
    "kernel": lambda s: s,
    # rows' list loads in flight a lane while building the bitsets
    "stage_loads4": _const("kStageLoads", 8, 4),
    "stage_loads16": _const("kStageLoads", 8, 16),
    # level rows' words in flight a lane in a sweep
    "sweep_rows1": _const("kSweepRows", 4, 1),
    "sweep_rows8": _const("kSweepRows", 4, 8),
    # the whole card builds the bitsets at every batch size, or never
    "spread_always": lambda s: patch(s, "*spread = !*cached || 2 * B <= *grid;",
                                     "*spread = true;"),
    "spread_never": lambda s: patch(s, "*spread = !*cached || 2 * B <= *grid;",
                                    "*spread = !*cached;"),
    # the sweeps read the bitsets from device memory (L2)
    "bitsets_from_device": lambda s: patch(
        s, "*cached = cone_smem(N, true) <= (size_t)kMaxSmem;", "*cached = false;"),
    "threads256": _const("kConeThreads", 512, 256),
}


def only_cone(csrc: Path, fn=None) -> None:
    """Keep cone.cu alone in the copy's sources (the measurement calls no
    other kernel, and the copy builds in seconds), changed by fn if given."""
    for src in csrc.iterdir():
        if src.name != CONE:
            src.unlink()
    if fn is not None:
        vh.rewrite(csrc / CONE, fn)


def make_copy(root: Path, name: str) -> Path:
    return vh.make_copy(vh.REPO, root, name, lambda csrc: only_cone(csrc, VARIANTS[name]))


def measure(copy_dir: Path, name: str, out_file=None) -> dict:
    """The variant in `copy_dir` at [cone]'s shapes."""
    sys.path.insert(0, str(copy_dir))
    import torch

    import chip_smoke as cs
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import cone as kcone

    dev = torch.device("cuda:0")
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}
    model = cs.knn_setup(torch, dev, pocket, feat.feature_dim)[0]
    L = cs.FLAGSHIP["num_layers"]
    out = {"variant": name}
    for label, sizes in (("B4", cs.LIGAND_SIZES), ("B100", cs.LIGAND_SIZES * 25)):
        with torch.no_grad():
            _, x, mask, _ = model.net.embed(*cs.pocket_batch(
                torch, dev, pocket, feat.feature_dim, cs.MAX_LIGAND, sizes, 0))
        nbh = G.knn_graph(x, mask, cs.K)

        def call():
            return kcone.cone_cuda(nbh.idx, nbh.mask, cs.MAX_LIGAND, L)

        want = kcone.cone_plain(nbh.idx, nbh.mask, cs.MAX_LIGAND, L)
        case = {"bitwise_equal": all(torch.equal(a, b) for a, b in zip(call(), want)),
                "device_ms": cs.kernel_device_ms(torch, call, "cone_kernel", calls=20),
                "launches_per_call": cs.launches_per_call(torch, call, "cone_kernel")}
        if hasattr(kcone, "cone_phase_cycles"):
            stamped = kcone.cone_phase_cycles(nbh.idx, nbh.mask, cs.MAX_LIGAND, L)
            case["stamped_equal"] = all(torch.equal(a, b) for a, b in zip(stamped["cone"], want))
            case["phase_max_cycles"] = stamped["max_cycles"]
            case["sweeps_of_complex0"] = stamped["sweeps"]
        out[label] = case
    out["ptxas"] = vh.ptxas({f"cone_kernel<{c}, {p}, {s}>": ("cone", f"cone_kernelILb{c}ELb{p}ELb{s}E")
                             for c, p in ((1, 1), (1, 0), (0, 1)) for s in (0, 1)})
    return out


def main(argv) -> int:
    parent = None
    if argv[:1] == ["--parent"]:
        base = Path(argv[1]).resolve()
        parent = ("parent", lambda root: vh.make_copy(base, root, "parent", only_cone))
        argv = argv[2:]
    return vh.main(__file__, argv, VARIANTS, make_copy, measure, parent=parent)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
