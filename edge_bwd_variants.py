#!/usr/bin/env python3
"""Variants of the backward's edge kernel (edge_bwd_kernel in
targetdiff_tpu_torch/csrc/pass_bwd.cuh) on one NVIDIA GPU: the mutation check
of the backwards' float64 bars, a phase split of the kernel's time and the
design alternatives not taken, each variant held against the unchanged
kernel in one run.

    python3 edge_bwd_variants.py [--base CHECKOUT] [--parent CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package of
CHECKOUT (this checkout by default) whose pass_bwd.cuh or block_common.cuh
(the recompute's first layer) is changed by VARIANTS, or replaced by the
files of a directory (OVERLAYS); the copies are built in parallel and
measured one after the other, the unchanged kernel first and last. A phase
is taken out by skipping its loop or, for the recompute's second layers, by
loading its input in place of its output, so that nothing downstream folds
away; the results of those copies are wrong and only their times are read.
The alternatives are right and timed beside the kernel: `staged_cluster8`
(edge_bwd_staged/: the second layers staged once per cluster of eight
blocks in shared memory and read through distributed shared memory),
`drbf_prefetch`, `gather_first`, `fp32_table_drbf`, `unrolled_drbf`,
`select_first_layer`. Each prints one JSON line: the device ms per launch
of edge_bwd_kernel<x2h> and <h2x> in one block backward at the B=32 train
step's shapes (chip_smoke.py train_setup; N = 416, K = 32, L = 9), that
backward's CUDA-event ms, the kernels' registers, spills and shared memory
from `-Xptxas -v`, blocks per SM (block_vjp.edge_bwd_info) and, for the
unchanged kernel and the mutants, chip_smoke.margins (the gradients of
[train-block] and [layers]' hybrid backwards against float64, bars
chip_smoke.BWD64_MEDIAN and BWD64_BAR). With --parent, the unchanged kernel
of that checkout runs first too, and a last line gives every variant's
largest difference from its backward outputs (dh0, dx0, d e_w and every
weight gradient at those shapes; 0: bitwise equal); without, from the
unchanged kernel's. The card's name and power limit come first. Patches
that name the earlier FMA recompute, d rbf loop or first layer apply to a
checkout from before those changes (--base), so one command splits both.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import variant_harness as vh

REPO = vh.REPO
SOURCES = ("pass_bwd.cuh", "block_common.cuh")  # the files a variant may change
ERRORS = ("kernel", "one_term", "one_term_drbf")  # variants whose gradients are held to float64

OPAQUE = "for (int e = 0; e < KC; ++e) acc[e] = s_a[e][t];"
ONE_TERM = """// one fp16 product per term (the mutant of the three-term tile_mma)
template <int NT = 4>
__device__ __forceinline__ void one_term(float (&acc)[2][4][4], const float* a, const uint4* w,
                                         int ldn, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t ahi[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        ahi[mt][f] = *reinterpret_cast<const uint32_t*>(
            a + (16 * mt + g + 8 * (f & 1)) * kLdz + 16 * ks + 2 * tig + 8 * (f >> 1));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4 wf = w[(ks * ldn + nt) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_f16(acc[mt][nt], ahi[mt], wf.x, wf.y);
    }
  }
}

"""
SECOND_LAYERS = "template <int V>\n__device__ __forceinline__ void second_layers("
TWO_PASS = """  for (int e = n; e < KC; ++e) z[e][c] = 0.f;
  for (int ty = ta; ty < 4; ty += 2) {
    float w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = p.w_rbf[(ty * R + r) * H2 + c];
    const float wet = p.w_et[ty * H2 + c];
    for (int e = 0; e < n; ++e) {
      if (g.et[e] != ty) continue;
      float v = zi + in.nj[(b * N + g.j[e]) * H2 + c] + wet;
#pragma unroll
      for (int r = 0; r < R; ++r) v += g.rbf[e][r] * w[r];
      z[e][c] = v;
    }
  }
"""
SELECT = """  float wa[R], wb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wa[r] = p.w_rbf[(ta * R + r) * H2 + c];
    wb[r] = p.w_rbf[((ta + 2) * R + r) * H2 + c];
  }
  const float eta = p.w_et[ta * H2 + c], etb = p.w_et[(ta + 2) * H2 + c];
  for (int e = 0; e < KC; ++e) {
    float v = 0.f;
    if (e < n) {
      const bool is_a = g.et[e] == ta;
      v = zi + in.nj[(b * N + g.j[e]) * H2 + c] + (is_a ? eta : etb);
#pragma unroll
      for (int r = 0; r < R; ++r) v += g.rbf[e][r] * (is_a ? wa[r] : wb[r]);
    }
    z[e][c] = v;
  }
"""
# the sources' nj of the chunk's slots gathered first, all in flight together
GATHER_FIRST = """  for (int e = n; e < KC; ++e) z[e][c] = 0.f;
  float nj[KC];
#pragma unroll
  for (int e = 0; e < KC; ++e) nj[e] = e < n ? in.nj[(b * N + g.j[e]) * H2 + c] : 0.f;
  for (int ty = ta; ty < 4; ty += 2) {
    float w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = p.w_rbf[(ty * R + r) * H2 + c];
    const float wet = p.w_et[ty * H2 + c];
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      if (e >= n || g.et[e] != ty) continue;
      float v = zi + nj[e] + wet;
#pragma unroll
      for (int r = 0; r < R; ++r) v += g.rbf[e][r] * w[r];
      z[e][c] = v;
    }
  }
"""

# Each variant: groups of alternatives (old, new); in each group exactly one
# alternative's `old` occurs, once, in one of SOURCES, and is replaced.
VARIANTS = {
    "kernel": [],
    # mutant: the bar must hold the kernel and miss this
    "one_term": [
        [(SECOND_LAYERS, ONE_TERM + SECOND_LAYERS)],
        [("    if (half) tile_mma<kVT>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
          "    else tile_mma(acc, as, wk + 4 * qd * 32, kNTiles, lane);",
          "    if (half) one_term<kVT>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
          "    else one_term(acc, as, wk + 4 * qd * 32, kNTiles, lane);")]],
    # phases taken out (time only)
    "no_recompute": [
        [("      second_layers<V>(acc, s_a, s_buf, a.w2kf, a.w2vf, p, 2, t);",
          f"#pragma unroll\n      {OPAQUE}"),
         ("      if (active) {\n"
          "        if (is_k) second_layer(acc, s_a, 0, p.w2k, H, p.b2k[cc], cc);\n"
          "        else second_layer(acc, s_a, H, p.w2v, V, p.b2v[cc], cc);\n"
          "      }", f"#pragma unroll\n      {OPAQUE}")],
        [("      if (live) second_layers<V>(acc, s_a, s_buf, a.w2kf, a.w2vf, p, 1, t);",
          f"      if (live) {OPAQUE}"),
         ("      if (live && is_k) second_layer(acc, s_a, 0, p.w2k, H, p.b2k[cc], cc);",
          f"      if (live) {OPAQUE}")]],
    # the recompute's parts: its products (tile_mma), its activation split
    "no_products": [[("    if (half) tile_mma<kVT>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
                      "    else tile_mma(acc, as, wk + 4 * qd * 32, kNTiles, lane);",
                      "    (void)as;")]],
    "no_split": [[("    store_split_row(reinterpret_cast<uint32_t*>(buf + pr * kLdz), v, lane);",
                   "    (void)v;")]],
    "no_transposed": [[("""      for (int cl = 0; cl < C; cl += 4) {
        const float w0 = WT[(cl + 0) * H + m], w1 = WT[(cl + 1) * H + m],
                    w2 = WT[(cl + 2) * H + m], w3 = WT[(cl + 3) * H + m];
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          const float4 d4 = *reinterpret_cast<const float4*>(&s_d[e][doff + cl]);
          acc[e] += d4.x * w0 + d4.y * w1 + d4.z * w2 + d4.w * w3;
        }
      }""", "      for (int e = 0; e < KC; ++e) acc[e] = s_d[e][t];")]],
    "no_ln_bwd": [[("    for (int pair = warp; pair < 2 * n; pair += kThreads / 32) {",
                    "    for (int pair = warp; pair < 0; pair += kThreads / 32) {")]],
    "no_drbf": [[("    for (int pr = warp; pr < n * R; pr += kThreads / 32) {",
                  "    for (int pr = warp; pr < 0; pr += kThreads / 32) {"),
                 ("    drbf_chunk(s_drbf, &s_a[0][0], s_d, a.rbff, p.w_rbf, s_g.et, ta, n, t);\n",
                  "")]],
    # the recompute's first layer without its RBF-table sum (and the table's loads)
    "no_first_layer": [[("#pragma unroll\n      for (int r = 0; r < R; ++r) "
                         "v += g.rbf[e][r] * wr[r * H2];\n", "      (void)wr;\n"),
                        ("#pragma unroll\n      for (int r = 0; r < R; ++r) "
                         "v += g.rbf[e][r] * w[r];\n", "")]],
    # mutant: one TF32 product per term in d rbf
    "one_term_drbf": [[("        mma_tf32(d, al, b[nt].x, b[nt].y);\n"
                        "        mma_tf32(d, ah, b[nt].z, b[nt].w);\n", "")]],
    # design alternatives (right, timed): the d rbf k-step loop unrolled; the
    # first layer with both types' table columns in registers, selected per slot
    "unrolled_drbf": [[("#pragma unroll 1\n  for (int i = 0; i < kSteps; ++i) {",
                        "#pragma unroll\n  for (int i = 0; i < kSteps; ++i) {")]],
    "select_first_layer": [[(TWO_PASS, SELECT)]],
    # d rbf's B operand from the float32 table, split in the loop (option b)
    "fp32_table_drbf": [[("  return frags[((ta * kDrbfKSteps + ks) * kDrbfNTiles + nt) * 32 "
                          "+ lane];", "  return rbf_frag(w_rbf, ta, ks, nt, lane);")]],
    "no_edge_writes": [
        [("    for (int u = t; u < n * H2; u += kThreads) "
          "a.A[ec * H2 + u] = s_a[u / H2][u % H2];\n", "")],
        [("""    for (int u = t; u < n * (H + V); u += kThreads) {
      const int e = u / (H + V), cl = u % (H + V);
      a.dKV[(ec + e) * (H + V) + cl] = s_d[e][cl];
    }
""", "")],
        [("    for (int u = t; u < n * H2; u += kThreads) "
          "a.dZ[ec * H2 + u] = s_d[u / H2][u % H2];\n", "")],
        [("      a.F[(ec + e) * FE + f] = v;", "      (void)v;")],
        [("          a.drel[(ec + t) * 3 + k3] = d3[k3];\n", "")]],
    # one block per SM: the compiler's register limit doubles (no spills)
    "one_block_per_sm": [[("__launch_bounds__(kThreads, 2) edge_bwd_kernel",
                           "__launch_bounds__(kThreads, 1) edge_bwd_kernel")]],
    # latency alternatives (right, timed): d rbf with the next k-step's
    # fragments in flight; the first layer's source rows gathered before its
    # sums
    "drbf_prefetch": [[("""#pragma unroll 1
  for (int i = 0; i < kSteps; ++i) {
    const int ks = warp * kSteps + i;
    uint4 b[kDrbfNTiles];
#pragma unroll
    for (int nt = 0; nt < kDrbfNTiles; ++nt) b[nt] = drbf_frag(frags, w_rbf, ta, ks, nt, lane);""",
                        """  uint4 b[kDrbfNTiles], b2[kDrbfNTiles];
#pragma unroll
  for (int nt = 0; nt < kDrbfNTiles; ++nt)
    b2[nt] = drbf_frag(frags, w_rbf, ta, warp * kSteps, nt, lane);
#pragma unroll 1
  for (int i = 0; i < kSteps; ++i) {
    const int ks = warp * kSteps + i;
#pragma unroll
    for (int nt = 0; nt < kDrbfNTiles; ++nt) b[nt] = b2[nt];
#pragma unroll
    for (int nt = 0; nt < kDrbfNTiles; ++nt)
      b2[nt] = drbf_frag(frags, w_rbf, ta, i + 1 < kSteps ? ks + 1 : ks, nt, lane);""")]],
    "gather_first": [[(TWO_PASS, GATHER_FIRST)]],
    # the design not taken: the second layers staged once per cluster of
    # eight blocks in shared memory (edge_bwd_staged/, an overlay of whole
    # files: OVERLAYS)
    "staged_cluster8": [],
}
# Variants that replace whole files of the package's csrc with a directory's.
OVERLAYS = {"staged_cluster8": REPO / "edge_bwd_staged"}


def apply(texts: dict, groups) -> dict:
    """`texts` (file name -> source) with each group's one alternative replaced."""
    texts = dict(texts)
    for group in groups:
        hits = [(f, old, new) for old, new in group for f in texts if texts[f].count(old) == 1]
        if len(hits) != 1 or sum(t.count(hits[0][1]) for t in texts.values()) != 1:
            raise ValueError(f"{', '.join(texts)} hold {len(hits)} of these, not one:\n"
                             + "\n---\n".join(old for old, _ in group))
        f, old, new = hits[0]
        texts[f] = texts[f].replace(old, new)
    return texts


def make_copy(base: Path, root: Path, name: str, label: str = None) -> Path:
    """Variant `name` of the package in `base`, in root / label (default: name)."""

    def edit(csrc: Path):
        for f in OVERLAYS[name].iterdir() if name in OVERLAYS else ():
            shutil.copy(f, csrc / f.name)
        texts = {f: (csrc / f).read_text() for f in SOURCES}
        for f, text in apply(texts, VARIANTS[name]).items():
            (csrc / f).write_text(text)

    return vh.make_copy(base, root, label or name, edit)


def measure(copy: Path, name: str, out_file: Path) -> dict:
    """The variant in `copy`: its edge kernels' device time in one block
    backward at the B=32 step's shapes and, for ERRORS, chip_smoke.margins;
    that backward's outputs go to out_file."""
    sys.path.insert(0, str(copy))
    import torch

    import chip_smoke as cs
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    feat = FeaturizeProteinAtom()
    tb, tmodel, *_ = cs.train_setup(torch, dev, feat.feature_dim)
    rn = tmodel.net.refine_net
    with torch.no_grad():
        h, x, node_mask, mlig = tmodel.net.embed(*tb)
        nbh = G.knn_graph(x, node_mask, cs.K)
        e_w = rn.edge_weights(x, nbh)[..., 0]
        x2h, h2x = kblock.pack_pass_params(rn)
        hck, xck = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, cs.MAX_LIGAND,
                                                    x2h, h2x)
    gen = torch.Generator(device=dev).manual_seed(0)
    gh = torch.randn(h.shape, generator=gen, device=dev)
    gx = torch.randn(x.shape, generator=gen, device=dev)

    def bwd():
        return kvjp.block_bwd_cuda(hck, xck, nbh.idx, nbh.mask, mlig, e_w, cs.MAX_LIGAND, x2h,
                                   h2x, gh, gx)

    with torch.no_grad():
        dh0, dx0, dew, gx2h, gh2x = bwd()
    outputs = {"dh0": dh0, "dx0": dx0, "de_w": dew,
               **{f"x2h.{k}": v for k, v in gx2h.items()},
               **{f"h2x.{k}": v for k, v in gh2x.items()}}
    torch.save({k: v.cpu() for k, v in outputs.items()}, out_file)
    L = cs.FLAGSHIP["num_layers"]
    out = {"variant": name, "block_bwd_b32_ms": cs.cuda_ms(torch, bwd, reps=5)}
    for key, ms in cs.bwd_device_ms(torch, "b32", bwd, calls=5).items():
        out[key.replace("_device_ms", "_device_ms_per_launch")] = ms / L
    del hck, xck, tb, tmodel, rn, x2h, h2x
    torch.cuda.empty_cache()
    if name in ERRORS:
        data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
        pocket = {"protein_pos": data["protein_pos"],
                  "protein_feat": data["protein_atom_feature"]}
        out["margins"] = cs.margins(torch, dev, pocket, feat.feature_dim, check=False)
    out["ptxas"] = vh.ptxas({k: ("block_vjp", f"edge_bwd_kernelILb{b}E")
                             for k, b in (("x2h", 0), ("h2x", 1))})
    if hasattr(kvjp, "edge_bwd_info"):
        out["edge_bwd_info"] = {k: kvjp.edge_bwd_info(cs.K, k == "h2x") for k in ("x2h", "h2x")}
    return out


def main(argv) -> int:
    base, parent = REPO, None
    while argv[:1] in (["--base"], ["--parent"]):
        path = Path(argv[1]).resolve()
        base, parent = (path, parent) if argv[0] == "--base" else (base, path)
        argv = argv[2:]

    def diffs(root: Path, order: list):
        import torch

        ref = "parent" if parent is not None else "kernel"
        want = torch.load(root / f"{ref}.pt")
        out = {}
        for n in dict.fromkeys(order):
            got = torch.load(root / f"{n}.pt")
            out[n] = max(float((got[k] - want[k]).abs().max()) for k in want)
        print(json.dumps({"outputs_max_abs_diff_from": ref, "max_abs_diff": out}), flush=True)

    return vh.main(__file__, argv, VARIANTS, lambda root, n: make_copy(base, root, n), measure,
                   parent=None if parent is None else
                   ("parent", lambda root: make_copy(parent, root, "kernel", "parent")),
                   header={"base": str(base), "parent": str(parent)}, finish=diffs)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
