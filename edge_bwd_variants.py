#!/usr/bin/env python3
"""Variants of the backward's edge kernel (edge_bwd_kernel in
targetdiff_tpu_torch/csrc/pass_bwd.cuh) on one NVIDIA GPU: the mutation check
of the backwards' float64 bars, a phase split of the kernel's time and the
design alternatives not taken, each variant held against the unchanged
kernel in one run.

    python3 edge_bwd_variants.py [--base CHECKOUT] [--parent CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of the targetdiff_tpu_torch package of
CHECKOUT (this checkout by default) whose pass_bwd.cuh or block_common.cuh
(the recompute's first layer) is changed by VARIANTS; the copies are built
in parallel and measured one after the other, the unchanged kernel first
and last. A phase
is taken out by skipping its loop or, for the recompute's second layers, by
loading its input in place of its output, so that nothing downstream folds
away; the results of those copies are wrong and only their times are read.
The alternatives are right and timed beside the kernel: the transposed
product's (`staged_tf32_transposed`, B option (a); `staged_result`;
`tprod_unroll2`, `tprod_prefetch`, `tprod_both_mtiles`), `dq_in_register`,
`edge_writes_unroll1`, `drbf_prefetch`, `gather_first`, `fp32_table_drbf`,
`unrolled_drbf`, `select_first_layer`. Each prints one JSON line: the
device ms per launch of edge_bwd_kernel<x2h> and <h2x> in one float32 and
one bf16 block backward at the B=32 train step's shapes (chip_smoke.py
train_setup; N = 416, K = 32, L = 9), those backwards' CUDA-event ms, the
transposed product alone (chip_smoke.tprod_phase: device ms and error at
the same step's edges, both precisions), the four instantiations'
registers, spills and shared memory from `-Xptxas -v`, blocks per SM
(block_vjp.edge_bwd_info) and, for the unchanged kernel and the mutants,
chip_smoke.margins (the gradients of
[train-block] and [layers]' hybrid backwards against float64, bars
chip_smoke.BWD64_MEDIAN and BWD64_BAR). With --parent, the unchanged kernel
of that checkout runs first too, and a last line gives every variant's
largest difference from its backward outputs (dh0, dx0, d e_w and every
weight gradient at those shapes, float32 and bf16; 0: bitwise equal);
without, from the
unchanged kernel's. The card's name and power limit come first. Patches
that name the earlier FMA recompute, d rbf loop or first layer apply to a
checkout from before those changes (--base), so one command splits both.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import variant_harness as vh

REPO = vh.REPO
SOURCES = ("pass_bwd.cuh", "block_common.cuh")  # the files a variant may change
# variants whose gradients are held to float64
ERRORS = ("kernel", "one_term", "one_term_drbf", "one_term_transposed")

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
SECOND_LAYERS = ("template <int V, bool kBf16 = false>\n"
                 "__device__ __forceinline__ void second_layers(")
SECOND_LAYERS_OLD = "template <int V>\n__device__ __forceinline__ void second_layers("
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
# the float32 transposed product's loads of W2^T, split in registers
TPROD_F32_LOADS = """    const float* wt = w + tig * H + g;  // b0 = W2^T[8 ks + tig][8 nt + g], b1 4 rows down
#pragma unroll 1
    for (int ks = 0; ks < C / 8; ++ks) {
      uint4 b[4];  // (b0 hi, b1 hi, b0 lo, b1 lo)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(wt[8 * ks * H + 8 * nt], b[nt].x, b[nt].z);
        split_tf32(wt[(8 * ks + 4) * H + 8 * nt], b[nt].y, b[nt].w);
      }"""
# the float32 transposed product's k-step body after its fragments' loads
TPROD_F32_BODY = """      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = d + (16 * mt + g) * kLdd + 8 * ks + tig;
        split_tf32(ar[0], ah[mt][0], al[mt][0]);
        split_tf32(ar[8 * kLdd], ah[mt][1], al[mt][1]);
        split_tf32(ar[4], ah[mt][2], al[mt][2]);
        split_tf32(ar[8 * kLdd + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, al[mt], b[nt].x, b[nt].y);
          mma_tf32(p, ah[mt], b[nt].z, b[nt].w);
          mma_tf32(p, ah[mt], b[nt].x, b[nt].y);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] += p[c];
        }
      }"""
# the same, the kernel's form: one m-tile's A split at a time
TPROD_F32_MT_OUTER = """#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ah[4], al[4];
        const float* ar = d + (16 * mt + g) * kLdd + 8 * ks + tig;
        split_tf32(ar[0], ah[0], al[0]);
        split_tf32(ar[8 * kLdd], ah[1], al[1]);
        split_tf32(ar[4], ah[2], al[2]);
        split_tf32(ar[8 * kLdd + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, al, b[nt].x, b[nt].y);
          mma_tf32(p, ah, b[nt].z, b[nt].w);
          mma_tf32(p, ah, b[nt].x, b[nt].y);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] += p[c];
        }
      }"""
# the per-edge row writes of a live chunk
EDGE_WRITE_A = "    for (int u = t; u < n * H2; u += kThreads) a.A[ec * H2 + u] = s_a[u / H2][u % H2];\n"
EDGE_WRITE_DZ = "    for (int u = t; u < n * H2; u += kThreads) a.dZ[ec * H2 + u] = s_d[u / H2][u % H2];\n"
EDGE_WRITE_DKV = "    for (int u = t; u < n * (H + V); u += kThreads) {\n"
# the recompute's products as second_layers calls them (float32)
RECOMPUTE_TILES = """      if (half) tile_mma<kVT>(acc, as, f + kW2Frags + 4 * qd * 32, V / 8, lane);
      else tile_mma<4>(acc, as, f + 4 * qd * 32, kNTiles, lane);"""
# the parent's transposed second layers: the FMA loop of PRs 1-3, bf16 weights rounded in it
FMA_LOOP_BF16 = """      for (int cl = 0; cl < C; cl += 4) {
        float w0 = WT[(cl + 0) * H + m], w1 = WT[(cl + 1) * H + m],
              w2 = WT[(cl + 2) * H + m], w3 = WT[(cl + 3) * H + m];
        if constexpr (kBf16) {
          w0 = round_bf16(w0);
          w1 = round_bf16(w1);
          w2 = round_bf16(w2);
          w3 = round_bf16(w3);
        }
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          const float4 d4 = *reinterpret_cast<const float4*>(&s_d[e][doff + cl]);
          acc[e] += d4.x * w0 + d4.y * w1 + d4.z * w2 + d4.w * w3;
        }
      }"""

# Each variant: groups of alternatives (old, new); in each group exactly one
# alternative's `old` occurs, once, in one of SOURCES, and is replaced.
VARIANTS = {
    "kernel": [],
    # mutant: the bar must hold the kernel and miss this
    "one_term": [
        [(SECOND_LAYERS, ONE_TERM + SECOND_LAYERS),
         (SECOND_LAYERS_OLD, ONE_TERM + SECOND_LAYERS_OLD)],
        [(RECOMPUTE_TILES, RECOMPUTE_TILES.replace("tile_mma<4>", "one_term")
          .replace("tile_mma<kVT>", "one_term<kVT>")),
         ("    if (half) tile_mma<kVT>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
          "    else tile_mma(acc, as, wk + 4 * qd * 32, kNTiles, lane);",
          "    if (half) one_term<kVT>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
          "    else one_term(acc, as, wk + 4 * qd * 32, kNTiles, lane);")]],
    # mutant: one TF32 product per term in the transposed second layers
    "one_term_transposed": [[("          mma_tf32(p, al, b[nt].x, b[nt].y);\n"
                              "          mma_tf32(p, ah, b[nt].z, b[nt].w);\n", "")]],
    # phases taken out (time only)
    "no_recompute": [
        [("      second_layers<V, kBf16>(acc, s_a, s_buf, a.w2f, p, 2, t);",
          f"#pragma unroll\n      {OPAQUE}"),
         ("      second_layers<V, kBf16>(acc, s_a, s_buf, a.w2kf, a.w2vf, p, 2, t);",
          f"#pragma unroll\n      {OPAQUE}"),
         ("      second_layers<V>(acc, s_a, s_buf, a.w2kf, a.w2vf, p, 2, t);",
          f"#pragma unroll\n      {OPAQUE}"),
         ("      if (active) {\n"
          "        if (is_k) second_layer(acc, s_a, 0, p.w2k, H, p.b2k[cc], cc);\n"
          "        else second_layer(acc, s_a, H, p.w2v, V, p.b2v[cc], cc);\n"
          "      }", f"#pragma unroll\n      {OPAQUE}")],
        [("      if (live) second_layers<V, kBf16>(acc, s_a, s_buf, a.w2f, p, 1, t);",
          f"      if (live) {OPAQUE}"),
         ("      if (live) second_layers<V, kBf16>(acc, s_a, s_buf, a.w2kf, a.w2vf, p, 1, t);",
          f"      if (live) {OPAQUE}"),
         ("      if (live) second_layers<V>(acc, s_a, s_buf, a.w2kf, a.w2vf, p, 1, t);",
          f"      if (live) {OPAQUE}"),
         ("      if (live && is_k) second_layer(acc, s_a, 0, p.w2k, H, p.b2k[cc], cc);",
          f"      if (live) {OPAQUE}")]],
    # the recompute's parts: its products (tile_mma), its activation split
    "no_products": [[(RECOMPUTE_TILES, "      (void)as;"),
                     ("    if (half) tile_mma<kVT, kBf16>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
                      "    else tile_mma<4, kBf16>(acc, as, wk + 4 * qd * 32, kNTiles, lane);",
                      "    (void)as;"),
                     ("    if (half) tile_mma<kVT>(acc, as, wv + 4 * qd * 32, V / 8, lane);\n"
                      "    else tile_mma(acc, as, wk + 4 * qd * 32, kNTiles, lane);",
                      "    (void)as;")]],
    "no_split": [[("    store_split_row<kBf16>(reinterpret_cast<uint32_t*>(buf + pr * kLdz), v, "
                   "lane);", "    (void)v;"),
                  ("    store_split_row(reinterpret_cast<uint32_t*>(buf + pr * kLdz), v, lane);",
                   "    (void)v;")]],
    # the transposed second layers taken out (da is then the activations a)
    "no_transposed": [[("    transposed_layers<V, kBf16>(s_a, s_d, a.w2f, t);\n", ""),
                       (FMA_LOOP_BF16, "      for (int e = 0; e < KC; ++e) acc[e] = s_d[e][t];"),
                       ("""      for (int cl = 0; cl < C; cl += 4) {
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
    "no_drbf": [[("    drbf_chunk<kBf16>(s_drbf, &s_a[0][0], s_d, a.rbff, p.w_rbf, s_g.et, ta, n, t);\n",
                  ""),
                 ("    for (int pr = warp; pr < n * R; pr += kThreads / 32) {",
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
    # register pressure of the transposed product (spills, time): its k-step
    # loops unrolled twice; not unrolled but with the next k-step's fragments
    # in flight; float32 with both m-tiles' A split before the products
    "tprod_unroll2": [[("#pragma unroll 1\n    for (int ks = 0; ks < C / 16; ++ks) {",
                        "#pragma unroll 2\n    for (int ks = 0; ks < C / 16; ++ks) {")],
                      [("#pragma unroll 1\n    for (int ks = 0; ks < C / 8; ++ks) {",
                        "#pragma unroll 2\n    for (int ks = 0; ks < C / 8; ++ks) {")]],
    "tprod_prefetch": [[("""#pragma unroll 1
    for (int ks = 0; ks < C / 16; ++ks) {
      uint2 b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = w[(ks * kNTiles + nt) * 32 + lane];""", """    uint2 bn[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bn[nt] = w[nt * 32 + lane];
#pragma unroll 1
    for (int ks = 0; ks < C / 16; ++ks) {
      uint2 b[4];
      const int kn = ks + 1 < C / 16 ? ks + 1 : ks;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt] = bn[nt];
        bn[nt] = w[(kn * kNTiles + nt) * 32 + lane];
      }""")], [(TPROD_F32_LOADS, """    float bn[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      bn[nt][0] = wt[8 * nt];
      bn[nt][1] = wt[4 * H + 8 * nt];
    }
#pragma unroll 1
    for (int ks = 0; ks < C / 8; ++ks) {
      uint4 b[4];  // (b0 hi, b1 hi, b0 lo, b1 lo)
      const int kn = ks + 1 < C / 8 ? ks + 1 : ks;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(bn[nt][0], b[nt].x, b[nt].z);
        split_tf32(bn[nt][1], b[nt].y, b[nt].w);
        bn[nt][0] = wt[8 * kn * H + 8 * nt];
        bn[nt][1] = wt[(8 * kn + 4) * H + 8 * nt];
      }""")]],
    "tprod_both_mtiles": [[(TPROD_F32_MT_OUTER, TPROD_F32_BODY)]],
    # the float32 product's B operand, option (a): W2^T staged as TF32 (hi,
    # lo) fragments (twice the L2 bytes, no splits in the loop) in place of
    # the float32 transposes the kernel splits where it reads them (option (b))
    "staged_tf32_transposed": [
        [("constexpr int kW2Staged = 4 * kW2Frags;", "constexpr int kW2Staged = 6 * kW2Frags;")],
        [("""    float* wt = reinterpret_cast<float*>(f + 2 * kW2Frags);
    for (int u = t; u < (H + V) * H; u += n) {  // wt[c][m] = W2[m][c], k then v
      const int c = u / H, m = u % H;
      wt[u] = c < H ? p.w2k[m * H + c] : p.w2v[m * V + c - H];
    }""", """    for (int u = t; u < 4 * kW2Frags; u += n) {  // W2^T as TF32 (hi, lo), both halves
      const int half = u / (2 * kW2Frags), v = u % (2 * kW2Frags), C = half ? V : H;
      if (v >= C / 8 * kNTiles * 32) continue;
      const int ks = v / (kNTiles * 32), nt = v / 32 % kNTiles, fl = v % 32;
      const float* w = (half ? p.w2v : p.w2k) + (8 * nt + (fl >> 2)) * C + 8 * ks + (fl & 3);
      uint32_t h0, l0, h1, l1;
      split_tf32(w[0], h0, l0);
      split_tf32(w[4], h1, l1);
      f[(2 + 2 * half) * kW2Frags + v] = make_uint4(h0, h1, l0, l1);
    }""")],
        [("""    const float* w = reinterpret_cast<const float*>(f + 2 * kW2Frags) + half * H * H + n0;""",
          """    const float* w = reinterpret_cast<const float*>(f + (2 + 2 * half) * kW2Frags + n0 / 8 * 32);""")],
        [(TPROD_F32_LOADS, """    (void)tig;
#pragma unroll 1
    for (int ks = 0; ks < C / 8; ++ks) {
      uint4 b[4];  // (b0 hi, b1 hi, b0 lo, b1 lo)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        b[nt] = reinterpret_cast<const uint4*>(w)[(ks * kNTiles + nt) * 32 + lane];""")]],
    # register pressure elsewhere: dq kept in a register across the chunks
    # and stored once (the kernel sums each chunk's into the row buffer); the
    # per-edge write loops not unrolled
    "dq_in_register": [[("  // ---- pass 2: each chunk backward ----\n",
                         "  // ---- pass 2: each chunk backward ----\n  float dq = 0.f;\n")],
                       [("""    if (is_k) {
      float dq = 0.f;
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        const float al = s_alpha[e0 + e][head];
        const float dl = al * (s_w[e0 + e] * s_P[e0 + e][head] - s_dot[head]) * scale;
        dq += dl * s_buf[e * kLdc + cc];
      }
      rb[off_dq(V) + cc] += dq;
    }""", """    if (is_k) {
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        const float al = s_alpha[e0 + e][head];
        const float dl = al * (s_w[e0 + e] * s_P[e0 + e][head] - s_dot[head]) * scale;
        dq += dl * s_buf[e * kLdc + cc];
      }
    }""")],
                       [("  }\n}\n\n// transposed_layers alone", "  }\n  if (is_k) rb[off_dq(V) + cc] = dq;\n}\n\n// transposed_layers alone")]],
    "edge_writes_unroll1": [[(EDGE_WRITE_A, "#pragma unroll 1\n" + EDGE_WRITE_A)],
                            [(EDGE_WRITE_DZ, "#pragma unroll 1\n" + EDGE_WRITE_DZ)],
                            [(EDGE_WRITE_DKV, "#pragma unroll 1\n" + EDGE_WRITE_DKV)]],
    # the product's result passed through the third chunk buffer at row stride
    # kLdc (conflict-free stores) and copied to the activation rows, in place
    # of the C fragments' stores straight into them (4-way conflicts a store)
    "staged_result": [
        [("""    else transposed_tile<H, false>(acc, dhalf, w, lane);
  }
""", """    else transposed_tile<H, false>(acc, dhalf, w, lane);
  }
  float* buf = const_cast<float*>(&d[0][0]);
  __syncthreads();  // every warp has read d
""")],
        [("""        *reinterpret_cast<float2*>(&da[16 * mt + 8 * hf + g][half * H + n0 + 8 * nt + 2 * tig]) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
}""", """        *reinterpret_cast<float2*>(buf + (16 * mt + 8 * hf + g) * kLdc + half * H + n0 +
                                   8 * nt + 2 * tig) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
  __syncthreads();
  for (int u = t; u < KC * H2; u += kThreads) da[u / H2][u % H2] = buf[u / H2 * kLdc + u % H2];
}""")]],
}


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

    x2h16, h2x16 = (kblock.cast_pack(st, torch.bfloat16) for st in (x2h, h2x))
    with torch.no_grad():
        hck16, xck16 = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, cs.MAX_LIGAND,
                                                        x2h16, h2x16, torch.bfloat16)

    def bwd16():
        return kvjp.block_bwd_cuda(hck16, xck16, nbh.idx, nbh.mask, mlig, e_w, cs.MAX_LIGAND,
                                   x2h16, h2x16, gh, gx, torch.bfloat16)

    outputs = {}
    with torch.no_grad():
        for prefix, fn in (("", bwd), ("bf16.", bwd16)):
            dh0, dx0, dew, gx2h, gh2x = fn()
            outputs.update({f"{prefix}dh0": dh0, f"{prefix}dx0": dx0, f"{prefix}de_w": dew,
                            **{f"{prefix}x2h.{k}": v for k, v in gx2h.items()},
                            **{f"{prefix}h2x.{k}": v for k, v in gh2x.items()}})
    torch.save({k: v.cpu() for k, v in outputs.items()}, out_file)
    L = cs.FLAGSHIP["num_layers"]
    out = {"variant": name, "block_bwd_b32_ms": cs.cuda_ms(torch, bwd, reps=5),
           "bf16_block_bwd_b32_ms": cs.cuda_ms(torch, bwd16, reps=5)}
    for prefix, fn in (("", bwd), ("bf16_", bwd16)):
        for key, ms in cs.bwd_device_ms(torch, "b32", fn, calls=5).items():
            if key.startswith("edge_bwd"):
                out[prefix + key.replace("_device_ms", "_device_ms_per_launch")] = ms / L
    del hck, xck, hck16, xck16, tb, tmodel, rn, x2h, h2x, x2h16, h2x16
    torch.cuda.empty_cache()
    if hasattr(kvjp, "transposed_product_cuda"):  # the product alone (tprod_kernel)
        for prefix, dtype in (("", torch.float32), ("bf16_", torch.bfloat16)):
            try:
                tp = cs.tprod_phase(torch, dev, dtype)
            except AssertionError as err:  # a mutant or an ablation misses the bar
                out[prefix + "tprod"] = f"fails: {err}"
                continue
            out[prefix + "tprod"] = {sub: {k: f[k] for k in ("device_ms", "max_err_over_rss")}
                                     for sub, f in tp.items()}
    if name in ERRORS:
        data = pdb_to_pocket_data(str(cs.POCKET_PDB), feat)
        pocket = {"protein_pos": data["protein_pos"],
                  "protein_feat": data["protein_atom_feature"]}
        out["margins"] = cs.margins(torch, dev, pocket, feat.feature_dim, check=False)
    out["ptxas"] = vh.ptxas({f"{k}{p}": ("block_vjp", f"edge_bwd_kernelILb{b}ELb{q}E")
                             for k, b in (("x2h", 0), ("h2x", 1))
                             for p, q in (("", 0), ("_bf16", 1))})
    if hasattr(kvjp, "edge_bwd_info"):
        out["edge_bwd_info"] = {k + p: kvjp.edge_bwd_info(cs.K, k == "h2x", dt)
                                for k in ("x2h", "h2x")
                                for p, dt in (("", torch.float32), ("_bf16", torch.bfloat16))}
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
