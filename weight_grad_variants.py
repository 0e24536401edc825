#!/usr/bin/env python3
"""Variants of the weight-gradient kernel and its split-K reduction
(targetdiff_tpu_torch/csrc/weight_grad.cuh) on one NVIDIA GPU: the mutation
check of its accuracy bar and ablations of its design, each held against the
unchanged kernel in one run.

    python3 weight_grad_variants.py [--parent CHECKOUT] [VARIANT ...]

Each variant is a temporary copy of targetdiff_tpu_torch whose
weight_grad.cuh is changed by VARIANTS; the copies are built in parallel and
measured one after the other, the unchanged kernel first and last (with
--parent, CHECKOUT's package before them). On the products of chip_smoke.py's
[train-block weight-grad] (the B=32 step's shapes, operands made the same
way) each prints the largest error over s, the root-sum-square of an entry's
terms, against float64 (the bar is chip_smoke.WG_BAR), a digest of each
product's output (equal digests: bitwise equal), and for the products in
TIMED the CUDA-event ms of one call (the product and its reduction, as run_pass
runs them) and the profiler device time of each kernel of it, with the
kernel's registers and spills from `-Xptxas -v`. One JSON line per variant,
the card's name and power limit first, then which variants' digests equal
the first's (the parent's with --parent). Needs a CUDA device and nvcc.

The cluster variants change the float32 instantiation's cluster size
(kWgCluster); the bf16 one launches without clusters (kWgClusterBf16 = 1)
unless `bf16_cluster2` gives it clusters of 2. `cluster1` sums in the order
before clusters (kWgCluster = kRedGroups = 1): its digests must equal those
of a parent without clusters, in both precisions. The last-cluster
alternative (an atomic ticket choosing one cluster to sum a tile's partials)
is not built: at the train step's x2h w2k shape the last cluster, two SMs,
would read the tile's 131 partials (8.6 MB; 30 of 8 SMs, 2 MB, at clusters
of 8), longer than the reduction launch it removes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

KERNEL = "weight_grad.cuh"
TIMED = ("x2h_edge w2k", "x2h_edge table", "h2x_edge w2k", "node w_node x2h", "node w_q2 x2h")

SPLIT = """  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
"""
THREE_TERMS = """      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, al, bh[j][0], bh[j][1]);
      mma_tf32(d, ah, bl[j][0], bl[j][1]);
      mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += d[c];
"""
LAUNCH = """  WgPlan plan;
  if (int err = wg_plan_for<kBf16>(M, P, Q, plan)) return err;
  cudaLaunchConfig_t cfg = {};
"""
SMEM_ATTR = """    err = (int)cudaFuncSetAttribute(weight_grad_kernel<kBf16>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
"""
TRIGGER = """  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
"""
# The fold of the first cluster design: each block stores its whole tile in
# its ring, and each rank reads its rows from every peer (distributed shared
# memory), ranks ascending: the same sums, twice the shared-memory traffic.
FOLD_START = "  namespace cg = cooperative_groups;\n  constexpr int R"
FOLD_END = "\n}\n\n// partial[z] = X[rows of chunk z]"
PULL_FOLD = """  const int t = threadIdx.x;
  constexpr int R = kWgTile / C;
  __syncthreads();  // every warp is done with the ring: it takes the tile
#pragma unroll
  for (int i = 0; i < kWgMT; ++i) {
#pragma unroll
    for (int j = 0; j < kWgNT; ++j) {
      float* c = smem + (wp + i * 16 + gid) * kWgFoldLd + wq + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + 8 * kWgFoldLd) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  float* out = partial + (size_t)(blockIdx.z / C) * P * Q;
#pragma unroll
  for (int u = 0; u < R * kWgTile / 4 / kThreads; ++u) {
    const int i = t + u * kThreads;
    const int r = rank * R + i / (kWgTile / 4), c = i % (kWgTile / 4) * 4;
    float4 v[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      v[k] = *cluster.map_shared_rank(reinterpret_cast<float4*>(smem + r * kWgFoldLd + c), k);
    float4 sum = v[0];
#pragma unroll
    for (int k = 1; k < C; ++k) {
      sum.x += v[k].x;
      sum.y += v[k].y;
      sum.z += v[k].z;
      sum.w += v[k].w;
    }
    const int p = p0 + r, q = q0 + c;
    if (p < P && q < Q) *reinterpret_cast<float4*>(out + (size_t)p * Q + q) = sum;
  }
  cluster.sync();"""


def between(text: str, start: str, end: str, new: str) -> str:
    """`text` with what lies from `start` up to `end` (each held once)
    replaced by `new`."""
    a = vh.patch(text, start, start).index(start)
    b = vh.patch(text, end, end).index(end)
    return text[:a] + new + text[b:]


# The float32 FMA kernel this one replaced (8x8 outputs per thread, one
# 8-row shared buffer) with its chunking: the control of the mutation check.
FMA_KERNEL = """
__global__ void __launch_bounds__(kThreads)
atb_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y, int ldy,
           long long M, int P, int Q, long long chunk, float* __restrict__ partial) {
  __shared__ __align__(16) float sx[8][128];
  __shared__ __align__(16) float sy[8][128];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int p0 = blockIdx.x * 128, q0 = blockIdx.y * 128;
  const long long mb = blockIdx.z * chunk;
  const long long me = mb + chunk < M ? mb + chunk : M;
  float acc[8][8] = {};
  for (long long m0 = mb; m0 < me; m0 += 8) {
    for (int u = t; u < 8 * 128; u += kThreads) {
      const int mm = u / 128, c = u % 128;
      const long long m = m0 + mm;
      sx[mm][c] = (m < me && p0 + c < P) ? X[m * ldx + p0 + c] : 0.f;
      sy[mm][c] = (m < me && q0 + c < Q) ? Y[m * ldy + q0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < 8; ++mm) {
      float xv[8], yv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xv[i] = sx[mm][(i < 4 ? 0 : 64) + ty * 4 + i % 4];
        yv[i] = sy[mm][(i < 4 ? 0 : 64) + tx * 4 + i % 4];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * yv[j];
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.z * P * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pp = p0 + (i < 4 ? 0 : 64) + ty * 4 + i % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qq = q0 + (j < 4 ? 0 : 64) + tx * 4 + j % 4;
      if (pp < P && qq < Q) out[(size_t)pp * Q + qq] = acc[i][j];
    }
  }
}

long long fma_chunks(long long M, long long tiles, long long n) {
  long long s = (M + 255) / 256;
  const long long target = (528 + tiles - 1) / tiles;
  if (s > target) s = target;
  if (s > kPartialCap / n) s = kPartialCap / n;
  return s < 1 ? 1 : s;
}

"""


VARIANTS = {
    "kernel": lambda s: s,
    # mutants: the bar must hold the kernel and the FMA kernel, and miss these
    "one_term": lambda s: patch(s, THREE_TERMS, THREE_TERMS.replace(
        "      mma_tf32(d, al, bh[j][0], bh[j][1]);\n"
        "      mma_tf32(d, ah, bl[j][0], bl[j][1]);\n", "")),
    "mma_accumulator": lambda s: patch(s, THREE_TERMS, """      mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
      mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
      mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
"""),
    # the FMA kernel, one partial a chunk, through the same reduction
    "fma_atb": lambda s: patch(patch(s, "bool aligned16(", FMA_KERNEL + "bool aligned16("), LAUNCH,
                               """  const int tp = (P + kWgTile - 1) / kWgTile;
  const int tq = (Q + kWgTile - 1) / kWgTile;
  const long long S = fma_chunks(M, (long long)tp * tq, (long long)P * Q);
  atb_kernel<<<dim3(tp, tq, (unsigned)S), kThreads, 0, s>>>(X, ldx, Y, ldy, M, P, Q,
                                                           (M + S - 1) / S, partial);
  if (int err = (int)cudaGetLastError()) return err;
  return reduce_partials(partial, (int)S, (long long)P * Q, out, s);
  WgPlan plan;
  cudaLaunchConfig_t cfg = {};
"""),
    # ablations of the design
    "cvt_rna": lambda s: patch(s, SPLIT, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
"""),
    "checked_tiles": lambda s: patch(s, "    if (mt == MT && nt == NT) {", "    if (false) {"),
    "two_stages": lambda s: patch(s, "constexpr int kWgStages = 3;", "constexpr int kWgStages = 2;"),
    "four_stages": lambda s: patch(s, "constexpr int kWgStages = 3;",
                                   "constexpr int kWgStages = 4;"),
    # the split-K sum: the order before clusters (one partial a chunk through
    # device memory, summed in chunk order from zero), a cluster of 16
    # (non-portable), the reduction's ranges, and its launch in plain order
    "cluster1": lambda s: patch(patch(s, "constexpr int kWgCluster = 2;",
                                      "constexpr int kWgCluster = 1;"),
                                "constexpr int kRedGroups = 8;", "constexpr int kRedGroups = 1;"),
    "cluster16": lambda s: patch(patch(s, "constexpr int kWgCluster = 2;",
                                       "constexpr int kWgCluster = 16;"), SMEM_ATTR, SMEM_ATTR + """\
    if (!err && kWgClusterOf<kBf16> > 8)  // a non-portable cluster size
      err = (int)cudaFuncSetAttribute(weight_grad_kernel<kBf16>,
                                      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
"""),
    "groups1": lambda s: patch(s, "constexpr int kRedGroups = 8;", "constexpr int kRedGroups = 1;"),
    "groups16": lambda s: patch(s, "constexpr int kRedGroups = 8;",
                                "constexpr int kRedGroups = 16;"),
    "no_pdl": lambda s: patch(s, "at[0].val.programmaticStreamSerializationAllowed = 1;",
                              "at[0].val.programmaticStreamSerializationAllowed = 0;"),
    "cluster4": lambda s: patch(s, "constexpr int kWgCluster = 2;",
                                "constexpr int kWgCluster = 4;"),
    "cluster8": lambda s: patch(s, "constexpr int kWgCluster = 2;",
                                "constexpr int kWgCluster = 8;"),
    # the reduction alone: no fold (one partial a chunk), kRedGroups ranges
    "cluster1_groups8": lambda s: patch(s, "constexpr int kWgCluster = 2;",
                                        "constexpr int kWgCluster = 1;"),
    # cluster1 launched as before clusters: no early trigger, the reduction
    # in plain stream order (a cluster of 1 is launched without clusters)
    "cluster1_plain": lambda s: patch(patch(VARIANTS["cluster1"](s), TRIGGER, ""),
                                      "SerializationAllowed = 1;", "SerializationAllowed = 0;"),
    # the bf16 instantiation in clusters of 2, as float32
    "bf16_cluster2": lambda s: patch(s, "constexpr int kWgClusterBf16 = 1;",
                                     "constexpr int kWgClusterBf16 = 2;"),
    "no_trigger": lambda s: patch(s, TRIGGER, ""),
    "pull_fold": lambda s: between(s, FOLD_START, FOLD_END, PULL_FOLD),
    "min_rows128": lambda s: patch(s, "constexpr long long kWgMinRows = 256;",
                                   "constexpr long long kWgMinRows = 128;"),
}


def make_copy(root: Path, name: str) -> Path:
    return vh.make_copy(vh.REPO, root, name,
                        lambda csrc: vh.rewrite(csrc / KERNEL, VARIANTS[name]))


# the kernels of a product's call, by a piece of their names; reduce_kernel
# is this library's, not PyTorch's at::native one
PIECES = {"weight_grad": ("weight_grad_kernel", "atb_kernel"),
          "reduce": ("(anonymous namespace)::reduce_kernel",)}


def measure(copy: Path, name: str, out_file=None) -> dict:
    """The variant in `copy` on chip_smoke.py's weight-gradient products,
    float32 and (`bf16_` fields) bf16."""
    sys.path.insert(0, str(copy))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    def timed(fn) -> dict:
        f = {"ms": cs.cuda_ms(torch, fn)}
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        times = cs.device_times(prof, 20).items()
        for part, pieces in PIECES.items():
            f[f"{part}_device_ms"] = sum(v["ms"] for k, v in times
                                         if any(pc in k for pc in pieces))
        return f

    out = {}
    for cls, pname, M, P, Q, X, Y in cs.weight_grad_operands(torch, dev):
        got = kwg.weight_grad_cuda(X, Y)
        again = kwg.weight_grad_cuda(X, Y)
        got16, again16 = [kwg.weight_grad_cuda(X, Y, dtype=torch.bfloat16) for _ in range(2)]
        x, y = X.double(), Y.double()
        err = ((got.double() - x.T @ y).abs() / ((x * x).T @ (y * y)).sqrt()).max()
        key = f"{cls} {pname}"
        out[key] = {"err_over_s": float(err), "digest": cs.digest(torch, got),
                    "repeats_bitwise": bool(torch.equal(got, again)),
                    "bf16_digest": cs.digest(torch, got16),
                    "bf16_repeats_bitwise": bool(torch.equal(got16, again16))}
        if hasattr(kwg, "plan"):  # a parent before clusters has none
            out[key]["plan"] = kwg.plan(M, P, Q)
            out[key]["bf16_plan"] = kwg.plan(M, P, Q, torch.bfloat16)
        del x, y
        if key in TIMED:
            out[key].update(timed(lambda: kwg.weight_grad_cuda(X, Y, got)))
            out[key].update({f"bf16_{k}": v for k, v in timed(lambda: kwg.weight_grad_cuda(
                X, Y, got16, dtype=torch.bfloat16)).items()})
    ptxas = vh.ptxas({"float32": ("block_vjp", "atb_kernel")} if name == "fma_atb" else {
        "float32": ("block_vjp", "weight_grad_kernelILb0"),
        "bf16": ("block_vjp", "weight_grad_kernelILb1")})
    return {"variant": name, "ptxas": ptxas,
            "worst_err_over_s": max(v["err_over_s"] for v in out.values()), "products": out}


def main(argv) -> int:
    parent = None
    if argv[:1] == ["--parent"]:
        parent, argv = Path(argv[1]).resolve(), argv[2:]
    results = {}

    def measure_and_keep(copy: Path, name: str, out_file=None) -> dict:
        res = measure(copy, name, out_file)
        Path(out_file).write_text(json.dumps(res))
        return res

    def same_digests(root: Path, order: list):
        for n in dict.fromkeys(order):
            results[n] = json.loads((root / f"{n}.pt").read_text())
        ref = results[order[0]]["products"]
        print(json.dumps({"digests_equal_to": order[0], "equal": {
            n: {f"{k} {field}": r["products"][k].get(field) == v.get(field)
                for k, v in ref.items() for field in ("digest", "bf16_digest")}
            for n, r in results.items()}}), flush=True)

    return vh.main(__file__, argv, VARIANTS, make_copy, measure_and_keep,
                   parent=None if parent is None else
                   ("parent", lambda root: vh.make_copy(parent, root, "parent")),
                   header={"parent": str(parent)}, finish=same_digests)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
