#!/usr/bin/env python3
"""Variants of the weight-gradient kernel (targetdiff_tpu_torch/csrc/weight_grad.cuh)
on one NVIDIA GPU: the mutation check of its accuracy bar and ablations of its
design, each held against the unchanged kernel in one run.

    python3 weight_grad_variants.py [VARIANT ...]

Each variant is a temporary copy of targetdiff_tpu_torch whose
weight_grad.cuh is changed by VARIANTS; the copies are built in parallel and
measured one after the other, the unchanged kernel first and last. On the
products of chip_smoke.py's [train-block weight-grad] (the B=32 step's
shapes, operands made the same way) each prints the largest error over s,
the root-sum-square of an entry's terms, against float64 (the bar is
chip_smoke.WG_BAR), and for the products in TIMED the CUDA-event and
profiler device time of one product (the product kernel alone), with the
kernel's registers and spills from `-Xptxas -v`. One JSON line per variant,
the card's name and power limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import sys
from pathlib import Path

import variant_harness as vh
from variant_harness import patch

KERNEL = "weight_grad.cuh"
TIMED = ("x2h_edge w2k", "x2h_edge table", "h2x_edge w2k", "node w_node x2h")

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
LAUNCH = """  const long long chunk = wg_chunk_rows(M, (long long)tp * tq, (long long)P * Q);
  const long long S = (M + chunk - 1) / chunk;
  weight_grad_kernel<<<dim3(tp, tq, (unsigned)S), kThreads, kWgSmem, s>>>(
      X, ldx, Y, ldy, M, P, Q, chunk, partial);
"""
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
    "fma_atb": lambda s: patch(patch(s, "bool aligned16(", FMA_KERNEL + "bool aligned16("), LAUNCH,
                               """  const long long S = fma_chunks(M, (long long)tp * tq, (long long)P * Q);
  const long long chunk = (M + S - 1) / S;
  atb_kernel<<<dim3(tp, tq, (unsigned)S), kThreads, 0, s>>>(X, ldx, Y, ldy, M, P, Q, chunk,
                                                           partial);
"""),
    # ablations of the design
    "cvt_rna": lambda s: patch(s, SPLIT, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
"""),
    "checked_tiles": lambda s: patch(s, "    if (mt == MT && nt == NT) {", "    if (false) {"),
    "two_stages": lambda s: patch(s, "constexpr int kWgStages = 3;", "constexpr int kWgStages = 2;"),
    "four_stages": lambda s: patch(s, "constexpr int kWgStages = 3;",
                                   "constexpr int kWgStages = 4;"),
}


def make_copy(root: Path, name: str) -> Path:
    return vh.make_copy(vh.REPO, root, name,
                        lambda csrc: vh.rewrite(csrc / KERNEL, VARIANTS[name]))


def measure(copy: Path, name: str, out_file=None) -> dict:
    """The variant in `copy` on chip_smoke.py's weight-gradient products."""
    sys.path.insert(0, str(copy))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    out = {}
    for cls, pname, M, P, Q, X, Y in cs.weight_grad_operands(torch, dev):
        got = kwg.weight_grad_cuda(X, Y)
        x, y = X.double(), Y.double()
        err = ((got.double() - x.T @ y).abs() / ((x * x).T @ (y * y)).sqrt()).max()
        key = f"{cls} {pname}"
        out[key] = {"err_over_s": float(err)}
        del x, y
        if key in TIMED:
            def fn():
                return kwg.weight_grad_cuda(X, Y, got)

            out[key]["ms"] = cs.cuda_ms(torch, fn)
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            out[key]["device_ms"] = sum(
                v["ms"] for k, v in cs.device_times(prof, 20).items()
                if "weight_grad_kernel" in k or "atb_kernel" in k)
    kernel = "atb_kernel" if name == "fma_atb" else "weight_grad_kernel"
    ptxas = vh.ptxas({"k": ("block_vjp", kernel)})["k"]
    return {"variant": name, "ptxas": ptxas,
            "worst_err_over_s": max(v["err_over_s"] for v in out.values()), "products": out}


def main(argv) -> int:
    return vh.main(__file__, argv, VARIANTS, make_copy, measure)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
