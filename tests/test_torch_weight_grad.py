"""The weight-gradient kernel's arithmetic (targetdiff_tpu_torch/csrc/
weight_grad.cuh) replayed in plain PyTorch on the CPU: X^T Y over row chunks
of the kernel's length, each chunk walked in 8-row k-steps whose three TF32
products (lo*hi + hi*lo + hi*hi, operands rounded to TF32 by bit masks as
`cvt.rna` rounds) are summed into a zeroed tile and then added to the
float32 accumulator, the chunks' partials summed in ascending order. The
replay is held against float64 at the shapes of the backwards' five
products per pass (M cut to a few thousand rows), with columns from 1e-9 to
1e5, to the bar the kernel is held to on the card; a one-term TF32 product
and a three-term fp16 product without scaling miss it on the same inputs.
The plain version is held against the JAX package's `_cdotg`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.ops.pallas.edge_layer_vjp import _cdotg
from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

torch.set_num_threads(2)

# |got - want| <= WG_BAR * s elementwise, s[p][q] = sqrt(sum_m X[m][p]^2
# Y[m][q]^2) in float64 (chip_smoke.py [train-block], tests/test_torch_cuda.py)
WG_BAR = 1e-5
# csrc/weight_grad.cuh: output tile, rows per stage, rows per chunk at least,
# blocks aimed at, floats of partial scratch
TILE, STAGE_ROWS, MIN_ROWS, BLOCKS, PARTIAL_CAP = 128, 32, 256, 2 * 132, 1 << 22
KSTEP = 8  # rows per m16n8k8 product

# the five products of one pass (csrc/pass_bwd.cuh run_pass): name, M, P, Q;
# M cut to a few thousand rows, one not a multiple of a stage
SHAPES = [("w2k", 4096 + 7, 128, 128), ("w2v_h2x", 4096, 128, 16), ("table", 4096, 84, 256),
          ("w_node", 2048, 128, 640), ("w_q2", 2048, 128, 128)]


def tf32(a):
    """a rounded to TF32 in float32 as `cvt.rna.tf32.f32` rounds: to nearest,
    ties away from zero, on the 13 low mantissa bits (add half of the dropped
    part's range to the magnitude, clear the dropped bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_reference(a: np.ndarray) -> np.ndarray:
    """The same rounding in float64: |a| / ulp rounded half up, ulp = 2^-10 of
    the leading power of two (11 significant bits)."""
    x = a.astype(np.float64)
    _, e = np.frexp(np.abs(x))
    ulp = np.ldexp(1.0, e - 11)
    return (np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp).astype(np.float32)


def split3(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def f16(a):
    """a rounded to fp16 (nearest even, fp16's subnormals and overflow)."""
    return a.half().float()


def chunk_rows(M, P, Q):
    """Rows per chunk (csrc/weight_grad.cuh wg_chunk_rows)."""
    tiles = math.ceil(P / TILE) * math.ceil(Q / TILE)
    s = min(math.ceil(BLOCKS / tiles), PARTIAL_CAP // (P * Q))
    rows = max(math.ceil(M / s), MIN_ROWS)
    return math.ceil(rows / STAGE_ROWS) * STAGE_ROWS


def three_tf32(x, y):
    """One k-step's tile: lo*hi + hi*lo + hi*hi from zero, float32 (TF32
    products are exact in float32)."""
    (xh, xl), (yh, yl) = split3(x), split3(y)
    t = torch.bmm(xl.transpose(1, 2), yh)
    t = t + torch.bmm(xh.transpose(1, 2), yl)
    return t + torch.bmm(xh.transpose(1, 2), yh)


def one_tf32(x, y):
    return torch.bmm(tf32(x).transpose(1, 2), tf32(y))


def three_f16(x, y):
    """Three-term fp16 products without scaling (tc_common.cuh's split,
    without its weight and row scales)."""
    xh, yh = f16(x), f16(y)
    xl, yl = f16(x - xh), f16(y - yh)
    t = torch.bmm(xl.transpose(1, 2), yh)
    t = t + torch.bmm(xh.transpose(1, 2), yl)
    return t + torch.bmm(xh.transpose(1, 2), yh)


def replay(X, Y, kstep=three_tf32):
    """X^T Y as the kernel computes it: per chunk, 8-row k-steps (rows past
    the chunk zero) whose `kstep` tile is added to a float32 accumulator in
    order; the partials summed in ascending chunk order."""
    M, P = X.shape
    Q = Y.shape[1]
    rows = chunk_rows(M, P, Q)
    out = torch.zeros((P, Q))
    for m0 in range(0, M, rows):
        xc, yc = X[m0:m0 + rows], Y[m0:m0 + rows]
        pad = -len(xc) % KSTEP
        xc = torch.cat([xc, xc.new_zeros((pad, P))]).reshape(-1, KSTEP, P)
        yc = torch.cat([yc, yc.new_zeros((pad, Q))]).reshape(-1, KSTEP, Q)
        tiles = kstep(xc, yc)
        acc = torch.zeros((P, Q))
        for t in tiles:
            acc = acc + t
        out = out + acc
    return out


def inputs(M, P, Q, seed):
    """Zero-mean X [M, P], Y [M, Q] (float32) whose columns' scales span 1e-9
    to 1e5, in a seeded order."""
    rng = np.random.default_rng(seed)

    def make(n):
        scale = 10.0 ** rng.permutation(np.linspace(-9, 5, n))
        return (rng.standard_normal((M, n)) * scale).astype(np.float32)

    return make(P), make(Q)


def exact_and_scale(X, Y):
    """X^T Y in float64 and the root-sum-square of its terms, s."""
    x, y = X.astype(np.float64), Y.astype(np.float64)
    return x.T @ y, np.sqrt((x * x).T @ (y * y))


def rel_err(got, want, s):
    """The largest |got - want| / s (inf where got is not finite)."""
    got = np.asarray(got, dtype=np.float64)
    err = np.where(np.isfinite(got), np.abs(got - want), np.inf)
    return float((err / s).max())


def test_tf32_rounding_is_nearest_ties_away_from_zero():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    # exact ties: 1 + odd multiples of 2^-11 (half a TF32 ulp), both signs, any exponent
    odd = 2 * rng.integers(0, 1024, 2000) + 1
    ties = (np.ldexp(1.0 + odd * 2.0 ** -11, rng.integers(-60, 60, 2000))
            * rng.choice([-1.0, 1.0], 2000)).astype(np.float32)
    for v in (a, ties):
        got = tf32(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, tf32_reference(v))
        assert not (got.view(np.int32) & 0x1FFF).any()  # 10 explicit mantissa bits
    got = tf32(torch.from_numpy(ties)).numpy()
    assert (np.abs(got) > np.abs(ties)).all()  # every tie away from zero
    # x = hi + lo to 2^-22 of |x|
    hi, lo = split3(torch.from_numpy(a))
    resid = np.abs(a.astype(np.float64) - hi.numpy().astype(np.float64) - lo.numpy())
    assert (resid <= 2.0 ** -22 * np.abs(a.astype(np.float64))).all()


@pytest.mark.parametrize("name,M,P,Q", SHAPES, ids=[s[0] for s in SHAPES])
def test_three_term_tf32_replay_holds_the_bar(name, M, P, Q):
    X, Y = inputs(M, P, Q, seed=len(name) + M)
    want, s = exact_and_scale(X, Y)
    got = replay(torch.from_numpy(X), torch.from_numpy(Y))
    err = rel_err(got, want, s)
    assert err <= WG_BAR / 4, f"{name}: {err} of scale"  # float32-grade: ~2e-7 typical


@pytest.mark.parametrize("name,M,P,Q", SHAPES[:3], ids=[s[0] for s in SHAPES[:3]])
def test_one_term_tf32_and_unscaled_fp16_miss_the_bar(name, M, P, Q):
    X, Y = inputs(M, P, Q, seed=len(name) + M)
    want, s = exact_and_scale(X, Y)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    one = rel_err(replay(Xt, Yt, one_tf32), want, s)
    assert one > 10 * WG_BAR, f"one-term TF32: {one} of scale"  # ~3e-4
    # fp16 without scales: columns below fp16's range (6e-8 subnormal) are lost
    # and those above 65504 overflow
    fp16 = rel_err(replay(Xt, Yt, three_f16), want, s)
    assert fp16 > 10 * WG_BAR, f"three-term fp16: {fp16} of scale"
    small = np.abs(X).max(0) < 1e-6
    assert rel_err(replay(Xt[:, small], Yt, three_f16), want[small], s[small]) > 0.1


@pytest.mark.parametrize("name,M,P,Q", SHAPES, ids=[s[0] for s in SHAPES])
def test_plain_matches_jax_cdotg(name, M, P, Q):
    X, Y = inputs(M, P, Q, seed=7 + M)
    want, s = exact_and_scale(X, Y)
    got = kwg.weight_grad_plain(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
    ref = np.asarray(_cdotg(jnp.asarray(X), jnp.asarray(Y), jnp.float32))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (P, Q)
    # two float32 sums of the same M products: each within gamma_M |X|^T |Y| of exact
    gamma = M * 2.0 ** -24 / (1 - M * 2.0 ** -24)
    absprod = np.abs(X.astype(np.float64)).T @ np.abs(Y.astype(np.float64))
    assert (np.abs(got.astype(np.float64) - ref) <= 2 * gamma * absprod).all()
    assert rel_err(got, want, s) <= WG_BAR and rel_err(ref, want, s) <= WG_BAR


def test_weight_grad_cuda_refuses_cpu_tensors():
    X, Y = inputs(64, 128, 16, seed=0)
    before = dict(kwg.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kwg.weight_grad_cuda(torch.from_numpy(X), torch.from_numpy(Y))
    assert kwg.LAUNCHES == before


def test_chunks_follow_the_shape_only():
    """The chunking is a function of (M, P, Q): enough blocks for the card at
    the train step's edge counts, at least MIN_ROWS rows and a whole number of
    stages per chunk, the partials inside the scratch."""
    for M, P, Q in ((425_984, 128, 128), (425_984, 84, 256), (32_768, 128, 16),
                    (13_312, 128, 640), (425_991, 128, 128)):
        rows = chunk_rows(M, P, Q)
        S = math.ceil(M / rows)
        tiles = math.ceil(P / TILE) * math.ceil(Q / TILE)
        assert rows % STAGE_ROWS == 0 and rows >= MIN_ROWS
        assert S * P * Q <= PARTIAL_CAP
        if M >= BLOCKS * MIN_ROWS:
            assert BLOCKS * 0.9 <= S * tiles <= BLOCKS
