"""The weight-gradient kernel's arithmetic (targetdiff_tpu_torch/csrc/
weight_grad.cuh) replayed in plain PyTorch on the CPU: X^T Y over row chunks
of the kernel's length, each chunk walked in 8-row k-steps whose three TF32
products (lo*hi + hi*lo + hi*hi, operands rounded to TF32 by bit masks as
`cvt.rna` rounds) are summed into a zeroed tile and then added to the
float32 accumulator; then the split-K sum in the kernels' fixed order: the
chunks in clusters of C (padded with empty chunks), each cluster's partials
summed in rank order, then reduce_kernel's G ranges of the clusters'
partials, each summed in ascending order from zero, added in range order.
The replay is held against float64 at the shapes of the backwards' five
products per pass (M cut to a few thousand rows), with columns from 1e-9 to
1e5, to the bar the kernel is held to on the card, at the cluster sizes the
kernels use (2 in float32; 1, no cluster, in bf16, with the same ranges),
at 8 (the variant of weight_grad_variants.py) and at 1 with one range (the
order before clusters); a one-term TF32 product and a three-term fp16
product without scaling miss it on the same inputs. The plain version is
held against the JAX package's `_cdotg`."""

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
# floats of partial scratch, blocks a cluster (kWgCluster), reduce_kernel's
# ranges (kRedGroups)
TILE, STAGE_ROWS, MIN_ROWS, PARTIAL_CAP, CLUSTER, GROUPS = 128, 32, 256, 1 << 22, 2, 8
CLUSTER_BF16 = 1  # the bf16 instantiation's (kWgClusterBf16): no cluster
# clusters of C weight_grad_kernel blocks an NVIDIA H100 80GB HBM3 holds at
# once, by C (cudaOccupancyMaxActiveClusters as td_weight_grad_partials
# reads it on the card; weight_grad_variants.py prints it for each variant,
# tests/test_torch_cuda.py holds `plan` to the kernel's there)
WAVES = {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}
WAVE = WAVES[CLUSTER]
KSTEP = 8  # rows per m16n8k8 product
# (cluster, groups): the float32 kernel's, the cluster8 variant's, the order
# before clusters, and the bf16 kernel's
ORDERS = [(CLUSTER, GROUPS), (8, GROUPS), (1, 1), (CLUSTER_BF16, GROUPS)]
ORDER_IDS = ["kernel", "cluster8", "cluster1", "bf16_order"]

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


def plan(M, P, Q, cluster=CLUSTER, wave=WAVE):
    """(rows per chunk, chunks S) of csrc/weight_grad.cuh wg_plan: about one
    wave of `wave` clusters, S a multiple of the cluster size."""
    tiles = math.ceil(P / TILE) * math.ceil(Q / TILE)
    s = min(max(wave // tiles * cluster, cluster), PARTIAL_CAP // (P * Q) * cluster)
    rows = max(math.ceil(M / s), MIN_ROWS)
    rows = math.ceil(rows / STAGE_ROWS) * STAGE_ROWS
    return rows, math.ceil(math.ceil(M / rows) / cluster) * cluster


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


def fixed_order_sum(chunks, cluster=CLUSTER, groups=GROUPS):
    """The kernels' sum of the chunks' partials (a list, a multiple of
    `cluster` long): each cluster's in rank order (weight_grad_kernel's
    fold), then reduce_kernel's: range g of `groups` takes the clusters'
    partials [g S / G, (g + 1) S / G) ascending from zero, the range sums
    added in range order."""
    folds = []
    for c in range(0, len(chunks), cluster):
        f = chunks[c]
        for k in range(1, cluster):
            f = f + chunks[c + k]
        folds.append(f)
    S, out = len(folds), None
    for g in range(groups):
        r = torch.zeros_like(folds[0])
        for z in range(g * S // groups, (g + 1) * S // groups):
            r = r + folds[z]
        out = r if out is None else out + r
    return out


def replay(X, Y, kstep=three_tf32, cluster=CLUSTER, groups=GROUPS):
    """X^T Y as the kernels compute it: per chunk, 8-row k-steps (rows past
    the chunk zero) whose `kstep` tile is added to a float32 accumulator in
    order; the chunks' partials (empty chunks zero) summed in
    `fixed_order_sum`'s order."""
    M, P = X.shape
    Q = Y.shape[1]
    rows, S = plan(M, P, Q, cluster, WAVES[cluster])
    chunks = []
    for m0 in range(0, S * rows, rows):
        xc, yc = X[m0:m0 + rows], Y[m0:m0 + rows]
        acc = torch.zeros((P, Q))
        if len(xc):
            pad = -len(xc) % KSTEP
            xc = torch.cat([xc, xc.new_zeros((pad, P))]).reshape(-1, KSTEP, P)
            yc = torch.cat([yc, yc.new_zeros((pad, Q))]).reshape(-1, KSTEP, Q)
            for t in kstep(xc, yc):
                acc = acc + t
        chunks.append(acc)
    return fixed_order_sum(chunks, cluster, groups)


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


def replay_error(name, M, P, Q, cluster, groups):
    """The replay's largest error over s at one of SHAPES in one order."""
    X, Y = inputs(M, P, Q, seed=len(name) + M)
    want, s = exact_and_scale(X, Y)
    got = replay(torch.from_numpy(X), torch.from_numpy(Y), cluster=cluster, groups=groups)
    return rel_err(got, want, s)


@pytest.mark.parametrize("name,M,P,Q", SHAPES, ids=[s[0] for s in SHAPES])
def test_three_term_tf32_replay_holds_the_bar(name, M, P, Q):
    """In the kernels' order (clusters of CLUSTER, GROUPS ranges)."""
    err = replay_error(name, M, P, Q, CLUSTER, GROUPS)
    assert err <= WG_BAR / 4, f"{name}: {err} of scale"  # float32-grade: ~2e-7 typical


@pytest.mark.parametrize("cluster,groups", ORDERS[1:], ids=ORDER_IDS[1:])
@pytest.mark.parametrize("name,M,P,Q", SHAPES, ids=[s[0] for s in SHAPES])
def test_three_term_tf32_replay_holds_the_bar_in_other_orders(name, M, P, Q, cluster, groups):
    """In the cluster8 variant's order, in the order before clusters and in
    the bf16 instantiation's order (no cluster, GROUPS ranges)."""
    err = replay_error(name, M, P, Q, cluster, groups)
    assert err <= WG_BAR / 4, f"{name}: {err} of scale"


def test_fixed_order_sum_is_the_stated_order():
    """The split-K order on partials whose sums round differently in each
    order: clusters of C in rank order, then G ranges of the cluster sums,
    each from zero, added in range order. C = G = 1 is the plain ascending
    sum from zero."""
    rng = np.random.default_rng(3)
    chunks = [torch.tensor(v) for v in (rng.standard_normal((40, 6))
                                        * 10.0 ** rng.uniform(-8, 8, (40, 1))).astype(np.float32)]
    folds = [chunks[c] + chunks[c + 1] + chunks[c + 2] + chunks[c + 3] + chunks[c + 4]
             + chunks[c + 5] + chunks[c + 6] + chunks[c + 7] for c in range(0, 40, 8)]
    # five folds in eight ranges: ranges 1, 3, 4, 6, 7 hold one fold each
    want = (((0 + folds[0]) + (0 + folds[1])) + (0 + folds[2])) + (0 + folds[3]) + (0 + folds[4])
    assert torch.equal(fixed_order_sum(chunks, 8, 8), want)
    flat = torch.zeros(6)
    for c in chunks:
        flat = flat + c
    assert torch.equal(fixed_order_sum(chunks, 1, 1), flat)
    assert not torch.equal(fixed_order_sum(chunks, 8, 8), flat)


@pytest.mark.parametrize("S", [1, 7, 131])
def test_reduce_partials_on_the_cpu_is_the_fixed_order_sum(S):
    """`weight_grad.reduce_partials` on CPU partials (reduce_kernel's plain
    version) is bitwise the second half of `fixed_order_sum`: the partials'
    GROUPS ranges, each ascending from zero, added in range order."""
    rng = np.random.default_rng(S)
    partials = torch.from_numpy((rng.standard_normal((S, 64))
                                 * 10.0 ** rng.uniform(-8, 8, (S, 1))).astype(np.float32))
    assert kwg.REDUCE_GROUPS == GROUPS
    assert torch.equal(kwg.reduce_partials(partials), fixed_order_sum(list(partials), 1, GROUPS))
    with pytest.raises(ValueError, match="multiple of 4"):
        kwg.reduce_partials(partials[:, :6])


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
    """The chunking is a function of (M, P, Q) and the card's cluster wave, at
    the kernel's cluster size (`check_chunks`)."""
    check_chunks(CLUSTER)


@pytest.mark.parametrize("cluster", [8, 1])
def test_chunks_follow_the_shape_only_at_other_cluster_sizes(cluster):
    check_chunks(cluster)


def check_chunks(cluster):
    """Whole clusters (S a multiple of C, the last padded with empty chunks, no
    cluster of empty chunks only), one wave of clusters at the train step's
    edge counts, at least MIN_ROWS rows and a whole number of stages per
    chunk, the clusters' partials inside the scratch."""
    wave = WAVES[cluster]
    for M, P, Q in ((425_984, 128, 128), (425_984, 84, 256), (32_768, 128, 16),
                    (13_312, 128, 640), (425_991, 128, 128), (13_312, 128, 128), (4103, 128, 128)):
        rows, S = plan(M, P, Q, cluster, wave)
        tiles = math.ceil(P / TILE) * math.ceil(Q / TILE)
        assert S % cluster == 0 and S - math.ceil(M / rows) < cluster
        assert rows % STAGE_ROWS == 0 and rows >= MIN_ROWS
        assert S // cluster * P * Q <= PARTIAL_CAP
        assert S // cluster * tiles <= wave
        if M >= wave * cluster * MIN_ROWS:
            assert S // cluster * tiles >= wave * 0.9
