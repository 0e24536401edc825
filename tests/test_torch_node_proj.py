"""The node-projection kernel's design (targetdiff_tpu_torch/csrc/node_proj.cuh
node_kernel) replayed on the CPU.

The tile walk: persistent blocks dealt to three column groups (ni, nj, q)
by `node_deal`, each group's 64-row tiles walked by its warpgroups with the
stride of their number (`block_denoiser.node_walk`); every (row, group) is
covered once, the ni and q groups only on rows [row0, N) of each complex.

The staged weights: `node_stage` writes a 128 x 128 weight as a wgmma B
operand (B[n][k], K-major 8x8 core matrices, 8-row groups kNodeSbo bytes
apart) with w_node's rows in node_k_col order, so that a thread's A
fragment of a 16-deep k-step is one 16-byte load of h. Replayed in numpy,
the image read back through the operand's layout gives w_node (bf16)
exactly, or kWScale w_node as fp16 hi + lo within the split's error
(float32); and the A fragments built from the loads as the kernel builds
them, times that image, give h @ W.

The plain version (`node_projections_plain`) against the JAX package's node
math (the first layer's h_i and h_j blocks, `_node_mlp` for q) from the same
numpy inputs, float32 and bf16. Weights are random from a torch seed,
carried to JAX by utils/port.py; inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.models.fast_forward import extract_layer_params
from targetdiff_tpu.ops.pallas.edge_layer import _node_mlp
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.utils.port import state_dict_to_flax_params
from tests.test_torch_x2h_edge import NUM_CLASSES, PROTEIN_DIM, W_SCALE, small_flagship

torch.set_num_threads(2)

H = 128
KSTEPS = H // 16
SBO = 2 * KSTEPS * 128 + 16  # csrc/node_proj.cuh kNodeSbo: bytes between 8-row groups
NODE_REL = 4e-6  # the card's bar on ni, nj, q1 against float64 (tests/test_torch_cuda.py)
# (blocks the card holds at once, warpgroups a block): one H100 at one to
# three blocks a SM with one warpgroup, and at one block of two
WALK_SLOTS = [(132, 1), (264, 1), (396, 1), (132, 2)]


@pytest.mark.parametrize("row0_case", ["every_row", "source_only"])
@pytest.mark.parametrize("N", [75, 608])
@pytest.mark.parametrize("B", [1, 4, 100])
def test_node_walk_covers_each_row_and_group_once(B, N, row0_case):
    """Every row of every complex gets nj once; ni and q once on rows >=
    row0 (row0 = N - 11 as the h2x pass launches it) and never below; each
    warpgroup's tiles come in increasing order and every block has work."""
    row0 = 0 if row0_case == "every_row" else N - 11
    want = np.zeros((3, B * N), np.int64)
    want[1] = 1
    want[0] = want[2] = np.arange(B * N) % N >= row0
    for slots, warpgroups in WALK_SLOTS:
        seen = np.zeros_like(want)
        blocks = kblock.node_walk(B, N, row0, slots, warpgroups)
        assert len(blocks) <= max(slots, 3)
        for grp, walks in blocks:
            assert len(walks[0]) > 0
            for rows in walks:
                for r in rows:
                    np.add.at(seen[grp], r, 1)
                starts = [int(r[0]) for r in rows]
                assert starts == sorted(starts)
        np.testing.assert_array_equal(seen, want)


def node_k_col(k):
    """csrc/node_proj.cuh node_k_col: the column of h (row of w_node) of
    term k; within a k-step thread tig's columns 2 tig (+1) are 4 tig (+1),
    its columns 2 tig + 8 (+9) are 4 tig + 2 (+3)."""
    return (k & ~15) + 4 * ((k & 7) >> 1) + 2 * ((k >> 3) & 1) + (k & 1)


def stage_image(w_bits, permute):
    """node_stage's shared-memory image of w_bits [128, 128] (16-bit
    patterns), as 16-bit words: unit (kc, nb) writes row n of its core
    matrix, at nb * SBO + kc * 128 + 16 n bytes, from the eight rows k = 8 kc
    + i of W (node_k_col(k) when permuted), column 8 nb + n."""
    kc, nb, n, i = np.meshgrid(np.arange(16), np.arange(16), np.arange(8), np.arange(8),
                               indexing="ij")
    k = 8 * kc + i
    rows = node_k_col(k) if permute else k
    img = np.zeros(H // 8 * SBO // 2, np.uint16)
    img[(nb * SBO + kc * 128 + 16 * n + 2 * i) // 2] = w_bits[rows, 8 * nb + n]
    return img


def operand(img):
    """B[n][k] of a K-major, unswizzled wgmma operand at img (leading byte
    offset 128, stride byte offset SBO), as tc_common.cuh kmajor_off reads
    it."""
    n, k = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    return img[((n >> 3) * SBO + (k >> 3) * 128 + (n & 7) * 16 + (k & 7) * 2) // 2]


def a_fragments(h):
    """The A operand [rows, 128 terms] the kernel builds: thread (g, tig)
    loads columns 16 ks + 4 tig .. + 3 of its row and makes registers
    (k 2 tig, 2 tig + 1) of the first two, (k 2 tig + 8, 2 tig + 9) of the
    last two."""
    a = np.zeros_like(h)
    for ks in range(KSTEPS):
        for tig in range(4):
            x = h[:, 16 * ks + 4 * tig:16 * ks + 4 * tig + 4]
            a[:, 16 * ks + 2 * tig:16 * ks + 2 * tig + 2] = x[:, :2]
            a[:, 16 * ks + 8 + 2 * tig:16 * ks + 10 + 2 * tig] = x[:, 2:]
    return a


def bf16_bits(a):
    return (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
            .view(torch.int16).numpy().view(np.uint16))


def bits_bf16(b):
    return torch.from_numpy(b.view(np.int16)).view(torch.bfloat16).double().numpy()


def test_node_k_col_permutes_each_k_step():
    cols = node_k_col(np.arange(H))
    for ks in range(KSTEPS):
        assert sorted(cols[16 * ks:16 * ks + 16]) == list(range(16 * ks, 16 * ks + 16))
    np.testing.assert_array_equal(a_fragments(np.arange(H, dtype=float)[None])[0], cols)


@pytest.mark.parametrize("permute", [True, False], ids=["w_node", "w_q2"])
def test_bf16_staged_weight_reads_back_exactly(permute):
    """The bf16 image read back through the operand's layout is W, bit for
    bit; the A fragments times it are h @ W (bf16 operands, float64 sums)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(H, H)) * 0.1
    w_bits = bf16_bits(w)
    b = operand(stage_image(w_bits, permute))  # [n][k]
    back = np.zeros_like(w_bits)
    back[node_k_col(np.arange(H)) if permute else np.arange(H)] = b.T
    np.testing.assert_array_equal(back, w_bits)
    h = bits_bf16(bf16_bits(rng.normal(size=(70, H)) * 3))
    a = a_fragments(h) if permute else h
    np.testing.assert_allclose(a @ bits_bf16(b).T, h @ bits_bf16(w_bits), rtol=0, atol=1e-12)


def f16_split(x):
    hi = x.astype(np.float16)
    return hi, (x - hi.astype(np.float32)).astype(np.float16)


@pytest.mark.parametrize("permute", [True, False], ids=["w_node", "w_q2"])
def test_float32_staged_weight_is_the_split_and_keeps_the_product(permute):
    """The float32 images hold kWScale W as fp16 hi and lo: read back, hi +
    lo is kWScale W within the split's error (2^-22 relative, 2^-25 where lo
    is subnormal); the three-term product lo hi + hi lo + hi hi on rows
    scaled by a power of two stays at the node kernel's bar against
    float64."""
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(H, H)) * 10.0 ** rng.uniform(-4, 0, (H, H))).astype(np.float32)
    hi, lo = f16_split(np.float32(W_SCALE) * w)
    imgs = [stage_image(x.view(np.uint16), permute) for x in (hi, lo)]
    rows = node_k_col(np.arange(H)) if permute else np.arange(H)
    parts = []
    for img in imgs:
        back = np.zeros((H, H), np.uint16)
        back[rows] = operand(img).T
        parts.append(back.view(np.float16).astype(np.float64))
    x = np.float64(W_SCALE) * w
    err = np.abs(parts[0] + parts[1] - x)
    assert bool((err <= np.maximum(2.0 ** -22 * np.abs(x), 2.0 ** -25)).all())
    h = (rng.normal(size=(70, H)) * 1e3).astype(np.float32)
    e = 15 - np.frexp(np.abs(h).max(1))[1]
    hs = (h * 2.0 ** e[:, None]).astype(np.float32)
    a_hi, a_lo = f16_split(a_fragments(hs) if permute else hs)
    b_hi, b_lo = (operand(img).view(np.float16).astype(np.float64) for img in imgs)
    a_hi, a_lo = a_hi.astype(np.float64), a_lo.astype(np.float64)
    got = (a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T) * 2.0 ** (-e[:, None] - 8)
    want = h.astype(np.float64) @ w.astype(np.float64)
    assert float(np.abs(got - want).max() / np.abs(want).max()) < NODE_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub", ["x2h", "h2x"])
def test_node_projections_plain_matches_jax(sub, dtype):
    """ni, nj and q of `node_projections_plain` (layer 1 of a two-layer
    model at the released widths) against the JAX package's node math on
    the same weights and numpy rows: the first layer's h_i and h_j blocks of
    the k and v MLPs, and `_node_mlp` for the query MLP, in the same
    precision (bf16: h, the weights and the LayerNorm output rounded, float32
    sums)."""
    cfg = small_flagship()
    cfg.update(hidden_dim=H, n_heads=16, num_layers=2)
    torch.manual_seed(0)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=16,
                           max_ligand=8)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                          jnp.bfloat16)
    with torch.no_grad():
        stacks = kblock.pack_pass_params(model.net.refine_net, tdt)[sub == "h2x"]
    block = state_dict_to_flax_params(model.net.state_dict())["params"]["refine_net"]["block_1"]
    params = extract_layer_params(block, H, 20)[sub == "h2x"]._asdict()
    k, v, q = ("hk", "hv", "hq") if sub == "x2h" else ("xk", "xv", "xq")
    h = (np.random.default_rng(5).normal(size=(90, H)) * 3).astype(np.float32)
    hj = jnp.asarray(h)

    def dot(w):
        return jnp.dot(hj.astype(jdt), w.astype(jdt), preferred_element_type=jnp.float32)

    want = (jnp.concatenate([dot(params[f"{k}_w1i"]) + params[f"{k}_b1"],
                             dot(params[f"{v}_w1i"]) + params[f"{v}_b1"]], -1),
            jnp.concatenate([dot(params[f"{k}_w1j"]), dot(params[f"{v}_w1j"])], -1),
            _node_mlp(hj, *(params[f"{q}_{n}"] for n in ("w1", "b1", "lns", "lnb", "w2", "b2")),
                      jdt))
    with torch.no_grad():
        got = kblock.node_projections_plain(torch.from_numpy(h), stacks, layer=1)[:3]
    for name, g, w in zip(("ni", "nj", "q"), got, want):
        w = np.asarray(w, np.float64)
        rel = float(np.abs(g.double().numpy() - w).max() / np.abs(w).max())
        # two float32 orders of the same sums (measured: < 3e-7 of scale)
        assert rel < 1e-5, (name, rel)
