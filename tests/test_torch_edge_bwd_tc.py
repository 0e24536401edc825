"""The backward edge kernel's transposed second layers on the tensor cores
(csrc/pass_bwd.cuh transposed_layers: da = d W2^T), on the CPU. The bf16
fragments as stage_w2_kernel<true> stages them, replayed from the kernel's
index math in numpy: the W2^T image read back through the mma's B layout is
the rounded transpose exactly, and a warp-by-warp simulation of the kernel's
fragments (A from the third chunk buffer at row stride kLdd, B from the
image, C stored to the activation rows) gives d W2^T to float32 rounding; the
8-byte fragments of the recompute's W2 hold the words of the earlier 16-byte
ones. The float32 product's three-term TF32 arithmetic in the kernel's
k-step order against float64 (one TF32 term misses the bar). And the whole
backward replayed (`replay_block_bwd`) with that product, beside the other
products as the kernel computes them, against autograd of the plain block
and, as the block's backward inside the loss, against the JAX XLA loss's
gradients; with one TF32 term in this product alone it misses the bar."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu_torch.models import fast_forward
from targetdiff_tpu_torch.ops.kernels import block_vjp
from targetdiff_tpu_torch.ops.kernels.block_denoiser import (
    block_denoiser_train_plain,
    pack_pass_params,
)
from targetdiff_tpu_torch.ops.kernels.block_vjp import FIELDS
from targetdiff_tpu_torch.ops.kernels.block_vjp_replay import replay_block_bwd
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict
from tests.test_torch_block_vjp import (
    SPLIT_CASES,
    _hold_replay,
    _split_setup,
    _worst_over_scale,
    drbf_tf32,
    jax_draws,
    node_tf32,
)
from tests.test_torch_x2h_edge import split3_matmul

torch.set_num_threads(2)

H, KC, KLDD = 128, 32, 2 * 128 + 4  # csrc: H, KC, kLdd (the third chunk buffer's row stride)
KSTEPS, NTILES = H // 16, H // 8  # csrc: kKSteps, kNTiles
W2_FRAGS = KSTEPS * NTILES * 32  # csrc: kW2Frags
W_SCALE = 256.0  # csrc: kWScale


def bf16_bits(x):
    """float32 -> bf16 bit patterns (uint32), to nearest even, as
    __floats2bfloat162_rn rounds finite values."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32)


def bf16_value(bits):
    """bf16 bit patterns -> their float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def bf16_pair(lower, upper):
    """csrc tc_common.cuh bf16_pair: lower in the low half."""
    return bf16_bits(lower) | (bf16_bits(upper) << 16)


def stage_frags16(W, sk, sn, ksteps, ntiles, scale):
    """csrc/pass_bwd.cuh stage_frags16, its loop replayed thread by thread: B[k][n]
    = W.flat[k sk + n sn] times scale as (b0, b1) words [ksteps ntiles 32, 2]."""
    W = np.asarray(W, np.float32).reshape(-1)
    per = ksteps * ntiles * 32
    out = np.zeros((per, 2), np.uint32)
    for u in range(per):
        ks, nt, fl = u // (ntiles * 32), u // 32 % ntiles, u % 32
        w = (16 * ks + 2 * (fl & 3)) * sk + (8 * nt + (fl >> 2)) * sn
        out[u] = (bf16_pair(scale * W[w], scale * W[w + sk]),
                  bf16_pair(scale * W[w + 8 * sk], scale * W[w + 9 * sk]))
    return out


def stage_frags_uint4(W, ldw, ntiles, scale):
    """tc_common.cuh stage_frags<true>, the 16-byte form the recompute read
    before: (b0, b1, 0, 0) words [kKSteps ntiles 32, 4] of B = W [128][ldw]."""
    W = np.asarray(W, np.float32).reshape(-1)
    per = KSTEPS * ntiles * 32
    out = np.zeros((per, 4), np.uint32)
    for u in range(per):
        ks, nt, fl = u // (ntiles * 32), u // 32 % ntiles, u % 32
        w = (16 * ks + 2 * (fl & 3)) * ldw + 8 * nt + (fl >> 2)
        out[u, :2] = (bf16_pair(scale * W[w], scale * W[w + ldw]),
                      bf16_pair(scale * W[w + 8 * ldw], scale * W[w + 9 * ldw]))
    return out


def read_b(image, ksteps, ntiles):
    """The B operand [16 ksteps, 8 ntiles] an m16n8k16 mma reads from the
    image, by the PTX B-fragment layout: lane 4 g + tig holds in b0 rows 2 tig,
    2 tig + 1 and in b1 rows 2 tig + 8, 2 tig + 9 of column g."""
    B = np.zeros((16 * ksteps, 8 * ntiles), np.float32)
    for u in range(len(image)):
        ks, nt, lane = u // (ntiles * 32), u // 32 % ntiles, u % 32
        tig, k0, n = lane & 3, 16 * ks, 8 * nt + (lane >> 2)
        for word, row in ((image[u, 0], k0 + 2 * tig), (image[u, 1], k0 + 2 * tig + 8)):
            B[row, n], B[row + 1, n] = bf16_value(word & 0xFFFF), bf16_value(word >> 16)
    return B


def simulate_bf16_transposed(s_d, images, V):
    """transposed_layers<V, true>, warp by warp and lane by lane: A fragments
    built from s_d [KC][kLdd] as the kernel builds them, B fragments from the
    staged images (k, v) at the warp's n-tiles, each m16n8k16 product
    decoded by the PTX A / B / C layouts and accumulated in float32, the C
    fragments stored as the kernel stores them into da [KC][2H]."""
    da = np.full((KC, 2 * H), np.nan, np.float32)
    lanes = np.arange(32)
    g, tig = lanes >> 2, lanes & 3
    flat = s_d.reshape(-1)
    for warp in range(8):
        half, n0 = warp >> 2, 32 * (warp & 3)
        C = V if half else H
        acc = np.zeros((2, 4, 4, 32), np.float32)
        for ks in range(C // 16):
            for nt in range(4):
                b = images[half][(ks * NTILES + n0 // 8 + nt) * 32 + lanes]
                Bt = np.zeros((16, 8))
                for word, r in ((b[:, 0], 2 * tig), (b[:, 1], 2 * tig + 8)):
                    Bt[r, g], Bt[r + 1, g] = bf16_value(word & 0xFFFF), bf16_value(word >> 16)
                for mt in range(2):
                    ar = (16 * mt + g) * KLDD + half * H + 16 * ks + 2 * tig
                    a = [bf16_pair(flat[ar], flat[ar + 1]),
                         bf16_pair(flat[ar + 8 * KLDD], flat[ar + 8 * KLDD + 1]),
                         bf16_pair(flat[ar + 8], flat[ar + 9]),
                         bf16_pair(flat[ar + 8 * KLDD + 8], flat[ar + 8 * KLDD + 9])]
                    At = np.zeros((16, 16))
                    for word, r, c in ((a[0], g, 2 * tig), (a[1], g + 8, 2 * tig),
                                       (a[2], g, 2 * tig + 8), (a[3], g + 8, 2 * tig + 8)):
                        At[r, c], At[r, c + 1] = bf16_value(word & 0xFFFF), bf16_value(word >> 16)
                    D = At @ Bt
                    for c, (r, col) in enumerate(((g, 2 * tig), (g, 2 * tig + 1),
                                                  (g + 8, 2 * tig), (g + 8, 2 * tig + 1))):
                        acc[mt, nt, c] = (acc[mt, nt, c] + D[r, col]).astype(np.float32)
        for mt in range(2):
            for nt in range(4):
                for hf in range(2):
                    col = half * H + n0 + 8 * nt + 2 * tig
                    da[16 * mt + 8 * hf + g, col] = acc[mt, nt, 2 * hf]
                    da[16 * mt + 8 * hf + g, col + 1] = acc[mt, nt, 2 * hf + 1]
    return da


def _weights(rng, V):
    w2k = rng.normal(size=(H, H)) * 10.0 ** rng.uniform(-3, 1, (H, 1))
    w2v = rng.normal(size=(H, V)) * 10.0 ** rng.uniform(-3, 1, (H, 1))
    return w2k.astype(np.float32), w2v.astype(np.float32)


def _chunk_d(rng, V, n):
    """dk|dv of a chunk of n live slots in the third chunk buffer [KC][kLdd]
    (zero rows past n, noise in the padding columns the product never reads),
    rows spanning 1e-3 .. 1e3."""
    s_d = rng.normal(size=(KC, KLDD)).astype(np.float32)
    s_d[:, :H + V] *= 10.0 ** rng.uniform(-3, 3, (KC, 1))
    s_d[n:, :H + V] = 0.0
    return s_d


@pytest.mark.parametrize("V", [128, 16])
def test_bf16_transposed_image_reads_back_as_the_rounded_transpose(V):
    """The W2^T images stage_w2_kernel<true> writes (stage_frags16 with sk = 1,
    sn = the weight's row length, scale 1), replayed from the kernel's index
    math, read back through the B layout as round_bf16(W2)^T exactly, for
    w2k [128][128] and w2v [128][V]; `block_vjp.stage_w2_frags16`, the layout
    the card tests compare the staged words with, holds the same words."""
    w2k, w2v = _weights(np.random.default_rng(V), V)
    images = [stage_frags16(w2k, 1, H, H // 16, NTILES, 1.0),
              stage_frags16(w2v, 1, V, V // 16, NTILES, 1.0)]
    for image, w in zip(images, (w2k, w2v)):
        want = bf16_value(bf16_bits(w)).T
        assert np.array_equal(read_b(image, w.shape[1] // 16, NTILES), want)
    pkg = block_vjp.stage_w2_frags16(torch.from_numpy(w2k).bfloat16(),
                                     torch.from_numpy(w2v).bfloat16())
    assert [p.shape for p in pkg] == [(W2_FRAGS, 2), (KSTEPS * V // 8 * 32, 2),
                                      (W2_FRAGS, 2), (V // 16 * NTILES * 32, 2)]
    for got, want in zip(pkg[2:], images):
        assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("V,n", [(128, 32), (128, 9), (16, 32), (16, 17)])
def test_bf16_transposed_fragments_give_d_times_w2_transposed(V, n):
    """The kernel's bf16 fragments, simulated lane by lane (A from s_d at row
    stride kLdd as transposed_tile builds them, B from the staged images, C
    stored as transposed_layers stores it), give every slot's da = d_bf16
    W2_bf16^T within float32 rounding (1e-6 of each entry's terms'
    root-sum-square) for the k half and the v half (16 deep for h2x), with
    slots past n zero; every column of da is written."""
    rng = np.random.default_rng(7 * V + n)
    w2k, w2v = _weights(rng, V)
    s_d = _chunk_d(rng, V, n)
    s_d = bf16_value(bf16_bits(s_d))  # edge_bwd_kernel rounds d in place
    images = [stage_frags16(w2k, 1, H, H // 16, NTILES, 1.0),
              stage_frags16(w2v, 1, V, V // 16, NTILES, 1.0)]
    da = simulate_bf16_transposed(s_d, images, V)
    assert not np.isnan(da).any()
    d64 = s_d[:, :H + V].astype(np.float64)
    wk, wv = (bf16_value(bf16_bits(w)).astype(np.float64) for w in (w2k, w2v))
    exact = np.concatenate([d64[:, :H] @ wk.T, d64[:, H:] @ wv.T], 1)
    rss = np.sqrt(np.concatenate([d64[:, :H] ** 2 @ (wk ** 2).T, d64[:, H:] ** 2 @ (wv ** 2).T], 1))
    err = np.abs(da - exact) / np.maximum(rss, 1e-300)
    assert err[:n].max() < 1e-6, err.max()
    assert (da[n:] == 0).all()


@pytest.mark.parametrize("V", [128, 16])
def test_recompute_fragments_keep_the_words_of_the_16_byte_staging(V):
    """stage_w2_kernel<true>'s 8-byte fragments of the recompute's w2k and w2v
    (times 2^8, B = W) hold, word for word, the (b0, b1) of the 16-byte
    (b0, b1, 0, 0) fragments stage_frags<true> staged before, whose other two
    words were zeros; `block_vjp.stage_w2_frags16` holds them too."""
    w2k, w2v = _weights(np.random.default_rng(3 + V), V)
    w2k, w2v = (bf16_value(bf16_bits(w)) for w in (w2k, w2v))  # a bf16 pack
    pkg = block_vjp.stage_w2_frags16(torch.from_numpy(w2k).bfloat16(),
                                     torch.from_numpy(w2v).bfloat16())
    for w, ntiles, got in ((w2k, NTILES, pkg[0]), (w2v, V // 8, pkg[1])):
        old = stage_frags_uint4(w, w.shape[1], ntiles, W_SCALE)
        new = stage_frags16(w, w.shape[1], 1, KSTEPS, ntiles, W_SCALE)
        assert np.array_equal(new, old[:, :2]) and not old[:, 2:].any()
        assert np.array_equal(got.numpy().view(np.uint32), new)


def stage_frags_f16(W, ldw, ntiles, scale):
    """tc_common.cuh stage_frags<false>, its loop replayed thread by thread:
    B = W [128][ldw] times scale as (b0 hi, b1 hi, b0 lo, b1 lo) fp16-pair
    words [kKSteps ntiles 32, 4], each value split as split_f16 splits it
    (hi and lo rounded to fp16, to nearest even)."""
    W = np.asarray(W, np.float32).reshape(-1)
    per = KSTEPS * ntiles * 32
    out = np.zeros((per, 4), np.uint32)
    for u in range(per):
        ks, nt, fl = u // (ntiles * 32), u // 32 % ntiles, u % 32
        w = (16 * ks + 2 * (fl & 3)) * ldw + 8 * nt + (fl >> 2)
        x = np.float32(scale) * W[[w, w + ldw, w + 8 * ldw, w + 9 * ldw]]
        hi = x.astype(np.float16)
        lo = (x - hi.astype(np.float32)).astype(np.float16)
        h, lw = hi.view(np.uint16).astype(np.uint32), lo.view(np.uint16).astype(np.uint32)
        out[u] = (h[0] | h[1] << 16, h[2] | h[3] << 16, lw[0] | lw[1] << 16, lw[2] | lw[3] << 16)
    return out


@pytest.mark.parametrize("V", [128, 16])
def test_float32_staged_words_replay_stage_frags(V):
    """`block_vjp.stage_w2_frags`, the float32 layout the card tests compare
    stage_w2_kernel<false>'s words with: w2k and w2v times 2^8 as
    stage_frags<false> stages them (replayed thread by thread) at words 0
    and W2_REGION_WORDS, the float32 bits of w2k^T and w2v^T from 2
    W2_REGION_WORDS, zeros elsewhere."""
    w2k, w2v = _weights(np.random.default_rng(11 + V), V)
    got = block_vjp.stage_w2_frags(torch.from_numpy(w2k), torch.from_numpy(w2v)).numpy()
    words = got.view(np.uint32)
    region = block_vjp.W2_REGION_WORDS
    assert got.shape == (block_vjp.W2_STAGED_WORDS,) == (4 * region,)
    for i, (w, ntiles) in enumerate(((w2k, NTILES), (w2v, V // 8))):
        want = stage_frags_f16(w, w.shape[1], ntiles, W_SCALE).reshape(-1)
        assert np.array_equal(words[i * region:i * region + len(want)], want)
        assert not words[i * region + len(want):(i + 1) * region].any()
    wt = np.concatenate([w2k.T, w2v.T]).astype(np.float32).reshape(-1)
    assert np.array_equal(got[2 * region:2 * region + len(wt)].view(np.float32), wt)
    assert not words[2 * region + len(wt):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_batched_staging_is_the_per_pass_layouts_concatenated(dtype):
    """`block_vjp.stage_w2` on CPU tensors (the plain version of one
    stage_w2_kernel launch for a backward's passes) at the block's 2L = 18
    passes, x2h (V = 128) and h2x (V = 16) alternating as td_block_bwd
    stages them: pass i's row is `pass_words` of pass i, which holds
    `stage_w2_frags` (float32) or `stage_w2_frags16`'s four regions at
    W2_REGION_WORDS // 2 words apart (bf16)."""
    rng = np.random.default_rng(5)
    ws = [_weights(rng, 16 if i % 2 else 128) for i in range(18)]
    w2k = [torch.from_numpy(k).to(dtype) for k, _ in ws]
    w2v = [torch.from_numpy(v).to(dtype) for _, v in ws]
    got = block_vjp.stage_w2(w2k, w2v, dtype)
    assert got.shape == (18, block_vjp.W2_STAGED_WORDS) and got.dtype == torch.int32
    half = block_vjp.W2_REGION_WORDS // 2
    for i, (k, v) in enumerate(zip(w2k, w2v)):
        assert torch.equal(got[i], block_vjp.pass_words(k, v, dtype))
        if dtype == torch.float32:
            assert torch.equal(got[i], block_vjp.stage_w2_frags(k, v))
            continue
        for r, want in enumerate(block_vjp.stage_w2_frags16(k, v)):
            assert torch.equal(got[i, r * half:r * half + want.numel()], want.reshape(-1))
    with pytest.raises(ValueError, match="pack"):
        block_vjp.stage_w2(w2k, w2v, torch.bfloat16 if dtype == torch.float32 else torch.float32)


def transposed_tf32(a, b, terms=3):
    """a [.., C] @ b [C, N] as transposed_tile's float32 branch computes it:
    TF32 operands (split3: hi, lo), each 8-deep k-step's lo*hi + hi*lo +
    hi*hi summed from zero (terms=1: hi*hi alone), the k-steps added to the
    float32 accumulator in ascending order (node_tf32's order). A depth that
    is not a multiple of 8 (the small models' h2x value width) is padded with
    zeros, which add nothing."""
    pad = -a.shape[-1] % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    return node_tf32(a, b, terms)


@pytest.mark.parametrize("V", [128, 16])
def test_tf32_transposed_product_holds_the_float64_bar(V):
    """The float32 product's arithmetic (three-term TF32, the kernel's k-step
    order) on d rows spanning 1e-3 .. 1e3 and w2 rows 1e-3 .. 10: every entry
    within 1e-5 of float64, relative to the root-sum-square of its terms;
    one TF32 term (hi*hi) misses that bar by far."""
    rng = np.random.default_rng(11 + V)
    w2k, w2v = _weights(rng, V)
    d = np.concatenate([_chunk_d(rng, V, KC)[:, :H + V] for _ in range(8)])
    worst = {}
    for terms in (3, 1):
        errs = []
        for dh, w in ((d[:, :H], w2k), (d[:, H:], w2v)):
            got = transposed_tf32(torch.from_numpy(dh), torch.from_numpy(w.T.copy()), terms)
            exact = dh.astype(np.float64) @ w.T.astype(np.float64)
            rss = np.sqrt(dh.astype(np.float64) ** 2 @ (w.astype(np.float64) ** 2).T)
            errs.append((np.abs(got.numpy() - exact) / np.maximum(rss, 1e-300)).max())
        worst[terms] = max(errs)
    assert worst[3] < 1e-5, worst
    assert worst[1] > 10 * 1e-5, worst


def _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, n_heads, tmatmul):
    """(replay, autograd) as tests/test_torch_block_vjp.py `_replay_and_autograd`
    forms them, the replay with every product as the float32 kernel computes
    it: the recompute (split3_matmul), d rbf (drbf_tf32), the node kernel's
    products (node_tf32) and the transposed second layers through tmatmul."""
    h_leaf, x_leaf, ew_leaf = (t.clone().requires_grad_() for t in (h, x, e_w))
    model.net.zero_grad()
    h_out, x_out = rn.block_forward(h_leaf, x_leaf, nbh, mlig, e_w=ew_leaf)
    ((h_out * gh).sum() + (x_out * gx).sum()).backward()
    want = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
    want.update(dh0=h_leaf.grad, dx0=x_leaf.grad, de_w=ew_leaf.grad)
    x2h, h2x = pack_pass_params(rn)
    hck, xck = block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w)
    dh0, dx0, dew, gx2h, gh2x = replay_block_bwd(
        {f: t.detach() for f, t in x2h.items()}, {f: t.detach() for f, t in h2x.items()},
        hck, xck, nbh, mlig, e_w, model.max_ligand, gh, gx, n_heads, split3_matmul, drbf_tf32,
        node_tf32, tmatmul=tmatmul)
    model.net.zero_grad()
    torch.autograd.backward([x2h[f] for f in FIELDS] + [h2x[f] for f in FIELDS],
                            [gx2h[f] for f in FIELDS] + [gh2x[f] for f in FIELDS])
    got = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
    got.update(dh0=dh0, dx0=dx0, de_w=dew)
    return got, want


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_tf32_transposed_replay_matches_autograd_of_plain_block(case):
    """The kernel's algorithm with every product as the float32 kernel computes
    it, the transposed second layers three-term TF32 in the kernel's order
    (transposed_tf32), holds the float32-grade bar (1e-5 of each tensor's
    scale, rtol 1e-4) against autograd of the plain block on kNN and hybrid
    graphs of K = 8, 15 and 40."""
    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(*SPLIT_CASES[case])
    got, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                     transposed_tf32)
    _hold_replay(got, want, 36 * cfg.num_layers)


def test_one_term_tf32_transposed_replay_misses_the_bar():
    """One TF32 product per term in the transposed second layers alone lands
    well outside the bar the three-term product holds on the same inputs."""
    def one_term(a, b):
        return transposed_tf32(a, b, terms=1)

    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(
        *SPLIT_CASES["knn_K40"])
    three, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                       transposed_tf32)
    one, _ = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                  one_term)
    assert _worst_over_scale(three, want) < 1e-5
    assert _worst_over_scale(one, want) > 10 * 1e-5
    with pytest.raises(AssertionError):
        _hold_replay(one, want, 36 * cfg.num_layers)


class _KernelReplayBlock(torch.autograd.Function):
    """The block on the CPU: the plain train-mode forward, and as backward the
    float32 kernel's algorithm with every product as the kernel computes it
    (`replay_block_bwd` with split3_matmul, drbf_tf32, node_tf32 and
    transposed_tf32), returning the packed weights' gradients as
    `_BlockLayers` does."""

    @staticmethod
    def forward(ctx, h, x, e_w, refine_net, nbh, mlig, n_ligand, n_heads, *flat):
        hck, xck = block_denoiser_train_plain(refine_net, h, x, nbh, mlig, e_w)
        ctx.save_for_backward(hck, xck, e_w, mlig, *flat)
        ctx.nbh, ctx.n_ligand, ctx.n_heads = nbh, n_ligand, n_heads
        return hck[-1].clone(), xck[-1].clone()

    @staticmethod
    def backward(ctx, gh, gx):
        hck, xck, e_w, mlig, *flat = ctx.saved_tensors
        n = len(FIELDS)
        x2h, h2x = dict(zip(FIELDS, flat[:n])), dict(zip(FIELDS, flat[n:]))
        dh0, dx0, dew, gx2h, gh2x = replay_block_bwd(
            x2h, h2x, hck, xck, ctx.nbh, mlig, e_w, ctx.n_ligand, gh, gx, ctx.n_heads,
            split3_matmul, drbf_tf32, node_tf32, tmatmul=transposed_tf32)
        return (dh0, dx0, dew, None, None, None, None, None,
                *[gx2h[f] for f in FIELDS], *[gh2x[f] for f in FIELDS])


@pytest.mark.parametrize("case", ["knn_K8", "hybrid_K40"])
def test_tf32_transposed_replay_loss_and_grads_match_jax_xla(case, monkeypatch):
    """The loss's gradients with that replay as the whole block's backward
    (any K) against jax.value_and_grad of the JAX XLA loss, on the JAX draws,
    held as tests/test_torch_block_vjp.py holds the port's (loss 1e-4
    relative, every gradient 5e-3 of its scale)."""
    cfg, jmodel, params, jbatch, model, batch, *_ = _split_setup(*SPLIT_CASES[case])
    calls = []

    def trainable(refine_net, h, x, nbh, mask_ligand, e_w, n_ligand, dtype=torch.float32):
        assert dtype == torch.float32
        calls.append(nbh.idx.shape[-1])
        x2h, h2x = pack_pass_params(refine_net)
        return _KernelReplayBlock.apply(h, x, e_w, refine_net, nbh, mask_ligand, n_ligand,
                                        cfg.n_heads, *[x2h[f] for f in FIELDS],
                                        *[h2x[f] for f in FIELDS])

    monkeypatch.setattr(fast_forward, "block_layers_trainable", trainable)
    monkeypatch.setattr(fast_forward, "MAX_K", 256)  # K = 40 stays on the whole block
    key, t = jax.random.PRNGKey(5), np.array([2, 7])

    def loss_fn(p):
        return jmodel.get_diffusion_loss(p, key, jbatch, time_step=jnp.asarray(t))["loss"]

    la, ga = jax.value_and_grad(loss_fn)(params)
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    model.net.zero_grad()
    out = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                   v_uniform=u, impl="fast")
    out["loss"].backward()
    assert calls == [model.net.refine_net.num_neighbors()]
    assert abs(float(out["loss"]) - float(la)) / abs(float(la)) < 1e-4
    want = flax_params_to_state_dict(jax.device_get(ga))
    got = dict(model.net.named_parameters())
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        a, b = a.numpy(), got[name].grad.numpy()
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(b, a, atol=5e-3 * scale, rtol=5e-3, err_msg=name)

