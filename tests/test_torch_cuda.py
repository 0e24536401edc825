"""The CUDA kernels against their plain PyTorch versions on the card, at
the released widths (hidden 128, 16 heads, 20 RBF knots) with small node
counts, including K < 32 and masked rows. Marked `cuda`: each test skips
unless a CUDA device is present. On a GPU host, run
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q`
(the suite's conftest imports jax, which GPU hosts need not have)."""

import copy

import numpy as np
import pytest
import torch

from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import knn as kknn

pytestmark = pytest.mark.cuda

CONFIG = dict(
    model_mean_type="C0", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    v_beta_schedule="cosine", v_beta_s=0.01, num_diffusion_timesteps=20, center_pos_mode="protein",
    node_indicator=True, model_type="uni_o2", num_blocks=1, num_layers=2, hidden_dim=128,
    n_heads=16, edge_feat_dim=4, num_r_gaussian=20, knn=8, act_fn="relu", norm=True,
    cutoff_mode="knn", ew_net_type="global", num_x2h=1, num_h2x=1, r_max=10.0,
    x2h_out_fc=False, sync_twoup=False,
)
NP_, NL, B = 34, 8, 3
# The x2h edge kernel's products are float32-grade (three-term fp16): h' sits
# ~1e-6 from plain, where one fp16 product per term sits ~2e-4 away
# (tests/test_torch_x2h_edge.py replays it).
X2H_TOL = dict(atol=1e-5, rtol=0.0)
# So are the h2x edge kernel's (three-term fp16, k and v): x' sits ~2e-7 from
# plain, one fp16 product per term ~5e-5 away (tests/test_torch_h2x_edge.py).
H2X_TOL = dict(atol=1e-5, rtol=0.0)
# The node kernel's projections against float64: the largest error over the
# largest |exact| entry of each output (three-term fp16 on rows scaled by a
# power of two; tests/test_torch_h2x_edge.py replays them).
NODE_REL = 4e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _complexes(device, seed=0):
    rng = np.random.default_rng(seed)
    pmask = np.ones((B, NP_), bool)
    pmask[0, 30:] = False
    lmask = np.ones((B, NL), bool)
    lmask[1, 5:] = False
    lmask[2, 1:] = False  # a one-atom ligand
    return from_numpy(rng.normal(size=(B, NP_, 3)) * 3, rng.random((B, NP_, 27)) > 0.7, pmask,
                      rng.normal(size=(B, NL, 3)), rng.integers(0, 13, (B, NL)), lmask,
                      device=device)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_knn_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    N = 45
    pos = torch.tensor(rng.normal(size=(B, N, 3)) * 3, dtype=torch.float32, device=cuda)
    mask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    mask[0, 40:] = False
    mask[1, ::5] = False
    mask[2, 10:] = False  # fewer valid atoms than K + 1 when k = 32
    ref = G.knn_graph(pos, mask, k)
    out = kknn.knn_graph(pos, mask, k)
    torch.cuda.synchronize()
    assert torch.equal(out.mask, ref.mask)
    assert torch.equal(torch.where(out.mask, out.idx, -1), torch.where(ref.mask, ref.idx, -1))
    assert bool(((out.idx >= 0) & (out.idx < N)).all())


@pytest.mark.parametrize("k", [8, 32])
def test_block_kernel_matches_plain(cuda, k):
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    rn = model.net.refine_net
    batch = _complexes(cuda)
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = G.knn_graph(x, node_mask, k)
        h_ref, x_ref = rn.block_forward(h, x, nbh, mlig)
        h_out, x_out = kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=NL)
    torch.cuda.synchronize()
    m = node_mask[..., None]
    torch.testing.assert_close(x_out * m, x_ref * m, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(h_out * m, h_ref * m, atol=2e-3, rtol=1e-2)
    assert bool(x_out.isfinite().all()) and bool(h_out.isfinite().all())
    assert torch.equal(x_out[:, :NP_], x[:, :NP_])  # protein rows never move


def test_kernel_backed_step_matches_eager(cuda):
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    batch = _complexes(cuda, seed=1)
    with torch.no_grad():
        fast = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=torch.float32)
        ref = model.apply(batch, batch.ligand_pos, batch.ligand_v)
    lm = batch.ligand_mask[..., None]
    torch.testing.assert_close(fast["pred_ligand_pos"] * lm, ref["pred_ligand_pos"] * lm,
                               atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(fast["pred_ligand_v"] * lm, ref["pred_ligand_v"] * lm,
                               atol=2e-3, rtol=1e-2)
    res = model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v,
                                 torch.Generator(device=cuda).manual_seed(0), num_steps=5)
    assert bool(res.pos.isfinite().all())


def grads_close(got: dict, want: dict, atol_scale=5e-3, rtol=5e-3):
    """Every gradient within atol_scale * max|want| + rtol |want|. The k
    second-layer biases get zero gradient in exact arithmetic (softmax shift
    invariance), so theirs are float32 noise, held to the largest gradient."""
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        if name.endswith("k_func.net.3.bias"):
            assert float(g.abs().max()) < 1e-5 * top, name
            continue
        torch.testing.assert_close(g, w, atol=atol_scale * float(w.abs().max()), rtol=rtol,
                                   msg=lambda m, n=name: f"{n}: {m}")


def _train_block_setup(cuda, k, batch_size, seed=0):
    torch.manual_seed(seed)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    rn = model.net.refine_net
    batch = _complexes(cuda, seed)
    batch = type(batch)(*[t[:batch_size] for t in batch])
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = G.knn_graph(x, node_mask, k)
        e_w = rn.edge_weights(x, nbh)[..., 0]
    return rn, h, x, node_mask, mlig, nbh, e_w


@pytest.mark.parametrize("k", [8, 32])
def test_train_forward_kernel_matches_plain(cuda, k):
    rn, h, x, node_mask, mlig, nbh, e_w = _train_block_setup(cuda, k, B)
    with torch.no_grad():
        x2h, h2x = kblock.pack_pass_params(rn)
        want = kblock.block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w)
        got = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, x2h, h2x)
    torch.cuda.synchronize()
    m = node_mask[None, :, :, None]  # checkpoints are [L+1,B,N,.]
    torch.testing.assert_close(got[0] * m, want[0] * m, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(got[1] * m, want[1] * m, atol=2e-4, rtol=1e-3)
    assert torch.equal(got[1][:, :, :NP_], x[None, :, :NP_].expand(got[1].shape[0], -1, -1, -1))


@pytest.mark.parametrize("k,batch_size", [(8, B), (32, B), (32, 1)])
def test_block_vjp_kernel_matches_autograd(cuda, k, batch_size):
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    rn, h, x, node_mask, mlig, nbh, e_w = _train_block_setup(cuda, k, batch_size)
    gen = torch.Generator(device=cuda).manual_seed(k)
    gh = torch.randn(h.shape, generator=gen, device=cuda) * node_mask[..., None]
    gx = torch.randn(x.shape, generator=gen, device=cuda)

    def run(trainable):
        leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
        rn.zero_grad()
        if trainable:
            ho, xo = block_vjp.block_layers_trainable(rn, *leaves[:2], nbh, mlig, leaves[2], NL)
        else:
            ho, xo = rn.block_forward(leaves[0], leaves[1], nbh, mlig, e_w=leaves[2])
        ((ho * gh).sum() + (xo * gx).sum()).backward()
        grads = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
        grads.update(dh0=leaves[0].grad, dx0=leaves[1].grad, de_w=leaves[2].grad)
        return grads

    launches = block_vjp.LAUNCHES
    got, again, want = run(True), run(True), run(False)
    torch.cuda.synchronize()
    assert block_vjp.LAUNCHES == launches + 2
    assert all(torch.equal(got[n], again[n]) for n in got)  # fixed summation order
    assert sorted(got) == sorted(want)
    assert all(bool(g.isfinite().all()) for g in got.values())
    grads_close(got, want)


def _grads(module, fn, leaves_in, cot):
    """Every parameter gradient of `module` and of the inputs (d0, d1, d2)
    for the cotangents `cot` of fn(*leaves)."""
    leaves = [t.clone().requires_grad_() for t in leaves_in]
    module.zero_grad(set_to_none=True)
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    sum((o * c).sum() for o, c in zip(out, cot)).backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}
    grads.update({f"d{i}": t.grad for i, t in enumerate(leaves)})
    return grads


@pytest.mark.parametrize("case", ["block_K32", "x2h_hybrid_K95", "h2x_hybrid_K95",
                                  "x2h_knn_K40", "x2h_hybrid_K256", "h2x_hybrid_K256"])
def test_backward_kernels_hold_the_float64_bar_and_repeat(cuda, case):
    """The block backward (K = 32) and the per-layer backwards on a hybrid
    graph (K = 95: three chunks, pass 2 recomputes k) and, for x2h, on a kNN
    graph of K = 40 (its last chunk holds 8 slots: the d rbf product's second
    m-tile is all padding) against float64 autograd of the plain layers at
    the same inputs (the block: at the kernel's checkpoints), as
    chip_smoke.py holds them: the median tensor within BWD64_MEDIAN of its
    scale and, per layer, every tensor within BWD64_BAR or BWD64_F32 times
    the plain float32 version's own error; two runs bitwise equal. Also the
    largest K the per-layer backwards take (256: eight chunks per row)."""
    from chip_smoke import BWD64_BAR, BWD64_F32, BWD64_MEDIAN, block_vjp_chain, tensor_errs
    from targetdiff_tpu_torch.ops.kernels import block_vjp
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kelv

    gen = torch.Generator(device=cuda).manual_seed(3)
    if case == "block_K32":
        rn, h, x, node_mask, mlig, nbh, e_w = _train_block_setup(cuda, 32, B)
        cot = (torch.randn(h.shape, generator=gen, device=cuda) * node_mask[..., None],
               torch.randn(x.shape, generator=gen, device=cuda))

        def kernel(hh, xx, ee):
            return block_vjp.block_layers_trainable(rn, hh, xx, nbh, mlig, ee, NL)

        with torch.no_grad():
            x2h, h2x = kblock.pack_pass_params(rn)
            hck, xck = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, x2h, h2x)
        plain32 = block_vjp_chain(torch, rn, hck, xck, nbh, mlig, e_w, *cot)
        want64 = block_vjp_chain(torch, copy.deepcopy(rn).double(), hck.double(), xck.double(),
                                 nbh, mlig, e_w.double(), *[c.double() for c in cot])
        names = {"dh0": "d0", "dx0": "d1", "de_w": "d2"}
        plain32, want64 = ({names.get(n, n): t for n, t in g.items()} for g in (plain32, want64))
    else:
        K = int(case.split("_K")[1])
        cutoff_mode, k = ("knn", 40) if case.endswith("K40") else ("hybrid", 32)
        n_lig = 64 if cutoff_mode == "knn" else K + 1 - k  # hybrid K = n_lig - 1 + k
        _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, n_lig, 64,
                                                                  seed=1)
        assert nbh.idx.shape[-1] == K
        sub = case[:3]
        cot = ((torch.randn(h.shape, generator=gen, device=cuda) * node_mask[..., None],)
               if sub == "x2h" else (torch.randn(x.shape, generator=gen, device=cuda),))

        def kernel(hh, xx, ee):
            if sub == "x2h":
                return kelv.x2h_layer_trainable(rn.base_block[0], hh, xx, nbh, mlig, ee)
            return kelv.h2x_layer_trainable(rn.base_block[0], hh, xx, nbh, mlig, ee, n_lig)

        def plain(m):
            fn = kel.x2h_layer_plain if sub == "x2h" else kel.h2x_layer_plain
            return lambda hh, xx, ee: fn(m.base_block[0], hh, xx, nbh, mlig, ee)

        rn64 = copy.deepcopy(rn).double()
        plain32 = _grads(rn, plain(rn), (h, x, e_w), cot)
        want64 = _grads(rn64, plain(rn64), [t.double() for t in (h, x, e_w)],
                        [c.double() for c in cot])

    got = _grads(rn, kernel, (h, x, e_w), cot)
    again = _grads(rn, kernel, (h, x, e_w), cot)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want64)
    assert all(torch.equal(got[n], again[n]) for n in got)  # fixed summation order
    errs, floor = tensor_errs(got, want64), tensor_errs(plain32, want64)
    assert np.median(list(errs.values())) < BWD64_MEDIAN
    if case != "block_K32":
        for n, e in errs.items():
            assert e < max(BWD64_BAR, BWD64_F32 * floor[n]), (n, e, floor[n])


@pytest.mark.parametrize("h2x,K", [(False, 32), (True, 32), (False, 95), (False, 256),
                                   (True, 256)])
def test_edge_bwd_kernel_occupancy(cuda, h2x, K):
    """The backward's edge kernel as the card makes it: at most 128 registers
    per thread, two blocks per SM at the whole-block backward's K = 32 (two
    destination rows in flight) and one at the per-layer K of the hybrid
    graph and above, within the 232,448 bytes of shared memory one block may
    take; no local memory (spills)."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    info = block_vjp.edge_bwd_info(K, h2x)
    assert info["registers"] <= 128
    assert info["blocks_per_sm"] == (2 if K <= 32 else 1)
    assert info["smem"] <= 232448
    assert info["local_bytes"] == 0, info


def test_staged_rbf_fragments_are_the_tf32_split_of_the_table(cuda):
    """The d rbf product's B fragments as the backward stages them on the card
    (stage_rbf_kernel) are, word for word, the TF32 (hi, lo) split of the
    RBF table in both destination kinds' layouts, as `stage_rbf_frags` lays
    them out in PyTorch (types 0|2 for ligand rows, 1|3 for protein rows;
    tests/test_torch_block_vjp.py decodes that layout), on a table whose rows
    span 1e-6 .. 1e2."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 20, 256)) * 10.0 ** rng.uniform(-6, 2, (4, 20, 1))
    w_rbf = torch.tensor(w, dtype=torch.float32)
    want = block_vjp.stage_rbf_frags(w_rbf)
    got = block_vjp.stage_rbf_frags(w_rbf.to(cuda))
    again = block_vjp.stage_rbf_frags(w_rbf.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 32, 5, 32, 4)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert bool(((want & 0x1FFF) == 0).all())  # every word a TF32 number


# edge_bwd_kernel's transposed second layers alone (tprod_kernel): value width
# and precision. E = 4,115 edges: 128 full chunks and a partial one.
TPROD_CASES = {"x2h": (128, torch.float32), "h2x": (16, torch.float32),
               "x2h_bf16": (128, torch.bfloat16), "h2x_bf16": (16, torch.bfloat16)}
TPROD_BAR = 1e-5  # of each entry's terms' root-sum-square (tests/test_torch_edge_bwd_tc.py)


@pytest.mark.parametrize("case", list(TPROD_CASES))
def test_transposed_product_holds_the_float64_bar_and_repeats(cuda, case):
    """The backward's transposed second layers as edge_bwd_kernel runs them
    (transposed_layers, alone in tprod_kernel) against the float64 product
    of their operands (float32: d and the weights as given, three-term TF32;
    bf16: both rounded to bf16, one bf16 product), every entry within
    TPROD_BAR of the root-sum-square of its terms, on rows of d and weights
    spanning 1e-3 .. 1e3; two launches bitwise equal; the bf16 fragments the
    kernel staged are word for word `stage_w2_frags16`'s."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp
    from targetdiff_tpu_torch.ops.precision import round_bf16

    V, dtype = TPROD_CASES[case]
    H, E = 128, 4115
    rng = np.random.default_rng(V)
    d = rng.normal(size=(E, H + V)) * 10.0 ** rng.uniform(-3, 3, (E, 1))
    w2k = rng.normal(size=(H, H)) * 10.0 ** rng.uniform(-3, 1, (H, 1))
    w2v = rng.normal(size=(H, V)) * 10.0 ** rng.uniform(-3, 1, (H, 1))
    d, w2k, w2v = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (d, w2k, w2v))
    w2k, w2v = w2k.to(dtype), w2v.to(dtype)
    frags = torch.empty(block_vjp._tprod_entries()[1]() // 4, dtype=torch.int32, device=cuda)
    got = block_vjp.transposed_product_cuda(d, w2k, w2v, dtype, frags)
    again = block_vjp.transposed_product_cuda(d, w2k, w2v, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    dr = (round_bf16(d) if dtype == torch.bfloat16 else d).double()
    exact, rss = [], []
    for dh, w in ((dr[:, :H], w2k.double()), (dr[:, H:], w2v.double())):
        exact.append(dh @ w.T)
        rss.append(((dh ** 2) @ (w ** 2).T).sqrt())
    exact, rss = torch.cat(exact, 1), torch.cat(rss, 1)
    err = float(((got.double() - exact).abs() / rss.clamp(min=1e-300)).max())
    print(case, "max err over rss", err)
    assert err < TPROD_BAR, err
    if dtype == torch.bfloat16:  # four regions of kW2Frags (b0, b1) words
        words = frags.view(-1, 2).cpu()
        for i, want in enumerate(block_vjp.stage_w2_frags16(w2k.cpu(), w2v.cpu())):
            assert torch.equal(words[i * 4096:i * 4096 + len(want)], want), i


def test_train_loss_kernel_path_matches_eager(cuda):
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    batch = _complexes(cuda, seed=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    t = torch.tensor([0, 7, 19], device=cuda)
    eps = torch.randn(batch.ligand_pos.shape, generator=gen, device=cuda)
    u = torch.rand(batch.ligand_v.shape + (13,), generator=gen, device=cuda)
    out = {}
    for impl in ("fast", "eager"):
        model.net.zero_grad()
        loss = model.get_diffusion_loss(batch, time_step=t, pos_noise=eps, v_uniform=u,
                                        impl=impl)["loss"]
        loss.backward()
        out[impl] = (float(loss), {n: p.grad.clone() for n, p in model.net.named_parameters()})
    assert abs(out["fast"][0] - out["eager"][0]) <= 1e-4 * abs(out["eager"][0])
    grads_close(out["fast"][1], out["eager"][1])


def _layer_setup(cuda, cutoff_mode, k, max_ligand, n_protein, seed=0, nb=B):
    """A two-layer model at the released widths on a graph of K = k (knn) or
    max_ligand - 1 + k (hybrid), with padded protein rows (no valid
    neighbour), padded ligand slots and a one-atom ligand; one layer's
    inputs (h, x, graph, e_w) for nb complexes (ligand sizes repeating)."""
    torch.manual_seed(seed)
    cfg = Config(dict(CONFIG, cutoff_mode=cutoff_mode, knn=k))
    model = DiffusionModel(cfg, 27, 13, device=cuda, max_protein=n_protein, max_ligand=max_ligand)
    rng = np.random.default_rng(seed)
    pmask = np.ones((nb, n_protein), bool)
    pmask[0, n_protein - 6:] = False
    sizes = np.resize([max_ligand, max_ligand // 2 + 3, 1], nb)
    batch = from_numpy(rng.normal(size=(nb, n_protein, 3)) * 4,
                       rng.random((nb, n_protein, 27)) > 0.7, pmask,
                       rng.normal(size=(nb, max_ligand, 3)) * 1.5,
                       rng.integers(0, 13, (nb, max_ligand)),
                       np.arange(max_ligand)[None] < sizes[:, None], device=cuda)
    rn = model.net.refine_net
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = rn.graph(x, node_mask, mlig)
        e_w = rn.edge_weights(x, nbh)[..., 0]
    return model, batch, rn, h, x, node_mask, mlig, nbh, e_w


LAYER_CASES = [("knn", 8, 8, 40), ("knn", 32, 8, 40), ("hybrid", 32, 64, 64),
               ("hybrid", 32, 128, 40)]


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", LAYER_CASES)
def test_layer_kernels_match_plain(cuda, cutoff_mode, k, max_ligand, n_protein):
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein)
    assert nbh.idx.shape[-1] == rn.num_neighbors()
    layer = rn.base_block[1]
    with torch.no_grad():
        px, ph = kel.pack_layer_params(layer)
        h_ref = kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w)
        h_out = kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px)
        x_ref = kel.h2x_layer_plain(layer, h_ref, x, nbh, mlig, e_w)
        x_out = kel.h2x_layer_cuda(h_ref, x, nbh, mlig, e_w, max_ligand, ph)
    torch.cuda.synchronize()
    torch.testing.assert_close(h_out, h_ref, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(x_out, x_ref, atol=2e-4, rtol=1e-3)
    # rows without a valid neighbour keep h exactly; protein and padded rows keep x
    empty = ~nbh.mask.any(-1)
    assert bool(empty.any()) and torch.equal(h_out[empty], h[empty])
    assert torch.equal(x_out[~mlig], x[~mlig])


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", LAYER_CASES)
def test_x2h_kernel_callers_match_plain_and_repeat(cuda, cutoff_mode, k, max_ligand, n_protein):
    """The x2h edge kernel through its three callers, each against its plain
    version and each run twice bitwise equal (no atomics: a fixed summation
    order): td_x2h_layer at any K, and at K <= 32 the inference block
    (td_block_x2h) and the train-mode block forward (td_block_train_fwd).
    Each is also held to the float32-grade bar X2H_TOL where its h comes
    from x2h passes alone."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein, seed=4)
    layer = rn.base_block[0]
    with torch.no_grad():
        px, _ = kel.pack_layer_params(layer)
        runs = [kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px) for _ in range(2)]
        ref = kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0], ref, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(runs[0], ref, **X2H_TOL)
    empty = ~nbh.mask.any(-1)
    assert bool(empty.any()) and torch.equal(runs[0][empty], h[empty])
    if nbh.idx.shape[-1] > kblock.MAX_K:
        return
    with torch.no_grad():
        blocks = [kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=max_ligand)
                  for _ in range(2)]
        h_ref, x_ref = rn.block_forward(h, x, nbh, mlig)
        x2h, h2x = kblock.pack_pass_params(rn)
        trains = [kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, max_ligand, x2h, h2x)
                  for _ in range(2)]
        want = kblock.block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w)
    torch.cuda.synchronize()
    m, mk = node_mask[..., None], node_mask[None, :, :, None]
    assert all(torch.equal(a, b) for a, b in zip(*blocks))
    torch.testing.assert_close(blocks[0][0] * m, h_ref * m, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(blocks[0][0] * m, h_ref * m, **X2H_TOL)
    torch.testing.assert_close(blocks[0][1] * m, x_ref * m, atol=2e-4, rtol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(*trains))
    torch.testing.assert_close(trains[0][0] * mk, want[0] * mk, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(trains[0][0] * mk, want[0] * mk, **X2H_TOL)
    torch.testing.assert_close(trains[0][1] * mk, want[1] * mk, atol=2e-4, rtol=1e-3)


def _h2x_edge_alone(rn, h, x, nbh, mlig, e_w, n_ligand, stacks):
    """The h2x edge launch alone (td_block_h2x, or td_block_h2x_bf16 for bf16
    stacks) with the first layer of `stacks`, on node projections from the
    node kernel (row0 = N - n_ligand); x' with the protein rows of x."""
    from targetdiff_tpu_torch.ops.rbf import gaussian_smearing_offsets

    B_, N = h.shape[:2]
    K = nbh.idx.shape[-1]
    ni, nj, q, _ = kblock.node_projections_cuda(h, stacks, row0=N - n_ligand)
    offsets, coeff = gaussian_smearing_offsets(device=h.device)
    x, ew = x.contiguous(), e_w.contiguous()
    idx, nmask, ml = nbh.idx.contiguous(), nbh.mask.contiguous(), mlig.contiguous()
    out = x.clone()
    name = kblock.entry("td_block_h2x", stacks["w_node"].dtype)
    kblock.build.check(kblock._entries()[name](
        x.data_ptr(), idx.data_ptr(), nmask.data_ptr(), ml.data_ptr(), ew.data_ptr(),
        ni.data_ptr(), nj.data_ptr(), q.data_ptr(), offsets.data_ptr(), coeff,
        kblock._pass_structs(stacks, 1)[0], B_, N, K, N - n_ligand, out.data_ptr(),
        kblock.build.stream_ptr(h.device)), name)
    return out


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", LAYER_CASES)
def test_h2x_kernel_callers_match_plain_and_repeat(cuda, cutoff_mode, k, max_ligand, n_protein):
    """The h2x edge kernel through its three callers, each against its plain
    version at the float32-grade bar H2X_TOL and each run twice bitwise
    equal ((row, chunk) units merged in chunk order): td_h2x_layer at any K,
    and at K <= 32 the h2x edge launch alone (td_block_h2x), the inference
    block and the train-mode block forward (td_block_train_fwd)."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein, seed=5)
    layer = rn.base_block[0]
    with torch.no_grad():
        _, ph = kel.pack_layer_params(layer)
        runs = [kel.h2x_layer_cuda(h, x, nbh, mlig, e_w, max_ligand, ph) for _ in range(2)]
        ref = kel.h2x_layer_plain(layer, h, x, nbh, mlig, e_w)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0], ref, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(runs[0], ref, **H2X_TOL)
    assert torch.equal(runs[0][~mlig], x[~mlig])  # protein and padded ligand rows keep x
    tail = torch.arange(h.shape[1], device=cuda) >= h.shape[1] - max_ligand
    assert bool((tail & ~nbh.mask.any(-1)).any())  # ligand-tail rows without a valid edge
    if nbh.idx.shape[-1] > kblock.MAX_K:
        return
    with torch.no_grad():
        alone = [_h2x_edge_alone(rn, h, x, nbh, mlig, e_w, max_ligand, ph) for _ in range(2)]
        blocks = [kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=max_ligand)
                  for _ in range(2)]
        h_ref, x_ref = rn.block_forward(h, x, nbh, mlig)
        x2h, h2x = kblock.pack_pass_params(rn)
        trains = [kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, max_ligand, x2h, h2x)
                  for _ in range(2)]
        want = kblock.block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], alone[1]) and torch.equal(alone[0], runs[0])
    m, mk = node_mask[..., None], node_mask[None, :, :, None]
    assert all(torch.equal(a, b) for a, b in zip(*blocks))
    torch.testing.assert_close(blocks[0][1] * m, x_ref * m, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(blocks[0][1] * m, x_ref * m, **H2X_TOL)
    assert all(torch.equal(a, b) for a, b in zip(*trains))
    torch.testing.assert_close(trains[0][1] * mk, want[1] * mk, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(trains[0][1] * mk, want[1] * mk, **H2X_TOL)


# (complexes, rows, ligand rows) of the node kernel's cases: 225 rows (not a
# multiple of 64), and 18,240 (285 tiles of 64 a column group: more than the
# card holds at once, so every group's persistent walk wraps)
NODE_SHAPES = [(3, 75, 11), (30, 608, 32)]


def _node_rows(cuda, magnitude, nb, n):
    """h [nb, n, 128] with each row's largest |h| near `magnitude` (1e5 lies
    above fp16's range, 1e-5 in its subnormals), entries spread over three
    decades, and a row of zeros."""
    rng = np.random.default_rng(1)
    hv = rng.normal(size=(nb, n, 128)) * 10.0 ** rng.uniform(-3, 0, size=(nb, n, 128))
    hv = hv / np.abs(hv).max(-1, keepdims=True) * magnitude * rng.uniform(0.6, 1.0, (nb, n, 1))
    hv[0, 3] = 0.0
    return torch.tensor(hv, dtype=torch.float32, device=cuda)


def _node_launches(h, st, nl):
    """The node kernel on layer 1 of `st`: (with q1, without q1, with row0 =
    N - nl, with q1 again); asserts what must be bitwise: ni, nj, q alike
    with and without q1, two launches alike, and with row0 > 0 every row's nj
    and the rows >= row0's ni and q those of the full launch."""
    nb, n, _ = h.shape
    with torch.no_grad():
        full = kblock.node_projections_cuda(h, st, layer=1, want_q1=True)
        plain_launch = kblock.node_projections_cuda(h, st, layer=1)
        part = kblock.node_projections_cuda(h, st, layer=1, row0=n - nl)
        again = kblock.node_projections_cuda(h, st, layer=1, want_q1=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(full[:3], plain_launch[:3]))
    assert plain_launch[3] is None
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    dst = (torch.arange(nb * n, device=h.device) % n) >= n - nl
    assert torch.equal(part[1], full[1])
    assert torch.equal(part[0][dst], full[0][dst]) and torch.equal(part[2][dst], full[2][dst])
    return full


@pytest.mark.parametrize("nb,n,nl", NODE_SHAPES)
@pytest.mark.parametrize("magnitude", [1.0, 1e5, 1e-5])
def test_node_kernel_matches_plain(cuda, magnitude, nb, n, nl):
    """The node kernel against float64 on rows of largest |h| near
    `magnitude` (and a row of zeros), for both passes' weights; a launch
    with q1 gives q1 at the same bar (`_node_launches` holds what is
    bitwise)."""
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    stacks = kblock.pack_pass_params(model.net.refine_net)
    h = _node_rows(cuda, magnitude, nb, n)
    for st in stacks:
        full = _node_launches(h, st, nl)
        with torch.no_grad():
            want = kblock.node_projections_plain(
                h.double().reshape(-1, 128), {k: v.double() for k, v in st.items()}, layer=1)
        for name, got, w in zip(("ni", "nj", "q", "q1"), full, want):
            assert bool(got.isfinite().all()), name
            rel = float((got.double() - w).abs().max() / w.abs().max())
            assert rel < NODE_REL, (name, rel)


# The weight-gradient kernel (three-term TF32) against float64: |got - want|
# <= WG_BAR * s elementwise, s[p][q] the root-sum-square of the entry's M
# terms (a float32-grade product sits ~1e-7..3e-6 s from it, one TF32
# product per term ~3e-4 s: tests/test_torch_weight_grad.py).
WG_BAR = 1e-5
# run_pass's products (csrc/pass_bwd.cuh), M cut down: M, P, Q, then X's and
# Y's row length and the first column taken
WG_CASES = {
    "w2k": (4096, 128, 128, 256, 0, 256, 0),
    "w2v_h2x": (4096, 128, 16, 256, 128, 144, 128),
    "table": (4096, 84, 256, 84, 0, 256, 0),
    "w_node": (2048, 128, 640, 128, 0, 1680, 0),
    "w_q2": (2048, 128, 128, 128, 0, 1792, 1408),
    "odd_rows": (4096 + 7, 128, 128, 256, 128, 256, 128),
    # an odd M at Q = 16: 37 chunks, the last cluster padded with an empty one
    "odd_q16": (9 * 1024 + 13, 128, 16, 256, 128, 144, 128),
}


@pytest.mark.parametrize("case", list(WG_CASES))
def test_weight_grad_kernel_matches_float64_and_repeats(cuda, case):
    """X^T Y on the kernel, operands as column slices of wider rows (as
    run_pass passes them) whose columns span 1e-9 to 1e5, zero-mean: within
    WG_BAR of float64 entry by entry, and two launches bitwise equal."""
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    M, P, Q, ldx, ox, ldy, oy = WG_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(M + P + Q)

    def operand(ld, off, n):
        order = torch.randperm(n, generator=gen, device=cuda)
        rows = torch.randn((M, ld), generator=gen, device=cuda)
        rows[:, off:off + n] *= 10.0 ** torch.linspace(-9, 5, n, device=cuda)[order]
        return rows[:, off:off + n]

    X, Y = operand(ldx, ox, P), operand(ldy, oy, Q)
    launches = kwg.LAUNCHES["alone"]
    got, again = kwg.weight_grad_cuda(X, Y), kwg.weight_grad_cuda(X, Y)
    x, y = X.double(), Y.double()
    want, s = x.T @ y, ((x * x).T @ (y * y)).sqrt()
    torch.cuda.synchronize()
    assert kwg.LAUNCHES["alone"] == launches + 2
    assert torch.equal(got, again)
    err = float(((got.double() - want).abs() / s).max())
    assert err <= WG_BAR, err


@pytest.mark.parametrize("dtype,cluster", [(torch.float32, 2), (torch.bfloat16, 1)],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("case", list(WG_CASES))
def test_weight_grad_split_is_whole_clusters_in_one_wave(cuda, case, dtype, cluster):
    """The split the card takes (td_weight_grad_partials): row chunks of at
    least 256 rows, a whole number of 32-row stages, in clusters of 2 for
    float32 (the last padded with an empty chunk where their count is odd)
    and of 1 (no cluster) for bf16, one partial a cluster for reduce_kernel,
    no more clusters than the card holds at once."""
    import math

    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    M, P, Q = WG_CASES[case][:3]
    plan = kwg.plan(M, P, Q, dtype)
    rows, S, C = plan["chunk_rows"], plan["chunks"], plan["cluster"]
    tiles = math.ceil(P / 128) * math.ceil(Q / 128)
    assert C == cluster and plan["groups"] == 8 and plan["cluster_wave"] >= 64, plan
    assert rows % 32 == 0 and rows >= 256, plan
    assert S % C == 0 and 0 <= S - math.ceil(M / rows) < C and plan["partials"] == S // C, plan
    assert plan["partials"] * tiles <= plan["cluster_wave"], plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_weight_grad_refuses_unaligned_out_and_scratch(cuda, dtype):
    """reduce_kernel stores (and reads its partials) 16 bytes at a time: an
    out or a partial scratch off a 16-byte boundary is refused, by
    weight_grad_cuda before the launch and by the C entries themselves
    (td_weight_grad(_bf16), td_reduce_partials), with no launch counted,
    and the context is still usable afterwards."""
    from targetdiff_tpu_torch.ops.kernels import build
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    X = torch.randn((512, 128), device=cuda)
    Y = torch.randn((512, 16), device=cuda)
    base = torch.empty(128 * 16 + 4, device=cuda)
    odd = base[1:1 + 128 * 16].view(128, 16)  # 4 bytes past a 16-byte boundary
    counts = kwg.BF16_LAUNCHES if dtype == torch.bfloat16 else kwg.LAUNCHES
    before = dict(counts)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kwg.weight_grad_cuda(X, Y, odd, dtype=dtype)
    size, fns = kwg._entries()
    partial = torch.empty(size() + 4, device=cuda)
    stream = build.stream_ptr(cuda)
    for out, scratch in ((odd, partial), (base[:128 * 16], partial[1:])):
        assert fns[dtype](X.data_ptr(), 128, Y.data_ptr(), 16, 512, 128, 16, out.data_ptr(),
                          scratch.data_ptr(), stream) != 0
    partials = torch.randn((3, 68), device=cuda)
    assert fns["reduce"](partials.data_ptr(), 3, 64, base[1:].data_ptr(), stream) != 0
    assert fns["reduce"](partials[:, 1:].data_ptr(), 3, 64, base.data_ptr(), stream) != 0
    assert counts == before
    got = kwg.weight_grad_cuda(X, Y, dtype=dtype)
    torch.cuda.synchronize()
    assert bool(got.isfinite().all())


@pytest.mark.parametrize("S,n", [(131, 128 * 128), (66, 84 * 256), (7, 1792), (3, 16)])
def test_reduce_kernel_alone_is_its_plain_order_bitwise(cuda, S, n):
    """reduce_kernel alone (`weight_grad.reduce_partials`) at the partials
    of the B=32 step's x2h w2k and table products, of the column sums, and a
    narrow one: bitwise `reduce_plain` on the same card tensors (its ranges
    in the same order), and two launches bitwise equal."""
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    gen = torch.Generator(device=cuda).manual_seed(S + n)
    partials = torch.randn((S, n), generator=gen, device=cuda) * 10.0 ** torch.empty(
        (S, 1), device=cuda).uniform_(-6, 6, generator=gen)
    got, again = kwg.reduce_partials(partials), kwg.reduce_partials(partials)
    want = kwg.reduce_plain(partials)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, want)


@pytest.mark.parametrize("passes", [18, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_batched_staging_equals_per_pass_staging(cuda, dtype, passes):
    """stage_w2_kernel for every pass of a backward at once (18: the block's
    2L at L = 9, x2h V = 128 and h2x V = 16 alternating as td_block_bwd
    stages them; 70: two launches of at most 64 passes) gives, word for
    word, its launch at a pass count of 1 for each pass and the plain
    layouts (`block_vjp.pass_words`: stage_frags / stage_frags16's words);
    one launch counted per 64 passes, in the instantiation's own counter."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    gen = torch.Generator(device=cuda).manual_seed(passes)
    widths = [16 if i % 2 else 128 for i in range(passes)]
    w2k = [(torch.randn((128, 128), generator=gen, device=cuda)
            * 10.0 ** torch.empty((128, 1), device=cuda).uniform_(-3, 1, generator=gen)).to(dtype)
           for _ in widths]
    w2v = [(torch.randn((128, V), generator=gen, device=cuda)
            * 10.0 ** torch.empty((128, 1), device=cuda).uniform_(-3, 1, generator=gen)).to(dtype)
           for V in widths]
    bf16 = dtype == torch.bfloat16
    counters = ("BF16_STAGE_W2_LAUNCHES", "STAGE_W2_LAUNCHES")[::1 if bf16 else -1]
    before = [getattr(block_vjp, c) for c in counters]
    batch = block_vjp.stage_w2(w2k, w2v, dtype)
    torch.cuda.synchronize()
    assert [getattr(block_vjp, c) - b for c, b in zip(counters, before)] == [
        -(-passes // 64), 0]
    for i, (k, v) in enumerate(zip(w2k, w2v)):
        one = block_vjp.stage_w2([k], [v], dtype)
        assert torch.equal(batch[i], one[0]), i
        assert torch.equal(batch[i].cpu(), block_vjp.pass_words(k.cpu(), v.cpu(), dtype)), i


def test_weight_grad_kernel_refuses_unaligned_operands(cuda):
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg

    rows = torch.randn((64, 132), device=cuda)
    Y = torch.randn((64, 16), device=cuda)
    for X in (rows[:, 1:129], rows[:, :126]):  # base 4 bytes off; P not a multiple of 4
        with pytest.raises(RuntimeError, match="td_weight_grad"):
            kwg.weight_grad_cuda(X, Y)


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", LAYER_CASES)
def test_layer_vjp_kernels_match_autograd(cuda, cutoff_mode, k, max_ligand, n_protein):
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kvjp

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(k)
    layer = rn.base_block[0]

    def run(sub, trainable):
        leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
        rn.zero_grad()
        if sub == "x2h":
            fn = kvjp.x2h_layer_trainable if trainable else kvjp.x2h_layer_plain
            out = fn(layer, leaves[0], leaves[1], nbh, mlig, leaves[2])
        else:
            fn = kvjp.h2x_layer_trainable if trainable else kvjp.h2x_layer_plain
            args = (max_ligand,) if trainable else ()
            out = fn(layer, leaves[0], leaves[1], nbh, mlig, leaves[2], *args)
        (out * cot[sub]).sum().backward()
        grads = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
        grads.update(dh=leaves[0].grad, dx=leaves[1].grad, de_w=leaves[2].grad)
        return grads

    cot = {"x2h": torch.randn(h.shape, generator=gen, device=cuda) * node_mask[..., None],
           "h2x": torch.randn(x.shape, generator=gen, device=cuda)}
    for sub in ("x2h", "h2x"):
        launches = (kvjp.X2H_BWD_LAUNCHES, kvjp.H2X_BWD_LAUNCHES)
        got, again, want = run(sub, True), run(sub, True), run(sub, False)
        torch.cuda.synchronize()
        assert (kvjp.X2H_BWD_LAUNCHES - launches[0], kvjp.H2X_BWD_LAUNCHES - launches[1]) == (
            (2, 0) if sub == "x2h" else (0, 2))
        assert all(torch.equal(got[n], again[n]) for n in got)  # fixed summation order
        assert sorted(got) == sorted(want)
        assert all(bool(g.isfinite().all()) for g in got.values())
        grads_close(got, want)
        empty = ~nbh.mask.any(-1)
        assert bool((got["de_w"][empty] == 0).all())


def test_layer_forward_kernels_take_more_nodes_than_the_backwards(cuda):
    """N = 4104, above the backwards' inverse-adjacency limit: the forward
    kernels still match the plain layers; the backwards refuse, naming it."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kvjp

    _, _, rn, h, x, _, mlig, nbh, e_w = _layer_setup(cuda, "knn", 8, 8, kvjp.MAX_NODES)
    assert h.shape[1] > kvjp.MAX_NODES
    layer = rn.base_block[0]
    with torch.no_grad():
        px, ph = kel.pack_layer_params(layer)
        h_ref = kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w)
        h_out = kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px)
        x_ref = kel.h2x_layer_plain(layer, h_ref, x, nbh, mlig, e_w)
        x_out = kel.h2x_layer_cuda(h_ref, x, nbh, mlig, e_w, 8, ph)
    torch.cuda.synchronize()
    torch.testing.assert_close(h_out, h_ref, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(x_out, x_ref, atol=2e-4, rtol=1e-3)
    with pytest.raises(ValueError, match=f"N <= {kvjp.MAX_NODES}"):
        kvjp.x2h_layer_bwd_cuda(h, x, nbh, mlig, e_w, px, h)


def test_hybrid_train_loss_per_layer_path_matches_eager(cuda):
    model, batch, *_ = _layer_setup(cuda, "hybrid", 32, 64, 64, seed=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    t = torch.tensor([0, 7, 19], device=cuda)
    eps = torch.randn(batch.ligand_pos.shape, generator=gen, device=cuda)
    u = torch.rand(batch.ligand_v.shape + (13,), generator=gen, device=cuda)
    out = {}
    for impl in ("fast_pl", "eager"):
        model.net.zero_grad()
        loss = model.get_diffusion_loss(batch, time_step=t, pos_noise=eps, v_uniform=u,
                                        impl=impl)["loss"]
        loss.backward()
        out[impl] = (float(loss), {n: p.grad.clone() for n, p in model.net.named_parameters()})
    assert abs(out["fast_pl"][0] - out["eager"][0]) <= 1e-4 * abs(out["eager"][0])
    grads_close(out["fast_pl"][1], out["eager"][1])


def test_hybrid_sampling_runs_the_layer_kernels(cuda):
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    model, batch, *_ = _layer_setup(cuda, "hybrid", 32, 64, 64, seed=3)
    launches, block = kel.X2H_LAUNCHES, kblock.LAUNCHES
    with pytest.warns(UserWarning, match="per-layer"):
        res = model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v,
                                     torch.Generator(device=cuda).manual_seed(0), num_steps=3,
                                     dtype=torch.float32)
    assert kel.X2H_LAUNCHES - launches == 3 * 2 and kblock.LAUNCHES == block
    assert bool(res.pos.isfinite().all())


# The backward's node kernel (csrc/node_bwd.cuh) alone: rows, V (the pass's
# value width: 128 x2h, 16 h2x). 13,312 rows are the B=32 train step's (N =
# 416; 64-row tiles); one count that is not a multiple of the 64-row tile and
# one of the 32-row tile (2,432 rows: the B=4 block backward's).
NODE_BWD_CASES = {"x2h_B32": (13312, 128), "h2x_B32": (13312, 16),
                  "x2h_ragged64": (13312 - 5, 128), "h2x_ragged32": (2432 + 7, 16)}


@pytest.mark.parametrize("case", list(NODE_BWD_CASES))
def test_node_bwd_kernel_holds_the_float64_bar_and_repeats(cuda, case):
    """The backward's node kernel alone against float64 (`node_bwd_plain` on
    float64 copies, with the kernel's own ReLU mask), as chip_smoke.py
    [train-block node-bwd] holds it: every output within NODE_BWD_BAR of its
    scale; the row buffer's other columns untouched; two runs bitwise equal;
    each run one launch as the library counts them."""
    from chip_smoke import NODE_BWD_BAR, node_bwd_errs, node_bwd_operands
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    rows, V = NODE_BWD_CASES[case]
    ops = node_bwd_operands(torch, cuda, rows, V)
    rowbuf, q1, dh, q_ln, w_q2T, w_nodeT = ops
    launched = block_vjp.NODE_BWD_LAUNCHES
    got = block_vjp.node_bwd_cuda(rowbuf.clone(), q1, dh.clone(), q_ln, w_q2T, w_nodeT)
    again = block_vjp.node_bwd_cuda(rowbuf.clone(), q1, dh.clone(), q_ln, w_q2T, w_nodeT)
    torch.cuda.synchronize()
    assert block_vjp.NODE_BWD_LAUNCHES - launched == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = block_vjp.node_bwd_plain(*[t.double() for t in ops], relu_mask=got[1] > 0)
    errs = node_bwd_errs(got, want)
    assert max(v for k, v in errs.items() if k.endswith("_over_scale")) < NODE_BWD_BAR, errs
    lay = block_vjp.row_layout(128, V)
    kept = torch.ones(lay["width"], dtype=torch.bool, device=cuda)
    kept[4 * 128:5 * 128] = kept[lay["qln"]:lay["qln"] + 256] = False
    assert torch.equal(got[0][:, kept], rowbuf[:, kept])


@pytest.mark.parametrize("rows,tile", [(13312, 64), (2432, 32)])
def test_node_bwd_kernel_occupancy(cuda, rows, tile):
    """The node kernel as the card makes it: 64-row tiles where they fill the
    card's SMs, else 32; at most 128 registers, no spills, two blocks per SM."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    info = block_vjp.node_bwd_info(rows)
    assert info["tile_rows"] == tile
    assert info["registers"] <= 128 and info["local_bytes"] == 0
    assert info["blocks_per_sm"] == 2


@pytest.mark.parametrize("case", ["knn_K32", "hybrid_K95", "knn_B100"])
def test_edge_weight_kernel_holds_the_float64_bar_and_repeats(cuda, case):
    """The edge-weight kernel alone (csrc/block_denoiser.cu ew_kernel) on the
    kNN graph (K = 32), the hybrid graph (K = 95) and the kNN graph at the
    bench's batch of 100 (chip_smoke.EW_CASES): e_w of every valid slot
    within EW_TOL of the module's edge weights in float64; two runs bitwise
    equal; every slot finite."""
    from chip_smoke import EW_TOL, ew_case

    rn, x, nbh, packed = ew_case(torch, cuda, case)
    with torch.no_grad():
        got = kblock.edge_weights_cuda(x, nbh, packed)
        again = kblock.edge_weights_cuda(x, nbh, packed)
        want = copy.deepcopy(rn).double().edge_weights(x.double(), nbh)[..., 0]
    torch.cuda.synchronize()
    assert nbh.idx.shape[-1] == (95 if case == "hybrid_K95" else 32)
    assert torch.equal(got, again) and bool(got.isfinite().all())
    assert float((got.double() - want)[nbh.mask].abs().max()) < EW_TOL["atol"]


@pytest.mark.parametrize("k,n", [(k, n) for n in (45, 608, 1100) for k in (1, 8, 32, 48)
                                 if k <= n])
def test_knn_kernel_bitwise_equal_to_exact_on_ties(cuda, k, n):
    """Both kNN kernels (the warp list for k <= 32, K rounds for k = 48) on
    tie-heavy inputs: positions on an integer grid (many equal distances)
    and on a scaled, shifted one (rounding decides near-ties), scattered
    masked rows, a complex with 5 valid atoms and an all-masked one; idx and
    mask bitwise equal to knn_graph_exact on every entry, masked slots too."""
    rng = np.random.default_rng(k * 10000 + n)
    for scale, shift in ((1.0, 0.0), (0.37, 10.0)):
        pos = torch.tensor(rng.integers(0, 6, size=(4, n, 3)) * scale + shift,
                           dtype=torch.float32, device=cuda)
        mask = torch.ones((4, n), dtype=torch.bool, device=cuda)
        mask[1, torch.from_numpy(rng.random(n) < 0.3).to(cuda)] = False
        mask[2, 5:] = False
        mask[3] = False
        want = G.knn_graph_exact(pos, mask, k)
        got = kknn.knn_graph_cuda(pos, mask, k)
        torch.cuda.synchronize()
        assert torch.equal(got.idx, want.idx) and torch.equal(got.mask, want.mask)


def _adjacency_case(cuda, case):
    """(idx, nmask, n_ligand) of an adjacency case: the B=32 train step's
    kNN graph (N = 416, K = 32), the hybrid graph of four complexes (N =
    640, K = 95), or random indices repeating sources within rows."""
    from targetdiff_tpu_torch.data.synth import synth_batch

    rng = np.random.default_rng(5)
    if case == "train_knn_K32":
        tb = synth_batch(rng, 32, max_protein=384, max_ligand=32, n_protein_range=(330, 331),
                         n_ligand_range=(18, 28), device=cuda)
        pos = torch.cat([tb.protein_pos, tb.ligand_pos], 1).float()
        mask = torch.cat([tb.protein_mask, tb.ligand_mask], 1)
        nbh = kknn.knn_graph_cuda(pos, mask, 32)
        return nbh.idx, nbh.mask, 32
    if case == "hybrid_K95":
        pos = torch.tensor(rng.normal(size=(4, 640, 3)) * 5, dtype=torch.float32, device=cuda)
        mask = torch.ones((4, 640), dtype=torch.bool, device=cuda)
        mask[:, 572:576] = False
        mask[1, 576 + 40:] = False
        mlig = mask.clone()
        mlig[:, :576] = False
        nbh = G.hybrid_graph(pos, mask, mlig, 32, 64)
        return nbh.idx, nbh.mask, 64
    idx = torch.tensor(rng.integers(0, 9, size=(8, 200, 24)), device=cuda)
    return idx, torch.tensor(rng.random((8, 200, 24)) < 0.6, device=cuda), 40


@pytest.mark.parametrize("case", ["train_knn_K32", "hybrid_K95", "repeats"])
@pytest.mark.parametrize("h2x", [False, True])
def test_adjacency_kernel_bitwise_equal_to_plain(cuda, case, h2x):
    """build_adjacency alone (adjacency_cuda) for the x2h pass (row0 = 0)
    and the h2x pass (row0 = N - n_ligand): off and each source's list
    bitwise equal to adjacency_plain, two builds equal, one build counted."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    idx, nmask, n_lig = _adjacency_case(cuda, case)
    row0 = idx.shape[1] - n_lig if h2x else 0
    built = block_vjp.ADJ_LAUNCHES
    off, lst = block_vjp.adjacency_cuda(idx, nmask, row0)
    off2, lst2 = block_vjp.adjacency_cuda(idx, nmask, row0)
    want_off, want_lst = block_vjp.adjacency_plain(idx, nmask, row0)
    torch.cuda.synchronize()
    assert block_vjp.ADJ_LAUNCHES - built == 2
    assert torch.equal(off, want_off) and torch.equal(off2, want_off)
    n = want_off[:, -1]
    live = torch.arange(lst.shape[1], device=cuda)[None] < n[:, None]
    assert torch.equal(lst[live], want_lst[live]) and torch.equal(lst2[live], want_lst[live])


# fix_x (the embedding export): the whole-block route at kNN K = 32 and the
# per-layer route at the hybrid graph's K = 95 (64 ligand slots)
FIX_X_CASES = [("knn", 32, 8, 40), ("hybrid", 32, 64, 64)]


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", FIX_X_CASES)
def test_fix_x_kernels_match_plain_without_the_h2x_pass(cuda, cutoff_mode, k, max_ligand,
                                                        n_protein):
    """Under fix_x the kernels launch L x2h passes and no h2x pass a block,
    give back x bitwise as given, and match the plain block_forward(fix_x)
    on h at the [block] bars (and the x2h kernel's float32-grade bar, h
    coming from x2h passes alone); fetch_embedding on the kernels matches
    the eager one the same way."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    model, batch, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(
        cuda, cutoff_mode, k, max_ligand, n_protein, seed=6)
    L = len(rn.base_block)
    m = node_mask[..., None]
    if nbh.idx.shape[-1] <= kblock.MAX_K:
        before = (kblock.LAUNCHES, kblock.X2H_PASS_LAUNCHES, kblock.H2X_PASS_LAUNCHES)
        with torch.no_grad():
            h_out, x_out = kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=max_ligand,
                                                 fix_x=True)
            h_ref, x_ref = rn.block_forward(h, x, nbh, mlig, fix_x=True)
        torch.cuda.synchronize()
        after = (kblock.LAUNCHES, kblock.X2H_PASS_LAUNCHES, kblock.H2X_PASS_LAUNCHES)
        assert tuple(b - a for a, b in zip(before, after)) == (1, L, 0)
        assert torch.equal(x_out, x) and torch.equal(x_ref, x)
        torch.testing.assert_close(h_out * m, h_ref * m, atol=2e-3, rtol=1e-2)
        torch.testing.assert_close(h_out * m, h_ref * m, **X2H_TOL)

    counts = lambda: (kblock.X2H_PASS_LAUNCHES, kblock.H2X_PASS_LAUNCHES,  # noqa: E731
                      kel.X2H_LAUNCHES, kel.H2X_LAUNCHES)
    before = counts()
    if cutoff_mode == "hybrid":
        with pytest.warns(UserWarning, match="per-layer"):
            fast = model.fetch_embedding(batch, impl="fast")
    else:
        fast = model.fetch_embedding(batch, impl="fast")
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(before, counts()))
    assert launched == ((L, 0, 0, 0) if cutoff_mode == "knn" else (0, 0, L, 0))
    ref = model.fetch_embedding(batch, impl="eager")
    assert torch.equal(fast["pred_ligand_pos"], batch.ligand_pos)
    rows = torch.cat([batch.protein_mask, batch.ligand_mask], 1)[..., None]
    torch.testing.assert_close(fast["final_h"] * rows, ref["final_h"] * rows, atol=2e-3,
                               rtol=1e-2)
    lm = batch.ligand_mask[..., None]
    torch.testing.assert_close(fast["pred_ligand_v"] * lm, ref["pred_ligand_v"] * lm,
                               atol=2e-3, rtol=1e-2)


def test_likelihood_on_the_kernels_matches_eager(cuda):
    """likelihood_estimation on the kernels against the eager path with the
    same draws, at JAX's bar (rtol 2e-3, atol 2e-4): one kNN and one block
    launch per step call, none for the prior terms, which are bitwise equal."""
    from targetdiff_tpu_torch.ops.kernels import knn as kknn

    torch.manual_seed(0)
    model = DiffusionModel(Config(dict(CONFIG, knn=32)), 27, 13, device=cuda)
    batch = _complexes(cuda, seed=2)
    T = model.num_timesteps
    t = torch.tensor([0, 1, T // 2], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    noise = torch.randn(batch.ligand_pos.shape, generator=gen, device=cuda)
    uniform = torch.rand(batch.ligand_v.shape + (13,), generator=gen, device=cuda)
    before = (kknn.LAUNCHES, kblock.LAUNCHES)
    fast = model.likelihood_estimation(batch, t, pos_noise=noise, v_uniform=uniform,
                                       impl="fast")
    torch.cuda.synchronize()
    assert (kknn.LAUNCHES - before[0], kblock.LAUNCHES - before[1]) == (1, 1)
    eager = model.likelihood_estimation(batch, t, pos_noise=noise, v_uniform=uniform,
                                        impl="eager")
    for a, b in zip(fast, eager):
        assert bool(a.isfinite().all())
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-3)
    before = (kknn.LAUNCHES, kblock.LAUNCHES)
    prior = [model.likelihood_estimation(batch, torch.full((3,), T, device=cuda), impl=impl)
             for impl in ("fast", "eager")]
    assert (kknn.LAUNCHES, kblock.LAUNCHES) == before
    assert all(torch.equal(a, b) for a, b in zip(*prior))


EGNN_CONFIG = dict(CONFIG, model_type="egnn", num_layers=3, knn=32)


def test_egnn_denoiser_on_the_card_matches_the_cpu(cuda):
    """The EGNN denoiser (kNN kernel, one launch per layer) against the same
    weights and inputs on the CPU (the plain graph), at the suite's bars."""
    torch.manual_seed(0)
    model = DiffusionModel(Config(EGNN_CONFIG), 27, 13, device=cuda, max_ligand=NL)
    cpu = DiffusionModel(Config(EGNN_CONFIG), 27, 13, device="cpu", max_ligand=NL)
    cpu.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    batch = _complexes(cuda, seed=3)
    kknn.LAUNCHES = 0
    with torch.no_grad():
        got = model.apply(batch, batch.ligand_pos, batch.ligand_v)
        torch.cuda.synchronize()
        launches = kknn.LAUNCHES
        want = cpu.apply(batch.to("cpu"), batch.ligand_pos.cpu(), batch.ligand_v.cpu())
    assert launches == EGNN_CONFIG["num_layers"]
    lm = batch.ligand_mask.cpu()[..., None]
    torch.testing.assert_close(got["pred_ligand_pos"].cpu() * lm, want["pred_ligand_pos"] * lm,
                               atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(got["pred_ligand_v"].cpu() * lm, want["pred_ligand_v"] * lm,
                               atol=2e-3, rtol=1e-2)
    with pytest.raises(ValueError, match="egnn"):
        model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)


def _prop_batch(device, B_=4, NP2=60, NL2=12, seed=4):
    from targetdiff_tpu_torch.models.prop.prop_model import PropBatch

    rng = np.random.default_rng(seed)
    pmask = np.ones((B_, NP2), bool)
    pmask[0, 50:] = False
    lmask = np.ones((B_, NL2), bool)
    lmask[1, 7:] = False

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return PropBatch(t(rng.normal(size=(B_, NP2, 3)) * 4), t(rng.random((B_, NP2, 27)) > 0.7),
                     t(pmask, torch.bool), t(rng.normal(size=(B_, NL2, 3))),
                     t(rng.random((B_, NL2, 30))), t(lmask, torch.bool),
                     t(rng.normal(size=B_) + 6), t(np.arange(B_) % 3 + 1, torch.long))


@pytest.mark.parametrize("knn", [24, 48])
def test_prop_encoder_on_the_card_matches_the_cpu(cuda, knn):
    """PropPredNet at the PDBBind config's width (hidden 256, 64 knots) with
    one kNN launch per forward (K = 48: the rounds kernel) against the CPU."""
    from targetdiff_tpu_torch.models.prop.prop_model import PropPredNet

    cfg = Config(dict(hidden_channels=256, encoder=dict(
        name="egnn", num_layers=2, hidden_dim=256, edge_dim=0, num_r_gaussian=64,
        act_fn="relu", norm=False, knn=knn, cutoff=10.0)))
    torch.manual_seed(1)
    model = PropPredNet(cfg, 27, 30).to(cuda)
    cpu = PropPredNet(cfg, 27, 30)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = _prop_batch(cuda)
    kknn.LAUNCHES = 0
    with torch.no_grad():
        got = model(batch).cpu()
        launches = kknn.LAUNCHES
        want = cpu(batch.to("cpu"))
    assert launches == 1
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)


def test_knn_rounds_kernel_at_the_prop_shape(cuda):
    """knn_rounds_kernel (K = 48) on 16 complexes padded to train_prop's
    512 + 96 slots, bitwise equal to knn_graph_exact."""
    rng = np.random.default_rng(48)
    pos = torch.tensor(rng.normal(size=(16, 608, 3)) * 6, dtype=torch.float32, device=cuda)
    mask = torch.zeros((16, 608), dtype=torch.bool, device=cuda)
    for i in range(16):
        mask[i, :int(rng.integers(300, 512))] = True
        mask[i, 512:512 + int(rng.integers(10, 96))] = True
    got = kknn.knn_graph_cuda(pos, mask, 48)
    want = G.knn_graph_exact(pos, mask, 48)
    torch.cuda.synchronize()
    assert torch.equal(got.idx, want.idx) and torch.equal(got.mask, want.mask)


# ---- the bf16 kernels (dtype=torch.bfloat16, the sampling default) ----------
# A bf16 kernel against its bf16 plain version: both multiply the same bf16
# operands exactly and sum in float32, but an activation that lands on the
# other side of a bf16 rounding boundary (float32 sums in another order) moves
# its products by a bf16 step, so a few entries sit up to a bf16 step apart
# and the rest float32-close. Held: every entry within BF16_BAR of the
# tensor's scale (the JAX package's bf16 bar), and the median BF16_MEDIAN
# times closer to the bf16 plain version than to the float32 one (the
# float32 kernel there is as far from both as bf16 rounding puts it).
BF16_BAR = 2e-2
BF16_MEDIAN = 4.0


def bf16_close(name, got, want_bf16, want_f32, mask=None):
    """Max and median |got - want| over the scale of want, against the bf16
    and the float32 plain versions; asserts the bars above."""
    if mask is not None:
        got, want_bf16, want_f32 = got[mask], want_bf16[mask], want_f32[mask]
    scale = float(want_bf16.abs().max())
    d_bf, d_f32 = (got - want_bf16).abs() / scale, (got - want_f32).abs() / scale
    fields = {"max": float(d_bf.max()), "median": float(d_bf.median()),
              "median_vs_f32": float(d_f32.median())}
    assert fields["max"] < BF16_BAR, (name, fields)
    assert fields["median"] * BF16_MEDIAN < fields["median_vs_f32"], (name, fields)
    return fields


@pytest.mark.parametrize("k", [8, 32])
def test_bf16_block_kernels_match_plain(cuda, k):
    """The bf16 block kernels (the block_denoiser_bf16 entry points) against
    the bf16 plain block; launches counted apart from the float32 ones."""
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    rn = model.net.refine_net
    batch = _complexes(cuda)
    before = (kblock.LAUNCHES, kblock.EW_LAUNCHES, kblock.BF16_LAUNCHES, kblock.BF16_EW_LAUNCHES,
              kblock.BF16_X2H_PASS_LAUNCHES, kblock.BF16_H2X_PASS_LAUNCHES)
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = G.knn_graph(x, node_mask, k)
        want = {d: rn.block_forward(h, x, nbh, mlig, dtype=d)
                for d in (torch.bfloat16, torch.float32)}
        runs = [kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=NL, dtype=torch.bfloat16)
                for _ in range(2)]
    torch.cuda.synchronize()
    after = (kblock.LAUNCHES, kblock.EW_LAUNCHES, kblock.BF16_LAUNCHES, kblock.BF16_EW_LAUNCHES,
             kblock.BF16_X2H_PASS_LAUNCHES, kblock.BF16_H2X_PASS_LAUNCHES)
    L = len(rn.base_block)
    assert tuple(b - a for a, b in zip(before, after)) == (0, 0, 2, 2, 2 * L, 2 * L)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    m = node_mask
    bf16_close("h", runs[0][0], want[torch.bfloat16][0], want[torch.float32][0], m)
    bf16_close("x", runs[0][1], want[torch.bfloat16][1], want[torch.float32][1], mlig)
    assert torch.equal(runs[0][1][:, :NP_], x[:, :NP_])
    with torch.no_grad(), pytest.raises(ValueError, match="packed"):
        kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=NL,
                              packed=kblock.pack_block_params(rn), dtype=torch.bfloat16)


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", LAYER_CASES)
def test_bf16_layer_kernels_match_plain(cuda, cutoff_mode, k, max_ligand, n_protein):
    """The bf16 per-layer x2h and h2x kernels against their bf16 plain layers;
    rows without a valid neighbour keep h, protein rows keep x, both bitwise."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein)
    layer = rn.base_block[1]
    before = (kel.X2H_LAUNCHES, kel.H2X_LAUNCHES, kel.BF16_X2H_LAUNCHES, kel.BF16_H2X_LAUNCHES)
    with torch.no_grad():
        px, ph = kel.pack_layer_params(layer, torch.bfloat16)
        h_want = {d: kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, d)
                  for d in (torch.bfloat16, torch.float32)}
        h_out = kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px, torch.bfloat16)
        hb = h_want[torch.bfloat16]
        x_want = {d: kel.h2x_layer_plain(layer, hb, x, nbh, mlig, e_w, d)
                  for d in (torch.bfloat16, torch.float32)}
        x_out = kel.h2x_layer_cuda(hb, x, nbh, mlig, e_w, max_ligand, ph, torch.bfloat16)
    torch.cuda.synchronize()
    after = (kel.X2H_LAUNCHES, kel.H2X_LAUNCHES, kel.BF16_X2H_LAUNCHES, kel.BF16_H2X_LAUNCHES)
    assert tuple(b - a for a, b in zip(before, after)) == (0, 0, 1, 1)
    bf16_close("h", h_out, h_want[torch.bfloat16], h_want[torch.float32], node_mask)
    bf16_close("x", x_out, x_want[torch.bfloat16], x_want[torch.float32], mlig)
    empty = ~nbh.mask.any(-1)
    assert torch.equal(h_out[empty], h[empty]) and torch.equal(x_out[~mlig], x[~mlig])
    with torch.no_grad(), pytest.raises(ValueError, match="packed"):
        kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px, torch.float32)


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein",
                         LAYER_CASES + [("hybrid", 32, 225, 40)])
def test_bf16_x2h_mma_kernel_takes_any_k_and_repeats(cuda, cutoff_mode, k, max_ligand,
                                                     n_protein):
    """The bf16 x2h edge kernel (csrc/x2h_edge_bf16.cuh) through the
    per-layer entry at K = 8, 32, 95, 159 and kMaxLayerK = 256: against the
    bf16 plain layer, two launches bitwise equal, rows without a valid
    neighbour h bitwise."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein)
    layer = rn.base_block[0]
    with torch.no_grad():
        px, _ = kel.pack_layer_params(layer, torch.bfloat16)
        runs = [kel.x2h_layer_cuda(h, x, nbh, mlig, e_w, px, torch.bfloat16) for _ in range(2)]
        want = {d: kel.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, d)
                for d in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    assert torch.equal(*runs)
    bf16_close("h", runs[0], want[torch.bfloat16], want[torch.float32], node_mask)
    empty = ~nbh.mask.any(-1)
    assert bool(empty.any()) and torch.equal(runs[0][empty], h[empty])


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein",
                         LAYER_CASES + [("hybrid", 32, 225, 40)])
def test_bf16_h2x_mma_kernel_takes_any_k_and_repeats(cuda, cutoff_mode, k, max_ligand,
                                                     n_protein):
    """The bf16 h2x edge kernel (csrc/h2x_edge_bf16.cuh) through the
    per-layer entry at K = 8, 32, 95, 159 and kMaxLayerK = 256: against the
    bf16 plain layer, two launches bitwise equal, ligand-tail rows without a
    valid neighbour and every row outside the ligands x bitwise."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein, seed=5)
    layer = rn.base_block[0]
    with torch.no_grad():
        _, ph = kel.pack_layer_params(layer, torch.bfloat16)
        runs = [kel.h2x_layer_cuda(h, x, nbh, mlig, e_w, max_ligand, ph, torch.bfloat16)
                for _ in range(2)]
        want = {d: kel.h2x_layer_plain(layer, h, x, nbh, mlig, e_w, d)
                for d in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    assert torch.equal(*runs)
    bf16_close("x", runs[0], want[torch.bfloat16], want[torch.float32], mlig)
    tail = torch.arange(h.shape[1], device=cuda) >= h.shape[1] - max_ligand
    empty = tail & ~nbh.mask.any(-1)
    assert bool(empty.any()) and torch.equal(runs[0][empty], x[empty])
    assert torch.equal(runs[0][~mlig], x[~mlig])


# (cutoff mode, k, ligand slots, protein slots, complexes) of the sampling
# path's h2x launches at the example pocket's size: kNN B=4 and B=100 (N =
# 608, K = 32) and the hybrid graph (N = 640, K = 95)
H2X_SAMPLING_CASES = {"knn_B4": ("knn", 32, 32, 576, 4), "knn_B100": ("knn", 32, 32, 576, 100),
                      "hybrid_K95": ("hybrid", 32, 64, 576, 4)}


@pytest.mark.parametrize("case", list(H2X_SAMPLING_CASES))
def test_bf16_h2x_mma_kernel_at_the_sampling_shapes(cuda, case):
    """The bf16 h2x edge launch alone (td_block_h2x_bf16) at the sampling
    path's shapes against the bf16 plain layer: two launches bitwise equal
    and equal to the per-layer entry's, ligand-tail rows without a valid
    neighbour x bitwise."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    cutoff_mode, k, max_ligand, n_protein, nb = H2X_SAMPLING_CASES[case]
    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein, seed=6, nb=nb)
    layer = rn.base_block[0]
    with torch.no_grad():
        _, ph = kel.pack_layer_params(layer, torch.bfloat16)
        runs = [_h2x_edge_alone(rn, h, x, nbh, mlig, e_w, max_ligand, ph) for _ in range(2)]
        layer_run = kel.h2x_layer_cuda(h, x, nbh, mlig, e_w, max_ligand, ph, torch.bfloat16)
        want = {d: kel.h2x_layer_plain(layer, h, x, nbh, mlig, e_w, d)
                for d in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    assert torch.equal(*runs) and torch.equal(runs[0], layer_run)
    bf16_close("x", runs[0], want[torch.bfloat16], want[torch.float32], mlig)
    tail = torch.arange(h.shape[1], device=cuda) >= h.shape[1] - max_ligand
    empty = tail & ~nbh.mask.any(-1)
    assert bool(empty.any()) and torch.equal(runs[0][empty], x[empty])
    assert torch.equal(runs[0][~mlig], x[~mlig])


@pytest.mark.parametrize("k", [8, 32])
def test_bf16_h2x_kernel_callers_repeat(cuda, k):
    """The bf16 h2x edge kernel through its block callers at K <= 32: the
    inference block and the train-mode block forward, each run twice
    bitwise equal, against their bf16 plain versions on x."""
    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, "knn", k, NL, NP_, seed=5)
    bf16 = torch.bfloat16
    with torch.no_grad():
        blocks = [kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=NL, dtype=bf16)
                  for _ in range(2)]
        want = {d: rn.block_forward(h, x, nbh, mlig, dtype=d) for d in (bf16, torch.float32)}
        x2h, h2x = kblock.pack_pass_params(rn, bf16)
        trains = [kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, x2h, h2x, bf16)
                  for _ in range(2)]
        twant = {d: kblock.block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w, d)
                 for d in (bf16, torch.float32)}
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*blocks))
    bf16_close("x", blocks[0][1], want[bf16][1], want[torch.float32][1], mlig)
    assert all(torch.equal(a, b) for a, b in zip(*trains))
    ml = mlig[None].expand(trains[0][1].shape[0] - 1, -1, -1)
    bf16_close("xck", trains[0][1][1:], twant[bf16][1][1:], twant[torch.float32][1][1:], ml)


def test_bf16_node_and_edge_weight_kernels_match_plain(cuda):
    """The bf16 node kernel against float64 of its bf16 plain version (the
    same bf16 operands: ni and nj float32-close; q through a rounded
    LayerNorm output) and the bf16 edge-weight kernel against its plain
    version, the module's edge_weights at bf16."""
    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, "knn", 32, 8, 40)
    with torch.no_grad():
        stacks = kblock.pack_pass_params(rn, torch.bfloat16)
        f32 = kblock.pack_pass_params(rn)
        for st, st32 in zip(stacks, f32):
            got = kblock.node_projections_cuda(h, st, layer=1)
            want = kblock.node_projections_plain(h.double().reshape(-1, 128), st, layer=1)
            want32 = kblock.node_projections_plain(h.reshape(-1, 128), st32, layer=1)
            for name, g, w, w32 in zip(("ni", "nj", "q"), got, want, want32):
                if name == "q":
                    bf16_close(name, g.double(), w, w32.double())
                else:
                    assert float((g.double() - w).abs().max() / w.abs().max()) < NODE_REL, name
        packed = kblock.pack_block_params(rn, torch.bfloat16)
        ew = kblock.edge_weights_cuda(x, nbh, packed)
        want = {d: rn.edge_weights(x, nbh, d)[..., 0] for d in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    bf16_close("e_w", ew, want[torch.bfloat16], want[torch.float32], nbh.mask)


@pytest.mark.parametrize("nb,n,nl", NODE_SHAPES)
@pytest.mark.parametrize("magnitude", [1.0, 1e5, 1e-5])
def test_bf16_node_kernel_matches_plain(cuda, magnitude, nb, n, nl):
    """The bf16 node kernel (wgmma) on rows of largest |h| near `magnitude`
    (and a row of zeros), for both passes' weights: ni, nj and q1 at
    NODE_REL against float64 of the bf16 plain version (the same bf16
    operands), q within the bf16 bars of it and closer to it than to the
    float32 plain version; `_node_launches` holds what is bitwise."""
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    rn = model.net.refine_net
    h = _node_rows(cuda, magnitude, nb, n)
    for st, st32 in zip(kblock.pack_pass_params(rn, torch.bfloat16), kblock.pack_pass_params(rn)):
        full = _node_launches(h, st, nl)
        with torch.no_grad():
            want = kblock.node_projections_plain(h.double().reshape(-1, 128), st, layer=1)
            want32 = kblock.node_projections_plain(h.reshape(-1, 128), st32, layer=1)
        for name, got, w, w32 in zip(("ni", "nj", "q", "q1"), full, want, want32):
            assert bool(got.isfinite().all()), name
            if name == "q":
                bf16_close(name, got.double(), w, w32.double())
            else:
                rel = float((got.double() - w).abs().max() / w.abs().max())
                assert rel < NODE_REL, (name, rel)


def test_bf16_sampling_runs_the_bf16_kernels(cuda):
    """sample_diffusion at its default dtype (bf16) launches the bf16 block
    and edge-weight kernels (kNN) and the bf16 per-layer kernels (hybrid),
    and no float32 one."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    batch = _complexes(cuda, seed=1)
    f32 = (kblock.LAUNCHES, kblock.EW_LAUNCHES, kel.X2H_LAUNCHES, kel.H2X_LAUNCHES)
    bf16 = (kblock.BF16_LAUNCHES, kblock.BF16_EW_LAUNCHES)
    res = model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v,
                                 torch.Generator(device=cuda).manual_seed(0), num_steps=4)
    assert (kblock.BF16_LAUNCHES - bf16[0], kblock.BF16_EW_LAUNCHES - bf16[1]) == (4, 4)
    assert bool(res.pos.isfinite().all())
    hmodel, hbatch, *_ = _layer_setup(cuda, "hybrid", 32, 64, 64, seed=3)
    layers = (kel.BF16_X2H_LAUNCHES, kel.BF16_H2X_LAUNCHES)
    with pytest.warns(UserWarning, match="per-layer"):
        res = hmodel.sample_diffusion(hbatch, hbatch.ligand_pos, hbatch.ligand_v,
                                      torch.Generator(device=cuda).manual_seed(0), num_steps=3)
    assert (kel.BF16_X2H_LAUNCHES - layers[0], kel.BF16_H2X_LAUNCHES - layers[1]) == (6, 6)
    assert bool(res.pos.isfinite().all())
    assert (kblock.LAUNCHES, kblock.EW_LAUNCHES, kel.X2H_LAUNCHES, kel.H2X_LAUNCHES) == f32


# bf16 training (impl='fast_bf16' | 'fast_bf16_pl'): the bf16 train-mode
# forward, the bf16 block and per-layer backwards, and their node and
# weight-gradient kernels against their plain bf16 versions (autograd of the
# eager layers through precision.Bf16Linear; node_bwd_plain and
# weight_grad_plain at dtype=torch.bfloat16) at BF16_BAR of each tensor's
# scale. The kernels round sums per node where the plain version rounds per
# edge, so the backward's tensors sit at bf16 distance from it, not closer.


def bf16_grads_close(name, got, want, want_f32=None):
    """Every gradient within BF16_BAR of its scale; the k second-layer biases
    (zero in exact arithmetic) within BF16_BAR of the largest gradient.
    Returns the largest and the median error over scale (and, given the
    float32 gradients, the median of the float32 ones' distance)."""
    top = max(float(w.abs().max()) for w in want.values())
    errs, errs32 = [], []
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        if n.endswith("k_func.net.3.bias"):
            assert err < BF16_BAR * top, (name, n, err / top)
            continue
        scale = max(float(w.abs().max()), 1e-30)
        errs.append(err / scale)
        assert err < BF16_BAR * scale, (name, n, err / scale)
        if want_f32 is not None:
            errs32.append(float((got[n] - want_f32[n]).abs().max()) / scale)
    fields = {"max": max(errs), "median": float(np.median(errs))}
    if errs32:
        fields["median_vs_f32"] = float(np.median(errs32))
    print(name, fields)
    return fields


@pytest.mark.parametrize("k", [8, 32])
def test_bf16_train_forward_kernel_matches_plain(cuda, k):
    """td_block_train_fwd_bf16 against the bf16 plain train-mode forward: its
    float32 checkpoints at the bf16 bar, closer to the bf16 plain version
    than to the float32 one; two runs bitwise equal; counted apart."""
    rn, h, x, node_mask, mlig, nbh, e_w = _train_block_setup(cuda, k, B)
    before = (kblock.TRAIN_LAUNCHES, kblock.BF16_TRAIN_LAUNCHES)
    with torch.no_grad():
        x2h, h2x = kblock.pack_pass_params(rn, torch.bfloat16)
        want = {d: kblock.block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w, d)
                for d in (torch.bfloat16, torch.float32)}
        runs = [kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, x2h, h2x,
                                                 torch.bfloat16) for _ in range(2)]
    torch.cuda.synchronize()
    assert (kblock.TRAIN_LAUNCHES - before[0], kblock.BF16_TRAIN_LAUNCHES - before[1]) == (0, 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][0].dtype == runs[0][1].dtype == torch.float32
    m = node_mask[None, :, :, None].expand_as(runs[0][0])[1:]
    bf16_close("hck", runs[0][0][1:], want[torch.bfloat16][0][1:], want[torch.float32][0][1:], m)
    ml = mlig[None].expand(runs[0][1].shape[0] - 1, -1, -1)
    bf16_close("xck", runs[0][1][1:], want[torch.bfloat16][1][1:], want[torch.float32][1][1:], ml)
    with torch.no_grad(), pytest.raises(ValueError, match="packed"):
        f32 = kblock.pack_pass_params(rn)
        kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, *f32, torch.bfloat16)


@pytest.mark.parametrize("k,batch_size", [(8, B), (32, B)])
def test_bf16_block_vjp_kernel_matches_autograd(cuda, k, batch_size):
    """The bf16 whole-block backward (td_block_bwd_bf16, through
    block_layers_trainable(dtype=bf16)) against autograd of the plain bf16
    block: dh0, dx0, de_w and every parameter gradient at the bf16 bar, every
    one float32, and within REPLAY16_BAR of the replay of the kernel's
    rounding points (replay_block_bwd(bf16=True) on its checkpoints); two
    runs bitwise equal; only the bf16 entries launch; a float32 pack handed
    to the bf16 backward raises."""
    from chip_smoke import REPLAY16_BAR, replay_grads, tensor_errs
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    rn, h, x, node_mask, mlig, nbh, e_w = _train_block_setup(cuda, k, batch_size)
    gen = torch.Generator(device=cuda).manual_seed(k)
    gh = torch.randn(h.shape, generator=gen, device=cuda) * node_mask[..., None]
    gx = torch.randn(x.shape, generator=gen, device=cuda)

    def run(trainable, dtype=torch.bfloat16):
        leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
        rn.zero_grad()
        if trainable:
            ho, xo = block_vjp.block_layers_trainable(rn, *leaves[:2], nbh, mlig, leaves[2], NL,
                                                      dtype=dtype)
        else:
            ho, xo = rn.block_forward(leaves[0], leaves[1], nbh, mlig, e_w=leaves[2],
                                      dtype=dtype)
        ((ho * gh).sum() + (xo * gx).sum()).backward()
        grads = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
        grads.update(dh0=leaves[0].grad, dx0=leaves[1].grad, de_w=leaves[2].grad)
        return grads

    counts = lambda: (block_vjp.LAUNCHES, block_vjp.BF16_LAUNCHES, kblock.TRAIN_LAUNCHES,  # noqa
                      kblock.BF16_TRAIN_LAUNCHES, block_vjp.NODE_BWD_LAUNCHES,
                      block_vjp.BF16_NODE_BWD_LAUNCHES)
    before = counts()
    got, again = run(True), run(True)
    torch.cuda.synchronize()
    L = len(rn.base_block)
    assert tuple(b - a for a, b in zip(before, counts())) == (0, 2, 0, 2, 0, 4 * L)
    want, want32 = run(False), run(False, torch.float32)
    assert all(torch.equal(got[n], again[n]) for n in got)  # fixed summation order
    assert sorted(got) == sorted(want)
    assert all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in got.values())
    bf16_grads_close(f"block K={k}", got, want, want32)
    with torch.no_grad():
        x2h, h2x = kblock.pack_pass_params(rn)
        packs16 = [kblock.cast_pack(p, torch.bfloat16) for p in (x2h, h2x)]
        hck, xck = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, *packs16,
                                                    torch.bfloat16)
    # the second witness: the kernel's rounding points replayed in PyTorch
    replay = replay_grads(torch, rn, hck, xck, nbh, mlig, e_w, gh, gx, NL, CONFIG["n_heads"])
    errs = tensor_errs(got, replay)
    print(f"block K={k} vs replay", max(errs.values()), float(np.median(list(errs.values()))))
    assert max(errs.values()) < REPLAY16_BAR, errs
    with torch.no_grad():
        hck, xck = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, NL, x2h, h2x)
        with pytest.raises(ValueError, match="packed"):
            block_vjp.block_bwd_cuda(hck, xck, nbh.idx, nbh.mask, mlig, e_w, NL, x2h, h2x, gh,
                                     gx, torch.bfloat16)


@pytest.mark.parametrize("cutoff_mode,k,max_ligand,n_protein", LAYER_CASES)
def test_bf16_layer_vjp_kernels_match_autograd(cuda, cutoff_mode, k, max_ligand, n_protein):
    """The bf16 per-layer backwards (td_{x2h,h2x}_layer_bwd_bf16, through the
    trainables at dtype=bf16) against autograd of the plain bf16 sub-layers at
    the bf16 bar; two runs bitwise equal; only the bf16 entries launch."""
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kvjp

    _, _, rn, h, x, node_mask, mlig, nbh, e_w = _layer_setup(cuda, cutoff_mode, k, max_ligand,
                                                              n_protein, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(k)
    layer = rn.base_block[0]
    cot = {"x2h": torch.randn(h.shape, generator=gen, device=cuda) * node_mask[..., None],
           "h2x": torch.randn(x.shape, generator=gen, device=cuda)}

    def run(sub, trainable, dtype=torch.bfloat16):
        leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
        rn.zero_grad()
        if sub == "x2h":
            fn = kvjp.x2h_layer_trainable if trainable else kvjp.x2h_layer_plain
            out = fn(layer, leaves[0], leaves[1], nbh, mlig, leaves[2], dtype=dtype)
        elif trainable:
            out = kvjp.h2x_layer_trainable(layer, leaves[0], leaves[1], nbh, mlig, leaves[2],
                                           max_ligand, dtype=dtype)
        else:
            out = kvjp.h2x_layer_plain(layer, leaves[0], leaves[1], nbh, mlig, leaves[2],
                                       dtype=dtype)
        (out * cot[sub]).sum().backward()
        grads = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
        grads.update(dh=leaves[0].grad, dx=leaves[1].grad, de_w=leaves[2].grad)
        return grads

    counts = lambda: (kvjp.X2H_BWD_LAUNCHES, kvjp.H2X_BWD_LAUNCHES,  # noqa: E731
                      kvjp.BF16_X2H_BWD_LAUNCHES, kvjp.BF16_H2X_BWD_LAUNCHES,
                      kel.X2H_LAUNCHES, kel.H2X_LAUNCHES)
    for sub in ("x2h", "h2x"):
        before = counts()
        got, again = run(sub, True), run(sub, True)
        torch.cuda.synchronize()
        want = (2, 0) if sub == "x2h" else (0, 2)
        assert tuple(b - a for a, b in zip(before, counts())) == (0, 0, *want, 0, 0)
        ref, ref32 = run(sub, False), run(sub, False, torch.float32)
        assert all(torch.equal(got[n], again[n]) for n in got)
        assert sorted(got) == sorted(ref)
        assert all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in got.values())
        bf16_grads_close(f"{sub} {cutoff_mode} K={nbh.idx.shape[-1]}", got, ref, ref32)
        empty = ~nbh.mask.any(-1)
        assert bool((got["de_w"][empty] == 0).all())


@pytest.mark.parametrize("case", list(NODE_BWD_CASES))
def test_bf16_node_bwd_kernel_matches_plain_and_repeats(cuda, case):
    """The bf16 node kernel alone (td_node_bwd_bf16) against its plain version
    (node_bwd_plain(dtype=bf16) on float64 copies, the kernel's own ReLU
    mask): every output within NODE16_BAR of its scale, and more than ten
    times that from the unrounded float64 version (the operands were
    rounded); two runs bitwise equal; counted apart from the float32
    kernel."""
    from chip_smoke import NODE16_BAR, node_bwd_errs, node_bwd_operands
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    rows, V = NODE_BWD_CASES[case]
    ops = node_bwd_operands(torch, cuda, rows, V)
    rowbuf, q1, dh, q_ln, w_q2T, w_nodeT = ops
    before = (block_vjp.NODE_BWD_LAUNCHES, block_vjp.BF16_NODE_BWD_LAUNCHES)
    got, again = [block_vjp.node_bwd_cuda(rowbuf.clone(), q1, dh.clone(), q_ln, w_q2T, w_nodeT,
                                          dtype=torch.bfloat16) for _ in range(2)]
    torch.cuda.synchronize()
    assert (block_vjp.NODE_BWD_LAUNCHES - before[0],
            block_vjp.BF16_NODE_BWD_LAUNCHES - before[1]) == (0, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = block_vjp.node_bwd_plain(*[t.double() for t in ops], relu_mask=got[1] > 0,
                                    dtype=torch.bfloat16)
    exact = block_vjp.node_bwd_plain(*[t.double() for t in ops], relu_mask=got[1] > 0)
    errs = node_bwd_errs(got, want)
    unrounded = max(v for n, v in node_bwd_errs(got, exact).items() if n.endswith("_over_scale"))
    print(case, errs, unrounded)
    assert max(v for n, v in errs.items() if n.endswith("_over_scale")) < NODE16_BAR, errs
    assert unrounded > 10 * NODE16_BAR, unrounded


@pytest.mark.parametrize("case", list(WG_CASES))
def test_bf16_weight_grad_kernel_matches_plain_and_repeats(cuda, case):
    """X^T Y on the bf16 kernel (td_weight_grad_bf16) against float64 of the
    bf16-rounded operands (weight_grad_plain(dtype=bf16)'s products): within
    1e-4 of s, the root-sum-square of each entry's terms (float32 sums of
    exact products), and at least ten times that from float64 of the
    unrounded operands (the operands were rounded); two launches bitwise
    equal; counted apart."""
    from targetdiff_tpu_torch.ops.kernels import weight_grad as kwg
    from targetdiff_tpu_torch.ops.precision import round_bf16

    M, P, Q, ldx, ox, ldy, oy = WG_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(M + P + Q)

    def operand(ld, off, n):
        order = torch.randperm(n, generator=gen, device=cuda)
        rows = torch.randn((M, ld), generator=gen, device=cuda)
        rows[:, off:off + n] *= 10.0 ** torch.linspace(-9, 5, n, device=cuda)[order]
        return rows[:, off:off + n]

    X, Y = operand(ldx, ox, P), operand(ldy, oy, Q)
    before = (kwg.LAUNCHES["alone"], kwg.BF16_LAUNCHES["alone"])
    got, again = [kwg.weight_grad_cuda(X, Y, dtype=torch.bfloat16) for _ in range(2)]
    torch.cuda.synchronize()
    assert (kwg.LAUNCHES["alone"] - before[0], kwg.BF16_LAUNCHES["alone"] - before[1]) == (0, 2)
    assert torch.equal(got, again)
    x, y = round_bf16(X).double(), round_bf16(Y).double()
    want, s = x.T @ y, ((x * x).T @ (y * y)).sqrt()
    err = float(((got.double() - want).abs() / s.clamp(min=1e-300)).max())
    x, y = X.double(), Y.double()
    s_exact = ((x * x).T @ (y * y)).sqrt()
    unrounded = float(((got.double() - x.T @ y).abs() / s_exact.clamp(min=1e-300)).max())
    print(case, {"err_over_s": err, "vs_unrounded_over_s": unrounded})
    assert err <= 1e-4, err
    assert unrounded > 10 * err, unrounded


@pytest.mark.parametrize("h2x,K", [(False, 32), (True, 32), (False, 95), (True, 95)])
def test_bf16_edge_bwd_kernel_occupancy(cuda, h2x, K):
    """The bf16 backward's edge kernel as the card makes it: at most 128
    registers per thread, two blocks per SM at the whole-block backward's
    K = 32 and one at the hybrid graph's K, as the float32 one
    (test_edge_bwd_kernel_occupancy), and no local memory (spills)."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    info = block_vjp.edge_bwd_info(K, h2x, torch.bfloat16)
    print(h2x, K, info, block_vjp.edge_bwd_info(K, h2x))
    assert info["registers"] <= 128
    assert info["blocks_per_sm"] == (2 if K <= 32 else 1)
    assert info["smem"] <= 232448
    assert info["local_bytes"] == 0, info


@pytest.mark.parametrize("rows,tile", [(13312, 64), (2432, 32)])
def test_bf16_node_bwd_kernel_occupancy(cuda, rows, tile):
    """The bf16 node kernel: the float32 one's tiles, at most 128 registers,
    no spills, two blocks per SM."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    info = block_vjp.node_bwd_info(rows, torch.bfloat16)
    print(rows, info)
    assert info["tile_rows"] == tile
    assert info["registers"] <= 128 and info["local_bytes"] == 0
    assert info["blocks_per_sm"] == 2


def test_bf16_train_loss_runs_only_the_bf16_kernels(cuda):
    """get_diffusion_loss(impl='fast_bf16') on the card launches the bf16
    train-mode forward and backward and no float32 training kernel; its loss
    and gradients at the JAX package's bf16 training bar from the float32
    'fast' step's (tests/test_fast_train.py); 'fast_bf16_pl' on a hybrid
    graph launches the bf16 per-layer forwards and backwards."""
    from targetdiff_tpu_torch.ops.kernels import block_vjp
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
    from targetdiff_tpu_torch.ops.kernels import edge_layer_vjp as kvjp

    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    batch = _complexes(cuda, seed=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    t = torch.tensor([0, 7, 19], device=cuda)
    eps = torch.randn(batch.ligand_pos.shape, generator=gen, device=cuda)
    u = torch.rand(batch.ligand_v.shape + (13,), generator=gen, device=cuda)
    f32 = lambda: (kblock.TRAIN_LAUNCHES, block_vjp.LAUNCHES, block_vjp.NODE_BWD_LAUNCHES,  # noqa
                   kel.X2H_LAUNCHES, kel.H2X_LAUNCHES, kvjp.X2H_BWD_LAUNCHES,
                   kvjp.H2X_BWD_LAUNCHES)
    out = {}
    for impl in ("fast", "fast_bf16"):
        before = (f32(), kblock.BF16_TRAIN_LAUNCHES, block_vjp.BF16_LAUNCHES)
        model.net.zero_grad()
        loss = model.get_diffusion_loss(batch, time_step=t, pos_noise=eps, v_uniform=u,
                                        impl=impl)["loss"]
        loss.backward()
        if impl == "fast_bf16":
            assert f32() == before[0]
            assert (kblock.BF16_TRAIN_LAUNCHES - before[1], block_vjp.BF16_LAUNCHES - before[2]) \
                == (1, 1)
        out[impl] = (float(loss), {n: p.grad.clone() for n, p in model.net.named_parameters()})
    (l16, g16), (l32, g32) = out["fast_bf16"], out["fast"]
    assert abs(l16 - l32) < 2e-2 * abs(l32)
    assert all(g.dtype == torch.float32 for g in g16.values())
    for n, g in g32.items():
        assert float((g16[n] - g).abs().max()) < 0.08 * max(float(g.abs().max()), 1e-2), n
    hmodel, hbatch, *_ = _layer_setup(cuda, "hybrid", 32, 64, 64, seed=3)
    before = (f32(), kvjp.BF16_X2H_BWD_LAUNCHES, kvjp.BF16_H2X_BWD_LAUNCHES,
              kel.BF16_X2H_LAUNCHES, kel.BF16_H2X_LAUNCHES)
    with pytest.warns(UserWarning, match="per-layer"):
        loss = hmodel.get_diffusion_loss(hbatch, generator=gen, impl="fast_bf16")["loss"]
    loss.backward()
    L = len(hmodel.net.refine_net.base_block)
    assert f32() == before[0]
    assert (kvjp.BF16_X2H_BWD_LAUNCHES - before[1], kvjp.BF16_H2X_BWD_LAUNCHES - before[2],
            kel.BF16_X2H_LAUNCHES - before[3], kel.BF16_H2X_LAUNCHES - before[4]) == (L, L, L, L)
    assert bool(torch.isfinite(loss))


VARIANT_CASES = {"V1": dict(ew_net_type="r", x2h_out_fc=True),
                 "V2": dict(ew_net_type="m", num_x2h=2, num_h2x=2, sync_twoup=True,
                            act_fn="swish", norm=False, time_emb_mode="sin", time_emb_dim=8)}


@pytest.mark.parametrize("name", list(VARIANT_CASES))
def test_variant_builds_its_graph_on_the_knn_kernel(cuda, name):
    """A uni_o2 option off the block kernels runs eagerly on the card with its
    kNN graph from the kNN kernel, one launch a block call and no block
    kernel, and agrees with the same weights on the CPU (positions 2e-4 /
    1e-3, logits 2e-3 / 1e-2)."""
    cfg = Config(CONFIG, num_blocks=2, **VARIANT_CASES[name])
    torch.manual_seed(3)
    model = DiffusionModel(cfg, 27, 13, device=cuda, max_protein=NP_, max_ligand=NL)
    cpu = DiffusionModel(cfg, 27, 13, device="cpu", max_protein=NP_, max_ligand=NL)
    cpu.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    assert model.impl == "eager" and model.net.refine_net.knn_kernel
    batch = _complexes(cuda)
    t = torch.tensor([3, 9, 17], device=cuda)
    kknn.LAUNCHES = kblock.LAUNCHES = 0
    with torch.no_grad():
        got = model.apply(batch, batch.ligand_pos, batch.ligand_v, time_step=t)
        want = cpu.apply(batch.to("cpu"), batch.ligand_pos.cpu(), batch.ligand_v.cpu(),
                         time_step=t.cpu())
    assert kknn.LAUNCHES == 2 and kblock.LAUNCHES == 0
    lm = batch.ligand_mask.cpu()
    torch.testing.assert_close(got["pred_ligand_pos"].cpu()[lm], want["pred_ligand_pos"][lm],
                               atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(got["pred_ligand_v"].cpu()[lm], want["pred_ligand_v"][lm],
                               atol=2e-3, rtol=1e-2)


def test_bf16_model_runs_eagerly_on_the_card(cuda):
    """The bf16 model (model_dtype=torch.bfloat16) of V1 on the card: h in
    bf16, outputs float32 within 2e-2 of scale of the CPU's bf16 model on
    positions and final_h, no block kernel, the kernel paths refused."""
    cfg = Config(CONFIG, **VARIANT_CASES["V1"])
    torch.manual_seed(4)
    model = DiffusionModel(cfg, 27, 13, device=cuda, max_protein=NP_, max_ligand=NL,
                           model_dtype=torch.bfloat16)
    cpu = DiffusionModel(cfg, 27, 13, device="cpu", max_protein=NP_, max_ligand=NL,
                         model_dtype=torch.bfloat16)
    cpu.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    batch = _complexes(cuda)
    kblock.LAUNCHES = 0
    with torch.no_grad():
        assert model.net.embed(*batch)[0].dtype == torch.bfloat16
        got = model.apply(batch, batch.ligand_pos, batch.ligand_v)
        want = cpu.apply(batch.to("cpu"), batch.ligand_pos.cpu(), batch.ligand_v.cpu())
    assert kblock.LAUNCHES == 0
    for k in ("pred_ligand_pos", "final_h"):
        g, w = got[k].cpu(), want[k]
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 2e-2 * float(w.abs().max()), k
    with pytest.raises(ValueError, match="impl='eager'"):
        model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)


def _cone_graph(device, kind, B_, N, K, n_ligand, seed=0):
    """A graph for the cone kernel: 'knn' of atoms scattered over a 24 A cube
    with the ligand tail at the centre (a padded stretch, a one-atom
    ligand), or 'random' neighbour lists with random masks; 'ligand_only'
    random with every row in the ligand tail, 'dead' random with complex 1's
    slots all masked."""
    rng = np.random.default_rng(seed)
    if kind != "knn":
        idx = torch.tensor(rng.integers(0, N, (B_, N, K)), device=device)
        mask = torch.tensor(rng.random((B_, N, K)) < 0.7, device=device)
        if kind == "dead":
            mask[1] = False
        return G.Neighborhood(idx, mask)
    pos = rng.uniform(-12, 12, (B_, N, 3))
    pos[:, N - n_ligand:] = rng.normal(size=(B_, n_ligand, 3))
    mask = np.ones((B_, N), bool)
    mask[0, N - n_ligand - 9:N - n_ligand] = False
    mask[-1, N - n_ligand + 1:] = False
    return G.knn_graph(torch.tensor(pos, dtype=torch.float32, device=device),
                       torch.tensor(mask, device=device), K)


@pytest.mark.parametrize("kind,B_,N,K,L", [
    ("knn", 3, 608, 32, 9), ("knn", 5, 130, 8, 2), ("random", 2, 1100, 16, 4),
    ("random", 7, 45, 3, 1), ("random", 2, 300, 40, 3), ("random", 1, 4000, 32, 5),
    # B = 1, the sampler's B = 100, L = 1 and 29 (MAX_LAYERS), K = 1, more
    # complexes than one wave of co-resident blocks (the persistent blocks
    # loop), n_ligand = N, a complex whose slots are all masked, K > 32 with
    # lists too long for shared memory
    ("knn", 1, 608, 32, 9), ("knn", 100, 608, 32, 9), ("knn", 4, 608, 32, 1),
    ("knn", 4, 608, 32, 29), ("random", 3, 100, 1, 5), ("random", 1200, 64, 8, 3),
    ("ligand_only", 3, 40, 8, 4), ("dead", 5, 300, 16, 4), ("random", 1, 3000, 40, 4)])
def test_cone_kernel_matches_plain_bitwise(cuda, kind, B_, N, K, L):
    """cone_kernel's hop, order and counts equal the plain version's (the
    stable sort) bit for bit, N past one block's 512 rows included, with the
    neighbour lists in shared memory and (K > 32, or lists too long for it)
    read from device memory; two calls equal; one counted call each, and
    torch.profiler sees one cone_kernel launch a call; three calls in a row
    at different B through one ConeWorkspace equal the plain version's, the
    workspace allocated once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from targetdiff_tpu_torch.ops.kernels import cone as kcone

    n_ligand = N if kind == "ligand_only" else 32 if N > 100 else 8
    nbh = _cone_graph(cuda, kind, B_, N, K, n_ligand)
    grid = kcone.cone_grid(B_, N)
    resident = grid["blocks_per_sm"] * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    assert min(B_, resident) <= grid["grid"] <= resident
    assert grid["adj_words"] == kcone._adj_words(N)
    if B_ == 1200:
        assert grid["grid"] < B_  # the blocks loop over complexes
    kcone.cone_cuda(nbh.idx, nbh.mask, n_ligand, L)  # warm-up: the library loaded
    torch.cuda.synchronize()
    before = kcone.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = [kcone.cone_cuda(nbh.idx, nbh.mask, n_ligand, L) for _ in range(2)]
        torch.cuda.synchronize()
    assert kcone.LAUNCHES - before == 2
    assert sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "cone_kernel" in e.key) == 2
    want = kcone.cone_plain(nbh.idx.cpu(), nbh.mask.cpu(), n_ligand, L)
    for a, b in zip(got[0], got[1]):
        assert torch.equal(a, b)
    for name, a, w in zip(want._fields, got[0], want):
        assert torch.equal(a.cpu(), w), name
    assert int(got[0].counts[0]) == B_ * n_ligand
    ws, buffers = kcone.ConeWorkspace(), set()
    for b in (B_, max(1, B_ // 2), B_):
        cone = kcone.cone_cuda(nbh.idx[:b], nbh.mask[:b], n_ligand, L, ws)
        buffers.add(ws.buffer.data_ptr())
        want = kcone.cone_plain(nbh.idx[:b].cpu(), nbh.mask[:b].cpu(), n_ligand, L)
        for name, a, w in zip(want._fields, cone, want):
            assert torch.equal(a.cpu(), w), (b, name)
    assert len(buffers) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32])
def test_block_kernels_on_the_cone_keep_the_ligand_outputs(cuda, dtype, k):
    """The block kernels on the cone's row lists against the all-live block
    kernels: x and the ligand rows of h bitwise equal (and every row of the
    last layer's set), the cone's launches bitwise repeatable, the pass
    launches unchanged; the sampler's forward (need_full_h=False) gives the
    ligand outputs of need_full_h=True bitwise, with one cone call."""
    from targetdiff_tpu_torch.ops.kernels import cone as kcone

    torch.manual_seed(0)
    n_protein = 220
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda, max_protein=n_protein,
                           max_ligand=NL)
    rn = model.net.refine_net
    rng = np.random.default_rng(5)
    pmask = np.ones((B, n_protein), bool)
    pmask[0, 200:] = False
    lmask = np.ones((B, NL), bool)
    lmask[2, 1:] = False
    batch = from_numpy(rng.uniform(-12, 12, (B, n_protein, 3)),
                       rng.random((B, n_protein, 27)) > 0.7, pmask, rng.normal(size=(B, NL, 3)),
                       rng.integers(0, 13, (B, NL)), lmask, device=cuda)
    L = len(rn.base_block)
    bf16 = dtype == torch.bfloat16
    pass_counts = (lambda: (kblock.BF16_X2H_PASS_LAUNCHES, kblock.BF16_H2X_PASS_LAUNCHES)
                   if bf16 else (kblock.X2H_PASS_LAUNCHES, kblock.H2X_PASS_LAUNCHES))
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = G.knn_graph(x, node_mask, k)
        cone = kcone.cone_cuda(nbh.idx, nbh.mask, NL, L)
        packed = kblock.pack_block_params(rn, dtype)
        h_all, x_all = kblock.block_denoiser(rn, h, x, nbh, mlig, NL, packed, dtype=dtype)
        before = pass_counts()
        runs = [kblock.block_denoiser(rn, h, x, nbh, mlig, NL, packed, dtype=dtype, cone=cone)
                for _ in range(2)]
        after = pass_counts()
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, after)) == (2 * L, 2 * L)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    h_c, x_c = runs[0]
    assert torch.equal(x_c, x_all)
    last = cone.x2h_rows(L - 1).long()
    assert torch.equal(h_c.reshape(-1, 128)[last], h_all.reshape(-1, 128)[last])
    assert torch.equal(h_c[:, n_protein:], h_all[:, n_protein:])
    assert int(cone.counts[L]) < B * (n_protein + NL)  # the cone skipped rows
    calls = kcone.LAUNCHES
    with torch.no_grad():
        full = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=dtype)
        part = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=dtype,
                                need_full_h=False)
    torch.cuda.synchronize()
    assert kcone.LAUNCHES - calls == 1
    for key in ("pred_ligand_pos", "pred_ligand_v", "final_ligand_h"):
        assert torch.equal(part[key], full[key]), key
    assert bool(part["final_h"].isfinite().all())  # stale rows, never uninitialised
