"""The training slice's block, on the CPU: the block-VJP kernel's algorithm
(csrc/block_vjp.cu), replayed by hand in PyTorch on the packed weights and
held against autograd of the plain block; the same replay with the
recompute's k and v second layers as the kernel computes them (three fp16
products per term, split3_matmul), on kNN and hybrid graphs of K = 8, 15
and 40 (two 32-slot chunks: the kernel's pass 2 recomputes k), against
autograd of the plain block at the float32-grade bar and, as the block's
backward inside the loss, against the JAX XLA loss's gradients, while one
fp16 product per term misses that bar; d rbf as the kernel computes it
(drbf_tf32: one three-term TF32 product over the row's two edge-type tables,
each slot taking its type's columns) at the same bar on the same graphs,
while one TF32 product per term misses it, and that two-table form, from
the port's staged fragments, against the einsum over each edge's table; the
node kernel's two products as it computes them (node_tf32: three-term TF32 in
its k-step order) at the same bar on the same graphs, while one TF32 product
per term misses it, and its plain version `node_bwd_plain` against the JAX
query MLP's backward `_node_mlp_bwd`; the train-mode forward's
checkpoints against the JAX megakernel in interpret mode; and the port's
loss and every parameter gradient against jax.value_and_grad of the JAX
XLA loss, with the JAX draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.models.fast_forward import extract_block_params
from targetdiff_tpu.models.score_model import DiffusionModel as JaxDiffusionModel
from targetdiff_tpu.ops.pallas.block_denoiser import block_denoiser as jax_block_denoiser
from targetdiff_tpu.ops.pallas.edge_layer_vjp import _node_mlp_bwd, _node_mlp_fwd
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models import fast_forward
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels.block_denoiser import (
    block_denoiser_train_plain,
    pack_pass_params,
)
from targetdiff_tpu_torch.ops.kernels import block_vjp
from targetdiff_tpu_torch.ops.kernels.block_vjp import FIELDS, block_layers_trainable
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict
from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, batch_mult8, small_flagship
from tests.test_torch_block import _block_inputs
from tests.test_torch_score_model import small_setup
from tests.test_torch_weight_grad import split3
from tests.test_torch_x2h_edge import W_SCALE, f16, split3_matmul
from targetdiff_tpu_torch.ops.kernels.block_vjp_replay import drbf_einsum, replay_block_bwd

torch.set_num_threads(2)


def _two_tables(w_rbf):
    """[W_ta | W_ta+2] of both row kinds ta = 0 (ligand row: types 0, 2) and 1
    (protein row: 1, 3): [2, 2R, 2H]."""
    return torch.stack([torch.cat([w_rbf[t], w_rbf[t + 2]]) for t in (0, 1)])


def _by_kind(D, et, ta, R):
    """Each slot's R columns of its row kind's product D [2, .., 2R]: the first R
    for an edge of type ta, the last R for type ta + 2."""
    D = torch.where((ta == 0)[..., None], D[0], D[1])
    return torch.where((et == ta)[..., None], D[..., :R], D[..., R:])


def drbf_tf32(dz, w_rbf, et, ta, terms=3, warps=8):
    """d rbf as csrc/pass_bwd.cuh drbf_chunk computes it: D = dz [W_ta | W_ta+2]
    on TF32 operands (split3: hi, lo), each 8-channel k-step's lo*hi + hi*lo +
    hi*hi summed from zero (terms=1: hi*hi alone), each of `warps` warps' k-steps
    added in ascending order, then the warps' partials in warp order; each slot
    takes its type's R columns (_by_kind)."""
    R, H2 = w_rbf.shape[1], w_rbf.shape[2]
    ks = H2 // 8
    ah, al = split3(dz.reshape(*dz.shape[:-1], ks, 8))
    bh, bl = split3(_two_tables(w_rbf).reshape(2, 2 * R, ks, 8))

    def prod(a, b):  # [.., ks, 8] x [2, 2R, ks, 8] -> [2, .., ks, 2R]
        return torch.einsum("...ki,tjki->t...kj", a, b)

    d = prod(ah, bh) if terms == 1 else prod(al, bh) + prod(ah, bl) + prod(ah, bh)
    d = d.reshape(*d.shape[:-2], warps, ks // warps, 2 * R)
    part = d[..., 0, :]
    for i in range(1, ks // warps):
        part = part + d[..., i, :]
    D = part[..., 0, :]
    for w in range(1, warps):
        D = D + part[..., w, :]
    return _by_kind(D, et, ta, R)


def node_tf32(a, b, terms=3):
    """a [.., K] @ b [K, N] as csrc/node_bwd.cuh node_bwd_kernel computes its
    two products (d qa = dq w_q2^T, dh += dproj w_node^T): TF32 operands
    (split3: hi, lo), each 8-deep k-step's lo*hi + hi*lo + hi*hi (terms=1:
    hi*hi alone) summed from zero, the k-steps added to the float32
    accumulator in ascending order (every tile and row takes that order)."""
    ks = a.shape[-1] // 8
    ah, al = split3(a.reshape(*a.shape[:-1], ks, 8))
    bh, bl = split3(b.reshape(ks, 8, b.shape[-1]))

    def prod(x, y):  # [.., ks, 8] x [ks, 8, N] -> [.., ks, N]
        return torch.einsum("...ki,kin->...kn", x, y)

    d = prod(ah, bh) if terms == 1 else prod(al, bh) + prod(ah, bl) + prod(ah, bh)
    acc = d[..., 0, :]
    for k in range(1, ks):
        acc = acc + d[..., k, :]
    return acc


def _train_inputs():
    cfg, params, model, h, x, node_mask, mlig, idx, nmask = _block_inputs()
    rn = model.net.refine_net
    nbh = G.Neighborhood(torch.tensor(idx, dtype=torch.int64), torch.tensor(nmask))
    th, tx, tm = torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(mlig)
    with torch.no_grad():
        e_w = rn.edge_weights(tx, nbh)[..., 0]
    rng = np.random.default_rng(11)
    gh = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    gx = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    return cfg, params, model, rn, th, tx, tm, nbh, e_w, gh, gx, node_mask


def _close(got, want, name, atol_scale=1e-5, rtol=1e-4):
    got, want = got.detach().numpy(), want.detach().numpy()
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, atol=atol_scale * scale, rtol=rtol, err_msg=name)


def _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, n_heads,
                         matmul=torch.matmul, drbf_fn=drbf_einsum, node_matmul=torch.matmul,
                         dtype=torch.float32):
    """(replay, autograd): dh0, dx0, de_w and every parameter gradient of the
    block for the output cotangents (gh, gx), from `replay_block_bwd` (its
    recompute through `matmul`, d rbf through `drbf_fn`, the node kernel's
    products through `node_matmul`) on the packed weights and the
    train-mode checkpoints, and from autograd of the plain block; dtype=
    torch.bfloat16: the bf16 block's (train-mode forward, replay with
    bf16=True, autograd through precision.Bf16Linear)."""
    bf16 = dtype == torch.bfloat16
    h_leaf, x_leaf, ew_leaf = (t.clone().requires_grad_() for t in (h, x, e_w))
    model.net.zero_grad()
    h_out, x_out = rn.block_forward(h_leaf, x_leaf, nbh, mlig, e_w=ew_leaf, dtype=dtype)
    ((h_out * gh).sum() + (x_out * gx).sum()).backward()
    want = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
    want.update(dh0=h_leaf.grad, dx0=x_leaf.grad, de_w=ew_leaf.grad)
    x2h, h2x = pack_pass_params(rn)
    hck, xck = block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w, dtype)
    dh0, dx0, dew, gx2h, gh2x = replay_block_bwd(
        {f: t.detach() for f, t in x2h.items()}, {f: t.detach() for f, t in h2x.items()},
        hck, xck, nbh, mlig, e_w, model.max_ligand, gh, gx, n_heads, matmul, drbf_fn,
        node_matmul, bf16)
    # every packed gradient, carried to the parameters by the packing's backward
    model.net.zero_grad()
    torch.autograd.backward([x2h[f] for f in FIELDS] + [h2x[f] for f in FIELDS],
                            [gx2h[f] for f in FIELDS] + [gh2x[f] for f in FIELDS])
    got = {n: p.grad.clone() for n, p in rn.named_parameters() if p.grad is not None}
    got.update(dh0=dh0, dx0=dx0, de_w=dew)
    return got, want


def _hold_replay(got, want, n_params):
    """Every gradient of the replay within `_close` of autograd's."""
    assert sorted(got) == sorted(want) and len(got) == n_params + 3
    top = max(float(g.abs().max()) for g in want.values())
    for name in want:
        if name.endswith("k_func.net.3.bias"):
            # zero in exact arithmetic (softmax shift invariance): both sides
            # are float32 cancellation noise, held to the block's largest grad
            assert float(got[name].abs().max()) < 1e-6 * top, name
            assert float(want[name].abs().max()) < 1e-6 * top, name
        else:
            _close(got[name], want[name], name)


def test_backward_replay_matches_autograd_of_plain_block():
    cfg, _, model, rn, h, x, mlig, nbh, e_w, gh, gx, _ = _train_inputs()
    got, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads)
    _hold_replay(got, want, 36 * cfg.num_layers)


# The recompute's second layers as the kernel computes them (csrc/pass_bwd.cuh
# second_layers): three fp16 products per term, weights times 2^8. Cases:
# cutoff mode, knn, protein slots, ligand slots; K = knn (kNN) or ligand
# slots - 1 + knn (hybrid). K = 40 is two chunks of 32: the kernel's pass 2
# recomputes k (the replay's chunks give the same values).
SPLIT_CASES = {"knn_K8": ("knn", 8, 16, 8), "knn_K40": ("knn", 40, 40, 8),
               "hybrid_K15": ("hybrid", 8, 16, 8), "hybrid_K40": ("hybrid", 8, 16, 33)}


def _split_setup(cutoff_mode, knn, n_protein, n_ligand):
    """A small flagship model (H=32, 4 heads, L=2) of the case with its JAX
    twin (same parameters) and batch_mult8's batch at these slots; the
    block's inputs (h, x, graph, e_w) and output cotangents from numpy seeds."""
    cfg = small_flagship()
    cfg.update(dict(cutoff_mode=cutoff_mode, knn=knn))
    jbatch = batch_mult8(NP_=n_protein, NL=n_ligand)
    jmodel = JaxDiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, max_protein=n_protein,
                               max_ligand=n_ligand)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=n_protein,
                           max_ligand=n_ligand)
    model.net.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    batch = from_numpy(*[np.asarray(a) for a in jbatch])
    rn = model.net.refine_net
    rng = np.random.default_rng(13)
    with torch.no_grad():
        _, x, node_mask, mlig = model.net.embed(*batch)
        h = torch.from_numpy(rng.normal(size=(*x.shape[:2], cfg.hidden_dim)).astype(np.float32))
        nbh = rn.graph(x, node_mask, mlig)
        e_w = rn.edge_weights(x, nbh)[..., 0]
    gh = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    gx = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    assert nbh.idx.shape[-1] == rn.num_neighbors()
    return cfg, jmodel, params, jbatch, model, batch, rn, h, x, mlig, nbh, e_w, gh, gx


def _worst_over_scale(got, want):
    """The largest |got - want| / max|want| over the tensors (the k biases,
    zero in exact arithmetic, left out)."""
    return max(float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-6)
               for n, w in want.items() if not n.endswith("k_func.net.3.bias"))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split3_backward_replay_matches_autograd_of_plain_block(case):
    """The kernel's algorithm with its three-term fp16 recompute holds the
    float32-grade bar of the float32 replay (`_close`: 1e-5 of each tensor's
    scale, rtol 1e-4) against autograd of the plain block."""
    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(*SPLIT_CASES[case])
    got, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                     split3_matmul)
    _hold_replay(got, want, 36 * cfg.num_layers)


def test_one_fp16_product_backward_replay_misses_the_bar():
    """One fp16 product per term (weights times 2^8) in the recompute lands
    well outside the bar the three-term replay holds."""
    def single(a, w):
        return f16(a) @ f16(w * W_SCALE) / W_SCALE

    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(
        *SPLIT_CASES["knn_K40"])
    three, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                       split3_matmul)
    one, _ = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads, single)
    assert _worst_over_scale(three, want) < 1e-5
    assert _worst_over_scale(one, want) > 10 * 1e-5
    with pytest.raises(AssertionError):
        _hold_replay(one, want, 36 * cfg.num_layers)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_tf32_drbf_backward_replay_matches_autograd_of_plain_block(case):
    """The kernel's algorithm with its three-term fp16 recompute and its d rbf
    as the kernel computes it (drbf_tf32: three-term TF32 over the row's two
    type tables, selected by type) holds the float32-grade bar (`_close`)
    against autograd of the plain block; K = 40 is two chunks, the second
    partial (8 slots)."""
    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(*SPLIT_CASES[case])
    got, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                     split3_matmul, drbf_tf32)
    _hold_replay(got, want, 36 * cfg.num_layers)


def test_one_term_tf32_drbf_backward_replay_misses_the_bar():
    """One TF32 product per term in d rbf lands well outside the bar that the
    three-term d rbf holds on the same inputs."""
    def one_term(dz, w_rbf, et, ta):
        return drbf_tf32(dz, w_rbf, et, ta, terms=1)

    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(
        *SPLIT_CASES["knn_K40"])
    three, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                       split3_matmul, drbf_tf32)
    one, _ = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                  split3_matmul, one_term)
    assert _worst_over_scale(three, want) < 1e-5
    assert _worst_over_scale(one, want) > 10 * 1e-5
    with pytest.raises(AssertionError):
        _hold_replay(one, want, 36 * cfg.num_layers)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_tf32_node_bwd_replay_matches_autograd_of_plain_block(case):
    """The kernel's algorithm with its three-term fp16 recompute, its d rbf and
    its node kernel's two products as the kernel computes them (node_tf32:
    three-term TF32 in the kernel's k-step order) holds the float32-grade bar
    (`_close`) against autograd of the plain block."""
    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(*SPLIT_CASES[case])
    got, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                     split3_matmul, drbf_tf32, node_tf32)
    _hold_replay(got, want, 36 * cfg.num_layers)


def test_one_term_tf32_node_bwd_replay_misses_the_bar():
    """One TF32 product per term in the node kernel's products lands well
    outside the bar that the three-term products hold on the same inputs."""
    def one_term(a, b):
        return node_tf32(a, b, terms=1)

    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(
        *SPLIT_CASES["knn_K40"])
    three, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                       split3_matmul, drbf_tf32, node_tf32)
    one, _ = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                  split3_matmul, drbf_tf32, one_term)
    assert _worst_over_scale(three, want) < 1e-5
    assert _worst_over_scale(one, want) > 10 * 1e-5
    with pytest.raises(AssertionError):
        _hold_replay(one, want, 36 * cfg.num_layers)


@pytest.mark.parametrize("V", [32, 4])
def test_node_bwd_plain_matches_jax_node_mlp_bwd(V):
    """`node_bwd_plain` (the node kernel's function on a pass's row buffer,
    width H = 32, value width V: x2h or h2x) against the JAX query MLP's
    backward `_node_mlp_bwd` on its `_node_mlp_fwd` residuals, plus a float64
    numpy dh product for the node projections' other columns, on the same
    seeded numpy inputs: qa, and dq1 and the LayerNorm partials through the
    gradients JAX forms from them (d b1 and d w1 = h^T dq1, d lns, d lnb),
    w_q2's gradient qa^T dq, and dh."""
    rng = np.random.default_rng(21)
    n, H = 37, 32
    f32 = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)  # noqa: E731
    h_tile, w_node, b1 = f32(n, H), f32(H, 5 * H, s=H ** -0.5), f32(H, s=0.1)
    lns, lnb, w_q2, b2 = 1 + f32(H, s=0.2), f32(H, s=0.3), f32(H, H, s=H ** -0.5), f32(H)
    lay = block_vjp.row_layout(H, V)
    rowbuf, dh = f32(n, lay["width"]), f32(n, H)
    dq = rowbuf[:, lay["dq"]:lay["dq"] + H]
    w1 = w_node[:, 4 * H:]
    _, res = _node_mlp_fwd(*map(jnp.asarray, (h_tile, w1, b1, lns, lnb, w_q2, b2)))
    dh_q, (dw1, db1, dlns, dlnb, dw2, _) = _node_mlp_bwd(
        jnp.asarray(dq), res, jnp.asarray(h_tile), jnp.asarray(w1), jnp.asarray(lns),
        jnp.asarray(w_q2))
    q1 = np.array(res[0])
    out, qa, dh_out = block_vjp.node_bwd_plain(
        *map(torch.from_numpy, (rowbuf, q1, dh, np.stack([lns, lnb]), w_q2.T.copy(),
                                w_node.T.copy())))
    dq1 = out[:, 4 * H:5 * H].numpy()
    qln = out[:, lay["qln"]:lay["qln"] + 2 * H].numpy()

    def close(got, want, name):
        want = np.asarray(want, np.float64).reshape(np.shape(got))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    close(qa.numpy(), res[4], "qa")
    close(dq1.sum(0), db1, "d b1")
    close(h_tile.T.astype(np.float64) @ dq1, dw1, "d w1")
    close(qln[:, :H].sum(0), dlns, "d lns")
    close(qln[:, H:].sum(0), dlnb, "d lnb")
    close(qa.numpy().T.astype(np.float64) @ dq, dw2, "d w2")
    want_dh = (dh.astype(np.float64) + np.asarray(dh_q, np.float64)
               + rowbuf[:, :4 * H].astype(np.float64) @ w_node[:, :4 * H].T.astype(np.float64))
    close(dh_out.numpy(), want_dh, "dh")
    untouched = np.ones(lay["width"], bool)
    untouched[4 * H:5 * H] = untouched[lay["qln"]:lay["qln"] + 2 * H] = False
    assert np.array_equal(out.numpy()[:, untouched], rowbuf[:, untouched])


def test_two_table_drbf_from_staged_fragments_equals_einsum_over_edge_types():
    """The two-table-and-select form of d rbf, on B operands decoded from the
    port's staged fragments (`stage_rbf_frags`, the layout the kernel reads),
    equals dz . w_rbf[type] on rows of both destination kinds with invalid
    slots (dz zero, as the kernel has them) and a partial last chunk (K = 40,
    slots padded to 64 with type 3 and noise in dz: the kernel reads only the
    slots below K). Every fragment word is a TF32 number, and hi + lo gives
    the table to ~2^-22."""
    rng = np.random.default_rng(5)
    H2, K, KP, nrow = 64, 40, 64, 6
    w_rbf = torch.from_numpy(rng.normal(size=(4, 20, H2)) * 10.0 ** rng.uniform(-3, 1, (4, 20, 1)))
    w_rbf = w_rbf.float()
    frags = block_vjp.stage_rbf_frags(w_rbf)
    assert frags.shape == (2, H2 // 8, 5, 32, 4) and frags.dtype == torch.int32
    assert bool(((frags & 0x1FFF) == 0).all())  # TF32: the 13 low mantissa bits clear
    # decode: kind, ks, nt, (g, tig), (b0 hi, b1 hi, b0 lo, b1 lo) -> B [2][k][j]
    f = frags.view(torch.float32).reshape(2, H2 // 8, 5, 8, 4, 2, 2)  # .., g, tig, hi|lo, b0|b1
    tables = f.permute(5, 0, 1, 6, 4, 2, 3).reshape(2, 2, H2, 40)  # hi|lo, kind, k, j
    want_b = _two_tables(w_rbf).transpose(1, 2)
    torch.testing.assert_close(tables[0], split3(want_b)[0], rtol=0, atol=0)
    torch.testing.assert_close(tables[1], split3(want_b)[1], rtol=0, atol=0)
    b = tables[0].double() + tables[1].double()
    assert float(((b - want_b.double()).abs() / want_b.double().abs()).max()) < 2 ** -21
    # rows: three ligand (kind 0), three protein (kind 1); sources of both kinds
    dst_lig = torch.tensor([True, True, True, False, False, False])
    src_lig = torch.from_numpy(rng.random((nrow, KP)) < 0.4)
    et = torch.where(src_lig, torch.where(dst_lig[:, None], 0, 1),
                     torch.where(dst_lig[:, None], 2, 3))
    et[:, K:] = 3
    ta = torch.where(dst_lig, 0, 1)[:, None].expand(nrow, KP)
    valid = torch.from_numpy(rng.random((nrow, KP)) < 0.8)
    valid[:, K:] = False
    dz = torch.from_numpy(rng.normal(size=(nrow, KP, H2))).float()
    dz[:, :K] *= valid[:, :K, None]
    got = _by_kind(torch.einsum("nkc,tcj->tnkj", dz.double(), b), et, ta, 20)[:, :K]
    want = drbf_einsum(dz[:, :K].double(), w_rbf.double(), et[:, :K], ta[:, :K])
    scale = torch.einsum("nkc,nkrc->nkr", dz[:, :K].double().abs(),
                         w_rbf.double().abs()[et[:, :K]])
    assert float(((got - want).abs() / scale.clamp(min=1e-30)).max()) < 2 ** -20
    assert bool((got[~valid[:, :K]] == 0).all())
    # the kernel's arithmetic (three TF32 terms) on the same slots
    tf = drbf_tf32(dz[:, :K], w_rbf, et[:, :K], ta[:, :K])
    assert float(((tf.double() - want).abs() / scale.clamp(min=1e-30)).max()) < 1e-5


class _SplitReplayBlock(torch.autograd.Function):
    """The block on the CPU: the plain train-mode forward, and as backward
    the kernel's algorithm with the three-term fp16 recompute
    (`replay_block_bwd`), returning the packed weights' gradients as
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
        dh0, dx0, dew, gx2h, gh2x = replay_block_bwd(x2h, h2x, hck, xck, ctx.nbh, mlig, e_w,
                                                     ctx.n_ligand, gh, gx, ctx.n_heads,
                                                     split3_matmul)
        return (dh0, dx0, dew, None, None, None, None, None,
                *[gx2h[f] for f in FIELDS], *[gh2x[f] for f in FIELDS])


@pytest.mark.parametrize("case", ["knn_K8", "hybrid_K40"])
def test_split3_backward_replay_loss_and_grads_match_jax_xla(case, monkeypatch):
    """The loss's gradients with the split3 replay as the whole block's
    backward (any K) against jax.value_and_grad of the JAX XLA loss, held as
    `test_loss_and_grads_match_jax_xla` holds the port's."""
    cfg, jmodel, params, jbatch, model, batch, *_ = _split_setup(*SPLIT_CASES[case])
    calls = []

    def trainable(refine_net, h, x, nbh, mask_ligand, e_w, n_ligand, dtype=torch.float32):
        assert dtype == torch.float32
        calls.append(nbh.idx.shape[-1])
        x2h, h2x = pack_pass_params(refine_net)
        return _SplitReplayBlock.apply(h, x, e_w, refine_net, nbh, mask_ligand, n_ligand,
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


def test_train_checkpoints_match_jax_megakernel():
    cfg, params, model, rn, h, x, mlig, nbh, e_w, _, _, node_mask = _train_inputs()
    L, H, NL = cfg.num_layers, cfg.hidden_dim, model.max_ligand
    hck, xck = block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w)
    ew_p, block_p = extract_block_params(params["params"]["refine_net"], L, H,
                                         cfg.num_r_gaussian, dtype=jnp.float32,
                                         n_heads=cfg.n_heads)
    offsets, coeff = jax_offsets(0.0, cfg.r_max, cfg.num_r_gaussian)
    _, _, jhck, jxck = jax_block_denoiser(
        jnp.asarray(h.numpy()), jnp.asarray(x.numpy()), jnp.asarray(nbh.idx.numpy()),
        jnp.asarray(nbh.mask.numpy()), jnp.asarray(mlig.numpy()), offsets, ew_p, block_p,
        num_layers=L, n_heads=cfg.n_heads, coeff=coeff, dtype=jnp.float32, interpret=True,
        n_ligand=NL, ew_in=jnp.asarray(e_w.numpy()), train_checkpoints=True)
    m = node_mask[:, None, :, None]  # fully masked rows are implementation-defined
    assert hck.shape == (L + 1, *h.shape) and xck.shape == (L + 1, *x.shape)
    # the JAX kernel lays its checkpoints out as [B,L+1,...]
    np.testing.assert_allclose(xck.transpose(0, 1).numpy() * m, np.asarray(jxck) * m,
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(hck.transpose(0, 1).numpy() * m, np.asarray(jhck) * m,
                               atol=2e-3, rtol=1e-2)
    with torch.no_grad():
        h_out, x_out = rn.block_forward(h, x, nbh, mlig, e_w=e_w)
    assert torch.equal(hck[-1], h_out) and torch.equal(xck[-1], x_out)
    assert torch.equal(hck[0], h) and torch.equal(xck[0], x)


def test_trainable_block_on_cpu_is_the_plain_block():
    _, _, model, rn, h, x, mlig, nbh, e_w, _, _, _ = _train_inputs()
    with torch.no_grad():
        got = block_layers_trainable(rn, h, x, nbh, mlig, e_w, model.max_ligand)
        want = rn.block_forward(h, x, nbh, mlig, e_w=e_w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def jax_draws(key, batch, num_classes):
    """The draws of the JAX get_diffusion_loss for `key`
    (targetdiff_tpu/models/score_model.py:325-336)."""
    _, key_pos, key_v = jax.random.split(key, 3)
    eps = np.asarray(jax.random.normal(key_pos, batch.ligand_pos.shape))
    u = np.asarray(jax.random.uniform(key_v, batch.ligand_v.shape + (num_classes,)))
    return torch.from_numpy(eps), torch.from_numpy(u)


@pytest.mark.parametrize("impl", ["fast", "eager"])
def test_loss_and_grads_match_jax_xla(impl):
    _, jmodel, params, jbatch, model, batch = small_setup()
    key, t = jax.random.PRNGKey(5), np.array([2, 7])

    def loss_fn(p):
        return jmodel.get_diffusion_loss(p, key, jbatch, time_step=jnp.asarray(t))["loss"]

    la, ga = jax.value_and_grad(loss_fn)(params)
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    model.net.zero_grad()
    out = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                   v_uniform=u, impl=impl)
    out["loss"].backward()
    assert abs(float(out["loss"]) - float(la)) / abs(float(la)) < 1e-4
    want = flax_params_to_state_dict(jax.device_get(ga))
    got = dict(model.net.named_parameters())
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        a, b = a.numpy(), got[name].grad.numpy()
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(b, a, atol=5e-3 * scale, rtol=5e-3, err_msg=name)


def test_training_kernel_wrappers_refuse_cpu_tensors():
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp

    _, _, model, rn, h, x, mlig, nbh, e_w, gh, gx, _ = _train_inputs()
    x2h, h2x = pack_pass_params(rn)
    with pytest.raises(ValueError, match="CUDA"):
        kblock.block_denoiser_train_cuda(rn, h, x, nbh, mlig, e_w, model.max_ligand, x2h, h2x)
    hck, xck = block_denoiser_train_plain(rn, h, x, nbh, mlig, e_w)
    with pytest.raises(ValueError, match="CUDA"):
        block_vjp.block_bwd_cuda(hck, xck, nbh.idx, nbh.mask,
                                 mlig, e_w, model.max_ligand, x2h, h2x, gh, gx)
    assert kblock.TRAIN_LAUNCHES == 0 and block_vjp.LAUNCHES == 0
    assert block_vjp.NODE_BWD_LAUNCHES == 0
