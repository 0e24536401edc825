"""The per-layer slice on the CPU: the hybrid graph, the plain versions of
the per-layer kernels (one x2h and one h2x sub-layer with the edge weights
given) and their gradients, the hybrid ScorePosNet and the per-layer
training loss, each held against the JAX package: its hybrid graph, its
per-layer Pallas kernels and their custom VJPs in interpret mode, its XLA
forward and its `impl='fast_pl'` loss. Inputs come from numpy seeds; weights
are carried across by utils/port.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.models.fast_forward import extract_layer_params
from targetdiff_tpu.ops import graph as JG
from targetdiff_tpu.ops.pallas.edge_layer import h2x_attention_layer as jax_h2x
from targetdiff_tpu.ops.pallas.edge_layer import x2h_attention_layer as jax_x2h
from targetdiff_tpu.ops.pallas.edge_layer_vjp import h2x_layer_trainable as jax_h2x_trainable
from targetdiff_tpu.ops.pallas.edge_layer_vjp import x2h_layer_trainable as jax_x2h_trainable
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import build, edge_layer, edge_layer_vjp
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict
from tests.test_fast_forward import PROTEIN_DIM, small_flagship
from tests.test_torch_block_vjp import jax_draws
from tests.test_torch_score_model import assert_ligand_close, small_setup

torch.set_num_threads(2)

POS_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_fast_forward.py
H_TOL = dict(atol=2e-3, rtol=1e-2)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)  # tests/test_edge_layer_vjp.py:_cmp_tree


def _hybrid_inputs(seed=0, cutoff_mode="hybrid"):
    """A hybrid model at small width (H=32, 4 heads, k=8, 8 ligand slots:
    N = 24, K = 15) with its JAX twin, and one layer's inputs: h and e_w
    from a numpy seed, positions and masks from the batch (a padded protein
    row, padded ligand slots), the JAX graph and edge types."""
    cfg, jmodel, params, jbatch, model, batch = small_setup(cutoff_mode=cutoff_mode)
    rng = np.random.default_rng(seed)
    B, NP_ = jbatch.protein_mask.shape
    NL = jbatch.ligand_mask.shape[1]
    N, H = NP_ + NL, cfg.hidden_dim
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    x = np.concatenate([np.asarray(jbatch.protein_pos), np.asarray(jbatch.ligand_pos)], 1)
    node_mask = np.concatenate([np.asarray(jbatch.protein_mask), np.asarray(jbatch.ligand_mask)],
                               1)
    mlig = node_mask & (np.arange(N) >= NP_)[None]
    if cutoff_mode == "hybrid":
        nbh = JG.hybrid_graph(jnp.asarray(x), jnp.asarray(node_mask), jnp.asarray(mlig),
                              cfg.knn, NL)
    else:
        nbh = JG.knn_graph(jnp.asarray(x), jnp.asarray(node_mask), cfg.knn)
    idx, nmask = np.asarray(nbh.idx), np.asarray(nbh.mask)
    src_lig = np.take_along_axis(np.broadcast_to(mlig[:, None, :], (B, N, N)), idx, axis=2)
    dst_lig = mlig[:, :, None]
    etype = np.where(src_lig & dst_lig, 0, np.where(src_lig, 1, np.where(dst_lig, 2, 3)))
    e_w = rng.uniform(0.1, 1.0, size=idx.shape).astype(np.float32)
    return dict(cfg=cfg, params=params, model=model, jmodel=jmodel, jbatch=jbatch, batch=batch,
                h=h, x=x, node_mask=node_mask, mlig=mlig, idx=idx, nmask=nmask,
                etype=etype.astype(np.int32), e_w=e_w, NL=NL)


def _torch(d):
    nbh = G.Neighborhood(torch.from_numpy(d["idx"]).long(), torch.from_numpy(d["nmask"]))
    return (torch.from_numpy(d["h"]), torch.from_numpy(d["x"]), nbh,
            torch.from_numpy(d["mlig"]), torch.from_numpy(d["e_w"]))


def _jax_layer(d, l=0):
    cfg = d["cfg"]
    offsets, coeff = jax_offsets(0.0, cfg.r_max, cfg.num_r_gaussian)
    block = d["params"]["params"]["refine_net"][f"block_{l}"]
    return block, offsets, coeff


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hybrid_graph_matches_jax(seed):
    """Tie-free random geometry: the same neighbours, slots and masks."""
    rng = np.random.default_rng(seed)
    B, NP_, NL, k = 2, 40, 16, 8
    N = NP_ + NL
    pos = (rng.normal(size=(B, N, 3)) * 4).astype(np.float32)
    node_mask = np.ones((B, N), bool)
    node_mask[0, 35:NP_] = False
    node_mask[1, NP_ + 10:] = False
    mlig = node_mask & (np.arange(N) >= NP_)[None]
    want = JG.hybrid_graph(jnp.asarray(pos), jnp.asarray(node_mask), jnp.asarray(mlig), k, NL)
    got = G.hybrid_graph(torch.from_numpy(pos), torch.from_numpy(node_mask),
                         torch.from_numpy(mlig), k, NL)
    assert got.idx.shape == (B, N, NL - 1 + k)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    # valid slots come first on every row, at most k protein sources per row
    m = got.mask.numpy()
    assert (np.sort(m, axis=-1)[..., ::-1] == m).all()
    src_protein = ~np.take_along_axis(np.broadcast_to(mlig[:, None], (B, N, N)),
                                      got.idx.numpy(), 2)
    assert ((src_protein & m).sum(-1) <= k).all()


def test_hybrid_graph_breaks_ties_as_jax():
    """Integer lattice positions: exact distance ties go to the lower index."""
    B, NP_, NL, k = 1, 24, 8, 6
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2), indexing="ij"), -1)
    pos = g.reshape(1, -1, 3).astype(np.float32)[:, :NP_ + NL]
    node_mask = np.ones((B, NP_ + NL), bool)
    mlig = node_mask & (np.arange(NP_ + NL) >= NP_)[None]
    want = JG.hybrid_graph(jnp.asarray(pos), jnp.asarray(node_mask), jnp.asarray(mlig), k, NL)
    got = G.hybrid_graph(torch.from_numpy(pos), torch.from_numpy(node_mask),
                         torch.from_numpy(mlig), k, NL)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("cutoff_mode", ["hybrid", "knn"])
def test_x2h_layer_plain_matches_jax_kernel(cutoff_mode):
    d = _hybrid_inputs(0, cutoff_mode)
    cfg = d["cfg"]
    block, offsets, coeff = _jax_layer(d)
    px, _ = extract_layer_params(block, cfg.hidden_dim, cfg.num_r_gaussian)
    want = jax_x2h(jnp.asarray(d["h"]), jnp.asarray(d["x"]), jnp.asarray(d["idx"]),
                   jnp.asarray(d["nmask"]), jnp.asarray(d["etype"]), jnp.asarray(d["e_w"]),
                   offsets, px, n_heads=cfg.n_heads, coeff=coeff, dtype=jnp.float32,
                   interpret=True)
    layer = d["model"].net.refine_net.base_block[0]
    with torch.no_grad():
        got = edge_layer.x2h_attention_layer(layer, *_torch(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **H_TOL)


@pytest.mark.parametrize("cutoff_mode", ["hybrid", "knn"])
def test_h2x_layer_plain_matches_jax_kernel(cutoff_mode):
    d = _hybrid_inputs(1, cutoff_mode)
    cfg = d["cfg"]
    block, offsets, coeff = _jax_layer(d)
    _, ph = extract_layer_params(block, cfg.hidden_dim, cfg.num_r_gaussian)
    want = jax_h2x(jnp.asarray(d["h"]), jnp.asarray(d["x"]), jnp.asarray(d["idx"]),
                   jnp.asarray(d["nmask"]), jnp.asarray(d["etype"]), jnp.asarray(d["e_w"]),
                   jnp.asarray(d["mlig"]), offsets, ph, n_heads=cfg.n_heads, coeff=coeff,
                   dtype=jnp.float32, interpret=True, n_ligand=d["NL"])
    layer = d["model"].net.refine_net.base_block[0]
    with torch.no_grad():
        got = edge_layer.h2x_attention_layer(layer, *_torch(d), n_ligand=d["NL"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POS_TOL)
    assert torch.equal(got[:, :-d["NL"]], torch.from_numpy(d["x"])[:, :-d["NL"]])


def _layer_grads(d, sub, trainable_jax, fields_index):
    """Gradients of sum(g * layer(h, x, e_w)) on both sides: the JAX custom
    VJP in interpret mode (weights as the flax block, so its gradient maps
    to the port's parameters) and autograd of the port's plain layer."""
    cfg, NL = d["cfg"], d["NL"]
    block, offsets, coeff = _jax_layer(d)
    rng = np.random.default_rng(21)
    out_dim = cfg.hidden_dim if sub == "x2h" else 3
    g = rng.normal(size=d["h"].shape[:2] + (out_dim,)).astype(np.float32)
    args = [jnp.asarray(d[k]) for k in ("idx", "nmask", "etype")]

    def loss(h, x, e_w, blk):
        p = extract_layer_params(blk, cfg.hidden_dim, cfg.num_r_gaussian)[fields_index]
        if sub == "x2h":
            out = trainable_jax(h, x, *args, e_w, offsets, p, cfg.n_heads, coeff, True,
                                jnp.float32)
        else:
            out = trainable_jax(h, x, *args, e_w, jnp.asarray(d["mlig"]), offsets, p,
                                cfg.n_heads, coeff, True, NL, jnp.float32)
        return (out * jnp.asarray(g)).sum()

    ja = jax.grad(loss, argnums=(0, 1, 2, 3))(jnp.asarray(d["h"]), jnp.asarray(d["x"]),
                                              jnp.asarray(d["e_w"]), block)
    rn = d["model"].net.refine_net
    rn.zero_grad(set_to_none=True)
    h, x, nbh, mlig, e_w = _torch(d)
    leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
    if sub == "x2h":
        out = edge_layer_vjp.x2h_layer_trainable(rn.base_block[0], leaves[0], leaves[1], nbh,
                                                 mlig, leaves[2])
    else:
        out = edge_layer_vjp.h2x_layer_trainable(rn.base_block[0], leaves[0], leaves[1], nbh,
                                                 mlig, leaves[2], NL)
    (out * torch.from_numpy(g)).sum().backward()
    for i, name in enumerate(("dh", "dx", "de_w")):
        np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(ja[i]), **GRAD_TOL,
                                   err_msg=name)
    want = flax_params_to_state_dict({"refine_net": {"block_0": jax.device_get(ja[3])}})
    got = {f"refine_net.{n}": p.grad for n, p in rn.named_parameters()}
    used = [n for n in want if f".{sub}_layers." in n]
    assert len(used) == 18
    for name in want:
        if name in used:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **GRAD_TOL,
                                       err_msg=name)
        else:  # the other sub-layer's parameters: no gradient on either side
            assert got[name] is None and not want[name].abs().max() > 0, name


@pytest.mark.parametrize("cutoff_mode", ["hybrid", "knn"])
def test_x2h_layer_grads_match_jax_vjp(cutoff_mode):
    _layer_grads(_hybrid_inputs(2, cutoff_mode), "x2h", jax_x2h_trainable, 0)


@pytest.mark.parametrize("cutoff_mode", ["hybrid", "knn"])
def test_h2x_layer_grads_match_jax_vjp(cutoff_mode):
    _layer_grads(_hybrid_inputs(3, cutoff_mode), "h2x", jax_h2x_trainable, 1)


@pytest.mark.parametrize("path", ["eager", "mega", "layers"])
def test_hybrid_forward_matches_jax_xla_and_layers(path):
    _, jmodel, params, jbatch, model, batch = small_setup(cutoff_mode="hybrid")
    t = jnp.array([3, 7])
    ref_xla = jmodel.apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, t)
    ref_pl = jmodel.fast_apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, t,
                               dtype=jnp.float32, interpret=True, mode="layers")
    with torch.no_grad():
        if path == "eager":
            out = model.apply(batch, batch.ligand_pos, batch.ligand_v)
        else:
            out = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode=path,
                                   dtype=torch.float32)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    assert_ligand_close(out, ref_xla, lmask)
    assert_ligand_close(out, ref_pl, lmask)


def test_wide_graph_downgrades_to_the_layer_path():
    """K = max_ligand - 1 + k > 32: mode 'mega' warns and runs the layers."""
    cfg = small_flagship()
    cfg.update(cutoff_mode="hybrid", knn=30)
    from targetdiff_tpu_torch.data.batch import from_numpy
    from targetdiff_tpu_torch.models.score_model import DiffusionModel

    torch.manual_seed(0)
    model = DiffusionModel(cfg, PROTEIN_DIM, 13, device="cpu", max_protein=40, max_ligand=8)
    rng = np.random.default_rng(5)
    batch = from_numpy(rng.normal(size=(2, 40, 3)) * 3, rng.random((2, 40, PROTEIN_DIM)) > 0.7,
                       np.ones((2, 40), bool), rng.normal(size=(2, 8, 3)),
                       rng.integers(0, 13, (2, 8)), np.arange(8)[None] < np.array([[8], [5]]))
    assert model.net.refine_net.num_neighbors() == 37
    with torch.no_grad(), pytest.warns(UserWarning, match="per-layer"):
        mega = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode="mega")
    with torch.no_grad():
        layers = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode="layers")
    for key in ("pred_ligand_pos", "pred_ligand_v"):
        assert torch.equal(mega[key], layers[key])
    with pytest.raises(ValueError, match="max_ligand=8"):
        model.apply(batch._replace(ligand_pos=batch.ligand_pos[:, :6],
                                   ligand_v=batch.ligand_v[:, :6],
                                   ligand_mask=batch.ligand_mask[:, :6]),
                    batch.ligand_pos[:, :6], batch.ligand_v[:, :6])


@pytest.mark.parametrize("cutoff_mode", ["knn", "hybrid"])
def test_fast_pl_loss_and_grads_match_jax(cutoff_mode):
    _, jmodel, params, jbatch, model, batch = small_setup(cutoff_mode=cutoff_mode)
    key, t = jax.random.PRNGKey(5), np.array([2, 7])

    def loss_fn(p):
        return jmodel.get_diffusion_loss(p, key, jbatch, time_step=jnp.asarray(t),
                                         impl="fast_pl")["loss"]

    la, ga = jax.value_and_grad(loss_fn)(params)
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    model.net.zero_grad()
    out = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                   v_uniform=u, impl="fast_pl")
    out["loss"].backward()
    assert abs(float(out["loss"].detach()) - float(la)) / abs(float(la)) < 1e-4
    want = flax_params_to_state_dict(jax.device_get(ga))
    got = dict(model.net.named_parameters())
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        a, b = a.numpy(), got[name].grad.numpy()
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(b, a, atol=5e-3 * scale, rtol=5e-3, err_msg=name)


def test_layer_kernel_wrappers_refuse_cpu_tensors():
    d = _hybrid_inputs(4)
    layer = d["model"].net.refine_net.base_block[0]
    px, ph = edge_layer.pack_layer_params(layer)
    h, x, nbh, mlig, e_w = _torch(d)
    before = (edge_layer.X2H_LAUNCHES, edge_layer.H2X_LAUNCHES,
              edge_layer_vjp.X2H_BWD_LAUNCHES, edge_layer_vjp.H2X_BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        edge_layer.x2h_layer_cuda(h, x, nbh, mlig, e_w, px)
    with pytest.raises(ValueError, match="CUDA"):
        edge_layer.h2x_layer_cuda(h, x, nbh, mlig, e_w, d["NL"], ph)
    with pytest.raises(ValueError, match="CUDA"):
        edge_layer_vjp.x2h_layer_bwd_cuda(h, x, nbh, mlig, e_w, px, h)
    with pytest.raises(ValueError, match="CUDA"):
        edge_layer_vjp.h2x_layer_bwd_cuda(h, x, nbh, mlig, e_w, d["NL"], ph, x)
    after = (edge_layer.X2H_LAUNCHES, edge_layer.H2X_LAUNCHES,
             edge_layer_vjp.X2H_BWD_LAUNCHES, edge_layer_vjp.H2X_BWD_LAUNCHES)
    assert after == before
    # on CPU tensors the wrappers are the plain layers, with the same results
    with torch.no_grad():
        assert torch.equal(edge_layer_vjp.x2h_layer_trainable(layer, h, x, nbh, mlig, e_w),
                           edge_layer.x2h_layer_plain(layer, h, x, nbh, mlig, e_w))
        assert torch.equal(edge_layer_vjp.h2x_layer_trainable(layer, h, x, nbh, mlig, e_w,
                                                              d["NL"]),
                           edge_layer.h2x_layer_plain(layer, h, x, nbh, mlig, e_w))


def test_only_the_layer_backwards_limit_the_node_count(monkeypatch):
    """N above the inverse adjacency's limit passes the forward kernels' input
    check; the backwards refuse it, naming the limit, before any launch."""
    monkeypatch.setattr(build, "require_cuda", lambda t, name: None)
    B, N, K, H = 1, edge_layer_vjp.MAX_NODES + 8, 2, edge_layer.HIDDEN
    nbh = G.Neighborhood(torch.zeros((B, N, K), dtype=torch.long),
                         torch.ones((B, N, K), dtype=torch.bool))
    h, x, e_w = torch.zeros((B, N, H)), torch.zeros((B, N, 3)), torch.ones((B, N, K))
    mlig = torch.zeros((B, N), dtype=torch.bool)
    params = {"w_node": torch.zeros((1, 1)), "w2k": torch.zeros((1, H))}
    edge_layer.check_layer_inputs(h, x, nbh, mlig, e_w, params)
    limit = f"N <= {edge_layer_vjp.MAX_NODES}"
    with pytest.raises(ValueError, match=limit):
        edge_layer_vjp.x2h_layer_bwd_cuda(h, x, nbh, mlig, e_w, params, h)
    with pytest.raises(ValueError, match=limit):
        edge_layer_vjp.h2x_layer_bwd_cuda(h, x, nbh, mlig, e_w, 8, params, x)
