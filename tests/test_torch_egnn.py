"""The port's EGNN denoiser (`model_type: egnn`) against the JAX package on
the CPU: the general MLP, `EnBaseLayer` and `EGNN` (kNN and hybrid graphs,
frozen coordinates), `ScorePosNet` at the JAX suite's bars (positions 2e-4 /
1e-3, logits 2e-3 / 1e-2), the eager loss with JAX's draws (1e-4) and its
gradients, one ddpm and one ddim step with JAX's noise, the likelihood terms
and the embedding export, one Adam step against the JAX trainer, the weight
bridge and .npz checkpoints in both directions, `resolve_impl` (the path
the model reads from its config), the kernel paths' refusal, and the
sampling and train entry points on that path. Weights are bridged from the JAX
parameters; the kNN graph is the kernel's plain version here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu import trainer as jtrainer
from targetdiff_tpu.config import Config as JConfig
from targetdiff_tpu.models import common as jcommon
from targetdiff_tpu.models import egnn as jegnn
from targetdiff_tpu.models.score_model import DiffusionModel as JaxDiffusionModel
from targetdiff_tpu.ops import diffusion as JD
from targetdiff_tpu.ops import graph as JG
from targetdiff_tpu.utils import checkpoint as jckpt
from targetdiff_tpu.utils import train as JTU
from targetdiff_tpu_torch import trainer as T
from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models import common, egnn
from targetdiff_tpu_torch.models.fast_forward import require_kernels, resolve_impl
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops import diffusion as D
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.utils import checkpoint as ckpt
from targetdiff_tpu_torch.utils import train as TU
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict, state_dict_to_flax_params
from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, batch_mult8, small_flagship
from tests.test_torch_block_vjp import jax_draws
from tests.test_torch_ddim import MARGIN, NOISE_SEED, POS_ATOL, _centered, _gumbel_margin
from tests.test_torch_ddim import _noise, _ts_pair
from tests.test_torch_score_model import LOGIT_TOL, POS_TOL

torch.set_num_threads(2)

H_TOL = dict(atol=2e-4, rtol=1e-3)
ELBO_TOL = dict(atol=2e-4, rtol=2e-3)
OPT = dict(type="adam", lr=5e-4, weight_decay=0.0, beta1=0.95, beta2=0.999, max_grad_norm=8.0)


def egnn_config(**overrides):
    cfg = small_flagship()
    cfg.update(dict(model_type="egnn"), **overrides)
    return cfg


def egnn_setup(**overrides):
    """(config, JAX model, JAX params, JAX batch, port model, port batch) for
    the EGNN denoiser at small width (H=32, K=8, L=2)."""
    cfg = egnn_config(**overrides)
    jbatch = batch_mult8()
    jmodel = JaxDiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, max_protein=16, max_ligand=8)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=16,
                           max_ligand=8)
    model.net.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    batch = from_numpy(*[np.asarray(a) for a in jbatch])
    return cfg, jmodel, params, jbatch, model, batch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _load(module, flax_tree):
    module.load_state_dict(flax_params_to_state_dict(jax.device_get(flax_tree)))  # strict


# ---- the general MLP ----------------------------------------------------------------

@pytest.mark.parametrize("norm,act_fn,act_last", [(True, "relu", False), (False, "silu", True),
                                                  (True, "silu", True), (False, "tanh", False)])
def test_mlp_matches_jax_with_the_reference_names(norm, act_fn, act_last):
    x = np.random.default_rng(1).normal(size=(5, 7, 12)).astype(np.float32)
    jmlp = jcommon.MLP(16, 24, num_layer=2, norm=norm, act_fn=act_fn, act_last=act_last)
    params = jmlp.init(jax.random.PRNGKey(2), jnp.asarray(x))
    mlp = common.MLP(12, 16, 24, num_layer=2, norm=norm, act_fn=act_fn, act_last=act_last)
    _load(mlp, params)
    names = sorted(n.rsplit(".", 1)[0] for n in mlp.state_dict())
    want = (["net.0", "net.1", "net.3"] if norm else ["net.0", "net.2"])
    if norm and act_last:
        want.append("net.4")
    assert sorted(set(names)) == want
    np.testing.assert_allclose(_np(mlp(torch.from_numpy(x))),
                               np.asarray(jmlp.apply(params, jnp.asarray(x))), atol=1e-5,
                               rtol=1e-5)
    back = state_dict_to_flax_params(mlp.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.device_get(params["params"]))


def test_released_mlp_keeps_its_names_and_unknown_activation_raises():
    """The released MLP keeps net.0/1/3; an unknown activation raises with
    its name; swish is JAX's, one learnable beta an MLP (flax's Swish_0),
    shared by the MLP's activations, at the first activation's index."""
    assert sorted(common.MLP(4, 2, 8).state_dict()) == [
        "net.0.bias", "net.0.weight", "net.1.bias", "net.1.weight", "net.3.bias", "net.3.weight"]
    with pytest.raises(ValueError, match="gelu"):
        common.get_activation("gelu")
    x = np.random.default_rng(4).normal(size=(3, 5, 12)).astype(np.float32)
    for norm in (True, False):
        jmlp = jcommon.MLP(16, 24, num_layer=2, norm=norm, act_fn="swish")
        params = jax.device_get(jmlp.init(jax.random.PRNGKey(3), jnp.asarray(x)))
        params["params"]["Swish_0"]["beta"] = np.float32(0.7)
        mlp = common.MLP(12, 16, 24, num_layer=2, norm=norm, act_fn="swish")
        _load(mlp, params)
        assert f"net.{2 if norm else 1}.beta" in mlp.state_dict()
        np.testing.assert_allclose(_np(mlp(torch.from_numpy(x))),
                                   np.asarray(jmlp.apply(params, jnp.asarray(x))), atol=1e-5,
                                   rtol=1e-5)
        back = state_dict_to_flax_params(mlp.state_dict())["params"]
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, params["params"])
    act = common.MLP(4, 2, 8, num_layer=3, act_fn="swish").net
    assert act[2] is act[5] and len(list(act.parameters())) == 3 * 2 + 2 * 2 + 1


# ---- EnBaseLayer and EGNN -----------------------------------------------------------

def _graph_inputs(cutoff_mode, seed=3, B=2, NP_=14, NL=6, H=16):
    rng = np.random.default_rng(seed)
    N = NP_ + NL
    x = (rng.normal(size=(B, N, 3)) * 2.5).astype(np.float32)
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    node_mask = np.ones((B, N), bool)
    node_mask[0, 12:NP_] = False
    node_mask[1, NP_ + 4:] = False
    mask_ligand = np.zeros((B, N), bool)
    mask_ligand[:, NP_:] = True
    mask_ligand &= node_mask
    return h, x, node_mask, mask_ligand, NL


def _nbh(cutoff_mode, x, node_mask, mask_ligand, k, nl):
    if cutoff_mode == "hybrid":
        return (JG.hybrid_graph(jnp.asarray(x), jnp.asarray(node_mask), jnp.asarray(mask_ligand),
                                k, nl),
                G.hybrid_graph(torch.from_numpy(x), torch.from_numpy(node_mask),
                               torch.from_numpy(mask_ligand), k, nl))
    return (JG.knn_graph(jnp.asarray(x), jnp.asarray(node_mask), k),
            G.knn_graph(torch.from_numpy(x), torch.from_numpy(node_mask), k))


@pytest.mark.parametrize("cutoff_mode", ["knn", "hybrid"])
@pytest.mark.parametrize("fix_x", [False, True])
def test_en_base_layer_matches_jax(cutoff_mode, fix_x):
    """The layer as the denoiser builds it (one distance feature, silu, no
    norm; the MLP names with a norm: the prop encoder's tests)."""
    h, x, node_mask, mask_ligand, nl = _graph_inputs(cutoff_mode)
    jnbh, nbh = _nbh(cutoff_mode, x, node_mask, mask_ligand, 5, nl)
    np.testing.assert_array_equal(_np(nbh.idx), np.asarray(jnbh.idx))
    jet = JG.edge_types(jnbh, jnp.asarray(mask_ligand)).astype(jnp.float32)
    jlayer = jegnn.EnBaseLayer(16, 4, 1)
    args = (jnp.asarray(h), jnp.asarray(x), jnbh, jnp.asarray(mask_ligand), jet, fix_x)
    params = jlayer.init(jax.random.PRNGKey(4), *args)
    jh, jx = jlayer.apply(params, *args)
    layer = egnn.EnBaseLayer(16, 4)
    _load(layer, params)
    hh, xx = layer(torch.from_numpy(h), torch.from_numpy(x), nbh, torch.from_numpy(mask_ligand),
                   G.edge_types(nbh, torch.from_numpy(mask_ligand)), fix_x=fix_x)
    m = node_mask[..., None]
    np.testing.assert_allclose(_np(hh) * m, np.asarray(jh) * m, **H_TOL)
    np.testing.assert_allclose(_np(xx) * m, np.asarray(jx) * m, atol=1e-5, rtol=1e-5)
    moved = np.abs(_np(xx) - x)
    assert moved[~mask_ligand].max() == 0.0
    assert (moved.max() == 0.0) == fix_x


def test_x_mlp_init_is_small_and_bias_free():
    layer = egnn.EnBaseLayer(128, 4)
    w = layer.x_mlp[2].weight
    assert layer.x_mlp[2].bias is None and isinstance(layer.x_mlp[3], torch.nn.Tanh)
    assert float(w.detach().abs().max()) <= 1e-3 * np.sqrt(6.0 / 129)


@pytest.mark.parametrize("cutoff_mode", ["knn", "hybrid"])
@pytest.mark.parametrize("fix_x", [False, True])
def test_egnn_matches_jax(cutoff_mode, fix_x):
    """Three layers, each on a graph rebuilt from its input coordinates."""
    h, x, node_mask, mask_ligand, nl = _graph_inputs(cutoff_mode, seed=8)
    jnet = jegnn.EGNN(num_layers=3, hidden_dim=16, edge_feat_dim=4, num_r_gaussian=1, k=5,
                      cutoff_mode=cutoff_mode, max_ligand=nl)
    args = (jnp.asarray(h), jnp.asarray(x), jnp.asarray(mask_ligand), jnp.asarray(node_mask))
    params = jnet.init(jax.random.PRNGKey(6), *args)
    want = jnet.apply(params, *args, fix_x=fix_x)
    net = egnn.EGNN(num_layers=3, hidden_dim=16, edge_feat_dim=4, k=5, cutoff_mode=cutoff_mode,
                    max_ligand=nl)
    _load(net, params)
    hh, xx = net(*(torch.from_numpy(a) for a in (h, x, mask_ligand, node_mask)), fix_x=fix_x)
    m = node_mask[..., None]
    np.testing.assert_allclose(_np(hh) * m, np.asarray(want["h"]) * m, **H_TOL)
    np.testing.assert_allclose(_np(xx) * m, np.asarray(want["x"]) * m, **POS_TOL)


def test_egnn_refuses_other_cutoffs_and_edge_widths():
    with pytest.raises(ValueError, match="cutoff"):
        egnn.EGNN(2, 16, 4, cutoff_mode="radius")
    with pytest.raises(ValueError, match="edge types"):
        egnn.EGNN(2, 16, 8)


# ---- ScorePosNet and DiffusionModel ------------------------------------------------

@pytest.mark.parametrize("cutoff_mode", ["knn", "hybrid"])
def test_score_posnet_matches_jax(cutoff_mode):
    _, jmodel, params, jbatch, model, batch = egnn_setup(cutoff_mode=cutoff_mode)
    ref = jmodel.apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, jnp.array([3, 7]))
    with torch.no_grad():
        out = model.apply(batch, batch.ligand_pos, batch.ligand_v)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    np.testing.assert_allclose(_np(out["pred_ligand_pos"]) * lmask,
                               np.asarray(ref["pred_ligand_pos"]) * lmask, **POS_TOL)
    np.testing.assert_allclose(_np(out["pred_ligand_v"]) * lmask,
                               np.asarray(ref["pred_ligand_v"]) * lmask, **LOGIT_TOL)
    assert isinstance(model.net.refine_net, egnn.EGNN)
    assert len(model.net.refine_net.net) == 2


def test_eager_loss_matches_jax():
    """get_diffusion_loss(impl='eager') with JAX's draws within 1e-4 of the
    JAX loss (its gradients: test_adam_step_matches_jax_trainer)."""
    _, jmodel, params, jbatch, model, batch = egnn_setup()
    key, t = jax.random.PRNGKey(5), np.array([2, 7])
    want = jmodel.get_diffusion_loss(params, key, jbatch, time_step=jnp.asarray(t))
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    with torch.no_grad():
        out = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                       v_uniform=u, impl="eager")
    for k in ("loss", "loss_pos", "loss_v"):
        assert abs(float(out[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k


@pytest.mark.parametrize("mode,dim", [("simple", 4), ("sin", 8)])
def test_time_embedding_matches_jax(mode, dim):
    """The EGNN denoiser with a time embedding (the JAX ScorePosNet's, for any
    refine net): the forward at [3, 7] and the eager loss with JAX's draws."""
    _, jmodel, params, jbatch, model, batch = egnn_setup(time_emb_dim=dim, time_emb_mode=mode)
    assert model.impl == "eager"
    ref = jmodel.apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, jnp.array([3, 7]))
    with torch.no_grad():
        out = model.apply(batch, batch.ligand_pos, batch.ligand_v, time_step=torch.tensor([3, 7]))
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    np.testing.assert_allclose(_np(out["pred_ligand_pos"]) * lmask,
                               np.asarray(ref["pred_ligand_pos"]) * lmask, **POS_TOL)
    np.testing.assert_allclose(_np(out["pred_ligand_v"]) * lmask,
                               np.asarray(ref["pred_ligand_v"]) * lmask, **LOGIT_TOL)
    key, t = jax.random.PRNGKey(5), np.array([2, 7])
    want = jmodel.get_diffusion_loss(params, key, jbatch, time_step=jnp.asarray(t))
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    with torch.no_grad():
        got = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                       v_uniform=u)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4 * abs(float(want["loss"]))


def test_bf16_model_matches_jax_bf16():
    """`model_dtype=torch.bfloat16` against JAX's `dtype=jnp.bfloat16` EGNN on
    its XLA path, at tests/test_torch_uni_o2_variants.py's bf16 bars:
    outputs within 2e-2 of scale, the loss within 1e-2 relative, the
    gradients' median tensor within 5e-2 of its scale (0.7e-2 measured)."""
    from tests.test_torch_uni_o2_variants import (BF16_BAR, BF16_GRAD_MEDIAN, BF16_LOSS_REL,
                                                  _bf16_margins, _forward, _loss_and_grads,
                                                  setup)

    jmodel, params, jbatch, model, batch = setup(dict(model_type="egnn"), jnp.bfloat16,
                                                 torch.bfloat16)
    assert model.impl == "eager" and model.net.refine_net.net[0].model_dtype == torch.bfloat16
    out, ref = _forward(jmodel, params, jbatch, model, batch)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    for k, m in (("pred_ligand_pos", lmask), ("pred_ligand_v", lmask), ("final_h", 1.0)):
        a, b = _np(out[k]) * m, np.asarray(ref[k]).astype(np.float32) * m
        assert np.abs(a - b).max() <= BF16_BAR * np.abs(b).max(), k
    la, want, lout, got = _loss_and_grads(jmodel, params, jbatch, model, batch)
    assert abs(float(lout["loss"].detach()) - la) <= BF16_LOSS_REL * abs(la)
    margins = _bf16_margins(got, want)
    print(f"egnn bf16 gradient median {np.median(margins):.2e}, max {margins[-1]:.2e}")
    assert np.median(margins) <= BF16_GRAD_MEDIAN


@pytest.mark.parametrize("sampler,t,s,eta", [("ddpm", 6, 5, 0.0), ("ddim", 9, 4, 0.5)])
def test_one_step_matches_jax(sampler, t, s, eta):
    _, jmodel, params, jbatch, model, batch = egnn_setup()
    jcb, cbatch, lpos, lmask_f = _centered(jbatch, batch)
    C = jmodel.num_classes
    _, noise, uniform = _noise(jax.random.PRNGKey(NOISE_SEED), lpos.shape, C)
    ts = ({"t": jnp.int32(t), "s": jnp.int32(s)} if sampler == "ddpm"
          else _ts_pair(jmodel, t, s, eta))
    (jpos, jv, _), ys = jmodel._sample_step(
        params, jcb, lmask_f, jnp.zeros((2, 1, 3)),
        (lpos, jbatch.ligand_v, jax.random.PRNGKey(NOISE_SEED)), ts, impl="xla",
        dtype=jnp.float32, pos_only=False, return_traj=False, return_v_probs=True,
        sampler=sampler, eta=eta)
    assert _gumbel_margin(uniform, ys["vt"]) > MARGIN
    coefs = None
    if sampler == "ddim":
        coefs = [float(c[0]) for c in D.ddim_pos_coefficients(model.pos_sched.betas.numpy(),
                                                              [t], [s], eta)]
    pos, v, v0, vt = model.sample_step(
        cbatch, torch.tensor(np.asarray(lpos)), batch.ligand_v, t, torch.tensor(noise),
        torch.tensor(uniform), s=s, sampler=sampler, coefs=coefs, return_v_probs=True,
        impl="eager")
    np.testing.assert_allclose(_np(pos), np.asarray(jpos), atol=POS_ATOL)
    np.testing.assert_array_equal(_np(v), np.asarray(jv))
    np.testing.assert_allclose(_np(v0), np.asarray(ys["v0"]), **LOGIT_TOL)


@pytest.mark.parametrize("sampler,pos_only", [("ddpm", False), ("dpm2", False), ("ddim", True)])
def test_eager_sample_diffusion_runs_and_kernels_refuse(sampler, pos_only):
    """A short eager run packs no block weights (an EGNN has none) and
    returns finite positions and types in the vocabulary (pos_only: the
    given types), with its trajectory; impl='fast' refuses the config with
    its reason on every kernel path."""
    _, _, _, _, model, batch = egnn_setup()
    gen = torch.Generator().manual_seed(3)
    res = model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, gen, num_steps=4,
                                 sampler=sampler, pos_only=pos_only, return_traj=True,
                                 impl="eager")
    assert res.pos.shape == batch.ligand_pos.shape and torch.isfinite(res.pos).all()
    assert bool(((res.v >= 0) & (res.v < NUM_CLASSES)).all())
    assert res.pos_traj.shape[0] == 4 and res.v_traj.shape[0] == 4
    assert torch.equal(res.v, batch.ligand_v) == pos_only
    with pytest.raises(ValueError, match="model_type='egnn'"):
        model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, gen, num_steps=2,
                               impl="fast")
    with pytest.raises(ValueError, match="model_type='egnn'"):
        model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)
    with pytest.raises(ValueError, match="model_type='egnn'"):
        model.get_diffusion_loss(batch, generator=gen, impl="fast")
    with pytest.raises(ValueError, match="model_type='egnn'"):
        model.fetch_embedding(batch, impl="fast")


def test_likelihood_and_embedding_match_jax():
    _, jmodel, params, jbatch, model, batch = egnn_setup()
    T_ = jmodel.num_timesteps
    t = np.array([1, T_ - 1])
    key = jax.random.PRNGKey(11)
    want = jmodel.likelihood_estimation(params, key, jbatch, jnp.asarray(t), impl="xla")
    key_pos, key_v = jax.random.split(key)
    noise = torch.tensor(np.asarray(jax.random.normal(key_pos, batch.ligand_pos.shape)))
    uniform = torch.tensor(np.asarray(jax.random.uniform(
        key_v, tuple(batch.ligand_v.shape) + (jmodel.num_classes,))))
    got = model.likelihood_estimation(batch, torch.from_numpy(t), pos_noise=noise,
                                      v_uniform=uniform, impl="eager")
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **ELBO_TOL)
    ref = jmodel.fetch_embedding(params, jbatch, impl="xla")
    out = model.fetch_embedding(batch, impl="eager")
    np.testing.assert_array_equal(_np(out["pred_ligand_pos"]), np.asarray(jbatch.ligand_pos))
    m = np.concatenate([np.asarray(jbatch.protein_mask), np.asarray(jbatch.ligand_mask)], 1)
    np.testing.assert_allclose(_np(out["final_h"]) * m[..., None],
                               np.asarray(ref["final_h"]) * m[..., None], **H_TOL)


def test_adam_step_matches_jax_trainer():
    """Same params, batch and draws: the port's eager train step reports the
    JAX XLA step's loss and pre-clip gradient norm, and moves the
    parameters where optax moves them."""
    _, jmodel, params, jbatch, model, batch = egnn_setup()
    jopt = JTU.get_optimizer(JConfig(OPT))
    T_ = jmodel.num_timesteps
    state = jtrainer.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32),
                                jnp.zeros((T_,), jnp.float32), jnp.zeros((T_,), jnp.float32))
    key = jax.random.PRNGKey(3)
    new_state, metrics = jtrainer.make_train_step(jmodel, jopt, impl="xla", remat=False)(
        state, jbatch, key)
    _, _, key_loss = jax.random.split(key, 3)
    key_t, _, _ = jax.random.split(key_loss, 3)
    t, _ = JD.sample_time_symmetric(key_t, jbatch.num_graphs, jmodel.num_timesteps)
    eps, u = jax_draws(key_loss, jbatch, jmodel.num_classes)
    tstate = T.create_train_state(model, TU.get_optimizer(Config(OPT), model.parameters()))
    step = T.make_train_step(model, pos_noise_std=0.0, impl="eager")
    tstate, tm = step(tstate, batch, None, time_step=torch.from_numpy(np.asarray(t)).long(),
                      pos_noise=eps, v_uniform=u)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(metrics[k])) <= 1e-4 * abs(float(metrics[k])), k
    want = flax_params_to_state_dict(jax.device_get(new_state.params))
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(_np(p), want[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)


# ---- the bridge and checkpoints ------------------------------------------------------

def test_bridge_round_trip_of_the_egnn_tree():
    _, _, params, _, model, _ = egnn_setup()
    sd = flax_params_to_state_dict(jax.device_get(params))
    assert "refine_net.net.1.x_mlp.2.weight" in sd and "refine_net.net.0.edge_inf.0.bias" in sd
    assert "refine_net.net.0.edge_mlp.net.2.weight" in sd  # no norm: lin_1 is net.2
    back = state_dict_to_flax_params(model.net.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.device_get(params["params"]))


def test_npz_checkpoints_load_in_both_packages(tmp_path):
    cfg, jmodel, params, jbatch, model, batch = egnn_setup()
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, cfg, jax.device_get(params))
    fresh = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=16,
                           max_ligand=8)
    fresh.net.load_state_dict(ckpt.load_checkpoint(jpath)["state_dict"])
    for a, b in zip(fresh.net.parameters(), model.net.parameters()):
        assert torch.equal(a, b)
    tpath = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(tpath, Config(cfg), model.net)
    template = jmodel.init(jax.random.PRNGKey(9), jbatch)
    loaded = jckpt.load_checkpoint(tpath, params_template=template)
    assert loaded["config"].model_type == "egnn"
    jax.tree_util.tree_map(np.testing.assert_array_equal, loaded["params"],
                           jax.device_get(params))


# ---- resolve_impl and the callers of impl ---------------------------------------------

def test_resolve_impl_reads_the_config_alone():
    """The kernels for the released config, the plain network for EGNN; the
    model reads its path once, whatever its device; the kernels refuse EGNN
    with the reason."""
    released, egnn_cfg = small_flagship(), egnn_config()
    assert resolve_impl(released) == "fast"
    assert resolve_impl(egnn_cfg) == "eager"
    for cfg, want in ((released, "fast"), (egnn_cfg, "eager")):
        model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=16,
                               max_ligand=8)
        assert model.impl == want
    require_kernels(released)
    with pytest.raises(ValueError, match="model_type='egnn'"):
        require_kernels(egnn_cfg)


def test_sampling_entry_point_takes_impl():
    """The sampling entry points run an EGNN model on the path its config
    gives it (eager); impl='fast' asked of the model itself raises."""
    from targetdiff_tpu_torch.sampling import init_ligand_state, sample_diffusion_ligand
    from targetdiff_tpu_torch.sampling import sample_testset

    _, _, _, jbatch, model, batch = egnn_setup()
    pocket = {"protein_pos": np.asarray(jbatch.protein_pos)[0, :14],
              "protein_feat": np.asarray(jbatch.protein_feat)[0, :14]}
    res = sample_diffusion_ligand(model, pocket, num_samples=2,
                                  generator=torch.Generator().manual_seed(1), batch_size=2,
                                  num_steps=3, max_protein=16, max_ligand=8)
    assert len(res["pos"]) == 2 and all(np.isfinite(p).all() for p in res["pos"])
    out = sample_testset(model, [pocket], 2, torch.Generator().manual_seed(1), num_steps=3,
                         max_protein=16, max_ligand=8)
    assert len(out[0]["pos"]) == 2
    pos, v = init_ligand_state(batch, NUM_CLASSES, torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="model_type='egnn'"):
        model.sample_diffusion(batch, pos, v, torch.Generator(), num_steps=2, impl="fast")


def test_train_cli_trains_an_egnn_eagerly(tmp_path):
    """The train CLI on an EGNN config takes the eager path (the model's,
    from its config), validates, and writes a checkpoint that both packages
    read; the kernels' training step refuses the config."""
    import yaml

    from targetdiff_tpu_torch.cli import train_diffusion
    from tests.test_torch_data import _data_cfg, _mini_raw

    raw, split = _mini_raw(tmp_path)
    model_cfg = dict(egnn_config(num_diffusion_timesteps=12, hidden_dim=16, knn=6))
    cfg = {"data": _data_cfg(raw, split), "model": model_cfg,
           "train": {"seed": 1, "batch_size": 2, "max_iters": 2, "val_freq": 2,
                     "pos_noise_std": 0.1, "max_grad_norm": 8.0,
                     "optimizer": {"type": "adam", "lr": 1.0e-3, "weight_decay": 0,
                                   "beta1": 0.95, "beta2": 0.999},
                     "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10,
                                   "min_lr": 1.0e-6}}}
    cfg_path = str(tmp_path / "egnn.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = train_diffusion.main([cfg_path, "--logdir", str(tmp_path / "logs"), "--device", "cpu",
                                "--max_protein", "640", "--max_ligand", "40",
                                "--train_report_iter", "1"])
    assert out["checkpoints"] and np.isfinite(list(out["metrics"].values())).all()
    sd = ckpt.load_checkpoint(out["checkpoints"][-1])["state_dict"]
    assert any(k.startswith("refine_net.net.0.x_mlp") for k in sd)
    model = DiffusionModel(Config(model_cfg), PROTEIN_DIM, NUM_CLASSES, device="cpu",
                           max_protein=16, max_ligand=8)
    assert model.impl == "eager"
    _, _, _, _, _, batch = egnn_setup()
    state = T.create_train_state(model, TU.get_optimizer(Config(OPT), model.parameters()))
    with pytest.raises(ValueError, match="model_type='egnn'"):
        T.make_train_step(model, impl="fast")(state, batch, torch.Generator().manual_seed(0))
