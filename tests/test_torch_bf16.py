"""The port's bf16 sampling path, the JAX package's default precision for
sampling, on the CPU (the plain versions of the bf16 kernels), against the
JAX package's bf16 Pallas kernels in interpret mode (`fast_apply(dtype=
jnp.bfloat16, interpret=True)`, `_sample_step(impl='fast', dtype=bf16)`) on
the same inputs and bridged weights.

The bar is the JAX package's own bf16 bar (tools/kparity.py:91): a masked
ligand output within 2e-2 of its largest |value|. The two frameworks round
to bf16 at other places (JAX also stores h, k and v in bf16 and splits x
into bf16 pairs; the port keeps them float32), so a bf16-grade bar is what
holds them together; each side is also held to JAX's float32 XLA forward at
the same bar. That bar alone would pass a float32 forward, so the rounding
is shown apart: the bf16 output differs from the float32 one, and every
dense product of the attention layers (and, on the whole-block route, of
the edge-weight MLP) ran with bf16 operands. Then the defaults: bf16 for
sampling, float32 for the lower-level functions, likelihood, embedding and
training."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu_torch import sampling
from targetdiff_tpu_torch.models import fast_forward as FF
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops import diffusion as D
from targetdiff_tpu_torch.ops import precision
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import edge_layer as kel
from tests.test_torch_ddim import _centered, _noise, _ts_pair
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

BAR = 2e-2  # the JAX package's bf16 bar: max |a - b| / max |b| (tools/kparity.py:91)
NOISE_SEED = 3
OUTPUTS = ("pred_ligand_pos", "pred_ligand_v")


def rel(a, b, mask) -> float:
    """max |a - b| / max |b| over the masked ligand rows."""
    a, b = np.asarray(a)[mask], np.asarray(b)[mask]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _forwards(mode):
    _, jmodel, params, jbatch, model, batch = small_setup()
    t = jnp.array([3, 7])
    ref_xla = jmodel.apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, t)
    ref_bf16 = jmodel.fast_apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, t,
                                 dtype=jnp.bfloat16, interpret=True, mode=mode)
    with torch.no_grad():
        out = {d: model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode=mode, dtype=d)
               for d in (torch.bfloat16, torch.float32)}
    return np.asarray(jbatch.ligand_mask), ref_xla, ref_bf16, out


@pytest.mark.parametrize("mode", ["mega", "layers"])
def test_bf16_forward_matches_jax_bf16_kernels(mode):
    """The port's bf16 fast_forward against JAX's bf16 kernels (interpret
    mode), and each against JAX's float32 XLA forward, at the bf16 bar."""
    lm, ref_xla, ref_bf16, out = _forwards(mode)
    port = {k: out[torch.bfloat16][k].numpy() for k in OUTPUTS}
    margins = {}
    for key in OUTPUTS:
        margins[key] = dict(port_vs_jax_bf16=rel(port[key], ref_bf16[key], lm),
                            port_vs_xla_f32=rel(port[key], ref_xla[key], lm),
                            jax_bf16_vs_xla_f32=rel(ref_bf16[key], ref_xla[key], lm))
    print(f"bf16 margins ({mode}, over max |.|): {margins}")
    for key, m in margins.items():
        for name, value in m.items():
            assert value < BAR, f"{key} {name}: {value} of scale (bar {BAR})"
        assert np.isfinite(port[key]).all()


@pytest.mark.parametrize("mode", ["mega", "layers"])
def test_bf16_rounds_every_product(mode, monkeypatch):
    """dtype reaches every dense product: the bf16 forward differs from the
    float32 one by more than float32 noise, and each Linear of the attention
    MLPs (k, v, q of both passes, every layer) and, on the whole-block
    route, the edge-weight MLP's ran with bf16 operands; the float32 forward
    rounds nothing."""
    _, _, _, _, model, batch = small_setup()
    seen = []
    linear = precision.linear

    def recording(x, layer, dtype=torch.float32):
        seen.append((id(layer), dtype))
        return linear(x, layer, dtype)

    monkeypatch.setattr(precision, "linear", recording)
    with torch.no_grad():
        bf = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode=mode,
                              dtype=torch.bfloat16)
        n_bf16 = len(seen)
        f32 = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode=mode,
                               dtype=torch.float32)
    assert len(seen) == n_bf16, "the float32 forward rounded a product"
    rn = model.net.refine_net
    attention = {id(m) for layer in rn.base_block
                 for sub in (layer.x2h_layers[0], layer.h2x_layers[0])
                 for m in sub.modules() if isinstance(m, torch.nn.Linear)}
    ew = {id(m) for m in rn.edge_pred_layer.modules() if isinstance(m, torch.nn.Linear)}
    ran = {i for i, d in seen if d == torch.bfloat16}
    assert len(attention) == 2 * 3 * 2 * len(rn.base_block)
    assert attention <= ran
    assert (ew <= ran) == (mode == "mega") and not ew & ran - ew
    assert ran <= attention | ew
    lm = batch.ligand_mask
    for key in OUTPUTS:
        diff = float((bf[key] - f32[key])[lm].abs().max())
        scale = float(f32[key][lm].abs().max())
        print(f"{mode} {key}: bf16 - float32 = {diff / scale:.3e} of scale")
        assert diff > 1e-4 * scale


@pytest.mark.parametrize("sampler,t,s", [("ddpm", 7, 6), ("ddim", 9, 4)])
def test_bf16_sample_step_matches_jax(sampler, t, s):
    """One reverse step on the bf16 kernels against JAX _sample_step(impl=
    'fast', dtype=bf16) on its interpret-mode kernels, fed the same noise
    and uniforms (ddim at eta 0): positions and recon log-probabilities at
    the bf16 bar, types equal wherever the Gumbel-perturbed winner leads the
    runner-up by more than the bar."""
    _, jmodel, params, jbatch, model, batch = small_setup()
    jcb, cbatch, lpos, lmask_f = _centered(jbatch, batch)
    _, noise, uniform = _noise(jax.random.PRNGKey(NOISE_SEED), lpos.shape, jmodel.num_classes)
    ts = {"t": t, "s": s} if sampler == "ddpm" else _ts_pair(jmodel, t, s, 0.0)
    (jpos, jv, _), ys = jmodel._sample_step(
        params, jcb, lmask_f, jnp.zeros((2, 1, 3)),
        (lpos, jbatch.ligand_v, jax.random.PRNGKey(NOISE_SEED)), ts, impl="fast",
        dtype=jnp.bfloat16, pos_only=False, return_traj=False, return_v_probs=True,
        sampler=sampler, eta=0.0)
    coefs = None
    if sampler == "ddim":
        coefs = [float(c[0]) for c in D.ddim_pos_coefficients(
            model.pos_sched.betas.numpy(), [t], [s], 0.0)]
    pos, v, v0, vt = model.sample_step(
        cbatch, torch.tensor(np.asarray(lpos)), batch.ligand_v, t, torch.tensor(noise),
        torch.tensor(uniform), s=s, sampler=sampler, coefs=coefs, return_v_probs=True)
    lm = np.asarray(jbatch.ligand_mask)
    pos_m, v0_m = rel(pos.numpy(), jpos, lm), rel(v0.numpy(), ys["v0"], lm)
    gumbel = -np.log(-np.log(uniform + 1e-30) + 1e-30) + np.asarray(ys["vt"])
    top2 = np.sort(gumbel, -1)[..., -2:]
    clear = lm & (top2[..., 1] - top2[..., 0] > BAR)
    print(f"{sampler} {t}->{s}: positions {pos_m:.3e}, recon log-probs {v0_m:.3e} of scale; "
          f"types compared on {int(clear.sum())} of {int(lm.sum())} atoms")
    assert pos_m < BAR and v0_m < BAR
    assert clear.sum() >= lm.sum() // 2
    np.testing.assert_array_equal(v.numpy()[clear], np.asarray(jv)[clear])
    assert np.isfinite(vt.numpy()[lm]).all()


def _default(fn, name="dtype"):
    return inspect.signature(fn).parameters[name].default


def test_defaults():
    """bf16 for sampling (as the JAX package); float32 for the lower-level
    functions and the kernel wrappers, so their callers keep their meaning."""
    for fn in (DiffusionModel.sample_diffusion, DiffusionModel.sample_step,
               DiffusionModel.fast_apply, sampling.sample_diffusion_ligand,
               sampling.sample_testset):
        assert _default(fn) == torch.bfloat16, fn.__qualname__
    for fn in (FF.fast_forward, kblock.block_denoiser, kblock.block_denoiser_cuda,
               kblock.pack_block_params, kel.x2h_attention_layer, kel.h2x_attention_layer,
               kel.x2h_layer_cuda, kel.h2x_layer_cuda, kel.pack_layer_params):
        assert _default(fn) == torch.float32, fn.__qualname__


def test_likelihood_embedding_and_training_stay_float32(monkeypatch):
    """Whatever the sampler's default: likelihood_estimation and
    fetch_embedding run the kernels at float32 and training rounds nothing,
    while the default sample_step runs bf16."""
    _, _, _, _, model, batch = small_setup()
    dtypes = []
    forward = FF.fast_forward

    def recording(*a, **kw):
        dtypes.append(kw.get("dtype", torch.float32))
        return forward(*a, **kw)

    rounded = []
    linear = precision.linear

    def counting(x, layer, dtype=torch.float32):
        if dtype != torch.float32:
            rounded.append(dtype)
        return linear(x, layer, dtype)

    from targetdiff_tpu_torch.models import score_model as SM

    monkeypatch.setattr(SM, "fast_forward", recording)
    monkeypatch.setattr(precision, "linear", counting)
    gen = torch.Generator().manual_seed(0)
    model.likelihood_estimation(batch, torch.tensor([3, 5]), generator=gen, impl="fast")
    model.fetch_embedding(batch, impl="fast")
    for impl in ("fast", "fast_pl", "eager"):
        model.get_diffusion_loss(batch, generator=gen, impl=impl)["loss"].backward()
    assert dtypes == [torch.float32, torch.float32] and not rounded
    cb = batch._replace(protein_pos=D.center_pos_protein(
        batch.protein_pos, batch.ligand_pos, batch.protein_mask)[0])
    model.sample_step(cb, batch.ligand_pos, batch.ligand_v, 5,
                      torch.zeros_like(batch.ligand_pos),
                      torch.rand(batch.ligand_v.shape + (model.num_classes,), generator=gen))
    assert dtypes[-1] == torch.bfloat16 and rounded


def test_eager_ignores_dtype():
    """impl='eager' (the EGNN denoiser's path) runs float32 whatever dtype
    says, as the JAX package's XLA path."""
    _, _, _, _, model, batch = small_setup()
    gen = torch.Generator().manual_seed(1)
    noise = torch.randn(batch.ligand_pos.shape, generator=gen)
    uniform = torch.rand(batch.ligand_v.shape + (model.num_classes,), generator=gen)
    outs = [model.sample_step(batch, batch.ligand_pos, batch.ligand_v, 5, noise, uniform,
                              impl="eager", return_v_probs=True, dtype=d)
            for d in (torch.bfloat16, torch.float32)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


BAD_DTYPES = [torch.float16, torch.float64, "bf16", jnp.bfloat16]


@pytest.mark.parametrize("dtype", BAD_DTYPES, ids=str)
def test_other_dtypes_raise(dtype):
    _, _, _, _, model, batch = small_setup()
    rn = model.net.refine_net
    layer = rn.base_block[0]
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda: model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, gen,
                                       num_steps=1, dtype=dtype),
        lambda: model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, gen,
                                       num_steps=1, impl="eager", dtype=dtype),
        lambda: model.sample_step(batch, batch.ligand_pos, batch.ligand_v, 3,
                                  torch.zeros_like(batch.ligand_pos), None, pos_only=True,
                                  dtype=dtype),
        lambda: model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=dtype),
        lambda: kblock.pack_block_params(rn, dtype),
        lambda: kel.pack_layer_params(layer, dtype),
    ]
    h, x, node_mask, mlig = model.net.embed(batch.protein_pos, batch.protein_feat,
                                            batch.protein_mask, batch.ligand_pos,
                                            batch.ligand_v, batch.ligand_mask)
    nbh = rn.graph(x, node_mask, mlig)
    e_w = rn.edge_weights(x, nbh)[..., 0]
    calls += [
        lambda: kblock.block_denoiser(rn, h, x, nbh, mlig, 8, dtype=dtype),
        lambda: kel.x2h_attention_layer(layer, h, x, nbh, mlig, e_w, dtype=dtype),
        lambda: kel.h2x_attention_layer(layer, h, x, nbh, mlig, e_w, 8, dtype=dtype),
    ]
    for call in calls:
        with torch.no_grad(), pytest.raises(ValueError, match="dtype"):
            call()


def test_a_pack_serves_only_its_dtype():
    """Weights packed for one precision's kernels are refused by the other's."""
    _, _, _, _, model, batch = small_setup()
    rn = model.net.refine_net
    with torch.no_grad():
        f32, bf16 = (kblock.pack_block_params(rn, d) for d in (torch.float32, torch.bfloat16))
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    for name, t in bf16.x2h.items():
        want = torch.bfloat16 if name in kblock.WEIGHT_FIELDS else torch.float32
        assert t.dtype == want, name
        assert torch.equal(t.float(), f32.x2h[name].to(want).float())
    assert [t.dtype for t in bf16.ew] == [torch.bfloat16, torch.float32, torch.float32,
                                          torch.bfloat16, torch.float32]
    for packed, dtype in ((f32, torch.bfloat16), (bf16, torch.float32)):
        with pytest.raises(ValueError, match="packed"):
            model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, packed=packed, dtype=dtype)


def test_bf16_node_projections_plain_is_the_eager_rounding():
    """The bf16 node kernel's plain version (bf16 stacks) rounds where the
    eager bf16 layers do: ni|nj are the first layer's h_i|h_j products of
    the k and v MLPs, q the query MLP."""
    _, _, _, _, model, batch = small_setup()
    rn = model.net.refine_net
    h = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(2)) * 3
    with torch.no_grad():
        x2h, _ = kblock.pack_pass_params(rn, torch.bfloat16)
        ni, nj, q, _ = kblock.node_projections_plain(h, x2h, 1)
        att = rn.base_block[1].x2h_layers[0]
        H = h.shape[-1]
        w1k, w1v = att.hk_func.net[0].weight, att.hv_func.net[0].weight
        hb = precision.round_bf16(h)
        lo = w1k.shape[1] - 2 * H
        for got, w, bias in ((ni[..., :H], w1k[:, lo:lo + H], att.hk_func.net[0].bias),
                             (ni[..., H:], w1v[:, lo:lo + H], att.hv_func.net[0].bias),
                             (nj[..., :H], w1k[:, lo + H:], None),
                             (nj[..., H:], w1v[:, lo + H:], None)):
            want = hb @ precision.round_bf16(w).t() + (0 if bias is None else bias)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(q, att.hq_func(h, torch.bfloat16), atol=1e-5, rtol=1e-5)
        assert not torch.allclose(q, att.hq_func(h), atol=1e-5, rtol=1e-5)


def test_bf16_edge_weight_kernel_arithmetic():
    """The bf16 edge-weight kernel's algorithm replayed (csrc/block_denoiser.cu
    ew_kernel<true>: bf16 RBF rows padded to 32 knots against bf16 w1, the
    bias added in float32, LayerNorm + ReLU, the outputs rounded to bf16
    before the float32 dot with bf16 w2) equals its plain version, the
    module's edge_weights at bf16, and differs from the float32 weights."""
    _, _, _, _, model, batch = small_setup()
    rn = model.net.refine_net
    h, x, node_mask, mlig = model.net.embed(batch.protein_pos, batch.protein_feat,
                                            batch.protein_mask, batch.ligand_pos,
                                            batch.ligand_v, batch.ligand_mask)
    nbh = rn.graph(x, node_mask, mlig)
    with torch.no_grad():
        packed = kblock.pack_block_params(rn, torch.bfloat16)
        w1, b1, ln, w2, b2 = packed.ew
        from targetdiff_tpu_torch.ops import graph as G
        from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets

        offsets, coeff = gaussian_smearing_offsets()
        rbf = precision.round_bf16(gaussian_smearing(G.rel_geometry(x, nbh)[1], offsets, coeff))
        rows = torch.cat([rbf, rbf.new_zeros(rbf.shape[:-1] + (32 - rbf.shape[-1],))], -1)
        w1p = torch.cat([w1.float(), w1.new_zeros(32 - w1.shape[0], w1.shape[1]).float()])
        z = b1 + rows.double().matmul(w1p.double()).float()
        z = torch.relu(torch.nn.functional.layer_norm(z, z.shape[-1:], ln[0], ln[1], 1e-5))
        replay = torch.sigmoid(precision.round_bf16(z) @ w2.float() + b2)
        plain = rn.edge_weights(x, nbh, torch.bfloat16)[..., 0]
        f32 = rn.edge_weights(x, nbh)[..., 0]
    torch.testing.assert_close(replay, plain, atol=1e-6, rtol=0)
    assert float((plain - f32).abs().max()) > 1e-5
