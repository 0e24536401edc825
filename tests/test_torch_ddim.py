"""The port's strided samplers (ddim, dpm2), trajectories and position-only
sampling against the JAX package on the CPU: the strided type posterior
(1e-6), the float64 position coefficients (bitwise), the jump grid, single
jumps of `sample_step` against JAX `_sample_step` (XLA, float32) and short
whole runs against JAX `sample_diffusion`, both fed JAX's own noise
(replayed from its key splits, as tests/test_torch_sampling.py does):
positions within 1e-3, types exactly, every Gumbel margin (and dpm2's
argmax margin) asserted above 1e-3 so that equal types are well defined.
Cases follow the JAX suite's tests/test_ddim.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.ops import diffusion as JD
from targetdiff_tpu.ops import schedules as JS
from targetdiff_tpu_torch.models.score_model import sampling_schedule
from targetdiff_tpu_torch.ops import diffusion as D
from targetdiff_tpu_torch.ops import schedules as S
from tests.test_torch_score_model import LOGIT_TOL, small_setup

torch.set_num_threads(2)

T = 1000  # the flagship schedule
MARGIN = 1e-3
NOISE_SEED = 0
POS_ATOL = 1e-3


def _schedules(num_timesteps=T):
    kw = dict(beta_schedule="sigmoid", num_diffusion_timesteps=num_timesteps,
              beta_start=1e-7, beta_end=2e-3)
    vkw = dict(v_beta_schedule="cosine", num_diffusion_timesteps=num_timesteps, v_beta_s=0.01)
    return (JS.make_gaussian_schedule(**kw), JS.make_categorical_schedule(**vkw),
            S.make_gaussian_schedule(**kw), S.make_categorical_schedule(**vkw))


# s = t-1 (the single step), s = -1 (the final jump), long and short jumps
TS_PAIRS = [(1, 0), (500, 499), (999, 998), (5, -1), (999, -1), (999, 899), (120, 3), (40, 0)]


@pytest.mark.parametrize("t,s", TS_PAIRS)
def test_strided_type_posterior_matches_jax(t, s):
    _, jv, _, pv = _schedules()
    C, B = 13, 3
    rng = np.random.default_rng(t)
    log_v0 = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(B, 6, C)).astype(np.float32)))
    vt = rng.integers(0, C, (B, 6))
    jt, js = jnp.full((B,), t, jnp.int32), jnp.full((B,), s, jnp.int32)
    pt, ps = torch.full((B,), t), torch.full((B,), s)
    log_vt = D.index_to_log_onehot(torch.from_numpy(vt), C)
    jlog_vt = JD.index_to_log_onehot(jnp.asarray(vt), C)
    tol = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(D.q_v_pred_strided(pv, log_vt, pt, ps, C).numpy(),
                               np.asarray(JD.q_v_pred_strided(jv, jlog_vt, jt, js, C)), **tol)
    post = D.q_v_posterior_strided(pv, torch.tensor(np.asarray(log_v0)), log_vt, pt, ps, C)
    np.testing.assert_allclose(
        post.numpy(), np.asarray(JD.q_v_posterior_strided(jv, log_v0, jlog_vt, jt, js, C)),
        **tol)
    if s == t - 1:  # the single step's posterior (the JAX suite's bar)
        one = D.q_v_posterior(pv, torch.tensor(np.asarray(log_v0)), log_vt, pt, C)
        np.testing.assert_allclose(post.numpy(), one.numpy(), atol=5e-5)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("grid", ["uniform-100", "quadratic-100", "uniform-50", "quadratic-50",
                                  "ddpm-1000"])
def test_ddim_coefficients_are_bitwise_jax(grid, eta):
    """From each package's float32 betas: the same float32 tables, bit for
    bit, on the jump grids the samplers run (and on the single-step grid)."""
    jg, _, pg, _ = _schedules()
    spacing, n = grid.split("-")
    sampler = "ddpm" if spacing == "ddpm" else "ddim"
    time_seq, s_seq = sampling_schedule(T, int(n), sampler, "uniform" if sampler == "ddpm"
                                        else spacing)
    got = D.ddim_pos_coefficients(pg.betas.numpy(), time_seq, s_seq, eta)
    want = JD.ddim_pos_coefficients(np.asarray(jg.betas), time_seq, s_seq, eta)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.uint32), np.asarray(w).view(np.uint32))
    if sampler == "ddpm" and eta == 1.0:  # the DDPM posterior (JAX suite's identity)
        for g, ref in zip(got, (pg.posterior_mean_c0_coef, pg.posterior_mean_ct_coef,
                                torch.exp(0.5 * pg.posterior_logvar))):
            keep = s_seq >= 0
            np.testing.assert_allclose(g[keep], ref.numpy()[time_seq[keep]], rtol=1e-4)
    final = s_seq < 0
    assert (got[0][final] == 1.0).all() and (got[1][final] == 0).all()
    assert (got[2][final] == 0).all()


def _jax_grid(num_timesteps, num_steps, sampler, spacing):
    """The (t, s) pairs and coefficients JAX's sample_diffusion scans over,
    read back through a step that records them in its trajectory slots."""
    from targetdiff_tpu.models.score_model import DiffusionModel as JaxDiffusionModel
    from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, batch_mult8, small_flagship

    cfg = small_flagship()
    cfg.update(num_diffusion_timesteps=num_timesteps)
    jmodel = JaxDiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, max_protein=16, max_ligand=8)

    def record(params, cbatch, lmask_f, offset, carry, ts_pair, **kw):
        ys = {"pos": ts_pair["t"], "v": ts_pair["s"]}
        if "cx0" in ts_pair:
            ys.update(v0=jnp.stack([ts_pair["cx0"], ts_pair["cxt"], ts_pair["sig"]]))
        return carry, ys

    jmodel._sample_step = record
    b = batch_mult8()
    res = jmodel.sample_diffusion(None, jax.random.PRNGKey(0), b, b.ligand_pos, b.ligand_v,
                                  num_steps=num_steps, sampler=sampler, eta=0.5,
                                  ddim_spacing=spacing, scan_chunk=None)
    coefs = None if res.v0_traj is None else np.asarray(res.v0_traj)
    return np.asarray(res.pos_traj), np.asarray(res.v_traj), coefs


@pytest.mark.parametrize("sampler,num_steps,spacing", [
    ("ddpm", 1000, "uniform"), ("ddpm", 100, "uniform"), ("ddim", 100, "uniform"),
    ("ddim", 50, "quadratic"), ("ddim", 7, "uniform"), ("dpm2", 25, "uniform"),
    ("dpm2", 100, "quadratic")])
def test_sampling_schedule_is_the_jax_scan(sampler, num_steps, spacing):
    t_j, s_j, coefs_j = _jax_grid(T, num_steps, sampler, spacing)
    time_seq, s_seq = sampling_schedule(T, num_steps, sampler, spacing)
    np.testing.assert_array_equal(time_seq, t_j)
    np.testing.assert_array_equal(s_seq, s_j)
    if sampler != "ddpm":
        _, _, pg, _ = _schedules()
        got = np.stack(D.ddim_pos_coefficients(pg.betas.numpy(), time_seq, s_seq, 0.5), 1)
        np.testing.assert_array_equal(got.view(np.uint32), coefs_j.view(np.uint32))


def test_unknown_sampler_or_spacing_raises():
    for args in [("euler", "uniform"), ("ddim", "cubic")]:
        with pytest.raises(ValueError):
            sampling_schedule(T, 10, *args)
    _, _, _, _, model, batch = small_setup()
    with pytest.raises(ValueError, match="sampler"):
        model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, torch.Generator(),
                               num_steps=2, sampler="euler")


# ---- single jumps against JAX _sample_step ----------------------------------


def _centered(jbatch, batch):
    ppos, lpos, _ = JD.center_pos_protein(jbatch.protein_pos, jbatch.ligand_pos,
                                          jbatch.protein_mask, "protein")
    lmask_f = jbatch.ligand_mask.astype(jnp.float32)[..., None]
    return (jbatch._replace(protein_pos=ppos), batch._replace(protein_pos=torch.tensor(
        np.asarray(ppos))), lpos * lmask_f, lmask_f)


def _noise(key, pos_shape, num_classes):
    k, k_pos, k_v = jax.random.split(key, 3)
    return (k, np.asarray(jax.random.normal(k_pos, pos_shape, jnp.float32)),
            np.asarray(jax.random.uniform(k_v, pos_shape[:2] + (num_classes,))))


def _margin(scores) -> float:
    """Smallest top-1 minus top-2 gap over the last axis."""
    top2 = np.sort(np.asarray(scores), -1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _gumbel_margin(uniform, log_prob) -> float:
    return _margin(-np.log(-np.log(uniform + 1e-30) + 1e-30) + np.asarray(log_prob))


def _dpm2_mid_margin(jmodel, params, jcb, pos, v, t, s) -> float:
    """The margin of dpm2's greedy mid-point types (JAX score_model.py:525-532)."""
    tt = jnp.full((jcb.num_graphs,), t, jnp.int32)
    logits = jmodel.apply(params, jcb, pos, v, tt)["pred_ligand_v"]
    post = JD.q_v_posterior_strided(jmodel.v_sched, jax.nn.log_softmax(logits, -1),
                                    JD.index_to_log_onehot(v, jmodel.num_classes), tt,
                                    jnp.full_like(tt, max(s, 0)), jmodel.num_classes)
    return _margin(post)


def _ts_pair(jmodel, t, s, eta):
    cx0, cxt, sig = JD.ddim_pos_coefficients(np.asarray(jmodel.pos_sched.betas),
                                             np.array([t]), np.array([s]), eta)
    return {"t": jnp.int32(t), "s": jnp.int32(s), "cx0": cx0[0], "cxt": cxt[0], "sig": sig[0]}


@pytest.mark.parametrize("sampler,t,s,eta", [
    ("ddim", 9, 5, 0.5), ("ddim", 6, 2, 0.0), ("dpm2", 9, 4, 0.0), ("dpm2", 7, 3, 1.0),
    ("ddim", 2, -1, 1.0), ("dpm2", 3, -1, 0.0)])
@pytest.mark.parametrize("pos_only", [False, True])
def test_one_jump_matches_jax(sampler, t, s, eta, pos_only):
    _, jmodel, params, jbatch, model, batch = small_setup()
    jcb, cbatch, lpos, lmask_f = _centered(jbatch, batch)
    C = jmodel.num_classes
    _, noise, uniform = _noise(jax.random.PRNGKey(NOISE_SEED), lpos.shape, C)
    if sampler == "dpm2" and s >= 0:
        assert _dpm2_mid_margin(jmodel, params, jcb, lpos, jbatch.ligand_v, t, s) > MARGIN
    (jpos, jv, _), ys = jmodel._sample_step(
        params, jcb, lmask_f, jnp.zeros((2, 1, 3)), (lpos, jbatch.ligand_v,
                                                     jax.random.PRNGKey(NOISE_SEED)),
        _ts_pair(jmodel, t, s, eta), impl="xla", dtype=jnp.float32, pos_only=pos_only,
        return_traj=False, return_v_probs=True, sampler=sampler, eta=eta)
    if not pos_only:
        assert _gumbel_margin(uniform, ys["vt"]) > MARGIN
    coefs = D.ddim_pos_coefficients(model.pos_sched.betas.numpy(), [t], [s], eta)
    pos, v, v0, vt = model.sample_step(
        cbatch, torch.tensor(np.asarray(lpos)), batch.ligand_v, t, torch.tensor(noise),
        None if pos_only else torch.tensor(uniform), s=s, sampler=sampler,
        coefs=[float(c[0]) for c in coefs], pos_only=pos_only, return_v_probs=True,
        impl="eager")
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=POS_ATOL)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(v0.numpy(), np.asarray(ys["v0"]), **LOGIT_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(ys["vt"]), **LOGIT_TOL)
    if pos_only:
        assert torch.equal(v, batch.ligand_v)


@pytest.mark.parametrize("sampler,t,s", [("ddpm", 4, 3), ("ddim", 9, 5), ("dpm2", 8, 2),
                                         ("dpm2", 3, -1)])
def test_fast_step_matches_eager(sampler, t, s):
    """impl='fast' (the kernels' plain versions here) against 'eager' on the
    same noise: positions at the kernels' bar, types equal."""
    _, _, _, _, model, batch = small_setup()
    ppos, lpos, _ = D.center_pos_protein(batch.protein_pos, batch.ligand_pos, batch.protein_mask)
    cbatch = batch._replace(protein_pos=ppos)
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn(lpos.shape, generator=gen)
    uniform = torch.rand(batch.ligand_v.shape + (model.num_classes,), generator=gen)
    coefs = (None if sampler == "ddpm" else
             D.ddim_pos_coefficients(model.pos_sched.betas.numpy(), [t], [s], 0.5))
    outs = {impl: model.sample_step(cbatch, lpos, batch.ligand_v, t, noise, uniform, s=s,
                                    sampler=sampler,
                                    coefs=None if coefs is None else [float(c[0]) for c in coefs],
                                    return_v_probs=True, impl=impl, dtype=torch.float32)
            for impl in ("fast", "eager")}
    assert _gumbel_margin(uniform.numpy(), outs["eager"][3].numpy()) > MARGIN
    np.testing.assert_allclose(outs["fast"][0].numpy(), outs["eager"][0].numpy(), atol=2e-4,
                               rtol=1e-3)
    assert torch.equal(outs["fast"][1], outs["eager"][1])
    with pytest.raises(ValueError, match="impl"):
        model.sample_step(cbatch, lpos, batch.ligand_v, t, noise, uniform, impl="xla")


# ---- whole runs against JAX sample_diffusion --------------------------------


class _JaxDraws:
    """torch.randn / torch.rand replaced by JAX's draws of each step: the
    key split of score_model.py:491, normal for the positions, uniform for
    the types (in the order the port draws them)."""

    def __init__(self, key, pos_shape, num_classes, pos_only):
        self.key, self.pos_shape, self.C, self.pos_only = key, pos_shape, num_classes, pos_only
        self.uniforms = []
        self.pending = None

    def randn(self, shape, generator=None, device=None):
        assert tuple(shape) == self.pos_shape
        self.key, noise, uniform = _noise(self.key, self.pos_shape, self.C)
        self.pending = uniform
        return torch.tensor(noise)

    def rand(self, shape, generator=None, device=None):
        assert tuple(shape) == self.pos_shape[:2] + (self.C,) and not self.pos_only
        self.uniforms.append(self.pending)
        return torch.tensor(self.pending)


@pytest.mark.parametrize("sampler,num_steps,spacing,eta,pos_only", [
    ("ddim", 5, "uniform", 0.5, False), ("dpm2", 4, "quadratic", 0.0, False),
    ("ddim", 4, "quadratic", 1.0, True), ("ddpm", 3, "uniform", 0.0, False)])
def test_short_run_matches_jax_trajectories(sampler, num_steps, spacing, eta, pos_only,
                                            monkeypatch):
    _, jmodel, params, jbatch, model, batch = small_setup()
    key = jax.random.PRNGKey(NOISE_SEED)
    init_pos = jax.random.normal(jax.random.PRNGKey(11), jbatch.ligand_pos.shape) + 0.5
    kw = dict(num_steps=num_steps, sampler=sampler, eta=eta, ddim_spacing=spacing,
              pos_only=pos_only, return_traj=True, return_v_probs=True)
    ref = jmodel.sample_diffusion(params, key, jbatch, init_pos, jbatch.ligand_v, impl="xla",
                                  dtype=jnp.float32, **kw)
    draws = _JaxDraws(key, tuple(jbatch.ligand_pos.shape), jmodel.num_classes, pos_only)
    monkeypatch.setattr(torch, "randn", draws.randn)
    monkeypatch.setattr(torch, "rand", draws.rand)
    res = model.sample_diffusion(batch, torch.tensor(np.asarray(init_pos)), batch.ligand_v,
                                 torch.Generator(), dtype=torch.float32, **kw)
    monkeypatch.undo()

    if not pos_only:
        for uniform, vt in zip(draws.uniforms, np.asarray(ref.vt_traj)):
            assert _gumbel_margin(uniform, vt) > MARGIN
    if sampler == "dpm2":
        jcb, _, _, _ = _centered(jbatch, batch)
        _, _, offset = JD.center_pos_protein(jbatch.protein_pos, init_pos, jbatch.protein_mask)
        time_seq, s_seq = sampling_schedule(jmodel.num_timesteps, num_steps, sampler, spacing)
        lmask_f = jbatch.ligand_mask.astype(jnp.float32)[..., None]
        states = [(init_pos - offset, jbatch.ligand_v)] + [
            ((p - offset) * lmask_f, v) for p, v in zip(ref.pos_traj[:-1], ref.v_traj[:-1])]
        for (p, v), t, s in zip(states, time_seq, s_seq):
            if s >= 0:
                assert _dpm2_mid_margin(jmodel, params, jcb, p, v, int(t), int(s)) > MARGIN
    S_ = len(sampling_schedule(jmodel.num_timesteps, num_steps, sampler, spacing)[0])
    assert res.pos_traj.shape == (S_,) + tuple(batch.ligand_pos.shape)
    assert res.vt_traj.shape == (S_,) + tuple(batch.ligand_v.shape) + (model.num_classes,)
    for got, want in ((res.pos, ref.pos), (res.pos_traj, ref.pos_traj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POS_ATOL)
    for got, want in ((res.v, ref.v), (res.v_traj, ref.v_traj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((res.v0_traj, ref.v0_traj), (res.vt_traj, ref.vt_traj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_array_equal(res.pos_traj[-1].numpy(), res.pos.numpy())
    if pos_only:
        assert all(torch.equal(v, batch.ligand_v) for v in res.v_traj)


@pytest.mark.parametrize("sampler", ["ddim", "dpm2"])
def test_eta0_positions_do_not_depend_on_the_noise(sampler):
    """At eta 0 with the types held, two generators give the same positions
    (JAX suite: test_ddim_eta0_positions_deterministic)."""
    _, _, _, _, model, batch = small_setup()
    init = torch.randn(batch.ligand_pos.shape, generator=torch.Generator().manual_seed(1))
    runs = [model.sample_diffusion(batch, init, batch.ligand_v,
                                   torch.Generator().manual_seed(seed), num_steps=5,
                                   sampler=sampler, eta=0.0, pos_only=True)
            for seed in (7, 8)]
    assert torch.equal(runs[0].pos, runs[1].pos)
    assert torch.equal(runs[0].v, batch.ligand_v)
    stochastic = [model.sample_diffusion(batch, init, batch.ligand_v,
                                         torch.Generator().manual_seed(seed), num_steps=5,
                                         sampler=sampler, eta=1.0, pos_only=True).pos
                  for seed in (7, 8)]
    assert not torch.equal(*stochastic)


def test_default_sampler_is_ddpm_and_traj_fields_are_opt_in():
    _, _, _, _, model, batch = small_setup()
    a, b = (model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v,
                                   torch.Generator().manual_seed(2), num_steps=3, **kw)
            for kw in ({}, {"sampler": "ddpm"}))
    assert torch.equal(a.pos, b.pos) and torch.equal(a.v, b.v)
    assert a.pos_traj is a.v_traj is a.v0_traj is a.vt_traj is None


# ---- sampling.py -------------------------------------------------------------


def _pocket(n=14, seed=5):
    rng = np.random.default_rng(seed)
    return {"protein_pos": rng.normal(size=(n, 3)).astype(np.float32) * 3 + 10.0,
            "protein_feat": (rng.random((n, 27)) > 0.7).astype(np.float32)}


@pytest.mark.parametrize("sampler", ["ddim", "dpm2"])
def test_sample_diffusion_ligand_trajectories_are_cut_to_each_sample(sampler):
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    _, _, _, _, model, _ = small_setup()
    out = sample_diffusion_ligand(model, _pocket(), num_samples=3,
                                  generator=torch.Generator().manual_seed(0), batch_size=2,
                                  num_steps=5, max_protein=16, max_ligand=8, return_traj=True,
                                  traj_stride=2, rng=np.random.default_rng(0), sampler=sampler,
                                  eta=1.0, ddim_spacing="quadratic")
    frames = len(sampling_schedule(model.num_timesteps, 5, sampler, "quadratic")[0][::2])
    assert len(out["pos_traj"]) == len(out["v_traj"]) == 3 and len(out["time"]) == 2
    for pos, v, pt, vt in zip(out["pos"], out["v"], out["pos_traj"], out["v_traj"]):
        n = len(v)
        assert pt.shape == (frames, n, 3) and vt.shape == (frames, n)
        assert np.isfinite(pt).all() and ((vt >= 0) & (vt < model.num_classes)).all()
        assert np.linalg.norm(pos.mean(0) - _pocket()["protein_pos"].mean(0)) < 20


def test_pos_only_samples_the_reference_types():
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    _, _, _, _, model, _ = small_setup()
    ref = {"ligand_pos": np.zeros((6, 3), np.float32), "ligand_v": np.array([1, 4, 4, 7, 0, 2])}
    out = sample_diffusion_ligand(model, _pocket(), num_samples=2,
                                  generator=torch.Generator().manual_seed(3), num_steps=4,
                                  pos_only=True, sample_num_atoms="ref", ref_ligand=ref,
                                  max_protein=16, max_ligand=8, return_traj=True,
                                  sampler="ddim")
    for v, vt in zip(out["v"], out["v_traj"]):
        np.testing.assert_array_equal(v, ref["ligand_v"])
        assert (vt == ref["ligand_v"]).all()


def test_sample_testset_runs_the_strided_samplers():
    from targetdiff_tpu_torch.sampling import sample_testset

    _, _, _, _, model, _ = small_setup()
    pockets = [_pocket(14, 5), _pocket(9, 6)]
    out = sample_testset(model, pockets, 2, torch.Generator().manual_seed(0), num_steps=4,
                         sample_num_atoms="ref", ref_sizes=[3, 5], chunk_rows=3,
                         sampler="dpm2", eta=0.5, ddim_spacing="quadratic")
    for entry, size in zip(out, [3, 5]):
        for pos, v in zip(entry["pos"], entry["v"]):
            assert pos.shape == (size, 3) and np.isfinite(pos).all()
