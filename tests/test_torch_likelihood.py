"""The port's likelihood and embedding-export path against the JAX package:
the KL and likelihood terms of ops/diffusion.py, `fetch_embedding` with
frozen coordinates (eager, and on the plain versions of the kernels:
whole-block and per-layer), `likelihood_estimation` and
`batch_likelihood_estimation` with JAX's own draws fed in, and the
likelihood CLI on the six-entry dataset beside the JAX CLI. Weights are
bridged from the JAX parameters; the JAX fast path runs its Pallas kernels
in interpret mode. Bars: positions exactly, hidden states atol 2e-4 / rtol
1e-3, logits 2e-3 / 1e-2 (tests/test_fast_forward.py), the ELBO terms 2e-3
/ 2e-4 (tests/test_impl_wiring.py), the plain terms (in float64) and the
position prior 1e-6, the float32 type prior 1e-5 (see its test)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.ops import diffusion as JD
from targetdiff_tpu_torch.data.batch import ComplexBatch
from targetdiff_tpu_torch.ops import diffusion as D
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

H_TOL = dict(atol=2e-4, rtol=1e-3)
LOGIT_TOL = dict(atol=2e-3, rtol=1e-2)
ELBO_TOL = dict(atol=2e-4, rtol=2e-3)
EXACT_TOL = dict(rtol=1e-6, atol=0.0)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- the KL and likelihood terms -------------------------------------------------

def _f64_scheds(jmodel, model):
    """Both packages' schedules as float64 (call under jax.enable_x64)."""
    def port(s):
        return s._replace(**{k: v.double() for k, v in s._asdict().items()
                             if isinstance(v, torch.Tensor)})

    def jax_(s):
        return s._replace(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                             for k, v in s._asdict().items() if hasattr(v, "shape")})

    return (jax_(jmodel.pos_sched), jax_(jmodel.v_sched)), (port(model.pos_sched),
                                                            port(model.v_sched))


@pytest.mark.parametrize("name", ["normal_kl", "log_normal", "kl_v_prior", "kl_pos_prior",
                                  "compute_pos_Lt", "masked_sum"])
def test_likelihood_terms_match_jax(name):
    """Each term against its JAX function on the same inputs and schedules,
    both evaluated in float64, at rtol 1e-6 (they agree to ~1e-14). In
    float32 the type prior (a KL of a near-uniform distribution from the
    uniform one) sits ~7e-5 from float64 in both packages alike, and the two
    float32 results ~4e-6 apart: see test_likelihood_prior_terms_match_jax."""
    _, jmodel, _, _, model, _ = small_setup()
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s)  # noqa: E731
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = False
    mask[2, 1:] = False
    C, T = jmodel.num_classes, jmodel.num_timesteps
    tt = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    with jax.enable_x64(True):
        (jpos, jv), (pos, v) = _f64_scheds(jmodel, model)
        ja = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
        if name == "normal_kl":
            args = (f(3, 7, 3), f(3, 7, 3) * 0.3, f(3, 7, 3), f(3, 7, 3) * 0.3)
            got, want = D.normal_kl(*map(tt, args)), JD.normal_kl(*map(ja, args))
        elif name == "log_normal":
            args = (f(3, 7, 3), f(3, 7, 3), f(3, 1, 1) * 0.5)
            got, want = D.log_normal(*map(tt, args)), JD.log_normal(*map(ja, args))
        elif name == "kl_v_prior":
            log_v0 = np.log(np.clip(np.eye(C)[rng.integers(0, C, (3, 7))], 1e-30, None))
            got = D.kl_v_prior(v, tt(log_v0), tt(mask), C)
            want = JD.kl_v_prior(jv, ja(log_v0), ja(mask), C)
        elif name == "kl_pos_prior":
            x0 = f(3, 7, 3) * 3
            got, want = D.kl_pos_prior(pos, tt(x0), tt(mask)), JD.kl_pos_prior(jpos, ja(x0),
                                                                                ja(mask))
        elif name == "compute_pos_Lt":
            args = (f(3, 7, 3), f(3, 7, 3), f(3, 7, 3), np.array([0, 4, T - 1]), mask)
            got = D.compute_pos_Lt(pos, *map(tt, args))
            want = JD.compute_pos_Lt(jpos, *map(ja, args))
        else:
            x = f(3, 7)
            got, want = D.masked_sum(tt(x), tt(mask)), JD.masked_sum(ja(x), ja(mask))
        want = np.asarray(want)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, **EXACT_TOL)


# ---- fetch_embedding: frozen coordinates ---------------------------------------

EMBED_CASES = [("knn", "eager"), ("knn", "mega"), ("knn", "layers"),
               ("hybrid", "eager"), ("hybrid", "mega"), ("hybrid", "layers")]


def _valid_rows(jbatch):
    """Valid protein rows, then valid ligand rows, of the composed context."""
    return np.concatenate([np.asarray(jbatch.protein_mask), np.asarray(jbatch.ligand_mask)], 1)


@pytest.mark.parametrize("cutoff_mode,path", EMBED_CASES)
def test_fetch_embedding_matches_jax(cutoff_mode, path):
    """fetch_embedding of the port (eager, or the plain versions of the
    whole-block kernels; the per-layer ones through fast_apply(fix_x)) against JAX fetch_embedding(xla) and
    JAX fast_apply(fix_x=True) on its Pallas kernels in interpret mode:
    positions exactly the input, hidden states and logits at the bars."""
    _, jmodel, params, jbatch, model, batch = small_setup(cutoff_mode=cutoff_mode)
    ref_xla = jmodel.fetch_embedding(params, jbatch, impl="xla")
    ref_pl = jmodel.fast_apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, None,
                               dtype=jnp.float32, interpret=True,
                               mode="mega" if path == "eager" else path, fix_x=True)
    if path == "eager":
        out = model.fetch_embedding(batch, impl="eager")
    elif path == "mega":
        out = model.fetch_embedding(batch, impl="fast")
    else:
        with torch.no_grad():
            out = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode=path,
                                   fix_x=True, dtype=torch.float32)
    assert torch.equal(out["pred_ligand_pos"], batch.ligand_pos)
    lm = np.asarray(jbatch.ligand_mask)
    rows = _valid_rows(jbatch)
    for ref in (ref_xla, ref_pl):
        np.testing.assert_array_equal(_np(out["pred_ligand_pos"])[lm],
                                      np.asarray(ref["pred_ligand_pos"])[lm])
        np.testing.assert_allclose(_np(out["final_h"])[rows], np.asarray(ref["final_h"])[rows],
                                   **H_TOL)
        np.testing.assert_allclose(_np(out["final_ligand_h"])[lm],
                                   np.asarray(ref["final_ligand_h"])[lm], **H_TOL)
        np.testing.assert_allclose(_np(out["pred_ligand_v"])[lm],
                                   np.asarray(ref["pred_ligand_v"])[lm], **LOGIT_TOL)
    # padded ligand rows of final_ligand_h are zero, as JAX exports them
    assert not _np(out["final_ligand_h"])[~lm].any()


def test_fix_x_skips_the_h2x_pass(monkeypatch):
    """Under fix_x no h2x sub-layer runs, on any route (whole-block and
    per-layer plain versions, eager); the unfrozen forward runs one a layer."""
    from targetdiff_tpu_torch.models import uni_transformer as U

    _, _, _, _, model, batch = small_setup()
    calls = {"n": 0}
    forward = U.BaseH2XAttLayer.forward

    def counted(self, *a, **kw):
        calls["n"] += 1
        return forward(self, *a, **kw)

    monkeypatch.setattr(U.BaseH2XAttLayer, "forward", counted)
    with torch.no_grad():
        for path in ("mega", "layers"):
            model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, mode=path, fix_x=True)
        model.fetch_embedding(batch, impl="eager")
        assert calls["n"] == 0
        model.apply(batch, batch.ligand_pos, batch.ligand_v)
    assert calls["n"] == len(model.net.refine_net.base_block)


# ---- likelihood_estimation with JAX's draws --------------------------------------

def _jax_draws(key, B, NL, C):
    """The draws of JAX likelihood_estimation's step terms
    (score_model.py:420-423, diffusion.py perturb_pos / q_v_sample)."""
    key_pos, key_v = jax.random.split(key)
    noise = jax.random.normal(key_pos, (B, NL, 3), jnp.float32)
    uniform = jax.random.uniform(key_v, (B, NL, C))
    return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(uniform))


def _rep(jbatch, batch, n):
    """The batch's complexes n times over, in both packages."""
    jrep = jax.tree_util.tree_map(lambda a: jnp.concatenate([a] * n, 0), jbatch)
    return jrep, ComplexBatch(*[torch.cat([f] * n, 0) for f in batch])


@pytest.mark.parametrize("impl,jax_impl", [("eager", "xla"), ("eager", "fast"),
                                           ("fast", "xla"), ("fast", "fast")])
def test_likelihood_step_terms_match_jax(impl, jax_impl):
    """t in {0, 1, T/2, T-1}, one per row (each complex twice), against JAX
    likelihood_estimation with the same draws."""
    _, jmodel, params, jbatch, model, batch = small_setup()
    T = jmodel.num_timesteps
    jrep, rep = _rep(jbatch, batch, 2)
    t = np.array([0, 1, T // 2, T - 1])
    key = jax.random.PRNGKey(11)
    want = jmodel.likelihood_estimation(params, key, jrep, jnp.asarray(t), impl=jax_impl)
    noise, uniform = _jax_draws(key, 4, batch.ligand_pos.shape[1], jmodel.num_classes)
    got = model.likelihood_estimation(rep, torch.from_numpy(t), pos_noise=noise,
                                      v_uniform=uniform, impl=impl)
    for g, w in zip(got, want):
        assert g.shape == (4,) and np.isfinite(_np(g)).all()
        np.testing.assert_allclose(_np(g), np.asarray(w), **ELBO_TOL)


@pytest.mark.parametrize("impl", ["eager", "fast"])
def test_likelihood_prior_terms_match_jax(impl):
    """t = T everywhere: the prior terms, which run no network and need no
    draws (the generator is left unused), against JAX's float32 terms: the
    position prior at rtol 1e-6. The type prior is a KL of a near-uniform
    distribution from the uniform one: both packages' float32 values sit
    ~7e-5 from float64 (their float64 values agree to ~1e-14,
    test_likelihood_terms_match_jax) and ~2.4e-6 from each other, held
    here at 1e-5."""
    _, jmodel, params, jbatch, model, batch = small_setup()
    T = jmodel.num_timesteps
    want = jmodel.likelihood_estimation(params, jax.random.PRNGKey(0), jbatch,
                                        jnp.full((2,), T, jnp.int32), impl="xla")
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    got = model.likelihood_estimation(batch, torch.full((2,), T), generator=gen, impl=impl)
    assert torch.equal(gen.get_state(), state)
    other = model.likelihood_estimation(batch, torch.full((2,), T),
                                        impl="eager" if impl == "fast" else "fast")
    assert all(torch.equal(a, b) for a, b in zip(got, other))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **EXACT_TOL)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-5, atol=0.0)


def test_likelihood_draws_come_from_the_generator():
    """Without injected draws, the same generator state gives the same
    terms, and equals feeding the generator's own draws (positions first)."""
    _, _, _, _, model, batch = small_setup()
    t = torch.tensor([3, 7])
    a = model.likelihood_estimation(batch, t, generator=torch.Generator().manual_seed(5),
                                    impl="fast")
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn(batch.ligand_pos.shape, generator=gen)
    uniform = torch.rand(batch.ligand_v.shape + (model.num_classes,), generator=gen)
    b = model.likelihood_estimation(batch, t, pos_noise=noise, v_uniform=uniform, impl="fast")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="impl"):
        model.likelihood_estimation(batch, t, impl="xla")


@pytest.mark.parametrize("impl", ["eager", "fast"])
def test_batch_likelihood_estimation_matches_jax(impl):
    from targetdiff_tpu.cli.likelihood_est_diffusion import (
        batch_likelihood_estimation as jax_batch_likelihood_estimation,
    )
    from targetdiff_tpu_torch.cli.likelihood_est_diffusion import (
        batch_likelihood_estimation,
        data_likelihood_estimation,
    )

    _, jmodel, params, jbatch, model, batch = small_setup()
    time_steps = [0, 3, 6, 9]
    key = jax.random.PRNGKey(4)
    want = jax_batch_likelihood_estimation(jmodel, params, jbatch, key, time_steps,
                                           impl="xla" if impl == "eager" else "fast")
    noise, uniform = _jax_draws(key, 2 * len(time_steps), batch.ligand_pos.shape[1],
                                jmodel.num_classes)
    got = batch_likelihood_estimation(model, batch, time_steps, None, impl=impl,
                                      pos_noise=noise, v_uniform=uniform)
    assert got[0].shape == (2,) and got[1].shape == got[2].shape == (2, len(time_steps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **ELBO_TOL)
    one = ComplexBatch(*[f[:1] for f in batch])
    nll, kl_pos, kl_v = data_likelihood_estimation(model, one, time_steps,
                                                   torch.Generator().manual_seed(0), impl=impl)
    assert np.isfinite(nll) and kl_pos.shape == kl_v.shape == (len(time_steps),)


# ---- the likelihood CLI ------------------------------------------------------------

EXPORT_FIELDS = {"ligand_filename", "protein_filename", "nll", "kl_pos", "kl_v", "final_h",
                 "final_ligand_h", "pred_ligand_v"}


def _cli_setup(tmp_path, setup=small_setup, **saved_overrides):
    """A checkpoint that loads in both packages (the small flagship, or the
    model of another `setup`) over the six-entry dataset, and a sampling
    config naming it. `saved_overrides` change the model config written into
    the checkpoint only."""
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from tests.test_torch_data import _data_cfg, _mini_raw

    cfg, _, params, _, _, _ = setup()
    raw, split = _mini_raw(tmp_path)
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": _data_cfg(raw, split),
                                "model": dict(cfg, **saved_overrides)},
                    jax.device_get(params))
    yml = tmp_path / "sampling.yml"
    yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n")
    return str(yml)


@pytest.mark.parametrize("impl", ["fast", "eager"])
def test_likelihood_cli_writes_the_jax_fields(impl, tmp_path):
    """The port's CLI on the CPU writes crossdocked_test.pkl with the JAX
    CLI's fields; the fields that do not depend on the draws (the embedding
    export, the file names) match the JAX CLI's at the bars. The model picks
    the path from the checkpoint's config: 'fast' (the kernels' plain
    versions) for the small flagship, 'eager' for an EGNN checkpoint, which
    the CLI takes without a flag."""
    from targetdiff_tpu.cli import likelihood_est_diffusion as jax_cli
    from targetdiff_tpu_torch.cli import likelihood_est_diffusion as cli
    from targetdiff_tpu_torch.cli.sample_for_pocket import load_model_from_checkpoint
    from tests.test_torch_egnn import egnn_setup

    yml = _cli_setup(tmp_path, setup=small_setup if impl == "fast" else egnn_setup)
    ckpt = str(tmp_path / "ckpt.npz")
    assert load_model_from_checkpoint(ckpt, "cpu", 640, 40)[0].impl == impl
    common = ["--t_stride", "3", "--max_ligand", "40", "--batch_complexes", "3"]
    cli.main([yml, "--result_path", str(tmp_path / "port"), "--device", "cpu", *common])
    jax_cli.main([yml, "--result_path", str(tmp_path / "jax"), "--impl", "xla", *common])
    got = pickle.loads((tmp_path / "port" / "crossdocked_test.pkl").read_bytes())
    want = pickle.loads((tmp_path / "jax" / "crossdocked_test.pkl").read_bytes())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == EXPORT_FIELDS
        assert (g["ligand_filename"], g["protein_filename"]) == ("ligand.sdf", "pocket.pdb")
        assert (g["ligand_filename"], g["protein_filename"]) == (w["ligand_filename"],
                                                                 w["protein_filename"])
        assert g["kl_pos"].shape == g["kl_v"].shape == w["kl_pos"].shape == (4,)
        assert np.isfinite([g["nll"], *g["kl_pos"], *g["kl_v"]]).all()
        assert g["final_h"].shape == w["final_h"].shape
        assert g["final_h"].shape[0] == 572 + g["final_ligand_h"].shape[0]
        np.testing.assert_allclose(g["final_h"], w["final_h"], **H_TOL)
        np.testing.assert_allclose(g["final_ligand_h"], w["final_ligand_h"], **H_TOL)
        np.testing.assert_allclose(g["pred_ligand_v"], w["pred_ligand_v"], **LOGIT_TOL)
        np.testing.assert_allclose(g["pred_ligand_v"].sum(-1), 1.0, rtol=1e-5)


def test_likelihood_cli_pads_batches_and_seeds_by_first_index(tmp_path):
    """Batches of C complexes padded by repeating the last: one record per
    real complex whatever C (1, or 2 over 3 complexes: one padded batch),
    embeddings that do not depend on C, and draws seeded by the config's
    seed plus the batch's first index (a rerun gives the same nll)."""
    from targetdiff_tpu_torch.cli import likelihood_est_diffusion as cli

    yml = _cli_setup(tmp_path)
    runs = []
    for c in (1, 2, 2):
        path = cli.main([yml, "--split", "train", "--result_path",
                         str(tmp_path / f"run{len(runs)}"), "--device", "cpu", "--t_stride",
                         "5", "--max_ligand", "40", "--batch_complexes", str(c), "--limit", "3"])
        runs.append(pickle.loads(open(path, "rb").read()))
    assert [len(r) for r in runs] == [3, 3, 3]
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_allclose(a["final_h"], b["final_h"], atol=1e-5, rtol=1e-5)
        assert np.isfinite(a["nll"]) and a["kl_pos"].shape == (2,)
    assert [r["nll"] for r in runs[1]] == [r["nll"] for r in runs[2]]


def test_likelihood_cli_refuses_a_missing_gpu_and_an_unsupported_fast_config(tmp_path,
                                                                              monkeypatch):
    from targetdiff_tpu_torch.cli import likelihood_est_diffusion as cli

    yml = _cli_setup(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([yml, "--device", "cuda", "--result_path", str(tmp_path / "out")])
    # a variant checkpoint (V1: ew_net_type r, the x2h output MLP) runs
    # through the CLI on the eager path
    var = tmp_path / "variant"
    var.mkdir()
    var_yml = _cli_setup(var, setup=lambda: small_setup(ew_net_type="r", x2h_out_fc=True))
    path = cli.main([var_yml, "--split", "train", "--result_path", str(var / "out"), "--device",
                     "cpu", "--t_stride", "5", "--max_ligand", "40", "--limit", "2"])
    rows = pickle.loads(open(path, "rb").read())
    assert len(rows) == 2 and all(np.isfinite(r["nll"]) for r in rows)
    assert rows[0]["final_ligand_h"].shape[1] == 32
    # configs it does not take: a radius cutoff, and a time embedding (the
    # embedding export passes no time step)
    for name, override in (("bad", dict(cutoff_mode="radius")), ("temb", dict(time_emb_dim=4))):
        bad = tmp_path / name
        bad.mkdir()
        bad_yml = _cli_setup(bad, **override)
        with pytest.raises(SystemExit, match="cutoff_mode" if name == "bad" else "time step"):
            cli.main([bad_yml, "--device", "cpu", "--result_path", str(tmp_path / "out")])
