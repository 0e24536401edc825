"""The port's DDPM step against the JAX package's `_sample_step` (XLA path)
with the same noise: the JAX noise is derived from the key split of
score_model.py:491 and diffusion.py:88 and passed to the port explicitly.
Plus the schedules and the posterior helpers against the JAX functions,
and a short end-to-end sampling run on the CPU."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.ops import diffusion as JD
from targetdiff_tpu_torch.ops import diffusion as D
from targetdiff_tpu_torch.sampling import sample_diffusion_ligand
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

# key seed whose Gumbel argmax margins all exceed 1e-3 on the steps below
NOISE_SEED = 0


def _jax_noise(key, pos_shape, num_classes):
    k, k_pos, k_v = jax.random.split(key, 3)
    noise = jax.random.normal(k_pos, pos_shape, jnp.float32)
    uniform = jax.random.uniform(k_v, pos_shape[:2] + (num_classes,))
    return k, np.asarray(noise), np.asarray(uniform)


def _gumbel_margin(jmodel, params, cbatch, pos, v, t, uniform):
    """Smallest top-1 minus top-2 gap of gumbel + log q(v_{t-1}|v_t, v0) on
    the JAX side."""
    tt = jnp.full((cbatch.num_graphs,), t, jnp.int32)
    preds = jmodel.apply(params, cbatch, pos, v, tt)
    log_recon = jax.nn.log_softmax(preds["pred_ligand_v"], -1)
    log_prob = JD.q_v_posterior(jmodel.v_sched, log_recon,
                                JD.index_to_log_onehot(v, jmodel.num_classes), tt,
                                jmodel.num_classes)
    g = np.asarray(-jnp.log(-jnp.log(uniform + 1e-30) + 1e-30) + log_prob)
    top2 = np.sort(g, -1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("ts", [(9,), (4,), (0,), (9, 8, 7)])
def test_sample_steps_match_jax(ts):
    _, jmodel, params, jbatch, model, batch = small_setup()
    ppos, lpos, _ = JD.center_pos_protein(jbatch.protein_pos, jbatch.ligand_pos,
                                          jbatch.protein_mask, "protein")
    jcb = jbatch._replace(protein_pos=ppos)
    cbatch = batch._replace(protein_pos=torch.tensor(np.asarray(ppos)))
    lmask_f = jbatch.ligand_mask.astype(jnp.float32)[..., None]
    carry = (lpos * lmask_f, jbatch.ligand_v, jax.random.PRNGKey(NOISE_SEED))
    pos = torch.tensor(np.asarray(carry[0]))
    v = torch.from_numpy(np.asarray(carry[1]).astype(np.int64))
    for t in ts:
        _, noise, uniform = _jax_noise(carry[2], carry[0].shape, jmodel.num_classes)
        assert _gumbel_margin(jmodel, params, jcb, carry[0], carry[1], t, uniform) > 1e-3
        carry, _ = jmodel._sample_step(
            params, jcb, lmask_f, jnp.zeros((2, 1, 3)), carry, {"t": t, "s": t - 1},
            impl="xla", dtype=jnp.float32, pos_only=False, return_traj=False,
            return_v_probs=False)
        pos, v = model.sample_step(cbatch, pos, v, t, torch.tensor(noise),
                                   torch.tensor(uniform), dtype=torch.float32)
        np.testing.assert_array_equal(v.numpy(), np.asarray(carry[1]))
        np.testing.assert_allclose(pos.numpy(), np.asarray(carry[0]), atol=1e-3)


def test_schedules_and_posteriors_match_jax():
    _, jmodel, _, jbatch, model, batch = small_setup()
    for name in jmodel.pos_sched._fields:
        np.testing.assert_allclose(getattr(model.pos_sched, name).numpy(),
                                   np.asarray(getattr(jmodel.pos_sched, name)), rtol=1e-6)
    for name in jmodel.v_sched._fields:
        np.testing.assert_allclose(getattr(model.v_sched, name).numpy(),
                                   np.asarray(getattr(jmodel.v_sched, name)), rtol=1e-6,
                                   atol=1e-6)
    rng = np.random.default_rng(0)
    C = jmodel.num_classes
    log_v0 = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(2, 8, C)).astype(np.float32)))
    vt = rng.integers(0, C, (2, 8))
    t = np.array([0, 6])
    ref = JD.q_v_posterior(jmodel.v_sched, log_v0, JD.index_to_log_onehot(jnp.asarray(vt), C),
                           jnp.asarray(t), C)
    out = D.q_v_posterior(model.v_sched, torch.tensor(np.asarray(log_v0)),
                          D.index_to_log_onehot(torch.from_numpy(vt), C), torch.from_numpy(t), C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)

    ref_c = JD.center_pos_protein(jbatch.protein_pos, jbatch.ligand_pos, jbatch.protein_mask)
    out_c = D.center_pos_protein(batch.protein_pos, batch.ligand_pos, batch.protein_mask)
    for a, b in zip(out_c, ref_c):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_sample_diffusion_ligand_runs_on_cpu():
    _, _, _, _, model, _ = small_setup()
    rng = np.random.default_rng(5)
    pocket = {"protein_pos": rng.normal(size=(14, 3)).astype(np.float32) * 3 + 10.0,
              "protein_feat": (rng.random((14, 27)) > 0.7).astype(np.float32)}
    out = sample_diffusion_ligand(model, pocket, num_samples=3,
                                  generator=torch.Generator().manual_seed(0), batch_size=2,
                                  num_steps=4, max_protein=16, max_ligand=8,
                                  rng=np.random.default_rng(0))
    assert len(out["pos"]) == 3 and len(out["time"]) == 2
    for pos, v in zip(out["pos"], out["v"]):
        assert pos.shape == (len(v), 3) and 1 <= len(v) <= 8
        assert np.isfinite(pos).all() and ((v >= 0) & (v < model.num_classes)).all()
        assert np.linalg.norm(pos.mean(0) - pocket["protein_pos"].mean(0)) < 20


def test_sample_for_pocket_cli_on_cpu(tmp_path):
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_for_pocket

    cfg, _, params, _, _, _ = small_setup()
    ckpt = tmp_path / "ckpt.npz"
    train_cfg = {"data": {"transform": {"ligand_atom_mode": "add_aromatic"}},
                 "model": dict(cfg)}
    save_checkpoint(str(ckpt), train_cfg, jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n  num_steps: 2\n")
    out = tmp_path / "out"
    sample_for_pocket.main([
        str(sample_yml), "--pdb_path",
        str(REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb"),
        "--num_samples", "2",
        "--result_path", str(out), "--max_ligand", "8", "--device", "cpu"])
    assert (out / "samples.smi").exists()


def test_sample_for_pocket_cli_runs_a_hybrid_checkpoint(tmp_path):
    """A hybrid-cutoff checkpoint samples from its config unchanged: the
    model's max_ligand is the CLI's ligand slot count."""
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_for_pocket

    cfg, _, params, _, _, _ = small_setup(cutoff_mode="hybrid")
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": {"transform": {"ligand_atom_mode": "add_aromatic"}},
                                "model": dict(cfg)}, jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 4\n  num_steps: 2\n")
    model, _, _ = sample_for_pocket.load_model_from_checkpoint(str(ckpt), "cpu", max_ligand=8)
    assert model.net.refine_net.cutoff_mode == "hybrid"
    assert model.net.refine_net.num_neighbors() == 8 - 1 + cfg.knn
    out = tmp_path / "out"
    sample_for_pocket.main([
        str(sample_yml), "--pdb_path",
        str(REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb"),
        "--num_samples", "2", "--result_path", str(out), "--max_ligand", "8", "--device", "cpu"])
    assert (out / "samples.smi").exists()


@pytest.mark.parametrize("np_max,max_protein", [(1, 640), (64, 640), (65, 640), (572, 640),
                                                (600, 600), (100, 128), (127, 128)])
def test_choose_protein_padding_matches_jax(np_max, max_protein):
    from targetdiff_tpu.sampling import choose_protein_padding as jax_padding
    from targetdiff_tpu_torch.sampling import choose_protein_padding

    assert choose_protein_padding(np_max, max_protein, 32) == jax_padding(np_max, max_protein, 32)
    with pytest.raises(ValueError):
        choose_protein_padding(max_protein + 1, max_protein, 32)


def _pockets(counts, seed=5):
    rng = np.random.default_rng(seed)
    return [{"protein_pos": rng.normal(size=(n, 3)).astype(np.float32) * 3 + 10.0,
             "protein_feat": (rng.random((n, 27)) > 0.7).astype(np.float32)} for n in counts]


def test_sample_testset_gives_each_pocket_its_samples_at_ref_sizes():
    from targetdiff_tpu_torch.sampling import sample_testset

    _, _, _, _, model, _ = small_setup()
    pockets = _pockets([14, 9, 16])
    out = sample_testset(model, pockets, 2, torch.Generator().manual_seed(0), num_steps=3,
                         sample_num_atoms="ref", ref_sizes=[3, 5, 8], chunk_rows=4)
    assert len(out) == 3
    for entry, pocket, size in zip(out, pockets, [3, 5, 8]):
        assert len(entry["pos"]) == len(entry["v"]) == 2 and entry["time"] > 0
        for pos, v in zip(entry["pos"], entry["v"]):
            assert pos.shape == (size, 3) and v.shape == (size,)
            assert np.isfinite(pos).all() and ((v >= 0) & (v < model.num_classes)).all()
            assert np.linalg.norm(pos.mean(0) - pocket["protein_pos"].mean(0)) < 20
    with pytest.raises(ValueError, match="ref_sizes"):
        sample_testset(model, pockets, 2, torch.Generator(), num_steps=1, sample_num_atoms="ref")


@pytest.mark.parametrize("mode", ["prior", "range"])
def test_sample_testset_sizes_do_not_depend_on_chunk_rows(mode):
    from targetdiff_tpu_torch.sampling import sample_testset

    _, _, _, _, model, _ = small_setup()
    pockets = _pockets([14, 9, 16, 12])
    sizes = []
    for chunk_rows in (3, 100):
        out = sample_testset(model, pockets, 3, torch.Generator().manual_seed(1), num_steps=1,
                             sample_num_atoms=mode, rng=np.random.default_rng(4),
                             chunk_rows=chunk_rows)
        sizes.append([[len(v) for v in entry["v"]] for entry in out])
    assert sizes[0] == sizes[1]
    assert all(1 <= s <= model.max_ligand for row in sizes[0] for s in row)


@pytest.mark.parametrize("sharded", [False, True])
def test_sample_diffusion_cli_results_read_in_the_jax_evaluation(sharded, tmp_path):
    """The port's sampling CLI on the six-entry dataset (test split: two
    pockets) writes result_*.pkl files with the JAX CLI's fields, which the
    JAX package's evaluate_results reads as the port's does."""
    from targetdiff_tpu.cli.evaluate_diffusion import evaluate_results as jax_evaluate_results
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_diffusion
    from targetdiff_tpu_torch.cli.evaluate_diffusion import evaluate_results
    from tests.test_torch_data import _data_cfg, _mini_raw
    from tests.test_torch_evaluation import _close

    cfg, _, params, _, _, _ = small_setup()
    raw, split = _mini_raw(tmp_path)
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": _data_cfg(raw, split), "model": dict(cfg)},
                    jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n  num_steps: 2\n"
                          "  num_samples: 3\n  sample_num_atoms: prior\n")
    out = tmp_path / "out"
    sample_diffusion.main([str(sample_yml), "--all", "--result_path", str(out),
                           "--max_ligand", "8", "--device", "cpu",
                           *(["--sharded", "--chunk_rows", "2"] if sharded else [])])
    files = sorted(out.glob("result_*.pkl"))
    assert [f.name for f in files] == ["result_0.pkl", "result_1.pkl"]
    for f in files:
        res = pickle.loads(f.read_bytes())
        assert set(res) == {"data", "pred_ligand_pos", "pred_ligand_v", "time",
                            "ligand_atom_mode"}
        assert len(res["pred_ligand_pos"]) == 3 and res["ligand_atom_mode"] == "add_aromatic"
        assert res["data"]["protein_pos"].shape == (572, 3)
        assert res["data"]["ligand_filename"] == "ligand.sdf"
    got, _ = evaluate_results(files, "add_aromatic")
    want, _ = jax_evaluate_results(files, "add_aromatic")
    _close(got, want, "summary")


def test_sample_diffusion_cli_runs_the_strided_samplers_and_saves_trajectories(tmp_path):
    """--sampler ddim --save_traj 1 on the six-entry dataset: result files
    with the trajectory fields, read by the JAX package's evaluate_results as
    by the port's, at the final step and at a trajectory step; --sharded
    refuses --save_traj and sample.pos_only."""
    from targetdiff_tpu.cli.evaluate_diffusion import evaluate_results as jax_evaluate_results
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_diffusion
    from targetdiff_tpu_torch.cli.evaluate_diffusion import evaluate_results
    from targetdiff_tpu_torch.models.score_model import sampling_schedule
    from tests.test_torch_data import _data_cfg, _mini_raw
    from tests.test_torch_evaluation import _close

    cfg, _, params, _, _, _ = small_setup()
    raw, split = _mini_raw(tmp_path)
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": _data_cfg(raw, split), "model": dict(cfg)},
                    jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n  num_steps: 4\n"
                          "  num_samples: 3\n  sample_num_atoms: prior\n")
    out = tmp_path / "out"
    sample_diffusion.main([str(sample_yml), "-i", "1", "--result_path", str(out),
                           "--max_ligand", "8", "--device", "cpu", "--sampler", "ddim",
                           "--eta", "0.5", "--ddim_spacing", "quadratic", "--save_traj", "1"])
    files = sorted(out.glob("result_*.pkl"))
    assert [f.name for f in files] == ["result_1.pkl"]
    res = pickle.loads(files[0].read_bytes())
    assert set(res) == {"data", "pred_ligand_pos", "pred_ligand_v", "time", "ligand_atom_mode",
                        "pred_ligand_pos_traj", "pred_ligand_v_traj", "traj_stride"}
    frames = len(sampling_schedule(cfg.num_diffusion_timesteps, 4, "ddim", "quadratic")[0])
    assert res["traj_stride"] == 1 and len(res["pred_ligand_pos_traj"]) == 3
    for pos, v, pt, vt in zip(res["pred_ligand_pos"], res["pred_ligand_v"],
                              res["pred_ligand_pos_traj"], res["pred_ligand_v_traj"]):
        assert pt.shape == (frames,) + pos.shape and vt.shape == (frames,) + v.shape
        np.testing.assert_array_equal(pt[-1], pos)
        np.testing.assert_array_equal(vt[-1], v)
    for step in (-1, 0):
        got, _ = evaluate_results(files, "add_aromatic", eval_step=step)
        want, _ = jax_evaluate_results(files, "add_aromatic", eval_step=step)
        _close(got, want, f"summary at step {step}")

    pos_only_yml = tmp_path / "pos_only.yml"
    pos_only_yml.write_text(sample_yml.read_text() + "  pos_only: true\n")
    for yml, extra in ((sample_yml, ["--save_traj", "1"]), (pos_only_yml, [])):
        with pytest.raises(SystemExit, match="sharded"):
            sample_diffusion.main([str(yml), "--all", "--sharded", "--device", "cpu", *extra])


def test_sample_diffusion_cli_samples_positions_for_the_pocket_ligand(tmp_path):
    """sample.pos_only: the molecules keep the test ligand's own types."""
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_diffusion
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.datasets import get_dataset
    from targetdiff_tpu_torch.data.transforms import (Compose, FeaturizeLigandAtom,
                                                      FeaturizeProteinAtom)
    from tests.test_torch_data import _data_cfg, _mini_raw

    cfg, _, params, _, _, _ = small_setup()
    raw, split = _mini_raw(tmp_path)
    data_cfg = _data_cfg(raw, split)
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": data_cfg, "model": dict(cfg)}, jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n  num_steps: 3\n"
                          "  num_samples: 2\n  sample_num_atoms: ref\n  pos_only: true\n")
    out = tmp_path / "out"
    sample_diffusion.main([str(sample_yml), "--result_path", str(out), "--max_ligand", "64",
                           "--device", "cpu", "--sampler", "dpm2"])
    res = pickle.loads((out / "result_0.pkl").read_bytes())
    transform = Compose([FeaturizeProteinAtom(), FeaturizeLigandAtom("add_aromatic")])
    _, subsets = get_dataset(Config(data_cfg), transform=transform)
    ref_v = subsets["test"][0]["ligand_atom_feature_full"]
    for pos, v in zip(res["pred_ligand_pos"], res["pred_ligand_v"]):
        np.testing.assert_array_equal(v, ref_v)
        assert pos.shape == (len(ref_v), 3) and np.isfinite(pos).all()


def test_sample_for_pocket_cli_takes_the_ddim_flags(tmp_path):
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_for_pocket

    cfg, _, params, _, _, _ = small_setup()
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": {"transform": {"ligand_atom_mode": "add_aromatic"}},
                                "model": dict(cfg)}, jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n  num_steps: 3\n")
    out = tmp_path / "out"
    sample_for_pocket.main([
        str(sample_yml), "--pdb_path",
        str(REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb"),
        "--num_samples", "2", "--result_path", str(out), "--max_ligand", "8", "--device", "cpu",
        "--sampler", "ddim", "--ddim_spacing", "quadratic", "--eta", "1.0"])
    assert (out / "samples.smi").exists()
    with pytest.raises(SystemExit):  # JAX's sample_for_pocket offers no dpm2
        sample_for_pocket.main([str(sample_yml), "--pdb_path", "x.pdb", "--sampler", "dpm2"])
