"""The port's data and storage layer and its train CLI on the CPU, against
the JAX package: synthetic complexes bit for bit, the mini CrossDocked-style
dataset collated to the same arrays, checkpoints the JAX loader reads,
resume, and `train_diffusion.main` end to end."""

import glob
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from targetdiff_tpu.cli import train_diffusion as jcli
from targetdiff_tpu.config import Config as JConfig
from targetdiff_tpu.data import datasets as jdatasets
from targetdiff_tpu.data.synth import synth_batch as jax_synth_batch
from targetdiff_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from targetdiff_tpu_torch import trainer as T
from targetdiff_tpu_torch.cli import train_diffusion
from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data import datasets
from targetdiff_tpu_torch.data.synth import synth_batch
from targetdiff_tpu_torch.utils import train as TU
from targetdiff_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

OPT = dict(type="adam", lr=1e-3, weight_decay=0.0, beta1=0.95, beta2=0.999, max_grad_norm=8.0)


def _mini_raw(root):
    """The six-entry dataset of tests/test_cli_integration.py."""
    raw = root / "raw"
    raw.mkdir(parents=True)
    shutil.copyfile("examples/1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb", raw / "pocket.pdb")
    shutil.copyfile("examples/3ug2_ligand.sdf", raw / "ligand.sdf")
    with open(raw / "index.pkl", "wb") as f:
        pickle.dump([("pocket.pdb", "ligand.sdf", 0.5)] * 6, f)
    split = str(root / "split.pt")
    torch.save({"train": [0, 1, 2, 3], "test": [4, 5]}, split)
    return str(raw), split


def _data_cfg(raw, split):
    return {"name": "pl", "path": raw, "split": split,
            "transform": {"ligand_atom_mode": "add_aromatic", "random_rot": False}}


def test_synth_batch_matches_jax_bit_for_bit():
    kw = dict(batch=3, max_protein=64, max_ligand=32, n_protein_range=(40, 64))
    ours = synth_batch(np.random.default_rng(7), **kw)
    ref = jax_synth_batch(np.random.default_rng(7), **kw)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mini_dataset_collates_like_jax(tmp_path):
    batches = []
    for pkg, mod, cfg_cls in (("jax", jdatasets, JConfig), ("port", datasets, Config)):
        raw, split = _mini_raw(tmp_path / pkg)
        cfg = cfg_cls(_data_cfg(raw, split))
        build = jcli.build_transform if pkg == "jax" else train_diffusion.build_transform
        transform = build(cfg)[0]
        _, subsets = mod.get_dataset(cfg, transform=transform)
        loader = mod.PaddedLoader(subsets["train"], 2, max_protein=640, max_ligand=40,
                                  shuffle=False)
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) == 2
    for ref, ours in zip(*batches):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _trained(steps, seed=0):
    """The small port model after `steps` train steps, and its state."""
    cfg, _, params, _, model, batch = small_setup()
    state = T.create_train_state(model, TU.get_optimizer(Config(OPT), model.parameters()))
    step = T.make_train_step(model, pos_noise_std=0.1)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        state, _ = step(state, batch, gen)
    return cfg, params, state, step, batch


def test_checkpoint_loads_in_jax_and_resumes(tmp_path):
    cfg, params, state, step, batch = _trained(2)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, cfg, state.model.net, state.optimizer, {"lr": 1e-3}, state.step)
    # the JAX loader reads it, with the JAX params tree as the template
    ck = jax_load_checkpoint(path, params_template=params)
    assert ck["iteration"] == 2 and ck["config"].hidden_dim == cfg.hidden_dim
    leaves = jax.tree_util.tree_leaves_with_path(ck["params"])
    sd = dict(state.model.net.named_parameters())
    assert len(leaves) == len(sd)
    w = state.model.net.refine_net.base_block[1].x2h_layers[0].hv_func.net[3].weight
    np.testing.assert_array_equal(
        ck["params"]["params"]["refine_net"]["block_1"]["x2h_0"]["hv_func"]["lin_1"]["kernel"],
        w.detach().numpy().T)
    # resume: a fresh model and optimizer continue exactly where the run stopped
    _, _, fresh, _, _ = _trained(0)
    ck = load_checkpoint(path)
    fresh.model.net.load_state_dict(ck["state_dict"])
    fresh.optimizer.load_state_dict(ck["opt_state"])
    fresh.step = ck["iteration"]
    assert fresh.step == state.step and ck["scheduler"] == {"lr": 1e-3}
    for (i, a), (j, b) in zip(state.optimizer.state_dict()["state"].items(),
                              fresh.optimizer.state_dict()["state"].items()):
        assert i == j and all(torch.equal(a[k], b[k]) for k in a)
    draws = dict(time_step=torch.tensor([1, 4]), pos_noise=torch.randn(batch.ligand_pos.shape),
                 v_uniform=torch.rand(batch.ligand_v.shape + (13,)))
    step_b = T.make_train_step(fresh.model)
    step_a = T.make_train_step(state.model)
    step_a(state, batch, None, **draws)
    step_b(fresh, batch, None, **draws)
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_train_cli_runs_on_cpu_and_writes_a_checkpoint(tmp_path):
    raw, split = _mini_raw(tmp_path)
    cfg = {
        "data": _data_cfg(raw, split),
        "model": {
            "model_mean_type": "C0", "beta_schedule": "sigmoid", "beta_start": 1.0e-7,
            "beta_end": 2.0e-3, "v_beta_schedule": "cosine", "v_beta_s": 0.01,
            "num_diffusion_timesteps": 12, "loss_v_weight": 100.0,
            "sample_time_method": "symmetric", "time_emb_dim": 0, "time_emb_mode": "simple",
            "center_pos_mode": "protein", "node_indicator": True, "model_type": "uni_o2",
            "num_blocks": 1, "num_layers": 1, "hidden_dim": 16, "n_heads": 2,
            "edge_feat_dim": 4, "num_r_gaussian": 20, "knn": 6, "num_node_types": 8,
            "act_fn": "relu", "norm": True, "cutoff_mode": "knn", "ew_net_type": "global",
            "num_x2h": 1, "num_h2x": 1, "r_max": 10.0, "x2h_out_fc": False, "sync_twoup": False,
        },
        "train": {
            "seed": 1, "batch_size": 2, "max_iters": 4, "val_freq": 2, "pos_noise_std": 0.1,
            "max_grad_norm": 8.0,
            "optimizer": {"type": "adam", "lr": 1.0e-3, "weight_decay": 0, "beta1": 0.95,
                          "beta2": 0.999},
            "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10, "min_lr": 1.0e-6},
        },
    }
    cfg_path = str(tmp_path / "train.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    common = ["--device", "cpu", "--max_protein", "640", "--max_ligand", "40",
              "--train_report_iter", "1"]
    out = train_diffusion.main([cfg_path, "--logdir", str(tmp_path / "logs"), *common])
    assert out["checkpoints"] and all(os.path.exists(c) for c in out["checkpoints"])
    assert np.isfinite(list(out["metrics"].values())).all()
    log = open(os.path.join(out["log_dir"], "log.txt")).read()
    assert "[train] iter 4" in log and "[val] iter 4" in log
    # resume from the iteration-2 checkpoint: only iterations 3 and 4 run
    ck2 = glob.glob(os.path.join(out["log_dir"], "ckpt_2.npz"))
    assert ck2
    res = train_diffusion.main([cfg_path, "--logdir", str(tmp_path / "logs2"), "--resume",
                                ck2[0], *common])
    log = open(os.path.join(res["log_dir"], "log.txt")).read()
    assert "resumed from" in log and "[train] iter 3" in log and "[train] iter 1 " not in log


def test_train_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = train_diffusion.parser().parse_args(["unused.yml", "--logdir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train_diffusion.run(Config({}), args)
