"""The port's data parallelism (parallel/mesh.py) on the CPU: two gloo ranks,
spawned, against one process and against the JAX package.

One spawn of two ranks runs every job of tests/torch_parallel_jobs.py: the
data-parallel train step on the kNN and the hybrid graph, impl 'fast' (the
kernels' plain versions) and 'eager', symmetric and importance time, and
'fast_pl' and the EGNN denoiser;
`sample_testset` (ddpm, ddim) with a chunk that splits unequally and one
that leaves a rank no rows; validation with an uneven last batch;
`gather_rows`; and the step with the JAX step's draws given. The parent
runs the same jobs with no mesh. Bars of the step: loss rel 1e-6, the
all-reduced gradients within 1e-5 of max |g|, the gradient norm rel 1e-5,
the updated parameters abs 1e-6 where |g| > 1e-3 max |g| (Adam's first
step is about lr * sign(g), so an entry whose gradient is near zero can
flip by 2 lr on a float32-order difference), the Lt EMA rel 1e-5.
Sampling: positions within 1e-5, types equal, identical on both ranks.
Then the failure paths (a batch that does not split, a rank that raises,
a rank whose peer dies), `tools/dryrun_multi` at W = 2 and 4, and the train and
sampling CLIs over two processes against one.
"""

import os
import pickle
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from targetdiff_tpu import trainer as jtrainer
from targetdiff_tpu.config import Config as JConfig
from targetdiff_tpu.ops import diffusion as JD
from targetdiff_tpu.utils import train as JTU
from targetdiff_tpu_torch.cli import train_diffusion
from targetdiff_tpu_torch.parallel import mesh as pmesh
from targetdiff_tpu_torch.tools import dryrun_multi
from tests import torch_parallel_jobs as jobs
from tests.test_torch_block_vjp import jax_draws
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL, GRAD_BAR, NORM_REL, PARAM_ABS, PARAM_G_FLOOR, LT_REL = 1e-6, 1e-5, 1e-5, 1e-6, 1e-3, 1e-5
POS_TOL = dict(atol=1e-5, rtol=0.0)
JAX_REL = 1e-4  # tests/test_torch_train.py's bar against the JAX step
TIMEOUT = 300


def _jax_step():
    """The JAX XLA step of tests/test_torch_train.py and its draws, and the
    port's weights and batch of the same small setup."""
    _, jmodel, params, jbatch, model, batch = small_setup()
    jopt = JTU.get_optimizer(JConfig(jobs.OPT))
    T_ = jmodel.num_timesteps
    state = jtrainer.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32),
                                jnp.zeros((T_,), jnp.float32), jnp.zeros((T_,), jnp.float32))
    key = jax.random.PRNGKey(3)
    _, metrics = jtrainer.make_train_step(jmodel, jopt, impl="xla", remat=False)(state, jbatch,
                                                                                  key)
    _, _, key_loss = jax.random.split(key, 3)
    key_t, _, _ = jax.random.split(key_loss, 3)
    t, _ = JD.sample_time_symmetric(key_t, jbatch.num_graphs, jmodel.num_timesteps)
    eps, u = jax_draws(key_loss, jbatch, jmodel.num_classes)
    draws = (torch.from_numpy(np.asarray(t)).long(), eps, u)
    return {k: float(v) for k, v in metrics.items()}, model.net.state_dict(), batch, draws


@pytest.fixture(scope="module")
def runs():
    """(rank 0's results, rank 1's, one process's, the JAX step's metrics)."""
    jax_metrics, state_dict, batch, draws = _jax_step()
    args = (state_dict, batch, draws)
    ranks = pmesh.run_ranks(jobs.all_jobs, 2, "cpu", "gloo", args=args, timeout_s=TIMEOUT,
                            threads=1)
    return ranks[0], ranks[1], jobs.all_jobs(None, *args), jax_metrics


def _check_step(got, want):
    gm, wm = got["metrics"], want["metrics"]
    assert abs(gm["loss"] - wm["loss"]) <= LOSS_REL * abs(wm["loss"])
    assert abs(gm["grad_norm"] - wm["grad_norm"]) <= NORM_REL * wm["grad_norm"]
    for k in ("loss_pos", "loss_v"):
        assert gm[k] == pytest.approx(wm[k], rel=1e-5, abs=1e-7), k
    assert got["grads"].keys() == want["grads"].keys()
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for n, g in want["grads"].items():
        assert float((got["grads"][n] - g).abs().max()) <= GRAD_BAR * gmax, n
        sel = g.abs() > PARAM_G_FLOOR * gmax
        diff = (got["params"][n] - want["params"][n]).abs()[sel]
        assert float(diff.max()) <= PARAM_ABS if diff.numel() else True, n
    lt = want["Lt_history"]
    assert float((got["Lt_history"] - lt).abs().max()) <= LT_REL * float(lt.abs().max())
    assert torch.equal(got["Lt_count"], want["Lt_count"])


@pytest.mark.parametrize("case", jobs.TRAIN_CASES, ids=["-".join(c) for c in jobs.TRAIN_CASES])
def test_dp_train_step_matches_one_process(runs, case):
    r0, r1, one, _ = runs
    _check_step(r0["train"][case], one["train"][case])
    # the ranks applied the same gradients: their replicas stay bitwise equal
    for n, p in r0["train"][case]["params"].items():
        assert torch.equal(p, r1["train"][case]["params"][n]), n
    assert r0["train"][case]["metrics"] == r1["train"][case]["metrics"]


def test_dp_train_step_with_jax_draws_matches_the_jax_step(runs):
    r0, r1, one, jax_metrics = runs
    _check_step(r0["given_draws"], one["given_draws"])
    for k in ("loss", "grad_norm"):
        assert abs(r0["given_draws"]["metrics"][k] - jax_metrics[k]) <= JAX_REL * abs(
            jax_metrics[k]), k


@pytest.mark.parametrize("sampler", jobs.SAMPLERS)
def test_dp_sample_testset_matches_one_process(runs, sampler):
    r0, r1, one, _ = runs
    want = one["sample"][sampler]
    assert len(want) == 3 and all(len(p["pos"]) == 3 for p in want)
    for got in (r0["sample"][sampler], r1["sample"][sampler]):
        for g, w in zip(got, want, strict=True):
            for gp, gv, wp, wv in zip(g["pos"], g["v"], w["pos"], w["v"], strict=True):
                np.testing.assert_array_equal(gv, wv)
                np.testing.assert_allclose(gp, wp, **POS_TOL)
    for a, b in zip(r0["sample"][sampler], r1["sample"][sampler]):
        assert all(np.array_equal(x, y) for x, y in zip(a["pos"], b["pos"]))
        assert all(np.array_equal(x, y) for x, y in zip(a["v"], b["v"]))


def test_dp_validation_with_an_uneven_last_batch(runs):
    r0, r1, one, _ = runs
    assert r0["validation"] == r1["validation"]
    assert r0["validation"] == pytest.approx(one["validation"], rel=1e-6)


def test_gather_rows_assembles_every_rank_rows(runs):
    r0, r1, one, _ = runs
    for k, want in one["gather"].items():
        for got in (r0["gather"][k], r1["gather"][k]):
            assert got.dtype == want.dtype and torch.equal(got, want), k


def test_row_range_and_shard_rows():
    mesh = [pmesh.Mesh(r, 3, torch.device("cpu")) for r in range(3)]
    assert [pmesh.row_range(7, m) for m in mesh] == [(0, 2), (2, 4), (4, 7)]
    assert [pmesh.row_range(2, m) for m in mesh] == [(0, 0), (0, 1), (1, 2)]
    batch = jobs.small_batch(6, 0)
    parts = [pmesh.shard_rows(batch, m) for m in mesh]
    for f, field in enumerate(batch):
        assert torch.equal(torch.cat([p[f] for p in parts]), field)
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_rows(jobs.small_batch(4, 0), mesh[0])


def test_a_batch_that_does_not_split_raises(tmp_path):
    model = jobs.small_model()
    state = jobs.create_train_state(model, jobs.get_optimizer(jobs.Config(jobs.OPT),
                                                              model.parameters()))
    step = jobs.make_train_step(model, mesh=pmesh.Mesh(0, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="does not split"):
        step(state, jobs.small_batch(3, 0), torch.Generator().manual_seed(0))
    args = train_diffusion.parser().parse_args(
        ["unused.yml", "--device", "cpu", "--logdir", str(tmp_path), "--dist_coordinator",
         f"file://{tmp_path}/rdv", "--dist_num_processes", "2", "--dist_process_id", "0"])
    with pytest.raises(ValueError, match="does not split over 2"):
        train_diffusion.run(jobs.Config({"train": {"batch_size": 3}}), args)
    assert not os.path.exists(tmp_path / "rdv")  # raised before joining any group


def test_a_rank_that_raises_stops_the_run():
    t0 = time.monotonic()
    with pytest.raises((torch.multiprocessing.ProcessRaisedException,
                        torch.multiprocessing.ProcessExitedException)):
        pmesh.run_ranks(jobs.fail_on_rank_1, 2, "cpu", "gloo", timeout_s=120, threads=1)
    assert time.monotonic() - t0 < 120


_PEER = """
import sys, torch
from targetdiff_tpu_torch.parallel import mesh
rank = int(sys.argv[1])
mesh.init_distributed(sys.argv[2], 2, rank, "gloo", "cpu", timeout_s=60)
if rank == 1:
    raise SystemExit("rank 1 leaves")
torch.distributed.all_reduce(torch.ones(4))
print("rank 0 went on")
"""


def test_a_rank_whose_peer_dies_exits_nonzero(tmp_path):
    """Two processes started on their own, as a launcher starts them: rank 1
    leaves after joining, and rank 0's collective raises (it does not go
    on alone)."""
    rdv = f"file://{tmp_path}/rdv"
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-c", _PEER, str(r), rdv], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode != 0 for p in procs), outs
    assert "went on" not in outs[0]
    assert time.monotonic() - t0 < 120


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multi(capsys, world):
    """W = 4 splits the 6 sampling rows into chunks of 4 and 2: two ranks
    sample nothing in the second."""
    report = dryrun_multi.run(world, "cpu", "gloo", small=True, timeout_s=TIMEOUT, threads=1)
    assert f"dryrun_multi ok: dp={world}" in capsys.readouterr().out
    assert len(report["ranks"]) == world and report["backend"] == "gloo"
    for r in report["ranks"]:
        assert r["sample_pos_err"] <= POS_TOL["atol"]
        assert r["train_errs"]["loss_rel"] <= LOSS_REL
        assert r["all_reduce_bytes"] == 4 * sum(
            p.numel() for p in dryrun_multi.build(dryrun_multi.SMALL, "cpu", 64).parameters())


# ---- the CLIs over two processes ------------------------------------------------------

def _ranks(module, argv, tmp_path, world=2):
    """Run `python -m module argv` as `world` ranks; returns their outputs."""
    rdv = f"file://{tmp_path}/rdv_{module.rsplit('.', 1)[-1]}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--dist_coordinator", rdv,
         "--dist_num_processes", str(world), "--dist_process_id", str(r), "--dist_backend",
         "gloo"], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _logged(log_dir):
    text = open(os.path.join(log_dir, "log.txt")).read()
    return [float(x) for x in re.findall(r"\] iter \d+ loss ([-\d.]+)", text)]


def test_train_cli_two_processes_match_one(tmp_path):
    """Six-entry dataset, batch 2 (one complex a rank), 4 iterations with
    validation at 2 and 4: both ranks log the one-process run's train and
    validation losses, and rank 0 alone writes its checkpoints."""
    from tests.test_torch_data import _data_cfg, _mini_raw

    raw, split = _mini_raw(tmp_path)
    model = dict(jobs.SMALL, num_diffusion_timesteps=12, num_layers=1, hidden_dim=16,
                 n_heads=2, knn=6)
    cfg = {"data": _data_cfg(raw, split), "model": model,
           "train": {"seed": 1, "batch_size": 2, "max_iters": 4, "val_freq": 2,
                     "pos_noise_std": 0.1, "max_grad_norm": 8.0,
                     "optimizer": {"type": "adam", "lr": 1.0e-3, "weight_decay": 0,
                                   "beta1": 0.95, "beta2": 0.999},
                     "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10,
                                   "min_lr": 1.0e-6}}}
    cfg_path = tmp_path / "train.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    common = ["--device", "cpu", "--max_protein", "640", "--max_ligand", "40",
              "--train_report_iter", "1"]
    one = train_diffusion.main([str(cfg_path), "--logdir", str(tmp_path / "one"), *common])
    _ranks("targetdiff_tpu_torch.cli.train_diffusion",
           [str(cfg_path), "--logdir", str(tmp_path / "dp"), *common], tmp_path)
    dirs = sorted(os.listdir(tmp_path / "dp"))
    assert [d[-3:] for d in dirs] == ["_p0", "_p1"]
    want = _logged(one["log_dir"])
    assert len(want) == 6  # 4 train reports, 2 validations
    for d in dirs:
        np.testing.assert_allclose(_logged(tmp_path / "dp" / d), want, rtol=2e-5, atol=2e-4)
    ckpts = [sorted(f for f in os.listdir(tmp_path / "dp" / d) if f.endswith(".npz"))
             for d in dirs]
    assert ckpts[0] == sorted(os.path.basename(c) for c in one["checkpoints"]) and not ckpts[1]


def test_sample_cli_sharded_two_processes_match_one(tmp_path):
    """`sample_diffusion --all --sharded` on the six-entry dataset's two test
    pockets, 3 samples each in chunks of 2 rows, over two processes: rank 0
    writes the one-process result files (positions within 1e-5, types
    equal)."""
    from targetdiff_tpu.utils.checkpoint import save_checkpoint
    from targetdiff_tpu_torch.cli import sample_diffusion
    from tests.test_torch_data import _data_cfg, _mini_raw

    cfg, _, params, _, _, _ = small_setup()
    raw, split = _mini_raw(tmp_path)
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(str(ckpt), {"data": _data_cfg(raw, split), "model": dict(cfg)},
                    jax.device_get(params))
    sample_yml = tmp_path / "sampling.yml"
    sample_yml.write_text(f"model:\n  checkpoint: {ckpt}\nsample:\n  seed: 3\n  num_steps: 3\n"
                          "  num_samples: 3\n  sample_num_atoms: prior\n")
    common = [str(sample_yml), "--all", "--sharded", "--chunk_rows", "2", "--max_ligand", "8",
              "--device", "cpu"]
    sample_diffusion.main([*common, "--result_path", str(tmp_path / "one")])
    _ranks("targetdiff_tpu_torch.cli.sample_diffusion",
           [*common, "--result_path", str(tmp_path / "dp")], tmp_path)
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == ["result_0.pkl", "result_1.pkl"] == sorted(os.listdir(tmp_path / "dp"))
    for name in names:
        got, want = (pickle.loads((tmp_path / d / name).read_bytes()) for d in ("dp", "one"))
        for gp, gv, wp, wv in zip(got["pred_ligand_pos"], got["pred_ligand_v"],
                                  want["pred_ligand_pos"], want["pred_ligand_v"], strict=True):
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_allclose(gp, wp, **POS_TOL)
    with pytest.raises(SystemExit, match="--all --sharded"):
        sample_diffusion.main([str(sample_yml), "--device", "cpu", "--dist_num_processes", "2"])
