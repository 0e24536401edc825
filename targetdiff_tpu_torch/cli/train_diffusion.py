"""Train the pocket-conditioned diffusion model.

Usage: python -m targetdiff_tpu_torch.cli.train_diffusion configs/training.yml
       [--device cuda|cpu] [--logdir ./logs_diffusion] [--resume ckpt.npz]
       [--max_protein 640] [--max_ligand 64] [--train_report_iter 200]
       [--dtype f32|bf16] [--dist_coordinator HOST:PORT --dist_num_processes W --dist_process_id R
        [--dist_backend gloo|nccl]]

Counterpart of targetdiff_tpu/cli/train_diffusion.py (reference:
scripts/train_diffusion.py) with the same loop: protein-position noise,
Adam behind global-norm clipping, validation over 10 fixed timesteps with
the atom-type AUROC, a checkpoint at each new best validation loss, and
resume from a checkpoint. The training step runs the denoiser through the
block kernels and their backward (`DiffusionModel.get_diffusion_loss`,
impl='fast'), or through the plain network on a config the kernels do not
take, such as the EGNN denoiser: the model picks the path from its config.
--dtype bf16 trains the kernel path as the JAX package's bf16 training
variant (impl='fast_bf16': bf16 products in both directions, float32
parameters, optimizer and checkpoints; validation stays float32). On a
config that trains eagerly (EGNN, the uni_o2 options off the kernels) it
builds the bf16 model, `DiffusionModel(model_dtype=torch.bfloat16)`, and
trains it eagerly, as the JAX CLI's --dtype bf16 --impl xla: parameters,
optimizer state and checkpoints float32, validation in the bf16 model.
With the --dist_* flags, W processes train one model data parallel
(`parallel/mesh.py`, JAX's --dist_* flags): each builds the same global
batch from the same loader seed and computes its equal row slice, one card
a rank when the machine has a card for each (`mesh.rank_device`), all on
`cuda:0` when it has one; rank 0 alone writes checkpoints. `main` reads the
YAML config (PyYAML is imported there only); `run` takes a Config built in
code.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import load_config
from ..data.datasets import PaddedLoader, get_dataset, inf_iterator
from ..data.transforms import (
    Compose,
    FeaturizeLigandAtom,
    FeaturizeLigandBond,
    FeaturizeProteinAtom,
    RandomRotation,
)
from ..models.fast_forward import fast_forward_supported
from ..models.score_model import DiffusionModel
from ..parallel import mesh as pmesh
from ..trainer import atom_auroc, create_train_state, make_eval_step, make_train_step
from ..utils import train as train_utils
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .common import add_dist_args, multi_process, run_logger, start_mesh


def build_transform(cfg_data, seed: int = 0):
    protein_featurizer = FeaturizeProteinAtom()
    ligand_featurizer = FeaturizeLigandAtom(cfg_data.transform.ligand_atom_mode)
    tfs = [protein_featurizer, ligand_featurizer, FeaturizeLigandBond()]
    if cfg_data.transform.get("random_rot", False):
        tfs.append(RandomRotation(np.random.default_rng(seed)))
    return Compose(tfs), protein_featurizer, ligand_featurizer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--logdir", default="./logs_diffusion")
    ap.add_argument("--tag", default="")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--max_protein", type=int, default=640)
    ap.add_argument("--max_ligand", type=int, default=64)
    ap.add_argument("--train_report_iter", type=int, default=200)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="the denoiser's precision in training (parameters stay float32): "
                    "bf16 trains on the bf16 kernels (impl='fast_bf16'), or the bf16 "
                    "model eagerly where the config trains eagerly")
    add_dist_args(ap)
    return ap


def model_dtype(model_cfg, dtype: str) -> torch.dtype:
    """The model dtype for --dtype: bf16 where the config trains eagerly,
    else float32 (the kernels' bf16 variant takes its precision from impl)."""
    eager = not fast_forward_supported(model_cfg)[0]
    return torch.bfloat16 if dtype == "bf16" and eager else torch.float32


def train_impl(model: DiffusionModel, dtype: str) -> str:
    """The training step's impl for --dtype: the model's path, or for
    'bf16' on the kernel path its bf16 variant, 'fast_bf16'."""
    if dtype == "bf16" and model.impl == "fast":
        return "fast_bf16"
    return model.impl


def run(config, args) -> dict:
    """Train as `config` says. Returns the log dir, the checkpoints written,
    the best validation loss, the final TrainState and the last step's
    metrics. With the --dist_* flags, starts the process group, runs as one
    of its ranks and ends the group when the run ends."""
    world = args.dist_num_processes or 1
    if multi_process(args) and config.train.batch_size % world:  # before any rank joins
        raise ValueError(f"batch_size {config.train.batch_size} does not split over {world} "
                         "processes")
    device, mesh = start_mesh(args)
    try:
        seed = int(config.train.seed)
        torch.manual_seed(seed)
        tag = args.tag + (f"p{mesh.rank}" if mesh is not None else "")
        log_dir = os.path.join(args.logdir, "training_" + time.strftime("%Y_%m_%d__%H_%M_%S")
                               + (f"_{tag}" if tag else ""))
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=1)
        logger = run_logger(log_dir, "train_diffusion")
        try:
            return _train(config, args, device, log_dir, logger, mesh)
        finally:
            for handler in logger.handlers[:]:
                handler.close()
                logger.removeHandler(handler)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _train(config, args, device, log_dir, logger, mesh=None) -> dict:
    seed = int(config.train.seed)
    is_main = mesh is None or mesh.is_main
    logger.info(f"log dir: {log_dir}; device: {device}"
                + (f"; rank {mesh.rank} of {mesh.world}" if mesh is not None else ""))
    transform, protein_feat, ligand_feat = build_transform(config.data, seed)
    _, subsets = get_dataset(config.data, transform=transform)
    train_set, val_set = subsets["train"], subsets["test"]
    logger.info(f"train {len(train_set)} / val {len(val_set)}")
    bs = config.train.batch_size
    loader = PaddedLoader(train_set, bs, args.max_protein, args.max_ligand, shuffle=True,
                          seed=seed, device=device)
    val_loader = PaddedLoader(val_set, bs, args.max_protein, args.max_ligand, shuffle=False,
                              drop_last=False, device=device)
    train_iter = inf_iterator(loader)

    model = DiffusionModel(config.model, protein_feat.feature_dim, ligand_feat.feature_dim,
                           device=device, max_protein=args.max_protein,
                           max_ligand=args.max_ligand,
                           model_dtype=model_dtype(config.model, args.dtype))
    impl = train_impl(model, args.dtype)
    logger.info(f"training path: {impl}; model dtype: {model.model_dtype}")
    opt_cfg = dict(config.train.optimizer, max_grad_norm=config.train.max_grad_norm)
    optimizer = train_utils.get_optimizer(type(config)(opt_cfg), model.parameters())
    scheduler = train_utils.get_scheduler(config.train.scheduler, config.train.optimizer)
    state = create_train_state(model, optimizer)
    logger.info(f"parameters: {sum(p.numel() for p in model.parameters()):,}")

    start_iter = 1
    if args.resume:
        ck = load_checkpoint(args.resume, device=device)
        model.net.load_state_dict(ck["state_dict"])
        if ck["opt_state"] is not None:
            optimizer.load_state_dict(ck["opt_state"])
        if ck["scheduler"]:
            scheduler.load_state_dict(ck["scheduler"])
        state.step = ck["iteration"]
        start_iter = ck["iteration"] + 1
        logger.info(f"resumed from {args.resume} at iter {start_iter}")
    if mesh is not None:
        pmesh.replicate_state(model.net, optimizer, mesh)

    train_step = make_train_step(model, config.train.pos_noise_std, impl=impl, mesh=mesh)
    eval_step = make_eval_step(model, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    best_val, ckpts, metrics = float("inf"), [], {}
    it = start_iter
    try:
        while it <= config.train.max_iters:
            state, metrics = train_step(state, next(train_iter), gen)
            if it % args.train_report_iter == 0 or it == start_iter:
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(f"[train] iter {it} loss {m['loss']:.4f} pos {m['loss_pos']:.4f} "
                            f"v {m['loss_v']:.4f} grad {m['grad_norm']:.2f} "
                            f"lr {train_utils.get_learning_rate(optimizer):.2e}")
            if it % config.train.val_freq == 0:
                val_loss = validate(model, eval_step, val_loader, seed, logger, it)
                scheduler.step(val_loss, train_utils.get_learning_rate(optimizer))
                train_utils.set_learning_rate(optimizer, scheduler.lr)
                if val_loss < best_val:
                    best_val = val_loss
                    if is_main:  # rank 0 owns checkpoints
                        ckpt = os.path.join(log_dir, f"ckpt_{it}.npz")
                        save_checkpoint(ckpt, config, model.net, optimizer,
                                        scheduler.state_dict(), it)
                        ckpts.append(ckpt)
                        logger.info(f"[val] new best {val_loss:.4f} -> {ckpt}")
                    if mesh is not None:
                        pmesh.barrier(mesh)
            it += 1
    except KeyboardInterrupt:
        logger.info("interrupted; saving last checkpoint" if is_main else "interrupted")
        if is_main:
            ckpt = os.path.join(log_dir, f"ckpt_last_{it}.npz")
            save_checkpoint(ckpt, config, model.net, optimizer, scheduler.state_dict(), it)
            ckpts.append(ckpt)
        if mesh is not None:
            pmesh.barrier(mesh)
    return {"log_dir": log_dir, "checkpoints": ckpts, "best_val": best_val, "state": state,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def validate(model, eval_step, val_loader, seed, logger, it, num_t=10) -> float:
    """Loss at fixed timesteps and atom-type AUROC
    (reference: scripts/train_diffusion.py:153-208). With a data-parallel
    eval_step the losses and pred_v are global, so every rank returns the
    one-process value and the schedulers and "new best" agree."""
    ts = np.linspace(0, model.num_timesteps - 1, num_t).astype(np.int64)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    tot = tot_pos = tot_v = 0.0
    n = 0
    ys, ps, ms = [], [], []
    for batch in val_loader:
        for t in ts:
            out = eval_step(batch, int(t), gen)
            B = batch.num_graphs
            tot += float(out["loss"]) * B
            tot_pos += float(out["loss_pos"]) * B
            tot_v += float(out["loss_v"]) * B
            n += B
        ys.append(batch.ligand_v.cpu().numpy().ravel())
        probs = torch.softmax(out["pred_v"], -1)
        ps.append(probs.reshape(-1, probs.shape[-1]).cpu().numpy())
        ms.append(batch.ligand_mask.cpu().numpy().ravel())
    val_loss = tot / max(n, 1)
    auroc = atom_auroc(np.concatenate(ys), np.concatenate(ps), np.concatenate(ms))
    logger.info(f"[val] iter {it} loss {val_loss:.4f} pos {tot_pos / max(n, 1):.4f} "
                f"v {tot_v / max(n, 1):.4f} auroc {auroc:.4f}")
    return val_loss


def main(argv=None):
    args = parser().parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
