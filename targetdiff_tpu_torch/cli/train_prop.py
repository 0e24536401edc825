"""Train the supervised binding-affinity regressor on PDBBind.

Usage: python -m targetdiff_tpu_torch.cli.train_prop configs/prop/pdbbind_general_egnn.yml
       [--device cuda|cpu] [--logdir ./logs_prop] [--max_protein 512] [--max_ligand 96]

Counterpart of targetdiff_tpu/cli/train_prop.py (reference:
scripts/property_prediction/train_prop.py): MSE training with
coordinate-noise augmentation, Adam behind global-norm clipping, the plateau
scheduler on the validation RMSE, per-kind (Ki/Kd/IC50) validation metrics
and a .npz checkpoint (utils/checkpoint.py, which the JAX package reads) at
each new best. The encoder 'egnn_enc' selects PropPredNetEnc, fed the
diffusion-derived features merged from `data.emb_path`. `main` reads the
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
from ..data.datasets import get_dataset
from ..data.transforms import Compose, FeaturizeProteinAtom
from ..data.transforms_prop import FeaturizeLigandAtomProp
from ..models.prop.prop_model import prop_loss_fn
from ..utils import train as train_utils
from ..utils.checkpoint import save_checkpoint
from ..utils.misc_prop import collate_prop, get_eval_scores, get_prop_model
from .common import require_device, run_logger

KINDS = ((1, "Ki"), (2, "Kd"), (3, "IC50"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--logdir", default="./logs_prop")
    ap.add_argument("--max_protein", type=int, default=512)
    ap.add_argument("--max_ligand", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def prop_transform() -> Compose:
    return Compose([FeaturizeProteinAtom(), FeaturizeLigandAtomProp()])


def build_model(config_model, device) -> torch.nn.Module:
    return get_prop_model(config_model, FeaturizeProteinAtom().feature_dim,
                          FeaturizeLigandAtomProp().feature_dim).to(device)


def enc_feature_type(config_model):
    """The diffusion features PropPredNetEnc reads, None for PropPredNet."""
    return (config_model.get("enc_feature_type") if config_model.encoder.name == "egnn_enc"
            else None)


def batches(dataset, bs: int, max_protein: int, max_ligand: int, enc_ft, device,
            shuffle: bool = False, seed: int = 0, skipped: dict = None,
            drop_last: bool = True):
    """Batches of the samples of `dataset` that load, fit the padding and,
    for PropPredNetEnc, have their diffusion features
    (targetdiff_tpu/cli/train_prop.py: `batches`: full ones only, unless
    drop_last is False); skips are counted by reason in `skipped`."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    skipped = {} if skipped is None else skipped
    buf = []
    for i in order:
        try:
            s = dataset[int(i)]
        except Exception:  # a record that fails to load is skipped, as the reference
            skipped["error"] = skipped.get("error", 0) + 1
            continue
        if len(s["protein_pos"]) > max_protein or len(s["ligand_pos"]) > max_ligand:
            skipped["oversize"] = skipped.get("oversize", 0) + 1
            continue
        if enc_ft is not None and "final_h" not in s:
            skipped["no_emb"] = skipped.get("no_emb", 0) + 1
            continue
        buf.append(s)
        if len(buf) == bs:
            yield collate_prop(buf, max_protein, max_ligand, enc_feature_type=enc_ft,
                               device=device)
            buf = []
    if buf and not drop_last:
        yield collate_prop(buf, max_protein, max_ligand, enc_feature_type=enc_ft, device=device)


@torch.no_grad()
def predict(model, batch_iter):
    """(y, pred, kind) numpy arrays over the batches."""
    model.eval()
    ys, ps, kinds = [], [], []
    for batch in batch_iter:
        ps.append(model(batch).cpu().numpy())
        ys.append(batch.y.cpu().numpy())
        kinds.append(batch.kind.cpu().numpy())
    return tuple(map(np.concatenate, (ys, ps, kinds)))


def kind_scores(y, p, kinds) -> dict:
    """Scores of each affinity kind with more than two complexes."""
    return {name: get_eval_scores(p[kinds == k], y[kinds == k])
            for k, name in KINDS if (kinds == k).sum() > 2}


def run(config, args) -> dict:
    """Train as `config` says. Returns the log dir, the checkpoints written,
    the best validation RMSE, the last epoch's scores and the model."""
    device = require_device(args.device)
    seed = int(config.train.seed)
    torch.manual_seed(seed)
    log_dir = os.path.join(args.logdir, "prop_" + time.strftime("%Y_%m_%d__%H_%M_%S"))
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    logger = run_logger(log_dir, "train_prop")
    try:
        return _train(config, args, device, log_dir, logger)
    finally:
        for handler in logger.handlers[:]:
            handler.close()
            logger.removeHandler(handler)


def _train(config, args, device, log_dir, logger) -> dict:
    _, subsets = get_dataset(config.data, transform=prop_transform())
    train_set, val_set = subsets["train"], subsets["test"]
    logger.info(f"train {len(train_set)} val {len(val_set)}; device {device}")
    model = build_model(config.model, device)
    enc_ft = enc_feature_type(config.model)
    logger.info(f"parameters: {sum(p.numel() for p in model.parameters()):,}")
    opt_cfg = type(config)(dict(config.train.optimizer,
                                max_grad_norm=config.train.get("max_grad_norm", 0)))
    optimizer = train_utils.get_optimizer(opt_cfg, model.parameters())
    scheduler = train_utils.get_scheduler(config.train.scheduler, config.train.optimizer)
    gen = torch.Generator(device=device).manual_seed(int(config.train.seed))
    bs, mp, ml = config.train.batch_size, args.max_protein, args.max_ligand
    best_val, ckpts, scores, it = float("inf"), [], {}, 0
    for epoch in range(config.train.get("max_epochs", 100)):
        skipped = {}
        model.train()
        for batch in batches(train_set, bs, mp, ml, enc_ft, device, shuffle=True, seed=epoch,
                             skipped=skipped):
            optimizer.zero_grad()
            loss, _ = prop_loss_fn(model, batch, config.train.pos_noise_std, generator=gen)
            loss.backward()
            optimizer.step()
            it += 1
            if it % 100 == 0:
                logger.info(f"iter {it} loss {float(loss):.4f}")
        if epoch == 0 and skipped:
            logger.info(f"skipped training complexes: {skipped}")
        y, p, kinds = predict(model, batches(val_set, bs, mp, ml, enc_ft, device))
        scores = get_eval_scores(p, y)
        for name, s in kind_scores(y, p, kinds).items():
            logger.info(f"[val {name}] " + " ".join(f"{a} {b:.3f}" for a, b in s.items()))
        logger.info(f"[val] epoch {epoch} " + " ".join(f"{a} {b:.4f}" for a, b in scores.items()))
        scheduler.step(scores["rmse"], train_utils.get_learning_rate(optimizer))
        train_utils.set_learning_rate(optimizer, scheduler.lr)
        if scores["rmse"] < best_val:
            best_val = scores["rmse"]
            path = os.path.join(log_dir, f"prop_ckpt_{epoch}.npz")
            save_checkpoint(path, config, model, optimizer, scheduler.state_dict(), it)
            ckpts.append(path)
            logger.info(f"new best rmse {best_val:.4f}")
    return {"log_dir": log_dir, "checkpoints": ckpts, "best_val": best_val, "scores": scores,
            "iterations": it, "model": model}


def main(argv=None):
    args = parser().parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
