"""Likelihood (ELBO) estimation and embedding export for affinity prediction.

Usage: python -m targetdiff_tpu_torch.cli.likelihood_est_diffusion configs/sampling.yml
       [--split train|test] [--result_path ./likelihood] [--device cuda|cpu]

Counterpart of targetdiff_tpu/cli/likelihood_est_diffusion.py (reference:
scripts/likelihood_est_diffusion.py): for each complex, sums T * mean(KL_t)
over a strided timestep set plus the t = T prior terms (:18-64), and exports
the `fetch_embedding` hidden states (:86-109) to crossdocked_{split}.pkl
with the JAX CLI's fields. Complexes go `--batch_complexes` at a time: one
[C * n_t]-row call for the step terms and one [C]-row call for the prior.
The model picks the denoiser's path from the checkpoint's config
(`DiffusionModel.impl`): the kernels in float32 for the released uni_o2
architecture, for both the KL terms and the embedding, whose coordinates
stay frozen; the plain network for every other configuration (the EGNN
denoiser, the uni_o2 options off the kernels). A config the port does not
build is refused, and so is a time-embedding config, whose embedding export
has no time step (`fetch_embedding`). `main` reads the YAML config (PyYAML
is imported there only); `run` takes a Config built in code.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch

from ..config import load_config
from ..data.batch import ComplexBatch
from ..data.datasets import collate_padded, get_dataset
from ..data.transforms import Compose, FeaturizeLigandAtom
from ..models.fast_forward import eager_supported
from ..utils.port import load_npz_config
from .common import require_device
from .sample_for_pocket import load_model_from_checkpoint


def batch_likelihood_estimation(model, batch_c: ComplexBatch, time_steps, generator,
                                impl=None, pos_noise=None, v_uniform=None):
    """nll estimates for a batch of C complexes in two calls: one
    [C * n_t]-row call for the strided step terms (complex-major rows) and
    one [C]-row call for the t = T prior terms (JAX :43-76). pos_noise
    [C * n_t, NL, 3] and v_uniform [C * n_t, NL, classes] may be given, else
    they are drawn from `generator`. impl as in
    DiffusionModel.likelihood_estimation. Returns (nll [C], kl_pos [C, n_t],
    kl_v [C, n_t]) as numpy."""
    C, n_t = batch_c.num_graphs, len(time_steps)
    rep = ComplexBatch(*[f.repeat_interleave(n_t, dim=0) for f in batch_c])
    t = torch.as_tensor(list(time_steps), dtype=torch.long, device=batch_c.device).repeat(C)
    kl_pos, kl_v = model.likelihood_estimation(rep, t, pos_noise=pos_noise, v_uniform=v_uniform,
                                               generator=generator, impl=impl)
    kl_pos = kl_pos.cpu().numpy().reshape(C, n_t)
    kl_v = kl_v.cpu().numpy().reshape(C, n_t)
    T = model.num_timesteps
    t_prior = torch.full((C,), T, dtype=torch.long, device=batch_c.device)
    kl_pos_prior, kl_v_prior = model.likelihood_estimation(batch_c, t_prior, impl=impl)
    nll = (T * (kl_pos.mean(axis=1) + kl_v.mean(axis=1)) + kl_pos_prior.cpu().numpy()
           + kl_v_prior.cpu().numpy())
    return nll, kl_pos, kl_v


def data_likelihood_estimation(model, batch_one: ComplexBatch, time_steps, generator,
                               impl=None):
    """nll estimate for one complex (reference: likelihood_est_diffusion.py:
    18-64). Returns (nll, kl_pos [n_t], kl_v [n_t])."""
    nll, kl_pos, kl_v = batch_likelihood_estimation(model, batch_one, time_steps, generator,
                                                    impl=impl)
    return float(nll[0]), kl_pos[0], kl_v[0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--split", default="test", choices=["train", "test"])
    ap.add_argument("--result_path", default="./likelihood")
    ap.add_argument("--t_stride", type=int, default=100)
    ap.add_argument("--max_protein", type=int, default=640)
    ap.add_argument("--max_ligand", type=int, default=64)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--batch_complexes", type=int, default=8,
                    help="complexes per call")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _export_rows(batch_items, nll, kl_pos, kl_v, emb, batch_c):
    """One record per real complex of the batch, unpadded (JAX :131-160)."""
    emb_h = emb["final_ligand_h"].cpu().numpy()
    emb_full = emb["final_h"].cpu().numpy()  # [C, NP + NL, H] composed order
    emb_v = torch.softmax(emb["pred_ligand_v"], dim=-1).cpu().numpy()
    lmask = batch_c.ligand_mask.cpu().numpy()
    pmask = batch_c.protein_mask.cpu().numpy()
    NP = pmask.shape[1]
    out = []
    for bi, (_, d) in enumerate(batch_items):
        nl, npr = int(lmask[bi].sum()), int(pmask[bi].sum())
        out.append({
            "ligand_filename": d.get("ligand_filename"),
            "protein_filename": d.get("protein_filename"),
            "nll": float(nll[bi]),
            "kl_pos": kl_pos[bi],
            "kl_v": kl_v[bi],
            # the real protein rows, then the ligand rows after the padded protein
            "final_h": np.concatenate([emb_full[bi, :npr], emb_full[bi, NP:NP + nl]], axis=0),
            "final_ligand_h": emb_h[bi, :nl],
            "pred_ligand_v": emb_v[bi, :nl],
        })
    return out


def run(config, args) -> str:
    """Estimate and export as `config` (model.checkpoint, sample.seed) and
    `args` say. Returns the path of the pickle written."""
    require_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("likelihood")
    ckpt = config.model.checkpoint
    model_cfg = load_npz_config(ckpt).model
    ok, reason = eager_supported(model_cfg)
    if not ok:
        raise SystemExit(f"the port does not build this checkpoint's model ({reason})")
    if model_cfg.get("time_emb_dim", 0) > 0:
        raise SystemExit("this checkpoint's model embeds the time step, and the embedding "
                         "export (fetch_embedding) passes none")
    os.makedirs(args.result_path, exist_ok=True)
    model, train_config, protein_feat = load_model_from_checkpoint(
        ckpt, args.device, args.max_protein, args.max_ligand)
    transform = Compose([protein_feat,
                         FeaturizeLigandAtom(train_config.data.transform.ligand_atom_mode)])
    _, subsets = get_dataset(train_config.data, transform=transform)
    dset = subsets[args.split]
    time_steps = list(range(0, model.num_timesteps, args.t_stride))
    seed = int(config.sample.seed)

    n = len(dset) if not args.limit else min(args.limit, len(dset))
    C = max(1, args.batch_complexes)
    out, batch_items = [], []  # (index, data dict)
    for i in range(n):
        try:
            batch_items.append((i, dset[i]))
        except Exception as e:
            logger.info(f"skip {i}: {e}")
        if not (len(batch_items) == C or (i == n - 1 and batch_items)):
            continue
        # pad the batch to C complexes by repeating the last; extras are dropped
        ds = [d for _, d in batch_items]
        n_real = len(ds)
        batch_c = collate_padded(ds + [ds[-1]] * (C - n_real), args.max_protein,
                                 args.max_ligand, device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(seed + batch_items[0][0])
        nll, kl_pos, kl_v = batch_likelihood_estimation(model, batch_c, time_steps, gen)
        emb = model.fetch_embedding(batch_c)
        out.extend(_export_rows(batch_items, nll, kl_pos, kl_v, emb, batch_c))
        logger.info(f"{len(out)} complexes done, last nll {float(nll[n_real - 1]):.1f}")
        batch_items = []

    path = os.path.join(args.result_path, f"crossdocked_{args.split}.pkl")
    with open(path, "wb") as f:
        pickle.dump(out, f)
    logger.info(f"saved {len(out)} entries -> {path}")
    return path


def main(argv=None):
    args = parser().parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
