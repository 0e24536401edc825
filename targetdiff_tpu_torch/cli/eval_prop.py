"""Evaluate a trained affinity regressor on the PDBBind test split.

Usage: python -m targetdiff_tpu_torch.cli.eval_prop CKPT [--batch_size 16]
       [--max_protein 512] [--max_ligand 96] [--device cuda|cpu]

Counterpart of targetdiff_tpu/cli/eval_prop.py (reference:
scripts/property_prediction/eval_prop.py:29-89): rebuilds the model from
the checkpoint's config (the port's or the JAX package's .npz), predicts
every usable complex of the test split in batches and reports the overall
and per-kind scores.
"""

from __future__ import annotations

import argparse
import logging

from ..data.datasets import get_dataset
from ..utils.checkpoint import load_checkpoint
from ..utils.misc_prop import get_eval_scores
from .common import require_device
from .train_prop import batches, build_model, enc_feature_type, kind_scores, predict, prop_transform


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--max_protein", type=int, default=512)
    ap.add_argument("--max_ligand", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def run(args) -> dict:
    """Returns {'overall': scores, 'per_kind': {...}, 'n': complexes}."""
    logger = logging.getLogger("eval_prop")
    device = require_device(args.device)
    ck = load_checkpoint(args.ckpt, device=device)
    config = ck["config"]
    _, subsets = get_dataset(config.data, transform=prop_transform())
    model = build_model(config.model, device)
    model.load_state_dict(ck["state_dict"])
    enc_ft = enc_feature_type(config.model)
    # the last batch may be short: every usable complex is scored
    y, p, kinds = predict(model, batches(subsets["test"], args.batch_size, args.max_protein,
                                         args.max_ligand, enc_ft, device, drop_last=False))
    scores = get_eval_scores(p, y)
    logger.info("overall: " + " ".join(f"{a} {b:.4f}" for a, b in scores.items()))
    per_kind = kind_scores(y, p, kinds)
    for name, s in per_kind.items():
        logger.info(f"{name}: " + " ".join(f"{a} {b:.4f}" for a, b in s.items()))
    return {"overall": scores, "per_kind": per_kind, "n": len(y)}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s::%(name)s] %(message)s")
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
