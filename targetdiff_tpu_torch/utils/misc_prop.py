"""Affinity-prediction helpers, counterpart of targetdiff_tpu/utils/misc_prop.py
(reference: utils/misc_prop.py:9-64): regression metrics, the
diffusion-derived encoder features, batch assembly and the model factory.
The metrics are numpy and scipy, the same numbers as the JAX package's
sklearn calls (the card's machine has no sklearn)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.prop.prop_model import PropBatch, PropPredNet, PropPredNetEnc


def get_eval_scores(ypred, ytrue, verbose: bool = False) -> Dict[str, float]:
    """RMSE / MAE / R^2 / Pearson / Spearman (reference: utils/misc_prop.py:
    9-24), in float64."""
    from scipy import stats

    ypred = np.asarray(ypred, np.float64).ravel()
    ytrue = np.asarray(ytrue, np.float64).ravel()
    err = ytrue - ypred
    out = {"rmse": float(np.sqrt(np.mean(err ** 2))), "mae": float(np.mean(np.abs(err))),
           "r2": float(1.0 - np.sum(err ** 2) / np.sum((ytrue - ytrue.mean()) ** 2)),
           "pearson": float(stats.pearsonr(ytrue, ypred)[0]),
           "spearman": float(stats.spearmanr(ytrue, ypred)[0])}
    if verbose:
        print(" | ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def build_enc_features(sample: Dict, feature_type: str):
    """A sample's diffusion-derived features for `feature_type` from its
    merged export fields (reference: models/property_pred/prop_model.py:
    167-205). Returns (enc_ligand [NL, Dl] | None, enc_node [np+nl, Dn] |
    None, enc_graph [Dg] | None)."""
    lig = node = graph = None
    if feature_type == "nll":
        graph = sample["nll"]
    elif feature_type == "nll_all":
        graph = sample["nll_all"]
    elif feature_type == "final_h":
        node = sample["final_h"]
    elif feature_type == "pred_ligand_v":
        lig = sample["pred_ligand_v"]
    elif feature_type == "pred_v_entropy_pre":
        lig = sample["pred_v_entropy"]
    elif feature_type == "pred_v_entropy_post":
        graph = sample["pred_v_entropy"].sum(0)
    elif feature_type == "full":
        graph = np.concatenate([sample["nll_all"], sample["pred_v_entropy"].sum(0)])
        node = sample["final_h"]
        lig = np.concatenate([sample["pred_ligand_v"], sample["pred_v_entropy"]], axis=-1)
    else:
        raise NotImplementedError(feature_type)
    return lig, node, graph


def collate_prop(samples: List[Dict], max_protein: int, max_ligand: int,
                 enc_feature_type: Optional[str] = None, device="cpu") -> PropBatch:
    """Pad prop samples into a PropBatch on `device`. With enc_feature_type,
    the diffusion-derived features are padded alongside: node features
    follow the composed protein | ligand layout (protein rows at [0, np),
    ligand rows at [max_protein, max_protein + nl))."""
    B = len(samples)
    fp = samples[0]["protein_atom_feature"].shape[-1]
    fl = samples[0]["ligand_atom_feature_full"].shape[-1]
    ppos = np.zeros((B, max_protein, 3), np.float32)
    pfeat = np.zeros((B, max_protein, fp), np.float32)
    pmask = np.zeros((B, max_protein), bool)
    lpos = np.zeros((B, max_ligand, 3), np.float32)
    lfeat = np.zeros((B, max_ligand, fl), np.float32)
    lmask = np.zeros((B, max_ligand), bool)
    y = np.zeros((B,), np.float32)
    kind = np.ones((B,), np.int64)
    enc_l = enc_n = enc_g = None
    for i, s in enumerate(samples):
        np_, nl = len(s["protein_pos"]), len(s["ligand_pos"])
        if np_ > max_protein or nl > max_ligand:
            raise ValueError(f"sample {i} exceeds padding: protein {np_}>{max_protein} or "
                             f"ligand {nl}>{max_ligand}")
        ppos[i, :np_] = s["protein_pos"]
        pfeat[i, :np_] = s["protein_atom_feature"]
        pmask[i, :np_] = True
        lpos[i, :nl] = s["ligand_pos"]
        lfeat[i, :nl] = s["ligand_atom_feature_full"]
        lmask[i, :nl] = True
        y[i] = float(s.get("y", 0.0))
        kind[i] = int(s.get("kind", 1))
        if enc_feature_type is None:
            continue
        el, en, eg = build_enc_features(s, enc_feature_type)
        if el is not None:
            if enc_l is None:
                enc_l = np.zeros((B, max_ligand, el.shape[-1]), np.float32)
            enc_l[i, :nl] = el
        if en is not None:
            if enc_n is None:
                enc_n = np.zeros((B, max_protein + max_ligand, en.shape[-1]), np.float32)
            enc_n[i, :np_] = en[:np_]
            enc_n[i, max_protein:max_protein + nl] = en[np_:np_ + nl]
        if eg is not None:
            eg = np.asarray(eg, np.float32).ravel()
            if enc_g is None:
                enc_g = np.zeros((B, eg.shape[-1]), np.float32)
            enc_g[i] = eg

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return PropBatch(t(ppos), t(pfeat), t(pmask), t(lpos), t(lfeat), t(lmask), t(y), t(kind),
                     enc_ligand_feat=t(enc_l), enc_node_feat=t(enc_n), enc_graph_feat=t(enc_g))


def get_prop_model(config_model, protein_atom_feature_dim: int, ligand_atom_feature_dim: int,
                   output_dim: int = 3):
    """(reference: utils/misc_prop.py:45-64): encoder name 'egnn_enc'
    selects PropPredNetEnc with one regression head, else PropPredNet."""
    if config_model.encoder.name == "egnn_enc":
        return PropPredNetEnc(config_model, protein_atom_feature_dim, ligand_atom_feature_dim,
                              enc_ligand_dim=int(config_model.get("enc_ligand_dim", 0)),
                              enc_node_dim=int(config_model.get("enc_node_dim", 0)),
                              enc_graph_dim=int(config_model.get("enc_graph_dim", 0)),
                              output_dim=1)
    return PropPredNet(config_model, protein_atom_feature_dim, ligand_atom_feature_dim,
                       output_dim=output_dim)
