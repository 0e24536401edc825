"""Affinity-regressor quality gate of the port: counterpart of
tools/prop_quality_gate.py, with the same synthetic set-up and checks.

Phase 1, the supervised regressor: PropPredNet (EGNN encoder, the 3-way
Ki/Kd/IC50 head masked by kind) is trained on synthetic complexes whose
affinity is a function of their structure plus noise (a contact count,
protein atoms within 4.5 A of ligand atoms, and the ligand's heteroatom
fraction, standardized, plus N(0, 0.3) label noise; kinds planted
round-robin) and scored on a held-out split: Pearson, RMSE against the
label spread, trained against untrained RMSE, and each kind's Pearson.

Phase 2, the diffusion-derived features: the flagship denoiser is trained
on the same complexes (tools/quality_gate.py's `train`), each complex's nll
comes from `batch_likelihood_estimation` (the likelihood CLI's function)
and its final_h from `fetch_embedding`, both on the kernels (`impl='fast'`,
their plain versions on the CPU); PropPredNetEnc is trained on ligand
features + nll (graph) + final_h (node) and must still learn, and the nll
must rank pose quality unsupervised: 1 A jitter of the held-out ligands
raises it (AUROC).

`PROP_GATES` holds every limit; `prop_gate_checks` applies them.

Usage: python -m targetdiff_tpu_torch.tools.prop_quality_gate [epochs]
       [out.json] [diffusion_steps] [--device cuda]
(diffusion_steps 0 skips phase 2). Writes the report and exits 1 if a
check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli.likelihood_est_diffusion import batch_likelihood_estimation
from ..config import Config
from ..data.batch import ComplexBatch
from ..data.synth import synth_batch
from ..models.prop.prop_model import PropBatch, prop_loss_fn
from ..utils.misc_prop import get_eval_scores, get_prop_model
from ..utils.train import get_optimizer
from . import quality_gate as qg

NP_, NL = 128, 32
POOL, TEST = 448, 64
BATCH = 32
NOISE = 0.3  # label noise in std units -> Bayes RMSE floor
NUM_V, PROTEIN_DIM = 13, 27
# the limits of tools/prop_quality_gate.py's checks
PROP_GATES = dict(pearson_min=0.5, rmse_over_std_max=0.85, trained_over_untrained_max=0.7,
                  per_kind_pearson_min=0.35, enc_pearson_min=0.5, nll_auroc_min=0.8)
# the reduced flagship prop config (configs/prop/pdbbind_general_egnn.yml
# halved: the synthetic corpus is small and its pockets are 128 atoms)
ENCODER = dict(name="egnn", num_layers=3, hidden_dim=128, edge_dim=0, num_r_gaussian=20,
               act_fn="relu", norm=False, knn=24, cutoff=10.0)
OPTIMIZER = dict(type="adam", lr=5e-4, weight_decay=0, beta1=0.95, beta2=0.999,
                 max_grad_norm=8.0)
POS_NOISE_STD = 0.05


def make_dataset(seed=0, n=POOL + TEST):
    """Synthetic complexes, standardized structural affinity labels y and
    the contact term."""
    b = synth_batch(np.random.default_rng(seed), n, max_protein=NP_, max_ligand=NL)
    ppos, pmask, lpos, lv, lmask = (t.numpy() for t in (b.protein_pos, b.protein_mask,
                                                        b.ligand_pos, b.ligand_v, b.ligand_mask))
    contacts, hetero = np.zeros(n), np.zeros(n)
    for i in range(n):
        lp, pp = lpos[i][lmask[i]], ppos[i][pmask[i]]
        d = np.sqrt(((lp[:, None] - pp[None]) ** 2).sum(-1))
        contacts[i] = (d < 4.5).sum() / max(len(lp), 1)
        # add_aromatic classes 1 and 2 are carbon; every other one a heteroatom
        hetero[i] = (~np.isin(lv[i][lmask[i]], (1, 2))).mean()
    sig = ((contacts - contacts.mean()) / (contacts.std() + 1e-9) * 0.8
           + (hetero - hetero.mean()) / (hetero.std() + 1e-9) * 0.6)
    sig = (sig - sig.mean()) / (sig.std() + 1e-9)
    y = sig + np.random.default_rng(seed + 1).normal(0, NOISE, n)
    return b, y.astype(np.float32), contacts


def make_prop_batches(b: ComplexBatch, y, idx, enc_graph=None, enc_node=None, device="cpu",
                      batch=BATCH):
    """PropBatches of `batch` complexes over `idx` (a short tail is dropped):
    protein features as they are, ligand features the one-hot of the atom
    type, kind (index % 3) + 1; with enc_graph [n, Dg] / enc_node [n, N, Dn]
    the diffusion-feature fields."""
    lfeat = np.eye(NUM_V, dtype=np.float32)[b.ligand_v.numpy()]
    out = []
    for s in range(0, len(idx) - batch + 1, batch):
        sel = np.asarray(idx[s:s + batch])
        st = torch.as_tensor(sel)

        def take(a):
            return None if a is None else torch.as_tensor(np.asarray(a)[sel], device=device)

        out.append(PropBatch(
            protein_pos=b.protein_pos[st].to(device), protein_feat=b.protein_feat[st].to(device),
            protein_mask=b.protein_mask[st].to(device), ligand_pos=b.ligand_pos[st].to(device),
            ligand_feat=take(lfeat), ligand_mask=b.ligand_mask[st].to(device),
            y=take(y), kind=torch.as_tensor(sel % 3 + 1, device=device),
            enc_graph_feat=take(enc_graph), enc_node_feat=take(enc_node)))
    return out


def _eval(model, test_batches):
    model.eval()
    with torch.no_grad():
        ps = np.concatenate([model(tb).cpu().numpy() for tb in test_batches])
    ys = np.concatenate([tb.y.cpu().numpy() for tb in test_batches])
    kinds = np.concatenate([tb.kind.cpu().numpy() for tb in test_batches])
    per_kind = {name: get_eval_scores(ps[kinds == k], ys[kinds == k])
                for k, name in ((1, "Ki"), (2, "Kd"), (3, "IC50")) if (kinds == k).sum() >= 8}
    return get_eval_scores(ps, ys), per_kind


def train_eval_prop(model, batches_of, train_idx, test_idx, epochs, seed=3, log=print):
    """Train `model` for `epochs` over batches_of(permuted train_idx) with
    Adam (lr 5e-4, clip 8) and coordinate noise 0.05; returns the untrained
    and trained test scores, the trained per-kind scores and the host ms
    per step (ending in a synchronise)."""
    test_batches = batches_of(test_idx)
    dev = test_batches[0].protein_pos.device
    optimizer = get_optimizer(Config(OPTIMIZER), model.parameters())
    gen = torch.Generator(device=dev).manual_seed(seed)
    ev_untrained, _ = _eval(model, test_batches)
    rng = np.random.default_rng(seed)
    steps, t0 = 0, time.perf_counter()
    for ep in range(epochs):
        model.train()
        losses = []
        for tb in batches_of(rng.permutation(train_idx)):
            optimizer.zero_grad()
            loss, _ = prop_loss_fn(model, tb, POS_NOISE_STD, generator=gen)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            steps += 1
        if ep % 5 == 0 or ep == epochs - 1:
            log(f"  epoch {ep}: loss {float(torch.stack(losses).mean()):.4f} "
                f"({time.perf_counter() - t0:.0f}s)")
    qg._sync(dev)
    ms_per_step = 1e3 * (time.perf_counter() - t0) / max(steps, 1)
    ev, per_kind = _eval(model, test_batches)
    return ev_untrained, ev, per_kind, ms_per_step


def auroc(pos_scores, neg_scores) -> float:
    """P(pos > neg) by rank statistic (ties count one half)."""
    pos, neg = np.asarray(pos_scores, float), np.asarray(neg_scores, float)
    gt = (pos[:, None] > neg[None, :]).sum()
    eq = (pos[:, None] == neg[None, :]).sum()
    return float((gt + 0.5 * eq) / (len(pos) * len(neg)))


def _likelihood_ts(model):
    return np.linspace(0, model.num_timesteps - 1, 10).astype(np.int64)


def diffusion_features(b, diff_steps, device, log=print, batch=BATCH, **model_overrides):
    """The flagship (with `model_overrides`) trained `diff_steps` steps on
    the complexes, then each complex's nll (batch_likelihood_estimation) and
    final_h (fetch_embedding), both on the kernels, `batch` complexes a
    call. Returns (model, nll [n], final_h [n, NP_ + NL, hidden], train ms
    per step)."""
    model = qg.build_model(device, **model_overrides)
    log(f"training the diffusion model {diff_steps} steps for the enc features...")
    qg._sync(device)
    t0 = time.perf_counter()
    qg.train(model, b, diff_steps, log=log)
    qg._sync(device)
    train_ms = 1e3 * (time.perf_counter() - t0) / max(diff_steps, 1)
    model.eval()
    n = b.protein_pos.shape[0]
    nll = np.zeros(n)
    final_h = np.zeros((n, NP_ + NL, model.config.hidden_dim), np.float32)
    gen = torch.Generator(device=model.device).manual_seed(11)
    for s in range(0, n, batch):
        sel = torch.arange(s, min(s + batch, n))
        bc = ComplexBatch(*[t[sel].to(model.device) for t in b])
        nll[sel.numpy()], _, _ = batch_likelihood_estimation(model, bc, _likelihood_ts(model),
                                                             gen, impl="fast")
        final_h[sel.numpy()] = model.fetch_embedding(bc, impl="fast")["final_h"].cpu().numpy()
    return model, nll, final_h, train_ms


def distortion_nll_auroc(model, b, test_idx, sigma=1.0, batch=BATCH):
    """nll of the held-out ligands jittered by N(0, sigma) against intact:
    the unsupervised ranking check. Returns (auroc, mean intact nll, mean
    distorted nll)."""
    idx = torch.as_tensor(np.asarray(test_idx)[:batch])
    bc = ComplexBatch(*[t[idx].to(model.device) for t in b])
    jitter = np.random.default_rng(9).normal(0, sigma, tuple(bc.ligand_pos.shape))
    jitter = torch.as_tensor(jitter.astype(np.float32), device=model.device)
    bd = bc._replace(ligand_pos=bc.ligand_pos + jitter * bc.ligand_mask[..., None].float())
    ts = _likelihood_ts(model)
    nll_i, _, _ = batch_likelihood_estimation(
        model, bc, ts, torch.Generator(device=model.device).manual_seed(13), impl="fast")
    nll_d, _, _ = batch_likelihood_estimation(
        model, bd, ts, torch.Generator(device=model.device).manual_seed(13), impl="fast")
    return auroc(nll_d, nll_i), float(np.mean(nll_i)), float(np.mean(nll_d))


def prop_gate_checks(report: dict, g=PROP_GATES) -> dict:
    """tools/prop_quality_gate.py's checks on a report (phase 2's when the
    report has its fields)."""
    ev_t, ev_u, per_kind = report["trained"], report["untrained"], report["per_kind"]
    checks = {
        "pearson": ev_t["pearson"] >= g["pearson_min"],
        "beats_mean_predictor": ev_t["rmse"] <= g["rmse_over_std_max"] * report["y_std"],
        "learned": ev_t["rmse"] <= g["trained_over_untrained_max"] * ev_u["rmse"],
        "per_kind_heads": (len(per_kind) == 3 and all(
            v["pearson"] >= g["per_kind_pearson_min"] for v in per_kind.values())),
    }
    if "enc_trained" in report:
        checks["enc_pipeline_learns"] = report["enc_trained"]["pearson"] >= g["enc_pearson_min"]
        checks["nll_ranks_pose_quality"] = report["nll_distortion_auroc"] >= g["nll_auroc_min"]
    return checks


def run_prop_gate(epochs=30, diff_steps=1500, device="cuda", n=POOL + TEST, batch=BATCH,
                  log=print, **model_overrides) -> dict:
    """Both phases on `n` complexes, the last quarter of a permutation (at
    most TEST) held out, in batches of `batch`; the gate's own sizes unless a
    test asks for fewer, and the flagship denoiser with `model_overrides`.
    Returns the report with its checks and host times."""
    b, y, contacts = make_dataset(n=n)
    n_test = min(TEST, n // 4)
    order = np.random.default_rng(2).permutation(n)
    train_idx, test_idx = order[:-n_test], order[-n_test:]
    log("phase 1: PropPredNet (3-way Ki/Kd/IC50 head) ...")
    torch.manual_seed(0)
    model = get_prop_model(Config(dict(hidden_channels=128, encoder=ENCODER)), PROTEIN_DIM,
                           NUM_V).to(device)
    ev_u, ev_t, per_kind, ms = train_eval_prop(
        model, lambda idx: make_prop_batches(b, y, idx, device=device, batch=batch), train_idx,
        test_idx, epochs, log=log)
    report = {"untrained": ev_u, "trained": ev_t, "per_kind": per_kind,
              "y_std": float(np.std(y[test_idx])), "label_noise": NOISE, "epochs": epochs,
              "timing": {"prop_train_ms_per_step": ms}}
    if diff_steps > 0:
        log("phase 2: diffusion-derived enc features ...")
        dmodel, nll, final_h, dms = diffusion_features(b, diff_steps, device, log=log,
                                                       batch=batch, **model_overrides)
        enc_graph = ((nll - nll.mean()) / (nll.std() + 1e-9))[:, None].astype(np.float32)
        torch.manual_seed(0)
        model_enc = get_prop_model(
            Config(dict(hidden_channels=128, encoder=dict(ENCODER, name="egnn_enc"),
                        enc_graph_dim=1, enc_node_dim=final_h.shape[-1])), PROTEIN_DIM,
            NUM_V).to(device)
        ev_enc_u, ev_enc, _, enc_ms = train_eval_prop(
            model_enc, lambda idx: make_prop_batches(b, y, idx, enc_graph, final_h, device, batch),
            train_idx, test_idx, epochs, log=log)
        auc, nll_i, nll_d = distortion_nll_auroc(dmodel, b, test_idx, batch=batch)
        report.update(enc_untrained=ev_enc_u, enc_trained=ev_enc, nll_distortion_auroc=auc,
                      nll_intact_mean=nll_i, nll_distorted_mean=nll_d,
                      nll_contact_pearson=float(np.corrcoef(nll, contacts)[0, 1]),
                      diffusion_steps=diff_steps)
        report["timing"].update(diffusion_train_ms_per_step=dms,
                                enc_train_ms_per_step=enc_ms)
    report["checks"] = prop_gate_checks(report)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("epochs", nargs="?", type=int, default=30)
    ap.add_argument("out", nargs="?", default="prop_quality_gate_torch.json")
    ap.add_argument("diffusion_steps", nargs="?", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run_prop_gate(args.epochs, args.diffusion_steps, args.device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    failed = [k for k, ok in report["checks"].items() if not ok]
    print("PROP GATE", "FAIL: " + ", ".join(failed) if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
