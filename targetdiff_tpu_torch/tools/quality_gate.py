"""Trained-against-untrained generation quality gate of the port:
counterpart of tools/quality_gate.py, with the same checks and limits.

The flagship architecture is trained on the synthetic corpus (data/synth.py:
aromatic rings, double bonds, S/P/Cl; 11 of the 13 add_aromatic classes),
then both the untrained and the trained weights sample test pockets through
`sampling.sample_testset` (the function behind `cli/sample_diffusion --all
--sharded`), and the molecules are scored by `cli.evaluate_diffusion.
evaluate_results` on a result_0.pkl written by the sampling CLI's writer:
stability, reconstruction, pair-distance, atom-type and bond-length JSDs
against the training corpus, aromatic-ring recovery and class coverage.

Usage: python -m targetdiff_tpu_torch.tools.quality_gate [train_steps]
       [n_sample] [out.json] [num_steps] [--device cuda]
Writes the report to out.json (default quality_gate_torch.json) and exits 1
if any check fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from ..chem.reconstruct import MolReconsError, reconstruct_from_generated
from ..cli.evaluate_diffusion import evaluate_results
from ..cli.sample_diffusion import write_result
from ..config import Config
from ..data.batch import ComplexBatch
from ..data.synth import synth_batch
from ..data.transforms import get_atomic_number_from_index, is_aromatic_from_index
from ..evaluation import analyze, eval_bond_length
from ..models.score_model import DiffusionModel
from ..sampling import sample_testset
from ..trainer import create_train_state, make_train_step
from ..utils.train import get_optimizer

NP_, NL = 128, 32  # pocket/ligand padding (synthetic pockets 96-128 atoms)
BATCH = 32
CHUNK_ROWS = 100  # pocket x sample rows per sampling chunk (sample_testset's default)
ATOM_MODE = "add_aromatic"
PROTEIN_FEAT_DIM, NUM_CLASSES = 27, 13

# the released TargetDiff config (__graft_entry__._flagship, reference:
# configs/training.yml:9-42): uni_o2, 1 block x 9 layers, hidden 128, 16
# heads, kNN 32, global edge weights
FLAGSHIP = dict(
    model_mean_type="C0", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    v_beta_schedule="cosine", v_beta_s=0.01, num_diffusion_timesteps=1000,
    loss_v_weight=100.0, sample_time_method="symmetric", time_emb_dim=0,
    time_emb_mode="simple", center_pos_mode="protein", node_indicator=True,
    model_type="uni_o2", num_blocks=1, num_layers=9, hidden_dim=128, n_heads=16,
    edge_feat_dim=4, num_r_gaussian=20, knn=32, num_node_types=8, act_fn="relu",
    norm=True, cutoff_mode="knn", ew_net_type="global", num_x2h=1, num_h2x=1,
    r_max=10.0, x2h_out_fc=False, sync_twoup=False,
)
OPTIMIZER = dict(type="adam", lr=5e-4, weight_decay=0, beta1=0.95, beta2=0.999,
                 max_grad_norm=8.0)


def build_model(device="cuda", seed=1, **overrides) -> DiffusionModel:
    """The flagship (with `overrides` to its config) at the gate's padding,
    its weights drawn from `seed` (the JAX gate initialises from key 1)."""
    torch.manual_seed(seed)
    return DiffusionModel(Config(dict(FLAGSHIP, **overrides)), PROTEIN_FEAT_DIM, NUM_CLASSES,
                          device=device, max_protein=NP_, max_ligand=NL)


def make_pool(seed=0, pool=1024) -> ComplexBatch:
    rng = np.random.default_rng(seed)
    return synth_batch(rng, pool, max_protein=NP_, max_ligand=NL)


def train(model, pool, steps, seed=1, impl="fast", log=print):
    """`steps` Adam steps at batch BATCH drawn from `pool` (indices from
    numpy's generator `seed` + 2, as the JAX gate draws them). Returns copies
    of the untrained and the trained state_dicts and the loss every 200
    steps."""
    state = create_train_state(model, get_optimizer(Config(OPTIMIZER), model.parameters()))
    # the optimizer updates the parameters in place: copy them first
    untrained = copy.deepcopy(model.net.state_dict())
    step_fn = make_train_step(model, pos_noise_std=0.1, impl=impl)
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    pool_d = pool.to(model.device)
    P = pool.protein_pos.shape[0]
    rng = np.random.default_rng(seed + 2)
    t0 = time.time()
    loss_hist = []
    for i in range(steps):
        sel = torch.as_tensor(rng.integers(0, P, BATCH), device=model.device)
        state, metrics = step_fn(state, ComplexBatch(*[t[sel] for t in pool_d]), gen)
        if i % 200 == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            loss_hist.append(loss)
            log(f"  step {i}: loss {loss:.4f} ({time.time() - t0:.0f}s)")
    return untrained, copy.deepcopy(model.net.state_dict()), loss_hist


def sample(model, state_dict, pool, n_mols, seed=3, num_steps=1000, n_pockets=32,
           sampler="ddpm", eta=0.0, ddim_spacing="uniform"):
    """n_mols ligands from `state_dict` through `sampling.sample_testset`:
    the first n_pockets pockets of the pool, n_mols / n_pockets samples each,
    ligand sizes those of the pocket's own ligand ('ref'), `num_steps` steps
    of `sampler` (sampler, eta, ddim_spacing as in
    DiffusionModel.sample_diffusion). Returns the molecules and the sampling
    seconds."""
    model.net.load_state_dict(state_dict)
    S = -(-n_mols // n_pockets)
    pp, pf, pm, lm = (t.cpu().numpy() for t in (pool.protein_pos, pool.protein_feat,
                                                pool.protein_mask, pool.ligand_mask))
    pockets = [{"protein_pos": pp[i][pm[i]], "protein_feat": pf[i][pm[i]]}
               for i in range(n_pockets)]
    res = sample_testset(model, pockets, S, torch.Generator(device=model.device).manual_seed(seed),
                         num_steps=num_steps, sample_num_atoms="ref",
                         ref_sizes=[int(lm[i].sum()) for i in range(n_pockets)],
                         max_protein=NP_, max_ligand=NL, chunk_rows=CHUNK_ROWS,
                         sampler=sampler, eta=eta, ddim_spacing=ddim_spacing)
    mols = [{"pos": pos, "v": v} for entry in res for pos, v in zip(entry["pos"], entry["v"])]
    return mols[:n_mols], sum(entry["time"] for entry in res)


def _atom_type_jsd(counter, train_counter):
    """JSD between two atomic-number histograms over the union of elements
    (the reference's eval_atom_type.eval_atom_type_distribution, against the
    training corpus instead of the frozen CrossDocked distribution)."""
    keys = sorted(set(train_counter) | set(counter))
    p = np.array([counter.get(k, 0) for k in keys], float)
    q = np.array([train_counter.get(k, 0) for k in keys], float)
    if p.sum() == 0 or q.sum() == 0:
        return None
    return float(analyze.js_divergence(p / p.sum(), q / q.sum()))


def _bond_jsd(bond_profile, train_bond_profile, train_counts=None, min_frac=0.03):
    """JSD over the bond types present in both profiles. With train_counts,
    the mean is weighted by the training corpus's bond-type frequency and
    types below min_frac of all training bonds are dropped: a handful of
    rare-type bonds would otherwise dominate the mean with histogram noise."""
    common = [bt for bt in train_bond_profile if bt in bond_profile]
    if train_counts:
        total = sum(train_counts.values())
        common = [bt for bt in common if train_counts.get(bt, 0) >= min_frac * total]
    if not common:
        return None, {}
    detail = {eval_bond_length._bond_type_str(bt):
              float(analyze.js_divergence(bond_profile[bt], train_bond_profile[bt]))
              for bt in common}
    if train_counts:
        w = np.array([train_counts[bt] for bt in common], float)
        vals = np.array([detail[eval_bond_length._bond_type_str(bt)] for bt in common])
        return float((w * vals).sum() / w.sum()), detail
    return float(np.mean(list(detail.values()))), detail


def evaluate(mols, profiles):
    """Score molecules through the evaluation CLI's `evaluate_results` on a
    result_0.pkl written by the sampling CLI's writer, and compare its raw
    profiles with the training corpus's. Only MolReconsError counts as a
    failed reconstruction inside evaluate_results; any other exception
    propagates and fails the gate."""
    with tempfile.TemporaryDirectory() as td:
        fpath = os.path.join(td, "result_0.pkl")
        write_result(fpath, [np.asarray(m["pos"]) for m in mols],
                     [np.asarray(m["v"]) for m in mols], ATOM_MODE)
        summary, _results = evaluate_results([fpath], ATOM_MODE,
                                             logger=logging.getLogger("gate-eval"))

    prof = summary["pair_length_profile"]
    jsd = {k: analyze.js_divergence(prof[k], profiles["pair"][k])
           for k in profiles["pair"] if k in prof}
    bond_jsd, bond_detail = _bond_jsd(summary["bond_length_profile"], profiles["bond"],
                                      train_counts=profiles.get("bond_counts"))
    classes = Counter()
    for m in mols:
        classes.update(int(x) for x in m["v"])
    v = summary["validity"]
    return {
        "mol_stable": v["mol_stable"],
        "atom_stable": v["atm_stable"],
        "recon_success": v["recon_success"],
        "completeness": v["completeness"],
        "ring_recovery": summary["aromatic_ring_recovery"],
        "n_aromatic_predicted": summary["n_aromatic_predicted"],
        "n_classes": len(classes),
        "class_counts": {int(k): int(c) for k, c in sorted(classes.items())},
        "pair_jsd_vs_train": float(np.mean(list(jsd.values()))) if jsd else None,
        "pair_jsd_detail": {k: float(x) for k, x in jsd.items()},
        "atom_type_jsd_vs_train": _atom_type_jsd(summary["atom_type_counts"], profiles["atom"]),
        "bond_jsd_vs_train": bond_jsd,
        "bond_jsd_detail": bond_detail,
        "qed_mean": summary["qed_mean"],
        "sa_mean": summary["sa_mean"],
        "n": len(mols),
    }


def corpus_mols(pool, n=256):
    lp, lv, lm = (t.cpu().numpy() for t in (pool.ligand_pos, pool.ligand_v, pool.ligand_mask))
    return [{"pos": lp[i][lm[i]], "v": lv[i][lm[i]]} for i in range(min(n, len(lp)))]


def train_profile(pool, n=256):
    """Pair-distance, atom-type and bond-length profiles of the synthetic
    training ligands. Bonds come from the same reconstruction the sampled
    molecules go through (the evaluation's aromatic-flagged path), so the
    bond JSD compares like with like."""
    pair = []
    atoms = Counter()
    bonds = []
    for m in corpus_mols(pool, n):
        z = get_atomic_number_from_index(m["v"], ATOM_MODE)
        arom = is_aromatic_from_index(m["v"], ATOM_MODE)
        pair += eval_bond_length.pair_distance_from_pos_v(m["pos"], z)
        atoms.update(int(zz) for zz in z)
        try:
            mol = reconstruct_from_generated(m["pos"], z, arom, basic_mode=False)
            bonds += eval_bond_length.bond_distance_from_mol(mol)
        except MolReconsError:
            pass
    return {
        "pair": eval_bond_length.get_pair_length_profile(pair),
        "atom": atoms,
        "bond": eval_bond_length.get_bond_length_profile(bonds),
        "bond_counts": Counter(eval_bond_length._format_bond_type(bt) for bt, _ in bonds),
    }


# The limits of tools/quality_gate.py, unchanged: margins the trained model
# must beat the untrained one by, and absolute floors pinned below the JAX
# package's measured trained runs on this corpus (its aromatic rings cap
# molecule stability: the corpus itself scores ~0.58; the recon margin is
# capped because untrained geometry already reconstructs often).
GATES = dict(
    mol_stable_margin=0.08,
    atom_stable_margin=0.15,
    recon_margin=0.15,
    recon_margin_cap=0.95,
    jsd_improvement=0.05,
    mol_stable_floor=0.15,
    atom_stable_floor=0.80,
    recon_floor=0.90,
    atom_jsd_improvement=0.05,
    atom_jsd_ceiling=0.15,
    bond_jsd_ceiling=0.35,
    arom_predicted_min=10,
    ring_recovery_floor=0.50,
    n_classes_min=8,
)


def gate_checks(ev_u, ev_t, g=GATES):
    """Every gate comparison of trained (ev_t) against untrained (ev_u), as
    named booleans."""
    return {
        "mol_stable": ev_t["mol_stable"] >= ev_u["mol_stable"] + g["mol_stable_margin"],
        "atom_stable": ev_t["atom_stable"] >= ev_u["atom_stable"] + g["atom_stable_margin"],
        "recon": ev_t["recon_success"]
        >= min(ev_u["recon_success"] + g["recon_margin"], g["recon_margin_cap"]),
        "jsd": (ev_u["pair_jsd_vs_train"] or 1) - (ev_t["pair_jsd_vs_train"] or 1)
        >= g["jsd_improvement"],
        "mol_stable_floor": ev_t["mol_stable"] >= g["mol_stable_floor"],
        "atom_stable_floor": ev_t["atom_stable"] >= g["atom_stable_floor"],
        "recon_floor": ev_t["recon_success"] >= g["recon_floor"],
        # atom-type JSD: beats untrained (uniform types) and is small
        "atom_type_jsd": (
            ev_t["atom_type_jsd_vs_train"] is not None
            and ev_t["atom_type_jsd_vs_train"] <= g["atom_jsd_ceiling"]
            and (ev_u["atom_type_jsd_vs_train"] is None
                 or ev_t["atom_type_jsd_vs_train"]
                 <= ev_u["atom_type_jsd_vs_train"] - g["atom_jsd_improvement"])
        ),
        # bond-length JSD: untrained geometry may reconstruct too few bonds
        # for a stable profile, so this is a ceiling on the trained model
        "bond_jsd": (ev_t["bond_jsd_vs_train"] is not None
                     and ev_t["bond_jsd_vs_train"] <= g["bond_jsd_ceiling"]),
        # the trained model emits aromatic systems (type channel) and they
        # reconstruct to aromatic rings (geometry channel)
        "aromatics_emitted": ev_t["n_aromatic_predicted"] >= g["arom_predicted_min"],
        "ring_recovery": (ev_t["ring_recovery"] is not None
                          and ev_t["ring_recovery"] >= g["ring_recovery_floor"]),
        "class_coverage": ev_t["n_classes"] >= g["n_classes_min"],
    }


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_gate(steps, n_mols, device="cuda", num_steps=1000, n_pockets=32, pool_size=1024,
             corpus_n=256, log=print, **model_overrides):
    """The whole gate: the corpus self-score, `steps` training steps,
    sampling and scoring of the untrained and the trained weights, and the
    checks. Returns the report, with the loss curve and host times:
    train ms per step, sampling seconds and ms per DDPM step of one chunk of
    up to CHUNK_ROWS rows, and evaluation seconds."""
    model = build_model(device, **model_overrides)
    pool = make_pool(pool=pool_size)
    t0 = time.perf_counter()
    prof = train_profile(pool, corpus_n)
    ev_c = evaluate(corpus_mols(pool, corpus_n), prof)
    corpus_s = time.perf_counter() - t0
    log(f"corpus self-score: {json.dumps(ev_c)}")
    log(f"training {steps} steps on {pool.protein_pos.shape[0]} synthetic complexes...")
    _sync(device)
    t0 = time.perf_counter()
    untrained, trained, loss_hist = train(model, pool, steps, log=log)
    _sync(device)
    train_s = time.perf_counter() - t0
    chunks = -(-(n_pockets * -(-n_mols // n_pockets)) // CHUNK_ROWS)
    evs, timing = {}, {"train_seconds": train_s, "train_ms_per_step": 1e3 * train_s / steps,
                       "corpus_eval_seconds": corpus_s}
    for name, weights, seed in (("untrained", untrained, 3), ("trained", trained, 4)):
        log(f"sampling {name}...")
        mols, sample_s = sample(model, weights, pool, n_mols, seed=seed, num_steps=num_steps,
                                n_pockets=n_pockets)
        t0 = time.perf_counter()
        evs[name] = evaluate(mols, prof)
        timing[f"{name}_eval_seconds"] = time.perf_counter() - t0
        timing[f"{name}_sample_seconds"] = sample_s
        timing[f"{name}_sample_ms_per_step"] = 1e3 * sample_s / (chunks * num_steps)
    return {"corpus": ev_c, **evs, "loss_hist": loss_hist, "train_steps": steps,
            "n_pockets": n_pockets, "num_steps": num_steps, "chunk_rows": CHUNK_ROWS,
            "chunks": chunks, "timing": timing,
            "checks": gate_checks(evs["untrained"], evs["trained"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=12000)
    ap.add_argument("n_mols", nargs="?", type=int, default=256)
    ap.add_argument("out", nargs="?", default="quality_gate_torch.json")
    ap.add_argument("num_steps", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run_gate(args.steps, args.n_mols, args.device, args.num_steps)
    report["device"] = (torch.cuda.get_device_name(args.device)
                        if torch.device(args.device).type == "cuda" else args.device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    failed = [k for k, ok in report["checks"].items() if not ok]
    print("GATE", "FAIL: " + ", ".join(failed) if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
