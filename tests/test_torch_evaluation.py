"""The port's evaluation pipeline against the JAX package's on the same
molecules: stability (the port's Python valence count against the JAX
package's, which takes its C++ path where tdnative is built), the
distribution distances, the bond-length and atom-type profiles and JSDs, the
descriptors and `get_chem`, `evaluate_results` and the evaluation CLI, and
the resource files. The molecules are the first 64 ligands of
`synth_batch` (seed 2) and the example SDF ligands, as they are and jittered
by 0.3, 0.7 and 1.5 A, so that unstable atoms and failed reconstructions
occur. Floats agree within 1e-12, everything else exactly."""

import pickle
from collections import Counter
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from targetdiff_tpu.chem import crippen as jax_crippen
from targetdiff_tpu.chem import descriptors as jax_descriptors
from targetdiff_tpu.chem import reconstruct as jax_reconstruct
from targetdiff_tpu.chem import sascorer as jax_sascorer
from targetdiff_tpu.chem import sdf as jax_sdf
from targetdiff_tpu.cli import evaluate_diffusion as jax_evaluate
from targetdiff_tpu.evaluation import analyze as jax_analyze
from targetdiff_tpu.evaluation import eval_atom_type as jax_eval_atom_type
from targetdiff_tpu.evaluation import eval_bond_length as jax_eval_bond_length
from targetdiff_tpu.evaluation import scoring as jax_scoring
from targetdiff_tpu_torch.chem import crippen, descriptors, reconstruct, sascorer
from targetdiff_tpu_torch.cli import evaluate_diffusion
from targetdiff_tpu_torch.cli.sample_diffusion import write_result
from targetdiff_tpu_torch.data.synth import synth_batch
from targetdiff_tpu_torch.data.transforms import (FeaturizeLigandAtom,
                                                  get_atomic_number_from_index,
                                                  is_aromatic_from_index)
from targetdiff_tpu_torch.evaluation import analyze, eval_atom_type, eval_bond_length, scoring

REPO = Path(__file__).resolve().parents[1]
MODE = "add_aromatic"
JITTERS = (0.0, 0.3, 0.7, 1.5)
FLOAT_TOL = 1e-12


@lru_cache(maxsize=None)
def _clean_mols():
    """(pos, v) of the 64 synthetic ligands and the two example ligands."""
    b = synth_batch(np.random.default_rng(2), 64)
    lp, lv, lm = (t.numpy() for t in (b.ligand_pos, b.ligand_v, b.ligand_mask))
    mols = [(lp[i][lm[i]].astype(np.float64), lv[i][lm[i]]) for i in range(64)]
    for name in ("3ug2_ligand.sdf", "1h36_A_rec_1h36_r88_lig_tt_docked_0.sdf"):
        lig = jax_sdf.parse_sdf_file(str(REPO / "examples" / name))
        v = FeaturizeLigandAtom(MODE)({"ligand_element": lig["element"],
                                       "ligand_atom_feature": lig["atom_feature"],
                                       "ligand_hybridization": lig["hybridization"]})
        mols.append((np.asarray(lig["pos"], np.float64), v["ligand_atom_feature_full"]))
    return mols


@lru_cache(maxsize=None)
def _mols(jitter):
    rng = np.random.default_rng(int(jitter * 10))
    return [(pos + jitter * rng.normal(size=pos.shape), v) for pos, v in _clean_mols()]


def _all_mols():
    return [m for j in JITTERS for m in _mols(j)]


def _close(got, want, where="value"):
    """Equal structures: floats within FLOAT_TOL, everything else exactly."""
    if isinstance(want, dict):
        assert type(got) is type(want) and sorted(got, key=repr) == sorted(want, key=repr), where
        for k in want:
            _close(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype, where
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert isinstance(got, float), (where, got, want)
        assert abs(got - want) <= FLOAT_TOL or np.isnan(got) and np.isnan(want), (where, got, want)
    else:
        assert got == want, (where, got, want)


def _rebuild(pkg_reconstruct, pos, v):
    try:
        return pkg_reconstruct.reconstruct_from_generated(
            pos, get_atomic_number_from_index(v, MODE), is_aromatic_from_index(v, MODE))
    except pkg_reconstruct.MolReconsError:
        return None


@pytest.mark.parametrize("name", ["atom_type_distribution.json.gz",
                                  "bond_length_empirical.json.gz", "sa_fpscores.npz"])
def test_evaluation_resources_are_byte_copies(name):
    assert ((REPO / "targetdiff_tpu_torch" / "resources" / name).read_bytes()
            == (REPO / "targetdiff_tpu" / "resources" / name).read_bytes())


@pytest.mark.parametrize("jitter", JITTERS)
def test_check_stability_matches_the_jax_module(jitter):
    """The port counts valences in Python; the JAX module counts them in C++
    wherever tdnative builds (utils/native.py builds it with g++ on first
    use), so the two branches meet."""
    unstable = 0
    for pos, v in _mols(jitter):
        z = get_atomic_number_from_index(v, MODE)
        for hs in (False, True):
            got = analyze.check_stability(pos, z, hs=hs, return_nr_bonds=True)
            want = jax_analyze.check_stability(pos, z, hs=hs, return_nr_bonds=True)
            assert got[:3] == want[:3]
            np.testing.assert_array_equal(got[3], np.asarray(want[3]))
        unstable += not got[0]
    assert unstable > 0


def test_divergences_match_the_jax_module():
    rng = np.random.default_rng(0)
    for n in (3, 12, 101):
        p, q = rng.random(n), rng.random(n)
        p[rng.random(n) < 0.3] = 0.0
        for fn in ("kl_divergence", "js_divergence", "emd"):
            for a, b in ((p, q), (q, p), (p, p), (p, np.zeros(n))):
                got, want = getattr(analyze, fn)(a, b), getattr(jax_analyze, fn)(a, b)
                assert abs(got - want) <= FLOAT_TOL, (fn, n, got, want)


def test_bond_length_profiles_and_jsds_match_the_jax_module():
    pairs, bonds, jax_bonds = [], [], []
    for pos, v in _all_mols():
        z = get_atomic_number_from_index(v, MODE)
        got = eval_bond_length.pair_distance_from_pos_v(pos, z)
        _close(got, jax_eval_bond_length.pair_distance_from_pos_v(pos, z), "pairs")
        pairs += got
        mol, jmol = _rebuild(reconstruct, pos, v), _rebuild(jax_reconstruct, pos, v)
        assert (mol is None) == (jmol is None)
        if mol is not None:
            bonds += eval_bond_length.bond_distance_from_mol(mol)
            jax_bonds += jax_eval_bond_length.bond_distance_from_mol(jmol)
    _close(bonds, jax_bonds, "bonds")
    assert {bt[2] for bt, _ in bonds} >= {1, 2, 4}
    profile = eval_bond_length.get_bond_length_profile(bonds)
    _close(profile, jax_eval_bond_length.get_bond_length_profile(bonds), "bond profile")
    _close(eval_bond_length.eval_bond_length_profile(profile),
           jax_eval_bond_length.eval_bond_length_profile(profile), "bond JSD")
    pair_profile = eval_bond_length.get_pair_length_profile(pairs)
    _close(pair_profile, jax_eval_bond_length.get_pair_length_profile(pairs), "pair profile")
    _close(eval_bond_length.eval_pair_length_profile(pair_profile),
           jax_eval_bond_length.eval_pair_length_profile(pair_profile), "pair JSD")


def test_atom_type_jsd_matches_the_jax_module():
    counts = Counter()
    for pos, v in _clean_mols():
        counts += Counter(get_atomic_number_from_index(v, MODE))
    for counter in (counts, Counter({6: 5}), Counter({6: 10, 7: 3, 35: 1}), Counter()):
        got = eval_atom_type.eval_atom_type_distribution(counter)
        want = jax_eval_atom_type.eval_atom_type_distribution(counter)
        assert abs(got - want) <= FLOAT_TOL or (np.isnan(got) and np.isnan(want))


DESCRIPTORS = [(descriptors, jax_descriptors, name)
               for name in ("qed", "logp", "tpsa", "sa_score", "normalized_sa", "obey_lipinski")]
DESCRIPTORS += [(crippen, jax_crippen, "crippen_logp"), (sascorer, jax_sascorer, "sa_score_native"),
                (scoring, jax_scoring, "get_chem")]


@pytest.mark.parametrize("port_mod,jax_mod,name", DESCRIPTORS,
                         ids=[d[2] for d in DESCRIPTORS])
def test_descriptors_match_the_jax_modules(port_mod, jax_mod, name):
    n = 0
    for pos, v in _all_mols():
        mol, jmol = _rebuild(reconstruct, pos, v), _rebuild(jax_reconstruct, pos, v)
        if mol is None:
            continue
        _close(getattr(port_mod, name)(mol), getattr(jax_mod, name)(jmol), name)
        n += 1
    assert n > 100


def test_evaluate_results_and_cli_match_the_jax_module(tmp_path):
    """One result_0.pkl, written by the port's sampling-CLI writer, read by
    both packages' evaluate_results and evaluation CLIs: the same summary
    (raw profiles included) and the same per-molecule results."""
    mols = _all_mols()
    write_result(tmp_path / "result_0.pkl", [m[0] for m in mols], [m[1] for m in mols], MODE)
    got, got_results = evaluate_diffusion.evaluate_results([tmp_path / "result_0.pkl"], MODE)
    want, want_results = jax_evaluate.evaluate_results([tmp_path / "result_0.pkl"], MODE)
    _close(got, want, "summary")
    v = got["validity"]
    assert 0 < v["mol_stable"] < 1 and 0 < v["recon_success"] < 1
    assert got["aromatic_ring_recovery"] is not None and got["num_results"] > 50
    assert len(got_results) == len(want_results)
    for r, w in zip(got_results, want_results):
        assert r["smiles"] == w["smiles"]
        _close(r["chem_results"], w["chem_results"], "chem_results")

    evaluate_diffusion.main([str(tmp_path), "--out", str(tmp_path / "port.pkl")])
    jax_evaluate.main([str(tmp_path), "--out", str(tmp_path / "jax.pkl")])
    got, want = (pickle.loads((tmp_path / f).read_bytes()) for f in ("port.pkl", "jax.pkl"))
    _close(got["summary"], want["summary"], "metrics.pkl summary")
    for r, w in zip(got["results"], want["results"]):
        assert sorted(r) == sorted(w) and r["smiles"] == w["smiles"]
        _close(r["chem_results"], w["chem_results"], "metrics.pkl chem_results")


def test_evaluation_cli_refuses_docking(tmp_path):
    with pytest.raises(SystemExit):
        evaluate_diffusion.main([str(tmp_path), "--docking_mode", "vina_score"])
