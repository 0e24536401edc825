"""The port's analyze_affinity against the JAX package's on the same
pickles: the same printed correlations of nll, type entropy and |h| with
pK, the same skips and the same refusal; and the port's likelihood export
read by both."""

import pickle

import numpy as np
import pytest

from targetdiff_tpu.cli import analyze_affinity as jax_analyze
from targetdiff_tpu_torch.cli import analyze_affinity


def _entries(n, seed=0, labels="map"):
    """n likelihood-export records with distinct ligand files, and a pK map
    (labels='map') or pK fields in the records (labels='inline'); a few
    labels missing or not positive (labels='partial')."""
    rng = np.random.default_rng(seed)
    entries, pk = [], {}
    for i in range(n):
        nl = int(rng.integers(5, 30))
        p = rng.random((nl, 13))
        entries.append({
            "ligand_filename": f"lig_{i}.sdf", "protein_filename": f"pocket_{i}.pdb",
            "nll": float(rng.normal(200, 40)), "kl_pos": rng.random(10), "kl_v": rng.random(10),
            "final_h": rng.normal(size=(nl + 40, 32)), "final_ligand_h": rng.normal(size=(nl, 32)),
            "pred_ligand_v": p / p.sum(-1, keepdims=True)})
        pk[f"lig_{i}.sdf"] = float(rng.uniform(2, 11))
    if labels == "inline":
        for e in entries:
            e["pk"] = pk[e["ligand_filename"]]
        pk = None
    elif labels == "partial":
        for name in list(pk)[:: 3]:
            pk[name] = -1.0
        del pk["lig_1.sdf"]
    return entries, pk


def _run_both(capsys, argv):
    outs = []
    for mod in (analyze_affinity, jax_analyze):
        mod.main(argv)
        outs.append(capsys.readouterr().out)
    return outs


def _write(tmp_path, entries, pk):
    path = tmp_path / "crossdocked_test.pkl"
    path.write_bytes(pickle.dumps(entries))
    argv = [str(path)]
    if pk is not None:
        (tmp_path / "pk.pkl").write_bytes(pickle.dumps(pk))
        argv += ["--affinity_pkl", str(tmp_path / "pk.pkl")]
    return argv


@pytest.mark.parametrize("labels", ["map", "inline", "partial"])
def test_analyze_affinity_prints_as_the_jax_cli(labels, tmp_path, capsys):
    entries, pk = _entries(24, seed=len(labels), labels=labels)
    got, want = _run_both(capsys, _write(tmp_path, entries, pk))
    assert got == want
    lines = got.splitlines()
    n = {"map": 24, "inline": 24, "partial": 24 - 8 - 1}[labels]
    assert lines[0] == f"{n} complexes" and len(lines) == 4
    assert [ln.split()[0] for ln in lines[1:]] == ["nll", "entropy", "h_norm"]


def test_analyze_affinity_refuses_too_few_labels_as_the_jax_cli(tmp_path):
    entries, pk = _entries(5)
    for name in list(pk)[2:]:
        del pk[name]
    argv = _write(tmp_path, entries, pk)
    with pytest.raises(SystemExit) as got:
        analyze_affinity.main(argv)
    with pytest.raises(SystemExit) as want:
        jax_analyze.main(argv)
    assert str(got.value) == str(want.value) == "not enough complexes with affinity labels"
    assert analyze_affinity.entropy_of(np.full((3, 4), 0.25)) == pytest.approx(np.log(4))


def test_port_likelihood_export_reads_in_both_analyzers(tmp_path, capsys):
    """The port's likelihood CLI on the CPU (train split of the six-entry
    dataset), its records given pK fields from a seed: JAX and the port's
    analyze_affinity print the same."""
    from targetdiff_tpu_torch.cli import likelihood_est_diffusion as cli
    from tests.test_torch_likelihood import EXPORT_FIELDS, _cli_setup

    yml = _cli_setup(tmp_path)
    path = cli.main([yml, "--split", "train", "--result_path", str(tmp_path / "out"),
                     "--device", "cpu", "--t_stride", "5", "--max_ligand", "40"])
    entries = pickle.loads(open(path, "rb").read())
    assert len(entries) == 4 and all(set(e) == EXPORT_FIELDS for e in entries)
    rng = np.random.default_rng(7)
    for e in entries:
        e["pk"] = float(rng.uniform(2, 11))
    got, want = _run_both(capsys, _write(tmp_path, entries, None))
    assert got == want and got.startswith("4 complexes")
