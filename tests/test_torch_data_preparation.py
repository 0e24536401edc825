"""The port's CrossDocked preparation (`cli/data_preparation`: clean,
pockets, split) against the JAX CLI on a CrossDocked-shaped tree built from
the examples: byte-equal index.pkl, extracted poses and pocket PDBs, and
equal split contents. Also the --help of every port CLI."""

import gzip
import importlib
import pickle
import pkgutil
import re
import shutil

import numpy as np
import pytest
import torch

import targetdiff_tpu_torch.cli as port_cli
from targetdiff_tpu.cli import data_preparation as jprep
from targetdiff_tpu_torch.cli import data_preparation as prep
from tests.test_torch_prop_cli import _SerialPool

LIG_1H36 = "examples/1h36_A_rec_1h36_r88_lig_tt_docked_0.sdf"
LIG_3UG2 = "examples/3ug2_ligand.sdf"


def _shifted(sdf_text: str, dx: float) -> str:
    """The molfile with every atom's x moved by dx (a second docked pose)."""
    lines = sdf_text.splitlines(keepends=True)
    n_atoms = int(lines[3][:3])
    for i in range(4, 4 + n_atoms):
        x = float(lines[i][:10]) + dx
        lines[i] = f"{x:10.4f}" + lines[i][10:]
    return "".join(lines)


def _pose_block(path: str, dx: float) -> str:
    text = open(path).read().split("$$$$")[0].rstrip("\n") + "\n"
    return _shifted(text, dx) + "$$$$\n"


def _crossdocked_tree(root):
    """CrossDocked2020-style source: receptors, gzipped multi-pose SDFs and a
    .types index with poses under and over the RMSD cut (1.0), one at it,
    a pose index past the file's poses, a missing receptor and a short
    line."""
    src = root / "crossdocked"
    (src / "1h36").mkdir(parents=True)
    (src / "3ug2").mkdir()
    shutil.copyfile("examples/1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb",
                    src / "1h36" / "1h36_A_rec.pdb")
    shutil.copyfile("examples/3ug2_protein.pdb", src / "3ug2" / "3ug2_rec.pdb")
    for rel, path, shifts in (("1h36/1h36_A_rec_1h36_r88_lig_tt_docked.sdf.gz", LIG_1H36,
                               (0.0, 0.8, -0.5)),
                              ("3ug2/3ug2_rec_3ug2_lig_tt_docked.sdf.gz", LIG_3UG2,
                               (0.0, 0.6))):
        with gzip.open(src / rel, "wt") as g:
            g.write("".join(_pose_block(path, dx) for dx in shifts))
    rec_1h36, rec_3ug2 = "1h36/1h36_A_rec_0.gninatypes", "3ug2/3ug2_rec_0.gninatypes"
    lig_1h36 = "1h36/1h36_A_rec_1h36_r88_lig_tt_docked_{}.gninatypes"
    lig_3ug2 = "3ug2/3ug2_rec_3ug2_lig_tt_docked_{}.gninatypes"
    lines = [f"1 -7.50 0.5012 {rec_1h36} {lig_1h36.format(0)}",
             f"0 -6.00 1.8400 {rec_1h36} {lig_1h36.format(1)}",
             f"1 -7.10 0.9000 {rec_1h36} {lig_1h36.format(2)}",
             f"1 -7.00 0.3000 {rec_1h36} {lig_1h36.format(5)}",
             f"1 -9.20 0.1000 {rec_3ug2} {lig_3ug2.format(0)}",
             f"1 -8.00 1.0000 {rec_3ug2} {lig_3ug2.format(1)}",
             "0 -5.00 0.4000 missing/x_rec_0.gninatypes missing/x_rec_y_lig_tt_docked_0.gninatypes",
             "1 -5.0"]
    types = root / "it2_tt_v1.1_completeset_train0.types"
    types.write_text("\n".join(lines) + "\n")
    return src, types


def _files(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def test_data_preparation_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jprep, "Pool", _SerialPool)
    src, types = _crossdocked_tree(tmp_path)
    outs = {}
    for name, mod in (("port", prep), ("jax", jprep)):
        clean, pockets = tmp_path / name / "clean", tmp_path / name / "pockets"
        mod.main(["clean", "--source", str(src), "--dest", str(clean), "--types_index",
                  str(types)])
        mod.main(["pockets", "--source", str(clean), "--dest", str(pockets), "--radius", "10",
                  "--num_workers", "1"])
        for n_test, size in ((1, 0), (1, 2), (5, 0)):
            mod.main(["split", "--path", str(pockets), "--dest",
                      str(tmp_path / name / f"split_{n_test}_{size}.pt"),
                      "--num_test_pockets", str(n_test), "--train_size", str(size),
                      "--seed", "7"])
        outs[name] = tmp_path / name
    files = _files(outs["jax"])
    assert files == _files(outs["port"])
    assert {"clean/index.pkl", "clean/1h36/1h36_A_rec_1h36_r88_lig_tt_docked_2.sdf",
            "pockets/index.pkl",
            "pockets/3ug2/3ug2_rec_3ug2_lig_tt_docked_1_pocket10.pdb"} <= set(files)
    for f in files:
        if f.endswith(".pt"):
            assert torch.load(outs["port"] / f) == torch.load(outs["jax"] / f), f
        else:
            assert (outs["port"] / f).read_bytes() == (outs["jax"] / f).read_bytes(), f
    with open(outs["port"] / "clean" / "index.pkl", "rb") as fh:
        index = pickle.load(fh)
    # kept: rmsd <= 1.0 with both files and the pose present
    assert [(p, l[-len("docked_0.sdf"):], r) for p, l, r in index] == [
        ("1h36/1h36_A_rec.pdb", "docked_0.sdf", 0.5012),
        ("1h36/1h36_A_rec.pdb", "docked_2.sdf", 0.9),
        ("3ug2/3ug2_rec.pdb", "docked_0.sdf", 0.1),
        ("3ug2/3ug2_rec.pdb", "docked_1.sdf", 1.0)]
    pose = (outs["port"] / "clean" / index[1][1]).read_text()
    x0 = float(pose.splitlines()[4][:10])
    assert x0 == pytest.approx(float(open(LIG_1H36).read().splitlines()[4][:10]) - 0.5)
    split = torch.load(outs["port"] / "split_1_0.pt")
    assert len(split["test"]) == 1 and len(split["train"]) == 2
    assert torch.load(outs["port"] / "split_1_2.pt")["train"] == split["train"][:2]


def test_pocket_extraction_keeps_residues_near_the_pose(tmp_path, monkeypatch):
    """Every residue of an extracted pocket has its centre of mass within the
    radius of a ligand atom (the reference's criterion), and the pocket is a
    PDB block the port's parser reads."""
    from targetdiff_tpu_torch.chem.pdb import PDBProtein
    from targetdiff_tpu_torch.chem.sdf import parse_sdf_file

    src, types = _crossdocked_tree(tmp_path)
    clean, pockets = tmp_path / "clean", tmp_path / "pockets"
    prep.main(["clean", "--source", str(src), "--dest", str(clean), "--types_index", str(types)])
    prep.main(["pockets", "--source", str(clean), "--dest", str(pockets), "--radius", "6",
               "--num_workers", "1"])
    with open(pockets / "index.pkl", "rb") as fh:
        index = pickle.load(fh)
    assert len(index) == 4
    for pocket_fn, ligand_fn in index:
        assert re.search(r"_pocket6\.pdb$", pocket_fn)
        lig = parse_sdf_file(str(pockets / ligand_fn))["pos"]
        res = PDBProtein(str(pockets / pocket_fn)).to_dict_residue()
        d = np.linalg.norm(res["center_of_mass"][:, None] - lig[None], axis=-1).min(1)
        assert len(d) > 0 and (d < 6.0 + 1e-6).all()


CLIS = sorted(m.name for m in pkgutil.iter_modules(port_cli.__path__) if m.name != "common")


def test_port_has_every_cli_of_the_jax_package_but_docking():
    import targetdiff_tpu.cli as jax_cli

    jax_clis = {m.name for m in pkgutil.iter_modules(jax_cli.__path__)}
    assert set(CLIS) == jax_clis - {"dock_testset"}  # docking waits for QVina / Vina


@pytest.mark.parametrize("name", CLIS)
def test_port_cli_help(name, capsys):
    mod = importlib.import_module(f"targetdiff_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out.lower()
