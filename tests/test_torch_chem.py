"""The port's own copies of the host-side chemistry (PDB and SDF parsing,
reconstruction, bond orders, the ligand-size prior and their data files)
against the JAX package's modules they were copied from, and the rule that
no module of the port, nor chip_smoke.py or the kernel-variant tools
(weight_grad_variants.py, edge_bwd_variants.py, node_ew_variants.py,
x2h_bf16_variants.py, node_proj_variants.py and their variant_harness.py),
imports the JAX package, and that no module of
the port (the evaluation modules and tools/quality_gate.py included) names
a path under targetdiff_tpu/ or reads a file there."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from targetdiff_tpu.chem import pdb as jax_pdb
from targetdiff_tpu.chem import reconstruct as jax_reconstruct
from targetdiff_tpu.chem import sdf as jax_sdf
from targetdiff_tpu.evaluation import analyze as jax_analyze
from targetdiff_tpu.utils import atom_num as jax_atom_num
from targetdiff_tpu_torch.chem import pdb, reconstruct, sdf
from targetdiff_tpu_torch.evaluation import analyze
from targetdiff_tpu_torch.utils import atom_num

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("name", ["1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb",
                                  "3ug2_protein.pdb"])
def test_pdb_copy_parses_as_the_jax_module(name):
    path = str(EXAMPLES / name)
    got, want = pdb.PDBProtein(path), jax_pdb.PDBProtein(path)
    _assert_dicts_equal(got.to_dict_atom(), want.to_dict_atom())
    _assert_dicts_equal(got.to_dict_residue(), want.to_dict_residue())
    ligand = {"pos": np.asarray(want.to_dict_atom()["pos"][:5]) + 1.0}
    assert ([r["atoms"] for r in got.query_residues_ligand(ligand, 8.0)]
            == [r["atoms"] for r in want.query_residues_ligand(ligand, 8.0)])


@pytest.mark.parametrize("name", ["3ug2_ligand.sdf", "1h36_A_rec_1h36_r88_lig_tt_docked_0.sdf"])
def test_sdf_copy_parses_as_the_jax_module(name):
    path = str(EXAMPLES / name)
    _assert_dicts_equal(sdf.parse_sdf_file(path), jax_sdf.parse_sdf_file(path))


def _clouds():
    """Fixed point clouds: the example ligands as they are and with seeded
    noise of 0.05 and 0.15 A, as atomic numbers and positions."""
    out = []
    for i, name in enumerate(["3ug2_ligand.sdf", "1h36_A_rec_1h36_r88_lig_tt_docked_0.sdf"]):
        lig = jax_sdf.parse_sdf_file(str(EXAMPLES / name))
        rng = np.random.default_rng(i)
        for noise in (0.0, 0.05, 0.15):
            out.append((lig["element"], lig["pos"] + noise * rng.normal(size=lig["pos"].shape)))
    return out


@pytest.mark.parametrize("case", range(6))
def test_reconstruct_copy_matches_the_jax_module(case, tmp_path):
    z, pos = _clouds()[case]
    try:
        want = jax_reconstruct.reconstruct_from_generated(pos, z)
    except jax_reconstruct.MolReconsError:
        with pytest.raises(reconstruct.MolReconsError):
            reconstruct.reconstruct_from_generated(pos, z)
        return
    got = reconstruct.reconstruct_from_generated(pos, z)
    assert got.to_smiles() == want.to_smiles()
    assert ([(b.a1, b.a2, b.order, b.aromatic) for b in got.bonds]
            == [(b.a1, b.a2, b.order, b.aromatic) for b in want.bonds])
    sdf.write_sdf(got, str(tmp_path / "got.sdf"), name="m")
    jax_sdf.write_sdf(want, str(tmp_path / "want.sdf"), name="m")
    assert (tmp_path / "got.sdf").read_text() == (tmp_path / "want.sdf").read_text()


def test_bond_orders_and_atom_count_prior_match_the_jax_modules():
    for a1, a2 in [("C", "C"), ("C", "N"), ("C", "O"), ("N", "N"), ("C", "S"), ("P", "O"),
                   ("H", "C"), ("Cl", "C")]:
        for d in np.linspace(0.9, 2.2, 27):
            assert analyze.get_bond_order(a1, a2, d) == jax_analyze.get_bond_order(a1, a2, d)
    pocket = pdb.PDBProtein(str(EXAMPLES / "3ug2_protein.pdb")).to_dict_atom()["pos"][:300]
    space = atom_num.get_space_size(pocket)
    assert space == jax_atom_num.get_space_size(pocket)
    for size in (space, 8.0, 15.0, 30.0):
        rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
        assert ([atom_num.sample_atom_num(size, rng_a) for _ in range(20)]
                == [jax_atom_num.sample_atom_num(size, rng_b) for _ in range(20)])


@pytest.mark.parametrize("name", ["atom_num_prior.json.gz", "bond_order_tables.json.gz"])
def test_resource_files_are_byte_copies(name):
    assert ((REPO / "targetdiff_tpu_torch" / "resources" / name).read_bytes()
            == (REPO / "targetdiff_tpu" / "resources" / name).read_bytes())


_NO_JAX_PACKAGE = """
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name == "targetdiff_tpu" or name.startswith("targetdiff_tpu."):
            raise ImportError(f"{name} is not available")
        return None

sys.meta_path.insert(0, Refuse())
import targetdiff_tpu_torch
names = [m.name for m in pkgutil.walk_packages(targetdiff_tpu_torch.__path__,
                                                "targetdiff_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m == "targetdiff_tpu" or m.startswith("targetdiff_tpu.")]
print(len(names))
"""


def test_port_imports_without_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_PACKAGE], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 30  # every module of the port was imported


def _jax_package_paths(source: str) -> list:
    """String constants of `source`, docstrings aside, that name a path
    under targetdiff_tpu/ or the package itself (as in
    `files("targetdiff_tpu")`; the SDF writer's program line
    "  targetdiff_tpu" is neither)."""
    tree = ast.parse(source)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docstrings.add(id(first.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings
            and ("targetdiff_tpu/" in node.value or node.value == "targetdiff_tpu")]


def test_port_names_no_path_of_the_jax_package():
    files = sorted((REPO / "targetdiff_tpu_torch").rglob("*.py"))
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"targetdiff_tpu_torch/tools/quality_gate.py",
            "targetdiff_tpu_torch/evaluation/eval_bond_length.py",
            "targetdiff_tpu_torch/chem/sascorer.py"} <= names
    found = {f.name: _jax_package_paths(f.read_text()) for f in files}
    assert not {k: v for k, v in found.items() if v}
    # the rule itself catches both forms
    assert _jax_package_paths('files("targetdiff_tpu") / "resources"') == ["targetdiff_tpu"]
    assert _jax_package_paths('open("../targetdiff_tpu/resources/x.npz")')


_READS_NO_JAX_FILE = """
import builtins, io, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name == "targetdiff_tpu" or name.startswith("targetdiff_tpu."):
            raise ImportError(f"{name} is not available")
        return None

sys.meta_path.insert(0, Refuse())
real_open = builtins.open

def guarded_open(file, *args, **kwargs):
    if "/targetdiff_tpu/" in str(file):
        raise PermissionError(f"read of {file}")
    return real_open(file, *args, **kwargs)

builtins.open = io.open = guarded_open
from targetdiff_tpu_torch.chem import sascorer
from targetdiff_tpu_torch.evaluation import analyze, eval_atom_type, eval_bond_length
from targetdiff_tpu_torch.tools import quality_gate as qg
from targetdiff_tpu_torch.utils import atom_num

analyze._tables(), eval_bond_length._cfg(), eval_atom_type.atom_type_distribution()
sascorer._table(), atom_num.get_space_size([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
pool = qg.make_pool(seed=2, pool=6)
ev = qg.evaluate(qg.corpus_mols(pool, 6), qg.train_profile(pool, 6))
print(ev["n"], ev["qed_mean"] is not None)
"""


def test_port_reads_no_file_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _READS_NO_JAX_FILE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["6", "True"]


def _imported_roots(script: str) -> set:
    tree = ast.parse((REPO / script).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    roots = _imported_roots("chip_smoke.py")
    assert "targetdiff_tpu_torch" in roots
    assert not roots & {"targetdiff_tpu", "jax", "jaxlib", "flax", "optax"}, roots


def test_weight_grad_variants_imports_neither_jax_nor_the_jax_package():
    roots = _imported_roots("weight_grad_variants.py")
    assert {"targetdiff_tpu_torch", "chip_smoke"} <= roots
    assert not roots & {"targetdiff_tpu", "jax", "jaxlib", "flax", "optax"}, roots


def test_edge_bwd_variants_imports_neither_jax_nor_the_jax_package():
    roots = _imported_roots("edge_bwd_variants.py")
    assert {"targetdiff_tpu_torch", "chip_smoke"} <= roots
    assert not roots & {"targetdiff_tpu", "jax", "jaxlib", "flax", "optax"}, roots


@pytest.mark.parametrize("script", ["node_ew_variants.py", "x2h_bf16_variants.py",
                                    "node_proj_variants.py", "variant_harness.py",
                                    "cone_variants.py", "h2x_bf16_variants.py",
                                    "graph_variants.py"])
def test_variant_tools_import_neither_jax_nor_the_jax_package(script):
    roots = _imported_roots(script)
    assert "targetdiff_tpu_torch" in roots
    assert not roots & {"targetdiff_tpu", "jax", "jaxlib", "flax", "optax"}, roots
