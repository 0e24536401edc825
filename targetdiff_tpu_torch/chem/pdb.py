"""PDB protein parsing: fixed-column ATOM records, residue assembly, pocket
selection around a ligand, and PDB block writing.

Copy of targetdiff_tpu/chem/pdb.py without its C++ (tdnative) fast path.
Dependency-free counterpart of the reference's `PDBProtein`
(reference: utils/data.py:23-200), keeping its public API contract:
`to_dict_atom()`, `to_dict_residue()`, `query_residues_ligand()`,
`residues_to_pdb_block()`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import periodic as PT

AA_NAME_SYM = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F", "GLY": "G",
    "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L", "MET": "M", "ASN": "N",
    "PRO": "P", "GLN": "Q", "ARG": "R", "SER": "S", "THR": "T", "VAL": "V",
    "TRP": "W", "TYR": "Y",
}
AA_NAME_NUMBER = {name: i for i, name in enumerate(AA_NAME_SYM)}
AA_NUMBER_NAME = {i: name for name, i in AA_NAME_NUMBER.items()}
BACKBONE_NAMES = ("CA", "C", "N", "O")


class PDBProtein:
    """Parses ATOM records of (the first model of) a PDB file or block."""

    AA_NAME_SYM = AA_NAME_SYM
    AA_NAME_NUMBER = AA_NAME_NUMBER
    BACKBONE_NAMES = list(BACKBONE_NAMES)

    def __init__(self, data: str, mode: str = "auto"):
        if (mode == "auto" and data[-4:].lower() == ".pdb") or mode == "path":
            with open(data) as f:
                self.block = f.read()
        else:
            self.block = data

        self.title: Optional[str] = None
        self.atoms: List[Dict] = []
        self.element: List[int] = []
        self.atomic_weight: List[float] = []
        self.pos: List[np.ndarray] = []
        self.atom_name: List[str] = []
        self.is_backbone: List[bool] = []
        self.atom_to_aa_type: List[int] = []
        self.residues: List[Dict] = []
        self.amino_acid: List[int] = []
        self.center_of_mass: List[np.ndarray] = []
        self.pos_CA: List[np.ndarray] = []
        self.pos_C: List[np.ndarray] = []
        self.pos_N: List[np.ndarray] = []
        self.pos_O: List[np.ndarray] = []

        self._parse_python()

    @staticmethod
    def _element_of(line: str) -> str:
        sym = line[76:78].strip() if len(line) >= 78 else ""
        if not sym:
            sym = line[13:14]
        return sym.capitalize()

    def _parse_python(self):
        residues_tmp: Dict[str, Dict] = {}
        for line in self.block.splitlines():
            rec = line[0:6].strip()
            if rec == "HEADER":
                self.title = line[10:].strip().lower()
                continue
            if rec == "ENDMDL":
                break  # only the first model
            if rec != "ATOM":
                continue
            res_name = line[17:20].strip()
            if res_name not in AA_NAME_NUMBER:
                continue  # skip nonstandard residues (same effect as reference's KeyError-free path)
            atom_name = line[12:16].strip()
            try:
                z = PT.atomic_number(self._element_of(line))
            except KeyError:
                continue
            idx = len(self.element)
            pos = np.array(
                [float(line[30:38]), float(line[38:46]), float(line[46:54])], np.float32
            )
            self.atoms.append({"line": line, "atom_name": atom_name, "res_name": res_name})
            self.element.append(z)
            self.atomic_weight.append(PT.atomic_weight(z))
            self.pos.append(pos)
            self.atom_name.append(atom_name)
            self.is_backbone.append(atom_name in BACKBONE_NAMES)
            self.atom_to_aa_type.append(AA_NAME_NUMBER[res_name])

            chain = line[21:22].strip()
            segment = line[72:76].strip() if len(line) >= 76 else ""
            res_id = int(line[22:26])
            insert = line[26:27].strip()
            key = f"{chain}_{segment}_{res_id}_{insert}"
            if key not in residues_tmp:
                residues_tmp[key] = {
                    "name": res_name, "atoms": [idx], "chain": chain, "segment": segment,
                }
            else:
                residues_tmp[key]["atoms"].append(idx)

        self.residues = list(residues_tmp.values())
        self._assemble_residues()

    def _assemble_residues(self):
        for residue in self.residues:
            total = np.zeros(3, np.float32)
            mass = 0.0
            for ai in residue["atoms"]:
                total += self.pos[ai] * self.atomic_weight[ai]
                mass += self.atomic_weight[ai]
                if self.atom_name[ai] in BACKBONE_NAMES:
                    residue[f"pos_{self.atom_name[ai]}"] = self.pos[ai]
            residue["center_of_mass"] = total / max(mass, 1e-9)

        for residue in self.residues:
            self.amino_acid.append(AA_NAME_NUMBER[residue["name"]])
            self.center_of_mass.append(residue["center_of_mass"])
            for name in BACKBONE_NAMES:
                k = f"pos_{name}"
                getattr(self, k).append(residue.get(k, residue["center_of_mass"]))

    # -- exports ------------------------------------------------------------

    def to_dict_atom(self) -> Dict[str, np.ndarray]:
        return {
            "element": np.array(self.element, np.int64),
            "molecule_name": self.title,
            "pos": np.array(self.pos, np.float32).reshape(-1, 3),
            "is_backbone": np.array(self.is_backbone, bool),
            "atom_name": self.atom_name,
            "atom_to_aa_type": np.array(self.atom_to_aa_type, np.int64),
        }

    def to_dict_residue(self) -> Dict[str, np.ndarray]:
        return {
            "amino_acid": np.array(self.amino_acid, np.int64),
            "center_of_mass": np.array(self.center_of_mass, np.float32).reshape(-1, 3),
            "pos_CA": np.array(self.pos_CA, np.float32).reshape(-1, 3),
            "pos_C": np.array(self.pos_C, np.float32).reshape(-1, 3),
            "pos_N": np.array(self.pos_N, np.float32).reshape(-1, 3),
            "pos_O": np.array(self.pos_O, np.float32).reshape(-1, 3),
        }

    # -- queries ------------------------------------------------------------

    def query_residues_radius(self, center, radius, criterion="center_of_mass"):
        center = np.asarray(center).reshape(3)
        return [
            r for r in self.residues if np.linalg.norm(r[criterion] - center) < radius
        ]

    def query_residues_ligand(self, ligand: Dict, radius: float, criterion="center_of_mass"):
        """Residues whose `criterion` point is within `radius` of ANY ligand
        atom, in first-hit order (reference: utils/data.py:181-191)."""
        crit = np.stack([r[criterion] for r in self.residues])  # [R, 3]
        lig = np.asarray(ligand["pos"], np.float32)  # [L, 3]
        d = np.linalg.norm(crit[None, :, :] - lig[:, None, :], axis=-1)  # [L, R]
        selected, seen = [], set()
        for lrow in d:
            for i in np.nonzero(lrow < radius)[0]:
                if i not in seen:
                    seen.add(int(i))
                    selected.append(self.residues[int(i)])
        return selected

    def residues_to_pdb_block(self, residues, name: str = "POCKET") -> str:
        lines = [f"HEADER    {name}", f"COMPND    {name}"]
        for r in residues:
            for ai in r["atoms"]:
                lines.append(self.atoms[ai]["line"])
        lines.append("END")
        return "\n".join(lines) + "\n"


def parse_pdbbind_index_file(path: str) -> List[str]:
    """(reference: utils/data.py:203-210)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            out.append(line.split()[0])
    return out
