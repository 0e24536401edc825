"""3D views of complexes, generated molecules and sampling trajectories,
counterpart of targetdiff_tpu/utils/visualize.py (reference:
utils/visualize.py:6-93, py3Dmol viewers). py3Dmol is optional: without it
each function returns the text blocks, to be rendered elsewhere."""

from __future__ import annotations

import os

from ..chem import periodic as PT
from ..chem.mol import Molecule
from ..chem.sdf import write_sdf
from ..data.transforms import get_atomic_number_from_index


def _p3d():
    try:
        import py3Dmol
    except ImportError:
        return None
    return py3Dmol


def visualize_complex(pdb_block: str, sdf_block: str, show_ligand: bool = True,
                      size=(600, 600)):
    """Protein cartoon + ligand sticks (reference: utils/visualize.py:23-48).
    Returns a py3Dmol view, or the blocks when py3Dmol is missing."""
    p3d = _p3d()
    if p3d is None:
        return {"pdb": pdb_block, "sdf": sdf_block}
    view = p3d.view(width=size[0], height=size[1])
    view.addModel(pdb_block, "pdb")
    view.setStyle({"model": -1}, {"cartoon": {"color": "spectrum"}})
    if show_ligand:
        view.addModel(sdf_block, "sdf")
        view.setStyle({"model": -1}, {"stick": {}})
    view.zoomTo()
    return view


def visualize_generated_mol(mol: Molecule, size=(400, 400)):
    """(reference: utils/visualize.py:51-72)."""
    sdf_block = write_sdf(mol)
    p3d = _p3d()
    if p3d is None:
        return {"sdf": sdf_block}
    view = p3d.view(width=size[0], height=size[1])
    view.addModel(sdf_block, "sdf")
    view.setStyle({"model": -1}, {"stick": {}, "sphere": {"radius": 0.35}})
    view.zoomTo()
    return view


def visualize_trajectory(pos_traj, v_traj, atom_mode: str, out_dir: str,
                         stride: int = 50) -> list:
    """Write every `stride`-th frame of a sampling trajectory ([frames,
    n_atoms, 3] positions, [frames, n_atoms] type indices, as the sampling
    CLI's --save_traj saves them) as an xyz file, without reconstruction.
    Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s in range(0, len(pos_traj), stride):
        pos, v = pos_traj[s], v_traj[s]
        z = get_atomic_number_from_index(v, atom_mode)
        path = os.path.join(out_dir, f"frame_{s:05d}.xyz")
        with open(path, "w") as f:
            f.write(f"{len(z)}\nstep {s}\n")
            for zz, p in zip(z, pos):
                f.write(f"{PT.symbol(zz)} {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        paths.append(path)
    return paths
