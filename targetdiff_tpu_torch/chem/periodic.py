"""Periodic-table data (public physical constants): symbols, masses, covalent
radii (Cordero 2008, as used by OpenBabel/RDKit for bond perception), default
valences, and electronegativities for the elements that occur in
protein-ligand work."""

from __future__ import annotations

SYMBOLS = {
    1: "H", 5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 11: "Na", 12: "Mg", 14: "Si",
    15: "P", 16: "S", 17: "Cl", 19: "K", 20: "Ca", 26: "Fe", 29: "Cu", 30: "Zn",
    33: "As", 34: "Se", 35: "Br", 53: "I",
}
ATOMIC_NUMBERS = {s: z for z, s in SYMBOLS.items()}
# common alternate casings seen in PDB element columns
for s, z in list(ATOMIC_NUMBERS.items()):
    ATOMIC_NUMBERS[s.upper()] = z

ATOMIC_WEIGHTS = {
    1: 1.008, 5: 10.811, 6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998, 11: 22.990,
    12: 24.305, 14: 28.086, 15: 30.974, 16: 32.06, 17: 35.45, 19: 39.098,
    20: 40.078, 26: 55.845, 29: 63.546, 30: 65.38, 33: 74.922, 34: 78.971,
    35: 79.904, 53: 126.904,
}

# Cordero et al. 2008 single-bond covalent radii (Angstrom)
COVALENT_RADII = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 11: 1.66, 12: 1.41,
    14: 1.11, 15: 1.07, 16: 1.05, 17: 1.02, 19: 2.03, 20: 1.76, 26: 1.32,
    29: 1.32, 30: 1.22, 33: 1.19, 34: 1.20, 35: 1.20, 53: 1.39,
}

# maximum commonly-allowed total valence (sum of bond orders incl. H)
DEFAULT_VALENCES = {
    1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 5, 16: 6, 17: 1,
    35: 1, 53: 1, 11: 1, 12: 2, 19: 1, 20: 2, 26: 6, 29: 4, 30: 2, 33: 5, 34: 6,
}

# permitted valence states (for bond-order repair): element -> tuple of states
VALENCE_STATES = {
    6: (4,), 7: (3,), 8: (2,), 9: (1,), 15: (3, 5), 16: (2, 4, 6), 17: (1,),
    35: (1,), 53: (1, 3), 5: (3,), 14: (4,), 34: (2, 4, 6), 1: (1,),
}

PAULING_EN = {
    1: 2.20, 5: 2.04, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 14: 1.90, 15: 2.19,
    16: 2.58, 17: 3.16, 35: 2.96, 53: 2.66, 34: 2.55,
}


def symbol(z: int) -> str:
    return SYMBOLS.get(z, f"*{z}")


def atomic_number(sym: str) -> int:
    s = sym.strip()
    if s in ATOMIC_NUMBERS:
        return ATOMIC_NUMBERS[s]
    s2 = s.capitalize()
    if s2 in ATOMIC_NUMBERS:
        return ATOMIC_NUMBERS[s2]
    raise KeyError(f"unknown element symbol: {sym!r}")


def atomic_weight(z: int) -> float:
    return ATOMIC_WEIGHTS.get(z, 2.0 * z)


def covalent_radius(z: int) -> float:
    return COVALENT_RADII.get(z, 1.5)
