"""The host-side chemistry the port needs (PDB and SDF parsing, the
molecule model and its perception, point-cloud reconstruction): copies of
the jax-free modules of targetdiff_tpu/chem, kept here so that the port
imports nothing of the JAX package. The copies keep only the pure-Python
branches of the originals (no tdnative fast paths)."""

from .mol import Atom, Bond, Molecule  # noqa: F401
