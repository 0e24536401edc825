"""Pocket-ligand and PDBBind datasets cached in a RecordStore, the dense
padding collator and a shuffling loader; counterpart of
targetdiff_tpu/data/datasets.py (reference: datasets/__init__.py:7-22,
datasets/pl_pair_dataset.py:11-117, datasets/pdbbind.py:14-132).

Samples are plain dicts of numpy arrays with `protein_*` / `ligand_*` key
prefixes; batches are the port's ComplexBatch of torch tensors on a given
device (the property models' PropBatch: utils/misc_prop.py). The parsers
are the port's copies of `chem.pdb`, `chem.sdf` and `chem.mol2`.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..chem.pdb import PDBProtein
from ..chem.sdf import parse_sdf_file
from .batch import ComplexBatch, from_numpy
from .store import RecordStore, RecordStoreWriter


def merge_protein_ligand(protein: Dict, ligand: Dict) -> Dict:
    """Parsed protein/ligand dicts under prefixed keys
    (reference: datasets/pl_data.py:16-30)."""
    out = {f"protein_{k}": v for k, v in protein.items()}
    out.update({f"ligand_{k}": v for k, v in ligand.items()})
    return out


class PocketLigandPairDataset:
    """CrossDocked pocket10 pairs. On first access, parses every
    (pocket PDB, ligand SDF) pair of `index.pkl` under `raw_path` into a
    RecordStore beside it (reference: datasets/pl_pair_dataset.py:51-97);
    the store's name and format are the JAX package's, so one cache serves
    both."""

    def __init__(self, raw_path: str, transform: Optional[Callable] = None, version: str = "final"):
        self.raw_path = raw_path.rstrip("/")
        self.index_path = os.path.join(self.raw_path, "index.pkl")
        self.processed_path = os.path.join(
            os.path.dirname(self.raw_path),
            os.path.basename(self.raw_path) + f"_processed_{version}")
        self.transform = transform
        if not RecordStore.exists(self.processed_path):
            self._process()
        self.store = RecordStore(self.processed_path)
        self._keys = None

    def _process(self):
        with open(self.index_path, "rb") as f:
            index = pickle.load(f)
        num_skipped = 0
        with RecordStoreWriter(self.processed_path) as w:
            for i, entry in enumerate(index):
                pocket_fn, ligand_fn = entry[0], entry[1]
                if pocket_fn is None:
                    continue
                try:
                    protein = PDBProtein(os.path.join(self.raw_path, pocket_fn)).to_dict_atom()
                    ligand = parse_sdf_file(os.path.join(self.raw_path, ligand_fn))
                except (OSError, ValueError, KeyError, IndexError) as e:  # skip and count
                    num_skipped += 1
                    if num_skipped < 20:
                        logging.getLogger(__name__).warning(
                            "skip %s %s: %s: %s", pocket_fn, ligand_fn, type(e).__name__, e)
                    continue
                data = merge_protein_ligand(protein, ligand)
                data["protein_filename"] = pocket_fn
                data["ligand_filename"] = ligand_fn
                w.put_obj(str(i), data)
        logging.getLogger(__name__).info("processed %d entries, skipped %d", len(index),
                                         num_skipped)

    def keys(self):
        if self._keys is None:
            self._keys = sorted(self.store.keys(), key=int)
        return self._keys

    def __len__(self):
        return len(self.keys())

    def __getitem__(self, idx: int) -> Dict:
        data = self.store.get_obj(self.keys()[idx])
        data["id"] = idx
        if self.transform is not None:
            data = self.transform(data)
        return data


class PDBBindDataset:
    """PDBBind complexes with binding-affinity labels: y = pK and kind in
    {1: Ki, 2: Kd, 3: IC50} as `cli/pdbbind_preparation.py` writes them
    (the KMAP below is the reference's 0-based map, kept for its readers).
    On first access every (pocket PDB, ligand) entry of the index is parsed
    into a RecordStore beside it, the ligand through the SDF reader with the
    MOL2 retry and featurized with the prop models' 5-column property
    matrix; more than MAX_SKIP_FRACTION failures abort (and remove) the
    store. With `emb_path`, the diffusion-derived features of a likelihood
    export (the port's or the JAX CLI's pickle, or the reference's torch .pt
    meta file) are merged by ligand file name (reference:
    datasets/pdbbind.py:14-132)."""

    KMAP = {"Ki": 0, "Kd": 1, "IC50": 2}
    MAX_SKIP_FRACTION = 0.2

    def __init__(self, index_path: str, transform: Optional[Callable] = None,
                 emb_path: Optional[str] = None):
        self.index_path = index_path
        self.raw_path = os.path.dirname(index_path)
        self.processed_path = os.path.join(self.raw_path, "pdbbind_processed_final")
        self.transform = transform
        if not RecordStore.exists(self.processed_path):
            self._process()
        self.store = RecordStore(self.processed_path)
        self._keys = None
        self.emb = None
        if emb_path is not None:
            self.emb = {e["ligand_filename"]: e for e in load_embedding_export(emb_path)}

    def _process(self):
        from ..chem.mol2 import read_ligand_mol
        from ..chem.sdf import mol_to_ligand_dict, remove_hydrogens
        from .transforms_prop import ligand_atom_feature_matrix

        log = logging.getLogger(__name__)
        with open(self.index_path, "rb") as f:
            index = pickle.load(f)
        num_skipped = num_mol2 = 0
        with RecordStoreWriter(self.processed_path) as w:
            for i, entry in enumerate(index):
                try:
                    pocket_fn, ligand_fn = entry["pocket"], entry["ligand"]
                    protein = PDBProtein(os.path.join(self.raw_path, pocket_fn)).to_dict_atom()
                    mol, from_mol2 = read_ligand_mol(os.path.join(self.raw_path, ligand_fn))
                    ligand = mol_to_ligand_dict(mol)
                    ligand["atom_feature"] = ligand_atom_feature_matrix(remove_hydrogens(mol))
                except Exception as e:  # any parse failure: skip and count, as the reference
                    num_skipped += 1
                    if num_skipped < 20:
                        log.warning("skip %s: %s: %s", entry, type(e).__name__, e)
                    continue
                num_mol2 += bool(from_mol2)
                data = merge_protein_ligand(protein, ligand)
                data["protein_filename"] = pocket_fn
                data["ligand_filename"] = ligand_fn
                data["y"] = np.float32(entry["pk"])
                data["kind"] = np.int64(entry.get("kind", 0))
                w.put_obj(str(i), data)
        log.info("processed pdbbind, skipped %d (%d recovered through the mol2 retry)",
                 num_skipped, num_mol2)
        if index and num_skipped > self.MAX_SKIP_FRACTION * len(index):
            for suffix in (".data", ".idx"):
                try:
                    os.remove(self.processed_path + suffix)
                except OSError:
                    pass
            raise RuntimeError(f"PDBBind processing skipped {num_skipped}/{len(index)} "
                               f"complexes (> {self.MAX_SKIP_FRACTION:.0%}); refusing to build "
                               "a silently-shrunken dataset")

    def keys(self):
        if self._keys is None:
            self._keys = sorted(self.store.keys(), key=int)
        return self._keys

    def __len__(self):
        return len(self.keys())

    def __getitem__(self, idx: int) -> Dict:
        data = self.store.get_obj(self.keys()[idx])
        data["id"] = idx
        if self.emb is not None:
            e = self.emb.get(data["ligand_filename"])
            if e is not None:
                data.update(embedding_fields(e))
        if self.transform is not None:
            data = self.transform(data)
        return data


def load_embedding_export(path: str) -> List[Dict]:
    """The records of a likelihood export: a pickle (this package's or the
    JAX package's CLI) or the reference's torch .pt meta file."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except pickle.UnpicklingError:
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)


def embedding_fields(e: Dict) -> Dict[str, np.ndarray]:
    """The diffusion-derived features of one export record, with the
    reference's field contract (reference: datasets/pdbbind.py:112-122)."""
    kl_pos = np.asarray(e["kl_pos"], np.float32).ravel()
    kl_v = np.asarray(e["kl_v"], np.float32).ravel()
    pv = np.asarray(e["pred_ligand_v"], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -(pv * np.log(np.clip(pv, 1e-12, None))).sum(-1)
    return {"nll": np.concatenate([kl_pos[1:], kl_v[1:]]),
            "nll_all": np.concatenate([kl_pos, kl_v]), "pred_ligand_v": pv,
            "final_h": np.asarray(e["final_h"], np.float32),
            "pred_v_entropy": ent.astype(np.float32)[:, None]}


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def get_dataset(config, transform=None) -> tuple:
    """(reference: datasets/__init__.py:7-22). Returns (dataset, subsets or
    None); the split file is a torch .pt dict of name -> index list."""
    name = config["name"]
    if name == "pl":
        dataset = PocketLigandPairDataset(config["path"], transform=transform)
    elif name == "pdbbind":
        dataset = PDBBindDataset(config["path"], transform=transform,
                                 emb_path=config.get("emb_path"))
    else:
        raise NotImplementedError(f"Unknown dataset: {name}")
    if config.get("split"):
        import torch

        split = torch.load(config["split"], weights_only=False)
        return dataset, {k: Subset(dataset, v) for k, v in split.items()}
    return dataset, None


def collate_padded(samples: List[Dict], max_protein: int, max_ligand: int,
                   device="cpu") -> ComplexBatch:
    """Pad a list of data dicts into one ComplexBatch on `device`
    (reference: scripts/train_diffusion.py:88-98)."""
    B = len(samples)
    fp = samples[0]["protein_atom_feature"].shape[-1]
    ppos = np.zeros((B, max_protein, 3), np.float32)
    pfeat = np.zeros((B, max_protein, fp), np.float32)
    pmask = np.zeros((B, max_protein), bool)
    lpos = np.zeros((B, max_ligand, 3), np.float32)
    lv = np.zeros((B, max_ligand), np.int64)
    lmask = np.zeros((B, max_ligand), bool)
    for i, s in enumerate(samples):
        np_, nl = len(s["protein_pos"]), len(s["ligand_pos"])
        if np_ > max_protein or nl > max_ligand:
            raise ValueError(f"sample {i} exceeds padding: protein {np_}>{max_protein} or "
                             f"ligand {nl}>{max_ligand}")
        ppos[i, :np_] = s["protein_pos"]
        pfeat[i, :np_] = s["protein_atom_feature"]
        pmask[i, :np_] = True
        lpos[i, :nl] = s["ligand_pos"]
        lv[i, :nl] = s["ligand_atom_feature_full"]
        lmask[i, :nl] = True
    return from_numpy(ppos, pfeat, pmask, lpos, lv, lmask, device=device)


class PaddedLoader:
    """Shuffling batch loader that skips, and counts, oversize complexes and
    records that fail to load; `skipped_oversize` / `skipped_error` hold the
    last epoch's counts."""

    def __init__(self, dataset, batch_size: int, max_protein: int = 384, max_ligand: int = 64,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True, device="cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_protein, self.max_ligand = max_protein, max_ligand
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.device = device
        self.skipped_oversize = 0
        self.skipped_error = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, batch):
        return collate_padded(batch, self.max_protein, self.max_ligand, self.device)

    def __iter__(self):
        log = logging.getLogger(__name__)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        self.skipped_oversize = self.skipped_error = 0
        batch = []
        for i in order:
            try:
                s = self.dataset[int(i)]
            except (KeyError, IndexError, ValueError, OSError) as e:
                self.skipped_error += 1
                if self.skipped_error <= 3:
                    log.warning("PaddedLoader: skipping item %d (%s: %s)", i, type(e).__name__, e)
                continue
            if len(s["protein_pos"]) > self.max_protein or len(s["ligand_pos"]) > self.max_ligand:
                self.skipped_oversize += 1
                continue
            batch.append(s)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._collate(batch)
        if self.skipped_oversize or self.skipped_error:
            log.warning("PaddedLoader epoch: skipped %d oversize (> max_protein=%d or "
                        "max_ligand=%d) and %d errored of %d items", self.skipped_oversize,
                        self.max_protein, self.max_ligand, self.skipped_error,
                        len(self.dataset))


def inf_iterator(loader):
    """(reference: utils/train.py:46-52)."""
    while True:
        yield from loader
