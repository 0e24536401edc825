"""Pocket-ligand datasets cached in a RecordStore, the dense padding collator
and a shuffling loader; counterpart of targetdiff_tpu/data/datasets.py
(reference: datasets/__init__.py:7-22, datasets/pl_pair_dataset.py:11-117).

Samples are plain dicts of numpy arrays with `protein_*` / `ligand_*` key
prefixes; batches are the port's ComplexBatch of torch tensors on a given
device. The parsers are the port's copies of `chem.pdb` and `chem.sdf`.
The PDBBind dataset belongs to the property models and is not ported yet.
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
    if name != "pl":
        raise NotImplementedError(f"dataset {name!r} is not ported (only 'pl')")
    dataset = PocketLigandPairDataset(config["path"], transform=transform)
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
