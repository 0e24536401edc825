"""RecordStore: a minimal memory-mapped key-value record store, the same
file format as targetdiff_tpu/data/store.py (copied, since importing
`targetdiff_tpu.data` imports jax), so both packages read one cache.

Replaces the reference's LMDB dataset cache (reference:
datasets/pl_pair_dataset.py:28-44, datasets/pdbbind.py:30-51) without the
lmdb dependency: one append-only data file of length-prefixed blobs plus a
pickled key->(offset, size) index, mmapped read-only for zero-copy reads from
many worker processes. Write once, read many — exactly the dataset-cache
access pattern.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Optional

MAGIC = b"TDB1"


class RecordStoreWriter:
    def __init__(self, path: str):
        self.path = path
        self.tmp_data = path + ".data.tmp"
        self.f = open(self.tmp_data, "wb")
        self.f.write(MAGIC)
        self.index = {}

    def put(self, key: str, value: bytes) -> None:
        off = self.f.tell()
        self.f.write(struct.pack("<Q", len(value)))
        self.f.write(value)
        self.index[key] = (off, len(value))

    def put_obj(self, key: str, obj) -> None:
        self.put(key, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def close(self) -> None:
        self.f.close()
        with open(self.path + ".idx.tmp", "wb") as f:
            pickle.dump(self.index, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(self.tmp_data, self.path + ".data")
        os.replace(self.path + ".idx.tmp", self.path + ".idx")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordStore:
    """Read-only view. Lazily opened (safe to pickle across fork for loader
    workers, mirroring the reference's lazy LMDB connect pattern)."""

    def __init__(self, path: str):
        self.path = path
        self._mm: Optional[mmap.mmap] = None
        self._index = None

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(path + ".data") and os.path.exists(path + ".idx")

    def _ensure_open(self):
        if self._mm is None:
            f = open(self.path + ".data", "rb")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            assert self._mm[:4] == MAGIC, f"bad store magic in {self.path}.data"
            with open(self.path + ".idx", "rb") as fi:
                self._index = pickle.load(fi)

    def keys(self):
        self._ensure_open()
        return list(self._index.keys())

    def __len__(self) -> int:
        self._ensure_open()
        return len(self._index)

    def __contains__(self, key: str) -> bool:
        self._ensure_open()
        return key in self._index

    def get(self, key: str) -> bytes:
        self._ensure_open()
        off, size = self._index[key]
        start = off + 8
        return self._mm[start : start + size]

    def get_obj(self, key: str):
        return pickle.loads(self.get(key))

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._mm = None
        self._index = None

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None
