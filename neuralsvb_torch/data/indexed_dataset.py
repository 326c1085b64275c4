"""Pickle-blob packed dataset with an offset index; port of
``neuralsvb_tpu/data/indexed_dataset.py``.

On-disk compatible with the reference format
(reference: utils/indexed_datasets.py:7-54): ``<path>.data`` is a stream of
pickled dicts, ``<path>.idx`` a numpy-saved {'offsets': [...]}. Keeping the
format lets packed datasets produced by the PyTorch reference be read
directly.
"""

from __future__ import annotations

import os
import pickle
import threading
from copy import deepcopy

import numpy as np


class IndexedDataset:
    def __init__(self, path: str, num_cache: int = 1):
        self.path = path
        self.data_offsets = np.load(f"{path}.idx", allow_pickle=True).item()["offsets"]
        self.data_file = open(f"{path}.data", "rb", buffering=-1)
        self._pid = os.getpid()
        self._reopen_lock = threading.Lock()
        self.cache = []
        self.num_cache = num_cache

    def check_index(self, i: int):
        if i < 0 or i >= len(self.data_offsets) - 1:
            raise IndexError("index out of range")

    def __del__(self):
        if getattr(self, "data_file", None):
            self.data_file.close()

    def _fileno(self):
        # A dataset captured across a fork (mp.Pool workers) inherits the
        # parent's file object. Reopen once per process, and read with
        # os.pread below: it takes an explicit offset, so neither forked
        # processes nor prefetch threads can race the shared fd position.
        # Double-checked lock: two threads of a forked child must not BOTH
        # reopen — the loser's file object would be GC-closed while the
        # winner still holds its raw fd (EBADF / wrong-file reads).
        if os.getpid() != self._pid:
            with self._reopen_lock:
                if os.getpid() != self._pid:
                    self.data_file = open(f"{self.path}.data", "rb",
                                          buffering=0)
                    self._pid = os.getpid()
        return self.data_file.fileno()

    def __getitem__(self, i: int):
        self.check_index(i)
        if self.num_cache > 0:
            for c in self.cache:
                if c[0] == i:
                    return c[1]
        off = self.data_offsets[i]
        n = self.data_offsets[i + 1] - off
        b = os.pread(self._fileno(), n, off)
        while len(b) < n:  # pread may return short on signals/EINTR
            more = os.pread(self._fileno(), n - len(b), off + len(b))
            if not more:
                raise EOFError(f"short read at item {i} of {self.path}")
            b += more
        item = pickle.loads(b)
        if self.num_cache > 0:
            self.cache = [(i, deepcopy(item))] + self.cache[:-1]
        return item

    def __len__(self):
        return len(self.data_offsets) - 1


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self.out_file = open(f"{path}.data", "wb")
        self.byte_offsets = [0]

    def add_item(self, item):
        s = pickle.dumps(item)
        n = self.out_file.write(s)
        self.byte_offsets.append(self.byte_offsets[-1] + n)

    def finalize(self):
        self.out_file.close()
        np.save(open(f"{self.path}.idx", "wb"),
                {"offsets": self.byte_offsets})
