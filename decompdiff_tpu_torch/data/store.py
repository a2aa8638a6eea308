"""DDStore — a self-contained, mmap-able record store for processed complexes
(port of decompdiff_tpu/data/store.py; the file format is the same).

TPU-native replacement for the reference's LMDB layer
(ref datasets/pl_pair_dataset.py:76-119): the environment has no lmdb, and a
training corpus of pickled numpy records needs only append-once/read-many
random access. Layout:

    [8-byte magic 'DDSTORE1'][8-byte LE index offset]
    [record 0][record 1]...[zlib-pickled index]

where the index is {'offsets': [(off, len)], 'keys': [str], 'meta': dict}.
Records are zlib-compressed pickles of plain-dict numpy samples. Reading uses
a single mmap; workers can share it read-only across forks (same role as
LMDB's zero-copy reads).
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import zlib
from typing import Iterator, Optional

MAGIC = b'DDSTORE1'


class DDStoreWriter:
    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = path
        self.meta = meta or {}
        self._f = open(path, 'wb')
        self._f.write(MAGIC)
        self._f.write(struct.pack('<Q', 0))  # index offset placeholder
        self._offsets = []
        self._keys = []

    def append(self, key: str, record: dict):
        blob = zlib.compress(pickle.dumps(record, protocol=4), level=3)
        off = self._f.tell()
        self._f.write(blob)
        self._offsets.append((off, len(blob)))
        self._keys.append(key)

    def close(self):
        index_off = self._f.tell()
        index = {'offsets': self._offsets, 'keys': self._keys,
                 'meta': self.meta}
        self._f.write(zlib.compress(pickle.dumps(index, protocol=4), level=3))
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack('<Q', index_off))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DDStore:
    """Read-only, lazily-mmapped (fork-safe: opens on first access per
    process, like the reference's lazy LMDB connect at
    ref datasets/pl_pair_dataset.py:76-92)."""

    def __init__(self, path: str):
        self.path = path
        self._mm = None
        self._pid = None
        with open(path, 'rb') as f:
            magic = f.read(8)
            assert magic == MAGIC, f'not a DDStore file: {path}'
            (index_off,) = struct.unpack('<Q', f.read(8))
            f.seek(index_off)
            index = pickle.loads(zlib.decompress(f.read()))
        self.offsets = index['offsets']
        self.keys = index['keys']
        self.meta = index.get('meta', {})
        self.key_to_id = {k: i for i, k in enumerate(self.keys)}

    def _ensure_open(self):
        if self._mm is None or self._pid != os.getpid():
            f = open(self.path, 'rb')
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._pid = os.getpid()

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, idx: int) -> dict:
        self._ensure_open()
        off, length = self.offsets[idx]
        return pickle.loads(zlib.decompress(self._mm[off:off + length]))

    def get_by_key(self, key: str) -> dict:
        return self[self.key_to_id[key]]

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]
