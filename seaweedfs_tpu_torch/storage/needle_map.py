"""Needle-map: in-memory needle id -> (offset, size) index with `.idx` append log.

Equivalent of weed/storage/needle_map_memory.go: a dict for O(1) lookup
plus sorted iteration on demand, with the counter bookkeeping done while
replaying the `.idx` log (needle_map_memory.go:35-56).  ``offset_size``
(4 or 5, the volume's) is the width of the `.idx` entries read and
written.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple, Optional

from . import idx as idx_mod
from .types import TOMBSTONE_FILE_SIZE, size_is_valid


class NeedleValue(NamedTuple):
    """One needle's entry (a tuple: the compact map makes one per lookup)."""

    key: int
    offset: int  # actual byte offset into the .dat file
    size: int


class MemoryNeedleMap:
    """NeedleMapper (storage/needle_map.go:22-36), memory kind, with the
    `.idx` append log as the persistence mechanism."""

    def __init__(self, index_path: Optional[str] = None, replay: bool = False,
                 offset_size: int = 4):
        self._m: dict[int, NeedleValue] = {}
        self.offset_size = offset_size
        self.index_path = index_path
        self._index_file = None
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.max_file_key = 0
        if index_path is not None:
            if replay:
                for key, offset, size in idx_mod.iter_index_file(
                        index_path, offset_size):
                    self._replay(key, offset, size)
            self._index_file = open(index_path, "ab")

    @classmethod
    def load(cls, index_path: str,
             offset_size: int = 4) -> "MemoryNeedleMap":
        return cls(index_path, replay=True, offset_size=offset_size)

    def _replay(self, key: int, offset: int, size: int) -> None:
        """doLoading semantics (needle_map_memory.go:35-56)."""
        self.max_file_key = max(self.max_file_key, key)
        if offset != 0 and size_is_valid(size):
            self.file_counter += 1
            self.file_byte_counter += size
            old = self._m.get(key)
            self._m[key] = NeedleValue(key, offset, size)
            if old is not None and old.offset != 0 and size_is_valid(old.size):
                self.deletion_counter += 1
                self.deletion_byte_counter += old.size
        else:
            old = self._m.pop(key, None)
            self.deletion_counter += 1
            if old is not None:
                self.deletion_byte_counter += old.size

    def put(self, key: int, offset: int, size: int) -> None:
        old = self._m.get(key)
        self._m[key] = NeedleValue(key, offset, size)
        self.max_file_key = max(self.max_file_key, key)
        self.file_counter += 1
        self.file_byte_counter += size
        if old is not None and size_is_valid(old.size):
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._append_index(key, offset, size)

    def delete(self, key: int, tombstone_offset: int) -> None:
        """Drop the entry and log (key, tombstone_offset, -1) in the index
        (needle_map_memory.go:67-71)."""
        old = self._m.pop(key, None)
        if old is not None and size_is_valid(old.size):
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._append_index(key, tombstone_offset, TOMBSTONE_FILE_SIZE)

    def _append_index(self, key: int, offset: int, size: int) -> None:
        if self._index_file is not None:
            self._index_file.write(
                idx_mod.pack_entry(key, offset, size, self.offset_size))
            self._index_file.flush()

    def get(self, key: int) -> Optional[NeedleValue]:
        return self._m.get(key)

    def __iter__(self) -> Iterator[NeedleValue]:
        # one copy of the values, taken at once: a reader that locks
        # nothing (volume.fsck's scan) may iterate while a write deletes
        return iter(sorted(self._m.values(), key=lambda nv: nv.key))

    def __len__(self) -> int:
        return len(self._m)

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    def sync(self) -> None:
        if self._index_file is not None:
            os.fsync(self._index_file.fileno())

    def close(self) -> None:
        if self._index_file is not None:
            self._index_file.close()
            self._index_file = None


class MemDb(MemoryNeedleMap):
    """Temp map used for .idx -> .ecx sorting (needle_map/memdb.go):
    no backing index file, plus reference `readNeedleMap` replay filtering
    (ec_encoder.go:289-306: tombstones delete, zero offsets delete)."""

    def __init__(self):
        super().__init__(index_path=None)

    @classmethod
    def from_idx_file(cls, index_path: str, offset_size: int = 4) -> "MemDb":
        db = cls()
        for key, offset, size in idx_mod.iter_index_file(index_path,
                                                         offset_size):
            if offset != 0 and size != TOMBSTONE_FILE_SIZE:
                db.set(key, offset, size)
            else:
                db.unset(key)
        return db

    def set(self, key: int, offset: int, size: int) -> None:
        self._m[key] = NeedleValue(key, offset, size)

    def unset(self, key: int) -> None:
        self._m.pop(key, None)

    def write_sorted_file(self, path: str, offset_size: int = 4) -> None:
        """WriteSortedFileFromIdx output: ascending sorted entries
        (ec_encoder.go:27-54)."""
        with open(path, "wb") as f:
            for nv in self:
                f.write(idx_mod.pack_entry(nv.key, nv.offset, nv.size,
                                           offset_size))
