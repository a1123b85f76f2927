"""The compact and persisted needle-map kinds.

The three NeedleMapper kinds beside the dict-based MemoryNeedleMap
(weed/storage/needle_map.go:13-20), as seaweedfs_tpu/storage/
needle_map_compact.py builds them.  Each takes the volume's
``offset_size``: 4, or 5 for a volume past 32 GB, whose `.idx`, `.sdx`
and offset units are wider.

- CompactNeedleMap (needle_map/compact_map.go:28), the volume's default:
  sorted numpy sections of 16-byte entries (key u64, offset in 8-byte
  units u32, size i32; the units are u64 on a 5-byte volume, 20 bytes
  an entry), binary-searched, so a live needle costs about 16 bytes of
  memory where a dict entry costs about 400.  Appends in
  ascending key order go to a tail of Python lists, sectioned every
  ``_TAIL_FLUSH`` entries; out-of-order keys go to an overflow dict,
  merged into new sections at ``_OVERFLOW_MERGE``.  Loading replays the
  whole `.idx` in one numpy pass (``_replay_arrays``), not per entry,
  then returns the heap its temporaries freed to the system.
  Readers take no lock of the volume, so the map guards its structure
  with its own: a tail flush or a merge replaces lists and sections.

- CheckpointedNeedleMap (needle_map_leveldb.go's place): a CompactNeedleMap
  that checkpoints its arrays and the `.idx` size it covers (the
  watermark) to a `.ldb` snapshot, written through a temporary file and a
  rename (offsets as u32, or u64 on a 5-byte volume); an open reads the snapshot and replays only the `.idx` bytes past
  the watermark.  A snapshot whose watermark lies past the `.idx` (the
  crash check cut the index) is thrown away and the whole index replayed.

- SortedFileNeedleMap (needle_map_sorted_file.go): the map is a key-sorted
  `.sdx` file searched with one pread per probe, nothing held in memory.
  For read-only volumes: put raises, delete negates the entry's size in
  place and logs the tombstone to the `.idx`.

Every kind keeps MemoryNeedleMap's counters (needle_map_memory.go:35-56):
put and delete count as MemoryNeedleMap's do, replay as doLoading does
(a delete of a key never live counts in replay, not live).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from bisect import bisect_left
from typing import Callable, Iterator, Optional

import numpy as np

from . import idx as idx_mod
from .needle_map import MemDb, MemoryNeedleMap, NeedleValue
from .types import NEEDLE_PADDING_SIZE, TOMBSTONE_FILE_SIZE, size_is_valid

_SECTION = 1 << 20          # entries per immutable section
_TAIL_FLUSH = 1 << 16       # ascending appends buffered before sectioning
_OVERFLOW_MERGE = 50_000    # out-of-order entries held before a merge

_COUNTERS = ("file_counter", "file_byte_counter", "deletion_counter",
             "deletion_byte_counter", "max_file_key")


_libc = None


def _return_freed_heap() -> None:
    """Hand the heap pages a replay's temporaries freed back to the system
    (glibc's malloc_trim; nothing elsewhere).  Once a large array is freed
    glibc raises its mmap threshold, so the next temporaries of up to 32
    MiB come from the heap and stay resident after they are freed: at a
    million needles that doubled the map's 16 bytes a needle."""
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL("libc.so.6").malloc_trim
        except (OSError, AttributeError):
            _libc = False
    if _libc:
        _libc(0)


def _units_dtype_of(width: int) -> type:
    """Offset units of ``width`` bytes (8: a 5-byte volume's) -> dtype."""
    return np.uint64 if width == 8 else np.uint32


def _replay_arrays(entries: np.ndarray) -> tuple[dict, np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """doLoading (needle_map_memory.go:35-56) over parsed `.idx` entries in
    one numpy pass -> (counters, live keys, offset units, sizes), sorted
    by key.  Within a key the later entry wins; a put over a live put, and
    any entry over a live one, count as deletions; a delete always counts
    in deletion_counter, live before or not.  The units keep the width
    they were parsed with: u64 from 5-byte entries, else u32."""
    counters = dict.fromkeys(_COUNTERS, 0)
    units_dtype = _units_dtype_of(entries["offset"].dtype.itemsize)
    n = len(entries)
    if n == 0:
        return (counters, np.empty(0, np.uint64), np.empty(0, units_dtype),
                np.empty(0, np.int32))
    keys = entries["key"].astype(np.uint64)
    offs = entries["offset"].astype(units_dtype)
    sizes = entries["size"].astype(np.int32)
    is_put = (offs != 0) & (sizes > 0)  # size_is_valid, vectorized
    counters["max_file_key"] = int(keys.max())
    counters["file_counter"] = int(is_put.sum())
    counters["file_byte_counter"] = int(sizes[is_put].astype(np.int64).sum())

    order = np.argsort(keys, kind="stable")
    sk, so, ss, sp = keys[order], offs[order], sizes[order], is_put[order]
    same_prev = np.zeros(n, dtype=bool)
    same_prev[1:] = sk[1:] == sk[:-1]
    prev_live = np.zeros(n, dtype=bool)
    prev_live[1:] = sp[:-1]
    consumed = same_prev & prev_live           # replaced a live put
    counters["deletion_counter"] = int((consumed & sp).sum() + (~sp).sum())
    prev_sizes = np.zeros(n, dtype=np.int64)
    prev_sizes[1:] = ss[:-1]
    counters["deletion_byte_counter"] = int(prev_sizes[consumed].sum())

    # the last entry of each key, kept if it is a put
    last = np.zeros(n, dtype=bool)
    last[:-1] = sk[:-1] != sk[1:]
    last[-1] = True
    live = last & sp
    return counters, sk[live], so[live], ss[live]


class _Section:
    """A sorted run of keys that never changes; offsets and sizes change
    in place.  Lookups go through memoryviews of the arrays: an element
    comes back as a Python int with none of numpy's per-call cost, and
    ``bisect`` searches the keys in place."""

    __slots__ = ("keys", "offs", "sizes", "k", "o", "s")

    def __init__(self, keys: np.ndarray, offs: np.ndarray, sizes: np.ndarray):
        self.keys = keys
        self.offs = offs
        self.sizes = sizes
        self.k, self.o, self.s = (memoryview(keys), memoryview(offs),
                                  memoryview(sizes))

    def find(self, key: int) -> int:
        i = bisect_left(self.k, key)
        if i < len(self.k) and self.k[i] == key:
            return i
        return -1


class CompactNeedleMap:
    """Numpy-sectioned needle map; see the module docstring."""

    def __init__(self, index_path: Optional[str] = None, replay: bool = False,
                 offset_size: int = 4):
        self.offset_size = offset_size
        # 4-byte volumes keep u32 units: 16 bytes a needle
        self._units_dtype = _units_dtype_of(8 if offset_size == 5 else 4)
        # guards the structure (tail lists, overflow, sections) against
        # readers that hold no lock of the volume
        self._mu = threading.RLock()
        self._sections: list[_Section] = []
        self._section_maxes: list[int] = []   # each section's largest key
        self._tail_k: list[int] = []          # strictly ascending appends
        self._tail_o: list[int] = []          # offsets in padding units
        self._tail_s: list[int] = []
        self._over: dict[int, tuple[int, int]] = {}  # key -> (units, size)
        self.index_path = index_path
        self._index_file = None
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.max_file_key = 0
        if index_path is not None:
            if replay and os.path.exists(index_path):
                with open(index_path, "rb") as f:
                    self._ingest_replay(f.read())
                _return_freed_heap()
            self._index_file = open(index_path, "ab")

    @classmethod
    def load(cls, index_path: str,
             offset_size: int = 4) -> "CompactNeedleMap":
        return cls(index_path, replay=True, offset_size=offset_size)

    def _ingest_replay(self, blob: bytes) -> None:
        counters, k, o, s = _replay_arrays(
            idx_mod.parse_entries(blob, self.offset_size))
        for name, v in counters.items():
            setattr(self, name, max(self.max_file_key, v)
                    if name == "max_file_key" else getattr(self, name) + v)
        self._install_arrays(k, o, s)

    def _install_arrays(self, k: np.ndarray, o: np.ndarray,
                        s: np.ndarray) -> None:
        for start in range(0, len(k), _SECTION):
            sec = _Section(k[start:start + _SECTION].copy(),
                           o[start:start + _SECTION].copy(),
                           s[start:start + _SECTION].copy())
            self._sections.append(sec)
            self._section_maxes.append(int(sec.keys[-1]))

    def _reset(self) -> None:
        """Empty map, counters at 0."""
        self._sections, self._section_maxes = [], []
        self._tail_k, self._tail_o, self._tail_s = [], [], []
        self._over = {}
        for name in _COUNTERS:
            setattr(self, name, 0)

    # --- lookup -----------------------------------------------------------
    def _find_section(self, key: int) -> tuple[Optional[_Section], int]:
        si = bisect_left(self._section_maxes, key)
        if si < len(self._sections):
            i = self._sections[si].find(key)
            if i >= 0:
                return self._sections[si], i
        return None, -1

    def _lookup(self, key: int) -> tuple[str, object, int, int]:
        """-> (where, ref, units, size); where is '' when the key is absent."""
        if key in self._over:
            units, size = self._over[key]
            return "over", None, units, size
        if self._tail_k:
            j = bisect_left(self._tail_k, key)
            if j < len(self._tail_k) and self._tail_k[j] == key:
                return "tail", j, self._tail_o[j], self._tail_s[j]
        sec, i = self._find_section(key)
        if sec is not None:
            return "sec", (sec, i), sec.o[i], sec.s[i]
        return "", None, 0, 0

    def get(self, key: int) -> Optional[NeedleValue]:
        with self._mu:
            where, _, units, size = self._lookup(key)
        # absent: never set, a tombstone, or never written.  A size-0 put
        # is live, as the dict map holds it
        if not where or size == TOMBSTONE_FILE_SIZE or units == 0:
            return None
        return NeedleValue(key, units * NEEDLE_PADDING_SIZE, size)

    # --- mutation ---------------------------------------------------------
    def _set(self, key: int, units: int, size: int) -> None:
        with self._mu:
            where, ref, _, _ = self._lookup(key)
            if where == "over":
                self._over[key] = (units, size)
            elif where == "tail":
                self._tail_o[ref] = units
                self._tail_s[ref] = size
            elif where == "sec":
                sec, i = ref
                sec.o[i] = units
                sec.s[i] = size
            else:
                last = self._tail_k[-1] if self._tail_k else (
                    self._section_maxes[-1] if self._section_maxes else -1)
                if key > last:
                    self._tail_k.append(key)
                    self._tail_o.append(units)
                    self._tail_s.append(size)
                    if len(self._tail_k) >= _TAIL_FLUSH:
                        self._flush_tail()
                else:
                    self._over[key] = (units, size)
                    if len(self._over) >= _OVERFLOW_MERGE:
                        self._rebuild()

    def _flush_tail(self) -> None:
        if not self._tail_k:
            return
        self._install_arrays(np.array(self._tail_k, dtype=np.uint64),
                             np.array(self._tail_o, dtype=self._units_dtype),
                             np.array(self._tail_s, dtype=np.int32))
        self._tail_k, self._tail_o, self._tail_s = [], [], []

    def _rebuild(self) -> None:
        """Merge overflow, tail and sections into new sorted sections."""
        with self._mu:
            self._flush_tail()
            parts_k = [s.keys for s in self._sections]
            parts_o = [s.offs for s in self._sections]
            parts_s = [s.sizes for s in self._sections]
            if self._over:
                parts_k.append(np.fromiter(self._over.keys(),
                                           dtype=np.uint64,
                                           count=len(self._over)))
                vals = list(self._over.values())
                parts_o.append(np.array([v[0] for v in vals],
                                        dtype=self._units_dtype))
                parts_s.append(np.array([v[1] for v in vals],
                                        dtype=np.int32))
            if not parts_k:
                return
            k = np.concatenate(parts_k)
            o = np.concatenate(parts_o)
            s = np.concatenate(parts_s)
            # the overflow came last: a stable sort keeping the last of
            # each key gives it precedence (no key should be in both)
            order = np.argsort(k, kind="stable")
            k, o, s = k[order], o[order], s[order]
            last = np.ones(len(k), dtype=bool)
            last[:-1] = k[:-1] != k[1:]
            k, o, s = k[last], o[last], s[last]
            self._sections, self._section_maxes, self._over = [], [], {}
            self._install_arrays(k, o, s)

    def put(self, key: int, offset: int, size: int) -> None:
        old = self.get(key)
        self._set(key, offset // NEEDLE_PADDING_SIZE, size)
        self.max_file_key = max(self.max_file_key, key)
        self.file_counter += 1
        self.file_byte_counter += size
        if old is not None and size_is_valid(old.size):
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._append_index(key, offset, size)

    def delete(self, key: int, tombstone_offset: int) -> None:
        """MemoryNeedleMap.delete's counters: only a live needle counts
        (replay alone counts a delete of a key never live)."""
        old = self.get(key)
        if old is not None:
            self._set(key, old.offset // NEEDLE_PADDING_SIZE,
                      TOMBSTONE_FILE_SIZE)
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._append_index(key, tombstone_offset, TOMBSTONE_FILE_SIZE)

    def _append_index(self, key: int, offset: int, size: int) -> None:
        if self._index_file is not None:
            self._index_file.write(
                idx_mod.pack_entry(key, offset, size, self.offset_size))
            self._index_file.flush()

    # --- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[NeedleValue]:
        """Every entry but tombstones, size-0 puts included, ascending by
        key over a copy of the structure taken at once."""
        with self._mu:
            sections = list(self._sections)
            tail = list(zip(self._tail_k, self._tail_o, self._tail_s))
            over = sorted((k, u, s) for k, (u, s) in self._over.items())

        def main() -> Iterator[tuple[int, int, int]]:
            for sec in sections:
                for a in range(0, len(sec.keys), _TAIL_FLUSH):
                    b = a + _TAIL_FLUSH
                    yield from zip(sec.keys[a:b].tolist(),
                                   sec.offs[a:b].tolist(),
                                   sec.sizes[a:b].tolist())
            yield from tail

        oi = 0
        for k, u, s in main():
            while oi < len(over) and over[oi][0] < k:
                ok, ou, osz = over[oi]
                oi += 1
                if osz != TOMBSTONE_FILE_SIZE:
                    yield NeedleValue(ok, ou * NEEDLE_PADDING_SIZE, osz)
            if s != TOMBSTONE_FILE_SIZE:
                yield NeedleValue(k, u * NEEDLE_PADDING_SIZE, s)
        for ok, ou, osz in over[oi:]:
            if osz != TOMBSTONE_FILE_SIZE:
                yield NeedleValue(ok, ou * NEEDLE_PADDING_SIZE, osz)

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self:
            fn(nv)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    def sync(self) -> None:
        if self._index_file is not None:
            self._index_file.flush()
            os.fsync(self._index_file.fileno())

    def close(self) -> None:
        if self._index_file is not None:
            self._index_file.close()
            self._index_file = None


_LDB_MAGIC = b"SWTPUNM1"
# magic, watermark, entries, then the five counters
_LDB_HEADER = struct.Struct(">8sQQQQQQQ")


def snapshot_path_for(index_path: str) -> str:
    return os.path.splitext(index_path)[0] + ".ldb"


class CheckpointedNeedleMap(CompactNeedleMap):
    """A CompactNeedleMap checkpointed to `<name>.ldb`: an open reads the
    snapshot and replays only the `.idx` past its watermark."""

    CHECKPOINT_EVERY = 100_000  # index appends between checkpoints

    def __init__(self, index_path: str, replay: bool = True,
                 offset_size: int = 4):
        self.snapshot_path = snapshot_path_for(index_path)
        self._since_checkpoint = 0
        self._loaded_from_snapshot = False
        super().__init__(index_path, replay=False, offset_size=offset_size)
        if replay:
            self._load_with_snapshot()
            _return_freed_heap()

    @classmethod
    def load(cls, index_path: str,
             offset_size: int = 4) -> "CheckpointedNeedleMap":
        return cls(index_path, replay=True, offset_size=offset_size)

    def _load_with_snapshot(self) -> None:
        idx_size = (os.path.getsize(self.index_path)
                    if os.path.exists(self.index_path) else 0)
        watermark = 0
        if os.path.exists(self.snapshot_path):
            try:
                watermark = self._read_snapshot()
                self._loaded_from_snapshot = True
            except (OSError, ValueError, struct.error):
                self._reset()  # unreadable: replay the whole index
                watermark = 0
        if watermark > idx_size:
            # the index was cut below the snapshot: it describes entries
            # that no longer exist
            self._reset()
            watermark = 0
            self._loaded_from_snapshot = False
        if idx_size <= watermark:
            return
        with open(self.index_path, "rb") as f:
            f.seek(watermark)
            blob = f.read(idx_size - watermark)
        if not watermark:  # no snapshot: the whole index in one pass
            self._ingest_replay(blob)
            return
        tail = idx_mod.parse_entries(blob, self.offset_size)
        # the tail applies over the snapshot's state, entry by entry
        for key, units, size in zip(tail["key"].tolist(),
                                    tail["offset"].tolist(),
                                    tail["size"].tolist()):
            self.max_file_key = max(self.max_file_key, key)
            old = self.get(key)
            if units != 0 and size_is_valid(size):
                self._set(key, units, size)
                self.file_counter += 1
                self.file_byte_counter += size
                if old is not None:
                    self.deletion_counter += 1
                    self.deletion_byte_counter += old.size
            else:
                if old is not None:
                    self._set(key, old.offset // NEEDLE_PADDING_SIZE,
                              TOMBSTONE_FILE_SIZE)
                    self.deletion_byte_counter += old.size
                self.deletion_counter += 1

    def _read_snapshot(self) -> int:
        with open(self.snapshot_path, "rb") as f:
            magic, watermark, n, *counters = _LDB_HEADER.unpack(
                f.read(_LDB_HEADER.size))
            if magic != _LDB_MAGIC:
                raise ValueError("bad snapshot magic")
            ow = np.dtype(self._units_dtype).itemsize
            k = np.frombuffer(f.read(8 * n), dtype="<u8")
            o = np.frombuffer(f.read(ow * n), dtype=f"<u{ow}")
            s = np.frombuffer(f.read(4 * n), dtype="<i4")
            if len(k) != n or len(o) != n or len(s) != n:
                raise ValueError("short snapshot")
        for name, v in zip(_COUNTERS, counters):
            setattr(self, name, v)
        self._install_arrays(k.astype(np.uint64), o.astype(self._units_dtype),
                             s.astype(np.int32))
        return watermark

    def checkpoint(self) -> None:
        """Write the state and the `.idx` size it covers, the index synced
        first so the watermark never names bytes that are not durable."""
        self.sync()
        watermark = (os.path.getsize(self.index_path)
                     if os.path.exists(self.index_path) else 0)
        self._rebuild()  # tail and overflow into the sections
        with self._mu:
            sections = list(self._sections)
        k = np.concatenate([s.keys for s in sections] or
                           [np.empty(0, np.uint64)])
        o = np.concatenate([s.offs for s in sections] or
                           [np.empty(0, self._units_dtype)])
        s = np.concatenate([s.sizes for s in sections] or
                           [np.empty(0, np.int32)])
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_LDB_HEADER.pack(
                _LDB_MAGIC, watermark, len(k),
                *(getattr(self, name) for name in _COUNTERS)))
            f.write(k.astype("<u8").tobytes())
            f.write(o.astype(f"<u{o.itemsize}").tobytes())
            f.write(s.astype("<i4").tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        self._since_checkpoint = 0

    def _append_index(self, key: int, offset: int, size: int) -> None:
        super()._append_index(key, offset, size)
        self._since_checkpoint += 1
        if self._since_checkpoint >= self.CHECKPOINT_EVERY:
            self.checkpoint()

    def close(self) -> None:
        if self._index_file is not None:
            self.checkpoint()
        super().close()


def sorted_path_for(index_path: str) -> str:
    return os.path.splitext(index_path)[0] + ".sdx"


class SortedFileNeedleMap:
    """The sorted-file kind: lookups binary-search `<name>.sdx` with
    pread, made from the `.idx` when absent; nothing held in memory."""

    def __init__(self, index_path: str, offset_size: int = 4):
        self.index_path = index_path
        self.offset_size = offset_size
        self._es = idx_mod.entry_size(offset_size)
        self.sorted_path = sorted_path_for(index_path)
        if not os.path.exists(self.sorted_path):
            MemDb.from_idx_file(index_path, offset_size).write_sorted_file(
                self.sorted_path, offset_size)
        self._f = open(self.sorted_path, "r+b")
        self._n = os.path.getsize(self.sorted_path) // self._es
        self._index_file = open(index_path, "ab")
        # the counters come from one scan of the sorted file
        m = MemoryNeedleMap()
        for nv in self:
            if size_is_valid(nv.size):
                m.put(nv.key, nv.offset, nv.size)
        self.file_counter = m.file_counter
        self.file_byte_counter = m.file_byte_counter
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.max_file_key = m.max_file_key

    @classmethod
    def load(cls, index_path: str,
             offset_size: int = 4) -> "SortedFileNeedleMap":
        return cls(index_path, offset_size=offset_size)

    def _entry_at(self, i: int) -> tuple[int, int, int]:
        e = idx_mod.parse_entries(os.pread(
            self._f.fileno(), self._es, i * self._es), self.offset_size)[0]
        return int(e["key"]), int(e["offset"]), int(e["size"])

    def _search(self, key: int) -> int:
        lo, hi = 0, self._n
        while lo < hi:
            mid = (lo + hi) // 2
            if self._entry_at(mid)[0] < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < self._n and self._entry_at(lo)[0] == key:
            return lo
        return -1

    def get(self, key: int) -> Optional[NeedleValue]:
        i = self._search(key)
        if i < 0:
            return None
        _, units, size = self._entry_at(i)
        if units == 0 or not size_is_valid(size):
            return None
        return NeedleValue(key, units * NEEDLE_PADDING_SIZE, size)

    def put(self, key: int, offset: int, size: int) -> None:
        raise PermissionError(
            "sorted-file needle map is read-only (needle_map_sorted_file.go)")

    def delete(self, key: int, tombstone_offset: int) -> None:
        i = self._search(key)
        if i >= 0:
            k, units, size = self._entry_at(i)
            if size_is_valid(size):
                # deleted in place: size -> -size
                self._f.seek(i * self._es)
                self._f.write(idx_mod.pack_entry(
                    k, units * NEEDLE_PADDING_SIZE, -size, self.offset_size))
                self._f.flush()
                self.deletion_counter += 1
                self.deletion_byte_counter += size
        self._index_file.write(idx_mod.pack_entry(
            key, tombstone_offset, TOMBSTONE_FILE_SIZE, self.offset_size))
        self._index_file.flush()

    def __iter__(self) -> Iterator[NeedleValue]:
        """Every entry of the sorted file, deleted ones (negative sizes)
        included, as the reference's iteration gives them."""
        for i in range(self._n):
            k, units, size = self._entry_at(i)
            yield NeedleValue(k, units * NEEDLE_PADDING_SIZE, size)

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self:
            if size_is_valid(nv.size):
                fn(nv)

    def __len__(self) -> int:
        return sum(1 for nv in self if size_is_valid(nv.size))

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._index_file.flush()
        os.fsync(self._index_file.fileno())

    def close(self) -> None:
        if self._index_file is not None:
            self._index_file.close()
            self._index_file = None
        if self._f is not None:
            self._f.close()
            self._f = None


NEEDLE_MAP_KINDS = {
    "memory": MemoryNeedleMap,
    "compact": CompactNeedleMap,
    "ldb": CheckpointedNeedleMap,
    "sorted": SortedFileNeedleMap,
}
