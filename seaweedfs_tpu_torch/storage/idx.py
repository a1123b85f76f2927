"""`.idx` / `.ecx` index-file entries: (key u64, offset, size i32).

Byte-compatible with weed/storage/idx/walk.go.  Offsets are stored in
units of NEEDLE_PADDING_SIZE (8 bytes); a zero offset means "never
written", size==-1 means tombstone.  Parsing is vectorized with numpy.

Two offset widths, per volume (the reference's 5BytesOffset build tag,
weed/storage/types/offset_5bytes.go, made a per-volume option as
seaweedfs_tpu/storage/idx.py makes it):
  - 4 bytes (default): u32 BE units, 16-byte entries, 32GB volumes;
  - 5 bytes: the low u32 BE at [8:12], the high byte at [12], the size
    at [13:17]: 17-byte entries, 8TB volumes.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

import numpy as np

from .types import NEEDLE_PADDING_SIZE

# big-endian struct dtype matching IdxFileEntry (idx/walk.go:45-50)
IDX_DTYPE = np.dtype([("key", ">u8"), ("offset", ">u4"), ("size", ">i4")])
# a 5-byte entry as it lies on disk
IDX_DTYPE_5_RAW = np.dtype([("key", ">u8"), ("off_lo", ">u4"),
                            ("off_hi", "u1"), ("size", ">i4")])
# a 5-byte entry parsed: the offset's two parts joined
IDX_DTYPE_5 = np.dtype([("key", np.uint64), ("offset", np.uint64),
                        ("size", np.int32)])

_PACK5 = struct.Struct(">QIBi")


def entry_size(offset_size: int = 4) -> int:
    """16 bytes an entry with 4-byte offsets, 17 with 5-byte ones."""
    return 8 + offset_size + 4


def pack_entry(key: int, actual_offset: int, size: int,
               offset_size: int = 4) -> bytes:
    units = actual_offset // NEEDLE_PADDING_SIZE
    if offset_size == 4:
        arr = np.zeros(1, dtype=IDX_DTYPE)
        arr[0] = (key, units, size)
        return arr.tobytes()
    return _PACK5.pack(key, units & 0xFFFFFFFF, (units >> 32) & 0xFF, size)


def parse_entries(buf: bytes, offset_size: int = 4) -> np.ndarray:
    """Decode a whole index file at once -> structured array
    (key, offset, size); a torn last entry is ignored.  Offset is left in
    padding units; multiply by 8 for byte offsets."""
    es = entry_size(offset_size)
    usable = len(buf) - (len(buf) % es)
    if offset_size == 4:
        return np.frombuffer(buf[:usable], dtype=IDX_DTYPE)
    raw = np.frombuffer(buf[:usable], dtype=IDX_DTYPE_5_RAW)
    out = np.empty(len(raw), dtype=IDX_DTYPE_5)
    out["key"] = raw["key"]
    out["offset"] = (raw["off_lo"].astype(np.uint64)
                     | (raw["off_hi"].astype(np.uint64) << np.uint64(32)))
    out["size"] = raw["size"]
    return out


def iter_index_file(path: str,
                    offset_size: int = 4) -> Iterator[tuple[int, int, int]]:
    """(key, byte offset, size) per entry, in file order."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        entries = parse_entries(f.read(), offset_size)
    for i in range(len(entries)):
        yield (
            int(entries["key"][i]),
            int(entries["offset"][i]) * NEEDLE_PADDING_SIZE,
            int(entries["size"][i]),
        )
