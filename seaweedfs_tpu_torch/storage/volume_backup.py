"""Incremental volume sync: tail a volume's `.dat` by AppendAtNs.

seaweedfs_tpu/storage/volume_backup.py (weed/storage/volume_backup.go).
``binary_search_by_append_at_ns`` (:171) finds the first index entry whose
record was appended after a time: entries are in append order, so the
times their records carry never fall.  ``records_since`` (IncrementalBackup,
:66) sends the raw records from there on, at most ``max_bytes`` a call,
and the time of the last one sent; the follower applies them through the
needle codec (``apply_records``: a record with data is written, one
without replays as a delete) and asks again from that time until nothing
comes back (``incremental_backup``).  The records keep their append times,
so the follower's `.dat` is the source's, byte for byte.  The index is
read in the volume's own width (17-byte entries on a 5-byte volume).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

import numpy as np

from .idx import parse_entries
from .needle import (Needle, SizeMismatchError, get_actual_size,
                     needle_body_length)
from .types import (NEEDLE_CHECKSUM_SIZE, NEEDLE_HEADER_SIZE,
                    NEEDLE_PADDING_SIZE, TIMESTAMP_SIZE, bytes_to_size,
                    bytes_to_u64, size_is_valid)
from .volume import Volume

# .dat bytes records_since reads at a time
_TAIL_WINDOW = 4 << 20


def _index_entries(volume: Volume) -> Optional[np.ndarray]:
    if not os.path.exists(volume.idx_path):
        return None
    with open(volume.idx_path, "rb") as f:
        return parse_entries(f.read(), volume.offset_size)


def _entry_append_at_ns(volume: Volume, offset: int, size: int) -> int:
    """The append time of the record an index entry names, from its 8
    bytes alone: the search must not read large needles' data."""
    if offset == 0:
        return 0
    read_size = size if size_is_valid(size) else 0
    ts_pos = offset + NEEDLE_HEADER_SIZE + read_size + NEEDLE_CHECKSUM_SIZE
    tail = volume._read_at(ts_pos, TIMESTAMP_SIZE)
    return bytes_to_u64(tail) if len(tail) == TIMESTAMP_SIZE else 0


def binary_search_by_append_at_ns(volume: Volume, since_ns: int,
                                  entries=None) -> Optional[int]:
    """The first index entry whose record was appended after ``since_ns``,
    None when nothing is newer (volume_backup.go:171-209).  An entry of
    offset 0 carries no time: the search probes its left neighbours."""
    if entries is None:
        entries = _index_entries(volume)
        if entries is None:
            return None
    offsets = entries["offset"]
    lo, hi = 0, len(entries)
    while lo < hi:
        mid = (lo + hi) // 2
        probe = mid
        ts = 0
        while probe >= lo:
            off = int(offsets[probe]) * NEEDLE_PADDING_SIZE
            if off != 0:
                ts = _entry_append_at_ns(volume, off,
                                         int(entries["size"][probe]))
                break
            probe -= 1
        if ts > since_ns:
            hi = probe if probe < mid else mid
        else:
            lo = mid + 1
    return lo if lo < len(entries) else None


def records_since(volume: Volume, since_ns: int,
                  max_bytes: int = 64 * 1024 * 1024) -> tuple[bytes, int]:
    """The raw records appended after ``since_ns``, at most ``max_bytes``
    (one record at least), and the append time of the last one sent
    (``since_ns`` when none was)."""
    all_entries = _index_entries(volume)
    if all_entries is None:
        return b"", since_ns
    start = binary_search_by_append_at_ns(volume, since_ns, all_entries)
    if start is None:
        return b"", since_ns
    entries = all_entries[start:]
    out = bytearray()
    last_ts = since_ns
    # records in append order lie one after another: read them a window
    # at a time, a record outside the window on its own
    window, window_off = b"", 0
    for key, units, size in zip(entries["key"].tolist(),
                                entries["offset"].tolist(),
                                entries["size"].tolist()):
        if units == 0:
            continue
        read_size = size if size_is_valid(size) else 0
        offset = units * NEEDLE_PADDING_SIZE
        length = get_actual_size(read_size, volume.version)
        rel = offset - window_off
        if rel < 0 or rel + length > len(window):
            window_off, rel = offset, 0
            window = volume._read_at(offset, max(length, _TAIL_WINDOW))
        blob = window[rel:rel + length]
        ts_off = NEEDLE_HEADER_SIZE + read_size + NEEDLE_CHECKSUM_SIZE
        if len(blob) < ts_off + TIMESTAMP_SIZE:
            raise ValueError(f"needle {key}: record cut short")
        found = bytes_to_size(blob[12:16])
        if found != read_size:
            raise SizeMismatchError(
                f"found size {found}, expected {read_size}")
        ts = bytes_to_u64(blob[ts_off:ts_off + TIMESTAMP_SIZE])
        if ts <= since_ns:
            continue
        if out and len(out) + len(blob) > max_bytes:
            break
        out += blob
        last_ts = ts
    return bytes(out), last_ts


def iter_records(blob: bytes, version) -> Iterator[Needle]:
    """The needles of a records_since blob (the receiver's side)."""
    offset = 0
    while offset + NEEDLE_HEADER_SIZE <= len(blob):
        n = Needle()
        n.parse_header(blob[offset:offset + NEEDLE_HEADER_SIZE])
        size = n.size if size_is_valid(n.size) else 0
        end = offset + NEEDLE_HEADER_SIZE + needle_body_length(size, version)
        if end > len(blob):
            break
        n.read_body_bytes(blob[offset + NEEDLE_HEADER_SIZE:end], version)
        yield n
        offset = end


def apply_records(volume: Volume, blob: bytes) -> int:
    """Append tailed records to a follower: a needle with data is written,
    a record without replays as a delete.  Returns the records applied."""
    count = 0
    with volume.write_lock:  # one hold for the blob's records
        for n in iter_records(blob, volume.version):
            if n.size > 0:
                volume._do_write(n, False)
            else:
                volume._do_delete(n)
            count += 1
    return count


def last_appended_ns(volume: Volume) -> int:
    """The append time of the volume's newest record, read through the
    index's tail, so a follower opened anew resumes where it stopped."""
    entries = _index_entries(volume)
    if entries is None:
        return 0
    for i in range(len(entries) - 1, -1, -1):
        off = int(entries["offset"][i]) * NEEDLE_PADDING_SIZE
        if off != 0:
            return _entry_append_at_ns(volume, off, int(entries["size"][i]))
    return 0


def incremental_backup(follower: Volume,
                       fetch: Callable[[int], tuple[bytes, int]]) -> int:
    """fetch(since_ns) -> (blob, last_ts) until a blob comes back empty;
    returns the records applied (volume_backup.go:66)."""
    total = 0
    since = max(follower.last_append_at_ns, last_appended_ns(follower))
    while True:
        blob, last_ts = fetch(since)
        if not blob:
            return total
        total += apply_records(follower, blob)
        since = last_ts
