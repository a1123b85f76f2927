"""Volume: one append-only `.dat` + `.idx` pair with superblock and needle map.

The subset of seaweedfs_tpu/storage/volume.py (weed/storage/volume.go +
volume_write.go + volume_read.go) that the volume server needs: create or
open, append and delete needles, read them back, and describe the volume
to the master.  Version 3 needles, 4-byte `.idx` offsets and the
in-memory needle map replayed from the `.idx` log.  The files are
byte-compatible with the reference's, so either package reads volumes the
other wrote.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from .needle import Needle, get_actual_size
from .needle_map import MemoryNeedleMap
from .super_block import SUPER_BLOCK_SIZE, ReplicaPlacement, SuperBlock
from .ttl import TTL
from .types import MAX_POSSIBLE_VOLUME_SIZE, NEEDLE_HEADER_SIZE, Version, size_is_valid


class NotFoundError(KeyError):
    pass


class DeletedError(KeyError):
    pass


class CookieMismatchError(ValueError):
    pass


def volume_file_prefix(directory: str, collection: str, vid: int) -> str:
    name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(directory, name)


class Volume:
    def __init__(self, directory: str, collection: str, vid: int,
                 replica_placement: Optional[ReplicaPlacement] = None,
                 ttl: Optional[TTL] = None):
        """Open the volume, or create it with ``replica_placement`` and
        ``ttl`` in its superblock (an existing volume keeps its own)."""
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.collection = collection
        self.id = vid
        self.read_only = False
        self.last_modified_ts_seconds = 0
        self.file_prefix = volume_file_prefix(directory, collection, vid)
        # serializes appends to .dat/.idx (dataFileAccessLock)
        self.write_lock = threading.Lock()
        self._fd = os.open(self.dat_path, os.O_RDWR | os.O_CREAT, 0o644)
        size = os.fstat(self._fd).st_size
        if size < SUPER_BLOCK_SIZE:
            self.super_block = SuperBlock(
                version=Version.V3,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or TTL())
            os.pwrite(self._fd, self.super_block.to_bytes(), 0)
        else:
            self.super_block = SuperBlock.from_bytes(
                os.pread(self._fd, SUPER_BLOCK_SIZE + 0xFFFF, 0))
            # a loaded volume is as old as its file (volume_loading.go:63)
            self.last_modified_ts_seconds = int(os.path.getmtime(
                self.dat_path))
        self.version = self.super_block.version
        if self.version != Version.V3 or self.super_block.offset_size != 4:
            os.close(self._fd)
            raise ValueError(f"volume {vid}: only version 3 volumes with "
                             "4-byte offsets are supported")
        self._size = os.fstat(self._fd).st_size
        self.nm = MemoryNeedleMap.load(self.idx_path)

    @property
    def dat_path(self) -> str:
        return self.file_prefix + ".dat"

    @property
    def idx_path(self) -> str:
        return self.file_prefix + ".idx"

    @property
    def data_size(self) -> int:
        return self._size

    def close(self) -> None:
        with self.write_lock:
            if self.nm is not None:
                self.nm.close()
                self.nm = None
            if self._fd >= 0:
                os.fsync(self._fd)
                os.close(self._fd)
                self._fd = -1

    def sync(self) -> None:
        """Make every append so far durable: `.dat`, then `.idx`."""
        with self.write_lock:
            os.fsync(self._fd)
            self.nm.sync()

    def destroy(self) -> None:
        """Close and remove the volume's files."""
        self.close()
        for path in (self.dat_path, self.idx_path):
            if os.path.exists(path):
                os.remove(path)

    # --- write path (volume_write.go) ---------------------------------
    def _read_needle_at(self, offset: int, size: int) -> Needle:
        blob = os.pread(self._fd, get_actual_size(size, self.version), offset)
        return Needle.from_bytes(blob, size, self.version)

    def _is_file_unchanged(self, n: Needle) -> bool:
        if str(self.super_block.ttl):
            return False
        nv = self.nm.get(n.id)
        if nv is None or nv.offset == 0 or not size_is_valid(nv.size):
            return False
        old = self._read_needle_at(nv.offset, nv.size)
        return old.cookie == n.cookie and old.data == n.data

    def _append(self, n: Needle) -> int:
        """Append n's record at EOF (write_lock held); returns its offset.
        A failed write is truncated back (needle_read_write.go:136-166)."""
        if not n.append_at_ns:
            n.append_at_ns = time.time_ns()
        blob = n.to_bytes(self.version)
        offset = self._size
        try:
            written = os.pwrite(self._fd, blob, offset)
            if written != len(blob):
                raise OSError(f"short write {written} != {len(blob)}")
        except OSError:
            os.ftruncate(self._fd, offset)
            raise
        self._size = offset + len(blob)
        return offset

    def write_needle(self, n: Needle) -> tuple[int, int, bool]:
        """doWriteRequest (volume_write.go:130-178): append the record,
        then log it in the index.  Returns (offset, size, is_unchanged)."""
        with self.write_lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read only")
            actual = get_actual_size(len(n.data), self.version)
            if MAX_POSSIBLE_VOLUME_SIZE < self.nm.content_size + actual:
                raise OSError(f"volume size limit {MAX_POSSIBLE_VOLUME_SIZE} "
                              "exceeded")
            if self._is_file_unchanged(n):
                return 0, len(n.data), True
            nv = self.nm.get(n.id)
            if nv is not None:
                existing = Needle()
                existing.parse_header(
                    os.pread(self._fd, NEEDLE_HEADER_SIZE, nv.offset))
                if existing.cookie != n.cookie:
                    raise CookieMismatchError(
                        f"mismatching cookie {n.cookie:x}")
            offset = self._append(n)
            self.nm.put(n.id, offset, n.size)
            if self.last_modified_ts_seconds < n.last_modified:
                self.last_modified_ts_seconds = n.last_modified
            return offset, n.size, False

    def delete_needle(self, n: Needle) -> int:
        """doDeleteRequest (volume_write.go:212-240): append a zero-data
        tombstone record, then log the tombstone in the index.  Returns
        the deleted needle's size, 0 when there was none."""
        with self.write_lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read only")
            nv = self.nm.get(n.id)
            if nv is None or not size_is_valid(nv.size):
                return 0
            n.data = b""
            self.nm.delete(n.id, self._append(n))
            return nv.size

    # --- read path (volume_read.go) ------------------------------------
    def read_needle(self, key: int, cookie: Optional[int] = None) -> Needle:
        """readNeedle (volume_read.go:16-63) + handler-level cookie check."""
        nv = self.nm.get(key)
        if nv is None or nv.offset == 0:
            raise NotFoundError(key)
        if not size_is_valid(nv.size):
            raise DeletedError(key)
        n = self._read_needle_at(nv.offset, nv.size)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatchError(f"cookie mismatch for {key}")
        if n.ttl is not None and n.ttl.minutes and n.last_modified:
            expire_ns = n.append_at_ns + n.ttl.minutes * 60 * 1_000_000_000
            if time.time_ns() >= expire_ns:
                raise NotFoundError(key)
        return n

    # --- info -----------------------------------------------------------
    def to_volume_information(self) -> dict:
        """The volume as the master's heartbeat handler reads it (the
        keys of seaweedfs_tpu/storage/volume.py to_volume_information)."""
        return {
            "id": self.id,
            "size": self.data_size,
            "collection": self.collection,
            "file_count": self.nm.file_counter,
            "delete_count": self.nm.deletion_counter,
            "deleted_byte_count": self.nm.deletion_byte_counter,
            "read_only": self.read_only,
            "replica_placement": self.super_block.replica_placement.to_byte(),
            "version": int(self.version),
            "ttl": self.super_block.ttl.to_u32(),
            "compact_revision": self.super_block.compaction_revision,
            "modified_at_second": self.last_modified_ts_seconds,
            "max_file_key": self.nm.max_file_key,
        }
