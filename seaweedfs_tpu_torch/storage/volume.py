"""Volume: one append-only `.dat` + `.idx` pair with superblock and needle map.

The subset of seaweedfs_tpu/storage/volume.py (weed/storage/volume.go +
volume_write.go + volume_read.go + volume_vacuum.go + volume_checking.go)
that the volume server needs: create or open, append and delete needles,
read them back, describe the volume to the master, and vacuum it.
Version 3 needles.  The files are byte-compatible with the reference's,
so either package reads volumes the other wrote.

A volume's `.idx` offsets are 4 bytes wide (16-byte entries, volumes up
to 32 GB) or, made with ``offset_5``, 5 bytes (17-byte entries, up to
8 TB): the reference's 5BytesOffset build tag (weed/storage/types/
offset_5bytes.go) as a per-volume option, flagged by bit 0 of the
superblock's extra byte, which a reopen reads back.  Every `.idx`, map,
crash check, compaction and backup of the volume keeps its width.

The needle map is of the volume's ``needle_map_kind``
(needle_map_compact.py): "compact" (the default: numpy sections, about 16
bytes a needle, the `.idx` replayed in one vectorized pass), "memory" (a
dict, about 400 bytes a needle), "ldb" (compact, checkpointed to a `.ldb`
snapshot so an open replays only the `.idx` past it) or "sorted" (a
key-sorted `.sdx` searched on disk, for read-only volumes).  A commit's
rebuilt map, and a rollback's, keep the kind.

``write_needle`` and ``delete_needle`` append under ``write_lock`` with no
durability barrier; ``write_needle2`` and ``delete_needle2`` with
``fsync`` go through the group-commit worker (volume_write.py), which
makes a batch of up to 128 requests durable with one fsync of the `.dat`
and one of the `.idx` (the reference fsyncs the `.dat` alone).  A compaction
commit and ``close`` park the worker before they take ``write_lock``; a
parked worker's writers append and fsync directly.  ``scan`` visits every
record of the `.dat` in file order (export's walk).

Every open ends with the crash check (CheckAndFixVolumeDataIntegrity): a
torn `.idx` entry is cut, index entries that point past the `.dat` or at
another needle are dropped from the tail, and the `.dat` is truncated past
the furthest record the kept entries name.

Vacuum copies the live needles into `.cpd`/`.cpx` (``compact``), then
``commit_compact`` replays what was appended meanwhile and swaps the
files in.  ``check_needles`` is volume.fsck's scan of every live record
against its stored CRC; ``configure_replication`` rewrites the
superblock's replica placement in place.  ``read_needle_meta`` and
``read_needle_data`` serve a Range GET's bytes without the rest of the
needle.  Reads take no lock, so the
swap is made safe for them this way: readers use the (needle map, `.dat`
handle) pair published last.
The commit builds the new pair over the compacted files, crash check
included, before it publishes it, and the old handle closes only when its
last reader has left: a read sees either the old files whole or the new
ones whole, never a closed or reused descriptor.  A read that took the old
pair just as its handle closed retries on the new one, already published;
so no read waits out a swap, where the reference's ``_read_at`` retries
for up to 2 s.

The `.dat` is a storage/backend.py file: ``DiskFile`` (pread), or with
``use_mmap`` (``volume -mmap``) ``MemoryMappedFile``, read through a
shared mapping and written with pwrite, so its bytes on disk are the same.

Tiering moves the `.dat` to a named backend (``-tier.backends``) in two
phases, crash-safe through the `.tier` manifest, the write-ahead record of
every move (``tier_*``, volume_grpc_tier_upload.go / _download.go):

  uploading  written before the first remote byte: a crash leaves the
             local `.dat` authoritative, and recovery deletes the partial
             object the manifest names;
  pending    uploaded and verified (size and crc32 read back from the
             backend); the local `.dat` is kept and writes are frozen;
             recovery still deletes the remote copy;
  committed  the `.vif` names the remote file and the local `.dat` may
             go; recovery finishes the commit;
  recalling  a verified download in flight to a temporary file: a crash
             leaves the volume tiered, and a whole, verified `.dat` lets
             recovery finish the recall.

A volume with a `.vif` and no `.dat` opens tiered: read-only, every read a
ranged read of the remote object (``RemoteFile``), the `.idx` local.  An
open first runs ``tier_recover``.  The tier moves publish the new (needle
map, file) pair as a commit does, so a read never fails across one: the
recall serves from the remote object until the verified `.dat` is in
place, and deletes the object only after.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional, TypeVar, Union

import numpy as np

from ..utils import faultinject
from . import idx as idx_mod
from .backend import DiskFile as _DatFile
from .backend import (HandleClosedError, MemoryMappedFile, RemoteFile,
                      crc32_of_file, crc32_of_remote, get_backend)
from .needle import (Needle, get_actual_size, needle_body_length,
                     parse_needle_tail)
from .needle_map import MemoryNeedleMap
from .needle_map_compact import (NEEDLE_MAP_KINDS, CompactNeedleMap,
                                 SortedFileNeedleMap, snapshot_path_for,
                                 sorted_path_for)
from .super_block import SUPER_BLOCK_SIZE, ReplicaPlacement, SuperBlock
from .ttl import TTL
from .types import (MAX_POSSIBLE_VOLUME_SIZE, NEEDLE_CHECKSUM_SIZE,
                    NEEDLE_HEADER_SIZE, NEEDLE_PADDING_SIZE, TIMESTAMP_SIZE,
                    Version, bytes_to_u32, size_is_valid)
from .volume_info import (RemoteFileInfo, VolumeInfo, maybe_load_volume_info,
                          save_volume_info, vif_path)

T = TypeVar("T")
NeedleMap = Union[MemoryNeedleMap, CompactNeedleMap, SortedFileNeedleMap]
DatFile = Union[_DatFile, MemoryMappedFile, RemoteFile]

# index entries parsed at a time by the crash check's walk from the tail
_CHECK_BLOCK_ENTRIES = 1024
# bytes of the .dat a scan reads at a time
_SCAN_BLOCK = 4 << 20
# a new 5-byte volume's superblock extra: bit 0 set, padded to 8 bytes so
# needle offsets stay 8-aligned (seaweedfs_tpu/storage/volume.py:105)
_OFFSET_5_EXTRA = b"\x01" + b"\x00" * 7


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
                 ttl: Optional[TTL] = None,
                 needle_map_kind: str = "compact", use_mmap: bool = False,
                 offset_5: bool = False):
        """Open the volume, or create it with ``replica_placement``,
        ``ttl`` and, with ``offset_5``, 5-byte offsets in its superblock
        (an existing volume keeps its own), its needle map of
        ``needle_map_kind``, its `.dat` mapped with ``use_mmap``.  A tier
        move a crash interrupted is finished or rolled back first
        (``tier_recover``)."""
        if needle_map_kind not in NEEDLE_MAP_KINDS:
            raise ValueError(f"needle map kind {needle_map_kind!r} is not "
                             f"one of {sorted(NEEDLE_MAP_KINDS)}")
        self.needle_map_kind = needle_map_kind
        self.use_mmap = use_mmap
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.collection = collection
        self.id = vid
        self.read_only = False
        # the .dat lives in a backend (a .vif and no local .dat)
        self.tiered = False
        self.last_modified_ts_seconds = 0
        self.last_append_at_ns = 0
        self.file_prefix = volume_file_prefix(directory, collection, vid)
        # 4 or 5: the width of the .idx offsets, read from the superblock
        self.offset_size = 5 if offset_5 else 4
        # serializes appends to .dat/.idx and the commit's file swap
        # (dataFileAccessLock)
        self.write_lock = threading.Lock()
        # the (needle map, .dat handle) pair readers use; None once closed
        self._live: Optional[tuple[NeedleMap, DatFile]] = None
        # the group-commit worker, made at the first fsync write; parked
        # (and not made again) while a commit or close holds write_lock
        self._group_commit = None
        self._worker_parked = False
        # the .idx size when the last compact began (makeupDiff's start)
        self._compact_idx_size: Optional[int] = None
        # the local .dat or the committed remote copy: decided before any
        # file opens
        self.tier_recover()
        self._open(replica_placement, ttl, offset_5)

    @property
    def dat_path(self) -> str:
        return self.file_prefix + ".dat"

    @property
    def idx_path(self) -> str:
        return self.file_prefix + ".idx"

    @property
    def nm(self) -> Optional[NeedleMap]:
        live = self._live
        return live[0] if live is not None else None

    @property
    def data_size(self) -> int:
        return self._size

    @property
    def content_size(self) -> int:
        return self.nm.content_size

    # --- lifecycle ------------------------------------------------------
    def _open(self, replica_placement: Optional[ReplicaPlacement] = None,
              ttl: Optional[TTL] = None, offset_5: bool = False) -> None:
        """_load_or_create (volume.py): open the files, write a new
        volume's superblock, run the crash check, replay the index, then
        publish the pair to readers.  A `.vif` naming a remote file with
        no local `.dat` opens the tiered volume through its backend,
        read-only; one that survived beside a `.dat` (an upload that kept
        the local copy) keeps writes frozen."""
        info = maybe_load_volume_info(self.file_prefix)
        remote = info.remote_file if info else None
        tiered = remote is not None and not os.path.exists(self.dat_path)
        if tiered:
            dat = RemoteFile(get_backend(remote.backend_id), remote.key,
                             remote.file_size)
        elif self.use_mmap:
            dat = MemoryMappedFile(self.dat_path)
        else:
            dat = _DatFile(self.dat_path)
        try:
            if not tiered and dat.size < SUPER_BLOCK_SIZE:
                sb = SuperBlock(
                    version=Version.V3,
                    replica_placement=replica_placement or ReplicaPlacement(),
                    ttl=ttl or TTL(),
                    extra=_OFFSET_5_EXTRA if offset_5 else b"")
                dat.write_at(sb.to_bytes(), 0)
            else:
                sb = SuperBlock.from_bytes(
                    dat.read_at(SUPER_BLOCK_SIZE + 0xFFFF, 0))
                if not tiered:
                    # a loaded volume is as old as its file
                    # (volume_loading.go:63)
                    self.last_modified_ts_seconds = int(os.path.getmtime(
                        self.dat_path))
            if sb.version != Version.V3:
                raise ValueError(f"volume {self.id}: only version 3 volumes "
                                 "are supported")
            # the width is the volume's own: the superblock overrides the
            # constructor's flag
            self.offset_size = sb.offset_size
            if not tiered:
                self._check_integrity(dat, sb.version)
            nm = NEEDLE_MAP_KINDS[self.needle_map_kind].load(
                self.idx_path, self.offset_size)
        except BaseException:
            dat.close()
            raise
        self.super_block = sb
        self.version = sb.version
        self.tiered = tiered
        if remote is not None:
            self.read_only = True
        self._size = dat.size
        self._live = (nm, dat)

    def _entry_is_healthy(self, dat: DatFile, version: Version, key: int,
                          offset: int, size: int, dat_size: int) -> bool:
        """Does this index entry point at a whole record of its needle?"""
        if offset == 0:
            return True  # no .dat record to verify
        body = needle_body_length(size if size_is_valid(size) else 0, version)
        if offset + NEEDLE_HEADER_SIZE + body > dat_size:
            return False  # torn .dat tail: the record is cut short
        header = dat.read_at(NEEDLE_HEADER_SIZE, offset)
        if len(header) < NEEDLE_HEADER_SIZE:
            return False
        n = Needle()
        n.parse_header(header)
        if n.id != key:
            return False
        return not size_is_valid(size) or n.size == size

    def _check_integrity(self, dat: DatFile, version: Version) -> None:
        """CheckAndFixVolumeDataIntegrity (volume_checking.go:17-45): cut a
        torn index entry, walk the index from its tail dropping entries
        that point at torn or mismatched records (the .idx append outlived
        a crash the .dat pages did not), then truncate the .dat past the
        last healthy record.  With no healthy entry left, or a tail entry
        that names no record, the .dat stays as it is: its needles may
        still be recovered by a scan.

        "Past the last record" is the furthest record any kept entry
        names.  In an index in append order that is the tail entry's, the
        reference's rule; an index sorted by key (what ec.decode writes)
        can name later records before its tail, and the reference's rule
        would cut them off (ROADMAP Queue 3)."""
        if not os.path.exists(self.idx_path):
            return
        es = idx_mod.entry_size(self.offset_size)
        idx_size = os.path.getsize(self.idx_path)
        if idx_size % es:
            idx_size -= idx_size % es
            with open(self.idx_path, "r+b") as f:
                f.truncate(idx_size)
        dat_size = dat.size
        healthy_idx_size = idx_size
        last_healthy = None
        with open(self.idx_path, "rb") as f:
            while healthy_idx_size > 0 and last_healthy is None:
                start = max(0, healthy_idx_size - _CHECK_BLOCK_ENTRIES * es)
                f.seek(start)
                entries = idx_mod.parse_entries(
                    f.read(healthy_idx_size - start), self.offset_size)
                for i in range(len(entries) - 1, -1, -1):
                    key = int(entries["key"][i])
                    offset = int(entries["offset"][i]) * NEEDLE_PADDING_SIZE
                    size = int(entries["size"][i])
                    if self._entry_is_healthy(dat, version, key, offset,
                                              size, dat_size):
                        last_healthy = (offset, size)
                        break
                    healthy_idx_size -= es
        if healthy_idx_size != idx_size:
            with open(self.idx_path, "r+b") as f:
                f.truncate(healthy_idx_size)
        if last_healthy is not None and last_healthy[0]:
            end = self._furthest_record_end(healthy_idx_size)
            if dat_size > end:
                dat.truncate(end)

    def _furthest_record_end(self, idx_size: int) -> int:
        """The end of the furthest `.dat` record the first ``idx_size``
        bytes of the index name (version 3 records: header, data, CRC,
        append time, 1-8 bytes of padding; a tombstone's data is empty)."""
        with open(self.idx_path, "rb") as f:
            e = idx_mod.parse_entries(f.read(idx_size), self.offset_size)
        offset = e["offset"].astype(np.int64) * NEEDLE_PADDING_SIZE
        size = np.maximum(e["size"].astype(np.int64), 0)
        used = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
        ends = offset + used + NEEDLE_PADDING_SIZE - used % NEEDLE_PADDING_SIZE
        return int(ends[offset != 0].max(initial=0))

    def _writable(self) -> tuple[NeedleMap, DatFile]:
        """The live pair, for a caller holding write_lock."""
        if self._live is None:
            raise HandleClosedError(f"volume {self.id} is closed")
        return self._live

    def _park_worker(self) -> None:
        """Stop the group-commit worker, its queue committed, and make
        none again until ``_unpark_worker``.  Called before a sequence
        that takes write_lock and waits: a worker made in between would
        block on the lock, and close's join would wait out its 30 s."""
        self._worker_parked = True
        w = self._group_commit
        if w is not None:
            w.stop()
            self._group_commit = None

    def _unpark_worker(self) -> None:
        self._worker_parked = False

    def close(self) -> None:
        self._park_worker()
        with self.write_lock:
            self._close_live(self._live)
            self._live = None

    @staticmethod
    def _close_live(live) -> None:
        """Close a (needle map, `.dat`) pair no longer published."""
        if live is not None:
            nm, dat = live
            try:
                nm.close()
                dat.sync()
            finally:
                dat.close()

    def reload(self) -> None:
        """Open the files again and publish the new (needle map, `.dat`)
        pair, the map replayed from the `.idx` as it is on disk now:
        another writer (the native data plane) appended to it.  The old
        map closes first and its `.ldb` or `.sdx` goes (they describe
        less than the index holds); reads in flight finish on the old
        `.dat`.  No tier recovery runs: a pending move stays pending."""
        self._park_worker()
        try:
            with self.write_lock:
                nm, dat = self._writable()
                nm.close()
                for path in (snapshot_path_for(self.idx_path),
                             sorted_path_for(self.idx_path)):
                    if os.path.exists(path):
                        os.remove(path)
                try:
                    self._open()
                finally:
                    dat.close()
        finally:
            self._unpark_worker()

    def sync(self) -> None:
        """Make every append so far durable: `.dat`, then `.idx`."""
        with self.write_lock:
            self._sync_files()

    def _sync_files(self) -> None:
        """sync's body, for a caller holding write_lock."""
        nm, dat = self._writable()
        dat.sync()
        nm.sync()

    def destroy(self) -> None:
        """Close and remove the volume's files, a vacuum's, the needle
        map's and a tier move's included, and a tiered volume's remote
        object (before the `.vif`, its only record, goes)."""
        try:
            self.tier_delete_remote()
        except Exception:  # noqa: BLE001 - the local files go regardless
            pass
        self.close()
        for ext in (".dat", ".idx", ".cpd", ".cpx", ".ldb", ".sdx", ".vif",
                    ".tier", ".tier.tmp", ".dat.tierdl"):
            path = self.file_prefix + ext
            if os.path.exists(path):
                os.remove(path)

    # --- reads that survive the swap (volume.py _read_at) ---------------
    def _with_live(self, fn: Callable[[NeedleMap, DatFile], T]) -> T:
        """``fn(nm, dat)`` on the live pair.  A commit publishes the new
        pair before it closes the old one, so a read whose pair closed
        under it retries on the pair published since; a closed volume
        fails at once."""
        while True:
            live = self._live
            if live is None:
                raise HandleClosedError(f"volume {self.id} is closed")
            try:
                return fn(*live)
            except HandleClosedError:
                if self._live is live or self._live is None:
                    raise

    def _read_at(self, offset: int, length: int) -> bytes:
        return self._with_live(lambda nm, dat: dat.read_at(length, offset))

    def read_needle_blob(self, offset: int, size: int) -> bytes:
        """The whole record of a needle of ``size`` at ``offset``."""
        return self._read_at(offset, get_actual_size(size, self.version))

    def _read_needle_at(self, dat: DatFile, offset: int,
                        size: int) -> Needle:
        blob = dat.read_at(get_actual_size(size, self.version), offset)
        return Needle.from_bytes(blob, size, self.version)

    # --- write path (volume_write.go) ---------------------------------
    def _is_file_unchanged(self, dat: DatFile, n: Needle, nv) -> bool:
        """Is ``n`` the needle ``nv`` names, cookie and data alike?"""
        if str(self.super_block.ttl):
            return False
        if nv is None or nv.offset == 0 or not size_is_valid(nv.size):
            return False
        old = self._read_needle_at(dat, nv.offset, nv.size)
        return old.cookie == n.cookie and old.data == n.data

    def _append(self, dat: DatFile, n: Needle) -> int:
        """Append n's record at EOF (write_lock held); returns its offset.
        A failed write is truncated back (needle_read_write.go:136-166)."""
        if not n.append_at_ns:
            n.append_at_ns = time.time_ns()
        blob = n.to_bytes(self.version)
        offset = self._size
        try:
            written = dat.write_at(blob, offset)
            if written != len(blob):
                raise OSError(f"short write {written} != {len(blob)}")
        except OSError:
            dat.truncate(offset)
            raise
        self._size = offset + len(blob)
        return offset

    def write_needle(self, n: Needle) -> tuple[int, int, bool]:
        """doWriteRequest (volume_write.go:130-178): append the record,
        then log it in the index, with no durability barrier.  Returns
        (offset, size, is_unchanged)."""
        with self.write_lock:
            return self._do_write(n)

    def _do_write(self, n: Needle,
                  check_cookie: bool = True) -> tuple[int, int, bool]:
        """write_needle's body, for a caller holding write_lock.  Without
        ``check_cookie`` a needle of cookie 0 takes the stored one's."""
        if self.read_only:
            raise PermissionError(f"volume {self.id} is read only")
        nm, dat = self._writable()
        if isinstance(nm, SortedFileNeedleMap):
            # refused before the append: no record the map cannot name
            raise PermissionError(f"volume {self.id}: the sorted-file "
                                  "needle map is read-only")
        actual = get_actual_size(len(n.data), self.version)
        # 5-byte offsets address 256 times as far
        cap = MAX_POSSIBLE_VOLUME_SIZE * (256 if self.offset_size == 5
                                          else 1)
        if cap < nm.content_size + actual:
            raise OSError(f"volume size limit {cap} exceeded")
        nv = nm.get(n.id)
        if self._is_file_unchanged(dat, n, nv):
            return 0, len(n.data), True
        if nv is not None:
            existing = Needle()
            existing.parse_header(dat.read_at(NEEDLE_HEADER_SIZE, nv.offset))
            if n.cookie == 0 and not check_cookie:
                n.cookie = existing.cookie
            if existing.cookie != n.cookie:
                raise CookieMismatchError(f"mismatching cookie {n.cookie:x}")
        offset = self._append(dat, n)
        self.last_append_at_ns = n.append_at_ns
        nm.put(n.id, offset, n.size)
        if self.last_modified_ts_seconds < n.last_modified:
            self.last_modified_ts_seconds = n.last_modified
        return offset, n.size, False

    def delete_needle(self, n: Needle) -> int:
        """doDeleteRequest (volume_write.go:212-240): append a zero-data
        tombstone record, then log the tombstone in the index.  Returns
        the deleted needle's size, 0 when there was none."""
        with self.write_lock:
            return self._do_delete(n)

    def _do_delete(self, n: Needle) -> int:
        """delete_needle's body, for a caller holding write_lock.  A
        tombstone that carries its append time (a backup's replay) keeps
        it: the follower resumes from it."""
        if self.read_only:
            raise PermissionError(f"volume {self.id} is read only")
        nm, dat = self._writable()
        nv = nm.get(n.id)
        if nv is None or not size_is_valid(nv.size):
            return 0
        n.data = b""
        offset = self._append(dat, n)
        self.last_append_at_ns = n.append_at_ns
        nm.delete(n.id, offset)
        return nv.size

    # --- fsync writes through group commit (volume_write.go:110-128) ----
    def group_commit_worker(self):
        """The volume's worker, made at first use; None while it is
        parked (the caller then writes and fsyncs directly)."""
        w = self._group_commit
        if w is None:
            with self.write_lock:  # first writers race here
                if self._worker_parked:
                    return None
                w = self._group_commit
                if w is None:
                    from .volume_write import GroupCommitWorker

                    w = self._group_commit = GroupCommitWorker(self)
        return w

    def write_needle2(self, n: Needle,
                      fsync: bool = False) -> tuple[int, int, bool]:
        """writeNeedle2: without ``fsync`` write_needle; with it the
        group-commit worker, durable on return, one fsync of each file a
        batch."""
        if not fsync:
            return self.write_needle(n)
        return self._durably(lambda: self._do_write(n),
                             lambda w: w.submit_write(n))

    def delete_needle2(self, n: Needle, fsync: bool = False) -> int:
        if not fsync:
            return self.delete_needle(n)
        return self._durably(lambda: (0, self._do_delete(n), False),
                             lambda w: w.submit_delete(n))[1]

    def _durably(self, direct: Callable[[], tuple],
                 submit: Callable) -> tuple:
        """One fsync request through the worker, or, while it is parked,
        ``direct()`` and an fsync of the `.dat` and the `.idx` under
        write_lock.  A worker that a commit stopped before it took the request took none of it: the
        request goes again (the reference's fails instead)."""
        from .volume_write import WorkerStoppedError

        while True:
            w = self.group_commit_worker()
            if w is None:
                with self.write_lock:
                    res = direct()
                    self._sync_files()
                    return res
            try:
                return submit(w).wait()
            except WorkerStoppedError:
                w.wait_stopped()  # then the parker has it out of the way

    def _rollback_appends(self, dat_start: int, idx_start: int) -> None:
        """A failed batch (write_lock held): cut the `.dat` and the `.idx`
        back to where it began, drop the map's snapshot or sorted file
        (they may name the cut entries), and publish a map of the
        volume's kind reloaded from the cut index."""
        nm, dat = self._writable()
        try:
            dat.truncate(dat_start)
        except OSError:
            pass
        self._size = dat_start
        nm.close()
        for path in (snapshot_path_for(self.idx_path),
                     sorted_path_for(self.idx_path)):
            if os.path.exists(path):
                os.remove(path)
        if os.path.exists(self.idx_path):
            with open(self.idx_path, "r+b") as f:
                f.truncate(idx_start)
        self._live = (NEEDLE_MAP_KINDS[self.needle_map_kind].load(
            self.idx_path, self.offset_size), dat)

    # --- read path (volume_read.go) ------------------------------------
    def read_needle(self, key: int, cookie: Optional[int] = None) -> Needle:
        """readNeedle (volume_read.go:16-63) + handler-level cookie check."""

        def lookup_and_read(nm: NeedleMap, dat: DatFile) -> Needle:
            nv = nm.get(key)
            if nv is None or nv.offset == 0:
                raise NotFoundError(key)
            if not size_is_valid(nv.size):
                raise DeletedError(key)
            return self._read_needle_at(dat, nv.offset, nv.size)

        n = self._with_live(lookup_and_read)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatchError(f"cookie mismatch for {key}")
        if n.ttl is not None and n.ttl.minutes and n.last_modified:
            expire_ns = n.append_at_ns + n.ttl.minutes * 60 * 1_000_000_000
            if time.time_ns() >= expire_ns:
                raise NotFoundError(key)
        return n

    def read_needle_meta(self, key: int, cookie: Optional[int] = None):
        """The needle's header and the metadata after its data, without
        reading the data: a ranged read costs the range's IO (the newer
        reference's ReadNeedleMeta/ReadNeedleData split).  Returns (loc,
        data_size, flags, name, mime); ``loc`` is what read_needle_data
        takes, tied to the `.dat` the metadata was read from."""

        def meta(nm: NeedleMap, dat: DatFile):
            nv = nm.get(key)
            if nv is None or nv.offset == 0:
                raise NotFoundError(key)
            if not size_is_valid(nv.size):
                raise DeletedError(key)
            hdr = dat.read_at(NEEDLE_HEADER_SIZE + 4, nv.offset)
            n = Needle()
            n.parse_header(hdr[:NEEDLE_HEADER_SIZE])
            if n.id != key:
                raise ValueError(f"stale offset: found needle {n.id}, "
                                 f"wanted {key}")
            if cookie is not None and n.cookie != cookie:
                raise CookieMismatchError(f"cookie mismatch for {key}")
            loc = (dat, nv.offset + NEEDLE_HEADER_SIZE + 4)
            if n.size == 0:  # an empty body: no data_size or flags
                return loc, 0, 0, b"", b""
            data_size = bytes_to_u32(hdr[NEEDLE_HEADER_SIZE:])
            # flags + the longest name and mime: 1 + (1 + 255) * 2
            flags, name, mime = parse_needle_tail(
                dat.read_at(513, loc[1] + data_size))
            return loc, data_size, flags, name, mime

        return self._with_live(meta)

    @staticmethod
    def read_needle_data(loc, data_off: int, length: int) -> bytes:
        """Exactly [data_off, data_off + length) of the data whose ``loc``
        read_needle_meta gave.  No CRC: a part cannot verify the whole
        data's checksum."""
        dat, start = loc
        return dat.read_at(length, start + data_off)

    def scan(self, visit: Callable[[Needle, int], None]) -> None:
        """visit(needle, offset) for every record of the `.dat` in file
        order, tombstones included (volume_read.go:72-130); a torn tail
        ends the walk.  Reads the file in _SCAN_BLOCK windows."""
        offset = self.super_block.block_size
        end = self.data_size
        buf, buf_off = b"", offset
        while offset + NEEDLE_HEADER_SIZE <= end:
            rel = offset - buf_off
            if rel + NEEDLE_HEADER_SIZE > len(buf):
                buf, buf_off, rel = self._read_at(
                    offset, min(_SCAN_BLOCK, end - offset)), offset, 0
            n = Needle()
            n.parse_header(buf[rel:rel + NEEDLE_HEADER_SIZE])
            body_len = needle_body_length(
                n.size if size_is_valid(n.size) else 0, self.version)
            stop = rel + NEEDLE_HEADER_SIZE + body_len
            if stop > len(buf):  # the record runs past the window
                buf, buf_off, rel = self._read_at(offset, max(
                    _SCAN_BLOCK, NEEDLE_HEADER_SIZE + body_len)), offset, 0
                stop = NEEDLE_HEADER_SIZE + body_len
                if len(buf) < stop:
                    break
            n.read_body_bytes(buf[rel + NEEDLE_HEADER_SIZE:stop],
                              self.version)
            visit(n, offset)
            offset += NEEDLE_HEADER_SIZE + body_len

    # --- vacuum (volume_vacuum.go) --------------------------------------
    def garbage_ratio(self) -> float:
        cs = self.content_size
        if cs == 0:
            return 0.0
        return self.nm.deletion_byte_counter / cs

    def compact(self) -> None:
        """Copy the live needles, in the order of their offsets, into
        `.cpd`/`.cpx` under a superblock one compaction revision on
        (copyDataBasedOnIndexFile, volume_vacuum.go:396-470).  The index
        size at the start is kept, so commit_compact can replay what is
        appended meanwhile."""
        with self.write_lock:
            nm, _ = self._writable()
            self._compact_idx_size = os.path.getsize(self.idx_path)
            # a sorted-file map also lists its deleted (negated) entries
            live = sorted((nv for nv in nm if nv.size >= 0),
                          key=lambda nv: nv.offset)
            new_sb = self._compacted_super_block()
        with open(self.file_prefix + ".cpd", "wb") as dat_out, \
                open(self.file_prefix + ".cpx", "wb") as idx_out:
            dat_out.write(new_sb.to_bytes())
            new_offset = new_sb.block_size
            for nv in live:
                blob = self.read_needle_blob(nv.offset, nv.size)
                dat_out.write(blob)
                idx_out.write(idx_mod.pack_entry(nv.key, new_offset, nv.size,
                                                 self.offset_size))
                new_offset += len(blob)

    def _compacted_super_block(self) -> SuperBlock:
        """This volume's superblock one compaction revision on."""
        sb = self.super_block
        return dataclasses.replace(
            sb, compaction_revision=(sb.compaction_revision + 1) & 0xFFFF)

    def _makeup_diff(self, cpd: str, cpx: str) -> None:
        """makeupDiff (volume_vacuum.go:181): replay the index entries
        appended since compact began into the compacted files, so a write
        or delete that landed in between is not lost."""
        start = self._compact_idx_size
        if start is None:
            return
        idx_size = os.path.getsize(self.idx_path)
        if idx_size <= start:
            return
        with open(self.idx_path, "rb") as f:
            f.seek(start)
            entries = idx_mod.parse_entries(f.read(idx_size - start),
                                            self.offset_size)
        with open(cpd, "r+b") as dat_out, open(cpx, "ab") as idx_out:
            new_offset = dat_out.seek(0, os.SEEK_END)
            for i in range(len(entries)):
                key = int(entries["key"][i])
                offset = int(entries["offset"][i]) * NEEDLE_PADDING_SIZE
                size = int(entries["size"][i])
                if offset != 0 and size_is_valid(size):
                    blob = self.read_needle_blob(offset, size)
                    dat_out.write(blob)
                    idx_out.write(idx_mod.pack_entry(key, new_offset, size,
                                                     self.offset_size))
                    new_offset += len(blob)
                else:
                    idx_out.write(idx_mod.pack_entry(key, 0, -1,
                                                     self.offset_size))

    def commit_compact(self) -> None:
        """CommitCompact (volume_vacuum.go:91-160): under write_lock,
        catch up on what was appended since compact began, make the
        compacted files durable, swap them in and reopen (crash check
        included).  Readers keep the old pair until the new one is
        published."""
        cpd, cpx = self.file_prefix + ".cpd", self.file_prefix + ".cpx"
        if not (os.path.exists(cpd) and os.path.exists(cpx)):
            raise FileNotFoundError("no compacted files to commit")
        # parked before write_lock: the worker's batch may wait on it
        self._park_worker()
        try:
            with self.write_lock:
                self._commit_compact_locked(cpd, cpx)
        finally:
            self._unpark_worker()

    def _commit_compact_locked(self, cpd: str, cpx: str) -> None:
        nm, dat = self._writable()
        self._makeup_diff(cpd, cpx)
        # a configure_replication since compact began reaches the new
        # files too (the reference's commit keeps the old placement)
        with open(cpd, "r+b") as f:
            f.write(self._compacted_super_block().to_bytes())
        for path in (cpd, cpx):
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        try:
            # the old map closes over the old index (an ldb map's last
            # checkpoint describes that index), before the swap
            nm.close()
            os.replace(cpd, self.dat_path)
            os.replace(cpx, self.idx_path)
            # the compacted index is another history: a snapshot or a
            # sorted file of the old one must not be read over it
            for path in (snapshot_path_for(self.idx_path),
                         sorted_path_for(self.idx_path)):
                if os.path.exists(path):
                    os.remove(path)
            self._compact_idx_size = None
            self._open()
        except BaseException:
            self._live = None  # the old pair may name replaced files
            raise
        finally:
            dat.close()

    def cleanup_compact(self) -> None:
        """Drop a compaction's `.cpd`/`.cpx` without committing them."""
        for ext in (".cpd", ".cpx"):
            path = self.file_prefix + ext
            if os.path.exists(path):
                os.remove(path)

    # --- upkeep: volume.fsck, volume.configure.replication -------------
    def check_needles(self) -> dict:
        """The fsck scan (/admin/volume_check): parse every live needle's
        whole record, which checks its stored CRC.  Reads the live pair as
        reads do, locking nothing; a commit's swap restarts the scan on
        the new files.  -> indexed, scanned_live, crc_errors."""

        def scan(nm: NeedleMap, dat: DatFile) -> dict:
            live = [nv for nv in nm if nv.size >= 0]
            errors = 0
            for nv in live:
                try:
                    self._read_needle_at(dat, nv.offset, nv.size)
                except HandleClosedError:
                    raise  # a commit swapped the files: rescan the new ones
                except ValueError:  # CRC, size or header mismatch
                    errors += 1
            return {"indexed": len(live), "scanned_live": len(live),
                    "crc_errors": errors}

        return self._with_live(scan)

    def configure_replication(self, rp: ReplicaPlacement) -> None:
        """VolumeConfigure (volume_grpc_admin.go): rewrite the
        superblock's replica placement at offset 0 of the `.dat`, on disk
        before in memory, so a failed write leaves the old placement in
        both.  Under write_lock: a compaction's commit writes the
        placement in force into the compacted files."""
        with self.write_lock:
            _, dat = self._writable()
            sb = dataclasses.replace(self.super_block, replica_placement=rp)
            blob = sb.to_bytes()
            written = dat.write_at(blob, 0)
            if written != len(blob):
                raise OSError(f"short write {written} != {len(blob)}")
            self.super_block = sb

    # --- tiering (volume_grpc_tier_upload.go / _download.go) -------------
    @property
    def tier_manifest_path(self) -> str:
        return self.file_prefix + ".tier"

    def tier_manifest(self) -> Optional[dict]:
        try:
            with open(self.tier_manifest_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _save_tier_manifest(self, doc: dict) -> None:
        """Write the manifest durably: a temporary file, fsynced, renamed."""
        doc["updated_at"] = round(time.time(), 3)
        tmp = self.tier_manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.tier_manifest_path)

    def _remove_tier_manifest(self) -> None:
        for p in (self.tier_manifest_path,
                  self.tier_manifest_path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)

    def _tier_key(self) -> str:
        """The object's key: the local file's name ("5.dat",
        "photos_5.dat"); volume ids are unique in a cluster."""
        return f"{self.collection}_{self.id}.dat" if self.collection \
            else f"{self.id}.dat"

    @staticmethod
    def _remote_info(m: dict, version: int,
                     modified_time: int) -> VolumeInfo:
        """The `.vif` of the remote file a manifest names."""
        return VolumeInfo(version=version, files=[RemoteFileInfo(
            backend_type=m["backend_type"], backend_id=m["backend_id"],
            key=m["key"], file_size=int(m["file_size"]),
            modified_time=modified_time)])

    def tier_upload_begin(self, backend_id: str) -> dict:
        """Phase 1: upload and verify, the local `.dat` kept.  The manifest
        is written before the first remote byte, the `.dat` copied up, the
        remote copy read back through the backend and held to the local
        file's size and crc32; then the volume is frozen read-only with the
        manifest ``pending``: committable, abortable, crash-safe.  The
        upload runs under write_lock, so no acknowledged write lands after
        the crc was taken."""
        if self.tiered:
            raise PermissionError(f"volume {self.id} is already tiered")
        m = self.tier_manifest()
        if m and m.get("state") == "pending":
            return m  # a retry: already uploaded and verified
        # parked before write_lock: the worker's batch may wait on it
        self._park_worker()
        try:
            with self.write_lock:
                backend = get_backend(backend_id)
                self._sync_files()
                key = self._tier_key()
                size = os.path.getsize(self.dat_path)
                crc = crc32_of_file(self.dat_path)
                manifest = {
                    "state": "uploading",
                    "version": int(self.version),
                    "backend_type": backend.kind,
                    "backend_id": backend_id, "key": key,
                    "file_size": size, "crc32": crc,
                    "modified_time": int(time.time()),
                    "started_at": round(time.time(), 3),
                }
                self._save_tier_manifest(manifest)
                # a delay armed here stalls with the manifest on disk and
                # the remote object absent or partial: the kill window
                faultinject.hit("tier.upload")
                backend.upload_file(self.dat_path, key)
                remote_size = backend.object_size(key)
                remote_crc = crc32_of_remote(backend, key, remote_size)
                if remote_size != size or remote_crc != crc:
                    try:
                        backend.delete_file(key)
                    except Exception:  # noqa: BLE001 - the error below
                        pass
                    self._remove_tier_manifest()
                    raise IOError(
                        f"tier upload verify failed for volume "
                        f"{self.id}: size {remote_size}!={size} or "
                        f"crc {remote_crc:#x}!={crc:#x}")
                manifest["state"] = "pending"
                self._save_tier_manifest(manifest)
                # both copies exist: a write now would leave the remote
                # object (and the manifest's crc) stale
                self.read_only = True
                return manifest
        finally:
            self._unpark_worker()

    def tier_commit(self) -> dict:
        """Phase 2: persist ``committed``, write the `.vif`, drop the local
        `.dat` and reopen tiered.  Idempotent: recovery runs it again after
        a crash at any step.  Reads keep the local pair until the remote
        one is published (the unlinked `.dat` stays readable through its
        open descriptor)."""
        m = self.tier_manifest()
        if m is None:
            if self.tiered:
                return {"state": "committed"}  # tiered before manifests
            raise FileNotFoundError(
                f"volume {self.id} has no pending tier manifest")
        if m.get("state") not in ("pending", "committed"):
            raise PermissionError(
                f"volume {self.id} tier manifest is {m.get('state')!r}, "
                "not committable")
        m["state"] = "committed"
        self._save_tier_manifest(m)  # the local commit point
        save_volume_info(self.file_prefix, self._remote_info(
            m, int(self.version),
            int(m.get("modified_time") or time.time())))
        self._park_worker()
        try:
            with self.write_lock:
                if not self.tiered:
                    old = self._writable()
                    if os.path.exists(self.dat_path):
                        os.remove(self.dat_path)
                    self._open()
                    self._close_live(old)
        finally:
            self._unpark_worker()
        return m

    def tier_abort(self) -> None:
        """Roll back an uncommitted upload: delete the remote object (the
        manifest is its only record), drop the manifest, thaw writes."""
        m = self.tier_manifest()
        if m is None:
            return
        if m.get("state") == "committed":
            raise PermissionError(
                f"volume {self.id} tier is committed; recall instead")
        try:
            get_backend(m["backend_id"]).delete_file(m["key"])
        except Exception:  # noqa: BLE001 - a partial object that never landed
            pass
        self._remove_tier_manifest()
        self.read_only = False

    def tier_recover(self) -> Optional[str]:
        """At open, before any file opens: finish or roll back the tier
        move a crash interrupted.  -> "gc_partial_upload",
        "finish_commit", "finish_recall", "revert_recall" or None."""
        m = self.tier_manifest()
        if m is None:
            return None
        state = m.get("state")
        tmp = self.dat_path + ".tierdl"
        if state in ("uploading", "pending"):
            # uncommitted: the local .dat is authoritative
            try:
                get_backend(m["backend_id"]).delete_file(m["key"])
            except Exception:  # noqa: BLE001 - nothing to collect
                pass
            self._remove_tier_manifest()
            return "gc_partial_upload"
        if state == "committed":
            # the remote copy is the volume: a .vif and no .dat
            if maybe_load_volume_info(self.file_prefix) is None:
                save_volume_info(self.file_prefix, self._remote_info(
                    m, int(m.get("version") or 3),
                    int(m.get("modified_time") or 0)))
            if os.path.exists(self.dat_path):
                os.remove(self.dat_path)
            return "finish_commit"
        if state == "recalling":
            if os.path.exists(tmp):
                os.remove(tmp)  # a partial download: the remote stays
            if os.path.exists(self.dat_path) and \
                    os.path.getsize(self.dat_path) == \
                    int(m.get("file_size") or -1) and \
                    crc32_of_file(self.dat_path) == int(m.get("crc32") or -1):
                # the swap landed: delete the remote before the .vif,
                # which is the key's only other record
                try:
                    get_backend(m["backend_id"]).delete_file(m["key"])
                except Exception:  # noqa: BLE001 - the copy stays behind
                    pass
                if os.path.exists(vif_path(self.file_prefix)):
                    os.remove(vif_path(self.file_prefix))
                self._remove_tier_manifest()
                return "finish_recall"
            # no whole local copy: stay tiered
            m["state"] = "committed"
            self._save_tier_manifest(m)
            return "revert_recall"
        return None

    def tier_upload(self, backend_id: str, keep_local: bool = False) -> dict:
        """The one-shot move (VolumeTierMoveDatToRemote): phase 1, then
        unless ``keep_local`` phase 2 at once.  -> the remote file's
        description."""
        manifest = self.tier_upload_begin(backend_id)
        if not keep_local:
            self.tier_commit()
        return {"backend_type": manifest["backend_type"],
                "backend_id": manifest["backend_id"],
                "key": manifest["key"],
                "file_size": manifest["file_size"],
                "modified_time": manifest["modified_time"]}

    def tier_download(self) -> None:
        """The verified recall: download the tiered `.dat` to a temporary
        file, hold it to the manifest's size and crc32 (size alone for a
        volume tiered before manifests), move it into place, then delete
        the remote object and the sidecars.  Reads are served from the
        remote copy until the local pair is published; a failed recall
        leaves the volume tiered."""
        info = maybe_load_volume_info(self.file_prefix)
        remote = info.remote_file if info else None
        if remote is None:
            raise FileNotFoundError(f"volume {self.id} is not tiered")
        backend = get_backend(remote.backend_id)
        m = self.tier_manifest()
        if m is None:
            m = {"backend_type": remote.backend_type,
                 "backend_id": remote.backend_id, "key": remote.key,
                 "file_size": remote.file_size, "crc32": None,
                 "modified_time": remote.modified_time}
        m["state"] = "recalling"
        self._save_tier_manifest(m)
        tmp = self.dat_path + ".tierdl"
        self._park_worker()
        try:
            try:
                # a delay armed here stalls mid-recall, the remote copy
                # whole and only the temporary file partial
                faultinject.hit("tier.recall")
                backend.download_file(remote.key, tmp)
                got = os.path.getsize(tmp)
                if got != int(m["file_size"]):
                    raise IOError(f"tier recall verify failed for volume "
                                  f"{self.id}: size {got} != "
                                  f"{m['file_size']}")
                if m.get("crc32") is not None:
                    crc = crc32_of_file(tmp)
                    if crc != int(m["crc32"]):
                        raise IOError(
                            f"tier recall verify failed for volume "
                            f"{self.id}: crc {crc:#x} != "
                            f"{int(m['crc32']):#x}")
                with self.write_lock:
                    old = self._writable()
                    os.replace(tmp, self.dat_path)
                    # the manifest still names the key: a crash from here
                    # on finishes the recall
                    os.remove(vif_path(self.file_prefix))
                    self.read_only = False
                    self._open()
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                if self.tiered:
                    m["state"] = "committed"  # still tiered
                    self._save_tier_manifest(m)
                raise
            self._close_live(old)  # after the reads in flight leave
            try:
                backend.delete_file(remote.key)
            except Exception:  # noqa: BLE001 - the copy stays behind
                pass
            self._remove_tier_manifest()
        finally:
            self._unpark_worker()

    def tier_delete_remote(self) -> None:
        """Delete a tiered volume's remote object, or an uncommitted
        upload's (destroy)."""
        info = maybe_load_volume_info(self.file_prefix)
        remote = info.remote_file if info else None
        if remote is not None:
            get_backend(remote.backend_id).delete_file(remote.key)
        m = self.tier_manifest()
        if m is not None and m.get("key") and remote is None:
            # an uncommitted manifest is the key's only record
            try:
                get_backend(m["backend_id"]).delete_file(m["key"])
            except Exception:  # noqa: BLE001 - nothing to collect
                pass

    # --- info -----------------------------------------------------------
    def to_volume_information(self) -> dict:
        """The volume as the master's heartbeat handler reads it (the
        keys of seaweedfs_tpu/storage/volume.py to_volume_information)."""
        nm = self.nm
        return {
            "id": self.id,
            "size": self.data_size,
            "collection": self.collection,
            "file_count": nm.file_counter,
            "delete_count": nm.deletion_counter,
            "deleted_byte_count": nm.deletion_byte_counter,
            "read_only": self.read_only,
            "replica_placement": self.super_block.replica_placement.to_byte(),
            "version": int(self.version),
            "ttl": self.super_block.ttl.to_u32(),
            "compact_revision": self.super_block.compaction_revision,
            "modified_at_second": self.last_modified_ts_seconds,
            "max_file_key": nm.max_file_key,
        }
