"""EcVolume runtime: serve needle reads from `.ecNN` shards via `.ecx` search.

Equivalent of weed/storage/erasure_coding/ec_volume.go + ec_shard.go, by
way of seaweedfs_tpu/ec/ec_volume.py.  The `.ecx` file is searched on disk
by binary search over its sorted 16-byte entries (ec_volume.go:226-251).
Reads that meet a missing or corrupt shard ask a remote holder for the
interval, then reconstruct it from the local survivors through the codec,
whose GF product runs on the card.  Deletes tombstone the `.ecx` entry in
place and append the needle id to the `.ecj` journal
(ec_volume_delete.go).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..storage import idx as idx_mod
from ..storage.needle import get_actual_size
from ..storage.types import (NEEDLE_ID_SIZE, NEEDLE_MAP_ENTRY_SIZE,
                             TOMBSTONE_FILE_SIZE, Version, size_is_deleted,
                             u64_to_bytes)
from ..utils import faultinject
from .codec import ReedSolomon
from .integrity import (EciSidecar, ShardCorruptError, note_corruption,
                        sidecar_is_stale)
from .layout import (
    DATA_SHARDS_COUNT,
    LARGE_BLOCK_SIZE,
    PARITY_SHARDS_COUNT,
    SMALL_BLOCK_SIZE,
    Interval,
    locate_data,
    to_ext,
)


class NeedleNotFoundError(KeyError):
    pass


def search_needle_from_sorted_index(ecx_fd: int, ecx_size: int,
                                    needle_id: int, mark_deleted: bool = False
                                    ) -> tuple[int, int, int]:
    """Binary search the sorted `.ecx` (ec_volume.go:227-251); with
    ``mark_deleted`` the found entry's size becomes the tombstone in place.
    Returns (entry_file_pos, byte_offset, size); raises NeedleNotFoundError."""
    lo, hi = 0, ecx_size // NEEDLE_MAP_ENTRY_SIZE
    while lo < hi:
        mid = (lo + hi) // 2
        buf = os.pread(ecx_fd, NEEDLE_MAP_ENTRY_SIZE, mid * NEEDLE_MAP_ENTRY_SIZE)
        entry = idx_mod.parse_entries(buf)[0]
        key = int(entry["key"])
        if key == needle_id:
            if mark_deleted:
                os.pwrite(ecx_fd,
                          (TOMBSTONE_FILE_SIZE & 0xFFFFFFFF).to_bytes(4, "big"),
                          mid * NEEDLE_MAP_ENTRY_SIZE + NEEDLE_ID_SIZE + 4)
            return (mid * NEEDLE_MAP_ENTRY_SIZE,
                    int(entry["offset"]) * 8, int(entry["size"]))
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    raise NeedleNotFoundError(needle_id)


class EcVolumeShard:
    """One `.ecNN` file handle (ec_shard.go:17-27)."""

    def __init__(self, base_file_name: str, shard_id: int):
        self.shard_id = shard_id
        self.path = base_file_name + to_ext(shard_id)
        self._f = open(self.path, "rb")
        self.size = os.fstat(self._f.fileno()).st_size

    def read_at(self, length: int, offset: int) -> bytes:
        data = os.pread(self._f.fileno(), length, offset)
        if faultinject._points:
            # bit-rot drill: a deterministic flip the sidecar verify
            # paths must catch and demote
            data = faultinject.corrupt_block("ec.shard.corrupt",
                                             self.shard_id, data, offset)
        return data

    def close(self) -> None:
        self._f.close()


class EcVolume:
    """Open `.ecx` plus whichever local shards exist; serve reads.

    Shards may be partial (a server typically holds a few of the 14); an
    interval whose shard is missing or corrupt is reconstructed from the
    local survivors (store_ec.go:188-218).  RS(10,4), version 3 needles.
    """

    def __init__(self, base_file_name: str, vid: int = 0,
                 large_block_size: int = LARGE_BLOCK_SIZE,
                 small_block_size: int = SMALL_BLOCK_SIZE):
        self.base_file_name = base_file_name
        self.vid = vid
        self.version = Version.V3
        self.data_shards = DATA_SHARDS_COUNT
        self.parity_shards = PARITY_SHARDS_COUNT
        self.total_shards = DATA_SHARDS_COUNT + PARITY_SHARDS_COUNT
        self.large_block_size = large_block_size
        self.small_block_size = small_block_size
        self._ecx = open(base_file_name + ".ecx", "r+b")
        self.ecx_size = os.fstat(self._ecx.fileno()).st_size
        self._ecj = open(base_file_name + ".ecj", "a+b")
        self.shards: dict[int, EcVolumeShard] = {}
        for i in range(self.total_shards):
            if os.path.exists(base_file_name + to_ext(i)):
                self.shards[i] = EcVolumeShard(base_file_name, i)
        # block-crc sidecar (ec/integrity.py): reads verify survivor
        # blocks against it and demote mismatching shards to erasures;
        # None (missing/rotted sidecar) means reads trust the bytes
        self.sidecar = EciSidecar.load(base_file_name)
        if sidecar_is_stale(self.sidecar,
                            (sh.size for sh in self.shards.values())):
            # a stale table (different encode's geometry) would demote
            # the whole healthy volume; mismatching shards among
            # size-agreeing peers instead demote in _verified_read
            self.sidecar = None
        # shards demoted by a crc mismatch this mount: excluded from
        # reads AND from reconstruction survivor sets until remount
        self.corrupt_shards: set[int] = set()
        # per-mount verified-block cache: a block that passed its crc
        # once serves later narrow reads without re-widening/re-hashing
        # (detection stays: rot at rest is caught on first use or by
        # a re-read; rot landing mid-mount after a block was verified
        # is left to a scrub)
        self._verified = (np.zeros(
            (self.total_shards, self.sidecar.block_count), dtype=bool)
            if self.sidecar is not None else None)

    # --- index ---------------------------------------------------------
    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        _, offset, size = search_needle_from_sorted_index(
            self._ecx.fileno(), self.ecx_size, needle_id)
        return offset, size

    @property
    def shard_size(self) -> int:
        """Size of one `.ecNN` file; needs at least one local shard."""
        if not self.shards:
            raise NeedleNotFoundError(
                f"ec volume {self.vid}: no local shard files to derive geometry")
        return next(iter(self.shards.values())).size

    def locate_ec_shard_needle(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        """(offset, size, intervals) — ec_volume.go:206-221."""
        offset, size = self.find_needle_from_ecx(needle_id)
        intervals = locate_data(
            self.large_block_size, self.small_block_size,
            self.data_shards * self.shard_size, offset,
            get_actual_size(size, self.version) if not size_is_deleted(size) else 0,
            self.data_shards)
        return offset, size, intervals

    # --- deletes (ec_volume_delete.go) -----------------------------------
    def delete_needle(self, needle_id: int) -> None:
        """Tombstone the needle's `.ecx` entry and journal its id in the
        `.ecj`; a needle not in the index is a no-op."""
        try:
            search_needle_from_sorted_index(
                self._ecx.fileno(), self.ecx_size, needle_id,
                mark_deleted=True)
        except NeedleNotFoundError:
            return
        self._ecj.seek(0, os.SEEK_END)
        self._ecj.write(u64_to_bytes(needle_id))
        self._ecj.flush()

    # --- interval reads ---------------------------------------------------
    def _padded_read(self, shard_id: int, length: int,
                     offset: int) -> np.ndarray:
        """Zero-padded shard read through read_at."""
        buf = self.shards[shard_id].read_at(length, offset)
        arr = np.zeros(length, dtype=np.uint8)
        if buf:
            arr[: len(buf)] = np.frombuffer(buf, dtype=np.uint8)
        return arr

    def _verified_read(self, shard_id: int, offset: int,
                       length: int) -> np.ndarray:
        """Read [offset, offset+length) of one shard, verifying every
        COVERING sidecar block (the read is widened to block boundaries,
        then sliced back).  Raises ShardCorruptError on a crc mismatch
        or a size mismatch (a truncated shard's missing tail would
        otherwise read back as trusted zeros — silent garbage); without
        a sidecar row for this shard it degrades to a trusting read."""
        sc = self.sidecar
        if sc is None or not sc.has_row(shard_id):
            return self._padded_read(shard_id, length, offset)
        if sc.shard_size != self.shards[shard_id].size:
            # the mount-time check cleared sidecars that disagree with
            # EVERY shard, so a lone divergent shard here is truncated/
            # grown rot, not a stale table
            raise ShardCorruptError(
                f"ec volume {self.vid}: shard {shard_id} size "
                f"{self.shards[shard_id].size} != sidecar "
                f"{sc.shard_size}", (shard_id,))
        bs = sc.block_size
        b0 = offset // bs
        b1 = -(-(offset + length) // bs)
        if self._verified is not None and not faultinject._points \
                and bool(self._verified[shard_id, b0:b1].all()):
            # every covering block already passed its crc this mount:
            # serve the narrow read without re-widening/re-hashing
            return self._padded_read(shard_id, length, offset)
        a0, a1 = b0 * bs, b1 * bs
        arr = self._padded_read(shard_id, a1 - a0, a0)
        bad = sc.verify_range(shard_id, a0, arr)
        if bad is not None:
            raise ShardCorruptError(
                f"ec volume {self.vid}: shard {shard_id} block {bad} "
                f"crc mismatch", (shard_id,))
        if self._verified is not None:
            self._verified[shard_id, b0:b1] = True
        return arr[offset - a0: offset - a0 + length]

    def _note_corrupt(self, shard_id: int) -> None:
        if shard_id not in self.corrupt_shards:
            self.corrupt_shards.add(shard_id)
            note_corruption("read", shard_id, self.base_file_name)

    def read_interval(self, interval: Interval, rs: ReedSolomon,
                      fetch_remote: Optional[
                          Callable[[int, int, int, int], bytes]] = None
                      ) -> bytes:
        """Read one interval (store_ec.go:188-218, the order of
        seaweedfs_tpu's Store.read_ec_needle): the local shard, verified
        against the `.eci`; else ``fetch_remote(vid, shard, offset,
        size)``, whose exceptions count as an absent shard; else
        reconstruction from >= data_shards local shards on the card
        (:328-382).  A crc-mismatching local shard is demoted to an
        erasure."""
        shard_id, shard_offset = interval.to_shard_id_and_offset(
            self.large_block_size, self.small_block_size, self.data_shards)
        if shard_id in self.shards and shard_id not in self.corrupt_shards:
            try:
                return self._verified_read(
                    shard_id, shard_offset, interval.size).tobytes()
            except ShardCorruptError:
                self._note_corrupt(shard_id)
            except OSError:
                # bad sector/dying disk on the direct read: treat the
                # shard as absent (not demoted: the next read retries
                # the disk)
                pass
        if fetch_remote is not None:
            try:
                return fetch_remote(self.vid, shard_id, shard_offset,
                                    interval.size)
            except Exception:  # noqa: BLE001 - any remote failure = absent
                pass
        return self.reconstruct_interval(shard_id, shard_offset, interval.size, rs)

    def reconstruct_interval(self, missing_shard_id: int, shard_offset: int,
                             length: int, rs: ReedSolomon) -> bytes:
        """Rebuild one missing/corrupt interval from local survivors.
        Survivors are sidecar-verified before use; one that fails its
        crc — or errors at the IO layer (bad sector, dying disk) — is
        skipped and the next local shard takes its place, so corruption
        and read errors both become correctable erasures.  Raises
        ShardCorruptError when corruption leaves fewer than data_shards
        clean survivors (never silent garbage), NeedleNotFoundError when
        there were simply never enough local shards."""
        bufs: list[Optional[np.ndarray]] = [None] * self.total_shards
        clean = 0
        errored: list[int] = []
        for i in self.shards:
            if clean >= self.data_shards:
                break
            if i == missing_shard_id or i in self.corrupt_shards:
                continue
            try:
                bufs[i] = self._verified_read(i, shard_offset, length)
            except ShardCorruptError:
                self._note_corrupt(i)
                continue
            except OSError:
                # bad sector: an alternate survivor takes this slot
                errored.append(i)
                continue
            clean += 1
        # alternates exhausted but shards errored: transient IO blips
        # (EINTR, a loaded controller) get bounded second chances before
        # the interval gives up — a persistent bad sector exhausts the
        # retries, a transient one doesn't cost the read when there were
        # no spare shards left to take its slot
        for _ in range(3):
            if clean >= self.data_shards or not errored:
                break
            still: list[int] = []
            for i in errored:
                if clean >= self.data_shards:
                    break
                try:
                    bufs[i] = self._verified_read(i, shard_offset, length)
                except ShardCorruptError:
                    self._note_corrupt(i)
                except OSError:
                    still.append(i)
                else:
                    clean += 1
            errored = still
        if clean < self.data_shards:
            # blame corruption only when it was the DECIDING factor:
            # with the demoted shards counted back in we'd have had
            # enough survivors.  A server that simply never held
            # data_shards local shards keeps raising
            # NeedleNotFoundError (the 404 / fall-through-to-remote
            # path), demotions or not.
            demoted_local = sum(1 for s in self.corrupt_shards
                                if s in self.shards
                                and s != missing_shard_id)
            if demoted_local and clean + demoted_local >= self.data_shards:
                raise ShardCorruptError(
                    f"ec volume {self.vid}: only {clean} clean local "
                    f"shards after demoting corrupt "
                    f"{sorted(self.corrupt_shards)}",
                    tuple(sorted(self.corrupt_shards)))
            raise NeedleNotFoundError(
                f"cannot reconstruct shard {missing_shard_id}: "
                f"only {clean} readable local shards")
        rs.reconstruct(bufs)
        return bufs[missing_shard_id].tobytes()

    def read_needle(self, needle_id: int, rs: ReedSolomon) -> bytes:
        """Full needle record bytes via interval reads; raises on deleted."""
        offset, size, intervals = self.locate_ec_shard_needle(needle_id)
        if size_is_deleted(size):
            raise NeedleNotFoundError(f"needle {needle_id} deleted")
        return b"".join(self.read_interval(iv, rs) for iv in intervals)

    def close(self) -> None:
        self._ecx.close()
        self._ecj.close()
        for s in self.shards.values():
            s.close()
