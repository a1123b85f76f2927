"""Shard-integrity sidecars: per-shard, per-block crc32c for EC volumes.

The needle CRCs in storage/crc.py only protect data bytes on the
needle-read path; parity shards and the rebuild/reconstruct inputs had
zero integrity coverage, so one bit-flipped survivor silently poisoned
every regenerated shard.  RS(10,4) can *correct* bit rot for free — but
only if corruption is first detected and demoted to an erasure.  This
module provides the detection layer:

  - one `.eci` sidecar per EC volume, covering all 14 shards (parity
    included) with a masked crc32c per fixed-size block, written during
    encode (encoder.write_ec_files, ec/streaming.py);
  - verify-on-use helpers for the rebuild/read paths: a mismatching
    block demotes that shard to *erased* so reconstruction retries with
    an alternate survivor set, and the operation hard-fails with a typed
    ShardCorruptError only when clean survivors < data_shards — never
    silent garbage.

The `.eci` bytes are identical to those seaweedfs_tpu writes for the same
shards, so either package can verify the other's volumes.

Sidecar format (`<base>.eci`, big-endian):

    header  magic  b"ECI1"
            u8     total_shards
            u8     flags (reserved, 0)
            u16    present_mask   (bit i set = shard i's row is valid;
                                   a server holding a partial shard set
                                   can only backfill its local rows)
            u32    block_size
            u64    shard_size
            u32    table_crc      (masked crc32c of the table bytes — a
                                   rotted sidecar must read as ABSENT,
                                   not mass-demote healthy shards)
    table   total_shards rows x ceil(shard_size/block_size) u32 masked
            crc32c values; the final block's crc covers only the tail
            bytes when shard_size % block_size != 0

CRCs use the same masked crc32c as needle checksums (storage/crc.py:
rotr15 + 0xa282ead8), computed by csrc/crc32c.c.  Rebuild NEVER
rewrites sidecar rows: regenerated shards are byte-identical to the originals by the codec contract, so the row
written at encode time stays authoritative — corruption that happened
after encode can never launder itself into the baseline.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from ..observability import events as _events
from ..observability import get_tracer
from ..stats import ec_integrity_metrics
from ..storage.crc import crc32c, masked_value
from ..utils import faultinject
from .layout import TOTAL_SHARDS_COUNT, to_ext

ECI_EXT = ".eci"
ECI_MAGIC = b"ECI1"
DEFAULT_BLOCK_SIZE = 256 * 1024  # 4 table bytes per shard per 256KB: ~0.002%
_HEADER = struct.Struct(">4sBBHIQI")


class ShardCorruptError(IOError):
    """Corruption left fewer than data_shards clean survivors: the
    operation CANNOT produce trustworthy bytes and must fail loudly
    instead of emitting silent garbage."""

    def __init__(self, msg: str, shards: tuple = ()):
        super().__init__(msg)
        self.corrupt_shards = tuple(shards)


class CorruptSurvivor(Exception):
    """Internal control flow: a survivor failed sidecar verification
    mid-operation.  The rebuild loops catch it, demote the shard to an
    erasure, and retry with an alternate survivor set."""

    def __init__(self, shard_id: int, block: int = -1):
        super().__init__(f"shard {shard_id} failed block crc")
        self.shard_id = shard_id
        self.block = block


def block_crc(data) -> int:
    """The u32 stored per block: masked crc32c, same transform as the
    needle checksum so CRCs of CRCs stay well-distributed."""
    return masked_value(crc32c(data))


def sidecar_path(base_file_name: str) -> str:
    return base_file_name + ECI_EXT


def note_corruption(source: str, shard_id: int, base: str = "",
                    block: int = -1) -> None:
    """One corrupt-shard detection: counted on
    SeaweedFS_ec_corrupt_shards_total{source=...}, recorded on the trace
    as a ``pipeline.retry`` event with reason corrupt_shard (the
    analyzer's degraded verdict keys on it) and journaled as
    ``shard_corrupt``."""
    ec_integrity_metrics().corrupt_shards.inc(source)
    get_tracer().event(
        "pipeline.retry", reason="corrupt_shard", source=source,
        shard=shard_id, path=base, block=block)
    _events.emit("shard_corrupt", source=source, shard=shard_id,
                 path=base, block=block)


def sidecar_is_stale(sidecar: Optional["EciSidecar"],
                     sizes) -> bool:
    """True when the sidecar describes a DIFFERENT encode's geometry
    than the local shard set — its crcs are then unverifiable noise,
    not evidence of rot.  The tell: EVERY local shard disagrees with
    the table's shard_size (a crash between shard rewrite and sidecar
    rewrite leaves exactly this).  A single local shard is never enough
    to call stale: encode and copy both move shards WITH their sidecar
    as a consistent set, so a lone disagreeing shard is truncation/
    growth rot and must be demoted, not used to discredit the table.
    EcVolume checks it at mount."""
    sizes = list(sizes)
    if sidecar is None or len(sizes) < 2:
        return False
    return all(s != sidecar.shard_size for s in sizes)


class EciSidecar:
    """Parsed `.eci` document: the per-volume block-crc table."""

    def __init__(self, block_size: int, shard_size: int, crcs: np.ndarray,
                 present_mask: int):
        self.block_size = int(block_size)
        self.shard_size = int(shard_size)
        self.crcs = crcs  # [total_shards, block_count] uint32
        self.present_mask = int(present_mask)
        self.total_shards = int(crcs.shape[0])

    @property
    def block_count(self) -> int:
        return int(self.crcs.shape[1])

    def block_len(self, block_idx: int) -> int:
        """Bytes the stored crc for this block covers (the tail may be
        short)."""
        start = block_idx * self.block_size
        return max(0, min(self.block_size, self.shard_size - start))

    def has_row(self, shard_id: int) -> bool:
        return bool((self.present_mask >> shard_id) & 1)

    def verify_range(self, shard_id: int, offset: int,
                     data) -> Optional[int]:
        """Verify a block-ALIGNED read of one shard; returns the first
        mismatching block index, or None when every covered block
        checks out.  Bytes past shard_size (zero-padded tail reads) are
        outside crc coverage and ignored; shards without a valid row
        verify vacuously."""
        if not self.has_row(shard_id):
            return None
        bs = self.block_size
        if offset % bs:
            raise ValueError(f"unaligned verify offset {offset}")
        mv = memoryview(data)
        n = min(len(mv), max(0, self.shard_size - offset))
        row = self.crcs[shard_id]
        pos = 0
        while pos < n:
            bi = offset // bs + pos // bs
            take = min(bs, n - pos)
            if block_crc(mv[pos:pos + take]) != int(row[bi]):
                return bi
            pos += take
        return None

    # --- persistence ------------------------------------------------------
    def save(self, base_file_name: str) -> None:
        """Atomic write (tmp + rename): a torn sidecar must never be
        half-readable — load() would reject it on table_crc anyway, but
        rename keeps the previous good one until the new one is whole."""
        table = np.ascontiguousarray(
            self.crcs.astype(">u4", copy=False)).tobytes()
        hdr = _HEADER.pack(ECI_MAGIC, self.total_shards, 0,
                           self.present_mask, self.block_size,
                           self.shard_size, block_crc(table))
        path = sidecar_path(base_file_name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(hdr + table)
        os.replace(tmp, path)

    @classmethod
    def load(cls, base_file_name: str) -> Optional["EciSidecar"]:
        """None when the sidecar is missing OR fails its own integrity
        checks — a rotted sidecar reads as absent (verification simply
        unavailable), never as evidence against healthy shards."""
        path = sidecar_path(base_file_name)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            magic, total, _flags, mask, bs, shard_size, table_crc = \
                _HEADER.unpack_from(raw)
            if magic != ECI_MAGIC or not bs or not total:
                raise ValueError("bad header")
            nblocks = -(-shard_size // bs) if shard_size else 0
            table = raw[_HEADER.size:_HEADER.size + total * nblocks * 4]
            if len(table) != total * nblocks * 4 \
                    or block_crc(table) != table_crc:
                raise ValueError("table crc mismatch")
            crcs = np.frombuffer(table, dtype=">u4").reshape(
                total, nblocks).astype(np.uint32)
        except (ValueError, struct.error):
            get_tracer().event("ec.sidecar.invalid", path=path)
            return None
        return cls(bs, shard_size, crcs, mask)


# bytes read per call when a sidecar row is computed from a file
_IO_CHUNK = 1 << 20


class SidecarBuilder:
    """Streaming crc accumulation: feed each shard's bytes IN WRITE
    ORDER (any chunking) and finalize into an EciSidecar — the encode
    paths build the sidecar as shard bytes stream out, no second read
    pass.  Each shard's state is its own, so one thread may feed some
    shards while another feeds the rest (the encode's producer feeds
    the data shards, its writer thread the parity shards).
    seed_from_file() re-seeds a shard from the completed prefix of an
    output file after a checkpoint resume."""

    def __init__(self, total_shards: int):
        self.block_size = DEFAULT_BLOCK_SIZE
        self.total_shards = total_shards
        self._crcs: list[list[int]] = [[] for _ in range(total_shards)]
        self._run = [0] * total_shards    # running crc of the open block
        self._fill = [0] * total_shards   # bytes in the open block
        self._size = [0] * total_shards
        self._touched = [False] * total_shards

    def reset_shard(self, shard_id: int) -> None:
        self._crcs[shard_id] = []
        self._run[shard_id] = 0
        self._fill[shard_id] = 0
        self._size[shard_id] = 0
        self._touched[shard_id] = False

    def update(self, shard_id: int, data) -> None:
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:  # ndarray rows arrive as u8
            mv = mv.cast("B")
        bs = self.block_size
        self._touched[shard_id] = True
        pos, n = 0, len(mv)
        while pos < n:
            take = min(bs - self._fill[shard_id], n - pos)
            self._run[shard_id] = crc32c(mv[pos:pos + take],
                                         self._run[shard_id])
            self._fill[shard_id] += take
            pos += take
            if self._fill[shard_id] == bs:
                self._crcs[shard_id].append(
                    masked_value(self._run[shard_id]))
                self._run[shard_id] = 0
                self._fill[shard_id] = 0
        self._size[shard_id] += n

    def seed_from_file(self, shard_id: int, f, nbytes: int) -> None:
        """Rebuild this shard's accumulator from bytes [0, nbytes) of an
        open file (checkpoint-resume: the prefix survived, the tail was
        truncated away; backfill: the whole file)."""
        self.reset_shard(shard_id)
        fd = f.fileno()
        off = 0
        while off < nbytes:
            buf = os.pread(fd, min(_IO_CHUNK, nbytes - off), off)
            if not buf:
                raise IOError(f"short read seeding sidecar shard "
                              f"{shard_id}: {off} < {nbytes}")
            self.update(shard_id, buf)
            off += len(buf)

    def finalize(self) -> EciSidecar:
        """Flush trailing partial blocks and assemble the table.  Every
        touched shard must have received the same byte count — unequal
        shard streams mean the caller interleaved geometries."""
        sizes = {self._size[i] for i in range(self.total_shards)
                 if self._touched[i]}
        if len(sizes) > 1:
            raise ValueError(f"unequal shard stream sizes: {sorted(sizes)}")
        shard_size = sizes.pop() if sizes else 0
        nblocks = -(-shard_size // self.block_size) if shard_size else 0
        crcs = np.zeros((self.total_shards, nblocks), dtype=np.uint32)
        mask = 0
        for i in range(self.total_shards):
            if not self._touched[i]:
                continue
            row = list(self._crcs[i])
            if self._fill[i]:
                row.append(masked_value(self._run[i]))
            crcs[i, :len(row)] = row
            mask |= 1 << i
        return EciSidecar(self.block_size, shard_size, crcs, mask)


def backfill_sidecar(base_file_name: str) -> Optional[EciSidecar]:
    """Compute and save a sidecar from whatever `.ecNN` files exist
    locally: the adoption path for shard sets that predate sidecars (rows
    for absent shards stay masked invalid).  Records the CURRENT bytes as
    the baseline: backfill cannot detect rot that happened before it ran.
    Returns the saved sidecar, or None when no shard file is present."""
    sb = SidecarBuilder(TOTAL_SHARDS_COUNT)
    found = False
    for i in range(TOTAL_SHARDS_COUNT):
        path = base_file_name + to_ext(i)
        if not os.path.exists(path):
            continue
        found = True
        with open(path, "rb") as f:
            sb.seed_from_file(i, f, os.fstat(f.fileno()).st_size)
    if not found:
        return None
    sc = sb.finalize()
    sc.save(base_file_name)
    return sc


def verify_shard_file(sidecar: EciSidecar, path: str, shard_id: int,
                      pace=None, on_block=None) -> list[int]:
    """Scan one shard file against its sidecar row; returns the corrupt
    block indices.  ``pace(nbytes)`` is called before each block read
    (the scrubber's rate limiter and pause hook), ``on_block(ok)`` after
    each verification.  Shards without a valid row scan as clean."""
    if not sidecar.has_row(shard_id):
        return []
    bad: list[int] = []
    bs = sidecar.block_size
    with open(path, "rb") as f:
        fd = f.fileno()
        st_size = os.fstat(fd).st_size
        if st_size != sidecar.shard_size:
            # truncated (or grown) shard: its bytes are not the bytes
            # the table describes.  Per-block preads past EOF come back
            # empty and would verify vacuously — the rot class a
            # scrubber exists to catch — so every block from the
            # divergence point reports corrupt
            if sidecar.block_count == 0:
                return [0]
            first = min(st_size, sidecar.shard_size) // bs
            return list(range(min(first, sidecar.block_count - 1),
                              sidecar.block_count))
        for bi in range(sidecar.block_count):
            if pace is not None:
                pace(sidecar.block_len(bi))
            raw = os.pread(fd, bs, bi * bs)
            if faultinject._points:
                raw = faultinject.corrupt_block(
                    "ec.shard.corrupt", shard_id, raw, bi * bs)
            ok = sidecar.verify_range(shard_id, bi * bs, raw) is None
            if not ok:
                bad.append(bi)
            if on_block is not None:
                on_block(ok)
    return bad
