"""Volume super block: the 8-byte `.dat` header.

Byte-compatible with weed/storage/super_block/super_block.go:16-23:
  byte 0    : needle version (1|2|3)
  byte 1    : replica placement byte (dc*100 + rack*10 + same)
  bytes 2-3 : TTL
  bytes 4-5 : compaction revision (u16 BE)
  bytes 6-7 : extra size (u16 BE), followed by protobuf extra (unused here)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ttl import TTL
from .types import CURRENT_VERSION, Version, bytes_to_u16, u16_to_bytes

SUPER_BLOCK_SIZE = 8


@dataclass(frozen=True)
class ReplicaPlacement:
    """xyz replica spec (super_block/replica_placement.go): digit0 = copies in
    other DCs, digit1 = copies on other racks, digit2 = copies on same rack."""

    same_rack: int = 0
    diff_rack: int = 0
    diff_dc: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        digits = [int(c) for c in s]
        if any(d < 0 or d > 2 for d in digits):
            raise ValueError(f"unknown replication type: {s}")
        digits += [0] * (3 - len(digits))
        return cls(diff_dc=digits[0], diff_rack=digits[1], same_rack=digits[2])

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse("%03d" % b)

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


@dataclass
class SuperBlock:
    version: Version = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compaction_revision: int = 0
    extra: bytes = b""

    @property
    def block_size(self) -> int:
        if self.version in (Version.V2, Version.V3):
            return SUPER_BLOCK_SIZE + len(self.extra)
        return SUPER_BLOCK_SIZE

    @property
    def offset_size(self) -> int:
        """4 or 5: idx/needle-map offset width.  Extra-byte bit0 is the
        per-volume 5-byte-offset flag (the reference's 5BytesOffset
        build tag made per-volume; ref: weed/storage/types/
        offset_5bytes.go) — the single decode point for volume load and
        the debug tools."""
        return 5 if (self.extra and self.extra[0] & 1) else 4

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = int(self.version)
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        header[4:6] = u16_to_bytes(self.compaction_revision)
        if self.extra:
            header[6:8] = u16_to_bytes(len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("super block too short")
        extra_size = bytes_to_u16(b[6:8])
        return cls(
            version=Version(b[0]),
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=TTL.from_bytes(b[2:4]),
            compaction_revision=bytes_to_u16(b[4:6]),
            extra=bytes(b[SUPER_BLOCK_SIZE : SUPER_BLOCK_SIZE + extra_size]),
        )
