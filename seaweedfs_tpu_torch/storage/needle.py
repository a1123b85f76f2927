"""Needle record codec — byte-identical to the reference format.

Version 3 records, the current format (weed/storage/needle/needle.go:25-45,
needle_read_write.go):

  header : cookie u32 | id u64 | size i32            (16 bytes, big-endian)
  body (when data_size > 0):
      data_size u32 | data | flags u8
      [name_size u8 | name]        if FLAG_HAS_NAME
      [mime_size u8 | mime]        if FLAG_HAS_MIME
      [last_modified u40]          if FLAG_HAS_LAST_MODIFIED (5 low bytes, BE)
      [ttl u16]                    if FLAG_HAS_TTL
      [pairs_size u16 | pairs]     if FLAG_HAS_PAIRS
  tail   : checksum u32 (masked crc32c of data)
           append_at_ns u64
           padding to 8-byte alignment (always 1..8 bytes — the reference's
           PaddingLength returns 8, not 0, when already aligned;
           needle_read_write.go:354-360)

Quirk preserved deliberately: the reference writes padding out of a reused
scratch buffer, so padding bytes are NOT zeros but the big-endian size
bytes then zeros (needle_read_write.go:41-134).  We reproduce this so a
volume written by this implementation is bit-identical to one written by the
reference given the same inputs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .crc import crc32c, masked_value
from .ttl import TTL
from .types import (
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_PADDING_SIZE,
    TIMESTAMP_SIZE,
    Version,
    bytes_to_size,
    bytes_to_u16,
    bytes_to_u32,
    bytes_to_u64,
    size_to_bytes,
    u16_to_bytes,
    u32_to_bytes,
    u64_to_bytes,
)

_HEADER = struct.Struct(">IQ")   # cookie, id (the size follows)
_TAIL = struct.Struct(">IQ")     # masked CRC, append time

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80
LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2

PAIR_NAME_PREFIX = "Seaweed-"


def parse_needle_tail(tail: bytes) -> tuple[int, bytes, bytes]:
    """The flags, name and mime that follow a v2/v3 body's data, from
    ``tail`` starting at the flags byte (it may run long: only declared
    lengths are read).  A ranged read learns them without the data."""
    if not tail:
        return 0, b"", b""
    i = 0
    flags = tail[i]
    i += 1
    name = mime = b""
    if flags & FLAG_HAS_NAME and i < len(tail):
        ln = tail[i]
        i += 1
        name = tail[i:i + ln]
        i += ln
    if flags & FLAG_HAS_MIME and i < len(tail):
        lm = tail[i]
        i += 1
        mime = tail[i:i + lm]
    return flags, name, mime


class CRCError(ValueError):
    pass


class SizeMismatchError(ValueError):
    pass


def padding_length(size: int, version: Version) -> int:
    """needle_read_write.go:354-360 — in 1..8, never 0."""
    if version == Version.V3:
        used = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
    else:
        used = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
    return NEEDLE_PADDING_SIZE - (used % NEEDLE_PADDING_SIZE)


def needle_body_length(size: int, version: Version) -> int:
    if version == Version.V3:
        return size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE + padding_length(size, version)
    return size + NEEDLE_CHECKSUM_SIZE + padding_length(size, version)


def get_actual_size(size: int, version: Version) -> int:
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # logical body size (Size field), set by to_bytes / parse

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""  # json name/value pairs
    last_modified: int = 0  # unix seconds, 5 bytes stored
    ttl: TTL | None = None

    checksum: int = 0  # RAW crc32c of data (the stored u32 is masked_value(checksum))
    append_at_ns: int = 0  # v3

    data_size: int = field(default=0, repr=False)

    # --- flag helpers -------------------------------------------------
    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set_flag(self, flag: int) -> None:
        self.flags |= flag

    @property
    def is_compressed(self) -> bool:
        return self.has(FLAG_IS_COMPRESSED)

    def etag(self) -> str:
        """The HTTP ETag: the raw crc32c of the stored data, 8 hex digits."""
        return "%08x" % self.checksum

    # --- size computation (needle_read_write.go:62-88) ----------------
    def computed_size(self, version: Version) -> int:
        if len(self.data) == 0:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + min(len(self.name), 0xFF)
        if self.has(FLAG_HAS_MIME):
            # NOTE: divergence from the reference, which wraps MimeSize with
            # uint8() but writes the FULL mime bytes (needle_read_write.go:
            # 67,101-105) — a >=256-byte mime there produces a self-
            # inconsistent record.  We truncate to 255 (like name) instead;
            # real mime types never approach the limit.
            size += 1 + min(len(self.mime), 0xFF)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            size += TTL_BYTES
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    # --- write --------------------------------------------------------
    def to_bytes(self, version: Version = Version.V3) -> bytes:
        """Serialize; sets self.size/self.checksum.  Returns the full record
        including header, tail, and reference-faithful padding bytes."""
        if version != Version.V3:
            raise ValueError(f"writes version 3 needles only, not {version}")
        data = self.data
        self.checksum = crc32c(data)
        self.data_size = len(data)
        self.size = size = self.computed_size(version)
        size_bytes = size_to_bytes(size)
        out = [_HEADER.pack(self.cookie & 0xFFFFFFFF,
                            self.id & 0xFFFFFFFFFFFFFFFF), size_bytes]
        if self.data_size > 0:
            flags = self.flags
            out += (u32_to_bytes(self.data_size), data, bytes((flags & 0xFF,)))
            if flags & FLAG_HAS_NAME:
                name = self.name[:0xFF]
                out += (bytes((len(name),)), name)
            if flags & FLAG_HAS_MIME:
                mime = self.mime[:0xFF]
                out += (bytes((len(mime),)), mime)
            if flags & FLAG_HAS_LAST_MODIFIED:
                out.append(
                    u64_to_bytes(self.last_modified)[8 - LAST_MODIFIED_BYTES:])
            if flags & FLAG_HAS_TTL:
                out.append((self.ttl or TTL()).to_bytes())
            if flags & FLAG_HAS_PAIRS:
                out += (u16_to_bytes(len(self.pairs)), self.pairs)
        pad = padding_length(size, version)
        out.append(_TAIL.pack(masked_value(self.checksum),
                              self.append_at_ns & 0xFFFFFFFFFFFFFFFF))
        # quirk: padding bytes are header[12:12+pad] == size bytes then zeros
        out.append((size_bytes + b"\x00" * 8)[:pad])
        return b"".join(out)

    # --- read ---------------------------------------------------------
    def parse_header(self, b: bytes) -> None:
        self.cookie = bytes_to_u32(b[0:4])
        self.id = bytes_to_u64(b[4:12])
        self.size = bytes_to_size(b[12:16])

    def _parse_body_v2(self, b: bytes) -> None:
        """needle_read_write.go:268-334."""
        i, n = 0, len(b)
        if i < n:
            self.data_size = bytes_to_u32(b[i : i + 4])
            i += 4
            if self.data_size + i > n:
                raise ValueError("index out of range 1")
            self.data = bytes(b[i : i + self.data_size])
            i += self.data_size
            self.flags = b[i]
            i += 1
        if i < n and self.has(FLAG_HAS_NAME):
            name_size = b[i]
            i += 1
            if name_size + i > n:
                raise ValueError("index out of range 2")
            self.name = bytes(b[i : i + name_size])
            i += name_size
        if i < n and self.has(FLAG_HAS_MIME):
            mime_size = b[i]
            i += 1
            if mime_size + i > n:
                raise ValueError("index out of range 3")
            self.mime = bytes(b[i : i + mime_size])
            i += mime_size
        if i < n and self.has(FLAG_HAS_LAST_MODIFIED):
            if LAST_MODIFIED_BYTES + i > n:
                raise ValueError("index out of range 4")
            self.last_modified = bytes_to_u64(b"\x00\x00\x00" + bytes(b[i : i + LAST_MODIFIED_BYTES]))
            i += LAST_MODIFIED_BYTES
        if i < n and self.has(FLAG_HAS_TTL):
            if TTL_BYTES + i > n:
                raise ValueError("index out of range 5")
            self.ttl = TTL.from_bytes(b[i : i + TTL_BYTES])
            i += TTL_BYTES
        if i < n and self.has(FLAG_HAS_PAIRS):
            if 2 + i > n:
                raise ValueError("index out of range 6")
            pairs_size = bytes_to_u16(b[i : i + 2])
            i += 2
            if pairs_size + i > n:
                raise ValueError("index out of range 7")
            self.pairs = bytes(b[i : i + pairs_size])
            i += pairs_size

    @classmethod
    def from_bytes(cls, b: bytes, size: int,
                   version: Version = Version.V3) -> "Needle":
        """Hydrate a needle from a full record blob (ReadBytes semantics,
        needle_read_write.go:216-251); version 3 records only."""
        if version != Version.V3:
            raise ValueError(f"reads version 3 needles only, not {version}")
        n = cls()
        n.parse_header(b)
        if n.size != size:
            raise SizeMismatchError(f"found size {n.size}, expected {size}")
        n._parse_body_v2(b[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + n.size])
        if size > 0:
            stored = bytes_to_u32(b[NEEDLE_HEADER_SIZE + size : NEEDLE_HEADER_SIZE + size + 4])
            raw = crc32c(n.data)
            if stored != masked_value(raw):
                raise CRCError("CRC error! Data On Disk Corrupted")
            n.checksum = raw
        ts_off = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
        n.append_at_ns = bytes_to_u64(b[ts_off : ts_off + TIMESTAMP_SIZE])
        return n

    def read_body_bytes(self, body: bytes, version: Version) -> None:
        """ReadNeedleBodyBytes (needle_read_write.go:386-407): the body
        after a parsed header, up to and with the append time."""
        if not body:
            return
        self._parse_body_v2(body[:self.size])
        ts_off = self.size + NEEDLE_CHECKSUM_SIZE
        self.append_at_ns = bytes_to_u64(body[ts_off:ts_off + TIMESTAMP_SIZE])
        self.checksum = crc32c(self.data)
