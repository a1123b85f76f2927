"""File id: "<volumeId>,<needleIdHex><cookieHex8>".

Byte-compatible with weed/storage/needle/file_id.go: the key is hex with
leading zero bytes stripped (whole bytes, not nibbles), cookie is always
8 hex chars.  A copy of seaweedfs_tpu/storage/file_id.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from .types import bytes_to_u32, bytes_to_u64, u32_to_bytes, u64_to_bytes


def format_needle_id_cookie(key: int, cookie: int) -> str:
    raw = u64_to_bytes(key) + u32_to_bytes(cookie)
    i = 0
    while i < 8 and raw[i] == 0:
        i += 1
    return raw[i:].hex()


def parse_needle_id_cookie(s: str) -> tuple[int, int]:
    if len(s) <= 8:
        raise ValueError(f"needle id too short: {s}")
    if len(s) % 2 == 1:
        s = "0" + s
    raw = bytes.fromhex(s)
    key = bytes_to_u64(b"\x00" * (12 - len(raw)) + raw[:-4])
    cookie = bytes_to_u32(raw[-4:])
    return key, cookie


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"wrong fid format: {fid}")
        vid = int(fid[:comma])
        key, cookie = parse_needle_id_cookie(fid[comma + 1 :])
        return cls(vid, key, cookie)

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"
