"""Volume/needle TTL: 2-byte (count, unit) encoding.

Byte-compatible with weed/storage/needle/volume_ttl.go.
"""

from __future__ import annotations

from dataclasses import dataclass

EMPTY, MINUTE, HOUR, DAY, WEEK, MONTH, YEAR = range(7)

_UNIT_BY_CHAR = {"m": MINUTE, "h": HOUR, "d": DAY, "w": WEEK, "M": MONTH, "y": YEAR}
_CHAR_BY_UNIT = {v: k for k, v in _UNIT_BY_CHAR.items()}
_MINUTES = {MINUTE: 1, HOUR: 60, DAY: 24 * 60, WEEK: 7 * 24 * 60,
            MONTH: 31 * 24 * 60, YEAR: 365 * 24 * 60}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = EMPTY

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """"3d", "12h", "5" (minutes), "" (none); ValueError or KeyError
        on anything else."""
        if not s:
            return cls()
        unit_ch = s[-1]
        if unit_ch.isdigit():
            return cls(int(s), MINUTE)
        return cls(int(s[:-1]), _UNIT_BY_CHAR[unit_ch])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return cls()
        return cls(b[0], b[1])

    @classmethod
    def from_u32(cls, v: int) -> "TTL":
        return cls.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_u32(self) -> int:
        if self.count == 0:
            return 0
        return ((self.count & 0xFF) << 8) | (self.unit & 0xFF)

    @property
    def minutes(self) -> int:
        if self.count == 0 or self.unit == EMPTY:
            return 0
        return self.count * _MINUTES[self.unit]

    def __str__(self) -> str:
        if self.count == 0 or self.unit == EMPTY:
            return ""
        return f"{self.count}{_CHAR_BY_UNIT[self.unit]}"
