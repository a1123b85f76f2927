"""Needle checksum: CRC32-Castagnoli with the masked-value transform.

The reference computes crc32c over the needle Data and stores
``value = rotr15(crc) + 0xa282ead8`` (weed/storage/needle/crc.go:24-26) —
the same masking scheme leveldb/snappy use so that CRCs of CRCs stay
well-distributed.

``crc32c`` runs in csrc/crc32c.c (the SSE4.2 crc32 instruction, or its
table loop on CPUs without it), built at first use by ops/_build.py.  A
volume plus its shards is gigabytes of CRC, which a Python byte loop
would take many minutes over; ``crc32c_plain`` is that byte loop, kept as
the reference the tests compare the library with.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_POLY = 0x82F63B78  # reversed Castagnoli
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _as_u8(data) -> np.ndarray:
    """A zero-copy uint8 view of any contiguous buffer (bytes, bytearray,
    memoryview, ndarray); a copy only for a non-contiguous one."""
    try:
        return np.frombuffer(data, dtype=np.uint8)
    except (ValueError, BufferError):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


_bytes_extend = None


def _bytes_crc32c():
    """crc32c_extend bound to take a bytes object as its pointer: a needle's
    data goes to the library with no array view made for it."""
    global _bytes_extend
    if _bytes_extend is None:
        fn = _build.load("crc32c").crc32c_extend
        _bytes_extend = ctypes.CFUNCTYPE(
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_size_t)(ctypes.cast(fn, ctypes.c_void_p).value)
    return _bytes_extend


def crc32c(data, initial: int = 0) -> int:
    """crc32c of ``data``, continuing from ``initial`` (0 starts afresh;
    google_crc32c.extend semantics)."""
    if type(data) is bytes:
        return _bytes_crc32c()(initial, data, len(data))
    arr = _as_u8(data)
    return _build.load("crc32c").crc32c_extend(initial, arr.ctypes.data,
                                               arr.size)


def crc32c_table(data, initial: int = 0) -> int:
    """The library's table loop, which serves CPUs without SSE4.2."""
    arr = _as_u8(data)
    return _build.load("crc32c").crc32c_extend_table(
        initial, arr.ctypes.data, arr.size)


def crc32c_plain(data, initial: int = 0) -> int:
    """Reference byte loop: the same function as crc32c, in Python."""
    c = initial ^ 0xFFFFFFFF
    for b in bytes(data):
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_value(crc: int) -> int:
    """crc.go:24-26: uint32(c>>15|c<<17) + 0xa282ead8."""
    crc &= 0xFFFFFFFF
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF


def needle_checksum(data) -> int:
    """The u32 stored after the needle body."""
    return masked_value(crc32c(data))
