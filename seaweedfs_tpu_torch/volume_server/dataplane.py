"""The native data plane (``volume -dataplane native``): ctypes over
csrc/dataplane.cpp.

The port's form of seaweedfs_tpu/volume_server/dataplane.py.  The C++
plane serves the framed-TCP ops W, R and D (utils/framing.py) from its own
threads, with no Python on the path, and the Store funnels every HTTP
needle op of a volume it holds through the same engine, so each volume
has exactly one writer.  Maintenance (vacuum, EC encode, copy, tier,
fsck, replica placement) quiesces a volume first (Store.native_quiesced):
the plane lets go of it, the Python Volume reopens and replays the whole
`.idx` (so its map holds every needle the plane appended), the work runs,
and the plane takes the volume back, rebuilding its map from the `.idx`.

The library is built at first use by ops/_build.py (``c++ ... -lz``) into
``seaweedfs_tpu_torch/build/``.  A failed build or load raises: no server
runs the Python plane in its place.  Codes from the plane map to the
store's own errors (NotFoundError, CookieMismatchError, DeletedError,
PermissionError); any other is a DataPlaneError, an OSError whose
``code`` is the plane's.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from ..observability import get_tracer
from ..observability.tracer import NOOP_SPAN
from ..ops import _build
from ..storage.volume import CookieMismatchError, DeletedError, NotFoundError

# error codes (dataplane.cpp's enum)
DP_OK = 0
DP_NOT_FOUND = -2
DP_COOKIE = -3
DP_DELETED = -4
DP_READONLY = -5
DP_NO_VOLUME = -6
DP_IO = -7
DP_CRC = -8
DP_BAD_REQ = -9
DP_FULL = -10
DP_TCP_FORBIDDEN = -11


class DataPlaneError(OSError):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _raise(code: int, context: str = ""):
    if code == DP_NOT_FOUND:
        raise NotFoundError(context)
    if code == DP_COOKIE:
        raise CookieMismatchError(context)
    if code == DP_DELETED:
        raise DeletedError(context)
    if code == DP_READONLY:
        raise PermissionError(f"volume is read only {context}")
    raise DataPlaneError(code, f"data plane error {code} {context}")


class NativeDataPlane:
    """One running C++ plane and the volumes registered with it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        """Listen on host:port (0: any free port), or with ``port`` -1
        start the engine with no listener at all (``port`` then reads 0):
        a server with a whitelist keeps native needle IO through the HTTP
        funnel and opens no unguarded port.  A port that does not bind
        leaves the plane not ``alive`` (the volume server retries it, as
        it does the Python plane); a library that does not build
        raises."""
        self._lib = _build.load("dataplane")
        self._h = self._lib.dp_start(host.encode(), port)
        self.alive = bool(self._h)
        self.port = self._lib.dp_port(self._h) if self._h else port
        self.vids: set[int] = set()
        self._lock = threading.Lock()

    def add_volume(self, vid: int, dat_path: str, idx_path: str,
                   read_only: bool = False,
                   tcp_writable: bool = True) -> None:
        """Take the volume: its map rebuilt from the `.idx`.  Without
        ``tcp_writable`` W and D frames from the TCP port are refused
        (reads still serve): a replicated volume (a frame would skip the
        fan-out) and a server with a whitelist (the plane has no
        whitelist).  The funnel's own calls are never refused by it."""
        rc = self._lib.dp_add_volume(
            self._handle(), vid, dat_path.encode(), idx_path.encode(),
            1 if read_only else 0, 1 if tcp_writable else 0)
        if rc != DP_OK:
            _raise(rc, f"add_volume {vid}")
        with self._lock:
            self.vids.add(vid)

    def remove_volume(self, vid: int) -> None:
        """Let go of the volume; an append in flight finishes first."""
        with self._lock:
            self.vids.discard(vid)
        h = self._h
        if h:
            self._lib.dp_remove_volume(h, vid)

    def has(self, vid: int) -> bool:
        return vid in self.vids

    def _handle(self):
        h = self._h
        if not h:  # stopped: "not mine", so callers fall back
            raise DataPlaneError(DP_NO_VOLUME, "data plane stopped")
        return h

    def append(self, vid: int, key: int, cookie: int, record: bytes,
               size: int) -> None:
        """Append a record the caller serialized (name, mime, flags and
        TTL ride in it), under the plane's volume lock."""
        tr = get_tracer()
        with (tr.span("dataplane.append", vid=vid, key=key,
                      bytes=len(record)) if tr.enabled else NOOP_SPAN):
            rc = self._lib.dp_append(self._handle(), vid, key, cookie,
                                     record, len(record), size)
        if rc != DP_OK:
            _raise(rc, f"append {vid},{key:x}")

    def write(self, vid: int, key: int, cookie: int, data: bytes) -> int:
        """What a W frame does: the plane builds the record -> its size."""
        out = ctypes.c_uint()
        tr = get_tracer()
        with (tr.span("dataplane.write", vid=vid, key=key,
                      bytes=len(data)) if tr.enabled else NOOP_SPAN):
            rc = self._lib.dp_write(self._handle(), vid, key, cookie, data,
                                    len(data), ctypes.byref(out))
        if rc != DP_OK:
            _raise(rc, f"write {vid},{key:x}")
        return out.value

    def delete(self, vid: int, key: int, cookie: int) -> int:
        """Append a tombstone -> the deleted needle's size (0: none)."""
        out = ctypes.c_uint()
        tr = get_tracer()
        with (tr.span("dataplane.delete", vid=vid, key=key)
              if tr.enabled else NOOP_SPAN):
            rc = self._lib.dp_delete(self._handle(), vid, key, cookie,
                                     ctypes.byref(out))
        if rc != DP_OK:
            _raise(rc, f"delete {vid},{key:x}")
        return out.value

    def read(self, vid: int, key: int, cookie: int) -> bytes:
        """What an R frame answers: the needle's data, CRC-checked and
        ungzipped."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint()
        rc = self._lib.dp_read(self._handle(), vid, key, cookie,
                               ctypes.byref(out), ctypes.byref(out_len))
        if rc != DP_OK:
            _raise(rc, f"read {vid},{key:x}")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.dp_free(out)

    def read_record(self, vid: int, key: int,
                    cookie: Optional[int]) -> tuple[bytes, int]:
        """(the whole stored record, its size): Needle.from_bytes parses
        it.  ``cookie`` None skips the cookie check (read_needle's)."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_ulonglong()
        out_size = ctypes.c_int()
        tr = get_tracer()
        with (tr.span("dataplane.read", vid=vid, key=key)
              if tr.enabled else NOOP_SPAN):
            rc = self._lib.dp_read_record(
                self._handle(), vid, key, cookie or 0,
                0 if cookie is None else 1, ctypes.byref(out),
                ctypes.byref(out_len), ctypes.byref(out_size))
            if rc != DP_OK:
                _raise(rc, f"read {vid},{key:x}")
            try:
                blob = ctypes.string_at(out, out_len.value)
            finally:
                self._lib.dp_free(out)
        return blob, out_size.value

    def stat(self, vid: int) -> Optional[tuple[int, int, int, int, int]]:
        """(dat_size, live files, max file key, deleted bytes, fsync
        passes), or None if the plane does not hold the volume."""
        h = self._h  # read once: stop() clears it
        if not h:
            return None
        vals = [ctypes.c_ulonglong() for _ in range(5)]
        rc = self._lib.dp_stat(h, vid, *(ctypes.byref(v) for v in vals))
        if rc != DP_OK:
            return None
        return tuple(v.value for v in vals)

    def sync(self, vid: int) -> None:
        """Durable on return: one group fsync of the `.dat`, then the
        `.idx`, shared by every writer waiting at once."""
        rc = self._lib.dp_sync(self._handle(), vid)
        if rc != DP_OK:
            _raise(rc, f"sync {vid}")

    def frames(self) -> dict[str, int]:
        """The W, R and D frames the TCP listener has served."""
        h = self._h
        if not h:
            return {"W": 0, "R": 0, "D": 0}
        vals = [ctypes.c_ulonglong() for _ in range(3)]
        self._lib.dp_frames(h, *(ctypes.byref(v) for v in vals))
        return dict(zip("WRD", (v.value for v in vals)))

    def stats_all(self) -> dict[int, tuple[int, int, int, int, int]]:
        """``stat`` of every volume the plane holds."""
        with self._lock:
            vids = sorted(self.vids)
        out = {}
        for vid in vids:
            st = self.stat(vid)
            if st is not None:
                out[vid] = st
        return out

    def stop(self) -> None:
        """Close the listener and every connection, let go of every
        volume.  The C++ server's shell is never freed: a thread that
        raced the stop gets DP_NO_VOLUME from it."""
        h, self._h = self._h, None
        with self._lock:
            self.vids.clear()
        if h:
            self._lib.dp_stop(h)
