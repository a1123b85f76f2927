"""Backend storage: a volume's `.dat` on local disk, mapped, or tiered.

The port's copy of seaweedfs_tpu/storage/backend.py (weed/storage/backend/
backend.go:15-46, the ``BackendStorageFile`` {ReadAt, WriteAt, Truncate,
Sync} and the ``BackendStorage`` factory, and backend/memory_map):

  - ``DiskFile``: a local unbuffered file read with pread.  ``close``
    closes the descriptor at once when no read is in flight, else when the
    last one leaves, so a read never meets a closed descriptor or one an
    open reused (the port's volume swaps files under lock-free readers;
    see storage/volume.py).  A read that finds the file closed raises
    ``HandleClosedError``;
  - ``MemoryMappedFile`` (``volume -mmap``): reads are slices of a shared
    read-only mapping, remapped when a read lands past it; writes stay
    pwrite, so the file on disk always holds exactly the logical content
    (an EC encode, a tier upload or a volume copy reads what ``DiskFile``
    would have written);
  - ``DirBackendStorage``: an object store rooted at a directory, objects
    are files and keys relative paths (the "dir" backend type,
    ``volume -tier.backends NAME=DIR``);
  - ``RemoteFile``: the read-only file of a tiered `.dat`, every read a
    ranged read of the backend's object;
  - ``register_backend`` / ``get_backend`` / ``configure_backends``: the
    process's named backends; ``crc32_of_file`` and ``crc32_of_remote``
    verify a tier move.

Not ported: ``S3BackendStorage`` (it waits for the S3 gateway).
"""

from __future__ import annotations

import os
import shutil
import threading
import zlib
from typing import Optional

from ..utils import faultinject


class HandleClosedError(ValueError):
    """The `.dat` handle a read took was closed: the volume is closed, or
    a compaction commit or tier move swapped the files."""


class DiskFile:
    """A local file (backend/disk_file.go), closed when its last reader
    leaves."""

    def __init__(self, path: str):
        self.path = path
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self._lock = threading.Lock()
        self._readers = 0
        self._closing = False

    def read_at(self, length: int, offset: int) -> bytes:
        if faultinject._points:
            faultinject.hit("disk.read")
        with self._lock:
            if self._closing:
                raise HandleClosedError("volume file handle closed")
            self._readers += 1
        try:
            return self._read(length, offset)
        finally:
            with self._lock:
                self._readers -= 1
                last = self._closing and not self._readers
            if last:
                self._release()

    def _read(self, length: int, offset: int) -> bytes:
        return os.pread(self.fd, length, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        if faultinject._points:
            faultinject.hit("disk.write")
        return os.pwrite(self.fd, data, offset)

    def truncate(self, size: int) -> None:
        os.ftruncate(self.fd, size)

    def sync(self) -> None:
        if faultinject._points:
            faultinject.hit("disk.sync")
        os.fsync(self.fd)

    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            last = not self._readers
        if last:
            self._release()

    def _release(self) -> None:
        os.close(self.fd)

    @property
    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def fileno(self) -> int:
        return self.fd


class _Mapping:
    """One read-only mapping of the file, its size, and the reads that
    hold it; closed when it is replaced and its last read has left."""

    __slots__ = ("mm", "size", "refs", "retired")

    def __init__(self, mm, size: int):
        self.mm, self.size, self.refs, self.retired = mm, size, 0, False


class MemoryMappedFile(DiskFile):
    """A `.dat` read through a shared read-only mapping (the reference's
    -memoryMapSizeMB analog).  The mapping always covers exactly the file
    as it was when mapped (a mapping past the end of the file would fault),
    and a read past it maps the file again at its current size.  Each read
    holds the mapping it slices, so a replaced mapping is closed as soon as
    its own last read leaves, however many later reads overlap: at most
    one mapping per read in flight, plus the current one, stays open."""

    def __init__(self, path: str):
        import mmap

        self._mmap = mmap
        super().__init__(path)
        self._map = _Mapping(None, 0)  # the current one, swapped under _lock

    def _read(self, length: int, offset: int) -> bytes:
        m = self._hold(offset + length)
        try:
            end = min(offset + length, m.size)
            if m.mm is None or offset >= end:
                return b""
            return m.mm[offset:end]
        finally:
            with self._lock:
                m.refs -= 1
                if m.retired:
                    self._retire(m)

    def _hold(self, want: int) -> _Mapping:
        """The current mapping, held by the caller; mapped anew at the
        file's current size when ``want`` lies past it (under _lock:
        readers that race here map once)."""
        with self._lock:
            m = self._map
            if want > m.size:
                size = os.fstat(self.fd).st_size
                if size > m.size:
                    self._retire(m)
                    m = self._map = _Mapping(self._mmap.mmap(
                        self.fd, size, access=self._mmap.ACCESS_READ), size)
            m.refs += 1
            return m

    @staticmethod
    def _retire(m: _Mapping) -> None:
        """Under _lock: ``m`` is replaced; closed now if no read holds it,
        else by its last read (closing twice is harmless)."""
        m.retired = True
        if not m.refs and m.mm is not None:
            m.mm.close()

    def truncate(self, size: int) -> None:
        """Only a failed append or a rolled-back batch truncates, with
        write_lock held: the mapping is dropped, and a read maps anew."""
        with self._lock:
            os.ftruncate(self.fd, size)
            if self._map.size > size:
                self._retire(self._map)
                self._map = _Mapping(None, 0)

    def _release(self) -> None:
        # no read is in flight: every replaced mapping is closed already
        with self._lock:
            self._retire(self._map)
            self._map = _Mapping(None, 0)
        super()._release()


class DirBackendStorage:
    """An object store rooted at a directory: objects are files, keys are
    relative paths (a key that would leave the root is flattened)."""

    kind = "dir"

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key.lstrip("/")))
        if not p.startswith(os.path.abspath(self.root) + os.sep) \
                and p != os.path.abspath(self.root):
            p = os.path.join(self.root, key.replace("/", "_"))
        return p

    def upload_file(self, local_path: str, key: str) -> int:
        dest = self._path(key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(local_path, dest)
        return os.path.getsize(dest)

    def download_file(self, key: str, local_path: str) -> int:
        shutil.copyfile(self._path(key), local_path)
        return os.path.getsize(local_path)

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            return os.pread(f.fileno(), length, offset)

    def delete_file(self, key: str) -> None:
        p = self._path(key)
        if os.path.exists(p):
            os.remove(p)

    def object_size(self, key: str) -> int:
        return os.path.getsize(self._path(key))


class RemoteFile:
    """The read-only file of a tiered `.dat`: every read is a ranged read
    of the backend's object (s3_backend.go S3BackendStorageFile).  A read
    after ``close`` raises HandleClosedError, and ``close`` returns once
    the reads in flight have left, so a recall deletes the object only
    after its last reader (within ``CLOSE_WAIT_S``)."""

    CLOSE_WAIT_S = 30.0

    def __init__(self, backend: DirBackendStorage, key: str,
                 file_size: Optional[int] = None):
        self.backend = backend
        self.key = key
        self._size = file_size if file_size is not None \
            else backend.object_size(key)
        self._idle = threading.Condition()
        self._readers = 0
        self._closing = False

    def read_at(self, length: int, offset: int) -> bytes:
        if offset >= self._size:
            return b""
        length = min(length, self._size - offset)
        with self._idle:
            if self._closing:
                raise HandleClosedError("tiered volume file closed")
            self._readers += 1
        try:
            return self.backend.read_range(self.key, offset, length)
        finally:
            with self._idle:
                self._readers -= 1
                if not self._readers:
                    self._idle.notify_all()

    def write_at(self, data: bytes, offset: int) -> int:
        raise PermissionError("tiered volume is read-only")

    def truncate(self, size: int) -> None:
        raise PermissionError("tiered volume is read-only")

    def sync(self) -> None:
        pass

    def close(self) -> None:
        with self._idle:
            self._closing = True
            self._idle.wait_for(lambda: not self._readers,
                                timeout=self.CLOSE_WAIT_S)

    @property
    def size(self) -> int:
        return self._size


_registry: dict[str, DirBackendStorage] = {}
_registry_lock = threading.Lock()


def register_backend(storage: DirBackendStorage) -> DirBackendStorage:
    with _registry_lock:
        _registry[storage.name] = storage
    return storage


def get_backend(name: str) -> DirBackendStorage:
    with _registry_lock:
        if name not in _registry:
            raise KeyError(f"backend storage {name!r} not configured")
        return _registry[name]


CRC_CHUNK = 1 << 20  # bytes per read of a tier move's crc32 passes


def crc32_of_file(path: str) -> int:
    """The crc32 of a local file, read in ``CRC_CHUNK`` pieces."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(CRC_CHUNK)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def crc32_of_remote(backend: DirBackendStorage, key: str, size: int) -> int:
    """The crc32 of a remote object read back through the backend in
    ``CRC_CHUNK`` ranges: a tier upload verifies what the store kept, not
    what it was sent."""
    crc = 0
    off = 0
    while off < size:
        n = min(CRC_CHUNK, size - off)
        crc = zlib.crc32(backend.read_range(key, off, n), crc)
        off += n
    return crc & 0xFFFFFFFF


def configure_backends(conf: dict) -> None:
    """Register backends from {name: {"type": "dir", "root": ...}}."""
    for name, spec in conf.items():
        kind = spec.get("type", "dir")
        if kind != "dir":
            raise ValueError(f"unknown backend type {kind!r}")
        register_backend(DirBackendStorage(name, spec["root"]))
