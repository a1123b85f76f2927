"""Raw-TCP needle IO: the volume server's framed plane.

The port's copy of seaweedfs_tpu/volume_server/tcp.py (the reference's
``weed benchmark -useTcp`` path, weed/server/
volume_server_tcp_handlers_write.go): object IO over persistent TCP
connections in length-prefixed binary frames (utils/framing.py), with no
request line, headers or chunking to parse.  Ops:

  op 'W': write needle (key=fid, body=data); ok payload = u32 stored size
  op 'R': read needle  (key=fid);            ok payload = needle data
  op 'D': delete       (key=fid);            ok payload = u32 size
  op 'B': batch read   (body = [u16 fid_len | fid]...);
          ok payload = [status(1) | u32 len | data]... in order
  op 'P': batch write  (body = [u16 fid_len | fid | u32 len | data]...);
          ok payload = [status(1) | u32 stored size]... in order

A gzip-stored needle (an HTTP upload of compressible content) is read
back ungzipped: a frame has no encoding slot.  The plane listens on the
HTTP port + 20000 (``tcp_port_for``).  ``replicate_write`` and
``replicate_delete`` fan a W or D out to the volume's other replicas over
HTTP, as the HTTP plane's writes do.  Reads go to the live volumes only:
a framed R of an EC volume answers the store's KeyError, as the
reference's does.

``whitelist_ok`` (the guard's ``check_white_list``, given when the server
has a whitelist) closes a connection from a peer outside it before any
frame, reads included.  The volume server starts no framed plane at all
under a write or read key, or under cluster TLS: a frame has no token
slot and the plane no TLS.

``heat`` (the server's HeatAccumulator, observability/heat.py, or None)
is fed once a needle op (a batch frame's per fid): the framed plane passes
no router, so it notes its reads, writes and failures itself
(``note_native``); the server's RequestLedger settles each frame in
``serve_frame`` (``FramedServer.ledger``).
"""

from __future__ import annotations

from typing import Optional

from ..storage.file_id import FileId
from ..storage.needle import Needle
from ..utils.compression import ungzip_data
from ..utils.framing import (  # noqa: F401 - re-exported for callers
    TCP_PORT_OFFSET,
    U16,
    U32,
    FramedClient,
    FramedServer,
    pack_fid_frames,
    tcp_address,
    tcp_port_for,
    unpack_fid_frames,
)


class TcpVolumeServer(FramedServer):
    """The framed front over a Store."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 whitelist_ok=None, replicate_write=None,
                 replicate_delete=None, heat=None):
        super().__init__(self._handle, host,
                         port or tcp_port_for(store.port),
                         whitelist_ok=whitelist_ok, name="tcp-volume")
        self.store = store
        self.replicate_write = replicate_write
        self.replicate_delete = replicate_delete
        # None costs one attribute check an op
        self.heat = heat

    def _handle_one(self, op: bytes, fid_str: str, body: bytes) -> bytes:
        if self.heat is None:
            return self._op(op, fid_str, body)
        fid = FileId.parse(fid_str)
        try:
            out = self._op(op, fid_str, body, fid=fid)
        except Exception:
            try:
                self.heat.note_native(op.decode(), fid.volume_id, 0,
                                      error=True)
            except Exception:  # noqa: BLE001 - accounting never breaks serving
                pass
            raise
        try:
            self.heat.note_native(op.decode(), fid.volume_id,
                                  len(out) if op == b"R" else len(body),
                                  fid=fid_str)
        except Exception:  # noqa: BLE001 - accounting never breaks serving
            pass
        return out

    def _op(self, op: bytes, fid_str: str, body: bytes,
            fid=None) -> bytes:
        if fid is None:
            fid = FileId.parse(fid_str)
        if op == b"W":
            n = Needle(cookie=fid.cookie, id=fid.key, data=body)
            size, _ = self.store.write_needle(fid.volume_id, n)
            if self.replicate_write is not None:
                self.replicate_write(fid_str, body)
            return U32.pack(size & 0xFFFFFFFF)
        if op == b"R":
            n = self.store.read_needle(fid.volume_id, fid.key, fid.cookie)
            return ungzip_data(n.data) if n.is_compressed else n.data
        if op == b"D":
            n = Needle(cookie=fid.cookie, id=fid.key)
            size = self.store.delete_needle(fid.volume_id, n)
            if self.replicate_delete is not None:
                self.replicate_delete(fid_str)
            return U32.pack(size & 0xFFFFFFFF)
        raise ValueError(f"unknown op {op!r}")

    def _handle(self, op: bytes, fid_str: str, body: bytes) -> bytes:
        if op == b"B":
            return self._batch_read(body)
        if op == b"P":
            return self._batch_write(body)
        return self._handle_one(op, fid_str, body)

    def _batch_read(self, body: bytes) -> bytes:
        # the whole batch is unpacked first: a torn one is refused before
        # any read, never half answered
        out = []
        for fid_str in unpack_fid_frames(body, with_data=False):
            try:
                data = self._handle_one(b"R", fid_str, b"")
                out.append(b"\x00" + U32.pack(len(data)))
                out.append(data)
            except Exception as e:  # noqa: BLE001 - a per-fid answer
                msg = f"{type(e).__name__}: {e}".encode()[:4096]
                out.append(b"\x01" + U32.pack(len(msg)) + msg)
        return b"".join(out)

    def _batch_write(self, body: bytes) -> bytes:
        out = []
        for fid_str, data in unpack_fid_frames(body, with_data=True):
            try:
                out.append(b"\x00" + self._handle_one(b"W", fid_str, data))
            except Exception:  # noqa: BLE001 - a per-fid answer
                out.append(b"\x01" + U32.pack(0))
        return b"".join(out)


class TcpVolumeClient(FramedClient):
    def write(self, addr: str, fid: str, data: bytes) -> int:
        return U32.unpack(self.request(addr, b"W", fid, data))[0]

    def read(self, addr: str, fid: str) -> bytes:
        return self.request(addr, b"R", fid)

    def delete(self, addr: str, fid: str) -> int:
        return U32.unpack(self.request(addr, b"D", fid))[0]

    def batch_read(self, addr: str,
                   fids: list[str]) -> list[Optional[bytes]]:
        """N needles in one frame round trip; a fid that failed is a None
        in its slot, never an exception for the whole batch."""
        payload = self.request(addr, b"B", "",
                               pack_fid_frames(fids, with_data=False))
        out: list = []
        i = 0
        while i < len(payload) and len(out) < len(fids):
            st = payload[i:i + 1]
            n = U32.unpack_from(payload, i + 1)[0]
            i += 5
            out.append(payload[i:i + n] if st == b"\x00" else None)
            i += n
        out.extend([None] * (len(fids) - len(out)))
        return out

    def batch_write(self, addr: str,
                    items: list[tuple[str, bytes]]) -> list[bool]:
        """N writes in one frame round trip -> each one's success."""
        payload = self.request(addr, b"P", "",
                               pack_fid_frames(items, with_data=True))
        out: list = []
        i = 0
        while i < len(payload) and len(out) < len(items):
            out.append(payload[i:i + 1] == b"\x00")
            i += 5
        out.extend([False] * (len(items) - len(out)))
        return out
