"""The framed-TCP RPC plumbing under the raw-TCP planes.

The port's copy of seaweedfs_tpu/utils/framing.py.  One frame shape
serves every framed front (the volume server's needle IO, the master's
assign):

  request:  op(1) | key_len(u16) | key utf8 | body_len(u32) | body
  response: status(1, 0=ok)      | payload_len(u32) | payload

A framed port is the HTTP port + 20000, wrapping down by 20000 past 65535
(``tcp_port_for``).  ``FramedServer`` calls ``handler(op, key, body) ->
payload`` for each frame through ``serve_frame``; any exception becomes a
status-1 frame carrying ``"<type>: <message>"`` and the connection
survives.  It registers with the process's reactor (utils/eventloop.py)
unless ``WEED_DATAPLANE=threaded``, which gives each connection a thread
of its own.  ``FramedClient`` keeps one TCP_NODELAY connection per
(thread, address), clamps each op's timeout to the caller's deadline and
resends once only on a reused connection; both ends read frames through
a buffered reader (``read_exact``).  ``pack_fid_frames`` and
``unpack_fid_frames`` are the batch record stream the ``B``/``P`` ops and
``/batch/write`` share.

``serve_frame`` is also the framed plane's telemetry chokepoint: with
the process's request log on, one sampled access record an op (its route
class from the op byte, reqlog.py ``NATIVE_ROUTES``), and with a
``ledger`` (the owning server's RequestLedger, read off ``FramedServer.
ledger`` by either front) the op's thread CPU, bytes and wait for a
worker settle into its route class and client.

Not ported: the client's ``net.*`` fault points.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Optional

from ..observability import context as _trace_context
from ..observability import events as _events
from ..observability import get_tracer as _get_tracer
from ..observability import reqlog as _reqlog
from ..stats import degraded_bind_metrics
from . import deadline as _deadline
from . import faultinject as _fi
from .httpd import net_faults as _net_faults

TCP_PORT_OFFSET = 20000
# the process's request log: read once a frame
_RECORDER = _reqlog.get_recorder()
U16 = struct.Struct(">H")
U32 = struct.Struct(">I")


def tcp_port_for(http_port: int) -> int:
    """http port + 20000, wrapping DOWN when that leaves the valid range
    (test servers sit on high ephemeral ports)."""
    p = http_port + TCP_PORT_OFFSET
    return p if p <= 65535 else http_port - TCP_PORT_OFFSET


def tcp_address(http_url: str) -> str:
    """host:port -> host:tcp_port_for(port)."""
    host, _, port = http_url.partition(":")
    return f"{host}:{tcp_port_for(int(port))}"


def pack_fid_frames(items, with_data: bool) -> bytes:
    """The batch record stream: ``u16 fid_len | fid`` (and ``u32 data_len
    | data`` when ``with_data``), repeated; ``items`` are fids, or (fid,
    data) pairs."""
    out = []
    for item in items:
        fid = item[0] if with_data else item
        f = fid.encode()
        out.append(U16.pack(len(f)) + f)
        if with_data:
            data = item[1]
            out.append(U32.pack(len(data)))
            out.append(data)
    return b"".join(out)


def unpack_fid_frames(body: bytes, with_data: bool) -> list:
    """Decode ``pack_fid_frames``; any truncation raises ValueError, so a
    torn batch is refused whole before one record is acted on.  ->
    [fid] or [(fid, data)]."""
    out: list = []
    i = 0
    n = len(body)
    while i < n:
        if i + 2 > n:
            raise ValueError("truncated batch frame")
        flen = U16.unpack_from(body, i)[0]
        i += 2
        if i + flen > n:
            raise ValueError("truncated batch frame")
        fid = body[i:i + flen].decode(errors="replace")
        i += flen
        if not with_data:
            out.append(fid)
            continue
        if i + 4 > n:
            raise ValueError("truncated batch frame")
        dlen = U32.unpack_from(body, i)[0]
        i += 4
        if i + dlen > n:
            raise ValueError("truncated batch frame")
        out.append((fid, body[i:i + dlen]))
        i += dlen
    return out


def read_exact(rfile, n: int) -> bytes:
    """``n`` bytes from a buffered socket reader.  The reference's
    ``recv_exact`` calls ``recv`` for each field of a frame, and each
    ``recv`` gives up the GIL, which a thread among many waits to get
    back; from a buffer, one ``recv`` serves every field of a frame that
    arrived whole."""
    data = rfile.read(n) if n else b""
    if len(data) != n:
        raise ConnectionError("peer closed")
    return data


def note_degraded_bind(role: str, server: str, port: int) -> None:
    """A server came up without its framed plane (``port`` stayed taken);
    its HTTP plane serves everything.  Said on three channels: a
    ``server.degraded_bind`` trace event, a ``degraded_bind`` journal
    event and ``SeaweedFS_server_degraded_binds_total{role}``."""
    detail = "framed-TCP plane bind failed; HTTP still serves"
    degraded_bind_metrics().degraded_binds.inc(role)
    _get_tracer().event("server.degraded_bind", role=role, port=port,
                        detail=detail)
    _events.emit("degraded_bind", role=role, server=server, port=port,
                 detail=detail)


def serve_frame(handler: Callable[[bytes, str, bytes], bytes],
                name: str, op: bytes, key: str, body: bytes,
                peer: str = "", send=None, ledger=None,
                queue_wait_s: float = 0.0) -> bytes:
    """Serve one framed op: the one ingress both fronts share.  Returns
    the whole response frame (status, length, payload); an exception
    becomes a status-1 frame and never escapes.  ``send`` (the threaded
    front passes ``conn.sendall``) sends the frame inside the op; the
    reactor passes None and queues the returned frame.

    A frame has no Traceparent slot, so each op is a head-sampling
    decision of its own, with a ``tcp.<name>`` span only when sampled.
    It has no X-Weed-Deadline slot either, so each op runs with no
    budget: the thread's deadline slot is cleared for it and restored
    after, or a pooled worker would carry an earlier request's budget
    into this frame.

    ``peer`` is the client's address; ``ledger`` the owning server's
    RequestLedger or None; ``queue_wait_s`` the reactor's wait from parse
    to worker (0 on the threaded front, which runs the frame inline)."""
    t_frame0 = time.perf_counter() if _RECORDER.enabled else 0.0
    # the ledger's stamp, on the thread that runs the frame
    ltok = ledger.begin() if ledger is not None else None
    tracer = _get_tracer()
    prev_ctx = sampled = None
    traced = False
    if tracer.enabled:
        sampled, prev_ctx = _trace_context.begin_request(None)
        traced = True
    _ddl, prev_ddl = _deadline.begin_request(None)
    frame_status, out_len = 200, 0
    try:
        try:
            # unsampled ops build no span name
            if sampled is not None:
                with tracer.span(f"tcp.{name}",
                                 op=op.decode("latin-1"), key=key):
                    payload = handler(op, key, body)
            else:
                payload = handler(op, key, body)
            out_len = len(payload)
            frame = b"\x00" + U32.pack(len(payload)) + payload
        except Exception as e:  # noqa: BLE001 - the connection survives
            frame_status = 500
            msg = f"{type(e).__name__}: {e}".encode()[:65536]
            out_len = len(msg)
            frame = b"\x01" + U32.pack(len(msg)) + msg
        if send is not None:
            send(frame)
    finally:
        _deadline.end_request(prev_ddl)
        if traced:
            _trace_context.end_request(prev_ctx)
        if _RECORDER.enabled and t_frame0:
            # a frame has no query string to redact
            try:
                _RECORDER.record(
                    _reqlog.NATIVE_ROUTES.get(
                        op, f"native_{op.decode('latin-1')}"),
                    "TCP", "/" + key, frame_status,
                    bytes_in=len(body), bytes_out=out_len,
                    duration_ms=(time.perf_counter() - t_frame0) * 1e3,
                    peer=peer, handler=name)
            except Exception:  # noqa: BLE001 - recording never breaks serving
                pass
        if ledger is not None:
            try:
                ledger.settle_native(
                    ltok, op, frame_status, len(body), out_len, peer,
                    sampled.trace_id if sampled is not None else "",
                    queue_wait_s)
            except Exception:  # noqa: BLE001 - accounting never breaks serving
                pass
    return frame


class FramedServer:
    """A framed listener at host:port serving ``handler``.  With
    ``whitelist_ok`` (the guard's ``check_white_list``) a connection from a
    peer it refuses is closed before a frame is read, on either front."""

    def __init__(self, handler: Callable[[bytes, str, bytes], bytes],
                 host: str = "127.0.0.1", port: int = 0,
                 whitelist_ok: Optional[Callable[[str], bool]] = None,
                 name: str = "framed"):
        self.handler = handler
        self.host, self.port = host, port
        self._whitelist_ok = whitelist_ok
        self.name = name
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._reactor = None
        # the owning server's RequestLedger (observability/ledger.py): each
        # front reads it here (the reactor through its listener's owner)
        self.ledger = None

    @property
    def alive(self) -> bool:
        return self._sock is not None

    def start(self) -> "FramedServer":
        """Bind and serve; a failed bind leaves the server not ``alive``
        (the HTTP plane still serves everything)."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((self.host, self.port))
        except OSError:
            self._sock.close()
            self._sock = None
            return self
        self._sock.listen(64)
        from . import eventloop

        if eventloop.reactor_enabled():
            # the loop owns accept and readiness; frames run on its pool
            # through serve_frame, as the threaded front's do
            self._reactor = eventloop.get_reactor()
            self._reactor.add_framed_listener(self._sock, self.handler,
                                              self.name, self)
            return self
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"{self.name}:{self.port}").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._reactor is not None:
            # the loop closes the listener and aborts its connections
            self._reactor.remove_listener(self)
            self._reactor = None
            self._sock = None
            return
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # the listener closed
            if self._whitelist_ok is not None and \
                    not self._whitelist_ok(addr[0]):
                conn.close()
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"{self.name}-conn:{addr[1]}").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb", buffering=1 << 16)
        try:
            peer = conn.getpeername()[0]
        except OSError:
            peer = ""
        try:
            while not self._stop.is_set():
                try:
                    op = read_exact(rfile, 1)
                    key_len = U16.unpack(read_exact(rfile, 2))[0]
                    key = read_exact(rfile, key_len).decode()
                    body_len = U32.unpack(read_exact(rfile, 4))[0]
                    body = read_exact(rfile, body_len)
                except (ConnectionError, OSError, UnicodeDecodeError):
                    return
                try:
                    serve_frame(self.handler, self.name, op, key, body,
                                peer, send=conn.sendall, ledger=self.ledger)
                except OSError:
                    return  # the peer went away mid-send
        finally:
            rfile.close()
            conn.close()


class FramedClient(threading.local):
    """Per-thread persistent framed-TCP connections, one per server, each
    a socket and its buffered reader."""

    def __init__(self):
        self._conns: dict[str, tuple] = {}

    def _conn(self, addr: str, timeout: float = 30.0) -> tuple:
        conn = self._conns.get(addr)
        if conn is None:
            host, _, port = addr.partition(":")
            # the connect waits no longer than the caller's budget either
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = self._conns[addr] = (sock, sock.makefile(
                "rb", buffering=1 << 16))
        return conn

    def _drop(self, addr: str) -> None:
        conn = self._conns.pop(addr, None)
        if conn is not None:
            for part in (conn[1], conn[0]):
                try:
                    part.close()
                except OSError:
                    pass

    def request(self, addr: str, op: bytes, key: str,
                body: bytes = b"") -> bytes:
        """One framed op -> its payload; a status-1 answer raises OSError
        with the server's text.  The timeout is clamped to the caller's
        deadline; a failure on a reused connection is resent once on a
        new one.  The egress rides the pooled HTTP client's peer-scoped
        net.* fault points."""
        if _fi._points:
            _net_faults(addr)
        op_timeout = _deadline.clamp(30.0)
        key_b = key.encode()
        frame = (op + U16.pack(len(key_b)) + key_b
                 + U32.pack(len(body)) + body)
        for _attempt in (0, 1):
            reused = addr in self._conns
            sock, rfile = self._conn(addr, op_timeout)
            try:
                sock.settimeout(op_timeout)
                sock.sendall(frame)
                head = read_exact(rfile, 5)
                status = head[:1]
                payload = read_exact(rfile, U32.unpack_from(head, 1)[0])
            except (ConnectionError, OSError):
                self._drop(addr)
                ddl = _deadline.current()
                if ddl is not None and ddl.expired():
                    # the budget ran out, not the wire: callers answer 504
                    raise _deadline.DeadlineExceeded(
                        f"deadline exceeded awaiting {addr}") from None
                if not reused:
                    raise
                continue
            if status != b"\x00":
                raise OSError(payload.decode(errors="replace"))
            return payload
        raise ConnectionError(f"{addr}: no answer")  # pragma: no cover
