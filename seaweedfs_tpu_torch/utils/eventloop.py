"""The event-loop serving front: one selector reactor per process.

The port's copy of the HTTP side of seaweedfs_tpu/utils/eventloop.py.
Every port server (volume servers and masters) registers its listening
socket here through ``utils/httpd.serve``:

  - the loop owns accept and readable/writable readiness for every
    connection, parses HTTP/1.1 requests without blocking and keeps
    connections alive across requests (keep-alive and pipelining, one
    request in flight per connection, answered in order);
  - parsed requests dispatch onto a bounded worker pool that runs the
    untouched ``Router.dispatch``, so tracing, deadlines and admission
    ride the code they always rode.  The pool has two lanes: operator
    and control-plane paths (heartbeats, ``/metrics``, ``/cluster``,
    ``/admin``, ``/raft``, ...) take the priority lane.  ``workers``
    core threads (``-dataplane.workers``; by default ``max(4, min(16,
    2 x cpus))``) serve it; when more requests wait than workers are
    idle an overflow worker starts, up to 128, and retires after 2 s
    idle: a degraded GET that
    waits on survivor fetches from other servers holds a worker, and
    servers fetching from each other must not starve each other's pools;
  - responses leave from the worker that made them (one gather write),
    or from the loop when the socket is full; ``Response(file_path=...)``
    bodies stream with ``os.sendfile``.  A worker whose response passes
    64 MB unsent waits for the client to drain it, and a client that
    reads nothing for 30 s is aborted;
  - GET/HEAD reads that the router's ``loop_fast_probe`` vouches for (the
    volume server: needles its needle cache holds, of a live volume)
    dispatch inline on the loop with no thread handoff.  EC reads never
    do, so no kernel is launched from the loop thread.

``SeaweedFS_dataplane_*`` (stats/metrics.py ``DataplaneMetrics``) counts
connections, workers, dispatches by lane kind, loop lag and stalls, and
connections aborted with work in flight (``dataplane_conn_aborts``
health key, a rate-limited ``dataplane_conn_abort`` event).

The framed-TCP fronts (utils/framing.py ``FramedServer``: the volume
server's needle IO, the master's assign) register their listeners here
too (``add_framed_listener``): the loop parses each frame without
blocking and runs its handler on the data lane through ``serve_frame``,
one frame in flight per connection, so pipelined frames are answered in
order.  A stop aborts a framed listener's connections as it does an HTTP
one's.

``WEED_DATAPLANE=threaded`` makes ``serve`` and ``FramedServer`` fall
back to a thread per connection; ``-dataplane.workers N`` sizes the pool
before the first server starts.

The resource ledger (observability/ledger.py) reads the loop: a volume
server with its ledger on sets ``stall_hook`` to ``RequestLedger.
note_stall`` (the watchdog's stall then carries its route and exemplar
trace) and hands ``loop_lag_stats`` to the ledger's snapshots; the loop
thread is branded (``_weed_loop``) so a request settled on it past
LOOP_STALL_THRESHOLD_S (the ledger's) counts as a stall; a framed op
settles with its peer, the listener owner's ledger and its wait for a
worker.

Not ported: the loop's fault point.
"""

from __future__ import annotations

import io
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

from . import faultinject as _fi

# per-connection bounds, mirroring the threaded servers' guards
MAX_HEADER_BYTES = 1 << 16          # request line + headers
MAX_HEADERS = 100
MAX_BODY_BYTES = 1 << 30            # buffered request body cap (413 past it)
MAX_OUT_BUFFERED = 64 << 20         # queued response bytes before a worker
#                                     waits for the client (sendfile
#                                     regions stream from disk: not counted)
FLUSH_THRESHOLD = 1 << 20           # past this, enqueue() drains the socket
#                                     as it writes
SLOW_CLIENT_GRACE_S = 30.0          # a backpressured worker waits this long
#                                     for the client before the abort
RECV_CHUNK = 1 << 16

# core + overflow workers, a runaway backstop
HARD_WORKER_CAP = 128

# the priority lane: liveness and operator visibility never queue behind
# a burst of object traffic (utils/admission.py's exempt prefixes, plus
# the raft wire)
OPS_PRIORITY_PREFIXES = (
    "/metrics", "/debug", "/cluster", "/ec/scrub", "/admin",
    "/heartbeat", "/dir/status", "/status", "/stats", "/raft",
)

_EVENT_MIN_INTERVAL_S = 5.0
_HAS_SENDFILE = hasattr(os, "sendfile")


def _metrics():
    from ..stats import dataplane_metrics

    return dataplane_metrics()


class _FileSend:
    """One sendfile region queued on a connection's outbox."""

    __slots__ = ("fd", "offset", "remaining")

    def __init__(self, fd: int, offset: int, length: int):
        self.fd = fd
        self.offset = offset
        self.remaining = length

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass


class _ConnWriter:
    """The ``wfile`` a handler writes to: each write queues the caller's
    own bytes on the connection's outbox, no join and no copy."""

    __slots__ = ("conn",)

    def __init__(self, conn: "_Conn"):
        self.conn = conn

    def write(self, data) -> int:
        self.conn.enqueue(data)
        return len(data)

    def flush(self) -> None:
        pass


class _LoopHandler:
    """One request's handler: the BaseHTTPRequestHandler surface
    ``Router.dispatch`` uses, its response side backed by the
    connection's outbox, with ``sendfile`` for file bodies."""

    __slots__ = ("server", "rfile", "wfile", "client_address", "command",
                 "path", "headers", "close_connection", "_out", "_conn",
                 "queue_wait_s")

    def __init__(self, server, conn: "_Conn", body: bytes, peer):
        self.server = server
        self._conn = conn
        # loop enqueue -> worker pickup; 0 on the inline fast path
        self.queue_wait_s = 0.0
        self.rfile = io.BytesIO(body)
        self.wfile = _ConnWriter(conn)
        self.client_address = peer
        self.command = ""
        self.path = ""
        self.headers = None
        self.close_connection = True
        self._out: list = []

    def send_response(self, status: int, message: str = "") -> None:
        from .httpd import _REASONS, _http_date

        self._out = [b"HTTP/1.1 %d %s\r\nDate: %s\r\n"
                     % (status,
                        (message or _REASONS.get(status, "OK")).encode(),
                        _http_date().encode())]

    def send_header(self, key: str, value) -> None:
        self._out.append(f"{key}: {value}\r\n".encode())
        if key.lower() == "connection" and str(value).lower() == "close":
            self.close_connection = True

    def end_headers(self) -> None:
        self._out.append(b"\r\n")
        self._conn.enqueue(b"".join(self._out))
        self._out = []

    def sendfile(self, path: str, offset: int, length: int) -> bool:
        """Queue a file region for the flushers to ``os.sendfile``; False
        when the platform or the file cannot, and the caller writes the
        body through ``wfile``."""
        if not _HAS_SENDFILE:
            return False
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return False
        self._conn.enqueue_file(_FileSend(fd, offset, length))
        return True


class _Conn:
    """One connection the reactor owns.  Parse state is the loop's alone;
    the outbox and the lifecycle flags are shared with the workers under
    ``_lock`` (a Condition: flushers notify when the outbox shrinks)."""

    __slots__ = ("reactor", "listener", "sock", "fileno", "peer",
                 "inbuf", "body_needed", "pending", "want_events",
                 "_lock", "outq", "out_bytes", "busy", "closing",
                 "aborted", "flushing")

    def __init__(self, reactor: "Reactor", listener: "_Listener",
                 sock: socket.socket, peer):
        self.reactor = reactor
        self.listener = listener
        self.sock = sock
        self.fileno = sock.fileno()
        self.peer = peer
        # loop-thread-only parse state
        self.inbuf = bytearray()
        self.body_needed = -1      # >= 0: head parsed, awaiting the body
        self.pending = None        # the parsed head awaiting its body
        self.want_events = selectors.EVENT_READ
        self._lock = threading.Condition()
        self.outq: list = []       # guarded-by: _lock
        self.out_bytes = 0         # guarded-by: _lock
        self.busy = False          # guarded-by: _lock
        self.closing = False       # guarded-by: _lock
        self.aborted = False       # guarded-by: _lock
        self.flushing = False      # one sender at a time  # guarded-by: _lock

    # --- the workers' side -------------------------------------------------
    def enqueue(self, data) -> None:
        """Queue response bytes (from a worker, or the loop's fast path).
        Small responses flush once at ``request_done``; past
        FLUSH_THRESHOLD the writer drains the socket as it writes, so a
        large body streams through a bounded outbox, and past
        MAX_OUT_BUFFERED a worker waits for the client to read."""
        if not len(data):
            # an all-empty sendmsg batch sends 0 bytes, which the flusher
            # could not tell from no progress
            return
        with self._lock:
            if self.aborted:
                return
            self.outq.append(data)
            self.out_bytes += len(data)
            big = self.out_bytes >= FLUSH_THRESHOLD
        if not big:
            return
        self.reactor.flush_conn(self)
        with self._lock:
            over = not self.aborted and self.out_bytes > MAX_OUT_BUFFERED
        if not over:
            return
        if self.reactor.on_loop_thread():
            # the loop never waits: a pipelining client that amassed 64 MB
            # of unread inline answers is a slow client, aborted at once
            with self._lock:
                self.aborted = True
            self.reactor.note_abort("slow_client")
            self.reactor.mark_dirty(self)
            return
        # backpressure: the loop watches for writability while this worker
        # waits for the client to drain; only a client that stops reading
        # altogether is aborted
        self.reactor.mark_dirty(self)
        deadline = time.monotonic() + SLOW_CLIENT_GRACE_S
        overflow = False
        with self._lock:
            while not self.aborted and self.out_bytes > MAX_OUT_BUFFERED:
                if time.monotonic() >= deadline:
                    self.aborted = True
                    overflow = True
                    break
                self._lock.wait(timeout=0.5)
        if overflow:
            self.reactor.note_abort("slow_client")
            self.reactor.mark_dirty(self)

    def enqueue_file(self, fs: _FileSend) -> None:
        with self._lock:
            if self.aborted:
                fs.close()
                return
            self.outq.append(fs)

    def request_done(self, close: bool) -> None:
        """One dispatch finished: flush from this thread (a response that
        fits the socket needs no loop round trip), then wake the loop only
        when it has work: output left, pipelined input, or a close."""
        with self._lock:
            self.busy = False
            if close:
                self.closing = True
        self.reactor.flush_conn(self)
        with self._lock:
            need_loop = bool(self.outq) or self.closing or self.aborted
        # a pipelined request that lands after this check re-fires
        # EVENT_READ on its own
        if need_loop or len(self.inbuf) > 0:
            self.reactor.mark_dirty(self)

    # --- the loop's side ---------------------------------------------------
    def drain_out(self) -> None:
        """Drop queued output unsent (the abort path); sendfile fds close
        under the lock a flusher sends under."""
        with self._lock:
            items, self.outq = self.outq, []
            self.out_bytes = 0
            for item in items:
                if isinstance(item, _FileSend):
                    item.close()
            self._lock.notify_all()


class _Listener:
    """One listening socket on the reactor."""

    __slots__ = ("sock", "kind", "owner", "router", "handler", "name",
                 "conns")

    def __init__(self, sock: socket.socket, kind: str, owner,
                 router=None, handler=None, name: str = ""):
        self.sock = sock
        self.kind = kind              # "http" | "framed"
        self.owner = owner            # the facade server (_stopping)
        self.router = router
        self.handler = handler        # framed: fn(op, key, body) -> bytes
        self.name = name
        self.conns: set = set()       # loop-thread-only


class Reactor:
    """The process's selector loop and its two-lane worker pool."""

    def __init__(self, workers: int = 0):
        self.workers = int(workers) if workers and int(workers) > 0 \
            else max(4, min(16, (os.cpu_count() or 4) * 2))
        self._sel = selectors.DefaultSelector()   # loop-thread-only
        self._lock = threading.Lock()
        self._listeners: dict[int, _Listener] = {}  # loop-thread-only
        self._pending: list = []    # listener add/remove  # guarded-by: _lock
        self._dirty: set = set()    # conns to refresh  # guarded-by: _lock
        self._qcond = threading.Condition()
        self._q_ops: list = []      # priority lane  # guarded-by: _qcond
        self._q_data: list = []     # object lane  # guarded-by: _qcond
        self._idle = 0              # parked workers  # guarded-by: _qcond
        self._alive = 0             # core + overflow  # guarded-by: _qcond
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._started = False       # guarded-by: _lock
        self._last_abort_event = 0.0  # guarded-by: _lock
        self._threads: list[threading.Thread] = []  # guarded-by: _lock
        # written once in start() before the loop runs
        self._loop_thread: Optional[threading.Thread] = None
        # the loop stamps each iteration; the watchdog reads the stamp's
        # age to see a loop blocked mid-iteration
        self._tick_ts = time.monotonic()
        # the inline request holding the loop, named in a stall
        self._loop_busy: Optional[str] = None
        # (monotonic ts, busy s) of iterations that held the loop >= 1 ms
        self._lag_samples: deque = deque(maxlen=512)  # guarded-by: _lock
        self._last_stall_note = 0.0
        # fn(route, lag_s, trace_id) called on a stall: a volume server's
        # RequestLedger.note_stall, which counts the loop_stalls family and
        # names the route; None counts SeaweedFS_dataplane_loop_stalls_total
        # alone
        self.stall_hook = None

    # --- lifecycle ---------------------------------------------------------
    def start(self) -> "Reactor":
        with self._lock:
            if self._started:
                return self
            self._started = True
            t = threading.Thread(target=self._run, daemon=True,
                                 name="dataplane-loop")
            self._loop_thread = t
            self._threads.append(t)
            self._threads.append(threading.Thread(
                target=self._watch, daemon=True, name="dataplane-watchdog"))
            for i in range(self.workers):
                self._threads.append(threading.Thread(
                    target=self._work, daemon=True,
                    name=f"dataplane-worker-{i}"))
            threads = list(self._threads)
        with self._qcond:
            self._alive += self.workers
        _metrics().workers.set(self.workers)
        for t in threads:
            t.start()
        return self

    def on_loop_thread(self) -> bool:
        return threading.current_thread() is self._loop_thread

    def wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def mark_dirty(self, conn: _Conn) -> None:
        with self._lock:
            self._dirty.add(conn)
        self.wake()

    def note_abort(self, reason: str) -> None:
        """Count one aborted connection; journal it, rate-limited."""
        _metrics().conn_aborts.inc(reason)
        now = time.monotonic()
        with self._lock:
            emit = now - self._last_abort_event >= _EVENT_MIN_INTERVAL_S
            if emit:
                self._last_abort_event = now
        if emit:
            from ..observability import events as _events

            try:
                _events.emit("dataplane_conn_abort", reason=reason)
            except Exception:  # noqa: BLE001 - accounting never breaks serving
                pass

    # --- listeners ----------------------------------------------------------
    def add_http_listener(self, sock: socket.socket, router, owner) -> None:
        self._add_listener(_Listener(sock, "http", owner, router=router))

    def add_framed_listener(self, sock: socket.socket, handler,
                            name: str, owner) -> None:
        """A framed-TCP listener (utils/framing.py): each frame runs
        ``handler`` on the pool through ``serve_frame``."""
        self._add_listener(_Listener(sock, "framed", owner,
                                     handler=handler, name=name))

    def _add_listener(self, lst: _Listener) -> None:
        lst.sock.setblocking(False)
        with self._lock:
            self._pending.append(("add", lst))
        self.wake()

    def remove_listener(self, owner, deadline_s: float = 1.5) -> None:
        """Stop accepting for ``owner`` and abort its connections; returns
        once the loop has done so (bounded), and the port can be bound
        again at once."""
        done = threading.Event()
        with self._lock:
            self._pending.append(("remove", owner, done))
        self.wake()
        done.wait(timeout=max(deadline_s, 0.1))

    # --- the worker pool ------------------------------------------------------
    def submit(self, fn: Callable[[], None], ops: bool = False) -> None:
        """Queue one dispatch without blocking; ``ops`` takes the priority
        lane.  When the queue holds more requests than there are idle
        workers to take them, an overflow worker starts (up to
        HARD_WORKER_CAP), so handlers that wait on other servers cannot
        starve the pool.  (The reference starts one only when no worker is
        idle, and a worker it has just notified still counts as idle: two
        quick submits can leave the second queued behind busy workers.)"""
        spawn = False
        with self._qcond:
            (self._q_ops if ops else self._q_data).append(fn)
            queued = len(self._q_ops) + len(self._q_data)
            if queued > self._idle and self._alive < HARD_WORKER_CAP:
                self._alive += 1
                spawn = True
            self._qcond.notify()
        if spawn:
            threading.Thread(target=self._work, args=(True,), daemon=True,
                             name="dataplane-worker-extra").start()

    def _work(self, extra: bool = False) -> None:
        while True:
            with self._qcond:
                self._idle += 1
                try:
                    while not self._q_ops and not self._q_data:
                        if not self._qcond.wait(timeout=2.0) and extra \
                                and not self._q_ops and not self._q_data:
                            self._alive -= 1
                            return  # an overflow worker idled out
                finally:
                    self._idle -= 1
                fn = (self._q_ops.pop(0) if self._q_ops
                      else self._q_data.pop(0))
            try:
                fn()
            except Exception:  # noqa: BLE001 - a worker never dies
                pass

    # --- the loop -----------------------------------------------------------
    def _run(self) -> None:
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        # the ledger asks "am I on the loop?" with one attribute read
        threading.current_thread()._weed_loop = True
        while True:
            self._apply_pending()
            self._tick_ts = time.monotonic()
            try:
                events = self._sel.select(timeout=1.0)
            except OSError:
                continue
            t_busy0 = time.monotonic()
            for key, mask in events:
                data = key.data
                try:
                    if data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except OSError:
                            pass
                    elif isinstance(data, _Listener):
                        self._on_accept(data)
                    elif isinstance(data, _Conn):
                        if mask & selectors.EVENT_READ:
                            self._on_readable(data)
                        if mask & selectors.EVENT_WRITE:
                            self._on_writable(data)
                except Exception:  # noqa: BLE001 - one connection's fault
                    if isinstance(data, _Conn):
                        try:
                            self._close_conn(data, abort_reason="loop_error")
                        except Exception:  # noqa: BLE001
                            pass
            busy_s = time.monotonic() - t_busy0
            if busy_s >= 0.001:
                # every connection waited this long; sub-ms iterations are
                # not worth a lock
                with self._lock:
                    self._lag_samples.append((t_busy0, busy_s))
                _metrics().loop_lag.observe(busy_s)

    def loop_lag_stats(self, window_s: float = 60.0) -> dict:
        """Loop lag percentiles over the recent window, the dispatch
        queue's depth and the pool's occupancy."""
        now = time.monotonic()
        with self._lock:
            samples = sorted(b for (t, b) in self._lag_samples
                             if now - t <= window_s)
        with self._qcond:
            qdepth = len(self._q_ops) + len(self._q_data)
            alive, idle = self._alive, self._idle

        def pct(p: float) -> float:
            if not samples:
                return 0.0
            return samples[min(int(p * len(samples)), len(samples) - 1)]

        return {
            "lag_p50_ms": round(pct(0.50) * 1000.0, 2),
            "lag_p99_ms": round(pct(0.99) * 1000.0, 2),
            "lag_max_ms": round(samples[-1] * 1000.0, 2) if samples
            else 0.0,
            "samples": len(samples),
            "queue_depth": qdepth,
            "workers": alive,
            "workers_busy": max(alive - idle, 0),
        }

    def _watch(self) -> None:
        """Refresh the queue-depth and occupancy gauges, and see a blocked
        loop from outside it: the tick stamp older than the select timeout
        plus LOOP_STALL_THRESHOLD_S means nothing moves."""
        from ..observability.ledger import LOOP_STALL_THRESHOLD_S

        while True:
            time.sleep(0.25)
            try:
                m = _metrics()
                with self._qcond:
                    qo, qd = len(self._q_ops), len(self._q_data)
                    alive, idle = self._alive, self._idle
                m.queue_depth.set("ops", float(qo))
                m.queue_depth.set("data", float(qd))
                m.workers_busy.set(float(max(alive - idle, 0)))
                # an idle loop's stamp is legitimately 1 s (the select
                # timeout) old
                lag = time.monotonic() - self._tick_ts - 1.0
                if lag < LOOP_STALL_THRESHOLD_S:
                    continue
                hook = self.stall_hook
                if hook is not None:
                    hook(self._loop_busy or "(loop)", lag, "")
                    continue
                now = time.monotonic()
                if now - self._last_stall_note >= _EVENT_MIN_INTERVAL_S:
                    self._last_stall_note = now
                    m.loop_stalls.inc()
            except Exception:  # noqa: BLE001 - the watchdog never dies
                pass

    def _apply_pending(self) -> None:
        with self._lock:
            ops, self._pending = self._pending, []
            dirty, self._dirty = self._dirty, set()
        for op in ops:
            if op[0] == "add":
                lst = op[1]
                self._listeners[lst.sock.fileno()] = lst
                try:
                    self._sel.register(lst.sock, selectors.EVENT_READ, lst)
                except (OSError, ValueError, KeyError):
                    pass
            else:  # ("remove", owner, done)
                _, owner, done = op
                for fno, lst in list(self._listeners.items()):
                    if lst.owner is not owner:
                        continue
                    del self._listeners[fno]
                    try:
                        self._sel.unregister(lst.sock)
                    except (OSError, ValueError, KeyError):
                        pass
                    try:
                        lst.sock.close()
                    except OSError:
                        pass
                    for conn in list(lst.conns):
                        self._close_conn(conn, abort_reason="stop")
                done.set()
        for conn in dirty:
            try:
                self._refresh_conn(conn)
            except Exception:  # noqa: BLE001
                try:
                    self._close_conn(conn, abort_reason="loop_error")
                except Exception:  # noqa: BLE001
                    pass

    def _refresh_conn(self, conn: _Conn) -> None:
        """After a worker's activity: flush, parse pipelined input, close
        when drained."""
        if conn not in conn.listener.conns:
            return  # already torn down
        with conn._lock:
            aborted = conn.aborted
        if aborted:
            self._close_conn(conn)
            return
        self.flush_conn(conn)
        self._advance(conn)

    def _on_accept(self, lst: _Listener) -> None:
        for _ in range(64):  # a bounded accept burst per readiness
            try:
                sock, peer = lst.sock.accept()
            except OSError:
                return
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                sock.close()
                continue
            if lst.kind == "framed":
                ok_fn = getattr(lst.owner, "_whitelist_ok", None)
                if ok_fn is not None and not ok_fn(peer[0]):
                    sock.close()
                    continue
            conn = _Conn(self, lst, sock, peer)
            lst.conns.add(conn)
            _metrics().connections.add(1)
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (OSError, ValueError, KeyError):
                lst.conns.discard(conn)
                _metrics().connections.add(-1)
                sock.close()

    def _on_readable(self, conn: _Conn) -> None:
        try:
            piece = conn.sock.recv(RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not piece:
            # the peer half-closed: finish what is in flight, then close
            with conn._lock:
                conn.closing = True
                busy = conn.busy
            if not busy and not conn.inbuf:
                self._close_conn(conn)
            else:
                self._refresh_conn(conn)
            return
        conn.inbuf += piece
        if len(conn.inbuf) > MAX_BODY_BYTES + MAX_HEADER_BYTES:
            # streaming past every framing bound while a request is in
            # flight: a memory-exhaustion vector
            self._close_conn(conn, abort_reason="overflow")
            return
        self._advance(conn)

    def _advance(self, conn: _Conn) -> None:
        """Parse what the one-request-in-flight rule allows, then update
        the selector interest."""
        while True:
            with conn._lock:
                if conn.busy or conn.closing or conn.aborted:
                    break
            parse = self._parse_http if conn.listener.kind == "http" \
                else self._parse_frame
            if not parse(conn):
                break
        self._update_interest(conn)

    # --- HTTP parsing -------------------------------------------------------
    def _parse_http(self, conn: _Conn) -> bool:
        """One parse step; True when a request was dispatched or its head
        parsed (the caller loops for pipelining)."""
        if conn.body_needed < 0:
            end = conn.inbuf.find(b"\r\n\r\n")
            if end < 0:
                if len(conn.inbuf) > MAX_HEADER_BYTES:
                    # still inside the request line: 414; past it: 431
                    if b"\r\n" not in conn.inbuf:
                        self._reject_http(conn, 414, "URI Too Long")
                    else:
                        self._reject_http(
                            conn, 431, "Request Header Fields Too Large")
                return False
            head = bytes(conn.inbuf[:end])
            del conn.inbuf[:end + 4]
            if not self._parse_http_head(conn, head):
                return False
            if conn.body_needed == 0:
                conn.body_needed = -1
                return self._dispatch_http(conn, b"")
            return True  # the body may already be buffered
        if len(conn.inbuf) < conn.body_needed:
            return False
        body = bytes(conn.inbuf[:conn.body_needed])
        del conn.inbuf[:conn.body_needed]
        conn.body_needed = -1
        return self._dispatch_http(conn, body)

    def _parse_http_head(self, conn: _Conn, head: bytes) -> bool:
        from .httpd import CIHeaders

        lines = head.split(b"\r\n")
        try:
            method, _, rest = lines[0].partition(b" ")
            target, _, version = rest.rpartition(b" ")
            command = method.decode("ascii")
            path = target.decode("iso-8859-1")
        except (UnicodeDecodeError, ValueError):
            self._reject_http(conn, 400, "Bad Request")
            return False
        if not command or not path:
            self._reject_http(conn, 400, "Bad Request")
            return False
        if len(lines) - 1 > MAX_HEADERS:
            self._reject_http(conn, 431, "Request Header Fields Too Large")
            return False
        pairs = []
        for hl in lines[1:]:
            if not hl:
                continue
            k, _, v = hl.partition(b":")
            pairs.append((k.decode("iso-8859-1"),
                          v.strip().decode("iso-8859-1")))
        headers = CIHeaders(pairs)
        if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
            # Request.body frames Content-Length bodies only
            self._reject_http(conn, 501, "Not Implemented")
            return False
        try:
            clen = int(headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            self._reject_http(conn, 400, "Bad Request")
            return False
        if clen < 0:
            # a negative length would read as the awaiting-head sentinel
            # and orphan the request
            self._reject_http(conn, 400, "Bad Request")
            return False
        if clen > MAX_BODY_BYTES:
            self._reject_http(conn, 413, "Payload Too Large")
            return False
        conn_hdr = (headers.get("Connection") or "").lower()
        close = (conn_hdr == "close"
                 or (version == b"HTTP/1.0" and conn_hdr != "keep-alive"))
        if (headers.get("Expect") or "").lower() == "100-continue":
            conn.enqueue(b"HTTP/1.1 100 Continue\r\n\r\n")
        conn.pending = (command, path, headers, close)
        conn.body_needed = clen
        return True

    def _reject_http(self, conn: _Conn, status: int, reason: str) -> None:
        conn.enqueue(("HTTP/1.1 %d %s\r\nContent-Length: 0\r\n"
                      "Connection: close\r\n\r\n" % (status, reason)).encode())
        with conn._lock:
            conn.closing = True
        self.flush_conn(conn)
        self._update_interest(conn)

    def _dispatch_http(self, conn: _Conn, body: bytes) -> bool:
        command, path, headers, close = conn.pending
        conn.pending = None
        lst = conn.listener
        h = _LoopHandler(lst.owner, conn, body, conn.peer)
        h.command = command
        h.path = path
        h.headers = headers
        h.close_connection = close
        router = lst.router
        with conn._lock:
            conn.busy = True
        probe = router.loop_fast_probe
        if probe is not None and command in ("GET", "HEAD") \
                and not body and "Range" not in headers \
                and probe(command, path):
            # the probe vouched that the answer is in memory: the whole
            # dispatch runs on the loop, no thread handoff
            self._loop_busy = path
            if _fi._points:
                # the loop-stall drill: a delay here blocks the whole
                # data plane, as blocking IO on the fast path would
                _fi.hit("loop.block")
            try:
                router.dispatch(h, command)
            except Exception:  # noqa: BLE001
                with conn._lock:
                    conn.closing = True
            self._loop_busy = None
            _metrics().fast_dispatches.inc()
            conn.request_done(close=h.close_connection)
            return True
        t_submit = time.monotonic()

        def run():
            h.queue_wait_s = time.monotonic() - t_submit
            try:
                router.dispatch(h, command)
            except Exception:  # noqa: BLE001
                with conn._lock:
                    conn.closing = True
            conn.request_done(close=h.close_connection)

        _metrics().pool_dispatches.inc()
        self.submit(run, ops=path.startswith(OPS_PRIORITY_PREFIXES))
        return True

    # --- framed-TCP parsing -------------------------------------------------
    def _parse_frame(self, conn: _Conn) -> bool:
        """One frame off the buffer, dispatched onto the pool; True when
        one was (the caller loops for pipelined frames, one in flight per
        connection, so they are answered in order)."""
        from .framing import U16, U32, serve_frame

        buf = conn.inbuf
        if len(buf) < 3:
            return False
        key_len = U16.unpack_from(buf, 1)[0]
        if len(buf) < 3 + key_len + 4:
            return False
        body_len = U32.unpack_from(buf, 3 + key_len)[0]
        total = 3 + key_len + 4 + body_len
        if len(buf) < total:
            return False
        op = bytes(buf[:1])
        try:
            key = bytes(buf[3:3 + key_len]).decode()
        except UnicodeDecodeError:
            self._close_conn(conn)
            return False
        body = bytes(buf[3 + key_len + 4:total])
        del conn.inbuf[:total]
        lst = conn.listener
        with conn._lock:
            conn.busy = True
        t_submit = time.monotonic()

        def run():
            conn.enqueue(serve_frame(
                lst.handler, lst.name, op, key, body, conn.peer[0],
                ledger=getattr(lst.owner, "ledger", None),
                queue_wait_s=time.monotonic() - t_submit))
            conn.request_done(close=False)

        _metrics().pool_dispatches.inc()
        self.submit(run)
        return True

    # --- writeback ----------------------------------------------------------
    def flush_conn(self, conn: _Conn) -> None:
        """Send what the socket takes now, from any thread: bytes in one
        gather write, file regions with ``os.sendfile``.  The ``flushing``
        claim keeps one sender per socket, so bytes never interleave."""
        with conn._lock:
            if conn.flushing or conn.aborted:
                return
            conn.flushing = True
        try:
            self._flush_locked_out(conn)
        finally:
            with conn._lock:
                conn.flushing = False

    def _flush_locked_out(self, conn: _Conn) -> None:
        # each send runs under conn._lock: _close_conn closes the socket
        # and queued fds under the same lock after marking the conn
        # aborted, so no send meets a closed (or reused) fd.  The sends do
        # not block, so the lock is held for microseconds.
        while True:
            with conn._lock:
                if not conn.outq or conn.aborted:
                    return
                head = conn.outq[0]
                if isinstance(head, _FileSend):
                    if head.remaining <= 0:
                        head.close()
                        conn.outq.pop(0)
                        continue
                    try:
                        sent = os.sendfile(conn.fileno, head.fd, head.offset,
                                           min(head.remaining, 1 << 20))
                    except (BlockingIOError, InterruptedError):
                        return
                    except OSError:
                        conn.aborted = True
                        conn._lock.notify_all()
                        self.mark_dirty(conn)
                        return
                    if sent == 0:  # the file is shorter than promised
                        head.remaining = 0
                        continue
                    head.offset += sent
                    head.remaining -= sent
                    continue
                batch = []
                for item in conn.outq:
                    if isinstance(item, _FileSend):
                        break
                    batch.append(item if isinstance(item, memoryview)
                                 else memoryview(item))
                    if len(batch) >= 32:
                        break
                try:
                    sent = conn.sock.sendmsg(batch)
                except (BlockingIOError, InterruptedError):
                    return
                except OSError:
                    conn.aborted = True
                    conn._lock.notify_all()
                    self.mark_dirty(conn)
                    return
                conn.out_bytes -= sent
                while conn.outq and not isinstance(conn.outq[0], _FileSend):
                    n = len(conn.outq[0])
                    if n == 0:
                        conn.outq.pop(0)
                    elif sent >= n:
                        conn.outq.pop(0)
                        sent -= n
                    elif sent > 0:
                        conn.outq[0] = memoryview(conn.outq[0])[sent:]
                        sent = 0
                    else:
                        break
                conn._lock.notify_all()  # backpressured writers resume

    def _update_interest(self, conn: _Conn) -> None:
        with conn._lock:
            have_out = bool(conn.outq)
            closing = conn.closing
            busy = conn.busy
            aborted = conn.aborted
        if aborted:
            self._close_conn(conn)
            return
        if closing and not have_out and not busy:
            self._close_conn(conn)
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                         if have_out else 0)
        if events != conn.want_events:
            conn.want_events = events
            try:
                self._sel.modify(conn.sock, events, conn)
            except (OSError, ValueError, KeyError):
                self._close_conn(conn)

    def _on_writable(self, conn: _Conn) -> None:
        self.flush_conn(conn)
        self._update_interest(conn)

    def _close_conn(self, conn: _Conn, abort_reason: str = "") -> None:
        if conn not in conn.listener.conns:
            return
        conn.listener.conns.discard(conn)
        _metrics().connections.add(-1)
        with conn._lock:
            had_work = bool(conn.outq) or conn.busy
            conn.aborted = True
        conn.drain_out()
        if abort_reason and had_work:
            self.note_abort(abort_reason)
        try:
            self._sel.unregister(conn.sock)
        except (OSError, ValueError, KeyError):
            pass
        # under conn._lock, as every send: half-close, drain what already
        # arrived (a close over unread bytes sends RST, which can destroy
        # a just-flushed error answer), close
        with conn._lock:
            try:
                conn.sock.shutdown(socket.SHUT_WR)
                for _ in range(64):
                    if not conn.sock.recv(RECV_CHUNK):
                        break
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass


# --- the process's reactor ---------------------------------------------------

_reactor: Optional[Reactor] = None
_reactor_lock = threading.Lock()
_configured_workers = 0


def configure(workers: Optional[int] = None) -> None:
    """``-dataplane.workers N``: the pool's core size, taken at the
    reactor's first use (it is sized once per process)."""
    global _configured_workers
    if workers is not None and int(workers) > 0:
        with _reactor_lock:
            _configured_workers = int(workers)


def get_reactor() -> Reactor:
    global _reactor
    with _reactor_lock:
        if _reactor is None:
            _reactor = Reactor(workers=_configured_workers)
    return _reactor.start()


def reactor_enabled() -> bool:
    """``WEED_DATAPLANE=threaded`` falls the process back to a thread per
    connection."""
    return os.environ.get("WEED_DATAPLANE", "reactor") != "threaded"


class ReactorHTTPServer:
    """``serve()``'s server over one listener on the process's reactor,
    with the surface ``stop_server`` and the servers use:
    ``server_address``, ``_stopping``, ``shutdown()``, ``server_close()``."""

    # the reference reactor's listen backlog
    request_queue_size = 512

    def __init__(self, addr, router):
        self.router = router
        self._stopping = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind(addr)
            self._sock.listen(self.request_queue_size)
        except OSError:
            self._sock.close()
            raise
        self.server_address = self._sock.getsockname()
        self._reactor = get_reactor()
        self._reactor.add_http_listener(self._sock, router, self)

    def shutdown(self) -> None:
        """Stop accepting, abort open keep-alive connections and release
        the port, within a bounded time."""
        self._stopping = True
        self._reactor.remove_listener(self, deadline_s=1.5)

    def server_close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
