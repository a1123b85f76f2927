"""HTTP server framework and client calls for the port's servers.

The subset of seaweedfs_tpu/utils/httpd.py that the port's servers need:

  - ``Router``: method + regex routes; ``dispatch`` maps a handler's
    exceptions to JSON errors (HttpError -> its status, KeyError -> 404,
    anything else -> 500) and ``_send`` writes a ``Response``, streaming
    ``file_path`` bodies (a ``file_range`` of them) from disk: through
    ``os.sendfile`` on the reactor, in bounded pieces elsewhere;
  - ``serve`` / ``stop_server``: by default the listener joins the
    process's event-loop reactor (utils/eventloop.py: non-blocking
    keep-alive and pipelined parsing, a bounded two-lane worker pool,
    listen backlog 512).  ``WEED_DATAPLANE=threaded`` selects
    ``FastHTTPServer`` (hand-parsed HTTP/1.1, a thread per connection,
    backlog 256).  A stop returns within a bounded time with the port free
    to bind again;
  - ``http_json``, ``http_bytes``, ``http_download``: client calls over a
    thread-local pool of keep-alive raw sockets, one per (thread, peer)
    (``_RawConn``, ``_pooled_request``).  A GET or HEAD that fails on a
    reused connection is sent once more on a fresh one; any other method
    first replaces an idle connection the peer has closed and is never
    resent once its bytes are out, and a timeout never, since a POST must
    not run twice;
  - cluster TLS (security/tls.py): ``serve(..., tls_context=...)`` listens
    with HTTPS on ``FastHTTPServer`` (the reactor has no handshake state
    machine, as in the reference), and ``set_client_tls`` installs the
    process's client context, which upgrades every ``http://`` URL the
    client calls are given to ``https://`` and verifies the peer
    (``_prep_url``);
  - ``parse_range``, ``extract_upload``, ``qint``: request parsing.

``Router.loop_fast_probe(method, path)``, when set, tells the reactor which
GET/HEAD requests may run inline on the loop (the volume server: needles
its needle cache holds); ``handler.queue_wait_s`` carries a pooled
request's wait for a worker.

Traces (``observability/``): with the process tracer enabled, ``dispatch``
makes the request's head sampling decision (``context.begin_request``:
adopt the caller's Traceparent, or decide afresh), stamps the thread with
the server's identity (``Router.server_url``), records the request span
``http.<router name>.<handler name>`` when sampled and answers with its
``X-Trace-Id``; the thread's context is restored afterwards, so a
worker's next request starts clean.  A disabled tracer costs one
attribute check.  Every client call under a sampled context records an
``rpc.client`` span and sends the Traceparent with it as the parent (the
edge the master's collector stitches on); under an unsampled decision it
sends the not-sampled header.

Deadlines (``utils/deadline.py``): ``dispatch`` adopts a request's
``X-Weed-Deadline`` for the handler's thread, answers 504 before the
handler runs when the budget is already spent (and when a handler raises
``DeadlineExceeded``), and restores the thread's previous deadline
afterwards.  Each 504 is counted on ``SeaweedFS_deadline_exceeded_total
{role}`` (the role is the router's name) and journaled as a
``deadline_exceeded`` event, at most one a second per router.  The client
calls clamp their timeout to the remaining budget, re-send the header with
what is left, and raise ``DeadlineExceeded`` without sending when it is
spent.  A ``Router`` given a server's metrics bundle counts each route's
requests, latency and 5xx answers, and a sampled request's trace id rides
on its latency observation as the bucket's exemplar.

Admission (``utils/admission.py``): a server started with
``max_inflight > 0`` sets ``Router.admission``; a request on a path that is
not exempt must take a slot before its handler runs, and one over the
bound is answered 503 with ``Retry-After: 1`` at once.  The slot is given
back after the response has been sent, whatever happened on the way.

Telemetry (``observability/``), after each response is sent: the request
log (reqlog.py: with the process's recorder on, one sampled access record
of the request, its query redacted first); heat (heat.py: with
``Router.heat`` set, ``note_http`` for each object route); the resource
ledger (ledger.py: with ``Router.ledger`` set, its stamp is taken on the
thread that runs the request before anything else, and ``settle_http``
charges its thread CPU, bytes and ``handler.queue_wait_s`` to its route
class and client).  Off, each costs one attribute check a request.

Not ported: the network fault points.
"""

from __future__ import annotations

import json
import os
import re
import socket
import ssl
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Callable, Optional

from ..observability import context as _trace_context
from ..observability import reqlog as _reqlog
from ..observability.tracer import NOOP_SPAN as _NOOP_SPAN
from ..observability.tracer import get_tracer as _get_tracer
from . import deadline as _deadline
from . import faultinject as _fi
from .deadline import DeadlineExceeded

# the process's request log (observability/reqlog.py): both chokepoints
# read its ``enabled`` once a request
_RECORDER = _reqlog.get_recorder()


class HttpError(Exception):
    def __init__(self, status: int, message: str = "",
                 headers: Optional[dict] = None):
        super().__init__(message or f"HTTP {status}")
        self.status = status
        self.message = message
        self.headers = headers or {}


def qint(query: dict, name: str, default: Optional[int] = None) -> int:
    """An int query parameter; garbage answers 400.  With no ``default``
    the parameter is required and its absence answers 400 too."""
    raw = query.get(name)
    if raw is None or raw == "":
        if default is None:
            raise HttpError(400, f"missing query parameter {name}")
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise HttpError(400, f"bad query parameter {name}={raw!r}: "
                             f"expected an integer")


def qfloat(query: dict, name: str,
           default: Optional[float] = None) -> float:
    """Float twin of qint: malformed or missing-required input answers
    400, never 500."""
    raw = query.get(name)
    if raw is None or raw == "":
        if default is None:
            raise HttpError(400, f"missing query parameter {name}")
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise HttpError(400, f"bad query parameter {name}={raw!r}: "
                             f"expected a number")


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, match: re.Match):
        self.handler = handler
        self.match = match
        parsed = urllib.parse.urlparse(handler.path)
        # %-escapes are decoded once here, like Go's r.URL.Path
        self.path = urllib.parse.unquote(parsed.path)
        self.query = {k: v[0] for k, v in urllib.parse.parse_qs(
            parsed.query, keep_blank_values=True).items()}
        self.headers = handler.headers
        self._body: Optional[bytes] = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            length = int(self.headers.get("Content-Length") or 0)
            self._body = self.handler.rfile.read(length) if length else b""
        return self._body

    def json(self) -> dict:
        return json.loads(self.body or b"{}")


def parse_form_data(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser for POST uploads: {field: str}
    plus {"file": bytes, "file.name": str} for the file part; fields after
    `file` are ignored."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    # RFC 2046 delimiters are CRLF--boundary, not the bare boundary bytes:
    # a file whose content holds the boundary string must survive
    sep = b"\r\n--" + m.group(1).encode()
    fields: dict = {}
    for part in (b"\r\n" + body).split(sep)[1:]:
        if part.startswith(b"--"):
            break  # closing delimiter
        part = part.lstrip(b" \t")  # transport padding after boundary
        if part.startswith(b"\r\n"):
            part = part[2:]
        head, hsep, payload = part.partition(b"\r\n\r\n")
        if not hsep and not head.strip():
            continue
        disp = ""
        ptype = ""
        for line in head.split(b"\r\n"):
            low = line.lower()
            if low.startswith(b"content-disposition:"):
                disp = line.decode(errors="replace")
            elif low.startswith(b"content-type:"):
                ptype = line.split(b":", 1)[1].strip().decode(errors="replace")
        nm = re.search(r'name="([^"]*)"', disp)
        name = nm.group(1) if nm else ""
        if name.lower() == "file":
            fn = re.search(r'filename="([^"]*)"', disp)
            fields["file"] = payload
            fields["file.name"] = fn.group(1) if fn else ""
            if ptype:
                fields.setdefault("content-type", ptype)
            break
        fields[name.lower()] = payload.decode(errors="replace")
    return fields


def extract_upload(body: bytes, content_type: str) -> tuple[bytes, str, str]:
    """-> (data, filename, mime) for a write-request body: unwraps one
    multipart/form-data file part as the reference's needle ParseUpload
    does (needle_parse_upload.go:37-76); raw bodies pass through with the
    request Content-Type as the mime."""
    if content_type and content_type.lower().startswith("multipart/form-data"):
        try:
            fields = parse_form_data(body, content_type)
        except ValueError as e:
            raise HttpError(400, str(e))
        if "file" in fields:
            # basename only (needle_parse_upload.go:141 path.Base)
            fname = fields.get("file.name", "")
            fname = fname.replace("\\", "/").rsplit("/", 1)[-1]
            return fields["file"], fname, fields.get("content-type", "")
    return body, "", content_type


class Response:
    def __init__(self, data=None, status: int = 200, raw: Optional[bytes] = None,
                 headers: Optional[dict] = None,
                 file_path: Optional[str] = None,
                 file_range: Optional[tuple[int, int]] = None):
        """A JSON body (``data``), raw bytes (``raw``), or a file on disk
        (``file_path``; ``file_range`` (offset, length) of it, or the
        whole file) streamed, never read whole."""
        self.data = data
        self.status = status
        self.raw = raw
        self.file_path = file_path
        self.file_range = file_range
        self.headers = headers or {}


_FILE_PIECE = 1 << 20
# how long a TLS listener waits for a peer's handshake
_HANDSHAKE_S = 10.0


class Router:
    """Method + regex route table; routes match in registration order."""

    def __init__(self, name: str = "httpd", metrics=None):
        """``metrics``: a server's bundle (stats/metrics.py
        ``_ServerMetrics``) counting each route's requests, latency and
        5xx answers, or None."""
        self.name = name
        self.metrics = metrics
        self.routes: list[tuple[str, re.Pattern, Callable]] = []
        # requests dispatched so far (a server's load gate reads it)
        self.requests = 0
        self._count_lock = threading.Lock()
        # the owning server's advertised host:port, stamped on the spans
        # of its requests (several servers may share one process tracer);
        # None: the request's Host header stands in
        self.server_url: Optional[str] = None
        # the server's AdmissionController (utils/admission.py), installed
        # by -maxInflight > 0; None costs one attribute check a request
        self.admission = None
        # probe(method, path) -> bool: may this GET/HEAD run inline on the
        # reactor's loop (utils/eventloop.py)?  The volume server answers
        # True only for needles its needle cache holds; None sends every
        # request to the worker pool
        self.loop_fast_probe = None
        # the volume server's HeatAccumulator (observability/heat.py): every
        # object route's answer feeds it; None costs one attribute check
        self.heat = None
        # the server's RequestLedger (observability/ledger.py): every
        # request settles its CPU, bytes and queue wait into it; None
        # costs one attribute check
        self.ledger = None
        # the deadline_exceeded event's rate limit (the counter counts
        # every 504); a lost race costs at most one extra event
        self._last_ddl_event = 0.0

    def _note_deadline_exceeded(self) -> None:
        """Count one budget-spent 504 and journal it, rate-limited."""
        from ..observability import events as _events
        from ..stats import request_plane_metrics

        request_plane_metrics().deadline_exceeded.inc(self.name)
        now = time.monotonic()
        if now - self._last_ddl_event >= 1.0:
            self._last_ddl_event = now
            _events.emit("deadline_exceeded", role=self.name)

    def route(self, method: str, pattern: str):
        compiled = re.compile("^" + pattern + "$")

        def deco(fn):
            self.routes.append((method, compiled, fn))
            if self.metrics is not None:
                # each route's series exist at 0 before its first request
                self.metrics.request_counter.labels(fn.__name__)
                self.metrics.request_histogram.labels(fn.__name__)
                self.metrics.request_errors.labels(fn.__name__)
            return fn

        return deco

    def dispatch(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        with self._count_lock:
            self.requests += 1
        if getattr(handler.server, "_stopping", False):
            # a stopped server's keep-alive connections outlive
            # server_close(): send their clients elsewhere
            handler.close_connection = True
            self._drain_body(handler)
            self._send(handler, Response({"error": "server shutting down"},
                                         status=503,
                                         headers={"Connection": "close"}))
            return
        path = urllib.parse.unquote(urllib.parse.urlparse(handler.path).path)
        # the ledger's stamp is taken on the thread that runs the request:
        # thread CPU clocks are per thread (the reactor's wait for a worker
        # rides apart, in handler.queue_wait_s)
        ledger = self.ledger
        ltok = ledger.begin() if ledger is not None else None
        # the trace context governs this request only, like the deadline
        # below: gated on tracer.enabled, so a dormant tracer costs one
        # attribute check
        tracer = _get_tracer()
        tctx = prev_ctx = prev_srv = None
        traced = False
        if tracer.enabled:
            tctx, prev_ctx = _trace_context.begin_request(handler.headers)
            traced = True
            prev_srv = _trace_context.swap_server(
                self.server_url or handler.headers.get("Host"))
        # the caller's budget governs this request only: the thread serves
        # its connection's next request too
        ddl, prev_ddl = _deadline.begin_request(handler.headers)
        try:
            for m, pattern, fn in self.routes:
                if m != method:
                    continue
                match = pattern.match(path)
                if not match:
                    continue
                self._run(handler, Request(handler, match), fn, ddl, tctx,
                          ltok)
                return
            self._drain_body(handler)
            self._send(handler, Response(
                {"error": f"no route {method} {path}"}, status=404))
        finally:
            _deadline.end_request(prev_ddl)
            if traced:
                _trace_context.end_request(prev_ctx)
                _trace_context.swap_server(prev_srv)

    def _run(self, handler: BaseHTTPRequestHandler, req: Request,
             fn: Callable, ddl, tctx=None, ltok=None) -> None:
        """``tctx``: a sampled request's trace context; the handler then
        runs inside its request span.  ``ltok``: the ledger's stamp."""
        t0 = time.perf_counter()
        admission = self.admission
        admitted = False
        shed = False
        try:
            try:
                if ddl is not None and ddl.expired():
                    # the caller has given up: answering now beats work
                    # nobody will read
                    self._note_deadline_exceeded()
                    resp = Response({"error": "deadline exceeded before "
                                              "dispatch"}, status=504)
                elif admission is not None \
                        and not admission.exempt(req.path) \
                        and not admission.try_acquire():
                    # over the inflight bound: a fast 503 in place of a
                    # late timeout (try_acquire counted and journaled it),
                    # and the connection closes
                    shed = True
                    handler.close_connection = True
                    resp = Response({"error": "overloaded: request shed"},
                                    status=503,
                                    headers={"Retry-After": "1",
                                             "Connection": "close"})
                else:
                    admitted = admission is not None \
                        and not admission.exempt(req.path)
                    if tctx is not None:
                        with _get_tracer().span(
                                f"http.{self.name}.{fn.__name__}",
                                method=req.handler.command, path=req.path):
                            resp = fn(req)
                    else:
                        resp = fn(req)
            except DeadlineExceeded as e:
                # the budget ran out inside the handler, at a downstream
                # call
                self._note_deadline_exceeded()
                resp = Response({"error": str(e) or "deadline exceeded"},
                                status=504)
            except HttpError as e:
                # a synthetic status 0 (unreachable peer) must not become
                # an invalid "HTTP/1.1 0" status line
                resp = Response({"error": e.message or str(e)},
                                status=e.status if e.status >= 100 else 502,
                                headers=e.headers or None)
            except LookupError as e:
                resp = Response({"error": str(e)}, status=404)
            except Exception as e:  # noqa: BLE001 - the server must not die
                resp = Response({"error": f"{type(e).__name__}: {e}"},
                                status=500)
            if self.metrics is not None:
                self.metrics.request_counter.inc(fn.__name__)
                if resp.status >= 500:
                    self.metrics.request_errors.inc(fn.__name__)
                # a sampled request's trace id is its bucket's exemplar
                self.metrics.request_histogram.observe(
                    fn.__name__, time.perf_counter() - t0,
                    exemplar=tctx.trace_id if tctx is not None else None)
            if tctx is not None:
                # the caller can fetch the stitched trace by this id
                resp.headers.setdefault("X-Trace-Id", tctx.trace_id)
            if req._body is None:
                # answering mid-upload would reset the connection and lose
                # the status (a shed request's too: this server has no
                # drain before its close); an unread body must not be
                # parsed as the next request either
                self._drain_body(handler)
            self._send(handler, resp)
            self._account(handler, req, fn.__name__, resp, shed, ddl, t0,
                          tctx, ltok)
        finally:
            # the slot goes back only once the response has left: for a
            # body streamed from disk the send is the work
            if admitted:
                admission.release()

    def _account(self, handler: BaseHTTPRequestHandler, req: Request,
                 handler_name: str, resp: Response, shed: bool, ddl,
                 t0: float, tctx, ltok) -> None:
        """The request log, heat and the ledger, after the send (a
        streamed body's send is the work, and an inline request's stall
        is its whole hold of the loop).  Never raises into serving."""
        method = handler.command
        if _RECORDER.enabled:
            self._record_access(handler, method, handler_name, req, resp,
                                shed, ddl, t0)
        heat = self.heat
        if heat is not None:
            # note_http's fid regex turns control routes away before any
            # lock
            try:
                heat.note_http(method, req.path, resp.status,
                               self._resp_bytes(resp),
                               tctx.trace_id if tctx is not None else "")
            except Exception:  # noqa: BLE001 - accounting never breaks serving
                pass
        ledger = self.ledger
        if ledger is not None and ltok is not None:
            try:
                ledger.settle_http(
                    ltok, method, req.path, handler_name, resp.status,
                    len(req._body or b""), self._resp_bytes(resp),
                    handler.client_address[0] if handler.client_address
                    else "",
                    tctx.trace_id if tctx is not None else "",
                    getattr(handler, "queue_wait_s", 0.0), query=req.query)
            except Exception:  # noqa: BLE001 - accounting never breaks serving
                pass

    @staticmethod
    def _resp_bytes(resp: Response) -> int:
        """The bytes out, from attributes alone (no syscall): a streamed
        whole file reads 0, so byte rates are a floor."""
        if resp.raw is not None:
            return len(resp.raw)
        if resp.file_range is not None:
            _off, length = resp.file_range
            return length if length >= 0 else 0
        if resp.data is not None:
            return len(str(resp.data))
        return 0

    @staticmethod
    def _record_access(handler, method: str, handler_name: str,
                       req: Request, resp: Response, shed: bool,
                       ddl, t0: float) -> None:
        """One sampled access record (observability/reqlog.py); the
        costly parts (redaction, bytes) only past the recorder's gate."""
        try:
            if resp.raw is not None:
                out = len(resp.raw)
            elif resp.file_path is not None:
                _off, length = resp.file_range or (0, -1)
                out = length if length >= 0 else \
                    os.path.getsize(resp.file_path)
            elif resp.data is not None:
                # an estimate that does not encode the body again
                out = len(str(resp.data))
            else:
                out = 0
            try:
                bytes_in = int(handler.headers.get("Content-Length") or 0)
            except (TypeError, ValueError):
                bytes_in = 0
            peer = ""
            addr = getattr(handler, "client_address", None)
            if addr:
                peer = str(addr[0])
            path = _reqlog.redact_query(handler.path)
            dur_s = time.perf_counter() - t0
            # the budget the caller sent, not what was left after
            _RECORDER.record(
                _reqlog.classify_route(method, req.path, handler_name,
                                       query=req.query),
                method, path, resp.status,
                bytes_in=bytes_in, bytes_out=out,
                duration_ms=dur_s * 1e3,
                deadline_s=(ddl.remaining() + dur_s
                            if ddl is not None else None),
                shed=shed, degraded=resp.status >= 500, peer=peer,
                handler=handler_name)
        except Exception:  # noqa: BLE001 - recording never breaks serving
            pass

    @staticmethod
    def _drain_body(handler: BaseHTTPRequestHandler) -> None:
        te = (handler.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            # Request.body frames by Content-Length only
            handler.close_connection = True
            return
        try:
            left = int(handler.headers.get("Content-Length") or 0)
            while left > 0:
                n = len(handler.rfile.read(min(left, 1 << 16)) or b"")
                if n == 0:
                    break
                left -= n
        except (OSError, ValueError):
            handler.close_connection = True

    @staticmethod
    def _send(handler: BaseHTTPRequestHandler, resp: Response) -> None:
        try:
            headers = dict(resp.headers)
            if resp.file_path is not None:
                size = os.path.getsize(resp.file_path)
                off, length = resp.file_range or (0, size)
                length = max(0, min(length, size - off))
                ctype = headers.pop("Content-Type", "application/octet-stream")
                body = None
            elif resp.raw is not None:
                body = resp.raw
                length = len(body)
                ctype = headers.pop("Content-Type", "application/octet-stream")
            else:
                body = json.dumps(resp.data if resp.data is not None
                                  else {}).encode()
                length = len(body)
                ctype = "application/json"
            handler.send_response(resp.status)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Content-Length", str(length))
            for k, v in headers.items():
                handler.send_header(k, v)
            handler.end_headers()
            if handler.command == "HEAD":
                return
            if body is not None:
                handler.wfile.write(body)
                return
            # a reactor connection streams the region with os.sendfile: a
            # slow client costs an outbox entry, not a thread
            sendfile = getattr(handler, "sendfile", None)
            if sendfile is not None and sendfile(resp.file_path, off,
                                                 length):
                return
            with open(resp.file_path, "rb") as f:
                f.seek(off)
                left = length
                while left > 0:
                    piece = f.read(min(left, _FILE_PIECE))
                    if not piece:
                        break
                    handler.wfile.write(piece)
                    left -= len(piece)
        except (BrokenPipeError, ConnectionResetError):
            pass


# --- servers ----------------------------------------------------------------


class CIHeaders:
    """Case-insensitive request headers: ``get``, ``[]`` and ``in`` by any
    case (the first value wins, as email.Message's ``get``)."""

    __slots__ = ("_lower",)

    def __init__(self, pairs: list):
        self._lower = {}
        for k, v in pairs:
            self._lower.setdefault(k.lower(), v)

    def get(self, key: str, default=None):
        return self._lower.get(key.lower(), default)

    def __getitem__(self, key: str):
        return self._lower[key.lower()]

    def __contains__(self, key) -> bool:
        return key.lower() in self._lower


_date_cache: tuple[int, str] = (0, "")


def _http_date() -> str:
    """The RFC 7231 Date, formatted once a second."""
    global _date_cache
    now = int(time.time())
    if _date_cache[0] != now:
        _date_cache = (now, time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                          time.gmtime(now)))
    return _date_cache[1]


_REASONS = {200: "OK", 201: "Created", 204: "No Content",
            206: "Partial Content", 301: "Moved Permanently", 302: "Found",
            303: "See Other", 304: "Not Modified", 307: "Temporary Redirect",
            400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
            412: "Precondition Failed", 416: "Range Not Satisfiable",
            500: "Internal Server Error", 503: "Service Unavailable"}


class _FastHandler:
    """One connection's handler on ``FastHTTPServer``: the
    BaseHTTPRequestHandler surface ``Router`` uses."""

    __slots__ = ("server", "rfile", "wfile", "client_address", "command",
                 "path", "headers", "close_connection", "_out")

    def __init__(self, server, rfile, wfile, client_address):
        self.server = server
        self.rfile = rfile
        self.wfile = wfile
        self.client_address = client_address
        self.command = ""
        self.path = ""
        self.headers: Optional[CIHeaders] = None
        self.close_connection = True
        self._out: list = []

    def send_response(self, status: int, message: str = "") -> None:
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
        self.wfile.write(b"".join(self._out))
        self._out = []


class _SockWriter:
    """Unbuffered writer over a socket: each write is one sendall."""

    __slots__ = ("_sock",)

    def __init__(self, sock):
        self._sock = sock

    def write(self, data) -> int:
        self._sock.sendall(data)
        return len(data)

    def flush(self) -> None:
        pass


class FastHTTPServer:
    """The threaded fallback: an accept loop and a thread per keep-alive
    connection, the request line and headers parsed by hand and the
    status line and headers sent in one write."""

    # the reference's threaded server's listen backlog: the stdlib's 5
    # drops the SYNs of a burst of reconnects (every shed closes its
    # connection), and each such client waits a second to retry
    request_queue_size = 256

    def __init__(self, addr, router: Router, tls_context=None):
        self.router = router
        # each connection's handshake runs on its own thread, never the
        # accept loop's
        self.tls_context = tls_context
        self._stopping = False
        self._done = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind(addr)
            self._sock.listen(self.request_queue_size)
        except OSError:
            self._sock.close()
            raise
        self.server_address = self._sock.getsockname()

    def serve_forever(self) -> None:
        import selectors

        # select with a short timeout, not a blocking accept: closing a
        # socket does not wake a thread blocked in accept(), which would
        # keep the port bound after a stop
        sel = selectors.DefaultSelector()
        sel.register(self._sock, selectors.EVENT_READ)
        try:
            while not self._stopping:
                if not sel.select(timeout=0.25):
                    continue
                try:
                    conn, peer = self._sock.accept()
                except OSError:
                    break  # the listener closed
                threading.Thread(target=self._handle, args=(conn, peer),
                                 daemon=True).start()
        finally:
            sel.close()
            try:
                self._sock.close()
            except OSError:
                pass
            self._done.set()

    def _handle(self, conn, peer) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.tls_context is not None:
                # a peer without the certificate mTLS asks for fails here
                conn.settimeout(_HANDSHAKE_S)
                conn = self.tls_context.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            rfile = conn.makefile("rb", buffering=1 << 16)
            h = _FastHandler(self, rfile, _SockWriter(conn), peer)
            # no stop check between requests: a stop that lands just after
            # an answer would close the connection unanswered, where the
            # router answers its next request 503 with Connection: close
            while True:
                line = rfile.readline(1 << 16)
                if not line or line in (b"\r\n", b"\n"):
                    break
                if not line.endswith(b"\n"):
                    # a 64 KiB+ request line would be parsed as two
                    conn.sendall(b"HTTP/1.1 414 URI Too Long\r\n"
                                 b"Content-Length: 0\r\n"
                                 b"Connection: close\r\n\r\n")
                    break
                try:
                    method, _, rest = line.rstrip(b"\r\n").partition(b" ")
                    target, _, version = rest.rpartition(b" ")
                    h.command = method.decode("ascii")
                    h.path = target.decode("iso-8859-1")
                except (UnicodeDecodeError, ValueError):
                    break
                pairs = []
                overflow = False
                while True:
                    hl = rfile.readline(1 << 16)
                    if hl in (b"\r\n", b"\n", b""):
                        break
                    if len(pairs) >= 100 or not hl.endswith(b"\n"):
                        overflow = True  # unbounded headers
                        break
                    k, _, v = hl.partition(b":")
                    pairs.append((k.decode("iso-8859-1"),
                                  v.strip().decode("iso-8859-1")))
                if overflow:
                    conn.sendall(b"HTTP/1.1 431 Request Header Fields Too "
                                 b"Large\r\nContent-Length: 0\r\n"
                                 b"Connection: close\r\n\r\n")
                    break
                h.headers = CIHeaders(pairs)
                if "chunked" in (h.headers.get("Transfer-Encoding")
                                 or "").lower():
                    # Request.body frames Content-Length bodies only
                    conn.sendall(b"HTTP/1.1 501 Not Implemented\r\n"
                                 b"Content-Length: 0\r\n"
                                 b"Connection: close\r\n\r\n")
                    break
                conn_hdr = (h.headers.get("Connection") or "").lower()
                h.close_connection = (
                    conn_hdr == "close"
                    or (version == b"HTTP/1.0" and conn_hdr != "keep-alive"))
                if (h.headers.get("Expect") or "").lower() == "100-continue":
                    conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
                self.router.dispatch(h, h.command)
                if h.close_connection:
                    break
        except (OSError, ValueError):
            pass
        finally:
            # half-close and drain briefly before the close: unread bytes
            # in the receive queue turn the close into an RST, which can
            # destroy an error answer already sent
            try:
                conn.shutdown(socket.SHUT_WR)
                conn.settimeout(0.5)
                deadline = time.monotonic() + 2.0
                drained = 0
                while time.monotonic() < deadline and drained < (1 << 22):
                    piece = conn.recv(1 << 16)
                    if not piece:
                        break
                    drained += len(piece)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def shutdown(self) -> None:
        """Stop accepting and release the port before returning."""
        self._stopping = True
        self._done.wait(timeout=5.0)

    def server_close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def serve(router: Router, host: str, port: int, tls_context=None):
    """Start serving ``router`` on host:port: on the process's reactor by
    default; ``WEED_DATAPLANE=threaded`` gives ``FastHTTPServer``.  With
    ``tls_context`` (security/tls.py ``server_context``) the listener
    speaks HTTPS, and mTLS when the context asks for client certificates;
    it stays on ``FastHTTPServer``."""
    from . import eventloop

    if tls_context is None and eventloop.reactor_enabled():
        return eventloop.ReactorHTTPServer((host, port), router)
    server = FastHTTPServer((host, port), router, tls_context)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"{router.name}:{server.server_address[1]}").start()
    return server


def stop_server(server) -> None:
    """Stop accepting and release the listening port, within a bounded
    time.  The reactor aborts the server's open connections; on the
    threaded server a kept-alive connection's next request answers 503
    with Connection: close.  Either way a pooled client moves on to
    whoever binds the port next."""
    server._stopping = True
    server.shutdown()
    server.server_close()


# --- cluster TLS ----------------------------------------------------------------
# One switch for the process (security.toml [tls]): with a client context
# installed, every http:// URL a client call is given is upgraded to
# https:// and the peer verified (with this node's certificate: mTLS).
_client_tls = None


def set_client_tls(context) -> None:
    """Install (or clear, with None) the process's client SSL context."""
    global _client_tls
    _client_tls = context


def _prep_url(url: str):
    """-> (url, ssl context): the scheme upgraded when TLS is on."""
    if _client_tls is not None and url.startswith("http://"):
        return "https://" + url[len("http://"):], _client_tls
    return url, (_client_tls if url.startswith("https://") else None)


# --- the pooled client --------------------------------------------------------
# One keep-alive TCP_NODELAY connection per (thread, peer): a new TCP
# connection per call costs a handshake and, with the control plane's small
# segments, Nagle / delayed-ACK stalls.  The exchange is hand-rolled
# HTTP/1.1 over the socket rather than http.client, whose header parse
# goes through email.parser.


class _RawConn:
    """One keep-alive HTTP/1.1 connection: request bytes built by hand,
    status, headers and body parsed by hand (Content-Length, chunked, or
    read to close).  ``sent`` says whether the last request's bytes all
    went out."""

    __slots__ = ("sock", "rfile", "host", "sent", "tls")

    def __init__(self, scheme: str, netloc: str, timeout: Optional[float],
                 ssl_ctx=None):
        host, _, port_s = netloc.partition(":")
        self.host = netloc
        self.tls = scheme == "https"
        sock = socket.create_connection(
            (host, int(port_s or (443 if self.tls else 80))),
            timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.tls:
            try:
                sock = (ssl_ctx or ssl.create_default_context()).wrap_socket(
                    sock, server_hostname=host)
            except BaseException:
                sock.close()
                raise
        self.sock = sock
        self.rfile = sock.makefile("rb", buffering=1 << 16)
        self.sent = False

    def stale(self) -> bool:
        """True when this idle connection can carry no request: the peer
        has closed or reset it, or sent bytes nobody asked for."""
        try:
            self.sock.setblocking(False)
            if self.tls:
                # a TLS socket takes no recv flags; a record that carries
                # no data (a session ticket) is read and the call wants
                # more, and unrequested data dooms the connection anyway
                self.sock.recv(1)
            else:
                self.sock.recv(1, socket.MSG_PEEK)
            return True  # b"" (closed) or unrequested bytes
        except (BlockingIOError, ssl.SSLWantReadError):
            return False
        except OSError:
            return True

    def request(self, method: str, target: str, body: Optional[bytes],
                headers: dict, sink=None) -> tuple[int, bytes, dict, bool]:
        """-> (status, body, headers, will_close).  ``sink(status)``, when
        given, returns a file to stream the body into (the body returned
        is then empty) or None to read it into memory."""
        out = [f"{method} {target} HTTP/1.1\r\nHost: {self.host}\r\n"
               .encode("latin-1")]
        has_len = False
        for k, v in headers.items():
            lk = k.lower()
            if lk == "host":
                continue  # already sent
            if lk == "content-length":
                has_len = True
            out.append(f"{k}: {v}\r\n".encode("latin-1"))
        if body is not None and not has_len:
            out.append(b"Content-Length: %d\r\n" % len(body))
        elif body is None and method in ("POST", "PUT") and not has_len:
            out.append(b"Content-Length: 0\r\n")
        out.append(b"\r\n")
        if body:
            out.append(body)
        self.sent = False
        self.sock.sendall(b"".join(out))
        self.sent = True
        while True:  # interim 1xx answers are skipped
            line = self.rfile.readline(1 << 16)
            if not line:
                raise ConnectionError("connection closed by peer")
            parts = line.split(None, 2)
            if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
                raise ConnectionError(f"bad status line {line!r}")
            status = int(parts[1])
            version = parts[0]
            hdrs: dict = {}
            while True:
                hl = self.rfile.readline(1 << 16)
                if hl in (b"\r\n", b"\n", b""):
                    break
                k, _, v = hl.partition(b":")
                hdrs[k.decode("latin-1")] = v.strip().decode("latin-1")
            if status >= 200:
                break
        lower = {k.lower(): v for k, v in hdrs.items()}
        conn_hdr = lower.get("connection", "").lower()
        will_close = (conn_hdr == "close"
                      or (version == b"HTTP/1.0"
                          and conn_hdr != "keep-alive"))
        if method == "HEAD" or status in (204, 304):
            return status, b"", hdrs, will_close
        dest = sink(status) if sink is not None else None
        if lower.get("transfer-encoding", "").lower() == "chunked":
            pieces = []
            while True:
                szline = self.rfile.readline(1 << 16)
                try:
                    n = int(szline.split(b";")[0].strip() or b"0", 16)
                except ValueError:
                    raise ConnectionError(f"bad chunk size {szline!r}")
                if n == 0:
                    while self.rfile.readline(1 << 16) not in (b"\r\n", b"\n",
                                                               b""):
                        pass  # trailers
                    break
                piece = self._read_exact(n)
                if dest is not None:
                    dest.write(piece)
                else:
                    pieces.append(piece)
                self.rfile.read(2)  # CRLF
            return status, b"".join(pieces), hdrs, will_close
        if "content-length" in lower:
            n = int(lower["content-length"])
            if dest is None:
                return status, self._read_exact(n), hdrs, will_close
            while n > 0:
                piece = self._read_exact(min(n, _FILE_PIECE))
                dest.write(piece)
                n -= len(piece)
            return status, b"", hdrs, will_close
        # no framing: the body runs to the connection's close
        if dest is None:
            return status, self.rfile.read() or b"", hdrs, True
        while True:
            piece = self.rfile.read(_FILE_PIECE)
            if not piece:
                break
            dest.write(piece)
        return status, b"", hdrs, True

    def _read_exact(self, n: int) -> bytes:
        data = self.rfile.read(n)
        if data is None or len(data) != n:
            raise ConnectionError("short body read")
        return data

    def settimeout(self, t: Optional[float]) -> None:
        self.sock.settimeout(t)

    def close(self) -> None:
        try:
            self.rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _ConnPool(threading.local):
    def __init__(self):
        self.conns: dict = {}


_pool = _ConnPool()
# a request of these methods may run twice: a failed one is resent
_RESENDABLE = ("GET", "HEAD")


def _egress_span(method: str, parsed, **attrs):
    """The trace egress of every client call: an ``rpc.client`` span when
    this thread holds a sampled trace context and the tracer is enabled
    (its id becomes the callee's parent, so the Traceparent is injected
    inside it), else the shared no-op.  -> (span, ctx); ctx None means
    the thread has no decision at all and nothing is injected."""
    ctx = _trace_context.current()
    if ctx is None:
        return _NOOP_SPAN, None
    tracer = _get_tracer()
    if tracer.enabled and _trace_context.current_sampled() is not None:
        return tracer.span("rpc.client", method=method, peer=parsed.netloc,
                           path=parsed.path, **attrs), ctx
    return _NOOP_SPAN, ctx


def net_faults(netloc: str) -> None:
    """The peer-scoped network faults of the scenario engine's wire, hit
    by every egress (this module's pooled client and http_download, the
    framed client): a partition or a drop fails the send at once
    (OSError); a delay is slept deadline-aware, so a slow wire stalls the
    request but never the caller past its budget."""
    _fi.hit_peer("net.partition", netloc)
    _fi.hit_peer("net.drop", netloc)
    delay = _fi.peer_delay("net.delay", netloc)
    if delay:
        _deadline.sleep_within(delay)


def _pooled_request(method: str, url: str, body: Optional[bytes],
                    headers: Optional[dict], timeout: Optional[float],
                    sink=None, **span_attrs) -> tuple[int, bytes, dict]:
    """One exchange over this thread's pooled connection to the peer;
    raises OSError (ConnectionError, TimeoutError) when it fails, and
    DeadlineExceeded when the thread's deadline is spent before the send
    or cuts the wait.  A request that may not run twice (any method but
    GET and HEAD) first replaces a pooled connection the peer closed while
    it idled; GET and HEAD skip that check, a syscall on every call, and
    lean on the resend.  A failure on a reused connection sends the
    request once more on a fresh one when the peer cannot have run it
    (the send itself failed) or running it twice is harmless (GET, HEAD).
    Anything else propagates: a timeout, a new connection's failure, and
    a failure after another method's request went out, since the peer may
    be running it and a POST must not run twice."""
    url, ssl_ctx = _prep_url(url)
    parsed = urllib.parse.urlsplit(url)
    if parsed.scheme not in ("http", "https"):
        raise ValueError(f"unsupported URL scheme in {url!r}")
    key = (parsed.scheme, parsed.netloc)
    target = (parsed.path or "/") + (f"?{parsed.query}" if parsed.query
                                     else "")
    if _fi._points and sink is None:  # http_download hits its own
        _fi.hit("net.request")
        net_faults(parsed.netloc)
    # the budget left; a spent one raises before anything is sent
    timeout = _deadline.clamp(timeout)
    span, ctx = _egress_span(method, parsed, **span_attrs)
    headers = dict(headers or {})
    with span:
        if ctx is not None:
            _trace_context.inject_trace_headers(headers)
        _deadline.inject_deadline_headers(headers)
        for _ in range(2):
            conn = _pool.conns.get(key)
            if conn is not None and method not in _RESENDABLE \
                    and conn.stale():
                conn.close()
                conn = None
            reused = conn is not None
            if conn is None:
                conn = _RawConn(parsed.scheme, parsed.netloc, timeout,
                                ssl_ctx)
                _pool.conns[key] = conn
            try:
                conn.settimeout(timeout)
                status, data, hdrs, will_close = conn.request(
                    method, target, body, headers, sink)
                if will_close:
                    conn.close()
                    _pool.conns.pop(key, None)
                return status, data, hdrs
            except TimeoutError:
                conn.close()
                _pool.conns.pop(key, None)
                ddl = _deadline.current()
                if ddl is not None and ddl.expired():
                    # the deadline, not the peer, bound the wait
                    raise DeadlineExceeded(
                        f"deadline exceeded awaiting {url}") from None
                raise
            except Exception:
                conn.close()
                _pool.conns.pop(key, None)
                if not reused or (conn.sent and method not in _RESENDABLE):
                    raise
    raise OSError("unreachable")  # pragma: no cover


def _pooled_with_redirects(method: str, url: str, body: Optional[bytes],
                           headers: Optional[dict], timeout: Optional[float],
                           follow_redirects: bool) -> tuple[int, bytes, dict]:
    """``_pooled_request``, following up to 5 redirects."""
    for _ in range(5):
        status, data, hdrs = _pooled_request(method, url, body, headers,
                                             timeout)
        if follow_redirects and status in (301, 302, 303, 307, 308) \
                and hdrs.get("Location"):
            url = urllib.parse.urljoin(url, hdrs["Location"])
            if status == 303:
                method, body = "GET", None
            continue
        return status, data, hdrs
    return status, data, hdrs


def http_json(method: str, url: str, payload: Optional[dict] = None,
              timeout: Optional[float] = 30.0) -> dict:
    """A JSON call; a ``timeout`` of None waits without end.  A status
    >= 400 raises HttpError with the peer's error message; an unreachable
    peer raises HttpError(503); a spent deadline raises DeadlineExceeded."""
    data = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"} if data is not None else {}
    try:
        status, body, _ = _pooled_with_redirects(method, url, data, headers,
                                                 timeout, True)
    except (OSError, ValueError) as e:
        raise HttpError(503, f"{url} unreachable: {e}") from None
    if status >= 400:
        try:
            err = json.loads(body).get("error", body.decode(errors="replace"))
        except (ValueError, AttributeError):
            err = body.decode(errors="replace")
        raise HttpError(status, err) from None
    return json.loads(body) if body else {}


def http_json_retry(method: str, url: str, payload: Optional[dict] = None,
                    timeout: float = 30.0, attempts: int = 3,
                    budget_kind: str = "http") -> dict:
    """http_json with up to ``attempts`` tries of an idempotent GET or
    HEAD while the peer is unreachable or answers 503.  Each retry (never
    the first try) takes a token of the peer's retry budget
    (utils/backoff.py): a drained bucket ends the tries there, and never
    past an active deadline.  Any other answer is the peer's, and raises
    at once."""
    from .backoff import jittered_backoff, retry_allowed

    dest = urllib.parse.urlsplit(url).netloc
    retriable = method.upper() in ("GET", "HEAD")
    last: Optional[HttpError] = None
    for i in range(max(1, int(attempts))):
        if i:
            if not retriable or not retry_allowed(dest, budget_kind):
                break
            _deadline.sleep_within(jittered_backoff(0.05, 1.0, i - 1))
        try:
            return http_json(method, url, payload, timeout=timeout)
        except HttpError as e:
            last = e
            if e.status != 503:
                raise
    raise last  # type: ignore[misc]


def http_bytes(method: str, url: str, payload: Optional[bytes] = None,
               headers: Optional[dict] = None, timeout: float = 60.0,
               follow_redirects: bool = True) -> tuple[int, bytes, dict]:
    """-> (status, body, headers); an unreachable peer gives status 0."""
    try:
        return _pooled_with_redirects(method, url, payload, headers, timeout,
                                      follow_redirects)
    except (OSError, ValueError) as e:
        return 0, str(e).encode(), {}


def http_download(method: str, url: str, dest_path: str,
                  timeout: float = 3600.0) -> int:
    """Stream a response body to ``dest_path`` in bounded pieces, through
    ``dest_path.part`` renamed on success, so a dropped transfer never
    leaves a torn file under the final name.  Returns the HTTP status
    (0 when the peer cannot be reached); only a 200 writes the file.  The
    pooled connection carries it; ``timeout`` bounds each wait for bytes,
    clamped to the thread's deadline.  An armed net.* fault raises
    OSError before anything is sent, as the reference's."""
    if _fi._points:
        net_faults(urllib.parse.urlsplit(_prep_url(url)[0]).netloc)
    tmp = dest_path + ".part"
    files: list = []

    def sink(status: int):
        if status != 200:
            return None
        for f in files:  # a resend on a fresh connection starts over
            f.close()
        files.append(open(tmp, "wb"))
        return files[-1]

    try:
        status, _, _ = _pooled_request(method, url, None, None, timeout,
                                       sink, download=True)
        if status == 200:
            files[-1].close()
            os.replace(tmp, dest_path)
        return status
    except (OSError, ValueError):
        return 0
    finally:
        for f in files:
            f.close()
        if os.path.exists(tmp):
            os.remove(tmp)

UNSATISFIABLE_RANGE = (-1, 0)


def parse_range(range_header: str, file_size: int) -> Optional[tuple[int, int]]:
    """Parse an RFC 7233 single range against file_size -> (offset, size);
    None for absent/invalid headers (serve the whole body), or
    UNSATISFIABLE_RANGE when the range starts past EOF (serve 416).
    Handles bytes=N-, bytes=N-M, bytes=-N."""
    if not range_header.startswith("bytes="):
        return None
    lo, dash, hi = range_header[6:].partition("-")
    if not dash:
        return None
    try:
        if lo == "":  # suffix range: last N bytes
            n = int(hi)
            if n == 0 or file_size == 0:
                # RFC 7233: a zero-length suffix (or any suffix of an empty
                # file) has no satisfiable byte range
                return UNSATISFIABLE_RANGE
            offset = max(0, file_size - n)
            return offset, file_size - offset
        offset = int(lo)
        if offset >= file_size:
            return UNSATISFIABLE_RANGE
        if hi == "":
            return offset, file_size - offset
        end = min(int(hi), file_size - 1)
        return offset, end - offset + 1
    except ValueError:
        return None
