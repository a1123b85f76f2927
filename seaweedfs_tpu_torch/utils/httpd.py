"""HTTP server framework and client calls for the port's servers.

The subset of seaweedfs_tpu/utils/httpd.py that a volume server needs:

  - ``Router``: method + regex routes; ``dispatch`` maps a handler's
    exceptions to JSON errors (HttpError -> its status, KeyError -> 404,
    anything else -> 500) and ``_send`` writes a ``Response``, streaming
    ``file_path`` bodies from disk in bounded pieces;
  - ``serve`` / ``stop_server``: a thread-per-connection
    ``ThreadingHTTPServer`` speaking HTTP/1.1 keep-alive with Nagle off
    and the reference's listen backlog of 256;
  - ``http_json``, ``http_bytes``, ``http_download``: client calls on
    ``http.client``, one connection per call;
  - ``parse_range``, ``extract_upload``, ``qint``: request parsing.

Traces (``observability/``): with the process tracer enabled, ``dispatch``
makes the request's head sampling decision (``context.begin_request``:
adopt the caller's Traceparent, or decide afresh), stamps the thread with
the server's identity (``Router.server_url``), records the request span
``http.<router name>.<handler name>`` when sampled and answers with its
``X-Trace-Id``; the thread's context is restored afterwards, so a
connection's next request starts clean.  A disabled tracer costs one
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

Not ported: heat and ledger accounting, the request log, TLS, the
event-loop reactor and the pooled raw-socket client.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..observability import context as _trace_context
from ..observability.tracer import NOOP_SPAN as _NOOP_SPAN
from ..observability.tracer import get_tracer as _get_tracer
from . import deadline as _deadline
from .deadline import DeadlineExceeded


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
                 file_path: Optional[str] = None):
        """A JSON body (``data``), raw bytes (``raw``), or a file on disk
        (``file_path``) sent in bounded pieces, never read whole."""
        self.data = data
        self.status = status
        self.raw = raw
        self.file_path = file_path
        self.headers = headers or {}


_FILE_PIECE = 1 << 20


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
                self._run(handler, Request(handler, match), fn, ddl, tctx)
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
             fn: Callable, ddl, tctx=None) -> None:
        """``tctx``: a sampled request's trace context; the handler then
        runs inside its request span."""
        t0 = time.perf_counter()
        admission = self.admission
        admitted = False
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
        finally:
            # the slot goes back only once the response has left: for a
            # body streamed from disk the send is the work
            if admitted:
                admission.release()

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
                length = os.path.getsize(resp.file_path)
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
            with open(resp.file_path, "rb") as f:
                left = length
                while left > 0:
                    piece = f.read(min(left, _FILE_PIECE))
                    if not piece:
                        break
                    handler.wfile.write(piece)
                    left -= len(piece)
        except (BrokenPipeError, ConnectionResetError):
            pass


class _Server(ThreadingHTTPServer):
    # the listen backlog of the reference's threaded server; the stdlib's
    # 5 drops the SYNs of a burst of new connections (clients reconnecting
    # after a shed's Connection: close), and each waits a second to retry
    request_queue_size = 256


def serve(router: Router, host: str, port: int) -> ThreadingHTTPServer:
    """Start serving ``router`` on host:port in a thread; each connection
    gets its own thread."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body go out as separate writes: with Nagle on, the
        # client's delayed ACK stalls every keep-alive exchange ~40 ms
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            router.dispatch(self, "GET")

        def do_HEAD(self):
            router.dispatch(self, "HEAD")

        def do_POST(self):
            router.dispatch(self, "POST")

        def do_PUT(self):
            router.dispatch(self, "PUT")

        def do_DELETE(self):
            router.dispatch(self, "DELETE")

    server = _Server((host, port), Handler)
    server.daemon_threads = True
    # a short poll lets stop_server return within 0.1 s
    threading.Thread(target=server.serve_forever, args=(0.1,), daemon=True,
                     name=f"{router.name}:{port}").start()
    return server


def stop_server(server: ThreadingHTTPServer) -> None:
    """Stop accepting and close the listening socket; connections still
    open answer 503 with Connection: close."""
    server._stopping = True
    server.shutdown()
    server.server_close()


# --- client calls -----------------------------------------------------------

def _connect(url: str, timeout: Optional[float]
             ) -> tuple[http.client.HTTPConnection, str]:
    parsed = urllib.parse.urlsplit(url)
    if parsed.scheme != "http":
        raise ValueError(f"unsupported URL scheme in {url!r}")
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port or 80,
                                      timeout=timeout)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    target = (parsed.path or "/") + (f"?{parsed.query}" if parsed.query
                                     else "")
    return conn, target


def _egress_span(method: str, url: str, **attrs):
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
        parsed = urllib.parse.urlsplit(url)
        return tracer.span("rpc.client", method=method, peer=parsed.netloc,
                           path=parsed.path, **attrs), ctx
    return _NOOP_SPAN, ctx


def _request(method: str, url: str, body: Optional[bytes],
             headers: Optional[dict], timeout: Optional[float],
             follow_redirects: bool) -> tuple[int, bytes, dict]:
    """One exchange, following up to 5 redirects; raises OSError (or
    http.client.HTTPException) when the peer cannot be reached, and
    DeadlineExceeded when the thread's deadline is spent before the send
    or cuts the wait for the answer."""
    span, ctx = _egress_span(method, url)
    with span:
        if ctx is not None:
            headers = _trace_context.inject_trace_headers(
                dict(headers or {}))
        return _request_hops(method, url, body, headers, timeout,
                             follow_redirects)


def _request_hops(method: str, url: str, body: Optional[bytes],
                  headers: Optional[dict], timeout: Optional[float],
                  follow_redirects: bool) -> tuple[int, bytes, dict]:
    for _ in range(5):
        # the budget left, re-read at every hop
        call_timeout = _deadline.clamp(timeout)
        hdrs = _deadline.inject_deadline_headers(dict(headers or {}))
        if body is None and method in ("POST", "PUT"):
            hdrs.setdefault("Content-Length", "0")
        try:
            conn, target = _connect(url, call_timeout)
            try:
                conn.request(method, target, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                rhdrs = dict(resp.getheaders())
            finally:
                conn.close()
        except TimeoutError:
            ddl = _deadline.current()
            if ddl is not None and ddl.expired():
                # the deadline, not the peer, bound the wait
                raise DeadlineExceeded(
                    f"deadline exceeded awaiting {url}") from None
            raise
        if follow_redirects and resp.status in (301, 302, 303, 307, 308) \
                and rhdrs.get("Location"):
            url = urllib.parse.urljoin(url, rhdrs["Location"])
            if resp.status == 303:
                method, body = "GET", None
            continue
        return resp.status, data, rhdrs
    return resp.status, data, rhdrs


def http_json(method: str, url: str, payload: Optional[dict] = None,
              timeout: Optional[float] = 30.0) -> dict:
    """A JSON call; a ``timeout`` of None waits without end.  A status
    >= 400 raises HttpError with the peer's error message; an unreachable
    peer raises HttpError(503); a spent deadline raises DeadlineExceeded."""
    data = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"} if data is not None else {}
    try:
        status, body, _ = _request(method, url, data, headers, timeout, True)
    except (OSError, http.client.HTTPException) as e:
        raise HttpError(503, f"{url} unreachable: {e}") from None
    if status >= 400:
        try:
            err = json.loads(body).get("error", body.decode(errors="replace"))
        except (ValueError, AttributeError):
            err = body.decode(errors="replace")
        raise HttpError(status, err) from None
    return json.loads(body) if body else {}


def http_bytes(method: str, url: str, payload: Optional[bytes] = None,
               headers: Optional[dict] = None, timeout: float = 60.0,
               follow_redirects: bool = True) -> tuple[int, bytes, dict]:
    """-> (status, body, headers); an unreachable peer gives status 0."""
    try:
        return _request(method, url, payload, headers, timeout,
                        follow_redirects)
    except (OSError, http.client.HTTPException) as e:
        return 0, str(e).encode(), {}


def http_download(method: str, url: str, dest_path: str,
                  timeout: float = 3600.0) -> int:
    """Stream a response body to ``dest_path`` in bounded pieces, through
    ``dest_path.part`` renamed on success, so a dropped transfer never
    leaves a torn file under the final name.  Returns the HTTP status
    (0 when the peer cannot be reached); only a 200 writes the file."""
    # a budgeted caller's bulk fetch inherits the remaining budget, never
    # the hour's default
    timeout = _deadline.clamp(timeout)
    headers = _deadline.inject_deadline_headers({})
    span, ctx = _egress_span(method, url, download=True)
    with span:
        if ctx is not None:
            _trace_context.inject_trace_headers(headers)
        return _download_body(method, url, dest_path, timeout, headers)


def _download_body(method: str, url: str, dest_path: str, timeout,
                   headers: dict) -> int:
    tmp = dest_path + ".part"
    try:
        conn, target = _connect(url, timeout)
        try:
            conn.request(method, target, headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                return resp.status
            with open(tmp, "wb") as f:
                while True:
                    piece = resp.read(_FILE_PIECE)
                    if not piece:
                        break
                    f.write(piece)
            if resp.length:
                raise OSError(f"{url}: body ended {resp.length} bytes short")
        finally:
            conn.close()
        os.replace(tmp, dest_path)
        return 200
    except (OSError, http.client.HTTPException):
        return 0
    finally:
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
