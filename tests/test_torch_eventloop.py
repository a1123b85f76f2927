"""The port's event-loop serving front (seaweedfs_tpu_torch/utils/
eventloop.py) against the reference's (seaweedfs_tpu/utils/eventloop.py).

The HTTP cases of the reference's tests/test_eventloop.py and the four of
tests/test_httpd_framing.py, each sent byte for byte to a router behind
each package's ``serve`` and answered alike (tolerance 0: status lines,
headers but Date, bodies); then what only the port's side can show here:
the bounded stop, a slow client beside fast ones, a response past the
outbox cap, and shed, deadline and trace through the reactor.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

from seaweedfs_tpu.utils import httpd as ref
from seaweedfs_tpu_torch.utils import eventloop as port_loop
from seaweedfs_tpu_torch.utils import httpd as port

MODS = {"ref": ref, "port": port}


def _routes(mod, router) -> None:
    @router.route("GET", "/ping")
    def ping(req):
        return mod.Response({"ok": True})

    @router.route("POST", "/echo")
    def echo(req):
        return mod.Response(raw=req.body)

    @router.route("GET", "/big")
    def big(req):
        return mod.Response(raw=b"Z" * (4 << 20))

    @router.route("GET", "/redir")
    def redir(req):
        return mod.Response(None, status=302, raw=b"",
                            headers={"Location": "http://x/y"})


@pytest.fixture
def servers():
    out = {}
    for name, mod in MODS.items():
        router = mod.Router("t")
        _routes(mod, router)
        srv = mod.serve(router, "127.0.0.1", 0)
        out[name] = (srv, srv.server_address[1], router)
    yield out
    for name, (srv, _, _) in out.items():
        try:
            MODS[name].stop_server(srv)
        except Exception:  # noqa: BLE001 - a test may have stopped it
            pass


def _recv_one(rfile) -> tuple[bytes, bytes]:
    """One response from a buffered reader: (head without its Date line,
    body framed by Content-Length)."""
    lines = []
    clen = 0
    while True:
        line = rfile.readline()
        if not line:
            return b"\r\n".join(lines), b""
        line = line.rstrip(b"\r\n")
        if not line:
            break
        k, _, v = line.partition(b":")
        if k.strip().lower() == b"content-length":
            clen = int(v.strip())
        if k.strip().lower() != b"date":
            lines.append(line)
    return b"\r\n".join(lines), rfile.read(clen)


def _session(port_no: int, sends: list[bytes], answers: int,
             until_close: bool = False) -> list:
    """Send each chunk in order on one connection, then read ``answers``
    responses (and, with ``until_close``, whether the server closed)."""
    with socket.create_connection(("127.0.0.1", port_no), timeout=10) as s:
        for chunk in sends:
            s.sendall(chunk)
        rfile = s.makefile("rb")
        got = [_recv_one(rfile) for _ in range(answers)]
        if until_close:
            s.settimeout(5)
            try:
                got.append(("closed", rfile.read(1) == b""))
            except OSError:
                got.append(("closed", True))
        rfile.close()
        return got


def _both(servers, sends, answers, until_close=False) -> dict:
    return {name: _session(servers[name][1], sends, answers, until_close)
            for name in MODS}


# --- the reference's tests/test_eventloop.py HTTP cases -------------------

def test_reactor_is_the_default_server(servers):
    for srv, _, _ in servers.values():
        assert type(srv).__name__ == "ReactorHTTPServer"


def test_keepalive_many_requests_one_socket(servers):
    got = _both(servers, [b"GET /ping HTTP/1.1\r\nHost: h\r\n\r\n"] * 20, 20)
    assert got["port"] == got["ref"]
    assert all(h.startswith(b"HTTP/1.1 200 ") and b == b'{"ok": true}'
               for h, b in got["port"])


def test_pipelined_requests_answered_in_order(servers):
    reqs = b""
    for i in range(3):
        body = b"req%d" % i
        reqs += (b"POST /echo HTTP/1.1\r\nHost: h\r\n"
                 b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    got = _both(servers, [reqs], 3)
    assert got["port"] == got["ref"]
    assert [b for _, b in got["port"]] == [b"req0", b"req1", b"req2"]


def test_negative_content_length_answers_400(servers):
    got = _both(servers, [b"GET /ping HTTP/1.1\r\nHost: h\r\n"
                          b"Content-Length: -1\r\n\r\n"], 1, True)
    assert got["port"] == got["ref"]
    assert got["port"][0][0].startswith(b"HTTP/1.1 400 ")


def test_http10_and_connection_close_semantics(servers):
    for req in (b"GET /ping HTTP/1.0\r\nHost: h\r\n\r\n",
                b"GET /ping HTTP/1.1\r\nHost: h\r\nConnection: close\r\n\r\n"):
        got = _both(servers, [req], 1, True)
        assert got["port"] == got["ref"]
        assert got["port"][-1] == ("closed", True)
    keep = _both(servers, [b"GET /ping HTTP/1.0\r\nConnection: keep-alive"
                           b"\r\n\r\n"] * 2, 2)
    assert keep["port"] == keep["ref"]


def test_empty_body_response_does_not_wedge_the_connection(servers):
    got = _both(servers, [b"GET /redir HTTP/1.1\r\nHost: h\r\n\r\n"] * 3
                + [b"GET /ping HTTP/1.1\r\nHost: h\r\n\r\n"], 4)
    assert got["port"] == got["ref"]
    assert got["port"][3][1] == b'{"ok": true}'


def test_stop_with_open_keepalive_connections_is_bounded(servers):
    srv, port_no, _ = servers["port"]
    conns = [socket.create_connection(("127.0.0.1", port_no), timeout=5)
             for _ in range(8)]
    for c in conns:
        c.sendall(b"GET /ping HTTP/1.1\r\nHost: h\r\n\r\n")
        c.recv(4096)
    t0 = time.monotonic()
    port.stop_server(srv)
    took = time.monotonic() - t0
    assert took < 2.0, f"stop under open keep-alive took {took:.2f}s"
    for c in conns:
        c.settimeout(5)
        assert c.recv(4096) == b""  # aborted by the stop
        c.close()
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port_no))  # the port is free at once
    s.close()
    again = port.serve(servers["port"][2], "127.0.0.1", port_no)
    try:
        assert port.http_json("GET", f"http://127.0.0.1:{port_no}/ping") \
            == {"ok": True}
    finally:
        port.stop_server(again)


def test_slow_client_does_not_stall_the_loop(servers):
    """A client that asks for 4 MiB and reads nothing parks its response
    in the outbox; other connections keep being served."""
    port_no = servers["port"][1]
    slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    slow.settimeout(10)
    slow.connect(("127.0.0.1", port_no))
    slow.sendall(b"GET /big HTTP/1.1\r\nHost: h\r\n\r\n")
    time.sleep(0.3)
    lat = []
    for _ in range(5):
        t0 = time.monotonic()
        st, _, _ = port.http_bytes("GET", f"http://127.0.0.1:{port_no}/ping",
                                   timeout=5.0)
        lat.append(time.monotonic() - t0)
        assert st == 200
    assert max(lat) < 1.0, f"loop stalled behind a slow client: {lat}"
    total = 0
    deadline = time.time() + 20
    while total < (4 << 20) and time.time() < deadline:
        piece = slow.recv(65536)
        if not piece:
            break
        total += len(piece)
    assert total >= (4 << 20)
    slow.close()


def test_large_response_streams_to_fast_client(servers):
    """Past the outbox cap a worker waits for a reading client instead
    of aborting it."""
    _, port_no, router = servers["port"]
    size = port_loop.MAX_OUT_BUFFERED + (8 << 20)
    blob = b"Q" * size

    @router.route("GET", "/huge")
    def huge(req):
        return port.Response(raw=blob)

    st, body, _ = port.http_bytes("GET", f"http://127.0.0.1:{port_no}/huge",
                                  timeout=120.0)
    assert st == 200 and len(body) == size and body == blob


def test_file_bodies_take_the_sendfile_road(servers, tmp_path):
    """``Response(file_path=, file_range=)`` streams through os.sendfile on
    the reactor, equal to the reference's answer byte for byte."""
    path = tmp_path / "f"
    path.write_bytes(bytes(range(256)) * 8192)  # 2 MiB
    for name, mod in MODS.items():
        router = servers[name][2]

        @router.route("GET", "/whole")
        def whole(req, mod=mod):
            return mod.Response(file_path=str(path))

        @router.route("GET", "/part")
        def part(req, mod=mod):
            return mod.Response(file_path=str(path),
                                file_range=(1000, 70000))

    for target in (b"/whole", b"/part"):
        got = _both(servers, [b"GET %s HTTP/1.1\r\nHost: h\r\n\r\n" % target]
                    * 2, 2)
        assert got["port"] == got["ref"]
    assert got["port"][0][1] == path.read_bytes()[1000:71000]


def test_shed_deadline_trace_through_reactor():
    from seaweedfs_tpu_torch.observability import (disable_tracing,
                                                   enable_tracing,
                                                   set_sample_rate)
    from seaweedfs_tpu_torch.stats import request_plane_metrics
    from seaweedfs_tpu_torch.utils.admission import AdmissionController

    r = port.Router("t")
    release = threading.Event()

    @r.route("GET", "/slowpoke")
    def slowpoke(req):
        release.wait(5.0)
        return port.Response({"ok": True})

    @r.route("GET", "/1,00000000deadbeef")
    def obj(req):
        return port.Response(raw=b"x" * 64)

    r.admission = AdmissionController(1, role="t")
    srv = port.serve(r, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    enable_tracing()
    set_sample_rate(0.0)
    plane = request_plane_metrics()
    shed0 = plane.shed.value("t")
    try:
        t = threading.Thread(target=lambda: port.http_bytes(
            "GET", url + "/slowpoke", timeout=10.0), daemon=True)
        t.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        st, _, hdrs = port.http_bytes("GET", url + "/1,00000000deadbeef",
                                      timeout=5.0)
        assert st == 503 and hdrs.get("Retry-After") == "1"
        assert time.monotonic() - t0 < 1.0
        assert plane.shed.value("t") - shed0 == 1
        release.set()
        t.join(timeout=10)
        st, body, _ = port.http_bytes("GET", url + "/1,00000000deadbeef",
                                      headers={"X-Weed-Deadline": "-0.5"},
                                      timeout=5.0)
        assert st == 504, (st, body)
        st, _, hdrs = port.http_bytes("GET", url + "/1,00000000deadbeef",
                                      headers={"X-Force-Trace": "1"},
                                      timeout=5.0)
        assert st == 200 and hdrs.get("X-Trace-Id")
        # the worker's thread context was restored: an unforced request on
        # the same pooled connection is not traced
        st, _, hdrs = port.http_bytes("GET", url + "/1,00000000deadbeef",
                                      timeout=5.0)
        assert st == 200 and "X-Trace-Id" not in hdrs
    finally:
        release.set()
        disable_tracing()
        port.stop_server(srv)


def test_priority_lane_and_overflow_workers():
    """Control-plane paths take the priority lane, and with every core
    worker parked an overflow worker serves the next request."""
    reactor = port_loop.Reactor(workers=2).start()
    ran: list[str] = []
    gate = threading.Event()
    for _ in range(2):
        reactor.submit(lambda: gate.wait(5))
    done = threading.Event()
    reactor.submit(lambda: (ran.append("data"), done.set()))
    assert done.wait(5), "no overflow worker took the queued request"
    stats = reactor.loop_lag_stats()
    assert stats["workers"] >= 3 and stats["workers_busy"] >= 2
    gate.set()
    assert port_loop.OPS_PRIORITY_PREFIXES == (
        "/metrics", "/debug", "/cluster", "/ec/scrub", "/admin",
        "/heartbeat", "/dir/status", "/status", "/stats", "/raft")


# --- the reference's tests/test_httpd_framing.py, on both fronts ----------

@pytest.fixture(params=["reactor", "threaded"])
def front(request, monkeypatch):
    if request.param == "threaded":
        monkeypatch.setenv("WEED_DATAPLANE", "threaded")
    return request.param


def _framing_servers():
    out = {}
    for name, mod in MODS.items():
        router = mod.Router()
        _routes(mod, router)
        srv = mod.serve(router, "127.0.0.1", 0)
        out[name] = (srv, srv.server_address[1], router)
    return out


def _framing_case(sends: list[bytes], answers: int, until_close=False):
    servers = _framing_servers()
    try:
        return _both(servers, sends, answers, until_close)
    finally:
        for name, (srv, _, _) in servers.items():
            MODS[name].stop_server(srv)


def test_404_with_body_does_not_desync_keepalive(front):
    body = b"x" * 5000
    got = _framing_case([b"POST /no/such/route HTTP/1.1\r\nHost: h\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body), body,
                         b"GET /ping HTTP/1.1\r\nHost: h\r\n\r\n"], 2)
    assert got["port"] == got["ref"]
    assert got["port"][0][0].startswith(b"HTTP/1.1 404 ")
    assert got["port"][1][1] == b'{"ok": true}'


def test_chunked_request_refused_and_closed(front):
    got = _framing_case([b"POST /echo HTTP/1.1\r\nHost: h\r\n"
                         b"Transfer-Encoding: chunked\r\n\r\n"
                         b"5\r\nhello\r\n0\r\n\r\n"], 1, True)
    assert got["port"] == got["ref"]
    assert got["port"][0][0].startswith(b"HTTP/1.1 501 ")
    assert b"Connection: close" in got["port"][0][0]
    assert got["port"][-1] == ("closed", True)


def test_oversize_request_line_gets_414(front):
    got = _framing_case([b"GET /" + b"a" * (1 << 17) + b" HTTP/1.1\r\n"], 1)
    assert got["port"] == got["ref"]
    assert got["port"][0][0].startswith(b"HTTP/1.1 414 ")


def test_matched_route_keepalive_still_works(front):
    sends = [b"POST /echo HTTP/1.1\r\nHost: h\r\nContent-Length: %d\r\n\r\n"
             % len(p) + p for p in (b"one", b"two")]
    got = _framing_case(sends, 2)
    assert got["port"] == got["ref"]
    assert [b for _, b in got["port"]] == [b"one", b"two"]


def test_the_fronts_answer_alike(monkeypatch):
    """The same requests through the reactor and the threaded fallback:
    one answer, the Date line aside (the two sessions may straddle a
    second)."""
    seen = {}
    for mode in ("reactor", "threaded"):
        monkeypatch.delenv("WEED_DATAPLANE", raising=False)
        if mode == "threaded":
            monkeypatch.setenv("WEED_DATAPLANE", "threaded")
        router = port.Router("t")
        _routes(port, router)
        srv = port.serve(router, "127.0.0.1", 0)
        try:
            got = _session(srv.server_address[1],
                           [b"POST /echo HTTP/1.1\r\nHost: h\r\n"
                            b"Content-Length: 3\r\n\r\nabc",
                            b"GET /ping HTTP/1.1\r\nHost: h\r\n\r\n"], 2)
        finally:
            port.stop_server(srv)
        seen[mode] = [(b"\r\n".join(ln for ln in h.split(b"\r\n")
                                    if not ln.startswith(b"Date:")), b)
                      for h, b in got]
    assert seen["reactor"] == seen["threaded"]
