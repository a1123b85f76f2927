"""The port's request deadlines (utils/deadline.py) against the reference's,
and their wiring into the port's HTTP server and client calls.

``parse_deadline``, ``clamp``, ``scope`` and ``inject_deadline_headers``
of both packages run over the same cases under one frozen monotonic clock;
what they return (or raise) must be equal.  Live: the port's Router and
the reference's answer an expired ``X-Weed-Deadline`` with the same 504
before the handler runs, restore the thread's deadline for the next
request on the connection, and map a handler's ``DeadlineExceeded`` to
504; the port's ``http_json`` and ``http_download`` raise
``DeadlineExceeded`` on a spent budget without sending, re-send the
budget left, and turn a wait the deadline cut into ``DeadlineExceeded``.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time

import pytest

import seaweedfs_tpu.utils.deadline as ref
import seaweedfs_tpu.utils.httpd as ref_httpd
import seaweedfs_tpu_torch.utils.deadline as port
import seaweedfs_tpu_torch.utils.httpd as port_httpd
from tests.conftest import free_port

HEADER_VALUES = [None, "", "abc", "nan", "inf", "-inf", "1.5", " 2 ", "0",
                 "-1", 3, "1e-4", "0.0005", "0.002", "12.25", "1_0"]
BUDGETS = [None, 0.0, 0.0004, 0.25, 5.0, 40.0]
TIMEOUTS = [0.001, 0.1, 3.0, 30.0, 3600.0]


@pytest.fixture
def frozen(monkeypatch):
    """One monotonic clock for both modules, moved by hand."""
    clock = {"now": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["now"])
    return clock


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return ("raise", type(e).__name__, str(e))


def _parse_cases(mod, clock) -> list:
    out = []
    for v in HEADER_VALUES:
        d = mod.parse_deadline(v)
        out.append((repr(v), None if d is None else
                    (d.at - clock["now"], d.remaining(), d.expired())))
        hdrs = {} if v is None else {mod.DEADLINE_HEADER: v}
        ddl, prev = mod.begin_request(hdrs)
        out.append(("begin", repr(v), ddl is None, prev is None,
                    mod.current() is ddl))
        mod.end_request(prev)
    out.append(("begin none", mod.begin_request(None)[0]))
    mod.end_request(None)
    return out


def _budget_cases(mod, clock) -> list:
    out = []
    for budget in BUDGETS:
        with mod.scope(budget) as ddl:
            out.append(("scope", budget, ddl is mod.current(),
                        None if ddl is None else ddl.remaining()))
            for t in TIMEOUTS:
                out.append(("clamp", budget, t,
                            _outcome(lambda: mod.clamp(t))))
            out.append(("headers", budget,
                        mod.inject_deadline_headers({"a": "b"}),
                        mod.inject_deadline_headers(
                            {mod.DEADLINE_HEADER: "9"})))
            clock["now"] += 0.2  # part of the budget goes by
            out.append(("later", budget, _outcome(lambda: mod.clamp(30.0)),
                        mod.inject_deadline_headers({})))
            # a helper thread carries the caller's deadline on
            with mod.scope(ddl) as same:
                out.append(("carried", same is ddl))
            with mod.scope(None):
                out.append(("cleared", mod.current() is None,
                            mod.clamp(7.0)))
            out.append(("restored", mod.current() is ddl))
        out.append(("after", mod.current() is None))
    return out


def test_parse_and_begin_equal_the_reference(frozen):
    assert _parse_cases(port, frozen) == _parse_cases(ref, frozen)


def test_clamp_scope_and_headers_equal_the_reference(frozen):
    start = frozen["now"]
    got = _budget_cases(port, frozen)
    frozen["now"] = start
    assert got == _budget_cases(ref, frozen)


# --- live -------------------------------------------------------------------

def _serve(httpd, seen: list):
    router = httpd.Router("deadline-test")
    mod = port if httpd is port_httpd else ref

    @router.route("GET", "/budget")
    def budget(req):
        ddl = mod.current()
        seen.append(None if ddl is None else ddl.remaining())
        return httpd.Response({"ran": True})

    @router.route("GET", "/spent")
    def spent(req):
        raise mod.DeadlineExceeded("downstream budget ran out")

    @router.route("GET", "/slow")
    def slow(req):
        time.sleep(1.0)
        return httpd.Response({"ran": True})

    port_no = free_port()
    server = httpd.serve(router, "127.0.0.1", port_no)
    return server, port_no


def _exchange(port_no: int, requests: list) -> list:
    """The requests on one keep-alive connection -> [(status, body)]."""
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=10)
    out = []
    try:
        for path, headers in requests:
            conn.request("GET", path, headers=headers)
            r = conn.getresponse()
            out.append((r.status, json.loads(r.read())))
    finally:
        conn.close()
    return out


@pytest.mark.parametrize("httpd", [port_httpd, ref_httpd],
                         ids=["port", "reference"])
def test_router_answers_504_and_restores_the_thread(httpd):
    seen: list = []
    server, port_no = _serve(httpd, seen)
    try:
        got = _exchange(port_no, [
            ("/budget", {"X-Weed-Deadline": "0"}),
            ("/budget", {"X-Weed-Deadline": "-1"}),
            ("/budget", {"X-Weed-Deadline": "5"}),
            ("/budget", {}),
            ("/budget", {"X-Weed-Deadline": "junk"}),
            ("/spent", {"X-Weed-Deadline": "5"}),
        ])
    finally:
        httpd.stop_server(server)
    want_504 = {"error": "deadline exceeded before dispatch"}
    assert got == [(504, want_504), (504, want_504), (200, {"ran": True}),
                   (200, {"ran": True}), (200, {"ran": True}),
                   (504, {"error": "downstream budget ran out"})]
    # the expired requests never ran; the budgeted one saw its budget, and
    # the next request on the thread saw none
    assert len(seen) == 3 and 4.0 < seen[0] <= 5.0
    assert seen[1:] == [None, None]


def test_router_504_equals_the_reference():
    transcripts = {}
    for name, httpd in (("port", port_httpd), ("reference", ref_httpd)):
        server, port_no = _serve(httpd, [])
        try:
            transcripts[name] = _exchange(port_no, [
                ("/budget", {"X-Weed-Deadline": "0.0001"}),
                ("/spent", {}), ("/budget", {"X-Weed-Deadline": "2"})])
        finally:
            httpd.stop_server(server)
    assert transcripts["port"] == transcripts["reference"]


class _Listener:
    """A socket that counts the connections made to it, and answers each
    request line with the X-Weed-Deadline it carried."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        self.headers: list[str] = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            self.accepted += 1
            with c:
                data = b""
                while b"\r\n\r\n" not in data:
                    piece = c.recv(4096)
                    if not piece:
                        break
                    data += piece
                value = ""
                for line in data.decode(errors="replace").split("\r\n"):
                    if line.lower().startswith("x-weed-deadline:"):
                        value = line.split(":", 1)[1].strip()
                self.headers.append(value)
                body = json.dumps({"deadline": value}).encode()
                c.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                          b"\r\nContent-Length: " + str(len(body)).encode()
                          + b"\r\nConnection: close\r\n\r\n" + body)

    def close(self):
        self.sock.close()


def test_client_calls_honour_the_deadline(tmp_path):
    lst = _Listener()
    url = f"http://127.0.0.1:{lst.port}/x"
    try:
        with port.scope(0):
            with pytest.raises(port.DeadlineExceeded):
                port_httpd.http_json("GET", url)
            with pytest.raises(port.DeadlineExceeded):
                port_httpd.http_bytes("GET", url)
            with pytest.raises(port.DeadlineExceeded):
                port_httpd.http_download("GET", url,
                                         str(tmp_path / "f"))
        assert lst.accepted == 0  # nothing was sent
        assert not (tmp_path / "f").exists()
        # no deadline: no header; a budget: what is left of it
        assert port_httpd.http_json("GET", url) == {"deadline": ""}
        with port.scope(5.0):
            left = float(port_httpd.http_json("GET", url)["deadline"])
        assert 4.0 < left <= 5.0
    finally:
        lst.close()


def test_a_wait_the_deadline_cut_raises_deadline_exceeded():
    server, port_no = _serve(port_httpd, [])
    try:
        t0 = time.monotonic()
        with port.scope(0.3):
            with pytest.raises(port.DeadlineExceeded):
                port_httpd.http_json("GET", f"http://127.0.0.1:{port_no}/slow")
        assert time.monotonic() - t0 < 0.9
        # without a deadline the same call waits and succeeds
        assert port_httpd.http_json(
            "GET", f"http://127.0.0.1:{port_no}/slow") == {"ran": True}
    finally:
        port_httpd.stop_server(server)
