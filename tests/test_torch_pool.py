"""The pooled keep-alive client (``_RawConn``, ``_pooled_request``) of
seaweedfs_tpu_torch/utils/httpd.py against the reference's.

A raw test listener counts the connections it accepts and the requests
its handler runs, so each case shows what went over the wire: N calls from
one thread to one peer ride one connection; a reused connection the peer
closed while idle is resent once on a fresh one; a POST whose answer times
out is never resent.  Each such case runs the same script through both
packages' clients and the counts must be equal.  The port alone never
resends a POST the peer may have run: one dropped unanswered, or one in
flight when its server stops and another binds the port.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

from seaweedfs_tpu.utils import httpd as ref
from seaweedfs_tpu_torch.utils import httpd as port


class CountingListener:
    """A keep-alive HTTP/1.1 server on a raw socket that counts accepts
    and handled requests.  ``close_after`` closes each connection after
    that many answers (no Connection: close header: the client finds out
    on its next use); ``slow_post`` holds each POST's answer that long;
    ``drop`` names requests ("METHOD path") that are read, counted and
    then answered by closing the connection."""

    def __init__(self, close_after: int = 0, slow_post: float = 0.0,
                 drop: tuple = ()):
        self.close_after = close_after
        self.slow_post = slow_post
        self.drop = drop
        self.accepts = 0
        self.handled: list[str] = []
        self._lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        self._stop = False
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self._lock:
                self.accepts += 1
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        answered = 0
        try:
            while True:
                line = rfile.readline()
                if not line:
                    return
                method, path, _ = line.decode().split(" ", 2)
                length = 0
                while True:
                    h = rfile.readline()
                    if h in (b"\r\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    if k.lower() == "content-length":
                        length = int(v)
                body = rfile.read(length) if length else b""
                with self._lock:
                    self.handled.append(f"{method} {path}")
                if f"{method} {path}" in self.drop:
                    return
                if method == "POST" and self.slow_post:
                    time.sleep(self.slow_post)
                out = b'{"n": %d, "len": %d}' % (len(self.handled),
                                                   len(body))
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: "
                             b"application/json\r\nContent-Length: %d\r\n"
                             b"\r\n%s" % (len(out), out))
                answered += 1
                if self.close_after and answered >= self.close_after:
                    return
        except OSError:
            return
        finally:
            rfile.close()
            conn.close()

    def close(self) -> None:
        self._stop = True
        self.sock.close()


def _in_thread(fn):
    """Run ``fn`` on a fresh thread (a fresh thread-local pool)."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(60)
    return out


MODS = {"ref": ref, "port": port}


@pytest.mark.parametrize("calls", [1, 10, 50])
def test_sequential_calls_ride_one_connection(calls):
    counts = {}
    for name, mod in MODS.items():
        srv = CountingListener()
        try:
            def script(mod=mod, srv=srv):
                got = [mod.http_json("GET", f"{srv.url}/x/{i}")
                       for i in range(calls)]
                got.append(mod.http_bytes("POST", f"{srv.url}/y", b"abc"))
                return got

            out = _in_thread(script)
            assert "error" not in out, out
            counts[name] = (srv.accepts, list(srv.handled), out["value"])
        finally:
            srv.close()
    assert counts["port"][0] == 1
    assert counts["port"] == counts["ref"]


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_a_stale_reused_connection_is_resent_once(method):
    """The peer closes each connection after one answer; every later call
    finds its pooled socket dead and goes again on a fresh one (the port
    checks before a POST's send, a GET it resends): one accept per call,
    each request handled once."""
    counts = {}
    for name, mod in MODS.items():
        srv = CountingListener(close_after=1)
        try:
            def script(mod=mod, srv=srv):
                out = []
                for i in range(4):
                    out.append(mod.http_json(method, f"{srv.url}/s/{i}",
                                             {} if method == "POST"
                                             else None))
                    time.sleep(0.05)  # the close reaches the client
                return out

            out = _in_thread(script)
            assert "error" not in out, out
            counts[name] = (srv.accepts, list(srv.handled), out["value"])
        finally:
            srv.close()
    assert counts["port"][0] == 4
    assert counts["port"][1] == [f"{method} /s/{i}" for i in range(4)]
    assert counts["port"] == counts["ref"]


def test_a_timed_out_post_is_not_resent():
    """A POST on a reused connection whose answer outlasts the timeout
    surfaces the failure; the handler ran once and no second connection
    was opened for it."""
    counts = {}
    for name, mod in MODS.items():
        srv = CountingListener(slow_post=1.5)
        try:
            def script(mod=mod, srv=srv):
                first = mod.http_json("GET", f"{srv.url}/warm")
                try:
                    mod.http_json("POST", f"{srv.url}/mutate", {"a": 1},
                                  timeout=0.4)
                    return first, "answered"
                except mod.HttpError as e:
                    return first, e.status

            out = _in_thread(script)
            assert "error" not in out, out
            time.sleep(1.5)  # the slow answer has come and gone
            counts[name] = (srv.accepts, list(srv.handled), out["value"])
        finally:
            srv.close()
    assert counts["port"] == (1, ["GET /warm", "POST /mutate"],
                              ({"n": 1, "len": 0}, 503))
    assert counts["port"] == counts["ref"]


def test_a_request_dropped_unanswered_is_resent_only_if_idempotent():
    """The peer reads a request on a reused connection and closes it with
    no answer (a handler that raised, a server stopping): the port sends a
    GET once more on a fresh connection, and surfaces a POST's failure
    without sending it again, since the peer may have run it."""
    for method, want in (("GET", (2, ["GET /warm", "GET /x", "GET /x"])),
                         ("POST", (1, ["GET /warm", "POST /x"]))):
        srv = CountingListener(drop=(f"{method} /x",))
        try:
            def script(srv=srv, method=method):
                port.http_json("GET", f"{srv.url}/warm")
                return port.http_bytes(method, f"{srv.url}/x", b"abc")[0]

            out = _in_thread(script)
            assert out.get("value") == 0, out  # unreachable either way
            assert (srv.accepts, srv.handled) == want, method
        finally:
            srv.close()


def test_a_post_in_flight_at_a_stop_runs_once():
    """A POST whose handler is still running when its reactor server stops
    (which aborts the connection) is not sent again to the server that
    binds the port next: the handler ran once, the caller sees 503."""
    calls: list[bytes] = []
    entered, release = threading.Event(), threading.Event()

    def router():
        r = port.Router("once")

        @r.route("GET", "/ping")
        def ping(req):
            return port.Response({"ok": True})

        @r.route("POST", "/mutate")
        def mutate(req):
            calls.append(req.body)
            entered.set()
            release.wait(10)
            return port.Response({"n": len(calls)})

        return r

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    url = f"http://127.0.0.1:{port_no}"
    first = port.serve(router(), "127.0.0.1", port_no)
    second = None
    out: dict = {}

    def client():
        port.http_json("GET", url + "/ping")  # pools the connection
        try:
            out["answer"] = port.http_json("POST", url + "/mutate", {"a": 1})
        except port.HttpError as e:
            out["status"] = e.status

    t = threading.Thread(target=client)
    t.start()
    try:
        assert entered.wait(10)
        t0 = time.monotonic()
        port.stop_server(first)
        assert time.monotonic() - t0 < 2.0
        second = port.serve(router(), "127.0.0.1", port_no)
        t.join(5)  # a resend would reach the second server and run
        release.set()
        t.join(30)
        assert not t.is_alive()
        assert out == {"status": 503} and calls == [b'{"a": 1}']
        # the second server serves the same client's next call
        assert port.http_json("GET", url + "/ping") == {"ok": True}
    finally:
        release.set()
        if second is not None:
            port.stop_server(second)


def test_a_spent_deadline_is_not_a_peer_failure():
    """A budget the answer outlasts raises DeadlineExceeded (a server
    answers 504), not the unreachable peer's 503; nothing is resent."""
    from seaweedfs_tpu_torch.utils import deadline

    srv = CountingListener(slow_post=1.0)
    try:
        def script():
            d, prev = deadline.begin_request({"X-Weed-Deadline": "0.3"})
            try:
                port.http_json("POST", f"{srv.url}/slow", {}, timeout=30)
            finally:
                deadline.end_request(prev)

        out = _in_thread(script)
        assert isinstance(out.get("error"), deadline.DeadlineExceeded), out
        time.sleep(1.0)
        assert (srv.accepts, srv.handled) == (1, ["POST /slow"])
    finally:
        srv.close()


def test_each_thread_has_its_own_connection():
    srv = CountingListener()
    try:
        threads = [threading.Thread(
            target=lambda: [port.http_json("GET", f"{srv.url}/t")
                            for _ in range(5)]) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert srv.accepts == 3 and len(srv.handled) == 15
    finally:
        srv.close()


def test_downloads_ride_the_pool(tmp_path):
    """http_download streams over the thread's pooled connection: calls
    before and after it share that one connection."""
    blob = bytes(range(256)) * 4096  # 1 MiB
    router = port.Router("dl")
    path = tmp_path / "blob"
    path.write_bytes(blob)

    @router.route("GET", "/blob")
    def get_blob(req):
        return port.Response(file_path=str(path))

    @router.route("GET", "/ping")
    def ping(req):
        return port.Response({"ok": True})

    accepts = []
    srv = port.serve(router, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        from seaweedfs_tpu_torch.stats import dataplane_metrics

        def script():
            m = dataplane_metrics().connections
            port.http_json("GET", url + "/ping")
            accepts.append(m.value())
            st = port.http_download("GET", url + "/blob",
                                    str(tmp_path / "out"))
            port.http_json("GET", url + "/ping")
            accepts.append(m.value())
            return st

        out = _in_thread(script)
        assert out.get("value") == 200, out
        assert (tmp_path / "out").read_bytes() == blob
        assert not (tmp_path / "out.part").exists()
        # the gauge counts open reactor connections: no new one opened
        assert accepts[0] == accepts[1]
    finally:
        port.stop_server(srv)
