"""The port's HTTP framework against seaweedfs_tpu.utils.httpd, on the same
inputs: range headers, multipart bodies, integer query parameters, and
one router behind each package's server answering the same requests."""

from __future__ import annotations

import http.client
import os

import pytest

from seaweedfs_tpu.utils import httpd as ref
from seaweedfs_tpu_torch.utils import httpd as port
from tests.conftest import free_port

RANGES = ["bytes=0-0", "bytes=0-9", "bytes=5-", "bytes=-3", "bytes=-0",
          "bytes=-500", "bytes=99-", "bytes=100-", "bytes=150-200",
          "bytes=10-5", "bytes=7-7000", "bytes=a-b", "bytes=-", "bytes=3",
          "bytes=", "items=0-1", "", "bytes=0-1,4-5"]


@pytest.mark.parametrize("size", [0, 1, 100])
@pytest.mark.parametrize("header", RANGES)
def test_parse_range(header, size):
    assert port.parse_range(header, size) == ref.parse_range(header, size)
    assert port.UNSATISFIABLE_RANGE == ref.UNSATISFIABLE_RANGE


def _multipart(boundary: str, parts: list[tuple[str, str, str, bytes]],
               close: bool = True) -> bytes:
    out = b""
    for name, filename, ctype, payload in parts:
        disp = f'form-data; name="{name}"'
        if filename is not None:
            disp += f'; filename="{filename}"'
        out += f"--{boundary}\r\nContent-Disposition: {disp}\r\n".encode()
        if ctype:
            out += f"Content-Type: {ctype}\r\n".encode()
        out += b"\r\n" + payload + b"\r\n"
    return out + (f"--{boundary}--\r\n".encode() if close else b"")


def _upload_cases():
    b = "XyZ12"
    payload = os.urandom(300) + b"\r\n--XyZ1" + os.urandom(40)
    return [
        ("raw", b"plain bytes", "text/plain"),
        ("raw-no-type", b"\x00\x01", ""),
        ("file", _multipart(b, [("file", "a.txt", "text/plain", b"hi")]),
         f"multipart/form-data; boundary={b}"),
        ("quoted-boundary", _multipart(b, [("file", "x.bin", "", payload)]),
         f'multipart/form-data; boundary="{b}"'),
        ("path-in-name", _multipart(b, [("file", "..\\d/e/../f.png",
                                         "image/png", b"png")]),
         f"Multipart/Form-Data; boundary={b}"),
        ("fields-first", _multipart(b, [("key", None, "", b"k1"),
                                        ("File", "y", "", b"data"),
                                        ("after", None, "", b"ignored")]),
         f"multipart/form-data; boundary={b}"),
        ("no-file-part", _multipart(b, [("other", None, "", b"v")]),
         f"multipart/form-data; boundary={b}"),
        ("unclosed", _multipart(b, [("file", "z", "", b"tail")], False),
         f"multipart/form-data; boundary={b}"),
        ("no-boundary", b"whatever", "multipart/form-data"),
    ]


@pytest.mark.parametrize("case", _upload_cases(), ids=lambda c: c[0])
def test_extract_upload(case):
    _, body, ctype = case

    def run(mod):
        try:
            return mod.extract_upload(body, ctype)
        except mod.HttpError as e:
            return ("error", e.status, e.message)

    assert run(port) == run(ref)


@pytest.mark.parametrize("query,default", [
    ({"n": "12"}, None), ({"n": "-3"}, 0), ({"n": ""}, 7), ({}, 7),
    ({}, None), ({"n": ""}, None), ({"n": "abc"}, 1), ({"n": "1.5"}, None),
])
def test_qint(query, default):
    def run(mod):
        try:
            return mod.qint(query, "n", default)
        except mod.HttpError as e:
            return ("error", e.status, e.message)

    assert run(port) == run(ref)


def _routes(mod, router, tmp_file: str) -> None:
    @router.route("GET", r"/json/(\d+)")
    def as_json(req):
        return mod.Response({"n": int(req.match.group(1)),
                             "q": req.query.get("q", "")})

    @router.route("POST", "/echo")
    def echo(req):
        return mod.Response(raw=req.body[::-1], status=201,
                            headers={"Content-Type": "text/x-echo",
                                     "X-Len": str(len(req.body))})

    @router.route("GET", "/teapot")
    def teapot(req):
        raise mod.HttpError(418, "short and stout")

    @router.route("GET", "/unreachable")
    def unreachable(req):
        raise mod.HttpError(0, "peer gone")

    @router.route("GET", "/missing")
    def missing(req):
        raise KeyError("no such thing")

    @router.route("GET", "/boom")
    def boom(req):
        raise ValueError("kaput")

    @router.route("POST", "/json-body")
    def json_body(req):
        return mod.Response({"got": req.json()})

    @router.route("GET", "/file")
    @router.route("HEAD", "/file")
    def file(req):
        return mod.Response(file_path=tmp_file)

    @router.route("GET", "/bad-int")
    def bad_int(req):
        return mod.Response({"v": mod.qint(req.query, "v")})


REQUESTS = [
    ("GET", "/json/42?q=x%20y", None),
    ("GET", "/json/x", None),
    ("POST", "/echo", b"hello world"),
    ("POST", "/echo", b""),
    ("GET", "/teapot", None),
    ("GET", "/unreachable", None),
    ("GET", "/missing", None),
    ("GET", "/boom", None),
    ("POST", "/json-body", b'{"a": [1, 2]}'),
    ("POST", "/json-body", None),
    ("GET", "/file", None),
    ("HEAD", "/file", None),
    ("GET", "/bad-int?v=zz", None),
    ("GET", "/bad-int", None),
    ("PUT", "/echo", b"no such method"),
    ("DELETE", "/nowhere", None),
]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("httpd") / "blob")
    with open(path, "wb") as f:
        f.write(os.urandom(3 * (1 << 20) + 17))  # several stream pieces
    out = {}
    for name, mod in (("ref", ref), ("port", port)):
        router = mod.Router("test")
        _routes(mod, router, path)
        port_no = free_port()
        out[name] = (mod.serve(router, "127.0.0.1", port_no), port_no, mod)
    yield out
    for srv, _, mod in out.values():
        mod.stop_server(srv)


def _exchange(port_no: int, method: str, path: str, body):
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return (r.status, r.read(), r.getheader("Content-Type"),
                r.getheader("Content-Length"), r.getheader("X-Len"))
    finally:
        conn.close()


@pytest.mark.parametrize("method,path,body", REQUESTS,
                         ids=[f"{m} {p}" for m, p, _ in REQUESTS])
def test_router_answers_like_the_reference(servers, method, path, body):
    got = _exchange(servers["port"][1], method, path, body)
    want = _exchange(servers["ref"][1], method, path, body)
    assert got == want


def test_client_calls_against_the_reference_server(servers, tmp_path):
    url = f"http://127.0.0.1:{servers['ref'][1]}"
    assert port.http_json("GET", url + "/json/7?q=z") == {"n": 7, "q": "z"}
    with pytest.raises(port.HttpError) as e:
        port.http_json("GET", url + "/teapot")
    assert (e.value.status, e.value.message) == (418, "short and stout")
    status, body, headers = port.http_bytes("POST", url + "/echo", b"abc")
    assert (status, body, headers["X-Len"]) == (201, b"cba", "3")
    dest = str(tmp_path / "copy")
    assert port.http_download("GET", url + "/file", dest) == 200
    assert open(dest, "rb").read() == \
        port.http_bytes("GET", url + "/file")[1]
    assert port.http_download("GET", url + "/missing", dest + "2") == 404
    assert not os.path.exists(dest + "2")
    assert not os.path.exists(dest + "2.part")
    closed = f"http://127.0.0.1:{free_port()}"
    with pytest.raises(port.HttpError) as e:
        port.http_json("GET", closed + "/x")
    assert e.value.status == 503
    assert port.http_bytes("GET", closed + "/x")[0] == 0
    assert port.http_download("GET", closed + "/x", dest + "3") == 0


def test_stopped_server_answers_503_on_open_connections(tmp_path,
                                                        monkeypatch):
    """The threaded fallback: a kept-alive connection outlives the stop
    and its next request answers 503 with Connection: close (the reactor
    closes such connections instead: the test after this one)."""
    monkeypatch.setenv("WEED_DATAPLANE", "threaded")
    router = port.Router("stop")

    @router.route("GET", "/ok")
    def ok(req):
        return port.Response({"ok": True})

    port_no = free_port()
    srv = port.serve(router, "127.0.0.1", port_no)
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=10)
    try:
        conn.request("GET", "/ok")
        r = conn.getresponse()
        assert (r.status, r.read()) == (200, b'{"ok": true}')
        port.stop_server(srv)
        conn.request("GET", "/ok")  # the kept-alive connection
        r = conn.getresponse()
        assert r.status == 503 and r.getheader("Connection") == "close"
        r.read()
    finally:
        conn.close()


def test_stopped_reactor_closes_open_connections(tmp_path):
    """The reactor's stop aborts the server's kept-alive connections, as
    the reference reactor's does, and a pooled client's next call goes to
    whoever binds the port next."""
    routers = []
    for answer in ("old", "new"):
        router = port.Router("stop")

        @router.route("GET", "/who")
        def who(req, answer=answer):
            return port.Response({"who": answer})

        routers.append(router)
    port_no = free_port()
    srv = port.serve(routers[0], "127.0.0.1", port_no)
    assert type(srv).__name__ == "ReactorHTTPServer"
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=10)
    try:
        conn.request("GET", "/who")
        r = conn.getresponse()
        assert (r.status, r.read()) == (200, b'{"who": "old"}')
        url = f"http://127.0.0.1:{port_no}/who"
        assert port.http_json("GET", url) == {"who": "old"}
        port.stop_server(srv)
        with pytest.raises((http.client.HTTPException, OSError)):
            conn.request("GET", "/who")  # the kept-alive connection
            conn.getresponse()
        srv = port.serve(routers[1], "127.0.0.1", port_no)
        # the pooled connection to the old server is stale: resent once
        assert port.http_json("GET", url) == {"who": "new"}
    finally:
        conn.close()
        port.stop_server(srv)
