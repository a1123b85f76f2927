"""The port's security plane against the reference's (tolerance 0).

JWTs (seaweedfs_tpu_torch/security/jwt.py) are byte-equal to the
reference's for the same key, fid and frozen clock, and each package
decodes the other's; wrong-key, tampered, expired and malformed tokens
fail with the reference's messages.  The guard's literal and CIDR
whitelist and its token checks answer alike, and the config loader reads
the same security.toml to the same guards, ``WEED_*`` overrides and a
missing file included.  Then secured servers: a reference and a port
volume server with the same keys and whitelist answer one transcript of
unsigned, wrong-fid, expired and signed PUTs, GETs, HEADs, Range GETs,
DELETEs, ``/admin/batch_delete`` and batch routes, from a whitelisted
peer and from 127.0.0.2, byte for byte.  Whole clusters, port-only and
mixed both ways (a reference master's tokens at port servers, a port
master's at reference servers), sign at assign and lookup, forward the
token to a ``001`` replica, and take the port WeedClient's writes, reads
and deletes; the framed planes stay closed under a key and admit only
whitelisted peers under a whitelist alone.
"""

from __future__ import annotations

import base64
import http.client
import json
import socket
import time

import pytest

from seaweedfs_tpu import security as ref_security
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.security import config as ref_config
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch import security
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.security import config as port_config
from seaweedfs_tpu_torch.security import jwt as port_jwt
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils.framing import tcp_port_for
from seaweedfs_tpu_torch.utils.httpd import http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

NOW = 1_700_000_000.5
WKEY, RKEY = "write-key-7f3a", "read-key-19c2"
FIDS = ["3,01637037d6", "7,ffee0000000000aa", "12,1a2b3c4d5e"]


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


# --- tokens --------------------------------------------------------------------

@pytest.mark.parametrize("key", [WKEY, b"bytes-key", "k"])
@pytest.mark.parametrize("expires", [10, 60, 0, -5])
def test_tokens_equal_the_reference_s(frozen, key, expires):
    for fid in FIDS:
        got = port_jwt.gen_jwt_for_volume_server(key, expires, fid)
        assert got == ref_jwt.gen_jwt_for_volume_server(key, expires, fid)
        assert port_jwt.decode_jwt(key, got) == \
            ref_jwt.decode_jwt(key, got)
    got = port_jwt.gen_jwt_for_filer_server(key, expires)
    assert got == ref_jwt.gen_jwt_for_filer_server(key, expires)
    assert port_jwt.gen_jwt_for_volume_server("", expires, FIDS[0]) == "" \
        == ref_jwt.gen_jwt_for_volume_server("", expires, FIDS[0])


def _forged(token: str) -> str:
    h, body, sig = token.split(".")
    claims = json.loads(base64.urlsafe_b64decode(body + "=="))
    claims["fid"] = "4,02"
    body = base64.urlsafe_b64encode(
        json.dumps(claims).encode()).rstrip(b"=").decode()
    return f"{h}.{body}.{sig}"


def _refusals() -> list[tuple[str, str]]:
    """(key, token) pairs both packages must refuse."""
    good = ref_jwt.gen_jwt_for_volume_server(WKEY, 60, FIDS[0])
    h, body, sig = good.split(".")
    none_alg = base64.urlsafe_b64encode(
        b'{"alg":"none","typ":"JWT"}').rstrip(b"=").decode()
    return [
        ("other-key", good),                                   # wrong key
        (WKEY, _forged(good)),                                 # tampered
        (WKEY, ref_jwt._sign(WKEY.encode(), {                  # expired
            "fid": FIDS[0], "exp": int(NOW) - 5})),
        (WKEY, "not-a-token"),
        (WKEY, f"{h}.{body}"),
        (WKEY, f"@@@.{body}.{sig}"),
        (WKEY, f"{none_alg}.{body}.{sig}"),
        (WKEY, f"{h}.{body}.@@"),
        (WKEY, f"{h}.{body}.{sig}xx"),
        (WKEY, ""),
    ]


@pytest.mark.parametrize("case", range(10))
def test_refused_tokens_give_the_reference_s_error(frozen, case):
    key, token = _refusals()[case]
    with pytest.raises(ref_jwt.JwtError) as want:
        ref_jwt.decode_jwt(key, token)
    with pytest.raises(port_jwt.JwtError) as got:
        port_jwt.decode_jwt(key, token)
    assert str(got.value) == str(want.value)


def test_get_jwt_reads_the_query_then_the_bearer_header():
    cases = [({}, {"jwt": "q"}), ({"Authorization": "BEARER abc"}, {}),
             ({"Authorization": "bearer xyz"}, {}),
             ({"Authorization": "Bearer "}, {}), ({"Authorization": "B"}, {}),
             ({"Authorization": "Basic aGk6aGk="}, {}),
             ({"Authorization": "BEARER h"}, {"jwt": "q"}), ({}, None),
             (None, None)]
    for headers, query in cases:
        assert port_jwt.get_jwt(headers, query) == \
            ref_jwt.get_jwt(headers, query)


# --- the guard and the config loader ----------------------------------------------

@pytest.mark.parametrize("white_list", [
    [], ["127.0.0.1"], ["127.0.0.1", "10.0.0.0/8"], ["192.168.1.0/24", ""],
    ["::1", "fd00::/8"], ["not-a-net/33", "10.1.2.3"]])
def test_whitelist_matches_the_reference_s(white_list):
    ref = ref_security.Guard(white_list=white_list)
    port = security.Guard(white_list=white_list)
    assert port.is_write_active == ref.is_write_active
    assert port.white_list == ref.white_list
    for ip in ("127.0.0.1", "127.0.0.2", "10.1.2.3", "10.255.0.1",
               "192.168.1.77", "192.168.2.1", "::1", "fd00::5", "fe80::1",
               "garbage"):
        assert port.check_white_list(ip) == ref.check_white_list(ip), ip


class _Req:
    """What the guard reads of a request."""

    def __init__(self, headers: dict, query: dict, peer: str = "127.0.0.1"):
        self.headers, self.query = headers, query
        self.handler = type("H", (), {"client_address": (peer, 1)})()


def test_guard_checks_answer_as_the_reference_s(frozen):
    kw = dict(white_list=["127.0.0.1"], signing_key=WKEY,
              read_signing_key=RKEY)
    ref, port = ref_security.Guard(**kw), security.Guard(**kw)
    tokens = [""] + [t for _, t in _refusals()] + [
        ref_jwt.gen_jwt_for_volume_server(WKEY, 10, FIDS[0]),
        ref_jwt.gen_jwt_for_volume_server(WKEY, 10, FIDS[1]),
        ref_jwt.gen_jwt_for_volume_server(RKEY, 10, FIDS[0]),
        ref_jwt.gen_jwt_for_filer_server(RKEY, 60)]
    for tok in tokens:
        for where in ("header", "query"):
            req = _Req({"Authorization": f"BEARER {tok}"} if where ==
                       "header" else {}, {"jwt": tok} if where == "query"
                       else {})
            assert port.check_write_jwt(req, FIDS[0]) == \
                ref.check_write_jwt(req, FIDS[0])
            assert port.check_read_jwt(req, FIDS[0]) == \
                ref.check_read_jwt(req, FIDS[0])
    for peer in ("127.0.0.1", "127.0.0.2"):
        req = _Req({}, {}, peer)
        assert port.white_list_ok(req) == ref.white_list_ok(req)
    assert port.gen_read_token() == ref.gen_read_token()
    assert security.Guard().check_write_jwt(_Req({}, {}), FIDS[0]) is None


TOMLS = [
    '[jwt.signing]\nkey = "abc"\nexpires_after_seconds = 11\n'
    '[guard]\nwhite_list = ["127.0.0.1"]\n',
    '[jwt.signing]\nkey = "has#hash"  # a comment\n'
    '[jwt.signing.read]\nkey = \'lit\\\\eral\'\n'
    'expires_after_seconds = 90\n'
    '[guard]\nwhite_list = [\n  "10.0.0.0/8",\n  "127.0.0.1",\n]\n',
    '[tls]\nca = "/c/ca.crt"\ncert = "/c/n.crt"\nkey = "/c/n.key"\n'
    'verify_client = false\n',
    '# nothing set\n[jwt.signing]\n',
]


def _guard_doc(g) -> dict:
    return {k: getattr(g, k) for k in (
        "white_list", "signing_key", "expires_after_sec", "read_signing_key",
        "read_expires_after_sec", "is_write_active")}


@pytest.mark.parametrize("text", TOMLS)
def test_config_loader_reads_the_reference_s_values(tmp_path, monkeypatch,
                                                    text):
    from seaweedfs_tpu.security import tls as ref_tls
    from seaweedfs_tpu_torch.security import tls as port_tls

    (tmp_path / "security.toml").write_text(text)
    ref_conf = ref_config.load_security_configuration([str(tmp_path)])
    conf = port_config.load_security_configuration([str(tmp_path)])
    assert conf.data == ref_conf.data and conf.source == ref_conf.source
    for fn in ("volume_guard", "master_guard"):
        assert _guard_doc(getattr(port_config, fn)(conf)) == \
            _guard_doc(getattr(ref_config, fn)(ref_conf))
    assert port_tls.from_configuration(conf).__dict__ == \
        ref_tls.from_configuration(ref_conf).__dict__
    monkeypatch.setenv("WEED_JWT_SIGNING_KEY", "zzz")
    monkeypatch.setenv("WEED_JWT_SIGNING_EXPIRES_AFTER_SECONDS", "77")
    monkeypatch.setenv("WEED_JWT_SIGNING_READ_EXPIRES_AFTER_SECONDS", "x")
    g = port_config.volume_guard(conf)
    assert (g.signing_key, g.expires_after_sec) == ("zzz", 77)
    assert _guard_doc(g) == _guard_doc(ref_config.volume_guard(ref_conf))
    for key, default in (("guard.white_list", []), ("missing.key", 5),
                         ("jwt.signing.key", "")):
        assert conf.get(key, default) == ref_conf.get(key, default)
        assert conf.get_bool(key) == ref_conf.get_bool(key)


def test_missing_file_gives_an_inactive_guard(tmp_path):
    conf = port_config.load_security_configuration(search_dirs=[str(tmp_path)])
    ref_conf = ref_config.load_security_configuration([str(tmp_path)])
    g = port_config.volume_guard(conf)
    assert not g.is_write_active and not g.read_signing_key
    assert _guard_doc(g) == _guard_doc(ref_config.volume_guard(ref_conf))


# --- secured volume servers, one transcript ----------------------------------------

def _exchange(url: str, method: str, path: str, body: bytes = None,
              headers: dict = None, source: str = "127.0.0.1"):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60,
                                      source_address=(source, 0))
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _secured_kw(read: bool = True) -> dict:
    return dict(white_list=["127.0.0.1"], signing_key=WKEY,
                read_signing_key=RKEY if read else "")


@pytest.fixture(scope="module")
def secured_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("secured")
    master = f"127.0.0.1:{free_port()}"  # nothing listens: no replicas
    ref = RefVolumeServer([str(root / "ref")], master, port=free_port(),
                          pulse_seconds=30, ec_engine="cpu", heat=False,
                          ledger=False, needle_cache_mb=0,
                          guard=ref_security.Guard(**_secured_kw())).start()
    port = VolumeServer([str(root / "port")], master, port=free_port(),
                        pulse_seconds=30, device="cpu", needle_cache_mb=0,
                        guard=security.Guard(**_secured_kw())).start()
    yield ref, port
    port.stop()
    ref.stop()


def _transcript() -> list[tuple]:
    """(method, path, body, headers, source) in order; tokens made with
    the clock frozen at NOW, so they hold for an hour."""
    def wtok(fid, exp=3600):
        return ref_jwt.gen_jwt_for_volume_server(WKEY, exp, fid)

    read = ref_jwt.gen_jwt_for_filer_server(RKEY, 3600)
    fid, fid2, fid3 = (str(FileId(1, k, 0x1000 + k)) for k in (1, 2, 3))
    expired = ref_jwt._sign(WKEY.encode(), {"fid": fid, "exp": 1})
    bearer = lambda t: {"Authorization": f"BEARER {t}"}  # noqa: E731
    data = bytes(range(256)) * 40
    out = [("POST", "/admin/assign_volume", b'{"volume_id": 1}', {},
            "127.0.0.1")]
    for h, q in (({}, ""), (bearer(wtok(fid2)), ""), (bearer(expired), ""),
                 (bearer(ref_jwt.gen_jwt_for_volume_server(RKEY, 60, fid)),
                  ""), ({}, "?jwt=garbage"), (bearer(wtok(fid)), "")):
        out.append(("PUT", f"/{fid}{q}?ts=5" if not q else f"/{fid}{q}&ts=5",
                    data, h, "127.0.0.1"))
    out += [
        ("PUT", f"/{fid2}?ts=6&jwt={wtok(fid2)}", data[:999], {}, "127.0.0.1"),
        ("PUT", f"/{fid3}?ts=7", data, bearer(wtok(fid3)), "127.0.0.2"),
        ("PUT", f"/{fid3}?ts=7", data[:77], bearer(wtok(fid3)), "127.0.0.1"),
        ("POST", f"/{fid3}?ts=8", b"", {}, "127.0.0.2"),
    ]
    for src in ("127.0.0.1", "127.0.0.2"):
        for method in ("GET", "HEAD"):
            for h in ({}, bearer(read), bearer(wtok(fid)),
                      bearer(ref_jwt.gen_jwt_for_volume_server(RKEY, 60,
                                                               fid)),
                      bearer(ref_jwt.gen_jwt_for_volume_server(RKEY, 60,
                                                               fid2))):
                out.append((method, f"/{fid}", None, h, src))
        out.append(("GET", f"/{fid}", None, {**bearer(read),
                                             "Range": "bytes=10-99"}, src))
        out.append(("GET", f"/{fid}?jwt={read}", None, {}, src))
    out += [
        ("POST", "/batch/read", json.dumps({"fids": [fid]}).encode(), {},
         "127.0.0.1"),
        ("POST", "/batch/write", b"", {}, "127.0.0.1"),
        ("POST", "/batch/write", b"", {}, "127.0.0.2"),
        ("DELETE", f"/{fid}", None, {}, "127.0.0.1"),
        ("DELETE", f"/{fid}", None, bearer(wtok(fid)), "127.0.0.2"),
        ("DELETE", f"/{fid}", None, bearer(wtok(fid2)), "127.0.0.1"),
        ("DELETE", f"/{fid}", None, bearer(wtok(fid)), "127.0.0.1"),
        ("POST", "/admin/batch_delete", json.dumps(
            {"fids": [fid2, fid3]}).encode(), {}, "127.0.0.1"),
        ("POST", "/admin/batch_delete", json.dumps(
            {"fids": [fid2, fid3]}).encode(), {}, "127.0.0.2"),
        ("POST", "/admin/batch_delete", json.dumps(
            {"fids": [fid2, fid3, "9,0100000001"],
             "jwts": {fid2: wtok(fid3), fid3: wtok(fid3),
                      "9,0100000001": wtok("9,0100000001")}}).encode(), {},
         "127.0.0.1"),
        ("POST", "/admin/batch_delete", json.dumps(
            {"fids": [fid2], "jwts": {fid2: wtok(fid2)}}).encode(), {},
         "127.0.0.1"),
        ("GET", f"/{fid3}", None, bearer(read), "127.0.0.1"),
        ("POST", "/admin/readonly", b'{"volume_id": 1}', {}, "127.0.0.2"),
        ("POST", "/admin/volume_check", b'{"volume_id": 1}', {},
         "127.0.0.2"),
    ]
    return out


def test_secured_transcript_equals_the_reference_s(secured_pair, frozen):
    ref, port = secured_pair
    transcript = _transcript()
    for i, (method, path, body, headers, src) in enumerate(transcript):
        want = _exchange(ref.url, method, path, body, headers, src)
        got = _exchange(port.url, method, path, body, headers, src)
        assert got == want, (i, method, path, src, want, got)
    statuses = [_exchange(port.url, m, p, b, h, s)[0]
                for m, p, b, h, s in transcript[1:4]]
    assert statuses == [401, 401, 401]


def test_secured_servers_keep_the_framed_plane_closed(secured_pair):
    ref, port = secured_pair
    assert port._tcp_server is None and ref._tcp_server is None
    for vs in (ref, port):
        with pytest.raises(OSError):
            socket.create_connection(
                ("127.0.0.1", tcp_port_for(vs.store.port)), timeout=2).close()


def test_a_whitelist_alone_admits_only_listed_peers_to_frames(tmp_path):
    from seaweedfs_tpu_torch.volume_server.tcp import TcpVolumeClient

    master = f"127.0.0.1:{free_port()}"
    vs = VolumeServer([str(tmp_path / "v")], master, port=free_port(),
                      pulse_seconds=30, device="cpu",
                      guard=security.Guard(white_list=["127.0.0.1"])).start()
    try:
        assert vs._tcp_server is not None and vs._tcp_server.alive
        vs.store.add_volume(1)
        fid = str(FileId(1, 5, 0x55))
        addr = f"127.0.0.1:{tcp_port_for(vs.store.port)}"
        TcpVolumeClient().write(addr, fid, b"framed")
        assert TcpVolumeClient().read(addr, fid) == b"framed"
        s = socket.create_connection(("127.0.0.1", tcp_port_for(
            vs.store.port)), timeout=5, source_address=("127.0.0.2", 0))
        try:
            try:
                s.sendall(b"R" + len(fid).to_bytes(2, "little")
                          + fid.encode() + b"\0\0\0\0")
                got = s.recv(16)
            except ConnectionResetError:  # closed with the frame unread
                got = b""
            assert got == b""  # closed before any frame
        finally:
            s.close()
    finally:
        vs.stop()


# --- secured clusters: port-only and mixed both ways --------------------------------

def _cluster(tmp_path, master_kind: str, server_kinds: list[str],
             guard_kw: dict):
    if master_kind == "ref":
        m = RefMasterServer(port=free_port(), pulse_seconds=0.4,
                            guard=ref_security.Guard(**guard_kw)).start()
    else:
        m = MasterServer(port=free_port(), pulse_seconds=0.4,
                         guard=security.Guard(**guard_kw)).start()
    servers = []
    for i, kind in enumerate(server_kinds):
        d = str(tmp_path / f"vs{i}")
        if kind == "ref":
            vs = RefVolumeServer([d], m.url, port=free_port(),
                                 pulse_seconds=0.4, ec_engine="cpu",
                                 needle_cache_mb=0,
                                 guard=ref_security.Guard(**guard_kw))
        else:
            vs = VolumeServer([d], m.url, port=free_port(), pulse_seconds=0.4,
                              device="cpu", needle_cache_mb=0,
                              guard=security.Guard(**guard_kw))
        servers.append(vs.start())
    deadline = time.time() + 10
    while time.time() < deadline and \
            len(m.topo.all_nodes()) < len(servers):
        time.sleep(0.05)
    assert len(m.topo.all_nodes()) == len(servers)
    return m, servers


@pytest.mark.parametrize("layout", [("port", ["port", "port"]),
                                    ("ref", ["port", "port"]),
                                    ("port", ["ref", "ref"]),
                                    ("ref", ["port", "ref"]),
                                    ("port", ["ref", "port"])])
def test_secured_cluster_signs_forwards_and_takes_the_client(tmp_path,
                                                             layout):
    m, servers = _cluster(tmp_path, layout[0], layout[1], _secured_kw())
    try:
        a = http_json("GET", f"http://{m.url}/dir/assign?replication=001")
        claims = port_jwt.decode_jwt(WKEY, a["auth"])
        assert claims["fid"] == a["fid"] and claims["exp"] >= time.time()
        assert a["auth"] == ref_jwt._sign(WKEY.encode(), claims)
        # unsigned and wrong-key writes answer 401 at the assigned server
        assert _exchange(a["url"], "PUT", f"/{a['fid']}", b"x")[0] == 401
        bad = port_jwt.gen_jwt_for_volume_server(RKEY, 30, a["fid"])
        assert _exchange(a["url"], "PUT", f"/{a['fid']}", b"x",
                         {"Authorization": f"BEARER {bad}"})[0] == 401
        # the signed write reaches the 001 replica with its token
        assert _exchange(a["url"], "PUT", f"/{a['fid']}", b"replicated",
                         {"Authorization": f"BEARER {a['auth']}"})[0] == 201
        vid = int(a["fid"].split(",")[0])
        look = http_json("GET", f"http://{m.url}/dir/lookup?volumeId={vid}"
                                f"&fileId={a['fid']}")
        assert port_jwt.decode_jwt(RKEY, look["auth"]).keys() <= {"exp"}
        assert port_jwt.decode_jwt(WKEY, look["writeAuth"])["fid"] == \
            a["fid"]
        assert len(look["locations"]) == 2
        for loc in look["locations"]:
            assert _exchange(loc["url"], "GET", f"/{a['fid']}")[0] == 401
            assert _exchange(loc["url"], "GET", f"/{a['fid']}", None, {
                "Authorization": f"BEARER {look['auth']}"}) == \
                (200, b"replicated")
        # the port's client carries every token
        c = WeedClient(m.url)
        payloads = {c.upload(b"secured %d" % i, name=f"s{i}.txt",
                             replication="001"): b"secured %d" % i
                    for i in range(4)}
        for fid, data in payloads.items():
            assert c.download(fid) == data
            assert c.download_range(fid, 2, 5) == data[2:7]
        fid = next(iter(payloads))
        assert _exchange(a["url"], "DELETE", f"/{fid}")[0] == 401
        c.delete(fid)
        for loc in look["locations"]:
            st, _ = _exchange(loc["url"], "GET", f"/{fid}", None, {
                "Authorization": f"BEARER {look['auth']}"})
            assert st == 404
        # the framed assign is closed under a key: upload_tcp falls back
        # to HTTP for both legs
        fid = c.upload_tcp(b"framed fallback", replication="001")
        assert c._tcp_assign_ok is False
        assert c.download(fid) == b"framed fallback"
    finally:
        for vs in servers:
            vs.stop()
        m.stop()


def test_write_key_only_cluster_reads_without_tokens(tmp_path):
    """A write key and no read key: tokens guard writes and deletes, reads
    stay open and lookup carries no read token (both packages)."""
    kw = dict(signing_key=WKEY)
    for master_kind in ("port", "ref"):
        m, servers = _cluster(tmp_path / master_kind, master_kind, ["port"],
                              kw)
        try:
            c = WeedClient(m.url)
            fid = c.upload(b"open reads")
            look = http_json("GET", f"http://{m.url}/dir/lookup?volumeId="
                                    f"{fid.split(',')[0]}")
            assert "auth" not in look
            assert _exchange(servers[0].url, "GET", f"/{fid}") == \
                (200, b"open reads")
            assert _exchange(servers[0].url, "DELETE", f"/{fid}")[0] == 401
        finally:
            for vs in servers:
                vs.stop()
            m.stop()
