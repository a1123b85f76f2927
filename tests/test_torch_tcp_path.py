"""The framed-TCP data path of the port (seaweedfs_tpu_torch/volume_server/
tcp.py, the master's framed assign, ``upload_tcp``/``download_tcp``,
``/batch/read`` and ``/batch/write``, ``benchmark -useTcp``) against
seaweedfs_tpu's, on the CPU (``device="cpu"``, ``ec_engine="cpu"``).

Every comparison is byte for byte (tolerance 0): answer frames and error
frames, batch answers, and the ``.dat`` and ``.idx`` after the same
frames with the write clock pinned in both packages.  The counterparts
of the reference's tests/test_tcp_path.py (but its JWT case: the port
has no guard) and tests/test_eventloop.py::test_tcp_batch_read_and_write
come first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import struct
import time

import numpy as np
import pytest

import weed
from seaweedfs_tpu.master.server import MasterServer as RefMaster
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.storage import volume as ref_volume_mod
from seaweedfs_tpu.volume_server import tcp as ref_tcp
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch import __main__ as port_cli
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.observability.events import get_journal
from seaweedfs_tpu_torch.stats import degraded_bind_metrics
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.storage import volume as port_volume_mod
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server import tcp as port_tcp
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from seaweedfs_tpu_torch.volume_server.store import Store
from tests.conftest import free_port

TCP = {"ref": ref_tcp, "port": port_tcp}


def _wait_nodes(master, n: int = 1, timeout: float = 10.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline and len(master.topo.all_nodes()) < n:
        time.sleep(0.05)
    assert len(master.topo.all_nodes()) >= n


@pytest.fixture
def pair(tmp_path):
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    d = tmp_path / "v"
    d.mkdir()
    vs = VolumeServer([str(d)], master.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    _wait_nodes(master)
    yield master, vs
    vs.stop()
    master.stop()


def _assign_and_write(master, payload: bytes) -> tuple[str, str]:
    r = http_json("GET", f"http://{master.url}/dir/assign?count=1",
                  timeout=10.0)
    st, _b, _h = http_bytes("POST", f"http://{r['url']}/{r['fid']}",
                            payload, timeout=10.0)
    assert st in (200, 201)
    return r["fid"], r["url"]


# --- the reference's tests/test_tcp_path.py, on the port ---------------------

def test_tcp_write_read_delete_roundtrip(pair):
    master, vs = pair
    client = WeedClient(master.url)
    payload = os.urandom(4096)
    fid = client.upload_tcp(payload)
    # readable over both planes: the framed write landed in the same store
    assert client.download_tcp(fid) == payload
    assert client.download(fid) == payload
    tcp = port_tcp.TcpVolumeClient()
    assert tcp.delete(port_tcp.tcp_address(vs.url), fid) > 0
    with pytest.raises(Exception):
        client.download_tcp(fid)


def test_tcp_errors_keep_connection_alive(pair):
    master, vs = pair
    tcp = port_tcp.TcpVolumeClient()
    addr = port_tcp.tcp_address(vs.url)
    with pytest.raises(OSError, match="not found|KeyError"):
        tcp.read(addr, "999,0000deadbeef")
    # the same pooled connection still serves the next request
    fid = WeedClient(master.url).upload_tcp(b"still alive")
    assert tcp.read(addr, fid) == b"still alive"


def test_tcp_interleaved_ops_on_one_connection(pair):
    master, vs = pair
    client = WeedClient(master.url)
    tcp = port_tcp.TcpVolumeClient()
    addr = port_tcp.tcp_address(vs.url)
    blobs = [client.upload_tcp(os.urandom(100 + i)) for i in range(50)]
    for fid in blobs:
        data = tcp.read(addr, fid)
        assert len(data) >= 100
        tcp.write(addr, fid, data + b"!")  # the same needle, overwritten
        assert tcp.read(addr, fid) == data + b"!"
    assert len(tcp._conns) == 1


def test_tcp_read_decompresses_http_written_objects(pair):
    """An HTTP upload of compressible content is stored gzipped; the
    framed read serves the original bytes."""
    master, vs = pair
    client = WeedClient(master.url)
    text = b"compress me " * 1000
    fid = client.upload(text, name="doc.txt", mime="text/plain")
    assert client.download(fid) == text
    assert client.download_tcp(fid) == text


def test_tcp_batch_read_and_write(pair):
    master, vs = pair
    fids = [_assign_and_write(master, b"t%03d" % i * 256)[0]
            for i in range(8)]
    tcp = port_tcp.TcpVolumeClient()
    addr = port_tcp.tcp_address(vs.url)
    res = tcp.batch_read(addr, fids)
    assert res == [b"t%03d" % i * 256 for i in range(8)]
    # a failed slot is a None, and the connection survives
    res = tcp.batch_read(addr, [fids[0], "999,00000000ffffffff"])
    assert res[0] is not None and res[1] is None
    ok = tcp.batch_write(addr, [(f, b"\xcc" * 256) for f in fids[:4]])
    assert ok == [True] * 4
    assert tcp.batch_read(addr, fids[:4]) == [b"\xcc" * 256] * 4


# --- both packages, frame for frame -----------------------------------------

class _PinnedTime:
    """A volume module's ``time`` with ``time_ns`` counting from a fixed
    start: each package's writes get the same stamps in the same order."""

    def __init__(self):
        self._ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self._ns += 1000
        return self._ns

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """A Store of each package with volume 1, its framed front not yet
    started, and the write clock pinned in both volume modules."""
    monkeypatch.setattr(ref_volume_mod, "time", _PinnedTime())
    monkeypatch.setattr(port_volume_mod, "time", _PinnedTime())
    out = {"ref": RefStore([str(tmp_path / "ref")], port=free_port()),
           "port": Store([str(tmp_path / "port")], port=free_port(),
                         device="cpu")}
    for st in out.values():
        st.add_volume(1)
    yield out
    for st in out.values():
        st.close()


def _serve(name: str, store, front: str, monkeypatch):
    if front == "threaded":
        monkeypatch.setenv("WEED_DATAPLANE", "threaded")
    srv = TCP[name].TcpVolumeServer(store, "127.0.0.1").start()
    monkeypatch.delenv("WEED_DATAPLANE", raising=False)
    assert srv.alive
    return srv


def _frame(op: bytes, key: str, body: bytes = b"") -> bytes:
    k = key.encode()
    return op + struct.pack(">H", len(k)) + k + \
        struct.pack(">I", len(body)) + body


def _ops(seed: int, count: int) -> list[tuple[bytes, str, bytes]]:
    """A seeded mix of W, R and D frames over volume 1 (and a missing
    volume, a malformed fid and an unknown op now and then)."""
    rng = np.random.default_rng(seed)
    fids = [f"1,{k:x}{int(rng.integers(1, 1 << 32)):08x}"
            for k in range(1, 21)]
    out = []
    for i in range(count):
        fid = fids[int(rng.integers(0, len(fids)))]
        r = int(rng.integers(0, 10))
        if i % 17 == 5:
            out.append((b"R", "9," + fid[2:], b""))
        elif i % 23 == 7:
            out.append((b"W", "not-a-fid", b"x"))
        elif i % 29 == 11:
            out.append((b"X", fid, b""))
        elif r < 5:
            out.append((b"W", fid, rng.bytes(int(rng.integers(0, 5000)))))
        elif r < 8:
            out.append((b"R", fid, b""))
        else:
            out.append((b"D", fid, b""))
    return out


def _answers(port: int, frames: list[bytes], pipelined: bool) -> list[bytes]:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        rfile = s.makefile("rb")

        def one() -> bytes:
            head = rfile.read(5)
            return head + rfile.read(struct.unpack(">I", head[1:])[0])

        if pipelined:
            s.sendall(b"".join(frames))
            return [one() for _ in frames]
        out = []
        for f in frames:
            s.sendall(f)
            out.append(one())
        return out


def _files(store) -> dict[str, bytes]:
    v = store.volumes[1]
    base = os.path.join(v.directory, "1")
    out = {}
    for ext in (".dat", ".idx"):
        with open(base + ext, "rb") as f:
            out[ext] = f.read()
    return out


@pytest.mark.parametrize("front", ["reactor", "threaded"])
def test_pipelined_frames_answer_in_order_like_the_references(
        stores, front, monkeypatch):
    """100 mixed W/R/D frames in one sendall: the port answers them in
    order, frame for frame as the reference does (on the reference's
    reactor), and leaves the same .dat and .idx."""
    frames = [_frame(*op) for op in _ops(1, 100)]
    got, files = {}, {}
    for name, st in stores.items():
        srv = _serve(name, st, front if name == "port" else "reactor",
                     monkeypatch)
        try:
            got[name] = _answers(srv.port, frames, pipelined=True)
        finally:
            srv.stop()
        files[name] = _files(st)
    assert got["port"] == got["ref"]
    assert files["port"] == files["ref"]
    statuses = [a[:1] for a in got["port"]]
    assert statuses.count(b"\x00") > 60 and statuses.count(b"\x01") > 5


def test_the_threaded_and_reactor_fronts_answer_alike(tmp_path,
                                                      monkeypatch):
    frames = [_frame(*op) for op in _ops(2, 80)]
    got, files = {}, {}
    for front in ("reactor", "threaded"):
        monkeypatch.setattr(port_volume_mod, "time", _PinnedTime())
        st = Store([str(tmp_path / front)], port=free_port(), device="cpu")
        st.add_volume(1)
        srv = _serve("port", st, front, monkeypatch)
        try:
            got[front] = _answers(srv.port, frames, pipelined=False)
        finally:
            srv.stop()
        files[front] = _files(st)
        st.close()
    assert got["reactor"] == got["threaded"]
    assert files["reactor"] == files["threaded"]


def _client_results(client, addr: str, ops) -> list:
    """Each op through a TcpVolumeClient: its return value, or the error
    frame's text."""
    out = []
    for op, key, body in ops:
        call = {b"W": lambda: client.write(addr, key, body),
                b"R": lambda: client.read(addr, key),
                b"D": lambda: client.delete(addr, key),
                b"B": lambda: client.batch_read(addr, body),
                b"P": lambda: client.batch_write(addr, body),
                b"X": lambda: client.request(addr, b"X", key)}[op]
        try:
            out.append(("ok", call()))
        except OSError as e:
            out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("client", ["ref", "port"])
def test_clients_cross_wired_answer_alike(stores, client, monkeypatch):
    """A reference TcpVolumeClient against the port's server and the
    port's against the reference's: every W, R, D, B and P answer and
    every error the same."""
    server = "port" if client == "ref" else "ref"
    ops = _ops(3, 60)
    written = sorted({k for op, k, _ in ops if op == b"W"
                      and k.startswith("1,")})
    ops += [(b"B", "", written + ["9,0102030405", "junk"]),
            (b"P", "", [(f, f.encode() * 3) for f in written[:5]]
             + [("9,0102030405", b"z")]),
            (b"B", "", written[:5]), (b"B", "", []), (b"P", "", [])]
    got = {}
    for side, srv_name in (("cross", server), ("same", client)):
        srv = _serve(srv_name, stores[srv_name], "reactor", monkeypatch)
        try:
            got[side] = _client_results(
                TCP[client].TcpVolumeClient(), f"127.0.0.1:{srv.port}",
                ops)
        finally:
            srv.stop()
        # the second pass runs on the other store, from the same start
        monkeypatch.setattr(ref_volume_mod, "time", _PinnedTime())
        monkeypatch.setattr(port_volume_mod, "time", _PinnedTime())
    assert got["cross"] == got["same"]
    assert ("error", "KeyError: 'volume 9 not found'") in got["cross"]
    assert any(kind == "ok" and isinstance(v, list) and None in v
               for kind, v in got["cross"])


def test_torn_batch_frames_answer_alike(stores, monkeypatch):
    good = port_tcp.pack_fid_frames([("1,0101020304", b"abc")], True)
    frames = [_frame(b"P", "", good[:-1]), _frame(b"B", "", b"\x00\x05ab"),
              _frame(b"P", "", good), _frame(b"B", "", good[:2 + 12])]
    got = {}
    for name, st in stores.items():
        srv = _serve(name, st, "reactor", monkeypatch)
        try:
            got[name] = _answers(srv.port, frames, pipelined=False)
        finally:
            srv.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0].endswith(b"ValueError: truncated batch frame")


# --- the master's framed assign ----------------------------------------------

def test_a_follower_refuses_assign_and_upload_tcp_falls_back(tmp_path):
    """Two masters elect a leader.  The follower's framed front answers
    ``A`` with the reference's error frame; a client pointed at it falls
    back to HTTP (a 307 to the leader) and remembers it."""
    ports = [free_port(), free_port()]
    urls = [f"127.0.0.1:{p}" for p in ports]
    masters = [MasterServer(port=p, pulse_seconds=0.3,
                            peers=[u for u in urls if u != f"127.0.0.1:{p}"],
                            mdir=str(tmp_path / f"m{p}")).start()
               for p in ports]
    vs = None
    ref_master = RefMaster(port=free_port(), pulse_seconds=0.3,
                           peers=["127.0.0.1:1"]).start()
    try:
        deadline = time.time() + 20
        while time.time() < deadline and \
                not any(m.is_leader for m in masters):
            time.sleep(0.05)
        leader = next(m for m in masters if m.is_leader)
        follower = next(m for m in masters if m is not leader)
        d = tmp_path / "v"
        d.mkdir()
        vs = VolumeServer([str(d)], ",".join(urls), port=free_port(),
                          pulse_seconds=0.3, device="cpu").start()
        _wait_nodes(leader)
        frame = _frame(b"A", "", b"{}")
        answers = {name: _answers(ports_tcp, [frame], False)[0]
                   for name, ports_tcp in (
                       ("port", port_tcp.tcp_port_for(follower.port)),
                       ("ref", port_tcp.tcp_port_for(ref_master.port)))}
        assert answers["port"] == answers["ref"] == \
            b"\x01" + struct.pack(">I", 31) + \
            b"PermissionError: not the leader"
        # the leader assigns over its framed front
        led = json.loads(_answers(port_tcp.tcp_port_for(leader.port),
                                  [frame], False)[0][5:])
        assert led["url"] == vs.url and led["count"] == 1
        client = WeedClient(follower.url)
        fid = client.upload_tcp(b"via the follower")
        assert client._tcp_assign_ok is False
        assert client.download_tcp(fid) == b"via the follower"
        client = WeedClient(leader.url)
        fid = client.upload_tcp(b"via the leader")
        assert client._tcp_assign_ok is True
        assert client.download_tcp(fid) == b"via the leader"
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()
        ref_master.stop()


# --- degraded binds ----------------------------------------------------------

def test_the_degraded_binds_family_equals_the_references():
    exposed = []
    for reg, fam in (
            (ref_metrics.Registry(), None), (port_metrics.Registry(), None)):
        if isinstance(reg, ref_metrics.Registry):
            fam = ref_metrics.ECPipelineMetrics(reg).degraded_binds
        else:
            fam = port_metrics.DegradedBindMetrics(reg).degraded_binds
        fam.inc("volume-tcp")
        fam.inc("master-tcp", amount=2)
        text = reg.expose()
        exposed.append([line for line in text.splitlines()
                        if "degraded_binds" in line])
    assert exposed[0] == exposed[1] and len(exposed[0]) == 4


def test_a_port_collision_counts_a_degraded_bind(tmp_path):
    """Both framed ports taken: the master comes up without its assign
    front and the volume server, after 3 s of retries, without its
    plane; each counts a degraded bind and journals it, /status and the
    master's /cluster/health show it, and the HTTP plane serves on."""
    mport, vport = free_port(), free_port()
    holds = []
    for p in (mport, vport):
        # bound, not listening: a connect there is refused
        s = socket.socket()
        s.bind(("127.0.0.1", port_tcp.tcp_port_for(p)))
        holds.append(s)
    fam = degraded_bind_metrics().degraded_binds
    before = {r: fam.value(r) for r in ("volume-tcp", "master-tcp")}
    since = time.time()
    master = vs = None
    try:
        master = MasterServer(port=mport, pulse_seconds=0.3).start()
        assert not master._tcp_server.alive
        t0 = time.monotonic()
        vs = VolumeServer([str(tmp_path)], master.url, port=vport,
                          pulse_seconds=0.3, device="cpu").start()
        assert time.monotonic() - t0 >= 3.0
        assert not vs._tcp_server.alive
        assert {r: fam.value(r) - before[r] for r in before} == \
            {"volume-tcp": 1, "master-tcp": 1}
        evs = [e for e in get_journal().query(type_="degraded_bind")
               if e["ts"] >= since]
        assert sorted(e["details"]["role"] for e in evs) == \
            ["master-tcp", "volume-tcp"]
        st = http_json("GET", f"http://{vs.url}/status")
        assert st["EcPipeline"]["degraded_binds"] >= 2
        _wait_nodes(master)
        health = http_json("GET", f"http://{master.url}/cluster/health")
        assert health["totals"]["degraded_binds"] >= 2
        # the HTTP plane serves everything, the client falls back
        client = WeedClient(master.url)
        fid = client.upload_tcp(b"over http")
        assert client._tcp_assign_ok is False
        assert client.download_tcp(fid) == b"over http"
    finally:
        for s in holds:
            s.close()
        if vs is not None:
            vs.stop()
        if master is not None:
            master.stop()


# --- an EC volume over the framed plane --------------------------------------

def test_a_framed_read_of_an_ec_volume_answers_the_references_error(
        tmp_path, monkeypatch):
    """The store's framed R reads live volumes only: an EC volume's needle
    answers ``KeyError: 'volume 1 not found'`` in both packages, and no
    reconstruction runs."""
    got = {}
    for name in ("ref", "port"):
        d = tmp_path / name
        d.mkdir()
        if name == "ref":
            vs = RefVolumeServer([str(d)], "127.0.0.1:1", port=free_port(),
                                 pulse_seconds=60, ec_engine="cpu",
                                 heat=False, ledger=False).start()
        else:
            vs = VolumeServer([str(d)], "127.0.0.1:1", port=free_port(),
                              pulse_seconds=60, device="cpu").start()
            calls = []
            real = vs.store.read_ec_needle
            monkeypatch.setattr(vs.store, "read_ec_needle",
                                lambda *a, **k: calls.append(a)
                                or real(*a, **k))
        try:
            http_json("POST", f"http://{vs.url}/admin/assign_volume",
                      {"volume_id": 1})
            fid = "1,0a01020304"
            assert http_bytes("POST", f"http://{vs.url}/{fid}",
                              b"ec bytes" * 100)[0] == 201
            for path in ("/admin/ec/generate", "/admin/ec/mount",
                         "/admin/delete_volume"):
                http_json("POST", f"http://{vs.url}{path}",
                          {"volume_id": 1, "collection": "",
                           "shard_ids": list(range(14))})
            got[name] = _answers(port_tcp.tcp_port_for(vs.store.port),
                                 [_frame(b"R", fid),
                                  _frame(b"B", "", port_tcp.pack_fid_frames(
                                      [fid], False))], False)
            # the HTTP plane reads it through EC
            assert http_bytes("GET", f"http://{vs.url}/{fid}")[1] == \
                b"ec bytes" * 100
        finally:
            vs.stop()
    assert got["port"] == got["ref"]
    msg = b"KeyError: 'volume 1 not found'"
    assert got["port"][0] == b"\x01" + struct.pack(">I", len(msg)) + msg
    assert len(calls) == 1  # the HTTP GET's; the frames ran none


# --- the HTTP plane's batches ------------------------------------------------

def _batch_server(name: str, d, master_url: str = "127.0.0.1:1"):
    if name == "ref":
        return RefVolumeServer([str(d)], master_url, port=free_port(),
                               pulse_seconds=60, ec_engine="cpu",
                               heat=False, ledger=False).start()
    return VolumeServer([str(d)], master_url, port=free_port(),
                        pulse_seconds=60, device="cpu").start()


def test_batch_routes_answer_like_the_references(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    items = [(f"1,{k:x}{int(rng.integers(1, 1 << 32)):08x}",
              rng.bytes(int(rng.integers(0, 3000)))) for k in range(1, 31)]
    body = port_tcp.pack_fid_frames(items, True)
    fids = [f for f, _ in items]
    got = {}
    for name in ("ref", "port"):
        d = tmp_path / name
        d.mkdir()
        vs = _batch_server(name, d)
        try:
            http_json("POST", f"http://{vs.url}/admin/assign_volume",
                      {"volume_id": 1})
            out = []
            # torn: 400, nothing written
            st, b, _ = http_bytes("POST", f"http://{vs.url}/batch/write",
                                  body[:-1])
            out.append((st, json.loads(b)))
            st, b, h = http_bytes("POST", f"http://{vs.url}/batch/read",
                                  json.dumps({"fids": fids}).encode())
            out.append((st, b, h.get("X-Batch-Count")))
            st, b, _ = http_bytes(
                "POST", f"http://{vs.url}/batch/write",
                body + port_tcp.pack_fid_frames([("9,0102", b"x"),
                                                 ("bad", b"")], True))
            out.append((st, json.loads(b)))
            st, b, _ = http_bytes(
                "POST", f"http://{vs.url}/batch/read",
                json.dumps({"fids": fids + ["9,0102", "bad"]}).encode())
            out.append((st, b))
            for bad in ({"fids": "1,01"}, {"fids": ["1,01"] * 10001}):
                st, _, _ = http_bytes("POST", f"http://{vs.url}/batch/read",
                                      json.dumps(bad).encode())
                out.append(st)
            got[name] = out
        finally:
            vs.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == 400
    # after the torn write, every fid read back a per-fid failure
    assert got["port"][1][1].count(b"\x01") >= len(fids)
    assert got["port"][2][0] == 200 and got["port"][4] == 400


def _parse_batch(payload: bytes) -> list:
    out, i = [], 0
    while i < len(payload):
        n = struct.unpack(">I", payload[i + 1:i + 5])[0]
        out.append(payload[i + 5:i + 5 + n] if payload[i] == 0 else None)
        i += 5 + n
    return out


def test_batch_write_and_framed_writes_reach_the_replica(tmp_path):
    """A 001 volume on two servers: /batch/write and framed W and D reach
    the replica; a fid the replica fails fails the whole batch."""
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    servers = []
    try:
        for k in range(2):
            d = tmp_path / f"v{k}"
            d.mkdir()
            servers.append(VolumeServer([str(d)], master.url,
                                        port=free_port(), pulse_seconds=0.3,
                                        device="cpu").start())
        _wait_nodes(master, 2)
        vid = http_json("GET", f"http://{master.url}/vol/grow?"
                               f"replication=001&count=1")["volumeIds"][0]
        a, b = servers
        items = [(f"{vid},{k:x}0a0b0c0d", bytes([k]) * (100 + k))
                 for k in range(1, 11)]
        st, body, _ = http_bytes("POST", f"http://{a.url}/batch/write",
                                 port_tcp.pack_fid_frames(items, True))
        assert st == 200
        assert [r["status"] for r in json.loads(body)["results"]] == \
            [201] * 10
        st, body, _ = http_bytes(
            "POST", f"http://{b.url}/batch/read",
            json.dumps({"fids": [f for f, _ in items]}).encode())
        assert _parse_batch(body) == [d for _, d in items]
        tcp = port_tcp.TcpVolumeClient()
        fid = f"{vid},ff0a0b0c0d"
        tcp.write(port_tcp.tcp_address(a.url), fid, b"framed")
        assert tcp.read(port_tcp.tcp_address(b.url), fid) == b"framed"
        tcp.delete(port_tcp.tcp_address(a.url), fid)
        with pytest.raises(OSError, match="NotFoundError|DeletedError"):
            tcp.read(port_tcp.tcp_address(b.url), fid)
        # the replica refuses its copies: the batch fails loudly
        b.store.volumes[vid].read_only = True
        st, body, _ = http_bytes("POST", f"http://{a.url}/batch/write",
                                 port_tcp.pack_fid_frames(items[:3], True))
        assert st == 500 and b"failed on the replica" in body
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


# --- benchmark -useTcp and the fids files ------------------------------------

def _bench_args(master_url: str, **kw) -> argparse.Namespace:
    base = dict(master=master_url, n=60, size=512, c=4, useTcp=True,
                phase="both", fidsFile="", collection="benchmark",
                replication="000", deletePercent=0, readSequentially=False,
                seed=port_cli.BENCH_SEED, zipf=40, json=True)
    base.update(kw)
    return argparse.Namespace(**base)


def test_benchmark_over_tcp_assigns_over_the_framed_front(pair):
    master, _vs = pair
    assigns = master.metrics.request_counter
    before = assigns.value("assign")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_cli.cmd_benchmark(_bench_args(master.url)) == 0
    passes = {d["pass"]: d for d in map(json.loads, (
        line for line in buf.getvalue().splitlines()
        if line.startswith("{")))}
    assert {k: (v["n"], v["mismatches"]) for k, v in passes.items()} == \
        {"write": (60, 0), "read": (60, 0), "zipf": (40, 0)}
    # every assign went over the framed front: no HTTP /dir/assign
    assert assigns.value("assign") == before


def _run_ref_benchmark(args) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        weed.cmd_benchmark(args)


def test_a_reference_fids_file_feeds_a_port_read(pair, tmp_path):
    """weed.py's -phase write (bare fids, its one payload) against a port
    cluster, then the port's -phase read of its file: every needle is
    held to the reference's payload, so a needle overwritten since fails
    the pass."""
    master, vs = pair
    fids_file = str(tmp_path / "ref.fids")
    _run_ref_benchmark(_bench_args(master.url, useTcp=False, n=30, size=700,
                                   phase="write", fidsFile=fids_file))
    lines = open(fids_file).read().splitlines()
    assert len(lines) == 30 and all(" " not in ln for ln in lines)
    assert {pid for _, pid in port_cli.read_fids_file(fids_file)} == {None}
    for use_tcp in (False, True):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert port_cli.cmd_benchmark(_bench_args(
                master.url, useTcp=use_tcp, size=700, phase="read",
                fidsFile=fids_file, zipf=0)) == 0
        assert '"mismatches": 0' in buf.getvalue()
    # a byte check, not a status check
    port_tcp.TcpVolumeClient().write(port_tcp.tcp_address(vs.url),
                                     lines[0], b"\x00" * 700)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit, match="1 answers differ"):
            port_cli.cmd_benchmark(_bench_args(
                master.url, size=700, phase="read", fidsFile=fids_file,
                zipf=0))


def test_a_port_fids_file_does_not_feed_a_reference_read(pair, tmp_path):
    """Kept on purpose: the port writes a payload of its own per needle
    and a ``fid id`` line, so the reference's read of the port's file
    fails, and fails on the bytes even with the ids stripped."""
    master, _vs = pair
    fids_file = str(tmp_path / "port.fids")
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli.cmd_benchmark(_bench_args(
            master.url, n=20, size=256, phase="write",
            fidsFile=fids_file)) == 0
    ref_args = _bench_args(master.url, useTcp=False, size=256, phase="read",
                           fidsFile=fids_file)
    with pytest.raises(Exception):
        _run_ref_benchmark(ref_args)
    bare = str(tmp_path / "bare.fids")
    with open(bare, "w") as f:
        f.write("\n".join(fid for fid, _ in
                          port_cli.read_fids_file(fids_file)))
    with pytest.raises(AssertionError):
        _run_ref_benchmark(_bench_args(master.url, useTcp=False, size=256,
                                       phase="read", fidsFile=bare))
