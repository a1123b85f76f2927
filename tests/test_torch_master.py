"""The port's master against the reference's, answer for answer.

One scripted transcript of full and delta heartbeats (EC shards
included), assigns that grow volumes under every placement, lookups,
``/dir/lookup_ec``, ``/dir/status``, ``/vol/grow``, ``/vol/status``,
``/col/delete``, ``/submit`` with its redirect, and the admin lease goes
to seaweedfs_tpu's MasterServer and to the port's, each in front of the
same stub volume servers.  Status, body and the headers a client reads
must be equal byte for byte, and so must the calls the stubs received.
Three values come from ``secrets`` and are masked first: the fid cookie,
the lease token and ``lock_ts_ns``.  The global ``random`` the reference
draws from and the port master's own ``random.Random`` get one seed, so
volume choice, growth placement and the assigned node agree.

Topology, volume growth and the sequencers are also held against the
reference's directly, as parametrised cases.
"""

from __future__ import annotations

import json
import random
import re
import threading

import pytest

import seaweedfs_tpu.master.sequence as ref_sequence
import seaweedfs_tpu.master.topology as ref_topology
import seaweedfs_tpu.master.volume_growth as ref_growth
import seaweedfs_tpu_torch.master.sequence as sequence
import seaweedfs_tpu_torch.master.topology as topology
import seaweedfs_tpu_torch.master.volume_growth as growth
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.storage.super_block import \
    ReplicaPlacement as RefReplicaPlacement
from seaweedfs_tpu.storage.ttl import TTL as RefTTL
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.utils.httpd import (Request, Response, Router,
                                             http_bytes, serve, stop_server)
from tests.conftest import free_port

SEED = 20261016
LIMIT_MB = 64
# (data center, rack) of the four stub volume servers
PLACES = [("dc1", "rackA"), ("dc1", "rackA"), ("dc1", "rackB"),
          ("dc2", "rackC")]


class StubVolumeServer:
    """Answers the master's calls to a volume server and records them."""

    def __init__(self, calls: list, lock: threading.Lock, index: int):
        router = Router("stub")

        def record(req: Request) -> Response:
            body = req.body or b""
            if req.path.startswith("/admin/"):
                detail = json.loads(body) if body else {}
            else:
                detail = {"bytes": len(body),
                          "type": req.headers.get("Content-Type", "")}
            with lock:
                calls.append([index, req.handler.command, req.path, detail])
            if req.path.startswith("/admin/"):
                return Response({})
            return Response({"size": len(body)}, status=201)

        for path in ("/admin/assign_volume", "/admin/delete_volume",
                     "/admin/ec/delete"):
            router.route("POST", path)(record)
        router.route("POST", r"/(\d+),([0-9a-f]+)")(record)
        self.port = free_port()
        self.url = f"127.0.0.1:{self.port}"
        self._server = serve(router, "127.0.0.1", self.port)

    def stop(self) -> None:
        stop_server(self._server)


@pytest.fixture(scope="module")
def stubs():
    calls: list = []
    lock = threading.Lock()
    servers = [StubVolumeServer(calls, lock, i) for i in range(len(PLACES))]
    yield servers, calls
    for s in servers:
        s.stop()


def _volume(vid: int, collection: str = "", size: int = 1000, rp: int = 0,
            read_only: bool = False, max_file_key: int = 0) -> dict:
    return {"id": vid, "size": size, "collection": collection,
            "file_count": 3, "delete_count": 1, "deleted_byte_count": 10,
            "read_only": read_only, "replica_placement": rp, "version": 3,
            "ttl": 0, "compact_revision": 0, "modified_at_second": 1700000000,
            "max_file_key": max_file_key}


def _ec(vid: int, shard_ids, collection: str = "ec") -> dict:
    bits = 0
    for sid in shard_ids:
        bits |= 1 << sid
    return {"volume_id": vid, "collection": collection, "ec_index_bits": bits}


def _full(stub, i: int, volumes: list, ec_shards: list) -> dict:
    dc, rack = PLACES[i]
    return {"ip": "127.0.0.1", "port": stub.port, "public_url": stub.url,
            "data_center": dc, "rack": rack, "max_volume_count": 6,
            "volumes": volumes, "ec_shards": ec_shards}


def _delta(stub, **changes) -> dict:
    return {"ip": "127.0.0.1", "port": stub.port, "delta": True, **changes}


def _multipart(name: str, mime: str, data: bytes) -> tuple[bytes, str]:
    boundary = "torchmasterboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: {mime}\r\n\r\n").encode() \
        + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def transcript(master: str, stubs) -> list:
    """The script; -> [(request, status, body, Location, Content-Type)]."""
    s = stubs
    out = []

    def req(method: str, path: str, payload=None, raw: bytes = None,
            ctype: str = ""):
        body = raw if raw is not None else (
            json.dumps(payload).encode() if payload is not None else None)
        headers = {"Content-Type": ctype} if ctype else None
        status, rbody, rheaders = http_bytes(
            method, f"http://{master}{path}", body, headers=headers,
            timeout=30.0, follow_redirects=False)
        out.append((f"{method} {path}", status, rbody,
                    rheaders.get("Location", ""),
                    rheaders.get("Content-Type", "")))
        return status, rbody

    def hb(doc: dict):
        return req("POST", "/heartbeat", doc)

    req("GET", "/dir/status")
    req("GET", "/dir/assign")  # no volume server yet
    hb(_full(s[0], 0, [_volume(1, max_file_key=50)], [_ec(7, range(0, 5))]))
    hb(_full(s[1], 1, [_volume(2, "pics"), _volume(3, "pics")],
             [_ec(7, range(5, 10))]))
    hb(_full(s[2], 2, [_volume(4, size=LIMIT_MB << 20)],
             [_ec(7, range(10, 14))]))
    hb(_full(s[3], 3, [_volume(5, read_only=True)], []))
    req("GET", "/dir/status")
    for q in ("", "?count=3", "?collection=pics&count=2",
              "?collection=pics", "?collection=pics", "?collection=new",
              "?replication=001", "?replication=010", "?replication=100",
              "?replication=011", "?replication=200", "?ttl=3d",
              "?count=abc"):
        req("GET", f"/dir/assign{q}")
    for q in ("1", "1,0123abcd", "99", "7", "2&collection=pics",
              "2&collection=other"):
        req("GET", f"/dir/lookup?volumeId={q}")
    for q in ("7", "99", "abc"):
        req("GET", f"/dir/lookup_ec?volumeId={q}")
    # deltas: a new volume and a deleted one, shards moving between nodes
    hb(_delta(s[0], new_volumes=[_volume(9, max_file_key=900)],
              deleted_volumes=[1], new_ec_shards=[_ec(7, range(0, 7))],
              deleted_ec_shards=[]))
    hb(_delta(s[1], new_volumes=[], deleted_volumes=[],
              new_ec_shards=[_ec(7, range(7, 10))], deleted_ec_shards=[]))
    hb(_delta(s[2], new_volumes=[], deleted_volumes=[4],
              new_ec_shards=[], deleted_ec_shards=[7]))
    hb({"ip": "127.0.0.1", "port": 1, "delta": True, "new_volumes": []})
    req("GET", "/dir/lookup_ec?volumeId=7")
    req("GET", "/dir/lookup?volumeId=1")
    req("GET", "/dir/assign")  # keys continue above the largest seen
    req("GET", "/dir/status")
    for q in ("collection=g&count=2", "collection=g&replication=001",
              "replication=200", "count=0"):
        req("GET", f"/vol/grow?{q}")
    req("GET", "/vol/status")
    req("GET", "/cluster/status")
    # /submit, then the redirect to the holder of what it wrote
    body, ctype = _multipart("hello.txt", "text/plain", b"hello master")
    status, rbody = req("POST", "/submit", raw=body, ctype=ctype)
    fid = json.loads(rbody)["fid"] if status == 201 else "3,01"
    req("GET", f"/{fid}?readDeleted=true")
    req("HEAD", f"/{fid}")
    req("GET", "/77,0100000000")
    # /col/delete of a plain collection, an EC one and a missing one
    req("GET", "/col/delete?collection=pics")
    req("POST", "/col/delete?collection=ec")
    req("GET", "/col/delete?collection=nope")
    req("GET", "/dir/status")
    # the admin lease: taken, refused to another, renewed with the token,
    # a stale release ignored, released, taken again
    status, rbody = req("POST", "/admin/lease", {"client_name": "shell"})
    token = json.loads(rbody)["token"]
    req("POST", "/admin/lease", {"client_name": "other"})
    status, rbody = req("POST", "/admin/lease", {"client_name": "shell",
                                                 "previous_token": token})
    renewed = json.loads(rbody)["token"]
    req("POST", "/admin/release", {"previous_token": token})
    req("POST", "/admin/lease", {"client_name": "other"})
    req("POST", "/admin/release", {"previous_token": renewed})
    req("POST", "/admin/lease", {"client_name": "other"})
    return out


def _mask_fid(text: bytes) -> bytes:
    # a fid is "<vid>,<key hex><8 hex cookie>"
    return re.sub(rb"(\d+,[0-9a-f]+?)[0-9a-f]{8}(?=[\"/?]|$)",
                  rb"\1<cookie>", text)


def _mask(entries: list, master: str, tokens: dict) -> list:
    """Mask the master's own address, fid cookies, lease tokens (each
    distinct token gets a stable name) and lock_ts_ns."""
    masked = []

    def token_name(m):
        return b'"token": "T%d"' % tokens.setdefault(m.group(1),
                                                     len(tokens))

    for what, status, body, location, ctype in entries:
        body = body.replace(master.encode(), b"MASTER")
        body = re.sub(rb'"token": ?(\d+)', token_name, body)
        body = re.sub(rb'"lock_ts_ns": ?\d+', b'"lock_ts_ns": 0', body)
        body = _mask_fid(body)
        masked.append((_mask_fid(what.encode()), status, body,
                       _mask_fid(location.replace(master, "MASTER").encode()),
                       ctype))
    return masked


def _run(make_master, stubs) -> tuple[list, list]:
    servers, calls = stubs
    calls.clear()
    master = make_master().start()
    # after start: the reference's start-up draws from the global random
    random.seed(SEED)
    if isinstance(master, MasterServer):
        master.topo.rng.seed(SEED)
    try:
        entries = transcript(master.url, servers)
    finally:
        master.stop()
    # an upload's path carries the fid, cookie and all
    return _mask(entries, master.url, {}), [
        [i, method, _mask_fid(path.encode()), detail]
        for i, method, path, detail in calls]


def test_port_master_answers_as_the_reference(stubs):
    kw = dict(volume_size_limit_mb=LIMIT_MB, pulse_seconds=3600)
    want, want_calls = _run(lambda: RefMasterServer(port=free_port(), **kw),
                            stubs)
    got, got_calls = _run(lambda: MasterServer(port=free_port(), **kw),
                          stubs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # /cluster/status too: a single master's raft view, leader with
        # no peers, is the reference's key for key
        assert g == w, w[0].decode()
    # the stubs saw the same growth, uploads and deletes, in order
    assert [c[1:] for c in got_calls] == [c[1:] for c in want_calls]
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls]
    # the script reached every branch it meant to
    statuses = {w[0].decode().split("?")[0]: w[1] for w in want}
    assert statuses["POST /submit"] == 201
    assert any(w[1] == 308 for w in want)
    assert any(w[1] == 423 for w in want)
    assert {c[2] for c in want_calls} >= {b"/admin/assign_volume",
                                         b"/admin/delete_volume",
                                         b"/admin/ec/delete"}


def test_janitor_drops_a_silent_volume_server(stubs):
    servers, _ = stubs
    master = MasterServer(port=free_port(), pulse_seconds=0.05).start()
    try:
        http_bytes("POST", f"http://{master.url}/heartbeat", json.dumps(
            _full(servers[0], 0, [_volume(1)], [_ec(7, [0, 1])])).encode(),
            timeout=30.0)
        assert master.topo.lookup(1)
        deadline = threading.Event()
        for _ in range(200):
            if not master.topo.all_nodes():
                break
            deadline.wait(0.01)
        assert not master.topo.all_nodes()
        assert master.topo.lookup(1) == []
        assert master.topo.lookup_ec_shards(7) is None
    finally:
        master.stop()


# --- topology, growth and sequencers, case by case ---------------------------

def _both_topologies(seed: int):
    random.seed(seed)
    port = topology.Topology(LIMIT_MB << 20, 5.0)
    port.rng.seed(seed)
    return ref_topology.Topology(LIMIT_MB << 20, 5.0), port


def _populate(mod, topo, nodes_per_rack=(2, 1, 3), dcs=2) -> list:
    nodes = []
    for d in range(dcs):
        for r, count in enumerate(nodes_per_rack):
            for k in range(count):
                port = 8000 + 100 * d + 10 * r + k
                nodes.append(topo.register_node(
                    "10.0.0.1", port, "", f"dc{d}", f"rack{r}", 3 + k))
    for i, node in enumerate(nodes):
        vols = [mod.VolumeInfo.from_dict(_volume(
            10 * i + j, ["", "a"][j % 2], size=(j + 1) * 1000,
            read_only=(i + j) % 5 == 0)) for j in range(i % 3)]
        topo.sync_node_volumes(node, vols)
        topo.sync_node_ec_shards(node, [mod.EcVolumeInfo(
            500, "ec", mod.ShardBits(0x3FFF & (0b111 << (i % 12))))])
    return nodes


def _topology_ops(mod, topo, nodes) -> list:
    """Deltas, EC moves and a node loss; -> to_map after each step."""
    maps = [topo.to_map()]
    topo.apply_volume_deltas(nodes[0], [mod.VolumeInfo.from_dict(
        _volume(900, "a", max_file_key=5))], [1, 2])
    maps.append(topo.to_map())
    topo.apply_ec_deltas(nodes[1], [mod.EcVolumeInfo(
        500, "ec", mod.ShardBits(0b1111))], [])
    topo.apply_ec_deltas(nodes[2], [], [500])
    maps.append(topo.to_map())
    topo.unregister_node(nodes[3])
    maps.append(topo.to_map())
    maps.append({"lookup": [n.url for n in topo.lookup(500)],
                 "lookup_ec": {s: [n.url for n in ns] for s, ns in
                               (topo.lookup_ec_shards(500) or {}).items()},
                 "lookup_a": [n.url for n in topo.lookup(900, "a")],
                 "missing": topo.lookup_ec_shards(12345)})
    nodes[4].last_seen -= 60
    maps.append([n.url for n in topo.dead_nodes()])
    return maps


def _growth(mod, gmod, topo, rp_mod, ttl_mod, rp: str, preferred: str):
    calls = []
    try:
        vids = gmod.grow_volume(
            topo, "c", rp_mod.parse(rp), ttl_mod.parse(""),
            lambda node, vid, *a: calls.append((node.url, vid, *a)),
            preferred_dc=preferred, count=2)
    except LookupError as e:
        return ("error", str(e), calls)
    layout = topo.get_layout("c", rp_mod.parse(rp), ttl_mod.parse(""))
    picks = [layout.pick_for_write()[0] for _ in range(5)]
    return (vids, calls, picks, topo.to_map())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_topology_equals_the_reference(seed):
    ref, port = _both_topologies(seed)
    want = _topology_ops(ref_topology, ref, _populate(ref_topology, ref))
    got = _topology_ops(topology, port, _populate(topology, port))
    assert got == want


@pytest.mark.parametrize("rp,preferred", [
    ("000", ""), ("001", ""), ("010", ""), ("100", ""), ("011", ""),
    ("110", ""), ("002", "dc1"), ("020", ""), ("200", ""), ("000", "dc0")])
@pytest.mark.parametrize("seed", [5, 6])
def test_volume_growth_equals_the_reference(rp, preferred, seed):
    ref, port = _both_topologies(seed)
    _populate(ref_topology, ref)
    _populate(topology, port)
    random.seed(seed)
    want = _growth(ref_topology, ref_growth, ref, RefReplicaPlacement,
                   RefTTL, rp, preferred)
    got = _growth(topology, growth, port, ReplicaPlacement, TTL, rp,
                  preferred)
    assert got == want


def _sequence(seq) -> list:
    out = [seq.next_file_id(), seq.next_file_id(5), seq.next_file_id(1)]
    seq.set_max(100)
    out += [seq.next_file_id(2), seq.peek()]
    seq.set_max(50)
    out += [seq.next_file_id(), seq.peek()]
    return out


@pytest.mark.parametrize("kind", ["MemorySequencer", "SnowflakeSequencer"])
def test_sequencer_equals_the_reference(kind, monkeypatch):
    # the snowflake sequencer reads the clock: both read the same instant
    for mod in (ref_sequence, sequence):
        monkeypatch.setattr(mod.time, "time", lambda: 1760000000.123)
    assert _sequence(getattr(sequence, kind)()) == \
        _sequence(getattr(ref_sequence, kind)())
