"""The port's location watch against the reference's, on the CPU:
``Topology``'s location broadcast, ``/cluster/watch``, the push-updated
client (seaweedfs_tpu_torch/client/wdclient.py), ``WeedClient
(keep_connected=True)`` and ``master.follower``.

- Both packages' Topology, driven by one sequence of registrations,
  heartbeats, deltas, EC shard changes, a growth and a node's loss, emit
  the same location events and snapshots, and answer the same long-poll
  documents.
- The five tests of tests/test_wdclient.py, on a port master and port
  volume servers (``device="cpu"``).
- A port WdClient and a reference WdClient follow a port master and a
  reference master: all four end with the master's map.
- ``python -m seaweedfs_tpu_torch master.follower`` answers /dir/lookup as
  the master does for plain and EC volumes and 307 to /dir/assign; a
  ``WeedClient(keep_connected=True)`` reads through pushed locations.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu.client.wdclient import VidMap as RefVidMap
from seaweedfs_tpu.client.wdclient import WdClient as RefWdClient
from seaweedfs_tpu.master import topology as ref_topology
from seaweedfs_tpu.master import volume_growth as ref_growth
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.storage.super_block import \
    ReplicaPlacement as RefReplicaPlacement
from seaweedfs_tpu.storage.ttl import TTL as RefTTL
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.client.wdclient import Location, VidMap, WdClient
from seaweedfs_tpu_torch.master import topology as port_topology
from seaweedfs_tpu_torch.master import volume_growth as port_growth
from seaweedfs_tpu_torch.master.follower import MasterFollower
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(what: str, ok, timeout: float = 15.0):
    t0 = time.monotonic()
    while True:
        got = ok()
        if got:
            return got
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


# --- the broadcast, both packages --------------------------------------------

def _topology_story(topo_mod, growth_mod, rp_cls, ttl_cls, seed_rng) -> dict:
    """One sequence of topology changes; the events, snapshots and
    long-poll answers along it."""
    topo = topo_mod.Topology(volume_size_limit=1 << 30, pulse_seconds=1.0)
    vi = topo_mod.VolumeInfo
    ec = topo_mod.EcVolumeInfo
    bits = topo_mod.ShardBits
    nodes = [topo.register_node("127.0.0.1", 8080 + i,
                                dc=f"dc{i % 2}", rack=f"r{i}",
                                max_volume_count=4) for i in range(3)]
    answers = [topo.watch_locations(0, timeout=0.0)]
    topo.sync_node_volumes(nodes[0], [vi(id=1), vi(id=2, collection="c")])
    answers.append(topo.watch_locations(0, timeout=0.0))
    topo.sync_node_volumes(nodes[1], [vi(id=1)])
    topo.apply_volume_deltas(nodes[1], [vi(id=3)], [1])
    topo.apply_volume_deltas(nodes[2], [vi(id=3), vi(id=3)], [9])
    answers.append(topo.watch_locations(2, timeout=0.0))
    topo.sync_node_ec_shards(nodes[0], [ec(7, "ec", bits(0b111))])
    topo.sync_node_ec_shards(nodes[1], [ec(7, "ec", bits(0b111000))])
    topo.apply_ec_deltas(nodes[2], [ec(7, "ec", bits(0b1 << 13))], [])
    topo.sync_node_ec_shards(nodes[0], [ec(7, "ec", bits(0b11))])
    topo.apply_ec_deltas(nodes[1], [], [7])
    seed_rng(topo)
    growth_mod.grow_volume(topo, "g", rp_cls.parse("000"),
                           ttl_cls.parse(""),
                           lambda *_a: None, count=2)
    mid = topo.location_seq
    topo.unregister_node(nodes[0])
    answers.append(topo.watch_locations(mid, timeout=0.0))
    answers.append(topo.watch_locations(topo.location_seq, timeout=0.05))
    answers.append(topo.watch_locations(topo.location_seq + 5, timeout=0.0))
    return {"events": list(topo._loc_events), "answers": answers,
            "snapshot": topo.location_snapshot(), "seq": topo.location_seq}


def test_the_location_broadcast_is_the_references():
    def ref_seed(_topo):
        random.seed(11)

    def port_seed(topo):
        topo.rng.seed(11)

    ref = _topology_story(ref_topology, ref_growth, RefReplicaPlacement,
                          RefTTL, ref_seed)
    port = _topology_story(port_topology, port_growth, ReplicaPlacement,
                           TTL, port_seed)
    assert port == ref
    kinds = {(e["op"], e["kind"]) for e in port["events"]}
    assert kinds == {("add", "volume"), ("del", "volume"), ("add", "ec"),
                     ("del", "ec")}


def test_a_watch_that_fell_off_the_history_gets_a_snapshot(monkeypatch):
    topo = port_topology.Topology()
    topo._loc_events = port_topology.deque(maxlen=4)
    node = topo.register_node("127.0.0.1", 9000)
    topo.sync_node_volumes(node, [port_topology.VolumeInfo(id=v)
                                  for v in range(1, 9)])
    doc = topo.watch_locations(1, timeout=0.0)
    assert set(doc) == {"volumes", "ec_volumes", "seq"} and doc["seq"] == 8
    assert [e["vid"] for e in topo.watch_locations(5, 0.0)["events"]] == \
        [6, 7, 8]


# --- tests/test_wdclient.py on the port --------------------------------------

def test_vid_map_events_and_same_dc_preference():
    for cls in (VidMap, RefVidMap):
        vm = cls(data_center="dc1")
        vm.apply_snapshot({"volumes": {
            "1": [{"url": "a:1", "data_center": "dc2"},
                  {"url": "b:1", "data_center": "dc1"}]}, "seq": 5})
        assert [x.data_center for x in vm.lookup(1)] == ["dc1", "dc2"]
        vm.apply_event({"op": "add", "vid": 1, "url": "c:1",
                        "data_center": "dc1"})
        assert len(vm.lookup(1)) == 3
        vm.apply_event({"op": "add", "vid": 1, "url": "c:1",
                        "data_center": "dc1"})
        assert len(vm.lookup(1)) == 3  # a second add changes nothing
        vm.apply_event({"op": "del", "vid": 1, "url": "a:1"})
        assert {x.url for x in vm.lookup(1)} == {"b:1", "c:1"}
        vm.apply_event({"op": "del", "vid": 1, "url": "b:1"})
        vm.apply_event({"op": "del", "vid": 1, "url": "c:1"})
        assert vm.lookup(1) == [] and not vm.has(1)
        vm.apply_event({"op": "add", "vid": 7, "url": "e:1", "kind": "ec"})
        assert vm.lookup_file_id("7,abc") == ["e:1"]
    assert Location("a:1", "a:1", "dc1") == Location("a:1", "a:1", "dc1")


@pytest.fixture
def cluster(tmp_path):
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vols = []
    for i in range(2):
        d = tmp_path / f"vs{i}"
        d.mkdir()
        vols.append(VolumeServer([str(d)], master.url, port=free_port(),
                                 pulse_seconds=0.3, data_center=f"dc{i}",
                                 device="cpu").start())
    _wait("two servers", lambda: len(master.topo.all_nodes()) == 2, 5)
    yield master, vols
    for v in vols:
        v.stop()
    master.stop()


def test_wdclient_snapshot_and_live_deltas(cluster):
    master, _ = cluster
    pre = http_json("GET", f"http://{master.url}/vol/grow?count=1")
    wd = WdClient(master.url, poll_timeout=2.0).start()
    try:
        assert wd.wait_synced(5)
        _wait("the snapshot's volume",
              lambda: wd.vid_map.has(pre["volumeIds"][0]), 5)
        new_vid = http_json("GET", f"http://{master.url}/vol/grow?count=1"
                            )["volumeIds"][0]
        _wait("the delta's volume", lambda: wd.vid_map.has(new_vid), 5)
        assert wd.lookup(new_vid)
    finally:
        wd.stop()


def test_wdclient_sees_node_death(cluster):
    master, vols = cluster
    http_json("GET", f"http://{master.url}/vol/grow?count=2")
    wd = WdClient(master.url, poll_timeout=2.0).start()
    try:
        assert wd.wait_synced(5)
        victim = vols[1].url
        vols[1].stop()

        def gone():
            return not any(
                victim in [x.url for x in wd.vid_map.lookup(vid)]
                for vid in range(1, master.topo.max_volume_id + 1))

        _wait("the dead server's volumes to leave the map", gone, 10)
    finally:
        wd.stop()


def test_watch_snapshot_fallback_when_history_pruned(cluster):
    master, _ = cluster
    http_json("GET", f"http://{master.url}/vol/grow?count=1")
    r = http_json("GET", f"http://{master.url}/cluster/watch?since_seq=0")
    assert "volumes" in r and r["leader"] == master.url
    r2 = http_json("GET", f"http://{master.url}/cluster/watch?"
                   f"since_seq={max(0, r['seq'] - 100000)}")
    assert "volumes" in r2 or r2.get("events") is not None
    t0 = time.time()
    r3 = http_json("GET", f"http://{master.url}/cluster/watch?"
                   f"since_seq={r['seq']}&timeout=0.5")
    assert r3.get("events") == [] and time.time() - t0 >= 0.4
    # malformed cursors answer 400, as every port route's query does
    st, _, _ = http_bytes(
        "GET", f"http://{master.url}/cluster/watch?since_seq=x")
    assert st == 400


def test_master_follower_serves_lookups(tmp_path):
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    d = tmp_path / "v"
    d.mkdir()
    vs = VolumeServer([str(d)], master.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    _wait("the server", lambda: master.topo.all_nodes(), 5)
    fid = WeedClient(master.url).upload(b"follow me")
    vid = fid.split(",")[0]
    follower = MasterFollower(master.url, port=free_port()).start()
    try:
        assert follower.wd.wait_synced(5.0)
        r = http_json("GET",
                      f"http://{follower.url}/dir/lookup?volumeId={vid}")
        assert r["locations"][0]["url"] == vs.url
        st, _, _ = http_bytes(
            "GET", f"http://{follower.url}/dir/lookup?volumeId=999999")
        assert st == 404
        st, _, hdrs = http_bytes("GET", f"http://{follower.url}/dir/assign",
                                 follow_redirects=False)
        assert st == 307 and master.url in hdrs.get("Location", "")
        assert "fid" in http_json("GET",
                                  f"http://{follower.url}/dir/assign")
        st = http_json("GET", f"http://{follower.url}/dir/status")
        assert st == {"IsFollower": True, "Leader": master.url,
                      "Synced": True}
    finally:
        follower.stop()
        vs.stop()
        master.stop()


# --- the clients across packages ---------------------------------------------

def test_each_package_s_client_follows_each_package_s_master(tmp_path):
    for kind in ("ref", "port"):
        cls = RefMasterServer if kind == "ref" else MasterServer
        master = cls(port=free_port(), pulse_seconds=0.3).start()
        vols = []
        clients = []
        try:
            for i in range(2):
                d = tmp_path / f"{kind}{i}"
                d.mkdir()
                vols.append(VolumeServer(
                    [str(d)], master.url, port=free_port(),
                    pulse_seconds=0.3, data_center=f"dc{i}",
                    device="cpu").start())
            _wait("two servers", lambda: len(master.topo.all_nodes()) == 2)
            http_json("GET", f"http://{master.url}/vol/grow?count=2")
            clients = [RefWdClient(master.url, poll_timeout=1.0).start(),
                       WdClient(master.url, poll_timeout=1.0).start()]
            for c in clients:
                assert c.wait_synced(5)
            http_json("GET", f"http://{master.url}/vol/grow?count=2"
                      "&collection=late")
            vols[0].stop()

            def maps():
                want = master.topo.location_snapshot()
                got = []
                for c in clients:
                    vm = c.vid_map
                    with vm._lock:
                        vols_ = {str(v): sorted(x.url for x in locs)
                                 for v, locs in vm._vols.items()}
                    got.append(vols_)
                want_vols = {v: sorted(x["url"] for x in locs)
                             for v, locs in want["volumes"].items()}
                return all(g == want_vols for g in got) and got

            got = _wait("both clients to hold the master's map", maps, 15)
            assert len(got[0]) == 4
        finally:
            for c in clients:
                c.stop()
            for v in vols:
                v.stop()
            master.stop()


def test_cli_follower_and_a_keep_connected_client(tmp_path):
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vols = []
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master.follower",
         "-masters", master.url, "-port", str(port)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    client = None
    try:
        for i in range(2):
            d = tmp_path / f"v{i}"
            d.mkdir()
            vols.append(VolumeServer([str(d)], master.url, port=free_port(),
                                     pulse_seconds=0.3,
                                     device="cpu").start())
        _wait("two servers", lambda: len(master.topo.all_nodes()) == 2)
        client = WeedClient(master.url, keep_connected=True)
        data = {}
        for i in range(6):
            body = os.urandom(100 + i)
            data[client.upload(body)] = body
        assert client.wd.wait_synced(5)
        for fid, body in data.items():
            assert client.download(fid) == body
        assert client.wd.vid_map.has(int(next(iter(data)).split(",")[0]))
        follower = f"127.0.0.1:{port}"

        def same():
            try:
                return all(
                    http_json("GET", f"http://{follower}/dir/lookup?"
                              f"volumeId={v}")["locations"]
                    == http_json("GET", f"http://{master.url}/dir/lookup?"
                                 f"volumeId={v}")["locations"]
                    for v in {int(f.split(",")[0]) for f in data})
            except Exception:  # noqa: BLE001 - not up yet
                return False

        _wait("the follower's lookups", same, 20)
        st, _, hdrs = http_bytes("GET", f"http://{follower}/dir/assign",
                                 follow_redirects=False)
        assert st == 307 and hdrs["Location"].startswith(
            f"http://{master.url}/dir/assign")
    finally:
        if client is not None:
            client.close()
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        for v in vols:
            v.stop()
        master.stop()
    assert proc.returncode == 0, out
    assert f"master.follower on 127.0.0.1:{port} -> {master.url}" in out
    assert "master.follower stopped" in out
