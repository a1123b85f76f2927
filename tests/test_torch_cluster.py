"""The reference's control plane drives the port's volume servers.

seaweedfs_tpu's MasterServer, WeedClient and shell (CommandEnv,
run_command) run the cluster flows of tests/test_cluster.py against
VolumeServer(device="cpu") from the port: assign -> PUT -> GET ->
DELETE, replicated writes, redirects, and the EC lifecycle (ec.encode ->
degraded reads -> ec.rebuild -> reads -> ec.decode -> reads) with
``-engine tpu``.  The lifecycle also runs on a mixed cluster of two port
and two reference servers, where each side copies shards from the other
and fetches remote intervals from the other.
"""

from __future__ import annotations

import time

import pytest
import torch

import seaweedfs_tpu.utils.httpd as ref_httpd
import seaweedfs_tpu.volume_server.server as ref_server_mod
import seaweedfs_tpu_torch.volume_server.server as server_mod
from seaweedfs_tpu.client.operation import WeedClient
from seaweedfs_tpu.master.server import MasterServer
from seaweedfs_tpu.shell import CommandEnv, run_command
from seaweedfs_tpu.utils.httpd import http_bytes, http_json
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start_cluster(tmp_path, mixed: bool):
    master = MasterServer(port=free_port(), volume_size_limit_mb=64,
                          pulse_seconds=0.4).start()
    servers = []
    for i in range(4):
        d = tmp_path / f"vs{i}"
        d.mkdir()
        if mixed and i % 2:
            # no needle cache: every read of the lifecycle reaches the shards
            vs = RefVolumeServer([str(d)], master.url, port=free_port(),
                                 max_volume_count=10, pulse_seconds=0.4,
                                 needle_cache_mb=0)
        else:
            vs = VolumeServer([str(d)], master.url, port=free_port(),
                              max_volume_count=10, pulse_seconds=0.4,
                              device="cpu")
        servers.append(vs.start())
    deadline = time.time() + 10
    while time.time() < deadline:
        if len(master.topo.all_nodes()) == 4:
            break
        time.sleep(0.05)
    assert {n.url for n in master.topo.all_nodes()} == \
        {vs.url for vs in servers}
    return master, servers


@pytest.fixture
def cluster(tmp_path, request):
    master, servers = _start_cluster(tmp_path,
                                     getattr(request, "param", "") == "mixed")
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def sync_heartbeats(servers):
    for vs in servers:
        vs.heartbeat_now()


def test_assign_put_get_delete(cluster):
    master, servers = cluster
    client = WeedClient(master.url)
    fid = client.upload(b"hello cluster", name="hi.txt", mime="text/plain")
    assert client.download(fid) == b"hello cluster"
    client.delete(fid)
    with pytest.raises(Exception):
        client.download(fid)


def test_replicated_write(cluster):
    master, servers = cluster
    client = WeedClient(master.url)
    fid = client.upload(b"replicated data", replication="001")
    vid = int(fid.split(",")[0])
    time.sleep(0.1)
    holders = [vs for vs in servers if vid in vs.store.volumes]
    assert len(holders) == 2
    for vs in holders:
        assert vs.store.volumes[vid].super_block.replica_placement \
            .to_byte() == 1
        status, body, _ = http_bytes("GET", f"http://{vs.url}/{fid}")
        assert status == 200 and body == b"replicated data"
    # delete propagates to both replicas
    client.delete(fid)
    for vs in holders:
        status, _, _ = http_bytes("GET", f"http://{vs.url}/{fid}")
        assert status == 404


def test_read_redirects_from_wrong_server(cluster):
    master, servers = cluster
    client = WeedClient(master.url)
    fid = client.upload(b"redirect me")
    vid = int(fid.split(",")[0])
    wrong = next(vs for vs in servers if vid not in vs.store.volumes)
    status, _, headers = http_bytes("GET", f"http://{wrong.url}/{fid}",
                                    follow_redirects=False)
    assert status == 302
    assert headers.get("Location", "").endswith(f"/{fid}")
    # and a normal client transparently follows to the right server
    status, body, _ = http_bytes("GET", f"http://{wrong.url}/{fid}")
    assert status == 200 and body == b"redirect me"


def _record_cross_traffic(monkeypatch, servers):
    """Wrap both packages' shard downloads and shard-interval reads;
    returns [(caller side, target side, kind)]."""
    side = {vs.url: ("port" if isinstance(vs, VolumeServer) else "ref")
            for vs in servers}
    seen: list[tuple[str, str, str]] = []

    def target(url: str) -> str:
        return side.get(url.split("/")[2], "?")

    def wrap(mod, name, caller):
        inner = getattr(mod, name)

        def spy(method, url, *a, **kw):
            if "/admin/ec/" in url:
                seen.append((caller, target(url),
                             url.split("/admin/ec/")[1].split("?")[0]))
            return inner(method, url, *a, **kw)

        monkeypatch.setattr(mod, name, spy)

    wrap(server_mod, "http_download", "port")
    wrap(server_mod, "http_bytes", "port")
    wrap(ref_httpd, "http_download", "ref")  # imported at call time
    wrap(ref_server_mod, "http_bytes", "ref")
    return seen


def _cross_copy(env, servers, vid):
    """Copy one shard each way between a port and a reference server and
    check the copy's bytes; then drop the copies again."""
    port = next(vs for vs in servers if isinstance(vs, VolumeServer))
    ref = next(vs for vs in servers if not isinstance(vs, VolumeServer))
    for dst, src in ((port, ref), (ref, port)):
        sid = sorted(set(src.store.ec_volumes[vid].shards)
                     - set(dst.store.ec_volumes[vid].shards))[0]
        env.volume_post(dst.url, "/admin/ec/copy", {
            "volume_id": vid, "shard_ids": [sid],
            "source_data_node": src.url})
        env.volume_post(dst.url, "/admin/ec/mount", {"volume_id": vid})
        got = dst.store.ec_shard_read(vid, sid, 0, 1 << 20)
        assert got == src.store.ec_shard_read(vid, sid, 0, 1 << 20)
        env.volume_post(dst.url, "/admin/ec/delete",
                        {"volume_id": vid, "shard_ids": [sid]})


@pytest.mark.parametrize("cluster", ["port", "mixed"], indirect=True)
def test_ec_lifecycle_end_to_end(cluster, monkeypatch):
    """The north-star slice: encode -> degraded read -> rebuild -> read ->
    decode -> read, as tests/test_cluster.py runs it, with -engine tpu."""
    master, servers = cluster
    mixed = not all(isinstance(vs, VolumeServer) for vs in servers)
    seen = _record_cross_traffic(monkeypatch, servers)
    client = WeedClient(master.url)

    payloads = {}
    fids = []
    for i in range(60):
        data = bytes([i % 251]) * (500 + i * 37)
        fid = client.upload(data, name=f"obj{i}.bin")
        payloads[fid] = data
        fids.append(fid)
    vid = int(fids[0].split(",")[0])
    sync_heartbeats(servers)

    env = CommandEnv(master.url)
    env.lock()
    out = run_command(env, f"ec.encode -volumeId {vid} -engine tpu")
    assert f"ec encoded volume {vid}" in out

    # the normal volume is gone everywhere; reads go through EC
    assert all(vid not in vs.store.volumes for vs in servers)
    for fid, data in payloads.items():
        assert client.download(fid) == data, fid
    if mixed:
        _cross_copy(env, servers, vid)
        sync_heartbeats(servers)

    # lose one holder's shards (<= 4 of 14) -> degraded reads still work.
    # The needles all lie in shard 0's first small block, so the victim is
    # shard 0's holder and shard 0 is among the lost: every read then
    # reconstructs from intervals fetched from the other servers
    victim = next(vs for vs in servers
                  if 0 in getattr(vs.store.ec_volumes.get(vid), "shards", ()))
    lost = [0] + [s for s in victim.store.ec_volumes[vid].shards if s][:3]
    victim.store.ec_delete_shards(vid, lost)
    sync_heartbeats(servers)
    for fid in fids[:10]:
        assert client.download(fid) == payloads[fid]
    # every holder serves every needle of the volume, fetching the
    # intervals it lacks from the others
    for vs in [vs for vs in servers if vs.store.ec_volumes.get(vid)]:
        for fid in fids[:20]:
            if int(fid.split(",")[0]) == vid:
                status, body, _ = http_bytes("GET", f"http://{vs.url}/{fid}")
                assert (status, body) == (200, payloads[fid])

    # rebuild restores the missing shards
    out = run_command(env, f"ec.rebuild -volumeId {vid} -engine tpu")
    assert "rebuilt shards" in out
    sync_heartbeats(servers)
    shard_map = http_json(
        "GET", f"http://{master.url}/dir/lookup_ec?volumeId={vid}")["shards"]
    present = {int(s) for s, urls in shard_map.items() if urls}
    assert present == set(range(14))
    for fid in fids[:10]:
        assert client.download(fid) == payloads[fid]

    # decode back to a normal volume
    out = run_command(env, f"ec.decode -volumeId {vid}")
    assert "decoded ec volume" in out
    sync_heartbeats(servers)
    for fid, data in payloads.items():
        assert client.download(fid) == data
    env.unlock()
    assert {n.url for n in master.topo.all_nodes()} == \
        {vs.url for vs in servers}
    if mixed:
        for caller, other in (("port", "ref"), ("ref", "port")):
            assert (caller, other, "download") in seen, seen
            assert (caller, other, "shard_read") in seen, seen
