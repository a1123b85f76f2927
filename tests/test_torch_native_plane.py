"""The native data plane (``volume -dataplane native``): the port's C++
plane and its Store funnel against the reference, at tolerance 0.

csrc/dataplane.cpp builds here with ``c++`` and zlib, so every case runs
on the CPU.  The plane's records must equal the reference's Python
Volume's and the reference's own NativeDataPlane's byte for byte (append
times masked where the plane stamps its own); Python and the plane read
each other's writes; the reference's framed client writes and reads
through a port plane; a compaction, an EC encode and a copy quiesce the
plane as the reference's do and give the reference's files; fsync writes
share the plane's group sync; TCP writes are gated per volume; a server
under a whitelist runs the plane engine-only, one under a key or TLS
runs none; a 5-byte or tiered volume never goes on the plane; a volume
server killed -9 mid-write recovers every durable write; and a plane
that does not build stops ``volume -dataplane native``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.client.operation import WeedClient as RefWeedClient
from seaweedfs_tpu.storage.needle import FLAG_HAS_NAME as REF_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.dataplane import \
    NativeDataPlane as RefPlane
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.security import Guard
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage.backend import configure_backends
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.volume import NotFoundError, Volume
from seaweedfs_tpu_torch.tools.see_dat import walk_dat
from seaweedfs_tpu_torch.utils.framing import tcp_port_for
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.dataplane import (DP_NO_VOLUME,
                                                         DataPlaneError,
                                                         NativeDataPlane)
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from seaweedfs_tpu_torch.volume_server.store import Store
from seaweedfs_tpu_torch.volume_server.tcp import (TcpVolumeClient,
                                                   tcp_address)
from tests.conftest import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000_000_000_000


def seeded(needle_cls, has_name: int, seed: int, count: int, first: int = 1,
           t0: int = T0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = needle_cls(cookie=0x3000 + first + i, id=first + i,
                       data=rng.bytes(int(rng.integers(1, 5000))))
        if i % 4 == 0:
            n.name = b"obj%d.bin" % i
            n.set_flag(has_name)
        n.append_at_ns = t0 + 1000 * i
        out.append(n)
    return out


def masked_dat(path: str) -> bytes:
    """The `.dat` with every record's append time zeroed: the plane
    stamps tombstones and W frames with its own clock."""
    blob = bytearray(open(path, "rb").read())
    for offset, rec in walk_dat(path):
        if isinstance(rec, Needle):
            ts = offset + 16 + max(rec.size, 0) + 4
            blob[ts:ts + 8] = bytes(8)
    return bytes(blob)


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_plane_records_equal_the_reference(tmp_path):
    """Appended records: the port plane's equal the reference's Python
    Volume's and the reference plane's; tombstones and W frames equal the
    reference plane's but for the append time."""
    dirs = {k: str(tmp_path / k) for k in ("py", "port", "refplane")}
    py = RefVolume(dirs["py"], "", 1)
    for n in seeded(RefNeedle, REF_HAS_NAME, 5, 40):
        py.write_needle(n)
    for v in (Volume(dirs["port"], "", 1), RefVolume(dirs["refplane"], "", 1)):
        v.close()
    port, ref = NativeDataPlane("127.0.0.1", -1), RefPlane("127.0.0.1", -1)
    try:
        for plane, d in ((port, dirs["port"]), (ref, dirs["refplane"])):
            plane.add_volume(1, os.path.join(d, "1.dat"),
                             os.path.join(d, "1.idx"))
        for n in seeded(Needle, FLAG_HAS_NAME, 5, 40):
            port.append(1, n.id, n.cookie, n.to_bytes(3), n.size)
        for n in seeded(RefNeedle, REF_HAS_NAME, 5, 40):
            ref.append(1, n.id, n.cookie, n.to_bytes(3), n.size)
        for ext in (".dat", ".idx"):
            assert read(os.path.join(dirs["port"], "1" + ext)) == \
                read(os.path.join(dirs["py"], "1" + ext)) == \
                read(os.path.join(dirs["refplane"], "1" + ext)), ext
        for plane in (port, ref):
            assert plane.delete(1, 7, 0x3007) > 0
            assert plane.delete(1, 7, 0x3007) == 0  # a double delete
            assert plane.write(1, 900, 0xabc, b"framed bytes") == 17
            assert plane.write(1, 901, 0xabd, b"") == 0
        assert port.stat(1) == ref.stat_full(1)
        assert port.read(1, 900, 0xabc) == b"framed bytes"
        for key, cookie in ((3, 0x3003), (40, 0x3028)):
            assert port.read_record(1, key, cookie) == \
                ref.read_record(1, key, cookie)
        with pytest.raises(NotFoundError):
            port.read(1, 7, 0x3007)
    finally:
        port.stop()
        ref.stop()
    assert read(os.path.join(dirs["port"], "1.idx")) == \
        read(os.path.join(dirs["refplane"], "1.idx"))
    assert masked_dat(os.path.join(dirs["port"], "1.dat")) == \
        masked_dat(os.path.join(dirs["refplane"], "1.dat"))


def test_python_and_the_plane_read_each_others_writes(tmp_path):
    d = str(tmp_path)
    Volume(d, "", 2).close()
    plane = NativeDataPlane("127.0.0.1", -1)
    try:
        plane.add_volume(2, os.path.join(d, "2.dat"), os.path.join(d, "2.idx"))
        for i in range(1, 30):
            plane.write(2, i, 0x100 + i, b"plane-%d" % i * i)
        plane.delete(2, 5, 0x105)
        plane.remove_volume(2)
        with pytest.raises(DataPlaneError) as e:
            plane.write(2, 99, 1, b"x")
        assert e.value.code == DP_NO_VOLUME
        v = Volume(d, "", 2)
        for i in range(1, 30):
            if i == 5:
                with pytest.raises(KeyError):
                    v.read_needle(i)
            else:
                assert v.read_needle(i, 0x100 + i).data == b"plane-%d" % i * i
        for n in seeded(Needle, FLAG_HAS_NAME, 6, 10, first=100):
            v.write_needle(n)
        v.close()
        plane.add_volume(2, os.path.join(d, "2.dat"), os.path.join(d, "2.idx"))
        for n in seeded(Needle, FLAG_HAS_NAME, 6, 10, first=100):
            assert plane.read(2, n.id, n.cookie) == n.data
            blob, size = plane.read_record(2, n.id, None)
            assert Needle.from_bytes(blob, size, 3).name == n.name
        assert plane.stat(2)[1] == 28 + 10
    finally:
        plane.stop()


@pytest.fixture
def native_cluster(tmp_path):
    """A port master and one port volume server on the native plane."""
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path / "vs")], master.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu",
                      dataplane="native").start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.all_nodes():
        time.sleep(0.05)
    yield master, vs
    vs.stop()
    master.stop()


def test_reference_client_frames_through_a_port_plane(native_cluster):
    """The reference's WeedClient assigns over the port master's framed
    front and writes, reads and deletes through the port's C++ plane;
    the port's HTTP plane serves the same needles through the funnel."""
    master, vs = native_cluster
    plane = vs.store.native_plane
    assert plane is not None and plane.port == tcp_port_for(vs.store.port)
    client = RefWeedClient(master.url)
    rng = np.random.default_rng(9)
    blobs = [rng.bytes(int(rng.integers(1, 20000))) for _ in range(40)]
    fids = [client.upload_tcp(b, collection="nat") for b in blobs]
    vids = {FileId.parse(f).volume_id for f in fids}
    assert vids and all(plane.has(v) for v in vids)
    for fid, b in zip(fids, blobs):
        assert client.download_tcp(fid) == b
        status, body, _ = http_bytes("GET", f"http://{vs.url}/{fid}")
        assert (status, body) == (200, b)
    status = http_json("GET", f"http://{vs.url}/status")
    live = sum(v["file_count"] for v in
               status["NativeDataPlane"]["volumes"].values())
    assert live == 40
    tcp = TcpVolumeClient()
    assert tcp.delete(tcp_address(vs.url), fids[0]) == len(blobs[0]) + 5
    with pytest.raises(OSError, match="not found"):
        tcp.read(tcp_address(vs.url), fids[0])
    # an HTTP write funnels into the plane, a frame reads it
    a = http_json("GET", f"http://{master.url}/dir/assign?collection=nat")
    status, _, _ = http_bytes("POST", f"http://{a['url']}/{a['fid']}",
                              b"over http")
    assert status == 201
    assert tcp.read(tcp_address(a["url"]), a["fid"]) == b"over http"
    # the frames the plane served itself; the HTTP write is the funnel's
    assert http_json("GET", f"http://{vs.url}/status")[
        "NativeDataPlane"]["frames"] == {"W": 40, "R": 42, "D": 1}


def test_store_quiesces_a_compaction_as_the_reference(tmp_path):
    """Plane writes and deletes, then a vacuum: compact (the plane lets
    go), three writes in the window (the Python engine), commit (the
    plane takes the volume back).  The compacted files equal the
    reference's compaction of the same files with the same writes."""
    store = Store([str(tmp_path / "p")], device="cpu")
    plane = NativeDataPlane("127.0.0.1", -1)
    store.attach_native_plane(plane)
    try:
        store.add_volume(4)
        assert plane.has(4)
        for n in seeded(Needle, FLAG_HAS_NAME, 8, 50):
            store.write_needle(4, n)
        for nid in range(2, 50, 4):
            assert store.delete_needle(4, Needle(cookie=0x3000 + nid,
                                                 id=nid)) > 0
        shutil.copytree(tmp_path / "p", tmp_path / "r")
        ref = RefVolume(str(tmp_path / "r"), "", 4)
        store.vacuum_compact(4)
        ref.compact()
        assert not plane.has(4)
        for n in seeded(Needle, FLAG_HAS_NAME, 9, 3, first=200):
            store.write_needle(4, n)
        for n in seeded(RefNeedle, REF_HAS_NAME, 9, 3, first=200):
            ref.write_needle(n)
        store.vacuum_commit(4)
        ref.commit_compact()
        assert plane.has(4)
        ref.close()
        for ext in (".dat", ".idx"):
            assert read(str(tmp_path / "p" / f"4{ext}")) == \
                read(str(tmp_path / "r" / f"4{ext}")), ext
        want = {n.id: n.data for n in seeded(Needle, FLAG_HAS_NAME, 8, 50)
                if n.id not in range(2, 50, 4)}
        want.update({n.id: n.data for n in
                     seeded(Needle, FLAG_HAS_NAME, 9, 3, first=200)})
        assert {k: store.read_needle(4, k).data for k in want} == want
        assert plane.stat(4)[1] == len(want)
        assert store.volume_info(store.get_volume(4))["file_count"] >= \
            len(want)
    finally:
        plane.stop()
        store.close()


def test_ec_encode_quiesces_the_plane_and_equals_the_reference(tmp_path):
    """The encode of a plane-written volume gives the reference's shards;
    the plane takes the volume back read-only and serves its reads."""
    store = Store([str(tmp_path / "p")], device="cpu")
    plane = NativeDataPlane("127.0.0.1", -1)
    store.attach_native_plane(plane)
    try:
        store.add_volume(6)
        for n in seeded(Needle, FLAG_HAS_NAME, 10, 80):
            store.write_needle(6, n)
        store.delete_needle(6, Needle(cookie=0x3003, id=3))
        shutil.copytree(tmp_path / "p", tmp_path / "r")
        store.ec_generate(6)
        assert plane.has(6) and store.get_volume(6).read_only
        with pytest.raises(PermissionError):
            store.write_needle(6, Needle(cookie=1, id=999, data=b"x"))
        assert store.read_needle(6, 80).data == \
            seeded(Needle, FLAG_HAS_NAME, 10, 80)[-1].data
    finally:
        plane.stop()
        store.close()
    ref = RefStore([str(tmp_path / "r")])
    try:
        ref.ec_generate(6)
    finally:
        ref.close()
    for ext in [to_ext(i) for i in range(14)] + [".ecx"]:
        assert read(str(tmp_path / "p" / f"6{ext}")) == \
            read(str(tmp_path / "r" / f"6{ext}")), ext


def test_writers_and_readers_survive_quiesce_cycles(tmp_path):
    """Twelve threads write, delete and read through the funnel while
    another compacts, commits and flips read-only (each a quiesce) over
    and over, the interpreter switching threads every 10 us: every
    acknowledged write reads back its bytes, every acknowledged delete
    stays deleted, and the plane and a fresh Python open agree."""
    store = Store([str(tmp_path)], device="cpu")
    plane = NativeDataPlane("127.0.0.1", -1)
    store.attach_native_plane(plane)
    store.add_volume(8)
    acked: dict[int, bytes] = {}
    deleted: set[int] = set()
    lock = threading.Lock()
    stop = threading.Event()
    errors: list = []

    def worker(t: int) -> None:
        try:
            work(t)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
            raise

    def work(t: int) -> None:
        i = 0
        while not stop.is_set():
            i += 1
            nid = t * 100_000 + i
            data = b"%d-" % nid * (1 + nid % 50)
            try:
                store.write_needle(8, Needle(cookie=nid, id=nid, data=data),
                                   fsync=i % 7 == 0)
            except PermissionError:
                continue  # the read-only window
            with lock:
                acked[nid] = data
            if i % 5 == 0:
                try:
                    store.delete_needle(8, Needle(cookie=nid, id=nid))
                except PermissionError:
                    continue
                with lock:
                    deleted.add(nid)
            got = store.read_needle(8, nid, nid) if nid not in deleted \
                else None
            if got is not None and got.data != data:
                errors.append(nid)

    def maintainer() -> None:
        while not stop.is_set():
            store.vacuum_compact(8)
            store.vacuum_commit(8)
            store.get_volume(8).read_only = True
            store.native_refresh(8)
            store.get_volume(8).read_only = False
            store.native_refresh(8)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(12)] + [threading.Thread(target=maintainer)]
        for t in threads:
            t.start()
        time.sleep(3)
        stop.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors and len(acked) > 100
        assert plane.has(8)
        for nid, data in acked.items():
            if nid in deleted:
                with pytest.raises(KeyError):
                    store.read_needle(8, nid, nid)
            else:
                assert store.read_needle(8, nid, nid).data == data
        assert plane.stat(8)[1] == len(acked) - len(deleted)
    finally:
        plane.stop()
        store.close()
    v = Volume(str(tmp_path), "", 8)
    try:
        assert len(v.nm) == len(acked) - len(deleted)
    finally:
        v.close()


def test_a_quiesce_between_append_and_sync_writes_once(tmp_path):
    """The plane lets go of the volume between an fsync write's append
    and its sync: the write answers once, its record is in the files
    once, and they are fsynced through the Python volume (the reference's
    funnel writes it again on the Python engine)."""
    store = Store([str(tmp_path)], device="cpu")
    plane = NativeDataPlane("127.0.0.1", -1)
    store.attach_native_plane(plane)
    synced = []
    try:
        store.add_volume(9)
        sync = plane.sync

        def quiesced_sync(vid):
            store.native_detach(vid)
            return sync(vid)

        plane.sync = quiesced_sync
        v = store.get_volume(9)
        v_sync = v.sync
        v.sync = lambda: (synced.append(9), v_sync())
        for fsync_op in ("write", "delete"):
            if fsync_op == "write":
                assert store.write_needle(9, Needle(cookie=5, id=5,
                                                    data=b"once"),
                                          fsync=True) == (9, False)
            else:
                store.native_reattach(9)
                assert store.delete_needle(9, Needle(cookie=5, id=5),
                                           fsync=True) == 9
        assert synced == [9, 9]
        entries = idx_mod.iter_index_file(str(tmp_path / "9.idx"))
        assert [(k, s) for k, _, s in entries] == [(5, 9), (5, -1)]
    finally:
        plane.stop()
        store.close()


def test_fsync_writes_share_the_planes_group_sync(tmp_path):
    store = Store([str(tmp_path)], device="cpu")
    plane = NativeDataPlane("127.0.0.1", -1)
    store.attach_native_plane(plane)
    try:
        store.add_volume(7)

        def writer(t: int) -> None:
            for i in range(20):
                nid = 1000 * t + i + 1
                store.write_needle(7, Needle(cookie=nid, id=nid,
                                             data=b"d%d" % nid), fsync=True)
                if i % 5 == 4:
                    store.delete_needle(7, Needle(cookie=nid, id=nid),
                                        fsync=True)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        size, live, _, _, passes = plane.stat(7)
        assert live == 8 * 16
        assert 1 <= passes <= 8 * 24
        # nothing went through the Python engine's worker
        assert store.get_volume(7)._group_commit is None
        assert size == os.path.getsize(tmp_path / "7.dat")
    finally:
        plane.stop()
        store.close()


def test_tcp_writes_are_gated_per_volume(tmp_path):
    """W and D frames only for replication 000: a 001 volume's frames are
    refused, its reads served, its HTTP writes funnelled."""
    vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{free_port()}",
                      port=free_port(), pulse_seconds=30, device="cpu",
                      dataplane="native").start()
    try:
        for vid, rep in ((1, "000"), (2, "001")):
            status, _, _ = http_bytes(
                "POST", f"http://{vs.url}/admin/assign_volume",
                json.dumps({"volume_id": vid, "replication": rep}).encode())
            assert status == 200
        tcp, addr = TcpVolumeClient(), tcp_address(vs.url)
        assert tcp.write(addr, "1,0a00000001", b"ok") == 7
        with pytest.raises(OSError, match="tcp writes not allowed"):
            tcp.write(addr, "2,0a00000001", b"no")
        status, _, _ = http_bytes(
            "POST", f"http://{vs.url}/2,0b00000001?type=replicate", b"http")
        assert status == 201
        assert tcp.read(addr, "2,0b00000001") == b"http"
        with pytest.raises(OSError, match="tcp writes not allowed"):
            tcp.delete(addr, "2,0b00000001")
        # a change of placement registers the volume again with its gate
        vs.store.configure_replication(2, "000")
        assert vs.store.native_plane.has(2)
        assert tcp.write(addr, "2,0a00000001", b"now") == 8
    finally:
        vs.stop()


def _listening(port: int) -> bool:
    with socket.socket() as s:
        s.settimeout(1)
        return s.connect_ex(("127.0.0.1", port)) == 0


def _self_signed(tmp_path):
    from seaweedfs_tpu_torch.security import tls

    key, crt = str(tmp_path / "n.key"), str(tmp_path / "n.crt")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", key, "-out", crt, "-days", "1",
                    "-subj", "/CN=node"], check=True, capture_output=True)
    return tls.server_context(tls.TlsConfig(ca_file=crt, cert_file=crt,
                                            key_file=key))


@pytest.mark.parametrize("secured", ["whitelist", "signing_key",
                                     "read_key", "tls"])
def test_secured_servers_open_no_unguarded_port(tmp_path, secured):
    kw: dict = {}
    if secured == "whitelist":
        kw["guard"] = Guard(white_list=["127.0.0.1"])
    elif secured == "signing_key":
        kw["guard"] = Guard(signing_key="k")
    elif secured == "read_key":
        kw["guard"] = Guard(read_signing_key="r")
    else:
        kw["tls_context"] = _self_signed(tmp_path)
    port = free_port()
    vs = VolumeServer([str(tmp_path / "d")], f"127.0.0.1:{free_port()}",
                      port=port, pulse_seconds=30, device="cpu",
                      dataplane="native", **kw).start()
    try:
        assert not _listening(tcp_port_for(port))
        assert vs._tcp_server is None
        plane = vs.store.native_plane
        if secured != "whitelist":
            assert plane is None
            return
        # engine-only: HTTP needle IO still goes through it
        assert plane.port == 0 and not vs.store.native_tcp_writes_ok
        vs.store.add_volume(3)
        status, _, _ = http_bytes("POST", f"http://{vs.url}/3,0100000001",
                                  b"guarded")
        assert status == 201 and plane.stat(3)[1] == 1
        assert http_json("GET", f"http://{vs.url}/status")[
            "NativeDataPlane"]["tcp_port"] == 0
    finally:
        vs.stop()


def test_a_taken_framed_port_leaves_the_plane_engine_only(tmp_path):
    """A framed port held by another socket for the whole 3 s retry: the
    server comes up, its degraded bind counted, and the plane still
    takes every HTTP needle op (engine-only)."""
    from seaweedfs_tpu_torch.stats import degraded_bind_metrics

    port = free_port()
    holder = socket.socket()
    holder.bind(("127.0.0.1", tcp_port_for(port)))  # bound, not listening
    before = degraded_bind_metrics().totals()["degraded_binds"]
    try:
        vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{free_port()}",
                          port=port, pulse_seconds=30, device="cpu",
                          dataplane="native").start()
    finally:
        holder.close()
    try:
        plane = vs.store.native_plane
        assert plane is not None and plane.port == 0
        assert degraded_bind_metrics().totals()["degraded_binds"] == \
            before + 1
        vs.store.add_volume(1)
        status, _, _ = http_bytes("POST", f"http://{vs.url}/1,0100000001",
                                  b"funnelled")
        assert status == 201 and plane.stat(1)[1] == 1
    finally:
        vs.stop()


def test_five_byte_and_tiered_volumes_stay_off_the_plane(tmp_path):
    configure_backends({"coldnp": {"type": "dir",
                                   "root": str(tmp_path / "cold")}})
    vs = VolumeServer([str(tmp_path / "d")], f"127.0.0.1:{free_port()}",
                      port=free_port(), pulse_seconds=30, device="cpu",
                      dataplane="native").start()
    plane = vs.store.native_plane
    try:
        for vid, off5 in ((1, False), (2, True), (3, False)):
            assert http_json("POST", f"http://{vs.url}/admin/assign_volume",
                             {"volume_id": vid, "offset_5": off5}) == {}
        assert plane.has(1) and not plane.has(2) and plane.has(3)
        for vid in (1, 2, 3):
            for i in range(1, 6):
                status, _, _ = http_bytes(
                    "POST", f"http://{vs.url}/{vid},{i:02x}00000001",
                    b"v%d-%d" % (vid, i))
                assert status == 201
        assert os.path.getsize(tmp_path / "d" / "2.idx") == 5 * 17
        # a two-phase upload freezes the volume on the plane too
        assert http_json("POST", f"http://{vs.url}/admin/tier_upload",
                         {"volume_id": 3, "backend": "coldnp",
                          "two_phase": True})["manifest"]
        assert plane.has(3)
        with pytest.raises(PermissionError):
            vs.store.write_needle(3, Needle(cookie=1, id=99, data=b"x"))
        assert http_json("POST", f"http://{vs.url}/admin/tier_commit",
                         {"volume_id": 3})["manifest"]
        assert not plane.has(3) and vs.store.get_volume(3).tiered
        for vid in (1, 2, 3):
            for i in range(1, 6):
                status, body, _ = http_bytes(
                    "GET", f"http://{vs.url}/{vid},{i:02x}00000001")
                assert (status, body) == (200, b"v%d-%d" % (vid, i))
        doc = http_json("GET", f"http://{vs.url}/status")
        assert set(doc["NativeDataPlane"]["volumes"]) == {"1"}
        assert doc["NativeDataPlane"]["volumes"]["1"]["file_count"] == 5
        _, text, _ = http_bytes("GET", f"http://{vs.url}/metrics")
        lines = text.decode().splitlines()
        assert 'SeaweedFS_volumeServer_native_plane{volume="1",' \
            'stat="live_files"} 5' in lines
        assert not any('native_plane{volume="2"' in x or
                       'native_plane{volume="3"' in x for x in lines)
        # the recall brings volume 3 back onto the plane
        assert http_json("POST", f"http://{vs.url}/admin/tier_download",
                         {"volume_id": 3}) == {}
        assert plane.has(3)
    finally:
        vs.stop()


def test_volume_copy_between_native_servers(tmp_path):
    """The source's read-only flip reaches its plane; the copy lands on
    the target's plane, files equal, and the source's flag is given
    back."""
    master = f"127.0.0.1:{free_port()}"
    src = VolumeServer([str(tmp_path / "s")], master, port=free_port(),
                       pulse_seconds=30, device="cpu",
                       dataplane="native").start()
    dst = VolumeServer([str(tmp_path / "t")], master, port=free_port(),
                       pulse_seconds=30, device="cpu",
                       dataplane="native").start()
    try:
        src.store.add_volume(5)
        for n in seeded(Needle, FLAG_HAS_NAME, 12, 30):
            src.store.write_needle(5, n)
        assert http_json("POST", f"http://{dst.url}/admin/volume_copy",
                         {"volume_id": 5, "source_data_node": src.url}) == {}
        assert dst.store.native_plane.has(5)
        assert src.store.native_plane.has(5)
        assert not src.store.get_volume(5).read_only
        for ext in (".dat", ".idx"):
            assert read(str(tmp_path / "s" / f"5{ext}")) == \
                read(str(tmp_path / "t" / f"5{ext}"))
        for n in seeded(Needle, FLAG_HAS_NAME, 12, 30):
            assert dst.store.read_needle(5, n.id, n.cookie).data == n.data
        # the plane took the source's flag: a write is refused, then
        # taken again once the flag is back
        http_json("POST", f"http://{src.url}/admin/readonly",
                  {"volume_id": 5, "readonly": True})
        with pytest.raises(PermissionError):
            src.store.write_needle(5, Needle(cookie=1, id=777, data=b"x"))
        http_json("POST", f"http://{src.url}/admin/readonly",
                  {"volume_id": 5, "readonly": False})
        src.store.write_needle(5, Needle(cookie=1, id=777, data=b"x"))
    finally:
        src.stop()
        dst.stop()


# the chaos test's own limit: every wait below is bounded, and the whole
# run must end inside it
CHAOS_BUDGET_S = 120
KILL_CYCLES = 3


def _cli(*argv: str, log=subprocess.DEVNULL) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *argv], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, stdout=log,
        stderr=subprocess.STDOUT)


def _http(method: str, url: str, data: bytes = None, timeout: float = 10):
    return http_bytes(method, url, data, timeout=timeout)[:2]


def _wait_http(port: int, deadline_s: float = 30) -> None:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            if _http("GET", f"http://127.0.0.1:{port}/status",
                     timeout=2)[0] == 200:
                return
        except Exception:  # noqa: BLE001 - not up yet
            pass
        time.sleep(0.1)
    raise AssertionError("volume server did not come up")


class _Answers(dict):
    errors: dict


def _batch_get(port: int, fids: list[str]) -> _Answers:
    """Every fid's bytes through ``POST /batch/read`` (the store's read
    path, so the plane's), a few thousand a request; None where the read
    failed, its error text in ``errors``."""
    out = _Answers()
    out.errors = {}
    for i in range(0, len(fids), 5000):
        chunk = fids[i:i + 5000]
        status, body = _http("POST", f"http://127.0.0.1:{port}/batch/read",
                             json.dumps({"fids": chunk}).encode(),
                             timeout=60)
        assert status == 200
        j = 0
        for fid in chunk:
            n = int.from_bytes(body[j + 1:j + 5], "big")
            payload = body[j + 5:j + 5 + n]
            if body[j] == 0:
                out[fid] = payload
            else:
                out[fid] = None
                out.errors[fid] = payload.decode(errors="replace")
            j += 5 + n
        assert j == len(body)
    return out


def test_kill9_midwrite_recovers_native(tmp_path):
    """tests/test_crash_chaos.py's kill -9 drill on the port's native
    plane: durable writes and writes on both paths in flight, SIGKILL,
    restart on the same directory.  Every fsync-acknowledged write reads
    back exact, every other one exact or 404, never corrupt; the volume
    takes writes again."""
    t_start = time.monotonic()
    mport, vport = free_port(), free_port()
    master = _cli("master", "-port", str(mport), "-mdir",
                  str(tmp_path / "m"))
    vdir = str(tmp_path / "v")

    def spawn():
        return _cli("volume", "-dir", vdir, "-port", str(vport),
                    "-mserver", f"127.0.0.1:{mport}", "-ec.engine", "cpu",
                    "-dataplane", "native")

    vs = spawn()
    acked: dict[str, bytes] = {}
    durable: dict[str, bytes] = {}
    lock = threading.Lock()
    try:
        _wait_http(vport)
        assert _http("POST", f"http://127.0.0.1:{vport}/admin/assign_volume",
                     json.dumps({"volume_id": 1}).encode())[0] == 200
        for cycle in range(KILL_CYCLES):
            stop = threading.Event()
            seq = [cycle * 1_000_000]

            def writer(kind: str) -> None:
                tcp = TcpVolumeClient()
                while not stop.is_set():
                    with lock:
                        seq[0] += 1
                        n = seq[0]
                    fid = f"1,{n:08x}000000aa"
                    payload = f"cycle{cycle}-{n}-".encode() * (1 + n % 40)
                    try:
                        if kind == "tcp":
                            tcp.write(tcp_address(f"127.0.0.1:{vport}"),
                                      fid, payload)
                            ok = True
                        else:
                            url = f"http://127.0.0.1:{vport}/{fid}"
                            if kind == "durable":
                                url += "?fsync=true"
                            ok = _http("POST", url, payload,
                                       timeout=5)[0] in (200, 201)
                    except Exception:  # noqa: BLE001 - died mid-request
                        return
                    if ok:
                        with lock:
                            (durable if kind == "durable"
                             else acked)[fid] = payload

            threads = [threading.Thread(target=writer, args=(k,))
                       for k in ("durable", "http", "tcp")]
            for t in threads:
                t.start()
            time.sleep(1.2)
            vs.send_signal(signal.SIGKILL)
            stop.set()
            vs.wait(timeout=10)
            for t in threads:
                t.join(timeout=15)
            vs = spawn()
            _wait_http(vport)
            with lock:
                durable_now, best_effort = dict(durable), dict(acked)
            got = _batch_get(vport, list(durable_now))
            for fid, payload in durable_now.items():
                assert got[fid] == payload, \
                    f"durable write {fid} lost or corrupt"
            got = _batch_get(vport, list(best_effort))
            for fid, payload in best_effort.items():
                if got[fid] is None:
                    assert "not found" in got.errors[fid], got.errors[fid]
                    del acked[fid]  # an unsynced tail may die
                    continue
                assert got[fid] == payload, f"{fid} corrupt"
            assert _http("POST",
                         f"http://127.0.0.1:{vport}/1,deadbeef000000aa",
                         b"post-recovery write")[0] in (200, 201)
            assert _http("GET",
                         f"http://127.0.0.1:{vport}/1,deadbeef000000aa") == \
                (200, b"post-recovery write")
            assert time.monotonic() - t_start < CHAOS_BUDGET_S
        assert len(durable) > 10, "chaos too shallow (durable)"
        status = http_json("GET", f"http://127.0.0.1:{vport}/status")
        assert "1" in status["NativeDataPlane"]["volumes"]
    finally:
        for p in (vs, master):
            p.terminate()
        for p in (vs, master):
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_a_plane_that_does_not_build_stops_the_server(tmp_path):
    """``volume -dataplane native`` over a csrc/dataplane.cpp that does
    not compile exits non-zero with the compiler's error: no server runs
    the Python plane in its place."""
    pkg = tmp_path / "seaweedfs_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "seaweedfs_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (pkg / "csrc" / "dataplane.cpp").write_text("this is not C++\n")
    port = free_port()
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-dir",
         str(tmp_path / "d"), "-port", str(port), "-mserver",
         f"127.0.0.1:{free_port()}", "-ec.engine", "cpu", "-dataplane",
         "native"], cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(tmp_path)},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "native build failed" in r.stderr
    assert "volume server listening" not in r.stdout
    assert not _listening(port) and not _listening(tcp_port_for(port))


def test_native_plane_phase_on_cpu(tmp_path):
    """chip_smoke.py's native_plane phase, small and on the plain EC
    engine: every check the card's run makes but the launch counts."""
    import chip_smoke

    res = chip_smoke.run_native_plane_phase(
        "cpu", str(tmp_path), n=300, size=1024, clients=4, zipf=200,
        degraded=40, five_byte=50, volumes=3)
    assert res["mismatches"] == 0 and res["zlib_h"]
    assert res["counts"]["tcp_write"]["W"] == 300
    assert res["counts"]["tcp_read"]["R"] == 500
    assert res["counts"]["http_write"]["W"] == 0
    assert res["counts"]["http_read"]["pool_dispatches"] >= 500
    assert set(res["passes"]) == {"tcp_write", "tcp_read", "tcp_zipf",
                                  "http_write", "http_read", "http_zipf"}
    assert res["data_shards_equal_dat"] and res["parity_equal_plain"]
    assert res["degraded"]["gets"] == 40 and res["launches"] == 0
    assert res["five_byte"]["idx_entry_bytes"] == 17
    assert all(0 <= c["client_share"] <= 1 for c in res["cpu_s"].values())
