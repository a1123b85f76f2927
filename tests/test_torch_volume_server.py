"""Transcripts: the port's VolumeServer(device="cpu") and seaweedfs_tpu's
VolumeServer(ec_engine="cpu") answer the same request list over HTTP.

Both serve copies of one volume that the reference server wrote (needles
carry their writer's append_at_ns, so EC files can only be compared when
both servers start from one `.dat`).  Every response is compared by
status, body and the ETag, Content-Type, Content-Disposition,
Content-Encoding and Content-Range headers; after each EC step the 14
shards, `.ecx`, `.eci` and `.ecj` (and after the decode `.dat` and `.idx`)
are compared byte for byte.  Neither server has a master: remote shard
fetches fail and degraded reads reconstruct locally.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.storage.crc import crc32c
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils.compression import gzip_data
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

HEADERS = ("ETag", "Content-Type", "Content-Disposition", "Content-Encoding",
           "Content-Range")
SHARDS = [to_ext(i) for i in range(14)]
TS = 1_700_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exchange(url: str, method: str, path: str, body: bytes = None,
             headers: dict = None):
    """One request, no redirects: (status, body, {compared headers})."""
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        return r.status, data, {h: r.getheader(h) for h in HEADERS}
    finally:
        conn.close()


def _needles(seed: int, vid: int, count: int) -> list[dict]:
    """Seeded uploads: every fourth gzipped, every third named, every
    fifth typed, every seventh a multipart POST, one with a TTL."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        data = rng.bytes(int(np.exp(rng.uniform(np.log(100),
                                                np.log(150_000)))))
        fid = str(FileId(vid, i + 1, int(rng.integers(1, 1 << 32))))
        query = {"ts": str(TS + i)}
        headers = {}
        body = data
        if i % 3 == 0:
            query["name"] = f"obj-{i}.bin"
        if i % 5 == 0:
            headers["Content-Type"] = "image/png"
        if i % 4 == 1:
            body = gzip_data(data)
            headers["Content-Encoding"] = "gzip"
        if i == 6:
            query["ttl"] = "3d"
        method = "PUT"
        if i % 7 == 2:
            method = "POST"
            boundary = uuid.UUID(int=i).hex
            body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="file"; filename="dir/up-{i}.txt"\r\n'
                    "Content-Type: text/plain\r\n\r\n").encode() + body + \
                f"\r\n--{boundary}--\r\n".encode()
            headers["Content-Type"] = \
                f"multipart/form-data; boundary={boundary}"
        path = f"/{fid}?" + "&".join(f"{k}={v}" for k, v in query.items())
        stored = gzip_data(data) if i % 4 == 1 else data
        out.append({"fid": fid, "data": data, "method": method,
                    "path": path, "body": body, "headers": headers,
                    "etag": '"%08x"' % crc32c(stored),
                    "gzip": i % 4 == 1})
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("transcript")
    master = f"127.0.0.1:{free_port()}"  # nothing listens: no master
    ref_dir, port_dir = root / "ref", root / "port"
    ref = RefVolumeServer([str(ref_dir)], master, port=free_port(),
                          pulse_seconds=0.5, ec_engine="cpu", tcp=False,
                          heat=False, ledger=False, needle_cache_mb=0).start()
    specs = {1: _needles(7, 1, 36), 2: _needles(8, 2, 6)}
    for vid, sp in specs.items():
        status, _, _ = exchange(ref.url, "POST", "/admin/assign_volume",
                                json.dumps({"volume_id": vid}).encode())
        assert status == 200
        for n in sp:
            status, _, _ = exchange(ref.url, n["method"], n["path"],
                                    n["body"], n["headers"])
            assert status == 201
    os.makedirs(port_dir)
    for vid in specs:
        for ext in (".dat", ".idx"):
            shutil.copy(ref_dir / f"{vid}{ext}", port_dir / f"{vid}{ext}")
    port = VolumeServer([str(port_dir)], master, port=free_port(),
                        pulse_seconds=0.5, device="cpu").start()
    yield {"ref": ref, "port": port, "specs": specs,
           "dirs": {"ref": str(ref_dir), "port": str(port_dir)}}
    port.stop()
    ref.stop()


def _post(path: str, body: dict, port_body: dict = None):
    """A JSON admin request; port_body when the two servers are asked in
    their own engine words."""
    return ("POST", path, json.dumps(body).encode(), {},
            json.dumps(port_body).encode() if port_body else None)


def _same_files(servers, exts, vid=1):
    for ext in exts:
        a = os.path.join(servers["dirs"]["ref"], f"{vid}{ext}")
        b = os.path.join(servers["dirs"]["port"], f"{vid}{ext}")
        assert os.path.exists(a) == os.path.exists(b), ext
        if os.path.exists(a):
            assert _read(a) == _read(b), ext


def _run(servers, requests, compare_body=True):
    out = []
    for req in requests:
        method, path, body, headers = req[:4]
        port_body = req[4] if len(req) > 4 and req[4] is not None else body
        want = exchange(servers["ref"].url, method, path, body, headers)
        got = exchange(servers["port"].url, method, path, port_body, headers)
        if compare_body:
            assert got == want, (method, path)
        else:
            assert (got[0], got[2]) == (want[0], want[2]), (method, path)
        out.append(got)
    return out


def _assert_served(servers, specs):
    """Both servers return every needle's bytes (not merely the same
    error)."""
    for n in specs:
        for side in ("ref", "port"):
            status, body, hdrs = exchange(servers[side].url, "GET",
                                          f"/{n['fid']}")
            assert (status, body, hdrs["ETag"]) == (200, n["data"],
                                                    n["etag"]), side


def _gets(specs, ranges=True):
    reqs = []
    for n in specs:
        fid = n["fid"]
        reqs.append(("GET", f"/{fid}", None, {}))
        reqs.append(("HEAD", f"/{fid}", None, {}))
        reqs.append(("GET", f"/{fid}", None, {"If-None-Match": n["etag"]}))
        reqs.append(("GET", f"/{fid}", None, {"If-None-Match": '"0"'}))
        if n["gzip"]:
            reqs.append(("GET", f"/{fid}", None,
                         {"Accept-Encoding": "gzip, deflate"}))
        if ranges or n["gzip"]:
            for rng in ("bytes=0-9", "bytes=-7", "bytes=5-",
                        "bytes=99999999-"):
                reqs.append(("GET", f"/{fid}", None, {"Range": rng}))
            reqs.append(("GET", f"/{fid}", None,
                         {"Range": "bytes=0-3", "Accept-Encoding": "gzip"}))
    key_only = specs[0]["fid"][:-8]
    reqs += [("GET", f"/{key_only}00000000", None, {}),   # wrong cookie
             ("GET", "/1,ffff0123abcd", None, {}),         # unknown key
             ("GET", "/9,0101020304", None, {})]           # unknown volume
    return reqs


def test_transcript(servers):
    specs = servers["specs"]
    # the plain volume; a Range GET of an uncompressed needle is left out
    # here, see ROADMAP Queue 3 (the reference answers it on its partial
    # read path, without an ETag)
    _run(servers, _gets(specs[1], ranges=False))
    _assert_served(servers, specs[1])
    v2 = specs[2]
    _run(servers, [
        ("DELETE", f"/{v2[0]['fid']}", None, {}),
        ("GET", f"/{v2[0]['fid']}", None, {}),
        ("DELETE", f"/{v2[0]['fid']}", None, {}),
        ("DELETE", "/9,0101020304", None, {}),
        ("PUT", f"/{v2[1]['fid']}?ts={TS}&name=again.txt", b"new bytes",
         {"Content-Type": "text/plain"}),
        ("GET", f"/{v2[1]['fid']}", None, {}),
        ("PUT", "/2,zz", b"x", {}),
        ("PUT", "/2,01", b"x", {}),
        _post("/admin/readonly", {"volume_id": 1}),
        ("PUT", f"/{specs[1][0]['fid']}?ts={TS}", b"late", {}),
        _post("/admin/readonly", {"volume_id": 77}),
    ])
    # encode: the reference's CPU server is asked for "cpu", the port's
    # CPU server for "tpu" (its own device); the reference answers with
    # pipeline counters the port does not keep, so only statuses compare
    _run(servers, [_post("/admin/ec/generate", {"volume_id": 1,
                                                "engine": "cpu"},
                         {"volume_id": 1, "engine": "tpu"})],
         compare_body=False)
    _same_files(servers, SHARDS + [".ecx", ".eci"])
    _run(servers, [_post("/admin/ec/mount", {"volume_id": 1}),
                   _post("/admin/delete_volume", {"volume_id": 1})])
    _same_files(servers, [".ecj", ".dat", ".idx"])
    # served from the shards; Range now slices the full body on both
    _run(servers, _gets(specs[1]))
    _assert_served(servers, specs[1])
    gone = specs[1][3]["fid"]
    _run(servers, [("DELETE", f"/{gone}", None, {}),
                   ("GET", f"/{gone}", None, {}),
                   _post("/admin/ec/delete", {"volume_id": 1,
                                              "shard_ids": [2, 7]})])
    _same_files(servers, SHARDS + [".ecx", ".ecj"])
    left = [n for n in specs[1] if n["fid"] != gone]
    _run(servers, _gets(left))  # degraded: shards 2 and 7 are gone
    _assert_served(servers, left)
    _run(servers, [
        ("GET", "/admin/ec/shard_read?volume_id=1&shard=0&offset=8&size=300",
         None, {}),
        ("GET", "/admin/ec/shard_read?volume_id=1&shard=13&offset=0"
                "&size=70000", None, {}),
        ("GET", "/admin/ec/shard_read?volume_id=1&shard=2&offset=0&size=9",
         None, {}),
        ("GET", "/admin/ec/shard_read?volume_id=1&shard=x&offset=0&size=9",
         None, {}),
        ("GET", "/admin/ec/shard_read?volume_id=1&offset=0&size=9", None, {}),
    ])
    rebuilt = _run(servers, [_post("/admin/ec/rebuild", {"volume_id": 1},
                                   {"volume_id": 1})], compare_body=False)
    assert json.loads(rebuilt[0][1])["rebuilt_shard_ids"] == [2, 7]
    _same_files(servers, SHARDS)
    _run(servers, [_post("/admin/ec/mount", {"volume_id": 1}),
                   _post("/admin/ec/blob_delete",
                         {"volume_id": 1, "key": FileId.parse(
                             left[5]["fid"]).key}),
                   _post("/admin/ec/blob_delete",
                         {"volume_id": 1, "key": 123456})])
    _same_files(servers, [".ecx", ".ecj"])
    left = left[:5] + left[6:]
    _run(servers, _gets(left[:8]))
    _run(servers, [_post("/admin/ec/to_volume", {"volume_id": 1})])
    _same_files(servers, [".dat", ".idx", ".ecx", ".ecj"])
    _run(servers, _gets(left, ranges=False)
         + [("GET", f"/{gone}", None, {}),
            ("GET", f"/{specs[1][5]['fid']}", None, {})])
    _assert_served(servers, left)


def test_port_answers_its_own_routes(servers):
    url = servers["port"].url
    status, body, _ = exchange(url, "GET", "/status")
    doc = json.loads(body)
    assert status == 200 and set(doc) == {"Version", "Volumes", "EcVolumes",
                                          "Master", "DataCenter", "Rack",
                                          "EcPipeline", "EcIntegrity",
                                          "EcKernelLaunches", "EcScrub",
                                          "EcKernelWidths", "NeedleCache",
                                          "Dataplane", "Heat", "Ledger"}
    assert doc["EcScrub"] == {"running": False, "passes": 0,
                              "cursor": [0, 0], "verdicts": {}}
    # the process's kernel count: a CPU server launches none
    assert doc["EcKernelLaunches"] == 0
    assert doc["EcKernelWidths"] == {"<=4KiB": 0, "<=64KiB": 0,
                                     "<=1MiB": 0, ">1MiB": 0}
    assert {v["id"] for v in doc["Volumes"]} >= {2}
    # a volume with 5-byte offsets is made, as the reference makes it
    answers = [exchange(servers[side].url, "POST", "/admin/assign_volume",
                        json.dumps({"volume_id": 31,
                                    "offset_5": True}).encode())
               for side in ("ref", "port")]
    assert answers[1] == answers[0] and answers[1][0] == 200
    assert servers["port"].store.volumes[31].offset_size == \
        servers["ref"].store.volumes[31].offset_size == 5
    # an engine this server does not run answers 400 and runs nothing
    for engine in ("fpga", "gpu"):
        status, body, _ = exchange(url, "POST", "/admin/ec/generate",
                                   json.dumps({"volume_id": 2,
                                               "engine": engine}).encode())
        assert status == 400 and "-ec.engine cpu" in json.loads(
            body)["error"]
    assert not os.path.exists(os.path.join(servers["dirs"]["port"],
                                           "2.ec00"))
    # a download outside the EC file set is refused
    status, _, _ = exchange(url, "GET",
                            "/admin/ec/download?volume_id=2&ext=.dat")
    assert status == 400


def test_port_serves_a_directory_the_reference_wrote(tmp_path):
    master = f"127.0.0.1:{free_port()}"
    ref = RefVolumeServer([str(tmp_path)], master, port=free_port(),
                          pulse_seconds=0.5, ec_engine="cpu", tcp=False,
                          heat=False, ledger=False).start()
    specs = _needles(9, 4, 24)
    try:
        exchange(ref.url, "POST", "/admin/assign_volume",
                 json.dumps({"volume_id": 4, "replication": "001",
                             "ttl": "7d"}).encode())
        for n in specs:
            assert exchange(ref.url, n["method"], n["path"], n["body"],
                            n["headers"])[0] == 201
        want = [exchange(ref.url, "GET", f"/{n['fid']}") for n in specs]
        info = json.loads(exchange(ref.url, "GET", "/status")[1])["Volumes"]
    finally:
        ref.stop()
    port = VolumeServer([str(tmp_path)], master, port=free_port(),
                        pulse_seconds=0.5, device="cpu").start()
    try:
        got = [exchange(port.url, "GET", f"/{n['fid']}") for n in specs]
        assert got == want
        assert [g[1] for g in got] == [n["data"] for n in specs]
        mine = json.loads(exchange(port.url, "GET", "/status")[1])["Volumes"]
        keys = ("id", "size", "file_count", "replica_placement", "ttl",
                "version", "max_file_key")
        assert [{k: v[k] for k in keys} for v in mine] == \
            [{k: v[k] for k in keys} for v in info]
    finally:
        port.stop()


def test_volume_copy_check_configure_and_leave_routes(tmp_path):
    """/admin/volume_copy, /admin/volume_download, /admin/volume_check,
    /admin/configure_replication and /admin/leave: a reference server and
    a port server, heartbeating to one master, each copy a volume from a
    third server and answer the same requests with the same status and
    body (a path in a body names the server's own directory), and end
    with byte-identical copies."""
    from seaweedfs_tpu_torch.master.server import MasterServer

    master = MasterServer(port=free_port(), pulse_seconds=0.5).start()
    dirs = {k: str(tmp_path / k) for k in ("src", "ref", "port")}
    src = VolumeServer([dirs["src"]], master.url, port=free_port(),
                       pulse_seconds=0.5, device="cpu").start()
    ref = RefVolumeServer([dirs["ref"]], master.url, port=free_port(),
                          pulse_seconds=0.5, ec_engine="cpu", tcp=False,
                          heat=False, ledger=False,
                          needle_cache_mb=0).start()
    port = VolumeServer([dirs["port"]], master.url, port=free_port(),
                        pulse_seconds=0.5, device="cpu").start()
    try:
        assert exchange(src.url, *_post("/admin/assign_volume", {
            "volume_id": 5, "collection": "c"})[:3])[0] == 200
        needles = _needles(11, 5, 12)
        for n in needles:
            path = n["path"] + "&type=replicate"
            assert exchange(src.url, n["method"], path, n["body"],
                            n["headers"])[0] == 201

        def both(requests) -> list:
            out = []
            for method, path, body, headers, *_ in requests:
                got = {}
                for side, vs in (("ref", ref), ("port", port)):
                    status, data, _ = exchange(vs.url, method, path, body,
                                               headers)
                    got[side] = (status, data.replace(
                        dirs[side].encode(), b"<dir>"))
                assert got["port"] == got["ref"], (method, path)
                out.append(got["port"])
            return out

        copy = _post("/admin/volume_copy", {"volume_id": 5, "collection": "c",
                                            "source_data_node": src.url})
        out = both([
            copy, copy,
            _post("/admin/volume_copy", {"volume_id": 77,
                                         "source_data_node": src.url}),
            ("GET", "/admin/volume_download?volume_id=5&ext=.dat", None, {}),
            ("GET", "/admin/volume_download?volume_id=5&ext=.idx", None, {}),
            ("GET", "/admin/volume_download?volume_id=5&ext=.vif", None, {}),
            ("GET", "/admin/volume_download?volume_id=5&ext=.ecx", None, {}),
            ("GET", "/admin/volume_download?volume_id=5", None, {}),
            ("GET", "/admin/volume_download?volume_id=9&ext=.dat", None, {}),
            ("GET", "/admin/volume_download?volume_id=x&ext=.dat", None, {}),
            _post("/admin/volume_check", {"volume_id": 5}),
            _post("/admin/volume_check", {"volume_id": 9}),
        ])
        assert [s for s, _ in out] == [200, 409, 404, 200, 200, 404, 400,
                                       404, 404, 400, 200, 404]
        src_dat = _read(os.path.join(dirs["src"], "c_5.dat"))
        assert out[3][1] == src_dat
        assert out[4][1] == _read(os.path.join(dirs["src"], "c_5.idx"))
        assert json.loads(out[10][1]) == {"indexed": 12, "scanned_live": 12,
                                          "crc_errors": 0}
        for side in ("ref", "port"):
            assert _read(os.path.join(dirs[side], "c_5.dat")) == src_dat
            # the source was writable before each copy, and is again
            doc = json.loads(exchange(src.url, "GET", "/status")[1])
            assert [v["read_only"] for v in doc["Volumes"]] == [False]
            # a flipped byte in the first needle's data
            with open(os.path.join(dirs[side], "c_5.dat"), "r+b") as f:
                f.seek(8 + 20)
                b = f.read(1)
                f.seek(8 + 20)
                f.write(bytes([b[0] ^ 0xFF]))
        out = both([
            _post("/admin/volume_check", {"volume_id": 5}),
            _post("/admin/configure_replication", {"volume_id": 5,
                                                   "replication": "010"}),
            _post("/admin/configure_replication", {"volume_id": 9,
                                                   "replication": "010"}),
            _post("/admin/configure_replication", {"volume_id": 5,
                                                   "replication": "3"}),
            _post("/admin/leave", {}),
        ])
        assert [s for s, _ in out] == [200, 200, 404, 500, 200]
        assert json.loads(out[0][1])["crc_errors"] == 1
        assert json.loads(out[1][1]) == {"replication": "010"}
        assert json.loads(out[4][1]) == {"left": True}
        ref_dat = _read(os.path.join(dirs["ref"], "c_5.dat"))
        assert ref_dat[1] == 10
        assert _read(os.path.join(dirs["port"], "c_5.dat")) == ref_dat
        # leave stops the heartbeat only: the server still answers
        deadline = time.monotonic() + 10
        while any(t.name == f"heartbeat:{port.url}"
                  for t in threading.enumerate()):
            assert time.monotonic() < deadline, "heartbeat still running"
            time.sleep(0.05)
        got = exchange(port.url, "GET", f"/{needles[1]['fid']}")
        assert got[:2] == (200, needles[1]["data"])
        assert exchange(port.url, "GET", "/status")[0] == 200
    finally:
        port.stop()
        ref.stop()
        src.stop()
        master.stop()
