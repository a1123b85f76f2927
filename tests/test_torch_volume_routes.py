"""The volume store's remaining routes, port against reference.

A reference VolumeServer and the port's (device "cpu") serve copies of
one volume the reference wrote; the same requests go to both and the
answers must be equal: ``/admin/batch_delete`` (live, missing, malformed,
EC-volume and replicated fids), ``/query`` (JSON, JSON lines and CSV, with
selections, a filter and a prefix), ``/stats/counter``, ``/stats/memory``
and ``/stats/disk`` (by key set, and the counters by value after the same
requests), and GETs with ``?width``/``?height`` (resized by Pillow here,
and passed through when Pillow cannot be imported).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port
from tests.test_torch_volume_server import exchange

TS = 1_700_000_000
ROWS = [{"id": i, "name": f"user{i:03d}", "city": ["Oslo", "Lima",
                                                   "Pune"][i % 3],
         "score": round(10.0 * i / 7, 3), "tags": {"tier": i % 4}}
        for i in range(30)]


def _image(w: int, h: int, fmt: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    out = io.BytesIO()
    img.save(out, format=fmt)
    return out.getvalue()


def _payloads() -> list[tuple[str, bytes, str]]:
    """(fid, bytes, mime) of volume 1: plain data, documents, images."""
    rng = np.random.default_rng(17)
    csv_rows = "id,name,city,score\n" + "".join(
        f"{r['id']},{r['name']},{r['city']},{r['score']}\n" for r in ROWS)
    items = [rng.bytes(int(rng.integers(10, 3000))) for _ in range(12)]
    docs = [json.dumps(ROWS).encode(),
            "\n".join(json.dumps(r) for r in ROWS).encode(),
            csv_rows.encode(), json.dumps(ROWS[4]).encode()]
    images = [(_image(64, 48, "PNG", 1), "image/png"),
              (_image(80, 60, "JPEG", 2), "image/jpeg"),
              (_image(40, 40, "GIF", 3), "image/gif")]
    out = []
    for i, data in enumerate(items + docs):
        out.append((str(FileId(1, i + 1, 0x1000 + i)), data, ""))
    for j, (data, mime) in enumerate(images):
        out.append((str(FileId(1, 100 + j, 0x2000 + j)), data, mime))
    return out


def _start_pair(root, master: str, payloads, vids=(1,)):
    """A reference server that writes the payloads, then a port server
    over a copy of its files."""
    ref_dir, port_dir = root / "ref", root / "port"
    ref = RefVolumeServer([str(ref_dir)], master, port=free_port(),
                          pulse_seconds=30, ec_engine="cpu", tcp=False,
                          heat=False, ledger=False,
                          needle_cache_mb=0).start()
    for vid in vids:
        status, _, _ = exchange(ref.url, "POST", "/admin/assign_volume",
                                json.dumps({"volume_id": vid}).encode())
        assert status == 200
    for i, (fid, data, mime) in enumerate(payloads):
        headers = {"Content-Type": mime} if mime else {}
        status, _, _ = exchange(ref.url, "PUT", f"/{fid}?ts={TS + i}", data,
                                headers)
        assert status == 201
    os.makedirs(port_dir)
    for vid in vids:
        for ext in (".dat", ".idx"):
            shutil.copy(ref_dir / f"{vid}{ext}", port_dir / f"{vid}{ext}")
    port = VolumeServer([str(port_dir)], master, port=free_port(),
                        pulse_seconds=30, device="cpu",
                        needle_cache_mb=0).start()
    return ref, port, {"ref": str(ref_dir), "port": str(port_dir)}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("routes")
    master = f"127.0.0.1:{free_port()}"  # nothing listens: no replicas
    ref, port, dirs = _start_pair(root, master, _payloads(), vids=(1, 2))
    yield {"ref": ref, "port": port, "dirs": dirs, "payloads": _payloads()}
    port.stop()
    ref.stop()


def both(pair, method: str, path: str, body=None, headers=None):
    """The same request to both servers -> (reference, port) answers."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    return (exchange(pair["ref"].url, method, path, body, headers),
            exchange(pair["port"].url, method, path, body, headers))


def test_query_selects_and_filters_as_the_reference(pair):
    fids = [fid for fid, _, _ in pair["payloads"]]
    doc_array, doc_lines, doc_csv, doc_one = fids[12:16]
    queries = [
        {"from_file_ids": [doc_array]},
        {"from_file_ids": [doc_array], "selections": ["name", "tags.tier"],
         "filter": {"field": "score", "operand": ">=", "value": 20}},
        {"from_file_ids": [doc_lines], "input_format": "jsonl",
         "filter": {"field": "city", "operand": "=", "value": "Lima"}},
        {"from_file_ids": [doc_lines, doc_array], "input_format": "jsonl",
         "selections": ["id"],
         "filter": {"field": "name", "operand": "prefix", "value": "user01"}},
        {"from_file_ids": [doc_csv], "input_format": "csv",
         "selections": ["name", "score"],
         "filter": {"field": "score", "operand": "<", "value": "5"}},
        {"from_file_ids": [doc_csv], "input_format": "csv",
         "filter": {"field": "city", "operand": "contains", "value": "un"}},
        {"from_file_ids": [doc_one], "selections": ["tags", "missing"]},
        {"from_file_ids": [doc_one],
         "filter": {"field": "nothing", "operand": "!=", "value": 3}},
        {"from_file_ids": ["1,ffff0000abcd"]},            # no such needle
        {"from_file_ids": [doc_csv[:-8] + "00000000"]},  # wrong cookie
        {"from_file_ids": ["7,0101020304"]},              # no such volume
    ]
    for q in queries:
        want, got = both(pair, "POST", "/query", q)
        assert got[:2] == want[:2], q
    rows = json.loads(both(pair, "POST", "/query", queries[1])[1][1])["rows"]
    assert rows == [{"name": r["name"], "tags.tier": r["tags"]["tier"]}
                    for r in ROWS if r["score"] >= 20]


def test_stats_documents_have_the_reference_keys(pair):
    for path in ("/stats/counter", "/stats/memory", "/stats/disk"):
        want, got = both(pair, "GET", path)
        assert got[0] == want[0] == 200
        w, g = json.loads(want[1]), json.loads(got[1])
        assert set(g) == set(w), path
        assert g["Version"] == w["Version"]
    w = json.loads(both(pair, "GET", "/stats/memory")[0][1])["Memory"]
    g = json.loads(both(pair, "GET", "/stats/memory")[1][1])["Memory"]
    assert set(g) == set(w) and g["MaxRssKb"] > 0
    ref_disk, port_disk = (json.loads(a[1])["DiskStatuses"]
                           for a in both(pair, "GET", "/stats/disk"))
    assert len(port_disk) == len(ref_disk) == 1
    assert set(port_disk[0]) == set(ref_disk[0])
    assert port_disk[0]["dir"] == os.path.abspath(pair["dirs"]["port"])
    assert port_disk[0]["all"] == ref_disk[0]["all"]


def test_stats_counter_counts_as_the_reference(tmp_path):
    """Fresh servers, the same requests: equal counters by route."""
    ref, port, _ = _start_pair(tmp_path, f"127.0.0.1:{free_port()}",
                               _payloads()[:3])
    try:
        pair = {"ref": ref, "port": port}
        fid = _payloads()[0][0]
        before = [json.loads(a[1])["Counters"]
                  for a in both(pair, "GET", "/stats/counter")]
        for _ in range(3):
            both(pair, "GET", f"/{fid}")
        both(pair, "HEAD", f"/{fid}")
        both(pair, "PUT", "/1,0a0b0c0d0e?ts=5", b"new")
        both(pair, "DELETE", "/1,0a0b0c0d0e")
        both(pair, "GET", "/status")
        both(pair, "POST", "/query", {"from_file_ids": [fid]})
        after = [json.loads(a[1])["Counters"]
                 for a in both(pair, "GET", "/stats/counter")]
        moved = [{k: v - b.get(k, 0) for k, v in a.items()
                  if v != b.get(k, 0)} for b, a in zip(before, after)]
        assert moved[1] == moved[0], moved
        assert sum(moved[1].values()) >= 8
    finally:
        port.stop()
        ref.stop()


def test_resize_on_get_as_the_reference(pair):
    images = [p for p in pair["payloads"] if p[2]]
    plain = pair["payloads"][0][0]
    for fid, data, mime in images:
        for q in ("width=32", "height=20", "width=30&height=30",
                  "width=24&height=24&mode=fill", "width=abc", "width=0",
                  "width=500"):
            want, got = both(pair, "GET", f"/{fid}?{q}")
            assert got == want, (mime, q)
        want, got = both(pair, "GET", f"/{fid}?width=16")
        assert got[1] != data and Image.open(io.BytesIO(got[1])).size[0] == 16
        # the resized tag is its own; the original's does not match it
        tag = got[2]["ETag"]
        for hdr in (tag, f'"{tag.strip(chr(34)).split("-")[0]}"'):
            want, got = both(pair, "GET", f"/{fid}?width=16",
                             headers={"If-None-Match": hdr})
            assert got == want, hdr
        # a Range GET of a resize answers the resized bytes' range
        want, got = both(pair, "GET", f"/{fid}?width=16",
                         headers={"Range": "bytes=0-9"})
        assert got == want and got[0] == 206
    want, got = both(pair, "GET", f"/{plain}?width=10")
    assert got == want and got[0] == 200


def test_resize_passes_through_without_pillow(pair, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for fid, data, mime in pair["payloads"]:
        if not mime:
            continue
        want, got = both(pair, "GET", f"/{fid}?width=16")
        assert got == want
        assert got[0] == 200 and got[1] == data
        assert got[2]["Content-Type"] == mime


def test_batch_delete_as_the_reference(pair):
    fids = [fid for fid, _, _ in pair["payloads"]]
    body = {"fids": [fids[0], fids[1], "1,ffff0000abcd", "9,0101020304",
                     "not-a-fid", "1,12", fids[1]]}
    want, got = both(pair, "POST", "/admin/batch_delete", body)
    assert got == want
    results = json.loads(got[1])["results"]
    assert [r["status"] for r in results] == [202, 202, 202, 404, 404, 404,
                                              202]
    assert results[0]["size"] > 0 and results[-1]["size"] == 0
    for fid in fids[:2]:
        want, got = both(pair, "GET", f"/{fid}")
        assert got == want and got[0] == 404
    for side in ("ref", "port"):
        assert os.path.getsize(os.path.join(pair["dirs"][side], "1.dat")) > 0
    for ext in (".dat", ".idx"):
        r = open(os.path.join(pair["dirs"]["ref"], f"1{ext}"), "rb").read()
        p = open(os.path.join(pair["dirs"]["port"], f"1{ext}"), "rb").read()
        # the tombstones carry each server's own append time
        assert len(p) == len(r), ext
    want, got = both(pair, "GET", "/status")
    volumes = [{v["id"]: (v["file_count"], v["delete_count"],
                          v["deleted_byte_count"])
                for v in json.loads(a[1])["Volumes"]} for a in (want, got)]
    assert volumes[1] == volumes[0]


def test_batch_delete_on_an_ec_volume(tmp_path):
    payloads = [(str(FileId(3, i + 1, 0x3000 + i)),
                 np.random.default_rng(i).bytes(2000 + 37 * i), "")
                for i in range(20)]
    ref, port, dirs = _start_pair(tmp_path, f"127.0.0.1:{free_port()}",
                                  payloads, vids=(3,))
    pair = {"ref": ref, "port": port}
    try:
        for path in ("/admin/ec/generate", "/admin/ec/mount",
                     "/admin/delete_volume"):
            want, got = both(pair, "POST", path, {"volume_id": 3})
            assert got[0] == want[0] == 200, path
        body = {"fids": [payloads[2][0], payloads[5][0], "3,ffff0000abcd"]}
        want, got = both(pair, "POST", "/admin/batch_delete", body)
        assert got == want
        assert [r["status"] for r in json.loads(got[1])["results"]] == \
            [202, 202, 202]
        for fid, data, _ in payloads[:7]:
            want, got = both(pair, "GET", f"/{fid}")
            assert got[:2] == want[:2]
            assert got[0] == (404 if fid in body["fids"] else 200)
        for ext in (".ecx", ".ecj"):
            assert open(os.path.join(dirs["port"], f"3{ext}"), "rb").read() \
                == open(os.path.join(dirs["ref"], f"3{ext}"), "rb").read()
    finally:
        port.stop()
        ref.stop()


def test_batch_delete_fans_out_to_replicas(tmp_path, monkeypatch):
    """A batch delete reaches the volume's other replica in one request
    (``replicate``), which does not fan out again."""
    payloads = _payloads()[:6]
    out = {}
    for side, cls, kw in (
            ("ref", RefVolumeServer, dict(ec_engine="cpu", tcp=False,
                                          heat=False, ledger=False)),
            ("port", VolumeServer, dict(device="cpu"))):
        servers = []
        for k in range(2):
            d = tmp_path / side / str(k)
            s = cls([str(d)], f"127.0.0.1:{free_port()}", port=free_port(),
                    pulse_seconds=30, needle_cache_mb=0, **kw).start()
            servers.append(s)
            exchange(s.url, "POST", "/admin/assign_volume",
                     json.dumps({"volume_id": 1}).encode())
            for i, (fid, data, _) in enumerate(payloads):
                exchange(s.url, "PUT", f"/{fid}?ts={TS + i}&type=replicate",
                         data)
        urls = [s.url for s in servers]
        for s in servers:
            monkeypatch.setattr(s, "_lookup_replicas", lambda vid: urls)
        try:
            fids = [payloads[1][0], payloads[4][0], "1,ffff0000abcd"]
            status, body, _ = exchange(
                urls[0], "POST", "/admin/batch_delete",
                json.dumps({"fids": fids}).encode())
            out[side] = [status, json.loads(body)]
            for fid, _, _ in payloads:
                out[side].append([exchange(u, "GET", f"/{fid}")[0]
                                  for u in urls])
        finally:
            for s in servers:
                s.stop()
    assert out["port"] == out["ref"]
    assert out["port"][3] == [404, 404]  # payloads[1] gone on both
