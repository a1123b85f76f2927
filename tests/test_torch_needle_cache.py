"""The needle cache, the loop's fast path, partial Range reads, degraded
GETs through the reactor and ``benchmark``: the port's VolumeServer
(``device="cpu"``) against seaweedfs_tpu's (``ec_engine="cpu"``).

Both servers serve copies of one volume the reference wrote, both on
their package's event-loop front with a 64 MiB needle cache; every
request goes to both as the same bytes and the answers must be equal byte
for byte (status line, every header but Date, body: tolerance 0).  After
the same request sequence both servers' ``NeedleCache`` documents must be
equal (the counters compared as their change over the sequence, since the
metrics are process-wide).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.volume_server.needle_cache import \
    NeedleCache as RefNeedleCache
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ops import gf_matmul as gm
from seaweedfs_tpu_torch.stats import dataplane_metrics
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import httpd as port_httpd
from seaweedfs_tpu_torch.utils.compression import gzip_data
from seaweedfs_tpu_torch.volume_server.needle_cache import (ENTRY_OVERHEAD,
                                                            NeedleCache)
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

TS = 1_700_000_000
COUNTERS = ("hits", "misses", "admissions", "evictions", "invalidations")


def raw(url: str, method: str, path: str, headers: dict = None,
        body: bytes = b"") -> tuple[bytes, bytes]:
    """One request on its own connection: (status line and headers
    without Date, body)."""
    host, port = url.split(":")
    lines = [f"{method} {path} HTTP/1.1", f"Host: {url}"]
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    if body or method in ("POST", "PUT"):
        lines.append(f"Content-Length: {len(body)}")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        rfile = s.makefile("rb")
        head, clen = [], 0
        while True:
            line = rfile.readline().rstrip(b"\r\n")
            if not line:
                break
            k, _, v = line.partition(b":")
            if k.lower() == b"content-length":
                clen = int(v)
            if k.lower() != b"date":
                head.append(line)
        data = rfile.read(clen) if method != "HEAD" else b""
        rfile.close()
    return b"\r\n".join(head), data


def _needles(seed: int, vid: int, count: int) -> list[dict]:
    """Seeded uploads: every fourth gzipped, every third named, every
    fifth typed, one with a TTL, one empty."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        data = rng.bytes(int(rng.integers(200, 20_000))) if i != 4 else b""
        fid = str(FileId(vid, i + 1, int(rng.integers(1, 1 << 32))))
        query = {"ts": str(TS + i), "type": "replicate"}
        headers = {}
        if i % 3 == 0:
            query["name"] = f"obj-{i}.bin"
        if i % 5 == 0:
            headers["Content-Type"] = "image/png"
        body = data
        if i % 4 == 1:
            body = gzip_data(data)
            headers["Content-Encoding"] = "gzip"
        if i == 6:
            query["ttl"] = "3d"
        path = f"/{fid}?" + "&".join(f"{k}={v}" for k, v in query.items())
        out.append({"fid": fid, "data": data, "path": path, "body": body,
                    "headers": headers})
    return out


def _status(url: str) -> dict:
    return json.loads(raw(url, "GET", "/status")[1])


def _cache_doc(url: str, before: dict = None) -> dict:
    """The NeedleCache document, counters as their change since
    ``before``; hit_ratio dropped (cumulative over the process)."""
    doc = dict(_status(url)["NeedleCache"])
    doc.pop("hit_ratio")
    if before is not None:
        for k in COUNTERS:
            doc[k] -= before[k]
    return doc


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    master = f"127.0.0.1:{free_port()}"  # nothing listens: no master
    ref_dir, port_dir = root / "ref", root / "port"
    ref = RefVolumeServer([str(ref_dir)], master, port=free_port(),
                          pulse_seconds=0.5, ec_engine="cpu", tcp=False,
                          heat=False, ledger=False,
                          needle_cache_mb=64).start()
    specs = _needles(11, 1, 24)
    raw(ref.url, "POST", "/admin/assign_volume", body=b'{"volume_id": 1}')
    for n in specs:
        head, _ = raw(ref.url, "PUT", n["path"], n["headers"], n["body"])
        assert head.startswith(b"HTTP/1.1 201"), head
    ref.store.unmount_volume(1)
    os.makedirs(port_dir)
    for ext in (".dat", ".idx"):
        shutil.copy(ref_dir / f"1{ext}", port_dir / f"1{ext}")
    ref.store.mount_volume(1)
    port = VolumeServer([str(port_dir)], master, port=free_port(),
                        pulse_seconds=0.5, device="cpu",
                        needle_cache_mb=64).start()
    yield {"ref": ref, "port": port, "specs": specs}
    port.stop()
    ref.stop()


def _both(servers, method, path, headers=None, body=b""):
    got = {name: raw(servers[name].url, method, path, headers, body)
           for name in ("ref", "port")}
    assert got["port"] == got["ref"], (method, path, headers)
    return got["port"]


# --- partial Range reads ----------------------------------------------------

RANGES = ["bytes=0-0", "bytes=5-", "bytes=-3", "bytes=-0", "bytes=10-5",
          "bytes=0-99999999", "bytes=99999999-", "bytes=a-b", "bytes=7-300"]


@pytest.mark.parametrize("method", ["GET", "HEAD"])
@pytest.mark.parametrize("rng", RANGES)
def test_range_reads_equal_the_references(servers, method, rng):
    """206 and 416 answers, headers included, for plain, named, typed,
    gzipped, TTL'd and empty needles of a live volume."""
    for n in servers["specs"]:
        for extra in ({}, {"Accept-Encoding": "gzip"}):
            head, body = _both(servers, method, f"/{n['fid']}",
                               {"Range": rng, **extra})
            if head.startswith(b"HTTP/1.1 206") and method == "GET" \
                    and not extra and n["data"]:
                m = re.search(rb"Content-Range: bytes (\d+)-(\d+)/", head)
                lo, hi = int(m.group(1)), int(m.group(2))
                assert body == n["data"][lo:hi + 1]


def test_a_partial_read_preads_only_its_range(servers):
    """The 206 comes from read_needle_meta and read_needle_data: no whole
    needle is read, so the store's read path is not called."""
    port = servers["port"]
    n = servers["specs"][2]  # plain, 206-able
    calls = []
    orig = port.store.read_needle
    port.store.read_needle = lambda *a, **k: (calls.append(a), orig(*a, **k))[1]
    try:
        head, body = raw(port.url, "GET", f"/{n['fid']}",
                         {"Range": "bytes=10-19"})
    finally:
        port.store.read_needle = orig
    assert head.startswith(b"HTTP/1.1 206") and body == n["data"][10:20]
    assert b"ETag" not in head
    assert calls == []


# --- the needle cache --------------------------------------------------------

def test_needle_cache_admission_hit_and_write_invalidation(servers):
    n = {"fid": str(FileId(1, 100, 0xC0FFEE)), "data": b"fresh " * 300}
    fid = FileId.parse(n["fid"])
    before = {name: _cache_doc(servers[name].url) for name in ("ref", "port")}
    _both(servers, "PUT", f"/{n['fid']}?ts={TS + 98}&type=replicate", {},
          n["data"])
    seen = []
    for step in range(3):
        _both(servers, "GET", f"/{n['fid']}")
        seen.append([servers[s].store.needle_cache.contains(
            fid.volume_id, fid.key) for s in ("ref", "port")])
    # admitted on the second read, not the first
    assert seen == [[False, False], [True, True], [True, True]]
    new = b"overwritten " * 50
    _both(servers, "PUT", f"/{n['fid']}?ts={TS + 99}&type=replicate", {},
          new)
    assert [servers[s].store.needle_cache.contains(fid.volume_id, fid.key)
            for s in ("ref", "port")] == [False, False]
    _, body = _both(servers, "GET", f"/{n['fid']}")
    assert body == new
    _both(servers, "GET", f"/{n['fid']}")
    _both(servers, "DELETE", f"/{n['fid']}?type=replicate")
    assert [servers[s].store.needle_cache.contains(fid.volume_id, fid.key)
            for s in ("ref", "port")] == [False, False]
    head, _ = _both(servers, "GET", f"/{n['fid']}")
    assert head.startswith(b"HTTP/1.1 404")
    docs = {name: _cache_doc(servers[name].url, before[name])
            for name in ("ref", "port")}
    assert docs["port"] == docs["ref"]
    assert docs["port"]["hits"] >= 1 and docs["port"]["invalidations"] >= 2


def test_needle_cache_vacuum_invalidation(servers):
    keep, gone = servers["specs"][8], servers["specs"][9]
    k = FileId.parse(keep["fid"])
    before = {name: _cache_doc(servers[name].url) for name in ("ref", "port")}
    for _ in range(2):
        _both(servers, "GET", f"/{keep['fid']}")
    assert servers["port"].store.needle_cache.contains(k.volume_id, k.key)
    _both(servers, "DELETE", f"/{gone['fid']}?type=replicate")
    for route in ("vacuum_compact", "vacuum_commit"):
        _both(servers, "POST", f"/admin/{route}", {}, b'{"volume_id": 1}')
    for name in ("ref", "port"):
        assert not servers[name].store.needle_cache.contains(k.volume_id,
                                                             k.key)
    _, body = _both(servers, "GET", f"/{keep['fid']}")
    assert body == keep["data"]
    docs = {name: _cache_doc(servers[name].url, before[name])
            for name in ("ref", "port")}
    assert docs["port"] == docs["ref"]


@pytest.mark.parametrize("admit_after", [1, 2])
def test_needle_cache_byte_bound_and_epoch_race_guard(admit_after):
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle

    out = {}
    for name, cls, ncls in (("ref", RefNeedleCache, RefNeedle),
                            ("port", NeedleCache, Needle)):
        cache = cls(max_bytes=8 * (1024 + ENTRY_OVERHEAD),
                    admit_after=admit_after)
        log = []
        for rnd in range(admit_after):
            for i in range(16):
                log.append(cache.offer(1, i, ncls(cookie=1, id=i,
                                                  data=b"x" * 1024)))
        log.append([cache.contains(1, i) for i in range(16)])
        log.append(cache.status()["bytes"])
        ep = cache.epoch(2)
        cache.invalidate(2, 99, "write")
        log.append(cache.offer(2, 99, ncls(cookie=1, id=99, data=b"old"),
                               epoch=ep))
        log.append(cache.contains(2, 99))
        big = ncls(cookie=1, id=500, data=b"y" * (cache.max_bytes // 4))
        log.append(cache.offer(1, 500, big))
        cache.invalidate_volume(1)
        log.append([cache.contains(1, i) for i in range(16)])
        log.append({k: v for k, v in cache.status().items()
                    if k not in COUNTERS + ("hit_ratio",)})
        out[name] = log
    assert out["port"] == out["ref"]
    assert out["port"][admit_after * 16][-1] and \
        not out["port"][admit_after * 16][0]


# --- the loop's fast path ------------------------------------------------------

def test_loop_fast_path_serves_hits(servers):
    n = servers["specs"][10]
    for _ in range(3):  # admitted
        _both(servers, "GET", f"/{n['fid']}")
    before = dataplane_metrics().totals()["fast_dispatches"]
    for _ in range(5):
        _, body = _both(servers, "GET", f"/{n['fid']}")
        assert body == n["data"]
    assert dataplane_metrics().totals()["fast_dispatches"] - before >= 5
    assert servers["port"]._loop_fast_probe("GET", f"/{n['fid']}")
    # a query or a Range sends it to the workers
    assert not servers["port"]._loop_fast_probe("GET", f"/{n['fid']}?x=1")


def test_the_probe_refuses_ec_and_uncached_needles(tmp_path):
    rng = np.random.default_rng(3)
    v = Volume(str(tmp_path), "", 5)
    data = {i: rng.bytes(3000) for i in range(1, 40)}
    for i, d in data.items():
        v.write_needle(Needle(cookie=i, id=i, data=d))
    v.close()
    vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{free_port()}",
                      port=free_port(), pulse_seconds=0.5, device="cpu")
    vs.start()
    try:
        fid = str(FileId(5, 7, 7))
        assert not vs._loop_fast_probe("GET", f"/{fid}")  # uncached
        for _ in range(2):
            assert port_httpd.http_bytes(
                "GET", f"http://{vs.url}/{fid}")[1] == data[7]
        assert vs._loop_fast_probe("GET", f"/{fid}")
        assert not vs._loop_fast_probe("GET", "/status")
        assert not vs._loop_fast_probe("GET", "/5,zz")
        vs.store.ec_generate(5)
        vs.store.unmount_volume(5)
        vs.store.ec_mount(5)
        # an EC volume's needle is never probed true, even one put in the
        # cache by hand
        cache = vs.store.needle_cache
        for _ in range(2):
            cache.offer(5, 7, Needle(cookie=7, id=7, data=data[7]))
        assert cache.contains(5, 7)
        assert not vs._loop_fast_probe("GET", f"/{fid}")
    finally:
        vs.stop()


# --- degraded GETs through the reactor, class (a) and (b) -----------------

class StubMaster:
    """A master that answers lookups: shard 1 lives on ``holder``."""

    def __init__(self):
        self.holder = ""
        r = port_httpd.Router("stub")

        @r.route("GET", "/dir/lookup_ec")
        def lookup_ec(req):
            return port_httpd.Response({"volumeId": 1, "shards": {
                "1": [self.holder]}})

        @r.route("GET", "/dir/lookup")
        def lookup(req):
            return port_httpd.Response({"locations": []})

        @r.route("POST", "/heartbeat")
        def heartbeat(req):
            return port_httpd.Response({})

        self.srv = port_httpd.serve(r, "127.0.0.1", 0)
        self.url = f"127.0.0.1:{self.srv.server_address[1]}"

    def stop(self):
        port_httpd.stop_server(self.srv)


def test_degraded_gets_through_the_reactor_equal_the_references(
        tmp_path, monkeypatch):
    """Front server A holds shards 2-13; B holds shard 1; shard 0 is
    gone.  A needle on shard 1 is fetched from B (class (a)), one on
    shard 0 rebuilt on A (class (b)); both packages answer alike, and the
    port's rebuild ran on a reactor worker, never on the loop."""
    rng = np.random.default_rng(21)
    src = tmp_path / "src"
    v = Volume(str(src), "", 1)
    data = {}
    for i in range(1, 90):
        data[i] = rng.bytes(int(rng.integers(20_000, 60_000)))
        n = Needle(cookie=i, id=i, data=data[i])
        n.append_at_ns = TS * 10**9 + i
        v.write_needle(n)
    v.close()
    ev = None
    fronts, others = {}, []
    threads = []
    plain = gm.gf_matmul_plain
    monkeypatch.setattr(gm, "gf_matmul_plain", lambda m, d: (
        threads.append(threading.current_thread().name), plain(m, d))[1])
    try:
        for name, cls, kw in (
                ("ref", RefVolumeServer,
                 {"ec_engine": "cpu", "tcp": False, "heat": False,
                  "ledger": False, "needle_cache_mb": 64}),
                ("port", VolumeServer, {"device": "cpu"})):
            a_dir, b_dir = tmp_path / name / "a", tmp_path / name / "b"
            os.makedirs(a_dir)
            os.makedirs(b_dir)
            for ext in (".dat", ".idx"):
                shutil.copy(src / f"1{ext}", a_dir / f"1{ext}")
            master = StubMaster()
            others.append(master)
            a = cls([str(a_dir)], master.url, port=free_port(),
                    pulse_seconds=0.5, **kw).start()
            others.append(a)
            for route, body in (("ec/generate", {"volume_id": 1}),
                                ("unmount", {"volume_id": 1}),
                                ("ec/mount", {"volume_id": 1})):
                head, _ = raw(a.url, "POST", f"/admin/{route}",
                              body=json.dumps(body).encode())
                assert head.startswith(b"HTTP/1.1 200"), (route, head)
            for ext in (".ecx", ".ec01"):
                shutil.copy(a_dir / f"1{ext}", b_dir / f"1{ext}")
            head, _ = raw(a.url, "POST", "/admin/ec/delete",
                          body=b'{"volume_id": 1, "shard_ids": [0, 1]}')
            assert head.startswith(b"HTTP/1.1 200"), head
            b = cls([str(b_dir)], master.url, port=free_port(),
                    pulse_seconds=0.5, **kw).start()
            others.append(b)
            master.holder = b.url
            fronts[name] = a
            if ev is None:
                ev = EcVolume(str(b_dir / "1"), 1)
        shard_of = {}
        for key in data:
            ivs = ev.locate_ec_shard_needle(key)[2]
            sids = {iv.to_shard_id_and_offset(ev.large_block_size,
                                              ev.small_block_size)[0]
                    for iv in ivs}
            if len(sids) == 1:
                shard_of.setdefault(sids.pop(), key)
        ev.close()
        picks = {"a": shard_of[1], "b": shard_of[0]}
        port_a = fronts["port"]
        for cls_name, key in picks.items():
            before = dict(port_a.ec_reads)
            del threads[:]
            path = f"/{FileId(1, key, key)}"
            got = {name: raw(fronts[name].url, "GET", path)
                   for name in ("ref", "port")}
            assert got["port"] == got["ref"]
            assert got["port"][0].startswith(b"HTTP/1.1 200")
            assert got["port"][1] == data[key]
            delta = {k: port_a.ec_reads[k] - before[k] for k in before}
            if cls_name == "a":
                assert delta == {"remote": 1, "reconstructed": 0}
                assert threads == []
            else:
                assert delta == {"remote": 0, "reconstructed": 1}
                assert threads and "dataplane-loop" not in threads
                assert all(t.startswith("dataplane-worker")
                           for t in threads)
    finally:
        for s in reversed(others):
            s.stop()


# --- benchmark -------------------------------------------------------------------

LINES = {
    "write": re.compile(r"^write: (\d+) x (\d+)B in [\d.]+s = \d+ req/s, "
                        r"avg [\d.]+ms p99 [\d.]+ms$"),
    "read": re.compile(r"^read: (\d+) in [\d.]+s = \d+ req/s, "
                       r"avg [\d.]+ms p99 [\d.]+ms$"),
}


def _parse(out: str) -> list:
    parsed = []
    for line in out.strip().splitlines():
        for kind, rx in LINES.items():
            m = rx.match(line)
            if m:
                parsed.append((kind,) + m.groups())
                break
        else:
            parsed.append(("unparsed", line))
    return parsed


def test_benchmark_lines_parse_like_the_references(tmp_path):
    import weed
    from seaweedfs_tpu.master.server import MasterServer as RefMaster
    from seaweedfs_tpu_torch import __main__ as port_cli
    from seaweedfs_tpu_torch.master.server import MasterServer

    outs = {}
    for name in ("ref", "port"):
        if name == "ref":
            master = RefMaster(port=free_port(), pulse_seconds=0.3).start()
            vs = RefVolumeServer([str(tmp_path / name)], master.url,
                                 port=free_port(), pulse_seconds=0.3,
                                 ec_engine="cpu", tcp=False, heat=False,
                                 ledger=False).start()
        else:
            master = MasterServer(port=free_port(),
                                  pulse_seconds=0.3).start()
            vs = VolumeServer([str(tmp_path / name)], master.url,
                              port=free_port(), pulse_seconds=0.3,
                              device="cpu").start()
        try:
            deadline = time.time() + 10
            while time.time() < deadline and not master.topo.all_nodes():
                time.sleep(0.05)
            args = argparse.Namespace(
                master=master.url, n=200, size=1024, c=4, useTcp=False,
                phase="both", fidsFile="", collection="benchmark",
                replication="000", deletePercent=0, readSequentially=False,
                seed=port_cli.BENCH_SEED, zipf=0, json=False)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = (weed.cmd_benchmark(args) if name == "ref"
                      else port_cli.cmd_benchmark(args))
            assert rc in (None, 0)
            outs[name] = buf.getvalue()
        finally:
            vs.stop()
            master.stop()
    parsed = {name: _parse(out) for name, out in outs.items()}
    assert parsed["port"] == parsed["ref"] == [
        ("write", "200", "1024"), ("read", "200")], outs


def test_benchmark_reads_check_each_needles_own_bytes(tmp_path):
    """Every benchmark needle's bytes differ and a read is held to its own
    needle's: a fids file whose payload ids are swapped between two
    needles fails the read pass."""
    from seaweedfs_tpu_torch import __main__ as port_cli
    from seaweedfs_tpu_torch.master.server import MasterServer

    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path / "vs")], master.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not master.topo.all_nodes():
            time.sleep(0.05)
        fids_file = str(tmp_path / "fids")

        def run(phase: str) -> int:
            args = argparse.Namespace(
                master=master.url, n=20, size=64, c=2, useTcp=False,
                phase=phase, fidsFile=fids_file, collection="benchmark",
                replication="000", deletePercent=0, readSequentially=True,
                seed=port_cli.BENCH_SEED, zipf=0, json=False)
            with contextlib.redirect_stdout(io.StringIO()):
                return port_cli.cmd_benchmark(args)

        assert run("write") == 0
        written = port_cli.read_fids_file(fids_file)
        bodies = {port_cli.bench_payload(pid, 64) for _, pid in written}
        assert len(written) == len(bodies) == 20
        assert run("read") == 0
        (f0, p0), (f1, p1) = written[:2]
        with open(fids_file, "w") as f:
            f.write("\n".join([f"{f0} {p1}", f"{f1} {p0}"]))
        with pytest.raises(SystemExit, match="2 answers differ"):
            run("read")
    finally:
        vs.stop()
        master.stop()
