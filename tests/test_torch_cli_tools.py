"""The port CLI's ``fix``, ``export``, ``upload``, ``download`` and
``backup`` against ``weed.py``'s, on the same volumes.

``fix`` and ``export`` run on two copies of one volume the reference
wrote: the rebuilt `.idx`, the listings and the tars must be equal byte
for byte (paths masked).  ``upload``, ``download`` and ``backup`` run on a
port master and volume server, each CLI in a subprocess: the uploads store
the same needles (name, TTL) and each CLI downloads the other's fids; the
two backups leave equal followers, whose `.dat` is the source's.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tarfile
import time

import pytest

from seaweedfs_tpu.storage.needle import FLAG_HAS_NAME as REF_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.httpd import http_bytes
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000_000_000_000


def run(side: str, *argv: str) -> subprocess.CompletedProcess:
    cmd = ([sys.executable, os.path.join(ROOT, "weed.py")] if side == "ref"
           else [sys.executable, "-m", "seaweedfs_tpu_torch"])
    return subprocess.run(cmd + list(argv), capture_output=True, text=True,
                          timeout=120, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT,
                               "JAX_PLATFORMS": "cpu"})


def make_volume(d: str, vid: int = 7, count: int = 12) -> None:
    """A reference-written volume: named needles, two deleted, one
    overwritten."""
    v = RefVolume(d, "c", vid)
    for i in range(1, count + 1):
        n = RefNeedle(cookie=i, id=i, data=b"data-%d" % i * i)
        n.name = b"file%d.txt" % i
        n.set_flag(REF_HAS_NAME)
        n.last_modified = 1_600_000_000 + i
        n.append_at_ns = T0 + i
        v.write_needle(n)
    for nid in (2, 9):
        t = RefNeedle(cookie=nid, id=nid)
        t.append_at_ns = T0 + 100 + nid
        v.delete_needle(t)
    n = RefNeedle(cookie=4, id=4, data=b"rewritten")
    n.append_at_ns = T0 + 200
    v.write_needle(n)
    v.close()


@pytest.fixture
def copies(tmp_path):
    make_volume(str(tmp_path / "ref"))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    return {side: str(tmp_path / side) for side in ("ref", "port")}


def masked(r: subprocess.CompletedProcess, d: str) -> tuple:
    return r.returncode, r.stdout.replace(d, "<dir>")


def test_fix_rebuilds_the_reference_index(copies):
    original = open(os.path.join(copies["ref"], "c_7.idx"), "rb").read()
    outs = {}
    for side, d in copies.items():
        with open(os.path.join(d, "c_7.idx"), "wb") as f:
            f.write(b"garbage!")
        r = run(side, "fix", "-dir", d, "-collection", "c", "-volumeId", "7")
        assert r.returncode == 0, r.stderr
        outs[side] = masked(r, d)
    assert outs["port"] == outs["ref"]
    assert "scanned 15 records (10 live)" in outs["port"][1]
    for side, d in copies.items():
        assert open(os.path.join(d, "c_7.idx"), "rb").read() == original
    v = Volume(copies["port"], "c", 7)
    try:
        assert v.read_needle(4).data == b"rewritten"
        with pytest.raises(KeyError):
            v.read_needle(9)
    finally:
        v.close()


def test_fix_keeps_the_index_of_a_malformed_dat(copies):
    original = open(os.path.join(copies["ref"], "c_7.idx"), "rb").read()
    for side, d in copies.items():
        with open(os.path.join(d, "c_7.dat"), "wb") as f:
            f.write(b"\xde\xad")
        r = run(side, "fix", "-dir", d, "-collection", "c", "-volumeId", "7")
        assert r.returncode != 0, side
        assert open(os.path.join(d, "c_7.idx"), "rb").read() == original
        assert not os.path.exists(os.path.join(d, "c_7.idx_fix"))


@pytest.mark.parametrize("flags", [[], ["-deleted"], ["-limit", "3"],
                                   ["-deleted", "-limit", "5"]])
def test_export_lists_as_the_reference(copies, flags):
    outs = {side: masked(run(side, "export", "-dir", d, "-collection", "c",
                             "-volumeId", "7", *flags), d)
            for side, d in copies.items()}
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == 0 and outs["port"][1]


def test_export_tar_equals_the_reference(copies, tmp_path):
    tars = {}
    for side, d in copies.items():
        out = str(tmp_path / f"{side}.tar")
        r = run(side, "export", "-dir", d, "-collection", "c",
                "-volumeId", "7", "-o", out)
        assert r.returncode == 0, r.stderr
        # the overwritten needle's old record is exported too: both
        # records carry a live id (the reference's walk of the .dat)
        assert r.stdout.replace(out, "<tar>") == \
            "export: wrote 11 files to <tar>\n"
        tars[side] = open(out, "rb").read()
    assert tars["port"] == tars["ref"]
    with tarfile.open(tmp_path / "port.tar") as t:
        assert t.extractfile("4_file4.txt").read() == b"data-4" * 4
        assert t.extractfile("4").read() == b"rewritten"


@pytest.fixture
def cluster(tmp_path):
    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path / "vs")], master.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.all_nodes():
        time.sleep(0.05)
    yield master, vs
    vs.stop()
    master.stop()


def test_upload_and_download_as_the_reference(cluster, tmp_path):
    master, vs = cluster
    src = tmp_path / "up"
    (src / "sub").mkdir(parents=True)
    files = {"a.log": b"alpha log", "b.dat": b"not matched",
             "sub/c.log": b"gamma" * 100}
    for name, data in files.items():
        (src / name).write_bytes(data)
    fids = {}
    for side in ("ref", "port"):
        r = run(side, "upload", "-master", master.url, "-dir", str(src),
                "-include", "*.log", "-ttl", "1h", "-collection", "cli")
        assert r.returncode == 0, r.stderr
        lines = [json.loads(line) for line in r.stdout.splitlines()]
        assert [os.path.relpath(x["file"], src) for x in lines] == \
            ["a.log", "sub/c.log"]
        fids[side] = [x["fid"] for x in lines]
        one = run(side, "upload", "-master", master.url,
                  str(src / "b.dat"))
        assert one.returncode == 0, one.stderr
        fids[side].append(json.loads(one.stdout)["fid"])
        assert run(side, "upload", "-master", master.url).returncode != 0
    client = WeedClient(master.url)
    for k, want in enumerate([b"alpha log", b"gamma" * 100, b"not matched"]):
        answers = []
        for side in ("ref", "port"):
            fid = fids[side][k]
            url = client.master.lookup(int(fid.split(",")[0]))[0]
            status, body, hdrs = http_bytes("GET", f"http://{url}/{fid}")
            answers.append((status, body, hdrs.get("Content-Disposition")))
            for reader in ("ref", "port"):
                out = tmp_path / f"{reader}-{side}-{k}"
                r = run(reader, "download", "-master", master.url,
                        "-o", str(out), fid)
                assert r.returncode == 0, r.stderr
                assert r.stdout == f"wrote {len(want)} bytes to {out}\n"
                assert out.read_bytes() == want
            r = run("port", "download", "-master", master.url, fid)
            assert r.returncode == 0 and r.stdout.encode() == want
        assert answers[0] == answers[1]
        assert answers[0][:2] == (200, want)
    # the TTL went with the -dir uploads: their volumes carry it
    vols = {v["id"]: v for v in vs.store.collect_heartbeat()["volumes"]}
    for side in ("ref", "port"):
        assert vols[int(fids[side][0].split(",")[0])]["ttl"] != 0


def test_backup_as_the_reference(cluster, tmp_path):
    """Both CLIs back up the same volume, then, after more writes and
    deletes, again: each second run applies only what is new, and the
    followers equal each other and the source."""
    master, vs = cluster
    client = WeedClient(master.url)
    fids = [client.upload(b"needle %d " % i * (i + 1), collection="bk")
            for i in range(30)]
    vid = int(fids[0].split(",")[0])
    fids = [f for f in fids if int(f.split(",")[0]) == vid]
    outs = {}
    for side in ("ref", "port"):
        d = str(tmp_path / f"follow-{side}")
        r = run(side, "backup", "-master", master.url, "-volumeId",
                str(vid), "-dir", d, "-collection", "bk")
        assert r.returncode == 0, r.stderr
        outs[side] = [r.stdout.replace(d, "<dir>")]
    assert outs["port"] == outs["ref"]
    assert f"applied {len(fids)} records" in outs["port"][0]
    for f in fids[:3]:
        client.delete(f)
    more = [client.upload(b"more %d" % i, collection="bk")
            for i in range(8)]
    new = 3 + sum(int(f.split(",")[0]) == vid for f in more)
    for side in ("ref", "port"):
        d = str(tmp_path / f"follow-{side}")
        r = run(side, "backup", "-master", master.url, "-volumeId",
                str(vid), "-dir", d, "-collection", "bk")
        assert r.returncode == 0, r.stderr
        outs[side].append(r.stdout.replace(d, "<dir>"))
    assert outs["port"] == outs["ref"]
    assert f"applied {new} records" in outs["port"][1]
    source = vs.store.get_volume(vid)
    for side in ("ref", "port"):
        for ext in (".dat", ".idx"):
            got = open(os.path.join(tmp_path, f"follow-{side}",
                                    f"bk_{vid}{ext}"), "rb").read()
            assert got == open(source.file_prefix + ext, "rb").read(), \
                (side, ext)
    r = run("port", "backup", "-master", master.url, "-volumeId", "999",
            "-dir", str(tmp_path / "none"))
    assert r.returncode != 0
