"""The port's storage backends and tiering against the reference's.

The same seeded needles (their append times fixed, the clock frozen) go
into a reference and a port Volume, each with a "dir" backend of its own
package: the tier upload's remote object, `.vif` and `.idx` are byte-equal,
reads through the remote object return every needle, writes are refused
alike, a reopened volume comes up tiered, and the verified recall gives
back the `.dat` byte for byte; a double upload and an unknown backend
fail with the reference's errors.  A manifest left at each state of the
two-phase move (uploading with a partial object, pending, committed with
the `.dat` still there, recalling with a whole or a partial download)
is recovered at open to the reference's action and files, and no needle
is lost.  Servers: the four tier routes, a tiered volume's GETs, Range
GETs, writes, ``/admin/configure_replication`` (the 409) and
``/admin/ec/generate`` answer as the reference's, and the shell's
``volume.tier.upload``, ``volume.tier.download`` and ``volume.tier.move``
print the reference shell's lines.  An ``-mmap`` volume's writes, reads,
reopens and compaction leave the reference's files.  A recalled volume
EC-encoded on the CPU gives the reference's 14 shards and `.ecx`.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import mmap
import os
import re
import shutil
import sys
import threading
import time
from typing import Optional

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.codec import ReedSolomon as RefReedSolomon
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.shell.commands import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell.commands import run_command as ref_run_command
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.utils import faultinject as ref_fi
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage import backend
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import faultinject as fi
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from seaweedfs_tpu_torch.volume_server.store import Store
from tests.conftest import free_port

NOW = 1_700_000_000.25
SEED = 20261018


def _needles(n: int, seed: int = SEED) -> list[tuple[int, int, bytes, int]]:
    """(id, cookie, data, append_at_ns) of seeded needles."""
    rng = np.random.default_rng(seed)
    return [(i, int(rng.integers(1, 1 << 32)),
             rng.bytes(int(np.exp(rng.uniform(np.log(50), np.log(60_000))))),
             1_700_000_000_000_000_000 + i * 1000) for i in range(1, n + 1)]


def _fill(v, needle_cls, needles) -> None:
    for nid, cookie, data, ts in needles:
        n = needle_cls(cookie=cookie, id=nid, data=data)
        n.append_at_ns = ts
        v.write_needle(n)


def _delete(v, needle_cls, nid: int, cookie: int) -> None:
    n = needle_cls(cookie=cookie, id=nid)
    n.append_at_ns = 1_800_000_000_000_000_000 + nid
    v.delete_needle(n)


def _files(directory: str) -> dict[str, bytes]:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))
            if os.path.isfile(os.path.join(directory, name))}


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


@pytest.fixture
def pair(tmp_path):
    """Directories and a backend named "cold" for each package."""
    out = {}
    for name, mod in (("ref", ref_backend), ("port", backend)):
        root = tmp_path / name
        mod.register_backend(mod.DirBackendStorage("cold", str(root / "cold")))
        out[name] = {"dir": str(root / "v"), "cold": str(root / "cold")}
    return out


def _open_both(pair, vid: int = 7, collection: str = "", **kw):
    return (RefVolume(pair["ref"]["dir"], collection, vid, **kw),
            Volume(pair["port"]["dir"], collection, vid, **kw))


# --- the Volume ----------------------------------------------------------------

@pytest.mark.parametrize("collection", ["", "photos"])
def test_tier_upload_read_download_equal_the_reference_s(pair, frozen,
                                                         collection):
    needles = _needles(40)
    ref, port = _open_both(pair, collection=collection)
    _fill(ref, RefNeedle, needles)
    _fill(port, Needle, needles)
    for nid, cookie, _, _ in needles[5:9]:
        _delete(ref, RefNeedle, nid, cookie)
        _delete(port, Needle, nid, cookie)
    dat_sha = hashlib.sha256(open(port.dat_path, "rb").read()).hexdigest()
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])
    assert port.tier_upload("cold") == ref.tier_upload("cold")
    assert not os.path.exists(port.dat_path) and port.tiered and \
        port.read_only
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])
    assert _files(pair["port"]["cold"]) == _files(pair["ref"]["cold"])
    assert port.to_volume_information() == ref.to_volume_information()
    for nid, cookie, data, _ in needles[9:]:
        assert port.read_needle(nid, cookie).data == data
    for v, ncls in ((ref, RefNeedle), (port, Needle)):
        with pytest.raises(PermissionError, match="read only"):
            v.write_needle(ncls(cookie=1, id=999, data=b"x"))
        v.close()
    ref, port = _open_both(pair, collection=collection)
    assert port.tiered and ref.tiered
    # the committed manifest stays: a second recovery is a no-op commit
    assert port.tier_recover() == ref.tier_recover() == "finish_commit"
    loc, size, flags, name, mime = port.read_needle_meta(needles[20][0])
    assert port.read_needle_data(loc, 3, 100) == needles[20][2][3:103]
    ref.tier_download()
    port.tier_download()
    assert not port.tiered and not port.read_only
    assert hashlib.sha256(open(port.dat_path, "rb").read()).hexdigest() == \
        dat_sha
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])
    assert _files(pair["port"]["cold"]) == _files(pair["ref"]["cold"]) == {}
    more = _needles(3, SEED + 1)
    more = [(nid + 100, c, d, ts) for nid, c, d, ts in more]
    _fill(ref, RefNeedle, more)
    _fill(port, Needle, more)
    for v in (ref, port):
        v.close()
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])


def test_double_upload_and_unknown_backend_fail_alike(pair, frozen):
    ref, port = _open_both(pair)
    _fill(ref, RefNeedle, _needles(3))
    _fill(port, Needle, _needles(3))
    for v in (ref, port):
        with pytest.raises(KeyError) as e:
            v.tier_upload("nope")
        assert str(e.value) == "\"backend storage 'nope' not configured\""
        v.tier_upload("cold")
    errors = []
    for v in (ref, port):
        with pytest.raises(PermissionError) as e:
            v.tier_upload("cold")
        errors.append(str(e.value))
        with pytest.raises(PermissionError) as e:
            v.tier_abort()
        errors.append(str(e.value))
    assert errors[:2] == errors[2:]
    ref.tier_download()
    port.tier_download()
    for v in (ref, port):
        with pytest.raises(FileNotFoundError) as e:
            v.tier_download()
        errors.append(str(e.value))
        v.close()
    assert errors[-1] == errors[-2] == "volume 7 is not tiered"


def _left_at(state: str, v, needle_cls, cold: str, fault_mod) -> None:
    """Leave ``v``'s files as a crash in ``state`` would, and close it."""
    if state == "uploading":
        fault_mod.enable("tier.upload", error_rate=1.0, max_hits=1)
        with pytest.raises(OSError):
            v.tier_upload_begin("cold")
        fault_mod.clear()
        # the object half-copied when the process died
        os.makedirs(cold, exist_ok=True)
        with open(v.dat_path, "rb") as src, \
                open(os.path.join(cold, "7.dat"), "wb") as dst:
            dst.write(src.read(1000))
    elif state == "pending":
        v.tier_upload("cold", keep_local=True)
    elif state == "committed_with_dat":
        v.tier_upload_begin("cold")
        m = v.tier_manifest()
        m["state"] = "committed"
        v._save_tier_manifest(m)
    elif state in ("recalling_whole", "recalling_partial"):
        v.tier_upload("cold")
        m = v.tier_manifest()
        m["state"] = "recalling"
        v._save_tier_manifest(m)
        with open(os.path.join(cold, "7.dat"), "rb") as f:
            remote = f.read()
        if state == "recalling_whole":
            with open(v.dat_path, "wb") as f:
                f.write(remote)
        else:
            with open(v.dat_path + ".tierdl", "wb") as f:
                f.write(remote[:len(remote) // 3])
    v.close()


@pytest.mark.parametrize("state", ["uploading", "pending",
                                   "committed_with_dat", "recalling_whole",
                                   "recalling_partial"])
def test_recovery_from_each_state_loses_no_needle(pair, frozen, state):
    needles = _needles(25)
    ref, port = _open_both(pair)
    _fill(ref, RefNeedle, needles)
    _fill(port, Needle, needles)
    _left_at(state, ref, RefNeedle, pair["ref"]["cold"], ref_fi)
    _left_at(state, port, Needle, pair["port"]["cold"], fi)
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])
    actions = []
    for name, cls in (("ref", RefVolume), ("port", Volume)):
        probe = cls.__new__(cls)
        probe.file_prefix = os.path.join(pair[name]["dir"], "7")
        probe.collection, probe.id = "", 7
        actions.append(probe.tier_manifest() and
                       probe.tier_manifest()["state"])
    ref, port = _open_both(pair)
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])
    assert _files(pair["port"]["cold"]) == _files(pair["ref"]["cold"])
    assert (port.tiered, port.read_only) == (ref.tiered, ref.read_only)
    assert actions[0] == actions[1]
    for nid, cookie, data, _ in needles:
        assert port.read_needle(nid, cookie).data == data
        assert ref.read_needle(nid, cookie).data == data
    for v in (ref, port):
        v.close()


def test_recover_names_the_reference_s_actions(pair, frozen):
    for state, want in (("uploading", "gc_partial_upload"),
                        ("pending", "gc_partial_upload"),
                        ("committed_with_dat", "finish_commit"),
                        ("recalling_whole", "finish_recall"),
                        ("recalling_partial", "revert_recall")):
        for name in ("ref", "port"):
            shutil.rmtree(pair[name]["dir"], ignore_errors=True)
        ref, port = _open_both(pair)
        _fill(ref, RefNeedle, _needles(5))
        _fill(port, Needle, _needles(5))
        _left_at(state, ref, RefNeedle, pair["ref"]["cold"], ref_fi)
        _left_at(state, port, Needle, pair["port"]["cold"], fi)
        got = []
        for cls, name in ((RefVolume, "ref"), (Volume, "port")):
            probe = cls.__new__(cls)
            probe.file_prefix = os.path.join(pair[name]["dir"], "7")
            probe.collection, probe.id = "", 7
            got.append(probe.tier_recover())
        assert got == [want, want], state
        for name in ("ref", "port"):
            for f in os.listdir(pair[name]["cold"]):
                os.remove(os.path.join(pair[name]["cold"], f))


def test_reads_survive_the_recall_swap(pair):
    """Eight readers loop over every needle while the volume is tiered and
    recalled three times: no read fails, every answer is its bytes."""
    needles = _needles(60)
    v = Volume(pair["port"]["dir"], "", 7)
    _fill(v, Needle, needles)
    errors: list = []
    stop = threading.Event()

    def reader(t: int) -> None:
        while not stop.is_set():
            for nid, cookie, data, _ in needles[t::8]:
                try:
                    if v.read_needle(nid, cookie).data != data:
                        errors.append(AssertionError(nid))
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for _ in range(3):
            v.tier_upload("cold")
            time.sleep(0.05)
            v.tier_download()
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    v.close()


# --- mmap --------------------------------------------------------------------------

def test_mmap_volume_files_equal_the_reference_s(pair):
    needles = _needles(60)
    ref, port = _open_both(pair, vid=8, use_mmap=True)
    for v, ncls in ((ref, RefNeedle), (port, Needle)):
        for nid, cookie, data, ts in needles:
            n = ncls(cookie=cookie, id=nid, data=data)
            n.append_at_ns = ts
            v.write_needle(n)
            assert v.read_needle(nid, cookie).data == data  # remaps
        for nid, cookie, _, _ in needles[::3]:
            _delete(v, ncls, nid, cookie)
    assert isinstance(port._live[1], backend.MemoryMappedFile)
    for v in (ref, port):
        v.close()
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])
    for use_mmap in (True, False):
        ref, port = _open_both(pair, vid=8, use_mmap=use_mmap)
        for nid, cookie, data, _ in needles:
            if (nid - 1) % 3:
                assert port.read_needle(nid, cookie).data == data
            else:
                with pytest.raises(KeyError):
                    port.read_needle(nid, cookie)
        for v in (ref, port):
            v.close()
    ref, port = _open_both(pair, vid=8, use_mmap=True)
    for v in (ref, port):
        v.compact()
        v.commit_compact()
    assert port.data_size < sum(len(d) for _, _, d, _ in needles)
    assert port.read_needle(needles[1][0], needles[1][1]).data == \
        needles[1][2]
    for v in (ref, port):
        v.close()
    assert _files(pair["port"]["dir"]) == _files(pair["ref"]["dir"])


class _Mappings:
    """Stands in for the mmap module of one MemoryMappedFile: records every
    mapping it makes, and holds the slices of one thread (``hold``) until
    ``release`` is set."""

    ACCESS_READ = mmap.ACCESS_READ

    def __init__(self):
        self.made: list = []
        self.hold: Optional[threading.Thread] = None
        self.holding = threading.Event()
        self.release = threading.Event()

    def mmap(self, *args, **kwargs):
        m = _Mapping(self, mmap.mmap(*args, **kwargs))
        self.made.append(m)
        return m

    def open_count(self) -> int:
        return sum(not m.closed for m in list(self.made))


class _Mapping:
    def __init__(self, owner: _Mappings, mm):
        self.owner, self.mm = owner, mm

    def __getitem__(self, key):
        if threading.current_thread() is self.owner.hold and \
                not self.owner.release.is_set():
            self.owner.holding.set()
            self.owner.release.wait(30)
        return self.mm[key]

    def close(self) -> None:
        self.mm.close()

    @property
    def closed(self) -> bool:
        return self.mm.closed


def test_mmap_reads_race_appends(pair):
    """Readers of the mapped file while a writer appends: each read is its
    needle's bytes, however many remaps it crosses, and no more mappings
    stay open than one per reader plus the current one."""
    v = Volume(pair["port"]["dir"], "", 9, use_mmap=True)
    maps = v._live[1]._mmap = _Mappings()
    needles = _needles(200)
    written: list = []
    errors: list = []
    open_counts: list = []
    done = threading.Event()

    def reader() -> None:
        while not done.is_set() or written:
            for nid, cookie, data, _ in list(written):
                try:
                    if v.read_needle(nid, cookie).data != data:
                        errors.append(nid)
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)
            if done.is_set():
                break

    threads = [threading.Thread(target=reader) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for item in needles:
            _fill(v, Needle, [item])
            written.append(item)
            open_counts.append(maps.open_count())
    finally:
        done.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert max(open_counts) <= len(threads) + 1
    assert maps.open_count() == 1
    mm = v._live[1]
    v.close()
    assert mm._map.mm is None and mm._map.size == 0
    assert maps.open_count() == 0


def test_mmap_replaced_mappings_close_while_a_read_holds_one(pair):
    """One read held inside its slice of the first mapping while 100
    appends each remap under a read of the newest needle: every replaced
    mapping but the held one closes at once, and the held one when its
    read leaves, with its needle's bytes."""
    v = Volume(pair["port"]["dir"], "", 10, use_mmap=True)
    maps = v._live[1]._mmap = _Mappings()
    needles = _needles(101)
    _fill(v, Needle, needles[:1])
    got: list = []
    held = threading.Thread(target=lambda: got.append(
        v.read_needle(needles[0][0], needles[0][1]).data))
    maps.hold = held
    held.start()
    try:
        assert maps.holding.wait(30)
        for nid, cookie, data, ts in needles[1:]:
            _fill(v, Needle, [(nid, cookie, data, ts)])
            assert v.read_needle(nid, cookie).data == data
            assert maps.open_count() <= 2
    finally:
        maps.release.set()
        held.join(timeout=30)
    assert not held.is_alive() and got == [needles[0][2]]
    assert len(maps.made) == 101 and maps.open_count() == 1
    v.close()
    assert maps.open_count() == 0


# --- servers: the routes, the 409, the encode of a tiered volume ---------------------

def _exchange(url: str, method: str, path: str, body=None, headers=None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        if isinstance(body, dict):
            body = json.dumps(body).encode()
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _masked(body: bytes, dirs: list[str]) -> bytes:
    """Directories, timestamps and the clock-derived manifest fields
    masked: what differs between two servers started apart."""
    text = body.decode(errors="replace")
    for d in dirs:
        text = text.replace(d, "<dir>")
    return re.sub(r'(["\'])(modified_time|updated_at|started_at)\1: [0-9.]+',
                  r'\1\2\1: 0', text).encode()


@pytest.fixture
def server_pair(tmp_path):
    """A reference server that writes volume 1's needles, then a port
    server over a copy of its files; a "cold" backend each."""
    master = f"127.0.0.1:{free_port()}"  # nothing listens: no replicas
    dirs = {k: str(tmp_path / k) for k in ("ref", "port")}
    ref = RefVolumeServer([dirs["ref"]], master, port=free_port(),
                          pulse_seconds=30, ec_engine="tpu", heat=False,
                          ledger=False, needle_cache_mb=0, backends={
                              "cold": {"type": "dir",
                                       "root": str(tmp_path / "rcold")}})
    ref.start()
    needles = _needles(30)
    fids = [str(FileId(1, nid, cookie)) for nid, cookie, _, _ in needles]
    assert _exchange(ref.url, "POST", "/admin/assign_volume",
                     {"volume_id": 1})[0] == 200
    for i, (nid, cookie, data, _) in enumerate(needles):
        assert _exchange(ref.url, "PUT", f"/{fids[i]}?ts={1000 + i}",
                         data)[0] == 201
    os.makedirs(dirs["port"])
    for ext in (".dat", ".idx"):
        shutil.copy(os.path.join(dirs["ref"], "1" + ext),
                    os.path.join(dirs["port"], "1" + ext))
    port = VolumeServer([dirs["port"]], master, port=free_port(),
                        pulse_seconds=30, device="cpu", backends={
                            "cold": {"type": "dir",
                                     "root": str(tmp_path / "pcold")}})
    yield ref, port.start(), dirs, needles, fids
    port.stop()
    ref.stop()


def _route_transcript(needles, fids: list[str]) -> list[tuple]:
    """Requests in order.  A write that lands appends a record stamped
    with its server's own clock, so until the last recall the writes are
    a stored needle sent again: 201 and nothing appended on a writable
    volume, 409 on a frozen one."""
    fid = fids[0]
    get = [("GET", f"/{f}", None, {}) for f in fids] + [
        ("GET", f"/{fid}", None, {"Range": "bytes=7-400"}),
        ("GET", f"/{fid}", None, {"Range": "bytes=-50"}),
        ("HEAD", f"/{fid}", None, {})]
    put = [("PUT", f"/{fids[1]}?ts=1001", needles[1][2], {})]
    put_new = [("PUT", f"/{FileId(1, 900, 0x9)}?ts=9", b"late", {})]
    conf = [("POST", "/admin/configure_replication",
             {"volume_id": 1, "replication": "001"}, {}),
            ("POST", "/admin/configure_replication",
             {"volume_id": 1, "replication": "000"}, {})]
    post = lambda p, b: [("POST", p, b, {})]  # noqa: E731
    return (post("/admin/tier_upload", {"volume_id": 9, "backend": "cold"})
            + post("/admin/tier_upload", {"volume_id": 1, "backend": "x"})
            + post("/admin/tier_commit", {"volume_id": 1})
            + post("/admin/tier_abort", {"volume_id": 1})
            + post("/admin/tier_download", {"volume_id": 1})
            + post("/admin/tier_upload", {"volume_id": 1, "backend": "cold",
                                          "two_phase": True})
            + put + get
            + post("/admin/tier_upload", {"volume_id": 1, "backend": "cold",
                                          "two_phase": True})
            + post("/admin/tier_abort", {"volume_id": 1}) + put
            + post("/admin/tier_upload", {"volume_id": 1, "backend": "cold",
                                          "two_phase": True})
            + post("/admin/tier_commit", {"volume_id": 1}) + get + put + conf
            + post("/admin/tier_commit", {"volume_id": 1})
            + post("/admin/tier_abort", {"volume_id": 1})
            + post("/admin/tier_upload", {"volume_id": 1, "backend": "cold"})
            + post("/admin/volume_check", {"volume_id": 1})
            + post("/admin/ec/generate", {"volume_id": 1})
            + post("/admin/tier_download", {"volume_id": 1}) + get + put
            + conf + post("/admin/tier_download", {"volume_id": 1})
            + post("/admin/tier_upload", {"volume_id": 1, "backend": "cold",
                                          "keep_local": True})
            + get + put + put_new)


def test_tier_routes_answer_as_the_reference_s(server_pair):
    ref, port, dirs, needles, fids = server_pair
    masks = list(dirs.values())
    for i, (method, path, body, headers) in enumerate(
            _route_transcript(needles, fids)):
        want = _exchange(ref.url, method, path, body, headers)
        got = _exchange(port.url, method, path, body, headers)
        assert (got[0], _masked(got[1], masks)) == \
            (want[0], _masked(want[1], masks)), (i, method, path, want, got)
    # the 409 of a tiered volume's configure_replication, exactly
    for vs in (ref, port):
        _exchange(vs.url, "POST", "/admin/tier_download", {"volume_id": 1})
        _exchange(vs.url, "POST", "/admin/tier_upload",
                  {"volume_id": 1, "backend": "cold"})
    got = _exchange(port.url, "POST", "/admin/configure_replication",
                    {"volume_id": 1, "replication": "001"})
    assert got == (409, b'{"error": "volume 1 is tiered (read-only); '
                        b'tier.download before reconfiguring"}')
    st, body = _exchange(port.url, "POST", "/admin/ec/generate",
                         {"volume_id": 1})
    assert st == 500 and json.loads(body) == {
        "error": "FileNotFoundError: [Errno 2] No such file or directory: "
                 f"'{os.path.join(dirs['port'], '1.dat')}'"}
    assert port.store.get_volume(1).tiered
    assert not port._loop_fast_probe("GET", f"/{fids[0]}")


def _tier_cluster(tmp_path, kind: str):
    root = tmp_path / kind
    backends = {"cold": {"type": "dir", "root": str(root / "cold")}}
    if kind == "ref":
        m = RefMasterServer(port=free_port(), pulse_seconds=0.3).start()
        vs = RefVolumeServer([str(root / "v")], m.url, port=free_port(),
                             pulse_seconds=0.3, ec_engine="cpu",
                             backends=backends).start()
    else:
        m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
        vs = VolumeServer([str(root / "v")], m.url, port=free_port(),
                          pulse_seconds=0.3, device="cpu",
                          backends=backends).start()
    deadline = time.time() + 10
    while time.time() < deadline and not m.topo.all_nodes():
        time.sleep(0.05)
    return m, vs, root


@pytest.mark.parametrize("shell", ["same", "crossed"])
def test_tier_shell_commands_print_the_reference_s_lines(tmp_path, shell):
    """volume.tier.upload, .download and .move through each package's
    shell on its own cluster (``crossed``: each shell on the other's)."""
    outs = {}
    for kind in ("ref", "port"):
        m, vs, root = _tier_cluster(tmp_path, kind)
        try:
            for v in (1, 2):
                _exchange(vs.url, "POST", "/admin/assign_volume",
                          {"volume_id": v})
                for nid, cookie, data, _ in _needles(12, SEED + v):
                    _exchange(vs.url, "PUT",
                              f"/{FileId(v, nid, cookie)}?ts=1700", data)
            vs.heartbeat_now()
            use_port = (kind == "port") == (shell == "same")
            env = (CommandEnv if use_port else RefCommandEnv)(m.url)
            run = run_command if use_port else ref_run_command
            env.lock()
            lines = []
            try:
                for cmd in ("volume.tier.upload -volumeId 1 -dest cold",
                            "volume.tier.download -volumeId 1",
                            "volume.tier.upload -volumeId 2 -dest cold "
                            "-keepLocalDatFile",
                            "volume.tier.move -volumeId 1 -dest cold "
                            "-keepLocalDatFile"):
                    lines.append(run(env, cmd))
                for cmd in ("volume.tier.download -volumeId 1",
                            "volume.tier.upload -volumeId 77 -dest cold"):
                    try:
                        lines.append(run(env, cmd))
                    except Exception as e:  # noqa: BLE001 - compared
                        lines.append(f"{type(e).__name__}: {e}")
            finally:
                env.unlock()
            outs[kind] = [_masked(line.replace(vs.url, "<url>").encode(),
                                  [str(root)]) for line in lines]
            for nid, cookie, data, _ in _needles(12, SEED + 1):
                st, body = _exchange(vs.url, "GET",
                                     f"/{FileId(1, nid, cookie)}")
                assert (st, body) == (200, data)
        finally:
            vs.stop()
            m.stop()
    assert outs["port"] == outs["ref"]
    assert b"cold" in outs["port"][0] and b"downloaded" in outs["port"][1]


def test_ec_encode_of_a_tiered_volume_answers_as_the_reference_s(tmp_path):
    """The reference streams the local `.dat`, which a tiered volume does
    not have: both shells, on both packages' clusters, print the same
    failure line and leave the same files (no shard written)."""
    outs = {}
    for kind in ("ref", "port"):
        m, vs, root = _tier_cluster(tmp_path, kind)
        try:
            _exchange(vs.url, "POST", "/admin/assign_volume", {"volume_id": 1})
            for nid, cookie, data, _ in _needles(12):
                _exchange(vs.url, "PUT", f"/{FileId(1, nid, cookie)}?ts=1700",
                          data)
            vs.heartbeat_now()
            for shell in ("ref", "port"):
                env = (CommandEnv if shell == "port" else RefCommandEnv)(m.url)
                run = run_command if shell == "port" else ref_run_command
                env.lock()
                try:
                    run(env, "volume.tier.upload -volumeId 1 -dest cold")
                    out = run(env, "ec.encode -volumeId 1")
                    files = sorted(os.listdir(root / "v"))
                    run(env, "volume.tier.download -volumeId 1")
                finally:
                    env.unlock()
                outs[(kind, shell)] = (out.replace(str(root), "<root>"),
                                       files)
        finally:
            vs.stop()
            m.stop()
    want = ("ec.encode volume 1 FAILED: FileNotFoundError: [Errno 2] No such "
            "file or directory: '<root>/v/1.dat'", ["1.idx", "1.tier",
                                                    "1.vif"])
    assert len(outs) == 4 and all(v == want for v in outs.values()), outs


# --- a recalled volume, EC-encoded --------------------------------------------------

def test_recalled_volume_encodes_to_the_reference_s_shards(pair, frozen):
    needles = _needles(80)
    ref, port = _open_both(pair, vid=3)
    _fill(ref, RefNeedle, needles)
    _fill(port, Needle, needles)
    for v in (ref, port):
        v.tier_upload("cold")
        v.tier_download()
        v.close()
    base_ref = os.path.join(pair["ref"]["dir"], "3")
    ref_encoder.write_ec_files(base_ref, RefReedSolomon(10, 4))
    ref_encoder.write_sorted_file_from_idx(base_ref)
    store = Store([pair["port"]["dir"]], device="cpu")
    try:
        assert not store.get_volume(3).tiered
        store.ec_generate(3)
    finally:
        store.close()
    base = os.path.join(pair["port"]["dir"], "3")
    for ext in [to_ext(i) for i in range(14)] + [".ecx", ".eci"]:
        assert open(base + ext, "rb").read() == \
            open(base_ref + ext, "rb").read(), ext


def test_store_opens_a_tiered_volume_from_its_vif(pair, frozen):
    """A directory holding only a `.vif` and an `.idx` (the `.dat` in the
    backend) loads as a tiered volume; unmount and mount find it again."""
    v = Volume(pair["port"]["dir"], "c", 4)
    _fill(v, Needle, _needles(10))
    v.tier_upload("cold")
    v.close()
    assert sorted(os.listdir(pair["port"]["dir"])) == ["c_4.idx", "c_4.tier",
                                                       "c_4.vif"]
    store = Store([pair["port"]["dir"]], device="cpu", use_mmap=True)
    try:
        assert store.get_volume(4).tiered
        nid, cookie, data, _ = _needles(10)[3]
        assert store.read_needle(4, nid, cookie).data == data
        store.unmount_volume(4)
        store.mount_volume(4)
        assert store.get_volume(4).tiered
        info = store.collect_heartbeat()["volumes"][0]
        assert info["read_only"] and info["size"] == v.data_size
        store.delete_volume(4)
        assert os.listdir(pair["port"]["dir"]) == []
        assert os.listdir(pair["port"]["cold"]) == []
    finally:
        store.close()
