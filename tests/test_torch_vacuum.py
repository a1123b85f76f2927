"""Vacuum in the port, against seaweedfs_tpu on the CPU, byte for byte.

The same seeded needle operations go through both packages' Volume, then
compact + commit: the `.dat`, `.idx`, superblock, counters and reads must
be equal, with writes and deletes between compact and commit too, and
after a reload.  A reader loops through commits with no error.  Over
HTTP, the port's volume server answers the four ``/admin/vacuum_*``
routes as the reference's does, and the port's master (``/vol/vacuum``,
its scan loop, the shell's ``volume.vacuum``) compacts both replicas of a
``001`` volume to the files the reference's master leaves over reference
servers.  The offline ``compact`` prints the reference's line, and the
compacted volume EC-encodes to the reference's shards, `.ecx` and `.eci`.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import seaweedfs_tpu.master.server as ref_master_mod
import seaweedfs_tpu.storage.volume as ref_volume_mod
import seaweedfs_tpu.volume_server.server as ref_server_mod
import seaweedfs_tpu_torch.master.server as master_mod
import seaweedfs_tpu_torch.storage.volume as volume_mod
import seaweedfs_tpu_torch.volume_server.server as server_mod
import weed
from seaweedfs_tpu.client.operation import WeedClient as RefWeedClient
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.streaming import StreamingEncoder as RefStreaming
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.ttl import TTL as RefTTL
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.__main__ import main as port_main
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_TTL, Needle
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.storage.volume import (HandleClosedError, Volume,
                                                volume_file_prefix)
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.store import Store
from tests.conftest import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 808
PULSE = 0.5
NS = 1_700_000_000_000_000_000
EC_EXTS = [to_ext(i) for i in range(14)] + [".ecx", ".eci"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the same operations through both packages' Volume ----------------------

def _ops(case: str) -> tuple[list[tuple], list[tuple]]:
    """(before compact, between compact and commit) operations:
    ("put", id, cookie, data, ttl) and ("del", id)."""
    rng = np.random.default_rng([SEED, len(case)])
    count = 48
    cookies = {i: int(rng.integers(1, 1 << 32)) for i in range(1, 200)}

    def put(i, size=None, ttl=""):
        size = int(rng.integers(1, 12_000)) if size is None else size
        return ("put", i, cookies[i], rng.bytes(size), ttl)

    before = [put(i, 0 if i % 11 == 4 else None) for i in range(1, count + 1)]
    between: list[tuple] = []
    if case == "deletes":
        before += [("del", i) for i in range(1, count + 1, 3)]
    elif case == "overwrites":
        before += [put(i) for i in range(2, count + 1, 5)]
        before += [("del", i) for i in (3, 8, 21)]
    elif case == "ttl":
        before += [put(100, ttl="3d"), put(101, ttl="5m"), ("del", 7),
                   ("del", 9), put(102, ttl="2h")]
    elif case == "all_deleted":
        before += [("del", i) for i in range(1, count + 1)]
    elif case == "nothing_deleted":
        pass
    elif case == "makeup_writes":
        before += [("del", i) for i in range(1, count + 1, 4)]
        between = [put(i) for i in range(120, 130)] + [put(5), put(122, 0)]
    elif case == "makeup_deletes":
        before += [("del", i) for i in range(1, count + 1, 4)]
        between = [("del", i) for i in (2, 3, 6, 10)]
    elif case == "makeup_mixed":
        before += [("del", i) for i in range(2, count + 1, 3)]
        between = [put(140), put(141), ("del", 140), put(6), ("del", 7),
                   put(142, 0), ("del", 3), put(143)]
    else:
        raise ValueError(case)
    return before, between


def _apply(v, needle_cls, ttl_cls, ops, clock: list[int]) -> None:
    for op in ops:
        clock[0] += 1
        if op[0] == "put":
            _, i, cookie, data, ttl = op
            n = needle_cls(cookie=cookie, id=i, data=data)
            n.flags = 0x08  # FLAG_HAS_LAST_MODIFIED
            n.last_modified = 1_700_000_000 + clock[0]
            if ttl:
                n.flags |= FLAG_HAS_TTL
                n.ttl = ttl_cls.parse(ttl)
            n.append_at_ns = NS + clock[0]
            v.write_needle(n)
        else:
            n = needle_cls(cookie=0, id=op[1])
            n.append_at_ns = NS + clock[0]
            v.delete_needle(n)


def _volumes(tmp_path, case: str, compact_rounds: int = 1):
    """Both packages' volume after the case's operations and
    ``compact_rounds`` compact + commit rounds (the between-operations in
    the first).  Returns (port, ref, ids ever written)."""
    before, between = _ops(case)
    port = Volume(str(tmp_path / "port"), "", 1)
    ref = RefVolume(str(tmp_path / "ref"), "", 1, needle_map_kind="compact")
    for v, ncls, tcls in ((port, Needle, TTL), (ref, RefNeedle, RefTTL)):
        clock = [0]
        _apply(v, ncls, tcls, before, clock)
        for r in range(compact_rounds):
            v.compact()
            if r == 0:
                _apply(v, ncls, tcls, between, clock)
            v.commit_compact()
    ids = sorted({op[1] for op in before + between})
    return port, ref, ids


def _reads(v, ids) -> list:
    out = []
    for i in ids:
        try:
            n = v.read_needle(i)
            out.append((i, n.cookie, n.data, n.append_at_ns))
        except (KeyError, ValueError) as e:
            out.append((i, type(e).__name__))
    return out


def _state(v) -> dict:
    info = v.to_volume_information()
    info.pop("modified_at_second")  # the mtime of each package's own file
    return {"info": info, "garbage": v.garbage_ratio(),
            "content": v.content_size,
            "revision": v.super_block.compaction_revision}


def _files(base: str, exts=(".dat", ".idx")) -> dict:
    out = {}
    for ext in exts:
        with open(base + ext, "rb") as f:
            out[ext] = hashlib.sha256(f.read()).hexdigest()
    return out


def _compare(tmp_path, port, ref, ids) -> None:
    assert _state(port) == _state(ref)
    assert _reads(port, ids) == _reads(ref, ids)
    port.close()
    ref.close()
    assert _files(str(tmp_path / "port" / "1")) == \
        _files(str(tmp_path / "ref" / "1"))
    # the counters again after a reload: replayed from the compacted .idx
    port = Volume(str(tmp_path / "port"), "", 1)
    ref = RefVolume(str(tmp_path / "ref"), "", 1, needle_map_kind="compact")
    try:
        assert _state(port) == _state(ref)
        assert _reads(port, ids) == _reads(ref, ids)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("case", ["deletes", "overwrites", "ttl",
                                  "all_deleted", "nothing_deleted"])
def test_compact_commit_equals_the_reference(case, tmp_path):
    port, ref, ids = _volumes(tmp_path, case)
    assert port.super_block.compaction_revision == 1
    assert not any(os.path.exists(str(tmp_path / "port" / "1") + ext)
                   for ext in (".cpd", ".cpx"))
    _compare(tmp_path, port, ref, ids)


@pytest.mark.parametrize("case", ["makeup_writes", "makeup_deletes",
                                  "makeup_mixed"])
def test_makeup_diff_equals_the_reference(case, tmp_path):
    """Writes and deletes that land between compact and commit survive
    the swap (makeupDiff), as in the reference."""
    port, ref, ids = _volumes(tmp_path, case)
    before, between = _ops(case)
    last = {}
    for op in before + between:
        last[op[1]] = op
    for i, op in last.items():
        if op[0] == "put" and op[3]:
            assert port.read_needle(i).data == op[3]
    _compare(tmp_path, port, ref, ids)


def test_second_compaction_counts_the_revision_on(tmp_path):
    port, ref, ids = _volumes(tmp_path, "makeup_mixed", compact_rounds=2)
    assert port.super_block.compaction_revision == 2
    _compare(tmp_path, port, ref, ids)


@pytest.mark.parametrize("case", ["deletes", "overwrites", "all_deleted"])
def test_garbage_ratio_before_and_after_a_reload(case, tmp_path):
    before, _ = _ops(case)
    ratios = {}
    for name, vcls, ncls, tcls in (("port", Volume, Needle, TTL),
                                   ("ref", RefVolume, RefNeedle, RefTTL)):
        v = vcls(str(tmp_path / name), "", 1)
        _apply(v, ncls, tcls, before, [0])
        live = v.garbage_ratio()
        v.close()
        v = vcls(str(tmp_path / name), "", 1)
        ratios[name] = (live, v.garbage_ratio(), v.nm.deletion_counter,
                        v.nm.deletion_byte_counter, v.content_size)
        v.close()
    assert ratios["port"] == ratios["ref"]
    assert ratios["port"][0] == ratios["port"][1]


def test_cleanup_compact_equals_the_reference(tmp_path):
    before, _ = _ops("deletes")
    for name, vcls, ncls, tcls in (("port", Volume, Needle, TTL),
                                   ("ref", RefVolume, RefNeedle, RefTTL)):
        v = vcls(str(tmp_path / name), "", 1)
        _apply(v, ncls, tcls, before, [0])
        base = str(tmp_path / name / "1")
        kept = _files(base)
        v.compact()
        assert os.path.exists(base + ".cpd") and os.path.exists(base + ".cpx")
        v.cleanup_compact()
        assert not os.path.exists(base + ".cpd")
        assert not os.path.exists(base + ".cpx")
        with pytest.raises(FileNotFoundError):
            v.commit_compact()
        v.cleanup_compact()  # nothing left to clean: no error
        assert v.super_block.compaction_revision == 0
        v.close()
        assert _files(base) == kept
    assert _files(str(tmp_path / "port" / "1")) == \
        _files(str(tmp_path / "ref" / "1"))


# --- reads during the swap ---------------------------------------------------

def test_reads_loop_through_commits_without_error(tmp_path, monkeypatch):
    """Eight threads read every live needle in a loop, with a short
    switch interval, while the test deletes, compacts and commits five
    times: each read returns the bytes written or, for a needle deleted
    meanwhile, DeletedError/NotFoundError.  Every `.dat` handle opened
    ends closed with no reader counted in it."""
    handles = []

    class Tracked(volume_mod._DatFile):
        def __init__(self, path):
            super().__init__(path)
            handles.append(self)

    monkeypatch.setattr(volume_mod, "_DatFile", Tracked)
    v = Volume(str(tmp_path), "", 1)
    rng = np.random.default_rng(SEED)
    data = {i: rng.bytes(int(rng.integers(100, 30_000)))
            for i in range(1, 151)}
    for i, d in data.items():
        v.write_needle(Needle(cookie=i, id=i, data=d))
    deleted: set[int] = set()
    errors: list[BaseException] = []
    reads = [0] * 8
    stop = threading.Event()

    def reader(t: int) -> None:
        while not stop.is_set():
            for i in range(1 + t, 151, 3):
                try:
                    if v.read_needle(i, cookie=i).data != data[i]:
                        raise AssertionError(f"needle {i}: wrong bytes")
                    reads[t] += 1
                except KeyError:
                    if i not in deleted:
                        errors.append(AssertionError(f"{i} lost"))
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for r in range(5):
            for i in range(1 + r, 151, 7):
                deleted.add(i)
                v.delete_needle(Needle(cookie=i, id=i))
            at = sum(reads)
            v.compact()
            v.commit_compact()
            deadline = time.monotonic() + 30
            while sum(reads) < at + 400 and time.monotonic() < deadline:
                time.sleep(0.001)  # the readers cross each commit
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert v.super_block.compaction_revision == 5 and sum(reads) >= 2000
    v.close()
    assert len(handles) == 6
    assert all(h._closing and h._readers == 0 for h in handles)


def test_a_read_on_a_closed_volume_fails_at_once(tmp_path):
    v = Volume(str(tmp_path), "", 1)
    v.write_needle(Needle(cookie=1, id=1, data=b"x" * 100))
    v.close()
    with pytest.raises(HandleClosedError):
        v.read_needle(1)


# --- the store and the volume server -----------------------------------------

def test_store_vacuum_takes_the_volume_lock_and_queues_the_change(tmp_path):
    store = Store([str(tmp_path)], device="cpu")
    try:
        store.add_volume(1)
        for i in range(1, 21):
            store.write_needle(1, Needle(cookie=i, id=i, data=b"v" * 3000))
        for i in range(1, 11):
            store.delete_needle(1, Needle(cookie=i, id=i))
        store.pop_heartbeat_delta()
        # an EC encode holds the volume's lock: the compact waits for it
        with store.volume_locks[1]:
            t = threading.Thread(target=store.vacuum_compact, args=(1,))
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive()
        t.join(timeout=30)
        assert not t.is_alive()
        assert store.pop_heartbeat_delta() is None
        store.vacuum_commit(1)
        delta = store.pop_heartbeat_delta()
        (info,) = delta["new_volumes"]
        v = store.get_volume(1)
        assert info["compact_revision"] == 1
        assert info["size"] == v.data_size < 20 * 3000
        assert (info["file_count"], info["delete_count"]) == (10, 0)
    finally:
        store.close()


class _Clock:
    """The clock needle writes read: a fixed second and a counting
    nanosecond, so two clusters write identical `.dat` files."""

    def __init__(self, real):
        self._real = real
        self._ns = NS

    def time(self) -> float:
        return 1_700_000_000.0

    def time_ns(self) -> int:
        self._ns += 1000
        return self._ns

    def __getattr__(self, name):
        return getattr(self._real, name)


class _Secrets:
    """Seeded fid cookies and lease tokens in both masters."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def randbits(self, k: int) -> int:
        return self._rng.getrandbits(k)


def _exchange(url: str, method: str, path: str, body=None) -> tuple:
    status, data, _ = http_bytes(method, f"http://{url}{path}", body,
                                 follow_redirects=False)
    return status, data


def _route_transcript(kind: str, root) -> tuple[list, dict]:
    d = str(root / kind)
    nowhere = f"127.0.0.1:{free_port()}"  # no master listens
    if kind == "port":
        vs = server_mod.VolumeServer([d], nowhere, port=free_port(),
                                     pulse_seconds=0.5, device="cpu")
    else:
        vs = RefVolumeServer([d], nowhere, port=free_port(),
                             pulse_seconds=0.5, ec_engine="cpu", tcp=False,
                             heat=False, ledger=False, needle_cache_mb=0)
    vs.start()
    rng = np.random.default_rng(SEED)
    out = []

    def post(path: str, vid: int = 1) -> None:
        out.append((path, vid, _exchange(vs.url, "POST", path, json.dumps(
            {"volume_id": vid}).encode())))

    try:
        post("/admin/assign_volume")
        fids = [f"1,{i:x}{int(rng.integers(1, 1 << 32)):08x}"
                for i in range(1, 31)]
        for i, fid in enumerate(fids):
            out.append(_exchange(vs.url, "PUT", f"/{fid}?ts={1_700_000_000 + i}",
                                 rng.bytes(int(rng.integers(1, 9000)))))
        for fid in fids[::3]:
            out.append(_exchange(vs.url, "DELETE", f"/{fid}"))
        post("/admin/vacuum_check")
        post("/admin/vacuum_compact")
        out.append(_exchange(vs.url, "PUT", f"/1,ff0000beef?ts=1700000100",
                             b"between compact and commit"))
        out.append(_exchange(vs.url, "DELETE", f"/{fids[1]}"))
        post("/admin/vacuum_commit")
        post("/admin/vacuum_check")
        post("/admin/vacuum_compact")
        post("/admin/vacuum_cleanup")
        post("/admin/vacuum_commit")  # nothing compacted to commit
        for path in ("/admin/vacuum_check", "/admin/vacuum_compact",
                     "/admin/vacuum_commit", "/admin/vacuum_cleanup"):
            post(path, vid=99)
        for fid in fids + ["1,ff0000beef"]:
            out.append(_exchange(vs.url, "GET", f"/{fid}"))
    finally:
        vs.stop()
    return out, _files(os.path.join(d, "1"))


def test_vacuum_routes_answer_as_the_reference(tmp_path, monkeypatch):
    got = {}
    for kind in ("ref", "port"):
        with monkeypatch.context() as m:
            for mod in (volume_mod, server_mod, ref_volume_mod,
                        ref_server_mod):
                m.setattr(mod, "time", _Clock(time))
            got[kind] = _route_transcript(kind, tmp_path)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    statuses = [e[2][0] for e in got["port"][0] if isinstance(e[0], str)
                and e[1] == 99]
    assert statuses == [404] * 4


# --- the master: /vol/vacuum, the shell, the scan loop -----------------------

def _wait(what: str, ok, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not ok():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


@contextlib.contextmanager
def _cluster(kind: str, root, monkeypatch, pulse: float = PULSE,
             **master_attrs):
    """A master and two volume servers of one package, started one at a
    time on ports that sort as strings, the masters' secrets seeded.
    Each server heartbeats once at its start, then every ``pulse``.
    ``master_attrs`` are set on the master before it starts."""
    for mod in (master_mod, ref_master_mod):
        monkeypatch.setattr(mod, "secrets", _Secrets(SEED))
    mcls = MasterServer if kind == "port" else RefMasterServer
    master = mcls(port=free_port(), volume_size_limit_mb=64,
                  pulse_seconds=pulse)
    for name, value in master_attrs.items():
        setattr(master, name, value)
    master.start()
    ports = set()
    while len(ports) < 2:
        p = free_port()
        if 10000 <= p <= 65535:
            ports.add(p)
    servers, dirs = [], []
    try:
        for i, port in enumerate(sorted(ports, key=str)):
            d = str(root / f"{kind}{i}")
            os.makedirs(d)
            dirs.append(d)
            if kind == "port":
                vs = server_mod.VolumeServer([d], master.url, port=port,
                                             pulse_seconds=pulse,
                                             device="cpu")
            else:
                vs = RefVolumeServer([d], master.url, port=port,
                                     pulse_seconds=pulse, tcp=False,
                                     needle_cache_mb=0)
            servers.append(vs.start())
            _wait("registration",
                  lambda: len(master.topo.all_nodes()) == i + 1)
        random.seed(SEED)
        if kind == "port":
            master.topo.rng.seed(SEED)
        yield master, servers, dirs
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def _fill(kind: str, master, servers, monkeypatch) -> tuple:
    """A 001 volume of collection "vac" on both servers: 40 seeded
    uploads through the client, then deletes of 45% of them."""
    vid = http_json("GET", f"http://{master.url}/vol/grow?collection=vac"
                           f"&replication=001&count=1")["volumeIds"][0]
    client = (WeedClient if kind == "port" else RefWeedClient)(master.url)
    rng = np.random.default_rng(SEED)
    blobs = [rng.bytes(int(rng.integers(500, 20_000))) for _ in range(40)]
    with monkeypatch.context() as m:
        for mod in (volume_mod, server_mod, ref_volume_mod, ref_server_mod):
            m.setattr(mod, "time", _Clock(time))
        fids = [client.upload(b, collection="vac", replication="001")
                for b in blobs]
        gone = sorted(int(i) for i in rng.choice(40, 18, replace=False))
        for i in gone:
            client.delete(fids[i])
    for vs in servers:
        vs.heartbeat_now()
    return vid, client, fids, blobs, gone


def _check_vacuumed(master, servers, dirs, vid, fids, blobs, gone) -> dict:
    """Both replicas at revision 1, their survivors read back from each,
    deleted needles 404, and /dir/status showing the new size, writable;
    returns every replica's file hashes."""
    for vs in servers:
        v = vs.store.volumes[vid]
        assert v.super_block.compaction_revision == 1
        assert v.garbage_ratio() == 0
        for i, fid in enumerate(fids):
            status, body, _ = http_bytes("GET", f"http://{vs.url}/{fid}")
            if i in gone:
                assert status == 404, (vs.url, i)
            else:
                assert (status, body) == (200, blobs[i]), (vs.url, i)

    def shown() -> bool:
        for vs in servers:
            vs.heartbeat_now()
        doc = http_json("GET", f"http://{master.url}/dir/status")
        infos = {n["Url"]: {v["id"]: v for v in n["VolumeInfos"]}
                 for dc in doc["Topology"]["DataCenters"]
                 for rack in dc["Racks"] for n in rack["DataNodes"]}
        return all(infos[vs.url][vid]["size"] == vs.store.volumes[vid].data_size
                   and infos[vs.url][vid]["read_only"] is False
                   and infos[vs.url][vid]["delete_count"] == 0
                   for vs in servers)

    _wait("/dir/status to show the compacted size", shown)
    layout = next(lay for lay in master.topo.layouts.values()
                  if vid in lay.vid_to_nodes)
    assert vid in layout.writables
    return {i: _files(volume_file_prefix(d, "vac", vid))
            for i, d in enumerate(dirs)}


def _vacuum_run(kind: str, how: str, root, monkeypatch) -> dict:
    with _cluster(kind, root, monkeypatch) as (master, servers, dirs):
        vid, client, fids, blobs, gone = _fill(kind, master, servers,
                                               monkeypatch)
        sizes = [vs.store.volumes[vid].data_size for vs in servers]
        if how == "route":
            none = http_json("GET", f"http://{master.url}/vol/vacuum"
                                    f"?garbageThreshold=0.9")
            done = http_json("GET", f"http://{master.url}/vol/vacuum"
                                    f"?garbageThreshold=0.3")
            bad = http_bytes("GET", f"http://{master.url}/vol/vacuum"
                                    f"?garbageThreshold=abc")[0]
            outputs = [none, done, bad]
        else:
            env = (CommandEnv if kind == "port" else RefCommandEnv)(
                master.url)
            run = run_command if kind == "port" else ref_run_command
            outputs = [run(env, "volume.vacuum -garbageThreshold 0.9"),
                       run(env, "volume.vacuum"),
                       run(env, "volume.vacuum -garbageThreshold 0.3")]
        files = _check_vacuumed(master, servers, dirs, vid, fids, blobs, gone)
        return {"outputs": outputs, "files": files, "vid": vid,
                "shrunk": [vs.store.volumes[vid].data_size < s
                           for vs, s in zip(servers, sizes)],
                "fids": fids}


@pytest.mark.parametrize("how", ["route", "shell"])
def test_master_vacuum_equals_the_reference(how, tmp_path, monkeypatch):
    """GET /vol/vacuum (or the shell's volume.vacuum) compacts both
    replicas of a 001 volume: the same answers and the same files on
    each replica as the reference's master over reference servers."""
    ref = _vacuum_run("ref", how, tmp_path, monkeypatch)
    got = _vacuum_run("port", how, tmp_path, monkeypatch)
    assert got == ref
    assert got["shrunk"] == [True, True]
    vid = got["vid"]
    if how == "route":
        assert got["outputs"][:2] == [{"compacted": []},
                                      {"compacted": [vid]}]
        assert got["outputs"][2] == 400
    else:
        assert got["outputs"] == ["compacted volumes: []",
                                  f"compacted volumes: [{vid}]",
                                  "compacted volumes: []"]


def test_scan_loop_vacuums_both_replicas(tmp_path, monkeypatch):
    """No operator: the port master's scan loop (every 0.5 s) compacts a
    001 volume past the threshold on both replicas."""
    with _cluster("port", tmp_path, monkeypatch,
                  vacuum_scan_seconds=0.5) as (master, servers, dirs):
        vid, client, fids, blobs, gone = _fill("port", master, servers,
                                               monkeypatch)
        _wait("the scan loop to compact both replicas",
              lambda: all(vs.store.volumes[vid].super_block
                          .compaction_revision == 1 for vs in servers))
        _check_vacuumed(master, servers, dirs, vid, fids, blobs, gone)
        for i in range(0, 40, 4):
            if i not in gone:
                assert client.download(fids[i]) == blobs[i]


def test_failed_compact_commits_nothing(tmp_path, monkeypatch):
    """One replica's compact raises: the master commits no replica, the
    volume is writable again, and the other replica's .cpd/.cpx wait for
    /admin/vacuum_cleanup, as in the reference.  No periodic heartbeat
    runs: one would put the volume back in the writable set mid-vacuum
    (a heartbeat's read_only flag wins, in the reference too)."""
    with _cluster("port", tmp_path, monkeypatch, pulse=120.0) as (
            master, servers, dirs):
        vid, client, fids, blobs, gone = _fill("port", master, servers,
                                               monkeypatch)
        broken = servers[1].store.volumes[vid]
        layout = next(lay for lay in master.topo.layouts.values()
                      if vid in lay.vid_to_nodes)
        writable_during = []

        def fail() -> None:
            writable_during.append(vid in layout.writables)
            raise OSError("disk full")

        monkeypatch.setattr(broken, "compact", fail)
        r = http_json("GET", f"http://{master.url}/vol/vacuum")
        assert r == {"compacted": []}
        # out of the writable set while the replicas compact, back after
        assert writable_during == [False]
        assert vid in layout.writables and vid not in layout.readonly
        base = volume_file_prefix(dirs[0], "vac", vid)
        for vs in servers:
            assert vs.store.volumes[vid].super_block.compaction_revision == 0
        assert os.path.exists(base + ".cpd") and os.path.exists(base + ".cpx")
        http_json("POST", f"http://{servers[0].url}/admin/vacuum_cleanup",
                  {"volume_id": vid})
        assert not os.path.exists(base + ".cpd")
        assert not os.path.exists(base + ".cpx")
        for i in range(40):
            if i not in gone:
                assert client.download(fids[i]) == blobs[i]


def test_shell_vacuum_waits_for_the_master(monkeypatch):
    """A full-size vacuum outlasts the shell's usual 30 s: volume.vacuum
    waits for the master's answer, which bounds each replica call itself;
    under a caller's deadline the wait is the budget left."""
    import seaweedfs_tpu_torch.shell.commands as commands_mod
    from seaweedfs_tpu_torch.utils import deadline

    calls = []

    def fake_http_json(method, url, payload=None, timeout=30.0):
        calls.append((method, url, timeout))
        return {"compacted": [7]}

    monkeypatch.setattr(commands_mod, "http_json", fake_http_json)
    env = CommandEnv("127.0.0.1:1")
    assert run_command(env, "volume.vacuum") == "compacted volumes: [7]"
    assert calls == [("GET", "http://127.0.0.1:1/vol/vacuum"
                             "?garbageThreshold=0.3", None)]
    assert deadline.clamp(None) is None
    with deadline.scope(5.0):
        assert 0 < deadline.clamp(None) <= 5.0


# --- the offline compact and the encode of a compacted volume ----------------

def test_offline_compact_prints_the_reference_line(tmp_path, capsys):
    before, _ = _ops("deletes")
    for name, vcls, ncls, tcls in (("port", Volume, Needle, TTL),
                                   ("ref", RefVolume, RefNeedle, RefTTL)):
        v = vcls(str(tmp_path / name), "c", 3)
        _apply(v, ncls, tcls, before, [0])
        v.close()
    shutil.copytree(str(tmp_path / "port"), str(tmp_path / "cli"))
    weed.cmd_compact(argparse.Namespace(dir=str(tmp_path / "ref"),
                                        collection="c", volumeId=3))
    want = capsys.readouterr().out
    assert port_main(["compact", "-dir", str(tmp_path / "port"),
                      "-collection", "c", "-volumeId", "3"]) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("compact: volume 3 ") and want.endswith(" bytes\n")
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "compact", "-dir", str(tmp_path / "cli"),
                        "-collection", "c", "-volumeId", "3"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert (r.returncode, r.stdout) == (0, want), r.stderr
    assert _files(str(tmp_path / "port" / "c_3")) == \
        _files(str(tmp_path / "ref" / "c_3")) == \
        _files(str(tmp_path / "cli" / "c_3"))


@pytest.mark.parametrize("case", ["deletes", "makeup_mixed"])
def test_ec_encode_of_a_compacted_volume_equals_the_reference(case,
                                                              tmp_path):
    """The port's Store.ec_generate of its compacted volume against the
    reference's device encoder (XLA on the CPU) of its own: shards, .ecx
    and .eci byte for byte; the encoder's dispatch count as its rule
    says."""
    port, ref, _ = _volumes(tmp_path, case)
    port.close()
    ref.close()
    rbase = str(tmp_path / "ref" / "1")
    RefStreaming(10, 4, engine="device", mesh=False).encode_file(
        rbase + ".dat", rbase)
    ref_encoder.write_sorted_file_from_idx(rbase)
    store = Store([str(tmp_path / "port")], device="cpu")
    try:
        store.ec_generate(1)
        enc = store.streaming_encoder()
        size = os.path.getsize(str(tmp_path / "port" / "1.dat"))
        assert enc.stats["dispatches"] == enc.dispatches_for(size)
    finally:
        store.close()
    pbase = str(tmp_path / "port" / "1")
    assert _files(pbase, EC_EXTS) == _files(rbase, EC_EXTS)


@pytest.mark.parametrize("size", [8 + 40, (3 << 20) + 1, (16 << 20) + 1,
                                  (24 << 20) + 7])
def test_dispatch_rule_matches_the_encode(size, tmp_path):
    """dispatches_for() equals the dispatches an encode makes, at a
    geometry with large rows (1.5 MiB a shard, wider than a dispatch)
    and small ones."""
    path = str(tmp_path / "v.dat")
    with open(path, "wb") as f:
        f.write(np.random.default_rng(size).bytes(size))
    enc = StreamingEncoder(dispatch_mb=1, device="cpu")
    large, small = 1536 * 1024, 64 * 1024
    enc.encode_file(path, str(tmp_path / "v"), large, small)
    assert enc.stats["dispatches"] == enc.dispatches_for(size, large, small)
