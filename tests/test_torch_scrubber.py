"""The port's EC scrubber against seaweedfs_tpu's, case by case.

Each case runs on two copies of one volume that the reference wrote: the
reference's Store and EcScrubber on one, the port's Store(device="cpu")
and EcScrubber on the other, with the same rot planted in both.  Verdicts
must be equal but for their time stamp, and so must the `.bad` files, the
repaired shards, the `.eci` and the change of the integrity counters
(tolerance 0: bytes).  The cases are those of tests/test_ec_integrity.py
for the reference's scrubber, plus the port's scrub routes, its heartbeat
after a quarantine, reads during a quarantine and the ``ec.scrub`` shell
command against the reference shell's output.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.integrity import EciSidecar as RefEciSidecar
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.stats import ec_integrity_metrics as ref_integrity_metrics
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.scrubber import EcScrubber as RefScrubber
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch.ec.integrity import EciSidecar
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.stats import ec_integrity_metrics
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils import faultinject as fi
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.scrubber import EcScrubber
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from seaweedfs_tpu_torch.volume_server.store import Store
from tests.conftest import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD_EXTS = [to_ext(i) for i in range(14)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_volume(directory: str, seed: int, vid: int = 1,
                  n_needles: int = 60) -> list[tuple[int, int, bytes]]:
    """A volume written by the reference: (id, cookie, data) per needle."""
    rng = np.random.default_rng(seed)
    v = RefVolume(directory, "", vid)
    out = []
    for i in range(1, n_needles + 1):
        data = rng.bytes(int(rng.integers(1, 800)))
        v.write_needle(RefNeedle(cookie=i, id=i, data=data))
        out.append((i, i, data))
    v.close()
    return out


def _flip(path: str, offset: int, bit: int = 0) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        c = f.read(1)
        f.seek(offset)
        f.write(bytes([c[0] ^ (1 << bit)]))


def _files(base: str) -> dict[str, bytes]:
    out = {}
    for ext in SHARD_EXTS + [e + ".bad" for e in SHARD_EXTS] + [".eci"]:
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                out[ext] = f.read()
    return out


def _verdicts(st: dict) -> dict:
    return {v: {k: x for k, x in d.items() if k != "at"}
            for v, d in st["verdicts"].items()}


class _Pair:
    """One volume encoded by both stores, one scrubber over each."""

    def __init__(self, root):
        src, self.dirs = root / "src", {"ref": root / "ref",
                                        "port": root / "port"}
        os.makedirs(src)
        self.needles = _write_volume(str(src), seed=11)
        for d in self.dirs.values():
            os.makedirs(d)
            for ext in (".dat", ".idx"):
                shutil.copy(src / f"1{ext}", d / f"1{ext}")
        self.stores = {"ref": RefStore([str(self.dirs["ref"])]),
                       "port": Store([str(self.dirs["port"])], device="cpu")}
        for s in self.stores.values():
            s.ec_generate(1)
            s.ec_mount(1)
        self.bases = {k: os.path.join(str(d), "1")
                      for k, d in self.dirs.items()}
        self.scrubbers = {"ref": RefScrubber(self.stores["ref"], rate_mb_s=0),
                          "port": EcScrubber(self.stores["port"],
                                             rate_mb_s=0)}
        self.orig = _files(self.bases["port"])
        assert _files(self.bases["ref"]) == self.orig

    def each(self, fn) -> None:
        for side in ("ref", "port"):
            fn(side, self.bases[side])

    def run_pass(self) -> dict:
        """One pass on both sides: the verdicts (equal), the files
        (equal), the change of the integrity counters (equal)."""
        metrics = {"ref": ref_integrity_metrics(),
                   "port": ec_integrity_metrics()}
        out = {}
        for side, scrub in self.scrubbers.items():
            before = metrics[side].totals()
            st = scrub.run_pass()
            after = metrics[side].totals()
            out[side] = (_verdicts(st), tuple(st["cursor"]),
                         {k: after[k] - before[k] for k in after})
        assert out["port"] == out["ref"]
        assert _files(self.bases["port"]) == _files(self.bases["ref"])
        return {"verdicts": out["port"][0], "cursor": out["port"][1],
                "delta": out["port"][2]}

    def close(self) -> None:
        for s in self.stores.values():
            s.close()


@pytest.fixture
def pair(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


def test_quarantine_and_repair_roundtrip(pair):
    assert pair.run_pass()["verdicts"]["1"]["status"] == "clean"
    pair.each(lambda side, base: _flip(base + to_ext(11), 2048, bit=5))
    res = pair.run_pass()
    assert res["verdicts"]["1"]["status"] == "repaired"
    assert res["verdicts"]["1"]["corrupt_shards"] == [11]
    assert res["delta"]["scrub_repairs"] == 1
    assert res["delta"]["corrupt_shards"] == 1
    files = _files(pair.bases["port"])
    assert files[to_ext(11)] == pair.orig[to_ext(11)]
    assert ".ec11.bad" in files
    assert 11 in pair.stores["port"].ec_volumes[1].shards


def test_unrepairable_quarantines_without_garbage(pair):
    for sid in (0, 1, 2, 3, 4):
        pair.each(lambda side, base, s=sid: _flip(base + to_ext(s), 300))
    for store in pair.stores.values():
        store.pop_heartbeat_delta()  # what the mounts queued before
    res = pair.run_pass()
    assert res["verdicts"]["1"]["status"] == "unrepairable"
    assert res["verdicts"]["1"]["corrupt_shards"] == [0, 1, 2, 3, 4]
    files = _files(pair.bases["port"])
    for sid in range(5):
        assert to_ext(sid) + ".bad" in files and to_ext(sid) not in files
    # the heartbeat delta names the volume's shard set without them
    deltas = {side: store.pop_heartbeat_delta()
              for side, store in pair.stores.items()}
    for side in ("ref", "port"):
        (info,) = deltas[side]["new_ec_shards"]
        assert info["ec_index_bits"] == sum(1 << s for s in range(5, 14))
    assert deltas["port"]["deleted_ec_shards"] == \
        deltas["ref"]["deleted_ec_shards"] == []


def test_backfills_pre_sidecar_volume(pair):
    def drop_sidecar(side, base):
        os.remove(base + ".eci")
        pair.stores[side].ec_mount(1)
        assert pair.stores[side].ec_volumes[1].sidecar is None

    pair.each(drop_sidecar)
    assert pair.run_pass()["verdicts"]["1"]["status"] == "no_sidecar"
    for scrub in pair.scrubbers.values():
        scrub.backfill = True
    assert pair.run_pass()["verdicts"]["1"]["status"] == "clean"
    assert _files(pair.bases["port"])[".eci"] == pair.orig[".eci"]


def test_cursor_resumes_mid_volume(pair):
    full = pair.run_pass()["verdicts"]["1"]["blocks"]
    for scrub in pair.scrubbers.values():
        scrub.cursor = (1, 5)  # as a stop() mid-volume leaves it
    res = pair.run_pass()
    assert res["verdicts"]["1"]["status"] == "clean"
    assert res["verdicts"]["1"]["blocks"] < full
    assert res["cursor"] == (0, 0)


def test_stop_mid_volume_still_quarantines(pair):
    pair.each(lambda side, base: _flip(base + to_ext(0), 512))
    for scrub in pair.scrubbers.values():
        calls = [0]

        def stop_soon(scrub=scrub, calls=calls):  # runs before each block
            calls[0] += 1
            if calls[0] == 30:
                scrub._stop.set()
            return False

        scrub.busy_fn = stop_soon
    res = pair.run_pass()
    assert res["cursor"][0] == 1 and res["cursor"][1] > 0
    assert res["verdicts"]["1"]["status"] == "repaired"
    files = _files(pair.bases["port"])
    assert files[to_ext(0)] == pair.orig[to_ext(0)] and ".ec00.bad" in files


def test_stale_sidecar_never_quarantines(pair):
    def doctor(side, base):
        cls = RefEciSidecar if side == "ref" else EciSidecar
        sc = cls.load(base)
        wrong = sc.shard_size - 1 if sc.shard_size % sc.block_size == 0 \
            else sc.shard_size + 1
        cls(sc.block_size, wrong, sc.crcs, sc.present_mask).save(base)
        pair.stores[side].ec_mount(1)

    pair.each(doctor)
    assert pair.run_pass()["verdicts"]["1"]["status"] == "stale_sidecar"
    files = _files(pair.bases["port"])
    assert all(e in files and e + ".bad" not in files for e in SHARD_EXTS)
    for scrub in pair.scrubbers.values():
        scrub.backfill = True
    assert pair.run_pass()["verdicts"]["1"]["status"] == "clean"


def test_detects_truncated_shard(pair):
    def truncate(side, base):
        with open(base + to_ext(12), "r+b") as f:
            f.truncate(len(pair.orig[to_ext(12)]) - 700)

    pair.each(truncate)
    res = pair.run_pass()
    assert res["verdicts"]["1"]["status"] == "repaired"
    assert res["verdicts"]["1"]["corrupt_shards"] == [12]
    assert _files(pair.bases["port"])[to_ext(12)] == pair.orig[to_ext(12)]


def test_read_path_heals_an_injected_flip(pair):
    """ec.shard.corrupt on the port's shard reads: the verified read
    demotes the shard and every needle reads back its bytes."""
    store = pair.stores["port"]
    ev = store.ec_volumes[1]
    clean = {nid: store.read_ec_needle(1, nid)[0]
             for nid, _, _ in pair.needles[:20]}
    _, _, ivs = ev.locate_ec_shard_needle(pair.needles[7][0])
    sid, soff = ivs[0].to_shard_id_and_offset(
        ev.large_block_size, ev.small_block_size, ev.data_shards)
    fi.enable("ec.shard.corrupt", params={"shard": sid, "offset": soff,
                                          "bit": 2})
    try:
        for nid, want in clean.items():
            assert store.read_ec_needle(1, nid)[0] == want, nid
        assert fi.fired("ec.shard.corrupt") >= 1
    finally:
        fi.clear()
    assert sid in ev.corrupt_shards
    want = {nid: pair.stores["ref"].read_ec_needle(1, nid)[0]
            for nid in clean}
    assert want == clean


def test_a_read_waiting_on_a_remote_shard_holds_back_no_quarantine(
        tmp_path):
    """A degraded read blocked in its remote fetch keeps the volume it
    found open, but neither a quarantine of that volume nor reads of
    another wait for it; the read then returns the fetched bytes, and the
    volume it held closes when it leaves."""
    vols = {vid: _write_volume(str(tmp_path), seed=20 + vid, vid=vid)
            for vid in (1, 2)}
    store = Store([str(tmp_path)], device="cpu")
    try:
        for vid in vols:
            store.ec_generate(vid)
            store.ec_mount(vid)
            store.unmount_volume(vid)
        base = os.path.join(str(tmp_path), "1")
        # every needle of these small volumes lies on shard 0: with it
        # gone, a read of volume 1 asks a remote holder
        with open(base + to_ext(0), "rb") as f:
            shard0 = f.read()
        os.remove(base + to_ext(0))
        store.ec_mount(1)
        held = store.ec_volumes[1]
        entered, release = threading.Event(), threading.Event()

        def fetch_remote(vid, sid, off, size):
            entered.set()
            release.wait(30)
            return shard0[off:off + size]

        nid, _, _ = vols[1][5]
        got = {}
        reader = threading.Thread(target=lambda: got.update(
            r=store.read_ec_needle(1, nid, fetch_remote)))
        reader.start()
        try:
            assert entered.wait(10)
            _flip(base + to_ext(12), 700)
            scrub = EcScrubber(store, rate_mb_s=0)
            t0 = time.monotonic()
            st = scrub.run_pass()
            assert time.monotonic() - t0 < 10
            assert not release.is_set() and reader.is_alive()
            assert st["verdicts"]["1"]["status"] == "repaired"
            assert st["verdicts"]["1"]["corrupt_shards"] == [12]
            assert st["verdicts"]["2"]["status"] == "clean"
            assert store.ec_volumes[1] is not held
            assert not held._ecx.closed  # the blocked read still holds it
            for nid2, _, _ in vols[2][:10]:
                store.read_ec_needle(2, nid2)
        finally:
            release.set()
            reader.join(30)
        want = RefStore([str(tmp_path)])
        try:
            assert got["r"] == want.read_ec_needle(1, nid)
        finally:
            want.close()
        assert held._ecx.closed
        with open(base + to_ext(0), "rb") as f:
            assert f.read() == shard0  # the repair rebuilt it too
    finally:
        store.close()


def test_gets_during_a_quarantine_return_the_written_bytes(tmp_path,
                                                          monkeypatch):
    """Readers hammer a volume server while its scrubber quarantines two
    shards; the rename is slowed so reads pile up behind the swap.  Every
    GET returns the written bytes, some of them while the volume was
    mounted degraded."""
    needles = _write_volume(str(tmp_path), seed=12, n_needles=80)
    vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{free_port()}",
                      port=free_port(), device="cpu").start()
    base = os.path.join(str(tmp_path), "1")
    real_replace = os.replace
    real_rebuild = vs.store.ec_rebuild

    def slow_replace(a, b):
        time.sleep(0.2)
        real_replace(a, b)

    def slow_rebuild(*args):
        time.sleep(0.3)  # reads meet the volume mounted degraded
        return real_rebuild(*args)

    try:
        vs.store.ec_generate(1)
        vs.store.ec_mount(1)
        vs.store.unmount_volume(1)
        orig = _files(base)
        _flip(base + to_ext(3), 1000)
        _flip(base + to_ext(12), 5000)
        stop = threading.Event()
        seen = {"ok": 0, "degraded": 0, "bad": []}

        def reader(t: int) -> None:
            rng = np.random.default_rng(t)
            while not stop.is_set():
                nid, cookie, data = needles[int(rng.integers(len(needles)))]
                with vs.store.ec_volume_held(1) as ev:
                    degraded = ev is not None and 3 not in ev.shards
                if ev is None:
                    seen["bad"].append((nid, "volume absent"))
                status, body, _ = http_bytes(
                    "GET", f"http://{vs.url}/{FileId(1, nid, cookie)}")
                if status != 200 or body != data:
                    seen["bad"].append((nid, status))
                seen["ok"] += 1
                seen["degraded"] += degraded

        threads = [threading.Thread(target=reader, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        monkeypatch.setattr(os, "replace", slow_replace)
        monkeypatch.setattr(vs.store, "ec_rebuild", slow_rebuild)
        r = http_json("POST", f"http://{vs.url}/ec/scrub/start",
                      {"rate_mb_s": 0, "interval_s": 0})
        assert r["started"] is True
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = http_json("GET", f"http://{vs.url}/ec/scrub/status")
            if not st["running"] and st["verdicts"]:
                break
            time.sleep(0.05)
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(30)
        monkeypatch.undo()
        assert not any(t.is_alive() for t in threads)
        assert st["verdicts"]["1"]["status"] == "repaired"
        assert st["verdicts"]["1"]["corrupt_shards"] == [3, 12]
        assert not seen["bad"] and seen["ok"] > 0 and seen["degraded"] > 0
        files = _files(base)
        assert files[to_ext(3)] == orig[to_ext(3)]
        assert files[to_ext(12)] == orig[to_ext(12)]
        assert ".ec03.bad" in files and ".ec12.bad" in files
    finally:
        vs.stop()


def test_status_right_after_start_shows_the_pass_running(pair):
    """A poll made before the scan thread has begun must see the pass
    running, never the previous pass's verdicts as a finished one."""
    scrub = pair.scrubbers["port"]
    first = scrub.run_pass()["verdicts"]["1"]
    go = threading.Event()
    real_loop = scrub._loop

    def late_loop():
        go.wait(10)
        real_loop()

    scrub._loop = late_loop
    time.sleep(0.01)  # the next verdict's time stamp is newer
    try:
        assert scrub.start(interval_s=0) is True
        assert scrub.status()["running"] is True
    finally:
        go.set()
    scrub._thread.join(10)
    st = scrub.status()
    assert st["running"] is False
    assert st["verdicts"]["1"]["status"] == "clean"
    assert st["verdicts"]["1"]["at"] > first["at"]


def test_scrub_routes_and_status(tmp_path):
    """/ec/scrub/start repairs planted rot; /ec/scrub/status, /status and
    /ec/scrub/stop answer as the reference server's do, but for the
    verdict's time and the process-wide counters."""
    from seaweedfs_tpu.volume_server.server import \
        VolumeServer as RefVolumeServer

    answers = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        os.makedirs(d)
        _write_volume(str(d), seed=13)
        master = f"127.0.0.1:{free_port()}"  # nothing listens
        if side == "ref":
            vs = RefVolumeServer([str(d)], master, port=free_port(),
                                 pulse_seconds=0.5, tcp=False, heat=False,
                                 ledger=False).start()
        else:
            vs = VolumeServer([str(d)], master, port=free_port(),
                              pulse_seconds=0.5, device="cpu").start()
        base = os.path.join(str(d), "1")
        try:
            vs.store.ec_generate(1)
            vs.store.ec_mount(1)
            orig = open(base + to_ext(11), "rb").read()
            _flip(base + to_ext(11), 4096)
            r = http_json("POST", f"http://{vs.url}/ec/scrub/start",
                          {"rate_mb_s": 0})
            assert r["started"] is True
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                st = http_json("GET", f"http://{vs.url}/ec/scrub/status")
                if not st["running"] and st["verdicts"]:
                    break
                time.sleep(0.05)
            assert open(base + to_ext(11), "rb").read() == orig
            status = http_json("GET", f"http://{vs.url}/status")
            stopped = http_json("POST", f"http://{vs.url}/ec/scrub/stop",
                                {})
            bad_vid = http_bytes("POST", f"http://{vs.url}/ec/scrub/start",
                                 b'{"volume_id": "x"}')[0]
            assert status["EcIntegrity"]["corrupt_shards"] >= 1
            answers[side] = {
                # the scan thread may be past its first shards already
                # when start answers: its progress fields are left out
                "start": {k: v for k, v in r.items() if k not in (
                    "totals", "running", "paused", "passes", "cursor",
                    "verdicts")},
                "start_keys": sorted(r),
                "status": {**{k: v for k, v in st.items() if k != "totals"},
                           "verdicts": _verdicts(st)},
                "stop": {k: v for k, v in stopped.items()
                         if k not in ("totals", "verdicts")},
                "EcScrub": status["EcScrub"],
                "totals_keys": sorted(st["totals"]),
                "bad_volume_id": bad_vid,
            }
        finally:
            vs.stop()
    assert answers["port"] == answers["ref"]
    assert answers["port"]["status"]["verdicts"]["1"]["status"] == "repaired"
    assert answers["port"]["EcScrub"]["verdicts"] == {"1": "repaired"}


# --- the ec.scrub shell command ----------------------------------------

def _mask(text: str, urls: list[str]) -> str:
    for i, url in enumerate(urls):
        text = text.replace(url, f"<server{i}>")
    return re.sub(r"127\.0\.0\.1:\d+", "<master>", text)


def _scrub_cluster(root, templates: list, run, commands: list[str]) -> list:
    """A port master and one port volume server per template directory,
    each server its own ``python -m seaweedfs_tpu_torch volume`` process
    (so each counts into its own integrity counters, as deployed), on
    ports that sort as the servers are numbered; ``run(master_url, line)``
    runs each command.  Returns the masked outputs."""
    ms = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    ports = sorted({free_port() for _ in range(8)}, key=str)[:len(templates)]
    procs = []
    try:
        for i, (tpl, port) in enumerate(zip(templates, ports)):
            d = root / f"vs{i}"
            shutil.copytree(tpl, d)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
                 "-dir", str(d), "-port", str(port), "-mserver", ms.url,
                 "-pulseSeconds", "0.3", "-ec.engine", "cpu"], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=ROOT),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        deadline = time.monotonic() + 60
        while len(ms.topo.all_nodes()) < len(procs):
            assert time.monotonic() < deadline, "servers did not register"
            time.sleep(0.05)
        urls = [f"127.0.0.1:{p}" for p in ports]
        return [_mask(run(ms.url, line), urls) for line in commands]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
        ms.stop()


def test_ec_scrub_shell_command_against_the_reference_shell(tmp_path):
    """Two port servers: one holds all 14 shards of volume 1 with rot in
    shards 2 and 9 (repaired locally), the other four shards of volume 2
    with rot in one (unrepairable there).  The port's shell and the
    reference's shell, each on a fresh copy of that cluster, print the
    same lines but for the servers' and the master's addresses."""
    full, part = tmp_path / "full", tmp_path / "part"
    os.makedirs(full)
    os.makedirs(part)
    _write_volume(str(full), seed=14, vid=1)
    _write_volume(str(part), seed=15, vid=2)
    for d, vid in ((full, 1), (part, 2)):
        s = Store([str(d)], device="cpu")
        s.ec_generate(vid)
        s.delete_volume(vid)
        s.close()
    for sid in range(4, 14):
        os.remove(part / f"2{to_ext(sid)}")
    _flip(str(full / f"1{to_ext(2)}"), 777)
    _flip(str(full / f"1{to_ext(9)}"), 300_000)
    _flip(str(part / f"2{to_ext(1)}"), 10)
    commands = ["ec.scrub", "ec.scrub -all -rate 0", "ec.scrub",
                "ec.scrub -action stop"]
    outputs = {}
    for shell, env_cls, runner in (("port", CommandEnv, run_command),
                                   ("ref", RefCommandEnv, ref_run_command)):
        outputs[shell] = _scrub_cluster(
            tmp_path / shell, [full, part],
            lambda master, line, e=env_cls, r=runner: r(e(master), line),
            commands)
    assert outputs["port"] == outputs["ref"]
    out = outputs["port"]
    assert out[1].startswith("cluster scrub: DEGRADED")
    assert "volume 2: unrepairable corrupt_shards=[1]" in out[1]
    assert "volume 1: repaired corrupt_shards=[2, 9]" in out[1]
    # the master's rollup counts the unrepairable verdict
    assert out[1].splitlines()[-1] == \
        "/cluster/health: degraded=True scrub_unrepairable=1"
    assert "passes=1" in out[2] and "repairs=2" in out[2]
