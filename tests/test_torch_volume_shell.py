"""The port's volume shell against the reference's, on four clusters.

One seeded script runs every command of shell/volume_commands.py that
the port has (all but ``volume.tier.*``): fsck and check.disk, copy (and
its 409), delete, move, unmount and mount, mark, a flipped byte that
fsck and check.disk report, a needle deleted on one replica only
(DIVERGED), fix.replication of the replica dropped for it,
configure.replication (a bad placement, then 000 and back to 001),
balance, deleteEmpty, server.evacuate of a server holding a volume and
EC shards, collection.delete and server.leave.  It runs on the four
clusters of tests/test_torch_shell.py, with its harness: the port
alone, the reference alone, the reference's shell over the port's
master, and the port's shell over the reference's master.

After every step the shell's output (server urls written as their
index), the master's ``/dir/status`` (without ``modified_at``) and the
sha256 of every volume and EC file on every server must equal the
reference cluster's.  Copied and moved `.dat`/`.idx`, evacuated EC files
and the rewritten superblock are among those files.

Further cases: the superblock rewrite around a vacuum (the port keeps
the new placement where the reference's commit loses it), and
``/admin/volume_copy`` giving the source back its read-only state.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
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
from seaweedfs_tpu.client.operation import WeedClient as RefWeedClient
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from tests.conftest import free_port
from tests.test_torch_shell import CLUSTERS, _Clock, _Secrets, _wait

SEED = 6161
SERVERS = 4
PULSE = 0.2
FILE_EXTS = (".dat", ".idx", ".ecx", ".ecj", ".eci") + tuple(
    f".ec{i:02d}" for i in range(14))
# every ported command, as the script runs it
COMMANDS = ("volume.fsck", "volume.check.disk", "volume.copy",
            "volume.delete", "volume.move", "volume.unmount",
            "volume.mount", "volume.mark", "volume.fix.replication",
            "volume.configure.replication", "volume.balance",
            "volume.deleteEmpty", "volume.server.evacuate",
            "collection.delete", "volume.server.leave")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ports() -> list[int]:
    """Ports whose urls sort as the servers are numbered, so url ties
    break alike in every cluster."""
    ports = set()
    while len(ports) < SERVERS:
        p = free_port()
        if 10000 <= p <= 65535:
            ports.add(p)
    return sorted(ports, key=str)


def _named(obj, names: dict):
    """``obj`` with every server url replaced by its index, urls in
    lists sorted, and no ``modified_at`` (a file's mtime)."""
    if isinstance(obj, dict):
        return {names.get(k, k): _named(v, names) for k, v in obj.items()
                if k != "modified_at"}
    if isinstance(obj, list):
        out = [_named(v, names) for v in obj]
        return sorted(out) if all(v in names.values() for v in out) and \
            out else out
    if isinstance(obj, str):
        for url, name in names.items():
            obj = obj.replace(url, name)
        return obj
    return obj


def _files(dirs: list[str]) -> dict:
    out = {}
    for i, d in enumerate(dirs):
        for name in sorted(os.listdir(d)):
            if name.endswith(FILE_EXTS):
                with open(os.path.join(d, name), "rb") as f:
                    out[f"vs{i}/{name}"] = hashlib.sha256(
                        f.read()).hexdigest()
    return out


def _holders(topo: dict, names: dict) -> dict[int, list[str]]:
    """vid -> the servers (by name) that hold it, in topology order."""
    out: dict[int, list[str]] = {}
    for dc in topo["DataCenters"]:
        for rack in dc["Racks"]:
            for n in rack["DataNodes"]:
                for vid in n["VolumeIds"]:
                    out.setdefault(vid, []).append(names[n["Url"]])
    return out


def _flip_in_a_live_needle(vs, vid: int) -> None:
    """Flip the first data byte of the live needle with the lowest key."""
    v = vs.store.volumes[vid]
    nv = min(v.nm, key=lambda nv: nv.key)
    with open(v.file_prefix + ".dat", "r+b") as f:
        f.seek(nv.offset + 20)
        b = f.read(1)
        f.seek(nv.offset + 20)
        f.write(bytes([b[0] ^ 0xFF]))


def run_script(root, kinds: tuple, monkeypatch) -> dict:
    """The script on one cluster -> {step: (output, /dir/status, files)}
    plus the fids it uploaded."""
    master_kind, shell_kind, server_kind = kinds
    for mod in (master_mod, ref_master_mod):
        monkeypatch.setattr(mod, "secrets", _Secrets(SEED))
    mcls = MasterServer if master_kind == "port" else RefMasterServer
    master = mcls(port=free_port(), volume_size_limit_mb=64,
                  pulse_seconds=PULSE).start()
    servers, dirs = [], []
    steps: dict = {}
    try:
        for i, port in enumerate(_ports()):
            d = str(root / f"vs{i}")
            os.makedirs(d)
            dirs.append(d)
            if server_kind == "port":
                vs = server_mod.VolumeServer(
                    [d], master.url, port=port, max_volume_count=6,
                    pulse_seconds=PULSE, device="cpu")
            else:
                vs = RefVolumeServer([d], master.url, port=port,
                                     max_volume_count=6, pulse_seconds=PULSE,
                                     needle_cache_mb=0)
            servers.append(vs.start())
            # one at a time: the master lists them in this order
            _wait("registration", lambda: len(master.topo.all_nodes()) == i + 1)
        names = {vs.url: f"vs{i}" for i, vs in enumerate(servers)}
        by_name = {f"vs{i}": vs for i, vs in enumerate(servers)}
        client = (WeedClient if shell_kind == "port" else RefWeedClient)(
            master.url)
        env = (CommandEnv if shell_kind == "port" else RefCommandEnv)(
            master.url)
        run = run_command if shell_kind == "port" else ref_run_command
        left: list = []

        def sync() -> None:
            for vs in servers:
                if vs not in left:
                    vs.heartbeat_now()

        def topo() -> dict:
            return http_json("GET", f"http://{master.url}/dir/status")[
                "Topology"]

        def step(label: str, line: str) -> str:
            try:
                out = run(env, line.format(**{n: vs.url for n, vs
                                              in by_name.items()}))
            except Exception as e:  # noqa: BLE001 - the REPL prints it
                out = f"error: {type(e).__name__}: {e}"
            sync()
            steps[label] = (_named(out, names), _named(topo(), names),
                            _files(dirs))
            return steps[label][0]

        random.seed(SEED)
        if master_kind == "port":
            master.topo.rng.seed(SEED)
        vids = {}
        for key, q in (("rep", "collection=rep&replication=001"),
                       ("plain", "collection=plain"), ("ec", "collection="),
                       ("empty", "collection=empty")):
            vids[key] = http_json("GET", f"http://{master.url}/vol/grow?"
                                         f"{q}&count=1")["volumeIds"][0]
        rng = np.random.default_rng(SEED)
        with monkeypatch.context() as m:
            for mod in (volume_mod, server_mod, ref_volume_mod,
                        ref_server_mod):
                m.setattr(mod, "time", _Clock(time))
            fids = [client.upload(rng.bytes(int(rng.integers(500, 9000))),
                                  collection=c, replication=r)
                    for c, r, n in (("rep", "001", 12), ("plain", "", 8),
                                    ("", "", 12)) for _ in range(n)]
        sync()
        env.lock()
        out = run(env, f"ec.encode -volumeId {vids['ec']}")
        assert out.startswith(f"ec encoded volume {vids['ec']} "), out
        sync()

        rep, plain, empty = vids["rep"], vids["plain"], vids["empty"]
        step("volume.fsck", "volume.fsck")
        step("volume.check.disk", "volume.check.disk")
        held = _holders(topo(), names)
        src = held[plain][0]
        dst = next(n for n in by_name if n not in held[plain])
        step("volume.copy", f"volume.copy -volumeId {plain} -source {{{src}}}"
                            f" -target {{{dst}}}")
        step("volume.copy/again", f"volume.copy -volumeId {plain} "
                                  f"-source {{{src}}} -target {{{dst}}}")
        step("volume.delete", f"volume.delete -volumeId {plain} "
                              f"-node {{{dst}}}")
        step("volume.move", f"volume.move -volumeId {plain} "
                            f"-source {{{src}}} -target {{{dst}}}")
        step("volume.unmount", f"volume.unmount -volumeId {plain} "
                               f"-node {{{dst}}}")
        step("volume.mount", f"volume.mount -volumeId {plain} "
                             f"-node {{{dst}}}")
        step("volume.mark", f"volume.mark -volumeId {plain} -node {{{dst}}}"
                            " -readonly")
        step("volume.mark/writable", f"volume.mark -volumeId {plain} "
                                     f"-node {{{dst}}} -writable")

        bad, good = held[rep]
        _flip_in_a_live_needle(by_name[bad], rep)
        step("volume.fsck/corrupt", f"volume.fsck -volumeId {rep}")
        step("volume.check.disk/corrupt", f"volume.check.disk -volumeId {rep}")
        with monkeypatch.context() as m:
            for mod in (volume_mod, server_mod, ref_volume_mod,
                        ref_server_mod):
                m.setattr(mod, "time", _Clock(time))
            gone = next(f for f in fids if int(f.split(",")[0]) == rep)
            status, _, _ = http_bytes("DELETE", f"http://{by_name[good].url}"
                                                f"/{gone}?type=replicate")
            assert status == 200
        step("volume.check.disk/diverged", f"volume.check.disk -volumeId "
                                           f"{rep}")
        step("volume.delete/node", f"volume.delete -volumeId {rep} "
                                   f"-node {{{bad}}}")
        step("volume.fix.replication", "volume.fix.replication")
        step("volume.configure.replication/bad",
             f"volume.configure.replication -volumeId {rep} -replication 5")
        step("volume.configure.replication",
             f"volume.configure.replication -volumeId {rep} -replication 000")
        step("volume.configure.replication/back",
             f"volume.configure.replication -volumeId {rep} -replication 001")
        step("volume.balance", "volume.balance")
        step("volume.deleteEmpty", "volume.deleteEmpty -quietFor 0 -force")
        assert empty not in _holders(topo(), names)
        doc = topo()
        ec_count = {names[n["Url"]]: (n["EcShards"], n["Volumes"])
                    for dc in doc["DataCenters"] for r in dc["Racks"]
                    for n in r["DataNodes"]}
        node = max(sorted(ec_count), key=lambda n: (
            ec_count[n][1] > 0, ec_count[n][0]))
        step("volume.server.evacuate", f"volume.server.evacuate "
                                       f"-node {{{node}}}")
        step("collection.delete", "collection.delete -collection rep")
        left.append(by_name[node])  # no heartbeat_now from here on
        step("volume.server.leave", f"volume.server.leave -node {{{node}}}")
        _wait("the master to drop the server that left",
              lambda: by_name[node].url not in {
                  n.url for n in master.topo.all_nodes()})
        steps["volume.server.leave/dropped"] = (
            "", _named(topo(), names), _files(dirs))
        env.unlock()
        return {"steps": steps, "fids": fids, "vids": vids, "evacuated": node,
                "moved": (src, dst), "bad": bad, "good": good}
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each cluster's script, run once when a case first asks for it."""
    cache: dict = {}

    def get(cluster: str) -> dict:
        if cluster not in cache:
            with pytest.MonkeyPatch.context() as mp:
                cache[cluster] = run_script(
                    tmp_path_factory.mktemp(cluster), CLUSTERS[cluster], mp)
        return cache[cluster]

    return get


def _labels(command: str, steps: dict) -> list[str]:
    return [s for s in steps if s.split("/")[0] == command]


@pytest.mark.parametrize("command", COMMANDS)
@pytest.mark.parametrize("cluster", ["port", "ref_shell_on_port_master",
                                     "port_shell_on_ref_master"])
def test_command_equals_the_reference(cluster, command, runs):
    """The command's output, /dir/status after it and every file on
    every server equal the reference cluster's after each of its steps."""
    want, got = runs("reference"), runs(cluster)
    assert got["fids"] == want["fids"]
    labels = _labels(command, want["steps"])
    assert labels and labels == _labels(command, got["steps"])
    for label in labels:
        w, g = want["steps"][label], got["steps"][label]
        assert g[0] == w[0], label
        assert g[1] == w[1], label
        assert g[2] == w[2], label


def test_the_script_did_what_it_says(runs):
    """The port cluster's steps, read for their meaning: each command did
    its job (the equality cases above hold the others to the same)."""
    got = runs("port")
    steps = got["steps"]
    vids = got["vids"]
    rep, plain = vids["rep"], vids["plain"]
    src, dst = got["moved"]
    assert all(line.endswith(" OK")
               for line in steps["volume.fsck"][0].splitlines())
    assert steps["volume.check.disk"][0].endswith("[in sync]")
    files = steps["volume.copy"][2]
    name = f"plain_{plain}"
    for ext in (".dat", ".idx"):
        assert files[f"{dst}/{name}{ext}"] == files[f"{src}/{name}{ext}"]
    assert "already here" in steps["volume.copy/again"][0]
    files = steps["volume.move"][2]
    assert f"{src}/{name}.dat" not in files
    assert files[f"{dst}/{name}.dat"] == \
        steps["volume.copy"][2][f"{src}/{name}.dat"]

    def info(label: str, node: str, vid: int) -> dict:
        nodes = [n for dc in steps[label][1]["DataCenters"]
                 for r in dc["Racks"] for n in r["DataNodes"]]
        return next(v for n in nodes if n["Url"] == node
                    for v in n["VolumeInfos"] if v["id"] == vid)

    assert info("volume.mark", dst, plain)["read_only"] is True
    assert info("volume.mark/writable", dst, plain)["read_only"] is False
    fsck = steps["volume.fsck/corrupt"][0].splitlines()
    assert [line.split()[-1] for line in fsck] == \
        ["CORRUPT" if f" @ {got['bad']}:" in line else "OK" for line in fsck]
    assert "CORRUPT" in fsck[0] + fsck[1] and "OK" in fsck[0] + fsck[1]
    assert steps["volume.check.disk/corrupt"][0].endswith("[CORRUPT]")
    assert steps["volume.check.disk/diverged"][0].endswith("[DIVERGED]")
    fixed = steps["volume.fix.replication"]
    target = fixed[0].split(" -> ")[-1]
    assert fixed[0] == f"replicated {rep} -> {target}"
    for ext in (".dat", ".idx"):
        assert fixed[2][f"{target}/rep_{rep}{ext}"] == \
            fixed[2][f"{got['good']}/rep_{rep}{ext}"]
    assert "unknown replication type" in \
        steps["volume.configure.replication/bad"][0]
    layouts = {(lay["collection"], lay["replication"]): lay["volumes"]
               for lay in steps["volume.configure.replication"][1]["Layouts"]}
    assert rep in layouts[("rep", "000")]
    # both masters keep a re-placed volume in its old layout as well
    # (ROADMAP Queue 3): back at 001, the 000 layout still lists it
    layouts = {(lay["collection"], lay["replication"]): lay["volumes"]
               for lay in steps["volume.configure.replication/back"][1][
                   "Layouts"]}
    assert rep in layouts[("rep", "001")] and rep in layouts[("rep", "000")]
    assert "deleted empty volumes" in steps["volume.deleteEmpty"][0]
    evac = steps["volume.server.evacuate"]
    assert " -> " in evac[0] and "ec " in evac[0]
    node = got["evacuated"]
    assert not [f for f in evac[2] if f.startswith(node + "/")]
    assert f"deleted collection rep: volumes [{rep}" in \
        steps["collection.delete"][0]
    assert "left the cluster" in steps["volume.server.leave"][0]
    nodes = [n["Url"] for dc in steps["volume.server.leave/dropped"][1][
        "DataCenters"] for r in dc["Racks"] for n in r["DataNodes"]]
    assert node not in nodes and len(nodes) == SERVERS - 1


def test_evacuated_shards_keep_their_bytes(runs):
    """Every EC file the evacuated server held moved to a server that
    now has the same bytes under the shard's collection."""
    got = runs("port")
    node = got["evacuated"]
    before = got["steps"]["volume.deleteEmpty"][2]
    after = got["steps"]["volume.server.evacuate"][2]
    moved = {k.split("/", 1)[1]: h for k, h in before.items()
             if k.startswith(node + "/") and ".ec" in k}
    assert moved and all(k.startswith(f"{got['vids']['ec']}.")
                         for k in moved)
    for name, h in moved.items():
        holders = [k for k, v in after.items()
                   if k.endswith("/" + name) and v == h]
        assert holders, name


# --- the superblock rewrite around a vacuum ---------------------------------

def _filled_volume(d: str) -> Volume:
    v = Volume(d, "", 1, replica_placement=ReplicaPlacement.parse("000"))
    rng = np.random.default_rng(SEED)
    for i in range(1, 21):
        v.write_needle(Needle(cookie=7, id=i,
                              data=rng.bytes(int(rng.integers(10, 4000)))))
    for i in range(1, 21, 3):
        v.delete_needle(Needle(cookie=7, id=i))
    return v


@pytest.mark.parametrize("when", ["before_compact", "between", "after_commit"])
def test_rewrite_around_a_vacuum_keeps_the_new_placement(when, tmp_path):
    """configure_replication before the compact, between the compact and
    its commit, or after the commit: the volume reopens with the new
    placement on disk, and every live needle reads back."""
    v = _filled_volume(str(tmp_path))
    new = ReplicaPlacement.parse("010")
    if when == "before_compact":
        v.configure_replication(new)
    v.compact()
    if when == "between":
        v.configure_replication(new)
    v.commit_compact()
    if when == "after_commit":
        v.configure_replication(new)
    assert v.super_block.replica_placement == new
    assert v.super_block.compaction_revision == 1
    v.close()
    with open(tmp_path / "1.dat", "rb") as f:
        assert f.read(8)[1] == new.to_byte()
    v = Volume(str(tmp_path), "", 1)
    try:
        assert v.super_block.replica_placement == new
        assert v.check_needles() == {"indexed": 13, "scanned_live": 13,
                                     "crc_errors": 0}
    finally:
        v.close()


def test_fsck_scan_races_commits_without_a_lock(tmp_path):
    """check_needles takes no lock: scans running through five compaction
    commits (a 10 us switch interval) each see the whole live set, clean,
    and a byte flipped after the last commit is found."""
    v = _filled_volume(str(tmp_path))
    results: list = []
    errors: list = []
    stop = threading.Event()

    def scan() -> None:
        while not stop.is_set():
            try:
                results.append(v.check_needles())
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=scan) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for _ in range(5):
            v.compact()
            v.commit_compact()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert results and all(r == {"indexed": 13, "scanned_live": 13,
                                 "crc_errors": 0} for r in results)
    nv = min(v.nm, key=lambda nv: nv.key)
    with open(tmp_path / "1.dat", "r+b") as f:
        f.seek(nv.offset + 20)
        b = f.read(1)
        f.seek(nv.offset + 20)
        f.write(bytes([b[0] ^ 0xFF]))
    assert v.check_needles()["crc_errors"] == 1
    v.close()


def _vacuum_with_rewrite(kind: str, root) -> tuple[list, bytes]:
    """compact, configure_replication 010, commit through one server's
    routes -> (the answers, the superblock on disk)."""
    master = (MasterServer if kind == "port" else RefMasterServer)(
        port=free_port(), pulse_seconds=0.5).start()
    d = str(root / kind)
    if kind == "port":
        vs = server_mod.VolumeServer([d], master.url, port=free_port(),
                                     pulse_seconds=0.5, device="cpu")
    else:
        vs = RefVolumeServer([d], master.url, port=free_port(),
                             pulse_seconds=0.5, tcp=False,
                             needle_cache_mb=0)
    vs.start()
    try:
        def post(path: str, **body) -> tuple:
            status, data, _ = http_bytes("POST", f"http://{vs.url}{path}",
                                         json.dumps({"volume_id": 1,
                                                     **body}).encode())
            return status, json.loads(data)

        out = [post("/admin/assign_volume")]
        for i in range(1, 9):
            status, _, _ = http_bytes(
                "PUT", f"http://{vs.url}/1,{i:x}0000abcd?ts=1700000000"
                       f"&type=replicate", bytes([i]) * 300)
            assert status == 201
        http_bytes("DELETE", f"http://{vs.url}/1,20000abcd?type=replicate")
        out += [post("/admin/vacuum_compact"),
                post("/admin/configure_replication", replication="010"),
                post("/admin/vacuum_commit")]
        with open(os.path.join(d, "1.dat"), "rb") as f:
            return out, f.read(8)
    finally:
        vs.stop()
        master.stop()


def test_rewrite_between_compact_and_commit_against_the_reference(tmp_path):
    """The same routes on both servers: the same answers, but the
    reference's commit swaps in the superblock its compact copied (old
    placement), where the port's keeps the rewrite (ROADMAP Queue 3)."""
    ref_out, ref_sb = _vacuum_with_rewrite("ref", tmp_path)
    out, sb = _vacuum_with_rewrite("port", tmp_path)
    assert out == ref_out
    assert out[2] == (200, {"replication": "010"})
    assert sb[1] == 10 and ref_sb[1] == 0
    assert sb[4:6] == ref_sb[4:6] == b"\x00\x01"


# --- /admin/volume_copy and the source's read-only state ------------------

@pytest.mark.parametrize("readonly", [True, False])
def test_volume_copy_gives_the_source_back_its_state(readonly, tmp_path):
    """A port server and a reference server each copy a volume from one
    source: the source ends read-only exactly when it began so, and both
    copies equal the source's files."""
    master = MasterServer(port=free_port(), pulse_seconds=0.5).start()
    servers = []
    try:
        for name in ("src", "port", "ref"):
            d = str(tmp_path / name)
            if name == "ref":
                vs = RefVolumeServer([d], master.url, port=free_port(),
                                     pulse_seconds=0.5, tcp=False,
                                     needle_cache_mb=0)
            else:
                vs = server_mod.VolumeServer([d], master.url,
                                             port=free_port(),
                                             pulse_seconds=0.5, device="cpu")
            servers.append(vs.start())
        src, port, ref = servers
        http_json("POST", f"http://{src.url}/admin/assign_volume",
                  {"volume_id": 5, "collection": "c"})
        for i in range(1, 7):
            http_bytes("PUT", f"http://{src.url}/5,{i:x}00001234?type="
                              f"replicate&ts=1700000000", bytes([i]) * 999)
        http_json("POST", f"http://{src.url}/admin/readonly",
                  {"volume_id": 5, "readonly": readonly})

        def src_readonly() -> bool:
            doc = http_json("GET", f"http://{src.url}/status")
            return next(v["read_only"] for v in doc["Volumes"]
                        if v["id"] == 5)

        for target in (port, ref):
            assert http_json("POST", f"http://{target.url}/admin/volume_copy",
                             {"volume_id": 5, "collection": "c",
                              "source_data_node": src.url}) == {}
            assert src_readonly() is readonly
        for ext in (".dat", ".idx"):
            want = (tmp_path / "src" / f"c_5{ext}").read_bytes()
            assert (tmp_path / "port" / f"c_5{ext}").read_bytes() == want
            assert (tmp_path / "ref" / f"c_5{ext}").read_bytes() == want
        for target in (port, ref):
            status, body, _ = http_bytes("GET", f"http://{target.url}/"
                                                f"5,300001234")
            assert (status, body) == (200, bytes([3]) * 999)
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


# --- evacuating the EC shards of a collection -------------------------------

@pytest.mark.parametrize("cluster", ["port", "port_shell_on_ref_servers",
                                     "ref_shell_on_port_servers"])
def test_evacuate_moves_a_collections_shards(cluster, tmp_path, monkeypatch):
    """volume.server.evacuate of a server holding shards of a collection's
    EC volume.  The port's shell names the collection in every call, and
    each moved shard keeps its bytes on its new holder under the
    collection's file name, on port servers and on reference servers.
    The reference's shell sends its /admin/ec/delete without the
    collection: the source's remount of its other shards looks for them
    outside the collection and fails (ROADMAP Queue 3)."""
    master_kind, shell_kind, server_kind = {
        "port": ("port", "port", "port"),
        "port_shell_on_ref_servers": ("ref", "port", "ref"),
        "ref_shell_on_port_servers": ("port", "ref", "port")}[cluster]
    mcls = MasterServer if master_kind == "port" else RefMasterServer
    master = mcls(port=free_port(), pulse_seconds=PULSE).start()
    servers = []
    try:
        for i in range(3):
            d = str(tmp_path / f"vs{i}")
            if server_kind == "port":
                vs = server_mod.VolumeServer([d], master.url,
                                             port=free_port(),
                                             pulse_seconds=PULSE,
                                             device="cpu")
            else:
                vs = RefVolumeServer([d], master.url, port=free_port(),
                                     pulse_seconds=PULSE, needle_cache_mb=0)
            servers.append(vs.start())
            _wait("registration", lambda: len(master.topo.all_nodes()) == i + 1)
        client = (WeedClient if shell_kind == "port" else RefWeedClient)(
            master.url)
        env = (CommandEnv if shell_kind == "port" else RefCommandEnv)(
            master.url)
        run = run_command if shell_kind == "port" else ref_run_command
        rng = np.random.default_rng(SEED)
        blobs = [rng.bytes(int(rng.integers(500, 9000))) for _ in range(10)]
        fids = [client.upload(b, collection="ec") for b in blobs]
        vid = int(fids[0].split(",")[0])
        for vs in servers:
            vs.heartbeat_now()
        env.lock()
        assert run(env, f"ec.encode -volumeId {vid} -collection ec"
                   ).startswith(f"ec encoded volume {vid} ")
        for vs in servers:
            vs.heartbeat_now()
        node = max(servers, key=lambda vs: len(vs.store.ec_volumes[vid].shards))
        base = volume_mod.volume_file_prefix(node.store.directories[0]
                                             if server_kind == "port"
                                             else node.store.locations[0]
                                             .directory, "ec", vid)
        held = {}
        for name in sorted(os.listdir(os.path.dirname(base))):
            if name.startswith(f"ec_{vid}.ec") and name[-2:].isdigit():
                with open(os.path.join(os.path.dirname(base), name),
                          "rb") as f:
                    held[name] = hashlib.sha256(f.read()).hexdigest()
        assert held
        if shell_kind == "ref":
            with pytest.raises(Exception, match=rf"ec_{vid}\.ecx|{vid}\.ecx"):
                run(env, f"volume.server.evacuate -node {node.url}")
            return
        out = run(env, f"volume.server.evacuate -node {node.url}")
        moved = [line for line in out.splitlines() if line.startswith("ec ")]
        assert len(moved) == len(held)
        others = {vs.url: vs for vs in servers if vs is not node}
        for line in moved:
            sid = int(line.split()[1].split(".")[1])
            dst = others[line.split(" -> ")[1]]
            d = (dst.store.directories[0] if server_kind == "port"
                 else dst.store.locations[0].directory)
            name = f"ec_{vid}.ec{sid:02d}"
            with open(os.path.join(d, name), "rb") as f:
                assert hashlib.sha256(f.read()).hexdigest() == held[name]
        assert not [n for n in os.listdir(os.path.dirname(base))
                    if n.startswith(f"ec_{vid}.")]
        for vs in servers:
            vs.heartbeat_now()
        doc = http_json("GET", f"http://{master.url}/dir/status")["Topology"]
        assert doc["EcCollections"] == {str(vid): "ec"}
        assert all(node.url not in urls
                   for urls in doc["EcVolumes"][str(vid)].values())
        env.unlock()
        for fid, blob in zip(fids, blobs):
            assert client.download(fid) == blob
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
