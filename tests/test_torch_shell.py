"""The port's shell, master and client run a whole EC cluster on the CPU.

One script, the operator's EC lifecycle: upload through WeedClient,
``ec.encode`` of the collection's full and quiet volumes, one volume
server lost (stopped, then dropped by the
master's janitor), degraded GETs from every live server, ``ec.rebuild``,
``ec.balance``, ``ec.decode`` and GETs of the decoded volume.  It runs on
four clusters of five volume servers:

  - the port alone: port master, port shell and client, port servers
    (``device="cpu"``);
  - the reference alone: seaweedfs_tpu's master, shell, client, servers;
  - the reference's shell and client driving the port's master;
  - the port's shell and client driving the reference's master.

The clusters start their servers in one order, on ports in one order, and
draw the fid cookies, clocks and random choices that end up in files or
placement from one seed, so all four must end with the same shard
placement after each step and byte-identical files (sha256 of every
``.ecNN``, ``.ecx``, ``.eci``, ``.dat`` and ``.idx``).  On port servers,
each server's own count of remote shard reads and reconstructions must
equal what its GETs needed: a GET of a shard alive on another server is
fetched from it, never reconstructed.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import random
import time

import numpy as np
import pytest
import torch

import chip_smoke
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
from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from tests.conftest import free_port

SEED = 4242
SERVERS = 5
PULSE = 0.5
COLLECTION = "ec"
EXTS = (".dat", ".idx", ".ecx", ".eci") + tuple(
    f".ec{i:02d}" for i in range(TOTAL_SHARDS_COUNT))
# (master, shell + client, volume servers)
CLUSTERS = {
    "port": ("port", "port", "port"),
    "reference": ("ref", "ref", "ref"),
    "ref_shell_on_port_master": ("port", "ref", "port"),
    "port_shell_on_ref_master": ("ref", "port", "port"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """The clock needle writes read: a fixed second and a counting
    nanosecond, so two clusters write identical `.dat` files."""

    def __init__(self, real):
        self._real = real
        self._ns = 1_700_000_000_000_000_000

    def time(self) -> float:
        return 1_700_000_000.0

    def time_ns(self) -> int:
        self._ns += 1000
        return self._ns

    def __getattr__(self, name):
        return getattr(self._real, name)


class _Secrets:
    """Seeded stand-in for ``secrets`` in the masters: fid cookies and
    lease tokens repeat from cluster to cluster."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def randbits(self, k: int) -> int:
        return self._rng.getrandbits(k)


def _needles() -> list[dict]:
    """Seeded uploads, log-uniform 4-160 KB: every fifth named, every
    seventh gzipped by the client (a text type)."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(80):
        size = int(np.exp(rng.uniform(np.log(4000), np.log(160_000))))
        if i % 7 == 3:
            data = bytes(rng.integers(97, 101, size, dtype=np.uint8))
            out.append({"data": data, "kw": {"mime": "text/plain"}})
        else:
            out.append({"data": rng.bytes(size),
                        "kw": {"name": f"n{i}.bin"} if i % 5 == 0 else {}})
    return out


def _ports() -> list[int]:
    """Ports whose urls sort as the servers are numbered: url ties in
    placement break the same way in every cluster."""
    ports = set()
    while len(ports) < SERVERS:
        p = free_port()
        if 10000 <= p <= 65535:
            ports.add(p)
    return sorted(ports, key=str)


def _disk(dirs: list[str]) -> dict:
    """server index -> {file name: sha256} of the volume's files."""
    out = {}
    for i, d in enumerate(dirs):
        files = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(EXTS):
                with open(os.path.join(d, name), "rb") as f:
                    files[name] = hashlib.sha256(f.read()).hexdigest()
        out[i] = files
    return out


def _placement(master: str, vid: int, index: dict) -> dict:
    doc = http_json("GET", f"http://{master}/dir/lookup_ec?volumeId={vid}")
    return {int(s): sorted(index[u] for u in urls)
            for s, urls in doc["shards"].items() if urls}


def _wait(what: str, ok, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not ok():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def run_lifecycle(tmp_path, kinds: tuple, monkeypatch) -> dict:
    master_kind, shell_kind, server_kind = kinds
    # what ends up in files or placement repeats from cluster to cluster
    for mod in (master_mod, ref_master_mod):
        monkeypatch.setattr(mod, "secrets", _Secrets(SEED))
    res: dict = {}
    if master_kind == "port":
        master = MasterServer(port=free_port(), volume_size_limit_mb=64,
                              pulse_seconds=PULSE).start()
    else:
        master = RefMasterServer(port=free_port(), volume_size_limit_mb=64,
                                 pulse_seconds=PULSE).start()
    servers, dirs = [], []
    try:
        for i, port in enumerate(_ports()):
            d = str(tmp_path / f"vs{i}")
            os.makedirs(d)
            dirs.append(d)
            if server_kind == "port":
                vs = server_mod.VolumeServer(
                    [d], master.url, port=port, max_volume_count=8,
                    pulse_seconds=PULSE, device="cpu")
            else:
                vs = RefVolumeServer([d], master.url, port=port,
                                     max_volume_count=8, pulse_seconds=PULSE,
                                     needle_cache_mb=0)
            servers.append(vs.start())
            # one at a time: the master lists them in this order
            _wait("registration", lambda: len(master.topo.all_nodes()) == i + 1)
        index = {vs.url: i for i, vs in enumerate(servers)}
        client = (WeedClient(master.url) if shell_kind == "port"
                  else RefWeedClient(master.url))
        env = (CommandEnv(master.url) if shell_kind == "port"
               else RefCommandEnv(master.url))
        run = run_command if shell_kind == "port" else ref_run_command

        def sync():
            for vs in servers:
                if vs is not None:
                    vs.heartbeat_now()

        # one volume, grown with one seed, holds every needle
        random.seed(SEED)
        if master_kind == "port":
            master.topo.rng.seed(SEED)
        vid = http_json("GET", f"http://{master.url}/vol/grow?collection="
                        f"{COLLECTION}&count=1")["volumeIds"][0]
        needles = _needles()
        with monkeypatch.context() as m:
            for mod in (volume_mod, server_mod, ref_volume_mod,
                        ref_server_mod):
                m.setattr(mod, "time", _Clock(time))
            fids = [client.upload(n["data"], collection=COLLECTION, **n["kw"])
                    for n in needles]
        assert {FileId.parse(f).volume_id for f in fids} == {vid}
        source = next(i for i, vs in enumerate(servers)
                      if vid in vs.store.volumes)
        res["source"] = source
        sync()

        env.lock()
        # by candidate selection: the collection's full (here 1% of the
        # 64 MB limit) and quiet volumes, which is this one alone
        out = run(env, f"ec.encode -collection {COLLECTION} -fullPercent 1 "
                       f"-quietFor 0")
        assert out.startswith(f"ec encoded volume {vid} ") and \
            "\n" not in out, out
        sync()
        res["encode"] = (_placement(master.url, vid, index), _disk(dirs))
        for i, n in enumerate(needles):
            assert client.download(fids[i]) == n["data"]

        # lose the holder of shard 0 (the first data shard) and its shards
        placed = res["encode"][0]
        victim = placed[0][0]
        lost = sorted(s for s, holders in placed.items() if victim in holders)
        victim_url = servers[victim].url
        servers[victim].stop()
        servers[victim] = None
        _wait("the master to drop the lost server",
              lambda: victim_url not in {n.url for n in
                                         master.topo.all_nodes()})
        holders = _placement(master.url, vid, index)
        assert sorted(holders) == sorted(set(range(14)) - set(lost))
        base = volume_file_prefix(dirs[source], COLLECTION, vid)
        shards_of = chip_smoke.needle_shards(
            base, vid, [FileId.parse(f).key for f in fids])
        # every live server serves every needle; count what each needed
        before = {i: dict(getattr(vs, "ec_reads", {}))
                  for i, vs in enumerate(servers) if vs is not None}
        expect = {}
        for i, vs in enumerate(servers):
            if vs is None:
                continue
            need = {"remote": 0, "reconstructed": 0}
            for k, n in enumerate(needles):
                status, body, headers = http_bytes(
                    "GET", f"http://{vs.url}/{fids[k]}")
                if headers.get("Content-Encoding") == "gzip":
                    body = gzip.decompress(body)
                assert (status, body) == (200, n["data"]), (i, k)
                for sid in shards_of[k]:
                    if sid in lost:
                        need["reconstructed"] += 1
                    elif i not in holders[sid]:
                        need["remote"] += 1
            expect[i] = need
        assert sum(e["remote"] for e in expect.values()) > 0
        assert sum(e["reconstructed"] for e in expect.values()) > 0
        if server_kind == "port":
            assert {i: {k: servers[i].ec_reads[k] - before[i][k]
                        for k in before[i]} for i in expect} == expect

        out = run(env, f"ec.rebuild -volumeId {vid}"
                  + (" -engine cpu" if shell_kind == "ref" else ""))
        assert "rebuilt shards" in out, out
        sync()
        res["rebuild"] = (_placement(master.url, vid, index), _disk(dirs))
        assert sorted(res["rebuild"][0]) == list(range(14))
        out = run(env, "ec.balance")
        sync()
        res["balance"] = (_placement(master.url, vid, index), _disk(dirs))
        out = run(env, f"ec.decode -volumeId {vid}")
        assert f"decoded ec volume {vid}" in out, out
        sync()
        env.unlock()
        res["decode"] = _disk(dirs)
        for k in range(0, len(needles), 3):
            assert client.download(fids[k]) == needles[k]["data"]
        res["fids"] = fids
        return res
    finally:
        for vs in servers:
            if vs is not None:
                vs.stop()
        master.stop()


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return run_lifecycle(tmp_path_factory.mktemp("reference"),
                             CLUSTERS["reference"], mp)


@pytest.mark.parametrize("cluster", ["port", "ref_shell_on_port_master",
                                     "port_shell_on_ref_master"])
def test_lifecycle_equals_the_reference(cluster, reference_run, tmp_path,
                                        monkeypatch):
    got = run_lifecycle(tmp_path, CLUSTERS[cluster], monkeypatch)
    for step in ("encode", "rebuild", "balance", "decode"):
        assert got[step] == reference_run[step], step
    assert got["fids"] == reference_run["fids"]
    assert got["source"] == reference_run["source"]
