"""Autonomous EC repair, live on the CPU: no typed ec.rebuild.

Five in-process port volume servers (``device="cpu"``) under a master
whose coordinator runs every 0.2 s (``coordinator_seconds``), with the
aggregator scraping as often.  A volume is uploaded and ec.encoded through
the shell, then, with no repair command typed:

  - rot: a byte of one shard flipped on a server that holds fewer than
    ten, ``ec.scrub -all`` quarantines it as unrepairable; the
    coordinator rebuilds it and re-scrubs, until every shard's holders
    hold the bytes from before any loss and /cluster/health counts no
    unrepairable verdict;
  - loss: a server stopped; the coordinator rebuilds its shards until
    every shard has a live holder with those bytes, and every needle
    reads back.

Two clusters run it: the port's master and shell, and the reference's
master and shell over the same port servers (the reference coordinator
asks for engine "cpu", which a CPU port server takes), which holds the
port servers' /metrics, /ec/scrub/start and rebuild legs to the wire the
reference's master speaks.  On the port's master, the reference's shell
and the port's render coordinator.status and cluster.health identically.
"""

from __future__ import annotations

import hashlib
import re
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT, to_ext
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
from seaweedfs_tpu_torch.utils.httpd import http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

PULSE = 0.2
CYCLE = 0.2
SERVERS = 5
COLLECTION = "ec"
# (master class, shell's CommandEnv, shell's run_command)
CLUSTERS = {
    "port": (MasterServer, CommandEnv, run_command),
    "reference_master": (RefMasterServer, RefCommandEnv, ref_run_command),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait(what: str, ok, timeout: float = 60.0):
    t0 = time.monotonic()
    while True:
        got = ok()
        if got:
            return got
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Cluster:
    def __init__(self, kind: str, tmp_path):
        master_cls, self.env_cls, self.run = CLUSTERS[kind]
        self.master = master_cls(port=free_port(), pulse_seconds=PULSE,
                                 coordinator_seconds=CYCLE,
                                 metrics_aggregation_seconds=CYCLE).start()
        self.servers: dict[str, VolumeServer] = {}
        self.shell("coordinator.pause")
        for i in range(SERVERS):
            d = tmp_path / f"vs{i}"
            d.mkdir()
            vs = VolumeServer([str(d)], self.master.url, port=free_port(),
                              pulse_seconds=PULSE, device="cpu").start()
            self.servers[vs.url] = vs
        _wait("every server to register",
              lambda: len(self.master.topo.all_nodes()) == SERVERS)
        self.stopped: set[str] = set()

    def shell(self, line: str) -> str:
        env = self.env_cls(self.master.url)
        env.lock()
        try:
            return self.run(env, line)
        finally:
            env.unlock()

    def get(self, path: str) -> dict:
        return http_json("GET", f"http://{self.master.url}{path}")

    def holders(self, vid: int) -> dict[int, list[str]]:
        doc = self.get(f"/dir/lookup_ec?volumeId={vid}")
        return {int(s): [u for u in us if u not in self.stopped]
                for s, us in doc["shards"].items()}

    def shard_path(self, url: str, vid: int, sid: int) -> str:
        return volume_file_prefix(self.servers[url].store.directories[0],
                                  COLLECTION, vid) + to_ext(sid)

    def wait_healed(self, vid: int, hashes: dict, done: int) -> dict:
        """Until a repair since ``done`` finished, the queue is empty and
        every shard has a live holder whose bytes are the original's."""
        def healed():
            st = self.get("/cluster/coordinator")
            h = self.holders(vid)
            if st["repairs"]["done"] <= done or st["queue"] or \
                    sorted(s for s, us in h.items() if us) != \
                    list(range(TOTAL_SHARDS_COUNT)):
                return None
            try:
                same = all(_sha(self.shard_path(u, vid, s)) == hashes[s]
                           for s, us in h.items() for u in us)
            except FileNotFoundError:
                return None  # a move's source dropped its copy: look again
            assert same, f"a healed shard of volume {vid} differs"
            return st

        return _wait(f"volume {vid} to heal", healed)

    def stop(self):
        for url, vs in self.servers.items():
            if url not in self.stopped:
                vs.stop()
        self.master.stop()


def run_drill(kind: str, tmp_path) -> tuple[Cluster, dict]:
    c = Cluster(kind, tmp_path)
    try:
        vid = http_json("GET", f"http://{c.master.url}/vol/grow?collection="
                               f"{COLLECTION}&count=1")["volumeIds"][0]
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(7)
        data = [rng.integers(0, 256, int(rng.integers(1, 120_000)),
                             dtype=np.uint8).tobytes() for _ in range(40)]
        fids = [client.upload(d, collection=COLLECTION) for d in data]
        out = c.shell(f"ec.encode -volumeId {vid} -collection {COLLECTION} "
                      f"-engine tpu")
        assert f"ec encoded volume {vid}" in out, out
        h = c.holders(vid)
        assert sorted(h) == list(range(TOTAL_SHARDS_COUNT))
        hashes = {s: _sha(c.shard_path(us[0], vid, s)) for s, us in h.items()}
        assert c.shell("coordinator.resume").startswith("coordinator:")

        # rot on a server that holds fewer than ten shards
        host = min(c.servers, key=lambda u: (
            -sum(u in us for us in h.values()), u))
        rot = min(s for s, us in h.items() if host in us)
        path = c.shard_path(host, vid, rot)
        with open(path, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x04]))
        # ec.scrub -all adds one pass on the host, its re-scrub another
        passes = http_json("GET",
                           f"http://{host}/ec/scrub/status")["passes"] + 1
        out = c.shell("ec.scrub -all -rate 0")
        assert f"volume {vid}: unrepairable corrupt_shards=[{rot}]" in out, out
        st = c.wait_healed(vid, hashes, 0)

        def verdict_cleared() -> bool:
            # from a scrape after the host's re-scrub pass
            doc = c.get("/cluster/health")
            scrub = doc["peers"].get(host, {}).get("scrub") or {}
            return scrub.get("passes", 0) > passes and \
                not scrub["running"] and \
                doc["totals"]["scrub_unrepairable"] == 0

        _wait("/cluster/health to clear the unrepairable verdict",
              verdict_cleared)
        rot_repair = next(r for r in st["recent"]
                          if r["action"] == "repair_done")

        # loss: a server that is not the rot's host
        victim = next(u for u in sorted(c.servers) if u != host
                      and any(u in us for us in c.holders(vid).values()))
        c.servers[victim].stop()
        c.stopped.add(victim)
        st = c.wait_healed(vid, hashes, st["repairs"]["done"])
        assert st["repairs"]["failed"] == 0 and not st["queue"]
        loss_repair = next(r for r in st["recent"]
                           if r["action"] == "repair_done")
        assert set(loss_repair["rebuilt"]) >= {
            s for s, us in h.items() if us == [victim]}
        client = WeedClient(c.master.url)
        for fid, d in zip(fids, data):
            assert client.download(fid) == d
        return c, {"rot": (rot, rot_repair), "loss": loss_repair,
                   "status": st}
    except BaseException:
        c.stop()
        raise


@pytest.mark.parametrize("kind", list(CLUSTERS))
def test_coordinator_heals_rot_and_loss(kind, tmp_path):
    c, res = run_drill(kind, tmp_path)
    try:
        rot, rot_repair = res["rot"]
        assert rot_repair["rebuilt"] == [rot]
        assert rot_repair["rescrubbed"]  # the holders re-verified it
        assert res["status"]["repairs"]["done"] >= 2
        if kind == "port":
            # the port's coordinator asks the servers for their own engine
            assert c.master.coordinator.engine == "tpu"
    finally:
        c.stop()


def _mask_ages(text: str) -> str:
    return re.sub(r"age=[\d.]+s|\"age_s\": [\d.]+", "<age>", text)


def test_shell_renderings_equal_the_reference(tmp_path):
    """coordinator.status and cluster.health (plain and -json) from the
    port's shell and the reference's, against the same port master after
    the drill; only the scrape ages are masked."""
    c, _res = run_drill("port", tmp_path)
    try:
        c.shell("coordinator.pause")
        # the telemetry loop's next wait outlasts the test: no scrape or
        # evaluation between the two shells' renderings
        c.master.metrics_aggregation_seconds = 3600.0
        _wait("the stopped server to leave the registry",
              lambda: len(c.master.topo.all_nodes()) == SERVERS - 1)
        c.master.aggregator.scrape(force=True, include_scrub=True)
        c.master.aggregator.min_interval = 3600.0  # no scrape in between
        for line in ("coordinator.status", "coordinator.status -json",
                     "cluster.health", "cluster.health -json"):
            port_out = run_command(CommandEnv(c.master.url), line)
            ref_out = ref_run_command(RefCommandEnv(c.master.url), line)
            assert _mask_ages(port_out) == _mask_ages(ref_out), line
        health = run_command(CommandEnv(c.master.url), "cluster.health")
        assert health.splitlines()[1] == \
            f"masters: 1 (leader {c.master.url}, term 0)"
        assert "repair_done" in run_command(CommandEnv(c.master.url),
                                            "coordinator.status")
    finally:
        c.stop()
