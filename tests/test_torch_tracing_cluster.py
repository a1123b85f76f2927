"""Traces and the event journal across a live cluster on the CPU: the port
against seaweedfs_tpu.

  - a sampled degraded GET on a port cluster (master and volume servers,
    ``device="cpu"``) is stitched at the master's /cluster/traces/<id>
    into the span names a reference cluster gives the same reads: the
    answering server's request span, the lookup at the master, the
    holder's /admin/ec/shard_read hop for a shard on another server, and
    ``ec.reconstruct`` exactly on the reads of a lost shard;
  - a port server's shippers are accepted by the reference's master and a
    reference server's by the port's;
  - a rotted shard's ``shard_corrupt`` and ``scrub_unrepairable`` reach
    ``EcCoordinator.on_events`` through the master's journal, and the
    repair the coordinator runs carries the same cause (the event's type,
    its trace, the alert) on the port's master as on the reference's;
  - the shells' ``trace.fetch``, ``trace.analyze -file`` and
    ``events.tail`` print the same text, modulo ids and times.

Tracing runs with head sampling at rate 0: only the forced or propagated
traces record, so heartbeats and scrapes stay out of the collector.
"""

from __future__ import annotations

import json
import re
import time

import numpy as np
import pytest
import torch

import seaweedfs_tpu.observability as ref_obs
import seaweedfs_tpu_torch.observability as port_obs
from seaweedfs_tpu.client.operation import WeedClient as RefWeedClient
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.observability import context as ref_context
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT, to_ext
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.observability import context as port_context
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

PULSE = 0.2
COLLECTION = "ec"
# the small-block rows are 1 MB a shard: ~1.5 MB of needles fill shard 0
# and part of shard 1
NEEDLES, NEEDLE_MAX = 30, 100_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_on():
    """Both packages' process tracers on, sampling only what is forced or
    propagated; off again afterwards, as they start."""
    for obs, ctx in ((port_obs, port_context), (ref_obs, ref_context)):
        obs.enable_tracing()
        obs.get_tracer().clear()
        ctx.set_sample_rate(0.0)
    yield
    for obs, ctx in ((port_obs, port_context), (ref_obs, ref_context)):
        obs.disable_tracing()
        obs.get_tracer().clear()
        ctx.set_sample_rate(1.0)


def _wait(what: str, ok, timeout: float = 60.0):
    t0 = time.monotonic()
    while True:
        got = ok()
        if got:
            return got
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


KINDS = {
    # master, volume server (and its keywords), client, shell
    "port": (MasterServer, VolumeServer, {"device": "cpu"}, WeedClient,
             CommandEnv, run_command),
    "reference": (RefMasterServer, RefVolumeServer, {"needle_cache_mb": 0},
                  RefWeedClient, RefCommandEnv, ref_run_command),
}


class Cluster:
    def __init__(self, tmp_path, master_kind: str, server_kinds: list[str],
                 coordinator_seconds: float = 0.0):
        self.master = KINDS[master_kind][0](
            port=free_port(), pulse_seconds=PULSE,
            coordinator_seconds=coordinator_seconds,
            metrics_aggregation_seconds=coordinator_seconds).start()
        self.env_cls, self.run = KINDS[master_kind][4:]
        self.client = KINDS[master_kind][3](self.master.url)
        self.servers: dict = {}
        self.dirs: dict[str, str] = {}
        self.stopped: set[str] = set()
        try:
            if coordinator_seconds:
                self.shell("coordinator.pause")
            for i, kind in enumerate(server_kinds):
                d = tmp_path / f"{master_kind}-vs{i}"
                d.mkdir()
                _, vs_cls, kw, *_ = KINDS[kind]
                vs = vs_cls([str(d)], self.master.url, port=free_port(),
                            pulse_seconds=PULSE, **kw).start()
                self.servers[vs.url] = vs
                self.dirs[vs.url] = str(d)
            _wait("every server to register", lambda: len(
                self.master.topo.all_nodes()) == len(server_kinds))
        except BaseException:
            self.stop()
            raise

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
        return volume_file_prefix(self.dirs[url],
                                  COLLECTION, vid) + to_ext(sid)

    def encoded_volume(self, seed: int) -> tuple[int, list, list]:
        vid = self.get(f"/vol/grow?collection={COLLECTION}&count=1")[
            "volumeIds"][0]
        rng = np.random.default_rng(seed)
        data = [rng.integers(0, 256, int(rng.integers(1_000, NEEDLE_MAX)),
                             dtype=np.uint8).tobytes()
                for _ in range(NEEDLES)]
        fids = [self.client.upload(d, collection=COLLECTION) for d in data]
        out = self.shell(f"ec.encode -volumeId {vid} -collection "
                         f"{COLLECTION} -engine tpu")
        assert f"ec encoded volume {vid}" in out, out
        assert sorted(self.holders(vid)) == list(range(TOTAL_SHARDS_COUNT))
        return vid, fids, data

    def stop_server(self, url: str) -> None:
        self.servers[url].stop()
        self.stopped.add(url)
        _wait("the master to drop the stopped server", lambda: url not in
              {n.url for n in self.master.topo.all_nodes()})

    def stop(self) -> None:
        for url, vs in self.servers.items():
            if url not in self.stopped:
                vs.stop()
        self.master.stop()


def _trace(c: Cluster, trace_id: str, root: str) -> dict:
    """The stitched trace once it is whole: its ``root`` span and the far
    side of every ``rpc.client`` hop have shipped."""
    def shipped():
        try:
            doc = c.get(f"/cluster/traces/{trace_id}")
        except Exception:  # noqa: BLE001 - not collected yet
            return None
        spans = doc["spans"]
        parents = {s.get("parent") for s in spans}
        whole = any(s["name"] == root for s in spans) and all(
            s["id"] in parents for s in spans if s["name"] == "rpc.client")
        return doc if whole else None

    return _wait(f"trace {trace_id}", shipped, 15)


def _shards_of(c: Cluster, front: str, vid: int, fid: str) -> list[int]:
    """The shards a GET of the needle reads, from the answering server's
    `.ecx` and the shard geometry."""
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
    from seaweedfs_tpu_torch.storage.file_id import FileId

    ev = EcVolume(volume_file_prefix(c.dirs[front], COLLECTION, vid), vid)
    try:
        return [iv.to_shard_id_and_offset(ev.large_block_size,
                                          ev.small_block_size,
                                          ev.data_shards)[0]
                for iv in ev.locate_ec_shard_needle(
                    FileId.parse(fid).key)[2]]
    finally:
        ev.close()


def traced_degraded_gets(tmp_path, kind: str) -> dict:
    """Four servers of ``kind``; the holder of shard 1 stopped; every
    needle GET from the holder of shard 2 with X-Force-Trace.  -> the
    span names per read class and the traces."""
    c = Cluster(tmp_path, kind, [kind] * 4)
    try:
        vid, fids, data = c.encoded_volume(seed=5)
        h = c.holders(vid)
        front = h[2][0]
        lost = h[1][0]
        c.stop_server(lost)
        classes: dict[str, list[dict]] = {"a": [], "b": [], "local": []}
        for fid, d in zip(fids, data):
            shards = _shards_of(c, front, vid, fid)
            status, body, hdrs = http_bytes(
                "GET", f"http://{front}/{fid}",
                headers={"X-Force-Trace": "1"})
            assert status == 200 and body == d
            cls = ("b" if any(lost in h[s] for s in shards) else
                   "a" if any(front not in h[s] for s in shards) else
                   "local")
            doc = _trace(c, hdrs["X-Trace-Id"], "http.volume.read_object")
            remote = sorted({s for s in shards if front not in h[s]
                             and lost not in h[s]})
            classes[cls].append({"remote": remote, "doc": doc})
        return {"classes": classes, "front": front, "holders": h}
    finally:
        c.stop()


def _names(docs: list[dict]) -> set[str]:
    return {s["name"] for d in docs for s in d["doc"]["spans"]}


def test_degraded_get_traces_stitch_like_the_reference(tmp_path):
    got = {kind: traced_degraded_gets(tmp_path, kind)
           for kind in ("reference", "port")}
    for kind, res in got.items():
        cl = res["classes"]
        assert cl["a"] and cl["b"], (kind, {k: len(v) for k, v in cl.items()})
    port, ref = got["port"]["classes"], got["reference"]["classes"]
    for cls in ("a", "b", "local"):
        assert _names(port[cls]) == _names(ref[cls]), cls
    front = got["port"]["front"]
    for cls, reads in port.items():
        for r in reads:
            doc = r["doc"]
            spans = doc["spans"]
            names = [s["name"] for s in spans]
            # one stitched tree: a single root, the front's request span
            roots = [s for s in spans if not s.get("parent") or s["parent"]
                     not in {x["id"] for x in spans}]
            assert [s["name"] for s in roots] == ["http.volume.read_object"]
            assert roots[0]["server"] == front
            recon = [s for s in spans if s["name"] == "ec.reconstruct"]
            if cls == "b":
                assert recon and all(s["server"] == front for s in recon)
            else:
                assert not recon, names
            hops = [s for s in spans
                    if s["name"] == "http.volume.ec_shard_read"]
            assert all(s["attrs"]["path"] == "/admin/ec/shard_read"
                       and s["server"] != front for s in hops)
            if cls == "a":
                # the hop to each remote shard's holder
                holders = {u for sid in r["remote"]
                           for u in got["port"]["holders"][sid]}
                assert hops and {s["server"] for s in hops} <= holders
            assert doc["analysis"]["root"]["name"] == \
                "http.volume.read_object"


def test_shippers_cross_accepted_both_ways(tmp_path):
    """A port server under the reference's master and a reference server
    under the port's: each server's sampled spans and journal events land
    in the other package's collector and journal."""
    for master_kind, server_kind, obs in (("reference", "port", port_obs),
                                          ("port", "reference", ref_obs)):
        c = Cluster(tmp_path, master_kind, [server_kind])
        try:
            (url,) = c.servers
            status, _, hdrs = http_bytes(
                "GET", f"http://{url}/status",
                headers={"X-Force-Trace": "1"})
            assert status == 200
            tid = hdrs["X-Trace-Id"]
            doc = _trace(c, tid, "http.volume.status")
            assert [s["name"] for s in doc["spans"]] == ["http.volume.status"]
            assert doc["servers"] == [url]
            from seaweedfs_tpu_torch.observability import events as pe
            from seaweedfs_tpu.observability import events as re_
            ev_mod = pe if obs is port_obs else re_
            ev = ev_mod.get_journal().emit("scrub_repair", server=url,
                                           vid=99, shards=[1], blocks=3,
                                           error="")
            got = _wait("the event at the master", lambda: [
                e for e in c.get("/cluster/events?type=scrub_repair")[
                    "events"] if e["id"] == ev.id])
            assert got[0]["server"] == url and got[0]["via"] == url
            assert got[0]["severity"] == "warning"
        finally:
            c.stop()


def rot_drill(tmp_path, master_kind: str) -> dict:
    """Port servers under ``master_kind``'s master with its coordinator
    paused: a byte of one shard flipped, ``ec.scrub -all``; once the
    scrub's events are in the cluster journal and the coordinator has
    seen the ``scrub_unrepairable`` alert fire, coordinator.resume, until
    the coordinator repaired the volume.  -> the repair entry, the journal
    and the coordinator's cause bookkeeping."""
    c = Cluster(tmp_path, master_kind, ["port"] * 5, coordinator_seconds=0.2)
    try:
        vid, _fids, _data = c.encoded_volume(seed=9)
        h = c.holders(vid)
        host = min(c.servers, key=lambda u: (
            -sum(u in us for us in h.values()), u))
        rot = min(s for s, us in h.items() if host in us)
        with open(c.shard_path(host, vid, rot), "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x04]))
        out = c.shell("ec.scrub -all -rate 0")
        assert f"volume {vid}: unrepairable corrupt_shards=[{rot}]" in out
        _wait("the scrub's events at the master", lambda: c.get(
            "/cluster/events?type=scrub_unrepairable")["events"])
        # the repair names the alert its cause maps to only once the
        # coordinator has seen that alert fire; until then another rot
        # alert that fired first (corrupt_shards_increase, a counter's
        # rule, on an earlier scrape under load) is named instead
        _wait("the rot's alert at the coordinator", lambda:
              "scrub_unrepairable" in c.master.coordinator._alerts)
        c.shell("coordinator.resume")
        st = _wait("the repair", lambda: (
            lambda s: s if s["repairs"]["done"] >= 1 else None)(
                c.get("/cluster/coordinator")))
        _wait("repair_done in the journal", lambda: c.get(
            "/cluster/events?type=repair_done")["events"])
        return {"vid": vid, "host": host, "rot": rot,
                "repair": next(r for r in st["recent"]
                               if r["action"] == "repair_done"),
                "events": c.get("/cluster/events?limit=0")["events"],
                "master": c.master.url}
    finally:
        c.stop()


def test_rot_events_reach_the_coordinator_like_the_reference(tmp_path):
    got = {kind: rot_drill(tmp_path, kind) for kind in ("reference", "port")}
    causes = {}
    for kind, res in got.items():
        by_id = {e["id"]: e for e in res["events"]}
        repair = res["repair"]
        cause = by_id[repair["cause_event"]]  # a journaled event's id
        assert cause["details"]["vid"] == res["vid"]
        assert cause["server"] == res["host"]
        # the scrub pass was force-sampled: its trace is the cause's
        assert cause.get("trace") and repair["cause_trace"] == cause["trace"]
        order = [(e["type"], e.get("server")) for e in res["events"]
                 if e["type"] in ("shard_corrupt", "scrub_unrepairable",
                                  "repair_planned", "repair_done")]
        assert order[:4] == [("shard_corrupt", res["host"]),
                             ("scrub_unrepairable", res["host"]),
                             ("repair_planned", res["master"]),
                             ("repair_done", res["master"])], order
        planned = next(e for e in res["events"]
                       if e["type"] == "repair_planned")
        assert planned["details"]["cause_event"] == cause["id"]
        # each event type's severity and detail keys, as the master saw
        shapes = {e["type"]: (e["severity"], sorted(e["details"]))
                  for e in res["events"]}
        causes[kind] = (cause["type"], repair["alert"],
                        planned["details"]["alert"], cause["severity"],
                        planned["trace"] != cause["trace"],
                        {t: shapes[t] for t in ("shard_corrupt",
                                                "scrub_unrepairable",
                                                "repair_planned",
                                                "repair_done")})
    assert causes["port"] == causes["reference"]
    assert causes["port"][0] == "scrub_unrepairable"


def test_a_running_coordinator_names_the_rot_it_repairs(tmp_path):
    """The coordinator runs through the rot, unpaused, and no event
    shipper flushes on its own clock: each heartbeat first ships the
    events journaled before the state it carries, so the repair of the
    quarantined shard names the scrub's event as its cause.  (In one
    process every shipper, the master's too, sees every event.)"""
    c = Cluster(tmp_path, "port", ["port"] * 5, coordinator_seconds=0.2)
    try:
        for sv in [c.master, *c.servers.values()]:
            sv._event_shipper.flush_interval = 3600.0
            sv._event_shipper._wake.set()
        vid, _fids, _data = c.encoded_volume(seed=9)
        h = c.holders(vid)
        host = min(c.servers, key=lambda u: (
            -sum(u in us for us in h.values()), u))
        rot = min(s for s, us in h.items() if host in us)
        c.shell("coordinator.resume")
        with open(c.shard_path(host, vid, rot), "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x04]))
        out = c.shell("ec.scrub -all -rate 0")
        assert f"volume {vid}: unrepairable corrupt_shards=[{rot}]" in out
        st = _wait("the repair", lambda: (
            lambda s: s if s["repairs"]["done"] >= 1 else None)(
                c.get("/cluster/coordinator")))
        repair = next(r for r in st["recent"]
                      if r["action"] == "repair_done")
        events = _wait("repair_planned in the journal", lambda: [
            e for e in c.get("/cluster/events?limit=0")["events"]
            if e["type"] in ("shard_corrupt", "scrub_unrepairable",
                             "repair_planned")] or None)
        by_id = {e["id"]: e for e in events}
        assert repair["cause_event"] in by_id, (repair, events)
        cause = by_id[repair["cause_event"]]
        assert cause["type"] in ("shard_corrupt", "scrub_unrepairable")
        assert cause["details"]["vid"] == vid and cause["server"] == host
        assert cause.get("trace") and repair["cause_trace"] == cause["trace"]
        order = [e["type"] for e in events]
        assert order.index("shard_corrupt") < order.index("repair_planned")
    finally:
        c.stop()


def _mask(text: str) -> str:
    text = re.sub(r"\b[0-9a-f]{32}\b", "<trace>", text)
    text = re.sub(r"\b\d\d:\d\d:\d\d\b", "<hh:mm:ss>", text)
    text = re.sub(r"127\.0\.0\.1:\d+", "<host>", text)
    return re.sub(r"\d+\.\d+(s|ms)?", "<n>", text)


def test_shell_trace_and_event_commands_match(tmp_path):
    c = Cluster(tmp_path, "port", ["port"] * 2)
    try:
        (url, _) = sorted(c.servers)
        status, _, hdrs = http_bytes("GET", f"http://{url}/status",
                                     headers={"X-Force-Trace": "1"})
        tid = hdrs["X-Trace-Id"]
        _trace(c, tid, "http.volume.status")
        from seaweedfs_tpu_torch.observability import events as pe
        pe.get_journal().emit("scrub_unrepairable", server=url, vid=4,
                              shards=[2], blocks=7, error="")
        pe.get_journal().emit("peer_stale", server=c.master.url,
                              peer=url, error="HttpError: 503")
        _wait("both events", lambda: c.get("/cluster/events")["count"] >= 2)
        trace_file = tmp_path / "trace.json"
        status, body, _ = http_bytes("GET", f"http://{url}/debug/traces")
        trace_file.write_bytes(body)
        lines = [f"trace.fetch {tid}", f"trace.fetch -trace {tid} -json",
                 "trace.fetch -list", f"trace.analyze -file {trace_file}",
                 f"trace.analyze -server {url}", "events.tail",
                 "events.tail -n 1", "events.tail -min_severity critical",
                 f"events.tail -server {url} -type scrub_unrepairable",
                 "events.tail -json -type peer_stale"]
        for line in lines:
            port_out = run_command(CommandEnv(c.master.url), line)
            ref_out = ref_run_command(RefCommandEnv(c.master.url), line)
            if line.endswith("-json") or " -json " in line:
                port_doc, ref_doc = json.loads(port_out), json.loads(ref_out)
                assert _mask(json.dumps(port_doc, sort_keys=True)) == \
                    _mask(json.dumps(ref_doc, sort_keys=True)), line
            elif "-server" in line and "analyze" in line:
                # each command's own sampled request joins the live ring
                # between the two calls: counts differ, the text does not
                assert re.sub(r"\d+", "<n>", _mask(port_out)) == \
                    re.sub(r"\d+", "<n>", _mask(ref_out)), line
            else:
                assert _mask(port_out) == _mask(ref_out), line
        out = run_command(CommandEnv(c.master.url), "events.tail")
        assert "critical scrub_unrepairable" in out and "vid=4" in out
        # a bare trace.fetch shows the previous command's trace
        env = CommandEnv(c.master.url)
        run_command(env, "volume.list")
        assert env.last_trace_id and env.prev_trace_id == ""
        run_command(env, "cluster.ps")
        assert env.prev_trace_id != env.last_trace_id
    finally:
        c.stop()
