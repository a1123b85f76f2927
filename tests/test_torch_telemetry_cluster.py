"""Heat, the ledger and the request log across a live cluster on the CPU:
the port against seaweedfs_tpu.

A port cluster (``MasterServer`` and two ``VolumeServer(device="cpu")``)
and a reference cluster (its master and two servers, ``ec_engine="cpu"``)
take one request script, serialized from one client thread: the shell's
``workload.record -sample 1.0``; HTTP writes of seeded needles to
volumes 1 and 2 (one a server) and volume 3; Zipf reads of volumes 1 and
2 (the needle cache admits the head); framed W, R, D and B ops; volume 3
EC-encoded on its server with data shards 0 and 1 deleted, then read
back (every read reconstructs); ``workload.stop``, ``workload.export``.
Heat's and the request log's clocks are frozen (each module's ``time``)
for the run, so decayed rates are exact.

Compared, at tolerance 0, with these left out: the records' ids,
timestamps, durations (``ms``), trace ids and ``via`` (which of the
process's chained shippers delivered a record first); the ``lookup``
records, all of them the volume servers' own calls to the master (their
number rides heartbeat timing and each server's replica-lookup cache);
the shipper counters (shipments are timed); every host:port, mapped to
its role; and of /cluster/ledger everything but its route classes (CPU
times and rates on the wall clock).

- each server's /debug/heat (volume rates, the needle sketch, noted);
- /cluster/heat's volume ranks, rates, head set and Zipf fit;
- /cluster/workload/export's records and summary (every GET of volume 3
  a 200 ``http_read``);
- /cluster/ledger's route classes;
- the shells' workload.record / stop / export, heat.volumes and heat.top;
- /status ``Heat`` and ``Ledger``, and ``-heat.off -ledger.off``: no heat
  noted, no ``Ledger``, /debug/ledger 404, as the reference.

The raft log: a follower applying the leader's ``workload`` entries holds
the leader's records, and a snapshot round-trips ``workload``.

chip_smoke.py's ``telemetry`` phase is rehearsed at a tiny size on CLI
processes (``-ec.engine cpu``): its flash crowd pages, its recording
holds one record per GET, its on/off/on overhead passes run, and its
scenarios leg profiles the recording, replays it against the cluster
(verdict pass, every fidelity check ok) and probes every route's
capacity (a looser SLO than the card's, p99 < 250 ms).

Shippers stop with their servers, and the recorders are off after.
"""

from __future__ import annotations

import http.client
import json
import re
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.observability import heat as ref_heat
from seaweedfs_tpu.observability import reqlog as ref_reqlog
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.storage.file_id import FileId
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu.volume_server.tcp import TcpVolumeClient as RefTcpClient
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.observability import heat as port_heat
from seaweedfs_tpu_torch.observability import reqlog as port_reqlog
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.utils.framing import tcp_address
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from seaweedfs_tpu_torch.volume_server.tcp import TcpVolumeClient
import chip_smoke
from tests.conftest import free_port
from tests.test_torch_reqlog import StubClock, reset_recorder

PULSE = 0.2
KINDS = {
    "port": (MasterServer, VolumeServer, {"device": "cpu"}, CommandEnv,
             run_command, TcpVolumeClient, port_heat, port_reqlog),
    "ref": (RefMasterServer, RefVolumeServer, {"ec_engine": "cpu"},
            RefCommandEnv, ref_run_command, RefTcpClient, ref_heat,
            ref_reqlog),
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


def _req(url: str, method: str, path: str, body: bytes = None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _json(url: str, path: str, body=None) -> dict:
    status, data = _req(url, "POST" if body is not None else "GET", path,
                        None if body is None else json.dumps(body).encode())
    assert status == 200, (path, status, data[:200])
    return json.loads(data)


def needles(seed: int, vid: int, count: int, lo: int, hi: int) -> list:
    rng = np.random.default_rng(seed)
    return [(str(FileId(vid, 0x100 + i, 0x5EED0000 + i)),
             rng.bytes(int(rng.integers(lo, hi))))
            for i in range(count)]


VOL1 = needles(1, 1, 30, 200, 4000)
VOL2 = needles(2, 2, 30, 200, 4000)
# about 1.2 MB: its data spans EC data shards 0 and 1 (1 MB small blocks)
VOL3 = needles(3, 3, 40, 20_000, 40_000)
FRAMED = needles(4, 1, 6, 100, 900)


class Run:
    """One cluster of ``kind`` driven through the script."""

    def __init__(self, kind: str, root):
        (master_cls, vs_cls, kw, self.env_cls, self.run_cmd, tcp_cls,
         self.heat_mod, self.reqlog_mod) = KINDS[kind]
        self.kind = kind
        self.master = master_cls(port=free_port(),
                                 pulse_seconds=PULSE).start()
        self.servers = []
        for i in range(2):
            d = root / f"{kind}-vs{i}"
            d.mkdir()
            self.servers.append(vs_cls(
                [str(d)], self.master.url, port=free_port(),
                pulse_seconds=PULSE, heat_halflife_s=30.0, **kw).start())
        self.tcp = tcp_cls()
        self.names = {self.master.url: "master",
                      self.servers[0].url: "vsA",
                      self.servers[1].url: "vsB"}
        for u in list(self.names):
            self.names[tcp_address(u)] = self.names[u] + "-tcp"

    def shell(self, line: str) -> str:
        env = self.env_cls(self.master.url)
        env.lock()
        try:
            return self.norm(self.run_cmd(env, line))
        finally:
            env.unlock()

    def norm(self, obj):
        """Every host:port of this cluster by its role."""
        text = json.dumps(obj) if not isinstance(obj, str) else obj
        for url, name in sorted(self.names.items(), key=lambda kv:
                                -len(kv[0])):
            text = text.replace(url, name)
        return json.loads(text) if not isinstance(obj, str) else text

    def stop(self) -> None:
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def drive(run: Run, tmp) -> dict:
    a, b = run.servers
    out: dict = {}
    _wait("both servers to register",
          lambda: len(run.master.topo.all_nodes()) == 2)
    for vs, vid in ((a, 1), (b, 2), (a, 3)):
        _json(vs.url, "/admin/assign_volume", {"volume_id": vid})
    out["record"] = run.shell("workload.record -sample 1.0 -seed 7")
    for vs, batch in ((a, VOL1), (b, VOL2), (a, VOL3)):
        for fid, data in batch:
            assert _req(vs.url, "PUT", f"/{fid}", data)[0] == 201
    rng = np.random.default_rng(9)
    picks = np.minimum(rng.zipf(1.2, 240), len(VOL1)) - 1
    for i, p in enumerate(picks):
        vs, batch = (a, VOL1) if i % 3 else (b, VOL2)
        fid, data = batch[int(p)]
        status, body = _req(vs.url, "GET", f"/{fid}")
        assert status == 200 and body == data
    assert _req(a.url, "GET", "/1,ffff00000000")[0] == 404
    addr = tcp_address(a.url)
    for fid, data in FRAMED:
        run.tcp.write(addr, fid, data)
    for fid, data in FRAMED[:4]:
        assert run.tcp.read(addr, fid) == data
    run.tcp.delete(addr, FRAMED[5][0])
    assert run.tcp.batch_read(addr, [f for f, _ in FRAMED[:3]]) == \
        [d for _, d in FRAMED[:3]]
    for path in ("/admin/ec/generate", "/admin/ec/mount",
                 "/admin/delete_volume"):
        _json(a.url, path, {"volume_id": 3})
    _json(a.url, "/admin/ec/delete", {"volume_id": 3, "shard_ids": [0, 1]})
    def survivors() -> list:
        status, data = _req(run.master.url, "GET",
                            "/dir/lookup_ec?volumeId=3")
        return sorted(int(s) for s in json.loads(data).get("shards", {})) \
            if status == 200 else []

    _wait("the master to see volume 3's survivors",
          lambda: survivors() == list(range(2, 14)))
    for fid, data in VOL3:
        status, body = _req(a.url, "GET", f"/{fid}")
        assert status == 200 and body == data
    out["stop"] = run.shell("workload.stop")
    rl = run.reqlog_mod.get_recorder()
    recorded = rl.status()["recorded"]
    _wait("every record at the master",
          lambda: len(run.master.workload_journal) >= recorded)
    out["export_line"] = run.shell(
        f"workload.export -out {tmp / (run.kind + '.json')}").replace(
        str(tmp / (run.kind + ".json")), "OUT")
    out["export"] = json.load(open(tmp / (run.kind + ".json")))
    # two more heat shipments from each server after the last read
    shipped = [vs._heat_shipper.shipped for vs in run.servers]
    _wait("two more heat shipments", lambda: all(
        vs._heat_shipper.shipped >= n + 2
        for vs, n in zip(run.servers, shipped)))
    out["debug_heat"] = [_json(vs.url, "/debug/heat?top=1024")
                         for vs in run.servers]
    out["cluster_heat"] = _json(run.master.url, "/cluster/heat?top=256")
    out["heat_volumes"] = run.shell("heat.volumes -top 10")
    out["heat_top"] = run.shell("heat.top -top 5")
    _wait("the ledger of every server", lambda: len(
        _json(run.master.url, "/cluster/ledger")["peers"]) == 3)
    out["cluster_ledger"] = _json(run.master.url, "/cluster/ledger?top=256")
    out["debug_ledger"] = [_json(vs.url, "/debug/ledger")
                           for vs in run.servers]
    out["status"] = [_json(vs.url, "/status") for vs in run.servers]
    return out


DROP_RECORD = ("id", "seq", "ts", "ms", "trace", "via")


def _records(run: Run, doc: dict) -> list:
    """The records in the order they were made (the journal orders by
    time, then id; the frozen clock leaves the id's sequence)."""
    recs = [{k: v for k, v in r.items() if k not in DROP_RECORD}
            for r in sorted(doc["records"], key=lambda r: r["seq"])
            if r["route"] != "lookup"]
    return run.norm(recs)


def _heat_doc(run: Run, doc: dict) -> dict:
    d = {k: v for k, v in doc.items() if k not in ("shipper", "ts")}
    d["volumes"] = {v: {k: x for k, x in row.items() if k != "trace"}
                    for v, row in d["volumes"].items()}
    return run.norm(d)


def _cluster_heat(run: Run, doc: dict) -> dict:
    d = {k: v for k, v in doc.items() if k not in ("ts", "ingested")}
    d["volumes"] = [{k: v for k, v in row.items() if k != "trace"}
                    for row in d["volumes"]]
    d["peers"] = {p: {k: v for k, v in row.items() if k != "ts"}
                  for p, row in d["peers"].items()}
    return run.norm(d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry")
    clock = StubClock()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for kind in ("ref", "port"):
            mp.setattr(KINDS[kind][6], "time", clock)
            mp.setattr(KINDS[kind][7], "time", clock)
        for kind in ("ref", "port"):
            reset_recorder(KINDS[kind][7])
            run = Run(kind, root)
            try:
                out[kind] = (run, drive(run, root))
            finally:
                run.stop()
                reset_recorder(KINDS[kind][7])
    return out


def test_debug_heat_equals_the_references(runs):
    (pr, p), (rr, r) = runs["port"], runs["ref"]
    got = [_heat_doc(pr, d) for d in p["debug_heat"]]
    want = [_heat_doc(rr, d) for d in r["debug_heat"]]
    assert got == want
    a = got[0]
    assert set(a["volumes"]) == {"1", "3"} and a["noted"] > 0
    assert a["volumes"]["1"]["cache_hit_rate"] > 0


def test_cluster_heat_ranks_equal_the_references(runs):
    (pr, p), (rr, r) = runs["port"], runs["ref"]
    assert _cluster_heat(pr, p["cluster_heat"]) == \
        _cluster_heat(rr, r["cluster_heat"])
    assert [v["volume"] for v in p["cluster_heat"]["volumes"]] == \
        [v["volume"] for v in r["cluster_heat"]["volumes"]]
    assert p["heat_volumes"] == r["heat_volumes"]
    assert p["heat_top"] == r["heat_top"]


def test_workload_export_equals_the_references(runs):
    (pr, p), (rr, r) = runs["port"], runs["ref"]
    got, want = _records(pr, p["export"]), _records(rr, r["export"])
    assert got == want
    summ = [{k: v for k, v in doc["export"]["summary"]["routes"].items()
             if k != "lookup"} for doc in (p, r)]
    assert summ[0] == summ[1]
    vol3 = [x for x in got if x["path"].startswith("/3,")]
    assert len(vol3) == len(VOL3) + len(VOL3)  # the PUTs and the GETs
    assert all(x["status"] == 200 for x in vol3 if x["method"] == "GET")
    assert {x["route"] for x in got} >= {
        "http_read", "http_write", "native_read", "native_write",
        "native_delete"}
    # the export's lines less the lookups (its total counts them)
    lines = [[re.sub(r"^wrote OUT: \d+ records", "wrote OUT: N records", ln)
              for ln in doc["export_line"].splitlines()
              if not ln.strip().startswith("lookup")] for doc in (p, r)]
    assert lines[0] == lines[1] and len(lines[0]) > 3
    assert p["record"] == r["record"]

    def stop_lines(doc):
        # the recorded counts, less the servers' own lookups
        n = sum(1 for x in doc["export"]["records"]
                if x["route"] == "lookup")
        return re.sub(r"recorded=(\d+)",
                      lambda m: f"recorded={int(m.group(1)) - n}",
                      doc["stop"])

    assert stop_lines(p) == stop_lines(r)


def test_cluster_ledger_route_classes_equal_the_references(runs):
    (pr, p), (rr, r) = runs["port"], runs["ref"]

    def classes(doc):
        return sorted(row["route"] for row in doc["routes"])

    assert classes(p["cluster_ledger"]) == classes(r["cluster_ledger"])
    assert "http_read" in classes(p["cluster_ledger"])
    assert sorted(pr.norm(list(p["cluster_ledger"]["peers"]))) == \
        sorted(rr.norm(list(r["cluster_ledger"]["peers"])))
    for doc in p["debug_ledger"]:
        assert {"routes", "clients", "stall", "loop", "profile",
                "shipper"} <= set(doc)
    for st_p, st_r in zip(p["status"], r["status"]):
        for key in ("Heat", "Ledger"):
            assert set(st_p[key]) == set(st_r[key])
            assert {k: v for k, v in st_p[key].items()
                    if k not in ("shipped", "dropped", "noted")} == \
                {k: v for k, v in st_r[key].items()
                 if k not in ("shipped", "dropped", "noted")}


def test_shippers_stop_with_their_servers(runs):
    pr, _ = runs["port"]
    for vs in pr.servers:
        for sh in (vs._heat_shipper, vs._ledger_shipper,
                   vs._reqlog_shipper):
            assert sh._thread is not None and not sh._thread.is_alive()
    assert not port_reqlog.get_recorder().enabled


def test_accounting_off_as_the_reference(tmp_path):
    out = {}
    for kind, cls, kw in (("ref", RefVolumeServer, {"ec_engine": "cpu"}),
                          ("port", VolumeServer, {"device": "cpu"})):
        d = tmp_path / kind
        vs = cls([str(d)], f"127.0.0.1:{free_port()}", port=free_port(),
                 pulse_seconds=30, heat=False, ledger=False, **kw).start()
        try:
            _json(vs.url, "/admin/assign_volume", {"volume_id": 1})
            for fid, data in VOL1[:5]:
                assert _req(vs.url, "PUT", f"/{fid}", data)[0] == 201
                assert _req(vs.url, "GET", f"/{fid}")[0] == 200
            st = _json(vs.url, "/status")
            heat = _json(vs.url, "/debug/heat")
            out[kind] = (st["Heat"], "Ledger" in st,
                         _req(vs.url, "GET", "/debug/ledger"),
                         {k: v for k, v in heat.items()
                          if k not in ("ts", "server")},
                         vs.router.heat, vs.router.ledger)
        finally:
            vs.stop()
    assert out["port"] == out["ref"]
    assert out["port"][0]["noted"] == 0 and out["port"][2][0] == 404


def test_debug_ec_kernel_counts_launches_by_width(tmp_path, monkeypatch):
    from collections import Counter

    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul

    monkeypatch.setattr(gf_matmul, "launches", 7)
    monkeypatch.setattr(gf_matmul, "widths",
                        Counter({1064: 5, 8 << 20: 2}))
    vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{free_port()}",
                      port=free_port(), pulse_seconds=30,
                      device="cpu").start()
    try:
        doc = _json(vs.url, "/debug/ec/kernel")
        st = _json(vs.url, "/status")
    finally:
        vs.stop()
    assert doc == {"launches": 7,
                   "widths": {"1064": 5, str(8 << 20): 2}}
    assert st["EcKernelLaunches"] == 7
    assert st["EcKernelWidths"]["<=4KiB"] == 5
    assert chip_smoke.widths_added({1064: 5}, {1064: 9, 17: 1}) == \
        {1064: 4, 17: 1}


def _fired(alert: str, ts: float, servers: list) -> dict:
    return {"type": "alert_fired", "ts": ts,
            "details": {"alert": alert, "servers": servers}}


def test_bundles_owed_are_the_fire_s_servers():
    m, a, b, c = "m:1", "a:1", "b:1", "c:1"
    events = [_fired("heat_shift", 10.0, [a]),
              _fired("heat_shift", 20.0, [a, b])]
    # the current fire (fired_at 20) named a and b; the alert now names c
    alert = {"fired_at": 20.0, "servers": [c],
             "bundles": [{"server": a, "id": "x"},
                         {"server": b, "error": "ConnectionRefused"},
                         {"server": m, "id": "y"}]}
    miss = chip_smoke.bundles_missing
    assert miss(m, "heat_shift", alert, events, killed={b}) == []
    # a capture error stands in only for a server the drill killed
    assert miss(m, "heat_shift", alert, events, killed=set()) == [b]
    assert miss(m, "heat_shift", dict(alert, bundles=alert["bundles"][1:]),
                events, killed={b}) == [a]
    # a provoked alert also owes its current servers, as before
    assert miss(m, "heat_shift", alert, events, killed={b},
                provoked=("heat_shift",)) == [c]
    # no bundle is owed until the fire's event is journaled
    assert miss(m, "heat_shift", dict(alert, fired_at=30.0), events,
                killed={b}) == ["alert_fired"]
    assert chip_smoke.fired_servers(events, "heat_shift",
                                    {"fired_at": 10.0}) == [a]
    assert chip_smoke.fired_servers(events, "flash_crowd",
                                    {"fired_at": 10.0}) is None


def test_debug_reqlog_routes_answer_as_the_references(tmp_path):
    out = {}
    for kind, cls, kw in (("ref", RefVolumeServer, {"ec_engine": "cpu"}),
                          ("port", VolumeServer, {"device": "cpu"})):
        mod = KINDS[kind][7]
        reset_recorder(mod)
        vs = cls([str(tmp_path / kind)], f"127.0.0.1:{free_port()}",
                 port=free_port(), pulse_seconds=30, **kw).start()
        try:
            answers = []
            for body in ({"sample": 0}, {"sample": 2}, {"size": 0},
                         {"sample": "x"}, {"sample": 1.0, "size": 64,
                                           "seed": 3}):
                answers.append(_req(vs.url, "POST", "/debug/reqlog/start",
                                    json.dumps(body).encode())[0])
            _json(vs.url, "/admin/assign_volume", {"volume_id": 1})
            for fid, data in VOL1[:4]:
                _req(vs.url, "PUT", f"/{fid}?jwt=SECRET", data)
                _req(vs.url, "GET", f"/{fid}")
            got = _json(vs.url, "/debug/reqlog?limit=5")
            bad = _req(vs.url, "GET", "/debug/reqlog?limit=x")[0]
            stopped = _json(vs.url, "/debug/reqlog/stop", {})
            recs = [{k: v for k, v in x.items() if k not in DROP_RECORD}
                    for x in got["records"]]
            cfg = {k: v for k, v in got["config"].items()
                   if k not in ("namespace", "started_at")}
            out[kind] = (answers, recs, cfg, bad, stopped["enabled"])
        finally:
            vs.stop()
            reset_recorder(mod)
    assert out["port"] == out["ref"]
    assert out["port"][0] == [400, 400, 400, 400, 200]
    assert all("SECRET" not in x["path"] for x in out["port"][1])


# --- the raft log ---------------------------------------------------------------

class _LogOnly:
    """A leader's raft stand-in: records what the master appends."""

    peers = ["127.0.0.1:1"]
    is_leader = True

    def __init__(self):
        self.entries: list = []

    def append(self, kind, data, sync=False):
        self.entries.append((kind, json.loads(json.dumps(data))))


def test_workload_replicates_over_raft(monkeypatch):
    leader = MasterServer(port=free_port())
    follower = MasterServer(port=free_port())
    restored = MasterServer(port=free_port())
    log = _LogOnly()
    monkeypatch.setattr(leader, "_leader_raft", lambda: log)
    rl = port_reqlog.ReqlogRecorder(sample=1.0, namespace="raft")
    rl.start()
    recs = [rl.record("http_read", "GET", f"/3,{i:x}0000beef", 200,
                      bytes_out=i).to_dict() for i in range(1, 60)]
    leader.workload_journal.ingest("vs:1", recs[:40])
    leader.workload_journal.ingest("vs:2", recs[30:])  # 10 repeats
    assert [k for k, _ in log.entries] == ["workload", "workload"]
    assert sum(len(d["records"]) for _, d in log.entries) == len(recs)
    for kind, data in log.entries + log.entries:  # a replay is idempotent
        follower._apply_raft_entry(kind, data)
    want = leader.workload_journal.query(limit=0)
    assert follower.workload_journal.query(limit=0) == want
    snap = json.loads(json.dumps(leader._raft_read_snapshot()))
    assert snap["workload"] == want
    restored._raft_apply_snapshot(snap)
    assert restored.workload_journal.query(limit=0) == want
    assert {r["via"] for r in want} == {"vs:1", "vs:2"}
    # a follower's own ingest appends nothing
    monkeypatch.setattr(follower, "_leader_raft", lambda: None)
    follower.workload_journal.ingest("vs:3", [dict(recs[0], id="x.1")])
    assert len(log.entries) == 2


def test_master_health_counts_lost_records():
    ms = MasterServer(port=free_port())
    before = ms._local_health_contribution()["reqlog_records_dropped"]
    rl = port_reqlog.ReqlogRecorder(capacity=16, sample=1.0,
                                    namespace="loss")
    rl.start()
    for i in range(20):
        rl.record("http_read", "GET", f"/1,{i:x}", 200)
    after = ms._local_health_contribution()["reqlog_records_dropped"]
    assert after - before == 4
    assert re.fullmatch(r"\d+", str(after))


def test_telemetry_phase_on_cpu(tmp_path):
    res = chip_smoke.run_telemetry_phase(
        "cpu", str(tmp_path), n=600, size=1024, clients=4, gets_a=400,
        gets_b=150, volumes=3, halflife_s=2.0, replay_s=3.0,
        probe_step_s=0.3, probe_p99_ms=250.0, probe_max_rps=400.0)
    checks = res["checks"]
    assert checks["flash_crowd"]["details"]["volume"] == \
        res["ec_volume"]["vid"]
    assert checks["flash_crowd"]["alert_state"] == "firing"
    assert checks["flash_crowd"]["paged_by"] in (
        "alert_fired_after_pass_b", "firing_alert_detail")
    assert f"volume={res['ec_volume']['vid']}" in \
        checks["flash_crowd"]["alert_detail"]
    assert checks["heat_rank"][0]["volume"] == res["ec_volume"]["vid"]
    assert not checks["pass_a_head_in_sketch"]["missing"]
    rec = checks["recording"]
    assert rec["http_read"] == rec["gets_issued"] == 550
    assert rec["pass_b_records"] == 150
    assert all(checks["shell"].values())
    assert [r["accounting"] for r in res["overhead"]] == ["on", "off", "on"]
    assert all(r["gets"] == 150 for r in res["overhead"])
    assert res["ec_volume"]["lost_data_shards"] == [0]
    # the scenarios leg, on the servers of the last overhead pass
    scn = res["scenarios"]
    assert scn["profile"]["records"] == 550
    assert scn["profile"]["read_fraction"] == 1.0
    assert scn["profile"]["top_key_count"] == scn["profile"]["top_key_gets"]
    assert scn["profile"]["heat_zipf"]["distinct"] >= 3
    assert scn["replay"]["verdict"] == "pass"
    assert set(scn["replay"]["fidelity"]) == {
        "fidelity_op_mix", "fidelity_size_mix", "fidelity_hot_head",
        "fidelity_replayed_op_mix", "fidelity_pacing"}
    assert set(scn["capacity"]) == set(chip_smoke.SCENARIOS_ROUTES)
    assert all(r["capacity_rps"] > 0 for r in scn["capacity"].values())
    # each knee and capacity step logs its requests (its rate times the
    # 0.3 s step), and whether its p99 is its slowest request (100 or
    # fewer)
    for r in scn["capacity"].values():
        n = r["capacity_step_requests"]
        assert n == max(int(0.3 * r["capacity_target_rps"]), 1)
        assert r["p99_is_slowest"]["capacity_step_requests"] == (n <= 100)
        assert (r["knee_step_requests"] is None) == (r["knee_rps"] is None)
    assert scn["slo"]["max_p99_ms"] == 250.0
    assert scn["parked_equal"] and scn["health_line"].startswith("capacity:")
    # one client's writes, split into the assign and POST hops
    split = scn["write_split"]
    assert split["n"] == chip_smoke.SCENARIOS_SPLIT_WRITES
    assert split["slo_ms"] == 250.0
    for hop in ("assign", "post", "write"):
        assert 0 < split[hop]["p50"] <= split[hop]["p90"] <= split[hop]["p99"]
        assert 0 <= split[hop]["over_slo"] <= split["n"]
    assert not any(scn["launches"].values())
