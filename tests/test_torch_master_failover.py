"""Master HA on port masters, on the CPU, against the reference.

  * a trio elects one leader that ``cluster.raft`` and ``cluster.health``
    name; a follower answers the control plane with 307, forwards POSTs,
    serves its own replicated view on ``?local=1`` and sends heartbeats
    to the leader; volume servers listing followers first heartbeat and
    ship to the leader;
  * the journal, the alert state and the repair records survive a
    failover, and a restarted master whose entries were compacted away
    catches up by InstallSnapshot to the leader's views, byte for byte;
  * ``/dir/assign`` fails closed when the volume-id commit has no quorum;
  * the drill: the leader is stopped mid-repair (its coordinator's legs
    slowed by ``coord.exec`` delay, its egress severed); the promoted
    leader's ``repair_done`` carries the planned record's alert, cause
    event and cause trace, and the rebuilt shard equals the reference's
    encode of the same ``.dat``;
  * AlertEngine and EcCoordinator export and import documents equal the
    reference's for the same input;
  * LeaderFollowingTransport learns and forgets the leader as the
    reference's does;
  * two port masters and a reference master form one quorum: each
    package leads in turn and the others apply its vid_alloc, event and
    coordinator entries (the ``/raft/*`` wire is the reference's).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.encoder import write_ec_files as ref_write_ec_files
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.ops import coordinator as ref_coordinator
from seaweedfs_tpu.utils import leader as ref_leader
from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT, to_ext
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.observability import (disable_tracing,
                                               enable_tracing, get_tracer)
from seaweedfs_tpu_torch.ops import coordinator as port_coordinator
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.utils import faultinject as fi
from seaweedfs_tpu_torch.utils import leader as port_leader
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port
from tests.test_torch_alerts import (PACKAGES, STEP_S, extra_rules, feed,
                                     red_families, snapshots)
from tests.test_torch_consensus import start_trio, wait_one_leader

EC_VID = 999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait(what: str, ok, timeout: float = 30.0):
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


def _event(i: int, prefix: str = "ha") -> dict:
    return {"id": f"{prefix}-{i}", "type": "drill_marker",
            "severity": "info", "server": "drill", "ts": 2000.0 + i,
            "details": {"i": i}}


def _stop_all(*groups) -> None:
    for group in groups:
        for s in group:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 - teardown goes on
                pass


# --- the quorum's surfaces --------------------------------------------------

def test_trio_elects_one_leader_the_shell_names(tmp_path):
    masters = start_trio(tmp_path)
    try:
        leader = wait_one_leader(masters)
        urls = [m.url for m in masters]
        out = run_command(CommandEnv(",".join(urls)), "cluster.raft")
        lines = out.splitlines()
        assert lines[0].startswith(f"masters: 3 (leader {leader.url}, term ")
        assert out.count("term=") == 3
        assert f"  {leader.url}: leader term=" in out
        doc = json.loads(run_command(CommandEnv(urls[0]),
                                     "cluster.raft -json"))
        assert set(doc["masters"]) == set(urls)
        assert sum(v["IsLeader"] for v in doc["masters"].values()) == 1
        follower = next(m for m in masters if m is not leader)
        # cluster.health through a follower: the 307 reaches the leader
        health = run_command(CommandEnv(follower.url), "cluster.health")
        assert f"masters: 3 (leader {leader.url}, term " in health
    finally:
        _stop_all(masters)


def test_a_follower_redirects_forwards_and_serves_its_copy(tmp_path):
    masters = start_trio(tmp_path)
    servers = []
    try:
        leader = wait_one_leader(masters)
        follower = next(m for m in masters if m is not leader)
        for path in ("/dir/assign", "/dir/status", "/cluster/coordinator",
                     "/cluster/events?limit=5", "/cluster/alerts",
                     "/cluster/traces", "/vol/status"):
            status, _, headers = http_bytes(
                "GET", f"http://{follower.url}{path}",
                follow_redirects=False)
            assert status == 307, path
            assert headers["Location"] == f"http://{leader.url}{path}"
        # POSTs are forwarded: the batch lands in the leader's journal
        r = http_json("POST", f"http://{follower.url}/cluster/events/ingest",
                      {"server": "drill", "events": [_event(0)]})
        assert r == {"accepted": 1, "leader": leader.url}
        assert any(e["id"] == "ha-0"
                   for e in leader.event_journal.query(limit=0))
        # and replicated back: the follower's own copy, on ?local=1
        _wait("the follower's copy", lambda: any(
            e["id"] == "ha-0" for e in http_json(
                "GET", f"http://{follower.url}/cluster/events?local=1"
                       f"&limit=0")["events"]))
        assert http_json("GET", f"http://{follower.url}/cluster/coordinator"
                                f"?local=1")["replicated"]["pending"] == {}
        # the admin lease through a follower is the leader's lease
        tok = http_json("POST", f"http://{follower.url}/admin/lease",
                        {"client_name": "shell"})["token"]
        with pytest.raises(HttpError) as e:
            http_json("POST", f"http://{leader.url}/admin/lease",
                      {"client_name": "other"})
        assert e.value.status == 423
        http_json("POST", f"http://{follower.url}/admin/release",
                  {"previous_token": tok})
        # a heartbeat to a follower names the leader
        r = http_json("POST", f"http://{follower.url}/heartbeat",
                      {"ip": "127.0.0.1", "port": 1})
        assert r == {"leader": leader.url, "not_leader": True}
        # a volume server listing the followers first still registers with
        # the leader, and its shippers learn the leader from ingest answers
        d = tmp_path / "vs"
        d.mkdir()
        order = [m.url for m in masters if m is not leader] + [leader.url]
        vs = VolumeServer([str(d)], ",".join(order), port=free_port(),
                          pulse_seconds=0.3, device="cpu").start()
        servers.append(vs)
        _wait("the server to register with the leader",
              lambda: [n.url for n in leader.topo.all_nodes()] == [vs.url])
        assert vs.master_url == leader.url
        assert not any(m.topo.all_nodes() for m in masters if m is not leader)
        from seaweedfs_tpu_torch.observability import events as _events

        _events.emit("peer_stale", server=vs.url, peer="127.0.0.1:1")
        _wait("the shipper to learn the leader",
              lambda: vs._event_shipper.transport.leader == leader.url)
        # the shell started at a follower runs a whole command there
        out = run_command(CommandEnv(follower.url), "volume.grow -count 1")
        assert out == "grew volumes: [1]"
    finally:
        _stop_all(servers, masters)


def test_state_survives_a_failover(tmp_path):
    masters = start_trio(tmp_path, metrics_aggregation_seconds=0.25)
    try:
        leader = wait_one_leader(masters)
        followers = [m for m in masters if m is not leader]
        for i in range(5):
            http_json("POST", f"http://{leader.url}/cluster/events/ingest",
                      {"server": "drill", "events": [_event(i)]})
        rec = {"id": "5:planned:1.000", "op": "planned", "vid": 5,
               "at": 1.0, "alert": "scrub_unrepairable",
               "cause_trace": "cd" * 16, "cause_event": "ha-1"}
        leader.coordinator.apply_replicated(rec)
        leader._replicate_coordinator_record(rec)
        # a firing alert in the leader's engine, replicated on the
        # telemetry cadence
        with leader.alert_engine._lock:
            st = leader.alert_engine._states["peer_down"]
            st.state, st.fired_at, st.fires = "firing", 1234.5, 1
            st.last_active = time.time()  # firing for keep_firing_s more
            st.servers, st.exemplar_trace = ["127.0.0.1:7"], "ef" * 16
        _wait("the followers to apply all three", lambda: all(
            {f"ha-{i}" for i in range(5)}
            <= {e["id"] for e in f.event_journal.query(limit=0)}
            and f.coordinator.export_replicated()["pending"].get("5")
            == rec
            and f.alert_engine.export_state()["peer_down"]
            == leader.alert_engine.export_state()["peer_down"]
            for f in followers), 15)
        leader.stop()
        new = wait_one_leader(followers, timeout=15)
        assert {f"ha-{i}" for i in range(5)} <= {
            e["id"] for e in http_json(
                "GET", f"http://{new.url}/cluster/events?limit=0")["events"]}
        status = http_json("GET", f"http://{new.url}/cluster/coordinator")
        assert status["replicated"]["pending"]["5"] == rec
        firing = {a["name"]: a for a in http_json(
            "GET", f"http://{new.url}/cluster/alerts?state=firing")["alerts"]}
        assert firing["peer_down"]["fired_at"] == 1234.5
        assert firing["peer_down"]["exemplar_trace"] == "ef" * 16
        # the promotion re-armed the orphaned record's cause
        with new.coordinator._lock:
            cause = dict(new.coordinator._causes[5])
        assert cause == {"event": "ha-1", "type": "replicated_plan",
                         "trace": "cd" * 16, "alert": "scrub_unrepairable"}
    finally:
        _stop_all(masters)


def _view(m) -> dict:
    return {"events": m.event_journal.query(limit=0),
            "coordinator": m.coordinator.export_replicated()}


def test_a_restarted_master_catches_up_by_snapshot(tmp_path):
    """tests/test_master_failover.py's catch-up on port masters: a stopped
    master misses entries the leader compacts away, then is brought back
    by InstallSnapshot to views equal to the leader's, byte for byte."""
    ports = [free_port() for _ in range(3)]
    urls = [f"127.0.0.1:{p}" for p in ports]

    def make(i):
        m = MasterServer(port=ports[i],
                         peers=[u for j, u in enumerate(urls) if j != i],
                         mdir=str(tmp_path / f"m{i}"), pulse_seconds=0.3)
        m.raft.snapshot_threshold = 8
        return m.start()

    masters = [make(i) for i in range(3)]
    try:
        leader = wait_one_leader(masters)
        for m in masters:
            m._event_shipper.detach()  # the POSTs below alone fill journals
        victim = next(m for m in masters if m is not leader)
        vi = masters.index(victim)
        victim_last = victim.raft.log.last_index
        victim.stop()
        masters.remove(victim)
        for i in range(40):
            http_json("POST", f"http://{leader.url}/cluster/events/ingest",
                      {"server": "drill", "events": [_event(i, "catchup")]})
        rec = {"id": "77:planned:1.000", "op": "planned", "vid": 77,
               "at": 1.0, "alert": "ec_under_replicated_increase",
               "cause_trace": "ab" * 16, "cause_event": "catchup-0"}
        leader.coordinator.apply_replicated(rec)
        leader._replicate_coordinator_record(rec)
        _wait("the leader to compact past the stopped master",
              lambda: leader.raft.log.base_index > victim_last, 20)
        m3 = make(vi)
        m3._event_shipper.detach()
        masters.append(m3)
        want = {f"catchup-{i}" for i in range(40)}
        _wait("the snapshot install", lambda: m3.raft.snapshots_installed
              and want <= {e["id"] for e in m3.event_journal.query(limit=0)},
              25)
        for m in masters:
            _wait(f"{m.url}'s views to equal the leader's",
                  lambda m=m: json.dumps(_view(m), sort_keys=True)
                  == json.dumps(_view(leader), sort_keys=True), 10)
        out = run_command(CommandEnv(",".join(urls)), "cluster.raft")
        assert "installed=1" in out
    finally:
        _stop_all(masters)


def test_assign_fails_closed_without_a_quorum(tmp_path):
    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    d = tmp_path / "vs"
    d.mkdir()
    vs = VolumeServer([str(d)], m.url, port=free_port(), pulse_seconds=0.3,
                      device="cpu").start()
    try:
        _wait("registration", lambda: m.topo.all_nodes())
        calls = []
        m._allocate_rpc = lambda *a, **k: calls.append(a)
        m.raft.commit_state = lambda: False
        # no writable volume yet: the assign must grow, and the growth's
        # volume-id commit fails before any allocate call
        status, body, _ = http_bytes("GET", f"http://{m.url}/dir/assign",
                                     follow_redirects=False)
        assert status == 500 and b"quorum" in body
        assert calls == []
        assert m.topo.max_volume_id == 1  # reserved, never handed out
    finally:
        _stop_all([vs, m])


# --- the drill: the leader stopped mid-repair -------------------------------

def _make_ec_volume(vs, vid: int, ref_dir, needles: int = 30) -> None:
    vs.store.add_volume(vid)
    rng = np.random.default_rng(0xFA11)
    for i in range(1, needles + 1):
        vs.store.write_needle(vid, Needle(cookie=i, id=i,
                                          data=rng.bytes(300 + i * 11)))
    base = vs.store.get_volume(vid).file_prefix
    vs.store.ec_generate(vid)
    vs.store.ec_mount(vid)
    # the reference's encode of the same .dat
    os.makedirs(ref_dir)
    shutil.copy(base + ".dat", os.path.join(ref_dir, f"{vid}.dat"))
    ref_write_ec_files(os.path.join(ref_dir, str(vid)))


def _spread_shards(servers, vid: int) -> None:
    """Round-robin the shards over every server, so each holds fewer than
    ten and a rotted one cannot be healed where it lies."""
    src, n = servers[0], len(servers)
    layout = {i: [s for s in range(TOTAL_SHARDS_COUNT) if s % n == i]
              for i in range(n)}
    for i, sids in layout.items():
        if i:
            http_json("POST", f"http://{servers[i].url}/admin/ec/copy",
                      {"volume_id": vid, "shard_ids": sids,
                       "source_data_node": src.url})
            http_json("POST", f"http://{servers[i].url}/admin/ec/mount",
                      {"volume_id": vid})
    http_json("POST", f"http://{src.url}/admin/ec/delete",
              {"volume_id": vid, "shard_ids": [
                  s for s in range(TOTAL_SHARDS_COUNT) if s not in layout[0]]})
    http_json("POST", f"http://{src.url}/admin/delete_volume",
              {"volume_id": vid})
    for vs in servers:
        vs.heartbeat_now()


def _registry(master, vid: int) -> dict:
    with master.topo.lock:
        return {sid: [n.url for n in nodes] for sid, nodes in
                master.topo.ec_shard_locations.get(vid, {}).items() if nodes}


def test_a_promoted_leader_finishes_the_orphaned_repair(tmp_path):
    # tracing on, as in the reference's drill: the scrub pass is a trace
    # root, so the rot's events, and the repair's cause, carry its id
    tracing_was_on = get_tracer().enabled
    enable_tracing()
    masters = start_trio(tmp_path / "masters",
                         metrics_aggregation_seconds=0.25,
                         coordinator_seconds=0.3)
    servers: list = []
    try:
        for m in masters:
            m.aggregator.min_interval = 0.0
            m.alert_engine.min_interval = 0.0
            m.coordinator.pause("setup")
        leader = wait_one_leader(masters)
        master_list = ",".join(m.url for m in masters)
        for i in range(4):
            d = tmp_path / f"vs{i}"
            d.mkdir()
            servers.append(VolumeServer(
                [str(d)], master_list, port=free_port(), rack=f"r{i % 2}",
                data_center="dc1", pulse_seconds=0.3, device="cpu").start())
        _wait("registration", lambda: len(leader.topo.all_nodes()) == 4)
        http_json("GET", f"http://{leader.url}/vol/grow?count=4")
        _make_ec_volume(servers[0], EC_VID, str(tmp_path / "ref"))
        _spread_shards(servers, EC_VID)
        _wait("the registry", lambda: len(_registry(leader, EC_VID))
              == TOTAL_SHARDS_COUNT)
        _wait("a first evaluation", lambda: leader.alert_engine.evaluations)
        # rot shard 2 on its holder, whose scrub can only quarantine it
        sid = 2
        holder = servers[sid % len(servers)]
        path = holder.store.ec_volumes[EC_VID].base_file_name + to_ext(sid)
        ref_shard = os.path.join(str(tmp_path / "ref"), f"{EC_VID}")
        want_sha = _sha(ref_shard + to_ext(sid))
        assert _sha(path) == want_sha
        with open(path, "r+b") as f:
            f.seek(1000)
            b = f.read(1)
            f.seek(1000)
            f.write(bytes([b[0] ^ 0x08]))
        http_json("POST", f"http://{holder.url}/ec/scrub/start",
                  {"rate_mb_s": 0, "interval_s": 0})
        _wait("the scrub", lambda: not http_json(
            "GET", f"http://{holder.url}/ec/scrub/status")["running"]
            and os.path.exists(path + ".bad"))
        _wait("the rot's alert", lambda: any(
            a["state"] == "firing" and a["name"] == "scrub_unrepairable"
            for a in leader.alert_engine.to_dict()["alerts"]))
        # the repair's legs slowed; the plan quorum-replicates first
        fi.enable("coord.exec", delay=1.0)
        for m in masters:
            m.coordinator.resume()
        followers = [m for m in masters if m is not leader]
        planned = _wait("a follower to hold the planned record", lambda: next(
            (f.coordinator.export_replicated()["pending"].get(str(EC_VID))
             for f in followers
             if f.coordinator.export_replicated()["pending"].get(
                 str(EC_VID))), None))
        assert planned["op"] == "planned"
        assert planned["alert"] and planned["cause_event"] \
            and planned["cause_trace"]
        pre_ids = {e["id"] for e in leader.event_journal.query(limit=0)}
        _wait("a follower to hold the pre-kill journal", lambda: any(
            pre_ids <= {e["id"] for e in f.event_journal.query(limit=0)}
            for f in followers))

        # stop the leader mid-repair; an in-process stop leaves its repair
        # thread running, so its egress is severed as a killed process's is
        def dead(*_a, **_k):
            raise ConnectionError("master process killed")

        leader.coordinator.executor._post_fn = dead
        leader.raft.peers = []
        t_kill = time.monotonic()
        leader.stop()
        new = wait_one_leader(followers, timeout=20)
        election_s = time.monotonic() - t_kill
        fi.disable("coord.exec")
        assert election_s < 8.0
        assert pre_ids <= {e["id"] for e in new.event_journal.query(limit=0)}

        def done():
            for e in new.event_journal.query(type_="repair_done", limit=0):
                if (e.get("details") or {}).get("vid") == EC_VID \
                        and e.get("server") == new.url:
                    return e
            return None

        ev = _wait("the promoted leader's repair_done", done, 45)
        det = ev["details"]
        assert {k: det[k] for k in ("alert", "cause_event", "cause_trace")} \
            == {k: planned[k] for k in ("alert", "cause_event",
                                       "cause_trace")}
        assert time.monotonic() - t_kill < 45.0
        # every holder of the rebuilt shard has the reference's bytes
        holders = _wait("the rebuilt shard's holders",
                        lambda: _registry(new, EC_VID).get(sid))
        by_url = {vs.url: vs for vs in servers}
        for url in holders:
            ev_ = by_url[url].store.ec_volumes[EC_VID]
            assert _sha(ev_.base_file_name + to_ext(sid)) == want_sha
        assert new.coordinator.export_replicated()["pending"] == {}
    finally:
        fi.clear()
        _stop_all(servers, masters)
        if not tracing_was_on:
            disable_tracing()


# --- documents against the reference ----------------------------------------

def test_alert_state_documents_equal_the_references():
    engines, snaps = {}, {}
    for name, (alerts_mod, events_mod, _m) in PACKAGES.items():
        engines[name] = alerts_mod.AlertEngine(
            alerts_mod.default_rules() + extra_rules(alerts_mod.Rule),
            source_fn=lambda name=name: snaps[name],
            server="127.0.0.1:9333", journal=events_mod.EventJournal(),
            min_interval=1.0)
    fams = {name: red_families(m) for name, (_a, _e, m) in PACKAGES.items()}
    now = 1_000.0
    exported = 0
    for step, (doc, restart, red, events) in enumerate(snapshots(seed=29)):
        for name, (_a, _e, metrics_mod) in PACKAGES.items():
            if restart:
                fams[name] = red_families(metrics_mod)
            feed(fams[name], red)
            snaps[name] = (copy.deepcopy(doc), fams[name])
            for etype, details in events:
                engines[name].journal.emit(etype, **details)
        for eng in engines.values():
            eng.evaluate(now=now, force=True)
        now += STEP_S
        if step % 16:
            continue
        docs = {name: eng.export_state() for name, eng in engines.items()}
        assert docs["port"] == docs["ref"], step
        # each package imports the other's document into a fresh engine
        for name, other in (("port", "ref"), ("ref", "port")):
            alerts_mod = PACKAGES[name][0]
            fresh = alerts_mod.AlertEngine(
                alerts_mod.default_rules() + extra_rules(alerts_mod.Rule),
                source_fn=lambda: ({}, {}), server="127.0.0.1:9333",
                journal=PACKAGES[name][1].EventJournal())
            fresh.import_state(docs[other])
            fresh.import_state(docs[other])  # idempotent
            assert fresh.export_state() == docs[other]
            assert fresh.to_dict()["alerts"] == \
                engines[name].to_dict()["alerts"]
        exported += sum(1 for d in docs["port"].values()
                        if d["state"] != "inactive")
    assert exported, "no alert ever left inactive: the test is inert"


def _coordinator_records(rng) -> list:
    recs = []
    for i in range(40):
        vid = int(rng.integers(1, 6))
        op = ["planned", "failed", "done"][int(rng.integers(0, 3))]
        at = 100.0 + i
        recs.append({"id": f"{vid}:{op}:{at:.3f}", "op": op, "vid": vid,
                     "at": at, "alert": "scrub_unrepairable",
                     "cause_trace": f"{vid:02x}" * 16,
                     "cause_event": f"ev-{vid}",
                     **({"error": "boom"} if op == "failed" else {})})
    return recs


def test_coordinator_records_equal_the_references():
    recs = _coordinator_records(np.random.default_rng(7))
    coords = {"port": port_coordinator.EcCoordinator(topo=None),
              "ref": ref_coordinator.EcCoordinator(topo=None)}
    for rec in recs:
        for c in coords.values():
            c.apply_replicated(dict(rec))
    docs = {n: c.export_replicated() for n, c in coords.items()}
    assert docs["port"] == docs["ref"]
    assert docs["port"]["pending"]
    for name, other in (("port", "ref"), ("ref", "port")):
        mod = port_coordinator if name == "port" else ref_coordinator
        fresh = mod.EcCoordinator(topo=None)
        fresh.import_replicated(docs[other])
        fresh.import_replicated(docs[other])
        assert fresh.export_replicated() == docs[other]
        fresh.resume_replicated()
    causes = {}
    for name, c in coords.items():
        c.resume_replicated()
        with c._lock:
            causes[name] = dict(c._causes)
    assert causes["port"] == causes["ref"] and causes["port"]
    # the records the leader makes: a plan's replicate_fn call
    sent = {n: [] for n in coords}
    for name, mod in (("port", port_coordinator), ("ref", ref_coordinator)):
        c = mod.EcCoordinator(topo=None, replicate_fn=sent[name].append)
        c._record("planned", 9, {"alert": "a", "cause_trace": "t",
                                 "cause_event": "e"}, deficit=1)
    strip = [{k: v for k, v in r.items() if k not in ("id", "at")}
             for r in sent["port"]]
    assert strip == [{k: v for k, v in r.items() if k not in ("id", "at")}
                     for r in sent["ref"]]
    assert strip[0]["op"] == "planned" and strip[0]["deficit"] == 1


def test_a_re_armed_plan_keeps_its_alert():
    """A promoted leader re-plans an orphaned repair under the planned
    record's alert even when that alert resolved since; the reference's
    names whichever relevant alert fires now (ROADMAP Queue 3, kept on
    purpose)."""
    events = [
        {"id": "e1", "type": "shard_corrupt", "trace": "t1",
         "details": {"vid": 7}},
        {"id": "a1", "type": "alert_fired",
         "details": {"alert": "corrupt_shards_increase"}},
        {"id": "a2", "type": "alert_fired",
         "details": {"alert": "scrub_unrepairable"}},
        {"id": "a3", "type": "alert_resolved",
         "details": {"alert": "corrupt_shards_increase"}}]
    rec = {"id": "7:planned:1.000", "op": "planned", "vid": 7, "at": 1.0,
           "alert": "corrupt_shards_increase", "cause_trace": "t1",
           "cause_event": "e1"}
    deficit = {7: {"deficit": 1, "critical": False, "clean": 13,
                   "under_replicated": False}}
    got = {}
    for name, mod in (("port", port_coordinator), ("ref", ref_coordinator)):
        c = mod.EcCoordinator(topo=None)
        c.on_events([dict(e) for e in events])
        c.apply_replicated(dict(rec))
        c.resume_replicated()
        if name == "port":
            c._update_queue(deficit)
        else:
            c._update_queue(None, deficit)
        e = c._queue[7]
        got[name] = (e["alert"], e["cause_event"], e["cause_trace"])
    assert got["port"] == ("corrupt_shards_increase", "e1", "t1")
    assert got["ref"] == ("scrub_unrepairable", "e1", "t1")


class _Masters:
    """A fake master set for the transports: which addresses answer, and
    the leader they name."""

    def __init__(self):
        self.up = {"m1", "m2", "m3"}
        self.leader = "m2"
        self.calls = []

    def http_json(self, method, url, payload=None, timeout=None):
        target = url.split("//", 1)[1].split("/", 1)[0]
        self.calls.append((method, target))
        if target not in self.up:
            raise HttpError(503, f"{target} unreachable")
        return {"accepted": 1, "leader": self.leader}


def _transport_story(mod, monkeypatch) -> list:
    fake = _Masters()
    monkeypatch.setattr(mod, "http_json", fake.http_json)
    cands = {"v": "m1,m2,m3"}
    tr = mod.LeaderFollowingTransport(lambda: cands["v"], name="t")
    story = []

    def step(what: str):
        try:
            r = tr.post("/cluster/events/ingest", {}) if what == "post" \
                else tr.get("/dir/lookup")
            out = r.get("leader")
        except HttpError as e:
            out = f"error {e.status}"
        story.append((what, out, tr.leader, tr.status()))

    step("post")                       # m1 answers, names m2: learned
    step("post")                       # straight to m2
    fake.up.discard("m2")              # the leader dies
    step("post")                       # fails: hint dropped, rotation
    step("get")
    fake.leader = "m3"
    step("post")                       # a follower names the new leader
    step("get")
    cands["v"] = "m3"                  # re-targeted candidate list
    fake.up.discard("m3")
    step("post")
    step("post")
    story.append(("calls", fake.calls))
    tr2 = mod.LeaderFollowingTransport(lambda: "", name="empty")
    try:
        tr2.target()
    except ConnectionError as e:
        story.append(("empty", str(e)))
    return story


def test_leader_following_transport_is_the_references(monkeypatch):
    got = _transport_story(port_leader, monkeypatch)
    want = _transport_story(ref_leader, monkeypatch)
    assert got == want
    assert got[1][2] == "m2" and got[1][3]["leader_hits"] == 1
    assert got[2][1] == "error 503" and got[2][2] == ""


# --- a mixed quorum ---------------------------------------------------------

def test_a_mixed_quorum_replicates_both_ways(tmp_path):
    ports = [free_port() for _ in range(3)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    classes = [MasterServer, MasterServer, RefMasterServer]
    masters = [cls(port=p, peers=[u for j, u in enumerate(urls) if j != i],
                   mdir=str(tmp_path / f"m{i}"), pulse_seconds=0.3).start()
               for i, (cls, p) in enumerate(zip(classes, ports))]
    try:
        wait_one_leader(masters)
        for m in masters:
            m._event_shipper.detach()
        for round_, want in enumerate((masters[2], masters[0])):
            # make `want` lead: it campaigns until it wins a term
            def leads():
                if want.is_leader and all(m.leader_url == want.url
                                          for m in masters):
                    return True
                if not want.is_leader:
                    want.raft._campaign()
                return False

            _wait(f"{want.url} to lead", leads, 20)
            base = 10 * round_
            for i in range(3):
                http_json("POST", f"http://{want.url}/cluster/events/ingest",
                          {"server": "drill",
                           "events": [_event(base + i, "mixed")]})
            rec = {"id": f"{40 + round_}:planned:1.000", "op": "planned",
                   "vid": 40 + round_, "at": 1.0, "alert": "peer_down",
                   "cause_trace": "12" * 16, "cause_event": f"mixed-{base}"}
            want.coordinator.apply_replicated(rec)
            want._replicate_coordinator_record(rec)
            with want.topo.lock:
                want.topo.max_volume_id = 50 + round_
            assert want.raft.commit_state()
            ids = {f"mixed-{base + i}" for i in range(3)}

            def applied(m):
                return (ids <= {e["id"] for e in m.event_journal.query(
                    limit=0)}
                        and m.coordinator.export_replicated()["pending"]
                        .get(str(40 + round_)) == rec
                        and m.topo.max_volume_id == 50 + round_)

            _wait("every master to apply the leader's entries",
                  lambda: all(applied(m) for m in masters), 15)
            kinds = {e["kind"] for e in masters[1].raft.log.entries}
            assert {"event", "coordinator", "vid_alloc"} <= kinds
    finally:
        _stop_all(masters)
