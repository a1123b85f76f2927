"""The port's heat autoscaler (seaweedfs_tpu_torch/ops/autoscaler.py)
against seaweedfs_tpu.ops.autoscaler, on the CPU.

- The reference's planner drills (tests/test_autoscaler.py: grow, shrink
  hysteresis, replicated resume, the tier loop, pause and views) run on
  both packages' HeatAutoscaler over the reference's fake topology and
  recording transport, fed the same heat documents and events under one
  stub clock.  Each drill keeps the reference's assertions, and the two
  runs must make the same ``(server, path, payload)`` calls, hand
  ``replicate_fn`` the same raft records, journal the same events and
  end with equal ``status()``, ``export_replicated()`` and
  ``autoscale.status`` lines.
- ``autoscale`` raft entries: a 2 + 1 mixed quorum of port and reference
  masters applies each other's records; the reference's
  kill-during-replica-add drill on a port trio over port volume servers
  (the promoted leader closes a landed grow without a second copy and
  re-runs the unlanded one to the recorded destination).
- The routes and the shell: ``/cluster/autoscale``, ``/pause``,
  ``/resume``, ``/tier`` and ``autoscale.*`` / ``volume.tier`` on a port
  and a reference cluster with a ``dir`` backend, each shell on its own
  and on the other's cluster, print the same lines; the tiered needles
  read back, and the recalled ``.dat`` keeps its sha256.
- ``python -m seaweedfs_tpu_torch master -autoscaleSeconds 1`` runs the
  loop.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.observability import events as ref_events
from seaweedfs_tpu.ops import autoscaler as ref_autoscaler
from seaweedfs_tpu.shell import autoscale_commands as ref_commands
from seaweedfs_tpu.shell.commands import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell.commands import run_command as ref_run_command
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.observability import events as port_events
from seaweedfs_tpu_torch.ops import autoscaler as port_autoscaler
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.shell import autoscale_commands as port_commands
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port
from tests.test_autoscaler import (_FakeNode, _FakeTopo, _FakeVol, _heat_doc,
                                   _three_rack_topo, _Transport)
from tests.test_torch_consensus import start_trio, wait_one_leader
from tests.test_torch_reqlog import StubClock
from tests.test_torch_tier import _exchange, _needles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": (ref_autoscaler, ref_events, ref_commands),
            "port": (port_autoscaler, port_events, port_commands)}
AUTOSCALE_EVENTS = ("replica_grow", "replica_shrink", "tier_committed",
                    "tier_recall", "autoscale_failed")


def _wait(what: str, ok, timeout: float = 30.0):
    t0 = time.monotonic()
    while True:
        got = ok()
        if got:
            return got
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


# --- the planner drills, both packages ---------------------------------------

class Kit:
    """One package's run of a drill: its HeatAutoscaler class, the stub
    clock, the recording transport and the records handed to
    replicate_fn."""

    def __init__(self, cls, clock: StubClock):
        self.cls = cls
        self.clock = clock
        self.tr = _Transport()
        self.records: list[dict] = []
        self.made: list = []

    def mk(self, topo, tr=None, **kw):
        kw.setdefault("interval_s", 999.0)
        kw.setdefault("grow_share", 0.3)
        kw.setdefault("max_replicas", 3)
        kw.setdefault("hold_down_s", 0.05)
        kw.setdefault("regrow_cooldown_s", 0.05)
        kw.setdefault("move_rate", 100.0)
        kw.setdefault("move_burst", 100.0)
        kw.setdefault("actuation_deadline_s", 10.0)
        a = self.cls(topo, server="m1", post_fn=tr or self.tr,
                     replicate_fn=self.records.append, **kw)
        self.made.append(a)
        return a


# TestGrow

def grow_rack_diverse(k):
    topo, nodes = _three_rack_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}))
    out = a.run_cycle()
    assert out["grown"] == 1
    copies = k.tr.of("/admin/volume_copy")
    assert len(copies) == 1
    dst, _path, payload = copies[0]
    assert dst in ("vs1:80", "vs2:80")  # a different rack
    assert payload["source_data_node"] == "vs0:80"
    assert payload["volume_id"] == 5
    st = a.status()
    assert st["grows"] == 1
    assert st["targets"]["5"]["added"] == [dst]
    assert [r["op"] for r in st["replicated"]["log"]] == \
        ["grow_planned", "grow_done"]


def grow_carries_cause(k):
    topo, _ = _three_rack_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}))
    a.on_events([
        {"type": "alert_fired", "id": "e1",
         "details": {"alert": "flash_crowd", "exemplar_trace": "a" * 32}},
        {"type": "flash_crowd", "id": "e2", "trace": "b" * 32,
         "details": {"volume": 5}},
    ])
    a.run_cycle()
    rec = a.status()["replicated"]["log"][-1]
    assert rec["op"] == "grow_done"
    assert rec["alert"] == "flash_crowd"
    assert rec["cause_trace"] == "b" * 32
    assert rec["cause_event"] == "e2"


def cold_does_not_grow(k):
    topo, _ = _three_rack_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.1}, head=[]))
    assert a.run_cycle()["grown"] == 0
    assert not k.tr.of("/admin/volume_copy")


def max_replicas_caps(k):
    topo, nodes = _three_rack_topo()
    nodes[1].volumes[5] = _FakeVol(size=1000)
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}), max_replicas=2)
    assert a.run_cycle()["grown"] == 0
    assert not k.tr.of("/admin/volume_copy")


def already_here_is_success(k):
    topo, _ = _three_rack_topo()
    k.tr.errors["/admin/volume_copy"] = RuntimeError(
        "409: volume 5 already here")
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}))
    assert a.run_cycle()["grown"] == 1
    assert a.status()["failures"] == 0


def grow_failure_recorded(k):
    topo, _ = _three_rack_topo()
    k.tr.errors["/admin/volume_copy"] = RuntimeError("boom")
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}))
    assert a.run_cycle()["grown"] == 0
    st = a.status()
    assert st["failures"] == 1
    assert a.health_contribution() == {"autoscale_failures": 1}
    assert [r["op"] for r in st["replicated"]["log"]] == \
        ["grow_planned", "grow_failed"]


def move_budget_bucket(k):
    nodes = [_FakeNode("vs0:80", "r0"), _FakeNode("vs1:80", "r1"),
             _FakeNode("vs2:80", "r2")]
    nodes[0].volumes[5] = _FakeVol(size=1000)
    nodes[1].volumes[6] = _FakeVol(size=1000)
    a = k.mk(_FakeTopo(nodes), heat_fn=lambda: _heat_doc({5: 0.5, 6: 0.5}),
             move_rate=0.0, move_burst=1.0)
    assert a.run_cycle()["grown"] == 1  # one token, two candidates
    assert len(k.tr.of("/admin/volume_copy")) == 1


# TestShrinkHysteresis

def _grown(k, **kw):
    topo, nodes = _three_rack_topo()
    heat = {"doc": _heat_doc({5: 0.9})}
    a = k.mk(topo, heat_fn=lambda: heat["doc"], **kw)
    a.run_cycle()
    dst = k.tr.of("/admin/volume_copy")[0][0]
    next(n for n in nodes if n.url == dst).volumes[5] = _FakeVol(size=1000)
    return a, heat, nodes


def shrink_waits_hold_down(k):
    a, heat, _ = _grown(k, hold_down_s=5.0)
    heat["doc"] = _heat_doc({5: 0.0}, head=[])
    assert a.run_cycle()["shrunk"] == 0
    assert not k.tr.of("/admin/delete_volume")


def sustained_cold_shrinks(k):
    a, heat, _ = _grown(k, hold_down_s=0.05)
    heat["doc"] = _heat_doc({5: 0.0}, head=[])
    a.run_cycle()           # starts the cold clock
    k.clock.step(0.08)
    assert a.run_cycle()["shrunk"] == 1
    dels = k.tr.of("/admin/delete_volume")
    assert len(dels) == 1 and dels[0][2]["volume_id"] == 5
    st = a.status()
    assert st["shrinks"] == 1
    assert st["targets"]["5"]["added"] == []
    assert st["targets"]["5"]["cycles"] == 1


def heat_blip_resets(k):
    a, heat, _ = _grown(k, hold_down_s=0.15)
    heat["doc"] = _heat_doc({5: 0.0}, head=[])
    a.run_cycle()
    k.clock.step(0.08)
    heat["doc"] = _heat_doc({5: 0.9})  # a blip: hot again
    a.run_cycle()
    heat["doc"] = _heat_doc({5: 0.0}, head=[])
    a.run_cycle()
    k.clock.step(0.08)      # past the first deadline, not the new one
    assert a.run_cycle()["shrunk"] == 0
    assert not k.tr.of("/admin/delete_volume")


def regrow_cooldown(k):
    a, heat, nodes = _grown(k, hold_down_s=0.01, regrow_cooldown_s=5.0)
    heat["doc"] = _heat_doc({5: 0.0}, head=[])
    a.run_cycle()
    k.clock.step(0.03)
    assert a.run_cycle()["shrunk"] == 1
    for n in nodes[1:]:
        n.volumes.pop(5, None)
    heat["doc"] = _heat_doc({5: 0.9})  # at once hot again
    assert a.run_cycle()["grown"] == 0  # the cooldown holds
    assert len(k.tr.of("/admin/volume_copy")) == 1


def cycle_cap(k):
    a, heat, nodes = _grown(k, hold_down_s=0.01, regrow_cooldown_s=0.01,
                            max_cycles_per_volume=1)
    heat["doc"] = _heat_doc({5: 0.0}, head=[])
    a.run_cycle()
    k.clock.step(0.03)
    assert a.run_cycle()["shrunk"] == 1
    for n in nodes[1:]:
        n.volumes.pop(5, None)
    k.clock.step(0.03)      # the cooldown is over: only the cap holds
    heat["doc"] = _heat_doc({5: 0.9})
    assert a.run_cycle()["grown"] == 0
    assert len(k.tr.of("/admin/volume_copy")) == 1


# TestReplicatedResume

def landed_grow_closes(k):
    topo, nodes = _three_rack_topo()
    nodes[1].volumes[5] = _FakeVol(size=1000)
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}), max_replicas=2)
    a.apply_replicated({"id": "5:grow_planned:1", "op": "grow_planned",
                        "vid": 5, "at": k.clock.time(), "dst": "vs1:80",
                        "src": "vs0:80", "alert": "flash_crowd",
                        "cause_trace": "c" * 32, "cause_event": "e9"})
    a.resume_replicated()
    out = a.run_cycle()
    assert out["resumed"] == 1
    assert not k.tr.of("/admin/volume_copy")
    st = a.status()
    assert st["replicated"]["pending"] == {}
    done = [r for r in st["replicated"]["log"] if r["op"] == "grow_done"]
    assert done and done[0]["alert"] == "flash_crowd"
    assert done[0]["cause_trace"] == "c" * 32
    assert st["targets"]["5"]["added"] == ["vs1:80"]


def unlanded_grow_reruns(k):
    topo, _ = _three_rack_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}), max_replicas=2)
    a.apply_replicated({"id": "5:grow_planned:1", "op": "grow_planned",
                        "vid": 5, "at": k.clock.time(), "dst": "vs2:80",
                        "src": "vs0:80", "alert": "", "cause_trace": "",
                        "cause_event": ""})
    out = a.run_cycle()
    assert out["resumed"] == 1
    copies = k.tr.of("/admin/volume_copy")
    assert len(copies) == 1 and copies[0][0] == "vs2:80"


def export_import(k):
    topo, _ = _three_rack_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}))
    a.run_cycle()
    b = k.mk(_FakeTopo([]), _Transport())
    b.import_replicated(a.export_replicated())
    assert b.status()["targets"] == a.status()["targets"]
    assert [r["id"] for r in b.status()["replicated"]["log"]] == \
        [r["id"] for r in a.status()["replicated"]["log"]]


# TestTierLoop

def _cold_full_topo(vid=9):
    nodes = [_FakeNode("vs0:80", "r0"), _FakeNode("vs1:80", "r1")]
    nodes[0].volumes[vid] = _FakeVol(size=900, read_only=True)
    return _FakeTopo(nodes), nodes


def cold_full_tiers(k):
    topo, _ = _cold_full_topo()
    k.tr.replies["/admin/tier_upload"] = {
        "manifest": {"key": "_9.dat", "file_size": 900, "crc32": 0xAB}}
    a = k.mk(topo, heat_fn=lambda: _heat_doc({}, head=[]),
             tier_backend="t1", tier_after_s=0.0, volume_size_limit=1000)
    assert a.run_cycle()["tiered"] == 1
    up = k.tr.of("/admin/tier_upload")
    assert len(up) == 1 and up[0][2]["two_phase"] is True
    assert up[0][2]["backend"] == "t1"
    assert len(k.tr.of("/admin/tier_commit")) == 1
    st = a.status()
    assert st["tiers"] == 1 and "9" in st["tiered"]
    # the raft-borne commit decision comes before the commit leg
    assert [r["op"] for r in st["replicated"]["log"]] == \
        ["tier_pending", "tier_done"]


def commit_failure_replans(k):
    topo, _ = _cold_full_topo()
    k.tr.replies["/admin/tier_upload"] = {"manifest": {"key": "k"}}
    k.tr.errors["/admin/tier_commit"] = RuntimeError(
        "404: no manifest pending")
    a = k.mk(topo, heat_fn=lambda: _heat_doc({}, head=[]),
             tier_backend="t1", tier_after_s=0.0, volume_size_limit=1000)
    assert a.run_cycle()["tiered"] == 0
    st = a.status()
    assert st["failures"] == 1
    assert st["replicated"]["log"][-1]["op"] == "tier_failed"
    assert st["replicated"]["pending"] == {}


def pending_tier_resumes(k):
    topo, _ = _cold_full_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({}, head=[]), tier_backend="t1")
    a.apply_replicated({"id": "9:tier_pending:1", "op": "tier_pending",
                        "vid": 9, "at": k.clock.time(), "server": "vs0:80",
                        "backend": "t1", "key": "_9.dat", "alert": "",
                        "cause_trace": "", "cause_event": ""})
    assert a.run_cycle()["resumed"] == 1
    assert not k.tr.of("/admin/tier_upload")  # the upload is not redone
    assert len(k.tr.of("/admin/tier_commit")) == 1
    assert a.status()["tiered"].get("9")


def heat_return_recalls(k):
    topo, _ = _cold_full_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({9: 0.9}), tier_backend="t1")
    a.apply_replicated({"id": "9:tier_done:1", "op": "tier_done",
                        "vid": 9, "at": k.clock.time(), "server": "vs0:80",
                        "backend": "t1", "key": "_9.dat", "alert": "",
                        "cause_trace": "", "cause_event": ""})
    assert a.run_cycle()["recalled"] == 1
    dl = k.tr.of("/admin/tier_download")
    assert len(dl) == 1 and dl[0][0] == "vs0:80"
    st = a.status()
    assert st["recalls"] == 1 and st["tiered"] == {}


def hot_or_replicated_never_tiers(k):
    topo, nodes = _cold_full_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({9: 0.5}), tier_backend="t1",
             tier_after_s=0.0, volume_size_limit=1000, max_replicas=1)
    assert a.run_cycle()["tiered"] == 0  # hot
    nodes[1].volumes[9] = _FakeVol(size=900)  # two holders
    a2 = k.mk(topo, heat_fn=lambda: _heat_doc({}, head=[]),
              tier_backend="t1", tier_after_s=0.0, volume_size_limit=1000)
    assert a2.run_cycle()["tiered"] == 0  # replicated
    assert not k.tr.of("/admin/tier_upload")


# TestPauseAndViews

def pause_resume(k):
    topo, _ = _three_rack_topo()
    a = k.mk(topo, heat_fn=lambda: _heat_doc({5: 0.9}))
    a.pause("drill")
    st = a.status()
    assert st["paused"] and st["pause_reason"] == "drill"
    a.resume()
    assert not a.status()["paused"]


def on_heat_wakes(k):
    topo, _ = _three_rack_topo()
    a = k.mk(topo)
    a._wake.clear()
    a.on_heat({"volumes": {5: {"heat": 1.0, "trace": ""},
                           6: {"heat": 99.0, "trace": ""}}})
    assert a._wake.is_set()  # 6 holds ~99% of the heat
    a._wake.clear()
    a.on_heat({"volumes": {v: {"heat": 1.0} for v in (5, 6, 7, 8)}})
    assert not a._wake.is_set()  # 25% each: none near grow_share


DRILLS = [grow_rack_diverse, grow_carries_cause, cold_does_not_grow,
          max_replicas_caps, already_here_is_success, grow_failure_recorded,
          move_budget_bucket, shrink_waits_hold_down, sustained_cold_shrinks,
          heat_blip_resets, regrow_cooldown, cycle_cap, landed_grow_closes,
          unlanded_grow_reruns, export_import, cold_full_tiers,
          commit_failure_replans, pending_tier_resumes, heat_return_recalls,
          hot_or_replicated_never_tiers, pause_resume, on_heat_wakes]


def _run_drill(drill, monkeypatch) -> dict:
    out = {}
    for name, (mod, events_mod, commands) in PACKAGES.items():
        clock = StubClock()
        monkeypatch.setattr(mod, "time", clock)
        journal = events_mod.get_journal()
        seq0 = max((e.seq for e in journal.snapshot()), default=0)
        k = Kit(mod.HeatAutoscaler, clock)
        drill(k)
        evs = [{x: v for x, v in e.to_dict().items()
                if x not in ("id", "ts", "seq")}
               for e in journal.snapshot()
               if e.seq > seq0 and e.type in AUTOSCALE_EVENTS]
        out[name] = {
            "calls": k.tr.calls, "records": k.records, "events": evs,
            "status": [a.status() for a in k.made],
            "export": [a.export_replicated() for a in k.made],
            "health": [a.health_contribution() for a in k.made],
            "lines": [commands._render_status(a.status()) for a in k.made]}
    return out


@pytest.mark.parametrize("drill", DRILLS, ids=[d.__name__ for d in DRILLS])
def test_planner_drill_decides_as_the_reference(drill, monkeypatch):
    out = _run_drill(drill, monkeypatch)
    for key in out["ref"]:
        assert out["port"][key] == out["ref"][key], key


def test_render_status_equals_the_references():
    doc = {"enabled": True, "paused": True, "pause_reason": "api",
           "cycles": 3, "last_cycle_at": 0, "last_error": "boom",
           "knobs": {"grow_share": 0.3, "max_replicas": 3,
                     "hold_down_s": 30.0, "tier_backend": "",
                     "tier_after_s": 60.0},
           "targets": {"12": {"added": ["a:1"], "cycles": 1},
                       "3": {"added": [], "cycles": 0, "grown_at": 0}},
           "tiered": {"4": {"server": "b:2", "backend": "cold",
                            "key": "4.dat", "at": 0}},
           "grows": 2, "shrinks": 1, "tiers": 1, "recalls": 0,
           "failures": 1,
           "move_budget": {"rate_per_s": 1.0, "burst": 4.0, "tokens": 2.5},
           "recent": [{"at": 0, "action": "replica_grow", "vid": 12,
                       "dst": "a:1", "alert": "", "src": "c:3"}] * 12,
           "replicated": {"pending": {"7": {"op": "grow_planned",
                                            "dst": "a:1",
                                            "alert": "heat_shift"}},
                          "log": []}}
    assert port_commands._render_status(doc) == \
        ref_commands._render_status(doc)
    assert port_commands._render_status({}) == ref_commands._render_status({})


# --- raft: a mixed quorum, and the kill during a replica add -----------------

def test_a_mixed_quorum_replicates_autoscale_records_both_ways(tmp_path):
    ports = [free_port() for _ in range(3)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    classes = [MasterServer, MasterServer, RefMasterServer]
    masters = [cls(port=p, peers=[u for j, u in enumerate(urls) if j != i],
                   mdir=str(tmp_path / f"m{i}"), pulse_seconds=0.3).start()
               for i, (cls, p) in enumerate(zip(classes, ports))]
    try:
        wait_one_leader(masters)
        for round_, want in enumerate((masters[2], masters[0])):
            def leads():
                if want.is_leader and all(m.leader_url == want.url
                                          for m in masters):
                    return True
                if not want.is_leader:
                    want.raft._campaign()
                return False

            _wait(f"{want.url} to lead", leads, 20)
            vid = 60 + round_
            cause = {"alert": "flash_crowd", "cause_trace": "ab" * 16,
                     "cause_event": f"evt-{vid}"}
            auto = want.autoscaler
            auto._record("grow_planned", vid, cause, dst="127.0.0.1:1",
                         src="127.0.0.1:2", share=0.9)
            auto._record("grow_done", vid, cause, dst="127.0.0.1:1",
                         src="127.0.0.1:2", resumed_from="")
            auto._record("tier_pending", vid + 10, cause,
                         server="127.0.0.1:2", backend="cold", key="k",
                         file_size=9, crc32=7)
            want_doc = auto.export_replicated()

            def applied():
                return all(m.autoscaler.export_replicated() == want_doc
                           for m in masters)

            _wait("every master to apply the leader's autoscale records",
                  applied, 15)
            assert want_doc["pending"][str(vid + 10)] == want_doc["log"][-1]
            assert want_doc["targets"][str(vid)]["added"] == ["127.0.0.1:1"]
            kinds = {e["kind"] for e in masters[1].raft.log.entries}
            assert "autoscale" in kinds
            # the snapshot image carries them too
            for m in masters:
                assert m._raft_read_snapshot()["autoscale"] == want_doc
    finally:
        for m in masters:
            m.stop()


def test_leader_kill_during_replica_add_no_duplicate(tmp_path):
    """The reference's drill (tests/test_master_failover.py): the old
    leader quorum-replicates two grow_planned records and dies, vid 1's
    copy landed and vid 2's never started.  The promoted port leader
    closes vid 1 with no copy and copies vid 2 once, to the recorded
    destination, each under the original flash-crowd cause."""
    masters = start_trio(tmp_path)
    servers = []
    try:
        leader = wait_one_leader(masters)
        mlist = ",".join(m.url for m in masters)
        for i in range(2):
            root = str(tmp_path / f"v{i}")
            os.makedirs(root, exist_ok=True)
            servers.append(VolumeServer(
                [root], mlist, port=free_port(), rack=f"r{i}",
                data_center="dc1", pulse_seconds=0.3, max_volume_count=8,
                device="cpu").start())
        src, dst = servers[0].url, servers[1].url
        for vid in (1, 2):
            http_json("POST", f"http://{src}/admin/assign_volume",
                      {"volume_id": vid})

        def holders(m):
            with m.topo.lock:
                return {vid: sorted(n.url for n in m.topo.all_nodes()
                                    if vid in n.volumes) for vid in (1, 2)}

        _wait("the volumes on the leader", lambda: holders(leader) ==
              {1: [src], 2: [src]} and len(leader.topo.all_nodes()) == 2)
        trace = "cd" * 16
        leader.autoscaler.on_events([
            {"id": f"evt-fc-{vid}", "type": "flash_crowd", "trace": trace,
             "details": {"volume": vid}} for vid in (1, 2)])
        auto = leader.autoscaler
        auto._record("grow_planned", 1, auto._cause(1), dst=dst, src=src,
                     share=0.9)
        auto.executor.admin_post(dst, "/admin/volume_copy", {
            "volume_id": 1, "collection": "", "source_data_node": src})
        auto.executor.refresh_heartbeats([dst])
        auto._record("grow_planned", 2, auto._cause(2), dst=dst, src=src,
                     share=0.4)
        leader.stop()
        masters.remove(leader)

        new_leader = wait_one_leader(masters, timeout=20.0)
        _wait("the landed copy on the new leader",
              lambda: holders(new_leader) == {1: sorted([src, dst]),
                                              2: [src]})
        copies = []
        real_post = new_leader.autoscaler.executor._post_fn

        def counting_post(server, path, payload, timeout):
            if path == "/admin/volume_copy":
                copies.append((server, payload.get("volume_id")))
            return real_post(server, path, payload, timeout)

        new_leader.autoscaler.executor._post_fn = counting_post
        out = new_leader.autoscaler.run_cycle()
        assert out["resumed"] == 2, out
        assert [c for c in copies if c[1] == 1] == []
        assert [c for c in copies if c[1] == 2] == [(dst, 2)]
        doc = new_leader.autoscaler.export_replicated()
        assert doc["pending"] == {}
        done = {r["vid"]: r for r in doc["log"] if r["op"] == "grow_done"}
        for vid in (1, 2):
            assert done[vid]["resumed_from"], done[vid]
            assert done[vid]["cause_trace"] == trace
            assert done[vid]["alert"] == "flash_crowd"
            assert done[vid]["cause_event"] == f"evt-fc-{vid}"
            assert done[vid]["dst"] == dst
        new_leader.autoscaler.executor.refresh_heartbeats([src, dst])
        _wait("two holders each", lambda: holders(new_leader) == {
            1: sorted([src, dst]), 2: sorted([src, dst])})
        follower = next(m for m in masters if m is not new_leader)

        def follower_closed():
            fdoc = follower.autoscaler.export_replicated()
            return fdoc["pending"] == {} and set(fdoc["targets"]) == \
                {"1", "2"} and fdoc

        fdoc = _wait("the follower to apply the resumed records",
                     follower_closed, 10)
        assert fdoc["targets"]["1"]["added"] == [dst]
        assert fdoc["targets"]["2"]["added"] == [dst]
    finally:
        for vs in servers:
            vs.stop()
        for m in masters:
            m.stop()


# --- the routes and the shell on live clusters -------------------------------

def _cluster(tmp_path, kind: str):
    """A master with -autoscale.tierBackend cold (loop off) and one volume
    server with a "cold" dir backend holding volumes 1 and 2, seeded."""
    root = tmp_path / kind
    backends = {"cold": {"type": "dir", "root": str(root / "cold")}}
    if kind == "ref":
        m = RefMasterServer(port=free_port(), pulse_seconds=0.3,
                            autoscale_tier_backend="cold").start()
        vs = RefVolumeServer([str(root / "v")], m.url, port=free_port(),
                             pulse_seconds=0.3, ec_engine="cpu",
                             backends=backends).start()
    else:
        m = MasterServer(port=free_port(), pulse_seconds=0.3,
                         autoscale_tier_backend="cold").start()
        vs = VolumeServer([str(root / "v")], m.url, port=free_port(),
                          pulse_seconds=0.3, device="cpu",
                          backends=backends).start()
    _wait("the volume server", lambda: m.topo.all_nodes(), 10)
    for v in (1, 2):
        _exchange(vs.url, "POST", "/admin/assign_volume", {"volume_id": v})
        for nid, cookie, data, _ in _needles(12, 7 + v):
            _exchange(vs.url, "PUT", f"/{FileId(v, nid, cookie)}?ts=1700",
                      data)
    vs.heartbeat_now()
    _wait("both volumes on the master", lambda: all(
        any(v in n.volumes for n in m.topo.all_nodes()) for v in (1, 2)))
    return m, vs, root


def _mask(text: str, urls: list[str], root) -> str:
    """Urls, directories and times masked: what differs between two
    clusters started apart."""
    for u in urls:
        text = text.replace(u, "<url>")
    text = text.replace(str(root), "<root>")
    text = re.sub(r"\d\d:\d\d:\d\d", "<t>", text)
    text = re.sub(r'("(?:at|last_cycle_at|grown_at|shrunk_at)": )[0-9.]+',
                  r"\1<t>", text)
    # the .dat's crc32 covers needle records each server stamped itself
    text = re.sub(r'("crc32": )[0-9]+', r"\1<crc>", text)
    return re.sub(r"(\d+:\w+:)\d+\.\d+", r"\1<t>", text)


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


SHELL_SCRIPT = ("autoscale.status", "autoscale.pause",
                "autoscale.status -json", "autoscale.resume",
                "volume.tier -volumeId 1", "autoscale.status",
                "volume.tier -volumeId 1 -recall",
                "volume.tier -volumeId 2 -backend nope",
                "volume.tier -volumeId 77", "volume.tier -volumeId 1 -recall",
                "volume.tier", "autoscale.status")


@pytest.mark.parametrize("shell", ["same", "crossed"])
def test_autoscale_shell_and_routes_answer_as_the_reference(tmp_path, shell):
    outs, docs = {}, {}
    for kind in ("ref", "port"):
        m, vs, root = _cluster(tmp_path, kind)
        try:
            dat = os.path.join(str(root / "v"), "1.dat")
            before = _sha(dat)
            use_port = (kind == "port") == (shell == "same")
            env = (CommandEnv if use_port else RefCommandEnv)(m.url)
            run = run_command if use_port else ref_run_command
            lines = []
            for cmd in SHELL_SCRIPT:
                try:
                    lines.append(run(env, cmd))
                except Exception as e:  # noqa: BLE001 - compared
                    lines.append(f"{type(e).__name__}: {e}")
                if cmd == "volume.tier -volumeId 1":
                    assert not os.path.exists(dat)
                    for nid, cookie, data, _ in _needles(12, 8):
                        assert _exchange(vs.url, "GET",
                                         f"/{FileId(1, nid, cookie)}") == \
                            (200, data)
            assert _sha(dat) == before
            urls = [m.url, vs.url]
            outs[kind] = [_mask(line, urls, root) for line in lines]
            # the routes, straight
            got = []
            for method, path, body in (
                    ("GET", "/cluster/autoscale", None),
                    ("POST", "/cluster/autoscale/pause", {}),
                    ("POST", "/cluster/autoscale/resume", {}),
                    ("POST", "/cluster/autoscale/tier", {}),
                    ("POST", "/cluster/autoscale/tier",
                     {"volume_id": 2, "recall": True}),
                    ("POST", "/cluster/autoscale/tier", {"volume_id": 2}),
                    ("POST", "/cluster/autoscale/tier",
                     {"volume_id": 2, "recall": True})):
                st, raw, _ = http_bytes(
                    method, f"http://{m.url}{path}",
                    json.dumps(body).encode() if body is not None else None)
                doc = json.loads(raw)
                if "move_budget" in doc:
                    doc["recent"] = [{k: v for k, v in r.items() if k != "at"}
                                     for r in doc["recent"]]
                got.append((st, _mask(json.dumps(doc, sort_keys=True),
                                      urls, root)))
            docs[kind] = got
        finally:
            vs.stop()
            m.stop()
    assert outs["port"] == outs["ref"]
    for i, (got, want) in enumerate(zip(docs["port"], docs["ref"])):
        assert got == want, i
    assert "tiered -> cold:" in outs["port"][4]
    assert "TIERED -> cold" in outs["port"][5]
    assert "recalled to local disk" in outs["port"][6]
    assert [d[0] for d in docs["port"]] == [200, 200, 200, 400, 502, 200,
                                            200]


def test_the_cli_master_runs_the_loop(tmp_path):
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port",
         str(port), "-autoscaleSeconds", "0.2", "-autoscale.tierBackend",
         "cold", "-pulseSeconds", "0.5"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        url = f"127.0.0.1:{port}"

        def cycled():
            try:
                doc = http_json("GET", f"http://{url}/cluster/autoscale",
                                timeout=2.0)
            except Exception:  # noqa: BLE001 - not up yet
                return None
            return doc if doc["cycles"] >= 2 else None

        doc = _wait("two autoscale cycles", cycled, 30)
        assert doc["enabled"] and not doc["paused"]
        assert doc["interval_s"] == 0.2
        assert doc["knobs"]["tier_backend"] == "cold"
        out = run_command(CommandEnv(url), "autoscale.status")
        assert out.startswith("autoscale: running")
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert "master stopped" in out
