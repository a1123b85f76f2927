"""The port's EC planner, executor and coordinator against the reference's.

Seeded topology documents, shaped like the master's ``/dir/status``
Topology (several data centers and racks, EC volumes with missing,
duplicated and stale-held shards), go through both packages'
``view_from_status``, ``clean_deficits``, ``placement_rank``,
``choose_rebuild_host``, ``rack_ceiling`` and ``plan_rebalance``; the
answers must be equal.  ``PlanExecutor`` runs each repair and each
planned move against a recording transport on both sides: the calls,
their order and payloads, and the results must be equal too.

``EcCoordinator``: the reference's loop, re-scrub and retry-budget cases
(tests/test_coordinator.py ``TestCoordinatorLoop``,
``TestPostRepairRescrub``, ``TestRepairRetryBudget``) run on each
package's coordinator over its own Topology, with one recording
transport each.  The ordered (server, path, payload, timeout) legs must
be equal except ``engine`` ("tpu" against "cpu"), and so must the
``status()`` documents, their timestamps masked.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import pytest

import seaweedfs_tpu.master.topology as ref_topology
import seaweedfs_tpu.ops.coordinator as ref
import seaweedfs_tpu.utils.backoff as ref_backoff
import seaweedfs_tpu.utils.faultinject as ref_fi
import seaweedfs_tpu_torch.master.topology as port_topology
import seaweedfs_tpu_torch.ops.coordinator as port
import seaweedfs_tpu_torch.utils.backoff as port_backoff
import seaweedfs_tpu_torch.utils.faultinject as port_fi

SEEDS = list(range(12))


def topology_doc(seed: int) -> tuple[dict, tuple]:
    """A /dir/status Topology with EC volumes; -> (doc, stale urls)."""
    rng = np.random.default_rng(seed)
    nodes = []
    dcs = []
    for d in range(int(rng.integers(1, 3))):
        racks = []
        for r in range(int(rng.integers(1, 4))):
            data_nodes = []
            for k in range(int(rng.integers(1, 4))):
                url = f"10.{d}.{r}.{k}:8080"
                nodes.append(url)
                data_nodes.append({"Url": url,
                                   "Free": int(rng.integers(-1, 6)),
                                   "EcShards": int(rng.integers(0, 20))})
            racks.append({"Id": f"rack{r}", "DataNodes": data_nodes})
        dcs.append({"Id": f"dc{d}", "Racks": racks})
    ec_volumes, collections = {}, {}
    for vid in range(1, int(rng.integers(2, 5))):
        shards = {}
        for sid in range(14):
            if rng.random() < 0.12:
                continue  # lost
            holders = list(rng.choice(nodes, size=1 + int(
                rng.random() < 0.15), replace=len(nodes) < 2))
            shards[str(sid)] = sorted(set(holders))
        ec_volumes[str(vid)] = shards
        collections[str(vid)] = ["", "ec", "pics"][vid % 3]
    stale = tuple(u for u in nodes if rng.random() < 0.15)
    return ({"DataCenters": dcs, "EcVolumes": ec_volumes,
             "EcCollections": collections}, stale)


def _view_doc(view) -> dict:
    return {"nodes": {u: dataclasses.asdict(n)
                      for u, n in view.nodes.items()},
            "shards": view.shards, "collections": view.collections}


def _moves(moves) -> list:
    return [(m.vid, m.sid, m.src, m.dst, m.kind, m.reason) for m in moves]


def _plans(mod, doc: dict, stale: tuple) -> dict:
    view = mod.view_from_status(doc, stale=stale)
    out = {"view": _view_doc(view), "deficits": mod.clean_deficits(view),
           "ceiling": mod.rack_ceiling(view), "racks": sorted(view.racks())}
    for vid in sorted(view.shards):
        out[f"host {vid}"] = mod.choose_rebuild_host(view, vid)
        out[f"present {vid}"] = sorted(view.present_shards(vid))
        out[f"racks {vid}"] = sorted(view.rack_counts(vid).items())
        for sid in range(14):
            out[f"rank {vid}.{sid}"] = mod.placement_rank(view, vid, sid)
    for budget in (0, 1, 3):
        out[f"plan {budget}"] = _moves(mod.plan_rebalance(
            mod.clone_view(view), max_moves=budget))
    out["view after planning"] = _view_doc(view)  # clone_view protects it
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_planner_equals_the_reference(seed):
    doc, stale = topology_doc(seed)
    assert _plans(port, doc, stale) == _plans(ref, doc, stale)


class Recorder:
    """A PlanExecutor transport: records every call; a rebuild answers
    the shards the host lacked, and ``fail`` makes one path raise."""

    def __init__(self, view, fail: str = ""):
        self.view = view
        self.fail = fail
        self.calls: list = []

    def __call__(self, server: str, path: str, payload: dict,
                 timeout: float) -> dict:
        self.calls.append((server, path, dict(payload), timeout))
        if path == self.fail:
            raise RuntimeError(f"{path} failed on {server}")
        if path == "/admin/ec/rebuild":
            vid = payload["volume_id"]
            have = {sid for sid, us in self.view.shards.get(vid, {}).items()
                    if server in us}
            copied = {c[2]["shard_ids"][0] for c in self.calls
                      if c[1] == "/admin/ec/copy" and c[0] == server}
            return {"rebuilt_shard_ids": sorted(
                set(range(14)) - have - copied)}
        return {}


def _execute(mod, doc: dict, stale: tuple, fail: str) -> list:
    out = []
    view = mod.view_from_status(doc, stale=stale)
    rec = Recorder(view, fail)
    ex = mod.PlanExecutor(post_fn=rec)
    for vid in sorted(view.shards):
        try:
            res = ex.execute_repair(view, vid, engine="tpu")
            res.pop("seconds", None)  # the port also times its legs
            out.append(("repair", vid, res))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("repair", vid, type(e).__name__, str(e)))
    plan = mod.plan_rebalance(mod.clone_view(view))
    for mv in plan:
        try:
            ex.execute_move(view, mv)
            out.append(("move", _moves([mv])))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("move", _moves([mv]), type(e).__name__, str(e)))
    out.append(("calls", rec.calls))
    out.append(("view", _view_doc(view)))
    return out


@pytest.mark.parametrize("fail", ["", "/admin/ec/mount", "/admin/ec/copy"])
@pytest.mark.parametrize("seed", SEEDS[:6])
def test_executor_equals_the_reference(seed, fail):
    doc, stale = topology_doc(seed)
    got = _execute(port, doc, stale, fail)
    want = _execute(ref, doc, stale, fail)
    assert got == want
    assert any(c[1] == "/admin/ec/rebuild" for c in got[-2][1]) or \
        not any(e[0] == "repair" and isinstance(e[2], dict) and e[2]["host"]
                for e in got[:-2])


def test_repair_sends_the_servers_own_engine_by_default():
    """The reference's executor asks for "cpu", which a card server of
    the port refuses; the port's asks for "tpu" unless told otherwise."""
    doc = {"DataCenters": [{"Id": "dc", "Racks": [{"Id": "r", "DataNodes": [
        {"Url": f"h{i}:80", "Free": 5, "EcShards": 0} for i in range(3)]}]}],
        "EcVolumes": {"1": {str(s): [f"h{s % 3}:80"] for s in range(12)}},
        "EcCollections": {"1": "c"}}
    engines = {}
    for name, mod in (("port", port), ("ref", ref)):
        view = mod.view_from_status(doc)
        rec = Recorder(view)
        mod.PlanExecutor(post_fn=rec).execute_repair(view, 1)
        engines[name] = [c[2]["engine"] for c in rec.calls
                         if c[1] == "/admin/ec/rebuild"]
    assert engines == {"port": ["tpu"], "ref": ["cpu"]}


# --- the coordinator loop, on both packages ---------------------------------

# (coordinator module, topology module, backoff module, fault points,
#  the engine its repairs ask for)
PACKAGES = {"port": (port, port_topology, port_backoff, port_fi, "tpu"),
            "ref": (ref, ref_topology, ref_backoff, ref_fi, "cpu")}
TS_KEYS = {"at", "queued_at", "last_attempt_at", "last_cycle_at"}


@pytest.fixture(autouse=True)
def _fresh_retry_budgets(monkeypatch):
    """A fresh process-wide retry budget in both packages for each test:
    every scenario re-attempts ``repair:1``, and a bucket drained by an
    earlier test (it refills at 0.5/s) would deny a re-attempt here."""
    for backoff in (port_backoff, ref_backoff):
        monkeypatch.setattr(backoff, "_GLOBAL", None)


class FakeTransport:
    """Records every executor POST; ``fail`` maps (server, path) to the
    exception it raises, a rebuild answers ``rebuilt``."""

    def __init__(self, rebuilt=(), fail=None, raise_on=()):
        self.calls: list = []
        self.rebuilt = list(rebuilt)
        self.fail = dict(fail or {})
        self.raise_on = set(raise_on)  # paths that fail on every server

    def __call__(self, server, path, payload, timeout=600.0):
        self.calls.append((server, path, dict(payload), timeout))
        exc = self.fail.get((server, path))
        if exc is None and path in self.raise_on:
            exc = OSError(f"{path} failed on {server}")
        if exc is not None:
            raise exc
        if path == "/admin/ec/rebuild":
            return {"rebuilt_shard_ids": list(self.rebuilt)}
        return {}

    def of(self, path):
        return [c for c in self.calls if c[1] == path]


def _topo_with_volume(topology, missing=(13,), n_nodes=4, racks=2):
    topo = topology.Topology()
    urls = []
    for i in range(n_nodes):
        node = topo.register_node("10.0.0.%d" % (i + 1), 80,
                                  rack=f"r{i % racks}", dc="dc1")
        urls.append(node.url)
        bits = topology.ShardBits()
        for sid in range(14):
            if sid in missing or sid % n_nodes != i:
                continue
            bits = bits.add(sid)
        topo.sync_node_ec_shards(node, [topology.EcVolumeInfo(1, "", bits)])
    return topo, urls


def _mask(doc):
    """Timestamps (and the record ids made of them) masked."""
    if isinstance(doc, dict):
        return {k: ("<ts>" if k in TS_KEYS and v else
                    re.sub(r":[\d.]+$", ":<ts>", v)
                    if k == "id" and isinstance(v, str) else _mask(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


def _legs(mod_engine: str, calls: list) -> list:
    """The transport's calls with ``engine`` taken out (checked here)."""
    out = []
    for server, path, payload, timeout in calls:
        if "engine" in payload:
            assert payload.pop("engine") == mod_engine, (path, payload)
        out.append((server, path, payload, timeout))
    return out


def _both(scenario):
    """Run ``scenario(pkg) -> (transport, record)`` for each package;
    -> {name: (legs, masked record)}."""
    out = {}
    for name, pkg in PACKAGES.items():
        transport, record = scenario(pkg)
        out[name] = (_legs(pkg[4], transport.calls), _mask(record))
    return out


def _assert_equal(results: dict) -> dict:
    assert results["port"] == results["ref"]
    return results["port"]


def _coordinator(pkg, topo, t, move_rate=None, move_burst=None, **kw):
    """A coordinator of either package on transport ``t``.  The port
    takes no ``server`` (nothing reads it without the event journal) and
    its move budget is attributes, set here after construction."""
    kw.setdefault("interval_s", 999.0)
    if pkg is PACKAGES["ref"]:
        kw["server"] = "m:1"
    c = pkg[0].EcCoordinator(topo=topo, post_fn=t, **kw)
    if move_rate is not None:
        c.move_rate = move_rate
    if move_burst is not None:
        c.move_burst = move_burst
    return c


def _failures(c) -> int:
    """The process-wide repair-failure count (a counter other tests in
    the process add to as well: compare its changes, not its value)."""
    return c.health_contribution()["coordinator_repair_failures"]


def test_cycle_queues_deficits_and_sets_gauge():
    def scenario(pkg):
        topo, _ = _topo_with_volume(pkg[1], missing=(10, 11, 12, 13))
        t = FakeTransport(rebuilt=[10, 11, 12, 13])
        c = _coordinator(pkg, topo, t)
        failures = _failures(c)
        cycle = c.run_cycle()
        return t, {"cycle": cycle, "status": c.status(),
                   "under": c.health_contribution()["ec_under_replicated"],
                   "new_failures": _failures(c) - failures}

    legs, rec = _assert_equal(_both(scenario))
    assert rec["status"]["cycles"] == 1
    assert rec["status"]["repairs"]["done"] == 1
    assert [leg for leg in legs if leg[1] == "/admin/ec/rebuild"]


def test_on_events_records_cause_and_repair_carries_it():
    def scenario(pkg):
        topo, _ = _topo_with_volume(pkg[1], missing=(13,))
        t = FakeTransport(rebuilt=[13])
        c = _coordinator(pkg, topo, t)
        c.on_events([
            {"id": "e1", "type": "alert_fired",
             "details": {"alert": "scrub_unrepairable",
                         "exemplar_trace": "ab" * 16}},
            {"id": "e2", "type": "scrub_unrepairable",
             "trace": "cd" * 16, "details": {"vid": 1, "shards": [13]}},
            {"id": "e3", "type": "shard_corrupt",
             "details": {"path": "/data/coll_7"}},
            {"id": "e4", "type": "alert_resolved",
             "details": {"alert": "other"}},
        ])
        c.run_cycle()
        return t, c.status()

    _legs_, st = _assert_equal(_both(scenario))
    done = st["recent"][0]
    assert done["action"] == "repair_done"
    assert (done["alert"], done["cause_trace"], done["cause_event"]) == (
        "scrub_unrepairable", "cd" * 16, "e2")


def test_vid_from_event_equals_the_reference():
    cases = [{"vid": 9}, {"vid": "x"}, {"path": "/data/coll_12"},
             {"path": "/data/7"}, {"path": "/data/x"}, {},
             {"path": "C:\\d\\a_b_3"}, {"vid": None}]
    assert [port._vid_from_event(c) for c in cases] == \
        [ref._vid_from_event(c) for c in cases]


@pytest.mark.parametrize("name", ["port", "ref"])
def test_pause_and_admin_lock_block_cycles(name):
    pkg = PACKAGES[name]
    topo, _ = _topo_with_volume(pkg[1], missing=(13,))
    locked = {"v": False}
    c = pkg[0].EcCoordinator(topo=topo, post_fn=FakeTransport(rebuilt=[13]),
                             interval_s=0.05,
                             admin_locked_fn=lambda: locked["v"])
    c.pause("test")
    c.start()
    try:
        time.sleep(0.3)
        assert c.status()["cycles"] == 0  # paused: nothing ran
        assert c.status()["pause_reason"] == "test"
        c.resume()
        locked["v"] = True  # the admin lock also holds it
        time.sleep(0.3)
        assert c.status()["cycles"] == 0
        assert c.status()["paused"] is True
        assert c.status()["pause_reason"] == "admin_lock"
        locked["v"] = False
        deadline = time.time() + 5
        while time.time() < deadline and c.status()["cycles"] == 0:
            time.sleep(0.05)
        assert c.status()["cycles"] > 0
        assert c.status()["enabled"] is True
    finally:
        c.stop()
    assert c.status()["enabled"] is False


def test_move_budget_token_bucket():
    def scenario(pkg):
        topology = pkg[1]
        topo = topology.Topology()
        hoarder = topo.register_node("10.0.0.1", 80, rack="r1", dc="dc1")
        bits = topology.ShardBits()
        for sid in range(14):
            bits = bits.add(sid)
        topo.sync_node_ec_shards(hoarder,
                                 [topology.EcVolumeInfo(1, "", bits)])
        for i in range(2, 6):
            topo.register_node("10.0.0.%d" % i, 80, rack=f"r{i}", dc="dc1")
        t = FakeTransport()
        c = _coordinator(pkg, topo, t, move_rate=0.0, move_burst=2.0)
        first = c.run_cycle()
        second = c.run_cycle()  # no tokens left
        return t, {"cycles": [first, second], "status": c.status()}

    _legs_, rec = _assert_equal(_both(scenario))
    assert rec["status"]["moves"] == 2
    assert rec["status"]["move_budget"]["tokens"] < 1.0


@pytest.mark.parametrize("name", ["port", "ref"])
def test_plan_fault_is_contained(name):
    pkg = PACKAGES[name]
    fi = pkg[3]
    topo, _ = _topo_with_volume(pkg[1], missing=())
    c = pkg[0].EcCoordinator(topo=topo, post_fn=FakeTransport(),
                             interval_s=0.05)
    fi.enable("coord.plan", error_rate=1.0, max_hits=1)
    c.start()
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not c.status()["cycles"]:
            time.sleep(0.05)
        # the injected planning fault was contained: the loop survived,
        # and a later cycle ran and cleared the error
        assert c.status()["cycles"] > 0
        assert fi.fired("coord.plan") == 1
        assert c.status()["last_error"] == ""
    finally:
        fi.clear()
        c.stop()


@pytest.mark.parametrize("hits", [1, 40])
def test_exec_fault_at_the_first_legs(hits):
    """``coord.exec`` failing the first leg only: that survivor's copy is
    skipped and the rebuild regenerates it; failing every leg: the repair
    fails, is counted and shown."""
    def scenario(pkg):
        fi = pkg[3]
        topo, _ = _topo_with_volume(pkg[1], missing=(13,))
        t = FakeTransport(rebuilt=[13])
        c = _coordinator(pkg, topo, t)
        fi.enable("coord.exec", error_rate=1.0, max_hits=hits)
        try:
            c.run_cycle()
            return t, {"status": c.status(), "fired": fi.fired("coord.exec")}
        finally:
            fi.clear()

    _legs_, rec = _assert_equal(_both(scenario))
    if hits == 1:
        assert rec["status"]["repairs"] == {"done": 1, "failed": 0}
    else:
        assert rec["status"]["repairs"] == {"done": 0, "failed": 1}
        assert rec["status"]["recent"][0]["error"] == \
            "OSError: fault injected at coord.exec"


def test_failed_repair_backs_off_exponentially():
    def scenario(pkg):
        topo, urls = _topo_with_volume(pkg[1], missing=(13,))
        t = FakeTransport(raise_on={"/admin/ec/copy", "/admin/ec/rebuild"})
        c = _coordinator(pkg, topo, t, interval_s=60.0)
        failures = _failures(c)
        docs = []
        c.run_cycle()
        docs.append(c.status())
        c.run_cycle()  # in backoff: nothing re-attempted
        docs.append(c.status())
        with c._lock:
            c._queue[1]["last_attempt_at"] -= 60.0 * 2 + 1
        c.run_cycle()
        docs.append(c.status())
        return t, {"docs": docs, "new_failures": _failures(c) - failures}

    _legs_, rec = _assert_equal(_both(scenario))
    assert [d["repairs"]["failed"] for d in rec["docs"]] == [1, 1, 2]
    assert rec["new_failures"] == 2


def test_health_contribution_keys():
    for pkg in PACKAGES.values():
        topo, _ = _topo_with_volume(pkg[1])
        c = _coordinator(pkg, topo, FakeTransport())
        assert set(c.health_contribution()) == {
            "ec_under_replicated", "coordinator_repair_failures"}


def test_executor_rescrub_posts_targeted_scan_to_holders():
    doc = {"DataCenters": [{"Id": "dc", "Racks": [{"Id": "r", "DataNodes": [
        {"Url": f"h{i}:80", "Free": 5, "EcShards": 0} for i in range(5)]}]}],
        "EcVolumes": {"1": {str(s): [f"h{s % 4}:80"] for s in range(13)}},
        "EcCollections": {"1": "c"}}

    def scenario(pkg):
        t = FakeTransport(fail={("h2:80", "/ec/scrub/start"):
                                OSError("scrubber busy")})
        view = pkg[0].view_from_status(doc, stale=("h3:80",))
        return t, pkg[0].PlanExecutor(post_fn=t).rescrub(view, 1)

    legs, started = _assert_equal(_both(scenario))
    assert started == ["h0:80", "h1:80"]
    # every alive holder was asked, with no knob overrides
    assert legs == [(f"h{i}:80", "/ec/scrub/start", {"volume_id": 1}, 30.0)
                    for i in range(3)]


def test_repair_done_carries_rescrubbed_holders():
    def scenario(pkg):
        topo, _ = _topo_with_volume(pkg[1], missing=(13,))
        t = FakeTransport(rebuilt=[13])
        c = _coordinator(pkg, topo, t)
        c.run_cycle()
        return t, c.status()

    legs, st = _assert_equal(_both(scenario))
    assert st["repairs"]["done"] == 1
    scrubs = [leg for leg in legs if leg[1] == "/ec/scrub/start"]
    assert scrubs and all(leg[2] == {"volume_id": 1} for leg in scrubs)
    assert st["recent"][0]["rescrubbed"] == sorted(leg[0] for leg in scrubs)


def test_rescrub_failure_never_fails_the_repair():
    def scenario(pkg):
        topo, _ = _topo_with_volume(pkg[1], missing=(13,))
        t = FakeTransport(rebuilt=[13], raise_on={"/ec/scrub/start"})
        c = _coordinator(pkg, topo, t)
        c.run_cycle()
        return t, c.status()

    _legs_, st = _assert_equal(_both(scenario))
    assert st["repairs"] == {"done": 1, "failed": 0}
    assert st["recent"][0]["rescrubbed"] == []


def test_reattempts_draw_from_retry_budget():
    """With the per-destination budget drained, a failing repair's
    re-attempts are denied: one attempt in all until the bucket
    refills."""
    def scenario(pkg):
        backoff = pkg[2]
        topo, urls = _topo_with_volume(pkg[1], missing=(13,))
        t = FakeTransport(fail={(u, "/admin/ec/rebuild"): OSError("wedged")
                                for u in urls})
        prev = backoff._GLOBAL
        backoff._GLOBAL = backoff.RetryBudget(rate=0.0, burst=0.0)
        try:
            c = _coordinator(pkg, topo, t, interval_s=0.0)
            c.run_cycle()  # the first attempt is not a retry
            c.run_cycle()  # the hold is 0 s: only the budget stops these
            c.run_cycle()
            return t, c.status()
        finally:
            backoff._GLOBAL = prev

    _legs_, st = _assert_equal(_both(scenario))
    assert st["repairs"]["failed"] == 1
    assert st["queue"][0]["attempts"] == 1


def test_retry_budget_equals_the_reference(monkeypatch):
    clock = {"now": 50.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["now"])
    out = []
    for backoff in (port_backoff, ref_backoff):
        b = backoff.RetryBudget(rate=0.5, burst=3.0)
        seen = []
        for step in range(12):
            seen.append((b.allow("a"), b.allow("b") if step % 3 else None,
                         b.remaining("a"), b.snapshot()))
            clock["now"] += 0.7
        b.prune(max_destinations=1)
        seen.append(b.snapshot())
        out.append(seen)
    assert out[0] == out[1]
