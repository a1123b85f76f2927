"""The alert plane and the flight recorder, against the reference's.

- The engine: one seeded sequence of (health, families) snapshots, built
  with numpy, goes through the reference's ``AlertEngine`` and the
  port's, each with ``default_rules()`` plus a few short-window rules, at
  a fixed ``now``.  After every step the two state documents, the
  journals the engines wrote and their ``on_fire`` calls are equal
  (tolerance 0).  The sequence has counter resets, a hold-down, a
  flapping ``keep_firing_s``, a broken rule and both burn-rate modes.
- The rule table: ``default_rules()`` to-dicts equal the reference's.
- The flight recorder: capture, list, get, bad ids, oldest-bundle and
  byte-cap eviction, held to the reference's behaviour by key sets,
  sections and counts (bundles carry wall times, pids and ids); a
  load-born alert's capture on a process with no spans and an empty
  journal, whose bundle both packages write with empty spans and events,
  and chip_smoke.py's bundle check, which holds such a bundle to the
  reference's shape.
- A live rot on five port servers (``device="cpu"``) under the port's
  master, and the same drill on a reference cluster: ``scrub_unrepairable``
  fires with bundles from its server and the master, and the
  coordinator's repair names the alert; alert names, states and the
  repair's alert agree.  Then the port's and the reference's shells
  render alerts.list, alerts.capture and fault.list alike.
"""

from __future__ import annotations

import copy
import re

import numpy as np
import pytest
import torch

from seaweedfs_tpu.observability import alerts as ref_alerts
from seaweedfs_tpu.observability import events as ref_events
from seaweedfs_tpu.observability import flightrecorder as ref_fr
from seaweedfs_tpu.observability import tracer as ref_tracer
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.utils import faultinject as ref_fi
from seaweedfs_tpu_torch.observability import alerts as port_alerts
from seaweedfs_tpu_torch.observability import events as port_events
from seaweedfs_tpu_torch.observability import flightrecorder as port_fr
from seaweedfs_tpu_torch.observability import tracer as port_tracer
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.stats.aggregate import HEALTH_FAMILIES
from seaweedfs_tpu_torch.utils import faultinject as port_fi
from seaweedfs_tpu_torch.utils.httpd import http_json
from tests.test_torch_tracing_cluster import Cluster

PACKAGES = {
    "ref": (ref_alerts, ref_events, ref_metrics),
    "port": (port_alerts, port_events, port_metrics),
}
PEERS = ["127.0.0.1:8080", "127.0.0.1:8081", "127.0.0.1:8082"]
ROUTES = ["read", "write", "delete"]
BUCKETS = (0.005, 0.05, 0.25, 0.5, 1.0, 2.5)
STEPS = 320
STEP_S = 15.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def extra_rules(Rule) -> list:
    """Rules beside the default table, so one sequence reaches every
    branch: a hold-down, a short keep_firing_s that flaps, short burn
    windows in both modes, a rule with no key and one of no known kind."""
    return [
        Rule("held_corrupt", "counter_increase", "error", for_s=10.0,
             keep_firing_s=30.0, params={"key": "corrupt_shards"}),
        Rule("flappy_shed", "counter_increase", for_s=0.0,
             keep_firing_s=20.0, params={"key": "requests_shed"}),
        Rule("fast_error_burn", "burn_rate", "critical", keep_firing_s=0.0,
             params={"mode": "error_ratio",
                     "errors": "SeaweedFS_volumeServer_request_errors_total",
                     "requests": "SeaweedFS_volumeServer_request_total",
                     "max_ratio": 0.05, "fast_s": 30.0, "slow_s": 120.0,
                     "min_requests": 10}),
        Rule("fast_p99_burn", "burn_rate", "critical", keep_firing_s=15.0,
             params={"mode": "p99",
                     "family": "SeaweedFS_volumeServer_request_seconds",
                     "max_p99_s": 0.3, "fast_s": 30.0, "slow_s": 120.0,
                     "min_requests": 10}),
        Rule("broken", "counter_increase", params={}),
        Rule("unknown_kind", "no_such_kind"),
    ]


def snapshots(seed: int):
    """STEPS seeded cluster snapshots: per-peer health counters that rise
    in bursts and now and then reset (a restarted peer), an unrepairable
    scrub verdict that comes and goes, stale peers, per-route requests,
    errors and latencies with bursts of errors and of slow requests, a
    restart of every RED counter, and journal events for the relay rules.
    Each step: (health doc, RED restart?, per-route (requests, errors,
    latencies) this step, events)."""
    rng = np.random.default_rng(seed)
    health = {u: {k: 0 for k in HEALTH_FAMILIES} for u in PEERS}
    for step in range(STEPS):
        phase = (step // 40) % 4  # quiet, errors, slow, both
        for u in PEERS:
            for k in HEALTH_FAMILIES:
                if rng.random() < 0.06:
                    health[u][k] += int(rng.integers(1, 4))
                if rng.random() < 0.01:
                    health[u][k] = 0  # the peer restarted
        unrep = {u: int(rng.random() < 0.08) for u in PEERS} \
            if phase in (1, 3) else {u: 0 for u in PEERS}
        stale = [u for u in PEERS if rng.random() < 0.05]
        peers = {u: {"pipeline_health": dict(health[u]),
                     "scrub": {"verdicts": {"unrepairable": unrep[u]}}}
                 for u in PEERS}
        totals = {k: sum(health[u][k] for u in PEERS)
                  for k in HEALTH_FAMILIES}
        totals["scrub_unrepairable"] = sum(unrep.values())
        doc = {"peers": peers, "totals": totals, "stale_peers": stale,
               "peer_count": len(PEERS),
               "degraded": any(totals.values())}
        red = {}
        for r in ROUTES:
            n = int(rng.integers(5, 40))
            errors = int(rng.binomial(n, 0.2)) if phase in (1, 3) else 0
            lat = rng.exponential(0.6 if phase in (2, 3) else 0.01, n)
            red[r] = (n, errors, [float(x) for x in lat])
        events = []
        if rng.random() < 0.04:
            events.append(("heat_shift", {"volume": int(rng.integers(1, 9)),
                                          "share": 0.5,
                                          "servers": [PEERS[0]]}))
        if rng.random() < 0.03:
            events.append(("loop_stall", {"route": "read", "lag_ms": 80,
                                          "servers": [PEERS[1]]}))
        yield doc, step == 200, red, events


def red_families(metrics_mod) -> dict:
    """Fresh per-route RED families of ``metrics_mod``, as the master's
    merge hands them to the engine."""
    return {
        "SeaweedFS_volumeServer_request_total":
            metrics_mod.Counter("SeaweedFS_volumeServer_request_total",
                                labels=("type",)),
        "SeaweedFS_volumeServer_request_errors_total":
            metrics_mod.Counter(
                "SeaweedFS_volumeServer_request_errors_total",
                labels=("type",)),
        "SeaweedFS_volumeServer_request_seconds":
            metrics_mod.Histogram("SeaweedFS_volumeServer_request_seconds",
                                  labels=("type",), buckets=BUCKETS),
    }


def feed(fams: dict, red: dict) -> None:
    for r, (n, errors, lat) in red.items():
        fams["SeaweedFS_volumeServer_request_total"].inc(r, amount=n)
        if errors:
            fams["SeaweedFS_volumeServer_request_errors_total"].inc(
                r, amount=errors)
        for x in lat:
            fams["SeaweedFS_volumeServer_request_seconds"].observe(r, x)


def _journal_view(journal) -> list:
    return [(e["type"], e["severity"], e.get("server"), e["details"])
            for e in journal.query(limit=0)]


def test_engines_agree_step_by_step():
    engines, fired, snaps = {}, {}, {}
    for name, (alerts_mod, events_mod, _m) in PACKAGES.items():
        fired[name] = []
        engines[name] = alerts_mod.AlertEngine(
            alerts_mod.default_rules() + extra_rules(alerts_mod.Rule),
            source_fn=lambda name=name: snaps[name],
            server="127.0.0.1:9333",
            journal=events_mod.EventJournal(),
            on_fire=lambda r, st, servers, name=name: fired[name].append(
                (r.name, st, list(servers))),
            min_interval=1.0)
    fams = {name: red_families(m) for name, (_a, _e, m) in PACKAGES.items()}
    seen = set()
    now = 1_000.0
    for doc, restart, red, events in snapshots(seed=13):
        for name, (alerts_mod, _e, metrics_mod) in PACKAGES.items():
            if restart:
                fams[name] = red_families(metrics_mod)
            feed(fams[name], red)
            snaps[name] = (copy.deepcopy(doc), fams[name])
            for etype, details in events:
                engines[name].journal.emit(etype, **details)
        docs = {name: eng.evaluate(now=now, force=True)
                for name, eng in engines.items()}
        assert docs["port"] == docs["ref"], now
        # an unforced poll inside min_interval serves the same round
        assert engines["port"].evaluate(now=now + 0.5) == \
            engines["ref"].evaluate(now=now + 0.5)
        seen |= {(a["name"], a["state"]) for a in docs["port"]["alerts"]}
        now += STEP_S
    assert _journal_view(engines["port"].journal) == \
        _journal_view(engines["ref"].journal)
    assert fired["port"] == fired["ref"]
    # the sequence reached every branch it was built for
    for want in [("held_corrupt", "pending"), ("held_corrupt", "firing"),
                 ("flappy_shed", "resolved"), ("fast_error_burn", "firing"),
                 ("fast_p99_burn", "firing"), ("volume_error_burn", "firing"),
                 ("volume_latency_burn", "firing"),
                 ("scrub_unrepairable", "resolved"),
                 ("peer_down", "firing"), ("heat_shift", "firing"),
                 ("loop_stall", "firing")]:
        assert want in seen, want
    states = {a["name"]: a for a in engines["port"].to_dict()["alerts"]}
    assert "rule error: KeyError" in states["broken"]["detail"]
    assert "unknown rule kind" in states["unknown_kind"]["detail"]
    assert sum(1 for f in fired["port"] if f[0] == "flappy_shed") >= 2


def test_counter_reset_rebaselines_like_the_reference():
    """A peer's counter falls (a restart), then rises by one: neither
    engine fires on the fall, both fire on the rise, with equal docs."""
    values = [7, 0, 0, 1]
    docs = {}
    for name, (alerts_mod, events_mod, _m) in PACKAGES.items():
        state = {"v": values[0]}
        eng = alerts_mod.AlertEngine(
            [alerts_mod.Rule("r", "counter_increase",
                             params={"key": "engine_fallbacks"})],
            source_fn=lambda state=state: ({"peers": {PEERS[0]: {
                "pipeline_health": {"engine_fallbacks": state["v"]}}},
                "totals": {"engine_fallbacks": state["v"]},
                "stale_peers": []}, {}),
            journal=events_mod.EventJournal(), min_interval=0.0)
        docs[name] = []
        for i, v in enumerate(values):
            state["v"] = v
            docs[name].append(eng.evaluate(now=10.0 + i, force=True))
    assert docs["port"] == docs["ref"]
    assert [d["alerts"][0]["state"] for d in docs["port"]] == \
        ["inactive", "inactive", "inactive", "firing"]


def test_default_rules_equal_the_references():
    port = [r.to_dict() for r in port_alerts.default_rules()]
    assert port == [r.to_dict() for r in ref_alerts.default_rules()]
    assert {r["params"].get("key") for r in port
            if r["kind"] == "counter_increase"} == set(HEALTH_FAMILIES)
    assert port_alerts.STATES == ref_alerts.STATES
    assert port_alerts.EXTRA_HEALTH_KEYS == ref_alerts.EXTRA_HEALTH_KEYS


def test_alert_event_types_are_the_port_s_own():
    for t in ("alert_pending", "alert_fired", "alert_resolved",
              "flight_capture"):
        assert port_events.EVENT_TYPES[t] == ref_events.EVENT_TYPES[t]
        assert t not in port_events.REFERENCE_ONLY_EVENT_TYPES
    assert {**port_events.HEALTH_EVENT_TYPES,
            **port_events.REFERENCE_ONLY_HEALTH_EVENT_TYPES} == \
        ref_events.HEALTH_EVENT_TYPES


# --- flight recorder ---------------------------------------------------------

def _mask_id(bundle_id: str) -> str:
    return re.sub(r"^fr-\d{14}-", "fr-<ts>-", bundle_id)


@pytest.mark.parametrize("profile_s", [0.0, 0.05])
def test_flight_recorder_round_trip_like_the_reference(tmp_path, profile_s):
    # a bundle holds its process's exposition: a family in each package's
    # registry, so the comparison does not hang on which tests ran before
    # in this process
    ref_metrics.volume_server_metrics()
    port_metrics.volume_server_metrics()
    got = {}
    for name, mod in (("ref", ref_fr), ("port", port_fr)):
        fr = mod.FlightRecorder(spool_dir=str(tmp_path / name))
        meta = fr.capture(reason="unit", alert="r1", server="vs:1",
                          trace_id="ab" * 16, profile_s=profile_s,
                          events=[{"type": "x", "n": i} for i in range(300)])
        doc = fr.get(meta["id"])
        listing = fr.list()
        got[name] = {
            "meta_keys": sorted(meta), "doc_keys": sorted(doc),
            "id": _mask_id(meta["id"]), "format": doc["format"],
            "meta": {k: doc["meta"][k] for k in
                     ("reason", "alert", "server", "trace_id",
                      "event_count")},
            "events": doc["events"],
            "trace_keys": sorted(doc["trace"]),
            "profile": bool(doc["profile"]) == (profile_s > 0),
            "metrics": doc["metrics"].startswith("# HELP")
            or doc["metrics"] == "",
            "listed": [(_mask_id(b["id"]), b["bytes"] == meta["bytes"])
                       for b in listing],
            "counts": (fr.captures, fr.evicted, fr.total_bytes() ==
                       meta["bytes"]),
        }
    assert got["port"] == got["ref"]
    assert got["port"]["meta"]["event_count"] == 256


def test_an_empty_journal_s_bundle_like_the_reference(tmp_path,
                                                     monkeypatch):
    """A load-born alert (loop_lag_increase) pages a server that traced
    nothing and journaled nothing: the capture its /debug route makes
    (events from its own journal) is the same document in both packages,
    with no spans and no events.  chip_smoke.py's bundle check takes that
    document as it takes the port's: the reference's shape holds, and the
    evidence check kept for the drill's own alerts finds the same empty
    events in both."""
    import chip_smoke

    ref_metrics.volume_server_metrics()
    port_metrics.volume_server_metrics()
    got = {}
    for name, fr_mod, ev_mod, tr_mod in (
            ("ref", ref_fr, ref_events, ref_tracer),
            ("port", port_fr, port_events, port_tracer)):
        monkeypatch.setattr(ev_mod, "_GLOBAL", ev_mod.EventJournal())
        monkeypatch.setattr(tr_mod, "_GLOBAL", tr_mod.Tracer(enabled=False))
        fr = fr_mod.FlightRecorder(spool_dir=str(tmp_path / name))
        meta = fr.capture(reason="alert:loop_lag_increase",
                          alert="loop_lag_increase", server="vs:1",
                          profile_s=0.05)
        doc = fr.get(meta["id"])
        got[name] = {
            "format": doc["format"], "doc_keys": sorted(doc),
            "meta_keys": sorted(doc["meta"]),
            "meta": {k: doc["meta"][k] for k in
                     ("reason", "alert", "server", "trace_id", "span_count",
                      "event_count")},
            "trace_keys": sorted(doc["trace"]),
            "spans": doc["trace"]["spans"], "events": doc["events"],
            "sections_typed": (isinstance(doc["profile"], str),
                               isinstance(doc["metrics"], str)),
            "shape": chip_smoke.bundle_problems(doc, "loop_lag_increase",
                                                provoked=False),
            "evidence": chip_smoke.bundle_problems(
                doc, "loop_lag_increase", provoked=True),
        }
    assert got["port"] == got["ref"]
    assert got["port"]["meta"]["span_count"] == 0
    assert got["port"]["events"] == [] and got["port"]["spans"] == []
    assert got["port"]["shape"] == []
    assert "empty events" in got["port"]["evidence"]
    assert got["port"]["meta_keys"] == sorted(chip_smoke.BUNDLE_META)


def test_stop_never_sees_an_unstarted_capture_thread(monkeypatch):
    """A firing alert's flight-capture thread is started before the
    master's stop() can see it: stop() joins every thread it sees, and
    joining one not yet started raises (a stop racing an alert)."""
    import threading

    import seaweedfs_tpu_torch.master.server as master_server
    from seaweedfs_tpu_torch.master.server import MasterServer
    from tests.conftest import free_port

    m = MasterServer(port=free_port(), pulse_seconds=0.3)
    m._stop.set()  # the worker returns at once: no capture is made
    visible_at_start = []

    class Probe(threading.Thread):
        def start(self):
            visible_at_start.append(self in m._capture_threads)
            super().start()

    monkeypatch.setattr(master_server.threading, "Thread", Probe)
    m._on_alert_fire(port_alerts.default_rules()[0], {}, [])
    monkeypatch.undo()
    assert visible_at_start == [False]
    for t in m._capture_threads:
        t.join(timeout=10)


def test_flight_recorder_bad_ids_like_the_reference(tmp_path):
    for mod in (ref_fr, port_fr):
        fr = mod.FlightRecorder(spool_dir=str(tmp_path / mod.__name__))
        for bad in ("../../etc/passwd", "", "nope", ".hidden", "a/b"):
            assert fr.get(bad) is None, (mod.__name__, bad)


def test_flight_recorder_eviction_like_the_reference(tmp_path):
    got = {}
    for name, mod in (("ref", ref_fr), ("port", port_fr)):
        fr = mod.FlightRecorder(spool_dir=str(tmp_path / f"{name}-n"),
                                max_bundles=3)
        ids = [fr.capture(reason=f"n{i}", profile_s=0.0)["id"]
               for i in range(5)]
        kept = [b["id"] for b in fr.list()]
        byte_fr = mod.FlightRecorder(spool_dir=str(tmp_path / f"{name}-b"),
                                     max_bytes=1)
        byte_fr.capture(reason="a", profile_s=0.0)
        byte_fr.capture(reason="b", profile_s=0.0)
        got[name] = ([ids.index(i) for i in kept], fr.evicted,
                     fr.get(ids[0]) is None, len(byte_fr.list()),
                     byte_fr.evicted, byte_fr.captures)
    assert got["port"] == got["ref"]
    assert got["port"][:3] == ([4, 3, 2], 2, True)


# --- live drill ----------------------------------------------------------------

def _wait(what: str, ok, timeout: float = 60.0):
    import time

    t0 = time.monotonic()
    while True:
        got = ok()
        if got:
            return got
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def alert_drill(tmp_path, kind: str) -> tuple[Cluster, dict]:
    """``kind``'s master over five of ``kind``'s volume servers, the
    coordinator paused: once the engine has a baseline, a byte of one
    shard flipped and ``ec.scrub -all``; wait for ``scrub_unrepairable``
    to fire and carry its bundles, then coordinator.resume until the
    repair.  Returns the cluster, still running, and what it showed."""
    c = Cluster(tmp_path, kind, [kind] * 5, coordinator_seconds=0.2)
    try:
        vid, _fids, _data = c.encoded_volume(seed=11)
        h = c.holders(vid)
        host = min(c.servers, key=lambda u: (
            -sum(u in us for us in h.values()), u))
        rot = min(s for s, us in h.items() if host in us)
        # two evaluations of the whole cluster: every counter has its
        # baseline before the rot
        base = c.master.alert_engine.evaluations
        _wait("two evaluations", lambda:
              c.master.alert_engine.evaluations >= base + 2)
        with open(c.shard_path(host, vid, rot), "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x04]))
        out = c.shell("ec.scrub -all -rate 0")
        assert f"volume {vid}: unrepairable corrupt_shards=[{rot}]" in out

        def with_bundles():
            doc = c.get("/cluster/alerts?state=firing")
            a = {x["name"]: x for x in doc["alerts"]}
            s = a.get("scrub_unrepairable")
            return (a, doc) if s and len(s.get("bundles") or []) >= 2 \
                else None

        firing, doc = _wait("scrub_unrepairable with its bundles",
                            with_bundles)
        c.shell("coordinator.resume")
        st = _wait("the repair", lambda: (
            lambda s: s if s["repairs"]["done"] >= 1 else None)(
                c.get("/cluster/coordinator")))
        repair = next(r for r in st["recent"]
                      if r["action"] == "repair_done")
        bundles = {}
        for bnd in firing["scrub_unrepairable"]["bundles"]:
            assert bnd.get("id"), bnd
            bundles[bnd["server"]] = http_json(
                "GET", f"http://{bnd['server']}/debug/flightrecorder/"
                       f"{bnd['id']}")
        return c, {"vid": vid, "host": host, "rot": rot, "doc": doc,
                   "firing": firing, "repair": repair,
                   "bundles": bundles,
                   "status": c.shell("coordinator.status")}
    except BaseException:
        c.stop()
        raise


def test_a_rot_pages_captures_and_names_its_repair(tmp_path):
    got = {}
    for kind in ("reference", "port"):
        c, res = alert_drill(tmp_path, kind)
        try:
            firing = res["firing"]
            s = firing["scrub_unrepairable"]
            assert s["servers"] == [res["host"]]
            assert s["severity"] == "critical" and s["value"] >= 1
            assert {b["server"] for b in s["bundles"]} == \
                {res["host"], c.master.url}
            for srv, bdoc in res["bundles"].items():
                assert bdoc["meta"]["alert"] == "scrub_unrepairable"
                assert bdoc["trace"] is not None and bdoc["metrics"]
                assert bdoc["events"] and bdoc["profile"]
            # the master's bundle froze the cluster journal: the rot's
            # own events are in it
            types = {e["type"] for e in res["bundles"][c.master.url]["events"]}
            assert {"shard_corrupt", "scrub_unrepairable"} <= types
            assert res["repair"]["alert"] in firing
            assert f"alert={res['repair']['alert']}" in res["status"]
            got[kind] = {
                "firing": sorted(firing),
                "states": {a["name"]: a["state"]
                           for a in res["doc"]["alerts"]},
                "repair_alert": res["repair"]["alert"],
                "bundle_keys": {sorted(b)[0]: sorted(b) for b in
                                res["bundles"].values()},
                "bundle_meta_keys": sorted(next(iter(
                    res["bundles"].values()))["meta"]),
            }
        finally:
            c.stop()
    assert got["port"] == got["reference"]
    assert "scrub_unrepairable" in got["port"]["firing"]
    assert got["port"]["repair_alert"] in ("scrub_unrepairable",
                                           "corrupt_shards_increase")


def _mask_shell(text: str) -> str:
    text = re.sub(r"\b\d\d:\d\d:\d\d\b", "<time>", text)
    text = re.sub(r"fr-\d{14}-\d+-[A-Za-z0-9_-]+", "<bundle>", text)
    text = re.sub(r"\(\d+ bytes, \d+ spans, \d+ events\)", "(<sizes>)", text)
    text = re.sub(r'"evaluated_at": [\d.]+', '"evaluated_at": <ts>', text)
    text = re.sub(r'"(fired_at|pending_since|resolved_at)": [\d.]+',
                  r'"\1": <ts>', text)
    return text


def test_alert_shell_renderings_equal_the_reference(tmp_path, monkeypatch):
    """alerts.list (plain, -firing, -json), alerts.capture (every server,
    and one) and fault.list from the port's shell and the reference's,
    against the port's master after the drill; times, bundle ids and
    sizes masked.  fault.list prints each package's own registry, so the
    reference's renders the port's table for the comparison."""
    c, _res = alert_drill(tmp_path, "port")
    try:
        c.shell("coordinator.pause")
        c.master.metrics_aggregation_seconds = 3600.0
        c.master.alert_engine.min_interval = 3600.0
        host = next(iter(c.servers))
        lines = ["alerts.list", "alerts.list -firing",
                 "alerts.list -firing -json",
                 "alerts.capture -reason renderings",
                 f"alerts.capture -server {host}"]
        for line in lines:
            port_out = run_command(CommandEnv(c.master.url), line)
            ref_out = ref_run_command(RefCommandEnv(c.master.url), line)
            assert _mask_shell(port_out) == _mask_shell(ref_out), line
        capture = run_command(CommandEnv(c.master.url), "alerts.capture")
        assert len(capture.splitlines()) == 1 + len(c.servers)
        assert "capture failed" not in capture
        monkeypatch.setattr(ref_fi, "FAULT_POINTS",
                            dict(port_fi.FAULT_POINTS))
        for line in ("fault.list", "fault.list -json"):
            port_out = run_command(CommandEnv(c.master.url), line)
            ref_out = ref_run_command(RefCommandEnv(c.master.url), line)
            assert port_out.replace("seaweedfs_tpu_torch.", "") == \
                ref_out.replace("seaweedfs_tpu.", "").replace(
                    "enable/scoped", "enable"), line
        health = run_command(CommandEnv(c.master.url), "cluster.health")
        assert re.search(r"^alerts: \d+ firing \(.*scrub_unrepairable",
                         health, re.M), health
    finally:
        c.stop()
