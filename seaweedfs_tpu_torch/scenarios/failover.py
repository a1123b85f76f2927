"""Master-failover drill: kill the raft leader mid write-storm, mid
EC repair, and measure what the HA control plane promises.

The port's copy of seaweedfs_tpu/scenarios/failover.py.  Its volume
servers run their EC work on ``device`` ("cuda" by default): the drill's
encode (``Store.ec_generate``) and the new leader's repair launch the
GF kernel on the card.

`run_failover` spawns a REAL in-process quorum (3+ masters peered over
/raft/*, volume servers heartbeating the full master list), spreads an
EC volume across every server, rots one shard so the scrub plane
quarantines it and the alert engine fires, lets the coordinator
quorum-replicate its repair plan and start executing with every
/admin/ec/* leg slowed by the coord.exec fault point — then stops the
leader dead and measures:

  election_time_s      — kill -> exactly one new leader all survivors
                         agree on
  assign_after_kill_s  — kill -> a deadline-scoped /dir/assign served
                         by the new leader
  journal_loss_count   — pre-kill journaled event ids missing from the
                         new leader's /cluster/events (the raft-
                         replicated journal contract: must be 0)
  repair_replan_s      — kill -> the new leader's repair_done for the
                         orphaned volume, with the ORIGINAL alert and
                         cause-trace attribution intact

The pre-kill snapshot is taken of events a FOLLOWER already holds:
raft only promises what a quorum acknowledged, and the election
restriction then guarantees the winner has every one of them.  Events
ingested in the kill window itself are post-kill by definition.

The result document mirrors the scenario engine's shape (routes,
checks, verdict), with the reference's keys.
"""

from __future__ import annotations

import random
import shutil
import tempfile
import threading
import time
from typing import Optional

from ..ec.layout import TOTAL_SHARDS_COUNT
from ..utils import deadline as _deadline
from ..utils import faultinject as fi
from ..utils.backoff import get_retry_budget
from ..utils.httpd import HttpError, http_bytes, http_json
from ..utils.leader import LeaderFollowingTransport
from .engine import _free_port, _Op, _route_stats
from .spec import ScenarioSpec
from .workload import SizeSampler, payload_for

# the drill's EC volume id: far above anything the storm's volume
# growth allocates, so the manually-built spread never collides
EC_VID = 999


def _wait(cond, timeout: float, what: str):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.1)
    raise RuntimeError(f"timed out waiting for {what}")


def _wait_leader(masters, timeout: float = 15.0):
    """One leader, and every live master agrees who it is."""
    def check():
        leaders = [m for m in masters if m.is_leader]
        if len(leaders) == 1 and all(
                m.leader_url == leaders[0].url for m in masters):
            return leaders[0]
        return None
    return _wait(check, timeout, "a stable leader")


def _make_ec_volume(vs, vid: int, needles: int = 30) -> None:
    import numpy as np

    from ..storage.needle import Needle

    v = vs.store.add_volume(vid)
    rng = np.random.default_rng(0xFA11)
    for i in range(1, needles + 1):
        v.write_needle(Needle(cookie=i, id=i,
                              data=rng.bytes(300 + i * 11)))
    vs.store.ec_generate(vid)
    vs.store.ec_mount(vid)


def _spread_shards(servers, vid: int) -> None:
    """Round-robin the volume's shards across every server with real
    /admin/ec/copy legs — each holder ends with < k local shards, so a
    corrupted one is locally unrepairable and MUST cross the wire."""
    src = servers[0]
    n = len(servers)
    layout = {i: [s for s in range(TOTAL_SHARDS_COUNT) if s % n == i]
              for i in range(n)}
    for i, sids in layout.items():
        if i == 0:
            continue
        http_json("POST", f"http://{servers[i].url}/admin/ec/copy",
                  {"volume_id": vid, "shard_ids": sids,
                   "source_data_node": src.url}, timeout=30.0)
        http_json("POST", f"http://{servers[i].url}/admin/ec/mount",
                  {"volume_id": vid}, timeout=30.0)
    drop = [s for s in range(TOTAL_SHARDS_COUNT)
            if s not in layout[0]]
    http_json("POST", f"http://{src.url}/admin/ec/delete",
              {"volume_id": vid, "shard_ids": drop}, timeout=30.0)
    http_json("POST", f"http://{src.url}/admin/ec/mount",
              {"volume_id": vid}, timeout=30.0)
    http_json("POST", f"http://{src.url}/admin/delete_volume",
              {"volume_id": vid}, timeout=30.0)
    for vs in servers:
        vs.heartbeat_now()


def _registry_shards(master, vid: int) -> dict:
    with master.topo.lock:
        locs = master.topo.ec_shard_locations.get(vid, {})
        return {sid: [n.url for n in nodes]
                for sid, nodes in locs.items() if nodes}


def _scrub_once(vs) -> None:
    # suspend the scrubber's busy gate for the forced pass: it exists
    # to defer scan IO behind live traffic, but this drill scans MID
    # write storm on purpose — gated, the pass can pause for as long
    # as the storm keeps the holder above the busy threshold
    prev_busy = vs.scrubber.busy_fn
    vs.scrubber.busy_fn = None
    try:
        http_json("POST", f"http://{vs.url}/ec/scrub/start",
                  {"rate_mb_s": 0, "interval_s": 0}, timeout=30.0)
        _wait(lambda: not http_json(
            "GET", f"http://{vs.url}/ec/scrub/status",
            timeout=10.0)["running"],
            45, f"scrub on {vs.url}")
    finally:
        vs.scrubber.busy_fn = prev_busy


def _storm_loop(ci: int, spec: ScenarioSpec,
                transport: LeaderFollowingTransport, t0: float,
                stop: threading.Event, out: list) -> None:
    """One write-storm client: assign through the leader-following
    transport (any live master serves — followers redirect GETs), PUT
    to the assigned volume server, under the spec deadline."""
    rng = random.Random(spec.seed * 7919 + ci)
    sizes = SizeSampler(spec.sizes)
    seq = 0
    while not stop.is_set():
        t_op = time.monotonic()
        status = 0
        try:
            with _deadline.scope(spec.deadline_s):
                r = transport.get("/dir/assign?count=1", timeout=10.0)
                seq += 1
                payload = payload_for(sizes.sample(rng), ci * 131 + seq)
                status, _b, _h = http_bytes(
                    "POST", f"http://{r['url']}/{r['fid']}", payload,
                    timeout=10.0)
        except _deadline.DeadlineExceeded:
            status = 504
        except HttpError as e:
            status = e.status
        except Exception:
            status = 0
        out.append(_Op("write", t_op - t0, time.monotonic() - t_op,
                       status))
        # sustained storm, not a tight-loop DoS of the test host
        stop.wait(0.02)


def run_failover(spec: Optional[ScenarioSpec] = None,
                 base_dir: Optional[str] = None, log=None,
                 device="cuda") -> dict:
    """Run the master_failover drill end to end on volume servers whose
    EC work runs on ``device``; returns the result document (routes /
    measurements / checks / verdict)."""
    from ..master.server import MasterServer
    from ..observability import disable_tracing, enable_tracing, get_tracer
    from ..volume_server.server import VolumeServer
    from .spec import master_failover as _default_spec

    spec = spec or _default_spec()
    say = log or (lambda _m: None)
    exp = spec.expectations
    # tracing on: the scrub verdicts must carry trace ids so the
    # repair's cause_trace attribution has something to preserve
    tracing_was_on = get_tracer().enabled
    if not tracing_was_on:
        enable_tracing()
    n_masters = max(3, spec.n_masters)
    mdirs = [tempfile.mkdtemp(dir=base_dir) for _ in range(n_masters)]
    roots = [tempfile.mkdtemp(dir=base_dir)
             for _ in range(spec.n_volume_servers)]
    ports = [_free_port() for _ in range(n_masters)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    master_list = ",".join(urls)
    result: dict = {"name": spec.name, "spec": spec.to_dict()}
    stop = threading.Event()
    threads: list[threading.Thread] = []
    masters: list = []
    servers: list = []
    try:
        for i, p in enumerate(ports):
            peers = [u for j, u in enumerate(urls) if j != i]
            m = MasterServer(port=p, peers=peers, mdir=mdirs[i],
                             pulse_seconds=0.3,
                             metrics_aggregation_seconds=0.25,
                             coordinator_seconds=0.3).start()
            m.aggregator.min_interval = 0.0
            m.alert_engine.min_interval = 0.0
            m.coordinator.move_rate = 100.0
            m.coordinator.pause("setup")
            masters.append(m)
        leader = _wait_leader(masters)
        say(f"{spec.name}: leader {leader.url} over {n_masters} masters")
        for i in range(spec.n_volume_servers):
            servers.append(VolumeServer(
                [roots[i]], master_list, port=_free_port(),
                rack=f"r{i % 2}", data_center="dc1",
                pulse_seconds=0.3, max_volume_count=16,
                device=device).start())
        _wait(lambda: len(leader.topo.all_nodes())
              >= spec.n_volume_servers, 15, "volume-server registration")
        # pre-grow so storm assigns spread instead of racing growth
        http_json("GET", f"http://{leader.url}/vol/grow"
                         f"?count={2 * spec.n_volume_servers}",
                  timeout=30.0)
        _make_ec_volume(servers[0], EC_VID)
        _spread_shards(servers, EC_VID)
        _wait(lambda: len(_registry_shards(leader, EC_VID))
              == TOTAL_SHARDS_COUNT, 15, "registry to see the EC spread")
        _wait(lambda: leader.alert_engine.evaluations > 0, 10,
              "the first alert evaluation")

        # --- the write storm ------------------------------------------
        t0 = time.monotonic()
        per_client: list[list] = [[] for _ in range(spec.clients)]
        for ci in range(spec.clients):
            tr = LeaderFollowingTransport(lambda: master_list,
                                          name=f"storm{ci}")
            threads.append(threading.Thread(
                target=_storm_loop,
                args=(ci, spec, tr, t0, stop, per_client[ci]),
                daemon=True, name=f"failover-c{ci}"))
        say(f"{spec.name}: {spec.clients} write-storm clients up")
        for t in threads:
            t.start()

        # --- rot a shard; the signal plane must notice ----------------
        sid = 2
        holder = servers[sid % len(servers)]
        fi.enable("ec.shard.corrupt",
                  params={"shard": sid, "offset": 0, "bit": 3},
                  max_hits=1)
        _scrub_once(holder)
        fi.disable("ec.shard.corrupt")
        # the corruption signal, specifically: under storm load the
        # plane also pages infrastructure alerts (loop_stall,
        # loop_lag_increase, reqlog drops) that are orthogonal to the
        # rot this drill plants — capturing those as `firing` would
        # break the attribution contract below even though the repair
        # cites its scrub cause correctly
        def _rot_alerts():
            return {a["name"]
                    for a in leader.alert_engine.to_dict()["alerts"]
                    if a["state"] == "firing"
                    and ("scrub" in a["name"] or "corrupt" in a["name"]
                         or a["name"].startswith("ec_"))} or None
        firing = _wait(_rot_alerts, 25, "a firing corruption alert")
        say(f"{spec.name}: firing={sorted(firing)}")

        # --- repair starts, slowed; plan quorum-replicates ------------
        fi.enable("coord.exec", delay=1.0)
        # resume EVERY coordinator: followers idle behind is_leader_fn,
        # but whichever wins the coming election must not stay parked
        # on the setup pause
        for m in masters:
            m.coordinator.resume()
        followers = [m for m in masters if m is not leader]
        _wait(lambda: any(
            f.coordinator.status()["replicated"]["pending"]
            for f in followers), 25,
            "the repair plan to replicate to a follower")
        # the plan exists, so the alert that seeded it is firing NOW —
        # fold the current rot set into the pre-kill capture (the first
        # counter_increase alert can reach firing a beat before the
        # threshold rule the coordinator actually cites)
        firing |= _rot_alerts() or set()
        # pre-kill zero-loss snapshot: what a follower already holds is
        # what raft promises survives the election
        pre_ids = {e["id"] for e in leader.event_journal.query(limit=0)}
        _wait(lambda: any(
            pre_ids <= {e["id"] for e in f.event_journal.query(limit=0)}
            for f in followers), 15, "journal replication to catch up")

        # --- kill -----------------------------------------------------
        say(f"{spec.name}: killing leader {leader.url} mid-repair "
            f"({len(pre_ids)} journaled events pre-kill)")
        kill_t = time.monotonic()
        # in-process artifact: a real master death takes its in-flight
        # repair threads with it, but stop() only joins them for 2s —
        # sever the old coordinator's egress so the orphaned repair
        # truly dies with its master and the re-plan measured below is
        # the NEW leader's work

        def _dead_post(*_a, **_k):
            raise ConnectionError("master process killed")
        leader.coordinator.executor._post_fn = _dead_post
        leader.stop()
        new_leader = _wait_leader(followers, timeout=25)
        election_s = round(time.monotonic() - kill_t, 2)
        fi.disable("coord.exec")
        say(f"{spec.name}: new leader {new_leader.url} "
            f"after {election_s}s")

        # the new leader's topology refills from volume-server
        # heartbeats (one pulse): a client retries until its assign
        # lands — the measure is election -> first SERVED assign
        assign_budget = float(exp.get("assign_after_kill_max_s", 5.0))
        assign_t = time.monotonic()
        assign_ok = False
        while time.monotonic() - assign_t < assign_budget + 5.0:
            try:
                with _deadline.scope(spec.deadline_s):
                    http_json(
                        "GET",
                        f"http://{new_leader.url}/dir/assign?count=1",
                        timeout=10.0)
                assign_ok = True
                break
            except Exception:
                time.sleep(0.1)
        assign_after_kill_s = round(time.monotonic() - assign_t, 3)

        def missing_ids():
            have = {e["id"]
                    for e in new_leader.event_journal.query(limit=0)}
            return pre_ids - have
        try:
            _wait(lambda: not missing_ids(), 20,
                  "pre-kill events on the new leader")
        except RuntimeError:
            pass  # scored below as journal_loss_count
        journal_loss = len(missing_ids())

        def done_event():
            evs = new_leader.event_journal.query(type_="repair_done",
                                                 limit=0)
            for e in reversed(evs):
                if (e.get("details") or {}).get("vid") == EC_VID:
                    return e
            return None
        repair_budget = float(exp.get("repair_replan_max_s", 45.0))
        ev = None
        try:
            ev = _wait(done_event, repair_budget + 10.0,
                       "the re-planned repair to finish")
        except RuntimeError:
            pass
        repair_replan_s = round(time.monotonic() - kill_t, 2) \
            if ev else None
        detail = (ev or {}).get("details") or {}

        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        ops = sorted((o for lst in per_client for o in lst),
                     key=lambda o: o.t)
        wall = time.monotonic() - t0
        new_alerts = {a["name"]: a for a in
                      new_leader.alert_engine.to_dict()["alerts"]}
        result.update({
            "wall_s": round(wall, 1),
            "total_ops": len(ops),
            "routes": _route_stats(ops, wall),
            "masters": n_masters,
            "killed_leader": leader.url,
            "new_leader": new_leader.url,
            "election_time_s": election_s,
            "assign_after_kill_s": assign_after_kill_s,
            "pre_kill_events": len(pre_ids),
            "journal_loss_count": journal_loss,
            "repair_replan_s": repair_replan_s,
            "repair_attribution": {
                "alert": detail.get("alert", ""),
                "cause_trace": detail.get("cause_trace", ""),
                "fired_pre_kill": sorted(firing)},
            "alerts": {
                "fired_on_new_leader": sorted(
                    n for n, a in new_alerts.items()
                    if a.get("fired_at")),
                "still_firing": sorted(
                    n for n, a in new_alerts.items()
                    if a["state"] == "firing")},
            "raft": new_leader.raft.status(),
        })

        checks: list[dict] = []

        def check(name, ok, value, bound):
            checks.append({"check": name, "ok": bool(ok),
                           "value": value, "bound": bound})

        if "election_max_s" in exp:
            check("election_time_s", election_s <= exp["election_max_s"],
                  election_s, exp["election_max_s"])
        if "journal_loss_max" in exp:
            check("journal_loss_count",
                  journal_loss <= exp["journal_loss_max"],
                  journal_loss, exp["journal_loss_max"])
        if "assign_after_kill_max_s" in exp:
            check("assign_after_kill_s",
                  assign_ok
                  and assign_after_kill_s <= exp["assign_after_kill_max_s"],
                  assign_after_kill_s, exp["assign_after_kill_max_s"])
        if "repair_replan_max_s" in exp:
            check("repair_replan_s",
                  repair_replan_s is not None
                  and repair_replan_s <= exp["repair_replan_max_s"],
                  repair_replan_s, exp["repair_replan_max_s"])
        check("repair_attribution",
              bool(detail.get("alert")) and detail["alert"] in firing
              and bool(detail.get("cause_trace")),
              {"alert": detail.get("alert", ""),
               "cause_trace": detail.get("cause_trace", "")},
              "original alert + cause trace")
        result["checks"] = checks
        result["degraded"] = any(not c["ok"] for c in checks)
        result["verdict"] = "degraded" if result["degraded"] else "pass"
        return result
    finally:
        stop.set()
        fi.clear()
        get_retry_budget().reset()
        for vs in servers:
            try:
                vs.stop()
            except Exception:
                pass
        for m in masters:
            try:
                m.stop()
            except Exception:
                pass
        if not tracing_was_on:
            disable_tracing()
        for d in mdirs + roots:
            shutil.rmtree(d, ignore_errors=True)
