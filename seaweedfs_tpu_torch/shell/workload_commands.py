"""Workload recording, replay and capacity shell commands.

The port's copy of seaweedfs_tpu/shell/workload_commands.py:

    workload.record [-sample 1.0] [-size 8192] [-seed N]  # start everywhere
    workload.stop                                         # stop everywhere
    workload.export [-out recording.json] [-route r]      # save the recording
    workload.profile [-file recording.json] [-json]       # its fitted shape
    workload.replay [-file recording.json] [-speed 2] [-duration s]
                    [-against host:port] [-json]
    capacity.probe [-routes http_read,native_read] [-p99 5] [-step 2]

workload.record sends POST /debug/reqlog/start to the master and every
volume server its topology names (a request log is one per process); the
shippers stream the sampled records to the master's /cluster/workload
journal all along.  workload.export saves the master's recording document
and prints its summary by route.  workload.profile prints the recording's
fitted shape (scenarios/replay.py recording_profile), cross-checked with
the heat plane's live Zipf fit; workload.replay fits it into a
ScenarioSpec and drives it (an in-process cluster whose servers run on
the card, or ``-against`` a live master), then prints the verdict and
the replay-fidelity checks.

capacity.probe runs the SLO capacity search (scenarios/capacity.py)
against the connected cluster and posts the result to the master
(POST /cluster/capacity), where cluster.health picks it up as a one-line
hint.  The probe writes load objects and drives the cluster to its knee:
it needs the admin lock, as replaying ``-against`` a cluster does.  An
unknown route, or a result the master refuses, fails the command.
"""

from __future__ import annotations

import json
import time

from ..utils.httpd import http_json
from .commands import CommandEnv, command


def _all_servers(env: CommandEnv) -> list[str]:
    """Every process whose request log a cluster-wide record or stop
    must reach: the master and every heartbeat-registered volume
    server."""
    targets = [env.master_url]
    topo = env.topology()
    for dc in topo.get("DataCenters", []):
        for rack in dc.get("Racks", []):
            for n in rack.get("DataNodes", []):
                targets.append(n["Url"])
    return targets


@command("workload.record")
def cmd_workload_record(env: CommandEnv, flags: dict) -> str:
    """workload.record [-sample 1.0] [-size 8192] [-seed N]
    [-include_ops] [-server host:port]
    # start the workload flight recorder on the master and every
    # registered volume server (or one -server); sampled, redacted
    # access records stream to the master's /cluster/workload journal"""
    body: dict = {"reset": True}
    try:
        if flags.get("sample"):
            body["sample"] = float(flags["sample"])
        if flags.get("size"):
            body["size"] = int(flags["size"])
        if flags.get("seed"):
            body["seed"] = int(flags["seed"])
    except ValueError as e:
        raise ValueError(f"bad -sample/-size/-seed: {e}")
    if flags.get("include_ops") == "true":
        body["include_ops"] = True
    targets = [flags["server"]] if flags.get("server") \
        else _all_servers(env)
    lines = []
    for url in targets:
        try:
            st = http_json("POST", f"http://{url}/debug/reqlog/start",
                           body, timeout=15.0)
            lines.append(f"{url}: recording sample={st['sample']:g} "
                         f"capacity={st['capacity']}")
        except Exception as e:  # noqa: BLE001 - one line a server
            lines.append(f"{url}: start failed: "
                         f"{type(e).__name__}: {e}")
    return "\n".join(lines)


@command("workload.stop")
def cmd_workload_stop(env: CommandEnv, flags: dict) -> str:
    """workload.stop [-server host:port]
    # stop recording (rings keep their records for export)"""
    targets = [flags["server"]] if flags.get("server") \
        else _all_servers(env)
    lines = []
    for url in targets:
        try:
            st = http_json("POST", f"http://{url}/debug/reqlog/stop",
                           {}, timeout=15.0)
            lines.append(f"{url}: stopped "
                         f"(recorded={st['recorded']} "
                         f"dropped={st['dropped']})")
        except Exception as e:  # noqa: BLE001 - one line a server
            lines.append(f"{url}: stop failed: "
                         f"{type(e).__name__}: {e}")
    return "\n".join(lines)


@command("workload.export")
def cmd_workload_export(env: CommandEnv, flags: dict) -> str:
    """workload.export [-out recording.json] [-route r] [-since ts]
    # save the master's merged workload recording (the replayable
    # document); prints the per-route summary"""
    params = []
    if flags.get("route"):
        params.append(f"route={flags['route']}")
    if flags.get("since"):
        params.append(f"since={flags['since']}")
    qs = ("?" + "&".join(params)) if params else ""
    doc = env.master_get(f"/cluster/workload/export{qs}")
    out = flags.get("out") or f"recording_{int(time.time())}.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    s = doc.get("summary") or {}
    lines = [f"wrote {out}: {s.get('records', 0)} records over "
             f"{s.get('window_s', 0)}s (dropped={doc.get('dropped', 0)})"]
    for route, row in sorted((s.get("routes") or {}).items()):
        lines.append(f"  {route:<14} ops={row['ops']} "
                     f"errors={row['errors']} "
                     f"in={row['bytes_in']} out={row['bytes_out']}")
    return "\n".join(lines)


def _load_recording(env: CommandEnv, flags: dict, qs: str = "") -> dict:
    """The recording a -file names, else the master's current one."""
    if flags.get("file"):
        with open(flags["file"], encoding="utf-8") as f:
            return json.load(f)
    return env.master_get(f"/cluster/workload/export{qs}")


@command("workload.profile")
def cmd_workload_profile(env: CommandEnv, flags: dict) -> str:
    """workload.profile [-file recording.json] [-route r] [-json]
    # fit the recorded workload's measured shape (the recording_profile
    # document spec_from_recording fits from): mix fractions, observed
    # rps, size buckets, and the Zipf skew, cross-checked against the
    # heat plane's own live fit (/cluster/heat) when heat is flowing"""
    from ..scenarios.replay import recording_profile

    qs = f"?route={flags['route']}" if flags.get("route") else ""
    profile = recording_profile(_load_recording(env, flags, qs))
    heat_zipf = None
    try:
        heat = env.master_get("/cluster/heat?top=1")
        z = heat.get("zipf") or {}
        if z.get("distinct", 0) >= 3:
            heat_zipf = z
    except Exception:  # noqa: BLE001 - as the reference's shell
        pass  # heat plane off or no snapshots yet: profile still prints
    if flags.get("json") == "true":
        doc = dict(profile)
        if heat_zipf is not None:
            doc["heat_zipf"] = heat_zipf
        return json.dumps(doc, indent=2)
    lines = [
        f"records={profile['records']} over {profile['window_s']}s "
        f"(observed_rps={profile['observed_rps']:g})",
        f"mix: read={profile['read_fraction']:g} "
        f"churn={profile['churn_fraction']:g} "
        f"submit={profile['submit_fraction']:g}",
        f"popularity: zipf_s={profile['zipf_s']:g} over "
        f"{profile['distinct_keys']} distinct keys",
        "sizes: " + ", ".join(f"{b}B x{w:g}"
                              for b, w in profile["sizes"]),
        f"deadline_p50_s={profile['deadline_p50_s']:g}",
    ]
    if heat_zipf is not None:
        lines.append(f"heat plane agrees: live zipf_s="
                     f"{heat_zipf.get('s', 0.0):g} over "
                     f"{heat_zipf.get('distinct', 0)} needles "
                     f"(/cluster/heat)")
    for key, count in profile["top_keys"][:5]:
        lines.append(f"  top key {key}: {count} reads")
    return "\n".join(lines)


@command("workload.replay")
def cmd_workload_replay(env: CommandEnv, flags: dict) -> str:
    """workload.replay [-file recording.json] [-speed 1.0]
    [-duration s] [-clients 8] [-against host:port] [-json]
    # fit a recording (a -file, or the master's current journal) into
    # a ScenarioSpec and replay it with the scenario engine: a fresh
    # in-process cluster on the card, alerting live,
    # open-loop paced.  Prints the scenario verdict and the
    # machine-checked replay-fidelity list.  -against drives the
    # recorded workload at a LIVE cluster's master instead (writes load
    # objects; hold the admin lock)"""
    from ..scenarios import run_against, run_scenario
    from ..scenarios.replay import replay_fidelity, spec_from_recording

    recording = _load_recording(env, flags)
    try:
        speed = float(flags.get("speed") or 1.0)
        duration = float(flags["duration"]) if flags.get("duration") \
            else None
        clients = int(flags.get("clients") or 8)
    except ValueError as e:
        raise ValueError(f"bad -speed/-duration/-clients: {e}")
    spec = spec_from_recording(recording, speed=speed,
                               duration_s=duration, clients=clients)
    against = (flags.get("against") or "").strip()
    if against:
        # replaying INTO a live cluster mutates it (hot-set preload +
        # recorded write mix): same admin-lock bar as capacity.probe
        env.confirm_is_locked()
        result = run_against(spec, against)
    else:
        result = run_scenario(spec)
    fidelity = replay_fidelity(recording, spec, result=result)
    result["fidelity"] = fidelity
    if flags.get("json") == "true":
        return json.dumps(result, indent=2)
    where = f" against {against}" if against else ""
    lines = [f"replayed {spec.name}{where}: "
             f"verdict={result['verdict']} "
             f"({result['total_ops']} ops over {result['wall_s']}s, "
             f"target_rps={spec.target_rps:g})"]
    for c in result.get("checks", []) + fidelity:
        mark = "ok " if c["ok"] else "FAIL"
        lines.append(f"  {mark} {c['check']}: value={c['value']} "
                     f"bound={c['bound']}")
    return "\n".join(lines)


@command("capacity.probe")
def cmd_capacity_probe(env: CommandEnv, flags: dict) -> str:
    """capacity.probe [-routes http_read,native_read,http_write]
    [-p99 5.0] [-errors 0.001] [-start 100] [-max 50000] [-step 2.0]
    [-json]
    # binary-search the max sustainable rps per route class under the
    # SLO against the LIVE cluster (writes load objects; drives the
    # cluster to its knee: hold the admin lock), then post the result
    # to the master so cluster.health can hint at it"""
    from ..scenarios.capacity import (CapacitySLO, probe_cluster,
                                      render_capacity)

    env.confirm_is_locked()
    routes = tuple(s.strip() for s in
                   (flags.get("routes")
                    or "http_read,native_read,http_write").split(",")
                   if s.strip())
    unknown = [r for r in routes
               if r not in ("http_read", "native_read", "http_write")]
    if unknown:
        raise ValueError(f"unknown route(s) {unknown}: the probe drives "
                         "http_read, native_read and http_write")
    try:
        slo = CapacitySLO(
            max_p99_ms=float(flags.get("p99") or 5.0),
            max_error_ratio=float(flags.get("errors") or 0.001))
        start = float(flags.get("start") or 100.0)
        max_rps = float(flags.get("max") or 50000.0)
        step_s = float(flags.get("step") or 2.0)
    except ValueError as e:
        raise ValueError(f"bad probe knobs: {e}")
    doc = probe_cluster(env.master_url, routes=routes, slo=slo,
                        start_rps=start, max_rps=max_rps, step_s=step_s)
    for res in doc["routes"].values():
        res.pop("samples", None)
    # a result the master did not park is no result: the error stands
    env.master_post("/cluster/capacity", doc)
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    return render_capacity(doc) + "\nposted to master /cluster/capacity"
