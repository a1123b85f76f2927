"""Workload recording shell commands (observability/reqlog.py).

The port's copy of the recording commands of seaweedfs_tpu/shell/
workload_commands.py:

    workload.record [-sample 1.0] [-size 8192] [-seed N]  # start everywhere
    workload.stop                                         # stop everywhere
    workload.export [-out recording.json] [-route r]      # save the recording

workload.record sends POST /debug/reqlog/start to the master and every
volume server its topology names (a request log is one per process); the
shippers stream the sampled records to the master's /cluster/workload
journal all along.  workload.export saves the master's recording document
and prints its summary by route.

Not ported: ``workload.profile``, ``workload.replay`` and
``capacity.probe``; they fit and drive the recording through
seaweedfs_tpu/scenarios/, which the port has not yet.
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
