"""Trace and journal shell commands.

The port's copy of seaweedfs_tpu/shell/trace_commands.py's trace.analyze
and trace.fetch and of alert_commands.py's events.tail:

    trace.analyze -server host:port   the critical-path report of a live
                                      server's span ring
    trace.analyze -file trace.json    the same for a saved trace
    trace.fetch <trace_id> | -list    one stitched cluster trace from
                                      the master's collector
    events.tail [-n 20] [-type t]     the cluster journal (or -server's
                                      own journal), one event a line
    cluster.raft [-json]              every master's raft view: role,
                                      term, leader, commit and applied
                                      indexes, log span, snapshots

The alerting commands are in alert_commands.py; cluster.health (in
coordinator_commands.py) prints the masters line of cluster.raft.
``-master`` may name any master: a follower redirects the control plane
to the leader.  cluster.raft also takes a comma-separated list and walks
every peer each master names.
"""

from __future__ import annotations

import json
import time

from ..observability.analysis import (analyze, render_cluster_report,
                                      render_report)
from ..utils.httpd import http_bytes, http_json
from .commands import CommandEnv, command


@command("trace.analyze")
def cmd_trace_analyze(env: CommandEnv, flags: dict) -> str:
    """trace.analyze [-server host:port] [-file trace.json] [-json]
    # critical-path attribution report for a server's span ring (or a
    # saved trace file); -json emits the raw report document"""
    path = flags.get("file") or ""
    server = flags.get("server") or ""
    if path:
        with open(path) as f:
            doc = json.load(f)
        report = analyze(doc)
    elif server:
        status, body, _ = http_bytes(
            "GET", f"http://{server}/debug/traces/analyze", timeout=60.0)
        if status != 200:
            raise RuntimeError(
                f"{server}/debug/traces/analyze: status {status}: "
                f"{body[:200].decode(errors='replace')}")
        report = json.loads(body)
    else:
        raise ValueError(
            "trace.analyze needs -server host:port or -file trace.json")
    if flags.get("json") == "true":
        return json.dumps(report, indent=2)
    return render_report(report).rstrip("\n")


@command("trace.fetch")
def cmd_trace_fetch(env: CommandEnv, flags: dict) -> str:
    """trace.fetch <trace_id> | -trace <trace_id> [-json]
    [-chrome [-out file.json]] | -list
    # fetch one stitched cluster trace from the master's collector and
    # render the cross-server analysis (per-hop occupancy, network-vs-
    # server split, bounding hop, degraded verdict); -chrome saves the
    # Chrome trace-event view instead; -list shows recent trace ids.
    # A bare `trace.fetch` defaults to the previous command's trace id."""
    if flags.get("list") == "true" or flags.get("") == "list":
        doc = env.master_get("/cluster/traces")
        lines = []
        for t in doc.get("traces", []):
            lines.append(f"{t['trace_id']}  root={t.get('root')} "
                         f"spans={t['span_count']} wall={t['wall_s']}s "
                         f"servers={','.join(t['servers'])}")
        return "\n".join(lines) or "no traces collected"
    trace_id = flags.get("trace") or flags.get("") or env.prev_trace_id
    if not trace_id:
        raise ValueError("trace.fetch needs a trace id — run a command "
                         "first, pass one, or -list recent ones")
    if flags.get("chrome") == "true":
        doc = env.master_get(f"/cluster/traces/{trace_id}?format=chrome")
        out = flags.get("out") or f"trace_{trace_id[:8]}.json"
        with open(out, "w") as f:
            json.dump(doc, f)
        return f"wrote {out} ({len(doc.get('traceEvents', []))} events)"
    doc = env.master_get(f"/cluster/traces/{trace_id}")
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    return render_cluster_report(doc["analysis"]).rstrip("\n")


def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"


@command("events.tail")
def cmd_events_tail(env: CommandEnv, flags: dict) -> str:
    """events.tail [-n 20] [-type t] [-severity s] [-min_severity s]
    [-server host:port] [-json]
    # the most recent cluster events (master journal), or one server's
    # local journal with -server.  One event per line:
    # <time> <severity> <type> <server> key=value... [trace <id>]"""
    n = int(flags.get("n") or 20)
    params = []
    for flag, qk in (("type", "type"), ("severity", "severity"),
                     ("min_severity", "min_severity")):
        if flags.get(flag):
            params.append(f"{qk}={flags[flag]}")
    params.append(f"limit={n}")
    qs = "&".join(params)
    if flags.get("server"):
        doc = http_json(
            "GET", f"http://{flags['server']}/debug/events?{qs}",
            timeout=30.0)
    else:
        doc = env.master_get(f"/cluster/events?{qs}")
    events = doc.get("events", [])
    if flags.get("json") == "true":
        return json.dumps(events, indent=2)
    if not events:
        return "no events"
    lines = []
    for e in events:
        details = " ".join(f"{k}={v}" for k, v
                           in sorted((e.get("details") or {}).items())
                           if v not in ("", None, []))
        line = (f"{_fmt_ts(e.get('ts', 0))} {e.get('severity', '?'):<8} "
                f"{e.get('type', '?'):<18} {e.get('server') or '-':<21} "
                f"{details}")
        if e.get("trace"):
            line += f" [trace {e['trace']}]"
        lines.append(line.rstrip())
    return "\n".join(lines)


def _raft_views(env: CommandEnv) -> dict[str, dict]:
    """/cluster/status from every reachable master: the configured
    candidates (``env.master_url`` may be a comma-separated list) and
    every peer any of them names.  An unreachable master stays in the map
    with an ``error`` key: a failover drill wants to see the dead one."""
    queue = [u for u in env.master_url.split(",") if u]
    views: dict[str, dict] = {}
    while queue:
        url = queue.pop(0)
        if url in views:
            continue
        try:
            views[url] = http_json("GET", f"http://{url}/cluster/status",
                                   timeout=5.0)
        except Exception as e:  # noqa: BLE001 - a dead master is listed
            views[url] = {"error": str(e) or e.__class__.__name__}
            continue
        queue.extend(p for p in views[url].get("Peers", [])
                     if p not in views and p not in queue)
    return views


def _quorum_line(views: dict[str, dict]) -> str:
    """``masters: 3 (leader host:port, term 7)``, and the masters down:
    the one-line quorum summary of cluster.health and cluster.raft."""
    up = {u: v for u, v in views.items() if "error" not in v}
    leaders = sorted({v.get("Leader") or "" for v in up.values()} - {""})
    term = max((int(v.get("Term") or 0) for v in up.values()), default=0)
    leader = leaders[0] if len(leaders) == 1 else \
        (f"DISPUTED {'/'.join(leaders)}" if leaders else "none")
    line = f"masters: {len(views)} (leader {leader}, term {term})"
    down = sorted(u for u, v in views.items() if "error" in v)
    if down:
        line += f"  down: {', '.join(down)}"
    return line


@command("cluster.raft")
def cmd_cluster_raft(env: CommandEnv, flags: dict) -> str:
    """cluster.raft [-json]  # per-master raft view: role, term, known
    leader, commit/applied indexes, log span, snapshot transfers —
    the quorum's replication progress at a glance"""
    views = _raft_views(env)
    if flags.get("json") == "true":
        return json.dumps({"masters": views}, indent=2)
    lines = [_quorum_line(views)]
    for url, v in sorted(views.items()):
        if "error" in v:
            lines.append(f"  {url}: unreachable ({v['error']})")
            continue
        lines.append(
            f"  {url}: {v.get('Role', '?')} term={v.get('Term', 0)} "
            f"commit={v.get('CommitIndex', 0)} "
            f"applied={v.get('LastApplied', 0)} "
            f"log[{v.get('LogFirstIndex', 1)}..{v.get('LastIndex', 0)}] "
            f"snap@{v.get('SnapshotIndex', 0)} "
            f"installed={v.get('SnapshotsInstalled', 0)} "
            f"sent={v.get('SnapshotsSent', 0)}")
    return "\n".join(lines)
