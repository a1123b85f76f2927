"""The EC repair coordinator's shell commands, and cluster.health.

The port's copy of seaweedfs_tpu/shell/coordinator_commands.py and of
``cluster.health`` (shell/trace_commands.py):

    coordinator.status [-json]   # queue, budget, recent actions
    coordinator.pause            # hold autonomous plans (survives locks)
    coordinator.resume
    cluster.health [-json]       # the master's /cluster/health rollup

The shell's admin ``lock`` already pauses the coordinator (no dueling
migrations); pause/resume is the operator's hold that outlives a lock
session.  Output is stable line-per-record text, so scripts can grep it;
-json prints the raw document.  cluster.health prints the masters line
from /cluster/status, the alerts line from /cluster/alerts and the
resource ledger's line from /cluster/ledger (the worst loop-lag p99, the
stalls, the route carrying the most CPU); the reference's capacity line
is left out, as the reference's shell leaves it out before a master with
no capacity result (the port's capacity probe waits for scenarios/).
"""

from __future__ import annotations

import json
import time

from .commands import CommandEnv, command
from .trace_commands import _quorum_line, _raft_views


def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"


def _render_status(doc: dict) -> str:
    state = "paused" if doc.get("paused") else (
        "running" if doc.get("enabled") else "disabled")
    reason = doc.get("pause_reason") or ""
    lines = [(f"coordinator: {state}"
              + (f" ({reason})" if reason else "")
              + f"  cycles={doc.get('cycles', 0)}"
              f" last={_fmt_ts(doc.get('last_cycle_at', 0))}"
              f" under_replicated={doc.get('under_replicated', 0)}")]
    rep = doc.get("repairs") or {}
    budget = doc.get("move_budget") or {}
    lines.append(f"  repairs: done={rep.get('done', 0)} "
                 f"failed={rep.get('failed', 0)}  "
                 f"moves={doc.get('moves', 0)} "
                 f"(budget {budget.get('tokens', 0)}/"
                 f"{budget.get('burst', 0)} tokens, "
                 f"{budget.get('rate_per_s', 0)}/s)")
    if doc.get("last_error"):
        lines.append(f"  last_error: {doc['last_error']}")
    for q in doc.get("queue", []):
        lines.append(
            f"  queued volume {q.get('vid')}: clean={q.get('clean')}"
            f" deficit={q.get('deficit')}"
            + (" CRITICAL" if q.get("critical") else "")
            + (f" alert={q['alert']}" if q.get("alert") else "")
            + (f" [trace {q['cause_trace']}]"
               if q.get("cause_trace") else ""))
    for a in list(doc.get("recent", []))[:10]:
        extra = {k: v for k, v in a.items()
                 if k not in ("at", "action") and v not in ("", [], None)}
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        lines.append(f"  {_fmt_ts(a.get('at', 0))} {a.get('action'):<14}"
                     f" {detail}")
    return "\n".join(lines)


@command("coordinator.status")
def cmd_coordinator_status(env: CommandEnv, flags: dict) -> str:
    """coordinator.status [-json]
    # the autonomous EC rebuild/rebalance coordinator's state: repair
    # queue (clean-shard deficit, causing alert + trace id), repair and
    # move totals, token-bucket budget, recent actions"""
    doc = env.master_get("/cluster/coordinator")
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    return _render_status(doc)


@command("coordinator.pause")
def cmd_coordinator_pause(env: CommandEnv, flags: dict) -> str:
    """coordinator.pause
    # hold all autonomous repair/rebalance plans until resume (the
    # admin lock pauses implicitly; this survives unlock)"""
    return _render_status(env.master_post("/cluster/coordinator/pause", {}))


@command("coordinator.resume")
def cmd_coordinator_resume(env: CommandEnv, flags: dict) -> str:
    """coordinator.resume
    # lift a coordinator.pause hold and wake the planner"""
    return _render_status(env.master_post("/cluster/coordinator/resume", {}))


@command("cluster.health")
def cmd_cluster_health(env: CommandEnv, flags: dict) -> str:
    """cluster.health [-json]  # master's per-volume-server telemetry
    rollup: reachability/staleness + pipeline health counters"""
    doc = env.master_get("/cluster/health")
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    lines = [f"peers: {doc['peer_count']}  "
             f"degraded: {doc['degraded']}  "
             f"stale: {', '.join(doc['stale_peers']) or 'none'}",
             _quorum_line(_raft_views(env))]
    # best-effort: a master without the alert engine leaves the line out
    try:
        al = env.master_get("/cluster/alerts")
        firing = [a["name"] for a in al.get("alerts", [])
                  if a["state"] == "firing"]
        lines.append(f"alerts: {al.get('firing', 0)} firing"
                     + (f" ({', '.join(firing)})" if firing else ""))
    except Exception:  # noqa: BLE001 - as the reference's shell
        pass
    # best-effort: the worst loop-lag p99 across the peers and the route
    # carrying the most CPU; cluster.top drills down
    try:
        led = env.master_get("/cluster/ledger?top=1")
        worst = max((s.get("loop_lag_p99_ms", 0.0)
                     for s in led.get("servers") or []), default=0.0)
        stalls = sum(s.get("stalls", 0)
                     for s in led.get("servers") or [])
        routes = led.get("routes") or []
        if routes:
            r = routes[0]
            lines.append(
                f"ledger: loop_lag_p99={worst:g}ms stalls={stalls} "
                f"top_route={r['route']} "
                f"({r.get('cpu_share', 0.0):.0%} cpu, "
                f"{r.get('req_rate', 0.0):g} req/s) — cluster.top")
    except Exception:  # noqa: BLE001 - as the reference's shell
        pass
    t = doc["totals"]
    lines.append(f"totals: worker_restarts={t['worker_restarts']} "
                 f"engine_fallbacks={t['engine_fallbacks']} "
                 f"degraded_binds={t['degraded_binds']} "
                 f"scrub_unrepairable={t.get('scrub_unrepairable', 0)}")
    for url, p in sorted(doc["peers"].items()):
        ph = p["pipeline_health"]
        state = "up" if p["up"] else f"DOWN ({p.get('error', '')})"
        if p["stale"]:
            state += " STALE"
        line = (f"  {url}: {state} age={p.get('age_s')}s "
                f"restarts={ph['worker_restarts']} "
                f"fallbacks={ph['engine_fallbacks']} "
                f"degraded_binds={ph['degraded_binds']}")
        scrub = p.get("scrub")
        if scrub:
            verdicts = ",".join(f"{k}={v}" for k, v
                                in sorted(scrub["verdicts"].items())) \
                or "none"
            line += (f" scrub[running={scrub['running']} "
                     f"passes={scrub['passes']} {verdicts}]")
        lines.append(line)
    return "\n".join(lines)
