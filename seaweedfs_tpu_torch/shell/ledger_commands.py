"""Resource-ledger shell commands (observability/ledger.py).

The port's copy of seaweedfs_tpu/shell/ledger_commands.py:

    cluster.top [-by route|client|server] [-top 20] [-json]

The cluster's top(1): who spends which serving resource now.  It reads
the master's merged ledger (GET /cluster/ledger), the decayed CPU, byte
and queue-wait rates by route class and client every server ships, and
ranks the chosen axis by CPU share.  A loop_stall or queue-wait alert
fires; ``cluster.top`` names the route or client prefix carrying the CPU;
the row's exemplar trace opens the request in trace.fetch; the servers'
profiler windows on /cluster/ledger say which stacks are rising.
"""

from __future__ import annotations

import json

from .commands import CommandEnv, command

_AXES = ("route", "client", "server")


def _ms(rate_s: float) -> str:
    """Seconds-per-second rate as ms/s (CPU and queue-wait columns)."""
    return f"{rate_s * 1000.0:.1f}"


def _kb(rate_b: float) -> str:
    return f"{rate_b / 1024.0:.1f}"


@command("cluster.top")
def cmd_cluster_top(env: CommandEnv, flags: dict) -> str:
    """cluster.top [-by route|client|server] [-top 20] [-json]
    # rank the cluster's serving cost by CPU share: per-route-class
    # (default), per-client /24 prefix, or per-server — merged from
    # every server's per-request resource ledger, with queue-wait,
    # byte and cache rates, loop-lag p99 and recent loop stalls"""
    by = str(flags.get("by") or "route")
    if by not in _AXES:
        raise ValueError(f"bad -by {by!r}: pick one of {'|'.join(_AXES)}")
    try:
        top = max(1, int(flags.get("top") or 20))
    except ValueError as e:
        raise ValueError(f"bad -top: {e}")
    doc = env.master_get(f"/cluster/ledger?top={top}")
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    totals = doc.get("totals") or {}
    lines: list[str] = []
    if by == "server":
        lines.append(f"{'server':<22} {'cpu%':>6} {'cpu ms/s':>9} "
                     f"{'req/s':>8} {'qwait ms/s':>11} "
                     f"{'loop p99 ms':>12} {'stalls':>6}")
        for row in (doc.get("servers") or [])[:top]:
            lines.append(
                f"{row['server']:<22} {row.get('cpu_share', 0.0):>6.1%} "
                f"{_ms(row.get('cpu_rate', 0.0)):>9} "
                f"{row.get('req_rate', 0.0):>8.2f} "
                f"{_ms(row.get('queue_wait_rate', 0.0)):>11} "
                f"{row.get('loop_lag_p99_ms', 0.0):>12.2f} "
                f"{row.get('stalls', 0):>6}")
    else:
        key = by
        rows = doc.get("routes" if by == "route" else "clients") or []
        lines.append(f"{key:<26} {'cpu%':>6} {'cpu ms/s':>9} "
                     f"{'req/s':>8} {'qwait ms/s':>11} {'in KB/s':>8} "
                     f"{'out KB/s':>9} {'hit/s':>7}  trace")
        for row in rows[:top]:
            lines.append(
                f"{row[key]:<26} {row.get('cpu_share', 0.0):>6.1%} "
                f"{_ms(row.get('cpu_rate', 0.0)):>9} "
                f"{row.get('req_rate', 0.0):>8.2f} "
                f"{_ms(row.get('queue_wait_rate', 0.0)):>11} "
                f"{_kb(row.get('bytes_in_rate', 0.0)):>8} "
                f"{_kb(row.get('bytes_out_rate', 0.0)):>9} "
                f"{row.get('cache_hit_rate', 0.0):>7.2f}  "
                f"{row.get('trace') or '-'}")
    if len(lines) == 1:
        lines.append("  (no ledger snapshots yet — servers ship "
                     "every ~1s; is -ledger.off set?)")
    lines.append(f"total: cpu {_ms(totals.get('cpu_rate', 0.0))} ms/s "
                 f"across {totals.get('req_rate', 0.0):g} req/s; "
                 f"{len(doc.get('peers') or {})} peers")
    stalls = doc.get("stalls") or []
    for ev in stalls[-3:]:
        d = ev.get("details") or {}
        lines.append(f"  loop_stall: server={ev.get('server')} "
                     f"route={d.get('route')} "
                     f"lag_ms={d.get('lag_ms')} "
                     f"trace={ev.get('trace') or '-'}")
    return "\n".join(lines)
