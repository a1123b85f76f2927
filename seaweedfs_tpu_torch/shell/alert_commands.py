"""Alerting shell commands.

The port's copy of the alert commands of seaweedfs_tpu/shell/
alert_commands.py (``events.tail`` is in trace_commands.py):

    alerts.list [-firing] [-json]          # the master's alert table
    alerts.capture [-server h:p] [-reason text]
                                           # force flight-recorder bundles

Output is stable line-per-record text (fixed field order, key=value
details) so scripts can grep it; -json prints the raw documents.
"""

from __future__ import annotations

import json
import time

from ..utils.httpd import http_json
from .commands import CommandEnv, command


def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"


@command("alerts.list")
def cmd_alerts_list(env: CommandEnv, flags: dict) -> str:
    """alerts.list [-firing] [-json]
    # the master's alerting-engine state: one line per rule with
    # state/severity/value/detail (+ bundle ids once the flight
    # recorder captured); -firing keeps only firing alerts"""
    doc = env.master_get("/cluster/alerts")
    alerts = doc.get("alerts", [])
    if flags.get("firing") == "true":
        alerts = [a for a in alerts if a["state"] == "firing"]
    if flags.get("json") == "true":
        return json.dumps({"firing": doc.get("firing", 0),
                           "evaluated_at": doc.get("evaluated_at"),
                           "alerts": alerts}, indent=2)
    lines = [f"alerts: {doc.get('firing', 0)} firing "
             f"(evaluated {_fmt_ts(doc.get('evaluated_at', 0))}, "
             f"{len(doc.get('rules', []))} rules)"]
    for a in alerts:
        line = (f"  {a['state']:<8} {a['severity']:<8} {a['name']}"
                f"  value={a.get('value', 0):g}")
        if a.get("fired_at"):
            line += f" fired={_fmt_ts(a['fired_at'])}"
        if a.get("detail"):
            line += f"  {a['detail']}"
        if a.get("exemplar_trace"):
            line += f" [trace {a['exemplar_trace']}]"
        lines.append(line)
        for b in a.get("bundles", []):
            lines.append(f"           bundle {b.get('id') or '-'} "
                         f"@ {b.get('server')}"
                         + (f" error={b['error']}" if b.get("error")
                            else ""))
    return "\n".join(lines)


@command("alerts.capture")
def cmd_alerts_capture(env: CommandEnv, flags: dict) -> str:
    """alerts.capture [-server host:port] [-reason text]
    # freeze flight-recorder bundles by hand: POSTs
    # /debug/flightrecorder/capture on the named server, or on the
    # master plus every registered volume server"""
    reason = flags.get("reason") or "shell"
    if flags.get("server"):
        targets = [flags["server"]]
    else:
        targets = [env.master_url]
        topo = env.topology()
        for dc in topo.get("DataCenters", []):
            for rack in dc.get("Racks", []):
                for n in rack.get("DataNodes", []):
                    targets.append(n["Url"])
    lines = []
    for url in targets:
        try:
            meta = http_json(
                "POST", f"http://{url}/debug/flightrecorder/capture",
                {"reason": reason}, timeout=30)
            lines.append(f"{url}: bundle {meta['id']} "
                         f"({meta.get('bytes', 0)} bytes, "
                         f"{meta.get('span_count', 0)} spans, "
                         f"{meta.get('event_count', 0)} events)")
        except Exception as e:  # noqa: BLE001 - one line per server
            lines.append(f"{url}: capture failed: "
                         f"{type(e).__name__}: {e}")
    return "\n".join(lines)
