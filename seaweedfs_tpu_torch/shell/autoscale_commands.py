"""The heat autoscaler's shell commands.

The port's copy of seaweedfs_tpu/shell/autoscale_commands.py:

    autoscale.status [-json]    # the loop, targets, tiered volumes
    autoscale.pause             # hold autonomous grow/shrink/tier moves
    autoscale.resume
    volume.tier -volumeId N [-backend NAME] [-recall]

The shell's admin ``lock`` already pauses the autoscaler (no dueling
moves); pause/resume is the operator's hold that outlives a lock session.
``volume.tier`` runs the autonomous cold path's own legs (upload and
verify, the raft-logged ``tier_pending``, the commit), so a volume tiered
by hand is recalled when heat returns.  Output is stable line-per-record
text, as coordinator.status's; -json prints the raw document.
"""

from __future__ import annotations

import json
import time

from .commands import CommandEnv, command


def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"


def _render_status(doc: dict) -> str:
    state = "paused" if doc.get("paused") else (
        "running" if doc.get("enabled") else "disabled")
    reason = doc.get("pause_reason") or ""
    knobs = doc.get("knobs") or {}
    budget = doc.get("move_budget") or {}
    lines = [
        f"autoscale: {state}"
        + (f" ({reason})" if reason else "")
        + f"  cycles={doc.get('cycles', 0)}"
        f" last={_fmt_ts(doc.get('last_cycle_at', 0))}",
        f"  actuations: grows={doc.get('grows', 0)}"
        f" shrinks={doc.get('shrinks', 0)} tiers={doc.get('tiers', 0)}"
        f" recalls={doc.get('recalls', 0)}"
        f" failures={doc.get('failures', 0)}"
        f"  (budget {budget.get('tokens', 0)}/{budget.get('burst', 0)}"
        f" tokens, {budget.get('rate_per_s', 0)}/s)",
        f"  knobs: grow_share={knobs.get('grow_share')}"
        f" max_replicas={knobs.get('max_replicas')}"
        f" hold_down_s={knobs.get('hold_down_s')}"
        f" tier_backend={knobs.get('tier_backend') or '-'}"
        f" tier_after_s={knobs.get('tier_after_s')}",
    ]
    if doc.get("last_error"):
        lines.append(f"  last_error: {doc['last_error']}")
    for vid, t in sorted(((doc.get("targets") or {}).items()),
                         key=lambda kv: int(kv[0])):
        lines.append(
            f"  volume {vid}: +{len(t.get('added') or ())} replicas"
            f" {t.get('added') or []}"
            f" cycles={t.get('cycles', 0)}"
            + (f" grown={_fmt_ts(t['grown_at'])}"
               if t.get("grown_at") else ""))
    for vid, t in sorted(((doc.get("tiered") or {}).items()),
                         key=lambda kv: int(kv[0])):
        lines.append(
            f"  volume {vid}: TIERED -> {t.get('backend')}"
            f":{t.get('key')} on {t.get('server')}"
            f" since={_fmt_ts(t.get('at', 0))}")
    pend = (doc.get("replicated") or {}).get("pending") or {}
    for vid, r in sorted(pend.items(), key=lambda kv: int(kv[0])):
        lines.append(
            f"  volume {vid}: PENDING {r.get('op')}"
            + (f" dst={r['dst']}" if r.get("dst") else "")
            + (f" alert={r['alert']}" if r.get("alert") else ""))
    for a in list(doc.get("recent", []))[:10]:
        extra = {k: v for k, v in a.items()
                 if k not in ("at", "action") and v not in ("", [], None)}
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        lines.append(f"  {_fmt_ts(a.get('at', 0))} {a.get('action'):<15}"
                     f" {detail}")
    return "\n".join(lines)


@command("autoscale.status")
def cmd_autoscale_status(env: CommandEnv, flags: dict) -> str:
    """autoscale.status [-json]
    # the heat autoscaler's state: per-volume replica targets and the
    # added-replica ledger, the tiered-volume registry, grow/shrink/
    # tier/recall totals, token-bucket budget, hysteresis knobs, raft-
    # replicated pending plans, recent actions with cause attribution"""
    doc = env.master_get("/cluster/autoscale")
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    return _render_status(doc)


@command("autoscale.pause")
def cmd_autoscale_pause(env: CommandEnv, flags: dict) -> str:
    """autoscale.pause
    # hold all autonomous grow/shrink/tier/recall plans until resume
    # (the admin lock pauses implicitly; this survives unlock)"""
    doc = env.master_post("/cluster/autoscale/pause", {})
    return _render_status(doc)


@command("autoscale.resume")
def cmd_autoscale_resume(env: CommandEnv, flags: dict) -> str:
    """autoscale.resume
    # lift an autoscale.pause hold and wake the planner"""
    doc = env.master_post("/cluster/autoscale/resume", {})
    return _render_status(doc)


@command("volume.tier")
def cmd_volume_tier(env: CommandEnv, flags: dict) -> str:
    """volume.tier -volumeId N [-backend NAME] [-recall]
    # tier a cold single-replica volume's .dat to the remote backend
    # (two-phase: upload+verify, raft-logged commit point, local
    # delete), or -recall it back to local disk.  Runs through the
    # autoscaler's journaled legs, so the move carries attribution
    # and the tiered volume auto-recalls when heat returns"""
    vid = flags.get("volumeId") or flags.get("volume_id")
    if not vid:
        raise ValueError("volume.tier requires -volumeId")
    payload = {"volume_id": int(vid),
               "backend": flags.get("backend", ""),
               "recall": flags.get("recall") == "true"}
    out = env.master_post("/cluster/autoscale/tier", payload)
    if "recalled" in out:
        return (f"volume {out['recalled']} recalled to local disk "
                f"on {out['server']}")
    return (f"volume {out['tiered']} tiered -> {out['backend']}"
            f":{out['key']} (local .dat dropped on {out['server']})")
