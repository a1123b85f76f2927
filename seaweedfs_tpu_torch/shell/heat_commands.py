"""Heat shell commands (observability/heat.py).

The port's copy of seaweedfs_tpu/shell/heat_commands.py:

    heat.volumes [-top 20] [-json]   # volume heat ranks and the head set
    heat.top [-top 20] [-json]       # the hottest needles (the servers'
                                     # space-saving sketches, merged)

Both read the master's merged heat journal (GET /cluster/heat): the
decayed read, byte, cache-hit and error rates each volume server ships,
the live Zipf fit over needle heat, the head set, and the recent
heat_shift / flash_crowd events.  An alert names a volume; ``heat.top``
shows which needles carry the head; the event's exemplar trace opens the
request in trace.fetch.
"""

from __future__ import annotations

import json

from .commands import CommandEnv, command


def _fetch(env: CommandEnv, flags: dict) -> dict:
    try:
        top = int(flags.get("top") or 20)
    except ValueError as e:
        raise ValueError(f"bad -top: {e}")
    return env.master_get(f"/cluster/heat?top={max(1, top)}")


@command("heat.volumes")
def cmd_heat_volumes(env: CommandEnv, flags: dict) -> str:
    """heat.volumes [-top 20] [-json]
    # per-volume heat ranks from the master's merged heat journal:
    # decayed read/cache-hit/error rates, head-set membership,
    # server/rack imbalance, and recent head-set shift events"""
    doc = _fetch(env, flags)
    if flags.get("json") == "true":
        return json.dumps(doc, indent=2)
    try:
        top = int(flags.get("top") or 20)
    except ValueError:
        top = 20
    head = set((doc.get("head") or {}).get("volumes") or [])
    lines = [f"{'volume':>7} {'heat':>9} {'share':>6} {'reads/s':>8} "
             f"{'hits/s':>8} {'err%':>5}  servers"]
    for row in (doc.get("volumes") or [])[:top]:
        mark = "*" if row["volume"] in head else " "
        lines.append(
            f"{mark}{row['volume']:>6} {row['heat']:>9.2f} "
            f"{row.get('share', 0.0):>6.1%} {row['read_rate']:>8.2f} "
            f"{row['cache_hit_rate']:>8.2f} "
            f"{row.get('error_share', 0.0):>5.1%}  "
            f"{','.join(row.get('servers') or [])}")
    imb = doc.get("imbalance") or {}
    zipf = doc.get("zipf") or {}
    lines.append(f"head(*): share >= "
                 f"{(doc.get('head') or {}).get('min_share', 0):g}; "
                 f"zipf_s={zipf.get('s', 0.0):g} over "
                 f"{zipf.get('distinct', 0)} needles; "
                 f"server_imbalance={imb.get('server', 0.0):g}")
    shifts = doc.get("shifts") or []
    for ev in shifts[-3:]:
        d = ev.get("details") or {}
        lines.append(f"  {ev.get('type')}: volume={d.get('volume')} "
                     f"share={d.get('share')} "
                     f"prev={d.get('prev_share')} "
                     f"trace={ev.get('trace') or '-'}")
    return "\n".join(lines)


@command("heat.top")
def cmd_heat_top(env: CommandEnv, flags: dict) -> str:
    """heat.top [-top 20] [-json]
    # hottest needles cluster-wide: the merged space-saving sketches
    # (decayed access mass per fid), plus the live Zipf fit over them
    # — which objects the flash crowd is actually fetching"""
    doc = _fetch(env, flags)
    if flags.get("json") == "true":
        return json.dumps(doc.get("zipf") or {}, indent=2)
    zipf = doc.get("zipf") or {}
    rows = zipf.get("top") or []
    if not rows:
        return ("no needle heat yet (reads feed the per-server "
                "sketches; snapshots ship every ~1s)")
    lines = [f"{'fid':<24} {'mass':>10}"]
    for row in rows:
        lines.append(f"{row['fid']:<24} {row['mass']:>10.2f}")
    lines.append(f"zipf_s={zipf.get('s', 0.0):g} over "
                 f"{zipf.get('distinct', 0)} distinct needles")
    return "\n".join(lines)
