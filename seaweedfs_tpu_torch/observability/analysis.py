"""Critical-path analysis of EC pipeline traces and stitched cluster
traces.

The port's copy of seaweedfs_tpu/observability/analysis.py: pure
functions over span dicts, so a report of the port's spans is the
reference's report of the same spans.  ``HOST_STAGES`` / ``ROOT_NAMES``
and ``_stage_of`` classify by span name, which is why the port's
pipeline spans carry the reference's names.

  report = analyze(tracer_or_trace_doc, counters=totals)

The input is a live Tracer, a list of Span objects, a
``Tracer.to_dict()`` document or the Chrome trace-event JSON that GET
/debug/traces writes; a saved trace gives the same report as the live
ring.  Per pipeline run (each ``pipeline.encode_file`` /
``pipeline.rebuild_files`` root):

  - stage occupancy: seconds and share of the wall per host stage (setup,
    fill, dispatch, compute, drain, write, fallback, close);
  - ``overlap_efficiency``: every second of the wall tied to a stage,
    the rest "unattributed";
  - the critical path through the dispatch sequence and the overall
    ``critical_path_stage``;
  - the gap analysis between worker windows (the port has no worker
    processes, so it reads zero windows);
  - the drain track: ``pipeline.drain`` spans on another thread than the
    root are the async drainer's fetches (``drain_track_s``,
    ``drain_profile``), while ``pipeline.drain_wait`` (the producer
    blocked on the slot pool) counts as host "drain";
  - a degraded flag from ``pipeline.retry`` / ``pipeline.fallback`` spans
    and, when given, the pipeline and integrity counters.

``analyze_cluster`` does the same for one stitched cluster trace: per-hop
occupancy, the network-versus-server split, the bounding hop and a
degraded verdict over the participating servers' counters.
"""

from __future__ import annotations

from typing import Optional

# stages that run ON the pipeline's host thread, in dispatch order;
# "drain" is the one where the host is BLOCKED waiting for results
HOST_STAGES = ("setup", "fill", "dispatch", "compute", "drain", "write",
               "fallback", "close")
ROOT_NAMES = ("pipeline.encode_file", "pipeline.rebuild_files")
# span names that are evidence of a degraded (self-healed) run
DEGRADE_EVENT_NAMES = ("pipeline.retry", "pipeline.fallback")
# counter keys (ec_pipeline_metrics().totals() / per-call encode stats)
# whose nonzero value marks the measured path degraded
DEGRADE_COUNTER_KEYS = ("worker_restarts", "engine_fallbacks",
                        "retries", "fallbacks",
                        # bit-rot defense (ec/integrity.py): nonzero
                        # means some measurement read shards that rotted
                        # and were demoted or repaired mid-run
                        "corrupt_shards", "scrub_repairs")

_EPS = 1e-6


def _normalize(trace) -> list[dict]:
    """Any trace shape -> list of plain span dicts
    {name, t0, t1, id, parent, tid, attrs} sorted by t0."""
    spans: list[dict] = []
    if hasattr(trace, "snapshot"):  # live Tracer
        trace = trace.snapshot()
    if isinstance(trace, dict):
        if "spans" in trace:        # Tracer.to_dict() document
            trace = trace["spans"]
        elif "traceEvents" in trace:
            return _from_chrome(trace)
        else:
            raise ValueError("unrecognized trace document: expected "
                             "'spans' or 'traceEvents'")
    for sp in trace:
        if hasattr(sp, "to_dict"):  # Span object
            sp = sp.to_dict()
        spans.append({"name": sp["name"], "t0": float(sp["t0"]),
                      "t1": float(sp["t1"]), "id": sp.get("id"),
                      "parent": sp.get("parent"),
                      "tid": sp.get("tid", 0),
                      # cross-server identity: the shipping server's url
                      # (collector-stitched docs), falling back to the
                      # recording process's namespace
                      "server": sp.get("server") or sp.get("pid"),
                      "attrs": dict(sp.get("attrs") or {})})
    spans.sort(key=lambda s: s["t0"])
    return spans


def _from_chrome(doc: dict) -> list[dict]:
    """Chrome trace-event JSON (to_chrome() / --trace-out output) back to
    span dicts.  ts/dur are µs on a run-relative axis; the analysis only
    ever compares times within one document, so the lost absolute epoch
    is irrelevant."""
    spans = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = dict(e.get("args") or {})
        sid = args.pop("span_id", None)
        parent = args.pop("parent_id", None)
        t0 = float(e["ts"]) / 1e6
        spans.append({"name": e["name"], "t0": t0,
                      "t1": t0 + float(e.get("dur", 0)) / 1e6,
                      "id": sid, "parent": parent,
                      "tid": e.get("tid", 0), "attrs": args})
    spans.sort(key=lambda s: s["t0"])
    return spans


def _overlap_s(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def _stage_of(span: dict) -> Optional[str]:
    name = span["name"]
    if name in ROOT_NAMES or not name.startswith("pipeline."):
        return None
    stage = name.split(".", 1)[1]
    if stage == "drain_wait":
        # async drain: the producer thread blocked on the slot
        # pool / final join — host-blocked time, the same bucket the
        # old inline fetch landed in
        return "drain"
    return stage if stage in HOST_STAGES else None


def _merged_intervals(spans: list[dict]) -> list[tuple[float, float]]:
    ivs = sorted((s["t0"], s["t1"]) for s in spans)
    out: list[tuple[float, float]] = []
    for a, b in ivs:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _cover_len(a: float, b: float,
               ivs: list[tuple[float, float]]) -> float:
    """Length of [a, b] covered by the merged intervals."""
    total = 0.0
    for i0, i1 in ivs:
        if i1 <= a:
            continue
        if i0 >= b:
            break
        total += min(b, i1) - max(a, i0)
    return total


def _gap_analysis(members: list[dict],
                  drain_track: Optional[list[dict]] = None,
                  offthread: Optional[list[dict]] = None) -> dict:
    """Classify idle gaps between consecutive worker.compute windows by
    what the HOST thread was doing during each gap: filling/dispatching
    the next input (the worker is input-starved), blocked in drain, or
    writing shards.  Host drain time that coincides with an ACTIVE
    fetch on the concurrent drainer track is split out as `link_bound`
    (the host waits because the wire is still moving parity) vs
    `drain_blocked` (the host waits on drain machinery that is not
    actually transferring)."""
    drain_track = drain_track or []
    track_ivs = _merged_intervals(drain_track)
    windows = sorted((s for s in members
                      if s["name"].startswith("worker.")),
                     key=lambda s: s["t0"])
    out = {"worker_windows": len(windows), "worker_busy_s": 0.0,
           "gap_total_s": 0.0,
           "classes": {"input_starved": 0.0, "drain_blocked": 0.0,
                       "link_bound": 0.0,
                       "writer_blocked": 0.0, "other": 0.0}}
    if not windows:
        return out
    out["worker_busy_s"] = round(
        sum(s["t1"] - s["t0"] for s in windows), 4)
    # identity-based exclusion of the concurrent tracks: value equality
    # would be O(n*m) dict compares on 10^4-span bench traces
    excl = {id(s) for s in drain_track}
    excl.update(id(s) for s in (offthread or []))
    host = [s for s in members if id(s) not in excl]
    by_class = {
        "input_starved": [s for s in host
                          if _stage_of(s) in ("fill", "dispatch")],
        "writer_blocked": [s for s in host if _stage_of(s) == "write"],
    }
    drain_spans = [s for s in host if _stage_of(s) == "drain"]
    for prev, nxt in zip(windows, windows[1:]):
        g0, g1 = prev["t1"], nxt["t0"]
        gap = g1 - g0
        if gap <= 0:
            continue
        out["gap_total_s"] += gap
        covered = 0.0
        for cls, stage_spans in by_class.items():
            s = sum(_overlap_s(g0, g1, sp["t0"], sp["t1"])
                    for sp in stage_spans)
            out["classes"][cls] += s
            covered += s
        for sp in drain_spans:
            a = max(g0, sp["t0"])
            b = min(g1, sp["t1"])
            if b <= a:
                continue
            lb = _cover_len(a, b, track_ivs)
            out["classes"]["link_bound"] += lb
            out["classes"]["drain_blocked"] += (b - a) - lb
            covered += b - a
        out["classes"]["other"] += max(0.0, gap - covered)
    out["classes"] = {k: round(v, 4) for k, v in out["classes"].items()}
    # the classes decompose gap_total_s: independent rounding could push
    # their sum past the rounded total, so the total absorbs the rounding
    out["gap_total_s"] = round(max(out["gap_total_s"],
                                   sum(out["classes"].values())), 4)
    return out


def _analyze_run(root: dict, members: list[dict],
                 max_path_items: int = 48) -> dict:
    wall = max(root["t1"] - root["t0"], _EPS)
    # the async drain fetches on a DIFFERENT thread than the
    # pipeline root: those pipeline.drain spans are a concurrent track
    # (like worker.compute) — counting them as host time would let the
    # wall decomposition exceed 1.0 and misread an overlapped link
    # transfer as a stall.  Old (inline-drain) traces record drain on
    # the root's thread and keep the host-blocked semantics.
    host_tid = root.get("tid")
    stage_s: dict[str, float] = {}
    stage_n: dict[str, int] = {}
    per_dispatch: dict[int, dict[str, float]] = {}
    fallback_reasons: dict[str, int] = {}
    drain_track: list[dict] = []
    offthread: list[dict] = []           # writer/fallback threads
    offthread_s: dict[str, float] = {}
    drain_host_spans: list[dict] = []
    retries = 0
    for sp in members:
        stage = _stage_of(sp)
        if sp["name"] == "pipeline.retry":
            retries += 1
        if sp["name"] == "pipeline.fallback":
            reason = str(sp["attrs"].get("reason", "unknown"))
            fallback_reasons[reason] = fallback_reasons.get(reason, 0) + 1
        if stage is None:
            continue
        dur = sp["t1"] - sp["t0"]
        d = sp["attrs"].get("dispatch")
        if host_tid is not None and sp.get("tid") != host_tid:
            # async-drain tracks: the fetch (pipeline.drain), the
            # writer's parity writes, and fallback recomputes all ride
            # other threads — CONCURRENT with the host stages, so they
            # leave the wall decomposition (shares would sum past 1.0
            # and an overlapped transfer would read as a stall).  They
            # still vote in the per-dispatch critical path: they ARE
            # the dominant cost of a link- or writer-bound dispatch.
            if sp["name"] == "pipeline.drain":
                drain_track.append(sp)
            else:
                offthread.append(sp)
                offthread_s[stage] = offthread_s.get(stage, 0.0) + dur
            if d is not None:
                row = per_dispatch.setdefault(int(d), {})
                row[stage] = row.get(stage, 0.0) + dur
            continue
        if stage == "drain":
            drain_host_spans.append(sp)
        stage_s[stage] = stage_s.get(stage, 0.0) + dur
        stage_n[stage] = stage_n.get(stage, 0) + 1
        if d is not None:
            row = per_dispatch.setdefault(int(d), {})
            row[stage] = row.get(stage, 0.0) + dur

    attributed = sum(stage_s.values())
    unattributed = max(0.0, wall - attributed)
    drain_s = stage_s.get("drain", 0.0)
    track_s = sum(s["t1"] - s["t0"] for s in drain_track)
    # per-device breakdown (the -ec.engine=mesh plane tags its
    # dispatch/drain spans with a `device` attr): occupancy per device
    # on the dispatch side, fetch seconds per drain lane — how the
    # profile says WHICH device queue is the straggler
    per_device: dict[str, dict] = {}
    for sp in drain_track:
        dev = sp["attrs"].get("device")
        if dev is None:
            continue
        row = per_device.setdefault(
            str(dev), {"fetch_s": 0.0, "drain_spans": 0, "dispatches": 0})
        row["fetch_s"] += sp["t1"] - sp["t0"]
        row["drain_spans"] += 1
    for sp in members:
        if sp["name"] != "pipeline.dispatch":
            continue
        dev = sp["attrs"].get("device")
        if dev is None:
            continue
        row = per_device.setdefault(
            str(dev), {"fetch_s": 0.0, "drain_spans": 0, "dispatches": 0})
        row["dispatches"] += 1
    track_ivs = _merged_intervals(drain_track)
    # host-blocked drain seconds coinciding with an ACTIVE fetch on the
    # drainer track: the host waited on the WIRE (link-bound); the rest
    # of the blocked time is drain machinery (drain-blocked)
    link_covered_s = sum(_cover_len(s["t0"], s["t1"], track_ivs)
                         for s in drain_host_spans)
    if drain_s + track_s < 0.02 * wall:
        drain_cls = "none"
    elif drain_s < 0.15 * wall:
        drain_cls = "overlapped"
    elif link_covered_s >= 0.5 * drain_s:
        drain_cls = "link_bound"
    else:
        drain_cls = "drain_blocked"

    # every second of the wall lands in a named bucket
    attribution = {stage: {"s": round(s, 4),
                           "share": round(s / wall, 4),
                           "spans": stage_n.get(stage, 0)}
                   for stage, s in sorted(stage_s.items())}
    attribution["unattributed"] = {"s": round(unattributed, 4),
                                   "share": round(unattributed / wall, 4),
                                   "spans": 0}
    critical_path_stage = max(attribution,
                              key=lambda k: attribution[k]["s"])

    # critical path through the dispatch sequence: dominant stage per
    # dispatch, compressed into consecutive segments
    segments: list[dict] = []
    for d in sorted(per_dispatch):
        row = per_dispatch[d]
        dom = max(row, key=row.get)
        if segments and segments[-1]["stage"] == dom:
            seg = segments[-1]
            seg["dispatches"][1] = d
            seg["s"] += row[dom]
        else:
            segments.append({"stage": dom, "dispatches": [d, d],
                             "s": row[dom]})
    truncated = max(0, len(segments) - max_path_items)
    segments = segments[:max_path_items]
    for seg in segments:
        seg["s"] = round(seg["s"], 4)

    drain_profile = {
        "host_blocked_s": round(drain_s, 4),
        "fetch_s": round(track_s if drain_track else drain_s, 4),
        "link_bound_s": round(link_covered_s, 4),
        "classification": drain_cls,
    }
    if per_device:
        for row in per_device.values():
            row["fetch_s"] = round(row["fetch_s"], 4)
            row["fetch_share"] = round(
                row["fetch_s"] / max(track_s, _EPS), 4)
        drain_profile["per_device"] = {
            k: per_device[k]
            for k in sorted(per_device,
                            key=lambda d: int(d) if d.isdigit() else -1)}

    degraded = bool(retries or fallback_reasons
                    or int(root["attrs"].get("resume_entry") or 0) > 0)
    worker_s = sum(s["t1"] - s["t0"] for s in members
                   if s["name"].startswith("worker."))
    report = {
        "name": root["name"],
        "mode": root["attrs"].get("mode"),
        "engine": root["attrs"].get("engine"),
        "bytes": root["attrs"].get("bytes"),
        "wall_s": round(wall, 4),
        "dispatches": len(per_dispatch),
        "stage_s": {k: round(v, 4) for k, v in sorted(stage_s.items())},
        "worker_compute_s": round(worker_s, 4),  # concurrent track
        "drain_track_s": round(track_s, 4),      # concurrent fetch track
        # writer/fallback work on the drainer's threads, per stage
        "concurrent_stage_s": {k: round(v, 4)
                               for k, v in sorted(offthread_s.items())},
        "unattributed_s": round(unattributed, 4),
        "overlap_efficiency": round(1.0 - drain_s / wall, 4),
        "drain_profile": drain_profile,
        "attribution": attribution,
        "critical_path_stage": critical_path_stage,
        "critical_path": segments,
        "gap_analysis": _gap_analysis(members, drain_track, offthread),
        "degraded": degraded,
        "retries": retries,
        "fallbacks": sum(fallback_reasons.values()),
        "fallback_reasons": fallback_reasons,
    }
    if truncated:
        report["critical_path_truncated"] = truncated
    blocked_pct = round(100.0 * drain_s / wall)
    report["summary"] = (
        f"{critical_path_stage}-bound: {critical_path_stage} holds "
        f"{round(100.0 * attribution[critical_path_stage]['share'])}% of "
        f"{report['wall_s']}s wall ({blocked_pct}% blocked in drain); "
        f"{'DEGRADED' if degraded else 'clean'} run")
    return report


def _dropped_of(trace) -> int:
    """Span-loss accounting for the input: a live Tracer's ring-eviction
    counter, or the `dropped` field a to_dict()/collector document
    carries.  Surfaced on every report so a truncated trace cannot
    masquerade as a complete one."""
    if hasattr(trace, "dropped"):
        return int(trace.dropped)
    if isinstance(trace, dict):
        try:
            return int(trace.get("dropped")
                       or trace.get("spansDropped") or 0)
        except (TypeError, ValueError):
            return 0
    return 0


def analyze(trace, counters: Optional[dict] = None,
            max_path_items: int = 48) -> dict:
    """Trace (live Tracer, span list, to_dict() doc, or Chrome doc) ->
    attribution report.  `counters` is an optional restart/fallback
    totals dict (ec_pipeline_metrics().totals() or per-call encode
    stats); nonzero values mark the report degraded even when the
    ring has already rotated the retry spans out."""
    spans_dropped = _dropped_of(trace)
    spans = _normalize(trace)
    roots = [s for s in spans if s["name"] in ROOT_NAMES]
    runs = []
    claimed: set[int] = set()
    for root in roots:
        members = []
        for i, s in enumerate(spans):
            if s is root or i in claimed:
                continue
            if s["t0"] >= root["t0"] - _EPS and s["t1"] <= root["t1"] + _EPS:
                members.append(s)
                claimed.add(i)
        runs.append(_analyze_run(root, members, max_path_items))
    if not roots and spans:
        # no root captured (ring rotated / partial dump): synthesize one
        # run over the whole span set so the report stays useful
        synth = {"name": "pipeline.(partial)", "attrs": {},
                 "t0": min(s["t0"] for s in spans),
                 "t1": max(s["t1"] for s in spans)}
        runs.append(_analyze_run(synth, spans, max_path_items))
        runs[-1]["partial"] = True

    retry_n = sum(1 for s in spans if s["name"] == "pipeline.retry")
    fallback_n = sum(1 for s in spans if s["name"] == "pipeline.fallback")
    degraded = bool(retry_n or fallback_n or any(r["degraded"]
                                                for r in runs))
    health = dict(counters or {})
    if any(float(health.get(k) or 0) > 0 for k in DEGRADE_COUNTER_KEYS):
        degraded = True
    return {"span_count": len(spans), "runs": runs,
            "degraded": degraded, "retry_spans": retry_n,
            "fallback_spans": fallback_n, "health": health,
            "spans_dropped": spans_dropped}


# --- cross-server (cluster) analysis -----------------------------------------
# Input: a stitched trace document from the master's TraceCollector
# (observability/collector.py) — spans from every participating server,
# joined by trace id, with parent edges crossing process boundaries via
# the Traceparent header.  Output: per-hop occupancy, the network-vs-
# server time split, the cluster critical path naming the bounding hop,
# and a degraded verdict folding in every participating server's
# pipeline counters.

# outbound-hop span name (utils/httpd.py client helpers)
RPC_CLIENT = "rpc.client"


def _self_time(span: dict, children: list[dict]) -> float:
    """Duration minus time covered by child spans (merged intervals,
    clipped to the parent) — the seconds this span itself is
    responsible for."""
    t0, t1 = span["t0"], span["t1"]
    ivs = sorted((max(c["t0"], t0), min(c["t1"], t1)) for c in children)
    covered = 0.0
    cur0 = cur1 = None
    for a, b in ivs:
        if b <= a:
            continue
        if cur0 is None:
            cur0, cur1 = a, b
        elif a <= cur1:
            cur1 = max(cur1, b)
        else:
            covered += cur1 - cur0
            cur0, cur1 = a, b
    if cur0 is not None:
        covered += cur1 - cur0
    return max(0.0, (t1 - t0) - covered)


def _resolve_hop(sp: dict, kids: list[dict]) -> tuple[list[dict], str, str]:
    """Name an rpc.client span's far side: (remote children, to-server,
    remote op).  Prefers child spans recorded on a DIFFERENT server (the
    stitched request span); a hop whose remote never shipped its spans
    falls back to the client-side peer/path attrs.  Single source of
    truth for the hops table and the bounding-hop name — they must
    never attribute the same span to different servers."""
    remote = [c for c in kids if c.get("server") != sp.get("server")] \
        or kids
    attrs = sp.get("attrs") or {}
    to = remote[0].get("server") if remote else attrs.get("peer", "?")
    op = remote[0]["name"] if remote else str(attrs.get("path", "?"))
    return remote, to, op


def analyze_cluster(doc, health: Optional[dict] = None,
                    max_path_items: int = 32) -> dict:
    """Stitched cluster trace -> cross-server attribution report.

    `health` maps participating server url -> its pipeline_health
    counters (the master's aggregator view); any nonzero degrade
    counter on a PARTICIPATING server flips the verdict, so a rebuild
    that quietly demoted a corrupt survivor on a remote peer reads
    DEGRADED even though every span looks clean."""
    spans_dropped = _dropped_of(doc)
    trace_id = doc.get("trace_id") if isinstance(doc, dict) else None
    spans = _normalize(doc)
    by_id = {s["id"]: s for s in spans if s.get("id")}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        par = s.get("parent")
        if par and par in by_id:
            children.setdefault(par, []).append(s)
        else:
            roots.append(s)
    servers = sorted({s["server"] for s in spans if s.get("server")})

    if not spans:
        # keep every key render_cluster_report() indexes — a trace whose
        # only content is a shipper loss ledger must still render (as a
        # truncation warning), not KeyError
        return {"trace_id": trace_id, "span_count": 0, "servers": [],
                "wall_s": 0.0, "root": None, "per_server": {}, "hops": [],
                "network_s": 0.0, "server_s": {}, "unattributed_s": 0.0,
                "critical_path": [], "bounding_hop": None,
                "degrade_events": 0, "error_spans": 0,
                "degraded": False, "degraded_servers": [],
                "health": dict(health or {}),
                "spans_dropped": spans_dropped,
                "summary": "empty trace"}

    wall_t0 = min(s["t0"] for s in spans)
    wall_t1 = max(s["t1"] for s in spans)
    wall = max(wall_t1 - wall_t0, _EPS)

    # per-server occupancy: each span's SELF time (children subtracted)
    # summed by server, so nested spans never double-count and time
    # spent waiting on a remote hop lands on the rpc.client span, not
    # the server that was waiting
    server_s: dict[str, float] = {}
    network_s = 0.0
    for s in spans:
        own = _self_time(s, children.get(s.get("id"), []))
        if s["name"] == RPC_CLIENT:
            # the caller-side slice of a hop not covered by the remote
            # server's recorded request span = wire + connect + queue
            network_s += own
        else:
            key = s.get("server") or "?"
            server_s[key] = server_s.get(key, 0.0) + own

    per_server = {}
    for srv in servers or ["?"]:
        busy = server_s.get(srv, 0.0)
        n = sum(1 for s in spans if s.get("server") == srv)
        per_server[srv] = {"spans": n, "busy_s": round(busy, 4),
                           "share": round(busy / wall, 4)}

    # hops: every rpc.client span, aggregated by (from, to, remote op)
    hops: dict[tuple, dict] = {}
    for s in spans:
        if s["name"] != RPC_CLIENT:
            continue
        remote, to, op = _resolve_hop(s, children.get(s.get("id"), []))
        key = (s.get("server") or "?", to or "?", op)
        row = hops.setdefault(key, {"from": key[0], "to": key[1],
                                    "op": op, "calls": 0,
                                    "client_s": 0.0, "server_s": 0.0,
                                    "network_s": 0.0})
        dur = s["t1"] - s["t0"]
        srv_covered = sum(c["t1"] - c["t0"] for c in remote)
        row["calls"] += 1
        row["client_s"] += dur
        row["server_s"] += min(srv_covered, dur)
        row["network_s"] += max(0.0, dur - srv_covered)
    hop_rows = sorted(hops.values(), key=lambda r: -r["client_s"])
    for row in hop_rows:
        for k in ("client_s", "server_s", "network_s"):
            row[k] = round(row[k], 4)

    # cluster critical path: from the earliest root, keep descending
    # into the child subtree that ends last (the one the parent's exit
    # actually waited for), recording each step's server + self time
    root = min(roots, key=lambda s: s["t0"]) if roots else spans[0]
    path: list[dict] = []
    cur = root
    seen: set[str] = set()
    while cur is not None and len(path) < max_path_items:
        sid = cur.get("id")
        if sid in seen:
            break  # defensive: a cyclic parent edge must not hang us
        seen.add(sid or f"@{len(path)}")
        kids = children.get(sid, [])
        path.append({"server": cur.get("server") or "?",
                     "name": cur["name"],
                     "s": round(_self_time(cur, kids), 4),
                     "span_id": sid})
        cur = max(kids, key=lambda c: c["t1"]) if kids else None

    # the bounding hop: the rpc.client on the critical path holding the
    # most wall time; with no hop on the path, the path step with the
    # largest self time bounds the trace
    path_rpcs = [p for p in path if p["name"] == RPC_CLIENT]
    if path_rpcs:
        worst = max(path_rpcs, key=lambda p: p["s"])
        sp = by_id.get(worst["span_id"]) or {}
        _, to, op = _resolve_hop(sp, children.get(worst["span_id"], []))
        dur = (sp.get("t1", 0.0) - sp.get("t0", 0.0)) if sp else worst["s"]
        bounding = {"kind": "hop", "from": worst["server"], "to": to,
                    "op": op, "s": round(dur, 4),
                    "network_s": worst["s"]}
    elif path:
        worst = max(path, key=lambda p: p["s"])
        bounding = {"kind": "local", "server": worst["server"],
                    "op": worst["name"], "s": worst["s"]}
    else:
        bounding = None

    # degraded verdict: in-trace recovery events, error-tagged spans,
    # or nonzero degrade counters on ANY participating server
    degrade_events = sum(1 for s in spans
                         if s["name"] in DEGRADE_EVENT_NAMES)
    errors = sum(1 for s in spans if s["attrs"].get("error"))
    health = dict(health or {})
    degraded_servers = sorted(
        srv for srv, counters in health.items()
        if any(float((counters or {}).get(k) or 0) > 0
               for k in DEGRADE_COUNTER_KEYS))
    degraded = bool(degrade_events or errors or degraded_servers)

    total_attr = sum(server_s.values()) + network_s
    summary_bits = []
    if bounding is not None:
        if bounding["kind"] == "hop":
            summary_bits.append(
                f"bounding hop {bounding['from']} -> {bounding['to']} "
                f"{bounding['op']} ({bounding['s']}s, "
                f"{bounding['network_s']}s network)")
        else:
            summary_bits.append(
                f"bounded locally by {bounding['op']} on "
                f"{bounding['server']} ({bounding['s']}s)")
    summary_bits.append(
        f"network {round(network_s, 4)}s vs server "
        f"{round(sum(server_s.values()), 4)}s over {wall:.4f}s wall")
    summary_bits.append("DEGRADED" if degraded else "clean")
    return {
        "trace_id": trace_id,
        "span_count": len(spans),
        "servers": servers,
        "wall_s": round(wall, 4),
        "root": {"name": root["name"],
                 "server": root.get("server") or "?"},
        "per_server": per_server,
        "hops": hop_rows,
        "network_s": round(network_s, 4),
        "server_s": {k: round(v, 4) for k, v in sorted(server_s.items())},
        "unattributed_s": round(max(0.0, wall - total_attr), 4),
        "critical_path": path,
        "bounding_hop": bounding,
        "degrade_events": degrade_events,
        "error_spans": errors,
        "degraded": degraded,
        "degraded_servers": degraded_servers,
        "health": health,
        "spans_dropped": spans_dropped,
        "summary": "; ".join(summary_bits),
    }


def render_cluster_report(report: dict) -> str:
    """Human rendering of analyze_cluster() (`weed shell trace.fetch`)."""
    lines = [f"trace {report.get('trace_id')}: "
             f"{report['span_count']} spans across "
             f"{len(report['servers'])} server(s), "
             f"wall {report['wall_s']}s — "
             f"{'DEGRADED' if report['degraded'] else 'clean'}"]
    if report.get("spans_dropped"):
        lines.append(f"WARNING: {report['spans_dropped']} spans dropped — "
                     "stitched trace is INCOMPLETE")
    lines.append(f"  {report['summary']}")
    for srv, row in sorted(report["per_server"].items(),
                           key=lambda kv: -kv[1]["busy_s"]):
        bar = "#" * int(round(40 * row["share"]))
        lines.append(f"  {srv:<22} {row['busy_s']:>9.3f}s "
                     f"{100 * row['share']:5.1f}% "
                     f"({row['spans']} spans) {bar}")
    if report["hops"]:
        lines.append("  hops (client / server / network seconds):")
        for h in report["hops"][:12]:
            lines.append(f"    {h['from']} -> {h['to']} {h['op']} x"
                         f"{h['calls']}: {h['client_s']} / "
                         f"{h['server_s']} / {h['network_s']}")
    if report["critical_path"]:
        steps = " -> ".join(f"{p['server']}:{p['name']}"
                            for p in report["critical_path"][:10])
        lines.append(f"  critical path: {steps}")
    if report["degraded_servers"]:
        lines.append("  degraded servers: "
                     + ", ".join(report["degraded_servers"]))
    return "\n".join(lines) + "\n"


def attribution_summary(report: dict) -> dict:
    """The compact attribution block of a report (the reference's bench
    embeds it as e2e_pipeline_*.attribution):
    per-stage seconds, the critical-path stage, and the degraded flag
    for the report's LAST run (the measured rep)."""
    if not report.get("runs"):
        return {"degraded": report.get("degraded", False)}
    run = report["runs"][-1]
    return {
        "stage_s": run["stage_s"],
        "unattributed_s": run["unattributed_s"],
        "wall_s": run["wall_s"],
        "critical_path_stage": run["critical_path_stage"],
        "overlap_efficiency": run["overlap_efficiency"],
        "drain_profile": run.get("drain_profile"),
        "degraded": bool(report.get("degraded") or run["degraded"]),
        "summary": run["summary"],
    }


def render_report(report: dict) -> str:
    """Human-readable rendering (the `weed shell` trace.analyze view)."""
    lines = [f"spans analyzed: {report['span_count']}  "
             f"degraded: {report['degraded']}  "
             f"(retry spans: {report['retry_spans']}, "
             f"fallback spans: {report['fallback_spans']})"]
    if report.get("spans_dropped"):
        lines.append(f"WARNING: {report['spans_dropped']} spans dropped "
                     "(ring eviction / ship loss) — this trace is "
                     "TRUNCATED, attribution may under-count")
    health = report.get("health") or {}
    if health:
        lines.append("health counters: " + ", ".join(
            f"{k}={v}" for k, v in sorted(health.items())))
    if not report["runs"]:
        lines.append("no pipeline runs in the trace "
                     "(enable tracing, run an encode, re-analyze)")
    for i, run in enumerate(report["runs"]):
        lines.append("")
        lines.append(f"run {i}: {run['name']} mode={run['mode']} "
                     f"engine={run['engine']} "
                     f"dispatches={run['dispatches']} "
                     f"wall={run['wall_s']}s")
        lines.append(f"  {run['summary']}")
        lines.append(f"  overlap_efficiency={run['overlap_efficiency']}")
        dp = run.get("drain_profile") or {}
        if dp.get("classification") and dp["classification"] != "none":
            lines.append(
                f"  drain: {dp['classification']} (host blocked "
                f"{dp['host_blocked_s']}s, concurrent fetch "
                f"{dp['fetch_s']}s, link-covered {dp['link_bound_s']}s)")
        width = max((len(k) for k in run["attribution"]), default=1)
        for stage, row in sorted(run["attribution"].items(),
                                 key=lambda kv: -kv[1]["s"]):
            bar = "#" * int(round(40 * row["share"]))
            lines.append(f"  {stage:<{width}} {row['s']:>9.3f}s "
                         f"{100 * row['share']:5.1f}% {bar}")
        ga = run["gap_analysis"]
        if ga["worker_windows"]:
            cls = ", ".join(f"{k}={v}s" for k, v in ga["classes"].items()
                            if v > 0)
            lines.append(f"  worker gaps: {ga['gap_total_s']}s over "
                         f"{ga['worker_windows']} windows ({cls or 'none'})")
        if run["critical_path"]:
            path = " -> ".join(
                f"{seg['stage']}[d{seg['dispatches'][0]}"
                + (f"-{seg['dispatches'][1]}"
                   if seg["dispatches"][1] != seg["dispatches"][0] else "")
                + "]" for seg in run["critical_path"][:12])
            lines.append(f"  critical path: {path}")
    return "\n".join(lines) + "\n"
