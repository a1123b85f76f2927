"""EC command family: ec.encode / ec.rebuild / ec.balance / ec.scrub /
ec.decode.

The port's copy of seaweedfs_tpu/shell/ec_commands.py (weed/shell/
command_ec_encode.go, command_ec_rebuild.go, command_ec_balance.go,
command_ec_decode.go, command_ec_common.go).  ``-engine`` names the
volume servers' EC engine and defaults to ``tpu``, which every port
server runs (on the card, or on the CPU where the server was started
with ``-ec.engine cpu``).  ec.encode and ec.rebuild report the wall time
of each leg.  ec.scrub drives the servers' ``/ec/scrub`` routes;
``ec.scrub -all`` ends with the master's ``/cluster/health`` verdict.
"""

from __future__ import annotations

import time

from ..ec.layout import TOTAL_SHARDS_COUNT
from ..ops import coordinator as coord
from ..utils.httpd import http_json
from .commands import CommandEnv, command


def _ec_nodes(env: CommandEnv) -> list[dict]:
    """collectEcNodes (command_ec_common.go:205): nodes sorted by free
    slots descending."""
    topo = env.topology()
    nodes = [n for dc in topo["DataCenters"] for rack in dc["Racks"]
             for n in rack["DataNodes"]]
    return sorted(nodes, key=lambda n: -n["Free"])


def _balanced_distribution(nodes: list[dict],
                           n_shards: int) -> dict[str, list[int]]:
    """balancedEcDistribution (command_ec_encode.go:249-265): round-robin
    shards onto the nodes with the most free slots."""
    if not nodes:
        raise RuntimeError("no volume servers with free slots")
    alloc: dict[str, list[int]] = {n["Url"]: [] for n in nodes}
    free = {n["Url"]: max(n["Free"], 0) for n in nodes}
    order = [n["Url"] for n in nodes]
    sid = 0
    while sid < n_shards:
        placed = False
        for url in order:
            if sid >= n_shards:
                break
            if free[url] > 0 or all(f <= 0 for f in free.values()):
                alloc[url].append(sid)
                free[url] -= 1 / 10  # ec shards are fractional slots
                sid += 1
                placed = True
        if not placed:
            for url in order:  # no free slots anywhere: spread anyway
                if sid >= n_shards:
                    break
                alloc[url].append(sid)
                sid += 1
    return {u: s for u, s in alloc.items() if s}


def _ec_encode_candidates(env: CommandEnv, collection: str,
                          full_percent: float, quiet_seconds: float
                          ) -> list[int]:
    """vidsToEcEncode (command_ec_encode.go:267-298): volumes of the
    collection that are >= fullPercent of the size limit AND have not
    been written for quietFor: full and cold."""
    doc = env.master_get("/dir/status")
    limit_b = doc.get("VolumeSizeLimitMB", 30 * 1024) * (1 << 20)
    threshold = limit_b * full_percent / 100.0
    now = time.time()
    vids: set[int] = set()
    for dc in doc["Topology"]["DataCenters"]:
        for rack in dc["Racks"]:
            for n in rack["DataNodes"]:
                for v in n.get("VolumeInfos", []):
                    if (v.get("collection", "") == collection
                            and v.get("size", 0) >= threshold
                            and now - v.get("modified_at", 0)
                            >= quiet_seconds):
                        vids.add(v["id"])
    return sorted(vids)


@command("ec.encode")
def cmd_ec_encode(env: CommandEnv, flags: dict) -> str:
    """ec.encode -volumeId <id> | -collection c [-fullPercent 95]
    [-quietFor 3600] [-engine tpu|cpu]
    # erasure-code a volume, or every full and quiet volume of a
    # collection (command_ec_encode.go:95-184, candidates :267-298)"""
    env.confirm_is_locked()
    collection = flags.get("collection", "")
    engine = flags.get("engine", "tpu")
    if "volumeId" in flags:
        vids = [int(flags["volumeId"])]
    else:
        vids = _ec_encode_candidates(
            env, collection, float(flags.get("fullPercent", "95")),
            float(flags.get("quietFor", "3600")))
        if not vids:
            return "no full+quiet volumes to encode"
    # per-volume isolation: each encode deletes its original, so a
    # failure mid-batch must not swallow the record of those converted
    lines = []
    for vid in vids:
        try:
            lines.append(_ec_encode_one(env, vid, collection, engine))
        except Exception as e:  # noqa: BLE001 - keep the audit trail
            lines.append(f"ec.encode volume {vid} FAILED: {e}")
    return "\n".join(lines)


def _ec_encode_one(env: CommandEnv, vid: int, collection: str,
                   engine: str) -> str:
    locations = env.master.lookup(vid)
    if not locations:
        raise RuntimeError(f"volume {vid} not found")
    source = locations[0]
    t0 = time.perf_counter()
    # 1. mark all replicas readonly (markVolumeReplicasWritable false)
    for url in locations:
        env.volume_post(url, "/admin/readonly",
                        {"volume_id": vid, "readonly": True})
    # 2. generate shards on the source replica
    env.volume_post(source, "/admin/ec/generate",
                    {"volume_id": vid, "collection": collection,
                     "engine": engine})
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # 3. spread shards with round-robin free-slot allocation
    alloc = _balanced_distribution(_ec_nodes(env), TOTAL_SHARDS_COUNT)
    for target, shard_ids in alloc.items():
        if target != source:
            env.volume_post(target, "/admin/ec/copy", {
                "volume_id": vid, "collection": collection,
                "shard_ids": shard_ids, "source_data_node": source,
            })
        env.volume_post(target, "/admin/ec/mount",
                        {"volume_id": vid, "collection": collection})
    # 4. delete shards the source no longer owns, then the original volume
    keep = set(alloc.get(source, []))
    drop = [s for s in range(TOTAL_SHARDS_COUNT) if s not in keep]
    if drop:
        env.volume_post(source, "/admin/ec/delete",
                        {"volume_id": vid, "collection": collection,
                         "shard_ids": drop})
        if keep:
            env.volume_post(source, "/admin/ec/mount",
                            {"volume_id": vid, "collection": collection})
    for url in locations:
        env.volume_post(url, "/admin/delete_volume", {"volume_id": vid})
    coord.PlanExecutor(env.volume_post).refresh_heartbeats(
        set(alloc) | set(locations))
    env.master.invalidate(vid)
    spread_s = time.perf_counter() - t0
    return (f"ec encoded volume {vid} via {engine} engine; shards: {alloc}; "
            f"generate {generate_s:.3f} s, spread {spread_s:.3f} s")


@command("ec.rebuild")
def cmd_ec_rebuild(env: CommandEnv, flags: dict) -> str:
    """ec.rebuild [-volumeId <id>] [-engine tpu|cpu]
    # regenerate missing EC shards on the best-placed host and spread
    # them rack-aware, through ops/coordinator.py's planner and executor
    # (command_ec_rebuild.go)"""
    env.confirm_is_locked()
    engine = flags.get("engine", "tpu")
    view = coord.view_from_status(env.topology())
    vids = ([int(flags["volumeId"])] if "volumeId" in flags
            else sorted(view.shards))
    ex = coord.PlanExecutor(post_fn=env.volume_post)
    results = []
    for vid in vids:
        present = view.present_shards(vid)
        if len(present) >= TOTAL_SHARDS_COUNT:
            results.append(f"volume {vid}: all shards present")
            continue
        if len(present) < 10:
            results.append(f"volume {vid}: unrepairable, only "
                           f"{len(present)} shards")
            continue
        try:
            res = ex.execute_repair(view, vid, engine=engine)
        except Exception as e:  # noqa: BLE001 - per-volume audit trail
            results.append(f"volume {vid}: rebuild FAILED: {e}")
            continue
        env.master.invalidate(vid)
        line = (f"volume {vid}: rebuilt shards {res['rebuilt']} "
                f"on {res['host']}")
        if res["moves"]:
            line += "; spread " + ", ".join(
                f"{sid}->{dst}" for sid, dst in res["moves"])
        line += "; " + ", ".join(f"{leg} {s:.3f} s"
                                 for leg, s in res["seconds"].items())
        results.append(line)
    return "\n".join(results)


@command("ec.balance")
def cmd_ec_balance(env: CommandEnv, flags: dict) -> str:
    """ec.balance [-maxMoves N]
    # dedupe duplicate shard copies, fix rack-diversity violations and
    # spread shards evenly, with the planner ec.rebuild uses
    # (command_ec_balance.go)"""
    env.confirm_is_locked()
    view = coord.view_from_status(env.topology())
    plan = coord.plan_rebalance(coord.clone_view(view),
                                max_moves=int(flags.get("maxMoves", 0)))
    ex = coord.PlanExecutor(post_fn=env.volume_post)
    lines = []
    touched: set[str] = set()
    for mv in plan:
        try:
            ex.execute_move(view, mv)
        except Exception as e:  # noqa: BLE001 - per-move audit trail
            lines.append(f"move {mv.vid}.{mv.sid} {mv.src} -> "
                         f"{mv.dst} FAILED: {e}")
            continue
        if mv.kind == "dedupe":
            lines.append(f"dedupe {mv.vid}.{mv.sid} from {mv.src}")
            touched.add(mv.src)
        else:
            lines.append(f"move {mv.vid}.{mv.sid} {mv.src} -> {mv.dst}"
                         f" ({mv.reason})")
            touched.update((mv.src, mv.dst))
    if touched:
        ex.refresh_heartbeats(touched)
    return "\n".join(lines) or "already balanced"


def _data_node_urls(env: CommandEnv) -> list[str]:
    return [n["Url"] for dc in env.topology()["DataCenters"]
            for rack in dc["Racks"] for n in rack["DataNodes"]]


def _scrub_start_body(flags: dict) -> dict:
    body: dict = {}
    if "rate" in flags:
        body["rate_mb_s"] = float(flags["rate"])
    if "interval" in flags:
        body["interval_s"] = float(flags["interval"])
    if flags.get("backfill") == "true":
        body["backfill"] = True
    return body


def _scrub_all(env: CommandEnv, flags: dict) -> str:
    """ec.scrub -all: one scrub pass on every registered volume server,
    polled to completion, the verdicts rolled up."""
    servers = sorted(_data_node_urls(env))
    if not servers:
        return "no volume servers registered"
    body = _scrub_start_body(flags)
    body.setdefault("interval_s", 0.0)  # one pass then stop
    lines = []
    started: list[str] = []
    failed: list[str] = []
    for url in servers:
        try:
            env.volume_post(url, "/ec/scrub/start", body, timeout=30)
            started.append(url)
        except Exception as e:  # noqa: BLE001 - per-server audit trail
            failed.append(url)
            lines.append(f"{url}: START FAILED {e}")
    deadline = time.monotonic() + float(flags.get("timeout", "300"))
    pending = set(started)
    statuses: dict[str, dict] = {}
    while pending and time.monotonic() < deadline:
        for url in sorted(pending):
            try:
                st = http_json("GET", f"http://{url}/ec/scrub/status",
                               timeout=30)
            except Exception:  # noqa: BLE001 - polled until the deadline
                continue
            statuses[url] = st
            if not st.get("running"):
                pending.discard(url)
        if pending:
            time.sleep(0.25)
    totals = {"volumes": 0, "corrupt": 0, "repairs": 0, "unrepairable": 0}
    for url in started:
        st = statuses.get(url, {})
        verdicts = st.get("verdicts", {})
        t = st.get("totals", {})
        unrep = sum(1 for d in verdicts.values()
                    if (d or {}).get("status") == "unrepairable")
        totals["volumes"] += len(verdicts)
        totals["corrupt"] += int(t.get("corrupt_shards", 0))
        totals["repairs"] += int(t.get("scrub_repairs", 0))
        totals["unrepairable"] += unrep
        state = "TIMED OUT (still running)" if url in pending else "done"
        lines.append(f"{url}: {state} volumes={len(verdicts)} "
                     f"corrupt={t.get('corrupt_shards', 0)} "
                     f"repairs={t.get('scrub_repairs', 0)} "
                     f"unrepairable={unrep}")
        for v, d in sorted(verdicts.items()):
            if (d or {}).get("status") not in ("clean", None):
                lines.append(f"  volume {v}: {d.get('status')}"
                             f" corrupt_shards={d.get('corrupt_shards', [])}")
    # an unreachable server is unverified: a partial scrub must never
    # read as a clean cluster
    verdict = "DEGRADED" if (totals["unrepairable"] or pending
                             or failed) else (
        "repaired" if totals["repairs"] else "clean")
    if failed:
        verdict += f" (UNVERIFIED: {len(failed)} server(s) not scrubbed)"
    lines.insert(0, f"cluster scrub: {verdict} — "
                    f"{len(started)}/{len(servers)} servers, "
                    f"{totals['volumes']} volumes, "
                    f"corrupt={totals['corrupt']} "
                    f"repairs={totals['repairs']} "
                    f"unrepairable={totals['unrepairable']}")
    try:
        health = env.master_get("/cluster/health")
        lines.append(f"/cluster/health: degraded={health['degraded']} "
                     f"scrub_unrepairable="
                     f"{health['totals'].get('scrub_unrepairable', 0)}")
    except Exception as e:  # noqa: BLE001 - the rollup stands alone
        lines.append(f"/cluster/health: unavailable ({e})")
    return "\n".join(lines)


@command("ec.scrub")
def cmd_ec_scrub(env: CommandEnv, flags: dict) -> str:
    """ec.scrub [-all [-timeout 300]] [-server host:port]
    [-action start|stop|status] [-rate 64] [-interval 0] [-backfill]
    # drive the volume servers' EC bit-rot scrubbers (/ec/scrub routes):
    # start launches a paced sidecar-verification scan (rate MB/s,
    # interval seconds between passes, -backfill adopts pre-sidecar
    # volumes); corrupt shards are quarantined to .ecNN.bad and rebuilt
    # while >= 10 clean shards remain.  -all runs one pass on every
    # registered server, polls to completion and rolls the verdicts up"""
    if flags.get("all") == "true":
        return _scrub_all(env, flags)
    action = flags.get("action", "status")
    if action not in ("start", "stop", "status"):
        raise ValueError(f"unknown -action {action!r}")
    servers = [flags["server"]] if "server" in flags else _data_node_urls(env)
    if not servers:
        return "no volume servers registered"
    lines = []
    for url in sorted(servers):
        try:
            if action == "status":
                st = http_json("GET", f"http://{url}/ec/scrub/status",
                               timeout=30)
            else:
                body = _scrub_start_body(flags) if action == "start" else {}
                st = env.volume_post(url, f"/ec/scrub/{action}", body,
                                     timeout=30)
        except Exception as e:  # noqa: BLE001 - per-server audit trail
            lines.append(f"{url}: ERROR {e}")
            continue
        verdicts = st.get("verdicts", {})
        bad = {v: d for v, d in verdicts.items()
               if d.get("status") not in ("clean", None)}
        totals = st.get("totals", {})
        lines.append(
            f"{url}: running={st.get('running')} paused={st.get('paused')} "
            f"passes={st.get('passes')} cursor={st.get('cursor')} "
            f"volumes={len(verdicts)} "
            f"blocks={totals.get('scrub_blocks', 0)} "
            f"corrupt={totals.get('corrupt_shards', 0)} "
            f"repairs={totals.get('scrub_repairs', 0)}")
        for v, d in sorted(bad.items()):
            lines.append(f"  volume {v}: {d.get('status')}"
                         f" corrupt_shards={d.get('corrupt_shards', [])}"
                         + (f" error={d['error']}" if d.get("error") else ""))
    return "\n".join(lines)


@command("ec.decode")
def cmd_ec_decode(env: CommandEnv, flags: dict) -> str:
    """ec.decode -volumeId <id>
    # convert an EC volume back to a normal volume (command_ec_decode.go)"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    info = env.master_get(f"/dir/lookup_ec?volumeId={vid}")
    collection = info.get("collection", "")
    shard_map = {int(s): urls for s, urls in info.get("shards", {}).items()}

    # the server already holding the most shards
    holder_counts: dict[str, int] = {}
    for sid, urls in shard_map.items():
        for u in urls:
            holder_counts[u] = holder_counts.get(u, 0) + 1
    if not holder_counts:
        raise RuntimeError(f"ec volume {vid} has no shards")
    target = max(holder_counts, key=holder_counts.get)

    # collect the data shards (0..9) it lacks
    for sid in range(10):
        holders = shard_map.get(sid, [])
        if not holders:
            raise RuntimeError(f"data shard {sid} lost; run ec.rebuild first")
        if target not in holders:
            env.volume_post(target, "/admin/ec/copy", {
                "volume_id": vid, "collection": collection,
                "shard_ids": [sid], "source_data_node": holders[0]})
    env.volume_post(target, "/admin/ec/to_volume",
                    {"volume_id": vid, "collection": collection})
    # drop the ec shards everywhere else
    for url in sorted({u for urls in shard_map.values() for u in urls}):
        if url != target:
            env.volume_post(url, "/admin/ec/delete", {
                "volume_id": vid, "collection": collection,
                "shard_ids": list(range(TOTAL_SHARDS_COUNT))})
    coord.PlanExecutor(env.volume_post).refresh_heartbeats(
        set(holder_counts) | {target})
    env.master.invalidate(vid)
    return f"decoded ec volume {vid} back to a normal volume on {target}"
