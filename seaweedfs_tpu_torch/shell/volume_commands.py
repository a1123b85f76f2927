"""Volume maintenance commands: copy/move/delete/balance/fix.replication/fsck.

The port's copy of seaweedfs_tpu/shell/volume_commands.py (weed/shell/
command_volume_copy.go, _move.go, _delete.go, _balance.go,
_fix_replication.go, _fsck.go, command_collection_delete.go,
command_volume_server_evacuate.go, _check_disk.go,
_configure_replication.go, _delete_empty.go, _server_leave.go,
command_volume_tier_upload.go, _download.go, _move.go), with its flags and
output lines.  ``collection.delete`` drops the collection's volumes, not
its EC shards, as the reference's does.  One difference:
``volume.server.evacuate`` names the collection in its
``/admin/ec/delete`` calls as well.
"""

from __future__ import annotations

import time

from ..storage.super_block import ReplicaPlacement
from .commands import CommandEnv, command


def _nodes_with_volumes(env: CommandEnv) -> list[dict]:
    topo = env.topology()
    return [n for dc in topo["DataCenters"] for rack in dc["Racks"]
            for n in rack["DataNodes"]]


def _volume_locations(env: CommandEnv, vid: int) -> list[str]:
    env.master.invalidate(vid)
    return env.master.lookup(vid)


def _collection_of(env: CommandEnv, vid: int) -> str:
    for layout in env.topology().get("Layouts", []):
        if vid in layout.get("volumes", []):
            return layout.get("collection", "")
    return ""


@command("volume.copy")
def cmd_volume_copy(env: CommandEnv, flags: dict) -> str:
    """volume.copy -volumeId <id> -source <host:port> -target <host:port>
    # copy a volume replica between servers"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    collection = flags.get("collection")
    if collection is None:
        collection = _collection_of(env, vid)
    env.volume_post(flags["target"], "/admin/volume_copy", {
        "volume_id": vid, "collection": collection,
        "source_data_node": flags["source"]})
    env.volume_post(flags["target"], "/admin/heartbeat_now", {}, timeout=30)
    return f"copied volume {vid} from {flags['source']} to {flags['target']}"


@command("volume.move")
def cmd_volume_move(env: CommandEnv, flags: dict) -> str:
    """volume.move -volumeId <id> -source <host:port> -target <host:port>
    # copy then delete from the source (crash-safe ordering)"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    cmd_volume_copy(env, flags)
    env.volume_post(flags["source"], "/admin/delete_volume", {"volume_id": vid})
    env.volume_post(flags["source"], "/admin/heartbeat_now", {}, timeout=30)
    env.master.invalidate(vid)
    return f"moved volume {vid} from {flags['source']} to {flags['target']}"


@command("volume.delete")
def cmd_volume_delete(env: CommandEnv, flags: dict) -> str:
    """volume.delete -volumeId <id> [-node <host:port>]
    # delete a volume replica (or all replicas if -node omitted)"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    targets = [flags["node"]] if "node" in flags else _volume_locations(env, vid)
    for url in targets:
        env.volume_post(url, "/admin/delete_volume", {"volume_id": vid})
        env.volume_post(url, "/admin/heartbeat_now", {}, timeout=30)
    env.master.invalidate(vid)
    return f"deleted volume {vid} on {targets}"


@command("volume.mount")
def cmd_volume_mount(env: CommandEnv, flags: dict) -> str:
    """volume.mount -volumeId <id> -node <host:port>"""
    env.confirm_is_locked()
    env.volume_post(flags["node"], "/admin/mount",
                    {"volume_id": int(flags["volumeId"])})
    env.volume_post(flags["node"], "/admin/heartbeat_now", {}, timeout=30)
    return "mounted"


@command("volume.unmount")
def cmd_volume_unmount(env: CommandEnv, flags: dict) -> str:
    """volume.unmount -volumeId <id> -node <host:port>"""
    env.confirm_is_locked()
    env.volume_post(flags["node"], "/admin/unmount",
                    {"volume_id": int(flags["volumeId"])})
    env.volume_post(flags["node"], "/admin/heartbeat_now", {}, timeout=30)
    return "unmounted"


@command("volume.mark")
def cmd_volume_mark(env: CommandEnv, flags: dict) -> str:
    """volume.mark -volumeId <id> -node <host:port> [-writable|-readonly]"""
    env.confirm_is_locked()
    readonly = "writable" not in flags
    env.volume_post(flags["node"], "/admin/readonly",
                    {"volume_id": int(flags["volumeId"]),
                     "readonly": readonly})
    return f"marked {'readonly' if readonly else 'writable'}"


@command("volume.balance")
def cmd_volume_balance(env: CommandEnv, flags: dict) -> str:
    """volume.balance [-force]
    # move volumes from overloaded to underloaded servers
    (command_volume_balance.go simplified: even out volume counts)"""
    env.confirm_is_locked()
    nodes = _nodes_with_volumes(env)
    if not nodes:
        return "no servers"
    counts = {n["Url"]: len(n["VolumeIds"]) for n in nodes}
    vol_map = {n["Url"]: list(n["VolumeIds"]) for n in nodes}
    avg = sum(counts.values()) / len(counts)
    moves = []
    for src in sorted(counts, key=counts.get, reverse=True):
        while counts[src] > avg + 0.5 and vol_map[src]:
            dst = min(counts, key=counts.get)
            if counts[dst] >= avg:
                break
            # pick a volume the destination doesn't already hold
            candidates = [v for v in vol_map[src]
                          if v not in vol_map.get(dst, [])]
            if not candidates:
                break
            vid = candidates[0]
            cmd_volume_move(env, {"volumeId": str(vid), "source": src,
                                  "target": dst})
            vol_map[src].remove(vid)
            vol_map[dst].append(vid)
            counts[src] -= 1
            counts[dst] += 1
            moves.append(f"{vid}: {src} -> {dst}")
    return "\n".join(moves) or "already balanced"


@command("volume.fix.replication")
def cmd_fix_replication(env: CommandEnv, flags: dict) -> str:
    """volume.fix.replication
    # re-replicate under-replicated volumes to meet their placement"""
    env.confirm_is_locked()
    topo = env.topology()
    nodes = _nodes_with_volumes(env)
    actions = []
    # volume -> holders
    holders: dict[int, list[str]] = {}
    for n in nodes:
        for vid in n["VolumeIds"]:
            holders.setdefault(vid, []).append(n["Url"])
    for layout in topo.get("Layouts", []):
        rp = ReplicaPlacement.parse(layout["replication"] or "000")
        want = rp.copy_count
        for vid in layout.get("volumes", []):
            have = holders.get(vid, [])
            if 0 < len(have) < want:
                targets = [n["Url"] for n in nodes
                           if n["Url"] not in have and n["Free"] > 0]
                for target in targets[: want - len(have)]:
                    cmd_volume_copy(env, {
                        "volumeId": str(vid), "source": have[0],
                        "target": target,
                        "collection": layout.get("collection", "")})
                    actions.append(f"replicated {vid} -> {target}")
    return "\n".join(actions) or "all volumes sufficiently replicated"


@command("volume.fsck")
def cmd_volume_fsck(env: CommandEnv, flags: dict) -> str:
    """volume.fsck [-volumeId <id>]
    # scan volumes, verify needle CRCs against the index"""
    nodes = _nodes_with_volumes(env)
    lines = []
    for n in nodes:
        for vid in n["VolumeIds"]:
            if "volumeId" in flags and vid != int(flags["volumeId"]):
                continue
            r = env.volume_post(n["Url"], "/admin/volume_check",
                                {"volume_id": vid})
            status = "OK" if r["crc_errors"] == 0 else "CORRUPT"
            lines.append(f"volume {vid} @ {n['Url']}: indexed={r['indexed']} "
                         f"live={r['scanned_live']} crc_errors={r['crc_errors']} "
                         f"{status}")
    return "\n".join(lines) or "no volumes"


@command("collection.delete")
def cmd_collection_delete(env: CommandEnv, flags: dict) -> str:
    """collection.delete -collection <name>
    # delete every volume of a collection"""
    env.confirm_is_locked()
    name = flags["collection"]
    topo = env.topology()
    deleted = []
    for layout in topo.get("Layouts", []):
        if layout["collection"] != name:
            continue
        # "volumes" is the full vid list; "writables" would miss full or
        # readonly volumes and leave their data behind
        for vid in layout.get("volumes", layout.get("writables", [])):
            for url in _volume_locations(env, vid):
                env.volume_post(url, "/admin/delete_volume", {"volume_id": vid})
            deleted.append(vid)
    for n in _nodes_with_volumes(env):
        env.volume_post(n["Url"], "/admin/heartbeat_now", {}, timeout=30)
    return f"deleted collection {name}: volumes {deleted}"


@command("volume.server.evacuate")
def cmd_evacuate(env: CommandEnv, flags: dict) -> str:
    """volume.server.evacuate -node <host:port>
    # move every volume + ec shard off a server before decommissioning"""
    env.confirm_is_locked()
    node = flags["node"]
    nodes = _nodes_with_volumes(env)
    me = next((n for n in nodes if n["Url"] == node), None)
    if me is None:
        raise RuntimeError(f"{node} not found in topology")
    others = [n for n in nodes if n["Url"] != node and n["Free"] > 0]
    if not others:
        raise RuntimeError("no destination servers with free slots")
    # urls that already hold each volume (skip as destinations)
    holders: dict[int, set[str]] = {}
    for n in nodes:
        for vid in n["VolumeIds"]:
            holders.setdefault(vid, set()).add(n["Url"])
    moves = []
    for i, vid in enumerate(list(me["VolumeIds"])):
        candidates = [n for n in others
                      if n["Url"] not in holders.get(vid, set())]
        if not candidates:
            moves.append(f"volume {vid}: no replica-free destination, skipped")
            continue
        dst = candidates[i % len(candidates)]["Url"]
        cmd_volume_move(env, {"volumeId": str(vid), "source": node,
                              "target": dst})
        moves.append(f"volume {vid} -> {dst}")
    # ec shards — carry the collection, or the target re-registers the
    # shard under the default collection and scoped ops miss it; the
    # delete carries it too (the reference's sends none, and the source's
    # remount of its other shards then looks outside the collection and
    # fails)
    topo = env.topology()
    info = topo.get("EcVolumes", {})
    ec_collections = topo.get("EcCollections", {})
    for vid_str, shards in info.items():
        collection = ec_collections.get(vid_str, "")
        for sid, urls in shards.items():
            if node not in urls:
                continue
            dst = others[int(sid) % len(others)]["Url"]
            env.volume_post(dst, "/admin/ec/copy", {
                "volume_id": int(vid_str), "shard_ids": [int(sid)],
                "collection": collection, "source_data_node": node})
            env.volume_post(dst, "/admin/ec/mount", {
                "volume_id": int(vid_str), "collection": collection})
            env.volume_post(node, "/admin/ec/delete",
                            {"volume_id": int(vid_str), "shard_ids": [int(sid)],
                             "collection": collection})
            moves.append(f"ec {vid_str}.{sid} -> {dst}")
    for n in nodes:
        env.volume_post(n["Url"], "/admin/heartbeat_now", {}, timeout=30)
    return "\n".join(moves) or "nothing to evacuate"


@command("volume.tier.upload")
def cmd_tier_upload(env: CommandEnv, flags: dict) -> str:
    """volume.tier.upload -volumeId <id> [-dest <backend>] [-keepLocalDatFile]
    # move a volume's .dat to a tiered backend (command_volume_tier_upload.go)"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    backend = flags.get("dest", "s3.default")
    results = []
    for url in _volume_locations(env, vid):
        r = env.volume_post(url, "/admin/tier_upload", {
            "volume_id": vid, "backend": backend,
            "keep_local": "keepLocalDatFile" in flags})
        results.append(f"{url}: {r['remote']}")
    if not results:
        raise RuntimeError(f"volume {vid} has no locations")
    return "\n".join(results)


@command("volume.tier.download")
def cmd_tier_download(env: CommandEnv, flags: dict) -> str:
    """volume.tier.download -volumeId <id>
    # bring a tiered volume's .dat back to local disk"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    urls = _volume_locations(env, vid)
    if not urls:
        raise RuntimeError(f"volume {vid} has no locations")
    for url in urls:
        env.volume_post(url, "/admin/tier_download", {"volume_id": vid})
    return f"volume {vid} downloaded on {', '.join(urls)}"


@command("volume.tier.move")
def cmd_tier_move(env: CommandEnv, flags: dict) -> str:
    """volume.tier.move -volumeId <id> -dest <backend>
    # tier.upload without keeping the local copy"""
    flags.pop("keepLocalDatFile", None)
    return cmd_tier_upload(env, flags)


@command("volume.check.disk")
def cmd_volume_check_disk(env: CommandEnv, flags: dict) -> str:
    """volume.check.disk [-volumeId <id>]
    # compare replicas of each volume pairwise and report divergence
    (command_volume_check_disk.go syncs missing needles; here divergent
    replicas are reported for volume.fix.replication to rebuild)"""
    nodes = _nodes_with_volumes(env)
    holders: dict[int, list[str]] = {}
    for n in nodes:
        for vid in n["VolumeIds"]:
            holders.setdefault(vid, []).append(n["Url"])
    lines = []
    for vid, urls in sorted(holders.items()):
        if "volumeId" in flags and vid != int(flags["volumeId"]):
            continue
        if len(urls) < 2:
            continue
        counts = {}
        for url in urls:
            r = env.volume_post(url, "/admin/volume_check",
                                {"volume_id": vid})
            counts[url] = (r["indexed"], r["crc_errors"])
        distinct = {c for c, _ in counts.values()}
        corrupt = any(errs for _, errs in counts.values())
        state = "DIVERGED" if len(distinct) != 1 \
            else ("CORRUPT" if corrupt else "in sync")
        lines.append(f"volume {vid}: " + ", ".join(
            f"{u}={c[0]} needles,{c[1]} crc_errors"
            for u, c in counts.items()) + f" [{state}]")
    return "\n".join(lines) or "no replicated volumes"


@command("volume.configure.replication")
def cmd_configure_replication(env: CommandEnv, flags: dict) -> str:
    """volume.configure.replication -volumeId <id> -replication <xyz>
    # rewrite a volume's replica placement in its superblock"""
    env.confirm_is_locked()
    vid = int(flags["volumeId"])
    rp = flags["replication"]
    ReplicaPlacement.parse(rp)  # validate before touching servers
    urls = _volume_locations(env, vid)
    if not urls:
        raise RuntimeError(f"volume {vid} has no locations")
    for url in urls:
        env.volume_post(url, "/admin/configure_replication",
                        {"volume_id": vid, "replication": rp})
    return f"volume {vid} replication set to {rp} on {', '.join(urls)}"


@command("volume.deleteEmpty")
def cmd_volume_delete_empty(env: CommandEnv, flags: dict) -> str:
    """volume.deleteEmpty [-quietFor 86400] [-force]
    # delete volumes that hold no live data (command_volume_delete_empty.go)"""
    env.confirm_is_locked()
    quiet_for = float(flags.get("quietFor", "86400"))
    deleted = []
    nodes = _nodes_with_volumes(env)
    for n in nodes:
        for v in n.get("VolumeInfos", []):
            vid = v["id"]
            live = v.get("file_count", 0) - v.get("delete_count", 0)
            quiet = time.time() - v.get("modified_at", 0) >= quiet_for
            if live <= 0 and (quiet or "force" in flags):
                env.volume_post(n["Url"], "/admin/delete_volume",
                                {"volume_id": vid})
                deleted.append(f"{vid}@{n['Url']}")
    if deleted:
        for n in nodes:
            env.volume_post(n["Url"], "/admin/heartbeat_now", {},
                            timeout=30)
    return f"deleted empty volumes: {deleted}" if deleted \
        else "no empty volumes"


@command("volume.server.leave")
def cmd_volume_server_leave(env: CommandEnv, flags: dict) -> str:
    """volume.server.leave -node <host:port>
    # ask a volume server to stop heartbeating and detach from the cluster
    (command_volume_server_leave.go; data stays on disk)"""
    env.confirm_is_locked()
    node = flags["node"]
    env.volume_post(node, "/admin/leave", {})
    return f"{node} left the cluster (process still running; data intact)"
