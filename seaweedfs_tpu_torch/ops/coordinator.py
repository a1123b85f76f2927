"""EC repair and rebalance planning, and the executor of its plans.

The port's copy of the planner and executor of seaweedfs_tpu/ops/
coordinator.py, which the shell's ec.rebuild and ec.balance drive:

  ClusterView + planner   pure functions over a neutral topology snapshot
                          (the master's /dir/status document): clean-shard
                          deficits, a rack/DC-aware placement ranking
                          (volume growth's same-rack / other-rack /
                          other-DC tiers), the rebuild host, and dedupe /
                          rack-diversity / skew rebalance plans.
  PlanExecutor            the HTTP legs (/admin/ec/copy -> mount ->
                          delete, /admin/ec/rebuild), with the transport
                          injected (the shell passes CommandEnv's).

EC work is asked of the servers' own engine, ``"tpu"`` by default: a
card server refuses ``"cpu"`` (the reference's default), a CPU server
takes either.

Not ported: the master's autonomous ``EcCoordinator`` loop, the targeted
re-scrub after a repair (``rescrub``, it needs the scrub routes), and
the fault-injection points.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..ec.layout import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT


@dataclass
class NodeView:
    url: str
    rack: str = "DefaultRack"
    dc: str = "DefaultDataCenter"
    free: float = 0.0
    ec_shards: int = 0
    alive: bool = True

    @property
    def rack_key(self) -> tuple[str, str]:
        # racks are only unique within a DC: placement diversity keys on
        # the (dc, rack) pair
        return (self.dc, self.rack)


@dataclass
class ClusterView:
    """vid -> shard id -> holder urls, plus per-node rack/DC/load."""
    nodes: dict[str, NodeView] = field(default_factory=dict)
    shards: dict[int, dict[int, list[str]]] = field(default_factory=dict)
    collections: dict[int, str] = field(default_factory=dict)

    def alive_holders(self, vid: int, sid: int) -> list[str]:
        return [u for u in self.shards.get(vid, {}).get(sid, [])
                if self.nodes.get(u) and self.nodes[u].alive]

    def present_shards(self, vid: int) -> set[int]:
        """Shard ids with at least one ALIVE holder: the clean-shard set
        the deficit math runs on."""
        return {sid for sid in self.shards.get(vid, {})
                if self.alive_holders(vid, sid)}

    def rack_counts(self, vid: int) -> dict[tuple, int]:
        """(dc, rack) -> how many of this volume's shards it holds."""
        out: dict[tuple, int] = {}
        for sid in self.shards.get(vid, {}):
            for url in self.alive_holders(vid, sid):
                key = self.nodes[url].rack_key
                out[key] = out.get(key, 0) + 1
        return out

    def racks(self) -> set[tuple]:
        return {n.rack_key for n in self.nodes.values() if n.alive}


def view_from_status(topology_doc: dict,
                     stale: tuple = ()) -> ClusterView:
    """A view from the master's /dir/status Topology document; ``stale``
    names servers that must not count as holders or targets."""
    view = ClusterView()
    for dc in topology_doc.get("DataCenters", []):
        for rack in dc.get("Racks", []):
            for n in rack.get("DataNodes", []):
                view.nodes[n["Url"]] = NodeView(
                    url=n["Url"], rack=rack.get("Id", "DefaultRack"),
                    dc=dc.get("Id", "DefaultDataCenter"),
                    free=float(n.get("Free", 0)),
                    ec_shards=int(n.get("EcShards", 0)),
                    alive=n["Url"] not in stale)
    for vid_str, shard_map in topology_doc.get("EcVolumes", {}).items():
        view.shards[int(vid_str)] = {
            int(sid): list(urls) for sid, urls in shard_map.items()}
    for vid_str, coll in topology_doc.get("EcCollections", {}).items():
        view.collections[int(vid_str)] = coll
    return view


def clone_view(view: ClusterView) -> ClusterView:
    """Deep-enough copy for planning: plan_rebalance simulates moves
    forward on the view it plans over, so execution needs the original
    holder state to drive the real mount/unmount decisions."""
    return ClusterView(
        nodes={u: NodeView(**vars(n)) for u, n in view.nodes.items()},
        shards={vid: {s: list(us) for s, us in m.items()}
                for vid, m in view.shards.items()},
        collections=dict(view.collections))


@dataclass
class Move:
    """One planned shard movement.  kind: 'move' relocates src -> dst,
    'dedupe' drops a duplicate copy from src (dst empty)."""
    vid: int
    sid: int
    src: str
    dst: str = ""
    kind: str = "move"
    reason: str = "skew"


def clean_deficits(view: ClusterView) -> dict[int, dict]:
    """Per-volume repair need: {vid: {clean, deficit, critical,
    under_replicated}}.  Under-replicated below k+1 clean shards,
    critical below k; any volume short of all 14 carries a deficit."""
    out: dict[int, dict] = {}
    for vid in view.shards:
        clean = len(view.present_shards(vid))
        if clean >= TOTAL_SHARDS_COUNT:
            continue
        out[vid] = {"clean": clean, "deficit": TOTAL_SHARDS_COUNT - clean,
                    "critical": clean < DATA_SHARDS_COUNT,
                    "under_replicated": clean < DATA_SHARDS_COUNT + 1}
    return out


def placement_rank(view: ClusterView, vid: int, sid: int) -> list[str]:
    """Candidate targets for one shard, best first: a rack not yet
    holding this volume's shards beats one that does, a fresh DC breaks
    ties, then fewest EC shards and most free slots, then the url."""
    holders = set(view.shards.get(vid, {}).get(sid, []))
    rack_counts = view.rack_counts(vid)
    dc_counts: dict[str, int] = {}
    for key, c in rack_counts.items():
        dc_counts[key[0]] = dc_counts.get(key[0], 0) + c
    cands = [n for n in view.nodes.values()
             if n.alive and n.url not in holders]
    cands.sort(key=lambda n: (
        rack_counts.get(n.rack_key, 0),    # rack diversity first
        dc_counts.get(n.dc, 0),            # then DC diversity
        n.free <= 0,                       # full nodes last
        n.ec_shards,                       # then least-loaded
        -n.free,
        n.url))                            # deterministic tie-break
    return [n.url for n in cands]


def choose_rebuild_host(view: ClusterView, vid: int) -> Optional[str]:
    """The server to rebuild on: already holds the most clean shards of
    this volume (fewest survivor copies over the wire), then most free
    slots, then least loaded.  None when no alive node exists."""
    local_counts: dict[str, int] = {}
    for sid in view.shards.get(vid, {}):
        for url in view.alive_holders(vid, sid):
            local_counts[url] = local_counts.get(url, 0) + 1
    cands = [n for n in view.nodes.values() if n.alive]
    if not cands:
        return None
    cands.sort(key=lambda n: (-local_counts.get(n.url, 0),
                              -n.free, n.ec_shards, n.url))
    return cands[0].url


def rack_ceiling(view: ClusterView) -> int:
    """Max shards of one volume a single rack may hold: losing any one
    rack must leave >= k shards, relaxed to an even split when the
    cluster has too few racks to afford it."""
    n_racks = max(1, len(view.racks()))
    return max(TOTAL_SHARDS_COUNT - DATA_SHARDS_COUNT,
               -(-TOTAL_SHARDS_COUNT // n_racks))


def plan_rebalance(view: ClusterView, max_moves: int = 0) -> list[Move]:
    """Dedupe duplicate shard copies, fix rack-diversity violations,
    then tighten server shard-count skew.  Pure planning over the view
    (node counters are simulated forward as moves are planned);
    max_moves > 0 bounds the move/dedupe total."""
    moves: list[Move] = []
    counts = {u: n.ec_shards for u, n in view.nodes.items()}

    def budget_left() -> bool:
        return not max_moves or len(moves) < max_moves

    # per-node ceiling for one volume's shards: never more than an even
    # split's share
    alive_n = max(1, sum(1 for n in view.nodes.values() if n.alive))
    node_vid_ceiling = -(-TOTAL_SHARDS_COUNT // alive_n)

    def _vid_held(vid: int, url: str) -> int:
        return sum(1 for us in view.shards.get(vid, {}).values()
                   if url in us)

    # 1. dedupe: keep the copy on the least-loaded holder
    for vid in sorted(view.shards):
        for sid, holders in sorted(view.shards[vid].items()):
            alive = [u for u in holders
                     if view.nodes.get(u) and view.nodes[u].alive]
            if len(alive) <= 1:
                continue
            keep = min(alive, key=lambda u: (counts.get(u, 0), u))
            for url in alive:
                if url == keep or not budget_left():
                    continue
                moves.append(Move(vid, sid, url, kind="dedupe",
                                  reason="dedupe"))
                counts[url] = counts.get(url, 1) - 1
                view.nodes[url].ec_shards = max(
                    0, view.nodes[url].ec_shards - 1)
                view.shards[vid][sid] = [keep]

    # 2. rack diversity: drain racks holding more of a volume than the
    #    ceiling allows toward the least-represented racks
    ceiling = rack_ceiling(view)
    for vid in sorted(view.shards):
        rack_counts = view.rack_counts(vid)
        for key in sorted(rack_counts, key=lambda kk: -rack_counts[kk]):
            while rack_counts[key] > ceiling and budget_left():
                src_sid, src_url = _pick_rack_excess(view, vid, key)
                if src_sid is None:
                    break
                dst = next(
                    (u for u in placement_rank(view, vid, src_sid)
                     if view.nodes[u].rack_key != key
                     and rack_counts.get(view.nodes[u].rack_key, 0)
                     < ceiling
                     and _vid_held(vid, u) < node_vid_ceiling), None)
                if dst is None:
                    break
                moves.append(Move(vid, src_sid, src_url, dst,
                                  reason="rack"))
                _apply_move(view, counts, rack_counts, vid, src_sid,
                            src_url, dst)

    # 3. skew: move shards off servers holding more than their share, to
    #    targets that hold nothing of the moved volume and stay under
    #    their rack's ceiling
    urls = sorted(u for u, n in view.nodes.items() if n.alive)
    if not urls:
        return moves
    avg = -(-sum(counts.get(u, 0) for u in urls) // len(urls))
    for src in sorted(urls, key=lambda u: -counts.get(u, 0)):
        while counts.get(src, 0) > avg and budget_left():
            picked = _pick_any_shard(view, src)
            if picked is None:
                break
            vid, sid = picked
            rack_counts = view.rack_counts(vid)
            src_rack = view.nodes[src].rack_key
            dst = next(
                (u for u in placement_rank(view, vid, sid)
                 if counts.get(u, 0) < avg
                 and _vid_held(vid, u) == 0
                 and (view.nodes[u].rack_key == src_rack
                      or rack_counts.get(view.nodes[u].rack_key, 0)
                      < ceiling)), None)
            if dst is None:
                break
            moves.append(Move(vid, sid, src, dst, reason="skew"))
            _apply_move(view, counts, rack_counts, vid, sid, src, dst)
    return moves


def _pick_rack_excess(view: ClusterView, vid: int, rack_key):
    """A (sid, url) of this volume held in the over-full rack, taken
    from the rack's most-loaded holder first."""
    best = None
    for sid in sorted(view.shards.get(vid, {})):
        for url in view.alive_holders(vid, sid):
            if view.nodes[url].rack_key != rack_key:
                continue
            load = view.nodes[url].ec_shards
            if best is None or load > best[2]:
                best = (sid, url, load)
    return (best[0], best[1]) if best else (None, None)


def _pick_any_shard(view: ClusterView, src: str):
    """Any (vid, sid) held by src whose volume is most concentrated on
    it (moving those improves per-volume spread too)."""
    best = None
    for vid in sorted(view.shards):
        held = [sid for sid in sorted(view.shards[vid])
                if src in view.shards[vid][sid]]
        if held and (best is None or len(held) > best[0]):
            best = (len(held), vid, held[0])
    return (best[1], best[2]) if best else None


def _apply_move(view: ClusterView, counts: dict, rack_counts: dict,
                vid: int, sid: int, src: str, dst: str) -> None:
    """Simulate one move forward so later planning sees it."""
    holders = view.shards[vid][sid]
    if src in holders:
        holders.remove(src)
    holders.append(dst)
    counts[src] = counts.get(src, 1) - 1
    counts[dst] = counts.get(dst, 0) + 1
    view.nodes[src].ec_shards = max(0, view.nodes[src].ec_shards - 1)
    view.nodes[dst].ec_shards += 1
    src_key = view.nodes[src].rack_key
    rack_counts[src_key] = max(0, rack_counts.get(src_key, 1) - 1)
    dst_key = view.nodes[dst].rack_key
    rack_counts[dst_key] = rack_counts.get(dst_key, 0) + 1


class UnrepairableError(RuntimeError):
    """Fewer than k clean shards reachable: no rebuild host can be given
    enough survivors."""


class PlanExecutor:
    """Execute repair and move plans over HTTP.  ``post_fn(server, path,
    payload, timeout)`` is the transport (CommandEnv.volume_post for the
    shell, a recorder in tests).  Stateless: safe to share across
    concurrent repairs."""

    TIMEOUT = 600.0

    def __init__(self, post_fn: Callable[[str, str, dict, float], dict]):
        self._post_fn = post_fn

    def _post(self, server: str, path: str, payload: dict) -> dict:
        return self._post_fn(server, path, payload, self.TIMEOUT)

    def refresh_heartbeats(self, servers) -> None:
        """Nudge touched servers to re-heartbeat so the master registry
        converges now instead of on the next pulse (best-effort)."""
        for url in sorted(set(servers)):
            try:
                self._post_fn(url, "/admin/heartbeat_now", {}, 30.0)
            except Exception:  # noqa: BLE001 - the next pulse converges
                pass

    # --- moves ------------------------------------------------------------
    def execute_move(self, view: ClusterView, mv: Move) -> None:
        """One planned move against the real cluster; the view's holder
        lists are updated to match (execute on a FRESH view: planning
        already simulated the moves on its own copy)."""
        collection = view.collections.get(mv.vid, "")
        if mv.kind == "dedupe":
            self._drop_shard(view, mv.vid, collection, mv.sid, mv.src)
            return
        self._post(mv.dst, "/admin/ec/copy", {
            "volume_id": mv.vid, "collection": collection,
            "shard_ids": [mv.sid], "source_data_node": mv.src})
        try:
            self._post(mv.dst, "/admin/ec/mount",
                       {"volume_id": mv.vid, "collection": collection})
        except Exception:
            # a copied-but-never-mounted shard file would be invisible to
            # heartbeats: an orphan forever; drop it before re-raising
            try:
                self._post(mv.dst, "/admin/ec/delete",
                           {"volume_id": mv.vid, "collection": collection,
                            "shard_ids": [mv.sid]})
            except Exception:  # noqa: BLE001 - the first error is raised
                pass
            raise
        self._drop_shard(view, mv.vid, collection, mv.sid, mv.src)
        view.shards.setdefault(mv.vid, {}).setdefault(
            mv.sid, []).append(mv.dst)

    def _drop_shard(self, view: ClusterView, vid: int, collection: str,
                    sid: int, url: str) -> None:
        """Delete one shard copy, keeping the holder mounted iff it still
        holds other shards of the volume (deleting the last one also
        removes the .ecx/.ecj/.eci set)."""
        self._post(url, "/admin/ec/delete",
                   {"volume_id": vid, "collection": collection,
                    "shard_ids": [sid]})
        holders = view.shards.get(vid, {}).get(sid, [])
        if url in holders:
            holders.remove(url)
        still_holds = any(url in us
                          for s2, us in view.shards.get(vid, {}).items()
                          if s2 != sid)
        if still_holds:
            self._post(url, "/admin/ec/mount",
                       {"volume_id": vid, "collection": collection})
        else:
            self._post(url, "/admin/ec/unmount", {"volume_id": vid})

    # --- repair -----------------------------------------------------------
    def execute_repair(self, view: ClusterView, vid: int,
                       engine: str = "tpu") -> dict:
        """Rebuild a volume's missing shards on the best host, then spread
        the rebuilt shards rack-aware.  Returns {host, rebuilt, moves,
        copied, move_errors, seconds}; ``seconds`` times the survivor
        copies, the rebuild and the spread.  On a failure before the
        rebuild lands, the survivor copies are cleaned off the host and
        the error re-raised."""
        shard_map = view.shards.get(vid, {})
        collection = view.collections.get(vid, "")
        present = view.present_shards(vid)
        missing = sorted(set(range(TOTAL_SHARDS_COUNT)) - present)
        if not missing:
            return {"host": "", "rebuilt": [], "moves": [], "copied": [],
                    "move_errors": [], "seconds": {}}
        k = DATA_SHARDS_COUNT
        if len(present) < k:
            raise UnrepairableError(
                f"volume {vid}: only {len(present)} clean shards "
                f"reachable, need {k}")
        host = choose_rebuild_host(view, vid)
        if host is None:
            raise UnrepairableError(f"volume {vid}: no alive servers")
        # copy every survivor the host lacks: the rebuild regenerates ALL
        # locally-missing shards, so any survivor not copied first would
        # be regenerated into a duplicate of a remote copy.  A copy the
        # receiver rejects on .eci verification retries the next holder;
        # with every holder bad the shard is regenerated instead, and the
        # rotted source copies are dropped once the rebuild lands
        copied: list[int] = []
        local = sum(1 for sid in present
                    if host in view.alive_holders(vid, sid))
        bad_sources: list[tuple[int, str]] = []
        last_err: Optional[Exception] = None
        seconds: dict[str, float] = {}
        t0 = time.perf_counter()
        try:
            for sid in sorted(present):
                holders = view.alive_holders(vid, sid)
                if host in holders:
                    continue
                for source in holders:
                    try:
                        self._post(host, "/admin/ec/copy", {
                            "volume_id": vid, "collection": collection,
                            "shard_ids": [sid],
                            "source_data_node": source,
                            "copy_ecx_file": True,
                            "copy_ecj_file": True})
                        copied.append(sid)
                        break
                    except Exception as e:  # noqa: BLE001 - next holder
                        last_err = e
                        if "sidecar verification" in str(e):
                            bad_sources.append((sid, source))
            if local + len(copied) < k:
                raise last_err or UnrepairableError(
                    f"volume {vid}: only {local + len(copied)} clean "
                    f"survivors reached {host}, need {k}")
            seconds["copy"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = self._post(host, "/admin/ec/rebuild",
                           {"volume_id": vid, "collection": collection,
                            "engine": engine})
            seconds["rebuild"] = time.perf_counter() - t0
            rebuilt = [int(s) for s in r.get("rebuilt_shard_ids", [])]
            t0 = time.perf_counter()
            if copied:
                self._post(host, "/admin/ec/delete",
                           {"volume_id": vid, "collection": collection,
                            "shard_ids": copied})
            self._post(host, "/admin/ec/mount",
                       {"volume_id": vid, "collection": collection})
        except Exception:
            # leave no orphan survivor copies behind the failed attempt
            if copied:
                try:
                    self._post(host, "/admin/ec/delete",
                               {"volume_id": vid,
                                "collection": collection,
                                "shard_ids": copied})
                    self._post(host, "/admin/ec/mount",
                               {"volume_id": vid,
                                "collection": collection})
                except Exception:  # noqa: BLE001 - the first error is raised
                    pass
            raise
        view.nodes[host].ec_shards += len(rebuilt)
        for sid, url in bad_sources:
            if sid not in rebuilt and sid not in copied:
                continue
            try:
                self._drop_shard(view, vid, collection, sid, url)
            except Exception:  # noqa: BLE001 - left for an operator
                pass
        # spread: each rebuilt shard goes where the ranking says; the host
        # keeps those it is itself the best placement for.  A failed
        # spread move is not fatal: the rebuild already landed, and a
        # later ec.balance converges the placement
        moves: list[tuple[int, str]] = []
        move_errors: list[str] = []
        for sid in rebuilt:
            # rank BEFORE registering the host as this shard's holder, so
            # the host competes like any other candidate
            target = next(iter(placement_rank(view, vid, sid)), None)
            shard_map.setdefault(sid, []).append(host)
            if target is None or target == host:
                continue
            try:
                self.execute_move(
                    view, Move(vid, sid, host, target, reason="spread"))
            except Exception as e:  # noqa: BLE001 - reported, not fatal
                move_errors.append(
                    f"{sid}->{target}: {type(e).__name__}: {e}"[:160])
                continue
            moves.append((sid, target))
        self.refresh_heartbeats([host] + [t for _s, t in moves])
        seconds["spread"] = time.perf_counter() - t0
        return {"host": host, "rebuilt": rebuilt, "moves": moves,
                "copied": copied, "move_errors": move_errors,
                "seconds": seconds}
