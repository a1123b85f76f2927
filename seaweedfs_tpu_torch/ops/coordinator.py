"""EC repair and rebalance: the planner, the executor of its plans, and
the master's autonomous coordinator loop.

The port's copy of seaweedfs_tpu/ops/coordinator.py:

  ClusterView + planner   pure functions over a neutral topology snapshot
                          (the master's /dir/status document, or its live
                          Topology): clean-shard deficits, a rack/DC-aware
                          placement ranking (volume growth's same-rack /
                          other-rack / other-DC tiers), the rebuild host,
                          and dedupe / rack-diversity / skew rebalance
                          plans.  Shared by the shell's ec.rebuild and
                          ec.balance and by the coordinator, so manual and
                          autonomous moves agree.
  PlanExecutor            the HTTP legs (/admin/ec/copy -> mount ->
                          delete, /admin/ec/rebuild, the post-repair
                          /ec/scrub/start), with the transport injected
                          (the shell passes CommandEnv's, the coordinator
                          the default http_json one).  Every leg passes
                          the ``coord.exec`` fault point.
  EcCoordinator           the master's loop (``-coordinatorSeconds``):
                          each cycle re-derives the degraded EC volumes
                          from the heartbeat registry (servers the
                          aggregator cannot scrape count as down), queues
                          them by clean-shard deficit, repairs them on the
                          best host under one propagated deadline each,
                          re-scrubs the healed volume's holders, and runs
                          a token-bucket-budgeted rebalance.  It pauses
                          while the shell's admin lock is held and on
                          POST /cluster/coordinator/pause.

EC work is asked of the servers' own engine, ``"tpu"`` by default: a
card server refuses ``"cpu"`` (the reference's default), a CPU server
takes either.

Each repair and each rebalance round runs under a trace root of its own
while the tracer is on (``coord.repair``, ``coord.rebalance``), so its
copy, rebuild and mount hops stitch into one cluster trace, and journals
``ec_under_replicated``, ``repair_planned``, ``repair_done``,
``repair_failed`` and ``rebalance_move`` events carrying both that trace
and the cause.  The master's cluster journal feeds ``on_events``: the
event, alert and trace that made a volume urgent land in its queue entry
(``cause_event``, ``cause_trace``).  Each repair's planned, done and
failed records (``status()["replicated"]``) go to ``replicate_fn``, the
master's synchronous raft append, so a leader killed mid-repair leaves
its planned record on a quorum; the promoted leader's
``resume_replicated`` re-plans it under the original alert, cause event
and cause trace.  ``export_replicated`` / ``import_replicated`` carry
the records through raft snapshots.  Only the leader's loop plans
(``is_leader_fn``).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..ec.layout import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from ..observability import context as _trace_context
from ..observability import events as _events
from ..observability import get_tracer
from ..stats import coordinator_metrics
from ..utils import deadline as _deadline
from ..utils import faultinject
from ..utils.backoff import retry_allowed
from ..utils.httpd import http_json

_log = logging.getLogger(__name__)


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


def view_from_topology(topo, stale: tuple = ()) -> ClusterView:
    """A view straight off the master's live Topology (under its lock, no
    HTTP); ``stale`` names registered servers the aggregator could not
    scrape, which must not count as holders or targets."""
    with topo.lock:
        return view_from_status(topo.to_map(), stale=stale)


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


def placement_rank(view: ClusterView, vid: int, sid: int,
                   exclude: tuple = ()) -> list[str]:
    """Candidate targets for one shard, best first: a rack not yet
    holding this volume's shards beats one that does, a fresh DC breaks
    ties, then fewest EC shards and most free slots, then the url.
    ``exclude`` drops more urls (the autoscaler's replica holders)."""
    holders = set(view.shards.get(vid, {}).get(sid, []))
    rack_counts = view.rack_counts(vid)
    dc_counts: dict[str, int] = {}
    for key, c in rack_counts.items():
        dc_counts[key[0]] = dc_counts.get(key[0], 0) + c
    cands = [n for n in view.nodes.values()
             if n.alive and n.url not in holders and n.url not in exclude]
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


def _default_post(server: str, path: str, payload: dict,
                  timeout: float = 600.0) -> dict:
    return http_json("POST", f"http://{server}{path}", payload,
                     timeout=timeout)


class PlanExecutor:
    """Execute repair and move plans over HTTP.  ``post_fn(server, path,
    payload, timeout)`` is the transport (CommandEnv.volume_post for the
    shell, ``http_json`` for the coordinator, a recorder in tests).
    Stateless: safe to share across concurrent repairs."""

    TIMEOUT = 600.0

    def __init__(self, post_fn: Optional[Callable[[str, str, dict, float],
                                                  dict]] = None):
        self._post_fn = post_fn or _default_post

    def _post(self, server: str, path: str, payload: dict,
              timeout: Optional[float] = None) -> dict:
        faultinject.hit("coord.exec")
        return self._post_fn(server, path, payload, timeout or self.TIMEOUT)

    def admin_post(self, server: str, path: str, payload: dict,
                   timeout: Optional[float] = None) -> dict:
        """An admin leg of the master's other loop, the heat autoscaler
        (replica copy, tier, recall): the same transport, timeout and
        ``coord.exec`` fault point as a repair's legs."""
        return self._post(server, path, payload, timeout)

    def refresh_heartbeats(self, servers) -> None:
        """Nudge touched servers to re-heartbeat so the master registry
        converges now instead of on the next pulse (best-effort)."""
        for url in sorted(set(servers)):
            try:
                self._post_fn(url, "/admin/heartbeat_now", {}, 30.0)
            except Exception:  # noqa: BLE001 - the next pulse converges
                pass

    def rescrub(self, view: ClusterView, vid: int) -> list[str]:
        """After a repair, every alive holder of the volume re-verifies it
        against its sidecar now, so a stale `unrepairable` verdict clears
        without waiting for the next full pass.  Best-effort; returns the
        holders that started."""
        holders = sorted({
            u for us in view.shards.get(vid, {}).values() for u in us
            if view.nodes.get(u) and view.nodes[u].alive})
        started: list[str] = []
        for url in holders:
            try:
                # no knob overrides: the scrubber keeps any rate it is
                # sent, so a rate here would change the operator's IO cap
                self._post(url, "/ec/scrub/start", {"volume_id": vid}, 30.0)
                started.append(url)
            except Exception:  # noqa: BLE001 - its next pass converges
                pass
        return started

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


# journal event types that wake the planner at once (everything else rides
# the periodic scan)
_WAKE_EVENT_TYPES = ("shard_corrupt", "scrub_unrepairable",
                     "scrub_repair_failed", "peer_stale", "alert_fired",
                     "degraded_bind")
# alert rule name by the event type whose moments it watches: attaches the
# firing alert to the repairs it caused
_ALERT_FOR_TYPE = {
    "shard_corrupt": "corrupt_shards_increase",
    "scrub_unrepairable": "scrub_unrepairable",
    "scrub_repair_failed": "scrub_unrepairable",
    "ec_under_replicated": "ec_under_replicated_increase",
}


class EcCoordinator:
    """The master's repair/rebalance loop.  Reached concurrently: its own
    cycle thread, the repair pool threads and the HTTP request threads
    (status, pause, resume).  All mutable state rides _lock; the HTTP legs
    run strictly outside it.

    The reference's defaults are constants here, set by no caller: two
    repairs at once, at most four a cycle and 16 moves; a rebalance token
    bucket of one move a second and a burst of eight (copied to
    attributes that tests set); one 900 s budget per repair, every leg
    drawing from it, so a wedged peer cannot pin a repair slot for the
    sum of every leg's timeout; and the servers' own engine, "tpu"."""

    MAX_CONCURRENT = 2
    MAX_REPAIRS_PER_CYCLE = 4
    MAX_MOVES_PER_CYCLE = 16
    MOVE_RATE = 1.0
    MOVE_BURST = 8.0
    REPAIR_DEADLINE_S = 900.0
    ENGINE = "tpu"

    def __init__(self, topo, server: str = "",
                 stale_peers_fn: Optional[Callable[[], list]] = None,
                 is_leader_fn: Optional[Callable[[], bool]] = None,
                 admin_locked_fn: Optional[Callable[[], bool]] = None,
                 interval_s: float = 15.0,
                 post_fn: Optional[Callable] = None,
                 replicate_fn: Optional[Callable[[dict], None]] = None):
        """``server``: the master's url, stamped on spans and events;
        ``stale_peers_fn``: registered servers to count as down;
        ``is_leader_fn``: False on a raft follower, whose loop idles;
        ``admin_locked_fn``: True while the shell's lock is held;
        ``replicate_fn``: takes each repair record to the raft log."""
        self.topo = topo
        self.server = server
        self.stale_peers_fn = stale_peers_fn or (lambda: [])
        self.is_leader_fn = is_leader_fn or (lambda: True)
        self.admin_locked_fn = admin_locked_fn or (lambda: False)
        self.replicate_fn = replicate_fn
        self.interval_s = float(interval_s)
        self.move_rate = self.MOVE_RATE
        self.move_burst = self.MOVE_BURST
        self.engine = self.ENGINE
        self.executor = PlanExecutor(post_fn=post_fn)
        self.metrics = coordinator_metrics()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # repair queue: vid -> {deficit, critical, attempts, cause...}
        self._queue: dict[int, dict] = {}  # guarded-by: _lock
        # degraded-event causes by vid, and the alerts firing now
        self._causes: dict[int, dict] = {}  # guarded-by: _lock
        self._alerts: dict[str, dict] = {}  # guarded-by: _lock
        # volumes already logged as under-replicated (once per transition)
        self._under_notified: set[int] = set()  # guarded-by: _lock
        self.paused = False  # guarded-by: _lock
        self.pause_reason = ""  # guarded-by: _lock
        self.cycles = 0  # guarded-by: _lock
        self.last_cycle_at = 0.0  # guarded-by: _lock
        self.last_error = ""  # guarded-by: _lock
        self.repairs_done = 0  # guarded-by: _lock
        self.repairs_failed = 0  # guarded-by: _lock
        self.moves_done = 0  # guarded-by: _lock
        self.recent: deque = deque(maxlen=64)  # guarded-by: _lock
        # token-bucket move budget
        self._tokens = self.MOVE_BURST  # guarded-by: _lock
        self._tokens_at = time.monotonic()  # guarded-by: _lock
        # the replicated repair records: vid -> the latest unfinished
        # record (planned / failed), and the history by record id
        self._replicated: dict[int, dict] = {}  # guarded-by: _lock
        self._replog: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "EcCoordinator":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ec-coordinator")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    @property
    def enabled(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def pause(self, reason: str = "api") -> None:
        with self._lock:
            self.paused = True
            self.pause_reason = reason

    def resume(self) -> None:
        with self._lock:
            self.paused = False
            self.pause_reason = ""
        self._wake.set()

    # --- event subscription ----------------------------------------------
    def on_events(self, events: list[dict]) -> None:
        """Cluster-journal ingest hook (the master's
        ``_on_cluster_events``): record which alert, event and trace made
        each volume urgent, and wake the planner.  Lock-only, never
        HTTP."""
        wake = False
        with self._lock:
            for e in events:
                etype = e.get("type") or ""
                det = e.get("details") or {}
                if etype == "alert_fired":
                    self._alerts[str(det.get("alert") or "")] = {
                        "event": e.get("id", ""),
                        "trace": det.get("exemplar_trace")
                        or e.get("trace") or ""}
                    wake = True
                elif etype == "alert_resolved":
                    self._alerts.pop(str(det.get("alert") or ""), None)
                elif etype in _WAKE_EVENT_TYPES:
                    vid = _vid_from_event(det)
                    if vid is not None:
                        self._causes[vid] = {
                            "event": e.get("id", ""), "type": etype,
                            "trace": e.get("trace") or "",
                            "alert": _ALERT_FOR_TYPE.get(etype, "")}
                    wake = True
        if wake:
            self._wake.set()

    # --- replicated repair records (master HA) ----------------------------
    def _record(self, op: str, vid: int, entry: dict, **extra) -> None:
        """Keep one repair lifecycle record (planned / done / failed):
        apply it to the local replicated view, then hand it to
        ``replicate_fn`` (the master's synchronous raft append) so it
        survives this leader.  Called outside _lock: replication does
        quorum HTTP."""
        at = round(time.time(), 3)
        rec = {"id": f"{vid}:{op}:{at:.3f}", "op": op, "vid": vid,
               "at": at, "alert": entry.get("alert", ""),
               "cause_trace": entry.get("cause_trace", ""),
               "cause_event": entry.get("cause_event", ""), **extra}
        self.apply_replicated(rec)
        if self.replicate_fn is not None:
            try:
                self.replicate_fn(rec)
            except Exception:  # noqa: BLE001 - never fails the repair
                _log.exception("coordinator: replicating %s", rec["id"])

    def apply_replicated(self, rec: dict) -> None:
        """Land one plan/done/failed record (the leader's own write or a
        follower's apply loop).  Idempotent: records dedup by id and the
        pending map is last-write-wins per volume."""
        try:
            vid = int(rec.get("vid"))
        except (TypeError, ValueError):
            return
        op = str(rec.get("op") or "")
        with self._lock:
            rid = str(rec.get("id") or f"{vid}:{op}:{rec.get('at')}")
            self._replog[rid] = dict(rec)
            while len(self._replog) > 256:
                self._replog.popitem(last=False)
            if op == "done":
                self._replicated.pop(vid, None)
            elif op in ("planned", "failed"):
                self._replicated[vid] = dict(rec)

    def export_replicated(self) -> dict:
        """The replicable repair-record state (a raft snapshot's leg)."""
        with self._lock:
            return {"pending": {str(vid): dict(r)
                                for vid, r in self._replicated.items()},
                    "log": [dict(r) for r in self._replog.values()]}

    def import_replicated(self, doc: dict) -> None:
        """Install a snapshot of the repair-record state (idempotent:
        replays merge by record id and volume id)."""
        for rec in (doc or {}).get("log") or []:
            self.apply_replicated(rec)
        with self._lock:
            for vid_s, rec in ((doc or {}).get("pending") or {}).items():
                try:
                    self._replicated[int(vid_s)] = dict(rec)
                except (TypeError, ValueError):
                    continue

    def resume_replicated(self) -> None:
        """Promotion hook: re-arm every planned-but-unfinished repair from
        the replicated records, so the new leader's repair_planned and
        repair_done carry the original alert, trace and event.  The
        deficits themselves re-derive from the volume servers'
        heartbeats; this sets the cause map and wakes the planner.  A
        record's cause replaces the one this follower derived from the
        journal (the same events, unless a later one came), and its alert
        stands even when that alert has resolved since (the reference's
        keeps the cause the follower derived and names whichever relevant
        alert fires now)."""
        with self._lock:
            for vid, rec in self._replicated.items():
                self._causes[vid] = {
                    "event": rec.get("cause_event", ""),
                    "type": "replicated_plan",
                    "trace": rec.get("cause_trace", ""),
                    "alert": rec.get("alert", "")}
        self._wake.set()

    # --- the loop ---------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            if not self.is_leader_fn():
                continue
            with self._lock:
                paused = self.paused
            if paused or self.admin_locked_fn():
                # an operator holds the shell's admin lock: their
                # migrations must not duel with ours
                continue
            try:
                self.run_cycle()
                with self._lock:
                    self.last_error = ""
            except Exception as e:  # noqa: BLE001 - the loop survives
                self.metrics.cycles.inc("error")
                _log.exception("coordinator cycle failed")
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"[:300]

    def run_cycle(self) -> dict:
        """One planning and execution round (synchronous: tests call it
        directly)."""
        faultinject.hit("coord.plan")
        view = self._snapshot_view()
        deficits = clean_deficits(view)
        self._update_queue(deficits)
        repaired = self._run_repairs()
        moved = self._run_rebalance()
        with self._lock:
            self.cycles += 1
            self.last_cycle_at = time.time()
        self.metrics.cycles.inc("ok")
        return {"deficits": len(deficits), "repaired": repaired,
                "moved": moved}

    def _snapshot_view(self) -> ClusterView:
        try:
            stale = tuple(self.stale_peers_fn() or ())
        except Exception:  # noqa: BLE001 - plan without staleness
            _log.exception("stale peers unavailable")
            stale = ()
        return view_from_topology(self.topo, stale=stale)

    def _update_queue(self, deficits: dict[int, dict]) -> None:
        """Refresh the repair queue and the under-replication gauge from
        this cycle's deficits; journal each volume that newly fell below
        k+1 clean shards."""
        newly_under: list[tuple[int, int]] = []
        with self._lock:
            for vid in list(self._queue):
                if vid not in deficits:
                    self._queue.pop(vid)  # healed, by us or otherwise
                    self._causes.pop(vid, None)
                    self._under_notified.discard(vid)
            for vid, d in deficits.items():
                entry = self._queue.setdefault(
                    vid, {"attempts": 0, "queued_at": time.time()})
                entry.update(d)
                cause = self._causes.get(vid, {})
                entry["cause_trace"] = cause.get("trace", "")
                entry["cause_event"] = cause.get("event", "")
                entry["alert"] = self._cause_alert_locked(vid)
                if d["under_replicated"] and \
                        vid not in self._under_notified:
                    self._under_notified.add(vid)
                    newly_under.append((vid, d["clean"]))
            under = sum(1 for d in deficits.values()
                        if d["under_replicated"])
            self.metrics.under_replicated.set(float(under))
            self.metrics.queue_depth.set(float(len(self._queue)))
        for vid, clean in newly_under:
            _events.emit("ec_under_replicated", server=self.server
                         or None, vid=vid, clean_shards=clean,
                         threshold=DATA_SHARDS_COUNT + 1)

    def _cause_alert_locked(self, vid: int) -> str:  # holds: _lock
        """The firing alert this volume's repair answers: a re-armed
        plan's own alert; else the cause event's mapped rule when that
        alert fires, else any relevant firing alert, else the cause's
        static mapping."""
        cause = self._causes.get(vid, {})
        mapped = cause.get("alert", "")
        if mapped and cause.get("type") == "replicated_plan":
            return mapped
        if mapped and mapped in self._alerts:
            return mapped
        for name in self._alerts:
            if name in _ALERT_FOR_TYPE.values() or name == "peer_down":
                return name
        return mapped

    def _forget_locked(self, vid: int) -> None:  # holds: _lock
        self._queue.pop(vid, None)
        self._causes.pop(vid, None)
        self._under_notified.discard(vid)

    # --- repairs ----------------------------------------------------------
    def _run_repairs(self) -> int:
        now = time.time()
        with self._lock:
            snapshot = [(vid, dict(e)) for vid, e in self._queue.items()]
        ready = []
        for vid, e in snapshot:
            attempts = e.get("attempts", 0)
            if attempts:
                # a failing repair re-copies up to k survivors per attempt:
                # hold it back exponentially, and count each re-attempt
                # against the retry budget
                hold = min(self.interval_s * (2 ** attempts), 600.0)
                if now - e.get("last_attempt_at", 0.0) < hold:
                    continue
                if not retry_allowed(f"repair:{vid}", "coordinator"):
                    continue
            ready.append((vid, e))
        with self._lock:
            batch = sorted(
                ready,
                key=lambda kv: (not kv[1].get("critical", False),
                                -kv[1].get("deficit", 0), kv[0]))
            batch = batch[:self.MAX_REPAIRS_PER_CYCLE]
            for vid, _e in batch:
                q = self._queue.get(vid)
                if q is not None:
                    q["last_attempt_at"] = now
        if not batch:
            return 0
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.MAX_CONCURRENT,
                thread_name_prefix="coord-repair") as pool:
            return sum(pool.map(lambda kv: self._run_repair(*kv), batch))

    def _run_repair(self, vid: int, entry: dict) -> bool:
        """One repair of volume ``vid`` under a trace root of its own: the
        copy, rebuild and mount hops stitch into one cluster trace, and
        each event carries both this trace and the cause.  The outcome
        lands in the counters, ``recent``, the repair records and the
        journal."""
        tr = get_tracer()
        ctx = prev = None
        if tr.enabled and _trace_context.current() is None:
            ctx = _trace_context.TraceContext(_trace_context.new_trace_id())
            prev = _trace_context.activate(ctx)
        prev_srv = _trace_context.swap_server(self.server or None)
        try:
            with tr.span("coord.repair", vid=vid,
                         deficit=entry.get("deficit", 0),
                         alert=entry.get("alert", "")):
                return self._repair(vid, entry)
        finally:
            _trace_context.swap_server(prev_srv)
            if ctx is not None:
                _trace_context.activate(prev)

    def _repair(self, vid: int, entry: dict) -> bool:
        cause = {"alert": entry.get("alert", ""),
                 "cause_trace": entry.get("cause_trace", ""),
                 "cause_event": entry.get("cause_event", "")}
        server = self.server or None
        view = self._snapshot_view()
        if len(view.present_shards(vid)) >= TOTAL_SHARDS_COUNT:
            # healed between queueing and execution: drop the entry
            # without journaling a repair that never ran
            with self._lock:
                self._forget_locked(vid)
                stale_plan = vid in self._replicated
            if stale_plan:
                self._record("done", vid, entry, host="", rebuilt=[],
                             healed_elsewhere=True)
            return True
        _events.emit("repair_planned", server=server, vid=vid,
                     deficit=entry.get("deficit", 0),
                     critical=entry.get("critical", False), **cause)
        self._record("planned", vid, entry,
                     deficit=entry.get("deficit", 0),
                     critical=entry.get("critical", False))
        try:
            # ONE deadline for the whole repair: every leg (copies,
            # rebuild, mounts, spread) draws from the same budget
            with _deadline.scope(self.REPAIR_DEADLINE_S):
                res = self.executor.execute_repair(view, vid,
                                                   engine=self.engine)
        except Exception as e:  # noqa: BLE001 - counted, shown, re-planned
            err = f"{type(e).__name__}: {e}"[:200]
            self.metrics.repairs.inc("failed")
            self.metrics.repair_failures.inc(type(e).__name__[:40])
            with self._lock:
                self.repairs_failed += 1
                q = self._queue.get(vid)
                if q is not None:
                    q["attempts"] = q.get("attempts", 0) + 1
                self.recent.appendleft({
                    "at": round(time.time(), 3), "vid": vid,
                    "action": "repair_failed", "error": err, **cause})
            _events.emit("repair_failed", server=server, vid=vid,
                         error=err, **cause)
            self._record("failed", vid, entry, error=err)
            return False
        if not res["host"] and not res["rebuilt"]:
            # healed between queueing and execution: not our repair
            with self._lock:
                self._forget_locked(vid)
            self._record("done", vid, entry, host="", rebuilt=[],
                         healed_elsewhere=True)
            return True
        # the holders re-verify the healed volume now, so a stale
        # unrepairable verdict clears (best-effort, its own budget); the
        # scrub route adopts this repair's trace context
        rescrubbed: list[str] = []
        try:
            with _deadline.scope(min(60.0, self.REPAIR_DEADLINE_S)):
                rescrubbed = self.executor.rescrub(view, vid)
        except Exception:  # noqa: BLE001 - the repair already landed
            _log.exception("coordinator: re-scrub of volume %d", vid)
        self.metrics.repairs.inc("done")
        with self._lock:
            self.repairs_done += 1
            self._forget_locked(vid)
            self.recent.appendleft({
                "at": round(time.time(), 3), "vid": vid,
                "action": "repair_done", "host": res["host"],
                "rebuilt": res["rebuilt"],
                "spread": [list(m) for m in res["moves"]],
                "rescrubbed": rescrubbed, **cause})
        _events.emit("repair_done", server=server, vid=vid,
                     host=res["host"], rebuilt=res["rebuilt"],
                     moves=len(res["moves"]),
                     move_errors=res.get("move_errors") or [],
                     rescrubbed=rescrubbed, **cause)
        # the legs' seconds are in no event: the log line keeps them
        _log.info("coordinator: repaired volume %d on %s: rebuilt %s, "
                  "spread %s, move errors %s, re-scrubbed %s, legs %s", vid,
                  res["host"], res["rebuilt"], res["moves"],
                  res["move_errors"], rescrubbed, res["seconds"])
        self._record("done", vid, entry, host=res["host"],
                     rebuilt=res["rebuilt"])
        return True

    # --- rebalance --------------------------------------------------------
    def _take_move_token(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.move_burst,
                self._tokens + (now - self._tokens_at) * self.move_rate)
            self._tokens_at = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def _run_rebalance(self) -> int:
        """Token-budgeted rebalance (dedupe, rack diversity, skew), planned
        every cycle: a server joining or leaving needs no edge detection,
        it just yields a plan.  A non-empty plan runs under a trace root
        of its own (``coord.rebalance``)."""
        view = self._snapshot_view()
        plan = plan_rebalance(clone_view(view),
                              max_moves=self.MAX_MOVES_PER_CYCLE)
        if not plan:
            return 0
        tr = get_tracer()
        ctx = prev = None
        if tr.enabled and _trace_context.current() is None:
            ctx = _trace_context.TraceContext(_trace_context.new_trace_id())
            prev = _trace_context.activate(ctx)
        prev_srv = _trace_context.swap_server(self.server or None)
        try:
            with tr.span("coord.rebalance", planned=len(plan)):
                return self._rebalance(view, plan)
        finally:
            _trace_context.swap_server(prev_srv)
            if ctx is not None:
                _trace_context.activate(prev)

    def _rebalance(self, view: ClusterView, plan: list) -> int:
        executed = 0
        touched: set[str] = set()
        for mv in plan:
            if self._stop.is_set() or not self._take_move_token():
                break  # the rest waits for the next cycle's tokens
            try:
                self.executor.execute_move(view, mv)
            except Exception as e:  # noqa: BLE001 - shown, re-planned
                with self._lock:
                    self.recent.appendleft({
                        "at": round(time.time(), 3),
                        "vid": mv.vid, "sid": mv.sid,
                        "action": "move_failed",
                        "error": f"{type(e).__name__}: {e}"[:200]})
                continue
            executed += 1
            touched.update((mv.src, mv.dst) if mv.dst else (mv.src,))
            self.metrics.moves.inc(mv.reason)
            with self._lock:
                self.moves_done += 1
                self.recent.appendleft({
                    "at": round(time.time(), 3),
                    "vid": mv.vid, "sid": mv.sid,
                    "action": mv.kind, "reason": mv.reason,
                    "src": mv.src, "dst": mv.dst})
            _events.emit("rebalance_move", server=self.server or None,
                         vid=mv.vid, sid=mv.sid, src=mv.src, dst=mv.dst,
                         reason=mv.reason)
        if touched:
            self.executor.refresh_heartbeats(touched)
        return executed

    # --- views ------------------------------------------------------------
    def health_contribution(self) -> dict:
        """Master-local additions to /cluster/health totals: volume servers
        cannot know cluster-wide shard counts."""
        m = self.metrics
        return {
            "ec_under_replicated": int(m.under_replicated.value()),
            "coordinator_repair_failures":
                int(sum(m.repair_failures.snapshot().values())),
        }

    def status(self) -> dict:
        try:
            admin_locked = bool(self.admin_locked_fn())
        except Exception:  # noqa: BLE001 - status still answers
            admin_locked = False
        with self._lock:
            queue = [
                {"vid": vid, **e}
                for vid, e in sorted(
                    self._queue.items(),
                    key=lambda kv: (not kv[1].get("critical", False),
                                    -kv[1].get("deficit", 0), kv[0]))]
            return {
                "enabled": self.enabled,
                "paused": self.paused or admin_locked,
                "pause_reason": self.pause_reason or (
                    "admin_lock" if admin_locked else ""),
                "interval_s": self.interval_s,
                "cycles": self.cycles,
                "last_cycle_at": round(self.last_cycle_at, 3),
                "last_error": self.last_error,
                "queue": queue,
                "under_replicated":
                    int(self.metrics.under_replicated.value()),
                "repairs": {"done": self.repairs_done,
                            "failed": self.repairs_failed},
                "moves": self.moves_done,
                "move_budget": {"rate_per_s": self.move_rate,
                                "burst": self.move_burst,
                                "tokens": round(self._tokens, 2)},
                "recent": list(self.recent),
                "replicated": {
                    "pending": {str(v): dict(r)
                                for v, r in self._replicated.items()},
                    "log": [dict(r) for r in self._replog.values()]},
            }


def _vid_from_event(details: dict) -> Optional[int]:
    """Volume id out of a journal event's details: explicit ``vid``, else
    parsed from the shard base ``path`` (``.../[coll_]vid``)."""
    if "vid" in details:
        try:
            return int(details["vid"])
        except (TypeError, ValueError):
            return None
    path = str(details.get("path") or "")
    if not path:
        return None
    name = path.replace("\\", "/").rsplit("/", 1)[-1]
    try:
        return int(name.rsplit("_", 1)[-1])
    except ValueError:
        return None
