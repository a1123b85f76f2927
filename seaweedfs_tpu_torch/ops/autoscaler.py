"""The heat autoscaler: the master's loop from heat to replica and tier
moves.

The port's copy of seaweedfs_tpu/ops/autoscaler.py.  It joins the heat
journal's signal (observability/heat.py: the Zipf head, ``flash_crowd``
and ``heat_shift`` events) to the coordinator's placement and executor
(ops/coordinator.py):

  hot path    a volume in the heat head, or named by a ``flash_crowd``
              event, grows read replicas on other racks
              (``placement_rank``), one a cycle, up to ``max_replicas``.
              The heat journal's ``on_ingest`` wakes the loop at once.
              Each replica add is journaled (``replica_grow``) with the
              heat alert that caused it and that alert's exemplar trace.
              An added replica is dropped (``replica_shrink``) only after
              the volume stayed under ``cold_share`` for ``hold_down_s``,
              under a token-bucket move budget; a shrunk volume cannot
              grow again within ``regrow_cooldown_s``, and a volume does
              at most ``max_cycles_per_volume`` grow/shrink cycles.
  cold path   a full (or read-only) single-replica volume cold for
              ``tier_after_s`` moves its ``.dat`` to the remote backend
              ``tier_backend`` in two phases: ``/admin/tier_upload
              {two_phase}`` uploads and verifies (size and crc32) and
              keeps the local copy; the ``tier_pending`` record reaches
              the raft log; only then ``/admin/tier_commit`` drops the
              local ``.dat``.  A crash at any step leaves the local file
              or a committed remote copy.  Heat returning recalls the
              volume (``/admin/tier_download``); ``tier_volume`` is the
              shell's manual tier and recall over the same legs.

Every actuation's lifecycle record (``grow_planned``, ``grow_done``,
``tier_pending``, ...) goes to ``replicate_fn``, the master's synchronous
raft append of the ``autoscale`` entry kind, so a leader killed mid-move
leaves its plan on a quorum; the promoted leader's ``resume_replicated``
and next cycle close a grow whose copy landed (no second copy) and
re-issue a pending tier's commit.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

from ..observability import events as _events
from ..utils import deadline as _deadline
from .coordinator import ClusterView, NodeView, PlanExecutor, placement_rank

# journal event types that wake the planner immediately (the heat
# on_ingest hook is the primary wake; these catch replayed/shipped
# batches and alert transitions)
_WAKE_EVENT_TYPES = ("flash_crowd", "heat_shift", "alert_fired")
# heat event type -> the journal_event alert rule it fires (the rules
# in observability/alerts.py are named after the event type itself)
_ALERT_FOR_TYPE = {
    "flash_crowd": "flash_crowd",
    "heat_shift": "heat_shift",
}


class HeatAutoscaler:  # weedlint: concurrent-class
    """Master-side heat -> replication/tiering loop.  Reached
    concurrently: its own cycle thread, HTTP router threads
    (status/pause/resume/manual tier), the heat journal's ingest
    thread (on_heat) and whatever thread ships cluster events
    (on_events).  All mutable state rides _lock; the HTTP actuation
    legs run strictly outside it."""

    def __init__(self, topo, server: str = "",
                 heat_fn: Optional[Callable[[], dict]] = None,
                 stale_peers_fn: Optional[Callable[[], list]] = None,
                 is_leader_fn: Optional[Callable[[], bool]] = None,
                 admin_locked_fn: Optional[Callable[[], bool]] = None,
                 interval_s: float = 5.0,
                 grow_share: float = 0.3, max_replicas: int = 3,
                 cold_share: float = 0.05, hold_down_s: float = 30.0,
                 regrow_cooldown_s: float = 30.0,
                 max_cycles_per_volume: int = 2,
                 move_rate: float = 1.0, move_burst: float = 4.0,
                 tier_backend: str = "", tier_after_s: float = 60.0,
                 tier_full_frac: float = 0.85,
                 volume_size_limit: int = 30 * 1000 * 1000 * 1000,
                 actuation_deadline_s: float = 600.0,
                 post_fn: Optional[Callable] = None,
                 replicate_fn: Optional[Callable[[dict], None]] = None):
        self.topo = topo
        self.server = server
        self.heat_fn = heat_fn or (lambda: {})
        self.stale_peers_fn = stale_peers_fn or (lambda: [])
        self.is_leader_fn = is_leader_fn or (lambda: True)
        self.admin_locked_fn = admin_locked_fn or (lambda: False)
        self.interval_s = float(interval_s)
        # hot-path knobs: a volume in the journal's head with at least
        # grow_share of cluster heat (or named by a flash_crowd event)
        # grows toward max_replicas, one replica per cycle
        self.grow_share = float(grow_share)
        self.max_replicas = max(1, int(max_replicas))
        # hysteresis: a grown volume must stay under cold_share for a
        # full hold_down_s before ONE added replica is dropped, and a
        # shrunk volume cannot re-grow inside regrow_cooldown_s
        self.cold_share = float(cold_share)
        self.hold_down_s = float(hold_down_s)
        self.regrow_cooldown_s = float(regrow_cooldown_s)
        self.max_cycles_per_volume = int(max_cycles_per_volume)
        self.move_rate = float(move_rate)
        self.move_burst = float(move_burst)
        # cold-path knobs: tiering stays off until a backend is named
        self.tier_backend = tier_backend or ""
        self.tier_after_s = float(tier_after_s)
        self.tier_full_frac = float(tier_full_frac)
        self.volume_size_limit = int(volume_size_limit)
        # one propagated deadline per actuation (utils/deadline.py) so
        # a wedged volume server can't pin the loop past the budget
        self.actuation_deadline_s = float(actuation_deadline_s)
        self.executor = PlanExecutor(post_fn=post_fn)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # vid -> {"added": [urls], "grown_at", "shrunk_at", "cycles"}
        self._targets: dict[int, dict] = {}  # guarded-by: _lock
        # placement snapshot, refreshed by _volume_map (the cycle
        # thread and manual tier_volume HTTP callers both refresh it)
        self._nodes: dict[str, NodeView] = {}  # guarded-by: _lock
        # vid -> wall time the volume was first seen cold (hold-down)
        self._cold_since: dict[int, float] = {}  # guarded-by: _lock
        # vid -> committed tier record {"server", "backend", "key"}
        self._tiered: dict[int, dict] = {}  # guarded-by: _lock
        # causes: vid -> {"event","type","trace","alert"} + firing set
        self._causes: dict[int, dict] = {}  # guarded-by: _lock
        self._alerts: dict[str, dict] = {}  # guarded-by: _lock
        self.paused = False  # guarded-by: _lock
        self.pause_reason = ""  # guarded-by: _lock
        self.cycles = 0  # guarded-by: _lock
        self.last_cycle_at = 0.0  # guarded-by: _lock
        self.last_error = ""  # guarded-by: _lock
        self.grows_done = 0  # guarded-by: _lock
        self.shrinks_done = 0  # guarded-by: _lock
        self.tiers_done = 0  # guarded-by: _lock
        self.recalls_done = 0  # guarded-by: _lock
        self.failures = 0  # guarded-by: _lock
        self.recent: deque = deque(maxlen=64)  # guarded-by: _lock
        # token-bucket actuation budget (grow/shrink moves)
        self._tokens = float(move_burst)  # guarded-by: _lock
        self._tokens_at = time.monotonic()  # guarded-by: _lock
        # --- replicated actuation records (master HA) ---------------
        # grow/shrink/tier lifecycle records ride the raft log as the
        # "autoscale" entry kind: a leader killed mid-actuation leaves
        # its planned record on a quorum, and resume_replicated() on
        # the NEW leader RESUMES the plan (closing it against the live
        # topology when the actuation already landed) with the original
        # alert/trace cause attribution.
        self.replicate_fn = replicate_fn
        # vid -> latest unfinished record (grow_planned / tier_pending)
        self._replicated: dict[int, dict] = {}  # guarded-by: _lock
        self._replog: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "HeatAutoscaler":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="heat-autoscaler")
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

    # --- event / heat subscription ---------------------------------------
    def on_heat(self, merged: dict) -> None:  # thread-entry
        """Heat-journal on_ingest hook: wake the planner the moment a
        volume crosses the grow threshold — cheap share math, lock-only,
        never HTTP (runs on whatever thread POSTed the heat batch)."""
        vols = merged.get("volumes") or {}
        total = sum(float(v.get("heat") or 0.0) for v in vols.values())
        if total <= 1e-9:
            return
        wake = False
        with self._lock:
            for vid, agg in vols.items():
                share = float(agg.get("heat") or 0.0) / total
                grown = len((self._targets.get(vid) or {}).get(
                    "added") or ())
                if share >= self.grow_share and \
                        (1 + grown < self.max_replicas
                         or vid in self._tiered):
                    wake = True
                    self._causes.setdefault(vid, {
                        "event": "", "type": "head_entry",
                        "trace": agg.get("trace") or "",
                        "alert": ""})
        if wake:
            self._wake.set()

    def on_events(self, events: list[dict]) -> None:  # thread-entry
        """Cluster-journal ingest hook (chained after the EC
        coordinator's): record which heat alert/event/trace made each
        volume urgent, and wake the planner."""
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
                    try:
                        vid = int(det.get("volume"))
                    except (TypeError, ValueError):
                        continue
                    self._causes[vid] = {
                        "event": e.get("id", ""), "type": etype,
                        "trace": e.get("trace") or "",
                        "alert": _ALERT_FOR_TYPE.get(etype, "")}
                    wake = True
        if wake:
            self._wake.set()

    def _cause_alert_locked(self, vid: int) -> str:  # holds: _lock
        """The firing heat alert id this volume's actuation answers:
        the cause event's mapped rule when firing, else any firing
        heat rule, else the static mapping."""
        cause = self._causes.get(vid, {})
        mapped = cause.get("alert", "")
        if mapped and mapped in self._alerts:
            return mapped
        for name in ("flash_crowd", "heat_shift"):
            if name in self._alerts:
                return name
        return mapped

    def _cause(self, vid: int) -> dict:
        with self._lock:
            c = self._causes.get(vid, {})
            return {"alert": self._cause_alert_locked(vid),
                    "cause_trace": c.get("trace", ""),
                    "cause_event": c.get("event", "")}

    # --- replicated actuation records (master HA) -------------------------
    def _record(self, op: str, vid: int, cause: dict,  # leader-only
                **extra) -> None:
        """Journal one actuation lifecycle record: apply locally, then
        hand to replicate_fn (the master's synchronous raft append) so
        it survives this leader.  Called OUTSIDE _lock."""
        at = round(time.time(), 3)
        rec = {"id": f"{vid}:{op}:{at:.3f}", "op": op, "vid": vid,
               "at": at, "alert": cause.get("alert", ""),
               "cause_trace": cause.get("cause_trace", ""),
               "cause_event": cause.get("cause_event", ""), **extra}
        self.apply_replicated(rec)
        if self.replicate_fn is not None:
            try:
                self.replicate_fn(rec)
            except Exception:
                pass  # replication loss must never fail the actuation

    def apply_replicated(self, rec: dict) -> None:  # raft-apply, thread-entry
        """Land one actuation record (leader's local write or a
        follower's apply loop).  Idempotent: records dedup by id; the
        pending map is last-write-wins per volume; the added-replica
        ledger and tier registry fold in so a promoted follower knows
        what the old leader added/tiered."""
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
            if op in ("grow_planned", "tier_pending"):
                self._replicated[vid] = dict(rec)
            elif op in ("grow_done", "grow_failed", "tier_done",
                        "tier_failed", "shrink_done", "recall_done"):
                self._replicated.pop(vid, None)
            if op == "grow_done" and rec.get("dst"):
                t = self._targets.setdefault(
                    vid, {"added": [], "cycles": 0})
                if rec["dst"] not in t["added"]:
                    t["added"].append(rec["dst"])
                t["grown_at"] = float(rec.get("at") or 0.0)
            elif op == "shrink_done" and rec.get("dst"):
                t = self._targets.get(vid)
                if t is not None and rec["dst"] in t.get("added", []):
                    t["added"].remove(rec["dst"])
                    t["shrunk_at"] = float(rec.get("at") or 0.0)
                    t["cycles"] = int(t.get("cycles") or 0) + 1
            elif op == "tier_done":
                self._tiered[vid] = {
                    "server": rec.get("server", ""),
                    "backend": rec.get("backend", ""),
                    "key": rec.get("key", ""),
                    "at": float(rec.get("at") or 0.0)}
            elif op == "recall_done":
                self._tiered.pop(vid, None)

    def export_replicated(self) -> dict:
        """The replicable actuation state (raft snapshot leg)."""
        with self._lock:
            return {"pending": {str(vid): dict(r)
                                for vid, r in self._replicated.items()},
                    "log": [dict(r) for r in self._replog.values()],
                    "targets": {str(vid): dict(t)
                                for vid, t in self._targets.items()},
                    "tiered": {str(vid): dict(t)
                               for vid, t in self._tiered.items()}}

    def import_replicated(self, doc: dict) -> None:  # raft-apply
        """Install a snapshot of the actuation state (idempotent:
        replays merge by record id / volume id)."""
        for rec in (doc or {}).get("log") or []:
            self.apply_replicated(rec)
        with self._lock:
            for vid_s, rec in ((doc or {}).get("pending") or {}).items():
                try:
                    self._replicated[int(vid_s)] = dict(rec)
                except (TypeError, ValueError):
                    continue
            for vid_s, t in ((doc or {}).get("targets") or {}).items():
                try:
                    self._targets[int(vid_s)] = dict(t)
                except (TypeError, ValueError):
                    continue
            for vid_s, t in ((doc or {}).get("tiered") or {}).items():
                try:
                    self._tiered[int(vid_s)] = dict(t)
                except (TypeError, ValueError):
                    continue

    def resume_replicated(self) -> None:
        """Promotion hook: re-arm every planned-but-unfinished
        actuation from the replicated records — the orphaned plan's
        cause attribution (alert + trace + event) survives the
        election, and the run_cycle resume pass closes plans whose
        actuation already landed instead of re-running them."""
        with self._lock:
            for vid, rec in self._replicated.items():
                self._causes.setdefault(vid, {
                    "event": rec.get("cause_event", ""),
                    "type": "replicated_plan",
                    "trace": rec.get("cause_trace", ""),
                    "alert": rec.get("alert", "")})
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
            if paused:
                continue
            if self.admin_locked_fn():
                # an operator holds the shell's exclusive admin lock:
                # their volume surgery must not duel with ours
                continue
            try:
                self.run_cycle()
                with self._lock:
                    self.last_error = ""
            except Exception as e:  # keep the loop alive; surface it
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"[:300]

    def run_cycle(self) -> dict:
        """One observe->plan->actuate round, synchronous (the loop, and
        tests, call it)."""
        doc = self.heat_fn() or {}
        shares = {}
        traces = {}
        for row in doc.get("volumes") or []:
            try:
                vid = int(row.get("volume"))
            except (TypeError, ValueError):
                continue
            shares[vid] = float(row.get("share") or 0.0)
            if row.get("trace"):
                traces[vid] = row["trace"]
        head = set()
        for vid in (doc.get("head") or {}).get("volumes") or []:
            try:
                head.add(int(vid))
            except (TypeError, ValueError):
                continue
        vols = self._volume_map()
        now = time.time()
        resumed_vids = self._resume_pending(vols)
        resumed = len(resumed_vids)
        grown = self._run_grows(vols, shares, traces, head, now,
                                skip=resumed_vids)
        recalled = self._run_recalls(vols, shares, head)
        shrunk = self._run_shrinks(vols, shares, now)
        tiered = self._run_tiers(vols, shares, now)
        with self._lock:
            self.cycles += 1
            self.last_cycle_at = now
        return {"grown": grown, "shrunk": shrunk, "tiered": tiered,
                "recalled": recalled, "resumed": resumed}

    # --- topology snapshot ------------------------------------------------
    def _volume_map(self) -> dict[int, dict]:
        """vid -> {holders: [urls], collection, size, read_only} for
        every REPLICA volume, read off the live topology under its lock
        (stale peers excluded — an unreachable holder can neither serve
        the flash crowd nor accept a tier command)."""
        try:
            stale = set(self.stale_peers_fn() or ())
        except Exception:
            stale = set()
        out: dict[int, dict] = {}
        nodes: dict[str, NodeView] = {}
        with self.topo.lock:
            for n in self.topo.all_nodes():
                rack = n.rack.name if n.rack else "DefaultRack"
                dc = n.dc.name if n.dc else "DefaultDataCenter"
                nodes[n.url] = NodeView(
                    url=n.url, rack=rack, dc=dc,
                    free=float(n.free_space()),
                    ec_shards=n.ec_shard_count(),
                    alive=n.url not in stale)
                for vid, v in n.volumes.items():
                    e = out.setdefault(vid, {
                        "holders": [], "collection": v.collection,
                        "size": 0, "read_only": False})
                    e["holders"].append(n.url)
                    e["size"] = max(e["size"], int(v.size))
                    e["read_only"] = e["read_only"] or bool(v.read_only)
        with self._lock:
            self._nodes = nodes
        return out

    def _placement_view(self, vid: int, holders: list[str],
                        collection: str) -> ClusterView:
        """A ClusterView seeding the volume's replica set as shard 0
        holders, so placement_rank's rack/DC diversity pools rank
        replica targets exactly like EC shard targets."""
        with self._lock:
            nodes = dict(self._nodes)
        view = ClusterView(nodes=nodes)
        view.shards[vid] = {0: list(holders)}
        view.collections[vid] = collection
        return view

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

    # --- resume (master HA) -----------------------------------------------
    def _resume_pending(self, vols: dict[int, dict]) -> set[int]:
        """Close or re-drive plans inherited from a dead leader.  A
        grow whose copy already landed (the dst holds the volume in
        the live topology) is closed WITHOUT re-copying — zero
        duplicate replica adds; one that never landed re-executes to
        the SAME dst.  A pending tier re-issues the idempotent commit
        leg (the raft record already holds the commit decision).
        Returns the touched vids so this cycle's grow pass skips them
        (its volume map predates the resume actuations)."""
        with self._lock:
            pending = [(vid, dict(r))
                       for vid, r in self._replicated.items()]
        resumed: set[int] = set()
        for vid, rec in pending:
            op = rec.get("op")
            cause = {"alert": rec.get("alert", ""),
                     "cause_trace": rec.get("cause_trace", ""),
                     "cause_event": rec.get("cause_event", "")}
            if op == "grow_planned":
                dst = rec.get("dst") or ""
                info = vols.get(vid)
                if info is None or not dst:
                    self._record("grow_failed", vid, cause,
                                 error="volume vanished before resume")
                    continue
                if dst in info["holders"]:
                    # the old leader's copy landed: close the plan
                    self._finish_grow(vid, rec.get("src") or "", dst,
                                      cause, resumed_from=rec.get("id"))
                else:
                    self._execute_grow(vid, info, dst, cause,
                                       resumed_from=rec.get("id"))
                resumed.add(vid)
            elif op == "tier_pending":
                server = rec.get("server") or ""
                if server:
                    self._commit_tier(vid, server, dict(rec), cause)
                    resumed.add(vid)
        return resumed

    # --- hot path: grow ---------------------------------------------------
    def _run_grows(self, vols, shares, traces, head, now,
                   skip=()) -> int:
        candidates = []
        with self._lock:
            cause_vids = set(self._causes)
        for vid in sorted(head | cause_vids, key=lambda v: -shares.get(v, 0.0)):
            info = vols.get(vid)
            if info is None or vid in skip:
                continue
            if shares.get(vid, 0.0) < self.grow_share and vid not in head:
                continue
            if len(info["holders"]) >= self.max_replicas:
                continue
            with self._lock:
                if vid in self._tiered or vid in self._replicated:
                    continue  # tiered (recall path) or plan in flight
                t = self._targets.get(vid) or {}
                if int(t.get("cycles") or 0) >= \
                        self.max_cycles_per_volume:
                    continue  # thrash guard: this volume flapped enough
                if now - float(t.get("shrunk_at") or 0.0) < \
                        self.regrow_cooldown_s:
                    continue  # hysteresis: just shrunk, don't flap back
            candidates.append((vid, info))
        grown = 0
        for vid, info in candidates:
            if self._stop.is_set():
                break
            if not self._take_move_token():
                break  # budget spent; the rest keeps next cycle
            with self._lock:
                if traces.get(vid) and vid not in self._causes:
                    self._causes[vid] = {
                        "event": "", "type": "head_entry",
                        "trace": traces[vid], "alert": ""}
            cause = self._cause(vid)
            view = self._placement_view(vid, info["holders"],
                                        info["collection"])
            dst = next(iter(placement_rank(
                view, vid, 0, exclude=tuple(info["holders"]))), None)
            if dst is None:
                continue  # no rack-diverse target alive
            # quorum-replicate the plan BEFORE executing: a leader
            # killed mid-copy leaves this record for its successor,
            # which resumes (not restarts) the add against this dst
            self._record("grow_planned", vid, cause, dst=dst,
                         src=info["holders"][0],
                         share=round(shares.get(vid, 0.0), 4))
            if self._execute_grow(vid, info, dst, cause):
                grown += 1
        return grown

    def _execute_grow(self, vid: int, info: dict, dst: str,
                      cause: dict, resumed_from: str = "") -> bool:
        src = next(iter(info["holders"]), "")
        if not src:
            self._record("grow_failed", vid, cause,
                         error="no alive holder to copy from")
            return False
        try:
            with _deadline.scope(self.actuation_deadline_s):
                self.executor.admin_post(dst, "/admin/volume_copy", {
                    "volume_id": vid,
                    "collection": info["collection"],
                    "source_data_node": src})
                self.executor.refresh_heartbeats([dst])
        except Exception as e:
            # the destination already holding the volume is SUCCESS
            # arriving by another path (the old leader's copy landed
            # after our topology snapshot): never a duplicate add
            if "already here" not in str(e):
                with self._lock:
                    self.failures += 1
                    self.recent.appendleft({
                        "at": round(time.time(), 3), "vid": vid,
                        "action": "grow_failed", "dst": dst,
                        "error": f"{type(e).__name__}: {e}"[:200],
                        **cause})
                _events.emit("autoscale_failed",
                             server=self.server or None, vid=vid,
                             action="grow", dst=dst,
                             error=f"{type(e).__name__}: {e}"[:200],
                             **cause)
                self._record("grow_failed", vid, cause, dst=dst,
                             error=f"{type(e).__name__}: {e}"[:200])
                return False
        self._finish_grow(vid, src, dst, cause,
                          resumed_from=resumed_from)
        return True

    def _finish_grow(self, vid: int, src: str, dst: str, cause: dict,
                     resumed_from: str = "") -> None:
        with self._lock:
            self.grows_done += 1
            t = self._targets.setdefault(vid, {"added": [], "cycles": 0})
            if dst not in t["added"]:
                t["added"].append(dst)
            t["grown_at"] = time.time()
            self._cold_since.pop(vid, None)
            self.recent.appendleft({
                "at": round(time.time(), 3), "vid": vid,
                "action": "replica_grow", "src": src, "dst": dst,
                "resumed": bool(resumed_from), **cause})
        # the journaled replica-add carries WHY: the firing heat alert
        # id and the exemplar trace of the flash crowd that caused it
        _events.emit("replica_grow", server=self.server or None,
                     trace_id=cause.get("cause_trace") or None,
                     vid=vid, src=src, dst=dst,
                     resumed=bool(resumed_from), **cause)
        self._record("grow_done", vid, cause, dst=dst, src=src,
                     resumed_from=resumed_from)

    # --- hot path: recall -------------------------------------------------
    def _run_recalls(self, vols, shares, head) -> int:
        with self._lock:
            tiered = {vid: dict(t) for vid, t in self._tiered.items()}
        recalled = 0
        for vid, t in tiered.items():
            if shares.get(vid, 0.0) < self.grow_share and vid not in head:
                continue
            info = vols.get(vid)
            server = t.get("server") or (
                next(iter(info["holders"]), "") if info else "")
            if not server:
                continue
            cause = self._cause(vid)
            try:
                with _deadline.scope(self.actuation_deadline_s):
                    self.executor.admin_post(
                        server, "/admin/tier_download",
                        {"volume_id": vid})
            except Exception as e:
                with self._lock:
                    self.failures += 1
                    self.recent.appendleft({
                        "at": round(time.time(), 3), "vid": vid,
                        "action": "recall_failed", "server": server,
                        "error": f"{type(e).__name__}: {e}"[:200]})
                _events.emit("autoscale_failed",
                             server=self.server or None, vid=vid,
                             action="recall",
                             error=f"{type(e).__name__}: {e}"[:200],
                             **cause)
                continue
            with self._lock:
                self.recalls_done += 1
                self._tiered.pop(vid, None)
                self._cold_since.pop(vid, None)
                self.recent.appendleft({
                    "at": round(time.time(), 3), "vid": vid,
                    "action": "tier_recall", "server": server, **cause})
            _events.emit("tier_recall", server=self.server or None,
                         trace_id=cause.get("cause_trace") or None,
                         vid=vid, volume_server=server, **cause)
            self._record("recall_done", vid, cause, server=server)
            recalled += 1
        return recalled

    # --- cold path: shrink ------------------------------------------------
    def _run_shrinks(self, vols, shares, now) -> int:
        """Drop ONE added replica per sufficiently-cold volume per
        cycle, only after the hold-down has run uninterrupted — the
        hysteresis half of the thrash guard."""
        due = []
        with self._lock:
            for vid, t in self._targets.items():
                if not t.get("added"):
                    continue
                if shares.get(vid, 0.0) > self.cold_share:
                    self._cold_since.pop(vid, None)
                    continue
                since = self._cold_since.setdefault(vid, now)
                if now - since >= self.hold_down_s:
                    due.append(vid)
        shrunk = 0
        for vid in due:
            if not self._take_move_token():
                break
            info = vols.get(vid)
            cause = self._cause(vid)
            with self._lock:
                t = self._targets.get(vid) or {}
                added = list(t.get("added") or ())
            # drop the most recent add still actually holding a copy
            dst = next((u for u in reversed(added)
                        if info is None or u in info["holders"]), None)
            if dst is None:
                continue
            try:
                with _deadline.scope(self.actuation_deadline_s):
                    self.executor.admin_post(dst, "/admin/delete_volume",
                                             {"volume_id": vid})
                    self.executor.refresh_heartbeats([dst])
            except Exception as e:
                with self._lock:
                    self.failures += 1
                    self.recent.appendleft({
                        "at": round(time.time(), 3), "vid": vid,
                        "action": "shrink_failed", "dst": dst,
                        "error": f"{type(e).__name__}: {e}"[:200]})
                _events.emit("autoscale_failed",
                             server=self.server or None, vid=vid,
                             action="shrink", dst=dst,
                             error=f"{type(e).__name__}: {e}"[:200],
                             **cause)
                continue
            with self._lock:
                self.shrinks_done += 1
                t = self._targets.get(vid)
                if t is not None and dst in t.get("added", []):
                    t["added"].remove(dst)
                    t["shrunk_at"] = now
                    t["cycles"] = int(t.get("cycles") or 0) + 1
                self._cold_since.pop(vid, None)
                self._causes.pop(vid, None)
                self.recent.appendleft({
                    "at": round(time.time(), 3), "vid": vid,
                    "action": "replica_shrink", "dst": dst, **cause})
            _events.emit("replica_shrink", server=self.server or None,
                         vid=vid, dst=dst,
                         hold_down_s=self.hold_down_s, **cause)
            self._record("shrink_done", vid, cause, dst=dst)
            shrunk += 1
        return shrunk

    # --- cold path: tier --------------------------------------------------
    def _tier_eligible(self, vid: int, info: dict, shares: dict,
                       now: float) -> bool:
        if not self.tier_backend:
            return False
        if len(info["holders"]) != 1:
            return False  # only single-replica volumes tier
        with self._lock:
            if vid in self._tiered or vid in self._replicated:
                return False
            if (self._targets.get(vid) or {}).get("added"):
                return False
        full = info["size"] >= self.tier_full_frac * \
            self.volume_size_limit or info["read_only"]
        if not full:
            return False
        if shares.get(vid, 0.0) > self.cold_share:
            with self._lock:
                self._cold_since.pop(vid, None)
            return False
        with self._lock:
            since = self._cold_since.setdefault(vid, now)
        return now - since >= self.tier_after_s

    def _run_tiers(self, vols, shares, now) -> int:
        tiered = 0
        for vid, info in sorted(vols.items()):
            if not self._tier_eligible(vid, info, shares, now):
                continue
            server = info["holders"][0]
            cause = self._cause(vid)
            # two-phase: (1) upload + verify on the volume server —
            # local .dat retained, manifest `pending`
            try:
                with _deadline.scope(self.actuation_deadline_s):
                    r = self.executor.admin_post(
                        server, "/admin/tier_upload",
                        {"volume_id": vid,
                         "backend": self.tier_backend,
                         "two_phase": True})
            except Exception as e:
                with self._lock:
                    self.failures += 1
                    self.recent.appendleft({
                        "at": round(time.time(), 3), "vid": vid,
                        "action": "tier_failed", "server": server,
                        "error": f"{type(e).__name__}: {e}"[:200]})
                _events.emit("autoscale_failed",
                             server=self.server or None, vid=vid,
                             action="tier",
                             error=f"{type(e).__name__}: {e}"[:200],
                             **cause)
                continue
            manifest = (r or {}).get("manifest") or {}
            # (2) the tier_committed decision rides the raft log BEFORE
            # the local delete: this record IS the commit point — a
            # leader (or volume server) crash after it resumes the
            # commit, a crash before it garbage-collects the upload
            self._record("tier_pending", vid, cause, server=server,
                         backend=self.tier_backend,
                         key=manifest.get("key", ""),
                         file_size=manifest.get("file_size", 0),
                         crc32=manifest.get("crc32"))
            if self._commit_tier(vid, server, {
                    "backend": self.tier_backend,
                    "key": manifest.get("key", "")}, cause):
                tiered += 1
        return tiered

    def _commit_tier(self, vid: int, server: str, rec: dict,
                     cause: dict) -> bool:
        """(3) the idempotent commit leg: the volume server persists
        `committed` and drops its local `.dat`.  Safe to re-issue after
        a failover — a volume server that crashed uncommitted GC'd the
        upload, which surfaces here as tier_failed (re-planned cold)."""
        try:
            with _deadline.scope(self.actuation_deadline_s):
                self.executor.admin_post(server, "/admin/tier_commit",
                                         {"volume_id": vid})
        except Exception as e:
            with self._lock:
                self.failures += 1
                self.recent.appendleft({
                    "at": round(time.time(), 3), "vid": vid,
                    "action": "tier_failed", "server": server,
                    "error": f"{type(e).__name__}: {e}"[:200]})
            _events.emit("autoscale_failed", server=self.server or None,
                         vid=vid, action="tier_commit",
                         error=f"{type(e).__name__}: {e}"[:200],
                         **cause)
            self._record("tier_failed", vid, cause, server=server,
                         error=f"{type(e).__name__}: {e}"[:200])
            return False
        with self._lock:
            self.tiers_done += 1
            self._cold_since.pop(vid, None)
            self.recent.appendleft({
                "at": round(time.time(), 3), "vid": vid,
                "action": "tier_committed", "server": server,
                "backend": rec.get("backend", ""),
                "key": rec.get("key", ""), **cause})
        _events.emit("tier_committed", server=self.server or None,
                     vid=vid, volume_server=server,
                     backend=rec.get("backend", ""),
                     key=rec.get("key", ""), **cause)
        self._record("tier_done", vid, cause, server=server,
                     backend=rec.get("backend", ""),
                     key=rec.get("key", ""))
        return True

    # --- manual actuation (shell volume.tier) -----------------------------
    def tier_volume(self, vid: int, backend: str = "",
                    recall: bool = False) -> dict:
        """Operator-driven tier/recall (shell `volume.tier`): the SAME
        two-phase legs the autonomous cold path runs — upload+verify,
        raft-logged tier_pending commit point, idempotent commit — so
        a manually tiered volume lands in the replicated tiered
        registry and auto-recalls when heat returns.  Raises ValueError
        on operator mistakes (unknown volume, replicated volume, no
        backend), RuntimeError when an actuation leg fails."""
        vols = self._volume_map()
        if recall:
            with self._lock:
                t = dict(self._tiered.get(vid) or {})
            info = vols.get(vid)
            server = t.get("server") or (
                next(iter(info["holders"]), "") if info else "")
            if not server:
                raise ValueError(f"volume {vid} is not tiered")
            cause = self._cause(vid)
            with _deadline.scope(self.actuation_deadline_s):
                self.executor.admin_post(server, "/admin/tier_download",
                                         {"volume_id": vid})
            with self._lock:
                self.recalls_done += 1
                self._tiered.pop(vid, None)
                self._cold_since.pop(vid, None)
                self.recent.appendleft({
                    "at": round(time.time(), 3), "vid": vid,
                    "action": "tier_recall", "server": server,
                    "manual": True, **cause})
            _events.emit("tier_recall", server=self.server or None,
                         vid=vid, volume_server=server, manual=True,
                         **cause)
            self._record("recall_done", vid, cause, server=server)
            return {"recalled": vid, "server": server}
        info = vols.get(vid)
        if info is None:
            raise ValueError(f"volume {vid} not found")
        if len(info["holders"]) != 1:
            raise ValueError(
                f"volume {vid} has {len(info['holders'])} replicas; "
                "only single-replica volumes tier")
        backend = backend or self.tier_backend
        if not backend:
            raise ValueError("no tier backend: pass -backend or start "
                             "the master with -autoscale.tierBackend")
        server = info["holders"][0]
        cause = self._cause(vid)
        with _deadline.scope(self.actuation_deadline_s):
            r = self.executor.admin_post(
                server, "/admin/tier_upload",
                {"volume_id": vid, "backend": backend,
                 "two_phase": True})
        manifest = (r or {}).get("manifest") or {}
        self._record("tier_pending", vid, cause, server=server,
                     backend=backend, key=manifest.get("key", ""),
                     file_size=manifest.get("file_size", 0),
                     crc32=manifest.get("crc32"))
        if not self._commit_tier(vid, server, {
                "backend": backend,
                "key": manifest.get("key", "")}, cause):
            raise RuntimeError(
                f"tier commit failed for volume {vid}; the verified "
                "upload was rolled back (see autoscale.status)")
        return {"tiered": vid, "server": server, "backend": backend,
                "key": manifest.get("key", "")}

    # --- views ------------------------------------------------------------
    def health_contribution(self) -> dict:
        """Master-local addition to /cluster/health totals: failed
        actuations (grow/shrink/tier/recall legs that errored) — the
        autoscale_failures health key."""
        with self._lock:
            return {"autoscale_failures": int(self.failures)}

    def status(self) -> dict:
        admin_locked = False
        try:
            admin_locked = bool(self.admin_locked_fn())
        except Exception:
            pass
        with self._lock:
            return {
                "enabled": self.enabled,
                "paused": self.paused or admin_locked,
                "pause_reason": self.pause_reason or (
                    "admin_lock" if admin_locked else ""),
                "interval_s": self.interval_s,
                "cycles": self.cycles,
                "last_cycle_at": round(self.last_cycle_at, 3),
                "last_error": self.last_error,
                "knobs": {"grow_share": self.grow_share,
                          "max_replicas": self.max_replicas,
                          "cold_share": self.cold_share,
                          "hold_down_s": self.hold_down_s,
                          "regrow_cooldown_s": self.regrow_cooldown_s,
                          "max_cycles_per_volume":
                              self.max_cycles_per_volume,
                          "tier_backend": self.tier_backend,
                          "tier_after_s": self.tier_after_s},
                "targets": {str(vid): dict(t)
                            for vid, t in self._targets.items()},
                "tiered": {str(vid): dict(t)
                           for vid, t in self._tiered.items()},
                "grows": self.grows_done,
                "shrinks": self.shrinks_done,
                "tiers": self.tiers_done,
                "recalls": self.recalls_done,
                "failures": self.failures,
                "move_budget": {"rate_per_s": self.move_rate,
                                "burst": self.move_burst,
                                "tokens": round(self._tokens, 2)},
                "recent": list(self.recent),
                # the raft-replicated actuation records: identical on
                # the leader and a caught-up follower (the state-hash
                # equality surface the failover tests compare)
                "replicated": {
                    "pending": {str(v): dict(r)
                                for v, r in self._replicated.items()},
                    "log": [dict(r) for r in self._replog.values()]},
            }
