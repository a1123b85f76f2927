"""Heat: decayed per-volume and per-needle access heat.

The port's copy of seaweedfs_tpu/observability/heat.py: the sensing layer
that says what is hot (the Haystack story: hot content in memory and
replicas, cold content erasure-coded).

  DecayedCounter      exponentially decayed mass with a half-life;
                      rate() turns mass into events a second.  Merging
                      decays both to one instant and adds, so it is
                      associative and per-server snapshots compose.
  SpaceSavingSketch   bounded top-K needle heat (Metwally's space-saving
                      over decayed masses): the Zipf head stays known
                      without state per fid.
  HeatAccumulator     one per volume server, fed at the chokepoints:
                      ``Router._run`` (object routes of the HTTP plane),
                      the framed plane (``TcpVolumeServer``) and the
                      needle cache's hit and admission callbacks.  Serves
                      GET /debug/heat.
  HeatShipper         snapshots to the master each second: a bounded
                      buffer, the leader-following transport, loss
                      counted, never back-pressure on serving.
  ClusterHeatJournal  the master's merged view (GET /cluster/heat):
                      volume ranks, a live Zipf fit over the merged needle
                      sketch (``estimate_zipf_s``, the port's copy of
                      seaweedfs_tpu/scenarios/replay.py's), the head set,
                      server and rack imbalance gauges, and a head-set
                      shift detector that journals ``heat_shift`` and
                      ``flash_crowd`` events (the volume, its share, its
                      holders, an exemplar trace) that the default
                      ``journal_event`` alert rules page on.

Accounting off is one attribute check at each chokepoint (``router.heat
is None``); on, a compiled-regex match and a few dict and float
operations under one small lock.  The port's cost of it on the card's
host is in PERF.md (``chip_smoke.py`` phase ``telemetry``, on/off/on).
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Callable, Optional

from . import context as _trace_context
from . import events as _events

_LN2 = math.log(2.0)

# the event types (events.EVENT_TYPES) the shift detector journals; a
# default `journal_event` alert rule watches each (alerts.default_rules)
HEAT_EVENT_TYPES = ("heat_shift", "flash_crowd")

# the metric families this plane owns (stats/metrics.py heat_metrics())
HEAT_METRIC_FAMILIES = ("SeaweedFS_volume_heat",
                        "SeaweedFS_heat_imbalance_ratio",
                        "SeaweedFS_heat_snapshots_dropped_total")

# object routes on the HTTP plane: /<vid>,<fid-rest> — same shape the
# router's fid parsing accepts; everything else (/status, /metrics,
# /batch/*, /debug/*) is control plane and carries no per-volume heat
_FID_PATH_RE = re.compile(r"^/(\d+),")


class DecayedCounter:
    """Exponentially-decayed event mass.  add(x, now) decays the mass
    to `now` then adds x; value(now) reads without mutating.  Under a
    CONSTANT input rate r the mass converges to r*half_life/ln2, so
    rate(now) = value(now)*ln2/half_life recovers events/s.  Merging
    decays both sides to one instant and adds — associative and
    commutative, the property the master-side journal leans on.

    Not internally locked: the owning accumulator/journal serializes
    access (instances are plain [mass, ts] state, like the sketch)."""

    __slots__ = ("half_life", "mass", "ts")

    def __init__(self, half_life: float = 30.0, mass: float = 0.0,
                 ts: float = 0.0):
        self.half_life = max(float(half_life), 1e-3)
        self.mass = float(mass)
        self.ts = float(ts)

    def _decay_to(self, now: float) -> None:
        if now > self.ts:
            self.mass *= 2.0 ** (-(now - self.ts) / self.half_life)
            self.ts = now

    def add(self, amount: float, now: float) -> None:
        self._decay_to(now)
        self.mass += amount

    def value(self, now: float) -> float:
        if now <= self.ts:
            return self.mass
        return self.mass * 2.0 ** (-(now - self.ts) / self.half_life)

    def rate(self, now: float) -> float:
        """Decayed events-per-second estimate."""
        return self.value(now) * _LN2 / self.half_life

    def merged(self, other: "DecayedCounter") -> "DecayedCounter":
        """A new counter holding both masses decayed to the later
        timestamp.  (a ⊕ b) ⊕ c == a ⊕ (b ⊕ c): decay is
        multiplicative in elapsed time, so the order of pairwise
        decays cannot change the final mass."""
        ts = max(self.ts, other.ts)
        return DecayedCounter(self.half_life,
                             self.value(ts) + other.value(ts), ts)

    def retune(self, half_life: float, now: float) -> None:
        """Change the half-life in place (drills shrink it so shares
        move on sub-second scales); mass is decayed under the OLD
        constant first so history is not re-interpreted."""
        self._decay_to(now)
        self.half_life = max(float(half_life), 1e-3)


class SpaceSavingSketch:
    """Bounded decayed top-K: Metwally space-saving over EWMA masses.

    A known key updates in O(1).  When the table is full, a new key
    replaces an approximately-coldest resident and INHERITS its decayed
    mass as `err` (the space-saving overestimate bound).  "Approximately
    coldest" is amortized: one O(K log K) harvest collects the coldest
    ~K/8 keys into a pool that subsequent replacements consume, so the
    steady-state tail-miss cost is O(log K) amortized, not O(K).

    Not internally locked — the owning accumulator/journal serializes
    access (same contract as DecayedCounter)."""

    __slots__ = ("capacity", "half_life", "_e", "_pool")

    def __init__(self, capacity: int = 512, half_life: float = 30.0):
        self.capacity = max(int(capacity), 8)
        self.half_life = max(float(half_life), 1e-3)
        # key -> [mass, ts, err]
        self._e: dict[str, list] = {}
        # (key, mass_at_harvest) coldest-first pool, consumed from the end
        self._pool: list[tuple[str, float]] = []

    def __len__(self) -> int:
        return len(self._e)

    def _decayed(self, ent: list, now: float) -> float:
        if now <= ent[1]:
            return ent[0]
        return ent[0] * 2.0 ** (-(now - ent[1]) / self.half_life)

    def _harvest(self, now: float) -> None:
        n = max(self.capacity // 8, 1)
        cold = sorted(((self._decayed(ent, now), k)
                       for k, ent in self._e.items()))[:n]
        # coldest LAST so .pop() consumes coldest-first
        self._pool = [(k, m) for m, k in reversed(cold)]

    def touch(self, key: str, now: float, amount: float = 1.0) -> None:
        ent = self._e.get(key)
        if ent is not None:
            ent[0] = self._decayed(ent, now) + amount
            ent[1] = now
            return
        if len(self._e) < self.capacity:
            self._e[key] = [amount, now, 0.0]
            return
        victim_mass = 0.0
        victim = None
        while self._pool:
            k, harvest_mass = self._pool.pop()
            ent = self._e.get(k)
            if ent is None:
                continue  # already evicted by an earlier replacement
            m = self._decayed(ent, now)
            if m > 2.0 * harvest_mass + 1.0:
                continue  # got hot since the harvest: not a victim
            victim, victim_mass = k, m
            break
        if victim is None:
            self._harvest(now)
            if self._pool:
                victim, victim_mass = self._pool.pop()
                victim_mass = self._decayed(self._e[victim], now)
        if victim is None:  # capacity >= 8 keys, all vanished: degenerate
            self._e[key] = [amount, now, 0.0]
            return
        del self._e[victim]
        # space-saving inheritance: the newcomer may BE the victim's
        # successor in disguise — carry the evicted mass as both count
        # floor and error bound
        self._e[key] = [victim_mass + amount, now, victim_mass]

    def top(self, now: float, k: int = 0) -> list[dict]:
        """Hottest-first [{key, mass, err}]; k=0 returns all."""
        rows = [{"key": key, "mass": self._decayed(ent, now),
                 "err": ent[2]}
                for key, ent in self._e.items()]
        rows.sort(key=lambda r: -r["mass"])
        return rows[:k] if k else rows

    def retune(self, half_life: float, now: float) -> None:
        for ent in self._e.values():
            ent[0] = self._decayed(ent, now)
            ent[1] = now
        self.half_life = max(float(half_life), 1e-3)


class _VolumeHeat:
    """Per-volume decayed signals (all guarded by the accumulator's
    lock).  error share = errors / (reads + errors) over the decay
    window — a volume serving 500s gets hot in the WRONG way and the
    placement consumer must see that."""

    __slots__ = ("reads", "bytes", "writes", "cache_hits", "errors",
                 "trace_id", "trace_ts")

    def __init__(self, half_life: float):
        self.reads = DecayedCounter(half_life)
        self.bytes = DecayedCounter(half_life)
        self.writes = DecayedCounter(half_life)
        self.cache_hits = DecayedCounter(half_life)
        self.errors = DecayedCounter(half_life)
        self.trace_id = ""     # latest sampled trace that touched it
        self.trace_ts = 0.0

    def doc(self, now: float) -> dict:
        reads = self.reads.rate(now)
        errors = self.errors.rate(now)
        total = reads + errors
        return {
            "read_rate": round(reads, 4),
            "byte_rate": round(self.bytes.rate(now), 1),
            "write_rate": round(self.writes.rate(now), 4),
            "cache_hit_rate": round(self.cache_hits.rate(now), 4),
            "error_rate": round(errors, 4),
            "error_share": round(errors / total, 4) if total > 1e-9
            else 0.0,
            "mass": round(self.reads.value(now), 3),
            "trace": self.trace_id,
        }


class HeatAccumulator:
    """One per VOLUME SERVER (never process-global: co-located test
    fixtures must not pool heat, and the master attributes per peer).
    Fed from the HTTP router hook, the framed-TCP handlers and the
    needle-cache callbacks — all request threads, hence every public
    method is a thread root."""

    def __init__(self, server: str = "", half_life: float = 30.0,
                 top_k: int = 512, enabled: bool = True):
        self.server = server
        self.enabled = bool(enabled)
        self.half_life = float(half_life)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._vols: dict[int, _VolumeHeat] = {}  # guarded-by: _lock
        self._sketch = SpaceSavingSketch(top_k, half_life)  # guarded-by: _lock
        self._noted = 0  # guarded-by: _lock

    # --- chokepoint feeds (hot path: keep the critical section tiny) --

    def _vol(self, vid: int) -> _VolumeHeat:  # holds: _lock
        vh = self._vols.get(vid)
        if vh is None:
            vh = self._vols[vid] = _VolumeHeat(self.half_life)
        return vh

    def note_http(self, method: str, path: str, status: int,
                  nbytes: int, trace_id: str = "") -> None:
        """Router.dispatch hook: every HTTP response, object routes
        only (the fid regex gates before any locking)."""
        m = _FID_PATH_RE.match(path)
        if m is None:
            return
        try:
            vid = int(m.group(1))
            fid = path[1:].partition("?")[0]
            if method in ("GET", "HEAD"):
                if status >= 500:
                    self.note_error(vid)
                elif status < 400:
                    self.note_read(vid, nbytes, fid=fid,
                                   trace_id=trace_id)
            elif status < 500:
                self.note_write(vid, nbytes)
            else:
                self.note_error(vid)
        except Exception:
            pass  # accounting must never break the serving path

    def note_read(self, vid: int, nbytes: int, fid: str = "",
                  trace_id: str = "") -> None:
        now = time.time()
        with self._lock:
            vh = self._vol(vid)
            vh.reads.add(1.0, now)
            if nbytes:
                vh.bytes.add(float(nbytes), now)
            if trace_id:
                vh.trace_id, vh.trace_ts = trace_id, now
            if fid:
                self._sketch.touch(fid, now)
            self._noted += 1

    def note_write(self, vid: int, nbytes: int = 0) -> None:
        now = time.time()
        with self._lock:
            vh = self._vol(vid)
            vh.writes.add(1.0, now)
            if nbytes:
                vh.bytes.add(float(nbytes), now)
            self._noted += 1

    def note_error(self, vid: int) -> None:
        now = time.time()
        with self._lock:
            self._vol(vid).errors.add(1.0, now)
            self._noted += 1

    def note_cache_hit(self, vid: int, key: int, nbytes: int) -> None:
        """needle_cache on_hit callback: hit MASS is a distinct signal
        (a fully cache-absorbed volume still holds the working set)."""
        now = time.time()
        with self._lock:
            self._vol(vid).cache_hits.add(1.0, now)
            self._sketch.touch(f"{vid},{key:x}", now, 0.5)

    def note_cache_admit(self, vid: int, key: int) -> None:
        """needle_cache on_admit callback: admission is the cache's own
        popularity verdict — boost the needle in the sketch."""
        now = time.time()
        with self._lock:
            self._sketch.touch(f"{vid},{key:x}", now, 1.0)

    # --- TCP plane (tcp.py _handle_one) -------------------------------

    def note_native(self, op: str, vid: int, nbytes: int,
                    fid: str = "", error: bool = False) -> None:
        if error:
            self.note_error(vid)
        elif op == "R":
            ctx = _trace_context.current_sampled()
            self.note_read(vid, nbytes, fid=fid,
                           trace_id=ctx.trace_id if ctx else "")
        else:  # W / D: write-side churn
            self.note_write(vid, nbytes)

    # --- snapshots -----------------------------------------------------

    def set_half_life(self, half_life: float) -> None:
        """Retune decay in place (scenario drills shrink it so a head
        shift shows within seconds)."""
        now = time.time()
        with self._lock:
            self.half_life = max(float(half_life), 1e-3)
            for vh in self._vols.values():
                for c in (vh.reads, vh.bytes, vh.writes, vh.cache_hits,
                          vh.errors):
                    c.retune(half_life, now)
            self._sketch.retune(half_life, now)

    def snapshot(self, top_k: int = 64) -> dict:
        """The wire/debug doc: decayed to NOW, JSON-ready."""
        now = time.time()
        with self._lock:
            vols = {str(vid): vh.doc(now)
                    for vid, vh in self._vols.items()}
            needles = [{"fid": r["key"], "mass": round(r["mass"], 3),
                        "err": round(r["err"], 3)}
                       for r in self._sketch.top(now, top_k)]
            noted = self._noted
            half_life = self.half_life
        return {"server": self.server, "ts": round(now, 3),
                "half_life_s": half_life, "noted": noted,
                "volumes": vols, "needles": needles}

    def status(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "half_life_s": self.half_life,
                    "volumes": len(self._vols),
                    "sketch_keys": len(self._sketch),
                    "noted": self._noted}


class HeatShipper:
    """Periodic snapshot shipper to POST /cluster/heat/ingest — the
    established transport contract (bounded pending buffer, leader-
    follow rotation on failure, loss counted, final best-effort flush
    on detach).  Time-driven rather than hook-driven: heat is a decayed
    STATE, so the freshest snapshot supersedes older ones and the
    buffer holds at most a short tail for a master that just came
    back."""

    def __init__(self, heat: HeatAccumulator, server: str,
                 master_url_fn: Optional[Callable[[], str]] = None,
                 interval: float = 1.0, buffer_cap: int = 8,
                 local_journal: Optional["ClusterHeatJournal"] = None):
        self.heat = heat
        self.server = server
        self.master_url_fn = master_url_fn
        self.interval = interval
        self.local_journal = local_journal
        self.buffer_cap = buffer_cap
        self._buf: deque[dict] = deque()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # shared leader-follow policy (utils/leader.py) — internally locked
        from ..utils.leader import LeaderFollowingTransport
        self.transport = LeaderFollowingTransport(master_url_fn,
                                                  name=f"heat:{server}")
        self.shipped = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def attach(self) -> "HeatShipper":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heat-ship:{self.server}")
        self._thread.start()
        return self

    def detach(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._snap()
        self._flush(timeout=0.5)

    def _snap(self) -> None:
        try:
            doc = self.heat.snapshot()
        except Exception:
            return
        with self._lock:
            if len(self._buf) >= self.buffer_cap:
                self._buf.popleft()  # stale state: newest wins
                self.dropped += 1
                self._count_drop()
            self._buf.append(doc)

    def _count_drop(self) -> None:  # holds: _lock
        try:
            from ..stats.metrics import heat_metrics
            heat_metrics().snapshots_dropped.inc()
        except Exception:
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._snap()
            self._flush()

    def _flush(self, timeout: float = 3.0) -> None:
        with self._lock:
            if not self._buf:
                return
            batch = list(self._buf)
            self._buf.clear()
        if self.local_journal is not None:
            self.local_journal.ingest(self.server, batch)
            with self._lock:
                self.shipped += len(batch)
            return
        try:
            # telemetry must never trace itself (same rule as spans)
            with _trace_context.scope(_trace_context.NOT_SAMPLED):
                self.transport.post("/cluster/heat/ingest",
                                    {"server": self.server,
                                     "snapshots": batch},
                                    timeout=timeout)
            with self._lock:
                self.shipped += len(batch)
        except Exception:
            # master down / not elected: stale heat is worthless — the
            # batch is LOST and counted; the transport rotated to the
            # next master and re-learns the leader from ingest replies
            with self._lock:
                self.dropped += len(batch)
                self._count_drop()


class ClusterHeatJournal:
    """The master's merged heat view + head-set shift detector.
    Reached concurrently from the threaded HTTP router (ingest POSTs,
    /cluster/heat GETs) and the telemetry loop."""

    def __init__(self, head_size: int = 5, trail_s: float = 10.0,
                 head_min_share: float = 0.15,
                 shift_min_share: float = 0.25,
                 cold_share: float = 0.05,
                 flash_share: float = 0.5,
                 min_event_interval: float = 5.0,
                 stale_s: float = 15.0,
                 rack_fn: Optional[Callable[[str], str]] = None):
        self.head_size = head_size
        self.trail_s = trail_s
        self.head_min_share = head_min_share
        self.shift_min_share = shift_min_share
        self.cold_share = cold_share
        self.flash_share = flash_share
        self.min_event_interval = min_event_interval
        self.stale_s = stale_s
        self.rack_fn = rack_fn
        self._lock = threading.Lock()
        self._peers: dict[str, dict] = {}  # guarded-by: _lock
        # (ts, {vid: share}) trailing head-share history
        self._history: deque = deque(maxlen=256)  # guarded-by: _lock
        self._last_event: dict[int, float] = {}  # guarded-by: _lock
        self._shifts: deque = deque(maxlen=32)  # guarded-by: _lock
        self.ingested = 0  # guarded-by: _lock
        # post-ingest hook: called OUTSIDE _lock with each merged view
        # — the heat autoscaler's event-driven wake (set by the master,
        # mirroring ClusterEventJournal.on_ingest)
        self.on_ingest: Optional[Callable[[dict], None]] = None

    # --- ingest --------------------------------------------------------

    def ingest(self, server: str, snapshots: list[dict]) -> int:
        if not snapshots:
            return 0
        latest = max(snapshots,
                     key=lambda s: float(s.get("ts") or 0.0))
        with self._lock:
            self._peers[server] = latest
            self.ingested += len(snapshots)
        self._after_ingest()
        return len(snapshots)

    def _after_ingest(self) -> None:
        now = time.time()
        merged = self.merged(now)
        self._update_gauges(merged)
        self._detect_shift(merged, now)
        hook = self.on_ingest
        if hook is not None:
            try:
                hook(merged)
            except Exception:
                pass  # a consumer bug must never fail heat ingest

    # --- merge ---------------------------------------------------------

    def merged(self, now: Optional[float] = None) -> dict:
        """Cross-peer per-volume heat: rates summed (rates — unlike
        masses with differing half-lives — compose), holders listed,
        exemplar trace kept from the freshest peer that saw one."""
        now = time.time() if now is None else now
        with self._lock:
            peers = dict(self._peers)
        vols: dict[int, dict] = {}
        needle_mass: dict[str, float] = {}
        for server, snap in peers.items():
            if now - float(snap.get("ts") or 0.0) > self.stale_s:
                continue
            for vid_s, doc in (snap.get("volumes") or {}).items():
                try:
                    vid = int(vid_s)
                except ValueError:
                    continue
                agg = vols.setdefault(vid, {
                    "volume": vid, "read_rate": 0.0, "byte_rate": 0.0,
                    "write_rate": 0.0, "cache_hit_rate": 0.0,
                    "error_rate": 0.0, "servers": [], "trace": ""})
                for k in ("read_rate", "byte_rate", "write_rate",
                          "cache_hit_rate", "error_rate"):
                    agg[k] = round(agg[k] + float(doc.get(k) or 0.0), 4)
                agg["servers"].append(server)
                if doc.get("trace") and not agg["trace"]:
                    agg["trace"] = doc["trace"]
            for row in snap.get("needles") or []:
                fid = row.get("fid")
                if fid:
                    needle_mass[fid] = needle_mass.get(fid, 0.0) + \
                        float(row.get("mass") or 0.0)
        for agg in vols.values():
            total = agg["read_rate"] + agg["error_rate"]
            agg["error_share"] = round(
                agg["error_rate"] / total, 4) if total > 1e-9 else 0.0
            # the ranking signal: served reads plus cache-absorbed hits
            agg["heat"] = round(
                agg["read_rate"] + agg["cache_hit_rate"], 4)
        return {"volumes": vols, "needles": needle_mass,
                "peers": peers, "ts": now}

    @staticmethod
    def _shares(vols: dict[int, dict]) -> dict[int, float]:
        total = sum(v["heat"] for v in vols.values())
        if total <= 1e-9:
            return {}
        return {vid: v["heat"] / total for vid, v in vols.items()}

    def _head(self, shares: dict[int, float]) -> list[int]:
        ranked = sorted(shares, key=lambda v: -shares[v])
        return [v for v in ranked[:self.head_size]
                if shares[v] >= self.head_min_share]

    # --- gauges --------------------------------------------------------

    def _update_gauges(self, merged: dict) -> None:
        try:
            from ..stats.metrics import heat_metrics
            m = heat_metrics()
        except Exception:
            return
        vols = merged["volumes"]
        m.volume_heat.clear()
        per_server: dict[str, float] = {}
        for vid, agg in vols.items():
            m.volume_heat.set(str(vid), agg["heat"])
            share = agg["heat"] / max(len(agg["servers"]), 1)
            for s in agg["servers"]:
                per_server[s] = per_server.get(s, 0.0) + share
        m.imbalance.clear()
        m.imbalance.set("server", _imbalance(per_server.values()))
        if self.rack_fn is not None:
            racks: dict[str, float] = {}
            for s, h in per_server.items():
                try:
                    rack = self.rack_fn(s) or "unknown"
                except Exception:
                    rack = "unknown"
                racks[rack] = racks.get(rack, 0.0) + h
            m.imbalance.set("rack", _imbalance(racks.values()))

    # --- shift detection ----------------------------------------------

    def _detect_shift(self, merged: dict, now: float) -> None:
        shares = self._shares(merged["volumes"])
        with self._lock:
            # thin the history to ~trail_s/8 resolution
            if not self._history or \
                    now - self._history[-1][0] >= self.trail_s / 8.0:
                self._history.append((now, shares))
            trailing = None
            for ts, snap in reversed(self._history):
                if now - ts >= self.trail_s:
                    trailing = snap
                    break
        if not shares or not trailing:
            # startup grace: no trailing baseline yet, or only one taken
            # before any read (it ranks nothing, so the cluster's first
            # reads are no crowd; the reference's pages flash_crowd on
            # them, ROADMAP Queue 3)
            return
        head = self._head(shares)
        trail_head = set(self._head(trailing))
        for vid in head:
            share = shares[vid]
            prev = trailing.get(vid, 0.0)
            if vid in trail_head or share < self.shift_min_share:
                continue
            with self._lock:
                if now - self._last_event.get(vid, 0.0) < \
                        self.min_event_interval:
                    continue
                self._last_event[vid] = now
            agg = merged["volumes"].get(vid) or {}
            flash = prev <= self.cold_share and share >= self.flash_share
            etype = "flash_crowd" if flash else "heat_shift"
            ev = _events.emit(
                etype,
                trace_id=agg.get("trace") or None,
                volume=vid, share=round(share, 3),
                prev_share=round(prev, 3),
                read_rate=agg.get("read_rate", 0.0),
                servers=list(agg.get("servers") or []),
                window_s=round(self.trail_s, 1))
            with self._lock:
                self._shifts.append(ev.to_dict())

    # --- the /cluster/heat document -----------------------------------

    def to_doc(self, top_needles: int = 20) -> dict:
        now = time.time()
        merged = self.merged(now)
        vols = merged["volumes"]
        shares = self._shares(vols)
        ranked = sorted(vols.values(), key=lambda v: -v["heat"])
        for row in ranked:
            row["share"] = round(shares.get(row["volume"], 0.0), 4)
        needles = sorted(merged["needles"].items(),
                         key=lambda kv: -kv[1])
        counts = [m for _, m in needles if m > 0.0]
        zipf_s = _zipf_fit(counts)
        per_server = {s: round(sum(
            v["heat"] / max(len(v["servers"]), 1)
            for v in vols.values() if s in v["servers"]), 4)
            for s in merged["peers"]}
        with self._lock:
            shifts = list(self._shifts)
            ingested = self.ingested
        return {
            "ts": round(now, 3),
            "volumes": ranked,
            "head": {"volumes": self._head(shares),
                     "min_share": self.head_min_share,
                     "size": self.head_size},
            "zipf": {"s": zipf_s, "distinct": len(counts),
                     "top": [{"fid": f, "mass": round(m, 3)}
                             for f, m in needles[:top_needles]]},
            "imbalance": {
                "server": _imbalance(per_server.values()),
                "per_server": per_server},
            "peers": {s: {"ts": snap.get("ts"),
                          "half_life_s": snap.get("half_life_s"),
                          "volumes": len(snap.get("volumes") or {}),
                          "stale": now - float(snap.get("ts") or 0.0)
                          > self.stale_s}
                      for s, snap in merged["peers"].items()},
            "shifts": shifts,
            "ingested": ingested,
        }


def _imbalance(values) -> float:
    """max/mean heat ratio across a scope (1.0 = perfectly balanced);
    0.0 when the scope is empty or entirely cold."""
    vals = [v for v in values]
    if not vals:
        return 0.0
    mean = sum(vals) / len(vals)
    if mean <= 1e-9:
        return 0.0
    return round(max(vals) / mean, 3)


def estimate_zipf_s(counts: list[float]) -> float:
    """Zipf exponent from popularity counts by least squares on (log
    rank, log count): the port's copy of seaweedfs_tpu/scenarios/
    replay.py's.  One distinct key or none has no measurable skew (0.0);
    the result is clamped to [0.0, 3.0]."""
    counts = sorted((c for c in counts if c > 0), reverse=True)
    if len(counts) < 2:
        return 0.0
    xs = [math.log(rank + 1.0) for rank in range(len(counts))]
    ys = [math.log(c) for c in counts]
    n = float(len(xs))
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0.0:
        return 0.0
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
    return max(0.0, min(-slope, 3.0))


def _zipf_fit(counts: list[float]) -> float:
    """The live Zipf skew over the merged needle masses."""
    if len(counts) < 3:
        return 0.0
    try:
        return estimate_zipf_s(counts)
    except Exception:  # noqa: BLE001 - a fit never fails the view
        return 0.0
