"""The resource ledger: per-request CPU, bytes and queue wait.

The port's copy of seaweedfs_tpu/observability/ledger.py.  Heat says
what is hot; the ledger says who spends which serving resource.  Every
request through the two ingress chokepoints (utils/httpd.py
``Router._run``, utils/framing.py ``serve_frame``) is stamped with its
thread CPU (``time.thread_time_ns`` measured on the thread that ran it,
so a reactor's worker handoff charges the worker), bytes in and out, its
wait for a worker (stamped by the reactor at the handoff) and the needle
cache's hits and misses (thread-local counts fed by the cache's
callbacks, settled per request), into bounded tables by route class
(reqlog.py ``classify_route``) and by client (the peer's /24).

Every cell is a set of decayed masses sharing one timestamp (one
2**(-dt/h) a settle), so a rate reads "per second, recently" and the
master adds rates across peers.

A snapshot carries two more signals: the reactor's loop lag, queue depth
and worker occupancy (utils/eventloop.py ``loop_lag_stats``, through
``loop_stats_fn``), a request that held the loop thread past
LOOP_STALL_THRESHOLD_S (a stall, with its route and exemplar trace; the
reactor's watchdog reports one through ``note_stall`` too), and the
windowed profiler's top and rising stacks (profiler.py
``WindowedProfiler``, through ``profile_fn``).

``LedgerShipper`` posts snapshots to POST /cluster/ledger/ingest each
second; the master's ``ClusterLedgerJournal`` keeps each peer's latest,
merges GET /cluster/ledger (what the shell's ``cluster.top`` renders),
and relays a peer's stall as one ``loop_stall`` event, which a default
alert rule pages on.

Accounting off is one attribute check at each chokepoint
(``router.ledger is None``); a settle is a few clock reads, one route
classification and one cell update a table.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Optional

from . import context as _trace_context
from . import reqlog as _reqlog

# the event types the master's stall relay journals; a default
# `journal_event` alert rule watches each (alerts.default_rules)
LEDGER_EVENT_TYPES = ("loop_stall",)

# the Prometheus families this plane registers (stats/metrics.py
# LedgerMetrics, and the reactor's DataplaneMetrics)
LEDGER_METRIC_FAMILIES = (
    "SeaweedFS_ledger_route_cpu_rate",
    "SeaweedFS_ledger_route_queue_wait_rate",
    "SeaweedFS_ledger_route_bytes_rate",
    "SeaweedFS_ledger_snapshots_dropped_total",
    "SeaweedFS_dataplane_loop_lag_seconds",
    "SeaweedFS_dataplane_loop_stalls_total",
    "SeaweedFS_dataplane_queue_depth",
)

# a request that held the reactor LOOP thread longer than this is a
# stall: the loop could not accept, parse or flush anything else for
# the duration (the inline fast path's budget is microseconds)
LOOP_STALL_THRESHOLD_S = 0.25

_LN2 = math.log(2.0)

# per-thread pending needle-cache verdicts: the cache callbacks fire
# on the request's own executing thread (the store lookup runs inside
# dispatch/serve_frame), so a plain thread-local count per request
# needs no lock and no plumbed identity
_tls = threading.local()


def _client_key(peer: str) -> str:
    """The per-client ledger key: peer /24 prefix for IPv4 — coarse
    enough to bound cardinality, specific enough to name a tenant's
    subnet (the future QoS key).  Non-IPv4 peers key as themselves."""
    parts = peer.split(".")
    if len(parts) == 4:
        return ".".join(parts[:3]) + ".*"
    return peer or "?"


class _Cell:
    """One ledger row: decayed masses for every accounted resource,
    sharing a single decay timestamp so a settle costs ONE exponential
    regardless of how many resources it touches."""

    __slots__ = ("ts", "req", "cpu", "bin", "bout", "qwait", "hit",
                 "miss", "trace", "trace_ts")

    def __init__(self, ts: float):
        self.ts = ts
        self.req = 0.0
        self.cpu = 0.0
        self.bin = 0.0
        self.bout = 0.0
        self.qwait = 0.0
        self.hit = 0.0
        self.miss = 0.0
        self.trace = ""
        self.trace_ts = 0.0

    def decay(self, now: float, half_life: float) -> None:
        dt = now - self.ts
        if dt > 0.0:
            f = 2.0 ** (-dt / half_life)
            self.req *= f
            self.cpu *= f
            self.bin *= f
            self.bout *= f
            self.qwait *= f
            self.hit *= f
            self.miss *= f
        self.ts = now

    def add(self, now: float, half_life: float, cpu_s: float,
            bytes_in: float, bytes_out: float, queue_wait_s: float,
            hits: float, misses: float, trace_id: str) -> None:
        self.decay(now, half_life)
        self.req += 1.0
        self.cpu += cpu_s
        self.bin += bytes_in
        self.bout += bytes_out
        self.qwait += queue_wait_s
        self.hit += hits
        self.miss += misses
        if trace_id:
            self.trace, self.trace_ts = trace_id, now

    def doc(self, now: float, half_life: float) -> dict:
        """JSON rates decayed to `now`: mass * ln2 / h estimates the
        recent per-second rate (the DecayedCounter identity)."""
        self.decay(now, half_life)
        k = _LN2 / half_life
        return {
            "req_rate": round(self.req * k, 4),
            "cpu_rate": round(self.cpu * k, 6),
            "bytes_in_rate": round(self.bin * k, 1),
            "bytes_out_rate": round(self.bout * k, 1),
            "queue_wait_rate": round(self.qwait * k, 6),
            "cache_hit_rate": round(self.hit * k, 4),
            "cache_miss_rate": round(self.miss * k, 4),
            "cpu_mass": round(self.cpu, 6),
            "trace": self.trace,
        }


class RequestLedger:
    """Per-server resource accounting at the ingress chokepoints.

    `begin()` is called at dispatch/serve_frame ENTRY on the executing
    thread and returns an opaque token; `settle_http`/`settle_native`
    close the ledger entry with the response facts.  Both are gated by
    the caller on `router.ledger is None` so accounting-off costs one
    attribute check, and the settle body is wrapped by the CALLER in
    try/except — accounting must never break the serving path."""

    def __init__(self, server: str, half_life: float = 60.0,
                 max_routes: int = 64, max_clients: int = 256,
                 enabled: bool = True):
        self.server = server
        self.half_life = max(float(half_life), 1e-3)
        self.max_routes = int(max_routes)
        self.max_clients = int(max_clients)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._routes: dict[str, _Cell] = {}  # guarded-by: _lock
        self._clients: dict[str, _Cell] = {}  # guarded-by: _lock
        self._noted = 0  # guarded-by: _lock
        self._evicted = 0  # guarded-by: _lock
        # most recent loop stall (route + exemplar trace) and a count:
        # the snapshot carries both and the master-side detector pages
        self._stalls = 0  # guarded-by: _lock
        self._last_stall: Optional[dict] = None  # guarded-by: _lock
        self._last_stall_note = 0.0  # guarded-by: _lock
        # wiring hooks (volume_server/server.py): reactor lag stats and
        # the windowed profiler's current summary ride each snapshot
        self.loop_stats_fn: Optional[Callable[[], dict]] = None
        self.profile_fn: Optional[Callable[[], dict]] = None

    # --- chokepoint hooks ----------------------------------------------

    @staticmethod
    def begin() -> tuple:
        """Entry stamp, ON the executing thread (thread CPU clocks are
        per-thread: a token minted on the loop and settled on a worker
        would charge the wrong thread).  Also resets this thread's
        pending needle-cache verdicts."""
        _tls.hits = 0
        _tls.misses = 0
        return (time.thread_time_ns(), time.perf_counter())

    def settle_http(self, token: tuple, method: str, path: str,
                    handler_name: str, status: int, bytes_in: int,
                    bytes_out: int, peer: str, trace_id: str = "",
                    queue_wait_s: float = 0.0,
                    query: Optional[dict] = None) -> None:
        route = _reqlog.classify_route(method, path, handler_name,
                                       query=query)
        self._settle(token, route, status, bytes_in, bytes_out, peer,
                     trace_id, queue_wait_s)

    def settle_native(self, token: tuple, op: bytes, status: int,
                      bytes_in: int, bytes_out: int, peer: str,
                      trace_id: str = "",
                      queue_wait_s: float = 0.0) -> None:
        route = _reqlog.NATIVE_ROUTES.get(
            op, f"native_{op.decode('latin-1')}")
        self._settle(token, route, status, bytes_in, bytes_out, peer,
                     trace_id, queue_wait_s)

    def _settle(self, token: tuple, route: str, status: int,
                bytes_in: int, bytes_out: int, peer: str,
                trace_id: str, queue_wait_s: float) -> None:
        cpu_s = max(time.thread_time_ns() - token[0], 0) / 1e9
        wall_s = time.perf_counter() - token[1]
        hits = getattr(_tls, "hits", 0)
        misses = getattr(_tls, "misses", 0)
        _tls.hits = 0
        _tls.misses = 0
        now = time.time()
        client = _client_key(peer)
        with self._lock:
            cell = self._routes.get(route)
            if cell is None:
                cell = self._table_insert(self._routes, route,
                                          self.max_routes, now)
            cell.add(now, self.half_life, cpu_s, float(bytes_in),
                     float(bytes_out), queue_wait_s, hits, misses,
                     trace_id)
            ccell = self._clients.get(client)
            if ccell is None:
                ccell = self._table_insert(self._clients, client,
                                           self.max_clients, now)
            ccell.add(now, self.half_life, cpu_s, float(bytes_in),
                      float(bytes_out), queue_wait_s, hits, misses,
                      trace_id)
            self._noted += 1
        # a request that held the reactor LOOP itself past the stall
        # threshold blocked every other connection for the duration:
        # record it with its route + exemplar trace so the master-side
        # detector can page naming the offender
        if wall_s >= LOOP_STALL_THRESHOLD_S and _on_loop_thread():
            self.note_stall(route, wall_s, trace_id)

    def _table_insert(self, table: dict, key: str, cap: int,
                      now: float) -> _Cell:
        """Bounded insert: past the cap the COLDEST row (smallest
        decayed request mass) is evicted — the ledger keeps the heavy
        hitters, exactly like the heat sketch keeps the Zipf head."""
        if len(table) >= cap:
            coldest, cold_mass = None, float("inf")
            for k, c in table.items():
                c.decay(now, self.half_life)
                if c.req < cold_mass:
                    coldest, cold_mass = k, c.req
            if coldest is not None:
                del table[coldest]
                self._evicted += 1
        cell = _Cell(now)
        table[key] = cell
        return cell

    # --- needle-cache verdicts (volume_server wiring) ------------------

    @staticmethod
    def note_cache_hit(vid: int, key: int, nbytes: int) -> None:
        """needle_cache on_hit callback (composed with the heat hook):
        counts into the CURRENT request's thread-local pending tally,
        settled into its route/client cells at request end."""
        _tls.hits = getattr(_tls, "hits", 0) + 1

    @staticmethod
    def note_cache_miss(vid: int, key: int) -> None:
        _tls.misses = getattr(_tls, "misses", 0) + 1

    # --- loop stalls ---------------------------------------------------

    def note_stall(self, route: str, lag_s: float,
                   trace_id: str = "") -> None:
        """One loop-stall moment (from a settled on-loop request, or
        from the reactor watchdog mid-block).  Rate-limited so a
        watchdog observing the SAME block every tick records one
        stall, and counted into the `loop_lag` HEALTH_FAMILIES counter
        (SeaweedFS_dataplane_loop_stalls_total) so the cluster rollup
        pages even before a snapshot ships."""
        if route.startswith("/"):
            # the watchdog only knows the RAW path the loop was busy
            # on (the inline fast path is GET-only); classify it into
            # the route class the rest of the ledger speaks, and
            # borrow that route's freshest exemplar trace — the
            # watchdog observes from outside the request, so it never
            # has one of its own
            route = _reqlog.classify_route("GET", route)
            if not trace_id:
                with self._lock:
                    cell = self._routes.get(route)
                    trace_id = cell.trace if cell is not None else ""
        now = time.time()
        with self._lock:
            if now - self._last_stall_note < 5.0:
                # same block, another observation: refresh the record
                # (the settle-side pass knows the route; the watchdog
                # may only know the loop was busy)
                if self._last_stall is not None and \
                        route != "(loop)":
                    self._last_stall["route"] = route
                    if trace_id:
                        self._last_stall["trace"] = trace_id
                    if lag_s * 1000.0 > self._last_stall["lag_ms"]:
                        self._last_stall["lag_ms"] = round(
                            lag_s * 1000.0, 1)
                return
            self._last_stall_note = now
            self._stalls += 1
            self._last_stall = {"ts": round(now, 3), "route": route,
                                "lag_ms": round(lag_s * 1000.0, 1),
                                "trace": trace_id}
        try:
            from ..stats.metrics import dataplane_metrics
            dataplane_metrics().loop_stalls.inc()
        except Exception:
            pass

    # --- snapshots -----------------------------------------------------

    def snapshot(self, top_clients: int = 32) -> dict:
        """The wire/debug doc: decayed to NOW, JSON-ready."""
        now = time.time()
        with self._lock:
            routes = {r: c.doc(now, self.half_life)
                      for r, c in self._routes.items()}
            clients = {k: c.doc(now, self.half_life)
                       for k, c in self._clients.items()}
            noted, evicted = self._noted, self._evicted
            stalls, last_stall = self._stalls, \
                dict(self._last_stall) if self._last_stall else None
        if top_clients and len(clients) > top_clients:
            keep = sorted(clients, key=lambda k: clients[k]["cpu_rate"],
                          reverse=True)[:top_clients]
            clients = {k: clients[k] for k in keep}
        doc = {"server": self.server, "ts": round(now, 3),
               "half_life_s": self.half_life, "noted": noted,
               "evicted": evicted, "routes": routes,
               "clients": clients,
               "stall": {"count": stalls, "last": last_stall}}
        if self.loop_stats_fn is not None:
            try:
                doc["loop"] = self.loop_stats_fn()
            except Exception:
                pass
        if self.profile_fn is not None:
            try:
                doc["profile"] = self.profile_fn()
            except Exception:
                pass
        return doc

    def status(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "half_life_s": self.half_life,
                    "routes": len(self._routes),
                    "clients": len(self._clients),
                    "noted": self._noted, "evicted": self._evicted,
                    "stalls": self._stalls}


def _on_loop_thread() -> bool:
    """Is the CURRENT thread a reactor loop thread?  The loop stamps
    its own thread object at startup (utils/eventloop.Reactor._run),
    so the check is one attribute read — no import of the reactor
    singleton, no lock."""
    return getattr(threading.current_thread(), "_weed_loop", False)


class LedgerShipper:
    """Periodic snapshot shipper to POST /cluster/ledger/ingest — the
    heat/trace/event transport contract: time-driven (the ledger is
    decayed STATE, the freshest snapshot supersedes older ones),
    bounded pending buffer, leader-follow rotation on failure, loss
    counted never backpressured, final best-effort flush on detach.
    Also refreshes the local per-route Prometheus gauges each cycle so
    /metrics carries the ledger without any per-request counter
    touches."""

    def __init__(self, ledger: RequestLedger, server: str,
                 master_url_fn: Optional[Callable[[], str]] = None,
                 interval: float = 1.0, buffer_cap: int = 8,
                 local_journal: Optional["ClusterLedgerJournal"] = None):
        self.ledger = ledger
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
                                                  name=f"ledger:{server}")
        self.shipped = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def attach(self) -> "LedgerShipper":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"ledger-ship:{self.server}")
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
            doc = self.ledger.snapshot()
        except Exception:
            return
        self._set_gauges(doc)
        with self._lock:
            if len(self._buf) >= self.buffer_cap:
                self._buf.popleft()  # stale state: newest wins
                self.dropped += 1
                self._count_drop()
            self._buf.append(doc)

    def _set_gauges(self, doc: dict) -> None:
        """Per-route ledger gauges, refreshed at ship cadence — the
        Prometheus surface costs nothing on the request path."""
        try:
            from ..stats.metrics import ledger_metrics
            m = ledger_metrics()
            for route, row in (doc.get("routes") or {}).items():
                m.route_cpu.set(route, row["cpu_rate"])
                m.route_qwait.set(route, row["queue_wait_rate"])
                m.route_bytes.set(route, "in", row["bytes_in_rate"])
                m.route_bytes.set(route, "out", row["bytes_out_rate"])
        except Exception:
            pass

    def _count_drop(self) -> None:
        try:
            from ..stats.metrics import ledger_metrics
            ledger_metrics().snapshots_dropped.inc()
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
                self.transport.post("/cluster/ledger/ingest",
                                    {"server": self.server,
                                     "snapshots": batch},
                                    timeout=timeout)
            with self._lock:
                self.shipped += len(batch)
        except Exception:
            # master down / not elected: a stale ledger is worthless —
            # the batch is LOST and counted; the transport rotated to
            # the next master and re-learns the leader on reply
            with self._lock:
                self.dropped += len(batch)
                self._count_drop()


class ClusterLedgerJournal:
    """The master's merged cost view + loop-stall relay.  Reached
    concurrently from the threaded HTTP router (ingest POSTs,
    /cluster/ledger GETs) and the telemetry loop."""

    def __init__(self, stale_s: float = 15.0,
                 min_event_interval: float = 5.0):
        self.stale_s = stale_s
        self.min_event_interval = min_event_interval
        self._lock = threading.Lock()
        self._peers: dict[str, dict] = {}  # guarded-by: _lock
        # per-peer stall relay floor: (count, last event wall time)
        self._stall_seen: dict[str, tuple] = {}  # guarded-by: _lock
        self._stall_events: deque = deque(maxlen=32)  # guarded-by: _lock
        self.ingested = 0  # guarded-by: _lock

    # --- ingest --------------------------------------------------------

    def ingest(self, server: str, snapshots: list[dict]) -> int:
        if not snapshots:
            return 0
        latest = max(snapshots,
                     key=lambda s: float(s.get("ts") or 0.0))
        with self._lock:
            self._peers[server] = latest
            self.ingested += len(snapshots)
        self._detect_stall(server, latest)
        return len(snapshots)

    def _detect_stall(self, server: str, snap: dict) -> None:
        """Relay a peer-reported loop stall as ONE `loop_stall`
        journal event (the detector-relay alert pattern): the snapshot
        already carries the verdict — offending route, lag, exemplar
        trace — so the rule pages without re-deriving anything."""
        stall = snap.get("stall") or {}
        count = int(stall.get("count") or 0)
        last = stall.get("last") or None
        if not count or not last:
            return
        now = time.time()
        with self._lock:
            seen, last_emit = self._stall_seen.get(server, (0, 0.0))
            if count <= seen or \
                    now - last_emit < self.min_event_interval:
                if count > seen:
                    # rate-limited: remember we saw it so a quiet peer
                    # does not re-fire an old stall later
                    self._stall_seen[server] = (count, last_emit)
                return
            self._stall_seen[server] = (count, now)
        from . import events as _events
        try:
            ev = _events.emit(
                "loop_stall", server=server,
                trace_id=last.get("trace") or None,
                route=last.get("route") or "?",
                lag_ms=last.get("lag_ms") or 0.0,
                stalls=count, servers=[server])
            with self._lock:
                self._stall_events.append(ev.to_dict())
        except Exception:
            pass

    # --- views ---------------------------------------------------------

    def merged(self, now: Optional[float] = None) -> dict:
        """Cluster-wide rates: per-route and per-client sums across
        non-stale peers (rates, not masses — peers decay locally), and
        per-server totals for the -by server axis."""
        now = time.time() if now is None else now
        with self._lock:
            peers = dict(self._peers)
        routes: dict[str, dict] = {}
        clients: dict[str, dict] = {}
        servers: dict[str, dict] = {}
        for url, snap in peers.items():
            if now - float(snap.get("ts") or 0.0) > self.stale_s:
                continue
            srv_cpu = srv_req = srv_qwait = 0.0
            for table, out in ((snap.get("routes") or {}, routes),
                               (snap.get("clients") or {}, clients)):
                for key, row in table.items():
                    agg = out.setdefault(key, {
                        "req_rate": 0.0, "cpu_rate": 0.0,
                        "bytes_in_rate": 0.0, "bytes_out_rate": 0.0,
                        "queue_wait_rate": 0.0, "cache_hit_rate": 0.0,
                        "cache_miss_rate": 0.0, "trace": "",
                        "servers": []})
                    for f in ("req_rate", "cpu_rate", "bytes_in_rate",
                              "bytes_out_rate", "queue_wait_rate",
                              "cache_hit_rate", "cache_miss_rate"):
                        agg[f] += float(row.get(f) or 0.0)
                    if row.get("trace"):
                        agg["trace"] = row["trace"]
                    agg["servers"].append(url)
            for row in (snap.get("routes") or {}).values():
                srv_cpu += float(row.get("cpu_rate") or 0.0)
                srv_req += float(row.get("req_rate") or 0.0)
                srv_qwait += float(row.get("queue_wait_rate") or 0.0)
            loop = snap.get("loop") or {}
            servers[url] = {
                "cpu_rate": round(srv_cpu, 6),
                "req_rate": round(srv_req, 4),
                "queue_wait_rate": round(srv_qwait, 6),
                "loop_lag_p99_ms":
                    float(loop.get("lag_p99_ms") or 0.0),
                "stalls":
                    int((snap.get("stall") or {}).get("count") or 0),
            }
        return {"routes": routes, "clients": clients,
                "servers": servers}

    def to_doc(self, top: int = 20) -> dict:
        """The full /cluster/ledger document."""
        now = time.time()
        merged = self.merged(now)
        total_cpu = sum(r["cpu_rate"]
                        for r in merged["routes"].values()) or 0.0

        def ranked(table: dict, key_name: str) -> list[dict]:
            rows = []
            for key, row in table.items():
                r = dict(row)
                r[key_name] = key
                r["cpu_share"] = round(r["cpu_rate"] / total_cpu, 4) \
                    if total_cpu > 0 else 0.0
                for f in ("req_rate", "cpu_rate", "bytes_in_rate",
                          "bytes_out_rate", "queue_wait_rate",
                          "cache_hit_rate", "cache_miss_rate"):
                    r[f] = round(r[f], 6)
                rows.append(r)
            rows.sort(key=lambda r: (-r["cpu_rate"], -r["req_rate"],
                                     r[key_name]))
            return rows[:top]

        with self._lock:
            peers_raw = dict(self._peers)
            stall_events = list(self._stall_events)
        peers = {}
        profiles = {}
        for url, snap in peers_raw.items():
            ts = float(snap.get("ts") or 0.0)
            peers[url] = {
                "ts": round(ts, 3),
                "stale": now - ts > self.stale_s,
                "noted": int(snap.get("noted") or 0),
                "loop": snap.get("loop") or {},
                "stall": snap.get("stall") or {},
            }
            if snap.get("profile"):
                profiles[url] = snap["profile"]
        srv_rows = [dict(v, server=u) for u, v in
                    merged["servers"].items()]
        total_srv_cpu = sum(r["cpu_rate"] for r in srv_rows) or 0.0
        for r in srv_rows:
            r["cpu_share"] = round(r["cpu_rate"] / total_srv_cpu, 4) \
                if total_srv_cpu > 0 else 0.0
        srv_rows.sort(key=lambda r: (-r["cpu_rate"], r["server"]))
        return {
            "ts": round(now, 3),
            "peers": peers,
            "routes": ranked(merged["routes"], "route"),
            "clients": ranked(merged["clients"], "client"),
            "servers": srv_rows,
            "profiles": profiles,
            "stalls": stall_events,
            "totals": {
                "cpu_rate": round(total_cpu, 6),
                "req_rate": round(sum(
                    r["req_rate"]
                    for r in merged["routes"].values()), 4),
            },
        }
