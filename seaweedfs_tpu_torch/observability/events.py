"""Structured cluster event journal: the record of what happened.

The port's copy of seaweedfs_tpu/observability/events.py.  A counter says
"3 since boot" and a span ring evicts; the journal keeps a bounded,
thread-safe ring of TYPED events emitted where the degraded-path counters
are bumped:

    from seaweedfs_tpu_torch.observability import events as _events
    _events.emit("shard_corrupt", source="scrub", shard=3, path=base)

Each event carries a type from EVENT_TYPES (which gives its default
severity), a wall timestamp, the emitting server (the request's
thread-local, or the journal's one registered server), the active sampled
trace id, the join key to the stitched trace that explains it, and a
small details dict.

Served per server at GET /debug/events and shipped to the master by
EventShipper (the TraceShipper pattern: a chained hook, a bounded buffer,
batch POSTs, loss counted and never back-pressured) into the master's
ClusterEventJournal at GET /cluster/events, whose ingest hook feeds the
EC coordinator.

The port emits these types: ``shard_corrupt`` (ec/integrity.py),
``scrub_repair``, ``scrub_repair_failed``, ``scrub_unrepairable``
(volume_server/scrubber.py), ``peer_stale`` (stats/aggregate.py),
``degraded_bind`` (the volume server's and the master's framed planes),
``ec_under_replicated``, ``repair_planned``, ``repair_done``,
``repair_failed``, ``rebalance_move`` (ops/coordinator.py),
``retry_budget_exhausted`` (utils/backoff.py), ``load_shed``
(utils/admission.py), ``deadline_exceeded`` (utils/httpd.py),
``alert_pending``, ``alert_fired``, ``alert_resolved``
(observability/alerts.py), ``flight_capture``
(observability/flightrecorder.py), ``reqlog_dropped``
(observability/reqlog.py), ``heat_shift`` and ``flash_crowd``
(observability/heat.py), ``loop_stall`` (observability/ledger.py) and
``dataplane_conn_abort`` (utils/eventloop.py).  The rest of the registry
is carried as data, so a reference server's journal documents keep their
severities here.

emit() runs only on degraded paths and coordinator actions, never on a
clean hot path, so the journal needs no enable gate.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from time import monotonic
from typing import Callable, Optional

from . import context as _trace_context

# severity order matters: min_severity filters compare by rank
SEVERITIES = ("info", "warning", "error", "critical")
SEVERITY_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# the event-type registry: every emit site of the port uses one of these
# types, and each carries its default severity (the reference's)
EVENT_TYPES = {
    "shard_corrupt": "error",           # ec/integrity.py note_corruption
    "scrub_repair": "warning",          # scrubber quarantine+rebuild ok
    "scrub_repair_failed": "error",     # rebuild raised; rot remains
    "scrub_unrepairable": "critical",   # < k clean shards left
    "peer_stale": "warning",            # master scrape lost a peer
    "degraded_bind": "warning",         # TCP plane bind failed
    # rebuild/rebalance coordinator (ops/coordinator.py, master-side)
    "ec_under_replicated": "error",  # volume dropped below k+1 clean
    "repair_planned": "info",        # coordinator queued + started one
    "repair_done": "info",           # volume back to full shard set
    "repair_failed": "error",        # plan step failed; will re-plan
    "rebalance_move": "info",        # one budgeted shard move executed
    "retry_budget_exhausted": "warning",  # token bucket denied a retry
    "load_shed": "warning",          # admission control answered 503
    "deadline_exceeded": "warning",  # X-Weed-Deadline budget spent: 504
    # alerting engine state transitions (observability/alerts.py)
    "alert_pending": "info",
    "alert_fired": "error",
    "alert_resolved": "info",
    # flight recorder captures (observability/flightrecorder.py)
    "flight_capture": "info",
    # the request log (observability/reqlog.py): access records lost
    "reqlog_dropped": "warning",
    # the event loop (utils/eventloop.py): a connection aborted
    "dataplane_conn_abort": "warning",
    # heat's shift detector (observability/heat.py)
    "heat_shift": "warning",
    "flash_crowd": "error",
    # the resource ledger's stall relay (observability/ledger.py)
    "loop_stall": "error",
    # the heat autoscaler (ops/autoscaler.py, master-side)
    "replica_grow": "info",          # a read replica added for the head
    "replica_shrink": "info",        # an added replica dropped when cold
    "tier_committed": "info",        # a cold volume's .dat moved remote
    "tier_recall": "info",           # a tiered volume brought back
    "autoscale_failed": "error",     # an actuation leg failed
}

# the reference's other event types, whose emitters the port does not
# have (worker supervision, engine fallback): data only,
# so a reference server's events keep their severity in the port's
# journals
REFERENCE_ONLY_EVENT_TYPES = {
    "worker_restart": "warning", "engine_fallback": "warning",
}

# HEALTH_FAMILIES key (stats/aggregate.py) -> the event type emitted where
# that family's counter is bumped, for the families the port emits
HEALTH_EVENT_TYPES = {
    "corrupt_shards": "shard_corrupt",
    "scrub_repairs": "scrub_repair",
    "ec_under_replicated": "ec_under_replicated",
    "coordinator_repair_failures": "repair_failed",
    "requests_shed": "load_shed",
    "deadline_exceeded": "deadline_exceeded",
    "retry_budget_exhausted": "retry_budget_exhausted",
    "degraded_binds": "degraded_bind",
    "reqlog_records_dropped": "reqlog_dropped",
    "dataplane_conn_aborts": "dataplane_conn_abort",
    "loop_lag": "loop_stall",
    "autoscale_failures": "autoscale_failed",
}

# the reference's rows of that mapping for the families the port has no
# emitter of: data only, so the alert rule on each such family takes the
# reference's severity
REFERENCE_ONLY_HEALTH_EVENT_TYPES = {
    "worker_restarts": "worker_restart",
    "engine_fallbacks": "engine_fallback",
}


def default_severity(type_: str) -> str:
    return EVENT_TYPES.get(type_) or \
        REFERENCE_ONLY_EVENT_TYPES.get(type_, "info")


class Event:
    """One journaled cluster event.  `id` is namespaced like span ids
    (process-unique salt + sequence) so the master-side journal can
    dedup re-ships and co-located in-process shippers."""

    __slots__ = ("type", "severity", "server", "ts", "trace_id",
                 "details", "seq", "id")

    def __init__(self, type_: str, severity: str, server: Optional[str],
                 ts: float, trace_id: Optional[str], details: dict,
                 seq: int, id_: str):
        self.type = type_
        self.severity = severity
        self.server = server
        self.ts = ts
        self.trace_id = trace_id
        self.details = details
        self.seq = seq
        self.id = id_

    def to_dict(self) -> dict:
        d = {"id": self.id, "seq": self.seq, "type": self.type,
             "severity": self.severity, "ts": round(self.ts, 3),
             "details": self.details}
        if self.server:
            d["server"] = self.server
        if self.trace_id:
            d["trace"] = self.trace_id
        return d


def _match(e: dict, type_: Optional[str] = None,
           severity: Optional[str] = None,
           min_severity: Optional[str] = None,
           since_seq: int = 0, since_ts: float = 0.0) -> bool:
    """Shared filter predicate over event DICTS (the wire shape)."""
    if type_ and e.get("type") != type_:
        return False
    if severity and e.get("severity") != severity:
        return False
    if min_severity:
        if SEVERITY_RANK.get(e.get("severity"), 0) < \
                SEVERITY_RANK.get(min_severity, 0):
            return False
    if since_seq and int(e.get("seq") or 0) <= since_seq:
        return False
    if since_ts and float(e.get("ts") or 0.0) <= since_ts:
        return False
    return True


class EventJournal:
    """Bounded thread-safe ring of typed events (one per process)."""

    def __init__(self, capacity: int = 2048,
                 namespace: Optional[str] = None):
        self._events: deque[Event] = deque(maxlen=capacity)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        # same salting rationale as the tracer: bare pids collide across
        # containerized hosts and the master journal dedups by event id
        self.namespace = namespace or (
            f"e{os.getpid():x}x{os.urandom(3).hex()}")
        # ring evictions — a truncated journal says so
        self.dropped = 0  # guarded-by: _lock
        # shipping hook (EventShipper): called with every emitted Event
        self.on_emit: Optional[Callable[[Event], None]] = None
        # server identities of the attached shippers: when exactly ONE
        # server owns this process's journal (the production shape),
        # emits from background threads (drainers, supervisors) that
        # carry no request thread-local still stamp correctly; with
        # co-located servers the stamp is AMBIGUOUS and the event ships
        # unattributed rather than letting whichever shipper's copy
        # wins the collector's dedup claim it
        self._servers: list[str] = []  # guarded-by: _lock

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def register_server(self, server: str) -> None:
        with self._lock:
            self._servers.append(server)

    def unregister_server(self, server: str) -> None:
        with self._lock:
            if server in self._servers:
                self._servers.remove(server)

    def _default_server(self) -> Optional[str]:
        with self._lock:
            unique = set(self._servers)
            return next(iter(unique)) if len(unique) == 1 else None

    def emit(self, type_: str, severity: Optional[str] = None,  # thread-entry
             server: Optional[str] = None,
             trace_id: Optional[str] = None, **details) -> Event:
        """Journal one event — from ANY thread (drainers, supervisors,
        scan loops; the thread-entry annotation makes the lockset
        checker model that).  Severity defaults from EVENT_TYPES; the
        trace id defaults to the calling thread's ACTIVE sampled trace
        context and the server to the request's owning-server identity
        (both thread-local reads — emit sites never plumb identity)."""
        if severity is None:
            severity = default_severity(type_)
        if trace_id is None:
            ctx = _trace_context.current_sampled()
            trace_id = ctx.trace_id if ctx is not None else None
        if server is None:
            server = _trace_context.current_server() or \
                self._default_server()
        with self._lock:
            self._seq += 1
            ev = Event(type_, severity, server, time.time(), trace_id,
                       details, self._seq,
                       f"{self.namespace}.{self._seq:x}")
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
        hook = self.on_emit
        if hook is not None:
            try:
                hook(ev)
            except Exception:
                pass  # shipping must never break the degraded path
        return ev

    def snapshot(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def query(self, type_: Optional[str] = None,
              severity: Optional[str] = None,
              min_severity: Optional[str] = None,
              since_seq: int = 0, since_ts: float = 0.0,
              limit: int = 256) -> list[dict]:
        """Filtered event dicts in chronological order, keeping the most
        RECENT `limit` matches (a tail, not a head — the fresh end is
        what an operator asks for)."""
        out = [e.to_dict() for e in self.snapshot()]
        out = [e for e in out
               if _match(e, type_, severity, min_severity,
                         since_seq, since_ts)]
        return out[-max(int(limit), 0):] if limit else out


class ClusterEventJournal:  # weedlint: concurrent-class
    """The master's merged journal: per-server journals ship here
    (EventShipper), dedup'd by event id, bounded by oldest-first
    eviction — the /cluster/events store.  Reached concurrently from
    the threaded HTTP router (ingest POSTs + query GETs)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._events: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.dropped = 0  # guarded-by: _lock
        # consumer hook: called OUTSIDE the lock with each batch of
        # newly-accepted (non-duplicate) event dicts — the rebuild
        # coordinator subscribes here instead of polling the journal
        self.on_ingest: Optional[Callable[[list[dict]], None]] = None

    def ingest(self, server: str, events: list[dict]) -> int:
        accepted: list[dict] = []
        with self._lock:
            for e in events:
                eid = e.get("id")
                if not eid or eid in self._events:
                    continue  # duplicate ship (chained shippers, retry)
                e = dict(e)
                # the transport's identity is only a LABEL of who
                # shipped, never a claim of who emitted: an event that
                # arrives unattributed (ambiguous co-located journal)
                # stays unattributed
                e["via"] = server
                self._events[eid] = e
                accepted.append(e)
            while len(self._events) > self.capacity:
                self._events.popitem(last=False)
                self.dropped += 1
        hook = self.on_ingest
        if hook is not None and accepted:
            try:
                hook(list(accepted))
            except Exception:
                pass  # a broken consumer must never break ingest
        return len(accepted)

    def query(self, type_: Optional[str] = None,
              severity: Optional[str] = None,
              min_severity: Optional[str] = None,
              since_ts: float = 0.0, server: Optional[str] = None,
              limit: int = 256) -> list[dict]:
        with self._lock:
            events = list(self._events.values())
        out = [e for e in events
               if _match(e, type_, severity, min_severity, 0, since_ts)
               and (not server or e.get("server") == server)]
        # shipped batches interleave across servers: order by time for a
        # coherent cluster timeline (id breaks ts ties stably)
        out.sort(key=lambda e: (float(e.get("ts") or 0.0),
                                str(e.get("id"))))
        return out[-max(int(limit), 0):] if limit else out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class EventShipper:
    """Ship this process's journal to the master's cluster journal —
    the TraceShipper transport pattern (collector.py): chained on_emit
    hook, bounded buffer, batch POST on a flush thread, loss COUNTED
    (never backpressure on the emitting path), `local_journal`
    short-circuit for the master's own events."""

    def __init__(self, journal: EventJournal, server: str,
                 master_url_fn: Optional[Callable[[], str]] = None,
                 local_journal: Optional[ClusterEventJournal] = None,
                 batch_size: int = 64, flush_interval: float = 0.5,
                 buffer_cap: int = 1024):
        self.journal = journal
        self.server = server
        self.master_url_fn = master_url_fn
        self.local_journal = local_journal
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.buffer_cap = buffer_cap
        self._buf: deque[Event] = deque()  # guarded-by: _lock
        self._lock = threading.Lock()
        # one batch on the wire at a time: flush() returns only after a
        # batch the flush thread took earlier has landed
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # hook-chain handoff: written by attach()/detach() on the
        # server's lifecycle thread before the flush thread starts /
        # after it stops; read lock-free on every emit
        self._prev_hook: Optional[Callable[[Event], None]] = None
        # the shared leader-follow policy (utils/leader.py; imported here:
        # utils/httpd.py imports this package at load), internally locked
        from ..utils.leader import LeaderFollowingTransport

        self.transport = LeaderFollowingTransport(master_url_fn,
                                                  name=f"events:{server}")
        self.shipped = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        # the master the batch on the wire goes to
        self._inflight_url: Optional[str] = None  # guarded-by: _lock

    def attach(self) -> "EventShipper":
        self._prev_hook = self.journal.on_emit
        self.journal.on_emit = self._on_event
        self.journal.register_server(self.server)
        self._thread = threading.Thread(target=self._flush_loop,
                                        daemon=True,
                                        name=f"event-ship:{self.server}")
        self._thread.start()
        return self

    def detach(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # == (not is): each attribute read makes a new bound method
        if self.journal.on_emit == self._on_event:
            self.journal.on_emit = self._prev_hook
        self.journal.unregister_server(self.server)
        # final flush with a sub-second timeout: at cluster teardown the
        # master is often already gone and stop() must not hang
        self.flush(timeout=0.5)

    def _on_event(self, ev: Event) -> None:  # thread-entry
        # called on whatever thread emitted (drainers, scan loops);
        # a detached shipper left mid-chain degrades to a pass-through
        if not self._stop.is_set():
            with self._lock:
                if len(self._buf) >= self.buffer_cap:
                    self.dropped += 1
                else:
                    self._buf.append(ev)
                    if len(self._buf) >= self.batch_size:
                        self._wake.set()
        prev = self._prev_hook
        if prev is not None:
            prev(ev)

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval)
            self._wake.clear()
            self.flush()

    def flush(self, timeout: float = 5.0) -> None:
        """Ship every event journaled so far before returning (a batch
        already in flight included), in about ``timeout`` seconds: the
        wait for a batch in flight counts against it.  A batch on its way
        to a master the server has since left is not waited for.  When
        the wait spends the time, the events stay buffered for the flush
        thread."""
        deadline = monotonic() + timeout
        if not self._send_lock.acquire(blocking=False):
            with self._lock:
                inflight = self._inflight_url
            if inflight is not None and self.master_url_fn is not None \
                    and inflight not in self.transport.candidates()[:1]:
                return
            if not self._send_lock.acquire(
                    timeout=max(deadline - monotonic(), 0.0)):
                return
        try:
            left = deadline - monotonic()
            if left <= 0:
                return
            self._ship(left)
        finally:
            self._send_lock.release()

    def _ship(self, timeout: float) -> None:  # holds: _send_lock
        with self._lock:
            if not self._buf:
                return
            batch = list(self._buf)
            self._buf.clear()
        # the server stamp is decided at EMIT time (thread-local or the
        # journal's sole-shipper default) — a shipper must not claim
        # unattributed events as its own: with co-located servers both
        # chained shippers ship the same event id and whichever copy
        # wins the collector's dedup would misattribute it
        docs = [ev.to_dict() for ev in batch]
        if self.local_journal is not None:
            self.local_journal.ingest(self.server, docs)
            with self._lock:
                self.shipped += len(docs)
            return
        try:
            url = self.transport.target()
            with self._lock:
                self._inflight_url = url
            # shipping must never trace itself (same rule as spans)
            with _trace_context.scope(_trace_context.NOT_SAMPLED):
                self.transport.post("/cluster/events/ingest",
                                    {"server": self.server, "events": docs},
                                    timeout=timeout)
            with self._lock:
                self.shipped += len(docs)
        except Exception:
            # master down or not elected: the batch is LOST and counted;
            # the transport rotated to the next configured master and
            # learns the leader from an ingest answer after the election.
            # Counter updates ride _lock: the flush thread and the
            # detach()-time final flush race these read-modify-writes
            with self._lock:
                self.dropped += len(docs)
        finally:
            with self._lock:
                self._inflight_url = None


# --- process-global journal --------------------------------------------------
# Every layer emits into ONE journal per process (like the tracer), so
# /debug/events and the shipper see corrupt shards from ec/, scrub
# verdicts from volume_server/ and the coordinator's actions from the
# master without plumbing a journal handle through each constructor.

_GLOBAL = EventJournal()


def get_journal() -> EventJournal:
    return _GLOBAL


def emit(type_: str, severity: Optional[str] = None,
         server: Optional[str] = None, trace_id: Optional[str] = None,
         **details) -> Event:
    """Module-level convenience: journal one event on the process-global
    journal (the one-liner the degraded-path chokepoints call)."""
    return _GLOBAL.emit(type_, severity=severity, server=server,
                        trace_id=trace_id, **details)
