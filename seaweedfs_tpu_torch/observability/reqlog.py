"""The request log: a bounded, sampled ring of access records.

The port's copy of seaweedfs_tpu/observability/reqlog.py.  The events,
alerts and traces say what went wrong; this says what the traffic looks
like.  It records the request stream at the two ingress chokepoints that
see every operation:

  - ``Router._run`` (utils/httpd.py): the HTTP plane of every role;
  - ``serve_frame`` (utils/framing.py): the framed-TCP plane (op R, W,
    D, B and P frames), on either front.

Each sampled request becomes one ``AccessRecord``: its route class
(``classify_route``: http_read, http_write, http_delete, native_*,
assign, lookup, ops, internal, other), method, status, bytes in and out,
duration, the deadline budget it arrived with, the shed and degraded (a
5xx answer) flags, the sampled trace id and the peer.  Credentials are
redacted when the record is made (``redact_query``): a ``?jwt=...`` must
never reach a recording an operator exports.

The recorder is one per process (``get_recorder``), shared by both
chokepoints and every server of the process.  Off, it costs one
attribute check a request; on, one seeded draw a request and the record
only for the sampled share.  The ring is bounded and every loss is
counted on ``SeaweedFS_reqlog_records_dropped_total{reason}`` (and
journaled as ``reqlog_dropped``, at most one event each 10 s).

``ReqlogShipper`` sends sampled records to the master (a chained hook, a
bounded buffer, batch POSTs, loss counted and never back-pressured) into
its ``WorkloadJournal`` at GET /cluster/workload, whose ``/export`` view
is the recording document.

Knobs: ``python -m seaweedfs_tpu_torch -reqlog.sample R -reqlog.size N
<role>`` or WEED_REQLOG_SAMPLE / WEED_REQLOG_SIZE, and live through POST
/debug/reqlog/start|stop (what the shell's ``workload.record`` sends to
every server).
"""

from __future__ import annotations

import os
import re
import threading
import time
import urllib.parse
from collections import OrderedDict, deque
from random import Random
from typing import Callable, Optional

from . import context as _trace_context

# query parameters whose values are credentials, redacted when a record
# is made; the key must match exactly (case-insensitive): ?keys= is data,
# ?key= a credential
SENSITIVE_PARAMS = frozenset((
    "jwt", "token", "auth", "authorization", "sig", "signature",
    "secret", "password", "accesskey", "secretkey", "key",
    "x-amz-signature", "x-amz-credential", "x-amz-security-token",
))
REDACTED = "REDACTED"

# operator and telemetry routes, not workload: recorded only with
# include_ops (a recording must not learn its own scrapes and shipper
# POSTs)
OPS_PREFIXES = ("/metrics", "/debug", "/cluster", "/admin", "/heartbeat",
                "/raft", "/stats", "/status", "/ui", "/dir/status",
                "/vol/", "/col/", "/ec/")

_OBJECT_PATH_RE = re.compile(r"^/\d+,[0-9a-f]+", re.IGNORECASE)


def redact_query(path: str) -> str:
    """``path?query`` with every SENSITIVE_PARAMS value replaced by
    ``REDACTED``; the path and other values survive.  The query is
    re-encoded with urlencode, so encoded values round-trip; a query that
    does not parse is dropped whole, never recorded unredacted."""
    base, sep, qs = path.partition("?")
    if not sep:
        return path
    try:
        pairs = urllib.parse.parse_qsl(qs, keep_blank_values=True)
    except ValueError:
        return base
    out = [(k, REDACTED if k.lower() in SENSITIVE_PARAMS else v)
           for k, v in pairs]
    return base + "?" + urllib.parse.urlencode(out) if out else base


def classify_route(method: str, path: str, handler: str = "",
                   query: Optional[dict] = None) -> str:
    """One HTTP request's route class.  Object routes (``/<vid>,<fid>``),
    the batch routes and ``/submit`` are workload; the operator surface is
    ``ops``; a server-to-server hop (``?type=replicate``, the master's
    ``/submit`` upload with ``?type=proxied``) is ``internal``, so a
    proxied or replicated write counts once; anything else is ``other``."""
    if query and query.get("type") in ("replicate", "proxied"):
        return "internal"
    if _OBJECT_PATH_RE.match(path):
        if method in ("GET", "HEAD"):
            return "http_read"
        if method == "DELETE":
            return "http_delete"
        return "http_write"
    if path.startswith("/batch/read"):
        return "http_read"
    if path.startswith("/batch/write"):
        return "http_write"
    if path.startswith("/submit"):
        return "http_write"
    if path.startswith("/dir/assign"):
        return "assign"
    if path == "/dir/lookup" or path.startswith("/dir/lookup"):
        return "lookup"
    if any(path.startswith(p) for p in OPS_PREFIXES):
        return "ops"
    return "other"


NATIVE_ROUTES = {b"R": "native_read", b"W": "native_write",
                 b"D": "native_delete",
                 # a batch frame carries N needles but is read or write
                 # workload all the same
                 b"B": "native_read", b"P": "native_write"}


def _dropped_counter():
    """SeaweedFS_reqlog_records_dropped_total{reason}: records lost to
    the ring (ring_evict), the journal (journal_evict) or the shipper
    (ship_buffer, ship_error)."""
    global _dropped
    with _reqlog_lock:
        if _dropped is None:
            from ..stats import REGISTRY

            _dropped = REGISTRY.counter(
                "SeaweedFS_reqlog_records_dropped_total",
                "Workload access records dropped before export/shipping.",
                labels=("reason",))
        return _dropped


_dropped = None
_reqlog_lock = threading.Lock()


def dropped_total() -> int:
    """This process's lost records over every reason: the master adds it
    to its /cluster/health contribution (its own registry is never
    scraped)."""
    return int(sum(_dropped_counter().snapshot().values()))


# the counter counts every loss; the journal gets one event each 10 s
_EVENT_MIN_INTERVAL_S = 10.0


class AccessRecord:
    """One sampled request, already redacted."""

    __slots__ = ("route", "method", "path", "status", "bytes_in",
                 "bytes_out", "duration_ms", "deadline_s", "shed",
                 "degraded", "trace_id", "peer", "server", "handler",
                 "ts", "seq", "id", "sample")

    def __init__(self, route: str, method: str, path: str, status: int,
                 bytes_in: int, bytes_out: int, duration_ms: float,
                 deadline_s: Optional[float], shed: bool, degraded: bool,
                 trace_id: Optional[str], peer: str, server: Optional[str],
                 handler: str, ts: float, seq: int, id_: str,
                 sample: float = 1.0):
        self.route = route
        self.method = method
        self.path = path
        self.status = status
        self.bytes_in = bytes_in
        self.bytes_out = bytes_out
        self.duration_ms = duration_ms
        self.deadline_s = deadline_s
        self.shed = shed
        self.degraded = degraded
        self.trace_id = trace_id
        self.peer = peer
        self.server = server
        self.handler = handler
        self.ts = ts
        self.seq = seq
        self.id = id_
        self.sample = sample

    def to_dict(self) -> dict:
        d = {"id": self.id, "seq": self.seq, "ts": round(self.ts, 3),
             "route": self.route, "method": self.method,
             "path": self.path, "status": self.status,
             "in": self.bytes_in, "out": self.bytes_out,
             "ms": round(self.duration_ms, 3)}
        if self.sample < 1.0:
            # a sampled record stands for 1/sample requests
            d["sample"] = self.sample
        if self.handler:
            d["handler"] = self.handler
        if self.deadline_s is not None:
            d["ddl_s"] = round(self.deadline_s, 3)
        if self.shed:
            d["shed"] = True
        if self.degraded:
            d["degraded"] = True
        if self.trace_id:
            d["trace"] = self.trace_id
        if self.peer:
            d["peer"] = self.peer
        if self.server:
            d["server"] = self.server
        return d


class ReqlogRecorder:
    """Bounded sampled ring of AccessRecords (one per process).

    Sampling is a seeded draw per request: the same seed over the same
    request sequence admits the same records.  ``enabled`` is the one
    attribute the chokepoints read; start() and stop() flip it live."""

    def __init__(self, capacity: int = 8192, sample: float = 0.1,
                 seed: int = 0x5EED, include_ops: bool = False,
                 namespace: Optional[str] = None):
        self.enabled = False
        self.sample = float(sample)
        self.include_ops = include_ops
        self._records: deque[AccessRecord] = deque(maxlen=max(int(capacity), 16))  # guarded-by: _lock
        self._rng = Random(seed)  # guarded-by: _lock
        self._seed = seed
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self.seen = 0  # guarded-by: _lock
        self.recorded = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        self.started_at = 0.0  # guarded-by: _lock
        self._last_drop_event = 0.0  # guarded-by: _lock
        # salted like span and event ids: the master's journal dedups by
        # id, and bare pids collide across hosts
        self.namespace = namespace or (
            f"r{os.getpid():x}x{os.urandom(3).hex()}")
        # the shipper's hook, called with every record
        self.on_record: Optional[Callable[[AccessRecord], None]] = None

    @property
    def capacity(self) -> int:
        return self._records.maxlen or 0

    def configure(self, sample: Optional[float] = None,
                  capacity: Optional[int] = None,
                  seed: Optional[int] = None,
                  include_ops: Optional[bool] = None) -> None:
        """Apply knobs live: a running recording keeps what it holds
        unless the ring shrinks (and then counts what it lost)."""
        with self._lock:
            if sample is not None:
                self.sample = max(0.0, min(float(sample), 1.0))
            if include_ops is not None:
                self.include_ops = bool(include_ops)
            if seed is not None:
                self._seed = int(seed)
                self._rng = Random(self._seed)
            if capacity is not None:
                # clamped before the slice: [-0:] would keep everything
                capacity = max(int(capacity), 16)
                if capacity != self._records.maxlen:
                    keep = list(self._records)[-capacity:]
                    lost = len(self._records) - len(keep)
                    self._records = deque(keep, maxlen=capacity)
                    if lost > 0:
                        self.dropped += lost
                        _dropped_counter().inc("ring_evict", amount=lost)

    def start(self, sample: Optional[float] = None,
              capacity: Optional[int] = None,
              seed: Optional[int] = None,
              include_ops: Optional[bool] = None,
              reset: bool = True) -> None:
        self.configure(sample=sample, capacity=capacity, seed=seed,
                       include_ops=include_ops)
        with self._lock:
            if reset:
                self._records.clear()
                self.seen = 0
                self.recorded = 0
                self._rng = Random(self._seed)
            self.started_at = time.time()
        self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    def record(self, route: str, method: str, path: str, status: int,
               bytes_in: int = 0, bytes_out: int = 0,
               duration_ms: float = 0.0,
               deadline_s: Optional[float] = None, shed: bool = False,
               degraded: bool = False, peer: str = "",
               handler: str = "") -> Optional[AccessRecord]:
        """Sample and record one request, on the thread that served it;
        None when the draw rejected it.  ``path`` arrives redacted."""
        if route in ("ops", "internal") and not self.include_ops:
            return None
        note_drop = False
        with self._lock:
            self.seen += 1
            if self.sample < 1.0 and self._rng.random() >= self.sample:
                return None
            self._seq += 1
            trace_ctx = _trace_context.current_sampled()
            rec = AccessRecord(
                route, method, path, int(status), int(bytes_in),
                int(bytes_out), float(duration_ms), deadline_s,
                bool(shed), bool(degraded),
                trace_ctx.trace_id if trace_ctx is not None else None,
                peer, _trace_context.current_server(), handler,
                time.time(), self._seq,
                f"{self.namespace}.{self._seq:x}",
                sample=self.sample)
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
                _dropped_counter().inc("ring_evict")
                now = time.monotonic()
                if now - self._last_drop_event >= _EVENT_MIN_INTERVAL_S:
                    self._last_drop_event = now
                    note_drop = True
            self._records.append(rec)
            self.recorded += 1
        if note_drop:
            # outside the ring's lock: the journal takes its own
            _emit_drop_event("ring_evict")
        hook = self.on_record
        if hook is not None:
            try:
                hook(rec)
            except Exception:  # noqa: BLE001 - shipping never breaks serving
                pass
        return rec

    def snapshot(self) -> list[AccessRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.seen = 0
            self.recorded = 0
            self.dropped = 0

    def query(self, route: Optional[str] = None, since_ts: float = 0.0,
              limit: int = 512) -> list[dict]:
        """Record dicts, filtered, the newest ``limit`` (<= 0: all)."""
        out = [r.to_dict() for r in self.snapshot()
               if (not route or r.route == route)
               and (not since_ts or r.ts > since_ts)]
        limit = max(int(limit), 0)
        return out[-limit:] if limit else out

    def status(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "sample": self.sample,
                    "capacity": self._records.maxlen,
                    "records": len(self._records),
                    "seen": self.seen, "recorded": self.recorded,
                    "dropped": self.dropped,
                    "include_ops": self.include_ops,
                    "seed": self._seed,
                    "started_at": round(self.started_at, 3),
                    "namespace": self.namespace}


def _emit_drop_event(reason: str) -> None:
    from . import events as _events

    try:
        _events.emit("reqlog_dropped", reason=reason)
    except Exception:  # noqa: BLE001 - accounting never breaks serving
        pass


def summarize_records(records: list[dict]) -> dict:
    """Per-route counts, byte totals and errors, and the window the
    records span: /cluster/workload's summary and the shell's lines."""
    routes: dict[str, dict] = {}
    t0 = t1 = 0.0
    for r in records:
        row = routes.setdefault(r.get("route", "other"), {
            "ops": 0, "errors": 0, "bytes_in": 0, "bytes_out": 0})
        row["ops"] += 1
        if int(r.get("status") or 0) >= 400:
            row["errors"] += 1
        row["bytes_in"] += int(r.get("in") or 0)
        row["bytes_out"] += int(r.get("out") or 0)
        ts = float(r.get("ts") or 0.0)
        if ts:
            t0 = ts if not t0 else min(t0, ts)
            t1 = max(t1, ts)
    return {"records": len(records), "routes": routes,
            "window_s": round(max(t1 - t0, 0.0), 3),
            "t0": round(t0, 3), "t1": round(t1, 3)}


class WorkloadJournal:
    """The master's merged recording: every server's records, deduped by
    id, the oldest evicted past ``capacity``.  Reached from the router's
    threads at once (ingest POSTs, query and export GETs)."""

    FORMAT = "seaweedfs-tpu-workload-recording-v1"

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._records: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.dropped = 0  # guarded-by: _lock
        # called outside the lock with each batch of newly accepted
        # records: the master's raft replication subscribes here
        self.on_ingest: Optional[Callable[[list[dict]], None]] = None

    def ingest(self, server: str, records: list[dict]) -> int:
        accepted: list[dict] = []
        with self._lock:
            for r in records:
                rid = r.get("id")
                if not rid or rid in self._records:
                    continue  # shipped twice (chained shippers, a retry)
                r = dict(r)
                r["via"] = server
                self._records[rid] = r
                accepted.append(r)
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
                self.dropped += 1
                _dropped_counter().inc("journal_evict")
        hook = self.on_ingest
        if hook is not None and accepted:
            try:
                hook(list(accepted))
            except Exception:  # noqa: BLE001 - a consumer never breaks ingest
                pass
        return len(accepted)

    def query(self, route: Optional[str] = None, server: Optional[str] = None,
              since_ts: float = 0.0, limit: int = 512) -> list[dict]:
        with self._lock:
            records = list(self._records.values())
        out = [r for r in records
               if (not route or r.get("route") == route)
               and (not server or r.get("server") == server
                    or r.get("via") == server)
               and (not since_ts or float(r.get("ts") or 0.0) > since_ts)]
        out.sort(key=lambda r: (float(r.get("ts") or 0.0),
                                str(r.get("id"))))
        limit = max(int(limit), 0)
        return out[-limit:] if limit else out

    def export(self, route: Optional[str] = None,
               since_ts: float = 0.0) -> dict:
        """The recording document (``workload.export`` writes it): in
        time order, with its losses and its format's version."""
        records = self.query(route=route, since_ts=since_ts, limit=0)
        with self._lock:
            dropped = self.dropped
        return {"format": self.FORMAT,
                "exported_at": round(time.time(), 3),
                "dropped": dropped,
                "summary": summarize_records(records),
                "records": records}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class ReqlogShipper:
    """Send this process's sampled records to the master's workload
    journal: a chained ``on_record`` hook, a bounded buffer, batch POSTs
    on a flush thread, loss counted and never back-pressured; the
    master's own records take ``local_journal``."""

    def __init__(self, recorder: ReqlogRecorder, server: str,
                 master_url_fn: Optional[Callable[[], str]] = None,
                 local_journal: Optional[WorkloadJournal] = None,
                 batch_size: int = 128, flush_interval: float = 0.5,
                 buffer_cap: int = 4096):
        from ..utils.leader import LeaderFollowingTransport

        self.recorder = recorder
        self.server = server
        self.master_url_fn = master_url_fn
        self.local_journal = local_journal
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.buffer_cap = buffer_cap
        self._buf: deque[AccessRecord] = deque()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set by attach() before the flush thread starts and by detach()
        # after it stops; read lock-free on every record
        self._prev_hook: Optional[Callable[[AccessRecord], None]] = None
        self.transport = LeaderFollowingTransport(master_url_fn,
                                                  name=f"workload:{server}")
        self.shipped = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def attach(self) -> "ReqlogShipper":
        self._prev_hook = self.recorder.on_record
        self.recorder.on_record = self._on_record
        self._thread = threading.Thread(target=self._flush_loop,
                                        daemon=True,
                                        name=f"reqlog-ship:{self.server}")
        self._thread.start()
        return self

    def detach(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # == (not is): each attribute read makes a new bound method
        if self.recorder.on_record == self._on_record:
            self.recorder.on_record = self._prev_hook
        # a short last flush: at teardown the master is often gone
        self._flush(timeout=0.5)

    def _on_record(self, rec: AccessRecord) -> None:
        # on the recording request's thread; a detached shipper left in
        # the chain passes records through
        if not self._stop.is_set():
            with self._lock:
                if len(self._buf) >= self.buffer_cap:
                    self.dropped += 1
                    _dropped_counter().inc("ship_buffer")
                else:
                    self._buf.append(rec)
                    if len(self._buf) >= self.batch_size:
                        self._wake.set()
        prev = self._prev_hook
        if prev is not None:
            prev(rec)

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval)
            self._wake.clear()
            self._flush()

    def _flush(self, timeout: float = 5.0) -> None:
        with self._lock:
            if not self._buf:
                return
            batch = list(self._buf)
            self._buf.clear()
        docs = [rec.to_dict() for rec in batch]
        if self.local_journal is not None:
            self.local_journal.ingest(self.server, docs)
            with self._lock:
                self.shipped += len(docs)
            return
        try:
            # the POST is neither traced nor recorded: it runs unsampled,
            # and the master classes it as ops, which the recorder skips
            with _trace_context.scope(_trace_context.NOT_SAMPLED):
                self.transport.post("/cluster/workload/ingest",
                                    {"server": self.server, "records": docs},
                                    timeout=timeout)
            with self._lock:
                self.shipped += len(docs)
        except Exception:  # noqa: BLE001 - the batch is lost and counted
            # the transport moved to the next master and learns the
            # leader again from an ingest answer
            _dropped_counter().inc("ship_error", amount=len(docs))
            with self._lock:
                self.dropped += len(docs)


# --- the process's recorder ---------------------------------------------------
# Both chokepoints record into one recorder a process, so /debug/reqlog
# and the shipper see the HTTP and framed planes in one stream.

_GLOBAL = ReqlogRecorder()


def get_recorder() -> ReqlogRecorder:
    return _GLOBAL


def enable_reqlog(sample: float = 0.1, capacity: Optional[int] = None,
                  seed: Optional[int] = None,
                  include_ops: Optional[bool] = None) -> ReqlogRecorder:
    """Turn the process's recorder on (-reqlog.sample, WEED_REQLOG_SAMPLE)."""
    _GLOBAL.start(sample=sample, capacity=capacity, seed=seed,
                  include_ops=include_ops, reset=False)
    return _GLOBAL


def disable_reqlog() -> None:
    _GLOBAL.stop()
