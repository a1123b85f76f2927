"""Master-side trace collector and per-server span shipper.

The port's copy of seaweedfs_tpu/observability/collector.py.  The trace
context makes every cross-server hop carry one trace id, but the spans
still live in per-process rings; this module brings them together:

  - TraceShipper (every server): hooks ``Tracer.on_record``, buffers the
    spans of SAMPLED traces (only spans with a trace id; local background
    work never ships) and batch-POSTs them to the master's
    /cluster/traces/ingest.  The buffer is bounded; overflow and transport
    failures drop spans and count them
    (``SeaweedFS_trace_spans_dropped_total{reason}``) rather than
    back-pressure the serving path.  The POST runs under an explicit
    NOT_SAMPLED context, so shipping never traces itself.
  - TraceCollector (the master): groups ingested spans by trace id, dedups
    by span id (several in-process shippers and re-ships are harmless) and
    serves the stitched trace at GET /cluster/traces/<trace_id>.  Each
    span carries the server that recorded it (``context.swap_server`` at
    the Router); the shipping server's url stands in only for spans
    recorded outside any request.  Oldest traces evict first, per-trace
    span counts are capped, and both losses show on the trace document
    (``dropped``).

Stitching needs no clock agreement: parent edges come from the span ids
carried in the Traceparent header, not from time order.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

from . import context as _trace_context
from .tracer import Span, Tracer, _dropped_counter


class TraceShipper:
    """Ship sampled spans from this process's tracer to a collector.

    `master_url_fn` returns the master candidates, comma-separated (a
    volume server puts the master its heartbeats follow first); each
    flush is one POST through a LeaderFollowingTransport
    (utils/leader.py), which rotates over the candidates after a failure
    and learns the leader from ingest answers, and a failed one is
    counted lost.  `local_collector` short-circuits HTTP for
    the master's own spans.  attach() CHAINS with any previously
    installed on_record hook, so several servers sharing one process
    (test fixtures) each get to ship — the collector's
    span-id dedup collapses the duplicates.
    """

    def __init__(self, tracer: Tracer, server: str,
                 master_url_fn: Optional[Callable[[], str]] = None,
                 local_collector: Optional["TraceCollector"] = None,
                 batch_size: int = 256, flush_interval: float = 0.5,
                 buffer_cap: int = 4096):
        self.tracer = tracer
        self.server = server
        self.master_url_fn = master_url_fn
        self.local_collector = local_collector
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.buffer_cap = buffer_cap
        self._buf: deque[Span] = deque()  # guarded-by: _lock
        # per-trace loss ledger: spans this shipper failed to deliver,
        # keyed by trace id, reported to the collector on the next
        # successful flush so a truncated stitched trace SAYS so
        # (at-least-once: a loss report that errors mid-POST may be
        # re-reported — dropped counts only ever over-warn, never
        # under-warn).  Bounded: past _LOST_CAP distinct traces only the
        # global counter keeps counting.
        self._lost: dict[str, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # hook-chain handoff: written by attach()/detach() on the
        # server's lifecycle thread before the flush thread starts /
        # after it stops; read lock-free on every recorded span
        self._prev_hook: Optional[Callable[[Span], None]] = None
        # the shared leader-follow policy (imported here: utils/httpd.py
        # imports this package at load), internally locked
        from ..utils.leader import LeaderFollowingTransport

        self.transport = LeaderFollowingTransport(master_url_fn,
                                                  name=f"traces:{server}")
        self.shipped = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    _LOST_CAP = 1024

    # --- lifecycle --------------------------------------------------------
    def attach(self) -> "TraceShipper":
        self._prev_hook = self.tracer.on_record
        self.tracer.on_record = self._on_span
        self._thread = threading.Thread(target=self._flush_loop, daemon=True,
                                        name=f"trace-ship:{self.server}")
        self._thread.start()
        return self

    def detach(self) -> None:
        """Stop shipping: final flush, restore the previous hook."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # == (not is): each attribute read makes a new bound method
        if self.tracer.on_record == self._on_span:
            self.tracer.on_record = self._prev_hook
        # whatever landed after the loop exited — with a sub-second
        # timeout: at cluster teardown the master is often already gone,
        # and server stop() must not hang the full transport timeout for
        # spans that would be dropped anyway (the loss is counted)
        self._flush(timeout=0.5)

    # --- hot path ---------------------------------------------------------
    def _on_span(self, sp: Span) -> None:  # thread-entry
        # called on whatever thread recorded the span;
        # a detached shipper may still sit mid-chain (another shipper
        # attached after it and holds the head of the hook chain): it
        # must degrade to a pure pass-through, not a buffer that fills
        # and drop-counts forever
        if not self._stop.is_set():
            # on_record already filtered to spans carrying a trace_id
            with self._lock:
                if len(self._buf) >= self.buffer_cap:
                    self.dropped += 1
                    _dropped_counter().inc("ship_buffer")
                    self._note_lost_locked(sp.trace_id)
                else:
                    self._buf.append(sp)
                    if len(self._buf) >= self.batch_size:
                        self._wake.set()
        prev = self._prev_hook
        if prev is not None:
            prev(sp)

    def _note_lost_locked(self, trace_id: Optional[str],
                          n: int = 1) -> None:
        if not trace_id:
            return
        if trace_id in self._lost or len(self._lost) < self._LOST_CAP:
            self._lost[trace_id] = self._lost.get(trace_id, 0) + n

    # --- shipping ---------------------------------------------------------
    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval)
            self._wake.clear()
            self._flush()

    def _flush(self, timeout: float = 5.0) -> None:
        with self._lock:
            if not self._buf and not self._lost:
                return
            batch = list(self._buf)
            self._buf.clear()
            lost = self._lost
            self._lost = {}
        docs = [sp.to_dict() for sp in batch]
        if self.local_collector is not None:
            self.local_collector.ingest(self.server, docs, lost=lost)
            with self._lock:
                self.shipped += len(docs)
            return
        try:
            # explicit negative decision: the ship POST must not be
            # sampled downstream (it would ship spans about shipping
            # spans, forever)
            with _trace_context.scope(_trace_context.NOT_SAMPLED):
                self.transport.post("/cluster/traces/ingest",
                                    {"server": self.server, "spans": docs,
                                     "lost": lost},
                                    timeout=timeout)
            with self._lock:
                self.shipped += len(docs)
        except Exception:
            # master down or not elected: the batch is LOST and counted,
            # and remembered per trace id, so when a master is reachable
            # again the affected stitched traces are marked truncated
            # instead of silently reading complete.  The transport
            # rotated to the next candidate (a follower forwards to the
            # leader, so any live one works).
            if docs:
                _dropped_counter().inc("ship_error", amount=len(docs))
            # counter updates ride _lock: the flush thread and the
            # detach()-time final flush race these read-modify-writes
            with self._lock:
                self.dropped += len(docs)
                for d in docs:
                    self._note_lost_locked(d.get("trace"))
                for tid, n in lost.items():
                    self._note_lost_locked(tid, n)


class _TraceEntry:
    __slots__ = ("spans", "span_ids", "servers", "updated_at", "dropped")

    def __init__(self):
        self.spans: list[dict] = []
        self.span_ids: set[str] = set()
        self.servers: set[str] = set()
        self.updated_at = time.time()
        self.dropped = 0


class TraceCollector:  # weedlint: concurrent-class
    """Bounded trace store keyed by trace id (the master's side).
    Reached concurrently from the threaded HTTP router (ingest POSTs +
    trace GETs)."""

    def __init__(self, max_traces: int = 512,
                 max_spans_per_trace: int = 8192, ttl_s: float = 900.0):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self.ttl_s = ttl_s
        self._traces: "OrderedDict[str, _TraceEntry]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.evicted_traces = 0  # guarded-by: _lock

    def ingest(self, server: str, spans: list[dict],
               lost: Optional[dict] = None) -> int:
        """Merge shipped span dicts; returns how many were accepted
        (dedup by span id; per-trace cap drops are counted on the
        trace so its doc says so).  `lost` maps trace id -> spans the
        SHIPPER already lost (buffer overflow, earlier failed POSTs):
        they land on the trace's dropped count so the stitched doc
        admits its truncation."""
        accepted = 0
        now = time.time()
        with self._lock:
            for tid, n in (lost or {}).items():
                try:
                    n = int(n)
                except (TypeError, ValueError):
                    continue
                if not tid or n <= 0:
                    continue
                entry = self._traces.get(tid)
                if entry is None:
                    entry = self._traces[tid] = _TraceEntry()
                entry.dropped += n
                entry.updated_at = now
                self._traces.move_to_end(tid)
            for sp in spans:
                tid = sp.get("trace")
                sid = sp.get("id")
                if not tid or not sid:
                    continue
                entry = self._traces.get(tid)
                if entry is None:
                    entry = self._traces[tid] = _TraceEntry()
                if sid in entry.span_ids:
                    continue  # duplicate ship (chained shippers, retry)
                if len(entry.spans) >= self.max_spans_per_trace:
                    entry.dropped += 1
                    _dropped_counter().inc("collector_cap")
                    continue
                sp = dict(sp)
                sp.setdefault("server", server)
                entry.spans.append(sp)
                entry.span_ids.add(sid)
                entry.servers.add(sp["server"])
                entry.updated_at = now
                self._traces.move_to_end(tid)
                accepted += 1
            self._evict(now)
        return accepted

    def _evict(self, now: float) -> None:  # holds: _lock
        while len(self._traces) > self.max_traces:
            self._traces.popitem(last=False)
            self.evicted_traces += 1
            _dropped_counter().inc("collector_evict")
        stale = [tid for tid, e in self._traces.items()
                 if now - e.updated_at > self.ttl_s]
        for tid in stale:
            del self._traces[tid]

    def get(self, trace_id: str) -> Optional[dict]:
        """The stitched trace document (analysis-ready: a `spans` list
        the analyzer's _normalize understands, plus identity fields)."""
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans = [dict(sp) for sp in entry.spans]
            servers = sorted(entry.servers)
            dropped = entry.dropped
        spans.sort(key=lambda s: s["t0"])
        return {"format": "seaweedfs-tpu-cluster-trace-v1",
                "trace_id": trace_id,
                "span_count": len(spans),
                "servers": servers,
                "dropped": dropped,
                "spans": spans}

    def summaries(self, limit: int = 64) -> list[dict]:
        """Most-recent-first index for GET /cluster/traces."""
        with self._lock:
            items = list(self._traces.items())[-limit:]
            out = []
            for tid, e in reversed(items):
                roots = [s for s in e.spans
                         if not s.get("parent")
                         or s["parent"] not in e.span_ids]
                root = min(roots, key=lambda s: s["t0"]) if roots else None
                t0 = min((s["t0"] for s in e.spans), default=0.0)
                t1 = max((s["t1"] for s in e.spans), default=0.0)
                out.append({"trace_id": tid,
                            "root": root["name"] if root else None,
                            "span_count": len(e.spans),
                            "servers": sorted(e.servers),
                            "wall_s": round(t1 - t0, 4),
                            "age_s": round(time.time() - e.updated_at, 1)})
        return out

    def chrome(self, trace_id: str) -> Optional[dict]:
        """Chrome trace-event rendering of one stitched trace (per-server
        process tracks come from each span's shipped namespace)."""
        doc = self.get(trace_id)
        if doc is None:
            return None
        tr = Tracer(capacity=max(len(doc["spans"]), 1))
        tr.ingest_log(doc["spans"])
        return tr.to_chrome()
