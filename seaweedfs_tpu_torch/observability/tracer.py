"""Thread-safe span tracer with Chrome trace-event and Prometheus exports.

The port's copy of seaweedfs_tpu/observability/tracer.py.  The streaming
encoder's counters (fill_s, dispatch_s, write_s, drain_wait_s) say where
time went in sum; spans say when, per dispatch and per request:

    with tracer.span("pipeline.dispatch", dispatch=3, bytes=n):
        ...

  - disabled, ``span()`` returns one shared no-op context manager: one
    attribute check, no allocation, so the spans stay on the hot paths;
  - spans nest per thread (a thread-local stack); the ring append takes
    one lock;
  - the ring is a ``deque(maxlen=capacity)`` and counts what it evicts;
  - span ids are namespaced (pid plus a random salt) and times are a
    wall-anchored monotonic clock, so logs of several processes merge
    (``export_log`` / ``ingest_log``);
  - ``to_chrome()`` writes Chrome trace-event JSON (chrome://tracing,
    ui.perfetto.dev), and the Prometheus bridge observes every span into
    ``SeaweedFS_trace_span_seconds{name}`` of the port's stats registry.

A span around CUDA work bounds only what the host waited for: the codec's
``ec.encode`` / ``ec.reconstruct`` return host bytes, so they cover the
card's time; ``pipeline.dispatch`` covers the enqueue of copies and the
kernel, and the card's time shows in ``pipeline.drain``, where a drain
thread waits on the dispatch's event.  Nothing here synchronizes the
card.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from . import context as _trace_context

# wall-anchored monotonic clock: perf_counter() gives monotonic intervals,
# the captured offset maps them onto the unix epoch so timestamps from
# different processes land on one comparable timeline
_EPOCH_WALL = time.time() - time.perf_counter()


def _now() -> float:
    return _EPOCH_WALL + time.perf_counter()


class Span:
    """One finished span: wall-anchored [t0, t1) plus identity/attrs.
    `trace_id` is set when the span was recorded under a sampled
    distributed-trace context (observability/context.py) — it is the
    stitching key the master-side collector groups cross-server spans
    by; locally minted spans outside any request carry None."""

    __slots__ = ("name", "span_id", "parent_id", "pid", "tid",
                 "thread", "t0", "t1", "attrs", "trace_id", "server")

    def __init__(self, name: str, span_id: str, parent_id: Optional[str],
                 pid: str, tid: int, thread: str,
                 t0: float, t1: float, attrs: dict,
                 trace_id: Optional[str] = None,
                 server: Optional[str] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.pid = pid          # namespace string (process identity)
        self.tid = tid          # thread ident within the namespace
        self.thread = thread    # human thread name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs
        self.trace_id = trace_id
        # the server (host:port) whose request produced this span,
        # stamped at record time from the Router's thread-local
        # (context.swap_server) so co-located servers sharing one
        # process tracer still attribute per-span; None = recorded
        # outside any request (the shipper's identity stands in then)
        self.server = server

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        """Serializable log entry (export_log/ingest_log wire format)."""
        d = {"name": self.name, "id": self.span_id,
             "parent": self.parent_id, "pid": self.pid, "tid": self.tid,
             "thread": self.thread, "t0": self.t0, "t1": self.t1,
             "attrs": self.attrs}
        if self.trace_id:
            d["trace"] = self.trace_id
        if self.server:
            d["server"] = self.server
        return d


class _NoopSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def span_id(self):
        return None


_NOOP = _NoopSpan()
# public alias: hot paths pre-guard on tracer.enabled and fall back to
# this shared context manager to skip even the attrs-dict allocation
NOOP_SPAN = _NOOP


class _SpanCtx:
    """Live span context manager: records on exit, nests via the
    tracer's per-thread stack, tags the span with the exception type on
    an abnormal exit."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self.tracer
        stack = getattr(tr._stack, "ids", None)
        if stack is None:
            stack = tr._stack.ids = []
        if stack:
            self.parent_id = stack[-1]
        else:
            # first span of this thread's request: re-root under the
            # caller's span id carried in by the trace context, so a
            # downstream server's request span nests below the upstream
            # rpc.client span when the collector stitches them
            ctx = _trace_context.current_sampled()
            self.parent_id = (ctx.span_id or None) if ctx else None
        self.span_id = tr._next_id()
        stack.append(self.span_id)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        tr = self.tracer
        stack = tr._stack.ids
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        ct = threading.current_thread()
        ctx = _trace_context.current_sampled()
        sp = Span(self.name, self.span_id, self.parent_id, tr.namespace,
                  ct.ident or 0, ct.name, self.t0, t1, self.attrs,
                  trace_id=ctx.trace_id if ctx else None,
                  server=_trace_context.current_server())
        tr._record(sp)
        return False


class Tracer:
    """Bounded in-memory span collector; see module docstring."""

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 namespace: Optional[str] = None, prometheus: bool = False):
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._stack = threading.local()
        self.enabled = enabled
        # pid alone collides across hosts (containerized servers are all
        # pid 1) and the collector dedups by span id, so a bare-pid
        # namespace would silently discard one server's spans from every
        # stitched trace — salt with random bytes to make ids unique
        # cluster-wide while staying stable within this tracer.  No "-"
        # in the salt: span ids ride the dash-delimited Traceparent
        # header as the parent field
        self.namespace = namespace or (
            f"p{os.getpid():x}x{os.urandom(3).hex()}")
        self._hist = _span_histogram() if prometheus else None
        # ring-eviction accounting: a bounded deque evicts silently, so a
        # truncated trace would masquerade as a complete one without this
        self.dropped = 0
        # trace shipping hook (observability/collector.py TraceShipper):
        # called with every recorded span that carries a trace_id
        self.on_record: Optional[Callable[[Span], None]] = None

    # --- recording --------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._spans.maxlen or 0

    def span(self, name: str, **attrs):
        """Context manager for a timed span.  Disabled tracers hand back
        a shared no-op — the hot-path cost of dormant instrumentation is
        one attribute check.  A thread whose ingress decided NOT to
        sample (head-based sampling, observability/context.py) also gets
        the no-op: at 1% sampling, 99% of requests pay one thread-local
        read here instead of span allocation + ring append."""
        if not self.enabled or _trace_context.is_not_sampled():
            return _NOOP
        return _SpanCtx(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float,
                 parent_id: Optional[str] = None,
                 thread: str = "", tid: Optional[int] = None,
                 **attrs) -> Optional[str]:
        """Record an externally timed span (wall-clock seconds — e.g.
        the overlap worker's compute window shipped back in its ack).
        `tid` places the span on its own thread track (defaults to the
        calling thread)."""
        if not self.enabled or _trace_context.is_not_sampled():
            return None
        span_id = self._next_id()
        ct = threading.current_thread()
        ctx = _trace_context.current_sampled()
        self._record(Span(name, span_id, parent_id, self.namespace,
                          tid if tid is not None else (ct.ident or 0),
                          thread or ct.name, t0, t1, attrs,
                          trace_id=ctx.trace_id if ctx else None,
                          server=_trace_context.current_server()))
        return span_id

    def event(self, name: str, **attrs) -> Optional[str]:
        """Record an instant (zero-duration) span — for punctual facts
        like a supervisor restart, an engine fallback decision, or a
        degraded bind, where the interesting thing is THAT it happened
        and its attrs, not how long it took."""
        t = _now()
        return self.add_span(name, t, t, **attrs)

    def current_span_id(self) -> Optional[str]:
        """The calling thread's innermost OPEN span id — the parent a
        cross-server hop stamps into its outbound Traceparent header."""
        stack = getattr(self._stack, "ids", None)
        return stack[-1] if stack else None

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self.namespace}.{self._seq:x}"

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
                counted_drop = True
            else:
                counted_drop = False
            self._spans.append(sp)
        if counted_drop:
            # counted regardless of the Prometheus bridge: the shared
            # registry counter must never diverge from Tracer.dropped
            _dropped_counter().inc("ring_evict")
        if self._hist is not None:
            self._hist.observe(sp.name, sp.t1 - sp.t0)
        hook = self.on_record
        if hook is not None and sp.trace_id:
            try:
                hook(sp)
            except Exception:
                pass  # shipping must never break the traced operation

    def attach_prometheus(self) -> None:
        """Bridge span durations into the shared stats REGISTRY so stage
        latencies appear on every server's /metrics."""
        self._hist = _span_histogram()
        # pre-touch EVERY drop reason so scrapers see all series at 0
        # before the first loss — an absent series breaks rate()/absent()
        # dashboards exactly when the first incident needs them
        c = _dropped_counter()
        for reason in ("ring_evict", "ship_buffer", "ship_error",
                       "collector_cap", "collector_evict"):
            c.labels(reason)

    # --- inspection -------------------------------------------------------
    def snapshot(self, clear: bool = False) -> list[Span]:
        """Point-in-time copy; clear=True drains ATOMICALLY so a
        poll-and-clear capture loop never drops spans recorded between
        the read and the clear.  Draining also re-baselines `dropped`:
        it counts losses from the CURRENT ring contents, so a complete
        capture taken after a clear must not inherit an old overflow's
        TRUNCATED verdict (the Prometheus counter stays cumulative)."""
        with self._lock:
            spans = list(self._spans)
            if clear:
                self._spans.clear()
                self.dropped = 0
            return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # --- cross-process merge ----------------------------------------------
    def export_log(self) -> list[dict]:
        """Serializable span log (plain dicts; json/pickle/queue-safe)."""
        return [sp.to_dict() for sp in self.snapshot()]

    def ingest_log(self, log: list[dict], parent_id: Optional[str] = None,
                   namespace: Optional[str] = None) -> None:
        """Merge another tracer's export_log().  Ids keep their source
        namespace (distinct per process by construction), or are
        re-prefixed with `namespace` when the caller must disambiguate
        same-namespace logs; entries without a parent are reparented
        under `parent_id` so worker spans nest below the dispatching
        span."""
        if not self.enabled:
            return
        spans = []
        for e in log:
            sid, pid_ns = e["id"], e.get("pid", "?")
            par = e.get("parent")
            if namespace:
                sid = f"{namespace}/{sid}"
                par = f"{namespace}/{par}" if par else None
                pid_ns = f"{namespace}/{pid_ns}"
            spans.append(Span(e["name"], sid, par or parent_id, pid_ns,
                              int(e.get("tid", 0)), e.get("thread", ""),
                              float(e["t0"]), float(e["t1"]),
                              dict(e.get("attrs") or {}),
                              trace_id=e.get("trace"),
                              server=e.get("server")))
        with self._lock:
            overflow = max(0, len(self._spans) + len(spans)
                           - (self._spans.maxlen or 0))
            self.dropped += overflow
            self._spans.extend(spans)
        if self._hist is not None:
            for sp in spans:
                self._hist.observe(sp.name, sp.t1 - sp.t0)

    # --- whole-ring serialization -----------------------------------------
    def to_dict(self) -> dict:
        """Whole-ring snapshot as one JSON-safe document — the offline
        hand-off format for the critical-path analyzer: save it next to a
        run, load it later with from_dict(), and analysis.analyze()
        produces the SAME report it would against the live ring."""
        return {"format": "seaweedfs-tpu-trace-v1",
                "namespace": self.namespace,
                "capacity": self.capacity,
                "dropped": self.dropped,
                "spans": self.export_log()}

    @classmethod
    def from_dict(cls, doc: dict) -> "Tracer":
        """Rebuild a tracer from to_dict() output.  Ids keep their source
        namespaces (already distinct per process), so a round-trip
        preserves every parent/child edge and worker track."""
        spans = doc.get("spans") or []
        cap = int(doc.get("capacity") or 0) or max(len(spans), 1)
        tr = cls(capacity=max(cap, len(spans)), enabled=True,
                 namespace=doc.get("namespace"))
        tr.ingest_log(spans)
        return tr

    # --- Chrome trace-event export ----------------------------------------
    def to_chrome(self, clear: bool = False,
                  spans: Optional[list[Span]] = None) -> dict:
        """{"traceEvents": [...]} loadable in chrome://tracing/Perfetto.
        Spans become "X" (complete) events; process/thread metadata rides
        "M" events.  ts is strictly increasing per (pid, tid) — ties are
        nudged by 1ns so downstream tooling never sees a zero-width
        reordering ambiguity.  clear=True drains the ring atomically with
        the read (the /debug/traces?clear=1 contract).  `spans` renders a
        pre-filtered subset (the ?trace_id=/?root= debug filters) instead
        of the whole ring; clear is ignored then — filtering must never
        drain spans the caller did not see."""
        if spans is None:
            spans = self.snapshot(clear=clear)
        if not spans:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        base = min(sp.t0 for sp in spans)
        pid_map: dict[str, int] = {}
        tid_map: dict[tuple, int] = {}
        meta: list[dict] = []
        events: list[dict] = []
        for sp in spans:
            pid = pid_map.get(sp.pid)
            if pid is None:
                pid = pid_map[sp.pid] = len(pid_map) + 1
                meta.append({"ph": "M", "name": "process_name", "pid": pid,
                             "args": {"name": sp.pid}})
            tkey = (pid, sp.tid)
            tid = tid_map.get(tkey)
            if tid is None:
                tid = tid_map[tkey] = len(
                    [k for k in tid_map if k[0] == pid]) + 1
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid, "args": {"name": sp.thread
                                                  or f"thread-{sp.tid}"}})
            args = dict(sp.attrs)
            args["span_id"] = sp.span_id
            if sp.parent_id:
                args["parent_id"] = sp.parent_id
            if sp.trace_id:
                args["trace_id"] = sp.trace_id
            events.append({"name": sp.name, "ph": "X",
                           "ts": (sp.t0 - base) * 1e6,
                           "dur": max((sp.t1 - sp.t0) * 1e6, 1e-3),
                           "pid": pid, "tid": tid, "args": args})
        # strictly increasing ts per thread track
        events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
        last: dict[tuple, float] = {}
        for e in events:
            key = (e["pid"], e["tid"])
            prev = last.get(key)
            if prev is not None and e["ts"] <= prev:
                e["ts"] = prev + 1e-3
            last[key] = e["ts"]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


# --- Prometheus bridge -------------------------------------------------------

_span_hist = None
_span_hist_lock = threading.Lock()
_dropped = None


def _dropped_counter():
    """SeaweedFS_trace_spans_dropped_total{reason}: spans lost to the
    bounded ring (ring_evict) or the collector ship buffer
    (ship_buffer/ship_error) — the accounting that keeps a truncated
    trace from masquerading as a complete one."""
    global _dropped
    with _span_hist_lock:
        if _dropped is None:
            from ..stats import REGISTRY

            _dropped = REGISTRY.counter(
                "SeaweedFS_trace_spans_dropped_total",
                "Trace spans dropped before analysis/shipping.",
                labels=("reason",))
        return _dropped


def _span_histogram():
    """The shared SeaweedFS_trace_span_seconds family, registered once in
    the global stats REGISTRY (imported lazily: stats must not become an
    import-time dependency of every tracer user)."""
    global _span_hist
    with _span_hist_lock:
        if _span_hist is None:
            from ..stats import REGISTRY

            _span_hist = REGISTRY.histogram(
                "SeaweedFS_trace_span_seconds",
                "Span durations from the observability tracer.",
                labels=("name",))
        return _span_hist


# --- process-global tracer ---------------------------------------------------
# Servers and instrumented modules record into ONE tracer per process
# (disabled by default, as in the reference), so /debug/traces and /metrics see every layer's
# spans without plumbing a tracer handle through each constructor.

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def enable_tracing(capacity: Optional[int] = None,
                   prometheus: bool = True) -> Tracer:
    """Turn on the process-global tracer (optionally resizing its ring)
    and attach the /metrics histogram bridge.  Returns the tracer."""
    if capacity is not None and capacity != _GLOBAL.capacity:
        with _GLOBAL._lock:
            _GLOBAL._spans = deque(_GLOBAL._spans, maxlen=capacity)
    if prometheus:
        _GLOBAL.attach_prometheus()
    _GLOBAL.enabled = True
    return _GLOBAL


def disable_tracing() -> Tracer:
    _GLOBAL.enabled = False
    return _GLOBAL
