"""The tracing, journal and profiling routes every server registers.

The port's copy of these routes of seaweedfs_tpu/utils/debug.py:

  GET /debug/traces            the process's span ring as Chrome
                               trace-event JSON; ?enable=1 / ?disable=1
                               turn the tracer on / off, ?clear=1 drains
                               the ring after the dump, ?trace_id= and
                               ?root= return one trace / one subtree
  GET /debug/traces/analyze    the critical-path report of the ring
                               (observability/analysis.py); ?format=text
                               renders what the shell's trace.analyze
                               prints
  GET /debug/events            the process's event journal; ?type=,
                               ?severity=, ?min_severity=, ?since_seq=,
                               ?since=<unix ts>, ?limit=N
  GET /debug/reqlog            the process's request log
                               (observability/reqlog.py): its sampled,
                               redacted access records; ?route=,
                               ?since=<unix ts>, ?limit=N (1-8192,
                               default 512), and its ``config``
  POST /debug/reqlog/start     start (or re-knob) recording; body:
                               sample (0, 1], size, seed, include_ops,
                               reset (default true); 400 out of range
  POST /debug/reqlog/stop      stop; the ring keeps its records
  GET /debug/profile           a wall-clock sampling profile of every
                               thread of the process, collapsed stacks
                               (flamegraph.pl input); ?seconds= (default
                               2, at most 60), ?hz= (default 100, at
                               most 250)
  GET /debug/pprof/profile     the same sampler over ?seconds=N at 200 Hz,
                               as self and cumulative hit tables
  GET /debug/pprof/goroutine   every thread's stack (the goroutine dump)
  GET /debug/pprof/heap        tracemalloc's top allocations; the first
                               call turns tracemalloc on, which slows every
                               allocation of the process from then on
  POST /debug/flightrecorder/capture
                               freeze the process's trace ring, a short
                               profile, the /metrics exposition and the
                               journal tail into one spooled bundle (201,
                               its meta); body: reason, alert, trace_id,
                               profile_s (at most 5)
  GET /debug/flightrecorder    the spool's bundles, newest first
  GET /debug/flightrecorder/<id>
                               one bundle (404 for an unknown id)

A capture holds the request's thread for its whole window; the sampler
takes the GIL ``hz`` times a second from the threads it watches.

Not ported: the status UI (so no index page links these routes).
"""

from __future__ import annotations

import json
import sys
import threading
import traceback

from ..observability import (analyze, disable_tracing, enable_tracing,
                             get_tracer, render_report)
from ..observability.events import get_journal
from ..observability.flightrecorder import get_flightrecorder
from ..observability.reqlog import get_recorder
from ..stats import degraded_bind_metrics, ec_integrity_metrics
from .httpd import HttpError, Request, Response, Router, qfloat

# the reference's pipeline-health counters the port has no path to bump:
# it runs no worker processes (worker_restarts) and never falls back to
# another engine (engine_fallbacks)
_NO_PIPELINE_FAULTS = {"worker_restarts": 0, "engine_fallbacks": 0}


def _profile_text(seconds: float) -> str:
    """A sampling profile across every thread at 200 Hz (cProfile would
    watch only the calling thread, which sleeps here), as hit tables."""
    from ..observability.profiler import SamplingProfiler

    prof = SamplingProfiler(hz=200.0)
    prof.run_for(seconds)
    return prof.report_text()


def _thread_dump() -> str:
    frames = sys._current_frames()
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = names.get(ident)
        label = f"{t.name} daemon={t.daemon}" if t else f"thread-{ident}"
        out.append(f"--- {label} ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def _heap_text() -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return ("tracemalloc just enabled — allocations made from now on "
                "will appear on the next call\n")
    snap = tracemalloc.take_snapshot()
    lines = [f"heap: {len(snap.traces)} traced blocks"]
    for stat in snap.statistics("lineno")[:40]:
        lines.append(str(stat))
    return "\n".join(lines) + "\n"


def register_debug_routes(router: Router) -> None:
    r = router

    @r.route("GET", "/debug/pprof/profile")
    def pprof_profile(req: Request) -> Response:
        seconds = min(qfloat(req.query, "seconds", 2.0), 60.0)
        return Response(raw=_profile_text(seconds).encode(),
                        headers={"Content-Type": "text/plain; charset=utf-8"})

    @r.route("GET", "/debug/pprof/goroutine")
    def pprof_goroutine(req: Request) -> Response:
        return Response(raw=_thread_dump().encode(),
                        headers={"Content-Type": "text/plain; charset=utf-8"})

    @r.route("GET", "/debug/pprof/heap")
    def pprof_heap(req: Request) -> Response:
        return Response(raw=_heap_text().encode(),
                        headers={"Content-Type": "text/plain; charset=utf-8"})

    @r.route("GET", "/debug/profile")
    def debug_profile(req: Request) -> Response:
        """Wall-clock sampling profile of every thread of the process, in
        collapsed-stack format."""
        from ..observability.profiler import profile_collapsed

        seconds = min(qfloat(req.query, "seconds", 2.0), 60.0)
        hz = min(qfloat(req.query, "hz", 100.0), 250.0)
        return Response(raw=profile_collapsed(seconds, hz=hz).encode(),
                        headers={"Content-Type": "text/plain; charset=utf-8"})

    @r.route("GET", "/debug/traces/analyze")
    def debug_traces_analyze(req: Request) -> Response:
        """Critical-path attribution report over the process's span ring;
        the integrity counters ride in as ``health``, so a run that met
        and healed shard rot reads DEGRADED even after the ring rotated
        its retry events out."""
        report = analyze(get_tracer(),
                         counters={**_NO_PIPELINE_FAULTS,
                                   **degraded_bind_metrics().totals(),
                                   **ec_integrity_metrics().totals()})
        if req.query.get("format", "").lower() == "text":
            return Response(raw=render_report(report).encode(),
                            headers={"Content-Type":
                                     "text/plain; charset=utf-8"})
        return Response(report)

    @r.route("GET", "/debug/traces")
    def debug_traces(req: Request) -> Response:
        """The span ring as Chrome trace-event JSON (chrome://tracing,
        ui.perfetto.dev).  A filter never drains the ring: clear is
        ignored with ?trace_id= or ?root=."""

        def flag(name: str) -> bool:
            # only explicit affirmatives act: ?clear=off must not drain
            return req.query.get(name, "").lower() in \
                ("1", "true", "yes", "on")

        if flag("enable"):
            enable_tracing()
        tracer = get_tracer()
        trace_id = req.query.get("trace_id", "")
        root_id = req.query.get("root", "")
        spans = None
        if trace_id or root_id:
            spans = tracer.snapshot()
            if trace_id:
                spans = [sp for sp in spans if sp.trace_id == trace_id]
            if root_id:
                by_id = {sp.span_id: sp for sp in spans}
                children: dict = {}
                for sp in spans:
                    if sp.parent_id:
                        children.setdefault(sp.parent_id, []).append(sp)
                keep, stack, seen = [], [root_id], set()
                while stack:
                    sid = stack.pop()
                    if sid in seen:
                        continue
                    seen.add(sid)
                    sp = by_id.get(sid)
                    if sp is not None:
                        keep.append(sp)
                    stack.extend(c.span_id
                                 for c in children.get(sid, []))
                spans = keep
        # the drops of the capture returned, read before a clear=1 drain
        # re-baselines them
        spans_dropped = tracer.dropped
        doc = tracer.to_chrome(clear=flag("clear"), spans=spans)
        doc["spansDropped"] = spans_dropped
        if flag("disable"):
            disable_tracing()
        return Response(raw=json.dumps(doc).encode(),
                        headers={"Content-Type": "application/json"})

    @r.route("GET", "/debug/events")
    def debug_events(req: Request) -> Response:
        """This process's event journal, filtered."""
        j = get_journal()
        try:
            since_seq = int(req.query.get("since_seq") or 0)
            since_ts = float(req.query.get("since") or 0.0)
            limit = min(int(req.query.get("limit") or 256), 2048)
        except ValueError as e:
            raise HttpError(400, f"bad query parameter: {e}")
        events = j.query(
            type_=req.query.get("type") or None,
            severity=req.query.get("severity") or None,
            min_severity=req.query.get("min_severity") or None,
            since_seq=since_seq, since_ts=since_ts, limit=limit)
        return Response({"events": events, "count": len(events),
                         "namespace": j.namespace,
                         "dropped": j.dropped})

    @r.route("GET", "/debug/reqlog")
    def debug_reqlog(req: Request) -> Response:
        """This process's request log, filtered, with its knobs and loss
        counts (``config``)."""
        rl = get_recorder()
        try:
            since_ts = float(req.query.get("since") or 0.0)
            # clamped both ways: a negative limit would slice [-0:]
            limit = min(max(int(req.query.get("limit") or 512), 1), 8192)
        except ValueError as e:
            raise HttpError(400, f"bad query parameter: {e}")
        records = rl.query(route=req.query.get("route") or None,
                           since_ts=since_ts, limit=limit)
        return Response({"records": records, "count": len(records),
                         "config": rl.status()})

    @r.route("POST", "/debug/reqlog/start")
    def debug_reqlog_start(req: Request) -> Response:
        """Start (or re-knob) recording in this process: what the shell's
        workload.record sends to every server."""
        try:
            b = req.json()
        except Exception:  # noqa: BLE001 - an empty or bad body: defaults
            b = {}
        try:
            sample = float(b["sample"]) if "sample" in b else None
            size = int(b["size"]) if "size" in b else None
            seed = int(b["seed"]) if "seed" in b else None
        except (TypeError, ValueError):
            raise HttpError(400, "bad sample/size/seed")
        # a knob out of range answers 400, never a recorder recording
        # nothing
        if sample is not None and not 0.0 < sample <= 1.0:
            raise HttpError(400, f"sample={sample:g} out of (0, 1]")
        if size is not None and size <= 0:
            raise HttpError(400, f"size={size} must be positive")
        rl = get_recorder()
        rl.start(sample=sample, capacity=size, seed=seed,
                 include_ops=(bool(b["include_ops"])
                              if "include_ops" in b else None),
                 reset=bool(b.get("reset", True)))
        return Response(rl.status())

    @r.route("POST", "/debug/reqlog/stop")
    def debug_reqlog_stop(req: Request) -> Response:
        """Stop recording; the ring keeps its records for export."""
        rl = get_recorder()
        rl.stop()
        return Response(rl.status())

    @r.route("POST", "/debug/flightrecorder/capture")
    def flightrecorder_capture(req: Request) -> Response:
        """Freeze this process's diagnostics into one spooled bundle:
        what the master's alert engine posts when a rule fires, and what
        the shell's alerts.capture drives by hand."""
        try:
            b = req.json()
        except Exception:  # noqa: BLE001 - an empty or bad body: defaults
            b = {}
        try:
            profile_s = min(float(b.get("profile_s", 0.25)), 5.0)
        except (TypeError, ValueError):
            raise HttpError(400, "bad profile_s")
        meta = get_flightrecorder().capture(
            reason=str(b.get("reason") or "manual"),
            alert=(str(b.get("alert")) if b.get("alert") else None),
            trace_id=(str(b.get("trace_id"))
                      if b.get("trace_id") else None),
            profile_s=profile_s)
        return Response(meta, status=201)

    @r.route("GET", "/debug/flightrecorder")
    def flightrecorder_list(req: Request) -> Response:
        fr = get_flightrecorder()
        return Response({"bundles": fr.list(),
                         "spool_dir": fr.spool_dir or "",
                         "total_bytes": fr.total_bytes(),
                         "captures": fr.captures,
                         "evicted": fr.evicted})

    @r.route("GET", r"/debug/flightrecorder/([A-Za-z0-9][A-Za-z0-9._-]*)")
    def flightrecorder_get(req: Request) -> Response:
        doc = get_flightrecorder().get(req.match.group(1))
        if doc is None:
            raise HttpError(404,
                            f"no bundle {req.match.group(1)!r} spooled")
        return Response(doc)
