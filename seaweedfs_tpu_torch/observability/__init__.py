"""Observability: trace context, span tracer, event journal, their
shipping to the master, and trace analysis.

The port's copy of the tracing and journal layer of
seaweedfs_tpu/observability/ (context, tracer, events, collector,
analysis).  Quick use:

    from seaweedfs_tpu_torch.observability import enable_tracing
    tracer = enable_tracing()
    ...  # run the pipeline / serve requests
    open("trace.json", "w").write(json.dumps(tracer.to_chrome()))

Every server serves GET /debug/traces (the same Chrome JSON),
/debug/traces/analyze and /debug/events; the master stitches shipped
spans at /cluster/traces/<id> and merges the journals at /cluster/events.
The tracer starts disabled: ``-trace.sample R`` on the CLI, or
``/debug/traces?enable=1``, turns it on.

``SamplingProfiler`` (profiler.py) samples every thread's stack at a
fixed rate; servers serve it at GET /debug/profile and /debug/pprof/*.

``AlertEngine`` (alerts.py) evaluates ``default_rules()`` over the
master's rollup and serves /cluster/alerts; a firing rule asks each
implicated server's ``FlightRecorder`` (flightrecorder.py) for a bundle,
served at /debug/flightrecorder[/<id>].

The three feeds of the serving plane, fed at the router, the framed plane
and the needle cache: the request log (reqlog.py: sampled, redacted
access records, the master's /cluster/workload), heat (heat.py: decayed
volume and needle heat, the master's /cluster/heat and its shift
detector) and the resource ledger (ledger.py: CPU, bytes and queue wait
by route and client, the master's /cluster/ledger, with the
``WindowedProfiler``'s windows).
"""

from .alerts import AlertEngine, Rule, default_rules
from .analysis import (analyze, analyze_cluster, attribution_summary,
                       render_cluster_report, render_report)
from .collector import TraceCollector, TraceShipper
from .context import (ingress_context, inject_trace_headers,
                      sample_rate, set_sample_rate)
from .events import (ClusterEventJournal, Event, EventJournal,
                     EventShipper, get_journal)
from .flightrecorder import FlightRecorder, get_flightrecorder
from .profiler import SamplingProfiler, profile_collapsed
from .tracer import (Span, Tracer, disable_tracing, enable_tracing,
                     get_tracer)

__all__ = ["Span", "Tracer", "get_tracer", "enable_tracing",
           "disable_tracing", "analyze", "analyze_cluster",
           "attribution_summary", "render_report",
           "render_cluster_report", "TraceCollector", "TraceShipper",
           "ingress_context", "inject_trace_headers", "sample_rate",
           "set_sample_rate", "Event", "EventJournal",
           "ClusterEventJournal", "EventShipper", "get_journal",
           "SamplingProfiler", "profile_collapsed", "AlertEngine", "Rule",
           "default_rules", "FlightRecorder", "get_flightrecorder"]
