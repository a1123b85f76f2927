"""Trace context and head sampling: the Dapper layer.

The port's copy of seaweedfs_tpu/observability/context.py.  A request's
sampling decision travels between servers in a traceparent-style header:

    Traceparent: 00-<32-hex trace id>-<parent span id>-<01|00>

The trace id is 128 random bits; the parent is this codebase's namespaced
span id (``p3f2a.1c``), not the W3C 16-hex form.  Flags 01 mean record,
00 (or an all-zero trace id) mean the caller decided not to sample, so no
server downstream decides again.  A malformed header never errors: the
ingress decides afresh.

At every ingress (``Router.dispatch``, the shell), in order:

  1. a valid incoming header: adopt its trace id, parent and decision;
  2. an ``X-Force-Trace`` header: sample, with a fresh trace id;
  3. otherwise sample with probability ``sample_rate()``.

The decision lives in a thread-local for the rest of the request and
every outbound call re-emits it (``inject_trace_headers``), so one head
decision governs the whole distributed operation.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional

TRACEPARENT_HEADER = "Traceparent"
FORCE_HEADER = "X-Force-Trace"

_ZERO_TRACE = "0" * 32
# what an unsampled request sends downstream: all-zero trace id + 00
# flags = "decided no" (distinct from an ABSENT header = "not decided")
NOT_SAMPLED_HEADER = "00-%s-%s-00" % (_ZERO_TRACE, "0" * 16)
_HEX = frozenset("0123456789abcdef")


class TraceContext:
    """An affirmative sampling decision: this request's spans record
    under `trace_id`, and the first local span parents under the
    caller's `span_id` (empty for a locally minted root)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id}, parent={self.span_id!r})"


class _NotSampled:
    """Shared marker for 'decided NOT to sample': propagated downstream
    (NOT_SAMPLED_HEADER) so one head decision rules the whole chain."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "NOT_SAMPLED"


NOT_SAMPLED = _NotSampled()

_tls = threading.local()
# module-level so servers, shell, and clients in one process share the
# knob; default 1.0 keeps "enable tracing = record everything" behavior
_state = {"rate": 1.0}


def set_sample_rate(rate: float) -> None:
    _state["rate"] = min(max(float(rate), 0.0), 1.0)


def sample_rate() -> float:
    return _state["rate"]


def new_trace_id() -> str:
    return os.urandom(16).hex()


def format_traceparent(trace_id: str, span_id: str = "",
                       sampled: bool = True) -> str:
    return "00-%s-%s-%s" % (trace_id, span_id or "0" * 16,
                            "01" if sampled else "00")


def parse_traceparent(value: str):
    """Header -> TraceContext (sampled), NOT_SAMPLED (explicit negative
    decision), or None (absent/malformed: the caller mints fresh, never
    errors)."""
    if not value:
        return None
    parts = value.strip().split("-", 3)
    if len(parts) != 4:
        return None
    version, trace_id, parent, flags = parts
    if version != "00" or len(trace_id) != 32 or not _HEX.issuperset(trace_id):
        return None
    if not parent or any(c.isspace() for c in parent):
        return None
    if flags not in ("00", "01"):
        return None
    if trace_id == _ZERO_TRACE or flags == "00":
        return NOT_SAMPLED
    # an all-zero parent means "root": no remote span to re-root under
    return TraceContext(trace_id, "" if parent.strip("0") == "" else parent)


def ingress_context(headers):
    """The head-based sampling decision at a server ingress.  `headers`
    is any .get()-able (or None for headerless ingresses like the
    shell entry points).  Always returns a
    decision: TraceContext or NOT_SAMPLED."""
    if headers is not None:
        parsed = parse_traceparent(headers.get(TRACEPARENT_HEADER) or "")
        if parsed is not None:
            return parsed
        force = (headers.get(FORCE_HEADER) or "").strip().lower()
        if force and force not in ("0", "false", "no", "off"):
            return TraceContext(new_trace_id())
    rate = _state["rate"]
    if rate >= 1.0 or (rate > 0.0 and random.random() < rate):
        return TraceContext(new_trace_id())
    return NOT_SAMPLED


def current():
    """The thread's active decision: TraceContext, NOT_SAMPLED, or None
    (no ingress ran on this thread)."""
    return getattr(_tls, "ctx", None)


def current_sampled() -> Optional[TraceContext]:
    ctx = getattr(_tls, "ctx", None)
    return ctx if type(ctx) is TraceContext else None


def is_not_sampled() -> bool:
    """True only for an explicit negative head decision on this thread —
    the tracer's one-attribute-read guard that keeps unsampled requests
    off the span ring.  Threads with NO decision (background pipelines,
    test loops) still record."""
    return getattr(_tls, "ctx", None) is NOT_SAMPLED


def activate(ctx):
    """Install `ctx` on this thread; returns the previous value for
    symmetric restore (threads are pooled per connection — a leaked
    context would bleed into the next request)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def swap_server(url):
    """Install this thread's owning-server identity (the advertised
    host:port) for the duration of a request; returns the previous
    value for symmetric restore.  Spans recorded while set are stamped
    with it (tracer._record), so several servers sharing one process
    tracer (in-process fixtures) still attribute each
    span to the server that actually did the work — the collector's
    ship-time fallback stamp is only used for spans recorded outside
    any request."""
    prev = getattr(_tls, "server", None)
    _tls.server = url or None
    return prev


def current_server():
    """The thread's owning-server identity, or None outside a request."""
    return getattr(_tls, "server", None)


def begin_request(headers):
    """Ingress helper: decide + activate in one step.  Returns
    (sampled_ctx_or_None, previous) — pass `previous` to end_request()
    in a finally block."""
    prev = getattr(_tls, "ctx", None)
    ctx = ingress_context(headers)
    _tls.ctx = ctx
    return (ctx if ctx is not NOT_SAMPLED else None), prev


def end_request(prev) -> None:
    _tls.ctx = prev


def fork_for_thread():
    """The calling thread's decision, with its INNERMOST OPEN span id
    folded in as the parent — the value to hand to `scope` on a helper
    thread so spans recorded there nest under the request span that
    spawned the work (a bare current() would re-root them, because the
    per-thread span stack does not travel)."""
    ctx = getattr(_tls, "ctx", None)
    if type(ctx) is not TraceContext:
        return ctx
    from .tracer import get_tracer

    span_id = get_tracer().current_span_id()
    return TraceContext(ctx.trace_id, span_id or ctx.span_id)


class scope:
    """``with scope(ctx):`` — carry a caller's decision onto another
    thread (the cluster aggregator's scrape pool, worker helpers).
    Pass fork_for_thread()'s result to keep the caller's open span as
    the parent."""

    __slots__ = ("ctx", "prev")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self.prev = activate(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self.prev
        return False


def inject_trace_headers(headers: dict) -> dict:
    """Stamp the active decision onto an outbound request's headers.
    Sampled: trace id + the CURRENT span id as the remote parent (the
    cross-server stitching edge).  Decided-unsampled: the static
    NOT_SAMPLED_HEADER so downstream doesn't re-decide.  No decision:
    untouched."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return headers
    if type(ctx) is not TraceContext:
        headers.setdefault(TRACEPARENT_HEADER, NOT_SAMPLED_HEADER)
        return headers
    from .tracer import get_tracer

    span_id = get_tracer().current_span_id() or ctx.span_id
    headers.setdefault(TRACEPARENT_HEADER,
                       format_traceparent(ctx.trace_id, span_id, True))
    return headers
