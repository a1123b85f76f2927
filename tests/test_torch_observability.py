"""The port's trace context, tracer, event journal, collector and analyzer
against seaweedfs_tpu's, on the same seeded inputs.

Normalisation: each comparison runs both packages with one fixed span
namespace, one fixed journal namespace and a deterministic clock (each
module's ``_now`` / ``time`` replaced by the same counter), so span ids,
event ids and timestamps come out equal by construction; thread idents,
which the OS assigns, are replaced by their order of first appearance.
Tolerance 0 for everything: trees, attributes, Chrome documents, journal
query results, dedup counts, and the analyzers' JSON byte for byte.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.observability import analysis as ref_analysis
from seaweedfs_tpu.observability import collector as ref_collector
from seaweedfs_tpu.observability import context as ref_context
from seaweedfs_tpu.observability import events as ref_events
from seaweedfs_tpu.observability import tracer as ref_tracer
from seaweedfs_tpu_torch.observability import analysis as port_analysis
from seaweedfs_tpu_torch.observability import collector as port_collector
from seaweedfs_tpu_torch.observability import context as port_context
from seaweedfs_tpu_torch.observability import events as port_events
from seaweedfs_tpu_torch.observability import tracer as port_tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "ref": (ref_context, ref_tracer, ref_events, ref_collector,
            ref_analysis),
    "port": (port_context, port_tracer, port_events, port_collector,
             port_analysis),
}
TRACE_ID = "ab" * 16


class _Clock:
    """A deterministic clock: every read advances 1 ms."""

    def __init__(self, t0: float = 1_700_000_000.0):
        self.t = t0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t

    def time(self) -> float:  # stands in for the time module
        return self()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both tracers and both journals on their own deterministic clock."""

    def install():
        for name, (_, tr, ev, _, _) in PACKAGES.items():
            clock = _Clock()
            monkeypatch.setattr(tr, "_now", clock)
            monkeypatch.setattr(ev, "time", clock)

    install()
    return install


def _norm_tids(docs: list[dict]) -> list[dict]:
    order: dict = {}
    out = []
    for d in docs:
        d = dict(d)
        d["tid"] = order.setdefault(d["tid"], len(order))
        out.append(d)
    return out


# --- trace context ----------------------------------------------------------

HEADERS = [
    "", "garbage", "00-" + TRACE_ID + "-p1.2-01", "00-" + TRACE_ID + "-p1.2-00",
    "00-" + "0" * 32 + "-p1.2-01", "00-" + TRACE_ID + "-0000000000000000-01",
    "01-" + TRACE_ID + "-p1.2-01", "00-" + TRACE_ID[:-1] + "g-p1.2-01",
    "00-" + TRACE_ID + "-p 1-01", "00-" + TRACE_ID + "-p1.2-02",
    "  00-" + TRACE_ID + "-e5x1.a-01  ", "00-" + TRACE_ID.upper() + "-p1-01",
    "00-" + TRACE_ID + "--01", "00-" + TRACE_ID + "-a-b-01",
]


def _parsed(ctx_mod, value):
    got = ctx_mod.parse_traceparent(value)
    if got is None or got is ctx_mod.NOT_SAMPLED:
        return repr(got)
    return ("ctx", got.trace_id, got.span_id)


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_matches(header):
    assert _parsed(port_context, header) == _parsed(ref_context, header)


@pytest.mark.parametrize("args", [(TRACE_ID, "", True),
                                  (TRACE_ID, "p3f.1c", True),
                                  (TRACE_ID, "p3f.1c", False)])
def test_traceparent_format_matches(args):
    assert port_context.format_traceparent(*args) == \
        ref_context.format_traceparent(*args)
    assert port_context.NOT_SAMPLED_HEADER == ref_context.NOT_SAMPLED_HEADER


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.3, 1.0])
def test_head_sampling_decisions_match(rate):
    """The same seeded random stream gives the same decisions; a forced
    or propagated decision wins over the rate."""
    decisions = {}
    for name, (ctx_mod, *_) in PACKAGES.items():
        old = ctx_mod.sample_rate()
        ctx_mod.set_sample_rate(rate)
        try:
            random.seed(1234)
            seq = [ctx_mod.ingress_context(None) is not ctx_mod.NOT_SAMPLED
                   for _ in range(500)]
            forced = ctx_mod.ingress_context({"X-Force-Trace": "1"})
            off = ctx_mod.ingress_context({"X-Force-Trace": "off"})
            adopted = ctx_mod.ingress_context(
                {"Traceparent": "00-" + TRACE_ID + "-p1.2-01"})
        finally:
            ctx_mod.set_sample_rate(old)
        decisions[name] = (seq, type(forced).__name__,
                           off is ctx_mod.NOT_SAMPLED if rate == 0.0
                           else None, adopted.trace_id, adopted.span_id)
    assert decisions["port"] == decisions["ref"]


def test_set_sample_rate_clamps_like_the_reference():
    for v in (-1.0, 0.25, 7.0):
        port_context.set_sample_rate(v)
        ref_context.set_sample_rate(v)
        assert port_context.sample_rate() == ref_context.sample_rate()
    port_context.set_sample_rate(1.0)
    ref_context.set_sample_rate(1.0)


# --- spans ------------------------------------------------------------------

def _span_program(ctx_mod, tr_mod) -> dict:
    """One fixed program: a request under a propagated context with nested
    spans, an instant event, a helper thread forked from the open span,
    a thread with no context, an externally timed span and a span that
    raises.  -> the tracer's log, tree and Chrome document."""
    tr = tr_mod.Tracer(namespace="pfixed")
    ctx = ctx_mod.TraceContext(TRACE_ID, "up.7")
    prev = ctx_mod.activate(ctx)
    prev_srv = ctx_mod.swap_server("127.0.0.1:8080")
    try:
        with tr.span("http.volume.get", method="GET", path="/3,01") as root:
            with tr.span("ec.reconstruct", k=10, r=4, missing=1):
                tr.event("pipeline.retry", reason="corrupt_shard", shard=3)
            forked = ctx_mod.TraceContext(ctx.trace_id,
                                          tr.current_span_id()
                                          or ctx.span_id)

            def helper():
                with ctx_mod.scope(forked):
                    with tr.span("rpc.client", peer="127.0.0.1:8081",
                                 path="/admin/ec/shard_read"):
                        with tr.span("inner", n=2):
                            pass

            def bare():
                with tr.span("pipeline.drain", dispatch=0, bytes=40):
                    pass

            # one thread after the other (a deterministic clock), each
            # alive until both are done (distinct thread idents)
            release = threading.Event()
            threads = []
            for fn, name in ((helper, "helper-1"), (bare, "drain-1")):
                done = threading.Event()

                def run(fn=fn, done=done):
                    fn()
                    done.set()
                    release.wait(10)

                t = threading.Thread(target=run, name=name)
                t.start()
                done.wait(10)
                threads.append(t)
            release.set()
            for t in threads:
                t.join()
            tr.add_span("worker.compute", 5.0, 6.0, parent_id=root.span_id,
                        thread="worker", tid=99, dispatch=0)
            with pytest.raises(KeyError):
                with tr.span("fails", x=1):
                    raise KeyError("x")
    finally:
        ctx_mod.swap_server(prev_srv)
        ctx_mod.activate(prev)
    log = tr.export_log()
    names = {d["id"]: d["name"] for d in log}
    tree = sorted((d["name"], names.get(d["parent"], d["parent"]),
                   json.dumps(d["attrs"], sort_keys=True), d.get("trace"),
                   d.get("server"), d["thread"]) for d in log)
    return {"log": _norm_tids(log), "tree": tree,
            "chrome": tr.to_chrome(), "dict": tr.to_dict()}


def test_span_trees_and_chrome_documents_match(fixed_clock):
    got = {}
    for name, (ctx_mod, tr_mod, *_) in PACKAGES.items():
        got[name] = _span_program(ctx_mod, tr_mod)
    assert got["port"]["tree"] == got["ref"]["tree"]
    assert got["port"]["log"] == got["ref"]["log"]
    assert got["port"]["chrome"] == got["ref"]["chrome"]
    # the exception's type rides the span, the helper nests under the
    # request, the context-free thread records outside the trace
    tree = {t[0]: t for t in got["port"]["tree"]}
    assert json.loads(tree["fails"][2])["error"] == "KeyError"
    assert tree["rpc.client"][1] == "http.volume.get"
    assert tree["http.volume.get"][1] == "up.7"
    assert tree["pipeline.drain"][3] is None


def test_ingest_log_and_from_dict_round_trip_match(fixed_clock):
    docs = {}
    for name, (ctx_mod, tr_mod, *_) in PACKAGES.items():
        doc = _span_program(ctx_mod, tr_mod)["dict"]
        tr = tr_mod.Tracer.from_dict(doc)
        merged = tr_mod.Tracer(namespace="pm")
        merged.ingest_log(doc["spans"], parent_id="pm.1", namespace="w")
        docs[name] = (_norm_tids(tr.export_log()),
                      _norm_tids(merged.export_log()), tr.to_chrome())
    assert docs["port"] == docs["ref"]


def test_disabled_tracer_records_nothing():
    tr = port_tracer.Tracer(enabled=False)
    assert tr.span("x", a=1) is port_tracer.NOOP_SPAN
    assert tr.add_span("y", 0.0, 1.0) is None
    assert tr.event("z") is None
    with tr.span("x"):
        pass
    assert tr.snapshot() == [] and tr.to_chrome()["traceEvents"] == []
    # an explicit not-sampled decision also gets the no-op
    on = port_tracer.Tracer()
    with port_context.scope(port_context.NOT_SAMPLED):
        assert on.span("x") is port_tracer.NOOP_SPAN
    assert on.snapshot() == []


def test_process_tracer_starts_disabled():
    code = ("import seaweedfs_tpu_torch.observability as o\n"
            "assert o.get_tracer().enabled is False\n"
            "import seaweedfs_tpu_torch.volume_server.server\n"
            "import seaweedfs_tpu_torch.master.server\n"
            "assert o.get_tracer().enabled is False\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_ring_eviction_is_counted_like_the_reference(fixed_clock):
    got = {}
    for name, (_, tr_mod, *_) in PACKAGES.items():
        tr = tr_mod.Tracer(capacity=5, namespace="pc")
        for i in range(12):
            with tr.span("s", i=i):
                pass
        got[name] = (tr.dropped, [d["attrs"]["i"] for d in tr.export_log()])
        tr.snapshot(clear=True)
        got[name] += (tr.dropped,)
    assert got["port"] == got["ref"] == (7, [7, 8, 9, 10, 11], 0)


def test_prometheus_bridge_on_the_ports_registry():
    from seaweedfs_tpu_torch.stats import REGISTRY

    tr = port_tracer.Tracer(namespace="pp")
    tr.attach_prometheus()
    with tr.span("bridge.check"):
        pass
    text = REGISTRY.expose()
    assert 'SeaweedFS_trace_span_seconds_count{name="bridge.check"} 1' \
        in text
    for reason in ("ring_evict", "ship_buffer", "ship_error",
                   "collector_cap", "collector_evict"):
        assert f'SeaweedFS_trace_spans_dropped_total{{reason="{reason}"}}' \
            in text


# --- event journal ----------------------------------------------------------

EVENTS = [
    ("shard_corrupt", dict(source="scrub", shard=3, path="/d/ec_7",
                           block=2)),
    ("scrub_unrepairable", dict(vid=7, shards=[3], blocks=40, error="")),
    ("peer_stale", dict(peer="127.0.0.1:8081", error="HttpError: 503")),
    ("repair_planned", dict(vid=7, deficit=1, critical=True, alert="",
                            cause_trace="", cause_event="e1x2.1")),
    ("repair_done", dict(vid=7, host="127.0.0.1:8082", rebuilt=[3],
                         moves=0, move_errors=[], rescrubbed=[])),
    ("retry_budget_exhausted", dict(dest="repair:7", kind="coordinator")),
    ("rebalance_move", dict(vid=7, sid=2, src="a", dst="b",
                            reason="skew")),
    ("ec_under_replicated", dict(vid=7, clean_shards=10, threshold=11)),
    ("repair_failed", dict(vid=8, error="HttpError: boom")),
    ("scrub_repair", dict(vid=9, shards=[1], blocks=4, error="")),
    ("alert_fired", dict(alert="peer_down")),  # a reference-only type
]

QUERIES = [dict(), dict(type_="repair_done"), dict(severity="error"),
           dict(min_severity="warning"), dict(min_severity="critical"),
           dict(since_seq=4), dict(since_seq=4, min_severity="error"),
           dict(limit=3), dict(limit=0), dict(type_="nope")]


def _journal(ev_mod, ctx_mod):
    j = ev_mod.EventJournal(capacity=8, namespace="efixed")
    j.register_server("127.0.0.1:8080")
    prev = ctx_mod.activate(ctx_mod.TraceContext(TRACE_ID))
    try:
        for t, details in EVENTS[:4]:
            j.emit(t, **details)
    finally:
        ctx_mod.activate(prev)
    for t, details in EVENTS[4:]:
        j.emit(t, **details)
    j.emit("repair_done", severity="critical", server="elsewhere:1",
           trace_id="cd" * 16, vid=1)
    return j


@pytest.mark.parametrize("query", QUERIES, ids=lambda q: repr(q))
def test_journal_query_filters_match(fixed_clock, query):
    got = {}
    for name, (ctx_mod, _, ev_mod, *_) in PACKAGES.items():
        j = _journal(ev_mod, ctx_mod)
        got[name] = (j.query(**query), j.dropped, j.capacity)
    assert got["port"] == got["ref"]


def test_journal_since_ts_and_severities_match(fixed_clock):
    got = {}
    for name, (ctx_mod, _, ev_mod, *_) in PACKAGES.items():
        j = _journal(ev_mod, ctx_mod)
        cut = j.query()[5]["ts"]
        got[name] = j.query(since_ts=cut)
    assert got["port"] == got["ref"]
    for t, _ in EVENTS:
        assert port_events.default_severity(t) == \
            ref_events.EVENT_TYPES[t], t


def test_cluster_journal_ingest_dedups_alike(fixed_clock):
    got = {}
    for name, (ctx_mod, _, ev_mod, *_) in PACKAGES.items():
        docs = [e.to_dict() for e in _journal(ev_mod, ctx_mod).snapshot()]
        cj = ev_mod.ClusterEventJournal(capacity=6)
        seen = []
        cj.on_ingest = seen.append
        counts = [cj.ingest("127.0.0.1:8080", docs[:5]),
                  cj.ingest("127.0.0.1:8081", docs[3:]),  # overlaps
                  cj.ingest("127.0.0.1:8080", docs),      # all re-shipped
                  cj.ingest("x", [{"type": "no_id"}, {"id": ""}])]
        got[name] = (counts, len(cj), cj.dropped,
                     cj.query(), cj.query(server="127.0.0.1:8080"),
                     cj.query(min_severity="error", limit=2),
                     [[e["id"] for e in batch] for batch in seen])
    assert got["port"] == got["ref"]


def test_event_shippers_ship_to_each_others_journals(fixed_clock):
    """A port journal's EventShipper into the reference's cluster journal
    (the local short-circuit of a master), and the reverse."""
    pairs = [(port_events, ref_events), (ref_events, port_events)]
    for src, dst in pairs:
        j = src.EventJournal(namespace="eship")
        cj = dst.ClusterEventJournal()
        sh = src.EventShipper(j, server="127.0.0.1:9", local_journal=cj,
                              flush_interval=0.05)
        sh.attach()
        try:
            j.emit("shard_corrupt", shard=1, path="/d/3")
            j.emit("scrub_unrepairable", vid=3, shards=[1])
        finally:
            sh.detach()
        assert [e["type"] for e in cj.query()] == ["shard_corrupt",
                                                   "scrub_unrepairable"]
        assert all(e["via"] == "127.0.0.1:9" and e["server"] == "127.0.0.1:9"
                   for e in cj.query())
        if src is port_events:
            assert j.on_emit is None  # detached: the hook is restored


# --- collector --------------------------------------------------------------

def test_collector_stitches_and_summarizes_alike(fixed_clock):
    got = {}
    for name, (ctx_mod, tr_mod, _, col_mod, _) in PACKAGES.items():
        log = _span_program(ctx_mod, tr_mod)["log"]
        c = col_mod.TraceCollector(max_traces=4, max_spans_per_trace=6)
        a = c.ingest("127.0.0.1:8080", log[:4], lost={TRACE_ID: 2})
        b = c.ingest("127.0.0.1:8081", log, lost={"": 3, "x": "bad"})
        doc = c.get(TRACE_ID)
        summ = c.summaries()
        for s in summ:
            s.pop("age_s")
        got[name] = (a, b, doc, summ, c.chrome(TRACE_ID), c.get("0" * 32))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_trace_shippers_ship_to_each_others_collectors(direction):
    """A port tracer's TraceShipper into the reference's collector (a
    master's local short-circuit), and the reverse."""
    src = PACKAGES["port" if direction == "port_to_ref" else "ref"]
    dst = PACKAGES["ref" if direction == "port_to_ref" else "port"]
    ctx_mod, tr_mod, _, col_mod, _ = src
    tr = tr_mod.Tracer(namespace="pship")
    col = dst[3].TraceCollector()
    sh = col_mod.TraceShipper(tr, server="127.0.0.1:9", local_collector=col,
                              flush_interval=0.05)
    sh.attach()
    try:
        prev = ctx_mod.activate(ctx_mod.TraceContext(TRACE_ID))
        try:
            with tr.span("a"):
                with tr.span("b"):
                    pass
        finally:
            ctx_mod.activate(prev)
        with tr.span("untraced"):  # no trace id: never shipped
            pass
    finally:
        sh.detach()
    doc = col.get(TRACE_ID)
    assert [s["name"] for s in doc["spans"]] == ["a", "b"]  # by t0
    assert doc["servers"] == ["127.0.0.1:9"] and sh.shipped == 2
    if direction == "port_to_ref":
        assert tr.on_record is None  # detached: the hook is restored


# --- analysis ---------------------------------------------------------------

def _encode_trace(tmp_path) -> dict:
    """The port's streaming encode and rebuild of a seeded volume on the
    CPU with the tracer on: a saved span log of the real pipeline."""
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder

    rng = np.random.default_rng(7)
    base = str(tmp_path / "v")
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes())
    tr = port_tracer.Tracer(namespace="penc")
    enc = StreamingEncoder(device="cpu")
    enc.dispatch_b = 1 << 17
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved, port_tracer._GLOBAL = port_tracer._GLOBAL, tr
    try:
        enc.encode_file(base + ".dat", base)
        for sid in (0, 12):
            os.remove(base + to_ext(sid))
        enc.rebuild_files(base)
    finally:
        port_tracer._GLOBAL = saved
        torch.set_num_threads(n)
    return tr.to_dict()


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def test_analyze_of_a_saved_encode_log_matches(tmp_path):
    doc = _encode_trace(tmp_path)
    names = {s["name"] for s in doc["spans"]}
    assert {"pipeline.encode_file", "pipeline.setup", "pipeline.fill",
            "pipeline.dispatch", "pipeline.write", "pipeline.drain",
            "pipeline.close", "pipeline.rebuild_files"} <= names
    counters = {"retries": 0, "corrupt_shards": 0}
    for trace in (doc, {"spans": doc["spans"][::-1]},
                  port_tracer.Tracer.from_dict(doc).to_chrome()):
        port = port_analysis.analyze(trace, counters=counters)
        ref = ref_analysis.analyze(trace, counters=counters)
        assert _dumps(port) == _dumps(ref)
        assert port_analysis.render_report(port) == \
            ref_analysis.render_report(ref)
        assert _dumps(port_analysis.attribution_summary(port)) == \
            _dumps(ref_analysis.attribution_summary(ref))
    report = port_analysis.analyze(doc)
    assert [r["name"] for r in report["runs"]] == [
        "pipeline.encode_file", "pipeline.rebuild_files"]


def test_analyze_cluster_of_a_stitched_trace_matches(fixed_clock):
    log = _span_program(port_context, port_tracer)["log"]
    for sp in log:
        sp["server"] = "127.0.0.1:8081" if sp["name"] == "inner" \
            else "127.0.0.1:8080"
    col = port_collector.TraceCollector()
    col.ingest("127.0.0.1:8080", log)
    doc = col.get(TRACE_ID)
    for health in (None, {"127.0.0.1:8081": {"corrupt_shards": 1}}):
        port = port_analysis.analyze_cluster(doc, health=health)
        ref = ref_analysis.analyze_cluster(doc, health=health)
        assert _dumps(port) == _dumps(ref)
        assert port_analysis.render_cluster_report(port) == \
            ref_analysis.render_cluster_report(ref)
    empty = {"trace_id": TRACE_ID, "spans": [], "dropped": 3}
    assert _dumps(port_analysis.analyze_cluster(empty)) == \
        _dumps(ref_analysis.analyze_cluster(empty))


def test_a_shippers_loss_is_counted_and_never_raises():
    """A master that does not answer: the traced work and the degraded
    path go on, the shippers count what they lost, and the trace shipper
    reports the loss per trace at its next flush."""
    import socket

    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    tr = port_tracer.Tracer(namespace="ploss")
    sh = port_collector.TraceShipper(tr, server="127.0.0.1:9",
                                     master_url_fn=lambda: dead,
                                     flush_interval=0.05)
    j = port_events.EventJournal(namespace="eloss")
    esh = port_events.EventShipper(j, server="127.0.0.1:9",
                                   master_url_fn=lambda: dead,
                                   flush_interval=0.05)
    sh.attach()
    esh.attach()
    try:
        prev = port_context.activate(port_context.TraceContext(TRACE_ID))
        try:
            with tr.span("a"):
                pass
        finally:
            port_context.activate(prev)
        j.emit("shard_corrupt", shard=1)
    finally:
        sh.detach()
        esh.detach()
    assert sh.dropped == 1 and sh.shipped == 0
    assert esh.dropped == 1 and esh.shipped == 0
    assert sh._lost == {TRACE_ID: 1}  # reported with the next batch
    assert len(tr.snapshot()) == 1 and len(j.snapshot()) == 1


def _pipeline_spans(tracer) -> "Counter":
    """A traced pipeline's spans as a multiset of (name, attributes), less
    what names the run rather than the work (the file path) and the
    producer's waits for a slot (``pipeline.drain_wait``), which depend on
    thread timing."""
    from collections import Counter

    out: Counter = Counter()
    for d in tracer.export_log():
        if d["name"] == "pipeline.drain_wait":
            continue
        attrs = {k: v for k, v in d["attrs"].items() if k != "path"}
        out[(d["name"], json.dumps(attrs, sort_keys=True))] += 1
    return out


def test_pipeline_spans_match_the_reference_encoder(tmp_path):
    """The port's streaming encode and rebuild, and the reference's device
    pipeline (XLA on the CPU) on the same seeded file at the same dispatch
    width, record the same spans with the same attributes: every
    dispatch's fill, dispatch, data and parity writes and drain, and the
    roots, set-up and close."""
    from seaweedfs_tpu.ec.streaming import StreamingEncoder as RefStreaming
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder

    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (3 << 20) + 12345, dtype=np.uint8).tobytes()
    got = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in ("ref", "port"):
            base = str(tmp_path / name)
            with open(base + ".dat", "wb") as f:
                f.write(data)
            mod = PACKAGES[name][1]
            tr = mod.Tracer(namespace="penc")
            if name == "ref":
                enc = RefStreaming(10, 4, engine="device", mesh=False,
                                   dispatch_mb=1)
            else:
                enc = StreamingEncoder(dispatch_mb=1, device="cpu")
            # each encoder follows its package's process tracer
            saved, mod._GLOBAL = mod._GLOBAL, tr
            try:
                enc.encode_file(base + ".dat", base, 1_000_000, 100_000)
                for sid in (0, 12):
                    os.remove(base + to_ext(sid))
                enc.rebuild_files(base)
            finally:
                mod._GLOBAL = saved
            got[name] = _pipeline_spans(tr)
    finally:
        torch.set_num_threads(n)
    assert got["port"] == got["ref"]
    names = {name for name, _ in got["port"]}
    assert {"pipeline.encode_file", "pipeline.setup", "pipeline.fill",
            "pipeline.dispatch", "pipeline.write", "pipeline.drain",
            "pipeline.close", "pipeline.rebuild_files"} <= names
