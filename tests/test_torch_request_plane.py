"""The port's request plane against the reference's: admission control
(utils/admission.py), the gate and 504 accounting in ``Router`` (utils/
httpd.py), the retry budget's counter (utils/backoff.py), the
request-plane families and histogram exemplars (stats/metrics.py).

Both packages get the same inputs, under one frozen clock where time
decides; their answers must be equal after the stated normalisation
(event ids, sequence numbers, timestamps and servers dropped; a live
answer compared by status, the headers a client reads and the body).
Live: a port server answers the reference's 503 and 504, releases every
admission slot whatever its request met, and shows a sampled request's
trace id as its latency bucket's exemplar.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

import seaweedfs_tpu.observability.events as ref_events
import seaweedfs_tpu.stats.metrics as ref_metrics
import seaweedfs_tpu.utils.admission as ref_admission
import seaweedfs_tpu.utils.backoff as ref_backoff
import seaweedfs_tpu.utils.deadline as ref_deadline
import seaweedfs_tpu.utils.httpd as ref_httpd
import seaweedfs_tpu_torch.observability.events as port_events
import seaweedfs_tpu_torch.stats.metrics as port_metrics
import seaweedfs_tpu_torch.utils.admission as port_admission
import seaweedfs_tpu_torch.utils.backoff as port_backoff
import seaweedfs_tpu_torch.utils.deadline as port_deadline
import seaweedfs_tpu_torch.utils.httpd as port_httpd
from tests.conftest import free_port

# (admission, backoff, httpd, deadline, events, metrics) of each package
PACKAGES = {
    "port": (port_admission, port_backoff, port_httpd, port_deadline,
             port_events, port_metrics),
    "reference": (ref_admission, ref_backoff, ref_httpd, ref_deadline,
                  ref_events, ref_metrics),
}
PATHS = ["/1,0123abcd", "/metrics", "/debug/profile", "/cluster/health",
         "/ec/scrub/status", "/admin/ec/shard_read", "/heartbeat",
         "/dir/status", "/dir/assign", "/status", "/stats/counter",
         "/submit", "/statusx", "/adminx", "/"]


@pytest.fixture
def frozen(monkeypatch):
    """One monotonic and one wall clock for both packages, moved by
    hand."""
    clock = {"now": 5000.0, "wall": 1.7e9}
    monkeypatch.setattr(time, "monotonic", lambda: clock["now"])
    monkeypatch.setattr(time, "time", lambda: clock["wall"])
    return clock


def _new_events(events_mod, since_seq: int, type_: str) -> list:
    """Events of ``type_`` journaled after ``since_seq``, without what
    differs between two journals by construction (id, seq, ts, server,
    trace)."""
    return [(e["type"], e["severity"], e["details"])
            for e in events_mod.get_journal().query(
                type_=type_, since_seq=since_seq, limit=0)]


def _state(ctl) -> tuple:
    """(bound, requests in flight, sheds) of either package's controller."""
    with ctl._lock:
        return ctl.max_inflight, ctl._inflight, ctl.shed_total


def _last_seq(events_mod) -> int:
    return max((e.seq for e in events_mod.get_journal().snapshot()),
               default=0)


# --- admission control --------------------------------------------------

def _admission_transcript(pkg, clock, seed: int) -> list:
    admission, _b, _h, _d, events_mod, metrics = pkg
    plane = metrics.request_plane_metrics()
    shed0 = plane.shed.value("volume")
    seq0 = _last_seq(events_mod)
    rng = np.random.default_rng(seed)
    ctl = admission.AdmissionController(int(rng.integers(1, 4)),
                                        role="volume")
    out = [_state(ctl)]
    for _ in range(60):
        op = int(rng.integers(0, 4))
        if op < 2:
            out.append(("acquire", ctl.try_acquire()))
        elif op == 2:
            ctl.release()
            out.append(("release",))
        else:
            path = PATHS[int(rng.integers(len(PATHS)))]
            out.append(("exempt", path, ctl.exempt(path)))
        clock["now"] += float(rng.choice([0.0, 0.3, 0.7, 1.2]))
        out.append(_state(ctl))
    out.append(("shed counter", plane.shed.value("volume") - shed0))
    out.append(("events", _new_events(events_mod, seq0, "load_shed")))
    out.append(("off", admission.maybe_controller(0, "master"),
                admission.maybe_controller(-3, "master"),
                _state(admission.maybe_controller(2, "master")),
                admission.DEFAULT_EXEMPT_PREFIXES))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_admission_controller_equals_the_reference(frozen, seed):
    got = {}
    for name, pkg in PACKAGES.items():
        frozen["now"] = 5000.0 + 100 * seed
        got[name] = _admission_transcript(pkg, frozen, seed)
    assert got["port"] == got["reference"]
    sheds = sum(1 for step in got["port"] if step == ("acquire", False))
    # every shed counted, and at least one event when any was shed
    assert got["port"][-3] == ("shed counter", sheds)
    assert bool(got["port"][-2][1]) == bool(sheds)


# --- the router's gate, live --------------------------------------------

def _gated_server(httpd, admission_mod, max_inflight: int):
    """A router named "volume" whose GET /block waits on an Event, with
    exempt /status and /metrics routes, gated at ``max_inflight``."""
    router = httpd.Router("volume")
    entered, release = threading.Event(), threading.Event()

    @router.route("GET", r"/(\d+),([0-9a-f]+)")
    def block(req):
        entered.set()
        release.wait(10)
        return httpd.Response({"ran": True})

    @router.route("GET", "/status")
    def status(req):
        return httpd.Response({"up": True})

    @router.route("GET", "/metrics")
    def metrics(req):
        return httpd.Response(raw=b"# none\n")

    router.admission = admission_mod.AdmissionController(max_inflight,
                                                         role="volume")
    port_no = free_port()
    server = httpd.serve(router, "127.0.0.1", port_no)
    return router, server, port_no, entered, release


def _call(port_no: int, path: str, headers=None) -> tuple:
    """-> (status, the headers a client acts on, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=10)
    try:
        conn.request("GET", path, headers=headers or {})
        r = conn.getresponse()
        body = r.read()
        return (r.status, {k: r.getheader(k) for k in (
            "Content-Type", "Content-Length", "Retry-After", "Connection")},
            json.loads(body) if body.startswith(b"{") else body)
    finally:
        conn.close()


def test_shed_503_equals_the_reference():
    got = {}
    for name, (admission, _b, httpd, _d, _e, _m) in PACKAGES.items():
        router, server, port_no, entered, release = _gated_server(
            httpd, admission, 1)
        first: list = []
        t = threading.Thread(target=lambda: first.append(
            _call(port_no, "/1,01637037d6")))
        try:
            t.start()
            assert entered.wait(10)
            shed = _call(port_no, "/1,01637037d6")
            exempt = [_call(port_no, p)[0] for p in ("/status", "/metrics")]
            release.set()
            t.join(10)
            # the slot goes back just after the answer left
            until = time.monotonic() + 5
            while _state(router.admission)[1] and \
                    time.monotonic() < until:
                time.sleep(0.01)
        finally:
            release.set()
            httpd.stop_server(server)
        got[name] = {"shed": shed, "exempt": exempt, "first": first,
                     "controller": _state(router.admission)}
    assert got["port"] == got["reference"]
    assert got["port"]["shed"][0] == 503
    assert got["port"]["shed"][1]["Retry-After"] == "1"
    assert got["port"]["shed"][2] == {"error": "overloaded: request shed"}
    assert got["port"]["exempt"] == [200, 200]
    assert got["port"]["first"][0][0] == 200
    assert got["port"]["controller"] == (1, 0, 1)


# --- 504 accounting -----------------------------------------------------

@pytest.mark.parametrize("case", ["before_dispatch", "raised"])
def test_504_counts_and_journals_like_the_reference(case):
    got = {}
    for name, (_a, _b, httpd, deadline, events_mod, metrics) in \
            PACKAGES.items():
        router = httpd.Router("volume")

        @router.route("GET", "/work")
        def work(req):
            if case == "raised":
                raise deadline.DeadlineExceeded("downstream budget ran out")
            return httpd.Response({"ran": True})

        plane = metrics.request_plane_metrics()
        before = plane.deadline_exceeded.value("volume")
        seq0 = _last_seq(events_mod)
        port_no = free_port()
        server = httpd.serve(router, "127.0.0.1", port_no)
        try:
            answer = _call(port_no, "/work", {"X-Weed-Deadline": "0"}
                           if case == "before_dispatch" else None)
        finally:
            httpd.stop_server(server)
        got[name] = (answer, plane.deadline_exceeded.value("volume")
                     - before,
                     _new_events(events_mod, seq0, "deadline_exceeded"))
    assert got["port"] == got["reference"]
    (status, _h, _body), moved, events = got["port"]
    assert status == 504 and moved == 1
    assert events == [("deadline_exceeded", "warning", {"role": "volume"})]


def test_504s_count_each_and_journal_once_a_second(frozen):
    """Three 504s inside one second: three counts, one event; a fourth a
    second later journals again."""
    got = {}
    for name, (_a, _b, httpd, _d, events_mod, metrics) in PACKAGES.items():
        router = httpd.Router("master")
        plane = metrics.request_plane_metrics()
        before = plane.deadline_exceeded.value("master")
        seq0 = _last_seq(events_mod)
        frozen["now"] = 9000.0
        for step in (0.0, 0.3, 0.4, 0.4):
            frozen["now"] += step
            router._note_deadline_exceeded()
        got[name] = (plane.deadline_exceeded.value("master") - before,
                     _new_events(events_mod, seq0, "deadline_exceeded"))
    assert got["port"] == got["reference"]
    assert got["port"][0] == 4 and len(got["port"][1]) == 2


# --- retry budget -------------------------------------------------------

def test_denied_retries_count_every_denial_like_the_reference(frozen):
    got = {}
    for name, (_a, backoff, _h, _d, events_mod, metrics) in \
            PACKAGES.items():
        plane = metrics.request_plane_metrics()
        before = {k: plane.retry_budget_exhausted.value(k)
                  for k in ("coordinator", "http")}
        seq0 = _last_seq(events_mod)
        prev, prev_last = backoff._GLOBAL, dict(backoff._last_event)
        backoff._GLOBAL = backoff.RetryBudget(rate=0.0, burst=2.0)
        backoff._last_event.clear()
        frozen["now"] = 7000.0
        rng = np.random.default_rng(11)
        try:
            answers = []
            for _ in range(40):
                dest = ["repair:3", "127.0.0.1:8080"][int(rng.integers(2))]
                kind = "coordinator" if dest.startswith("repair") else "http"
                answers.append((dest, backoff.retry_allowed(dest, kind)))
                frozen["now"] += float(rng.choice([0.2, 0.9, 2.5]))
        finally:
            backoff._GLOBAL = prev
            backoff._last_event.clear()
            backoff._last_event.update(prev_last)
        got[name] = (answers, {k: plane.retry_budget_exhausted.value(k)
                               - v for k, v in before.items()},
                     _new_events(events_mod, seq0,
                                 "retry_budget_exhausted"))
    assert got["port"] == got["reference"]
    answers, moved, events = got["port"]
    denied = [d for d, ok in answers if not ok]
    # every denial counted by kind; the journal rate-limited per dest
    assert moved == {"coordinator": sum(d.startswith("repair")
                                        for d in denied),
                     "http": sum(not d.startswith("repair")
                                 for d in denied)}
    assert 2 <= len(events) < len(denied)


# --- exposition and exemplars -------------------------------------------

def _exposition(metrics, clock) -> tuple:
    reg = metrics.Registry()
    vol = metrics._ServerMetrics("volumeServer", reg)
    master = metrics._ServerMetrics("master", reg)
    plane = metrics.RequestPlaneMetrics(reg)
    rng = np.random.default_rng(5)
    for i in range(40):
        bundle = [vol, master][int(rng.integers(2))]
        route = ["read_object", "status", "lookup_ec"][int(rng.integers(3))]
        clock["wall"] += 0.125
        sampled = rng.random() < 0.4
        bundle.request_counter.inc(route)
        bundle.request_histogram.observe(
            route, float(rng.lognormal(-5, 2)),
            exemplar=f"{i:032x}" if sampled else None)
    plane.shed.inc("volume", amount=3)
    plane.deadline_exceeded.inc("master")
    plane.retry_budget_exhausted.inc("coordinator", amount=2)
    return reg.expose(), reg.expose(exemplars=True)


def test_exposition_with_exemplars_equals_the_reference(frozen):
    import seaweedfs_tpu.stats.aggregate as ref_agg
    import seaweedfs_tpu_torch.stats.aggregate as port_agg

    got = {}
    for name, pkg in PACKAGES.items():
        frozen["wall"] = 1.7e9
        got[name] = _exposition(pkg[5], frozen)
    assert got["port"] == got["reference"]
    plain, with_ex = got["port"]
    assert "# {trace_id=" not in plain and "# {trace_id=" in with_ex
    for sample in ('SeaweedFS_requests_shed_total{role="volume"} 3',
                   'SeaweedFS_deadline_exceeded_total{role="master"} 1',
                   'SeaweedFS_retry_budget_exhausted_total'
                   '{kind="coordinator"} 2'):
        assert sample in plain.splitlines()
    # both parsers strip exemplars: the same families either way
    for agg in (port_agg, ref_agg):
        a, b = (agg.parse_prometheus_text(t) for t in (plain, with_ex))
        assert {k: v.snapshot() for k, v in a.items()} == \
            {k: v.snapshot() for k, v in b.items()}


class _Req:
    def __init__(self, query):
        self.query = query


@pytest.mark.parametrize("query", [
    {}, {"exemplars": "1"}, {"exemplars": "true"}, {"exemplars": "YES"},
    {"exemplars": "on"}, {"exemplars": "0"}, {"exemplars": ""},
    {"exemplars": "2"}, None])
def test_exemplars_requested_equals_the_reference(query):
    req = _Req(query)
    assert port_metrics.exemplars_requested(req) == \
        ref_metrics.exemplars_requested(req)


def test_a_sampled_request_is_its_buckets_exemplar(tmp_path):
    """Live: a forced trace's id shows on the port master's and volume
    server's /metrics?exemplars=1, and never without the flag."""
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.observability import (disable_tracing,
                                                   enable_tracing,
                                                   get_tracer)
    from seaweedfs_tpu_torch.utils.httpd import http_bytes
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    ms = MasterServer(port=free_port(), pulse_seconds=60).start()
    vs = VolumeServer([str(tmp_path)], ms.url, port=free_port(),
                      pulse_seconds=60, device="cpu").start()
    was = get_tracer().enabled
    enable_tracing()
    try:
        for url, path, family in (
                (vs.url, "/status", "SeaweedFS_volumeServer_request_seconds"),
                (ms.url, "/dir/status", "SeaweedFS_master_request_seconds")):
            status, _b, headers = http_bytes(
                "GET", f"http://{url}{path}", headers={"X-Force-Trace": "1"})
            tid = headers["X-Trace-Id"]
            assert status == 200 and len(tid) == 32
            plain = http_bytes("GET", f"http://{url}/metrics")[1].decode()
            with_ex = http_bytes(
                "GET", f"http://{url}/metrics?exemplars=1")[1].decode()
            assert f'trace_id="{tid}"' not in plain
            lines = [ln for ln in with_ex.splitlines()
                     if f'trace_id="{tid}"' in ln]
            assert len(lines) == 1 and lines[0].startswith(
                f"{family}_bucket{{type=")
            # the request plane's families exist before the first count
            assert "# TYPE SeaweedFS_requests_shed_total counter" in plain
    finally:
        if not was:
            disable_tracing()
        get_tracer().clear()
        vs.stop()
        ms.stop()


# --- every slot goes back ------------------------------------------------

def test_every_admitted_request_releases_its_slot(tmp_path):
    """500 mixed requests from ten clients at a max_inflight=2 router:
    handlers that return, raise (500, 404, 409, a DeadlineExceeded), a
    504 before dispatch, no route, an unread upload, raw and streamed
    bodies, and clients that hang up mid-body.  After them no slot is
    held, and the 503s, the shed counter and shed_total agree."""
    big = tmp_path / "big.bin"
    big.write_bytes(np.random.default_rng(1).integers(
        0, 256, 2 << 20, dtype=np.uint8).tobytes())
    router = port_httpd.Router("volume")

    @router.route("GET", "/ok")
    def ok(req):
        time.sleep(0.002)
        return port_httpd.Response({"ok": True})

    @router.route("GET", "/raise")
    def raises(req):
        raise ValueError("boom")

    @router.route("GET", "/missing")
    def missing(req):
        raise KeyError("no such needle")

    @router.route("GET", "/conflict")
    def conflict(req):
        raise port_httpd.HttpError(409, "conflict")

    @router.route("GET", "/spent")
    def spent(req):
        raise port_deadline.DeadlineExceeded("spent downstream")

    @router.route("GET", "/raw")
    def raw(req):
        return port_httpd.Response(raw=b"r" * 5000)

    @router.route("GET", "/file")
    def file(req):
        return port_httpd.Response(file_path=str(big))

    @router.route("PUT", "/put")
    def put(req):
        return port_httpd.Response({"ignored": True}, status=201)

    ctl = port_admission.AdmissionController(2, role="volume")
    router.admission = ctl
    plane = port_metrics.request_plane_metrics()
    shed0 = plane.shed.value("volume")
    port_no = free_port()
    server = port_httpd.serve(router, "127.0.0.1", port_no)
    kinds = ["/ok", "/raise", "/missing", "/conflict", "/spent", "/raw",
             "/file", "PUT /put", "/nowhere", "expired", "hangup"]
    want = {"/ok": 200, "/raise": 500, "/missing": 404, "/conflict": 409,
            "/spent": 504, "/raw": 200, "/file": 200, "PUT /put": 201,
            "/nowhere": 404, "expired": 504, "hangup": 200}
    seen: list[tuple[str, int]] = []
    errors: list[BaseException] = []

    def hang_up() -> int:
        s = socket.create_connection(("127.0.0.1", port_no), timeout=10)
        try:
            s.sendall(b"GET /file HTTP/1.1\r\nHost: x\r\n\r\n")
            head = b""
            while b"\r\n" not in head:  # the status line, then leave
                head += s.recv(64)
            return int(head.split()[1])
        finally:
            s.close()

    def client(t: int) -> None:
        rng = np.random.default_rng([3, t])
        conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=10)
        try:
            for _ in range(50):
                kind = kinds[int(rng.integers(len(kinds)))]
                if kind == "hangup":
                    seen.append((kind, hang_up()))
                    continue
                method, path, body, headers = "GET", kind, None, {}
                if kind == "PUT /put":
                    method, path, body = "PUT", "/put", b"u" * 70000
                elif kind == "expired":
                    path, headers = "/ok", {"X-Weed-Deadline": "0"}
                conn.request(method, path, body=body, headers=headers)
                r = conn.getresponse()
                r.read()
                seen.append((kind, r.status))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            conn.close()

    try:
        workers = [threading.Thread(target=client, args=(t,))
                   for t in range(10)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not errors and len(seen) == 500
        deadline = time.monotonic() + 10
        while _state(ctl)[1] and time.monotonic() < deadline:
            time.sleep(0.02)  # a hung-up send may still be failing
        assert _state(ctl)[1] == 0
        assert _call(port_no, "/ok")[0] == 200  # not shedding forever
    finally:
        port_httpd.stop_server(server)
    shed = sum(status == 503 for _k, status in seen)
    assert all(status in (want[k], 503) for k, status in seen)
    # no route and a spent budget never reach the gate
    assert all(status != 503 for k, status in seen
               if k in ("/nowhere", "expired"))
    assert shed > 0 and ctl.shed_total == shed
    assert plane.shed.value("volume") - shed0 == shed


def test_the_listen_backlog_is_the_references(monkeypatch):
    """A burst of reconnects (every shed closes its connection) must not
    overflow the listen queue: the port's threaded fallback listens with
    the reference's threaded server's backlog, not the stdlib's 5."""
    monkeypatch.setenv("WEED_DATAPLANE", "threaded")
    server = port_httpd.serve(port_httpd.Router("volume"), "127.0.0.1",
                              free_port())
    try:
        assert type(server).__name__ == "FastHTTPServer"
        assert server.request_queue_size == 256
    finally:
        port_httpd.stop_server(server)


def test_the_reactor_listen_backlog_is_the_references():
    """The default front, the reactor, listens with the reference
    reactor's backlog of 512 (seaweedfs_tpu/utils/eventloop.py)."""
    server = port_httpd.serve(port_httpd.Router("volume"), "127.0.0.1",
                              free_port())
    try:
        assert type(server).__name__ == "ReactorHTTPServer"
        assert server.request_queue_size == 512
    finally:
        port_httpd.stop_server(server)
