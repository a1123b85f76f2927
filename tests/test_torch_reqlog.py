"""The request log (observability/reqlog.py) against the reference's.

- ``redact_query`` and ``classify_route`` over a table of paths that
  covers every route class, credentials and object paths: equal.
- ``ReqlogRecorder``: one seeded stream of requests (numpy: Zipf keys,
  paths, sizes, statuses, peers, budgets) through both packages'
  recorders with one seed and one namespace, under one stub clock (each
  module's ``time`` replaced): equal records and status at tolerance 0,
  at sample rates 1.0, 0.3 and 0.05, through ring evictions (counted on
  ``SeaweedFS_reqlog_records_dropped_total`` alike) and a live re-knob.
- ``summarize_records``, ``WorkloadJournal`` (dedup, ``via``, eviction,
  filters, ``export``) and ``ReqlogShipper`` into a local journal: equal
  documents.
- ``serve_frame``: the framed plane's record of each op equal to the
  reference's, and the HTTP router's record of a request.
- The CLI: ``-reqlog.sample``, ``-reqlog.size`` and WEED_REQLOG_SAMPLE /
  WEED_REQLOG_SIZE turn the process's recorder on as weed.py does.

Every test that turns a process's recorder on turns it off again.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

import weed
from seaweedfs_tpu.observability import reqlog as ref_reqlog
from seaweedfs_tpu.utils import framing as ref_framing
from seaweedfs_tpu_torch import __main__ as port_main
from seaweedfs_tpu_torch.observability import reqlog as port_reqlog
from seaweedfs_tpu_torch.utils import framing as port_framing

PACKAGES = {"ref": ref_reqlog, "port": port_reqlog}


class StubClock:
    """One clock for both packages: wall, monotonic, perf-counter and
    thread-CPU readings that move only when ``step`` moves them."""

    def __init__(self, t0: float = 1_760_000_000.0):
        self.now = t0
        self.mono = 5_000.0
        self.perf = 70.0
        self.cpu_ns = 10_000_000

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        return self.mono

    def perf_counter(self) -> float:
        return self.perf

    def thread_time_ns(self) -> int:
        return self.cpu_ns

    def time_ns(self) -> int:
        return int(self.now * 1e9)

    def step(self, dt: float, cpu_s: float = 0.0) -> None:
        self.now += dt
        self.mono += dt
        self.perf += dt
        self.cpu_ns += int(round(cpu_s * 1e9))


@pytest.fixture
def clock(monkeypatch):
    c = StubClock()
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "time", c)
    return c


def reset_recorder(mod) -> None:
    """The process's recorder off, empty, at its default knobs."""
    rl = mod.get_recorder()
    rl.stop()
    rl.configure(sample=0.1, capacity=8192, seed=0x5EED, include_ops=False)
    rl.clear()


@pytest.fixture(autouse=True)
def _recorders_off():
    """Both processes' recorders start and end every test off, empty and
    at their defaults."""
    for mod in PACKAGES.values():
        reset_recorder(mod)
    yield
    for mod in PACKAGES.values():
        reset_recorder(mod)


# --- the route table ----------------------------------------------------------

PATHS = [
    ("GET", "/3,01ab2c3d"), ("HEAD", "/3,01ab2c3d"), ("PUT", "/3,01ab2c3d"),
    ("POST", "/3,01ab2c3d"), ("DELETE", "/3,01ab2c3d"),
    ("GET", "/3,01AB2C3D_1.jpg"), ("GET", "/3,01ab2c3d?jwt=eyJSECRET&n=2"),
    ("POST", "/3,01ab2c3d?type=replicate"), ("PUT", "/3,01ab?type=proxied"),
    ("POST", "/batch/read"), ("POST", "/batch/write?type=replicate"),
    ("POST", "/batch/write"), ("POST", "/submit?collection=c"),
    ("GET", "/dir/assign?count=2&collection=x"), ("GET", "/dir/lookup"),
    ("GET", "/dir/lookup?volumeId=3&fileId=3,01&auth=tok"),
    ("GET", "/dir/lookup_ec?volumeId=3"), ("GET", "/dir/status"),
    ("GET", "/metrics"), ("GET", "/metrics?exemplars=1"),
    ("GET", "/debug/reqlog?limit=5"), ("POST", "/cluster/heat/ingest"),
    ("GET", "/cluster/health"), ("POST", "/admin/ec/generate"),
    ("POST", "/heartbeat"), ("POST", "/raft/append"),
    ("GET", "/stats/counter"), ("GET", "/status"), ("GET", "/ui/index.html"),
    ("GET", "/vol/grow?count=1"), ("GET", "/col/delete?collection=c"),
    ("POST", "/ec/scrub/start"), ("GET", "/favicon.ico"), ("GET", "/"),
    ("GET", "/x?Signature=S&X-Amz-Credential=C&keys=a%2Cb&key=K"),
    ("GET", "/x?token=T&password=P&secret=S&accesskey=A&secretkey=B"),
    ("GET", "/x?Authorization=Z&sig=1&x-amz-security-token=Q&a=%26b"),
    ("GET", "/x?%zz=1&&=&q"), ("GET", "/x?"), ("GET", "/x?a=1;b=2"),
]


@pytest.mark.parametrize("method,raw", PATHS)
def test_redaction_and_route_classes_equal_the_references(method, raw):
    import urllib.parse

    parsed = urllib.parse.urlparse(raw)
    path = urllib.parse.unquote(parsed.path)
    query = {k: v[0] for k, v in urllib.parse.parse_qs(
        parsed.query, keep_blank_values=True).items()}
    got = {name: (m.redact_query(raw),
                  m.classify_route(method, path, "h", query=query),
                  m.classify_route(method, path))
           for name, m in PACKAGES.items()}
    assert got["port"] == got["ref"]
    assert "SECRET" not in got["port"][0]


def test_native_routes_equal_the_references():
    assert port_reqlog.NATIVE_ROUTES == ref_reqlog.NATIVE_ROUTES
    assert port_reqlog.SENSITIVE_PARAMS == ref_reqlog.SENSITIVE_PARAMS
    assert port_reqlog.OPS_PREFIXES == ref_reqlog.OPS_PREFIXES


# --- the recorder ---------------------------------------------------------------

ROUTE_PATHS = [
    ("GET", "/{vid},{key:x}0badf00d"), ("HEAD", "/{vid},{key:x}0badf00d"),
    ("PUT", "/{vid},{key:x}0badf00d"), ("DELETE", "/{vid},{key:x}0badf00d"),
    ("POST", "/batch/read"), ("GET", "/dir/assign?collection=c"),
    ("GET", "/dir/lookup?volumeId={vid}"), ("GET", "/status"),
    ("POST", "/{vid},{key:x}0badf00d?type=replicate"),
    ("GET", "/{vid},{key:x}0badf00d?jwt=tok{key}"), ("GET", "/other"),
]


def request_stream(seed: int, n: int) -> list[dict]:
    """``n`` requests: Zipf keys over 8 volumes, a route mix, sizes,
    statuses, peers and budgets, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n), 5000)
    kinds = rng.integers(0, len(ROUTE_PATHS), n)
    statuses = rng.choice([200, 200, 200, 201, 204, 304, 404, 500, 503], n)
    sizes = rng.integers(0, 1 << 16, n)
    durs = rng.exponential(2.0, n)
    peers = rng.integers(1, 6, n)
    budgets = rng.uniform(0.0, 5.0, n)
    steps = rng.exponential(0.004, n)
    out = []
    for i in range(n):
        method, pat = ROUTE_PATHS[int(kinds[i])]
        key = int(keys[i])
        raw = pat.format(vid=1 + key % 8, key=key)
        path = raw.partition("?")[0]
        out.append({
            "method": method, "raw": raw, "path": path,
            "status": int(statuses[i]), "in": int(sizes[i]) if method in (
                "PUT", "POST") else 0,
            "out": int(sizes[i]) if method == "GET" else 0,
            "ms": float(durs[i]),
            "ddl": float(budgets[i]) if i % 3 else None,
            "shed": int(statuses[i]) == 503, "peer": f"10.0.{peers[i]}.7",
            "step": float(steps[i])})
    return out


def _feed(mod, rl, clock, reqs) -> list:
    recs = []
    for r in reqs:
        clock.step(r["step"])
        rec = rl.record(
            mod.classify_route(r["method"], r["path"]), r["method"],
            mod.redact_query(r["raw"]), r["status"], bytes_in=r["in"],
            bytes_out=r["out"], duration_ms=r["ms"], deadline_s=r["ddl"],
            shed=r["shed"], degraded=r["status"] >= 500, peer=r["peer"],
            handler="h")
        recs.append(None if rec is None else rec.to_dict())
    return recs


def _dropped(mod) -> dict:
    return dict(mod._dropped_counter().snapshot())


@pytest.mark.parametrize("sample,capacity,include_ops", [
    (1.0, 8192, False), (0.3, 64, False), (0.05, 16, True)])
def test_recorder_records_as_the_reference(clock, sample, capacity,
                                           include_ops):
    reqs = request_stream(23 + int(sample * 100), 3000)
    docs, statuses, drops = {}, {}, {}
    for name, mod in PACKAGES.items():
        before = _dropped(mod)
        t0 = (clock.now, clock.mono, clock.perf)
        rl = mod.ReqlogRecorder(capacity=capacity, sample=sample, seed=99,
                                include_ops=include_ops, namespace="rtest")
        rl.start()
        recs = _feed(mod, rl, clock, reqs)
        # a live re-knob: shrink the ring (losses counted), re-rate
        rl.configure(capacity=max(capacity // 2, 16), sample=0.5)
        recs += _feed(mod, rl, clock, reqs[:400])
        docs[name] = (recs, rl.query(limit=0), rl.query(route="http_read"),
                      rl.query(since_ts=clock.now - 1.0, limit=7))
        statuses[name] = rl.status()
        after = _dropped(mod)
        drops[name] = {k: after.get(k, 0) - before.get(k, 0)
                       for k in after}
        clock.now, clock.mono, clock.perf = t0
    assert docs["port"] == docs["ref"]
    assert statuses["port"] == statuses["ref"]
    assert drops["port"] == drops["ref"]
    if capacity < 3000:
        assert drops["port"][("ring_evict",)] > 0
    assert any(r and r.get("path", "").endswith("jwt=REDACTED")
               for r in docs["port"][0])


def test_process_recorder_enable_and_disable(clock):
    for mod in PACKAGES.values():
        rl = mod.enable_reqlog(sample=0.5, capacity=100, seed=5)
        assert rl is mod.get_recorder() and rl.enabled
    st = {n: m.get_recorder().status() for n, m in PACKAGES.items()}
    for s in st.values():
        s.pop("namespace")
    assert st["port"] == st["ref"]
    for mod in PACKAGES.values():
        mod.disable_reqlog()
        assert not mod.get_recorder().enabled


# --- the journal and the shipper -------------------------------------------------

def test_journal_and_summary_equal_the_references(clock):
    reqs = request_stream(7, 1500)
    out = {}
    for name, mod in PACKAGES.items():
        t0 = (clock.now, clock.mono, clock.perf)
        rl = mod.ReqlogRecorder(sample=1.0, seed=3, namespace="jtest")
        rl.start()
        recs = [r for r in _feed(mod, rl, clock, reqs) if r is not None]
        j = mod.WorkloadJournal(capacity=900)
        before = _dropped(mod)
        accepted = [j.ingest("a:1", recs[:800]),
                    j.ingest("b:2", recs[400:1200]),  # half repeats
                    j.ingest("c:3", [dict(r, id="") for r in recs[:5]])]
        after = _dropped(mod)
        out[name] = {
            "accepted": accepted, "len": len(j), "dropped": j.dropped,
            "evicted": after.get(("journal_evict",), 0)
            - before.get(("journal_evict",), 0),
            "query": j.query(limit=0),
            "by_route": j.query(route="http_write", limit=50),
            "by_server": j.query(server="b:2", limit=0),
            "since": j.query(since_ts=clock.now - 2.0, limit=0),
            "export": j.export(),
            "export_route": j.export(route="lookup", since_ts=1.0),
            "summary": mod.summarize_records(recs),
            "empty": mod.summarize_records([])}
        clock.now, clock.mono, clock.perf = t0
    assert out["port"] == out["ref"]
    assert out["port"]["export"]["format"] == \
        "seaweedfs-tpu-workload-recording-v1"
    assert out["port"]["evicted"] == out["port"]["dropped"] > 0


def test_shipper_into_a_local_journal(clock):
    reqs = request_stream(11, 300)
    out = {}
    for name, mod in PACKAGES.items():
        t0 = (clock.now, clock.mono, clock.perf)
        rl = mod.ReqlogRecorder(sample=1.0, seed=4, namespace="stest")
        j = mod.WorkloadJournal()
        seen: list = []
        rl.on_record = seen.append  # a hook already there stays chained
        sh = mod.ReqlogShipper(rl, server="me:1", local_journal=j,
                               batch_size=64, flush_interval=30.0)
        sh.attach()
        try:
            rl.start()
            _feed(mod, rl, clock, reqs)
        finally:
            sh.detach()
        # the port's detach gives the recorder back the hook it chained;
        # the reference's identity check meets a fresh bound method, so
        # its detached shipper stays in the chain as a pass-through (kept
        # on purpose, as the port's other shippers)
        if name == "port":
            assert rl.on_record == seen.append
        else:
            assert rl.on_record == sh._on_record
        out[name] = (j.export(), sh.shipped, sh.dropped, len(seen))
        clock.now, clock.mono, clock.perf = t0
    assert out["port"] == out["ref"]
    assert out["port"][1] == out["port"][3] == len(reqs) - sum(
        1 for r in reqs if PACKAGES["ref"].classify_route(
            r["method"], r["path"]) in ("ops", "internal"))


# --- the chokepoints ----------------------------------------------------------------

def test_serve_frame_records_as_the_reference(clock, monkeypatch):
    monkeypatch.setattr(ref_framing, "_time", clock)
    monkeypatch.setattr(port_framing, "time", clock)

    def handler(op, key, body):
        clock.step(0.002)
        if op == b"E":
            raise ValueError("boom")
        return body[::-1] + b"!"

    frames = [(b"W", "3,01ab", b"hello"), (b"R", "3,01ab", b""),
              (b"D", "3,01ab", b""), (b"B", "", b"xy"),
              (b"P", "", b"zz" * 9), (b"E", "4,02", b"q"), (b"Z", "k", b"")]
    out = {}
    for name, (mod, framing) in {"ref": (ref_reqlog, ref_framing),
                                 "port": (port_reqlog,
                                          port_framing)}.items():
        t0 = (clock.now, clock.mono, clock.perf)
        rl = mod.get_recorder()
        rl.start(sample=1.0, seed=1, reset=True)
        try:
            answers = [framing.serve_frame(handler, "tcp-volume", op, key,
                                           body, "10.1.2.3")
                       for op, key, body in frames]
        finally:
            rl.stop()
        clock.now, clock.mono, clock.perf = t0
        recs = rl.query(limit=0)
        for r in recs:
            assert r.pop("id") and r.pop("seq")
        out[name] = (answers, recs)
    assert out["port"] == out["ref"]
    routes = [r["route"] for r in out["port"][1]]
    assert routes == ["native_write", "native_read", "native_delete",
                      "native_read", "native_write", "native_E",
                      "native_Z"]


# --- the CLI ------------------------------------------------------------------------

@pytest.mark.parametrize("argv,env", [
    (["-reqlog.sample", "0.25", "-reqlog.size", "300"], {}),
    (["-reqlog.sample", "7"], {}),
    ([], {"WEED_REQLOG_SAMPLE": "0.5", "WEED_REQLOG_SIZE": "77"}),
    (["-reqlog.size", "50"], {"WEED_REQLOG_SAMPLE": "1"}),
    ([], {"WEED_REQLOG_SAMPLE": "junk"}),
    ([], {"WEED_REQLOG_SAMPLE": "0"}),
    ([], {}),
])
def test_cli_flags_enable_the_recorder_as_weed_py(monkeypatch, argv, env):
    for k in ("WEED_REQLOG_SAMPLE", "WEED_REQLOG_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(weed, "cmd_backup",
                        lambda args: seen.setdefault("ref", args))
    weed.main([*argv, "backup", "-volumeId", "3"])
    args = port_main.parse_args([*argv, "backup", "-volumeId", "3"])
    port_main._maybe_enable_reqlog(args)
    for attr in ("reqlog_sample", "reqlog_size"):
        assert getattr(args, attr) == getattr(seen["ref"], attr)
    st = {n: m.get_recorder().status() for n, m in PACKAGES.items()}
    for s in st.values():
        s.pop("namespace")
        s.pop("started_at")
    assert st["port"] == st["ref"]
    assert st["port"]["enabled"] == bool(
        env.get("WEED_REQLOG_SAMPLE", "") not in ("", "junk", "0")
        or "-reqlog.sample" in argv)


def test_record_copies_are_independent(clock):
    """The journal stores copies: a caller mutating what it ingested
    changes neither package's journal."""
    recs = [{"id": f"r.{i}", "ts": 1.0 + i, "route": "http_read"}
            for i in range(5)]
    out = {}
    for name, mod in PACKAGES.items():
        j = mod.WorkloadJournal()
        batch = copy.deepcopy(recs)
        j.ingest("s", batch)
        batch[0]["route"] = "changed"
        out[name] = j.query(limit=0)
    assert out["port"] == out["ref"]
    assert out["port"][0]["route"] == "http_read"
