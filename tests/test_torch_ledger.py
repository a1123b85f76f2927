"""The resource ledger (observability/ledger.py) and the windowed profiler
against the reference's.

One stub clock drives both packages (each module's ``time`` replaced:
wall, ``perf_counter`` and ``thread_time_ns``), every input is drawn with
numpy from a seed, and everything is compared at tolerance 0:

- ``RequestLedger``: one seeded stream of HTTP and framed requests (route
  classes from paths and op bytes, peers over several /24s, CPU, wall,
  bytes, queue waits, needle-cache hits and misses) with bounded route and
  client tables, stalls settled on a loop-branded thread and from the
  watchdog's raw path: equal ``snapshot()`` (with ``loop_stats_fn`` and
  ``profile_fn``) and ``status()``, and equal
  ``SeaweedFS_dataplane_loop_stalls_total`` increments;
- ``LedgerShipper`` into a local ``ClusterLedgerJournal`` for three
  servers: equal ``to_doc()`` at every step, the same ``loop_stall``
  relays, the same ``SeaweedFS_ledger_route_*`` gauges;
- ``WindowedProfiler`` over seeded stack counts: equal ``top()``,
  ``diff()`` and ``summary()``;
- the shell's ``cluster.top`` (each axis) and ``cluster.health``'s ledger
  line print the same text from the same documents.

Left out of the event comparison: ids, sequence numbers and the server
(each process journal's own).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from seaweedfs_tpu.observability import events as ref_events
from seaweedfs_tpu.observability import ledger as ref_ledger
from seaweedfs_tpu.observability import profiler as ref_profiler
from seaweedfs_tpu.shell import ledger_commands as ref_ledger_commands
from seaweedfs_tpu.shell import trace_commands as ref_trace_commands
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu_torch.observability import events as port_events
from seaweedfs_tpu_torch.observability import ledger as port_ledger
from seaweedfs_tpu_torch.observability import profiler as port_profiler
from seaweedfs_tpu_torch.shell import coordinator_commands as port_coord
from seaweedfs_tpu_torch.shell import ledger_commands as port_ledger_commands
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from tests.test_torch_heat import DocEnv
from tests.test_torch_reqlog import StubClock

PACKAGES = {"ref": (ref_ledger, ref_events, ref_metrics),
            "port": (port_ledger, port_events, port_metrics)}


@pytest.fixture
def clock(monkeypatch):
    c = StubClock()
    for ledger, events, _ in PACKAGES.values():
        monkeypatch.setattr(ledger, "time", c)
        monkeypatch.setattr(events, "time", c)
    return c


def _mark(clock) -> tuple:
    return clock.now, clock.mono, clock.perf, clock.cpu_ns


def _rewind(clock, t0) -> None:
    clock.now, clock.mono, clock.perf, clock.cpu_ns = t0


HTTP = [("GET", "/{v},{k:x}0badf00d"), ("PUT", "/{v},{k:x}0badf00d"),
        ("DELETE", "/{v},{k:x}0badf00d"), ("POST", "/batch/read"),
        ("GET", "/dir/assign"), ("GET", "/dir/lookup"), ("GET", "/status"),
        ("POST", "/{v},{k:x}0badf00d"), ("GET", "/metrics"),
        ("POST", "/submit"), ("GET", "/weird")]
OPS = [b"R", b"W", b"D", b"B", b"P", b"Q"]


def ledger_stream(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    kinds = rng.random(n)
    http = rng.integers(0, len(HTTP), n)
    ops = rng.integers(0, len(OPS), n)
    keys = np.minimum(rng.zipf(1.3, n), 9000)
    subnets = rng.integers(0, 40, n)
    hosts = rng.integers(1, 250, n)
    cpu = rng.exponential(0.0004, n)
    wall = rng.exponential(0.002, n)
    bin_ = rng.integers(0, 1 << 16, n)
    bout = rng.integers(0, 1 << 16, n)
    qw = rng.exponential(0.0005, n)
    hits = rng.integers(0, 3, n)
    misses = rng.integers(0, 2, n)
    statuses = rng.choice([200, 201, 404, 500], n)
    gaps = rng.exponential(0.003, n)
    out = []
    for i in range(n):
        peer = (f"10.{subnets[i] % 4}.{subnets[i]}.{hosts[i]}"
                if i % 17 else "::1")
        method, pat = HTTP[int(http[i])]
        out.append({
            "http": kinds[i] < 0.7, "method": method,
            "path": pat.format(v=1 + int(keys[i]) % 5, k=int(keys[i])),
            "op": OPS[int(ops[i])], "peer": peer, "cpu": float(cpu[i]),
            "wall": float(wall[i]) * (200.0 if i % 997 == 5 else 1.0),
            "in": int(bin_[i]), "out": int(bout[i]), "qw": float(qw[i]),
            "hits": int(hits[i]), "misses": int(misses[i]),
            "status": int(statuses[i]), "gap": float(gaps[i]),
            "trace": f"{i:032x}" if i % 9 == 0 else "",
            "on_loop": i % 5 == 0})
    return out


def _settle(ledger_mod, led, clock, r) -> None:
    clock.step(r["gap"])
    tok = led.begin()
    for _ in range(r["hits"]):
        ledger_mod.RequestLedger.note_cache_hit(1, 2, 3)
    for _ in range(r["misses"]):
        ledger_mod.RequestLedger.note_cache_miss(1, 2)
    clock.step(r["wall"], cpu_s=r["cpu"])
    me = threading.current_thread()
    if r["on_loop"]:
        me._weed_loop = True
    try:
        if r["http"]:
            led.settle_http(tok, r["method"], r["path"], "h", r["status"],
                            r["in"], r["out"], r["peer"], r["trace"],
                            r["qw"], query={"type": "replicate"}
                            if r["status"] == 404 else None)
        else:
            led.settle_native(tok, r["op"], r["status"], r["in"],
                              r["out"], r["peer"], r["trace"], r["qw"])
    finally:
        if r["on_loop"]:
            del me._weed_loop


def test_request_ledger_equals_the_references(clock):
    stream = ledger_stream(5, 6000)
    out = {}
    for name, (ledger, _, metrics) in PACKAGES.items():
        t0 = _mark(clock)
        stalls0 = metrics.dataplane_metrics().loop_stalls.value()
        led = ledger.RequestLedger("vs:1", half_life=9.0, max_routes=6,
                                   max_clients=24)
        led.loop_stats_fn = lambda: {"lag_p99_ms": 1.5, "samples": 3}
        led.profile_fn = lambda: {"hz": 7.0, "top": []}
        docs = []
        for i, r in enumerate(stream):
            _settle(ledger, led, clock, r)
            if i % 700 == 0:
                # the watchdog's view: a raw path, no trace of its own
                led.note_stall("/3,01ab0badf00d", 0.3 + i * 1e-5)
                led.note_stall("(loop)", 0.26)
                docs.append(led.snapshot(top_clients=8))
        clock.step(4.0)
        docs += [led.snapshot(), led.snapshot(top_clients=0), led.status()]
        out[name] = (docs, metrics.dataplane_metrics().loop_stalls.value()
                     - stalls0)
        _rewind(clock, t0)
    assert out["port"] == out["ref"]
    last = out["port"][0][-3]
    assert last["stall"]["count"] > 0 and last["evicted"] > 0
    assert set(last["routes"]) <= {
        "http_read", "http_write", "http_delete", "assign", "lookup", "ops",
        "internal", "other", "native_read", "native_write",
        "native_delete", "native_Q"}


def test_broken_hooks_leave_the_snapshot_alike(clock):
    out = {}
    for name, (ledger, _, _) in PACKAGES.items():
        led = ledger.RequestLedger("vs:2")
        led.loop_stats_fn = lambda: 1 / 0
        led.profile_fn = lambda: {}[0]
        tok = led.begin()
        led.settle_http(tok, "GET", "/1,01", "read", 200, 0, 5, "1.2.3.4")
        out[name] = led.snapshot()
    assert out["port"] == out["ref"]
    assert "loop" not in out["port"] and "profile" not in out["port"]


def _strip_event(e: dict) -> dict:
    return {k: v for k, v in e.items() if k not in ("id", "seq", "server")}


SERVERS = ("10.0.0.1:8080", "10.0.0.2:8080", "10.0.0.3:8080")


def test_cluster_journal_and_stall_relay(clock):
    streams = {s: ledger_stream(11 + i, 1500)
               for i, s in enumerate(SERVERS)}
    out = {}
    for name, (ledger, events, metrics) in PACKAGES.items():
        t0 = _mark(clock)
        j = ledger.ClusterLedgerJournal(stale_s=6.0, min_event_interval=2.0)
        leds = {s: ledger.RequestLedger(s, half_life=5.0) for s in SERVERS}
        for s, led in leds.items():
            led.loop_stats_fn = (lambda s=s: {
                "lag_p99_ms": float(len(s)), "lag_p50_ms": 0.5})
        ships = {s: ledger.LedgerShipper(led, s, interval=3600.0,
                                         local_journal=j)
                 for s, led in leds.items()}
        journal = events.get_journal()
        seq0 = max([e.seq for e in journal.snapshot()] or [0])
        docs = []
        for step in range(30):
            for s in SERVERS:
                if s == SERVERS[2] and step > 20:
                    continue  # this peer goes quiet, then stale
                for r in streams[s][step * 50:(step + 1) * 50]:
                    _settle(ledger, leds[s], clock, r)
                ships[s]._snap()
                ships[s]._flush()
            clock.step(0.5)
            docs.append(j.to_doc(top=5))
        m = metrics.ledger_metrics()
        gauges = (m.route_cpu.snapshot(), m.route_qwait.snapshot(),
                  m.route_bytes.snapshot())
        relayed = [_strip_event(e.to_dict()) for e in journal.snapshot()
                   if e.type in ledger.LEDGER_EVENT_TYPES and e.seq > seq0]
        out[name] = (docs, relayed, gauges,
                     [(sh.shipped, sh.dropped) for sh in ships.values()])
        _rewind(clock, t0)
    for i, (p, r) in enumerate(zip(out["port"][0], out["ref"][0])):
        p = dict(p, stalls=[_strip_event(e) for e in p["stalls"]])
        r = dict(r, stalls=[_strip_event(e) for e in r["stalls"]])
        assert p == r, f"step {i}"
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][1], "no loop_stall was relayed"
    assert out["port"][0][-1]["peers"][SERVERS[2]]["stale"]


# --- the windowed profiler ----------------------------------------------------

def test_windowed_profiler_equals_the_references(monkeypatch):
    rng = np.random.default_rng(3)
    stacks = [("MainThread", tuple(("/x/a.py", int(line), f"f{d}")
                                   for d, line in enumerate(
                                       rng.integers(1, 99, depth))))
              for depth in rng.integers(1, 6, 40)]
    windows = []
    for w in range(5):
        counts = {}
        for k in rng.choice(len(stacks), 300):
            counts[stacks[k]] = counts.get(stacks[k], 0) + 1
        windows.append((counts, 300 + w))
    windows.append(({}, 0))  # an idle window rotates nothing
    out = {}
    for name, mod in (("ref", ref_profiler), ("port", port_profiler)):
        wp = mod.WindowedProfiler(hz=5.0, window_s=0.5, max_windows=3,
                                  top_k=4)
        feed = iter(windows)
        monkeypatch.setattr(wp._prof, "drain_counts",
                            lambda feed=feed: next(feed))
        docs = [wp.summary(), wp.top(), wp.diff()]
        for _ in windows:
            wp._rotate()
            docs += [wp.top(), wp.top(2), wp.diff(), wp.diff(10)]
        summary = wp.summary()
        out[name] = (docs, summary, wp.rotations, len(wp._windows))
    assert out["port"] == out["ref"]
    assert out["port"][2] == 5 and out["port"][3] == 3


def test_windowed_profiler_runs_and_stops():
    wp = port_profiler.WindowedProfiler(hz=50.0, window_s=1.0)
    wp.start()
    try:
        assert wp.start() is wp  # a second start is a no-op
    finally:
        wp.stop()
    assert wp._thread is None
    assert set(wp.summary()) == {"hz", "window_s", "windows", "top",
                                 "rising"}


# --- the shell ----------------------------------------------------------------------

def test_cluster_top_and_health_line_print_as_the_references(clock):
    streams = {s: ledger_stream(31 + i, 400) for i, s in enumerate(SERVERS)}
    j = ref_ledger.ClusterLedgerJournal()
    for s in SERVERS:
        led = ref_ledger.RequestLedger(s)
        led.loop_stats_fn = lambda: {"lag_p99_ms": 2.25}
        for r in streams[s]:
            _settle(ref_ledger, led, clock, r)
        j.ingest(s, [led.snapshot()])
    doc = j.to_doc(top=20)
    empty = ref_ledger.ClusterLedgerJournal().to_doc()
    for d in (doc, empty):
        for flags in ({}, {"by": "client"}, {"by": "server"},
                      {"by": "route", "top": "2"}, {"json": "true"},
                      {"by": "disk"}, {"top": "x"}):
            got = {}
            for name, mod in (("ref", ref_ledger_commands),
                              ("port", port_ledger_commands)):
                env = DocEnv(d)
                try:
                    got[name] = (mod.cmd_cluster_top(env, dict(flags)),
                                 env.paths)
                except ValueError as e:
                    got[name] = ("ValueError", str(e))
            assert got["port"] == got["ref"], flags
    # cluster.health's ledger line, from the same /cluster/ledger answer
    health = {"peer_count": 0, "degraded": False, "stale_peers": [],
              "peers": {}, "totals": {"worker_restarts": 0,
                                      "engine_fallbacks": 0,
                                      "degraded_binds": 0}}
    lines = {}
    for name, fn in (("ref", ref_trace_commands.cmd_cluster_health),
                     ("port", port_coord.cmd_cluster_health)):
        env = HealthEnv(health, doc)
        text = fn(env, {})
        lines[name] = [ln for ln in text.splitlines()
                       if ln.startswith("ledger:")]
    assert lines["port"] == lines["ref"] and len(lines["port"]) == 1


class HealthEnv:
    """A shell env whose master answers /cluster/health and
    /cluster/ledger, and nothing else."""

    def __init__(self, health: dict, ledger_doc: dict):
        self.master_url = "127.0.0.1:1"
        self.docs = {"/cluster/health": health,
                     "/cluster/ledger?top=1": ledger_doc}

    def master_get(self, path: str, timeout=None) -> dict:
        if path not in self.docs:
            raise OSError(f"no {path}")
        return self.docs[path]
