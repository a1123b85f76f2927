"""Heat (observability/heat.py) against the reference's.

One stub clock drives both packages (each module's ``time`` replaced) and
every input is drawn with numpy from a seed; everything is compared at
tolerance 0:

- ``DecayedCounter`` (add, value, rate, merged, retune) and
  ``SpaceSavingSketch`` over 100,000 Zipf keys with ``top_k`` 512: the
  same top lists, masses and error bounds;
- ``estimate_zipf_s`` (the port's own copy of scenarios/replay.py's);
- ``HeatAccumulator``: one seeded stream of HTTP answers, framed ops,
  batch reads and writes, errors and needle-cache hits and admissions,
  with a half-life retune midway: equal ``snapshot()`` and ``status()``;
- ``ClusterHeatJournal`` fed three servers' snapshots through
  ``HeatShipper`` (local journal) as a seeded read mix shifts its head
  onto a cold volume: equal ``to_doc()`` at every step, the same
  ``heat_shift`` / ``flash_crowd`` events at the same steps, and the same
  ``SeaweedFS_volume_heat`` / ``SeaweedFS_heat_imbalance_ratio`` gauges;
  one difference: a cluster's first reads are no crowd in the port (the
  reference pages ``flash_crowd`` on them);
- the shell's ``heat.volumes`` and ``heat.top`` print the same text from
  the same document.

Left out of the event comparison: the events' ids, sequence numbers and
server (each process journal's own).
"""

from __future__ import annotations

import numpy as np
import pytest

from seaweedfs_tpu.observability import events as ref_events
from seaweedfs_tpu.observability import heat as ref_heat
from seaweedfs_tpu.scenarios.replay import estimate_zipf_s as ref_zipf_s
from seaweedfs_tpu.shell import heat_commands as ref_heat_commands
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu_torch.observability import events as port_events
from seaweedfs_tpu_torch.observability import heat as port_heat
from seaweedfs_tpu_torch.shell import heat_commands as port_heat_commands
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from tests.test_torch_reqlog import StubClock

PACKAGES = {"ref": (ref_heat, ref_events, ref_metrics),
            "port": (port_heat, port_events, port_metrics)}


@pytest.fixture
def clock(monkeypatch):
    c = StubClock()
    for heat, events, _ in PACKAGES.values():
        monkeypatch.setattr(heat, "time", c)
        monkeypatch.setattr(events, "time", c)
    return c


def _rewind(clock, t0) -> None:
    clock.now, clock.mono, clock.perf = t0


def _mark(clock) -> tuple:
    return clock.now, clock.mono, clock.perf


def zipf_keys(seed: int, n: int, distinct: int = 20_000,
              s: float = 1.1) -> list[str]:
    """``n`` fids drawn Zipf(s) over ``distinct`` needles of 8 volumes."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, distinct + 1, dtype=np.float64)
    p = ranks ** -s
    p /= p.sum()
    draws = rng.choice(distinct, size=n, p=p)
    perm = rng.permutation(distinct)
    return [f"{1 + perm[d] % 8},{perm[d]:x}{0xC0FFEE:08x}" for d in draws]


# --- the primitives ------------------------------------------------------------

def test_decayed_counter_equals_the_references():
    rng = np.random.default_rng(5)
    ts = np.cumsum(rng.exponential(0.3, 400))
    amounts = rng.integers(1, 5000, 400)
    out = {}
    for name, (heat, _, _) in PACKAGES.items():
        a = heat.DecayedCounter(7.0)
        b = heat.DecayedCounter(7.0, 3.0, 1.0)
        vals = []
        for i, (t, x) in enumerate(zip(ts, amounts)):
            (a if i % 3 else b).add(float(x), float(t))
            if i == 200:
                a.retune(2.5, float(t))
            vals.append((a.value(float(t) + 0.5), a.rate(float(t)),
                         b.value(float(t) - 1.0)))
        c = heat.DecayedCounter(2.5, 11.0, float(ts[-1]) + 4.0)
        ab_c = a.merged(b).merged(c)
        a_bc = a.merged(b.merged(c))
        out[name] = (vals, (ab_c.mass, ab_c.ts, ab_c.half_life),
                     (a_bc.mass, a_bc.ts), heat.DecayedCounter(0).half_life)
    assert out["port"] == out["ref"]


def test_space_saving_sketch_over_100k_zipf_keys():
    keys = zipf_keys(17, 100_000)
    steps = np.cumsum(np.random.default_rng(18).exponential(0.0005,
                                                            len(keys)))
    out = {}
    for name, (heat, _, _) in PACKAGES.items():
        sk = heat.SpaceSavingSketch(512, 30.0)
        for i, (k, t) in enumerate(zip(keys, steps)):
            sk.touch(k, float(t), 1.0 if i % 7 else 0.5)
            if i == 60_000:
                sk.retune(12.0, float(t))
        now = float(steps[-1]) + 1.0
        out[name] = (len(sk), sk.top(now), sk.top(now, 512),
                     sk.top(now, 10))
    assert out["port"] == out["ref"]
    top = out["port"][2]
    assert len(top) == 512 and top[0]["mass"] >= top[-1]["mass"]


@pytest.mark.parametrize("seed", range(6))
def test_estimate_zipf_s_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    counts = [list(rng.zipf(1.1 + 0.3 * seed, 400).astype(float)),
              [5.0], [], [3.0, 3.0, 3.0], [0.0, 0.0, 1.0],
              sorted(rng.uniform(0, 100, 50))]
    for c in counts:
        assert port_heat.estimate_zipf_s(c) == ref_zipf_s(c)


# --- the accumulator -------------------------------------------------------------

def heat_feed(seed: int, n: int) -> list[tuple]:
    """One stream of accumulator calls, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    keys = zipf_keys(seed + 1, n, distinct=3000)
    kinds = rng.choice(["http", "read", "write", "error", "hit", "admit",
                        "native_r", "native_w", "native_err"], n,
                       p=[0.4, 0.1, 0.1, 0.03, 0.15, 0.05, 0.1, 0.05, 0.02])
    methods = rng.choice(["GET", "HEAD", "PUT", "DELETE", "POST"], n)
    statuses = rng.choice([200, 201, 204, 304, 404, 500, 503], n)
    sizes = rng.integers(0, 1 << 20, n)
    steps = rng.exponential(0.01, n)
    out = []
    for i in range(n):
        fid = keys[i]
        vid, _, rest = fid.partition(",")
        kind = str(kinds[i])
        if kind == "http":
            path = "/" + fid if i % 11 else "/status"
            args = (str(methods[i]), path, int(statuses[i]),
                    int(sizes[i]), f"t{i:x}" if i % 5 == 0 else "")
        elif kind == "read":
            args = (int(vid), int(sizes[i]), fid if i % 3 else "",
                    f"r{i}" if i % 4 == 0 else "")
        elif kind in ("write",):
            args = (int(vid), int(sizes[i]))
        elif kind == "error":
            args = (int(vid),)
        elif kind == "hit":
            args = (int(vid), int(rest[:-8], 16), int(sizes[i]))
        elif kind == "admit":
            args = (int(vid), int(rest[:-8], 16))
        else:
            args = ("R" if kind == "native_r" else "W", int(vid),
                    int(sizes[i]), fid, kind == "native_err")
        out.append((float(steps[i]), kind, args))
    return out


def _apply(acc, kind: str, args: tuple) -> None:
    if kind == "http":
        acc.note_http(*args)
    elif kind == "read":
        acc.note_read(*args)
    elif kind == "write":
        acc.note_write(*args)
    elif kind == "error":
        acc.note_error(*args)
    elif kind == "hit":
        acc.note_cache_hit(*args)
    elif kind == "admit":
        acc.note_cache_admit(*args)
    else:
        op, vid, n, fid, err = args
        acc.note_native(op, vid, n, fid=fid, error=err)


def test_accumulator_snapshots_equal_the_references(clock):
    feed = heat_feed(41, 20_000)
    out = {}
    for name, (heat, _, _) in PACKAGES.items():
        t0 = _mark(clock)
        acc = heat.HeatAccumulator(server="vs:1", half_life=20.0,
                                   top_k=128)
        docs = []
        for i, (dt, kind, args) in enumerate(feed):
            clock.step(dt)
            _apply(acc, kind, args)
            if i == 12_000:
                acc.set_half_life(4.0)
            if i % 2500 == 0:
                docs.append(acc.snapshot(top_k=32))
        clock.step(3.0)
        docs += [acc.snapshot(), acc.snapshot(top_k=0), acc.status()]
        out[name] = docs
        _rewind(clock, t0)
    assert out["port"] == out["ref"]
    assert out["port"][-1]["noted"] > 0


# --- the master's journal ----------------------------------------------------------

SERVERS = ("10.0.0.1:8080", "10.0.0.2:8080", "10.0.0.3:8080")
RACKS = {"10.0.0.1:8080": "r1", "10.0.0.2:8080": "r1",
         "10.0.0.3:8080": "r2"}


def shift_stream(seed: int, rounds: int, per_round: int) -> list[list]:
    """Reads spread over volumes 1-6 (Zipf over needles), and from round
    ``rounds // 2`` on 80% of them onto volume 7, cold until then: a
    flash crowd.  Each read names a holder server."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        keys = zipf_keys(seed + r, per_round, distinct=2000)
        hot = rng.random(per_round) < (0.8 if r >= rounds // 2 else 0.0)
        srv = rng.integers(0, len(SERVERS), per_round)
        batch = []
        for k, h, s in zip(keys, hot, srv):
            vid, _, rest = k.partition(",")
            if h:
                vid = "7"
            elif vid == "7":
                vid = "6"
            batch.append((SERVERS[int(s) if not h else 2],
                          int(vid), f"{vid},{rest}"))
        out.append(batch)
    return out


def _strip_event(e: dict) -> dict:
    return {k: v for k, v in e.items() if k not in ("id", "seq", "server")}


def test_cluster_journal_and_shift_detector(clock):
    stream = shift_stream(3, 40, 300)
    out = {}
    for name, (heat, events, metrics) in PACKAGES.items():
        t0 = _mark(clock)
        j = heat.ClusterHeatJournal(trail_s=4.0, min_event_interval=2.0,
                                    rack_fn=RACKS.get)
        accs = {s: heat.HeatAccumulator(server=s, half_life=1.0)
                for s in SERVERS}
        ships = {s: heat.HeatShipper(a, s, interval=3600.0,
                                     local_journal=j)
                 for s, a in accs.items()}
        journal = events.get_journal()
        seq0 = max([e.seq for e in journal.snapshot()] or [0])
        docs, fired = [], []
        for r, batch in enumerate(stream):
            for srv, vid, fid in batch:
                clock.step(0.0015)
                accs[srv].note_read(vid, 1024, fid=fid,
                                    trace_id=f"tr{vid}")
            for srv in SERVERS:
                ships[srv]._snap()
                ships[srv]._flush()
            doc = j.to_doc(top_needles=10)
            docs.append(doc)
            fired.append([_strip_event(e) for e in doc["shifts"]])
        m = metrics.heat_metrics()
        gauges = (m.volume_heat.snapshot(), m.imbalance.snapshot())
        out[name] = (docs, fired, gauges,
                     [(s.shipped, s.dropped) for s in ships.values()],
                     [_strip_event(e.to_dict()) for e in journal.snapshot()
                      if e.type in heat.HEAT_EVENT_TYPES and e.seq > seq0])
        _rewind(clock, t0)
    for i, (p, r) in enumerate(zip(out["port"][0], out["ref"][0])):
        p = {k: v for k, v in p.items() if k != "shifts"}
        r = {k: v for k, v in r.items() if k != "shifts"}
        assert p == r, f"step {i}"
    assert out["port"][1:] == out["ref"][1:]
    assert {(e["type"], e["details"]["volume"])
            for e in out["port"][1][-1]} >= {("heat_shift", 7),
                                              ("flash_crowd", 7)}
    assert out["port"][0][-1]["volumes"][0]["volume"] == 7


def test_a_cold_start_is_no_crowd(clock):
    """Writes alone for longer than the trail, then the cluster's first
    reads, all on volume 3, then a crowd onto volume 5.  The reference's
    trailing baseline from before any read ranks nothing, so it journals a
    flash_crowd on volume 3's first reads; the port waits for a baseline
    that holds reads (ROADMAP Queue 3).  The crowd onto volume 5 fires
    alike in both, at the same step."""
    out = {}
    for name, (heat, events, _) in PACKAGES.items():
        t0 = _mark(clock)
        j = heat.ClusterHeatJournal(trail_s=4.0, min_event_interval=2.0)
        acc = heat.HeatAccumulator(server="a:1", half_life=1.0)
        journal = events.get_journal()
        seq0 = max([e.seq for e in journal.snapshot()] or [0])
        for step in range(40):
            clock.step(0.5)
            if step < 12:
                acc.note_write(3, 100)
            for _ in range(20 if 12 <= step < 26 else 0):
                acc.note_read(3, 100, fid="3,01")
            for _ in range(20 if step >= 26 else 0):
                acc.note_read(5, 100, fid="5,01")
            j.ingest("a:1", [acc.snapshot()])
        out[name] = [(round(e.ts - t0[0], 3), e.type, e.details["volume"],
                      e.details["prev_share"])
                     for e in journal.snapshot() if e.seq > seq0
                     and e.type in heat.HEAT_EVENT_TYPES]
        _rewind(clock, t0)
    # each min_event_interval until its baseline holds the reads
    assert [e for e in out["ref"] if e[2] == 3] == [
        (6.5, "flash_crowd", 3, 0.0), (8.5, "flash_crowd", 3, 0.0)]
    assert [e for e in out["port"] if e[2] == 3] == []
    crowd = [e for e in out["ref"] if e[2] == 5]
    assert crowd and crowd == out["port"]


def test_shipper_buffer_loss_is_counted_alike(clock):
    out = {}
    for name, (heat, _, metrics) in PACKAGES.items():
        t0 = _mark(clock)
        acc = heat.HeatAccumulator(server="a:1")
        sh = heat.HeatShipper(acc, "a:1", master_url_fn=lambda: "",
                              buffer_cap=3)
        before = metrics.heat_metrics().snapshots_dropped.value()
        for i in range(5):
            clock.step(1.0)
            acc.note_read(1, 10, fid="1,01")
            sh._snap()
        out[name] = (sh.dropped, len(sh._buf),
                     metrics.heat_metrics().snapshots_dropped.value()
                     - before, [d["ts"] for d in sh._buf])
        _rewind(clock, t0)
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (2, 3)


# --- the shell ---------------------------------------------------------------------

class DocEnv:
    """A shell env whose master answers every GET with one document."""

    def __init__(self, doc: dict):
        self.doc = doc
        self.paths: list[str] = []

    def master_get(self, path: str, timeout=None) -> dict:
        self.paths.append(path)
        return self.doc


def test_heat_commands_print_as_the_references(clock):
    stream = shift_stream(8, 12, 200)
    j = ref_heat.ClusterHeatJournal(trail_s=2.0, min_event_interval=1.0)
    acc = {s: ref_heat.HeatAccumulator(server=s, half_life=3.0)
           for s in SERVERS}
    for batch in stream:
        for srv, vid, fid in batch:
            clock.step(0.002)
            acc[srv].note_read(vid, 512, fid=fid, trace_id="abc")
        for srv in SERVERS:
            j.ingest(srv, [acc[srv].snapshot()])
    doc = j.to_doc(top_needles=20)
    empty = ref_heat.ClusterHeatJournal().to_doc()
    for d in (doc, empty):
        for cmd in ("cmd_heat_volumes", "cmd_heat_top"):
            for flags in ({}, {"top": "3"}, {"json": "true"},
                          {"top": "junk"} if cmd == "cmd_heat_top" else {}):
                got = {}
                for name, mod in (("ref", ref_heat_commands),
                                  ("port", port_heat_commands)):
                    env = DocEnv(d)
                    try:
                        got[name] = (getattr(mod, cmd)(env, dict(flags)),
                                     env.paths)
                    except ValueError as e:
                        got[name] = ("ValueError", str(e))
                assert got["port"] == got["ref"], (cmd, flags)
