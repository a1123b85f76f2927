"""The scenario engine: run one ScenarioSpec against a real in-process
cluster and emit a measured, verdicted result document.

The port's copy of seaweedfs_tpu/scenarios/engine.py.  ``run_scenario``
starts its volume servers on ``device`` ("cuda" by default: a card, and
no server starts without one); every other path is the reference's.  A
spec with ``autoscale=True`` runs the master's heat autoscaler at drill
scale (one-second cycles), re-looks up the hot volumes' locations every
half second so clients find added replicas, and scores the loop in an
``autoscale`` block.

The engine spawns a master + N volume servers IN PROCESS (the chaos-
drill shape: fault points armed here fire at every client AND server
egress, the alert engine evaluates live on the master's telemetry
loop), preloads the Zipfian hot set, then drives client threads for
duration_s.  Every client op runs under the spec's deadline
(utils/deadline.py scope -> X-Weed-Deadline propagates across every
hop), faults arm/clear on the spec's timeline, and an alert poller
records the fire/resolve transitions the degradation causes.

The result document carries per-route RED stats (count, error ratio,
p50/p90/p99), per-phase throughput + accepted-p99 (healthy / fault /
recovery), the request-plane counter deltas (shed, deadline_exceeded,
retry_budget_exhausted), the fault + alert timelines, one stitched
sampled trace, and a `checks` list scoring the spec's expectations —
`verdict` is "pass" only when every check holds.
"""

from __future__ import annotations

import json
import random
import shutil
import socket
import tempfile
import threading
import time
from typing import Optional

from ..utils import deadline as _deadline
from ..utils import faultinject as fi
from ..utils.backoff import get_retry_budget
from ..utils.httpd import HttpError, http_bytes, http_json
from .spec import ScenarioSpec
from .workload import (SizeSampler, ZipfSampler, payload_for,
                       percentile as _percentile, pick_op)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Op:
    """One client operation's measurement."""

    __slots__ = ("route", "t", "lat", "status")

    def __init__(self, route: str, t: float, lat: float, status: int):
        self.route = route
        self.t = t          # start offset from load t0, seconds
        self.lat = lat      # wall latency, seconds
        self.status = status

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class _AlertWatch:
    """Samples the master alert engine and keeps the transition
    timeline: which alerts fired when, and whether they resolved."""

    def __init__(self, master, t0: float):
        self.master = master
        self.t0 = t0
        self.fired_at: dict[str, float] = {}
        self.resolved_at: dict[str, float] = {}
        self.timeline: list[dict] = []
        self._last: dict[str, str] = {}

    def sample(self) -> None:
        now = round(time.monotonic() - self.t0, 2)
        try:
            doc = self.master.alert_engine.to_dict()
        except Exception:
            return
        for a in doc.get("alerts", []):
            name, state = a["name"], a["state"]
            if self._last.get(name) == state:
                continue
            first_sight = name not in self._last
            self._last[name] = state
            if first_sight and state == "inactive":
                continue  # baseline, not a transition
            self.timeline.append({"t": now, "alert": name,
                                  "state": state})
            if state == "firing":
                self.fired_at.setdefault(name, now)
            elif state == "resolved" and name in self.fired_at:
                self.resolved_at[name] = now

    def firing_now(self) -> set:
        return {n for n, s in self._last.items() if s == "firing"}


def _shrink_alert_windows(master) -> None:
    """Scenario scale: SLO windows short enough to breach AND resolve
    inside one drill, plus a run-scoped burn-rate rule over the
    MASTER's per-route RED (the proxied write path surfaces a
    partition as master 5xx — exactly the error-budget burn the rule
    exists to catch)."""
    from ..observability.alerts import Rule

    for r in master.alert_engine.rules:
        r.keep_firing_s = 3.0
        if r.kind == "burn_rate":
            r.params.update({"fast_s": 3.0, "slow_s": 8.0,
                             "min_requests": 15})
    master.alert_engine.add_rule(Rule(
        "scenario_error_burn", "burn_rate", severity="critical",
        keep_firing_s=3.0,
        params={"mode": "error_ratio",
                "errors": "SeaweedFS_master_request_errors_total",
                "requests": "SeaweedFS_master_request_total",
                "max_ratio": 0.05, "fast_s": 3.0, "slow_s": 8.0,
                "min_requests": 10},
        description="run-scoped: master 5xx ratio > 5% over the "
                    "drill-scale fast+slow windows"))


def _preload(master_url: str, spec: ScenarioSpec,
             rng: random.Random) -> list[tuple[str, str]]:
    """Write the hot set; returns rank -> (fid, url) REORDERED so
    consecutive ranks round-robin across the servers that hold them —
    the Zipf head's mass then splits evenly, and partitioning one
    server costs ~1/N of the traffic by construction instead of by
    luck."""
    sizes = SizeSampler(spec.sizes)
    by_url: dict[str, list[tuple[str, str]]] = {}
    for rank in range(spec.hot_set):
        r = http_json("GET", f"http://{master_url}/dir/assign?count=1",
                      timeout=15.0)
        fid, url = r["fid"], r["url"]
        payload = payload_for(sizes.sample(rng), rank)
        st, body, _ = http_bytes("POST", f"http://{url}/{fid}", payload,
                                 timeout=30.0)
        if st not in (200, 201):
            raise RuntimeError(
                f"preload write {fid} -> {st}: {body[:120]!r}")
        by_url.setdefault(url, []).append((fid, url))
    ranks: list[tuple[str, str]] = []
    buckets = [list(v) for _u, v in sorted(by_url.items())]
    if spec.preload_locality:
        # keep placement: consecutive ranks stay on the server the
        # master chose, so the Zipf head lives on one server/volume
        # and a mid-run head shift moves heat BETWEEN volumes (what
        # the flash-crowd drill proves) instead of pre-smearing it
        for b in buckets:
            ranks.extend(b)
        return ranks
    while any(buckets):
        for b in buckets:
            if b:
                ranks.append(b.pop(0))
    return ranks


def _client_loop(ci: int, spec: ScenarioSpec, master_url: str,
                 ranks: list, zipf: ZipfSampler, t0: float,
                 stop: threading.Event, out: list,
                 shift: dict) -> None:
    rng = random.Random(spec.seed * 1000003 + ci)
    sizes = SizeSampler(spec.sizes)
    written: list[tuple[str, str]] = []  # this client's own objects
    seq = 0
    # open-loop pacing (replayed recordings): each client owns an
    # interleaved slice of a fixed global schedule — slot k of client
    # ci fires at (ci + k*clients)/target_rps.  The schedule never
    # slips: an op that ran long makes the NEXT slot fire immediately
    # (catch-up), so a degraded server faces the recorded arrival
    # rate instead of quietly back-pressuring its own load.
    pace = spec.target_rps > 0
    interval = spec.clients / spec.target_rps if pace else 0.0
    next_t = t0 + (ci / spec.target_rps) if pace else 0.0
    while not stop.is_set():
        if pace:
            delay = next_t - time.monotonic()
            if delay > 0 and stop.wait(delay):
                break
            next_t += interval
        op = pick_op(rng, spec.read_fraction, spec.churn_fraction)
        if op == "delete" and not written:
            op = "write"
        t_op = time.monotonic()
        status = 0
        try:
            with _deadline.scope(spec.deadline_s):
                if op == "read":
                    # shift["off"] rotates the popularity ranking: rank
                    # r's traffic lands on object (r + off) % n, so a
                    # mid-run off jump moves the WHOLE Zipf head to
                    # previously cold objects (the flash-crowd drill)
                    fid, url = ranks[(zipf.sample(rng) + shift["off"])
                                     % len(ranks)]
                    status, _b, _h = http_bytes(
                        "GET", f"http://{url}/{fid}", timeout=30.0)
                elif op == "write":
                    seq += 1
                    payload = payload_for(sizes.sample(rng),
                                          ci * 31 + seq)
                    if rng.random() < spec.submit_fraction:
                        status, body, _h = http_bytes(
                            "POST", f"http://{master_url}/submit",
                            payload, timeout=30.0)
                        if status == 201:
                            doc = json.loads(body)
                            written.append(
                                (doc["fid"],
                                 doc["fileUrl"].rsplit("/", 1)[0]))
                    else:
                        r = http_json(
                            "GET",
                            f"http://{master_url}/dir/assign?count=1",
                            timeout=30.0)
                        status, _b, _h = http_bytes(
                            "POST", f"http://{r['url']}/{r['fid']}",
                            payload, timeout=30.0)
                        if 200 <= status < 300:
                            written.append((r["fid"], r["url"]))
                else:  # delete
                    fid, url = written.pop(
                        rng.randrange(len(written)))
                    status, _b, _h = http_bytes(
                        "DELETE", f"http://{url}/{fid}", timeout=30.0)
        except _deadline.DeadlineExceeded:
            status = 504
        except HttpError as e:
            status = e.status
        except Exception:
            status = 0
        out.append(_Op(op, t_op - t0, time.monotonic() - t_op, status))


def _route_stats(ops: list, wall_s: float) -> dict:
    by_route: dict[str, list] = {}
    for o in ops:
        by_route.setdefault(o.route, []).append(o)
    out = {}
    for route, rops in sorted(by_route.items()):
        lat = sorted(o.lat for o in rops if o.ok)
        errors = sum(1 for o in rops if not o.ok)
        out[route] = {
            "ops": len(rops),
            "ok": len(rops) - errors,
            "errors": errors,
            "error_ratio": round(errors / len(rops), 4) if rops else 0.0,
            "rps": round(len(rops) / max(wall_s, 1e-9), 1),
            "ok_rps": round((len(rops) - errors) / max(wall_s, 1e-9), 1),
            "p50_ms": round(_percentile(lat, 0.50) * 1e3, 1),
            "p90_ms": round(_percentile(lat, 0.90) * 1e3, 1),
            "p99_ms": round(_percentile(lat, 0.99) * 1e3, 1),
            "shed_503": sum(1 for o in rops if o.status == 503),
            "deadline_504": sum(1 for o in rops if o.status == 504),
        }
    return out


def _phase_stats(ops: list, phases: dict, wall_s: float) -> dict:
    out = {}
    for name, (lo, hi) in phases.items():
        pops = [o for o in ops if lo <= o.t < hi]
        lat = sorted(o.lat for o in pops if o.ok)
        # rate over the phase's REAL extent (the last phase's inclusion
        # bound is open-ended so stragglers land somewhere)
        span = max(min(hi, wall_s) - lo, 1e-9)
        out[name] = {
            "ops": len(pops),
            "ok_rps": round(sum(1 for o in pops if o.ok) / span, 1),
            "error_ratio": round(
                sum(1 for o in pops if not o.ok) / len(pops), 4)
            if pops else 0.0,
            "accepted_p99_ms": round(_percentile(lat, 0.99) * 1e3, 1),
        }
    return out


def _evaluate(spec: ScenarioSpec, result: dict,
              watch: _AlertWatch, fault_window) -> list[dict]:
    """Score the spec's expectations -> the checks list."""
    checks: list[dict] = []
    exp = spec.expectations

    def check(name, ok, value, bound):
        checks.append({"check": name, "ok": bool(ok),
                       "value": value, "bound": bound})

    if "max_error_ratio" in exp:
        total = sum(r["ops"] for r in result["routes"].values())
        errs = sum(r["errors"] for r in result["routes"].values())
        ratio = round(errs / total, 4) if total else 0.0
        check("error_ratio", ratio <= exp["max_error_ratio"], ratio,
              exp["max_error_ratio"])
    if "deadline_overrun_max_ms" in exp:
        over = result["deadline"]["max_overrun_ms"]
        check("deadline_overrun_ms",
              over <= exp["deadline_overrun_max_ms"], over,
              exp["deadline_overrun_max_ms"])
        violations = result["deadline"]["violations"]
        check("deadline_violations", violations == 0, violations, 0)
    if fault_window is not None:
        ph = result["phases"]
        if "fault_rps_ratio_min" in exp:
            base = ph["healthy"]["ok_rps"] or 1e-9
            ratio = round(ph["fault"]["ok_rps"] / base, 3)
            check("fault_rps_ratio", ratio >= exp["fault_rps_ratio_min"],
                  ratio, exp["fault_rps_ratio_min"])
        if "fault_p99_factor_max" in exp:
            base = ph["healthy"]["accepted_p99_ms"] or 1e-9
            factor = round(ph["fault"]["accepted_p99_ms"] / base, 2)
            check("fault_p99_factor",
                  factor <= exp["fault_p99_factor_max"], factor,
                  exp["fault_p99_factor_max"])
    if "alert_fired_any" in exp and watch is not None:
        names = exp["alert_fired_any"]
        fired = [n for n in names if n in watch.fired_at]
        check("alert_fired", bool(fired), fired, names)
        if exp.get("alert_resolved"):
            unresolved = sorted(set(fired) & watch.firing_now())
            check("alert_resolved", not unresolved,
                  unresolved, [])
    if "heat_alert_within_s" in exp:
        heat = result.get("heat") or {}
        lat = heat.get("alert_latency_s")
        check("heat_alert_within_s",
              lat is not None and lat <= exp["heat_alert_within_s"],
              lat, exp["heat_alert_within_s"])
        check("heat_alert_named_volume",
              bool(heat.get("named_volume")),
              heat.get("named_volume"), "nonempty")
    auto = result.get("autoscale") or {}
    if "autoscale_grow_within_s" in exp:
        g = auto.get("first_grow_after_shift_s")
        check("autoscale_grow_within_s",
              g is not None and g <= exp["autoscale_grow_within_s"],
              g, exp["autoscale_grow_within_s"])
    if exp.get("autoscale_attribution"):
        check("autoscale_attribution", bool(auto.get("attributed")),
              auto.get("attributed"), True)
    if "autoscale_recover_within_s" in exp:
        r = auto.get("slo_recovery_s")
        check("autoscale_recover_within_s",
              r is not None and r <= exp["autoscale_recover_within_s"],
              r, exp["autoscale_recover_within_s"])
    if "autoscale_max_cycles" in exp:
        c = auto.get("max_cycles_per_volume", 0)
        check("autoscale_max_cycles", c <= exp["autoscale_max_cycles"],
              c, exp["autoscale_max_cycles"])
    return checks


def run_against(spec: ScenarioSpec, master_url: str,
                log=None) -> dict:
    """Drive a ScenarioSpec against a LIVE cluster (the
    ``workload.replay -against host:port`` mode): same client loops,
    same open-loop pacing, same result/checks document — but the
    servers are whoever answers at ``master_url`` instead of an
    in-process cluster spawned for the run.  This is how a recorded
    workload proves a refactor on real before/after builds: record on
    the old build, replay -against both, bench_diff the numbers.

    No faults are armed and no alert engine is sampled (the live
    cluster's own alert plane keeps running); the hot set is PRELOADED
    onto the target (it writes load objects, like capacity.probe —
    hold the admin lock).  Checks cover the spec's error-ratio and
    deadline expectations; fault-phase expectations are skipped."""
    say = log or (lambda _m: None)
    rng = random.Random(spec.seed)
    say(f"{spec.name}: preloading {spec.hot_set} objects onto "
        f"{master_url}")
    ranks = _preload(master_url, spec, rng)
    zipf = ZipfSampler(len(ranks), spec.zipf_s)
    result: dict = {"name": spec.name, "spec": spec.to_dict(),
                    "against": master_url}
    stop = threading.Event()
    t0 = time.monotonic()
    shift = {"off": 0}  # replay mode never shifts the head
    per_client_ops: list[list] = [[] for _ in range(spec.clients)]
    threads = [threading.Thread(
        target=_client_loop,
        args=(ci, spec, master_url, ranks, zipf, t0, stop,
              per_client_ops[ci], shift),
        daemon=True, name=f"replay-{spec.name}-c{ci}")
        for ci in range(spec.clients)]
    say(f"{spec.name}: driving {spec.clients} clients for "
        f"{spec.duration_s:.0f}s against {master_url}")
    for t in threads:
        t.start()
    try:
        time.sleep(spec.duration_s)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    ops = [o for lst in per_client_ops for o in lst]
    ops.sort(key=lambda o: o.t)
    wall = spec.duration_s
    overruns = [max(0.0, o.lat - spec.deadline_s) for o in ops]
    result.update({
        "wall_s": round(wall, 1),
        "total_ops": len(ops),
        "routes": _route_stats(ops, wall),
        "phases": _phase_stats(ops, {"healthy": (0.0, wall + 1e9)},
                               wall),
        "deadline": {
            "budget_s": spec.deadline_s,
            "violations": sum(1 for ov in overruns if ov > 0.25),
            "max_overrun_ms": round(max(overruns, default=0.0) * 1e3,
                                    1),
        },
    })
    checks = _evaluate(spec, result, None, None)
    result["checks"] = checks
    result["degraded"] = any(not c["ok"] for c in checks)
    result["verdict"] = "degraded" if result["degraded"] else "pass"
    return result


def run_scenario(spec: ScenarioSpec, base_dir: Optional[str] = None,
                 log=None, device="cuda") -> dict:
    """Run one scenario end to end on volume servers whose EC work runs
    on ``device``; returns the result document.  Always cleans up
    (servers, fault points, retry-budget buckets): scenarios must
    compose in one process."""
    from ..master.server import MasterServer
    from ..observability import (disable_tracing, enable_tracing,
                                 get_tracer, set_sample_rate)
    from ..observability.context import sample_rate
    from ..stats import request_plane_metrics
    from ..volume_server.server import VolumeServer

    say = log or (lambda _m: None)
    roots = [tempfile.mkdtemp(dir=base_dir)
             for _ in range(spec.n_volume_servers)]
    tracing_was_on = get_tracer().enabled
    prev_rate = sample_rate()
    if not tracing_was_on:
        enable_tracing()
    # only forced requests trace (zero hot-path cost) — except heat
    # drills, where a small head rate gives the shift detector's event
    # an exemplar trace to carry (the accumulator keeps the freshest
    # sampled trace id per volume)
    set_sample_rate(0.02 if spec.head_shift_frac > 0 else 0.0)
    result: dict = {"name": spec.name, "spec": spec.to_dict()}
    stop = threading.Event()
    threads: list[threading.Thread] = []
    master = None
    servers: list = []
    try:
        # everything that can fail (port races on start, registration
        # timeouts) happens INSIDE the try: a scenario that dies half-
        # started must still stop whatever came up — scenarios run
        # back-to-back in one bench process, and a leaked telemetry
        # loop would skew the next one's counters
        # drill-scale autoscaler knobs: second-scale planning, a grow
        # threshold the shifted Zipf head clears within one decay
        # half-life, short hold-down/cooldown so a shrink could
        # physically happen inside the run (the thrash guard must
        # hold by HYSTERESIS, not by the run being too short to flap)
        auto_opts = {"grow_share": 0.30, "cold_share": 0.02,
                     "hold_down_s": 6.0, "regrow_cooldown_s": 6.0,
                     "max_replicas": 3, "move_rate": 2.0,
                     "move_burst": 4.0, "actuation_deadline_s": 30.0} \
            if spec.autoscale else None
        master = MasterServer(port=_free_port(), pulse_seconds=0.3,
                              metrics_aggregation_seconds=0.25,
                              autoscale_seconds=(
                                  1.0 if spec.autoscale else 0.0),
                              autoscale_opts=auto_opts).start()
        master.aggregator.min_interval = 0.0
        master.alert_engine.min_interval = 0.0
        if spec.fast_alerts:
            _shrink_alert_windows(master)
        for i in range(spec.n_volume_servers):
            servers.append(VolumeServer(
                [roots[i]], master.url, port=_free_port(),
                rack=f"r{i}", data_center="dc1", pulse_seconds=0.3,
                max_volume_count=16, device=device,
                max_inflight=spec.max_inflight).start())
        plane0 = request_plane_metrics().totals()
        deadline_reg = time.time() + 15
        while time.time() < deadline_reg and \
                len(master.topo.all_nodes()) < spec.n_volume_servers:
            time.sleep(0.05)
        # pre-grow volumes across EVERY server: the first assign's
        # growth is winner-takes-all on the emptiest node, which would
        # quietly put the whole hot set on one server — a partition
        # drill against any OTHER server would then prove nothing
        try:
            http_json("GET", f"http://{master.url}/vol/grow"
                             f"?count={3 * spec.n_volume_servers}",
                      timeout=30.0)
        except HttpError:
            pass  # assign-triggered growth still works
        if spec.head_shift_frac > 0:
            # heat drill scale: second-scale decay so the shifted head
            # dominates the merged ranking within a couple of shipper
            # flushes, a trailing window short enough that the
            # PRE-shift head is still what "trailing" means when the
            # detector compares, and per-volume event rate limiting
            # that cannot swallow the one shift this run proves
            for vs in servers:
                vs.heat.set_half_life(2.0)
            master.heat_journal.trail_s = max(
                3.0, 0.2 * spec.duration_s)
            master.heat_journal.min_event_interval = 2.0
        rng = random.Random(spec.seed)
        say(f"{spec.name}: preloading {spec.hot_set} objects")
        ranks = _preload(master.url, spec, rng)
        zipf = ZipfSampler(len(ranks), spec.zipf_s)

        t0 = time.monotonic()
        t0_wall = time.time()  # event timestamps are wall-clock
        watch = _AlertWatch(master, t0)
        fault_window = None
        if spec.faults:
            lo = min(f.at_frac for f in spec.faults) * spec.duration_s
            hi = max(f.clear_frac for f in spec.faults) * spec.duration_s
            fault_window = (lo, hi)

        def resolve_peer(peer: str) -> Optional[str]:
            if peer.startswith("vs"):
                try:
                    return servers[int(peer[2:])].url
                except (ValueError, IndexError):
                    return None
            return peer or None

        fault_log: list[dict] = []

        def fault_timeline():
            events = []
            for f in spec.faults:
                events.append((f.at_frac * spec.duration_s, "arm", f))
                events.append((f.clear_frac * spec.duration_s,
                               "clear", f))
            for at, action, f in sorted(events, key=lambda e: e[0]):
                while not stop.is_set() and \
                        time.monotonic() - t0 < at:
                    time.sleep(0.05)
                if stop.is_set():
                    break
                peer = resolve_peer(f.peer)
                if action == "arm":
                    fi.enable(f.point, error_rate=f.error_rate,
                              delay=f.delay,
                              params={"peer": peer} if peer else None)
                    say(f"{spec.name}: armed {f.point} on {peer}")
                else:
                    fi.disable(f.point)
                    say(f"{spec.name}: cleared {f.point}")
                fault_log.append({
                    "t": round(time.monotonic() - t0, 2),
                    "action": action, "point": f.point, "peer": peer})

        shift = {"off": 0}  # read-index rotation shared with clients
        shift_t = [0.0]     # when the head actually moved (t0-relative)

        def head_shifter():
            at = spec.head_shift_frac * spec.duration_s
            while not stop.is_set() and time.monotonic() - t0 < at:
                time.sleep(0.05)
            if stop.is_set():
                return
            # aim the new Zipf head at the COLDEST volume's ranks, not
            # a blind half-rotation: the master's placement can stack
            # most fids onto the already-hot volume, and a rotation
            # that lands back on it moves no heat at all — the drill
            # would then (correctly!) see no head-set shift
            vol_of = [fid.partition(",")[0] for fid, _ in ranks]
            warm: dict = {}
            for i, v in enumerate(vol_of):
                warm[v] = warm.get(v, 0.0) + zipf.pmf(i % zipf.n)
            cold = min(warm, key=lambda v: warm[v])
            shift["off"] = next(
                (i for i, v in enumerate(vol_of) if v == cold),
                len(ranks) // 2)
            shift_t[0] = round(time.monotonic() - t0, 2)
            say(f"{spec.name}: Zipf head shifted by {shift['off']} "
                "ranks onto cold volume {} at t={:.1f}s".format(
                    cold, shift_t[0]))

        def replica_refresher():
            # the autoscaler's grows only help if clients FIND the new
            # replicas: re-lookup every distinct volume in the rank
            # list and spread consecutive ranks round-robin across the
            # current locations (tuple swaps are atomic under the GIL,
            # so the client loops never see a torn entry)
            while not stop.is_set():
                if stop.wait(0.5):
                    break
                vols: dict[str, list[int]] = {}
                for i, (fid, _u) in enumerate(ranks):
                    vols.setdefault(fid.partition(",")[0], []).append(i)
                for vol, idxs in vols.items():
                    try:
                        doc = http_json(
                            "GET", f"http://{master.url}/dir/lookup"
                                   f"?volumeId={vol}", timeout=5.0)
                    except Exception:
                        continue
                    urls = [loc["url"]
                            for loc in doc.get("locations") or []]
                    if not urls:
                        continue
                    for k, i in enumerate(idxs):
                        ranks[i] = (ranks[i][0], urls[k % len(urls)])

        def alert_poller():
            while not stop.is_set():
                watch.sample()
                time.sleep(0.25)

        def vacuum_loop():
            while not stop.is_set():
                if stop.wait(spec.vacuum_every_s):
                    break
                try:
                    http_json("GET", f"http://{master.url}/vol/vacuum"
                                     "?garbageThreshold=0.01",
                              timeout=20.0)
                except Exception:
                    pass

        per_client_ops: list[list] = [[] for _ in range(spec.clients)]
        threads = [threading.Thread(
            target=_client_loop,
            args=(ci, spec, master.url, ranks, zipf, t0, stop,
                  per_client_ops[ci], shift),
            daemon=True, name=f"scn-{spec.name}-c{ci}")
            for ci in range(spec.clients)]
        threads.append(threading.Thread(target=fault_timeline,
                                        daemon=True, name="scn-faults"))
        threads.append(threading.Thread(target=alert_poller,
                                        daemon=True, name="scn-alerts"))
        if spec.head_shift_frac > 0:
            threads.append(threading.Thread(target=head_shifter,
                                            daemon=True,
                                            name="scn-shift"))
        if spec.autoscale:
            threads.append(threading.Thread(target=replica_refresher,
                                            daemon=True,
                                            name="scn-replicas"))
        if spec.vacuum_every_s > 0:
            threads.append(threading.Thread(target=vacuum_loop,
                                            daemon=True,
                                            name="scn-vacuum"))
        say(f"{spec.name}: driving {spec.clients} clients for "
            f"{spec.duration_s:.0f}s")
        for t in threads:
            t.start()
        time.sleep(spec.duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        fi.clear()

        # grace window: alerts that the fault lit must get their chance
        # to resolve (keep_firing_s is drill-scale when fast_alerts)
        watched_names = set(watch.fired_at)
        grace_deadline = time.time() + 8.0
        while time.time() < grace_deadline:
            watch.sample()
            if not (watched_names & watch.firing_now()):
                break
            time.sleep(0.25)

        ops = [o for lst in per_client_ops for o in lst]
        ops.sort(key=lambda o: o.t)
        wall = spec.duration_s
        phases = {"healthy": (0.0, fault_window[0]),
                  "fault": fault_window,
                  "recovery": (fault_window[1], wall + 1e9)} \
            if fault_window else {"healthy": (0.0, wall + 1e9)}
        overruns = [max(0.0, o.lat - spec.deadline_s) for o in ops]
        plane1 = request_plane_metrics().totals()
        result.update({
            "wall_s": round(wall, 1),
            "total_ops": len(ops),
            "routes": _route_stats(ops, wall),
            "phases": _phase_stats(ops, phases, wall),
            "faults": fault_log,
            "alerts": {
                "fired": sorted(watch.fired_at),
                "resolved": sorted(watch.resolved_at),
                "still_firing": sorted(watch.firing_now()),
                "timeline": watch.timeline[:64],
            },
            "counters": {k: plane1[k] - plane0[k] for k in plane1},
            "deadline": {
                "budget_s": spec.deadline_s,
                "violations": sum(1 for ov in overruns if ov > 0.25),
                "max_overrun_ms": round(max(overruns, default=0.0)
                                        * 1e3, 1),
            },
        })

        # one forced-sample stitched trace as proof the request plane
        # still traces end to end under scenario load
        try:
            fid, url = ranks[0]
            st, _b, hdrs = http_bytes(
                "GET", f"http://{url}/{fid}",
                headers={"X-Force-Trace": "1"}, timeout=10.0)
            trace_id = hdrs.get("X-Trace-Id", "")
            doc = None
            t_tr = time.time() + 5
            while time.time() < t_tr and trace_id:
                try:
                    doc = http_json(
                        "GET", f"http://{master.url}/cluster/traces/"
                               f"{trace_id}", timeout=5.0)
                    break
                except HttpError:
                    time.sleep(0.2)
            if doc:
                an = doc.get("analysis") or {}
                result["trace"] = {
                    "trace_id": trace_id,
                    "span_count": doc.get("span_count", 0),
                    "servers": doc.get("servers", []),
                    "bounding_hop": an.get("bounding_hop", ""),
                }
        except Exception:
            pass

        if spec.head_shift_frac > 0:
            # capture the heat plane's verdict BEFORE teardown.  The
            # latency measure uses the shift EVENT stream, not the
            # alert state machine: reads ramping from zero at run
            # start can legitimately read as a heat shift (they are
            # one), so the proof is the first event emitted AT/AFTER
            # the head move — it must name the newly hot volume and
            # carry an exemplar trace, and the journal_event alert
            # must be firing on it
            fired = {n: t for n, t in watch.fired_at.items()
                     if n in ("heat_shift", "flash_crowd")}
            heat_block: dict = {"shift_t": shift_t[0],
                                "alerts_fired": fired}
            # post-shift serving rate over the NEW hot set: the number
            # an autoscaler's grows should lift (without them the
            # shifted head stays pinned to one server)
            if shift_t[0] and wall > shift_t[0] + 1.0:
                post_ok = sum(1 for o in ops if o.ok
                              and o.route == "read"
                              and o.t >= shift_t[0])
                heat_block["post_shift_read_rps"] = round(
                    post_ok / (wall - shift_t[0]), 1)
            try:
                doc = http_json(
                    "GET", f"http://{master.url}/cluster/heat?top=8",
                    timeout=10.0)
                heat_block["cluster"] = {
                    "volumes": doc.get("volumes", [])[:6],
                    "head": doc.get("head", {}),
                    "zipf": doc.get("zipf", {}),
                    "imbalance": doc.get("imbalance", {}),
                    "shifts": doc.get("shifts", [])[-6:],
                }
                post = [ev for ev in doc.get("shifts", [])
                        if shift_t[0] and float(ev.get("ts") or 0.0)
                        >= t0_wall + shift_t[0]]
                if post:
                    ev = post[0]
                    d = ev.get("details") or {}
                    heat_block.update({
                        "event": ev.get("type"),
                        "alert_latency_s": round(
                            float(ev["ts"]) - t0_wall - shift_t[0], 2),
                        "named_volume": str(d.get("volume", "")),
                        "share": d.get("share"),
                        "prev_share": d.get("prev_share"),
                        "servers": d.get("servers", []),
                        "exemplar_trace": ev.get("trace") or "",
                    })
            except Exception:
                pass
            try:
                for a in master.alert_engine.to_dict()["alerts"]:
                    if a["name"] in ("heat_shift", "flash_crowd") \
                            and a.get("detail"):
                        heat_block["alert_detail"] = a["detail"]
                        heat_block.setdefault(
                            "exemplar_trace",
                            a.get("exemplar_trace", ""))
                        break
            except Exception:
                pass
            result["heat"] = heat_block

        if spec.autoscale:
            # the closed-loop verdict, captured BEFORE teardown: did
            # the autoscaler react to the shift, with attribution, and
            # did the hot set's p99 come back inside the SLO?
            st = master.autoscaler.status()
            grows = [r for r in st.get("recent", ())
                     if r.get("action") == "replica_grow"]
            shift_wall = t0_wall + shift_t[0] if shift_t[0] else None
            first_grow_s = None
            if grows and shift_wall:
                after = [r["at"] - shift_wall for r in grows
                         if r.get("at", 0.0) >= shift_wall - 0.5]
                if after:
                    first_grow_s = round(min(after), 2)
            cycles = [int(t.get("cycles") or 0)
                      for t in st.get("targets", {}).values()]
            auto_block = {
                "status": {k: st.get(k) for k in
                           ("cycles", "grows", "shrinks", "tiers",
                            "recalls", "failures", "targets",
                            "last_error")},
                "grow_events": [{k: r.get(k) for k in
                                 ("at", "vid", "src", "dst", "alert",
                                  "cause_trace", "cause_event")}
                                for r in grows],
                "first_grow_after_shift_s": first_grow_s,
                "attributed": any(r.get("alert") and r.get("cause_trace")
                                  for r in grows),
                "max_cycles_per_volume": max(cycles, default=0),
            }
            # SLO recovery: walk 1s windows of accepted read latency
            # from the shift on; recovery is the end of the first
            # window whose p99 is back inside the bound
            slo_ms = spec.expectations.get("autoscale_slo_p99_ms")
            if slo_ms and shift_t[0]:
                rec_s = None
                w = shift_t[0]
                while w < wall:
                    lat = sorted(o.lat for o in ops if o.ok
                                 and o.route == "read"
                                 and w <= o.t < w + 1.0)
                    if lat and _percentile(lat, 0.99) * 1e3 <= slo_ms:
                        rec_s = round(w + 1.0 - shift_t[0], 2)
                        break
                    w += 1.0
                auto_block["slo_recovery_s"] = rec_s
            result["autoscale"] = auto_block

        checks = _evaluate(spec, result, watch, fault_window)
        result["checks"] = checks
        result["degraded"] = any(not c["ok"] for c in checks)
        result["verdict"] = "degraded" if result["degraded"] else "pass"
        return result
    finally:
        stop.set()
        fi.clear()
        get_retry_budget().reset()
        for vs in servers:
            try:
                vs.stop()
            except Exception:
                pass
        if master is not None:
            try:
                master.stop()
            except Exception:
                pass
        set_sample_rate(prev_rate)
        if not tracing_was_on:
            disable_tracing()
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
