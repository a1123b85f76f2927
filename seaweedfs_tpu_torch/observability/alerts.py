"""Cluster alerting engine: declarative rules over the master's rollup.

The port's copy of seaweedfs_tpu/observability/alerts.py.  The master
already collects what this needs (/cluster/metrics merges every peer's
Prometheus families, /cluster/health sums the degraded-path counters per
peer), but nothing watched them: a shard goes corrupt, a peer goes stale,
load is shed, and nobody is paged.  This engine evaluates on the master's
aggregation cadence (the -metricsAggregationSeconds loop), so the serving
hot path pays nothing.

Rule kinds (declarative: a Rule is data, the engine interprets it, and
/cluster/alerts serves the whole table):

  counter_increase  a HEALTH_FAMILIES counter rose since the last
      evaluation, attributed per peer (corrupt_shards, requests_shed,
      ...).  A counter reset (a restarted peer's value drops) re-baselines
      silently: a reset is never an increase.
  threshold         a /cluster/health totals key reaches a floor
      (scrub_unrepairable >= 1: data is at risk now).
  peer_down         a registered peer is stale or unreachable.
  burn_rate         multi-window SLO burn over the per-route RED
      histograms of the merged cluster metrics: error ratio and p99
      latency, each over a fast (5 m) and a slow (1 h) window, active
      only when both breach.
  journal_event     a typed event of params["event"] landed in the
      process journal within params["window_s"] (and after this engine
      was made: a previous run's events never fire a fresh engine).  The
      detectors page this way: heat's shift detector (heat_shift,
      flash_crowd; heat.py) and the resource ledger's stall relay
      (loop_stall; ledger.py), both on the master.

State machine per rule: inactive -> pending -> firing -> resolved.
``for_s`` is the pending hold-down; ``keep_firing_s`` keeps a firing
alert up through flapping and resolves it after that much quiet.  Every
transition is journaled (alert_pending, alert_fired, alert_resolved), and
the firing transition hands the rule and its implicated servers to
``on_fire`` (the master's flight-recorder capture) once per fire.

``export_state``/``import_state`` carry the state machines (state,
pending windows, fire times, bundles, the exemplar trace) through the
masters' raft log, so a promoted follower continues a firing alert; the
evaluation baselines stay local, and a new leader's first evaluation
re-seeds them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from . import events as _events
from .heat import HEAT_EVENT_TYPES
from .ledger import LEDGER_EVENT_TYPES

# alert states, in lifecycle order
STATES = ("inactive", "pending", "firing", "resolved")

# /cluster/health totals keys that are not HEALTH_FAMILIES counters but
# are legal threshold-rule targets (the aggregator's scrub rollup)
EXTRA_HEALTH_KEYS = ("scrub_unrepairable",)


def _severity(etype: str) -> str:
    """An event type's severity from the port's registry or the
    reference-only one; "warning" for a type neither knows."""
    return _events.EVENT_TYPES.get(etype) or \
        _events.REFERENCE_ONLY_EVENT_TYPES.get(etype, "warning")


class Rule:
    """One declarative alert rule.  Pure data — serializable for the
    /cluster/alerts rules table and the README's default-rule table."""

    __slots__ = ("name", "kind", "severity", "for_s", "keep_firing_s",
                 "params", "description")

    def __init__(self, name: str, kind: str, severity: str = "warning",
                 for_s: float = 0.0, keep_firing_s: float = 300.0,
                 params: Optional[dict] = None, description: str = ""):
        self.name = name
        self.kind = kind
        self.severity = severity
        self.for_s = float(for_s)
        self.keep_firing_s = float(keep_firing_s)
        self.params = dict(params or {})
        self.description = description

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "severity": self.severity, "for_s": self.for_s,
                "keep_firing_s": self.keep_firing_s,
                "params": dict(self.params),
                "description": self.description}


def default_rules() -> list[Rule]:
    """The shipped rule set.  One counter_increase rule per
    HEALTH_FAMILIES key, the unrepairable-data threshold, peer
    reachability, and the two multi-window burn-rate SLOs on the volume
    servers' per-route RED histograms."""
    from ..stats.aggregate import HEALTH_FAMILIES

    rules: list[Rule] = []
    for key in sorted(HEALTH_FAMILIES):
        # the rule's severity is the severity of the event type that
        # family's chokepoint journals
        sev = _severity(_events.HEALTH_EVENT_TYPES.get(key) or
                        _events.REFERENCE_ONLY_HEALTH_EVENT_TYPES.get(key, ""))
        rules.append(Rule(
            f"{key}_increase", "counter_increase", severity=sev,
            for_s=0.0, keep_firing_s=300.0, params={"key": key},
            description=f"cluster {key} counter increased "
                        "(self-healing activity: something degraded)"))
    rules.append(Rule(
        "scrub_unrepairable", "threshold", severity="critical",
        for_s=0.0, keep_firing_s=600.0,
        params={"key": "scrub_unrepairable", "min": 1},
        description="a scrub verdict says < k clean shards remain "
                    "somewhere: data is at risk until repaired"))
    rules.append(Rule(
        "peer_down", "peer_down", severity="error",
        # keep_firing damps flapping: a peer timing out every other
        # scrape must stay ONE firing alert (one capture fan-out), not
        # fire/resolve per cycle and churn the bundle spool
        for_s=0.0, keep_firing_s=60.0,
        description="a heartbeat-registered volume server is "
                    "unreachable or serving stale metrics"))
    rules.append(Rule(
        "volume_error_burn", "burn_rate", severity="critical",
        for_s=0.0, keep_firing_s=300.0,
        params={"mode": "error_ratio",
                "errors": "SeaweedFS_volumeServer_request_errors_total",
                "requests": "SeaweedFS_volumeServer_request_total",
                "max_ratio": 0.01, "fast_s": 300.0, "slow_s": 3600.0,
                "min_requests": 10},
        description="volume-server 5xx ratio > 1% over BOTH the 5m "
                    "and 1h windows (sustained error budget burn)"))
    rules.append(Rule(
        "volume_latency_burn", "burn_rate", severity="critical",
        for_s=0.0, keep_firing_s=300.0,
        params={"mode": "p99",
                "family": "SeaweedFS_volumeServer_request_seconds",
                "max_p99_s": 0.5, "fast_s": 300.0, "slow_s": 3600.0,
                "min_requests": 10},
        description="volume-server per-route p99 latency > 500ms over "
                    "BOTH the 5m and 1h windows"))
    # heat's shift detector relays: one journal_event rule per
    # HEAT_EVENT_TYPES entry, severity from the event registry
    heat_descriptions = {
        "heat_shift": "the Zipf head moved: a volume newly entered "
                      "the cluster heat head set",
        "flash_crowd": "a previously-cold volume took the heat head "
                       "outright (flash crowd): replicate/cache it NOW",
    }
    for etype in HEAT_EVENT_TYPES:
        rules.append(Rule(
            etype, "journal_event",
            severity=_severity(etype),
            for_s=0.0, keep_firing_s=120.0,
            params={"event": etype, "window_s": 30.0},
            description=heat_descriptions.get(etype, "")))
    # the resource ledger's loop-stall relay: one loop_stall event per
    # peer-reported stall, the same journal_event contract
    ledger_descriptions = {
        "loop_stall": "a reactor event loop was blocked past the "
                      "stall threshold: every connection on that "
                      "server froze (the event names the route)",
    }
    for etype in LEDGER_EVENT_TYPES:
        rules.append(Rule(
            etype, "journal_event",
            severity=_severity(etype),
            for_s=0.0, keep_firing_s=120.0,
            params={"event": etype, "window_s": 30.0},
            description=ledger_descriptions.get(etype, "")))
    return rules


class AlertState:
    """Mutable per-rule evaluation state (serialized for
    /cluster/alerts)."""

    __slots__ = ("rule", "state", "pending_since", "fired_at",
                 "resolved_at", "last_active", "value", "detail",
                 "servers", "fires", "bundles", "exemplar_trace")

    def __init__(self, rule: Rule):
        self.rule = rule
        self.state = "inactive"
        self.pending_since = 0.0
        self.fired_at = 0.0
        self.resolved_at = 0.0
        self.last_active = 0.0
        self.value = 0.0
        self.detail = ""
        self.servers: list[str] = []
        self.fires = 0
        self.bundles: list[dict] = []
        self.exemplar_trace = ""

    def to_dict(self) -> dict:
        d = {"name": self.rule.name, "severity": self.rule.severity,
             "state": self.state, "value": self.value,
             "detail": self.detail, "servers": list(self.servers),
             "fires": self.fires}
        if self.pending_since:
            d["pending_since"] = round(self.pending_since, 3)
        if self.fired_at:
            d["fired_at"] = round(self.fired_at, 3)
        if self.resolved_at:
            d["resolved_at"] = round(self.resolved_at, 3)
        if self.bundles:
            d["bundles"] = list(self.bundles)
        if self.exemplar_trace:
            d["exemplar_trace"] = self.exemplar_trace
        return d


class AlertEngine:  # weedlint: concurrent-class
    """Evaluate rules against (health, families) snapshots.  Reached
    concurrently: the master's telemetry loop evaluates on a timer
    while HTTP threads serve on-demand GET /cluster/alerts.

    `source_fn()` returns the pair the master already computes:
    aggregator.health() and aggregator.merged().  `on_fire(rule,
    state_doc, servers)` runs on the firing transition (the flight-
    recorder hook; the caller backgrounds any slow work).
    `exemplar_fn(rule)` may return a trace id correlated with the fire
    (the master looks the most recent matching journal event up), so
    the alert carries the trace that explains it."""

    def __init__(self, rules: list[Rule],
                 source_fn: Callable[[], tuple],
                 server: str = "",
                 journal=None,
                 on_fire: Optional[Callable] = None,
                 exemplar_fn: Optional[Callable[[Rule], str]] = None,
                 min_interval: float = 1.0):
        self.rules = list(rules)
        self.source_fn = source_fn
        self.server = server
        self.journal = journal or _events.get_journal()
        self.on_fire = on_fire
        self.exemplar_fn = exemplar_fn
        self.min_interval = min_interval
        self._states = {r.name: AlertState(r) for r in self.rules}  # guarded-by: _lock
        # counter_increase baselines: rule name -> {peer|__total__: val}
        self._baselines: dict[str, dict] = {}  # guarded-by: _lock
        # burn_rate sample history: rule name -> deque[(ts, digest)]
        self._history: dict[str, deque] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.evaluated_at = 0.0  # guarded-by: _lock
        self.evaluations = 0  # guarded-by: _lock
        # journal_event floor: events emitted before this engine
        # existed (a previous drill in the same process) never fire it
        self._created = time.time()

    # --- evaluation -------------------------------------------------------
    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> dict:
        """One evaluation round; TTL-guarded so the on-demand
        /cluster/alerts GET cannot be turned into an evaluation
        amplifier next to the periodic loop.  `now` is injectable for
        the state-machine tests."""
        now = time.time() if now is None else now
        with self._lock:
            fresh = not force and \
                now - self.evaluated_at < self.min_interval
            if not fresh:
                self.evaluated_at = now
                self.evaluations += 1
        if fresh:
            # serve the last round's state (to_dict retakes the lock,
            # so the early return must happen outside it)
            return self.to_dict()
        health, families = self.source_fn()
        fired: list[tuple[Rule, dict, list[str]]] = []
        with self._lock:
            for rule in self.rules:
                try:
                    active, value, detail, servers = self._eval_rule(
                        rule, health, families, now)
                except Exception as e:  # a broken rule must not stop
                    active, value = False, 0.0  # the others evaluating
                    detail = f"rule error: {type(e).__name__}: {e}"
                    servers = []
                    # surface the breakage on the (inactive) alert —
                    # _transition only records detail while active
                    self._states[rule.name].detail = detail
                f = self._transition(rule, active, value, detail,
                                     servers, now)
                if f is not None:
                    fired.append(f)
            doc = self._to_dict_locked()
        # callbacks OUTSIDE the lock: capture fan-out does HTTP
        for rule, state_doc, servers in fired:
            if self.on_fire is not None:
                try:
                    self.on_fire(rule, state_doc, servers)
                except Exception:
                    pass
        return doc

    # --- replication (master HA) ------------------------------------------
    def export_state(self) -> dict:
        """The per-rule state machines as a plain replicable document
        (what the leader appends as ``alert`` raft-log entries): every
        field a promoted follower needs to continue a firing alert
        (pending windows, fire times, exemplar traces) rather than
        re-learn it mid-incident.  Evaluation internals (counter
        baselines, burn-rate history) stay local: a new leader re-seeds
        them from its own first scrape."""
        with self._lock:
            return {name: {
                "state": st.state,
                "pending_since": st.pending_since,
                "fired_at": st.fired_at,
                "resolved_at": st.resolved_at,
                "last_active": st.last_active,
                "value": st.value,
                "detail": st.detail,
                "servers": list(st.servers),
                "fires": st.fires,
                "bundles": list(st.bundles),
                "exemplar_trace": st.exemplar_trace,
            } for name, st in self._states.items()}

    def import_state(self, doc: dict) -> None:
        """Replay a replicated alert-state document into the local state
        machines (a follower's apply loop, a snapshot install).  Unknown
        rule names are skipped: rule tables are configuration, not
        replicated state.  Idempotent."""
        with self._lock:
            for name, d in (doc or {}).items():
                st = self._states.get(name)
                if st is None or not isinstance(d, dict):
                    continue
                st.state = str(d.get("state") or "inactive")
                st.pending_since = float(d.get("pending_since") or 0.0)
                st.fired_at = float(d.get("fired_at") or 0.0)
                st.resolved_at = float(d.get("resolved_at") or 0.0)
                st.last_active = float(d.get("last_active") or 0.0)
                st.value = float(d.get("value") or 0.0)
                st.detail = str(d.get("detail") or "")
                st.servers = [str(s) for s in (d.get("servers") or [])]
                st.fires = int(d.get("fires") or 0)
                st.bundles = list(d.get("bundles") or [])
                st.exemplar_trace = str(d.get("exemplar_trace") or "")

    def _transition(self, rule: Rule, active: bool, value: float,  # holds: _lock
                    detail: str, servers: list[str], now: float):
        """Advance one rule's state machine; returns (rule, state_doc,
        servers) when this round crossed into firing, else None.
        Called by evaluate() with _lock held."""
        st = self._states[rule.name]
        if active:
            st.last_active = now
            st.value = value
            st.detail = detail
            st.servers = servers
            if st.state == "firing" and not st.exemplar_trace \
                    and self.exemplar_fn is not None:
                # the correlated event often lands a shipper-flush
                # AFTER the fire: keep looking while firing so the
                # alert self-heals its trace link on the next cadence
                try:
                    st.exemplar_trace = self.exemplar_fn(rule) or ""
                except Exception:
                    pass
            if st.state in ("inactive", "resolved"):
                st.state = "pending"
                st.pending_since = now
                self.journal.emit("alert_pending", server=self.server,
                                  alert=rule.name, value=value,
                                  detail=detail)
            if st.state == "pending" and \
                    now - st.pending_since >= rule.for_s:
                st.state = "firing"
                st.fired_at = now
                st.fires += 1
                st.bundles = []
                if self.exemplar_fn is not None:
                    try:
                        st.exemplar_trace = self.exemplar_fn(rule) or ""
                    except Exception:
                        st.exemplar_trace = ""
                self.journal.emit("alert_fired", severity=rule.severity,
                                  server=self.server, alert=rule.name,
                                  value=value, detail=detail,
                                  servers=servers,
                                  exemplar_trace=st.exemplar_trace)
                return rule, st.to_dict(), list(servers)
        else:
            if st.state == "pending":
                # never fired: a blip shorter than for_s leaves no scar
                st.state = "inactive"
                st.pending_since = 0.0
            elif st.state == "firing" and \
                    now - st.last_active >= rule.keep_firing_s:
                st.state = "resolved"
                st.resolved_at = now
                self.journal.emit("alert_resolved", server=self.server,
                                  alert=rule.name,
                                  active_s=round(
                                      st.last_active - st.fired_at, 3))
        return None

    # --- rule kinds -------------------------------------------------------
    def _eval_rule(self, rule: Rule, health: dict, families: dict,  # holds: _lock
                   now: float):
        if rule.kind == "counter_increase":
            return self._eval_counter_increase(rule, health)
        if rule.kind == "threshold":
            return self._eval_threshold(rule, health)
        if rule.kind == "peer_down":
            return self._eval_peer_down(health)
        if rule.kind == "burn_rate":
            return self._eval_burn_rate(rule, families, now)
        if rule.kind == "journal_event":
            return self._eval_journal_event(rule, now)
        raise ValueError(f"unknown rule kind {rule.kind!r}")

    def _eval_journal_event(self, rule: Rule, now: float):
        """Active while a matching typed event sits inside the window.
        The event already carries the detector's verdict: surface its
        details (volume, share, servers) instead of re-deriving."""
        p = rule.params
        window = float(p.get("window_s", 30.0))
        events = self.journal.query(
            type_=p["event"],
            since_ts=max(now - window, self._created), limit=8)
        if not events:
            return False, 0.0, "", []
        latest = events[-1]
        d = latest.get("details") or {}
        servers = [s for s in (d.get("servers") or []) if s]
        detail = ", ".join(f"{k}={d[k]}" for k in
                           ("volume", "share", "prev_share",
                            "route", "lag_ms")
                           if k in d) or latest.get("type", "")
        return True, float(len(events)), detail, servers

    def _eval_counter_increase(self, rule: Rule, health: dict):  # holds: _lock
        key = rule.params["key"]
        cur: dict[str, float] = {}
        for url, peer in (health.get("peers") or {}).items():
            cur[url] = float(
                (peer.get("pipeline_health") or {}).get(key, 0))
        cur["__total__"] = float(
            (health.get("totals") or {}).get(key, 0))
        prev = self._baselines.get(rule.name)
        self._baselines[rule.name] = cur
        if prev is None:
            # first sight is the baseline: pre-existing totals (old
            # incidents, restarts) must not fire on engine startup
            return False, 0.0, "", []
        inc = {u: cur[u] - prev[u] for u in cur
               if u in prev and cur[u] > prev[u]}
        # cur < prev is a counter RESET (peer restart): tolerated — the
        # new lower value just became the baseline above
        servers = sorted(u for u in inc if u != "__total__")
        if not inc:
            return False, 0.0, "", []
        value = sum(v for u, v in inc.items() if u != "__total__") or \
            inc.get("__total__", 0.0)
        detail = (f"{key} +{int(value)} on "
                  f"{', '.join(servers) if servers else 'cluster'}")
        return True, value, detail, servers

    def _eval_threshold(self, rule: Rule, health: dict):
        key = rule.params["key"]
        floor = float(rule.params.get("min", 1))
        v = float((health.get("totals") or {}).get(key, 0))
        if v < floor:
            return False, v, "", []
        # name the peers whose scrub verdicts carry the damage
        servers = sorted(
            url for url, peer in (health.get("peers") or {}).items()
            if (peer.get("scrub") or {}).get("verdicts", {})
            .get("unrepairable", 0) > 0) if key == "scrub_unrepairable" \
            else []
        return True, v, f"{key}={int(v)}", servers

    def _eval_peer_down(self, health: dict):
        stale = sorted(health.get("stale_peers") or [])
        if not stale:
            return False, 0.0, "", []
        # the implicated servers are unreachable — capture targets are
        # empty; the master-local bundle still records the cluster view
        return True, float(len(stale)), \
            f"unreachable/stale peers: {', '.join(stale)}", []

    # --- burn rate --------------------------------------------------------
    def _eval_burn_rate(self, rule: Rule, families: dict, now: float):  # holds: _lock
        p = rule.params
        digest = self._burn_digest(rule, families)
        hist = self._history.setdefault(rule.name, deque())
        # thin the sample stream: a 1h window at a 1s evaluation
        # cadence must not retain 3600 full per-route snapshots —
        # one sample per ~fast_s/16 bounds memory without changing
        # which windows are answerable
        min_gap = max(1.0, float(p.get("fast_s", 300.0)) / 16.0)
        if not hist or now - hist[-1][0] >= min_gap:
            hist.append((now, digest))
        horizon = now - float(p.get("slow_s", 3600.0)) - 60.0
        while hist and hist[0][0] < horizon:
            hist.popleft()
        fast = self._window_breach(rule, hist, digest, now,
                                   float(p.get("fast_s", 300.0)))
        slow = self._window_breach(rule, hist, digest, now,
                                   float(p.get("slow_s", 3600.0)))
        if fast is None or slow is None:
            return False, 0.0, "", []
        value, detail = fast
        return True, value, \
            f"{detail} (fast+slow windows both breached)", []

    def _burn_digest(self, rule: Rule, families: dict):
        """Per-evaluation snapshot of just what the rule's windows
        need, keyed by route label tuple."""
        p = rule.params
        if p.get("mode") == "error_ratio":
            errs = families.get(p["errors"])
            reqs = families.get(p["requests"])
            e = errs.snapshot() if errs is not None else {}
            r = reqs.snapshot() if reqs is not None else {}
            return {"err": e, "req": r}
        fam = families.get(p["family"])
        if fam is None or not hasattr(fam, "buckets"):
            return {"buckets": (), "hist": {}}
        return {"buckets": tuple(fam.buckets),
                "hist": {k: (tuple(c), t)
                         for k, (c, _s, t) in fam.snapshot().items()}}

    def _window_breach(self, rule: Rule, hist, cur, now: float,
                       window_s: float):
        """The worst (value, detail) breach across routes over one
        window, None when the window has no base sample yet or nothing
        breaches.  The base is the NEWEST sample at least window_s old,
        so a window never fires before it has actually elapsed; `cur`
        is THIS evaluation's digest (which sample-thinning may not have
        appended to the history)."""
        base = None
        for ts, digest in hist:
            if ts <= now - window_s:
                base = digest
            else:
                break
        if base is None:
            return None
        p = rule.params
        min_req = int(p.get("min_requests", 10))
        worst = None
        if p.get("mode") == "error_ratio":
            max_ratio = float(p.get("max_ratio", 0.01))
            for key, req_now in cur["req"].items():
                req_base = base["req"].get(key, 0.0)
                dreq = req_now - req_base
                if dreq < min_req:
                    continue  # negative delta = counter reset: skip
                derr = cur["err"].get(key, 0.0) - \
                    base["err"].get(key, 0.0)
                if derr < 0:
                    continue
                ratio = derr / dreq
                if ratio > max_ratio and \
                        (worst is None or ratio > worst[0]):
                    route = ",".join(key) or "(all)"
                    worst = (ratio,
                             f"route {route} error ratio "
                             f"{ratio:.2%} > {max_ratio:.2%}")
            return worst
        # p99 mode
        max_p99 = float(p.get("max_p99_s", 0.5))
        buckets = cur.get("buckets") or ()
        if not buckets or base.get("buckets") != buckets:
            return None  # grid changed mid-window: not comparable
        for key, (counts, total) in cur["hist"].items():
            bcounts, btotal = base["hist"].get(key, ((), 0))
            dtotal = total - btotal
            if dtotal < min_req:
                continue
            if bcounts and len(bcounts) != len(counts):
                continue
            dcounts = [c - (bcounts[i] if bcounts else 0)
                       for i, c in enumerate(counts)]
            if any(c < 0 for c in dcounts):
                continue  # counter reset
            target = 0.99 * dtotal
            cum, p99 = 0, float("inf")
            for i, c in enumerate(dcounts):
                cum += c
                if cum >= target:
                    p99 = buckets[i]
                    break
            # cum never reaching target means >1% of observations sat
            # past the largest bucket: p99 stays +inf and breaches
            if p99 > max_p99 and (worst is None or p99 > worst[0]):
                route = ",".join(key) or "(all)"
                shown = "inf" if p99 == float("inf") else f"{p99:g}s"
                worst = (p99 if p99 != float("inf") else
                         (buckets[-1] * 10 if buckets else 1e9),
                         f"route {route} p99 ~{shown} > {max_p99:g}s")
        return worst

    def add_rule(self, rule: Rule) -> None:
        """Install one more rule at runtime: a drill registers run-scoped
        rules with windows short enough to breach and resolve inside
        it."""
        with self._lock:
            self.rules.append(rule)
            self._states[rule.name] = AlertState(rule)

    # --- views ------------------------------------------------------------
    def note_bundles(self, rule_name: str, bundles: list[dict]) -> None:
        """Attach flight-recorder capture results to the alert that
        triggered them (the capture fan-out runs on a background
        thread, after evaluate() returned)."""
        with self._lock:
            st = self._states.get(rule_name)
            if st is not None:
                st.bundles = list(bundles)

    def firing(self) -> list[dict]:
        with self._lock:
            return [st.to_dict() for st in self._states.values()
                    if st.state == "firing"]

    def to_dict(self) -> dict:
        with self._lock:
            return self._to_dict_locked()

    def _to_dict_locked(self) -> dict:
        order = {"firing": 0, "pending": 1, "resolved": 2, "inactive": 3}
        alerts = sorted(
            (st.to_dict() for st in self._states.values()),
            key=lambda a: (order.get(a["state"], 9),
                           -_events.SEVERITY_RANK.get(a["severity"], 0),
                           a["name"]))
        return {"alerts": alerts,
                "firing": sum(1 for a in alerts
                              if a["state"] == "firing"),
                "rules": [r.to_dict() for r in self.rules],
                "evaluated_at": round(self.evaluated_at, 3),
                "evaluations": self.evaluations}
