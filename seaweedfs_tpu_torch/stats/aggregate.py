"""Cluster-wide telemetry aggregation: scrape, parse, merge, re-expose.

The port's copy of seaweedfs_tpu/stats/aggregate.py.  The master knows
every volume server from its heartbeats; each serves a Prometheus
exposition on ``/metrics`` and its scrub verdicts on
``/ec/scrub/status``.  ``ClusterAggregator`` scrapes them and serves:

  GET /cluster/metrics  one merged exposition: counters and gauges summed
                        per label set, histograms merged bucket by bucket,
                        plus per-peer up / stale / scrape-age gauges;
  GET /cluster/health   JSON: per-server health counters (HEALTH_FAMILIES)
                        and scrub verdicts, cluster totals, the stale
                        peers, and a rollup ``degraded`` flag.

An unreachable peer is marked stale, not dropped and never an error: its
last-scraped values keep serving (peer_up 0, a rising scrape age), so a
flapping server shows as staleness instead of dipping cluster counters.
A peer that leaves the registry drops out.  The endpoints scrape on
demand through a short TTL (``min_interval``); the master's
``-metricsAggregationSeconds`` loop forces a scrape on its cadence.

A peer's up -> down transition is journaled as a ``peer_stale`` event
(once per loss, not per scrape), and a scrape carries the calling
request's trace context onto its pool threads, so a sampled GET
/cluster/health shows its fan-out as ``rpc.client`` hops.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import re
import threading
import time
from typing import Callable, Optional

from ..observability import context as _trace_context
from ..observability import events as _events
from ..utils.httpd import http_bytes
from .metrics import Counter, Gauge, Histogram

_log = logging.getLogger(__name__)

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)\s*$')
# OpenMetrics exemplar suffix (` # {trace_id="..."} value [ts]`) on bucket
# lines: stripped before parsing, so a peer that sends exemplars still
# merges exactly
_EXEMPLAR_RE = re.compile(r'\s+#\s+\{[^}]*\}\s+\S+(\s+\S+)?\s*$')

# the families /cluster/health summarizes per peer; every key feeds the
# rollup `degraded` flag, so only families whose nonzero value means
# something went wrong belong here.  The reference's whole table, so the
# document has the same keys; a port server exposes only the integrity
# families, and the rest read 0
HEALTH_FAMILIES = {
    "worker_restarts": "SeaweedFS_ec_worker_restarts_total",
    "engine_fallbacks": "SeaweedFS_ec_engine_fallbacks_total",
    "degraded_binds": "SeaweedFS_server_degraded_binds_total",
    "corrupt_shards": "SeaweedFS_ec_corrupt_shards_total",
    "scrub_repairs": "SeaweedFS_ec_scrub_repairs_total",
    # master-resident: the coordinator's totals come from local_fn
    "ec_under_replicated": "SeaweedFS_ec_under_replicated",
    "coordinator_repair_failures":
        "SeaweedFS_coordinator_repair_failures_total",
    "requests_shed": "SeaweedFS_requests_shed_total",
    "deadline_exceeded": "SeaweedFS_deadline_exceeded_total",
    "retry_budget_exhausted": "SeaweedFS_retry_budget_exhausted_total",
    "reqlog_records_dropped": "SeaweedFS_reqlog_records_dropped_total",
    "dataplane_conn_aborts": "SeaweedFS_dataplane_conn_aborts_total",
    "loop_lag": "SeaweedFS_dataplane_loop_stalls_total",
    "autoscale_failures": "SeaweedFS_autoscale_failures_total",
}

# keys whose truth lives on the MASTER: the per-peer rollup reports 0 and
# the totals come only from local_fn (summing peer scrapes would count
# them twice where servers share a process registry)
MASTER_LOCAL_HEALTH_KEYS = ("ec_under_replicated",
                            "coordinator_repair_failures",
                            "autoscale_failures")

_INF = ("+Inf", "Inf", "inf")


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_labels(raw: Optional[str]) -> dict[str, str]:
    if not raw:
        return {}
    return {k: _unescape(v) for k, v in _LABEL_RE.findall(raw)}


def parse_prometheus_text(text: str) -> dict[str, object]:
    """Exposition text -> {family name: Counter|Gauge|Histogram}
    (unregistered collectors, ready for merge()).  Histogram _bucket
    series are de-cumulated back into per-bucket counts so the merge is
    exact.  Untyped samples are gauges."""
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    # family -> [(labels, suffix, value)]
    raw: dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                (types if parts[1] == "TYPE" else helps)[parts[2]] = \
                    parts[3] if len(parts) > 3 else ""
            continue
        mo = _SAMPLE_RE.match(line) or \
            _SAMPLE_RE.match(_EXEMPLAR_RE.sub("", line))
        if not mo:
            continue
        name, _, raw_labels, raw_value = mo.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        base, suffix = name, ""
        for suf in ("_bucket", "_sum", "_count"):
            cand = name[:-len(suf)]
            if name.endswith(suf) and types.get(cand) == "histogram":
                base, suffix = cand, suf
                break
        raw.setdefault(base, []).append(
            (_parse_labels(raw_labels), suffix, value))

    out: dict[str, object] = {}
    for name, samples in raw.items():
        kind = types.get(name, "gauge")
        help_ = helps.get(name, "")
        if kind == "histogram":
            out[name] = _build_histogram(name, help_, samples)
            continue
        cls = Counter if kind == "counter" else Gauge
        label_names = next((tuple(labels) for labels, _s, _v in samples
                            if labels), ())
        coll = cls(name, help_, labels=label_names)
        for labels, _suf, v in samples:
            key = tuple(labels.get(ln, "") for ln in label_names)
            coll._values[key] = coll._values.get(key, 0.0) + v
        out[name] = coll
    return out


def _build_histogram(name: str, help_: str, samples: list) -> Histogram:
    label_names: tuple = ()
    les: set[float] = set()
    for labels, suffix, _v in samples:
        if suffix == "_bucket" and labels.get("le", "+Inf") not in _INF:
            les.add(float(labels["le"]))
        names = tuple(k for k in labels if k != "le")
        if names and not label_names:
            label_names = names
    # an empty grid is legal: every observation past the largest bucket
    # lives in _sum/_count (+Inf)
    hist = Histogram(name, help_, labels=label_names,
                     buckets=tuple(sorted(les)))
    # cumulative bucket values per label key, by le
    cum: dict[tuple, dict[float, float]] = {}
    for labels, suffix, v in samples:
        key = tuple(labels.get(ln, "") for ln in label_names)
        if suffix == "_bucket":
            le = labels.get("le", "+Inf")
            if le in _INF:
                continue  # _count carries the +Inf total
            cum.setdefault(key, {})[float(le)] = v
        elif suffix == "_sum":
            hist._sums[key] = hist._sums.get(key, 0.0) + v
        elif suffix == "_count":
            hist._totals[key] = hist._totals.get(key, 0) + int(v)
    for key, by_le in cum.items():
        counts = [0] * len(hist.buckets)
        prev = 0.0
        for i, b in enumerate(hist.buckets):
            c = by_le.get(b, prev)
            counts[i] = max(0, int(c - prev))
            prev = c
        hist._counts[key] = counts
        hist._sums.setdefault(key, 0.0)
        hist._totals.setdefault(key, 0)
    for key in hist._totals:
        hist._counts.setdefault(key, [0] * len(hist.buckets))
        hist._sums.setdefault(key, 0.0)
    return hist


def _clone(coll, name: str):
    """An empty collector like ``coll`` under ``name``, ``coll`` merged in:
    later merges never mutate a peer's cached families."""
    extra = {"buckets": coll.buckets} if isinstance(coll, Histogram) else {}
    clone = type(coll)(name, coll.help, labels=coll.label_names, **extra)
    clone.merge(coll)
    return clone


def merge_families(into: dict[str, object],
                   src: dict[str, object]) -> dict[str, object]:
    """Merge one peer's parsed families into the accumulator.  Same-name
    families combine through their collector's merge(); a histogram whose
    bucket grid disagrees (mixed versions mid-upgrade) is kept under
    ``<name>_mismatch`` rather than corrupting the merged series."""
    for name, coll in src.items():
        mine = into.get(name)
        if mine is None:
            into[name] = _clone(coll, name)
            continue
        try:
            mine.merge(coll)
        except (ValueError, AttributeError):
            alt = name + "_mismatch"
            if alt not in into:
                into[alt] = _clone(coll, alt)
    return into


class _PeerState:
    __slots__ = ("families", "scraped_at", "up", "error", "scrub")

    def __init__(self):
        self.families: Optional[dict] = None
        self.scraped_at = 0.0
        self.up = False
        self.error = ""
        # the last /ec/scrub/status document (None: never fetched, or the
        # peer has no scrubber)
        self.scrub: Optional[dict] = None


class ClusterAggregator:
    """Scrape-and-merge over a dynamic peer list (the master's registered
    volume servers).  Reached concurrently: the periodic scrape loop and
    the /cluster/* request threads."""

    def __init__(self, peers_fn: Callable[[], list[str]],
                 fetch: Optional[Callable[[str], str]] = None,
                 scrub_fetch: Optional[Callable[[str],
                                               Optional[dict]]] = None,
                 min_interval: float = 2.0, stale_after: float = 30.0,
                 timeout: float = 2.0,
                 local_fn: Optional[Callable[[], dict]] = None):
        """``local_fn`` adds master-local totals to health() (its keys must
        be totals keys): the coordinator's under-replication gauge and
        repair failures, which no scraped peer carries."""
        self.peers_fn = peers_fn
        self.local_fn = local_fn
        self.min_interval = min_interval
        self.stale_after = stale_after
        self.timeout = timeout
        self._fetch = fetch or self._http_fetch
        if scrub_fetch is not None:
            self._scrub_fetch = scrub_fetch
        elif fetch is not None:
            # a custom metrics fetch (tests) gets no implicit HTTP side
            # channel for scrub state
            self._scrub_fetch = lambda url: None
        else:
            self._scrub_fetch = self._http_scrub_fetch
        self._peers: dict[str, _PeerState] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._last_scrape = 0.0  # guarded-by: _lock
        self._last_scrub_scrape = 0.0  # guarded-by: _lock

    def _http_fetch(self, url: str) -> str:
        status, body, _ = http_bytes("GET", f"http://{url}/metrics",
                                     timeout=self.timeout)
        if status != 200:
            raise ConnectionError(
                f"scrape {url}: status {status}: "
                f"{body[:120].decode(errors='replace')}")
        return body.decode(errors="replace")

    def _http_scrub_fetch(self, url: str) -> Optional[dict]:
        """A server's scrub verdicts, best-effort: a peer without the
        scrub routes (or mid-restart) reports no scrub state."""
        status, body, _ = http_bytes("GET", f"http://{url}/ec/scrub/status",
                                     timeout=self.timeout)
        if status != 200:
            return None
        try:
            return json.loads(body)
        except ValueError:
            return None

    # --- scraping ---------------------------------------------------------
    def scrape(self, force: bool = False,
               include_scrub: bool = False) -> None:
        """Scrape every registered peer in parallel, at most once per
        ``min_interval`` unless forced, so the on-demand endpoints cannot
        be turned into a scrape amplifier.  ``include_scrub`` adds each
        peer's /ec/scrub/status: only health() reads it."""
        now = time.time()
        with self._lock:
            # a scrub-inclusive call is not swallowed by the TTL of a
            # plain metrics scrape that just ran without scrub state
            fresh = now - self._last_scrape < self.min_interval
            scrub_fresh = now - self._last_scrub_scrape < self.min_interval
            if not force and fresh and (scrub_fresh or not include_scrub):
                return
            self._last_scrape = now
            if include_scrub:
                self._last_scrub_scrape = now
        urls = list(dict.fromkeys(self.peers_fn()))
        with self._lock:
            # peers gone from the registry drop out of the merge: they
            # left, they are not stale
            for gone in set(self._peers) - set(urls):
                del self._peers[gone]
        if not urls:
            return
        # the pool's requests nest under the caller's open span
        ctx = _trace_context.fork_for_thread()

        def one(url: str):
            with _trace_context.scope(ctx):
                try:
                    fams = parse_prometheus_text(self._fetch(url))
                except Exception as e:  # noqa: BLE001 - marked down
                    return url, None, f"{type(e).__name__}: {e}"[:200], None
                scrub = None
                if include_scrub:
                    try:
                        scrub = self._scrub_fetch(url)
                    except Exception:  # noqa: BLE001 - optional state
                        scrub = None
                return url, fams, "", scrub

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(urls)),
                thread_name_prefix="metrics-scrape") as pool:
            results = list(pool.map(one, urls))
        lost: list[tuple[str, str]] = []
        with self._lock:
            for url, families, err, scrub in results:
                st = self._peers.setdefault(url, _PeerState())
                if families is not None:
                    st.families = families
                    st.scraped_at = time.time()
                    st.up, st.error = True, ""
                    if scrub is not None:
                        st.scrub = scrub
                else:
                    # keep the last good families: the merge serves them
                    # marked stale instead of dipping cluster counters
                    if st.up:
                        lost.append((url, err))
                    st.up, st.error = False, err
        for url, err in lost:
            _events.emit("peer_stale", peer=url, error=err)

    # --- views ------------------------------------------------------------
    def _snapshot(self) -> dict[str, _PeerState]:
        with self._lock:
            return dict(self._peers)

    def peer_status(self) -> dict[str, dict]:
        now = time.time()
        out = {}
        for url, st in sorted(self._snapshot().items()):
            age = now - st.scraped_at if st.scraped_at else None
            out[url] = {
                "up": st.up,
                "stale": (not st.up) or (age is not None
                                         and age > self.stale_after),
                "age_s": round(age, 1) if age is not None else None,
                "error": st.error,
                "has_data": st.families is not None,
            }
        return out

    def merged(self) -> dict[str, object]:
        merged: dict[str, object] = {}
        for _url, st in sorted(self._snapshot().items()):
            if st.families is not None:
                merge_families(merged, st.families)
        return merged

    def expose(self) -> str:
        """The /cluster/metrics body: the merged families plus per-peer
        up / stale / scrape-age gauges."""
        status = self.peer_status()
        up = Gauge("SeaweedFS_cluster_peer_up",
                   "1 if the peer's last /metrics scrape succeeded.",
                   labels=("peer",))
        stale = Gauge("SeaweedFS_cluster_peer_stale",
                      "1 if the peer's merged series come from a stale "
                      "scrape (peer unreachable; last-good values "
                      "served).", labels=("peer",))
        age = Gauge("SeaweedFS_cluster_peer_scrape_age_seconds",
                    "Seconds since the peer's last successful scrape.",
                    labels=("peer",))
        for url, st in status.items():
            up.set(url, 1.0 if st["up"] else 0.0)
            stale.set(url, 1.0 if st["stale"] else 0.0)
            if st["age_s"] is not None:
                age.set(url, st["age_s"])
        lines: list[str] = []
        for g in (up, stale, age):
            lines.extend(g.expose())
        merged = self.merged()
        for name in sorted(merged):
            lines.extend(merged[name].expose())
        return "\n".join(lines) + "\n"

    def health(self) -> dict:
        """The /cluster/health body: per-peer health counters and scrub
        verdict rollup, plus totals.  A volume whose scrub verdict is
        `unrepairable` anywhere marks the rollup degraded, even while
        every counter reads clean."""
        status = self.peer_status()
        peers: dict[str, dict] = {}
        totals = {k: 0 for k in HEALTH_FAMILIES}
        totals["scrub_unrepairable"] = 0
        for url, st in self._snapshot().items():
            entry = dict(status[url])
            ph = {}
            for key, family in HEALTH_FAMILIES.items():
                if key in MASTER_LOCAL_HEALTH_KEYS:
                    ph[key] = 0
                    continue
                coll = (st.families or {}).get(family)
                v = int(sum(coll.snapshot().values())) if coll is not None \
                    else 0
                ph[key] = v
                totals[key] += v
            entry["pipeline_health"] = ph
            if st.scrub is not None:
                verdict_counts: dict[str, int] = {}
                for _vid, d in (st.scrub.get("verdicts") or {}).items():
                    verdict = (d or {}).get("status") or "?"
                    verdict_counts[verdict] = \
                        verdict_counts.get(verdict, 0) + 1
                entry["scrub"] = {
                    "running": bool(st.scrub.get("running")),
                    "passes": int(st.scrub.get("passes") or 0),
                    "verdicts": verdict_counts,
                }
                totals["scrub_unrepairable"] += \
                    verdict_counts.get("unrepairable", 0)
            peers[url] = entry
        if self.local_fn is not None:
            try:
                extra = self.local_fn() or {}
            except Exception:  # noqa: BLE001 - health still answers
                _log.exception("local health contribution failed")
                extra = {}
            for key, val in extra.items():
                if key in totals:
                    totals[key] += int(val)
        stale = sorted(u for u, s in status.items() if s["stale"])
        return {"peers": peers, "totals": totals,
                "stale_peers": stale,
                "degraded": any(v for v in totals.values()),
                "peer_count": len(peers)}
