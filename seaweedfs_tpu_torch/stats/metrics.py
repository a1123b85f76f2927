"""Prometheus-format metrics: counters, gauges, histograms and exposition.

The port's copy of seaweedfs_tpu/stats/metrics.py (weed/stats/
metrics.go): ``Counter``, ``Gauge`` and ``Histogram`` (each with the
``merge`` the master's cluster aggregator folds peers with), the
``Registry`` and its text exposition (``text/plain; version=0.0.4``, the
wire contract any Prometheus scraper reads), the process-wide
``REGISTRY`` that a volume server's ``GET /metrics`` exposes, and these
families under the reference's names:

  - ``VolumeServerMetrics``: requests by route (count, latency, 5xx),
    the volume / EC-shard / disk-size gauges and the native data plane's
    per-volume state (``SeaweedFS_volumeServer_native_plane{volume,
    stat}``: size_bytes, live_files, deleted_bytes, fsync_passes);
  - ``ECIntegrityMetrics``: scrub blocks by verdict, corrupt shards by
    where they were caught, the scrubber's repairs by outcome (the keys
    of ``totals()`` are what ``/status`` and the scrub routes carry);
  - ``CoordinatorMetrics``: the master's repairs, moves, cycles, the
    under-replication gauge and the repair queue depth;
  - ``MasterMetrics``: the master's requests by route (count, latency,
    5xx), what its own ``GET /metrics`` adds;
  - ``RequestPlaneMetrics``: requests shed by admission control and
    answered 504 for a spent deadline (by ``role``), and retries a
    drained retry budget denied (by ``kind``);
  - ``DataplaneMetrics``: the event-loop reactor's connections, workers,
    pool and inline dispatches, loop lag and stalls, queue depth and
    aborted connections (utils/eventloop.py);
  - ``NeedleCacheMetrics``: the needle cache's hits, misses, admissions,
    rejections, evictions, invalidations and resident bytes
    (volume_server/needle_cache.py);
  - ``DegradedBindMetrics``: servers that came up without their
    framed-TCP plane, by ``role`` (the reference keeps this family in its
    ``ECPipelineMetrics``);
  - ``HeatMetrics``: the master's merged heat per volume and its
    imbalance by scope (server, rack), and the volume servers' lost heat
    snapshots (observability/heat.py);
  - ``LedgerMetrics``: the resource ledger's decayed CPU, queue-wait and
    byte rates by route class, refreshed at each shipment, and its lost
    snapshots (observability/ledger.py).

A histogram keeps the last OpenMetrics exemplar of each label set (a
sampled request's trace id on its latency bucket); the exposition shows
them only when asked, ``expose(exemplars=True)``, which a server's
``GET /metrics?exemplars=1`` does (``exemplars_requested``).

Not ported: the push gateway loop, and the families the port cannot have
or has not ported: the rest of ``ECPipelineMetrics`` (parity-worker
restarts and CPU fallbacks), the master's heartbeat family, and the
filer's and the S3 gateway's (their servers wait for the filer).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Optional

DEFAULT_BUCKETS = (0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03,
                   0.1, 0.3, 1.0, 3.0, 10.0)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping (backslash, quote, newline)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(label_names: tuple, label_values: tuple) -> str:
    if not label_names:
        return ""
    pairs = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in zip(label_names, label_values))
    return "{" + pairs + "}"


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Counter:
    def __init__(self, name: str, help_: str = "", labels: tuple = ()):
        self.name, self.help = name, help_
        self.label_names = tuple(labels)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, *label_values, amount: float = 1.0) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def labels(self, *label_values) -> None:
        """Pre-touch a label set: it is exposed at 0 before the first
        ``inc``."""
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values.setdefault(key, 0.0)

    def value(self, *label_values) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def snapshot(self) -> dict[tuple, float]:
        """Point-in-time copy, safe against concurrent inc()."""
        with self._lock:
            return dict(self._values)

    def merge(self, other: "Counter") -> None:
        """Fold another counter's samples in (per-label-set sum)."""
        for key, v in other.snapshot().items():
            with self._lock:
                self._values[key] = self._values.get(key, 0.0) + v

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        for lv, v in sorted(self.snapshot().items()):
            out.append(f"{self.name}{_fmt_labels(self.label_names, lv)} "
                       f"{_num(v)}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str = "", labels: tuple = ()):
        self.name, self.help = name, help_
        self.label_names = tuple(labels)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, *label_values_then_value) -> None:
        *label_values, value = label_values_then_value
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = float(value)

    def add(self, *label_values_then_delta) -> None:
        *label_values, delta = label_values_then_delta
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(delta)

    def value(self, *label_values) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def snapshot(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)

    def merge(self, other: "Gauge") -> None:
        """Per-label-set SUM: cluster gauges (volume counts, disk bytes)
        add up across peers."""
        for key, v in other.snapshot().items():
            with self._lock:
                self._values[key] = self._values.get(key, 0.0) + v

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for lv, v in sorted(self.snapshot().items()):
            out.append(f"{self.name}{_fmt_labels(self.label_names, lv)} "
                       f"{_num(v)}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "", labels: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.label_names = tuple(labels)
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        # the last exemplar of each label set: (bucket index, None for
        # +Inf; the observed value; the trace id; unix seconds)
        self._exemplars: dict[tuple, tuple[Optional[int], float, str,
                                           float]] = {}
        self._lock = threading.Lock()

    def observe(self, *label_values_then_obs,
                exemplar: Optional[str] = None) -> None:
        """``exemplar``: the trace id of a sampled request, kept as its
        label set's last exemplar on the bucket the value lands in."""
        *label_values, obs = label_values_then_obs
        key = tuple(str(v) for v in label_values)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            # the smallest bucket whose le >= obs owns the observation; the
            # cumulative form is computed at exposition time
            i = bisect_left(self.buckets, obs)
            if i < len(self.buckets):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + obs
            self._totals[key] = self._totals.get(key, 0) + 1
            if exemplar:
                self._exemplars[key] = (
                    i if i < len(self.buckets) else None,
                    obs, exemplar, time.time())

    def labels(self, *label_values) -> None:
        """Pre-touch a label set: every bucket, _sum and _count are exposed
        at 0 before the first ``observe``."""
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._counts.setdefault(key, [0] * len(self.buckets))
            self._sums.setdefault(key, 0.0)
            self._totals.setdefault(key, 0)

    def snapshot(self) -> dict[tuple, tuple[list[int], float, int]]:
        """Per-label-set (bucket counts, sum, count) copy."""
        with self._lock:
            return {key: (list(self._counts[key]),
                          self._sums.get(key, 0.0),
                          self._totals.get(key, 0))
                    for key in self._counts}

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in: per-label-set bucket sums plus _sum
        and _count sums, exactly as if one had observed both streams.
        Bucket grids must be equal; mismatched grids would misbin, so they
        raise instead."""
        if tuple(other.buckets) != self.buckets:
            raise ValueError(
                f"bucket mismatch: {other.buckets} vs {self.buckets}")
        for key, (counts, s, total) in other.snapshot().items():
            with self._lock:
                mine = self._counts.setdefault(key,
                                               [0] * len(self.buckets))
                for i, c in enumerate(counts):
                    mine[i] += c
                self._sums[key] = self._sums.get(key, 0.0) + s
                self._totals[key] = self._totals.get(key, 0) + total

    def expose(self, exemplars: bool = False) -> list[str]:
        """``exemplars=True`` appends each label set's exemplar to the
        bucket line it landed on.  Off by default: exemplar syntax is not
        legal in the text format 0.0.4 the exposition is served as, and a
        strict parser would reject the whole scrape."""
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            kept = dict(self._exemplars) if exemplars else {}
        for lv, (counts, total_sum, total) in sorted(self.snapshot().items()):
            ex = kept.get(lv)
            cumulative = 0
            for i, bound in enumerate(self.buckets):
                cumulative += counts[i]
                labels = dict(zip(self.label_names, lv))
                labels["le"] = _num(bound)
                pairs = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                                 for k, v in labels.items())
                line = f"{self.name}_bucket{{{pairs}}} {cumulative}"
                if ex is not None and ex[0] == i:
                    line += _fmt_exemplar(ex)
                out.append(line)
            labels = dict(zip(self.label_names, lv))
            labels["le"] = "+Inf"
            pairs = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                             for k, v in labels.items())
            line = f"{self.name}_bucket{{{pairs}}} {total}"
            if ex is not None and ex[0] is None:
                line += _fmt_exemplar(ex)
            out.append(line)
            plain = _fmt_labels(self.label_names, lv)
            out.append(f"{self.name}_sum{plain} {_num(total_sum)}")
            out.append(f"{self.name}_count{plain} {total}")
        return out


def _fmt_exemplar(ex: tuple) -> str:
    """The OpenMetrics exemplar suffix of a bucket line:
    `` # {trace_id="..."} value ts``."""
    _i, value, trace_id, ts = ex
    return (f' # {{trace_id="{_escape_label_value(trace_id)}"}} '
            f"{_num(value)} {_num(round(ts, 3))}")


class Registry:
    def __init__(self):
        self._collectors: list = []
        self._lock = threading.Lock()

    def register(self, collector):
        with self._lock:
            self._collectors.append(collector)
        return collector

    def counter(self, name, help_="", labels=()):
        return self.register(Counter(name, help_, labels))

    def gauge(self, name, help_="", labels=()):
        return self.register(Gauge(name, help_, labels))

    def histogram(self, name, help_="", labels=(), buckets=DEFAULT_BUCKETS):
        return self.register(Histogram(name, help_, labels, buckets))

    def expose(self, exemplars: bool = False) -> str:
        with self._lock:
            collectors = list(self._collectors)
        lines: list[str] = []
        for c in collectors:
            if exemplars and isinstance(c, Histogram):
                lines.extend(c.expose(exemplars=True))
            else:
                lines.extend(c.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def exemplars_requested(req) -> bool:
    """Does this /metrics request ask for exemplars?  Only an explicit
    ``?exemplars=1``: an OpenMetrics Accept header is not enough, since
    the body stays text/plain 0.0.4 without the OpenMetrics framing."""
    try:
        return req.query.get("exemplars", "").lower() in ("1", "true",
                                                          "yes", "on")
    except Exception:  # noqa: BLE001 - a malformed query asks for none
        return False


class _ServerMetrics:
    """A server role's request bundle, namespaced SeaweedFS_<subsystem>_*:
    requests by route, their latency, and those answered 5xx."""

    def __init__(self, subsystem: str, registry: Registry):
        ns = f"SeaweedFS_{subsystem}"
        self.request_counter = registry.counter(
            f"{ns}_request_total", f"Counter of {subsystem} requests.",
            labels=("type",))
        self.request_histogram = registry.histogram(
            f"{ns}_request_seconds", f"Bucketed {subsystem} request latency.",
            labels=("type",))
        self.request_errors = registry.counter(
            f"{ns}_request_errors_total",
            f"Counter of {subsystem} requests answered 5xx.",
            labels=("type",))


class MasterMetrics(_ServerMetrics):
    """The master's request bundle and its raft leader gauge (the
    reference's heartbeat family is not ported)."""

    def __init__(self, registry: Registry = REGISTRY):
        super().__init__("master", registry)
        self.leader_gauge = registry.gauge(
            "SeaweedFS_master_is_leader", "1 if this master is raft leader.")


class VolumeServerMetrics(_ServerMetrics):
    """The volume server's bundle, namespaced SeaweedFS_volumeServer_*."""

    def __init__(self, registry: Registry = REGISTRY):
        super().__init__("volumeServer", registry)
        self.volume_counter = registry.gauge(
            "SeaweedFS_volumeServer_volumes",
            "Number of volumes or EC shards.",
            labels=("collection", "type"))
        self.max_volume_counter = registry.gauge(
            "SeaweedFS_volumeServer_max_volumes", "Maximum volume count.")
        self.disk_size_gauge = registry.gauge(
            "SeaweedFS_volumeServer_total_disk_size",
            "Actual disk size used by volumes.",
            labels=("collection", "type"))
        self.native_plane_gauge = registry.gauge(
            "SeaweedFS_volumeServer_native_plane",
            "Native C++ data plane per-volume state.",
            labels=("volume", "stat"))


def _total(c: Counter) -> int:
    return int(sum(c.snapshot().values()))


class ECIntegrityMetrics:
    """Shard bit-rot counters: blocks the scrubber verified (by verdict),
    corrupt shards detected (by where: scrub, rebuild, read, wire) and the
    scrubber's quarantine-and-rebuild outcomes.  The master's
    /cluster/health reads the last two from every server's /metrics."""

    def __init__(self, registry: Registry = REGISTRY):
        self.scrub_blocks = registry.counter(
            "SeaweedFS_ec_scrub_blocks_total",
            "EC shard blocks verified against .eci sidecars.",
            labels=("verdict",))
        self.corrupt_shards = registry.counter(
            "SeaweedFS_ec_corrupt_shards_total",
            "Corrupt EC shards detected (sidecar block crc mismatch).",
            labels=("source",))
        self.repairs = registry.counter(
            "SeaweedFS_ec_scrub_repairs_total",
            "Corrupt EC shards quarantined and rebuilt by the scrubber.",
            labels=("outcome",))

    def totals(self) -> dict[str, int]:
        return {"scrub_blocks": _total(self.scrub_blocks),
                "corrupt_shards": _total(self.corrupt_shards),
                "scrub_repairs": _total(self.repairs)}


class CoordinatorMetrics:
    """The master's EC repair coordinator (ops/coordinator.py).
    ``under_replicated`` (volumes below k+1 clean shards) and
    ``repair_failures`` only the master can count; they reach
    /cluster/health through the aggregator's ``local_fn``."""

    def __init__(self, registry: Registry = REGISTRY):
        self.repairs = registry.counter(
            "SeaweedFS_coordinator_repairs_total",
            "EC volume repairs the coordinator executed.",
            labels=("outcome",))
        self.repair_failures = registry.counter(
            "SeaweedFS_coordinator_repair_failures_total",
            "Coordinator repair attempts that failed (by error type).",
            labels=("reason",))
        self.moves = registry.counter(
            "SeaweedFS_coordinator_moves_total",
            "EC shard moves the coordinator executed "
            "(dedupe/rack/skew/spread).",
            labels=("reason",))
        self.cycles = registry.counter(
            "SeaweedFS_coordinator_cycles_total",
            "Coordinator planning cycles.", labels=("outcome",))
        self.under_replicated = registry.gauge(
            "SeaweedFS_ec_under_replicated",
            "EC volumes below k+1 clean reachable shards.")
        self.queue_depth = registry.gauge(
            "SeaweedFS_coordinator_queue_depth",
            "EC volumes queued for repair.")


class RequestPlaneMetrics:
    """The graceful-degradation counters: requests admission control
    answered 503 without running the handler (``shed``), requests answered
    504 because their X-Weed-Deadline was spent (``deadline_exceeded``),
    both by server role, and retries a drained per-destination budget
    denied (``retry_budget_exhausted``, by subsystem).  The master's
    /cluster/health reads all three from every server's /metrics."""

    def __init__(self, registry: Registry = REGISTRY):
        self.shed = registry.counter(
            "SeaweedFS_requests_shed_total",
            "Requests shed by admission control (answered 503 early).",
            labels=("role",))
        self.deadline_exceeded = registry.counter(
            "SeaweedFS_deadline_exceeded_total",
            "Requests answered 504 because the propagated "
            "X-Weed-Deadline budget was exhausted.",
            labels=("role",))
        self.retry_budget_exhausted = registry.counter(
            "SeaweedFS_retry_budget_exhausted_total",
            "Retries denied by a drained per-destination retry budget.",
            labels=("kind",))


class DataplaneMetrics:
    """The event-loop serving front (utils/eventloop.py): connection and
    dispatch accounting for the process's reactor.  ``conn_aborts`` counts
    connections the loop tore down with work in flight (slow_client: the
    outbox overflowed; overflow: unframed input flood; stop: a bounded
    stop's teardown; loop_error) and feeds the ``dataplane_conn_aborts``
    health key."""

    def __init__(self, registry: Registry = REGISTRY):
        self.conn_aborts = registry.counter(
            "SeaweedFS_dataplane_conn_aborts_total",
            "Connections the reactor aborted with work in flight.",
            labels=("reason",))
        self.connections = registry.gauge(
            "SeaweedFS_dataplane_connections",
            "Connections currently owned by the reactor loop.")
        self.workers = registry.gauge(
            "SeaweedFS_dataplane_workers",
            "Dispatch worker pool size (-dataplane.workers).")
        self.pool_dispatches = registry.counter(
            "SeaweedFS_dataplane_pool_dispatches_total",
            "Requests dispatched onto the worker pool.")
        self.fast_dispatches = registry.counter(
            "SeaweedFS_dataplane_fast_dispatches_total",
            "Cache-probed reads dispatched inline on the loop.")
        # how long each loop iteration held every connection, and the
        # stall counter behind the loop_lag health key
        self.loop_lag = registry.histogram(
            "SeaweedFS_dataplane_loop_lag_seconds",
            "Reactor loop iteration busy time (every connection waits "
            "this long).",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5))
        self.loop_stalls = registry.counter(
            "SeaweedFS_dataplane_loop_stalls_total",
            "Loop-blocked moments past the stall threshold (the "
            "loop_lag health key).")
        self.queue_depth = registry.gauge(
            "SeaweedFS_dataplane_queue_depth",
            "Dispatch queue depth per lane (watchdog-sampled).",
            labels=("lane",))
        self.workers_busy = registry.gauge(
            "SeaweedFS_dataplane_workers_busy",
            "Dispatch workers currently running handlers "
            "(watchdog-sampled).")

    def totals(self) -> dict[str, int]:
        return {"dataplane_conn_aborts": _total(self.conn_aborts),
                "pool_dispatches": _total(self.pool_dispatches),
                "fast_dispatches": _total(self.fast_dispatches),
                "loop_stalls": _total(self.loop_stalls)}


class NeedleCacheMetrics:
    """The needle cache (volume_server/needle_cache.py): admission,
    eviction and invalidation accounting and the resident-bytes gauge."""

    def __init__(self, registry: Registry = REGISTRY):
        self.hits = registry.counter(
            "SeaweedFS_needle_cache_hits_total",
            "Needle reads served from the popularity cache.")
        self.misses = registry.counter(
            "SeaweedFS_needle_cache_misses_total",
            "Needle reads that went to the store.")
        self.admissions = registry.counter(
            "SeaweedFS_needle_cache_admissions_total",
            "Needles admitted after clearing the frequency bar.")
        self.rejections = registry.counter(
            "SeaweedFS_needle_cache_rejections_total",
            "Needle offers rejected by the admission policy.")
        self.evictions = registry.counter(
            "SeaweedFS_needle_cache_evictions_total",
            "Needles evicted to honor the byte bound.")
        self.invalidations = registry.counter(
            "SeaweedFS_needle_cache_invalidations_total",
            "Cache entries dropped by write/delete/vacuum.",
            labels=("reason",))
        self.bytes = registry.gauge(
            "SeaweedFS_needle_cache_bytes",
            "Resident cached needle bytes.")
        self.volume_hits = registry.counter(
            "SeaweedFS_needle_cache_volume_hits_total",
            "Needle cache hits per volume.", labels=("volume",))
        self.volume_misses = registry.counter(
            "SeaweedFS_needle_cache_volume_misses_total",
            "Needle cache misses per volume.", labels=("volume",))

    def hit_ratio(self) -> float:
        hits, misses = _total(self.hits), _total(self.misses)
        total = hits + misses
        return round(hits / total, 4) if total else 0.0

    def totals(self) -> dict:
        return {"hits": _total(self.hits), "misses": _total(self.misses),
                "admissions": _total(self.admissions),
                "evictions": _total(self.evictions),
                "invalidations": _total(self.invalidations),
                "bytes": int(self.bytes.value()),
                "hit_ratio": self.hit_ratio()}


class DegradedBindMetrics:
    """Servers whose framed-TCP plane failed to bind (the HTTP plane still
    serves): ``role`` is volume-tcp or master-tcp.  Feeds the
    ``degraded_binds`` health key."""

    def __init__(self, registry: Registry = REGISTRY):
        self.degraded_binds = registry.counter(
            "SeaweedFS_server_degraded_binds_total",
            "Servers that came up without their framed-TCP plane "
            "(bind failed; HTTP still serves).",
            labels=("role",))

    def totals(self) -> dict[str, int]:
        return {"degraded_binds": _total(self.degraded_binds)}


class HeatMetrics:
    """Heat (observability/heat.py).  The two gauges are the master's,
    set at each heat ingest; the counter is a volume server's shipper
    loss."""

    def __init__(self, registry: Registry = REGISTRY):
        self.volume_heat = registry.gauge(
            "SeaweedFS_volume_heat",
            "Merged decayed read+cache-hit heat per volume (1/s).",
            labels=("volume",))
        self.imbalance = registry.gauge(
            "SeaweedFS_heat_imbalance_ratio",
            "max/mean heat ratio across a scope (server, rack).",
            labels=("scope",))
        self.snapshots_dropped = registry.counter(
            "SeaweedFS_heat_snapshots_dropped_total",
            "Heat snapshots lost by the shipper (master unreachable "
            "or buffer superseded).")


class LedgerMetrics:
    """The resource ledger (observability/ledger.py).  The gauges by
    route are refreshed by the LedgerShipper at each shipment, never on
    the request path; the counter is shipper loss."""

    def __init__(self, registry: Registry = REGISTRY):
        self.route_cpu = registry.gauge(
            "SeaweedFS_ledger_route_cpu_rate",
            "Decayed thread-CPU seconds/second per route class.",
            labels=("route",))
        self.route_qwait = registry.gauge(
            "SeaweedFS_ledger_route_queue_wait_rate",
            "Decayed dispatch-queue-wait seconds/second per route "
            "class.",
            labels=("route",))
        self.route_bytes = registry.gauge(
            "SeaweedFS_ledger_route_bytes_rate",
            "Decayed bytes/second per route class and direction.",
            labels=("route", "dir"))
        self.snapshots_dropped = registry.counter(
            "SeaweedFS_ledger_snapshots_dropped_total",
            "Ledger snapshots lost by the shipper (master unreachable "
            "or buffer superseded).")


_singletons: dict[str, object] = {}
_singleton_lock = threading.Lock()


def _singleton(name: str, cls):
    with _singleton_lock:
        if name not in _singletons:
            _singletons[name] = cls()
        return _singletons[name]


def volume_server_metrics() -> VolumeServerMetrics:
    return _singleton("volume", VolumeServerMetrics)


def ec_integrity_metrics() -> ECIntegrityMetrics:
    return _singleton("ec_integrity", ECIntegrityMetrics)


def coordinator_metrics() -> CoordinatorMetrics:
    return _singleton("coordinator", CoordinatorMetrics)


def master_metrics() -> MasterMetrics:
    return _singleton("master", MasterMetrics)


def request_plane_metrics() -> RequestPlaneMetrics:
    return _singleton("request_plane", RequestPlaneMetrics)


def dataplane_metrics() -> DataplaneMetrics:
    return _singleton("dataplane", DataplaneMetrics)


def needle_cache_metrics() -> NeedleCacheMetrics:
    return _singleton("needle_cache", NeedleCacheMetrics)


def degraded_bind_metrics() -> DegradedBindMetrics:
    return _singleton("degraded_binds", DegradedBindMetrics)


def heat_metrics() -> HeatMetrics:
    return _singleton("heat", HeatMetrics)


def ledger_metrics() -> LedgerMetrics:
    return _singleton("ledger", LedgerMetrics)
