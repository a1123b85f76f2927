"""Master server: assign, lookup, growth, heartbeat ingest, admin lock.

The port's copy of the single-master core of seaweedfs_tpu/master/
server.py (weed/server/master_server*.go + master_grpc_server*.go):

  GET  /dir/assign      fid allocation (pick a writable volume, else grow)
  GET  /dir/lookup      vid -> locations (normal and EC volumes)
  GET  /dir/lookup_ec   vid -> shard id -> holders
  GET  /dir/status      topology dump
  GET  /cluster/status  this master's raft view: IsLeader, Leader, Peers,
                        Term, Role, commit / applied / log indexes,
                        snapshots installed and sent
  POST /raft/vote, /raft/append, /raft/snapshot
                        the peers' raft calls (master/consensus.py)
  POST /heartbeat       volume-server full sync, or a delta between syncs
  GET  /vol/grow        force growth;  GET /vol/status  volume inventory
  GET  /vol/vacuum      compact every volume past ?garbageThreshold=
  GET|POST /col/delete  drop a collection's volumes and EC shards
  POST|PUT /submit      assign + upload in one call
  GET|HEAD /<vid>,<fid> redirect to a holder
  POST /admin/lease, /admin/release   the shell's exclusive lock
                        (master_grpc_server_admin.go:73-150)
  GET  /cluster/metrics the registered volume servers' /metrics merged
                        (stats/aggregate.py ClusterAggregator)
  GET  /cluster/health  their health counters and scrub verdicts, the
                        coordinator's totals, and a rollup `degraded`
  GET  /cluster/coordinator, POST /cluster/coordinator/pause|resume
                        the EC repair coordinator (ops/coordinator.py);
                        ?local=1 answers this master's own replicated
                        view, leader or not
  GET  /cluster/alerts  the alert engine's rules and alerts
                        (observability/alerts.py); ?state=firing filters
  POST /cluster/traces/ingest, GET /cluster/traces, /cluster/traces/<id>
                        the trace collector: servers ship the spans of
                        sampled traces, the master stitches them by trace
                        id and serves each with analyze_cluster's report
                        (?format=chrome: Chrome trace-event JSON)
  POST /cluster/events/ingest, GET /cluster/events
                        the cluster event journal; each accepted batch
                        goes to the coordinator's on_events (?local=1 as
                        for /cluster/coordinator)
  POST /cluster/workload/ingest, GET /cluster/workload[/export]
                        the workload journal (observability/reqlog.py):
                        every server's sampled access records, deduped;
                        ?route=, ?server=, ?since=, ?limit=; /export is
                        the recording document
  POST /cluster/heat/ingest, GET /cluster/heat
                        the heat journal (observability/heat.py): volume
                        ranks, the head set, the live Zipf fit, imbalance,
                        and the heat_shift / flash_crowd detector; ?top=
  POST /cluster/ledger/ingest, GET /cluster/ledger
                        the resource ledger's merge (observability/
                        ledger.py): CPU, bytes and queue wait by route,
                        client and server, loop lag, profiles, and the
                        loop_stall relay; ?top=
  GET|POST /cluster/capacity
                        the last capacity probe's document (scenarios/
                        capacity.py, the shell's capacity.probe); 404
                        until one has posted
  GET  /cluster/autoscale, POST /cluster/autoscale/pause|resume|tier
                        the heat autoscaler (ops/autoscaler.py): targets,
                        tiered volumes, totals, replicated records; /tier
                        tiers ({"volume_id", "backend"}) or recalls
                        ({"recall": true}) one volume through its legs
  GET  /cluster/watch   the location long-poll (?since_seq=, ?timeout= at
                        most 55 s): the vid -> location events after the
                        cursor, or a snapshot; stamped with the leader
  GET  /metrics         this process's Prometheus exposition: the
                        master's requests by route, the coordinator's and
                        the request plane's families (?exemplars=1 adds
                        sampled requests' trace ids to their buckets)
  GET  /debug/traces, /debug/traces/analyze, /debug/events
                        this process's span ring and journal
  GET  /debug/reqlog, POST /debug/reqlog/start|stop
                        this process's request log
  GET  /debug/profile, /debug/pprof/profile|goroutine|heap
                        sampling profiles, the thread dump, the heap
  POST /debug/flightrecorder/capture, GET /debug/flightrecorder[/<id>]
                        this process's diagnostic bundles (utils/debug.py)

A janitor thread unregisters volume servers that stopped heartbeating.
``coordinator_seconds`` > 0 starts the coordinator's loop with that
interval (the routes answer either way); it pauses while the shell's
admin lock is held, and it counts a registered server the aggregator
cannot scrape as down.  ``autoscale_seconds`` > 0 (``-autoscaleSeconds``)
starts the heat autoscaler's loop likewise, woken at once by the heat
journal's ``on_ingest`` and by heat events and alerts in the cluster
journal; ``autoscale_tier_backend`` (``-autoscale.tierBackend``) names
the backend its cold path tiers to (none: no tiering), and
``autoscale_opts`` passes its other knobs.
``metrics_aggregation_seconds`` > 0 scrapes every server that often and
then evaluates the alert rules, so the coordinator
sees a dead server within a scrape and an alert fires with nobody polling;
otherwise the /cluster/* routes scrape and /cluster/alerts evaluates on
demand (each at most once per ``min_interval``).  A firing alert asks each
implicated server, then the master itself, for a flight-recorder bundle on
a thread of its own, and its ``alert_fired`` event reaches the
coordinator, whose repairs name it.  Every
``VACUUM_SCAN_SECONDS`` (900, as in the reference) the master vacuums
every volume whose replicas all carry ``GARBAGE_THRESHOLD`` (0.3) or more
of garbage.  Like the reference's master CLI, the port sets neither by a
flag; tests set the attributes before ``start()``.  ``max_inflight`` > 0
(``-maxInflight``) sheds requests beyond that many in flight with a fast
503 (utils/admission.py); the /metrics, /debug, /cluster, /heartbeat,
/admin and /dir/status routes are never shed.  The master's own sheds and
504s show on its /metrics; /cluster/health sums the volume servers'
(like the reference's, it folds in only the coordinator's totals of its
own).

The master's own spans, events, access records and ledger snapshots reach
its collector and journals without HTTP (the shippers' local
short-circuit); its router settles every request into its own
RequestLedger.  Its /cluster/health contribution adds this process's lost
access records (``reqlog_records_dropped``) to the coordinator's totals.

High availability (``peers``, ``-peers``; ``mdir``, ``-mdir``): masters
elect a leader and replicate a log (master/consensus.py ``RaftNode``,
durable under ``mdir``).  The leader appends the volume-id allocation
(quorum-committed before a grow's first allocate call, so no later
leader reissues an id), every batch its cluster journal accepts, the
alert engine's state machines when an evaluation changed them, each
repair record of the coordinator (quorum-committed before the repair
runs), each lifecycle record of the autoscaler (``autoscale`` entries,
quorum-committed before the move goes on), the EC registry when a
heartbeat changed it, and every batch of access records its workload
journal accepts (``workload`` entries; a
snapshot carries the journal under ``workload``).  A follower
applies committed entries to the same state machines, so a promoted
follower serves the journal, resumes a firing alert, re-plans an
orphaned repair under its original cause and closes or resumes an
orphaned replica add or tier commit.  The vacuum scan, the
coordinator, the autoscaler and the telemetry loop run on the leader
only.  A follower
answers the control plane's GETs with 307 and ``Location`` at the
leader (503 while no leader is elected), forwards POSTs to it, and
answers a heartbeat with ``{"leader", "not_leader": true}``.  With no
peers the master is the leader at once.

The framed-TCP assign front (utils/framing.py, op ``A``: a JSON body of
/dir/assign's parameters, /dir/assign's answer as JSON) listens on the
HTTP port + 20000, wrapping down past 65535.  It answers on the leader
only; a follower's answer is the error frame ``PermissionError: not the
leader``, and the client falls back to HTTP.  A failed bind leaves the
master up without it: a ``degraded_bind`` event and
``SeaweedFS_server_degraded_binds_total{role="master-tcp"}``.

Security (security/, from ``security.toml``): with the ``guard``'s write
key, /dir/assign's answer carries ``auth``, a token for exactly its fid,
and /dir/lookup's with ``fileId`` carries ``writeAuth`` for that fid (a
delete's); with its read key /dir/lookup carries ``auth``, a bare read
token.  ``tls_context`` serves HTTPS (mTLS with a CA).  The framed assign
front does not start under a write key or TLS: it has neither a token
nor a TLS slot, and clients fall back to HTTP.

Not ported: the maintenance scripts.
"""

from __future__ import annotations

import hashlib
import json
import logging
import secrets
import threading
import time
import urllib.parse
from typing import Optional

from ..observability import analyze_cluster, get_tracer
from ..observability.collector import TraceCollector, TraceShipper
from ..observability.alerts import AlertEngine, default_rules
from ..observability.events import (HEALTH_EVENT_TYPES,
                                    REFERENCE_ONLY_HEALTH_EVENT_TYPES,
                                    ClusterEventJournal, EventShipper,
                                    get_journal)
from ..observability.flightrecorder import get_flightrecorder
from ..observability.heat import ClusterHeatJournal
from ..observability.ledger import (ClusterLedgerJournal, LedgerShipper,
                                    RequestLedger)
from ..observability.reqlog import (ReqlogShipper, WorkloadJournal,
                                    dropped_total, get_recorder,
                                    summarize_records)
from ..ops.autoscaler import HeatAutoscaler
from ..ops.coordinator import EcCoordinator
from ..security import Guard, gen_jwt_for_volume_server
from ..stats import (REGISTRY, degraded_bind_metrics, heat_metrics,
                     ledger_metrics, master_metrics, request_plane_metrics)
from ..stats.aggregate import ClusterAggregator
from ..stats.metrics import exemplars_requested
from ..storage.file_id import format_needle_id_cookie
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from ..utils.admission import maybe_controller
from ..utils.debug import register_debug_routes
from ..utils.framing import FramedServer, note_degraded_bind, tcp_port_for
from ..utils.httpd import (HttpError, Request, Response, Router,
                           extract_upload, http_json, qfloat, qint, serve,
                           stop_server)
from .consensus import RaftNode
from .sequence import MemorySequencer
from .topology import EcVolumeInfo, ShardBits, Topology, VolumeInfo
from .volume_growth import grow_volume

VERSION = "seaweedfs-tpu 0.1"

log = logging.getLogger(__name__)


def _ec_infos(entries: list[dict]) -> list[EcVolumeInfo]:
    return [EcVolumeInfo(int(e["volume_id"]), e.get("collection", ""),
                         ShardBits(int(e["ec_index_bits"])))
            for e in entries]


def _max_file_key(volumes: list[dict]) -> int:
    return max((int(v.get("max_file_key", 0)) for v in volumes), default=0)


def _local(req: Request) -> bool:
    """``?local=1``: answer from this master's own replicated state, leader
    or not (a follower's warm copy; the port's addition)."""
    return req.query.get("local", "") in ("1", "true")


class MasterServer:
    # the periodic vacuum (master/server.py defaults of the reference)
    GARBAGE_THRESHOLD = 0.3
    VACUUM_SCAN_SECONDS = 900.0

    def __init__(self, host: str = "127.0.0.1", port: int = 9333,
                 volume_size_limit_mb: int = 30000,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 coordinator_seconds: float = 0.0,
                 metrics_aggregation_seconds: float = 0.0,
                 max_inflight: int = 0,
                 peers: Optional[list[str]] = None, mdir: str = "",
                 guard: Optional[Guard] = None, tls_context=None,
                 autoscale_seconds: float = 0.0,
                 autoscale_tier_backend: str = "",
                 autoscale_opts: Optional[dict] = None):
        """A master at host:port.  Volume servers silent for ten pulses
        are dropped.  ``max_inflight`` > 0 turns admission control on.
        ``autoscale_seconds`` > 0 runs the heat autoscaler's loop.
        ``peers``: the other masters' host:port (none: a single master,
        the leader at once); ``mdir``: the directory of its raft state.
        ``guard``: the keys it signs tokens with (none: no tokens);
        ``tls_context``: serve HTTPS."""
        self.host, self.port = host, port
        self.guard = guard or Guard()
        self._tls_context = tls_context
        self.garbage_threshold = self.GARBAGE_THRESHOLD
        self.vacuum_scan_seconds = self.VACUUM_SCAN_SECONDS
        self.topo = Topology(volume_size_limit_mb * 1024 * 1024,
                             pulse_seconds)
        self.default_replication = default_replication
        self.seq = MemorySequencer()
        self.metrics = master_metrics()
        request_plane_metrics()  # its families exist on /metrics at 0
        degraded_bind_metrics()
        self.router = Router("master", metrics=self.metrics)
        self.router.server_url = self.url
        self.router.admission = maybe_controller(max_inflight, "master")
        self._register_routes()
        self._server = None
        self._tcp_server = None
        self._stop = threading.Event()
        # admin lock (shell exclusivity), guarded by topo.lock
        self._admin_token: Optional[int] = None
        self._admin_lock_ts = 0.0
        self._admin_client = ""
        # lazy self-client for /submit (assign + upload in one call)
        self._submit_client = None
        self.metrics_aggregation_seconds = metrics_aggregation_seconds
        self.aggregator = ClusterAggregator(peers_fn=self._peer_urls)
        self.coordinator_seconds = coordinator_seconds
        self.coordinator = EcCoordinator(
            topo=self.topo, server=self.url,
            stale_peers_fn=self._stale_peers,
            is_leader_fn=lambda: self.is_leader,
            admin_locked_fn=self._admin_locked,
            interval_s=coordinator_seconds or 15.0,
            replicate_fn=self._replicate_coordinator_record)
        self.aggregator.local_fn = self._local_health_contribution
        # servers ship sampled spans and journal events here; the
        # master's own take the local short-circuit
        self.trace_collector = TraceCollector()
        self._trace_shipper = TraceShipper(
            get_tracer(), server=self.url,
            local_collector=self.trace_collector)
        self.event_journal = ClusterEventJournal()
        self._event_shipper = EventShipper(
            get_journal(), server=self.url,
            local_journal=self.event_journal)
        self.event_journal.on_ingest = self._on_cluster_events
        # every server's sampled access records (observability/reqlog.py);
        # the master's own take the local short-circuit
        self.workload_journal = WorkloadJournal()
        self._reqlog_shipper = ReqlogShipper(
            get_recorder(), server=self.url,
            local_journal=self.workload_journal)
        self.workload_journal.on_ingest = self._on_workload_records
        # the volume servers' heat (observability/heat.py), whose every
        # ingest wakes the heat autoscaler; the autoscaler's lifecycle
        # records ride the raft log as "autoscale" entries
        heat_metrics()
        self.heat_journal = ClusterHeatJournal(rack_fn=self._rack_of)
        self.autoscale_seconds = autoscale_seconds
        self.autoscaler = HeatAutoscaler(
            topo=self.topo, server=self.url,
            heat_fn=lambda: self.heat_journal.to_doc(top_needles=0),
            stale_peers_fn=self._stale_peers,
            is_leader_fn=lambda: self.is_leader,
            admin_locked_fn=self._admin_locked,
            interval_s=autoscale_seconds or 5.0,
            tier_backend=autoscale_tier_backend,
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            replicate_fn=self._replicate_autoscale_record,
            **dict(autoscale_opts or {}))
        self.heat_journal.on_ingest = self.autoscaler.on_heat
        # every server's resource ledger (observability/ledger.py); the
        # master settles its own requests too, shipped locally
        ledger_metrics()
        self.ledger_journal = ClusterLedgerJournal()
        self._capacity_doc: Optional[dict] = None
        self.ledger = RequestLedger(server=self.url)
        self._ledger_shipper = LedgerShipper(
            self.ledger, server=self.url,
            local_journal=self.ledger_journal)
        self.router.ledger = self.ledger
        self.alert_engine = AlertEngine(
            default_rules(),
            source_fn=lambda: (self.aggregator.health(),
                               self.aggregator.merged()),
            server=self.url,
            on_fire=self._on_alert_fire,
            exemplar_fn=self._alert_exemplar)
        # capture fan-outs in flight: stop() waits for them
        self._capture_lock = threading.Lock()
        self._capture_threads: list[threading.Thread] = []  # guarded-by: _capture_lock
        # the EC registry as a follower applied it from ec_registry
        # entries (plain urls: a promoted leader rebuilds the live one
        # from heartbeats), and the last replicated fingerprints
        self._ec_registry_shadow: dict = {}  # guarded-by: topo.lock
        self._ec_registry_hash = ""  # guarded-by: topo.lock
        self._alert_state_hash = ""  # the telemetry loop's alone
        # last: restart recovery replays the log through the state
        # machines above while RaftNode is being made
        self.raft = RaftNode(
            self.url, peers or [], state_dir=mdir,
            apply_state=self._apply_raft_state,
            read_state=lambda: {"max_volume_id": self.topo.max_volume_id,
                                "max_file_key": self.seq.peek()},
            apply_entry=self._apply_raft_entry,
            read_snapshot=self._raft_read_snapshot,
            apply_snapshot=self._raft_apply_snapshot)
        self.metrics.leader_gauge.set(1 if self.raft.is_leader else 0)
        self.raft.on_role_change = self._on_role_change

    # --- lifecycle --------------------------------------------------------
    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "MasterServer":
        self._trace_shipper.attach()
        self._event_shipper.attach()
        self._reqlog_shipper.attach()
        self._ledger_shipper.attach()
        self._server = serve(self.router, self.host, self.port,
                             tls_context=self._tls_context)
        if self._tls_context is None and not self.guard.signing_key:
            self._start_tcp_assign()
        self.raft.start()
        threading.Thread(target=self._janitor_loop, daemon=True,
                         name="master-janitor").start()
        if self.metrics_aggregation_seconds > 0:
            threading.Thread(target=self._telemetry_loop, daemon=True,
                             name="master-telemetry").start()
        if self.coordinator_seconds > 0:
            self.coordinator.start()
        if self.autoscale_seconds > 0:
            self.autoscaler.start()
        if self.vacuum_scan_seconds > 0:
            threading.Thread(target=self._vacuum_scan_loop, daemon=True,
                             name="master-vacuum-scan").start()
        return self

    def _tcp_assign(self, op: bytes, key: str, body: bytes) -> bytes:
        """The framed assign op ``A``: a JSON body of /dir/assign's
        parameters -> /dir/assign's answer as JSON.  Leader only: a
        follower refuses, and the client falls back to HTTP, whose
        redirects reach the leader."""
        if op != b"A":
            raise ValueError(f"unknown op {op!r}")
        if not self.is_leader:
            raise PermissionError("not the leader")
        params = json.loads(body) if body else {}
        return json.dumps(self.assign_fid(
            count=int(params.get("count", 1)),
            collection=params.get("collection", ""),
            replication=params.get("replication", ""),
            ttl_str=params.get("ttl", ""),
            preferred_dc=params.get("dataCenter", ""))).encode()

    def _start_tcp_assign(self) -> None:
        """The framed-TCP assign front on the HTTP port + 20000, which
        ``upload_tcp`` asks first.  A failed bind leaves the master up
        without it, and says so."""
        self._tcp_server = FramedServer(
            self._tcp_assign, self.host, tcp_port_for(self.port),
            name="tcp-master").start()
        if not self._tcp_server.alive:
            note_degraded_bind("master-tcp", self.url,
                               self._tcp_server.port)

    def stop(self) -> None:
        self._stop.set()
        self.coordinator.stop()
        self.autoscaler.stop()
        if self._tcp_server is not None:
            self._tcp_server.stop()
        self.raft.stop()
        if self._server is not None:
            stop_server(self._server)
        # a straggling capture writes no bundle after this (its stop
        # checks), but one mid-write finishes before the caller removes
        # the spool
        with self._capture_lock:
            captures = list(self._capture_threads)
        for t in captures:
            t.join(timeout=30.0)
        # detached, or a later master in this process would receive this
        # one's spans, events and records through the chained hooks
        self._trace_shipper.detach()
        self._event_shipper.detach()
        self._reqlog_shipper.detach()
        self._ledger_shipper.detach()

    def _local_health_contribution(self) -> dict:
        """The master's own totals in /cluster/health: the coordinator's,
        the autoscaler's failed actuations, and this process's lost access
        records (the master's registry is never scraped, so the workload
        journal's evictions would miss the reqlog_records_dropped alert).  Co-located servers in one process
        may count the total twice: a warning too many, never one short."""
        extra = dict(self.coordinator.health_contribution() or {})
        extra.update(self.autoscaler.health_contribution() or {})
        extra["reqlog_records_dropped"] = \
            extra.get("reqlog_records_dropped", 0) + dropped_total()
        return extra

    # --- consensus (raft_server.go; the state machine is the control
    # plane) ---------------------------------------------------------------
    def _apply_raft_state(self, state: dict) -> None:
        vid = int(state.get("max_volume_id", 0))
        with self.topo.lock:
            self.topo.max_volume_id = max(self.topo.max_volume_id, vid)
        key = int(state.get("max_file_key", 0))
        if key:
            self.seq.set_max(key)

    @staticmethod
    def _ingest_preserving_via(journal, docs: list) -> None:
        """Replay replicated records into a merged journal keeping each
        record's ``via`` (the transport the leader stamped), so a caught-up
        follower's journal equals the leader's."""
        by_via: dict[str, list] = {}
        for d in docs or []:
            by_via.setdefault(str(d.get("via") or "raft"), []).append(d)
        for via, batch in by_via.items():
            journal.ingest(via, batch)

    def _set_ec_registry_shadow(self, doc: dict) -> None:
        with self.topo.lock:
            self._ec_registry_shadow = doc.get("registry") or {}
            self._ec_registry_hash = doc.get("hash") or ""

    def _apply_raft_entry(self, kind: str, data: dict) -> None:
        """A committed log entry into the state machines the leader runs
        (the apply loop of consensus.py).  Every branch is idempotent:
        journals dedup by record id, the counters max-merge."""
        if kind == "vid_alloc":
            self._apply_raft_state(data)
        elif kind == "event":
            self._ingest_preserving_via(self.event_journal,
                                        data.get("events") or [])
        elif kind == "workload":
            self._ingest_preserving_via(self.workload_journal,
                                        data.get("records") or [])
        elif kind == "alert":
            self.alert_engine.import_state(data.get("alerts") or {})
        elif kind == "coordinator":
            self.coordinator.apply_replicated(data)
        elif kind == "autoscale":
            self.autoscaler.apply_replicated(data)
        elif kind == "ec_registry":
            self._set_ec_registry_shadow(data)

    def _raft_read_snapshot(self) -> dict:
        """The whole control-plane image, for log compaction and
        InstallSnapshot: the meta counters and every replicated state
        machine's state."""
        return {
            "max_volume_id": self.topo.max_volume_id,
            "max_file_key": self.seq.peek(),
            "events": self.event_journal.query(limit=0),
            "workload": self.workload_journal.query(limit=0),
            "alerts": self.alert_engine.export_state(),
            "coordinator": self.coordinator.export_replicated(),
            "autoscale": self.autoscaler.export_replicated(),
            "ec_registry": self._ec_registry_doc(),
        }

    def _raft_apply_snapshot(self, state: dict) -> None:
        """InstallSnapshot or restart recovery: the image through the local
        state machines (idempotent)."""
        self._apply_raft_state(state)
        self._ingest_preserving_via(self.event_journal,
                                    state.get("events") or [])
        self._ingest_preserving_via(self.workload_journal,
                                    state.get("workload") or [])
        self.alert_engine.import_state(state.get("alerts") or {})
        self.coordinator.import_replicated(state.get("coordinator") or {})
        self.autoscaler.import_replicated(state.get("autoscale") or {})
        reg = state.get("ec_registry") or {}
        if reg:
            self._set_ec_registry_shadow(reg)

    def _leader_raft(self) -> Optional[RaftNode]:
        """The raft node when this master leads a quorum with peers, else
        None.  getattr: restart recovery replays the log while RaftNode
        is being made, before ``self.raft`` is bound."""
        raft = getattr(self, "raft", None)
        if raft is not None and raft.peers and raft.is_leader:
            return raft
        return None

    def _on_cluster_events(self, accepted: list[dict]) -> None:
        """The cluster journal's ingest hook: each batch of newly accepted
        events wakes the coordinator and the autoscaler with their causes,
        and on a leader enters the raft log (it rides the next replication
        round)."""
        self.coordinator.on_events(accepted)
        self.autoscaler.on_events(accepted)
        raft = self._leader_raft()
        if raft is not None:
            raft.append("event", {"events": accepted})

    def _on_workload_records(self, accepted: list[dict]) -> None:
        """The workload journal's ingest hook: on a leader, each batch of
        newly accepted records enters the raft log."""
        raft = self._leader_raft()
        if raft is not None:
            raft.append("workload", {"records": accepted})

    def _rack_of(self, server_url: str) -> str:
        """The rack a volume server's heartbeats registered it under: the
        heat journal's rack-imbalance gauge."""
        with self.topo.lock:
            for node in self.topo.all_nodes():
                if node.url == server_url:
                    return node.rack.name if node.rack else ""
        return ""

    def _replicate_coordinator_record(self, record: dict) -> None:
        """The coordinator's replicate_fn: a repair record reaches a
        quorum before the repair goes on, so a leader killed mid-repair
        leaves its planned record for the next leader to re-plan."""
        raft = self._leader_raft()
        if raft is not None:
            raft.append("coordinator", record, sync=True)

    def _replicate_autoscale_record(self, record: dict) -> None:
        """The autoscaler's replicate_fn: a lifecycle record reaches a
        quorum before the move goes on.  ``tier_pending`` is the tier's
        commit point, and a leader killed mid replica add leaves its
        ``grow_planned`` for the next leader to close or resume, never to
        copy twice."""
        raft = self._leader_raft()
        if raft is not None:
            raft.append("autoscale", record, sync=True)

    def _ec_registry_doc(self) -> dict:
        """The EC registry as plain urls (what ec_registry entries carry):
        on the leader, from the live topology; on a follower, the applied
        shadow."""
        with self.topo.lock:
            if self.topo.ec_shard_locations:
                reg = {
                    str(vid): {
                        "collection": self.topo.ec_collections.get(vid, ""),
                        "shards": {str(sid): [n.url for n in nodes]
                                   for sid, nodes in shards.items()}}
                    for vid, shards in self.topo.ec_shard_locations.items()}
            else:
                reg = dict(self._ec_registry_shadow)
        h = hashlib.sha1(json.dumps(reg, sort_keys=True)
                         .encode()).hexdigest()[:16]
        return {"registry": reg, "hash": h}

    def _replicate_ec_registry(self) -> None:
        """Heartbeat path: when the EC shard map changed since the last
        replication, append the whole mapping as one ec_registry entry."""
        raft = self._leader_raft()
        if raft is None:
            return
        doc = self._ec_registry_doc()
        with self.topo.lock:
            if doc["hash"] == self._ec_registry_hash:
                return
            self._ec_registry_hash = doc["hash"]
        raft.append("ec_registry", doc)

    def _replicate_alert_state(self) -> None:
        """Telemetry cadence: replicate the alert state machines when they
        changed, so a promoted follower resumes firing and pending alerts
        instead of re-running their pending windows mid-incident."""
        raft = self._leader_raft()
        if raft is None:
            return
        doc = self.alert_engine.export_state()
        h = hashlib.sha1(json.dumps(doc, sort_keys=True)
                         .encode()).hexdigest()
        if h == self._alert_state_hash:
            return
        self._alert_state_hash = h
        raft.append("alert", {"alerts": doc})

    def _on_role_change(self, role: str) -> None:
        """Raft's role hook (outside its lock).  A demoted master's loops
        idle on their own (each gates on is_leader every tick); a
        promoted one re-arms the planned repairs and autoscaler moves it
        holds with their original causes."""
        self.metrics.leader_gauge.set(1 if role == "leader" else 0)
        if role == "leader":
            try:
                self.coordinator.resume_replicated()
            except Exception:  # noqa: BLE001 - the next cycle re-plans
                log.exception("resuming the replicated repairs")
            try:
                self.autoscaler.resume_replicated()
            except Exception:  # noqa: BLE001 - the next cycle re-plans
                log.exception("resuming the replicated autoscaler moves")

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader

    @property
    def leader_url(self) -> str:
        return self.raft.leader or self.url

    def _commit_volume_ids(self) -> None:
        """Quorum-replicate max_volume_id before an allocation is acked
        (the raft log commit of the reference); reached only from
        leader-gated routes, and commit_state fails closed on a
        follower."""
        if not self.raft.commit_state():
            raise HttpError(500, "cannot replicate volume id allocation "
                            "to a quorum; retry")

    def _no_leader(self) -> bool:
        return not self.raft.leader or self.raft.leader == self.url

    def _proxy_to_leader(self, req: Request) -> Response:
        """A follower forwards a POST to the leader and relays the answer
        (master_server.go proxyToLeader); 503 while none is elected."""
        if self._no_leader():
            raise HttpError(503, "no leader elected yet; retry")
        return Response(http_json(
            "POST", f"http://{self.leader_url}{req.handler.path}",
            req.json() if req.body else None, timeout=30.0))

    def _require_leader(self, req: Request) -> None:
        """The control plane answers on the leader: a follower redirects
        with 307 and the same path and query, and answers 503 while no
        leader is elected, so clients retry instead of looping."""
        if self.is_leader:
            return
        if self._no_leader():
            raise HttpError(503, "no leader elected yet; retry")
        raise HttpError(307, f"not the leader; leader is {self.leader_url}",
                        headers={"Location": f"http://{self.leader_url}"
                                             f"{req.handler.path}"})

    def _telemetry_loop(self) -> None:
        """The -metricsAggregationSeconds cadence, on the leader: keep the
        cluster rollup warm, evaluate the alert rules over it (alerts fire
        with nobody polling /cluster/health) and replicate their state."""
        while not self._stop.wait(self.metrics_aggregation_seconds):
            if not self.is_leader:
                continue
            try:
                self.aggregator.scrape(force=True, include_scrub=True)
                self.alert_engine.evaluate(force=True)
                self._replicate_alert_state()
            except Exception:  # noqa: BLE001 - rules carry their own errors
                log.exception("telemetry loop")

    def _alert_exemplar(self, rule) -> str:
        """The trace id of the newest cluster-journal event about this
        rule's subject: the alert's exemplar, so the operator can
        trace.fetch the operation that degraded."""
        if rule.kind == "journal_event":
            etype = rule.params.get("event", "")
        else:
            key = rule.params.get("key", "")
            etype = HEALTH_EVENT_TYPES.get(key) or \
                REFERENCE_ONLY_HEALTH_EVENT_TYPES.get(key)
        if not etype:
            return ""
        evs = self.event_journal.query(type_=etype, limit=1)
        return (evs[-1].get("trace") or "") if evs else ""

    def _on_alert_fire(self, rule, state_doc: dict, servers: list) -> None:
        """Firing transition -> flight-recorder fan-out: ask each
        implicated server (at most eight) to freeze a bundle, then
        capture the master's own view.  On a thread of its own (a 0.25 s
        profile per server must not stall the evaluation), landing the
        bundle ids on the alert (``bundles`` in /cluster/alerts)."""

        def worker():
            # let the peers' shippers flush the transition's events
            # before they are frozen into bundles
            if self._stop.wait(0.6):
                return
            bundles: list[dict] = []
            trace_id = state_doc.get("exemplar_trace", "")
            for url in list(dict.fromkeys(servers))[:8]:
                if self._stop.is_set():
                    return
                try:
                    r = http_json(
                        "POST", f"http://{url}/debug/flightrecorder/capture",
                        {"reason": f"alert:{rule.name}", "alert": rule.name,
                         "trace_id": trace_id}, timeout=15)
                    bundles.append({"server": url, "id": r.get("id")})
                except Exception as e:  # noqa: BLE001 - noted on the alert
                    bundles.append({"server": url,
                                    "error": f"{type(e).__name__}: {e}"
                                    [:200]})
            if self._stop.is_set():
                # a stopped master writes nothing into the
                # process-global recorder from a straggling thread
                return
            try:
                # the master's bundle freezes the cluster journal (its
                # own journal sees only the alert transitions)
                meta = get_flightrecorder().capture(
                    reason=f"alert:{rule.name}", alert=rule.name,
                    server=self.url, trace_id=trace_id,
                    events=self.event_journal.query(limit=256))
                bundles.append({"server": self.url, "id": meta["id"]})
            except Exception:  # noqa: BLE001 - the peers' bundles stand
                log.exception("flight capture on the master")
            self.alert_engine.note_bundles(rule.name, bundles)

        t = threading.Thread(target=worker, daemon=True,
                             name="flight-capture")
        with self._capture_lock:
            # started before stop() can see it: it joins what it sees
            t.start()
            self._capture_threads = [c for c in self._capture_threads
                                     if c.is_alive()] + [t]

    def _janitor_loop(self) -> None:
        while not self._stop.wait(self.topo.pulse_seconds):
            for node in self.topo.dead_nodes():
                self.topo.unregister_node(node)

    def _vacuum_scan_loop(self) -> None:
        """The periodic garbage scan (topology_event_handling.go ticker):
        compact every volume past the threshold with no operator, on the
        leader.  A failed pass is logged and the next one runs on time."""
        while not self._stop.wait(self.vacuum_scan_seconds):
            if not self.is_leader:
                continue
            try:
                self.vacuum(self.garbage_threshold)
            except Exception as e:  # noqa: BLE001 - keep scanning
                log.warning("vacuum-scan: %s", e)

    def vacuum(self, threshold: float) -> list[int]:
        """topology_vacuum.go: ask each replica its garbage ratio; when
        the smallest reaches ``threshold``, take the volume out of the
        writable set, compact every replica, then commit every replica.
        A failed compact commits nothing and leaves the `.cpd`/`.cpx` for
        /admin/vacuum_cleanup.  Returns the volumes compacted."""
        compacted = []
        with self.topo.lock:
            layouts = list(self.topo.layouts.values())
        for layout in layouts:
            with self.topo.lock:
                vid_nodes = [(vid, list(nodes)) for vid, nodes
                             in layout.vid_to_nodes.items()]
            for vid, nodes in vid_nodes:
                try:
                    ratios = [
                        http_json("POST", f"http://{n.url}/admin/vacuum_check",
                                  {"volume_id": vid},
                                  timeout=30.0)["garbage_ratio"]
                        for n in nodes]
                    if not ratios or min(ratios) < threshold:
                        continue
                    with self.topo.lock:
                        layout.set_readonly(vid, True)
                    try:
                        for n in nodes:
                            http_json("POST",
                                      f"http://{n.url}/admin/vacuum_compact",
                                      {"volume_id": vid}, timeout=600)
                        for n in nodes:
                            http_json("POST",
                                      f"http://{n.url}/admin/vacuum_commit",
                                      {"volume_id": vid}, timeout=600)
                        compacted.append(vid)
                    finally:
                        with self.topo.lock:
                            layout.set_readonly(vid, False)
                except HttpError:
                    continue
        return compacted

    def _peer_urls(self) -> list[str]:
        with self.topo.lock:
            return [n.url for n in self.topo.all_nodes()]

    def _stale_peers(self) -> list[str]:
        """Registered servers the aggregator's last scrape could not reach:
        the coordinator counts neither their shards nor them as targets."""
        return [u for u, s in self.aggregator.peer_status().items()
                if s["stale"]]

    def _admin_locked(self) -> bool:
        """True while the shell's admin lock is validly held: the
        coordinator waits, so an operator's ec.rebuild or ec.balance never
        duels it."""
        with self.topo.lock:
            return self._admin_token is not None and \
                time.time() - self._admin_lock_ts <= 60

    def assign_fid(self, count: int = 1, collection: str = "",
                   replication: str = "", ttl_str: str = "",
                   preferred_dc: str = "") -> dict:
        """fid allocation (master_grpc_server_volume.go:102 Assign): pick
        a writable volume, growing one when there is none."""
        replication = replication or self.default_replication
        ttl = TTL.parse(ttl_str)
        rp = ReplicaPlacement.parse(replication)
        layout = self.topo.get_layout(collection, rp, ttl)
        try:
            vid, nodes = layout.pick_for_write()
        except LookupError:
            grow_volume(self.topo, collection, rp, ttl, self._allocate_rpc,
                        preferred_dc=preferred_dc,
                        commit_ids=self._commit_volume_ids)
            vid, nodes = layout.pick_for_write()
        key = self.seq.next_file_id(count)
        cookie = secrets.randbits(32)
        node = self.topo.rng.choice(nodes)
        fid = f"{vid},{format_needle_id_cookie(key, cookie)}"
        result = {"fid": fid, "url": node.url, "publicUrl": node.public_url,
                  "count": count}
        # write authorization: a token for exactly this fid
        # (security/jwt.go:30, master_server_handlers.go)
        if self.guard.signing_key:
            result["auth"] = gen_jwt_for_volume_server(
                self.guard.signing_key, self.guard.expires_after_sec, fid)
        return result

    def _allocate_rpc(self, node, vid: int, collection: str,
                      replication: str, ttl: str) -> None:
        http_json("POST", f"http://{node.url}/admin/assign_volume", {
            "volume_id": vid, "collection": collection,
            "replication": replication, "ttl": ttl,
        }, timeout=30.0)

    def _heartbeat(self, hb: dict) -> dict:
        """One heartbeat (master_grpc_server.go:21-180): a full sync
        registers the node and replaces its volumes and EC shards; a
        delta applies only the changes, and from an unknown node asks for
        a full resync.  Either re-seeds the key sequencer from the
        largest needle key seen, so a restarted master never re-issues a
        key."""
        reply = {"volumeSizeLimit": self.topo.volume_size_limit,
                 "leader": self.url}
        if hb.get("delta"):
            node = self.topo.find_node(hb["ip"], int(hb["port"]))
            if node is None:
                return {"resync": True, "leader": self.url}
            new_volumes = hb.get("new_volumes", [])
            self.topo.apply_volume_deltas(
                node, [VolumeInfo.from_dict(v) for v in new_volumes],
                [int(v) for v in hb.get("deleted_volumes", [])])
            self.topo.apply_ec_deltas(
                node, _ec_infos(hb.get("new_ec_shards", [])),
                [int(v) for v in hb.get("deleted_ec_shards", [])])
            if hb.get("new_ec_shards") or hb.get("deleted_ec_shards"):
                self._replicate_ec_registry()
        else:
            node = self.topo.register_node(
                hb["ip"], int(hb["port"]), hb.get("public_url", ""),
                hb.get("data_center") or "DefaultDataCenter",
                hb.get("rack") or "DefaultRack",
                int(hb.get("max_volume_count", 8)))
            new_volumes = hb.get("volumes", [])
            self.topo.sync_node_volumes(
                node, [VolumeInfo.from_dict(v) for v in new_volumes])
            ec_infos = _ec_infos(hb.get("ec_shards", []))
            self.topo.sync_node_ec_shards(node, ec_infos)
            if ec_infos:
                self._replicate_ec_registry()
        max_key = _max_file_key(new_volumes)
        if max_key:
            self.seq.set_max(max_key)
        return reply

    # --- routes -----------------------------------------------------------
    def _register_routes(self) -> None:
        r = self.router

        @r.route("POST", "/raft/vote")
        def raft_vote(req: Request) -> Response:
            b = req.json()
            return Response(self.raft.handle_vote(
                int(b["term"]), b["candidate"], b.get("state"),
                last_index=b.get("last_index"),
                last_term=b.get("last_term")))

        @r.route("POST", "/raft/append")
        def raft_append(req: Request) -> Response:
            b = req.json()
            res = self.raft.handle_append(
                int(b["term"]), b["leader"], b.get("state") or {},
                prev_index=b.get("prev_index"),
                prev_term=int(b.get("prev_term") or 0),
                entries=b.get("entries"), commit=b.get("commit"))
            self.metrics.leader_gauge.set(1 if self.raft.is_leader else 0)
            return Response(res)

        @r.route("POST", "/raft/snapshot")
        def raft_snapshot(req: Request) -> Response:
            """InstallSnapshot: a restarted or long-partitioned master whose
            needed entries were compacted away takes the leader's image
            and the entry tail."""
            b = req.json()
            res = self.raft.handle_snapshot(
                int(b["term"]), b["leader"],
                int(b.get("last_index") or 0),
                int(b.get("last_term") or 0),
                b.get("state") or {}, entries=b.get("entries"),
                commit=b.get("commit"))
            self.metrics.leader_gauge.set(1 if self.raft.is_leader else 0)
            return Response(res)

        @r.route("GET", "/dir/assign")
        def assign(req: Request) -> Response:
            self._require_leader(req)
            return Response(self.assign_fid(
                count=qint(req.query, "count", 1),
                collection=req.query.get("collection", ""),
                replication=req.query.get("replication", ""),
                ttl_str=req.query.get("ttl", ""),
                preferred_dc=req.query.get("dataCenter", "")))

        @r.route("GET", "/dir/lookup")
        def lookup(req: Request) -> Response:
            self._require_leader(req)
            vid_str = req.query.get("volumeId", "")
            vid = int(vid_str.split(",")[0])
            nodes = self.topo.lookup(vid, req.query.get("collection", ""))
            if not nodes:
                return Response({"volumeId": vid_str,
                                 "error": "volume id not found"}, status=404)
            result = {
                "volumeId": vid_str,
                "locations": [{"url": n.url, "publicUrl": n.public_url}
                              for n in nodes],
            }
            # a read key: a bare read token; a write key and a fileId: a
            # token to delete that file
            if self.guard.read_signing_key:
                result["auth"] = self.guard.gen_read_token()
            file_id = req.query.get("fileId", "")
            if file_id and self.guard.signing_key:
                result["writeAuth"] = gen_jwt_for_volume_server(
                    self.guard.signing_key, self.guard.expires_after_sec,
                    file_id)
            return Response(result)

        @r.route("GET", "/dir/lookup_ec")
        def lookup_ec(req: Request) -> Response:
            self._require_leader(req)
            vid = qint(req.query, "volumeId")
            locs = self.topo.lookup_ec_shards(vid)
            if locs is None:
                raise HttpError(404, f"ec volume {vid} not found")
            return Response({
                "volumeId": vid,
                "collection": self.topo.ec_collections.get(vid, ""),
                "shards": {str(sid): [n.url for n in nodes]
                           for sid, nodes in locs.items()},
            })

        @r.route("GET", "/dir/status")
        def dir_status(req: Request) -> Response:
            self._require_leader(req)
            return Response({"Topology": self.topo.to_map(),
                             "Version": VERSION,
                             "VolumeSizeLimitMB":
                                 self.topo.volume_size_limit >> 20})

        @r.route("GET", "/cluster/status")
        def cluster_status(req: Request) -> Response:
            st = self.raft.status()
            return Response({"IsLeader": self.is_leader,
                             "Leader": self.leader_url,
                             "Peers": self.raft.peers,
                             "Term": st["term"],
                             "Role": st["role"],
                             "CommitIndex": st["commit_index"],
                             "LastApplied": st["last_applied"],
                             "LogLength": st["log_length"],
                             "LogFirstIndex": st["log_first_index"],
                             "LastIndex": st["last_index"],
                             "SnapshotIndex": st["snapshot_index"],
                             "SnapshotsInstalled":
                                 st["snapshots_installed"],
                             "SnapshotsSent": st["snapshots_sent"]})

        @r.route("GET", "/cluster/metrics")
        def cluster_metrics(req: Request) -> Response:
            self.aggregator.scrape()
            return Response(raw=self.aggregator.expose().encode(), headers={
                "Content-Type": "text/plain; version=0.0.4; charset=utf-8"})

        @r.route("GET", "/metrics")
        def metrics(req: Request) -> Response:
            return Response(
                raw=REGISTRY.expose(
                    exemplars=exemplars_requested(req)).encode(),
                headers={"Content-Type":
                         "text/plain; version=0.0.4; charset=utf-8"})

        @r.route("GET", "/cluster/health")
        def cluster_health(req: Request) -> Response:
            self.aggregator.scrape(include_scrub=True)
            return Response(self.aggregator.health())

        @r.route("GET", "/cluster/alerts")
        def cluster_alerts(req: Request) -> Response:
            """The alert engine's state: every rule's alert (inactive,
            pending, firing or resolved) with value, detail, implicated
            servers, exemplar trace and flight-recorder bundles, and the
            rule table.  Evaluates on demand behind the same TTL guards
            as the scrape, so polling cannot amplify; ?state= filters."""
            self._require_leader(req)
            self.aggregator.scrape(include_scrub=True)
            doc = self.alert_engine.evaluate()
            want = req.query.get("state", "").strip().lower()
            if want:
                doc = dict(doc)
                doc["alerts"] = [a for a in doc["alerts"]
                                 if a["state"] == want]
            return Response(doc)

        @r.route("GET", "/cluster/coordinator")
        def cluster_coordinator(req: Request) -> Response:
            if not _local(req):
                self._require_leader(req)
            return Response(self.coordinator.status())

        @r.route("POST", "/cluster/coordinator/pause")
        def cluster_coordinator_pause(req: Request) -> Response:
            """An operator's hold that outlives the admin lock: no new
            repair or move starts until resume."""
            self._require_leader(req)
            self.coordinator.pause("api")
            return Response(self.coordinator.status())

        @r.route("POST", "/cluster/coordinator/resume")
        def cluster_coordinator_resume(req: Request) -> Response:
            self._require_leader(req)
            self.coordinator.resume()
            return Response(self.coordinator.status())

        @r.route("GET", "/cluster/autoscale")
        def cluster_autoscale(req: Request) -> Response:
            """The heat autoscaler's state: enabled or paused, each
            volume's added replicas, the tiered volumes, the totals, the
            move budget, the knobs and the replicated records."""
            self._require_leader(req)
            return Response(self.autoscaler.status())

        @r.route("POST", "/cluster/autoscale/pause")
        def cluster_autoscale_pause(req: Request) -> Response:
            """An operator's hold that outlives the admin lock: no new
            grow, shrink, tier or recall starts until resume."""
            self._require_leader(req)
            self.autoscaler.pause("api")
            return Response(self.autoscaler.status())

        @r.route("POST", "/cluster/autoscale/resume")
        def cluster_autoscale_resume(req: Request) -> Response:
            self._require_leader(req)
            self.autoscaler.resume()
            return Response(self.autoscaler.status())

        @r.route("POST", "/cluster/autoscale/tier")
        def cluster_autoscale_tier(req: Request) -> Response:
            """The shell's volume.tier: tier or recall one volume through
            the autoscaler's own legs, so the move is journaled,
            replicated and recalled when heat returns like its own.  An
            operator's mistake answers 400, a failed leg 502."""
            self._require_leader(req)
            b = req.json() or {}
            try:
                vid = int(b.get("volume_id"))
            except (TypeError, ValueError):
                raise HttpError(400, "volume_id required")
            try:
                out = self.autoscaler.tier_volume(
                    vid, backend=str(b.get("backend") or ""),
                    recall=bool(b.get("recall")))
            except ValueError as e:
                raise HttpError(400, str(e))
            except Exception as e:  # noqa: BLE001 - the leg's own error
                raise HttpError(502, f"{type(e).__name__}: {e}")
            return Response(out)

        @r.route("GET", "/cluster/watch")
        def cluster_watch(req: Request) -> Response:
            """The location long-poll (master_grpc_server.go KeepConnected):
            the events after ?since_seq=, or a snapshot.  On the leader
            only (a follower's topology is empty, so it redirects); the
            answer names the leader, so a client redirected here polls it
            directly next time."""
            self._require_leader(req)
            since = qint(req.query, "since_seq", 0)
            timeout = min(qfloat(req.query, "timeout", 14.0), 55.0)
            doc = self.topo.watch_locations(since, timeout)
            doc["leader"] = self.url
            return Response(doc)

        @r.route("GET", "/cluster/events")
        def cluster_events(req: Request) -> Response:
            """The cluster event journal, filtered: ?type=, ?severity=,
            ?min_severity=, ?server=, ?since=<unix ts>, ?limit=N."""
            if not _local(req):
                self._require_leader(req)
            try:
                since_ts = float(req.query.get("since") or 0.0)
                limit = min(int(req.query.get("limit") or 256), 2048)
            except ValueError as e:
                raise HttpError(400, f"bad query parameter: {e}")
            events = self.event_journal.query(
                type_=req.query.get("type") or None,
                severity=req.query.get("severity") or None,
                min_severity=req.query.get("min_severity") or None,
                server=req.query.get("server") or None,
                since_ts=since_ts, limit=limit)
            return Response({"events": events, "count": len(events),
                             "total": len(self.event_journal),
                             "dropped": self.event_journal.dropped})

        @r.route("POST", "/cluster/events/ingest")
        def cluster_events_ingest(req: Request) -> Response:
            """EventShipper's sink: a follower forwards the batch to the
            leader, so every shipper lands in one cluster journal; the
            answer's ``leader`` teaches the shipper's transport where to
            send the next one."""
            if not self.is_leader:
                return self._proxy_to_leader(req)
            b = req.json()
            accepted = self.event_journal.ingest(
                str(b.get("server") or ""), b.get("events") or [])
            return Response({"accepted": accepted, "leader": self.url})

        @r.route("GET", "/cluster/workload")
        def cluster_workload(req: Request) -> Response:
            """The cluster's workload recording: every server's sampled
            access records, deduped and bounded; ?route=, ?server=,
            ?since=<unix ts>, ?limit=N (1-8192, default 256), with a
            summary by route."""
            self._require_leader(req)
            try:
                since_ts = float(req.query.get("since") or 0.0)
                # clamped both ways: a negative limit would slice [-0:]
                limit = min(max(int(req.query.get("limit") or 256), 1),
                            8192)
            except ValueError as e:
                raise HttpError(400, f"bad query parameter: {e}")
            records = self.workload_journal.query(
                route=req.query.get("route") or None,
                server=req.query.get("server") or None,
                since_ts=since_ts, limit=limit)
            return Response({"records": records, "count": len(records),
                             "total": len(self.workload_journal),
                             "dropped": self.workload_journal.dropped,
                             "summary": summarize_records(records)})

        @r.route("GET", "/cluster/workload/export")
        def cluster_workload_export(req: Request) -> Response:
            """The whole recording document (format-versioned, its losses
            counted, in time order): what the shell's workload.export
            saves; ?route= and ?since= scope it."""
            self._require_leader(req)
            try:
                since_ts = float(req.query.get("since") or 0.0)
            except ValueError as e:
                raise HttpError(400, f"bad query parameter: {e}")
            return Response(self.workload_journal.export(
                route=req.query.get("route") or None, since_ts=since_ts))

        @r.route("POST", "/cluster/workload/ingest")
        def cluster_workload_ingest(req: Request) -> Response:
            """ReqlogShipper's sink: a follower forwards the batch to the
            leader, so every recorder lands in one recording."""
            if not self.is_leader:
                return self._proxy_to_leader(req)
            b = req.json()
            accepted = self.workload_journal.ingest(
                str(b.get("server") or ""), b.get("records") or [])
            return Response({"accepted": accepted, "leader": self.url})

        @r.route("POST", "/cluster/heat/ingest")
        def cluster_heat_ingest(req: Request) -> Response:
            """HeatShipper's sink (a snapshot a server a second): a
            follower forwards it to the leader, so one journal merges the
            cluster and the shift detector sees every peer."""
            if not self.is_leader:
                return self._proxy_to_leader(req)
            b = req.json()
            accepted = self.heat_journal.ingest(
                str(b.get("server") or ""), b.get("snapshots") or [])
            return Response({"accepted": accepted, "leader": self.url})

        @r.route("GET", "/cluster/heat")
        def cluster_heat(req: Request) -> Response:
            """The merged heat view: volume ranks (read, byte, cache-hit
            and error rates, share), the head set, the Zipf fit over the
            merged needle sketch (?top= needles, default 20, at most 256),
            imbalance, each peer's staleness and the recent heat_shift /
            flash_crowd events."""
            self._require_leader(req)
            top = min(qint(req.query, "top", 20), 256)
            return Response(self.heat_journal.to_doc(top_needles=top))

        @r.route("POST", "/cluster/ledger/ingest")
        def cluster_ledger_ingest(req: Request) -> Response:
            """LedgerShipper's sink (a snapshot a server a second), as
            heat's: a follower forwards it to the leader."""
            if not self.is_leader:
                return self._proxy_to_leader(req)
            b = req.json()
            accepted = self.ledger_journal.ingest(
                str(b.get("server") or ""), b.get("snapshots") or [])
            return Response({"accepted": accepted, "leader": self.url})

        @r.route("GET", "/cluster/ledger")
        def cluster_ledger(req: Request) -> Response:
            """The merged resource view: routes, clients and servers by
            CPU share (with queue-wait, byte and cache rates), each
            peer's loop lag, recent loop_stall events and the servers'
            profiler windows: what the shell's cluster.top renders;
            ?top= rows (default 20, at most 256)."""
            self._require_leader(req)
            top = min(qint(req.query, "top", 20), 256)
            return Response(self.ledger_journal.to_doc(top=top))

        @r.route("GET", "/cluster/capacity")
        def cluster_capacity(req: Request) -> Response:
            """The last capacity-probe result parked on this master
            (scenarios/capacity.py through the shell's capacity.probe):
            the rps per route class a declared SLO sustains.  404 until
            a probe has posted; cluster.health hints from it."""
            if self._capacity_doc is None:
                raise HttpError(404, "no capacity probe result; run "
                                     "`weed shell capacity.probe`")
            return Response(self._capacity_doc)

        @r.route("POST", "/cluster/capacity")
        def cluster_capacity_post(req: Request) -> Response:
            doc = req.json()
            if not isinstance(doc, dict) or not doc:
                raise HttpError(400, "capacity document required")
            doc = dict(doc)
            doc.setdefault("posted_at", round(time.time(), 3))
            # one rebind: the last probe wins, and a reader takes the
            # whole document or None
            self._capacity_doc = doc
            return Response({"stored": True}, status=201)

        @r.route("POST", "/cluster/traces/ingest")
        def cluster_traces_ingest(req: Request) -> Response:
            """TraceShipper's sink: spans of sampled traces, stitched by
            trace id; ``lost`` counts spans a shipper already dropped.  A
            follower forwards the batch to the leader."""
            if not self.is_leader:
                return self._proxy_to_leader(req)
            b = req.json()
            accepted = self.trace_collector.ingest(
                str(b.get("server") or ""), b.get("spans") or [],
                lost=b.get("lost") or {})
            return Response({"accepted": accepted, "leader": self.url})

        @r.route("GET", "/cluster/traces")
        def cluster_traces_index(req: Request) -> Response:
            """Most recent first: id, root span, servers, wall seconds."""
            self._require_leader(req)
            limit = min(qint(req.query, "limit", 64), 256)
            return Response(
                {"traces": self.trace_collector.summaries(limit=limit)})

        @r.route("GET", r"/cluster/traces/([0-9a-f]{32})")
        def cluster_trace_get(req: Request) -> Response:
            """One stitched trace with its cross-server analysis (per-hop
            occupancy, network versus server, the bounding hop, a
            degraded verdict over the servers' health counters);
            ?format=chrome answers the Chrome trace-event view."""
            self._require_leader(req)
            trace_id = req.match.group(1)
            if req.query.get("format", "").lower() == "chrome":
                doc = self.trace_collector.chrome(trace_id)
                if doc is None:
                    raise HttpError(404, f"trace {trace_id} not collected")
                return Response(doc)
            doc = self.trace_collector.get(trace_id)
            if doc is None:
                raise HttpError(404, f"trace {trace_id} not collected")
            health: dict = {}
            try:
                self.aggregator.scrape()
                for url, peer in self.aggregator.health()["peers"].items():
                    if url in doc["servers"]:
                        health[url] = peer.get("pipeline_health") or {}
            except Exception:  # noqa: BLE001 - health only garnishes
                pass
            doc["analysis"] = analyze_cluster(doc, health=health)
            return Response(doc)

        register_debug_routes(r)

        @r.route("POST", "/heartbeat")
        def heartbeat(req: Request) -> Response:
            hb = req.json()
            if not self.is_leader:
                # the volume server re-targets the leader
                # (volume_grpc_client_to_master.go leader redirect)
                known = self.raft.leader if self.raft.leader != self.url \
                    else None
                return Response({"leader": known, "not_leader": True})
            return Response(self._heartbeat(hb))

        @r.route("GET", "/vol/grow")
        def vol_grow(req: Request) -> Response:
            self._require_leader(req)
            rp = ReplicaPlacement.parse(req.query.get("replication")
                                        or self.default_replication)
            ttl = TTL.parse(req.query.get("ttl", ""))
            collection = req.query.get("collection", "")
            # one at a time, so a failure mid-batch still reports the
            # volumes that did grow (they are live on the servers)
            grown: list[int] = []
            grow_err = None
            for _ in range(qint(req.query, "count", 1)):
                try:
                    grown += grow_volume(self.topo, collection, rp, ttl,
                                         self._allocate_rpc,
                                         commit_ids=self._commit_volume_ids)
                except HttpError as e:
                    if not grown:
                        raise
                    grow_err = e.message or str(e)
                    break
            result = {"count": len(grown), "volumeIds": grown}
            if grow_err:
                result["error"] = grow_err
            return Response(result)

        @r.route("GET", "/vol/vacuum")
        def vol_vacuum(req: Request) -> Response:
            self._require_leader(req)
            threshold = qfloat(req.query, "garbageThreshold",
                               float(self.garbage_threshold))
            return Response({"compacted": self.vacuum(threshold)})

        @r.route("GET", "/vol/status")
        def vol_status(req: Request) -> Response:
            """volumeStatusHandler: per-node volume inventory keyed
            dc -> rack -> server."""
            self._require_leader(req)
            vols: dict = {}
            with self.topo.lock:
                for dc in self.topo.data_centers.values():
                    d = vols.setdefault(dc.name, {})
                    for rack in dc.racks.values():
                        rk = d.setdefault(rack.name, {})
                        for n in rack.nodes.values():
                            rk[n.url] = n.to_map()["VolumeInfos"]
            return Response({"Version": VERSION, "Volumes": vols})

        @r.route("GET", "/col/delete")
        @r.route("POST", "/col/delete")
        def col_delete(req: Request) -> Response:
            """collectionDeleteHandler: drop every volume and EC shard of
            a collection on its servers, then forget its layouts."""
            self._require_leader(req)
            name = req.query.get("collection", "")
            with self.topo.lock:
                keys = [k for k in self.topo.layouts if k[0] == name]
                vid_nodes = [
                    (vid, [n.url for n in nodes])
                    for k in keys
                    for vid, nodes in self.topo.layouts[k].vid_to_nodes.items()]
                ec_vids = [vid for vid, c in self.topo.ec_collections.items()
                           if c == name]
                ec_holders = [
                    (vid, sid, [n.url for n in nodes])
                    for vid in ec_vids
                    for sid, nodes in
                    (self.topo.ec_shard_locations.get(vid) or {}).items()]
            if not keys and not ec_vids:
                raise HttpError(400, f"collection {name!r} does not exist")
            for vid, urls in vid_nodes:
                for url in urls:
                    http_json("POST", f"http://{url}/admin/delete_volume",
                              {"volume_id": vid}, timeout=30.0)
            for vid, sid, urls in ec_holders:
                for url in urls:
                    http_json("POST", f"http://{url}/admin/ec/delete",
                              {"volume_id": vid, "collection": name,
                               "shard_ids": [sid]}, timeout=30.0)
            with self.topo.lock:
                for k in keys:
                    self.topo.layouts.pop(k, None)
                for vid in ec_vids:
                    self.topo.ec_shard_locations.pop(vid, None)
                    self.topo.ec_collections.pop(vid, None)
            return Response(None, status=204, raw=b"")

        @r.route("POST", "/submit")
        @r.route("PUT", "/submit")
        def submit(req: Request) -> Response:
            """submitFromMasterServerHandler: assign + upload in one call,
            through WeedClient.upload and its reassign-on-readonly loop."""
            self._require_leader(req)
            data, fname, mime = extract_upload(
                req.body, req.headers.get("Content-Type") or "")
            if self._submit_client is None:
                from ..client.operation import WeedClient

                self._submit_client = WeedClient(self.url)
            collection = req.query.get("collection", "")
            # internal: the volume PUT carries ?type=proxied, so the
            # request log counts this write once, as the client's /submit
            fid = self._submit_client.upload(
                data, name=fname, mime=mime, collection=collection,
                replication=req.query.get("replication", ""),
                ttl=req.query.get("ttl", ""), internal=True)
            nodes = self.topo.lookup(int(fid.split(",")[0]), collection)
            public = nodes[0].public_url if nodes else ""
            return Response({"fid": fid, "fileName": fname,
                             "fileUrl": f"{public}/{fid}",
                             "size": len(data)}, status=201)

        @r.route("GET", r"/(\d+),([0-9a-f]+)")
        @r.route("HEAD", r"/(\d+),([0-9a-f]+)")
        def redirect_to_volume(req: Request) -> Response:
            """redirectHandler: a permanent redirect to a holder, with the
            query string kept."""
            vid = int(req.match.group(1))
            nodes = self.topo.lookup(vid, req.query.get("collection", ""))
            if not nodes:
                raise HttpError(404, f"volume id {vid} not found")
            n = self.topo.rng.choice(nodes)
            raw_query = urllib.parse.urlparse(req.handler.path).query
            loc = (f"http://{n.public_url}"
                   f"{urllib.parse.quote(req.path, safe='/,')}")
            if raw_query:
                loc += "?" + raw_query
            return Response(None, status=308, raw=b"",
                            headers={"Location": loc})

        @r.route("POST", "/admin/lease")
        def admin_lease(req: Request) -> Response:
            if not self.is_leader:
                return self._proxy_to_leader(req)
            body = req.json()
            now = time.time()
            prev = body.get("previous_token") or None
            with self.topo.lock:
                expired = now - self._admin_lock_ts > 60
                if self._admin_token is None or expired \
                        or prev == self._admin_token:
                    self._admin_token = secrets.randbits(63)
                    self._admin_lock_ts = now
                    self._admin_client = body.get("client_name", "")
                    return Response({"token": self._admin_token,
                                     "lock_ts_ns": int(now * 1e9)})
            raise HttpError(423, f"already locked by {self._admin_client}")

        @r.route("POST", "/admin/release")
        def admin_release(req: Request) -> Response:
            if not self.is_leader:
                return self._proxy_to_leader(req)
            with self.topo.lock:
                if req.json().get("previous_token") == self._admin_token:
                    self._admin_token = None
            return Response({})
