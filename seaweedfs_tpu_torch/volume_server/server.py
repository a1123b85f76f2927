"""Volume server: object HTTP IO, admin and EC routes, heartbeat loop.

The subset of seaweedfs_tpu/volume_server/server.py (weed/server/
volume_server*.go) that a cluster's EC lifecycle drives: objects are
written, read and deleted at ``/<vid>,<fid>`` with replication fan-out
(topology/store_replicate.go, ``?type=replicate`` loop guard); the admin
"RPCs" are HTTP POSTs named after volume_server.proto: volume assign,
delete, mount, unmount and readonly, Configure (replica placement), the
fsck scan (``/admin/volume_check``), Copy (``/admin/volume_copy``
pulling the source's ``/admin/volume_download``), Leave (the heartbeat
stops), the vacuum set Check, Compact, Commit and Cleanup
(``/admin/vacuum_*``), and the EC set Generate, Rebuild,
Copy, Download, Delete, Mount, Unmount, ShardRead, BlobDelete and
ToVolume.  ``/ec/scrub/start|stop|status`` drive the EC bit-rot scrubber
(scrubber.py), which pauses while the server takes more than 50 requests
a second.  ``GET /metrics`` is the process's Prometheus exposition (the
master's cluster aggregator scrapes it): requests by route, the volume
and EC-shard gauges refreshed from the live store, the shard integrity
counters and the request plane's (``?exemplars=1`` adds sampled requests'
trace ids to their latency buckets).  ``max_inflight`` > 0
(``-maxInflight``) sheds object requests beyond that many in flight with a
fast 503 before their handler runs (utils/admission.py): a shed degraded
GET launches no kernel, while the admin, scrub, status, metrics and debug
routes, a remote holder's ``/admin/ec/shard_read`` among them, are never
shed.  Heartbeats go to the master, full every
FULL_SYNC_EVERY pulses and as deltas between; a scrub's quarantine
reaches the master as the volume's new shard set.  With several
``-mserver`` masters the heartbeats follow the raft leader: a follower's
``not_leader`` answer names it, and an unreachable or leaderless master
moves them to the next one.

EC work runs on ``device``: "cuda" (the default, the reference's
``-ec.engine tpu``) launches the GF(2^8) kernel on the card; "cpu" (the
reference's ``-ec.engine cpu``) runs the plain versions; ``ec_engine``
"mesh" (``-ec.engine mesh``) runs it over the lanes of
``ec_mesh_devices``.  A request's ``engine`` field never moves the work
off the card or onto it: a card server runs "tpu" and "mesh" requests
(each on its own streaming encoder), a CPU server "cpu" ("tpu" too, on
the CPU), and any other answers 400.  ``/status`` carries
``EcKernelLaunches``, the GF(2^8) kernels this process has launched (a
port-only key: a drill reads it to see which server ran a repair), and
the port-only ``GET /debug/ec/kernel`` the same count with the launches
by exact width.

``GET /debug/traces``, ``/debug/traces/analyze`` and ``/debug/events``
serve the process's span ring and event journal, ``/debug/profile`` and
``/debug/pprof/*`` its sampling profiles, threads and heap, and
``/debug/flightrecorder[/<id>|/capture]`` its diagnostic bundles, spooled
under ``directories[0]/flightrecorder`` (utils/debug.py); a
TraceShipper and an EventShipper send the spans of sampled traces and
every journal event to the masters (the one the heartbeats follow
first; utils/leader.py learns the raft leader from their answers), and
are detached when the server stops.

The front is the process's event-loop reactor (utils/httpd.py
``serve``): a GET or HEAD of a needle the needle cache holds, of a live
volume, is answered on the loop itself (``_loop_fast_probe``); everything
else, every EC read and so every kernel launch among them, runs on the
reactor's workers.  ``/status`` carries ``NeedleCache`` (the cache's
occupancy and counters) and ``Dataplane`` (dispatches and aborts).  A
Range GET of an uncompressed, TTL-less needle on a live volume preads only
its bytes (``_try_partial_read``) and answers 206 without an ETag, as the
reference's does; other Range GETs slice the full body.

The framed-TCP plane (tcp.py ``TcpVolumeServer``: W, R, D and the
batched B and P ops) listens on the HTTP port + 20000, wrapping down past
65535 (utils/framing.py ``tcp_port_for``), on the reactor or, under
``WEED_DATAPLANE=threaded``, a thread per connection.  Its W and D fan out
to the volume's other replicas over HTTP.  A port that stays taken for 3 s
leaves the server up without it: a ``degraded_bind`` event and
``SeaweedFS_server_degraded_binds_total{role="volume-tcp"}``, which
``/status`` ``EcPipeline`` and the master's /cluster/health read.
``POST /batch/read`` (a JSON list of fids -> ``status | u32 len | data``
per fid, in order) and ``POST /batch/write`` (the ``pack_fid_frames``
stream -> per-fid results; a torn body answers 400 with nothing written;
each volume's writes go to its replicas as one batch, and a replica's
per-fid failure fails the batch) are the HTTP plane's batches.

``POST /admin/batch_delete`` deletes many fids at once (the filer's chunk
GC calls it), each answered 202 or 404, fanned out to replicas;
``GET /admin/tail`` sends a volume's raw records appended after a time
(the CLI's ``backup`` follows it, storage/volume_backup.py); ``POST
/query`` filters and projects stored JSON, JSON-lines or CSV objects
(query/); ``GET /stats/counter``, ``/stats/memory`` and ``/stats/disk``
are the reference's documents; a GET with ``?width``/``?height`` resizes
an image (images/, passed through without Pillow).  An ``?fsync=true``
write or delete goes through its volume's group-commit worker.

Security (security/, from ``security.toml``): the ``guard``'s write key
makes every PUT/POST and DELETE of an object carry the master's token for
its fid (``Authorization: BEARER`` or ``?jwt=``), and a replica's forward
carries it on; its read key makes every GET and HEAD carry a read token;
its whitelist admits writes, deletes and ``/admin/batch_delete`` from
listed IPs and CIDRs only, and no other route.  ``/admin/batch_delete``
under a write key holds each fid to its own token in the body's
``jwts``; ``/batch/read`` and ``/batch/write`` refuse under a read or
write key (a batch has no token slot).  The framed plane does not start
under either key or under cluster TLS, and admits only whitelisted peers.
``tls_context`` serves HTTPS (mTLS with a CA) on the threaded front.

Tiering (storage/volume.py): ``POST /admin/tier_upload`` (``backend``,
``keep_local``, or ``two_phase`` to stop at the verified upload),
``/admin/tier_commit``, ``/admin/tier_abort`` and ``/admin/tier_download``
move a volume's `.dat` to a backend of ``backends`` (``-tier.backends``)
and back.  A tiered volume is read-only and serves every GET, Range GETs
included, from its remote object: the needle cache and the loop's fast
path never hold it, and ``/admin/configure_replication`` answers 409.
``use_mmap`` maps every `.dat` (``-mmap``).

``dataplane="native"`` (``volume -dataplane native``; "python", the
default, is the plane above) starts the C++ data plane (dataplane.py,
csrc/dataplane.cpp) on the framed port in place of ``TcpVolumeServer``:
it serves W, R and D frames from its own threads (a W or D of a volume
replicated beyond 000 is refused: a frame would skip the fan-out), and
the store funnels every HTTP needle op of the volumes it holds through it
(store.py).  Under a whitelist it binds no port (engine-only: HTTP needle
IO still goes through it); under a write or read key or cluster TLS it
does not start, as the Python plane does not.  A port that stays taken
for 3 s is a degraded bind, as the Python plane's, and the plane then
runs engine-only.  While it is attached the needle cache and the loop's
fast path are off and a Range GET slices the full read.  ``/status``
carries ``NativeDataPlane`` (its port, the W, R and D frames it served,
and each volume's size, live files, deleted bytes and fsync passes), ``/metrics`` the same as
``SeaweedFS_volumeServer_native_plane{volume,stat}``.  The plane builds
at the server's start and a failed build raises; it stops at ``stop()``.
``/admin/assign_volume`` takes ``offset_5`` (a volume past 32 GB, which
the plane never takes).

Telemetry (observability/): ``heat`` (on by default; ``-heat.off``) keeps
a HeatAccumulator (heat.py, ``heat_halflife_s``, ``heat_topk`` needles)
fed by the router at every object route, by the framed plane at every
needle op (``TcpVolumeServer(heat=)``), by the batch routes per fid and by
the needle cache's hit and admission callbacks; GET /debug/heat serves
its snapshot, and a HeatShipper sends one to the masters each second.
``ledger`` (on by default; ``-ledger.off``) keeps a RequestLedger
(ledger.py, ``ledger_halflife_s``) settled by the router and by
``serve_frame``, fed the needle cache's hits and misses, the reactor's
loop-lag stats and stalls (``stall_hook``, unhooked at stop) and a
WindowedProfiler's windows; GET /debug/ledger serves its snapshot, and a
LedgerShipper sends one each second.  ``/status`` carries ``Heat`` and
``Ledger`` (occupancy, shipped, dropped).  The process's request log
(reqlog.py, off until ``-reqlog.sample`` or POST /debug/reqlog/start)
records both planes; a ReqlogShipper sends its records to the masters'
/cluster/workload.  The C++ plane (``dataplane="native"``) serves its
frames with no Python, so they reach none of the three, as in the
reference.
"""

from __future__ import annotations

import json
import logging
import os
import re
import resource
import sys
import threading
import time
import urllib.parse
from typing import Optional

import numpy as np

from ..ec.ec_volume import NeedleNotFoundError
from ..ec.integrity import EciSidecar, note_corruption, verify_shard_file
from ..ec.layout import TOTAL_SHARDS_COUNT, to_ext
from ..images import resized_from_query
from ..observability import context as _trace_context
from ..observability import get_tracer
from ..observability.collector import TraceShipper
from ..observability.events import EventShipper, get_journal
from ..observability.flightrecorder import get_flightrecorder
from ..observability.heat import HeatAccumulator, HeatShipper
from ..observability.ledger import LedgerShipper, RequestLedger
from ..observability.profiler import WindowedProfiler
from ..observability.reqlog import ReqlogShipper, get_recorder
from ..ops import _build
from ..ops.gf_matmul import gf_matmul, width_classes
from ..query import execute_query
from ..security import Guard, JwtError, decode_jwt, get_jwt
from ..stats import (REGISTRY, dataplane_metrics, degraded_bind_metrics,
                     ec_integrity_metrics, heat_metrics, ledger_metrics,
                     needle_cache_metrics, request_plane_metrics,
                     volume_server_metrics)
from ..stats.metrics import exemplars_requested
from ..storage.file_id import FileId
from ..storage.backend import configure_backends
from ..storage.needle import (
    FLAG_HAS_LAST_MODIFIED,
    FLAG_HAS_MIME,
    FLAG_HAS_NAME,
    FLAG_HAS_TTL,
    FLAG_IS_COMPRESSED,
    Needle,
)
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from ..storage.volume import (
    CookieMismatchError,
    DeletedError,
    NotFoundError,
    volume_file_prefix,
)
from ..storage.volume_backup import records_since
from ..utils import eventloop
from ..utils.compression import ungzip_data
from ..utils.admission import maybe_controller
from ..utils.debug import register_debug_routes
from ..utils.httpd import (
    UNSATISFIABLE_RANGE,
    HttpError,
    Request,
    Response,
    Router,
    extract_upload,
    http_bytes,
    http_download,
    http_json,
    parse_range,
    qint,
    serve,
    stop_server,
)
from ..utils.framing import (U32, note_degraded_bind, pack_fid_frames,
                             tcp_port_for, unpack_fid_frames)
from ..utils.ioutil import pread_padded
from .scrubber import EcScrubber
from .store import Store
from .tcp import TcpVolumeServer

FID_PATTERN = r"/(\d+),([0-9a-f]+)"
# the loop fast path's probe: a plain object path, no query
_FAST_FID_RE = re.compile(r"^/(\d+),([0-9a-f]+)$", re.IGNORECASE)
# delta heartbeats between full syncs: every Nth pulse resends the whole
# state so drifting stats (sizes, counters) converge
FULL_SYNC_EVERY = 12
VERSION = "seaweedfs-tpu 0.1"
# the reference's EC pipeline health under its names: the port has no
# parity worker processes and no CPU fallback, so these never rise.
# /status carries them beside degraded_binds, and each admin EC call
# their change.
_EC_CALL_HEALTH = {"worker_restarts": 0, "engine_fallbacks": 0}


# how long a framed plane retries its derived port: a server that just
# stopped may still hold it
BIND_RETRY_S = 3.0


def _bind_with_retry(factory, role: str, server: str):
    """``factory()`` -> a started framed server, made again until it binds
    or BIND_RETRY_S pass; one that never bound is returned not ``alive``,
    its degraded bind noted (utils/framing.py ``note_degraded_bind``)."""
    deadline = time.monotonic() + BIND_RETRY_S
    srv = factory()
    while not srv.alive and time.monotonic() < deadline:
        time.sleep(0.15)
        srv = factory()
    if not srv.alive:
        note_degraded_bind(role, server, srv.port)
    return srv


class VolumeServer:
    def __init__(self, directories: list[str], master_url: str,
                 host: str = "127.0.0.1", port: int = 8080,
                 public_url: str = "", data_center: str = "",
                 rack: str = "", max_volume_count: int = 8,
                 pulse_seconds: float = 5.0, device="cuda",
                 max_inflight: int = 0, needle_cache_mb: int = 64,
                 guard: Optional[Guard] = None,
                 backends: Optional[dict] = None, tls_context=None,
                 use_mmap: bool = False, dataplane: str = "python",
                 ec_engine: str = "", ec_mesh_devices=None,
                 heat: bool = True, heat_halflife_s: float = 30.0,
                 heat_topk: int = 512, ledger: bool = True,
                 ledger_halflife_s: float = 60.0):
        """A volume server for ``directories`` at host:port, heartbeating
        to ``master_url`` (comma-separated masters; heartbeats follow the
        raft leader).  ``device`` runs the EC work: "cuda" needs a card
        and raises without one; only "cpu" selects the plain versions.
        ``max_inflight`` > 0 turns admission control on;
        ``needle_cache_mb`` sizes the needle cache (0: none).  ``guard``
        holds the whitelist and keys (none: an open server);
        ``backends`` registers tier backends ({name: {"type": "dir",
        "root": ...}}) before any volume opens; ``tls_context`` serves
        HTTPS; ``use_mmap`` maps each `.dat`; ``dataplane`` "native"
        serves needle IO through the C++ plane.  ``ec_engine`` "mesh" runs
        EC over the lanes of ``ec_mesh_devices`` (Store); empty is the
        device's own engine, "tpu" on a card and "cpu" on the CPU.
        ``heat`` and ``ledger`` turn the two accounting feeds on (their
        half-lives in seconds, ``heat_topk`` the needle sketch's size)."""
        if dataplane not in ("python", "native"):
            raise ValueError(f"dataplane {dataplane!r} is not python or "
                             "native")
        self.dataplane = dataplane
        self._native_plane = None
        if backends:
            configure_backends(backends)
        self.guard = guard or Guard()
        self._tls_context = tls_context
        self.masters = [m.strip() for m in master_url.split(",")
                        if m.strip()]
        self.master_url = self.masters[0]
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self.store = Store(directories, host, port, public_url,
                           max_volume_count, device=device,
                           needle_cache_mb=needle_cache_mb,
                           use_mmap=use_mmap, ec_engine=ec_engine,
                           ec_mesh_devices=ec_mesh_devices)
        if directories:
            get_flightrecorder().configure(
                spool_dir=os.path.join(directories[0], "flightrecorder"))
        self.engine = self.store.ec_engine
        self.metrics = volume_server_metrics()
        self.metrics.max_volume_counter.set(max_volume_count)
        # their families exist on /metrics before the first count
        ec_integrity_metrics()
        request_plane_metrics()
        dataplane_metrics()
        needle_cache_metrics()
        degraded_bind_metrics()
        self._tcp_server = None
        self.router = Router("volume", metrics=self.metrics)
        self.router.server_url = self.url
        self.router.admission = maybe_controller(max_inflight, "volume")
        self.router.loop_fast_probe = self._loop_fast_probe
        self._register_routes()
        self._server = None
        self._stop = threading.Event()
        # vid -> (replica urls, expiry); see _lookup_replicas
        self._vid_lock = threading.Lock()
        self._vid_cache: dict[int, tuple[list, float]] = {}
        self.vid_cache_ttl = 10.0
        # EC intervals this server lacked: served by a holder's
        # /admin/ec/shard_read ("remote") or rebuilt here
        # ("reconstructed"); the CLI prints both when it stops
        self._ec_reads_lock = threading.Lock()
        self.ec_reads = {"remote": 0, "reconstructed": 0}
        # idle until /ec/scrub/start (or the shell's ec.scrub)
        self.scrubber = EcScrubber(self.store, busy_fn=self._scrub_busy)
        self._req_lock = threading.Lock()
        self._req_sample = (0, time.monotonic())
        self._req_busy = False
        # sampled spans and journal events go to the masters through the
        # shippers' leader-following transport, the master the heartbeats
        # follow first; the hooks chain, so several servers in one
        # process each ship and the master dedups
        self._trace_shipper = TraceShipper(
            get_tracer(), server=self.url,
            master_url_fn=self._master_candidates)
        self._event_shipper = EventShipper(
            get_journal(), server=self.url,
            master_url_fn=self._master_candidates)
        # the process's request log ships to /cluster/workload; it is off
        # until recording starts, and the shipper stands ready
        self._reqlog_shipper = ReqlogShipper(
            get_recorder(), server=self.url,
            master_url_fn=self._master_candidates)
        # heat, one accumulator a server (co-located servers must not pool
        # it); off leaves router.heat and tcp.heat None
        heat_metrics()
        self.heat = HeatAccumulator(server=self.url,
                                    half_life=heat_halflife_s,
                                    top_k=heat_topk, enabled=heat)
        self._heat_shipper = HeatShipper(
            self.heat, server=self.url,
            master_url_fn=self._master_candidates) if heat else None
        cache = self.store.needle_cache
        if heat:
            cache.on_hit = self.heat.note_cache_hit
            cache.on_admit = self.heat.note_cache_admit
        # the resource ledger and its profiler; off leaves router.ledger
        # and the framed plane's ledger None
        ledger_metrics()
        self.ledger = RequestLedger(
            server=self.url, half_life=ledger_halflife_s) \
            if ledger else None
        self._ledger_shipper = LedgerShipper(
            self.ledger, server=self.url,
            master_url_fn=self._master_candidates) if ledger else None
        self._profiler = WindowedProfiler() if ledger else None
        if self.ledger is not None:
            self.ledger.profile_fn = self._profiler.summary
            # one hit slot, both fed: heat per volume, the ledger per
            # request
            heat_hit = cache.on_hit
            if heat_hit is None:
                cache.on_hit = RequestLedger.note_cache_hit
            else:
                def on_hit(vid, key, nbytes, _heat_hit=heat_hit):
                    _heat_hit(vid, key, nbytes)
                    RequestLedger.note_cache_hit(vid, key, nbytes)
                cache.on_hit = on_hit
            cache.on_miss = RequestLedger.note_cache_miss
        self.router.heat = self.heat if heat else None
        self.router.ledger = self.ledger

    @property
    def url(self) -> str:
        return f"{self.store.ip}:{self.store.port}"

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "VolumeServer":
        g = self.guard
        # a frame has no token slot and the plane no TLS: it must not open
        # a side door on a secured server
        framed = (not g.signing_key and not g.read_signing_key
                  and self._tls_context is None)
        native = framed and self.dataplane == "native"
        if native:
            from .dataplane import NativeDataPlane

            # built before anything serves: a failed build raises here
            _build.load("dataplane")
        self._trace_shipper.attach()
        self._event_shipper.attach()
        self._server = serve(self.router, self.store.ip, self.store.port,
                             tls_context=self._tls_context)
        if native:
            # no whitelist slot in the plane: under one it binds no port
            # and takes no W or D frame
            self.store.native_tcp_writes_ok = not g.white_list
            plane = NativeDataPlane(self.store.ip, -1) if g.white_list \
                else _bind_with_retry(
                    lambda: NativeDataPlane(self.store.ip,
                                            tcp_port_for(self.store.port)),
                    role="volume-native", server=self.url)
            if not plane.alive:  # a degraded bind: HTTP IO still native
                plane = NativeDataPlane(self.store.ip, -1)
            self._native_plane = plane
            self.store.attach_native_plane(plane)
        elif framed:
            self._tcp_server = _bind_with_retry(
                lambda: TcpVolumeServer(
                    self.store, self.store.ip,
                    whitelist_ok=(g.check_white_list if g.is_write_active
                                  else None),
                    replicate_write=self._tcp_replicate_write,
                    replicate_delete=self._tcp_replicate_delete,
                    heat=self.heat if self.heat.enabled else None).start(),
                role="volume-tcp", server=self.url)
            # serve_frame reads it off the FramedServer (either front)
            self._tcp_server.ledger = self.ledger
        if self.ledger is not None:
            # loop-lag stats ride each snapshot, and the watchdog's stalls
            # go through the ledger (it names the route)
            if eventloop.reactor_enabled():
                reactor = eventloop.get_reactor()
                self.ledger.loop_stats_fn = reactor.loop_lag_stats
                reactor.stall_hook = self.ledger.note_stall
            self._profiler.start()
        self._reqlog_shipper.attach()
        if self._heat_shipper is not None:
            self._heat_shipper.attach()
        if self._ledger_shipper is not None:
            self._ledger_shipper.attach()
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name=f"heartbeat:{self.url}").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._reqlog_shipper.detach()
        if self._heat_shipper is not None:
            self._heat_shipper.detach()
        if self._ledger_shipper is not None:
            self._ledger_shipper.detach()
        if self._profiler is not None:
            self._profiler.stop()
        if self.ledger is not None and eventloop.reactor_enabled():
            # the process's reactor outlives this server: unhook it
            reactor = eventloop.get_reactor()
            if reactor.stall_hook == self.ledger.note_stall:
                reactor.stall_hook = None
            if self.ledger.loop_stats_fn == reactor.loop_lag_stats:
                self.ledger.loop_stats_fn = None
        self.scrubber.stop(join_timeout=0.5)
        if self._tcp_server is not None:
            self._tcp_server.stop()
        if self._server is not None:
            stop_server(self._server)
        if self._native_plane is not None:
            # every volume back on the Python engine first: a handler
            # past has() meets a stopped plane, answers DP_NO_VOLUME and
            # falls back to a reloaded volume
            self.store.detach_native_plane()
            self._native_plane.stop()
            self._native_plane = None
        self._trace_shipper.detach()
        self._event_shipper.detach()
        self.store.close()

    def _master_candidates(self) -> str:
        """Every ``-mserver`` master, comma-separated, the one the
        heartbeats follow first: the shippers' candidate list."""
        current = self.master_url
        return ",".join([current] + [m for m in self.masters
                                     if m != current])

    def _rotate_master(self) -> None:
        if len(self.masters) > 1:
            i = (self.masters.index(self.master_url) + 1) \
                if self.master_url in self.masters else 0
            self.master_url = self.masters[i % len(self.masters)]

    def _heartbeat_loop(self) -> None:
        """Full state on the first pulse, every FULL_SYNC_EVERY after and
        whenever the master asks for a resync; small delta heartbeats in
        between (volume_grpc_client_to_master.go:48-120).  A master that
        cannot be reached is retried every pulse; the server serves its
        local volumes meanwhile."""
        pulse = 0
        while not self._stop.is_set():
            delta = None
            try:
                # a volume deleted while the payload is built must not
                # end the thread: that would unregister the whole server
                if pulse % FULL_SYNC_EVERY == 0:
                    payload = self.heartbeat_payload()
                else:
                    delta = self.store.pop_heartbeat_delta()
                    payload = {"ip": self.store.ip, "port": self.store.port,
                               "public_url": self.store.public_url,
                               "delta": True, **(delta or {})}
            except Exception:  # noqa: BLE001 - retried next pulse
                logging.getLogger(__name__).exception("heartbeat payload")
                self._stop.wait(self.pulse_seconds)
                continue
            # the events journaled before this state was read reach the
            # master first: a rot's shard_corrupt lands before the
            # heartbeat that shows its quarantine, so the coordinator's
            # repair of it names its cause.  The flush and the heartbeat
            # share one deadline: a silent master costs one timeout a
            # pulse, as in the reference's loop
            budget = max(3.0, self.pulse_seconds * 2)
            deadline = time.monotonic() + budget
            self._event_shipper.flush(timeout=budget)
            try:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise HttpError(504, "the event flush spent the "
                                         "heartbeat's deadline")
                resp = http_json("POST", f"http://{self.master_url}/heartbeat",
                                 payload, timeout=left)
            except (HttpError, ValueError):  # unreachable, or not JSON
                if delta:
                    self.store.requeue_heartbeat_delta(delta)
                self._rotate_master()
                pulse = 0
                self._stop.wait(self.pulse_seconds)
                continue
            if resp.get("not_leader"):
                if delta:
                    self.store.requeue_heartbeat_delta(delta)
                leader = resp.get("leader")
                pulse = 0
                if leader and leader != self.master_url:
                    # follower redirect: re-target now, opening with a
                    # full sync (the new leader may be fresh)
                    self.master_url = leader
                    continue
                self._rotate_master()  # leaderless: wait out the pulse
                self._stop.wait(self.pulse_seconds)
                continue
            if resp.get("resync"):
                # the master does not know us (it restarted): full sync now
                if delta:
                    self.store.requeue_heartbeat_delta(delta)
                pulse = 0
                continue
            self.store.volume_size_limit = int(
                resp.get("volumeSizeLimit", self.store.volume_size_limit))
            pulse += 1
            self._stop.wait(self.pulse_seconds)

    def heartbeat_payload(self) -> dict:
        hb = self.store.collect_heartbeat()
        hb["data_center"] = self.data_center
        hb["rack"] = self.rack
        return hb

    def heartbeat_now(self) -> None:
        resp = http_json("POST", f"http://{self.master_url}/heartbeat",
                         self.heartbeat_payload(), timeout=30.0)
        if resp.get("not_leader") and resp.get("leader"):
            self.master_url = resp["leader"]
            http_json("POST", f"http://{self.master_url}/heartbeat",
                      self.heartbeat_payload(), timeout=30.0)

    # --- helpers ----------------------------------------------------------
    def _loop_fast_probe(self, method: str, path: str) -> bool:
        """May the reactor answer this GET/HEAD on its loop?  True only for
        a plain object path (no query) whose needle the cache holds, of a
        volume mounted live here and not tiered: the answer then comes
        from memory (a raced invalidation costs one bounded pread).  An EC
        volume's needle is never cached, so no EC read and no kernel
        launch runs on the loop; a tiered volume's reads go to its remote
        object.  Never blocks: a regex, a parse, three dict lookups.  The
        native plane reads every needle it holds: with it attached,
        nothing is answered on the loop."""
        m = _FAST_FID_RE.match(path)
        if m is None:
            return False
        cache = self.store.needle_cache
        if not cache.enabled or self.store.native_plane is not None:
            return False
        try:
            fid = FileId.parse(f"{m.group(1)},{m.group(2)}")
        except ValueError:
            return False
        v = self.store.volumes.get(fid.volume_id)
        return v is not None and not v.tiered \
            and cache.contains(fid.volume_id, fid.key)

    def _try_partial_read(self, req: Request, fid: FileId,
                          rng_hdr: str):
        """A Range GET answered by preading only the range's bytes
        (``read_needle_meta`` / ``read_needle_data``): no whole-needle read
        and no CRC pass.  None sends the request down the full read
        (compressed or TTL'd needles, empty bodies, malformed ranges, and
        a volume the native plane holds: the Python map is stale, so the
        full read goes through the plane and is sliced)."""
        plane = self.store.native_plane
        if plane is not None and plane.has(fid.volume_id):
            return None
        v = self.store.volumes[fid.volume_id]
        try:
            loc, data_size, flags, name, mime = v.read_needle_meta(
                fid.key, fid.cookie)
        except (NotFoundError, DeletedError):
            raise HttpError(404, "not found")
        except CookieMismatchError:
            raise HttpError(404, "cookie mismatch")
        except ValueError:
            return None
        if flags & (FLAG_IS_COMPRESSED | FLAG_HAS_TTL) or data_size == 0:
            return None  # the full body is needed: gunzip, expiry check
        rng = parse_range(rng_hdr, data_size)
        if rng == UNSATISFIABLE_RANGE:
            return Response(raw=b"", status=416, headers={
                "Content-Range": f"bytes */{data_size}"})
        if rng is None:
            return None
        off, sz = rng
        headers = {
            "Accept-Ranges": "bytes",
            "Content-Range": f"bytes {off}-{off + sz - 1}/{data_size}",
            "Content-Type": (mime.decode(errors="replace")
                             if flags & FLAG_HAS_MIME and mime
                             else "application/octet-stream"),
        }
        if name:
            headers["Content-Disposition"] = \
                f'inline; filename="{name.decode(errors="replace")}"'
        body = b"" if req.handler.command == "HEAD" \
            else v.read_needle_data(loc, off, sz)
        return Response(raw=body, status=206, headers=headers)

    def _tier_volume(self, vid: int):
        try:
            return self.store.get_volume(vid)
        except KeyError:
            raise HttpError(404, f"volume {vid} not found")

    def _tier_moved(self, vid: int) -> None:
        """After a tier route: the volume's cached needles dropped (its
        reads now go where its `.dat` is) and its read-only state queued
        for the next heartbeat."""
        self.store.needle_cache.invalidate_volume(vid, "tier")
        self.store.note_volume_change(vid)

    def _scrub_busy(self) -> bool:
        """The scrubber's load gate: True while this server takes more
        than 50 requests a second, over windows of at least 0.5 s (the
        scrubber asks before every 256 KiB block)."""
        with self._req_lock:
            prev_total, prev_t = self._req_sample
            now = time.monotonic()
            dt = now - prev_t
            if dt < 0.5:
                return self._req_busy
            total = self.router.requests
            self._req_sample = (total, now)
            self._req_busy = (total - prev_total) / dt > 50.0
            return self._req_busy

    def _tcp_replicate_write(self, fid_str: str, data: bytes) -> None:
        """The framed plane's replica fan-out, over HTTP with the
        ``type=replicate`` loop guard (topology/store_replicate.go)."""
        vid = int(fid_str.split(",")[0])
        for url in self._lookup_replicas(vid):
            if url == self.url:
                continue
            status, _, _ = http_bytes(
                "POST", f"http://{url}/{fid_str}?type=replicate", data,
                timeout=60.0)
            if status not in (200, 201):
                raise OSError(f"replication to {url} failed: {status}")

    def _tcp_replicate_delete(self, fid_str: str) -> None:
        vid = int(fid_str.split(",")[0])
        for url in self._lookup_replicas(vid):
            if url == self.url:
                continue
            http_bytes("DELETE", f"http://{url}/{fid_str}?type=replicate",
                       timeout=60.0)

    def _lookup_replicas(self, vid: int) -> list[str]:
        """Replica locations with a short TTL cache
        (operation/lookup_vid_cache.go; shorter than the reference's 10
        minutes because membership moves with heartbeat pulses).  Without
        it every replicated write pays a master round trip."""
        now = time.monotonic()
        with self._vid_lock:
            hit = self._vid_cache.get(vid)
        if hit is not None and hit[1] > now:
            return hit[0]
        try:
            # the master round trip runs outside the lock: a slow master
            # must not stall every replicated write behind one lookup
            r = http_json(
                "GET", f"http://{self.master_url}/dir/lookup?volumeId={vid}",
                timeout=30.0)
            locs = [loc["url"] for loc in r.get("locations", [])]
        except HttpError:
            return []
        with self._vid_lock:
            self._vid_cache[vid] = (locs, now + self.vid_cache_ttl)
            if len(self._vid_cache) > 10_000:  # bound growth on churn
                self._vid_cache = {k: v for k, v in self._vid_cache.items()
                                   if v[1] > now}
        return locs

    def _verify_copied_shards(self, vid: int, collection: str,
                              base: str, shard_ids: list[int]) -> None:
        """/admin/ec/copy: check every fetched shard's blocks against the
        `.eci` that came with it before the copy is acknowledged.  A
        mismatching shard is deleted with the other shards this copy
        brought and the copy answers 502, so the caller retries from
        another holder.  No sidecar, or no row for a shard: the copy
        stands unverified."""
        sc = EciSidecar.load(base)
        if sc is None:
            return
        bad: list[int] = []
        for sid in shard_ids:
            path = base + to_ext(sid)
            if not os.path.exists(path):
                continue
            try:
                blocks = verify_shard_file(sc, path, sid)
            except OSError:
                continue  # unreadable local disk: not wire corruption
            if blocks:
                note_corruption("wire", sid, base, block=blocks[0])
                bad.append(sid)
        if bad:
            # shards this server already served before the request stay:
            # their overwritten bytes just verified clean
            ev = self.store.ec_volumes.get(vid)
            mounted = set(ev.shards) if ev is not None else set()
            self.store.ec_delete_shards(
                vid, [s for s in shard_ids if s in bad or s not in mounted],
                collection)
            raise HttpError(
                502, f"shards {bad} of volume {vid} failed .eci "
                     f"sidecar verification after copy; rejected")

    def _shard_read_url(self, url: str, vid: int, shard_id: int,
                        offset: int, length: int) -> str:
        return (f"http://{url}/admin/ec/shard_read?volume_id={vid}"
                f"&shard={shard_id}&offset={offset}&size={length}")

    def _fetch_remote_shard(self, vid: int, shard_id: int, offset: int,
                            length: int) -> bytes:
        """store_ec.go:188-218: the interval from a server that holds the
        shard, else reconstructed from any data_shards distinct shards,
        local or remote, through this server's codec on its device.  With
        no answer from the master the local survivors rebuild it, verified
        against the `.eci`; either rebuild is counted."""
        try:
            r = http_json(
                "GET",
                f"http://{self.master_url}/dir/lookup_ec?volumeId={vid}",
                timeout=30.0)
        except HttpError:
            ev = self.store.ec_volumes.get(vid)
            if ev is None:
                raise
            data = ev.reconstruct_interval(shard_id, offset, length,
                                           self.store.rs())
            self._count_ec_read("reconstructed")
            return data
        holders = r.get("shards", {})
        for url in holders.get(str(shard_id), []):
            if url == self.url:
                continue
            status, body, _ = http_bytes(
                "GET", self._shard_read_url(url, vid, shard_id, offset,
                                            length), timeout=60.0)
            if status == 200:
                self._count_ec_read("remote")
                return body
        rs = self.store.rs()
        bufs: list = [None] * TOTAL_SHARDS_COUNT
        have = 0
        ev = self.store.ec_volumes.get(vid)
        for sid in range(TOTAL_SHARDS_COUNT):
            if have >= rs.data_shards:
                break
            if ev is not None and sid in ev.shards:
                bufs[sid] = pread_padded(ev.shards[sid]._f, length, offset)
                have += 1
                continue
            for url in holders.get(str(sid), []):
                if url == self.url:
                    continue
                status, body, _ = http_bytes(
                    "GET", self._shard_read_url(url, vid, sid, offset,
                                                length), timeout=60.0)
                if status == 200:
                    arr = np.zeros(length, dtype=np.uint8)
                    arr[: len(body)] = np.frombuffer(body, dtype=np.uint8)
                    bufs[sid] = arr
                    have += 1
                    break
        if have < rs.data_shards:
            raise HttpError(404, f"cannot recover shard {shard_id} of {vid}")
        self._count_ec_read("reconstructed")
        rs.reconstruct(bufs)
        return bufs[shard_id].tobytes()

    def _count_ec_read(self, how: str) -> None:
        with self._ec_reads_lock:
            self.ec_reads[how] += 1

    def _check_engine(self, body: dict) -> Optional[str]:
        """An EC request may name the reference's engines: absent is this
        server's own, "tpu" its device; "mesh" only on a card (the
        per-card dispatch queues over the store's mesh lanes); "cpu" only
        where the server itself runs on the CPU.  Anything else answers
        400 and runs nothing.  Returns the engine the request runs."""
        engine = body.get("engine")
        if engine in (None, ""):
            return None
        if engine in ("tpu", self.engine) or (
                engine == "mesh" and self.store.device.type == "cuda"):
            return engine
        raise HttpError(400, f"engine {engine!r} is not served here: this "
                             f"server runs -ec.engine {self.engine} on "
                             f"{self.store.device}")

    def _replicate(self, fid_path: str, qs: str, method: str, vid: int,
                   data=None, headers=None) -> None:
        """Fan a write or delete out to the volume's other replicas."""
        for url in self._lookup_replicas(vid):
            if url == self.url:
                continue
            status, _, _ = http_bytes(
                method, "http://%s%s?%s" % (
                    url, urllib.parse.quote(fid_path, safe="/,"), qs),
                data, headers=headers, timeout=60.0)
            if method != "DELETE" and status not in (200, 201):
                raise HttpError(500, f"replication to {url} failed: {status}")

    # --- routes -----------------------------------------------------------
    def _register_routes(self) -> None:
        r = self.router
        register_debug_routes(r)

        @r.route("GET", FID_PATTERN)
        @r.route("HEAD", FID_PATTERN)
        def read_object(req: Request) -> Response:
            fid = FileId.parse(f"{req.match.group(1)},{req.match.group(2)}")
            err = self.guard.check_read_jwt(
                req, f"{req.match.group(1)},{req.match.group(2)}")
            if err:
                raise HttpError(401, err)
            vid = fid.volume_id
            wants_resize = bool(req.query.get("width")
                                or req.query.get("height"))
            rng_hdr = req.headers.get("Range", "")
            if rng_hdr and not wants_resize and vid in self.store.volumes:
                partial = self._try_partial_read(req, fid, rng_hdr)
                if partial is not None:
                    return partial
            if vid in self.store.volumes:
                try:
                    n = self.store.read_needle(vid, fid.key, fid.cookie)
                except (NotFoundError, DeletedError):
                    raise HttpError(404, "not found")
                except CookieMismatchError:
                    raise HttpError(404, "cookie mismatch")
            else:
                # the volume found stays open for the whole read; a
                # scrub's quarantine swaps it whole, never leaving it absent
                with self.store.ec_volume_held(vid) as ev:
                    if ev is not None:
                        try:
                            blob, size = self.store.read_ec_needle(
                                vid, fid.key, self._fetch_remote_shard)
                        except NeedleNotFoundError:
                            raise HttpError(404, "not found")
                        n = Needle.from_bytes(blob, size, ev.version)
                if ev is None:
                    others = [u for u in self._lookup_replicas(vid)
                              if u != self.url]
                    if not others:
                        raise HttpError(404, f"volume {vid} not found")
                    return Response(None, status=302, raw=b"", headers={
                        "Location": "http://%s%s" % (
                            others[0],
                            urllib.parse.quote(req.path, safe="/,"))})
                if n.cookie != fid.cookie:
                    raise HttpError(404, "cookie mismatch")
            etag = f'"{n.etag()}"'
            # a resized answer is another entity: its tag is checked after
            # the resize
            if not wants_resize and req.headers.get("If-None-Match") == etag:
                return Response(None, status=304, raw=b"")
            headers = {"ETag": etag, "Accept-Ranges": "bytes"}
            if n.has(FLAG_HAS_NAME) and n.name:
                headers["Content-Disposition"] = \
                    'inline; filename="%s"' % n.name.decode(errors="replace")
            headers["Content-Type"] = (
                n.mime.decode(errors="replace")
                if n.has(FLAG_HAS_MIME) and n.mime
                else "application/octet-stream")
            body = n.data
            # gzip-stored needles go out as they are to a client that
            # accepts gzip, decompressed to any other
            # (volume_server_handlers_read.go:122-137)
            if n.is_compressed:
                if "gzip" in req.headers.get("Accept-Encoding", ""):
                    headers["Content-Encoding"] = "gzip"
                else:
                    body = ungzip_data(body)
            # ?width / ?height resize an image on the fly (images/), the
            # bytes passed through when Pillow is absent or it is no image
            if wants_resize:
                orig_body = body
                body, headers["Content-Type"] = resized_from_query(
                    body, headers["Content-Type"], req.query)
                if body is not orig_body:
                    # a resized answer must not share the original's tag
                    etag = '"%s-%sx%s-%s"' % (
                        n.etag(), req.query.get("width", ""),
                        req.query.get("height", ""),
                        req.query.get("mode", ""))
                    headers["ETag"] = etag
                if req.headers.get("If-None-Match") == etag:
                    return Response(None, status=304, raw=b"")
            if rng_hdr and "Content-Encoding" not in headers:
                rng = parse_range(rng_hdr, len(body))
                if rng == UNSATISFIABLE_RANGE:
                    return Response(raw=b"", status=416, headers={
                        "Content-Range": f"bytes */{len(body)}"})
                if rng is not None:
                    off, sz = rng
                    headers["Content-Range"] = \
                        f"bytes {off}-{off + sz - 1}/{len(body)}"
                    return Response(raw=body[off:off + sz], status=206,
                                    headers=headers)
            return Response(raw=body, headers=headers)

        @r.route("POST", "/batch/read")
        def batch_read(req: Request) -> Response:
            """Batched GET: ``{"fids": [...]}`` (at most 10,000) ->
            ``status(1, 0=ok) | u32 len | payload`` per fid, in order; a
            gzip-stored needle comes back ungzipped, a failed fid's
            payload is its error's text.  Refused under a read key."""
            if self.guard.read_signing_key:
                raise HttpError(401, "batch read unavailable with "
                                     "read JWTs configured")
            fids = req.json().get("fids", [])
            if not isinstance(fids, list) or len(fids) > 10000:
                raise HttpError(400, "fids must be a list of <= 10000")
            heat = self.router.heat
            out = []
            for fid_str in fids:
                try:
                    fid = FileId.parse(str(fid_str))
                    n = self.store.read_needle(fid.volume_id, fid.key,
                                               fid.cookie)
                    data = ungzip_data(n.data) if n.is_compressed \
                        else n.data
                    out.append(b"\x00" + U32.pack(len(data)))
                    out.append(data)
                    if heat is not None:
                        # /batch/* never matches the router's fid regex
                        heat.note_read(fid.volume_id, len(data),
                                       fid=str(fid_str))
                except Exception as e:  # noqa: BLE001 - a per-fid answer
                    msg = f"{type(e).__name__}: {e}".encode()[:4096]
                    out.append(b"\x01" + U32.pack(len(msg)) + msg)
            return Response(raw=b"".join(out), headers={
                "X-Batch-Count": str(len(fids))})

        @r.route("POST", "/batch/write")
        def batch_write(req: Request) -> Response:
            """Batched PUT: the ``pack_fid_frames`` stream -> per-fid
            results.  The whole body is unpacked before the store is
            touched, so a torn one answers 400 with nothing written.  Each
            volume's writes then go to its replicas as one batch; a
            replica's failed fid fails the batch.  Refused under a write
            key."""
            if not self.guard.white_list_ok(req):
                raise HttpError(401, "not in whitelist")
            if self.guard.signing_key:
                raise HttpError(401, "batch write unavailable with "
                                     "write JWTs configured")
            try:
                items = unpack_fid_frames(req.body, with_data=True)
            except ValueError as e:
                raise HttpError(400, str(e))
            heat = self.router.heat
            results = []
            by_vid: dict[int, list[tuple[str, bytes]]] = {}
            for fid_str, data in items:
                try:
                    fid = FileId.parse(fid_str)
                    n = Needle(cookie=fid.cookie, id=fid.key, data=data)
                    n.set_flag(FLAG_HAS_LAST_MODIFIED)
                    n.last_modified = int(time.time())
                    self.store.write_needle(fid.volume_id, n)
                    results.append({"fid": fid_str, "status": 201,
                                    "size": len(data)})
                    if heat is not None:
                        heat.note_write(fid.volume_id, len(data))
                    if req.query.get("type") != "replicate":
                        by_vid.setdefault(fid.volume_id, []).append(
                            (fid_str, data))
                except Exception as e:  # noqa: BLE001 - a per-fid answer
                    results.append({"fid": fid_str, "status": 500,
                                    "error": f"{type(e).__name__}: {e}"})
            for vid, vitems in by_vid.items():
                for url in self._lookup_replicas(vid):
                    if url == self.url:
                        continue
                    status, rbody, _ = http_bytes(
                        "POST", f"http://{url}/batch/write?type=replicate",
                        pack_fid_frames(vitems, with_data=True),
                        timeout=60.0)
                    if status != 200:
                        raise HttpError(
                            500, f"batch replication to {url} failed: "
                                 f"{status}")
                    # the replica answers 200 even when fids failed there:
                    # a diverged replica fails the batch
                    try:
                        rres = json.loads(rbody).get("results", [])
                    except Exception:  # noqa: BLE001 - counted as missing
                        rres = []
                    bad = [x for x in rres if x.get("status") != 201]
                    if bad or len(rres) != len(vitems):
                        raise HttpError(
                            500, f"batch replication to {url}: "
                                 f"{len(bad) or 'missing'} item(s) "
                                 f"failed on the replica")
            return Response({"results": results})

        @r.route("POST", FID_PATTERN)
        @r.route("PUT", FID_PATTERN)
        def write_object(req: Request) -> Response:
            if not self.guard.white_list_ok(req):
                raise HttpError(401, "not in whitelist")
            err = self.guard.check_write_jwt(
                req, f"{req.match.group(1)},{req.match.group(2)}")
            if err:
                raise HttpError(401, err)
            try:
                fid = FileId.parse(
                    f"{req.match.group(1)},{req.match.group(2)}")
            except ValueError as e:
                raise HttpError(400, str(e))
            # form uploads arrive multipart-wrapped; POST unwraps the file
            # part, PUT bodies are raw (needle_parse_upload.go:46-50)
            if req.handler.command == "POST":
                data, part_name, part_mime = extract_upload(
                    req.body, req.headers.get("Content-Type") or "")
            else:
                data, part_name, part_mime = req.body, "", ""
            n = Needle(cookie=fid.cookie, id=fid.key, data=data)
            if req.headers.get("Content-Encoding") == "gzip":
                n.set_flag(FLAG_IS_COMPRESSED)  # the client gzipped it
            name = (req.query.get("name") or req.headers.get("X-File-Name")
                    or part_name)
            if name:
                n.set_flag(FLAG_HAS_NAME)
                n.name = name.encode()[:255]
            mime = req.headers.get("Content-Type")
            if mime and mime.lower().startswith("multipart/form-data"):
                mime = part_mime or None
            if mime == "application/x-www-form-urlencoded":  # client default
                mime = None
            if mime and mime != "application/octet-stream":
                n.set_flag(FLAG_HAS_MIME)
                n.mime = mime.encode()[:255]
            # every upload is stamped (needle.go:89-92): ec.encode's
            # quietFor guard and TTL expiry read it
            n.set_flag(FLAG_HAS_LAST_MODIFIED)
            n.last_modified = qint(req.query, "ts", int(time.time()))
            if req.query.get("ttl"):
                ttl = TTL.parse(req.query["ttl"])
                if ttl.count:
                    n.set_flag(FLAG_HAS_TTL)
                    n.ttl = ttl
            try:
                self.store.write_needle(
                    fid.volume_id, n, fsync=req.query.get("fsync") == "true")
            except KeyError:
                raise HttpError(404, f"volume {fid.volume_id} not found")
            except PermissionError as e:
                raise HttpError(409, str(e))
            if req.query.get("type") != "replicate":
                # replicas store byte-identical needles: forward the
                # original parameters, the name and the timestamp
                params = {k: v for k, v in req.query.items() if k != "type"}
                params["type"] = "replicate"
                if name and "name" not in params:
                    params["name"] = name
                params.setdefault("ts", str(n.last_modified))
                # the fid's token goes on, so the replicas' guards pass
                token = get_jwt(req.headers, req.query)
                if token:
                    params["jwt"] = token
                headers = {"Content-Type": mime or ""}
                if req.headers.get("Content-Encoding"):
                    headers["Content-Encoding"] = \
                        req.headers["Content-Encoding"]
                self._replicate(req.path, urllib.parse.urlencode(params),
                                "POST", fid.volume_id, data, headers)
            return Response({"name": name or "", "size": len(n.data),
                             "eTag": n.etag()}, status=201)

        @r.route("DELETE", FID_PATTERN)
        def delete_object(req: Request) -> Response:
            if not self.guard.white_list_ok(req):
                raise HttpError(401, "not in whitelist")
            # a delete is a mutation: the fid's write token, as a write
            err = self.guard.check_write_jwt(
                req, f"{req.match.group(1)},{req.match.group(2)}")
            if err:
                raise HttpError(401, err)
            fid = FileId.parse(f"{req.match.group(1)},{req.match.group(2)}")
            vid = fid.volume_id
            if vid in self.store.ec_volumes:
                self.store.ec_delete_needle(vid, fid.key)
                size = 0
            else:
                try:
                    size = self.store.delete_needle(
                        vid, Needle(cookie=fid.cookie, id=fid.key),
                        fsync=req.query.get("fsync") == "true")
                except KeyError:
                    raise HttpError(404, f"volume {vid} not found")
            if req.query.get("type") != "replicate":
                token = get_jwt(req.headers, req.query)
                self._replicate(req.path, "type=replicate" + (
                    f"&jwt={token}" if token else ""), "DELETE", vid)
            return Response({"size": size})

        @r.route("POST", "/admin/leave")
        def leave(req: Request) -> Response:
            """volume.server.leave: stop heartbeating so the master's
            janitor unregisters this node; data and the HTTP surface stay
            up until the process exits (VolumeServerLeave RPC)."""
            self._stop.set()
            return Response({"left": True})

        @r.route("POST", "/admin/heartbeat_now")
        def heartbeat_now(req: Request) -> Response:
            self.heartbeat_now()
            return Response({})

        @r.route("GET", "/status")
        def status(req: Request) -> Response:
            scrub = self.scrubber.status()
            doc = {
                "Version": VERSION,
                "Volumes": [self.store.volume_info(v)
                            for v in list(self.store.volumes.values())],
                "EcVolumes": sorted(self.store.ec_volumes),
                "Master": self.master_url,
                "DataCenter": self.data_center,
                "Rack": self.rack,
                "EcPipeline": {**_EC_CALL_HEALTH,
                               **degraded_bind_metrics().totals()},
                "EcIntegrity": ec_integrity_metrics().totals(),
                "EcKernelLaunches": gf_matmul.launches,
                "EcKernelWidths": width_classes(gf_matmul.widths),
                "NeedleCache": self.store.needle_cache.status(),
                "Dataplane": dataplane_metrics().totals(),
                "Heat": {
                    **self.heat.status(),
                    "shipped": self._heat_shipper.shipped
                    if self._heat_shipper is not None else 0,
                    "dropped": self._heat_shipper.dropped
                    if self._heat_shipper is not None else 0,
                },
                "EcScrub": {
                    "running": scrub["running"],
                    "passes": scrub["passes"],
                    "cursor": scrub["cursor"],
                    "verdicts": {v: d.get("status", "?")
                                 for v, d in scrub["verdicts"].items()},
                },
            }
            if self.ledger is not None:
                doc["Ledger"] = {
                    **self.ledger.status(),
                    "shipped": self._ledger_shipper.shipped,
                    "dropped": self._ledger_shipper.dropped,
                }
            plane = self.store.native_plane
            if plane is not None:
                doc["NativeDataPlane"] = {
                    "tcp_port": plane.port, "frames": plane.frames(),
                    "volumes": {
                        vid: {"size": ds, "file_count": fc,
                              "deleted_bytes": db, "fsync_passes": sp}
                        for vid, (ds, fc, _mk, db, sp)
                        in plane.stats_all().items()}}
            return Response(doc)

        @r.route("GET", "/debug/heat")
        def debug_heat(req: Request) -> Response:
            """This server's heat snapshot (?top= needles, default 64, at
            most 1024), its accumulator's status and its shipper's
            counts: the per-peer view /cluster/heat merges."""
            try:
                top = int(req.query.get("top", "64"))
            except (TypeError, ValueError):
                top = 64
            doc = self.heat.snapshot(top_k=max(0, min(top, 1024)))
            doc["status"] = self.heat.status()
            if self._heat_shipper is not None:
                doc["shipper"] = {
                    "shipped": self._heat_shipper.shipped,
                    "dropped": self._heat_shipper.dropped,
                    "interval_s": self._heat_shipper.interval}
            return Response(doc)

        @r.route("GET", "/debug/ec/kernel")
        def debug_ec_kernel(req: Request) -> Response:
            """The GF(2^8) kernel's launches in this process, in all and
            by exact launch width (a port-only route: /status
            ``EcKernelWidths`` gives the width classes alone)."""
            widths = dict(gf_matmul.widths)
            return Response({"launches": gf_matmul.launches,
                             "widths": {str(w): n for w, n in
                                        sorted(widths.items())}})

        @r.route("GET", "/debug/ledger")
        def debug_ledger(req: Request) -> Response:
            """This server's ledger snapshot: CPU, byte and queue-wait
            rates by route class and client, the loop's lag, the
            profiler's windows; 404 with the ledger off."""
            if self.ledger is None:
                return Response({"error": "ledger disabled"}, status=404)
            doc = self.ledger.snapshot()
            doc["shipper"] = {
                "shipped": self._ledger_shipper.shipped,
                "dropped": self._ledger_shipper.dropped,
                "interval_s": self._ledger_shipper.interval}
            return Response(doc)

        @r.route("GET", "/metrics")
        def metrics(req: Request) -> Response:
            # the volume and EC-shard gauges from the live store
            m = self.metrics
            m.volume_counter.clear()
            m.disk_size_gauge.clear()
            for v in list(self.store.volumes.values()):
                m.volume_counter.add(v.collection, "volume", 1)
                m.disk_size_gauge.add(v.collection, "volume",
                                      self.store.volume_info(v)["size"])
            for vid, ev in list(self.store.ec_volumes.items()):
                m.volume_counter.add(self.store.ec_collections.get(vid, ""),
                                     "ec_shards", len(ev.shards))
            m.native_plane_gauge.clear()
            plane = self.store.native_plane
            if plane is not None:
                for vid, (ds, fc, _mk, db, sp) in plane.stats_all().items():
                    for stat, value in (("size_bytes", ds),
                                        ("live_files", fc),
                                        ("deleted_bytes", db),
                                        ("fsync_passes", sp)):
                        m.native_plane_gauge.set(str(vid), stat, value)
            return Response(
                raw=REGISTRY.expose(
                    exemplars=exemplars_requested(req)).encode(),
                headers={"Content-Type":
                         "text/plain; version=0.0.4; charset=utf-8"})

        @r.route("GET", "/stats/counter")
        def stats_counter(req: Request) -> Response:
            """statsCounterHandler (common.go:228): requests by route, from
            the counter /metrics exposes."""
            counters = {labels[0] if labels else "": int(v) for labels, v
                        in self.metrics.request_counter.snapshot().items()}
            return Response({"Version": VERSION, "Counters": counters})

        @r.route("GET", "/stats/memory")
        def stats_memory(req: Request) -> Response:
            ru = resource.getrusage(resource.RUSAGE_SELF)
            # ru_maxrss is KiB on Linux, bytes on macOS
            rss_kb = (ru.ru_maxrss // 1024 if sys.platform == "darwin"
                      else ru.ru_maxrss)
            return Response({"Version": VERSION,
                             "Memory": {"MaxRssKb": rss_kb,
                                        "UserSeconds": ru.ru_utime,
                                        "SystemSeconds": ru.ru_stime}})

        @r.route("GET", "/stats/disk")
        def stats_disk(req: Request) -> Response:
            """statsDiskHandler: statvfs of each data directory."""
            ds = []
            for d in self.store.directories:
                st = os.statvfs(d)
                total = st.f_frsize * st.f_blocks
                free = st.f_frsize * st.f_bavail
                ds.append({"dir": os.path.abspath(d), "all": total,
                           "free": free, "used": total - free,
                           "percent_free": round(100.0 * free /
                                                 max(total, 1), 2)})
            return Response({"Version": VERSION, "DiskStatuses": ds})

        @r.route("POST", "/query")
        def query(req: Request) -> Response:
            """Query (volume_grpc_query.go): filter and project stored
            JSON, JSON-lines or CSV objects here; the body names
            from_file_ids, selections, filter and input_format."""
            b = req.json()
            rows = []
            for fid_str in b.get("from_file_ids", []):
                fid = FileId.parse(fid_str)
                try:
                    n = self.store.read_needle(fid.volume_id, fid.key,
                                               fid.cookie)
                except Exception as e:  # noqa: BLE001 - the fid's 404
                    raise HttpError(404, f"{fid_str}: {e}")
                rows.extend(execute_query(
                    n.data, b.get("selections"), b.get("filter"),
                    b.get("input_format", "json")))
            return Response({"rows": rows})

        # --- admin: volume lifecycle ---------------------------------
        @r.route("POST", "/admin/assign_volume")
        def assign_volume(req: Request) -> Response:
            b = req.json()
            self.store.add_volume(int(b["volume_id"]), b.get("collection", ""),
                                  b.get("replication", "000"),
                                  b.get("ttl", ""),
                                  offset_5=bool(b.get("offset_5", False)))
            return Response({})

        @r.route("POST", "/admin/delete_volume")
        def delete_volume(req: Request) -> Response:
            self.store.delete_volume(int(req.json()["volume_id"]))
            return Response({})

        @r.route("POST", "/admin/mount")
        def mount(req: Request) -> Response:
            self.store.mount_volume(int(req.json()["volume_id"]))
            return Response({})

        @r.route("POST", "/admin/unmount")
        def unmount(req: Request) -> Response:
            self.store.unmount_volume(int(req.json()["volume_id"]))
            return Response({})

        @r.route("POST", "/admin/readonly")
        def readonly(req: Request) -> Response:
            b = req.json()
            vid = int(b["volume_id"])
            self.store.get_volume(vid).read_only = bool(
                b.get("readonly", True))
            # the writable set must reach the master within one pulse
            self.store.note_volume_change(vid)
            # the plane takes the flag (nothing while a hold is out: its
            # release does)
            self.store.native_refresh(vid)
            return Response({})

        @r.route("POST", "/admin/configure_replication")
        def configure_replication(req: Request) -> Response:
            """VolumeConfigure (volume_grpc_admin.go): rewrite the
            superblock's replica placement in place."""
            b = req.json()
            vid = int(b["volume_id"])
            try:
                v = self.store.get_volume(vid)
            except KeyError:
                raise HttpError(404, f"volume {vid} not found")
            ReplicaPlacement.parse(b["replication"])
            if v.tiered:
                raise HttpError(
                    409, f"volume {vid} is tiered (read-only); "
                    "tier.download before reconfiguring")
            rp = self.store.configure_replication(vid, b["replication"])
            self.heartbeat_now()
            return Response({"replication": str(rp)})

        @r.route("POST", "/admin/volume_check")
        def volume_check(req: Request) -> Response:
            """fsck backend: scan the volume, verify needle CRCs against the
            index (volume.fsck / volume.check.disk analog)."""
            return Response(self.store.check_volume(
                int(req.json()["volume_id"])))

        @r.route("POST", "/admin/batch_delete")
        def batch_delete(req: Request) -> Response:
            """Delete many fids (volume_grpc_batch_delete.go): each answers
            202 with the size freed, or 404 with its error; an EC volume's
            needle is deleted in its `.ecx`/`.ecj`.  Unless the request is
            itself a replica's, the fids go on to the volumes' other
            replicas in one request each.  Under a write key each fid must
            carry its own token in the body's ``jwts`` ({fid: token}), as a
            single DELETE must: a fid without one answers 401; the tokens
            go on to the replicas."""
            if not self.guard.white_list_ok(req):
                raise HttpError(401, "not in whitelist")
            body = req.json()
            jwts = body.get("jwts", {})
            results = []
            fanned: dict[str, list[str]] = {}
            for fid_str in body.get("fids", []):
                if self.guard.signing_key:
                    try:
                        claims = decode_jwt(self.guard.signing_key,
                                            jwts.get(fid_str, ""))
                        if claims.get("fid") != fid_str:
                            raise JwtError("fid mismatch")
                    except JwtError as e:
                        results.append({"fid": fid_str, "error": str(e),
                                        "status": 401})
                        continue
                try:
                    fid = FileId.parse(fid_str)
                    if fid.volume_id in self.store.ec_volumes:
                        self.store.ec_delete_needle(fid.volume_id, fid.key)
                        size = 0
                    elif fid.volume_id not in self.store.volumes:
                        # the reference's answer: the bare volume id
                        raise KeyError(fid.volume_id)
                    else:
                        size = self.store.delete_needle(
                            fid.volume_id,
                            Needle(cookie=fid.cookie, id=fid.key))
                    results.append({"fid": fid_str, "status": 202,
                                    "size": size})
                    if not body.get("replicate"):
                        for url in self._lookup_replicas(fid.volume_id):
                            if url != self.url:
                                fanned.setdefault(url, []).append(fid_str)
                except Exception as e:  # noqa: BLE001 - a per-fid answer
                    results.append({"fid": fid_str, "status": 404,
                                    "error": str(e)})
            for url, fids in fanned.items():
                http_json("POST", f"http://{url}/admin/batch_delete",
                          {"fids": fids, "replicate": True,
                           "jwts": {f: jwts[f] for f in fids if f in jwts}},
                          timeout=30.0)
            return Response({"results": results})

        @r.route("GET", "/admin/tail")
        def tail(req: Request) -> Response:
            """VolumeIncrementalCopy (volume_backup.go:66): the raw records
            appended after ?since_ns, at most ?max_bytes (64 MiB), with
            the last one's append time in X-Last-Append-At-Ns; a follower
            asks again from it until the body comes back empty."""
            vid = qint(req.query, "volume_id")
            since_ns = qint(req.query, "since_ns", 0)
            try:
                v = self.store.get_volume(vid)
            except KeyError:
                raise HttpError(404, f"volume {vid} not found")
            blob, last_ts = records_since(
                v, since_ns, max_bytes=qint(req.query, "max_bytes", 64 << 20))
            return Response(raw=blob, headers={
                "X-Last-Append-At-Ns": str(last_ts),
                "X-Volume-Version": str(int(v.version))})

        # --- admin: tiering (volume_grpc_tier_*.go) ---------------------
        @r.route("POST", "/admin/tier_upload")
        def tier_upload(req: Request) -> Response:
            """VolumeTierMoveDatToRemote: the one-shot move (``keep_local``
            keeps the `.dat`, writes frozen), or with ``two_phase`` the
            verified upload alone, manifest ``pending``, for a control
            plane that commits with /admin/tier_commit."""
            b = req.json()
            vid = int(b["volume_id"])
            self._tier_volume(vid)
            # the plane lets go of the `.dat` while it moves, and takes it
            # back only if it is still local (keep_local, two_phase)
            with self.store.native_quiesced(vid), \
                    self.store.volume_locks[vid]:
                v = self._tier_volume(vid)
                if bool(b.get("two_phase")):
                    out = {"manifest": v.tier_upload_begin(b["backend"])}
                else:
                    out = {"remote": v.tier_upload(
                        b["backend"], keep_local=bool(b.get("keep_local")))}
            self._tier_moved(vid)
            return Response(out)

        @r.route("POST", "/admin/tier_commit")
        def tier_commit(req: Request) -> Response:
            """Phase 2 of the two-phase move: ``committed``, the `.vif`,
            the local `.dat` dropped, reopened tiered.  Idempotent; 404
            when no manifest is pending, 409 when it is not committable."""
            vid = int(req.json()["volume_id"])
            self._tier_volume(vid)
            try:
                with self.store.native_quiesced(vid), \
                        self.store.volume_locks[vid]:
                    manifest = self._tier_volume(vid).tier_commit()
            except FileNotFoundError as e:
                raise HttpError(404, str(e))
            except PermissionError as e:
                raise HttpError(409, str(e))
            self._tier_moved(vid)
            return Response({"manifest": manifest})

        @r.route("POST", "/admin/tier_abort")
        def tier_abort(req: Request) -> Response:
            """Roll back an uncommitted two-phase upload: the remote object
            deleted, the manifest dropped, writes thawed."""
            vid = int(req.json()["volume_id"])
            self._tier_volume(vid)
            try:
                with self.store.native_quiesced(vid), \
                        self.store.volume_locks[vid]:
                    self._tier_volume(vid).tier_abort()
            except PermissionError as e:
                raise HttpError(409, str(e))
            self._tier_moved(vid)
            return Response({})

        @r.route("POST", "/admin/tier_download")
        def tier_download(req: Request) -> Response:
            """VolumeTierMoveDatFromRemote: the verified recall."""
            vid = int(req.json()["volume_id"])
            self._tier_volume(vid)
            # the release registers the recalled volume with the plane
            with self.store.native_quiesced(vid), \
                    self.store.volume_locks[vid]:
                self._tier_volume(vid).tier_download()
            self._tier_moved(vid)
            return Response({})

        # --- admin: volume copy/move (volume_grpc_copy.go) -----------
        @r.route("GET", "/admin/volume_download")
        def volume_download(req: Request) -> Response:
            vid = qint(req.query, "volume_id")
            ext = req.query["ext"]
            if ext not in (".dat", ".idx", ".vif"):
                raise HttpError(400, f"bad ext {ext}")
            path = self.store.get_volume(vid).file_prefix + ext
            if not os.path.exists(path):
                raise HttpError(404, f"{path} not found")
            # streamed from the file (the CopyFile streaming RPC): a 30 GB
            # .dat never lands in memory.  The source is read-only during
            # a copy, so no lock is held across the transfer.
            return Response(file_path=path)

        @r.route("POST", "/admin/volume_copy")
        def volume_copy(req: Request) -> Response:
            """VolumeCopy: pull .dat/.idx from the source server, then mount.
            The source is marked readonly for a consistent snapshot, then
            given back the read-only state it had."""
            b = req.json()
            vid = int(b["volume_id"])
            collection = b.get("collection", "")
            source = b["source_data_node"]
            if vid in self.store.volumes:
                raise HttpError(409, f"volume {vid} already here")
            src_status = http_json("GET", f"http://{source}/status",
                                   timeout=30.0)
            was_readonly = any(v["id"] == vid and v["read_only"]
                               for v in src_status.get("Volumes", []))
            http_json("POST", f"http://{source}/admin/readonly",
                      {"volume_id": vid, "readonly": True}, timeout=30.0)
            try:
                base = volume_file_prefix(self.store.directories[0],
                                          collection, vid)
                for ext in (".dat", ".idx"):
                    status = http_download(
                        "GET", f"http://{source}/admin/volume_download"
                               f"?volume_id={vid}&ext={ext}",
                        base + ext, timeout=3600)
                    if status != 200:
                        raise HttpError(500, f"download {ext}: {status}")
                self.store.open_copied_volume(collection, vid)
            finally:
                http_json("POST", f"http://{source}/admin/readonly",
                          {"volume_id": vid, "readonly": was_readonly},
                          timeout=30.0)
            return Response({})

        # --- admin: vacuum -------------------------------------------
        @r.route("POST", "/admin/vacuum_check")
        def vacuum_check(req: Request) -> Response:
            vid = int(req.json()["volume_id"])
            v = self.store.get_volume(vid)
            plane = self.store.native_plane
            st = plane.stat(vid) if plane is not None and plane.has(vid) \
                else None
            if st is not None:
                # the Python map's counters are frozen while the plane
                # holds the volume: the plane's own know
                dat_size, _, _, deleted_bytes, _ = st
                return Response({"garbage_ratio": deleted_bytes / dat_size
                                 if dat_size else 0.0})
            return Response({"garbage_ratio": v.garbage_ratio()})

        @r.route("POST", "/admin/vacuum_compact")
        def vacuum_compact(req: Request) -> Response:
            self.store.vacuum_compact(int(req.json()["volume_id"]))
            return Response({})

        @r.route("POST", "/admin/vacuum_commit")
        def vacuum_commit(req: Request) -> Response:
            self.store.vacuum_commit(int(req.json()["volume_id"]))
            return Response({})

        @r.route("POST", "/admin/vacuum_cleanup")
        def vacuum_cleanup(req: Request) -> Response:
            self.store.vacuum_cleanup(int(req.json()["volume_id"]))
            return Response({})

        # --- admin: EC -----------------------------------------------
        @r.route("POST", "/admin/ec/generate")
        def ec_generate(req: Request) -> Response:
            b = req.json()
            engine = self._check_engine(b)
            self.store.ec_generate(int(b["volume_id"]), engine=engine)
            return Response({"pipeline": dict(_EC_CALL_HEALTH)})

        @r.route("POST", "/admin/ec/rebuild")
        def ec_rebuild(req: Request) -> Response:
            b = req.json()
            engine = self._check_engine(b)
            rebuilt = self.store.ec_rebuild(int(b["volume_id"]),
                                            b.get("collection", ""),
                                            engine=engine)
            return Response({"rebuilt_shard_ids": rebuilt,
                             "pipeline": dict(_EC_CALL_HEALTH)})

        # --- EC bit-rot scrubber (scrubber.py) -------------------------
        @r.route("POST", "/ec/scrub/start")
        def ec_scrub_start(req: Request) -> Response:
            """Launch the scan (or retune a running one).  Body knobs:
            rate_mb_s (0 unthrottled), interval_s (0: one pass), backfill,
            volume_id (a targeted one-pass scan of that volume, which
            adopts this request's trace context: a coordinator's
            re-scrub journals under its repair)."""
            try:
                b = req.json()
            except ValueError:  # not JSON: the defaults
                b = {}
            vid = b.get("volume_id")
            try:
                vid = int(vid) if vid is not None else None
            except (TypeError, ValueError):
                raise HttpError(400, f"bad volume_id {vid!r}")
            ctx = _trace_context.fork_for_thread() if vid is not None \
                else None
            started = self.scrubber.start(
                rate_mb_s=(float(b["rate_mb_s"])
                           if "rate_mb_s" in b else None),
                interval_s=(float(b["interval_s"])
                            if "interval_s" in b else None),
                backfill=(bool(b["backfill"]) if "backfill" in b else None),
                volume_id=vid, ctx=ctx)
            return Response({"started": started, **self.scrubber.status()})

        @r.route("POST", "/ec/scrub/stop")
        def ec_scrub_stop(req: Request) -> Response:
            """Stop the scan; the cursor survives for the next start."""
            self.scrubber.stop()
            return Response(self.scrubber.status())

        @r.route("GET", "/ec/scrub/status")
        def ec_scrub_status(req: Request) -> Response:
            return Response(self.scrubber.status())

        @r.route("POST", "/admin/ec/copy")
        def ec_copy(req: Request) -> Response:
            """VolumeEcShardsCopy: pull shard files (and the `.ecx`, `.ecj`
            and `.eci` that go with them) from the source server, each
            shard verified against the `.eci` before anything mounts it."""
            b = req.json()
            vid = int(b["volume_id"])
            collection = b.get("collection", "")
            source = b["source_data_node"]
            base = volume_file_prefix(self.store.directories[0], collection,
                                      vid)
            shard_ids = [int(s) for s in b.get("shard_ids", [])]
            exts = [to_ext(s) for s in shard_ids]
            if b.get("copy_ecx_file", True):
                exts.append(".ecx")
            if b.get("copy_ecj_file", True):
                exts.append(".ecj")
            exts.append(".eci")  # absent on a volume without a sidecar
            for ext in exts:
                status = http_download(
                    "GET", f"http://{source}/admin/ec/download?volume_id={vid}"
                           f"&collection={collection}&ext={ext}",
                    base + ext, timeout=3600)
                if status != 200 and ext not in (".ecj", ".eci"):
                    raise HttpError(500, f"copy {ext} from {source}: {status}")
            self._verify_copied_shards(vid, collection, base, shard_ids)
            return Response({})

        @r.route("GET", "/admin/ec/download")
        def ec_download(req: Request) -> Response:
            vid = qint(req.query, "volume_id")
            ext = req.query.get("ext", "")
            if ext not in {to_ext(i) for i in range(TOTAL_SHARDS_COUNT)} \
                    | {".ecx", ".ecj", ".eci"}:
                raise HttpError(400, f"bad ext {ext!r}")
            path = self.store._ec_base(vid, req.query.get("collection", "")) \
                + ext
            if not os.path.exists(path):
                raise HttpError(404, f"{path} not found")
            # streamed from the file (VolumeEcShardRead streaming,
            # volume_grpc_erasure_coding.go:284-350)
            return Response(file_path=path)

        @r.route("POST", "/admin/ec/delete")
        def ec_delete(req: Request) -> Response:
            b = req.json()
            self.store.ec_delete_shards(
                int(b["volume_id"]), [int(s) for s in b.get("shard_ids", [])],
                b.get("collection", ""))
            return Response({})

        @r.route("POST", "/admin/ec/mount")
        def ec_mount(req: Request) -> Response:
            b = req.json()
            self.store.ec_mount(int(b["volume_id"]), b.get("collection", ""))
            return Response({})

        @r.route("POST", "/admin/ec/unmount")
        def ec_unmount(req: Request) -> Response:
            self.store.ec_unmount(int(req.json()["volume_id"]))
            return Response({})

        @r.route("GET", "/admin/ec/shard_read")
        def ec_shard_read(req: Request) -> Response:
            try:
                data = self.store.ec_shard_read(
                    qint(req.query, "volume_id"), qint(req.query, "shard"),
                    qint(req.query, "offset"), qint(req.query, "size"))
            except NeedleNotFoundError as e:
                raise HttpError(404, str(e))
            return Response(raw=data)

        @r.route("POST", "/admin/ec/blob_delete")
        def ec_blob_delete(req: Request) -> Response:
            b = req.json()
            self.store.ec_delete_needle(int(b["volume_id"]), int(b["key"]))
            return Response({})

        @r.route("POST", "/admin/ec/to_volume")
        def ec_to_volume(req: Request) -> Response:
            b = req.json()
            self.store.ec_to_volume(int(b["volume_id"]),
                                    b.get("collection", ""))
            return Response({})
