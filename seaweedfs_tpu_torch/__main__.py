"""Command line: ``python -m seaweedfs_tpu_torch <subcommand>``.

The ``weed`` subcommands master, volume, shell, compact, backup, fix,
export, upload, download and benchmark (weed.py) with the flags this port
serves:

    python -m seaweedfs_tpu_torch master -port 9333 -volumeSizeLimitMB 30000 \\
        -coordinatorSeconds 15 -metricsAggregationSeconds 5
    python -m seaweedfs_tpu_torch master -port 9333 -mdir /m1 \\
        -peers 127.0.0.1:9334,127.0.0.1:9335
    python -m seaweedfs_tpu_torch volume -dir /data -port 8080 \\
        -mserver 127.0.0.1:9333,127.0.0.1:9334,127.0.0.1:9335 -ec.engine tpu
    python -m seaweedfs_tpu_torch shell -master 127.0.0.1:9333 \\
        -c "ec.encode -volumeId 3; ec.rebuild -volumeId 3"
    python -m seaweedfs_tpu_torch compact -dir /data -collection c -volumeId 3
    python -m seaweedfs_tpu_torch backup -master 127.0.0.1:9333 \
        -volumeId 3 -dir /backup
    python -m seaweedfs_tpu_torch fix -dir /backup -volumeId 3
    python -m seaweedfs_tpu_torch export -dir /data -volumeId 3 -o v3.tar
    python -m seaweedfs_tpu_torch upload -master 127.0.0.1:9333 \
        -dir photos -include '*.jpg' -ttl 1d
    python -m seaweedfs_tpu_torch download -master 127.0.0.1:9333 \
        -o out.bin 3,01637037d6
    python -m seaweedfs_tpu_torch benchmark -master 127.0.0.1:9333 \
        -n 100000 -size 1024 -c 16

``-ec.engine tpu`` (the default) runs EC on the CUDA card: the server
builds its kernel before it listens and fails without a card;
``-ec.engine mesh`` sends whole encode dispatches round-robin over the
cards ``-ec.mesh.devices`` names (the reference's vocabulary: '' or 'all',
a count 'N', or indices 'i,j'; '0,' is card 0 alone) and needs a card
too, a bad spec failing at start; ``-ec.engine cpu`` runs the plain
PyTorch versions.  ``master
-coordinatorSeconds N`` repairs EC volumes that lack shards on its own,
every N seconds (0, the default, leaves repair to the shell's
ec.rebuild), logs each repair on standard error and journals it;
``-metricsAggregationSeconds N`` scrapes the volume servers every N
seconds, so it finds a dead one sooner than the heartbeat timeout.
``master -peers a,b -mdir DIR`` runs one master of a raft quorum with
the other masters at ``a`` and ``b``, its log and state under ``DIR``
(restarted on the same ``DIR`` it recovers them); start each master with
the others as its peers, and give volume servers all of them in
``-mserver``.
``-maxInflight N`` on ``master`` or ``volume`` sheds requests beyond N in
flight with a fast 503 and ``Retry-After`` (0, the default, is off; the
operator, debug and control-plane routes are never shed).  The volume
server's start line ends with its front (``front reactor`` or
``threaded``).  The servers run until SIGINT or SIGTERM, a signal taken
during start-up included, then stop and exit 0; the volume server's last line counts the GF
kernels it launched and the EC intervals it lacked, fetched from a
holder or reconstructed, and the master's the fault hits it injected
by point, when there were any.  ``shell -c`` takes the admin lock, runs the
``;``-separated commands, prints what each returns and unlocks; without
``-c`` it reads commands from standard input.  ``compact`` vacuums one
volume offline (no server may hold it) and prints its size before and
after.  The master vacuums volumes with 30% garbage or more every 900 s,
as the reference's does; neither knob is a flag there, so none is here.
``backup`` follows a volume's server (found through the master) by
``/admin/tail`` into a follower volume under ``-dir``, so a second run
applies only the records appended since, deletes included; ``fix``
rebuilds a volume's ``.idx`` from its ``.dat``, keeping the old one when
the ``.dat`` is malformed; ``export`` lists a volume's live needles, or
with ``-o`` writes them to a tar; ``upload`` assigns and writes files (or
``-dir``'s, filtered by ``-include``) and prints a JSON line with each
fid; ``download`` writes a fid's bytes to ``-o`` (standard output by
default).

``master``, ``volume`` and ``shell`` read ``security.toml`` from ".",
``~/.seaweedfs`` or ``/etc/seaweedfs`` (``WEED_JWT_SIGNING_KEY``-style
variables override it), as weed.py does: ``[jwt.signing]`` and
``[jwt.signing.read]`` keys make the master sign write and read tokens
and the volume servers demand them, ``[guard] white_list`` limits who may
write, and ``[tls]`` (ca, cert, key) puts every listener and every call
between them under mTLS; the shell takes the client side of it.
``volume -dataplane native`` serves needle IO through the C++ data plane
(csrc/dataplane.cpp, built with ``c++ ... -lz`` before the server
listens; a failed build exits non-zero): it binds the framed port and
every HTTP needle op of a version 3, 4-byte-offset, local volume goes
through it (``python``, the default, is the Python framed plane).  A
volume with 5-byte offsets (past 32 GB) is made by POSTing
``/admin/assign_volume`` with ``"offset_5": true``.
``volume -mmap`` maps each `.dat`; ``volume -tier.backends NAME=DIR``
(repeatable) registers a directory as the tier backend NAME, the
``-dest`` of the shell's ``volume.tier.upload`` and ``volume.tier.move``.

Servers answer on the process's event-loop reactor (utils/eventloop.py);
``-dataplane.workers N`` (before the subcommand) sizes its worker pool, 0
the default size, and ``WEED_DATAPLANE=threaded`` serves a thread per
connection instead.
``volume -dataplane.cacheMB N`` sizes the needle cache (default 64, 0
disables it).  ``benchmark`` is the reference's (command/benchmark.go):
write ``-n`` needles of ``-size`` bytes from ``-c`` threads through the
master's assign, then read them back shuffled (``-readSequentially`` in
order), each answer checked against the bytes written for that needle;
``-phase write|read`` with ``-fidsFile`` splits the two.  Every needle's
bytes differ: the first 8 are its payload id (``-seed`` << 32 | its
index, as upstream's FakeReader puts the id in each body) and the rest
come from a stream seeded by that id, and the fids file holds ``fid id``
per line.  A line that is a bare fid is a needle the reference's
``weed.py benchmark`` wrote, and its read is held to that benchmark's one
payload.  It prints the reference's ``write:`` and ``read:`` lines.
``-useTcp`` assigns over the master's framed-TCP front and writes and
reads over the volume servers' framed planes (HTTP port + 20000).  Port
additions: ``-seed``, ``-zipf N`` reads N more needles drawn Zipf (theta
0.99, YCSB's default) over the fids, and ``-json`` prints each pass as a
JSON line too (ops/s, p50/p99 ms, mismatches).

Every subcommand first arms the fault points named in ``WEED_FAULTS``
(utils/faultinject.py ``arm_from_env``), e.g.
``WEED_FAULTS="ec.dispatch:error_rate=1,max_hits=1,after=12"``.

``-trace.sample R`` (before or after the subcommand of ``master``,
``volume`` or ``shell``), or ``WEED_TRACE_SAMPLE=R``, turns the span
tracer on with head sampling at rate R in [0, 1], as weed.py does;
negative or unset leaves it off (``/debug/traces?enable=1`` turns it on
live, and a request whose caller sampled it records anyway once on).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
from typing import Callable

# the reference's engine names -> the port's devices
ENGINES = {"tpu": "cuda", "mesh": "cuda", "cpu": "cpu"}
# benchmark -zipf's skew: YCSB's default request distribution
ZIPF_THETA = 0.99
# benchmark's default -seed
BENCH_SEED = 0xBE


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seaweedfs_tpu_torch")
    trace_help = ("enable tracing with this head sampling rate (0..1); "
                  "negative/unset = off (WEED_TRACE_SAMPLE works too)")
    p.add_argument("-trace.sample", dest="trace_sample", type=float,
                   default=-1.0, metavar="RATE", help=trace_help)
    p.add_argument("-dataplane.workers", dest="dataplane_workers", type=int,
                   default=0, metavar="N",
                   help="event-loop dispatch worker pool size; 0 = auto "
                        "(WEED_DATAPLANE=threaded serves a thread per "
                        "connection instead)")
    sub = p.add_subparsers(dest="command", required=True)
    m = sub.add_parser("master", help="start a master")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=30000)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-peers", default="",
                   help="comma-separated other master host:ports")
    m.add_argument("-mdir", default="",
                   help="dir for raft state persistence (-resumeState)")
    m.add_argument("-pulseSeconds", type=float, default=5.0,
                   help="heartbeat interval; a volume server silent for "
                        "ten pulses is dropped")
    m.add_argument("-maxInflight", type=int, default=0,
                   help="admission control: shed requests early (503 + "
                        "Retry-After) beyond this many in flight "
                        "(0 = off; operator/debug routes exempt)")
    m.add_argument("-metricsAggregationSeconds", type=float, default=0.0,
                   help="scrape registered volume-server /metrics every N "
                        "seconds for /cluster/metrics + /cluster/health "
                        "(0 = on demand only)")
    m.add_argument("-coordinatorSeconds", type=float, default=0.0,
                   help="run the autonomous EC rebuild/rebalance "
                        "coordinator with this planning interval: "
                        "repair volumes short of clean shards (below "
                        "k+1 first) and rebalance shard placement "
                        "rack-aware on server join/leave (0 = off; "
                        "status at GET /cluster/coordinator)")
    v = sub.add_parser("volume", help="start a volume server")
    v.add_argument("-dir", default="./data",
                   help="comma-separated data directories")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-mserver", default="127.0.0.1:9333",
                   help="comma-separated master addresses")
    v.add_argument("-dataCenter", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-max", type=int, default=8,
                   help="maximum number of volumes")
    v.add_argument("-pulseSeconds", type=float, default=5.0,
                   help="heartbeat interval")
    v.add_argument("-maxInflight", type=int, default=0,
                   help="admission control: shed object requests early "
                        "(503 + Retry-After) beyond this many in "
                        "flight (0 = off)")
    v.add_argument("-dataplane.cacheMB", dest="dataplane_cache_mb", type=int,
                   default=64,
                   help="needle read cache size in MB (0 disables)")
    v.add_argument("-dataplane", default="python",
                   choices=["python", "native"],
                   help="native: the C++ plane serves needle IO (framed "
                        "TCP and the HTTP funnel)")
    v.add_argument("-ec.engine", dest="ec_engine", default="tpu",
                   choices=sorted(ENGINES),
                   help="tpu: EC on the CUDA card; mesh: whole dispatches "
                        "round-robin over -ec.mesh.devices' cards; cpu: "
                        "the plain versions")
    v.add_argument("-ec.mesh.devices", dest="ec_mesh_devices", default="",
                   help="mesh engine device spec: '' or 'all' = every card,"
                        " 'N' = first N, 'i,j,...' = exact card indices")
    v.add_argument("-mmap", action="store_true",
                   help="mmap-backed .dat files (backend/memory_map analog)")
    v.add_argument("-tier.backends", dest="tier_backends", action="append",
                   default=[], metavar="NAME=DIR",
                   help="register a dir-type tier backend (repeatable): "
                        "the remote storage target of volume.tier.*")
    s = sub.add_parser("shell", help="run admin shell commands")
    s.add_argument("-master", default="127.0.0.1:9333")
    s.add_argument("-c", default="",
                   help="run these commands (; separated) and exit")
    for sp in (m, v, s):
        # SUPPRESS: absent here, the value before the subcommand stands
        sp.add_argument("-trace.sample", dest="trace_sample", type=float,
                        default=argparse.SUPPRESS, metavar="RATE",
                        help=trace_help)
    c = sub.add_parser("compact", help="vacuum one volume offline")
    c.add_argument("-dir", default=".")
    c.add_argument("-collection", default="")
    c.add_argument("-volumeId", type=int, required=True)
    bk = sub.add_parser("backup", help="incremental backup of a volume "
                                       "into a local follower")
    bk.add_argument("-master", default="127.0.0.1:9333")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.add_argument("-dir", default=".")
    bk.add_argument("-collection", default="")
    fx = sub.add_parser("fix", help="rebuild a volume's .idx from its .dat")
    fx.add_argument("-dir", default=".")
    fx.add_argument("-collection", default="")
    fx.add_argument("-volumeId", type=int, required=True)
    ex = sub.add_parser("export", help="list or tar a volume's needles")
    ex.add_argument("-dir", default=".")
    ex.add_argument("-collection", default="")
    ex.add_argument("-volumeId", type=int, required=True)
    ex.add_argument("-o", default="", help="output .tar path (default: list)")
    ex.add_argument("-limit", type=int, default=0)
    ex.add_argument("-deleted", action="store_true",
                    help="also list deleted records")
    up = sub.add_parser("upload", help="upload files through the master")
    up.add_argument("-master", default="127.0.0.1:9333")
    up.add_argument("-collection", default="")
    up.add_argument("-replication", default="")
    up.add_argument("-ttl", default="",
                    help="time to live, e.g. 1m, 1h, 1d, 1M, 1y")
    up.add_argument("-dir", default="",
                    help="upload the whole folder recursively")
    up.add_argument("-include", default="",
                    help="glob of files to upload, works with -dir")
    up.add_argument("files", nargs="*")
    dl = sub.add_parser("download", help="download a fid")
    dl.add_argument("-master", default="127.0.0.1:9333")
    dl.add_argument("-o", dest="output", default="-")
    dl.add_argument("fid")
    b = sub.add_parser("benchmark", help="write then read N needles")
    b.add_argument("-master", default="127.0.0.1:9333")
    b.add_argument("-n", type=int, default=1000)
    b.add_argument("-size", type=int, default=1024)
    b.add_argument("-c", type=int, default=16)
    b.add_argument("-useTcp", action="store_true",
                   help="write/read over the framed-TCP data path")
    b.add_argument("-phase", default="both",
                   choices=["both", "write", "read"],
                   help="run only one phase (scaled multi-client benches)")
    b.add_argument("-fidsFile", default="",
                   help="write: save fids here; read: load fids from here")
    b.add_argument("-collection", default="benchmark",
                   help="write data to this collection")
    b.add_argument("-replication", default="000")
    b.add_argument("-deletePercent", type=int, default=0,
                   help="percent of writes deleted after the write pass")
    b.add_argument("-readSequentially", action="store_true",
                   help="read fids in write order instead of shuffled")
    b.add_argument("-seed", type=int, default=BENCH_SEED,
                   help="the written payloads' seed (ids seed << 32 | i)")
    b.add_argument("-zipf", type=int, default=0, metavar="N",
                   help="after the reads, N more drawn Zipf (theta 0.99) "
                        "over the fids")
    b.add_argument("-json", action="store_true",
                   help="print each pass as a JSON line too")
    return p.parse_args(argv)


def _maybe_enable_tracing(rate: float) -> None:
    """-trace.sample R, else WEED_TRACE_SAMPLE: turn the tracer on with
    head sampling at rate R; negative or unset leaves it off."""
    if rate < 0:
        try:
            rate = float(os.environ.get("WEED_TRACE_SAMPLE", ""))
        except ValueError:
            return
        if rate < 0:
            return
    from .observability import enable_tracing, set_sample_rate

    enable_tracing()
    set_sample_rate(rate)


def _security():
    """security.toml from ".", ~/.seaweedfs or /etc/seaweedfs, with its
    WEED_* overrides (an empty configuration when there is none)."""
    from .security.config import load_security_configuration

    return load_security_configuration()


def _cluster_tls():
    """security.toml [tls] -> the server SSL context, the process's mTLS
    client side installed with it; None when TLS is not configured."""
    from .security.tls import enable_cluster_tls, from_configuration

    return enable_cluster_tls(from_configuration(_security()))


def _tier_backends(specs) -> dict:
    """-tier.backends NAME=DIR (repeatable) -> configure_backends' dict."""
    conf = {}
    for spec in specs or []:
        name, _, root = spec.partition("=")
        if not name or not root:
            raise SystemExit(f"-tier.backends wants NAME=DIR, got {spec!r}")
        conf[name] = {"type": "dir", "root": root}
    return conf


def _serve_until_signalled(start: Callable[[], Callable[[], None]]) -> None:
    """Install the SIGINT/SIGTERM handlers, then ``start()`` the server
    (it returns the server's stop), run until a signal, and stop.  A
    signal taken while the server starts stops it once it is up.  The
    caller's handlers come back on the way out, a failed start's too."""
    stop = threading.Event()
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        shutdown = start()
        # Python runs a handler on the main thread only.  When the kernel
        # hands the signal to another thread (request, heartbeat or torch
        # threads), an untimed wait here would never wake to run it, so
        # wake every half second
        while not stop.wait(0.5):
            pass
        shutdown()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def cmd_master(args: argparse.Namespace) -> int:
    from .master.server import MasterServer
    from .security.config import master_guard

    # the coordinator's repairs (with each leg's seconds) are log lines;
    # /cluster/events journals them
    logging.basicConfig(level=logging.INFO, format="%(asctime)s "
                        "%(levelname)s %(name)s: %(message)s")

    def start():
        ms = MasterServer(host=args.ip, port=args.port,
                          volume_size_limit_mb=args.volumeSizeLimitMB,
                          default_replication=args.defaultReplication,
                          pulse_seconds=args.pulseSeconds,
                          coordinator_seconds=args.coordinatorSeconds,
                          metrics_aggregation_seconds=(
                              args.metricsAggregationSeconds),
                          max_inflight=args.maxInflight,
                          peers=[p for p in args.peers.split(",") if p],
                          mdir=args.mdir, guard=master_guard(_security()),
                          tls_context=_cluster_tls()).start()
        print(f"master listening on {ms.url}", flush=True)
        return ms.stop

    _serve_until_signalled(start)
    from .utils import faultinject

    hits = {name: faultinject.fired(name)
            for name in sorted(faultinject.FAULT_POINTS)
            if faultinject.fired(name)}
    print("master stopped" + (f", faults injected {json.dumps(hits)}"
                              if hits else ""), flush=True)
    return 0


def cmd_volume(args: argparse.Namespace) -> int:
    state = {}

    def start():
        import torch

        from .ops import _build
        from .security.config import volume_guard
        from .volume_server.server import VolumeServer

        vs = VolumeServer(args.dir.split(","), args.mserver, host=args.ip,
                          port=args.port, data_center=args.dataCenter,
                          rack=args.rack, max_volume_count=args.max,
                          pulse_seconds=args.pulseSeconds,
                          device=ENGINES[args.ec_engine],
                          ec_engine=args.ec_engine,
                          ec_mesh_devices=args.ec_mesh_devices,
                          max_inflight=args.maxInflight,
                          needle_cache_mb=args.dataplane_cache_mb,
                          guard=volume_guard(_security()),
                          backends=_tier_backends(args.tier_backends) or None,
                          tls_context=_cluster_tls(), use_mmap=args.mmap,
                          dataplane=args.dataplane)
        device = vs.store.device
        if device.type == "cuda":
            # a kernel that does not build stops the server here, before
            # it serves any request
            _build.build(["crc32c", "gf_matmul"])
        vs.start()
        card = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "plain PyTorch")
        front = ("reactor" if type(vs._server).__name__ ==
                 "ReactorHTTPServer" else "threaded")
        plane = vs._native_plane
        native = "" if plane is None else (
            f", native plane on {plane.port}" if plane.port
            else ", native plane engine-only")
        lanes = vs.store.mesh_lanes
        if lanes is not None:
            native = (f", mesh over {len(lanes)} lanes "
                      f"({','.join(str(d) for d in lanes)})" + native)
        print(f"volume server listening on {vs.url}, dirs {args.dir}, "
              f"ec on {device} ({card}){native}, front {front}", flush=True)
        state["vs"] = vs
        return vs.stop

    _serve_until_signalled(start)
    from .ops.gf_matmul import gf_matmul

    reads = state["vs"].ec_reads
    print(f"volume server stopped, ec kernel launches {gf_matmul.launches}, "
          f"remote shard reads {reads['remote']}, "
          f"reconstructed intervals {reads['reconstructed']}", flush=True)
    return 0


def cmd_shell(args: argparse.Namespace) -> int:
    from .shell import CommandEnv, repl, run_command

    # a cluster under mTLS answers only a client with the node certificate
    _cluster_tls()
    if not args.c:
        repl(args.master)
        return 0
    env = CommandEnv(args.master)
    env.lock()
    try:
        for line in args.c.split(";"):
            out = run_command(env, line.strip())
            if out is not None:
                print(out, flush=True)
    finally:
        env.unlock()
    return 0


def cmd_compact(args: argparse.Namespace) -> int:
    """Offline vacuum of one volume (command/compact.go)."""
    from .storage.volume import Volume

    v = Volume(args.dir, args.collection, args.volumeId)
    try:
        before = v.data_size
        v.compact()
        v.commit_compact()
        print(f"compact: volume {args.volumeId} {before} -> {v.data_size} "
              f"bytes")
    finally:
        v.close()
    return 0


def cmd_backup(args: argparse.Namespace) -> int:
    """Incremental backup of a volume to local disk (command/backup.go):
    follow its server's /admin/tail by append time into a follower
    volume under ``-dir``; a second run applies only what is new."""
    from .client.operation import MasterClient
    from .storage.volume import Volume
    from .storage.volume_backup import incremental_backup
    from .utils.httpd import HttpError, http_bytes, http_json

    vid = args.volumeId
    urls = MasterClient(args.master).lookup(vid)
    if not urls:
        raise SystemExit(f"volume {vid} has no locations")
    src = urls[0]
    # tail records are raw needles in the source's version's framing
    version = next((int(v["version"]) for v in http_json(
        "GET", f"http://{src}/status", timeout=30.0).get("Volumes", [])
        if int(v["id"]) == vid), 3)
    if version != 3:
        raise SystemExit(f"volume {vid} is version {version}: only "
                         "version 3 volumes are served")
    follower = Volume(args.dir, args.collection, vid)

    def fetch(since_ns: int) -> tuple[bytes, int]:
        status, body, headers = http_bytes(
            "GET", f"http://{src}/admin/tail?volume_id={vid}"
            f"&since_ns={since_ns}", timeout=300.0)
        if status != 200:
            raise HttpError(status, body.decode(errors="replace"))
        last = next((v for k, v in headers.items()
                     if k.lower() == "x-last-append-at-ns"), since_ns)
        return body, int(last)

    try:
        applied = incremental_backup(follower, fetch)
    finally:
        follower.close()
    print(f"volume {vid}: applied {applied} records from {src} "
          f"into {args.dir}", flush=True)
    return 0


def cmd_fix(args: argparse.Namespace) -> int:
    """Rebuild a volume's .idx from its .dat (command/fix.go): one entry
    per record in .dat order, a tombstone as the live delete writes it,
    in the volume's own offset width (its superblock's), built in a
    temporary file so a malformed .dat keeps the old index."""
    from .storage import idx as idx_mod
    from .storage.needle_map import MemDb
    from .storage.super_block import SuperBlock
    from .storage.types import size_is_valid
    from .storage.volume import volume_file_prefix
    from .tools.see_dat import walk_dat

    base = volume_file_prefix(args.dir, args.collection, args.volumeId)
    db = MemDb()
    count = 0
    offset_size = 4
    tmp_idx = base + ".idx_fix"
    try:
        with open(tmp_idx, "wb") as f:
            for offset, rec in walk_dat(base + ".dat"):
                if isinstance(rec, SuperBlock):
                    offset_size = rec.offset_size
                    continue
                count += 1
                if size_is_valid(rec.size):
                    db.set(rec.id, offset, rec.size)
                    f.write(idx_mod.pack_entry(rec.id, offset, rec.size,
                                               offset_size))
                else:
                    db.unset(rec.id)
                    f.write(idx_mod.pack_entry(rec.id, offset, -1,
                                               offset_size))
    except BaseException:
        os.unlink(tmp_idx)
        raise
    os.replace(tmp_idx, base + ".idx")
    print(f"fix: scanned {count} records ({len(db)} live) to {base}.idx",
          flush=True)
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    """List a volume's needles, or write them to a tar (command/export.go):
    records in .dat order, the deleted ones only listed with -deleted."""
    import io
    import tarfile

    from .storage.types import size_is_valid
    from .storage.volume import Volume

    v = Volume(args.dir, args.collection, args.volumeId)
    tar_out = tarfile.open(args.o, "w") if args.o else None
    shown = 0
    try:
        live_keys = {nv.key for nv in v.nm}

        def visit(needle, offset: int) -> None:
            nonlocal shown
            if args.limit and shown >= args.limit:
                return
            deleted = needle.id not in live_keys \
                or not size_is_valid(needle.size)
            if deleted and not (args.deleted and tar_out is None):
                return
            name = (needle.name or b"").decode(errors="replace")
            if tar_out is not None:
                info = tarfile.TarInfo(name=f"{needle.id}_{name}"
                                       if name else str(needle.id))
                info.size = len(needle.data)
                info.mtime = needle.last_modified or 0
                tar_out.addfile(info, io.BytesIO(needle.data))
            else:
                mark = " DELETED" if deleted else ""
                print(f"id {needle.id} size {needle.size} "
                      f"name {name!r}{mark}")
            shown += 1

        v.scan(visit)
        if tar_out is not None:
            print(f"export: wrote {shown} files to {args.o}")
    finally:
        if tar_out is not None:
            tar_out.close()
        v.close()
    sys.stdout.flush()
    return 0


def walk_matching_files(root: str, include: str):
    """Every file under ``root``, sorted within each directory, whose name
    matches the ``include`` glob (all when empty): upload -dir's walk."""
    import fnmatch

    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if include and not fnmatch.fnmatch(name, include):
                continue
            yield os.path.join(dirpath, name)


def cmd_upload(args: argparse.Namespace) -> int:
    """weed upload (command/upload.go): the files named, or -dir's files
    matching -include, each assigned through the master with the
    collection, replication and TTL given; one JSON line per file."""
    from .client.operation import WeedClient

    client = WeedClient(args.master)
    paths = list(args.files)
    if args.dir:
        if not os.path.isdir(args.dir):
            raise SystemExit(f"-dir {args.dir!r} is not a directory")
        paths.extend(walk_matching_files(args.dir, args.include))
    if not paths:
        raise SystemExit("nothing to upload: pass files or -dir")
    for path in paths:
        with open(path, "rb") as f:
            fid = client.upload(f.read(), name=path.split("/")[-1],
                                collection=args.collection,
                                replication=args.replication, ttl=args.ttl)
        print(json.dumps({"file": path, "fid": fid}), flush=True)
    return 0


def cmd_download(args: argparse.Namespace) -> int:
    from .client.operation import WeedClient

    data = WeedClient(args.master).download(args.fid)
    if args.output == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.flush()
    else:
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"wrote {len(data)} bytes to {args.output}", flush=True)
    return 0


def _percentile(sorted_s: list[float], p: float) -> float:
    """The reference's rank: sorted[int(n * p) - 1]."""
    return sorted_s[max(int(len(sorted_s) * p) - 1, 0)]


def _pass_json(name: str, lat: list[float], wall: float,
               mismatches: int = 0) -> str:
    lat = sorted(lat)
    return json.dumps({"pass": name, "n": len(lat), "wall_s": wall,
                       "ops_per_s": len(lat) / wall if wall else 0.0,
                       "p50_ms": _percentile(lat, 0.50) * 1e3,
                       "p99_ms": _percentile(lat, 0.99) * 1e3,
                       "mismatches": mismatches})


def zipf_indices(n: int, count: int, theta: float, rng) -> list[int]:
    """``count`` draws over ranks 0..n-1 with P(rank i) proportional to
    1 / (i + 1)^theta (YCSB's request distribution at theta 0.99)."""
    import numpy as np

    weights = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    u = np.random.default_rng(rng.getrandbits(64)).random(count)
    return np.minimum(np.searchsorted(cdf, u), n - 1).tolist()


def bench_payload(pid: int, size: int) -> bytes:
    """benchmark's needle bytes for payload id ``pid``: the id in the first
    8 bytes, the rest from a stream seeded by it."""
    import random

    return (pid.to_bytes(8, "little")
            + random.Random(pid).randbytes(max(0, size - 8)))[:size]


def reference_bench_payload(size: int) -> bytes:
    """The one payload the reference's benchmark writes to every needle
    (weed.py ``cmd_benchmark``)."""
    import random

    return random.Random(0xBE).randbytes(size)


def expected_payload(pid, size: int) -> bytes:
    """The bytes a fids-file needle must read back: its own payload, or
    the reference's one payload for a bare-fid line (``pid`` None)."""
    return bench_payload(pid, size) if pid is not None \
        else reference_bench_payload(size)


def read_fids_file(path: str) -> list[tuple[str, int | None]]:
    """A benchmark fids file -> [(fid, payload id)]; a bare fid (the
    reference's lines) has the payload id None."""
    out = []
    with open(path) as f:
        for line in f.read().splitlines():
            fid, _, pid = line.strip().partition(" ")
            if not fid:
                continue
            if pid and not pid.isdigit():
                raise SystemExit(f"{path}: {line!r}: the payload id is "
                                 f"not a number")
            out.append((fid, int(pid) if pid else None))
    return out


def cmd_benchmark(args: argparse.Namespace) -> int:
    """weed benchmark (command/benchmark.go): write then read N files."""
    import concurrent.futures
    import random
    import time

    from .client.operation import WeedClient

    client = WeedClient(args.master)
    fids: list[tuple] = []
    to_delete: list[str] = []
    del_rng = random.Random(0xDE1)

    def write_one(i: int) -> float:
        pid = (args.seed << 32) | i
        payload = bench_payload(pid, args.size)
        t0 = time.perf_counter()
        if args.useTcp:
            fid = client.upload_tcp(payload, collection=args.collection,
                                    replication=args.replication)
        else:
            fid = client.upload(payload, name=f"bench{i}",
                                collection=args.collection,
                                replication=args.replication)
        dt = time.perf_counter() - t0
        # -deletePercent: deleted after the pool joins, so write latency
        # stays comparable across runs
        if args.deletePercent and del_rng.randrange(100) < args.deletePercent:
            to_delete.append(fid)
        else:
            fids.append((fid, pid))
        return dt

    if args.phase in ("both", "write"):
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(args.c) as ex:
            lat = sorted(ex.map(write_one, range(args.n)))
        wall = time.perf_counter() - t0
        for fid in to_delete:
            client.delete(fid)
        print(f"write: {args.n} x {args.size}B in {wall:.2f}s = "
              f"{args.n / wall:.0f} req/s, "
              f"avg {sum(lat) / len(lat) * 1e3:.1f}ms "
              f"p99 {lat[int(len(lat) * 0.99) - 1] * 1e3:.1f}ms"
              + (f", {len(to_delete)} deleted" if to_delete else ""),
              flush=True)
        if args.json:
            print(_pass_json("write", lat, wall), flush=True)
        if args.fidsFile:
            with open(args.fidsFile, "w") as f:
                f.write("\n".join(f"{fid} {pid}" for fid, pid in fids))
    if args.phase == "read":
        if not args.fidsFile:
            raise SystemExit("-phase read requires -fidsFile "
                             "(produced by a -phase write run)")
        fids = read_fids_file(args.fidsFile)
        if not fids:
            raise SystemExit(f"no fids in {args.fidsFile}")
    mismatches = [0]

    read = client.download_tcp if args.useTcp else client.download
    count_lock = threading.Lock()

    def read_one(fid_pid: tuple) -> float:
        fid, pid = fid_pid
        t0 = time.perf_counter()
        got = read(fid)
        dt = time.perf_counter() - t0
        if got != expected_payload(pid, args.size):
            with count_lock:
                mismatches[0] += 1
        return dt

    def read_pass(name: str, order: list[tuple]) -> None:
        mismatches[0] = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(args.c) as ex:
            lat = sorted(ex.map(read_one, order))
        wall = time.perf_counter() - t0
        print(f"{name}: {len(order)} in {wall:.2f}s = "
              f"{len(order) / wall:.0f} req/s, "
              f"avg {sum(lat) / len(lat) * 1e3:.1f}ms "
              f"p99 {lat[int(len(lat) * 0.99) - 1] * 1e3:.1f}ms", flush=True)
        if args.json:
            print(_pass_json(name, lat, wall, mismatches[0]), flush=True)
        if mismatches[0]:
            raise SystemExit(f"{name}: {mismatches[0]} answers differ from "
                             f"what was written")

    if args.phase in ("both", "read") and fids:
        order = list(fids)
        if not args.readSequentially:
            random.shuffle(order)
        read_pass("read", order)
        if args.zipf > 0:
            picks = zipf_indices(len(fids), args.zipf, ZIPF_THETA,
                                 random.Random(0x21F))
            read_pass("zipf", [fids[i] for i in picks])
    return 0


def main(argv: list[str]) -> int:
    from .utils import faultinject

    args = parse_args(argv)
    faultinject.arm_from_env()
    if args.dataplane_workers > 0:
        from .utils.eventloop import configure

        configure(workers=args.dataplane_workers)
    if args.command in ("master", "volume", "shell"):
        _maybe_enable_tracing(args.trace_sample)
    return {"master": cmd_master, "volume": cmd_volume,
            "shell": cmd_shell, "compact": cmd_compact,
            "backup": cmd_backup, "fix": cmd_fix, "export": cmd_export,
            "upload": cmd_upload, "download": cmd_download,
            "benchmark": cmd_benchmark}[args.command](args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
