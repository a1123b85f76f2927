"""Command line: ``python -m seaweedfs_tpu_torch master|volume|shell|compact``.

The ``weed master``, ``weed volume``, ``weed shell`` and ``weed compact``
subcommands (weed.py) with the flags this port serves:

    python -m seaweedfs_tpu_torch master -port 9333 -volumeSizeLimitMB 30000 \\
        -coordinatorSeconds 15 -metricsAggregationSeconds 5
    python -m seaweedfs_tpu_torch master -port 9333 -mdir /m1 \\
        -peers 127.0.0.1:9334,127.0.0.1:9335
    python -m seaweedfs_tpu_torch volume -dir /data -port 8080 \\
        -mserver 127.0.0.1:9333,127.0.0.1:9334,127.0.0.1:9335 -ec.engine tpu
    python -m seaweedfs_tpu_torch shell -master 127.0.0.1:9333 \\
        -c "ec.encode -volumeId 3; ec.rebuild -volumeId 3"
    python -m seaweedfs_tpu_torch compact -dir /data -collection c -volumeId 3

``-ec.engine tpu`` (the default) runs EC on the CUDA card: the server
builds its kernel before it listens and fails without a card;
``-ec.engine cpu`` runs the plain PyTorch versions.  ``master
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
operator, debug and control-plane routes are never shed).  The servers
run until SIGINT or SIGTERM, a signal taken during start-up included,
then stop and exit 0; the volume server's last line counts the GF
kernels it launched and the EC intervals it lacked, fetched from a
holder or reconstructed, and the master's the fault hits it injected
by point, when there were any.  ``shell -c`` takes the admin lock, runs the
``;``-separated commands, prints what each returns and unlocks; without
``-c`` it reads commands from standard input.  ``compact`` vacuums one
volume offline (no server may hold it) and prints its size before and
after.  The master vacuums volumes with 30% garbage or more every 900 s,
as the reference's does; neither knob is a flag there, so none is here.

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

# the reference's engine names -> the port's devices ("mesh" is not ported)
ENGINES = {"tpu": "cuda", "cpu": "cpu"}


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seaweedfs_tpu_torch")
    trace_help = ("enable tracing with this head sampling rate (0..1); "
                  "negative/unset = off (WEED_TRACE_SAMPLE works too)")
    p.add_argument("-trace.sample", dest="trace_sample", type=float,
                   default=-1.0, metavar="RATE", help=trace_help)
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
    v.add_argument("-ec.engine", dest="ec_engine", default="tpu",
                   choices=sorted(ENGINES),
                   help="tpu: EC on the CUDA card; cpu: the plain versions")
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
                          mdir=args.mdir).start()
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
        from .volume_server.server import VolumeServer

        vs = VolumeServer(args.dir.split(","), args.mserver, host=args.ip,
                          port=args.port, data_center=args.dataCenter,
                          rack=args.rack, max_volume_count=args.max,
                          pulse_seconds=args.pulseSeconds,
                          device=ENGINES[args.ec_engine],
                          max_inflight=args.maxInflight)
        device = vs.store.device
        if device.type == "cuda":
            # a kernel that does not build stops the server here, before
            # it serves any request
            _build.build(["crc32c", "gf_matmul"])
        vs.start()
        card = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "plain PyTorch")
        print(f"volume server listening on {vs.url}, dirs {args.dir}, "
              f"ec on {device} ({card})", flush=True)
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


def main(argv: list[str]) -> int:
    from .utils import faultinject

    args = parse_args(argv)
    faultinject.arm_from_env()
    if args.command != "compact":
        _maybe_enable_tracing(args.trace_sample)
    return {"master": cmd_master, "volume": cmd_volume,
            "shell": cmd_shell, "compact": cmd_compact}[args.command](args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
