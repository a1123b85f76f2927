"""Command line: ``python -m seaweedfs_tpu_torch volume [flags]``.

The ``weed volume`` subcommand (weed.py) with the flags this port serves:

    python -m seaweedfs_tpu_torch volume -dir /data -port 8080 \\
        -mserver 127.0.0.1:9333 -ec.engine tpu

``-ec.engine tpu`` (the default) runs EC on the CUDA card and fails
without one; ``-ec.engine cpu`` runs the plain PyTorch versions.  The
server runs until SIGINT or SIGTERM, then stops, prints how many GF
kernels it launched, and exits 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

# the reference's engine names -> the port's devices ("mesh" is not ported)
ENGINES = {"tpu": "cuda", "cpu": "cpu"}


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seaweedfs_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
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
    v.add_argument("-ec.engine", dest="ec_engine", default="tpu",
                   choices=sorted(ENGINES),
                   help="tpu: EC on the CUDA card; cpu: the plain versions")
    return p.parse_args(argv)


def cmd_volume(args: argparse.Namespace) -> int:
    import torch

    from .ops.gf_matmul import gf_matmul
    from .volume_server.server import VolumeServer

    vs = VolumeServer(args.dir.split(","), args.mserver, host=args.ip,
                      port=args.port, data_center=args.dataCenter,
                      rack=args.rack, max_volume_count=args.max,
                      device=ENGINES[args.ec_engine]).start()
    device = vs.store.device
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "plain PyTorch")
    print(f"volume server listening on {vs.url}, dirs {args.dir}, "
          f"ec on {device} ({card})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    # Python runs a handler on the main thread only.  When the kernel hands
    # the signal to another thread (request, heartbeat or torch threads), an
    # untimed wait here would never wake to run it, so wake every half second
    while not stop.wait(0.5):
        pass
    vs.stop()
    print(f"volume server stopped, ec kernel launches {gf_matmul.launches}",
          flush=True)
    return 0


def main(argv: list[str]) -> int:
    args = parse_args(argv)
    return cmd_volume(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
