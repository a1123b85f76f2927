#!/usr/bin/env python3
"""Run one phase of chip_smoke.py on the card, alone, at its full size.

    python3 chip_phase.py volume_store     # or: dataplane, secure_tier,
                                           #     native_plane, mesh,
                                           #     telemetry
    python3 chip_phase.py dataplane parent  # the label printed with it

Builds the native libraries from the checkout it runs in, runs
``run_volume_store_phase``, ``run_dataplane_phase``,
``run_secure_tier_phase``, ``run_native_plane_phase``,
``run_telemetry_phase`` or, after the main path that writes its volume,
``run_mesh_phase`` with chip_smoke.py's
constants, and prints the card's name and power limit,
then one JSON line of the phase's numbers (``dataplane``: each front's
healthy passes, ops/s and p50/p99 ms; ``native_plane``: its passes, the
frames and dispatches each moved, and the client's and servers' CPU
seconds; ``telemetry``: its checks, its on/off/on passes and its
``scenarios`` leg).  To hold one tree against another on one card,
unpack the other with ``git archive``, copy this script into it if it
lacks one, and run it from each checkout in turns (other, this, this,
other) in one call.  Needs a card.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time

import chip_smoke as cs

PASSES = ("write", "read", "zipf", "read_again", "zipf_again")


def main(argv: list[str]) -> int:
    if not argv or argv[0] not in ("volume_store", "dataplane",
                                   "secure_tier", "native_plane", "mesh",
                                   "telemetry"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_phase.py: no CUDA card", file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import _build

    phase, label = argv[0], argv[1] if len(argv) > 1 else ""
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    _build.build(["crc32c", "gf_matmul", "dataplane"])
    work = tempfile.mkdtemp(prefix=f"chip-{phase}-", dir=_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        if phase == "volume_store":
            res = cs.run_volume_store_phase(
                "cuda", work, cs.STORE_NEEDLES, cs.STORE_SIZE,
                cs.STORE_BATCH_DELETES, cs.STORE_MISSING,
                cs.STORE_GC_THREADS, cs.STORE_GC_PER_THREAD, cs.STORE_MORE,
                cs.STORE_MORE_DELETES, cs.STORE_DEGRADED,
                follower_seed=cs.STORE_FOLLOWER_SEED)
            res.pop("stats", None)
        elif phase == "native_plane":
            nat = cs.run_native_plane_phase(
                "tpu", work, cs.BENCH_N, cs.BENCH_SIZE, cs.BENCH_CLIENTS,
                cs.BENCH_ZIPF, cs.NATIVE_DEGRADED,
                cs.NATIVE_FIVE_BYTE_NEEDLES)
            res = {"passes": {k: {x: v[x] for x in
                                  ("ops_per_s", "p50_ms", "p99_ms")}
                              for k, v in nat["passes"].items()},
                   "counts": nat["counts"], "cpu_s": nat["cpu_s"],
                   "launches": nat["launches"],
                   "phase_s": nat["seconds"]["phase"]}
        elif phase == "mesh":
            main = cs.run_main_path("cuda", work, cs.VOLUME_BYTES,
                                    cs.LARGE_ROW_VOLUME_BYTES,
                                    cs.LARGE_ROW_BLOCK, cs.DEGRADED_READS,
                                    cs.PARITY_STRIPES)
            res = cs.run_mesh_phase("cuda", work, main["hashes"],
                                    main["specs"], cs.mesh_lane_sets("cuda"),
                                    cs.MESH_PROGRAM_WIDTH)
            res["tpu_encode_s"] = main["seconds"]["encode"]
            res["tpu_rebuild_s"] = main["seconds"]["rebuild"]
        elif phase == "telemetry":
            res = cs.run_telemetry_phase(
                "tpu", work, cs.BENCH_N, cs.BENCH_SIZE, cs.BENCH_CLIENTS,
                cs.TELEMETRY_A, cs.TELEMETRY_B,
                halflife_s=cs.TELEMETRY_HALFLIFE_S,
                event_timeout=cs.TELEMETRY_EVENT_S,
                gets_overhead=cs.TELEMETRY_OVERHEAD)
        elif phase == "secure_tier":
            res = cs.run_secure_tier_phase(
                "tpu", work, cs.SECURE_BYTES, cs.SECURE_THREADS,
                cs.SECURE_TIER_GETS, cs.SECURE_DEGRADED)
        else:
            dp = cs.run_dataplane_phase(
                "tpu", work, cs.BENCH_N, cs.BENCH_SIZE, cs.BENCH_CLIENTS,
                cs.BENCH_ZIPF, cs.BENCH_DEGRADED, cs.BENCH_THREADED_WRITES,
                batch_needles=cs.BATCH_NEEDLES, batch=cs.BATCH_SIZE)
            res = {"passes": {
                front: {k: {x: fr[k][x] for x in
                            ("ops_per_s", "p50_ms", "p99_ms")}
                        for k in PASSES if k in fr}
                for front, fr in dp["fronts"].items()}}
        res["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"phase": phase, "label": label, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
