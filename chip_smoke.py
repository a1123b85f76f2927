#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's EC main path on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without a card,
or without the repository beside it, it exits non-zero and prints no
result.  Phases, each of which fails the run on any mismatch:

 1. environment and build: the card, torch and CUDA versions, and the
    native libraries built from seaweedfs_tpu_torch/csrc/;
 2. the GF(2^8) kernel against its plain PyTorch version on the card,
    byte for byte, at every shape the main path gives it, plus one shape
    against the host multiplication table;
 3. the main path through ``Store(device="cuda")``: write a 2 GiB volume
    of seeded needles (log-uniform 1 KiB - 4 MiB), EC-encode it (the
    parity drained and written on the encoder's drain threads), check
    sampled parity against the host table and every shard against its
    `.eci`, encode a small volume with large rows, delete and rebuild four
    shards (hashes must match), and serve 200 degraded needle reads with
    two data shards gone (bytes and CRC must match); then the resume: the
    same volume encoded again with the ``ec.dispatch`` fault point failing
    the middle dispatch once, which must resume from its checkpoint (one
    retry, at most depth + 1 dispatches redone) to the clean encode's
    sha256 of every shard and the `.eci`; then the trace A/B
    (``run_trace_ab``): the same volume encoded twice more, the span
    tracer off and then on at head-sampling rate 1, both to the clean
    encode's sha256 and with the same kernel launches (the encoder's
    dispatch rule), the traced run's spans read by ``analyze()`` into a
    stage attribution printed beside the encoder's own counters; then
    the mesh phase (``run_mesh_phase``, ``-ec.engine mesh``) over every
    visible card and, on a one-card box, four lanes naming card 0: the
    sharded encode, MeshEngine, the training step (0 mismatches) and the
    ring rebuild (rings of 2 and 5) at [10, 8 MiB] against kernel 1
    alone and the plain version, each with its launch rule;
    ``Store(ec_engine="mesh")`` re-encoding the main path's volume to
    its sha256 (every shard and the `.eci`, a launch a dispatch) and
    rebuilding shards 2 and 11, the last encode's per-lane fetch seconds
    from ``analyze()``; the device engine's split over the same lanes
    (dp*sp*tp launches a dispatch, the same bytes); one ``volume
    -ec.engine mesh -ec.mesh.devices 0,`` process answering ``POST
    /admin/ec/generate`` with the same bytes.  A copy between two cards
    runs only where two are visible;
 4. the HTTP path through an in-process ``VolumeServer(device="cuda")``:
    write a 2 GiB volume with HTTP PUTs (names, mime types and gzip bodies
    among them), ``/admin/ec/generate``, check parity and `.eci` again,
    GETs through EC (ETag, type, Range, If-None-Match), delete and
    ``/admin/ec/rebuild`` four shards (hashes must match), 200 degraded
    GETs from one client and 200 from eight at once with shards 2 and 7
    gone, then the overload leg (``run_overload``): a second in-process
    master and ``VolumeServer(device="cuda", max_inflight=4)`` over hard
    links of the same shards, 32 readers x 25 GETs at once, every answer
    the written bytes or the shed's 503, the 503s, the shed counter,
    ``shed_total`` and the master's /cluster/health equal, one launch per
    lost interval of the admitted GETs only, /metrics and /status
    answering throughout, ``requests_shed_increase`` firing at the
    master with the 503s seen and a shortened copy of it (``add_rule``)
    resolving after the storm, then a spent ``X-Weed-Deadline``'s 504; the
    scrubber (``/ec/scrub/start`` and ``/ec/scrub/status``): a
    clean pass, then a bit flipped in shards 3 and 12 and a pass that must
    quarantine both to ``.bad`` and rebuild them on the card to their
    sha256 while a reader's GETs keep returning the written bytes, then
    ``/admin/ec/to_volume`` and GETs from the decoded volume;
 5. the CLI: ``python -m seaweedfs_tpu_torch volume -ec.engine tpu`` in a
    subprocess, whose start line must name the card, serves a 64 MiB
    volume's degraded GETs and exits 0 on SIGTERM, printing the kernel
    launches of its process;
 6. a whole cluster through the CLI: ``master -coordinatorSeconds 1
    -metricsAggregationSeconds 1`` (its coordinator paused by the shell's
    ``coordinator.pause``) and five ``volume -ec.engine tpu`` processes
    on the card.  First the vacuum leg: a ``001`` volume of its own on
    two servers, 1 GiB uploaded from eight threads, 40% of its bytes
    deleted, ``shell -c "volume.vacuum -garbageThreshold 0.3"`` while a
    reader GETs survivors (no error allowed), each replica's compacted
    `.dat` equal to the plain compaction of its own pre-vacuum files at
    compaction revision 1, /dir/status showing the new size, every live
    needle read back and every deleted one 404; then ``ec.encode`` of the
    compacted volume (parity against the host table, every shard against
    its `.eci`, GETs through EC), whose host must launch exactly the
    kernels the encoder's dispatch rule gives for the compacted size;
    between the vacuum and the encode, the volume shell on the same
    volume (``run_volume_ops``): ``volume.fsck`` and ``volume.check.disk``
    clean, then a flipped byte in one replica that both report, that
    replica dropped with ``volume.delete -node`` and re-replicated by
    ``volume.fix.replication`` (sha256 equal to the healthy replica's), a
    replica moved by ``volume.move`` under a reader (no error),
    ``volume.configure.replication`` 000 and back (superblocks, master
    layouts), ``volume.mark`` read-only and writable; at the leg's end
    ``ec.decode`` and ``collection.delete`` drop the collection.  Then a
    2 GiB volume uploaded
    through WeedClient from eight threads, ``shell -c "ec.encode"`` (shard
    sha256 recorded), the holder of the most shards SIGKILLed and dropped
    by the master, 200 + 8x25 degraded GETs classed by whether the shard
    they need lies on another live server (a remote shard read) or was
    lost (a reconstruction), then the same GETs again with tracing turned
    on live on the master and every server (``/debug/traces?enable=1``,
    off again after), each under a sampled Traceparent of its own: every
    GET's trace must be stitched at the master's /cluster/traces/<id>,
    each class (b) trace hold an ``ec.reconstruct`` span on the server
    that answered (whose launch count must equal its reconstruct spans),
    each class (a) trace the holder's /admin/ec/shard_read hop and no
    reconstruction; per-hop p50/p99 (front end, lookup_ec, remote shard
    read, reconstruct) and the bounding hop of the five slowest traces
    are printed (``traced_gets``), beside three more eight-client passes
    that weigh the tracer's cost against the host's drift: GETs sampled
    at 5% at their root, all at rate 1 again, untraced again, each
    pass's CPU per process and each traced period's spans counted from
    every ring; then the profile leg: one more untraced and one rate-1
    8-client pass, four times as long, while the server that
    reconstructed most and the master answer ``/debug/profile`` at 100
    Hz, each profile's samples by thread and layer printed beside the
    traced minus the untraced shares, the thread census
    (``/debug/pprof/goroutine``), the sampler's own cost, and a
    /cluster/health with nothing shed and no 504; each server's first
    class (b) GET is printed against its later ones; ``ec.rebuild`` (the
    rebuilt shards must
    match their sha256), a bit flipped in a shard of a server holding
    fewer than 10 (``ec.scrub -all`` must call it unrepairable and
    quarantine it, ``ec.rebuild`` heal it to its sha256, and a second
    ``ec.scrub -all`` find nothing unrepairable); then the repair drill:
    ``coordinator.resume`` and no shell command until each heal is
    checked: a byte of a shard on that server flipped and ``ec.scrub
    -all`` (unrepairable, quarantined) until the coordinator's rebuild
    and re-scrub leave every shard's sha256 equal and /cluster/health
    with no unrepairable verdict (``rot_to_heal_s``), then that server
    SIGKILLed until every shard has a live holder with its sha256
    (``kill_to_heal_s``) and /cluster/health reads ``degraded: false``;
    /cluster/coordinator must show two repairs or more, none failed; the
    master's /cluster/events must hold the rot's ``shard_corrupt`` and
    ``scrub_unrepairable`` from the rotted server, then ``repair_planned``
    and ``repair_done`` from the master, in that order, with the rot
    repair's ``cause_event`` naming one of the first two, and the
    killed server's ``peer_stale`` before the loss repair's
    ``repair_planned``; ``events.tail`` through the shell shows them
    (``journal``); the alert plane (``alerts``): the first kill fires
    ``peer_down`` and the host's first rot ``scrub_unrepairable`` and
    ``corrupt_shards_increase``, each timed from its fault to
    ``alert_fired`` and on to its flight-recorder bundles; in the drill's
    rot every firing alert carries a bundle from each implicated server
    and from the master, each fetched with its trace, profile, metrics
    and events, and the rot repair names a firing alert (its record,
    ``coordinator.status``, after the alert's ``alert_fired`` in the
    journal); after the drill's kill ``peer_down`` is firing (anew, or
    still since the first kill) and the loss repair names an alert; by hand, one timed capture per process,
    ``alerts.capture``, ``alerts.list -firing``, ``cluster.health``'s
    alerts line and ``fault.list``; the rules' host ms per evaluation;
    the alerts resolved by the phase's end;
    then the drain (``run_drain_leg``, coordinator paused):
    ``volume.server.evacuate`` of a live shard holder and
    ``volume.server.leave`` until the master drops it, every moved
    shard's sha256 on its new holder, its SIGTERM and stop line, 50 GETs
    of needles on moved shards with no reconstruction, one moved data
    shard deleted on its new holder and 25 GETs there reconstructed on
    its card, ``ec.rebuild`` of it to its sha256;
    last ``ec.decode`` and 50 GETs of the decoded volume.
    Each server's stop line must count exactly the remote reads and
    reconstructions its GETs needed, and the encode and rebuild hosts
    must have launched the kernel; each coordinator repair's host, by its
    live /status count read around the heal, at least as many kernels
    a repair as a typed ``ec.rebuild`` launched;
 7. master HA (``run_failover_phase``): three CLI masters (``-peers``,
    ``-mdir``, ``WEED_FAULTS="coord.exec:delay=0.5"``) and four ``volume
    -ec.engine tpu -mserver m1,m2,m3`` on the card; a 1 GiB volume
    uploaded through WeedClient and ec.encoded by the shell started at a
    follower; a rotted shard quarantined by its holder's scrub, and once
    ``scrub_unrepairable`` fires and a follower's own
    ``/cluster/coordinator?local=1`` holds the repair's planned record,
    the leader SIGKILLed.  It fails unless both survivors name one new
    leader within 8 s, the new leader serves ``/dir/assign`` within 5 s
    of its election, none of the follower's pre-kill events is missing
    from the new leader's journal, its ``repair_done`` for the volume
    comes within 45 s of the kill with the planned record's alert, cause
    event and cause trace, every holder of the rebuilt shard has its
    pre-rot sha256, and the rebuilding server launched the kernels the
    dispatch rule gives (dispatches of the shard times the rows a launch
    takes); ``cluster.raft`` and the survivors' ``/cluster/status`` are
    printed;
 8. the serving front (``run_dataplane_phase``): a CLI master and five
    ``volume -ec.engine tpu`` servers, 7 volumes of collection
    "benchmark" grown up front, and the port's ``benchmark`` at upstream
    ``weed benchmark``'s shapes (``-size 1024 -c 16``, replication 000,
    ``-n`` cut to 10,000): on the event-loop reactor the writes, every
    fid read back shuffled and 5,000 reads drawn Zipf (theta 0.99); the
    servers restarted on the same directories with
    ``WEED_DATAPLANE=threaded``: 1,000 more writes and the same reads;
    then ``ec.encode -collection benchmark``, the server with the most
    data shards of the largest volume stopped, and 2,000 of its fids read
    by one client and by 16 at once on the reactor, classed (a) remote
    shard read, (b) reconstruction on the card or local;
    every answer must be the bytes written for its needle (each
    needle's differ), each degraded pass's launches one per lost interval
    it read; printed: ops/s and
    p50/p99 per pass and front, the needle cache's hits and misses,
    inline against pooled dispatches, aborted connections, each server
    process's first reconstruction apart.  On the reactor and on
    the threaded front, ``benchmark -useTcp`` writes, reads back shuffled
    and reads Zipf as many needles again over the framed-TCP planes
    (``dataplane_tcp_reactor``, ``dataplane_tcp_threaded``): a direct
    ``A`` frame to the master first, and no HTTP /dir/assign during the
    write pass; then the batch leg (``dataplane_batch``): 1,000 of the
    framed pass's needles read 100 a request through framed ``B`` and
    ``POST /batch/read``, 1,000 fresh ones written with framed ``P`` and
    read back both ways, one torn ``/batch/write`` answered 400 with
    nothing written.  Every server's framed plane must have bound
    (``degraded_binds`` 0 after each start, here and in every phase
    before: the script picks each HTTP port with its framed port free);
 9. the volume store (``run_volume_store_phase``): a CLI master and an
    in-process ``VolumeServer(device="cuda")``; one volume of upstream
    ``weed benchmark``'s default shape (1,048,576 needles of 1,024 B, each
    its own seeded payload), the first 65,536 written through
    ``Volume.write_needle`` and the rest as the same records in bulk,
    opened in fresh interpreters with the compact and the memory needle
    map (open seconds and resident bytes per needle; equal live counts
    and counters); mounted, 1,000 seeded fids and 10 that do not exist
    deleted by ``/admin/batch_delete`` (the reference's answers, 404 on
    GET, the deletion counter up 1,000); ``/stats/*``; a second volume
    taking 16 x 250 ``PUT ?fsync=true`` and as many without (ops/s,
    p50/p99, the group-commit worker's requests, batches and fsyncs, the
    fsyncs fewer than the writes, every needle read back); the CLI's
    ``backup`` of the big volume into a follower that starts from a file
    copy of its first three quarters, 1,000 more needles and 100 deletes,
    ``backup`` again applying exactly those 1,100 records (the follower's
    `.dat` the source's, by sha256), ``fix`` of the follower (its `.idx`
    loads to the source's live map), ``export`` (a line a live needle),
    ``upload`` and ``download`` of a seeded file; then
    ``/admin/ec/generate`` on the card (the dispatch rule's launches, the
    `.ecx` equal to the plain sorted index, parity against the host
    table, the kernel against the plain version on the shards' bytes),
    data shards 2 and 7 deleted and 200 degraded GETs, each its needle's
    bytes, one launch per lost interval, a batch-deleted needle 404;
10. a secured, tiered cluster (``run_secure_tier_phase``): a CLI master
    and four ``volume -ec.engine tpu -tier.backends cold=DIR`` servers,
    one of them ``-mmap``, started beside a security.toml with a write
    key, a read key, a whitelist of 127.0.0.1 and mTLS (certificates made
    by ``openssl``; without it the phase runs without TLS and says
    ``"tls": "not run: no openssl"``); 1 GiB of seeded needles
    (log-uniform 1 KiB - 4 MiB) into one volume on the mmap server from
    eight WeedClient threads, each write with its assign's token; an
    unsigned PUT, a DELETE and a GET without a read token answer 401;
    ``volume.tier.upload -dest cold`` and 200 seeded GETs from the tier
    (each its needle's bytes) beside the same GETs read locally before;
    ``ec.encode`` of the tiered volume prints the reference's failure;
    ``volume.tier.download`` gives back the `.dat` by sha256; ``ec.encode``
    on the card (the dispatch rule's launches on its host); data shards 2
    and 7 deleted and 200 degraded GETs with read tokens, one launch and
    one reconstruction per lost interval, each server's first launching
    GET timed apart from the rest;
11. the native data plane (``run_native_plane_phase``): a CLI master and
    five ``volume -ec.engine tpu -dataplane native`` servers, 7 volumes of
    collection "benchmark", and ``benchmark -useTcp`` at the dataplane
    phase's shapes (10,000 writes, every fid read back shuffled, 5,000
    Zipf reads) over the C++ planes' framed ports, then the same passes
    over HTTP funnelled through the planes: each pass's ops/s and
    p50/p99 beside the dataplane phase's ``dataplane_tcp_reactor``, the
    W/R/D frames the planes served (the framed passes' exactly, the HTTP
    passes' none), the reactor's pooled dispatches flat in the framed
    passes (no frame reaches Python), and the CPU seconds of the client
    and of each server; ``ec.encode`` of the largest volume on the card
    (the dispatch rule's launches, the data shards decoding to the `.dat`
    the plane wrote, the parity against the host table), data shards 2
    and 7 deleted and 200 degraded GETs, one launch per lost interval;
    then a 5-byte-offset volume (``/admin/assign_volume offset_5``): 1,000
    needles over HTTP read back, its `.idx` 17 bytes an entry, off the
    plane, and ``ec.encode`` of it failing with the reference's error
    and writing no shard;
12. heat, the resource ledger and the request log
    (``run_telemetry_phase``): a CLI master with
    ``-metricsAggregationSeconds 1`` and three ``volume -ec.engine tpu
    -heat.halflife 5`` servers (heat and the ledger on by default), 7
    volumes filled by ``benchmark`` at the dataplane phase's shapes, the
    shell's ``workload.record -sample 1.0``, ``ec.encode`` of the volume
    with the most needles and its data shards that hold needles deleted;
    pass A, 5,000 Zipf GETs (theta 0.99) over the other volumes; pass B,
    2,000 Zipf GETs of the EC volume, each a reconstruction on the card
    (a flash crowd onto a cold volume).  It fails unless a ``flash_crowd``
    or ``heat_shift`` event names the EC volume within 30 s of pass B's
    start and an alert pages on it (fired after pass B began, or firing
    with its detail naming the volume); /cluster/heat ranks it first; the
    merged needle sketch holds pass A's ten most-read fids (the fitted
    Zipf ``s`` beside 0.99); /cluster/ledger has the http_read route with
    CPU and every server's loop lag; ``heat.volumes``, ``heat.top`` and
    ``cluster.top`` name the volume or the route; the exported recording
    holds one 200 ``http_read`` record a GET, pass B's as many as the
    holders' launches, which by exact width (/debug/ec/kernel) are the
    widths of the needles' intervals.  Then pass B three times more on
    freshly restarted servers, recording off, with accounting on, off
    (``-heat.off -ledger.off``) and on, over pass B's first 1,000 GETs:
    ops/s and p50/p99 of each, one launch a GET at its needle's width;
    last, on the servers of the last pass, the scenarios leg
    (``run_scenarios_leg``, its own ``scenarios`` line): the shell's
    ``workload.profile`` of the recording (its records, read share and
    top key's count the phase's own, heat's cross-check present),
    ``workload.replay -against`` the master (8 s, 8 clients; verdict
    pass, every fidelity check ok; ops/s, p50/p99), ``capacity.probe``
    of http_read, native_read and http_write under p99 < 5 ms (every
    route's capacity above 0, its knee and bound), /cluster/capacity
    equal to the posted document and cluster.health's capacity line;
    then 100 writes of one client split into their assign and POST hops
    (``write_split``); no server may launch a kernel across the leg;
13. numbers from the card: leg times and rates, read latency; each
    phase's kernel launches by width class (``launch_widths``); kernel
    1's own time at the encode and rebuild's [10, 8 MiB], at 1 MiB, 64
    KiB and the width most degraded GETs launch at (``kernel_shapes``):
    kernel-only ms from CUDA graphs of launches, warm and cold, beside
    the wrapper's host ms per call, an empty kernel's launch floor, the
    plain version's ms and the byte bound; the table build's.

Each path runs with every kernel count (gf_matmul.launches, its widths,
gf_table_build.launches) set to 0 just before it and read just after
(the CLI's servers count from 0 in their own processes), and fails if
it launched no kernel.  The last line is
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit; before that the {"kernels": [...]} line.
"""

from __future__ import annotations

import functools
import hashlib
import http.client
import json
import os
import random
import re
import select
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
# SeaweedFS's default volume size limit is 30,000 MB (weed master
# -volumeSizeLimitMB; seaweedfs_tpu/master/server.py:38); the run's time
# limit cuts it to 2 GiB
VOLUME_BYTES = 2 << 30
LARGE_ROW_VOLUME_BYTES = 96 << 20
LARGE_ROW_BLOCK = 4 << 20
NEEDLE_MIN, NEEDLE_MAX = 1 << 10, 4 << 20
DEGRADED_READS = 200
PARITY_STRIPES = 32
HTTP_THREADS, HTTP_READS_PER_THREAD = 8, 25
# the overload leg: 32 readers x 25 degraded GETs at a -maxInflight 4 server
OVERLOAD_THREADS, OVERLOAD_READS_PER_THREAD, OVERLOAD_MAX_INFLIGHT = 32, 25, 4
DECODED_READS = 50
CLI_VOLUME_BYTES = 64 << 20
CLI_READS = 20
# the vacuum leg's volume: cut from the same 30,000 MB limit to 1 GiB
VAC_BYTES = 1 << 30
# the failover phase: a 1 GiB volume, each repair leg slowed by 0.5 s
FAILOVER_BYTES = 1 << 30
FAILOVER_DELAY_S = 0.5
# the drain leg's GETs: of needles on moved shards, then of needles on a
# moved data shard deleted on its new holder
DRAIN_READS, DRAIN_DELETED_READS = 50, 25
# the dataplane phase: upstream weed benchmark's shapes
# (weed/command/benchmark.go: -size 1024 -c 16, replication 000, collection
# benchmark); -n cut from its 1,048,576 for the run's time limit (the
# script aims at half of it), the Zipf and threaded-front passes with it;
# then YCSB's default Zipf (theta 0.99) reads, and degraded GETs of the
# largest volume once it is EC-encoded with a server down; the batch leg
# reads 1,000 of the framed pass's needles 100 a request
BENCH_N, BENCH_SIZE, BENCH_CLIENTS = 10_000, 1024, 16
BENCH_ZIPF, BENCH_DEGRADED = 5_000, 2_000
BENCH_THREADED_WRITES = 1_000
BATCH_NEEDLES, BATCH_SIZE = 1_000, 100
# the volume_store phase: one volume of upstream weed benchmark's default
# shape (weed/command/benchmark.go: -n 1048576 -size 1024), each needle's
# payload its own; 1,000 batch deletes and 10 fids that do not exist; the
# group-commit pass: 16 writers x 250 PUTs of 1 KiB, with ?fsync=true and
# without; the backup's second pass: 1,000 more needles and 100 deletes;
# 200 degraded GETs with data shards 2 and 7 gone
STORE_NEEDLES, STORE_SIZE = 1 << 20, 1024
STORE_BATCH_DELETES, STORE_MISSING = 1_000, 10
STORE_GC_THREADS, STORE_GC_PER_THREAD = 16, 250
STORE_MORE, STORE_MORE_DELETES = 1_000, 100
STORE_DEGRADED = 200
# the backup's follower starts from a file copy of the first three
# quarters, so its first pass applies the last quarter: the phase's 240 s
# budget
STORE_FOLLOWER_SEED = STORE_NEEDLES * 3 // 4
# the budget is advisory: the phase reports within_budget and fails only
# on its checks, since the card's host runs it at speeds that drift
STORE_BUDGET_S = 240.0
# the secure_tier phase: 1 GiB into one volume (cut from the 30,000 MB
# volume default), eight writers, 200 GETs from the tier and 200 degraded
SECURE_BYTES, SECURE_THREADS = 1 << 30, 8
SECURE_TIER_GETS, SECURE_DEGRADED = 200, 200
# the native_plane phase: the dataplane phase's shapes (BENCH_*) on
# ``volume -dataplane native``; 200 degraded GETs with data shards 2 and 7
# gone; the 5-byte leg's 1,000 needles of 1,024 B; a 90 s budget,
# advisory as the volume store's
NATIVE_DEGRADED, NATIVE_FIVE_BYTE_NEEDLES = 200, 1_000
NATIVE_BUDGET_S = 90.0
# the telemetry phase: the dataplane phase's benchmark shapes (BENCH_*),
# then TELEMETRY_A Zipf GETs (YCSB's theta 0.99) over the volumes left
# replicated and TELEMETRY_B degraded GETs of the EC-encoded one (a flash
# crowd onto a cold volume), on servers with -heat.halflife
# TELEMETRY_HALFLIFE_S; its page must come within TELEMETRY_EVENT_S of the
# crowd's start; a 120 s budget, advisory as the volume store's
TELEMETRY_A, TELEMETRY_B = 5_000, 2_000
# the overhead record's passes: pass B's first 1,000 GETs (the script's
# time limit)
TELEMETRY_OVERHEAD = 1_000
TELEMETRY_HALFLIFE_S, TELEMETRY_EVENT_S = 5.0, 30.0
TELEMETRY_BUDGET_S = 120.0
# the scenarios leg, on the telemetry phase's cluster after its overhead
# passes: its recording replayed against the cluster for SCENARIOS_REPLAY_S
# by SCENARIOS_CLIENTS clients, then the capacity probe's default routes
# under its default SLO (p99 < SCENARIOS_P99_MS, errors < 0.1%) at
# SCENARIOS_STEP_S a step, its ramp capped at SCENARIOS_MAX_RPS (the
# probe's own -max default); a 75 s budget, advisory as the phase's
SCENARIOS_REPLAY_S, SCENARIOS_CLIENTS, SCENARIOS_STEP_S = 8.0, 8, 1.0
SCENARIOS_P99_MS, SCENARIOS_MAX_RPS = 5.0, 50000.0
# after the probe, this many single-client writes split into their assign
# and POST hops (write_split)
SCENARIOS_SPLIT_WRITES = 100
SCENARIOS_BUDGET_S = 75.0
SCENARIOS_ROUTES = ("http_read", "native_read", "http_write")
# the mesh phase: its device programs' width, and its advisory budget
MESH_PROGRAM_WIDTH = 8 << 20
MESH_BUDGET_S = 120.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
L2_BYTES = 50 << 20  # H100 SXM L2
# the CLI's -ec.engine names -> the device its start line names
ENGINES = {"tpu": "cuda", "mesh": "cuda", "cpu": "cpu"}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def needle_specs(seed: int, total: int):
    """(id, cookie, size) of seeded needles, sizes log-uniform in
    [NEEDLE_MIN, NEEDLE_MAX], until ``total`` bytes of data."""
    rng = np.random.default_rng(seed)
    out, used, nid = [], 0, 1
    while used < total:
        size = int(np.exp(rng.uniform(np.log(NEEDLE_MIN), np.log(NEEDLE_MAX))))
        out.append((nid, int(rng.integers(1, 1 << 32)), size))
        used += size
        nid += 1
    return out


def needle_data(seed: int, nid: int, size: int) -> bytes:
    return np.random.default_rng([seed, nid]).bytes(size)


def lut_product(m: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The GF product on the host through the 256x256 multiplication
    table: independent of both the kernel and the plain version."""
    from seaweedfs_tpu_torch.ec.gf256 import MUL_TABLE

    out = np.zeros((m.shape[0], data.shape[1]), dtype=np.uint8)
    for r in range(m.shape[0]):
        for k in range(m.shape[1]):
            out[r] ^= np.take(MUL_TABLE[m[r, k]], data[k])
    return out


def kernel_cases():
    """(name, GF matrix) for every shape family the main path launches:
    RS(10,4) parity rows (encode), composed rebuild/decode rows for 1-4
    erasures, and the other geometries and the Cauchy family."""
    from seaweedfs_tpu_torch.ec import gf256

    cases = []
    for kind, build in (("vandermonde", gf256.build_encoding_matrix),
                        ("cauchy", gf256.build_cauchy_matrix)):
        for k, r in ((10, 4), (6, 3), (12, 4)):
            cases.append((f"parity-{k}.{r}-{kind}", build(k, k + r)[k:]))
        full = build(10, 14)
        for missing in ((2,), (2, 7), (0, 3, 11), (0, 3, 11, 13)):
            survivors = [i for i in range(14) if i not in missing][:10]
            decode = gf256.mat_invert([[int(v) for v in full[i]]
                                       for i in survivors])
            rows = gf256.mat_mul([[int(v) for v in full[m]]
                                  for m in missing], decode)
            cases.append((f"decode-{len(missing)}-{kind}",
                          np.array(rows, dtype=np.uint8)))
    return cases


def check_kernel(device, widths) -> int:
    """Kernel against the plain version on ``device`` tensors, exactly,
    and each case's built table against its plain twin; returns the
    largest absolute difference seen (0)."""
    import torch

    from seaweedfs_tpu_torch.ops.gf_matmul import (gf_matmul,
                                                   gf_matmul_plain,
                                                   gf_table_build,
                                                   gf_table_plain)

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    worst = 0
    for name, m in kernel_cases():
        mt = torch.from_numpy(m.copy()).to(device)
        table = gf_table_build(mt).cpu().numpy().view(np.uint32)
        if not np.array_equal(table, gf_table_plain(m)):
            raise AssertionError(f"table != its plain twin: {name}")
        for width in widths:
            data = torch.randint(0, 256, (m.shape[1], width), generator=gen,
                                 dtype=torch.uint8).to(device)
            got = gf_matmul(mt, data)
            want = gf_matmul_plain(mt, data)
            diff = int((got.int() - want.int()).abs().max()) if width else 0
            worst = max(worst, diff)
            if diff:
                raise AssertionError(f"kernel != plain: {name} B={width}")
    # a row-strided view: a [10, b] slot used at width n, out in a wider
    # buffer; the columns past n must stay untouched
    m = kernel_cases()[0][1]
    mt = torch.from_numpy(m.copy()).to(device)
    slot = torch.randint(0, 256, (10, 70000), generator=gen,
                         dtype=torch.uint8).to(device)
    out = torch.full((4, 70016), 0xAB, dtype=torch.uint8, device=device)
    gf_matmul(mt, slot[:, 1:65538], out=out[:, 3:65540])
    want = gf_matmul_plain(mt, slot[:, 1:65538])
    if not torch.equal(out[:, 3:65540], want) or \
            not bool((out[:, :3] == 0xAB).all()) or \
            not bool((out[:, 65540:] == 0xAB).all()):
        raise AssertionError("kernel wrong on a row-strided view")
    # one shape against the host LUT
    host = np.random.default_rng(SEED).integers(0, 256, (10, 65537),
                                                dtype=np.uint8)
    got = gf_matmul(mt, torch.from_numpy(host).to(device)).cpu().numpy()
    if not np.array_equal(got, lut_product(m, host)):
        raise AssertionError("kernel != host multiplication table")
    return worst


def write_volume(store, vid: int, seed: int, total: int):
    from seaweedfs_tpu_torch.storage.needle import Needle

    store.add_volume(vid)
    specs = needle_specs(seed, total)
    for nid, cookie, size in specs:
        store.write_needle(vid, Needle(cookie=cookie, id=nid,
                                       data=needle_data(seed, nid, size)))
    return specs


def check_shards(base: str, stripes: int, seed: int,
                 shard_path=None) -> None:
    """Sampled 1 MiB stripes: parity shards == host-LUT product of the
    data shards; then every shard against its `.eci` row.  The shards
    are ``base`` + .ecNN, or ``shard_path(i)`` where they are spread over
    servers (``base`` then names a holder's `.eci`)."""
    from seaweedfs_tpu_torch.ec.gf256 import build_encoding_matrix
    from seaweedfs_tpu_torch.ec.integrity import EciSidecar, verify_shard_file
    from seaweedfs_tpu_torch.ec.layout import to_ext

    paths = [shard_path(i) if shard_path else base + to_ext(i)
             for i in range(14)]
    parity_rows = build_encoding_matrix(10, 14)[10:]
    shard_size = os.path.getsize(paths[0])
    rng = np.random.default_rng(seed)
    n = min(1 << 20, shard_size)
    fds = [os.open(p, os.O_RDONLY) for p in paths]
    try:
        for _ in range(stripes):
            off = int(rng.integers(0, shard_size - n + 1))
            rows = np.stack([np.frombuffer(os.pread(fd, n, off), np.uint8)
                             for fd in fds])
            if not np.array_equal(rows[10:], lut_product(parity_rows,
                                                         rows[:10])):
                raise AssertionError(f"{base}: parity wrong at {off}")
    finally:
        for fd in fds:
            os.close(fd)
    sidecar = EciSidecar.load(base)
    if sidecar is None or sidecar.shard_size != shard_size:
        raise AssertionError(f"{base}: no valid .eci")
    for i, path in enumerate(paths):
        bad = verify_shard_file(sidecar, path, i)
        if bad:
            raise AssertionError(f"{path}: .eci blocks {bad[:4]}")


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(8 << 20)
            if not buf:
                return h.hexdigest()
            h.update(buf)


def read_back(read, specs, seed: int, count: int, rng) -> list[float]:
    """``count`` seeded reads through ``read(nid) -> (record, size)``;
    each record must parse (its CRC checked) to the needle written.
    Returns the latencies in seconds."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.types import Version

    lat = []
    for i in rng.choice(len(specs), size=min(count, len(specs)),
                        replace=False):
        nid, cookie, size = specs[int(i)]
        t0 = time.perf_counter()
        record, stored = read(nid)
        lat.append(time.perf_counter() - t0)
        n = Needle.from_bytes(record, stored, Version.V3)
        if (n.id, n.cookie) != (nid, cookie) or \
                n.data != needle_data(seed, nid, size):
            raise AssertionError(f"degraded read of needle {nid} wrong")
    return lat


def run_main_path(device: str, work: str, volume_bytes: int,
                  large_row_volume_bytes: int, large_row_block: int,
                  reads: int, stripes: int) -> dict:
    """The main path through Store(device=...), checked at every leg.
    Returns per-leg launches, times and pipeline stats.  chip_smoke runs
    it on the card at full size; the CPU tests rehearse it tiny."""
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
    from seaweedfs_tpu_torch.ec.layout import SMALL_BLOCK_SIZE, to_ext
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.volume_server.store import Store

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    res: dict = {"launches": {}, "seconds": {}, "stats": {}}
    store = Store([work], device=device)
    try:
        t0 = time.perf_counter()
        specs = write_volume(store, 1, SEED, volume_bytes)
        base = store.get_volume(1).file_prefix
        res["seconds"]["write"] = time.perf_counter() - t0
        res["dat_bytes"] = os.path.getsize(base + ".dat")
        res["needles"] = len(specs)
        res["specs"] = specs

        before = gf_matmul.launches
        t0 = time.perf_counter()
        store.ec_generate(1)
        sync()
        res["seconds"]["encode"] = time.perf_counter() - t0
        res["launches"]["encode"] = gf_matmul.launches - before
        res["stats"]["encode"] = dict(store.streaming_encoder().stats)
        check_shards(base, stripes, SEED)

        # a second, small volume whose encode runs large-block rows
        specs2 = write_volume(store, 2, SEED + 1, large_row_volume_bytes)
        base2 = store.get_volume(2).file_prefix
        before = gf_matmul.launches
        t0 = time.perf_counter()
        store.streaming_encoder().encode_file(base2 + ".dat", base2,
                                              large_row_block,
                                              SMALL_BLOCK_SIZE)
        sync()
        res["seconds"]["encode_large_rows"] = time.perf_counter() - t0
        res["launches"]["encode_large_rows"] = gf_matmul.launches - before
        encoder.write_sorted_file_from_idx(base2)
        check_shards(base2, 4, SEED + 1)
        if os.path.getsize(base2 + ".ec00") < large_row_block:
            raise AssertionError("the large-row volume ran no large row")

        store.ec_mount(1)
        hashes = {i: sha256_file(base + to_ext(i)) for i in range(14)}
        # the clean encode's bytes, which the resume phase must reproduce
        res["hashes"] = {**{to_ext(i): h for i, h in hashes.items()},
                         ".eci": sha256_file(base + ".eci")}
        res["ecx_sha256"] = sha256_file(base + ".ecx")
        lost = [0, 3, 11, 13]
        store.ec_delete_shards(1, lost)
        before = gf_matmul.launches
        t0 = time.perf_counter()
        rebuilt = store.ec_rebuild(1)
        sync()
        res["seconds"]["rebuild"] = time.perf_counter() - t0
        res["launches"]["rebuild"] = gf_matmul.launches - before
        res["stats"]["rebuild"] = dict(store.streaming_encoder().stats)
        res["shard_bytes"] = os.path.getsize(base + to_ext(0))
        if rebuilt != lost or any(sha256_file(base + to_ext(i)) != hashes[i]
                                  for i in lost):
            raise AssertionError(f"rebuild of {lost} gave {rebuilt} or "
                                 "other bytes")

        store.ec_mount(1)
        store.ec_delete_shards(1, [2, 7])
        rng = np.random.default_rng(SEED)
        before = gf_matmul.launches
        lat = read_back(lambda nid: store.read_ec_needle(1, nid), specs,
                        SEED, reads, rng)
        res["launches"]["degraded_read"] = gf_matmul.launches - before
        res["read_latency_s"] = lat

        # degraded reads across the large rows too
        for i in (2, 7):
            os.remove(base2 + to_ext(i))
        ev = EcVolume(base2, 2, large_block_size=large_row_block)
        try:
            before = gf_matmul.launches
            read_back(lambda nid: (ev.read_needle(nid, store.rs()),
                                   ev.find_needle_from_ecx(nid)[1]),
                      specs2, SEED + 1, max(4, reads // 10), rng)
            res["launches"]["degraded_read_large_rows"] = \
                gf_matmul.launches - before
        finally:
            ev.close()
    finally:
        store.close()
    return res


def run_resume_phase(device: str, work: str, hashes: dict,
                     dispatch_b: int = 0) -> dict:
    """The main path's volume encoded again through Store(device=...)
    with ``ec.dispatch`` failing once, before the middle dispatch is
    launched: the encode must resume from its checkpoint (one retry, a
    resume byte past 0) and write the clean encode's bytes, every shard
    and the `.eci` by sha256.  ``dispatch_b`` overrides the dispatch
    width (the CPU rehearsal's volume is a few dispatches wide only at
    a narrow one).  Returns the dispatch the fault hit, launches and
    stats."""
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.utils import faultinject
    from seaweedfs_tpu_torch.volume_server.store import Store

    store = Store([work], device=device)
    try:
        enc = store.streaming_encoder()
        if dispatch_b:
            enc.dispatch_b = dispatch_b
        base = store.get_volume(1).file_prefix
        # every plan entry fills a dispatch evenly at these widths
        dispatches = -(-os.path.getsize(base + to_ext(0)) // enc.dispatch_b)
        fail_at = dispatches // 2
        if fail_at <= enc.depth + 1:
            raise AssertionError(f"{dispatches} dispatches: too few for a "
                                 "checkpoint before the fault")
        faultinject.enable("ec.dispatch", error_rate=1.0, max_hits=1,
                           after=fail_at - 1)
        try:
            before = gf_matmul.launches
            t0 = time.perf_counter()
            store.ec_generate(1)
            if device == "cuda":
                import torch

                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = gf_matmul.launches - before
            fired = faultinject.fired("ec.dispatch")
        finally:
            faultinject.clear()
        st = dict(enc.stats)
        got = {ext: sha256_file(base + ext) for ext in hashes}
    finally:
        store.close()
    if fired != 1 or st["retries"] != 1 or st["resume_byte"] <= 0:
        raise AssertionError(f"resume: fault fired {fired}, stats {st}")
    if got != hashes:
        raise AssertionError("resumed encode differs from the clean one: "
                             f"{sorted(e for e in got if got[e] != hashes[e])}")
    # a resume redoes at most the dispatches in flight at the fault; a
    # restart from byte 0 would redo all those before it
    bound = dispatches + enc.depth + 1
    if device == "cuda" and not 0 < launches <= bound:
        raise AssertionError(f"resume launched {launches} kernels for "
                             f"{dispatches} dispatches")
    return {"dispatches": dispatches, "failed_dispatch": fail_at,
            "launch_bound": bound,
            "launches": launches, "seconds": seconds,
            "resume_byte": st["resume_byte"], "stats": st}


def run_trace_ab(device: str, work: str, hashes: dict) -> dict:
    """The main path's volume encoded four times more through
    Store(device=...), the process tracer off, on (head-sampling rate 1),
    on, off.  Each must write the clean encode's bytes (every shard and
    the `.eci` by sha256) and launch the same kernels, the encoder's
    dispatch rule on the card.  Returns each run's wall and counters, and
    the last traced run's span count and analyze()'s stage attribution."""
    from seaweedfs_tpu_torch.observability import (analyze,
                                                   attribution_summary,
                                                   disable_tracing,
                                                   enable_tracing, get_tracer,
                                                   sample_rate,
                                                   set_sample_rate)
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.stats import ec_integrity_metrics
    from seaweedfs_tpu_torch.volume_server.store import Store

    tracer = get_tracer()
    was_rate = sample_rate()
    store = Store([work], device=device)
    runs: list = []
    try:
        enc = store.streaming_encoder()
        base = store.get_volume(1).file_prefix
        dispatches = enc.dispatches_for(os.path.getsize(base + ".dat"))
        for mode in ("off", "on", "on", "off"):
            if mode == "on":
                tracer.clear()
                enable_tracing()
                set_sample_rate(1.0)
            before = gf_matmul.launches
            health0 = ec_integrity_metrics().totals()
            t0 = time.perf_counter()
            store.ec_generate(1)
            if device == "cuda":
                import torch

                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({"mode": mode, "wall_s": wall,
                         "launches": gf_matmul.launches - before,
                         "stats": dict(enc.stats)})
            if mode == "on":
                disable_tracing()
                spans = tracer.snapshot()
                # this encode's integrity counts, not the process's:
                # whatever rotted before it must not mark it degraded
                health1 = ec_integrity_metrics().totals()
                report = analyze(tracer, counters={
                    k: health1[k] - health0[k] for k in health1})
            got = {ext: sha256_file(base + ext) for ext in hashes}
            if got != hashes:
                raise AssertionError(
                    f"encode with tracing {mode} differs from the clean "
                    f"one: {sorted(e for e in got if got[e] != hashes[e])}")
    finally:
        disable_tracing()
        set_sample_rate(was_rate)
        tracer.clear()
        store.close()
    launches = [r["launches"] for r in runs]
    if len(set(launches)) != 1 or (device == "cuda"
                                   and launches[0] != dispatches):
        raise AssertionError(f"launches off, on, on, off: {launches}; "
                             f"dispatch rule {dispatches}")
    names: dict[str, int] = {}
    for sp in spans:
        names[sp.name] = names.get(sp.name, 0) + 1
    if names.get("pipeline.encode_file") != 1 or \
            names.get("pipeline.dispatch") != runs[2]["stats"]["dispatches"]:
        raise AssertionError(f"traced encode spans: {names}")
    return {"runs": runs, "dispatches": dispatches, "spans": len(spans),
            "span_names": names, "dropped": report["spans_dropped"],
            "attribution": attribution_summary(report),
            "span_cost_us": span_cost_us()}


def mesh_lane_sets(device: str) -> list[list]:
    """The mesh phase's lane lists: every visible card and, on a one-card
    box, also four lanes naming card 0 (``factor_mesh(4)`` = (1, 2, 2));
    on the CPU, one and four CPU lanes."""
    import torch

    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if device == "cuda" else [torch.device("cpu")])
    return [cards, cards * 4] if len(cards) == 1 else [cards]


def check_mesh_programs(device: str, lanes: list, width: int) -> dict:
    """The mesh's device programs over ``lanes`` at [10, width]: the
    sharded encode, MeshEngine, the training step and the ring rebuild
    (rings of 2 and 5, lanes reused in turn), each against kernel 1 alone
    on lanes[0] and the plain version, byte for byte.  Returns per program
    the host ms of a warm call (inputs on the host, result back) and its
    launches, which must equal its rule on the card: dp*sp*tp a sharded
    product (R <= 4), the ring's length a ring rebuild of two shards."""
    import torch

    from seaweedfs_tpu_torch.ec import gf256
    from seaweedfs_tpu_torch.ec.codec import MeshEngine
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul, gf_matmul_plain
    from seaweedfs_tpu_torch.parallel import mesh as pm

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    full = gf256.build_encoding_matrix(10, 14)
    m = full[10:]
    data = np.random.default_rng(SEED + 20).integers(0, 256, (10, width),
                                                     dtype=np.uint8)
    mt = torch.from_numpy(m.copy()).to(lanes[0])
    dt = torch.from_numpy(data).to(lanes[0])
    sync()
    t0 = time.perf_counter()
    alone = gf_matmul(mt, dt).cpu().numpy()
    out = {"kernel_alone_ms": 1e3 * (time.perf_counter() - t0)}
    if not np.array_equal(alone, gf_matmul_plain(mt, dt).cpu().numpy()):
        raise AssertionError("kernel 1 != plain at the mesh shape")
    dims = pm.factor_mesh(len(lanes))
    mesh = pm.make_mesh(*dims, devices=lanes)
    per = dims[0] * dims[1] * dims[2]

    def timed(name: str, call, check, rule: int) -> None:
        call()  # the lanes' matrices go up once, as in a server
        before = gf_matmul.launches
        t0 = time.perf_counter()
        got = call()
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = gf_matmul.launches - before
        if not check(got):
            raise AssertionError(f"mesh program {name} over {lanes} differs "
                                 "from kernel 1")
        if device == "cuda" and launches != rule:
            raise AssertionError(f"mesh program {name}: {launches} launches, "
                                 f"rule {rule}")
        out[name] = {"ms": ms, "launches": launches, "rule": rule}

    encode = pm.sharded_encode_fn(mesh)
    grid = data.reshape(10, dims[0], -1)
    timed("sharded_encode",
          lambda: encode(m, grid).numpy().reshape(4, width),
          lambda got: np.array_equal(got, alone), per)
    engine = MeshEngine(mesh=mesh)
    timed("mesh_engine", lambda: engine.matmul(m, data),
          lambda got: np.array_equal(got, alone), per)
    sub = [[int(v) for v in full[i]] for i in list(range(1, 10)) + [10]]
    decode = np.array(gf256.mat_invert(sub), dtype=np.uint8)[:1]
    step = pm.training_step_fn(mesh)
    timed("training_step", lambda: step(m, decode, grid),
          lambda got: got[1] == 0 and np.array_equal(
              got[0].numpy().reshape(4, width), alone), 2 * per)
    shards = np.concatenate([data, alone])
    missing = [2, 11]
    survivors = [i for i in range(14) if i not in missing][:10]
    rec = np.array(gf256.mat_mul(
        [[int(v) for v in full[i]] for i in missing],
        gf256.mat_invert([[int(v) for v in full[i]] for i in survivors])),
        dtype=np.uint8)
    recs = torch.from_numpy(rec).to(lanes[0])
    surv = torch.from_numpy(shards[survivors]).to(lanes[0])
    if not (np.array_equal(gf_matmul(recs, surv).cpu().numpy(),
                           shards[missing]) and np.array_equal(
            gf_matmul_plain(recs, surv).cpu().numpy(), shards[missing])):
        raise AssertionError("kernel 1 / plain rebuild of shards 2 and 11")
    del surv
    for n in (2, 5):
        ring = pm.ring_rebuild_fn(pm.make_mesh(
            1, 1, n, devices=[lanes[i % len(lanes)] for i in range(n)]))
        timed(f"ring_rebuild_{n}",
              lambda: ring(rec, shards[survivors]).numpy(),
              lambda got: np.array_equal(got, shards[missing]), n)
    return out


def mesh_degraded_gets(device: str, work: str, specs: list, lanes: list,
                       threads: int, per_thread: int) -> dict:
    """A volume server over ``lanes`` (``ec_engine="mesh"``) holding the
    main path's EC volume with data shards 2 and 7 gone: ``threads``
    clients at once GET distinct needles that lie on those shards, each
    body checked, so the server's request threads call its one
    MeshEngine concurrently.  Returns the latencies and the launches,
    which must be dp*sp*tp for each interval on a lost shard."""
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.parallel.mesh import factor_mesh
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    lost = (2, 7)
    src, dst = work, os.path.join(work, "mesh_get")
    skip = {"1.dat", "1.idx"} | {"1" + to_ext(i) for i in lost}
    os.makedirs(dst)
    try:
        for name in os.listdir(src):
            if name.startswith("1.") and name not in skip and \
                    os.path.isfile(os.path.join(src, name)):
                os.link(os.path.join(src, name), os.path.join(dst, name))
        shards_of = needle_shards(os.path.join(dst, "1"), 1,
                                  [nid for nid, _, _ in specs])
        on_lost = [(spec, sum(s in lost for s in sh))
                   for spec, sh in zip(specs, shards_of)
                   if any(s in lost for s in sh)]
        rng = np.random.default_rng(SEED + 21)
        picks = [on_lost[int(i)] for i in rng.choice(
            len(on_lost), size=min(threads * per_thread, len(on_lost)),
            replace=False)]
        if not picks:
            raise AssertionError("no needle lies on shards 2 and 7")
        dims = factor_mesh(len(lanes))
        per = dims[0] * dims[1] * dims[2]
        rule = per * sum(n for _, n in picks) if device == "cuda" else 0
        lat: list[float] = []
        errors: list[BaseException] = []
        # the master's address is a closed port: lookups of the lost
        # shards fail at once and the server reconstructs locally
        vs = VolumeServer([dst], f"127.0.0.1:{free_port()}", port=free_port(),
                          device=device, ec_engine="mesh",
                          ec_mesh_devices=lanes).start()

        def reader(t: int) -> None:
            c = Conn(vs.url)
            try:
                for (nid, cookie, size), _ in picks[t::threads]:
                    t0 = time.perf_counter()
                    status, body, _ = c.call(
                        "GET", "/" + str(FileId(1, nid, cookie)))
                    lat.append(time.perf_counter() - t0)
                    if status != 200 or body != needle_data(SEED, nid, size):
                        raise AssertionError(f"degraded GET of {nid} from "
                                             f"the mesh server: {status}")
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
            finally:
                c.close()

        try:
            before = gf_matmul.launches
            t0 = time.perf_counter()
            workers = [threading.Thread(target=reader, args=(t,))
                       for t in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
            wall = time.perf_counter() - t0
            launches = gf_matmul.launches - before
            lanes_used = [str(d) for d in vs.store.rs().engine.devices]
        finally:
            vs.stop()
        if errors or any(w.is_alive() for w in workers) or \
                len(lat) != len(picks):
            raise AssertionError(f"mesh server's degraded GETs: "
                                 f"{errors[:1]}")
        if launches != rule:
            raise AssertionError(f"mesh server's degraded GETs: {launches} "
                                 f"launches, rule {rule}")
    finally:
        shutil.rmtree(dst, ignore_errors=True)
    ms = np.array(lat) * 1e3
    return {"lanes": lanes_used, "threads": threads, "gets": len(picks),
            "wall_s": wall, "launches": launches, "rule": rule,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def run_mesh_phase(device: str, work: str, hashes: dict, specs: list,
                   lane_sets: list, program_width: int,
                   cli_engine: str = "mesh", dispatch_b: int = 0,
                   threads: int = HTTP_THREADS,
                   per_thread: int = HTTP_READS_PER_THREAD) -> dict:
    """``-ec.engine mesh`` on the main path's volume: for each lane list
    the device programs (``check_mesh_programs``), then
    ``Store(ec_engine="mesh")`` encoding the volume (the clean encode's
    sha256 of every shard and the `.eci`; launches = the dispatch rule)
    and rebuilding shards 2 and 11 to their sha256 (its first lane); the
    last list's encode traced and read per lane by ``analyze()``, and a
    volume server over it answering ``threads`` x ``per_thread``
    concurrent degraded GETs (``mesh_degraded_gets``; ``specs`` are the
    main path's needles).  Then
    the device engine's split over the last list (dp*sp*tp launches a
    dispatch, the same bytes, and its rebuild), and one
    ``python -m seaweedfs_tpu_torch volume -ec.engine <cli_engine>``
    process (``-ec.mesh.devices 0,`` for mesh) answering ``POST
    /admin/ec/generate`` with the same bytes and the rule's launches in
    its stop line.  ``dispatch_b`` overrides the in-process encoders'
    dispatch width (the CPU rehearsal's).  Returns each run's walls,
    launches and rules."""
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.observability import (analyze, disable_tracing,
                                                   enable_tracing, get_tracer)
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.volume_server.store import Store

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    def same(prefix: str, exts) -> bool:
        return all(sha256_file(prefix + e) == hashes[e] for e in exts)

    t_phase = time.perf_counter()
    res: dict = {"programs": [], "store": [], "path_launches": 0}
    base = os.path.join(work, "1")
    dat_bytes = os.path.getsize(base + ".dat")
    lost = [to_ext(i) for i in (2, 11)]
    tracer = get_tracer()
    for li, lanes in enumerate(lane_sets):
        names = [str(d) for d in lanes]
        res["programs"].append({"lanes": names, **check_mesh_programs(
            device, lanes, program_width)})
        store = Store([work], device=device, ec_engine="mesh",
                      ec_mesh_devices=lanes)
        try:
            enc = store.streaming_encoder()
            enc.dispatch_b = dispatch_b or enc.dispatch_b
            rule = enc.dispatches_for(dat_bytes) * enc.launches_per_dispatch()
            traced = li == len(lane_sets) - 1
            if traced:
                tracer.clear()
                enable_tracing()
            try:
                before = gf_matmul.launches
                t0 = time.perf_counter()
                store.ec_generate(1)
                sync()
                encode_s = time.perf_counter() - t0
                launches = gf_matmul.launches - before
                report = analyze(tracer) if traced else None
            finally:
                if traced:
                    disable_tracing()
                    tracer.clear()
            st = dict(enc.stats)
            if not same(base, hashes):
                raise AssertionError(f"mesh encode over {names} differs "
                                     "from the main path's")
            for ext in lost:
                os.remove(base + ext)
            shard = os.path.getsize(base + to_ext(0))
            rebuild_rule = -(-shard // enc.dispatch_b)
            before = gf_matmul.launches
            t0 = time.perf_counter()
            rebuilt = store.ec_rebuild(1)
            sync()
            rebuild_s = time.perf_counter() - t0
            rebuild_launches = gf_matmul.launches - before
            if rebuilt != [2, 11] or not same(base, lost):
                raise AssertionError(f"mesh rebuild over {names}: {rebuilt}")
        finally:
            store.close()
        if device == "cuda" and (launches, rebuild_launches) != (
                rule, rebuild_rule):
            raise AssertionError(
                f"mesh over {names}: launches {launches} / "
                f"{rebuild_launches}, rules {rule} / {rebuild_rule}")
        res["path_launches"] += launches + rebuild_launches
        run = {"lanes": names, "cards": len(set(names)),
               "encode_s": encode_s, "launches": launches, "rule": rule,
               "rebuild_s": rebuild_s, "rebuild_launches": rebuild_launches,
               "rebuild_rule": rebuild_rule, "dispatches": st["dispatches"],
               "stats": st}
        if report is not None:
            (r0,) = report["runs"]
            run["per_lane_fetch_s"] = {
                k: v["fetch_s"] for k, v in
                r0["drain_profile"]["per_device"].items()}
        res["store"].append(run)
    res["degraded_gets"] = mesh_degraded_gets(device, work, specs,
                                              lane_sets[-1], threads,
                                              per_thread)
    res["path_launches"] += res["degraded_gets"]["launches"]

    # the device engine's split over the last lane list
    lanes = lane_sets[-1]
    enc = StreamingEncoder(device=device, devices=lanes, mesh=True)
    enc.dispatch_b = dispatch_b or enc.dispatch_b
    out = os.path.join(work, "split")
    rule = enc.dispatches_for(dat_bytes) * enc.launches_per_dispatch()
    before = gf_matmul.launches
    t0 = time.perf_counter()
    enc.encode_file(base + ".dat", out)
    sync()
    split = {"lanes": [str(d) for d in lanes], "mesh": list(enc.mesh.shape),
             "encode_s": time.perf_counter() - t0,
             "launches": gf_matmul.launches - before, "rule": rule,
             "stats": dict(enc.stats)}
    try:
        if not same(out, hashes):
            raise AssertionError("split encode differs from the main path's")
        for ext in lost:
            os.remove(out + ext)
        shard = os.path.getsize(out + to_ext(0))
        rebuild_rule = -(-shard // enc.dispatch_b) * \
            enc.launches_per_dispatch(rows=2)
        before = gf_matmul.launches
        t0 = time.perf_counter()
        if enc.rebuild_files(out) != [2, 11] or not same(out, lost):
            raise AssertionError("split rebuild of shards 2 and 11")
        sync()
        split.update(rebuild_s=time.perf_counter() - t0,
                     rebuild_launches=gf_matmul.launches - before,
                     rebuild_rule=rebuild_rule)
    finally:
        _remove_prefix(out)
    if device == "cuda" and (split["launches"], split["rebuild_launches"]) \
            != (rule, rebuild_rule):
        raise AssertionError(f"split launches: {split}")
    res["split"] = split
    res["path_launches"] += split["launches"] + split["rebuild_launches"]

    # one CLI process: POST /admin/ec/generate
    cli_dir = os.path.join(work, "mesh_cli")
    os.makedirs(cli_dir)
    try:
        for ext in (".dat", ".idx"):
            os.link(base + ext, os.path.join(cli_dir, "1" + ext))
        port = free_port()
        log_path = os.path.join(work, "mesh_cli.log")
        args = ["volume", "-dir", cli_dir, "-port", str(port), "-mserver",
                f"127.0.0.1:{free_port()}", "-ec.engine", cli_engine]
        if cli_engine == "mesh":
            args += ["-ec.mesh.devices", "0,"]
        t0 = time.perf_counter()
        proc = start_cli(args, log_path)
        try:
            line = read_start_line(proc, log_path, "volume server listening")
            if cli_engine == "mesh" and "mesh over 1 lanes (cuda:0)" \
                    not in line:
                raise AssertionError(f"start line {line!r}")
            cli = {"start_line": line,
                   "start_s": time.perf_counter() - t0}
            conn = Conn(f"127.0.0.1:{port}")
            try:
                t0 = time.perf_counter()
                conn.admin("/admin/ec/generate",
                           {"volume_id": 1, "engine": cli_engine})
                cli["generate_s"] = time.perf_counter() - t0
            finally:
                conn.close()
            if not same(os.path.join(cli_dir, "1"), hashes):
                raise AssertionError("the CLI's mesh encode differs from the "
                                     "main path's")
            cli["launches"] = stop_volume_server(proc)["launches"]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    # one lane at the default width: a launch a dispatch
    cli["rule"] = StreamingEncoder(device=device, engine="mesh",
                                   devices=lane_sets[0][:1]).dispatches_for(
        dat_bytes)
    if device == "cuda" and cli["launches"] != cli["rule"]:
        raise AssertionError(f"the CLI's mesh encode: {cli}")
    res["cli"] = cli
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _remove_prefix(prefix: str) -> None:
    from seaweedfs_tpu_torch.ec.layout import to_ext

    for ext in [to_ext(i) for i in range(14)] + [".eci"]:
        try:
            os.remove(prefix + ext)
        except OSError:
            pass


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds per span on this machine: a disabled tracer's
    shared no-op, an enabled one's span outside any trace, and one under
    a sampled trace context with a shipping hook that only buffers."""
    from seaweedfs_tpu_torch.observability import context
    from seaweedfs_tpu_torch.observability.tracer import Tracer

    out = {}
    for name in ("disabled", "enabled", "sampled"):
        tr = Tracer(enabled=name != "disabled", capacity=n)
        shipped: list = []
        tr.on_record = shipped.append
        prev = context.activate(context.TraceContext(context.new_trace_id())
                                if name == "sampled" else None)
        try:
            t0 = time.perf_counter()
            for i in range(n):
                with tr.span("pipeline.fill", dispatch=i, bytes=1):
                    pass
            out[name] = 1e6 * (time.perf_counter() - t0) / n
        finally:
            context.activate(prev)
    return out


# a profile's samples, by frame: the port's modules have distinct file
# names but server.py, so a frame's (file, function) tells its layer
PROFILE_HZ = 100
PROFILE_ROUNDS = 4
_SHIPPER_FUNCS = {"_on_span", "_note_lost_locked", "_flush_loop", "_flush",
                  "_on_event", "flush", "_ship"}
_COLLECTOR_FUNCS = {"ingest", "_evict", "get", "summaries", "chrome",
                    "query"}
_JSON_FUNCS = {"dumps", "loads", "encode", "iterencode", "decode",
               "raw_decode"}
_EC_FILES = {"codec.py", "ec_volume.py", "encoder.py", "gf256.py",
             "integrity.py", "layout.py", "streaming.py", "overlap.py"}
# a thread parked here waits for work: a lock, an event, a poll, a listen
# (the reactor's watchdog sleeps 0.25 s in C between its microsecond
# checks, so its leaf is its own frame)
_IDLE_LEAVES = {("threading.py", "wait"),
                ("threading.py", "_wait_for_tstate_lock"),
                ("selectors.py", "select"), ("socket.py", "accept"),
                ("eventloop.py", "_watch")}
_FRAME_RE = re.compile(r"^(.*) \((.*):(\d+)\)$")
PROFILE_LAYERS = ("tracer", "shippers", "collector", "json", "http_client",
                  "httpd", "ec", "kernel_wrapper")


def _frame(label: str) -> tuple[str, str, int]:
    m = _FRAME_RE.match(label)
    return (m.group(2), m.group(1), int(m.group(3))) if m else ("", label, 0)


@functools.lru_cache(maxsize=None)
def http_client_lines() -> range:
    """utils/httpd.py's pooled client by line, from ``_RawConn`` through
    ``http_download``: its frames are told from the server's (``Request``,
    ``Response``, the router) by where they stand in the file, not by
    method names the two sides share."""
    import inspect

    from seaweedfs_tpu_torch.utils import httpd

    first = inspect.getsourcelines(httpd._RawConn)[1]
    src, start = inspect.getsourcelines(httpd.http_download)
    return range(first, start + len(src))


def frame_layer(file: str, func: str, line: int) -> str:
    """The layer of a (file, function, line) frame, or "" for none: the
    span tracer and journal, the shippers, the master's collector, json,
    the HTTP client calls (httpd's pooled client, by line), the HTTP
    server (httpd's router, the reactor), ``ec/``, the kernel wrapper."""
    if file in ("tracer.py", "context.py"):
        return "tracer"
    if file in ("collector.py", "events.py"):
        return ("shippers" if func in _SHIPPER_FUNCS else
                "collector" if func in _COLLECTOR_FUNCS else "tracer")
    if file == "analysis.py":
        return "collector"
    if file == "leader.py":
        return "shippers"
    if file in ("__init__.py", "encoder.py", "decoder.py") and \
            func in _JSON_FUNCS:
        return "json"
    if file == "client.py" or (file == "httpd.py"
                               and line in http_client_lines()):
        return "http_client"
    if file in ("httpd.py", "socketserver.py", "eventloop.py"):
        return "httpd"
    if file in _EC_FILES:
        return "ec"
    if file == "gf_matmul.py":
        return "kernel_wrapper"
    return ""


def profile_summary(collapsed: str) -> dict:
    """One /debug/profile body -> its stack samples by thread (digits
    folded), busy ones by thread, the ten heaviest leaf frames, the
    ticks (MainThread's samples) and the mean stack depth, and where the
    busy samples went.  A sample whose leaf waits for work
    (``_IDLE_LEAVES``) is idle, one whose leaf reads a socket waits on a
    peer (``socket_read``); the rest are busy.  ``self_share``: each busy
    sample goes to the layer of the frame nearest its leaf that has one,
    else ``other``; ``under_share``: to every layer on its stack (the
    request thread's whole work is under httpd).  Both are of the busy
    samples; ``idle`` and ``socket_read`` are of all of them."""
    threads: dict[str, int] = {}
    busy_threads: dict[str, int] = {}
    leaves: dict[str, int] = {}
    self_n = dict.fromkeys(PROFILE_LAYERS + ("other",), 0)
    under_n = dict.fromkeys(PROFILE_LAYERS, 0)
    total = idle = socket_read = depth = 0
    for line in collapsed.splitlines():
        stack, _, count = line.rpartition(" ")
        n = int(count)
        parts = stack.split(";")
        total += n
        depth += n * (len(parts) - 1)
        name = re.sub(r"\d+", "N", parts[0])
        threads[name] = threads.get(name, 0) + n
        frames = [_frame(p) for p in parts[1:]]
        if not frames:
            continue
        leaves[parts[-1]] = leaves.get(parts[-1], 0) + n
        if frames[-1][:2] in _IDLE_LEAVES:
            idle += n
            continue
        if frames[-1][0] == "socket.py" and \
                frames[-1][1] in ("readinto", "recv_into", "recv"):
            socket_read += n
            continue
        busy_threads[name] = busy_threads.get(name, 0) + n
        layers = [frame_layer(*f) for f in frames]
        self_n[next((x for x in reversed(layers) if x), "other")] += n
        for layer in set(layers) - {""}:
            under_n[layer] += n
    busy = total - idle - socket_read
    top = sorted(leaves.items(), key=lambda kv: -kv[1])[:10]
    return {"stack_samples": total, "ticks": threads.get("MainThread", 0),
            "mean_depth": depth / max(total, 1), "busy_samples": busy,
            "idle_share": idle / max(total, 1),
            "socket_read_share": socket_read / max(total, 1),
            "threads": dict(sorted(threads.items(), key=lambda kv: -kv[1])),
            "busy_threads": dict(sorted(busy_threads.items(),
                                        key=lambda kv: -kv[1])),
            "top_leaves": [{"frame": f, "samples": n} for f, n in top],
            "self_share": {k: v / max(busy, 1) for k, v in self_n.items()},
            "under_share": {k: v / max(busy, 1) for k, v in under_n.items()}}


class Profiling:
    """``with Profiling(urls, seconds, hz) as p:`` fetches ``GET
    /debug/profile?seconds=&hz=`` from every url at once, on threads, for
    the block's duration; ``p.texts`` holds each body after the block."""

    def __init__(self, urls, seconds: float, hz: float):
        self.urls, self.seconds, self.hz = list(urls), seconds, hz
        self.texts: dict[str, str] = {}
        self.errors: list[BaseException] = []

    def _fetch(self, url: str) -> None:
        from seaweedfs_tpu_torch.utils.httpd import http_bytes

        try:
            status, body, _ = http_bytes(
                "GET", f"http://{url}/debug/profile?seconds={self.seconds}"
                       f"&hz={self.hz}", timeout=self.seconds + 60)
            if status != 200:
                raise AssertionError(f"{url}/debug/profile: {status}")
            self.texts[url] = body.decode()
        except BaseException as e:  # noqa: BLE001 - re-raised on exit
            self.errors.append(e)

    def __enter__(self) -> "Profiling":
        self._threads = [threading.Thread(target=self._fetch, args=(u,))
                         for u in self.urls]
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc) -> bool:
        for t in self._threads:
            t.join(timeout=self.seconds + 90)
        if exc[0] is None and (self.errors or
                               set(self.texts) != set(self.urls)):
            raise AssertionError(f"profiles: {self.errors[:1]}")
        return False


def sample_cost_us(threads: int, depth: int = 40, n: int = 200) -> float:
    """Host microseconds one sample of ``SamplingProfiler`` takes in a
    process with ``threads`` other threads parked ``depth`` frames deep
    (what it takes from the GIL ``hz`` times a second)."""
    from seaweedfs_tpu_torch.observability.profiler import SamplingProfiler

    release = threading.Event()
    ready = threading.Barrier(threads + 1)

    def park(d: int) -> None:
        if d:
            return park(d - 1)
        ready.wait()
        release.wait()

    parked = [threading.Thread(target=park, args=(depth,))
              for _ in range(threads)]
    for t in parked:
        t.start()
    try:
        ready.wait()
        prof = SamplingProfiler()
        skip = {threading.get_ident()}
        t0 = time.perf_counter()
        for _ in range(n):
            prof._sample_once(skip)
        return 1e6 * (time.perf_counter() - t0) / n
    finally:
        release.set()
        for t in parked:
            t.join()


def thread_census(dump: str) -> dict[str, int]:
    """A /debug/pprof/goroutine body -> threads per name, digits folded."""
    out: dict[str, int] = {}
    for m in re.finditer(r"^--- (.*?)(?: daemon=\w+)? ---$", dump, re.M):
        name = re.sub(r"\d+", "N", m.group(1))
        out[name] = out.get(name, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


_PICKED: set[int] = set()


@functools.lru_cache(maxsize=1)
def _quiet_ports() -> tuple[int, ...]:
    """Ports from 10000 up that lie, with their derived framed port,
    outside the host's ephemeral range."""
    from seaweedfs_tpu_torch.utils.framing import tcp_port_for

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        lo, hi = 32768, 60999
    return tuple(p for p in range(10000, 65536)
                 if not lo <= p <= hi and not lo <= tcp_port_for(p) <= hi)


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def free_port() -> int:
    """An HTTP port for a server of this run.  Every port server also
    binds its framed-TCP plane on the derived port (``tcp_port_for``:
    +20000, or -20000 past 65535), and a derived port that is taken
    brings the server up degraded.  So the pick and its derived port are
    both free now, neither was handed out before in this run (nor its
    derived port), and where the host's ephemeral range leaves room both
    lie outside it, where no client socket is given a port."""
    from seaweedfs_tpu_torch.utils.framing import tcp_port_for

    def usable(p: int) -> bool:
        d = tcp_port_for(p)
        return 1024 <= d <= 65535 and not {p, d} & _PICKED

    outside = _quiet_ports()
    rng = np.random.default_rng()
    for _ in range(256):
        if outside:
            p = int(outside[int(rng.integers(len(outside)))])
        else:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                p = s.getsockname()[1]
        if usable(p) and _bindable(p) and _bindable(tcp_port_for(p)):
            _PICKED.update((p, tcp_port_for(p)))
            return p
    raise RuntimeError("no free port with a free derived framed port")


class Conn:
    """One keep-alive HTTP/1.1 connection to a volume server, as a reader
    or an operator's tool holds it."""

    def __init__(self, url: str):
        host, port = url.split(":")
        self.c = http.client.HTTPConnection(host, int(port), timeout=600)
        self.c.connect()
        self.c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def call(self, method: str, path: str, body=None, headers=None):
        self.c.request(method, path, body=body, headers=headers or {})
        r = self.c.getresponse()
        return r.status, r.read(), r

    def admin(self, path: str, payload: dict) -> dict:
        status, body, _ = self.call("POST", path, json.dumps(payload).encode(),
                                    {"Content-Type": "application/json"})
        if status != 200:
            raise AssertionError(f"{path}: {status} {body[:300]!r}")
        return json.loads(body)

    def close(self) -> None:
        self.c.close()


def http_needle(seed: int, i: int, nid: int, cookie: int, size: int) -> dict:
    """The PUT of needle ``nid`` and what a GET must give back: every
    tenth needle carries, in turn, a gzip body, a name or a mime type."""
    from seaweedfs_tpu_torch.storage.crc import crc32c
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils.compression import gzip_data

    data = needle_data(seed, nid, size)
    n = {"path": "/" + str(FileId(1, nid, cookie)), "data": data,
         "body": data, "headers": {}, "query": "",
         "type": "application/octet-stream", "name": None}
    kind = (i // 10) % 3 if i % 10 == 0 else None
    if kind == 0:
        n["body"] = gzip_data(data)
        n["headers"]["Content-Encoding"] = "gzip"
    elif kind == 1:
        n["name"] = f"needle-{nid}.bin"
        n["query"] = f"?name={n['name']}"
    elif kind == 2:
        n["type"] = n["headers"]["Content-Type"] = "image/jpeg"
    n["etag"] = '"%08x"' % crc32c(n["body"])
    return n


def check_get(conn: Conn, n: dict) -> float:
    """GET one needle: bytes, ETag, Content-Type and name must be the
    written ones.  Returns the latency in seconds."""
    t0 = time.perf_counter()
    status, body, r = conn.call("GET", n["path"])
    lat = time.perf_counter() - t0
    disp = r.getheader("Content-Disposition")
    if status != 200 or body != n["data"] or r.getheader("ETag") != n["etag"] \
            or r.getheader("Content-Type") != n["type"] \
            or (n["name"] is not None) != (disp is not None):
        raise AssertionError(f"GET {n['path']}: {status}, "
                             f"{len(body)} bytes, {dict(r.getheaders())}")
    return lat


def check_gzip_served_as_stored(conn: Conn, n: dict) -> None:
    """A gzip-stored needle goes out gzipped to a client that accepts it."""
    from seaweedfs_tpu_torch.utils.compression import (is_gzipped_content,
                                                       ungzip_data)

    status, body, r = conn.call("GET", n["path"],
                                headers={"Accept-Encoding": "gzip"})
    if status != 200 or r.getheader("Content-Encoding") != "gzip" or \
            not is_gzipped_content(body) or ungzip_data(body) != n["data"]:
        raise AssertionError(f"gzip GET of {n['path']}: {status}")


def check_conditional_and_range(conn: Conn, n: dict) -> None:
    status, _, _ = conn.call("GET", n["path"],
                             headers={"If-None-Match": n["etag"]})
    if status != 304:
        raise AssertionError(f"If-None-Match on {n['path']}: {status}")
    size = len(n["data"])
    status, body, r = conn.call("GET", n["path"],
                                headers={"Range": "bytes=7-1030"})
    end = min(1030, size - 1)
    if status != 206 or body != n["data"][7:end + 1] or \
            r.getheader("Content-Range") != f"bytes 7-{end}/{size}":
        raise AssertionError(f"Range on {n['path']}: {status}")


def concurrent_gets(url: str, needles: list[dict], threads: int,
                    per_thread: int, seed: int) -> list[float]:
    """``threads`` readers at once, each on its own connection, each GETting
    ``per_thread`` seeded needles, byte-checked.  Returns the latencies."""
    lat: list[float] = []
    errors: list[BaseException] = []

    def reader(t: int) -> None:
        c = Conn(url)
        try:
            picks = np.random.default_rng([seed, t]).choice(
                len(needles), size=per_thread)
            lat.extend(check_get(c, needles[int(i)]) for i in picks)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            c.close()

    workers = [threading.Thread(target=reader, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    if errors or any(w.is_alive() for w in workers) or \
            len(lat) != threads * per_thread:
        raise AssertionError(f"concurrent degraded GETs: {errors[:1]}")
    return lat


def run_http_path(device: str, work: str, volume_bytes: int, reads: int,
                  threads: int, per_thread: int, decoded_reads: int,
                  stripes: int, overload_threads: int,
                  overload_per_thread: int,
                  overload_max_inflight: int) -> dict:
    """The EC lifecycle through the volume server's own HTTP entry points,
    checked at every step, with the overload leg (``run_overload``) after
    the degraded GETs.  Returns per-leg launches, times and read
    latencies.  chip_smoke runs it on the card at full size; the CPU
    tests rehearse it tiny."""
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    res: dict = {"launches": {}, "seconds": {}}
    seed = SEED + 2
    # the master's address is a closed port: heartbeats and remote-shard
    # lookups fail at once and degraded reads reconstruct locally
    vs = VolumeServer([work], f"127.0.0.1:{free_port()}", port=free_port(),
                      device=device).start()
    conn = Conn(vs.url)
    try:
        conn.admin("/admin/assign_volume", {"volume_id": 1})
        needles = [http_needle(seed, i, nid, cookie, size) for i, (
            nid, cookie, size) in enumerate(needle_specs(seed, volume_bytes))]
        t0 = time.perf_counter()
        for n in needles:
            status, body, _ = conn.call("PUT", n["path"] + n["query"],
                                        n["body"], n["headers"])
            if status != 201:
                raise AssertionError(f"PUT {n['path']}: {status} {body!r}")
        res["seconds"]["write"] = time.perf_counter() - t0
        base = vs.store.get_volume(1).file_prefix
        res["dat_bytes"] = os.path.getsize(base + ".dat")
        res["needles"] = len(needles)

        conn.admin("/admin/readonly", {"volume_id": 1})
        before = gf_matmul.launches
        t0 = time.perf_counter()
        conn.admin("/admin/ec/generate", {"volume_id": 1, "engine": "tpu"})
        sync()
        res["seconds"]["encode"] = time.perf_counter() - t0
        res["launches"]["encode"] = gf_matmul.launches - before
        conn.admin("/admin/ec/mount", {"volume_id": 1})
        conn.admin("/admin/delete_volume", {"volume_id": 1})
        check_shards(base, stripes, seed)
        res["shard_bytes"] = os.path.getsize(base + to_ext(0))

        rng = np.random.default_rng(seed)
        sample = [needles[int(i)] for i in rng.choice(
            len(needles), size=min(reads, len(needles)), replace=False)]
        for n in sample:
            check_get(conn, n)
        check_conditional_and_range(conn, next(
            n for n in sample if "Content-Encoding" not in n["headers"]))
        check_gzip_served_as_stored(conn, next(
            n for n in needles if "Content-Encoding" in n["headers"]))

        lost = [0, 3, 11, 13]
        hashes = {i: sha256_file(base + to_ext(i)) for i in lost}
        conn.admin("/admin/ec/delete", {"volume_id": 1, "shard_ids": lost})
        before = gf_matmul.launches
        t0 = time.perf_counter()
        rebuilt = conn.admin("/admin/ec/rebuild",
                             {"volume_id": 1})["rebuilt_shard_ids"]
        sync()
        res["seconds"]["rebuild"] = time.perf_counter() - t0
        res["launches"]["rebuild"] = gf_matmul.launches - before
        if rebuilt != lost or any(sha256_file(base + to_ext(i)) != hashes[i]
                                  for i in lost):
            raise AssertionError(f"rebuild of {lost} gave {rebuilt} or "
                                 "other bytes")

        conn.admin("/admin/ec/mount", {"volume_id": 1})
        conn.admin("/admin/ec/delete", {"volume_id": 1, "shard_ids": [2, 7]})
        before = gf_matmul.launches
        res["latency_1_client_s"] = [check_get(conn, n) for n in sample]
        res["latency_8_clients_s"] = concurrent_gets(
            vs.url, needles, threads, per_thread, seed)
        res["launches"]["degraded_get"] = gf_matmul.launches - before
        before = gf_matmul.launches
        res["overload"] = run_overload(
            device, work, os.path.join(work, "overload"), needles, seed,
            overload_threads, overload_per_thread, overload_max_inflight)
        res["launches"]["overload"] = gf_matmul.launches - before

        if conn.admin("/admin/ec/rebuild",
                      {"volume_id": 1})["rebuilt_shard_ids"] != [2, 7]:
            raise AssertionError("second rebuild")
        conn.admin("/admin/ec/mount", {"volume_id": 1})
        before = gf_matmul.launches
        res["scrub"] = scrub_and_repair(vs, base, needles, seed)
        res["launches"]["scrub_repair"] = gf_matmul.launches - before
        t0 = time.perf_counter()
        conn.admin("/admin/ec/to_volume", {"volume_id": 1})
        res["seconds"]["to_volume"] = time.perf_counter() - t0
        if 1 not in vs.store.volumes or 1 in vs.store.ec_volumes:
            raise AssertionError("to_volume did not mount the volume")
        for i in rng.choice(len(needles), size=min(decoded_reads,
                                                    len(needles)),
                            replace=False):
            check_get(conn, needles[int(i)])
    finally:
        conn.close()
        vs.stop()
    return res


def metric_value(url: str, family: str, *labels: str) -> float:
    """One sample of a server's /metrics, parsed as the master's
    aggregator parses it (0 while the family has no such sample)."""
    from seaweedfs_tpu_torch.stats.aggregate import parse_prometheus_text
    from seaweedfs_tpu_torch.utils.httpd import http_bytes

    status, body, _ = http_bytes("GET", f"http://{url}/metrics")
    if status != 200:
        raise AssertionError(f"{url}/metrics: {status}")
    fam = parse_prometheus_text(body.decode()).get(family)
    return 0.0 if fam is None else fam.value(*labels)


def run_overload(device: str, src: str, dst: str, needles: list[dict],
                 seed: int, threads: int, per_thread: int,
                 max_inflight: int) -> dict:
    """The overload leg: an in-process ``MasterServer`` and
    ``VolumeServer(device=..., max_inflight=...)`` over hard links of the
    EC volume in ``src`` (data shards 2 and 7 gone, no other holder), and
    ``threads`` readers at once each GETting ``per_thread`` seeded needles
    while a monitor polls /metrics and /status.  Every answer must be 200
    with the written bytes and ETag (the needle's CRC) or the shed's 503
    with ``Retry-After: 1`` and its body; the 503s, the change of
    ``SeaweedFS_requests_shed_total{role="volume"}``, the controller's
    ``shed_total`` and the change of the master's /cluster/health
    ``requests_shed`` must be equal; the server must reconstruct exactly
    the intervals of lost shards the admitted GETs read, and on the card
    launch one kernel for each; the monitor must get only 200s; the
    journal at most one ``load_shed`` a second of the storm.  Then one
    GET whose ``X-Weed-Deadline`` is spent: a 504 that moves
    ``SeaweedFS_deadline_exceeded_total{role="volume"}`` and the health's
    ``deadline_exceeded`` by one and runs nothing."""
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.observability.alerts import Rule
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    os.makedirs(dst)
    for name in os.listdir(src):
        if name.startswith("1.") and os.path.isfile(os.path.join(src, name)):
            os.link(os.path.join(src, name), os.path.join(dst, name))
    shards_of = needle_shards(os.path.join(dst, "1"), 1, [
        FileId.parse(n["path"][1:]).key for n in needles])
    lost = (2, 7)
    shed_body = {"error": "overloaded: request shed"}
    ms = MasterServer(port=free_port(), pulse_seconds=0.5).start()
    # a shortened copy of requests_shed_increase, which resolves a second
    # after the storm
    ms.alert_engine.add_rule(Rule(
        "requests_shed_brief", "counter_increase", keep_firing_s=1.0,
        params={"key": "requests_shed"}))
    vs = None
    try:
        vs = VolumeServer([dst], ms.url, port=free_port(), device=device,
                          pulse_seconds=0.5,
                          max_inflight=max_inflight).start()
        def listed() -> bool:
            try:
                return len(shard_holders(ms.url, 1)) == 12
            except HttpError:  # before the first heartbeat
                return False

        # the master's /cluster/health and /cluster/alerts read the
        # server once it is registered
        wait_for("the master to list the overload server's shards", listed,
                 30)

        def counters() -> dict:
            totals = cluster_health(ms.url)["totals"]
            return {
                "shed": metric_value(vs.url, "SeaweedFS_requests_shed_total",
                                     "volume"),
                "ddl": metric_value(vs.url,
                                    "SeaweedFS_deadline_exceeded_total",
                                    "volume"),
                "health_shed": totals["requests_shed"],
                "health_ddl": totals["deadline_exceeded"]}

        def settled(c0: dict, want: dict) -> dict:
            # the master's aggregator scrapes at most every 2 s
            got: dict = {}

            def ok() -> bool:
                got.update({k: v - c0[k] for k, v in counters().items()})
                return got == want

            try:
                wait_for("the counters to settle", ok, 10)
            except AssertionError:
                raise AssertionError(f"counters moved {got}, want {want}")
            return got

        c0 = counters()
        # the alert engine's baseline: it evaluates on demand here (no
        # telemetry loop), and its first sight of a counter never fires
        cluster_alerts(ms.url)
        launches0 = gf_matmul.launches
        t_wall = time.time()
        done: list[tuple[int, float, int]] = []
        polls: list[tuple[str, int]] = []
        storm = threading.Event()

        def reader(t: int) -> None:
            c = Conn(vs.url)
            try:
                for i in np.random.default_rng([seed, 7, t]).choice(
                        len(needles), size=per_thread):
                    n = needles[int(i)]
                    t0 = time.perf_counter()
                    status, body, r = c.call("GET", n["path"])
                    lat = time.perf_counter() - t0
                    if status == 200:
                        if body != n["data"] or \
                                r.getheader("ETag") != n["etag"]:
                            raise AssertionError(f"admitted GET {n['path']}"
                                                 f": {len(body)} bytes")
                    elif status != 503 or \
                            r.getheader("Retry-After") != "1" or \
                            json.loads(body) != shed_body:
                        raise AssertionError(f"GET {n['path']} under load: "
                                             f"{status} {body[:200]!r}")
                    done.append((status, lat, int(i)))
            finally:
                c.close()

        def monitor() -> None:
            c = Conn(vs.url)
            try:
                while not storm.is_set():
                    for path in ("/metrics", "/status"):
                        polls.append((path, c.call("GET", path)[0]))
                    time.sleep(0.05)
            finally:
                c.close()

        mon = threading.Thread(target=monitor)
        mon.start()
        t0 = time.perf_counter()
        try:
            run_threads(reader, threads, 600)
        finally:
            storm.set()
            mon.join(timeout=60)
        storm_s = time.perf_counter() - t0
        launches = gf_matmul.launches - launches0
        reconstructed = vs.ec_reads["reconstructed"]
        admitted = [(lat, i) for status, lat, i in done if status == 200]
        shed = [lat for status, lat, _ in done if status == 503]
        need = sum(sid in lost for _, i in admitted for sid in shards_of[i])
        if len(done) != threads * per_thread or not admitted or not shed:
            raise AssertionError(f"overload: {len(admitted)} admitted, "
                                 f"{len(shed)} shed of {len(done)} GETs")
        moved = settled(c0, {"shed": len(shed), "ddl": 0,
                             "health_shed": len(shed), "health_ddl": 0})
        if vs.router.admission.shed_total != len(shed):
            raise AssertionError(f"503s {len(shed)}, shed_total "
                                 f"{vs.router.admission.shed_total}")
        # the storm pages: requests_shed_increase fires with the 503s seen
        paged: dict = {}

        def shed_paged() -> bool:
            paged.update(cluster_alerts(ms.url).get(
                "requests_shed_increase") or {})
            return paged.get("state") == "firing"

        wait_for("requests_shed_increase to fire", shed_paged, 10)
        if paged["value"] != len(shed) or paged["servers"] != [vs.url]:
            raise AssertionError(f"requests_shed_increase {paged}, "
                                 f"{len(shed)} 503s")
        # with no shed since, the shortened rule resolves, and the master
        # journals it (each poll evaluates at most once a second)
        wait_for("requests_shed_brief to resolve", lambda: cluster_alerts(
            ms.url)["requests_shed_brief"]["state"] == "resolved", 10)
        wait_for("its alert_resolved in /cluster/events", lambda: any(
            e["details"].get("alert") == "requests_shed_brief"
            for e in journal(ms.url, t_wall)
            if e["type"] == "alert_resolved"), 10)
        if vs.ec_reads["remote"] or reconstructed != need or (
                device == "cuda" and launches != need):
            raise AssertionError(f"admitted GETs needed {need} "
                                 f"reconstructions: {vs.ec_reads}, "
                                 f"{launches} launches")
        if not polls or any(status != 200 for _, status in polls):
            raise AssertionError(f"/metrics and /status under load: "
                                 f"{polls[:8]}")
        events = http_json("GET", f"http://{vs.url}/debug/events?type="
                                  f"load_shed&since={t_wall}")["events"]
        if not 1 <= len(events) <= int(storm_s) + 1 or any(
                e["details"]["role"] != "volume" for e in events):
            raise AssertionError(f"{len(events)} load_shed events over a "
                                 f"{storm_s:.1f} s storm")
        # a GET its caller gave up on: 504 before the handler, no work
        c = Conn(vs.url)
        try:
            status, body, _ = c.call("GET", needles[0]["path"],
                                     headers={"X-Weed-Deadline": "0"})
        finally:
            c.close()
        if status != 504 or gf_matmul.launches - launches0 != launches or \
                vs.ec_reads["reconstructed"] != reconstructed:
            raise AssertionError(f"spent deadline: {status} {body!r}")
        settled(c0, {**moved, "ddl": 1, "health_ddl": 1})
    finally:
        if vs is not None:
            vs.stop()
        ms.stop()
        shutil.rmtree(dst, ignore_errors=True)
    return {"max_inflight": max_inflight, "threads": threads,
            "gets": len(done), "admitted": len(admitted), "shed": len(shed),
            "shed_share": len(shed) / len(done), "storm_s": storm_s,
            "admitted_ms": percentiles([lat for lat, _ in admitted]),
            "shed_ms": percentiles(shed),
            # a connect whose SYN the listen queue dropped waits ~1 s
            "over_1s": {"admitted": sum(lat >= 1 for lat, _ in admitted),
                        "shed": sum(lat >= 1 for lat in shed)},
            "reconstructed": reconstructed,
            "launches": launches, "load_shed_events": len(events),
            "monitor_polls": len(polls), "health_moved": moved,
            "deadline_504": True,
            "shed_alert": {k: paged[k] for k in ("state", "value",
                                                 "servers", "severity")},
            "brief_rule_resolved": True}


def flip_byte(path: str, offset: int) -> None:
    """Rot on the medium: one bit of ``path`` at ``offset`` flipped."""
    with open(path, "r+b") as f:
        f.seek(offset)
        c = f.read(1)
        f.seek(offset)
        f.write(bytes([c[0] ^ 0x10]))


def scrub_pass(conn: Conn) -> tuple[dict, float]:
    """``POST /ec/scrub/start`` one unthrottled pass and poll
    ``/ec/scrub/status`` until it ends; -> (status, seconds)."""
    t0 = time.perf_counter()
    if not conn.admin("/ec/scrub/start", {"rate_mb_s": 0,
                                          "interval_s": 0})["started"]:
        raise AssertionError("a scrub was already running")
    while True:
        status, body, _ = conn.call("GET", "/ec/scrub/status")
        st = json.loads(body)
        if status != 200:
            raise AssertionError(f"/ec/scrub/status: {status}")
        if not st["running"]:
            return st, time.perf_counter() - t0
        if time.perf_counter() - t0 > 600:
            raise AssertionError("scrub pass did not end")
        time.sleep(0.1)


def scrub_and_repair(vs, base: str, needles: list[dict], seed: int) -> dict:
    """The scrubber on a volume server holding all 14 shards: a clean
    pass (its scan rate), then a bit flipped in data shard 3 and parity
    shard 12 and a second pass, which must quarantine both to `.bad`,
    rebuild them on the server's device to their original sha256, and
    leave the volume mounted whole.  A reader GETs needles throughout the
    repair, under the server's 50 requests/s scrub gate; each must come
    back as written."""
    from seaweedfs_tpu_torch.ec.layout import to_ext

    conn = Conn(vs.url)
    try:
        st, clean_s = scrub_pass(conn)
        blocks = st["verdicts"]["1"].get("blocks", 0)
        if st["verdicts"]["1"]["status"] != "clean" or not blocks:
            raise AssertionError(f"clean scrub pass: {st['verdicts']}")
        scanned = sum(os.path.getsize(base + to_ext(i)) for i in range(14))
        rotted = [3, 12]
        hashes = {i: sha256_file(base + to_ext(i)) for i in rotted}
        for i in rotted:
            flip_byte(base + to_ext(i),
                      os.path.getsize(base + to_ext(i)) // 3)
        stop = threading.Event()
        gets: list = []
        errors: list = []

        def reader() -> None:
            c = Conn(vs.url)
            rng = np.random.default_rng([seed, 99])
            try:
                while not stop.is_set():
                    n = needles[int(rng.integers(len(needles)))]
                    gets.append(check_get(c, n))
                    time.sleep(0.05)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
            finally:
                c.close()

        t = threading.Thread(target=reader)
        t.start()
        try:
            st, repair_s = scrub_pass(conn)
        finally:
            stop.set()
            t.join(timeout=120)
        if errors or t.is_alive():
            raise AssertionError(f"GET during the repair: {errors[:1]}")
        verdict = st["verdicts"]["1"]
        if verdict["status"] != "repaired" or \
                verdict["corrupt_shards"] != rotted:
            raise AssertionError(f"scrub of rotted shards: {verdict}")
        for i in rotted:
            if not os.path.exists(base + to_ext(i) + ".bad") or \
                    sha256_file(base + to_ext(i)) != hashes[i]:
                raise AssertionError(f"shard {i} not quarantined or "
                                     "not repaired to its bytes")
        if sorted(vs.store.ec_volumes[1].shards) != list(range(14)):
            raise AssertionError("the repaired volume is not whole")
        return {"clean_pass_s": clean_s, "scanned_bytes": scanned,
                "scan_GBps": scanned / clean_s / 1e9, "blocks": blocks,
                "repair_pass_s": repair_s, "verdict": verdict,
                "gets_during_repair": len(gets),
                "get_ms_during_repair": percentiles(gets) if gets else None,
                "rebuild_stats": dict(vs.store.streaming_encoder().stats)}
    finally:
        conn.close()


def start_cli(args: list[str], log_path: str,
              env: dict | None = None, cwd: str = ROOT) -> subprocess.Popen:
    """``python -m seaweedfs_tpu_torch <args>`` from the checkout, with
    ``env`` added to the environment, in ``cwd`` (where it reads a
    security.toml); its standard error goes to ``log_path``."""
    with open(log_path, "w") as log_file:
        return subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=cwd,
            env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
            stdout=subprocess.PIPE, stderr=log_file, text=True)


def read_start_line(proc: subprocess.Popen, log_path: str, want: str,
                    timeout: float = 300) -> str:
    """The server's first line, which must start with ``want``."""
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline().strip() if ready else ""
    if not line.startswith(want):
        raise AssertionError(f"start line {line!r}; log: "
                             f"{open(log_path).read()[-2000:]}")
    return line


def run_cli_phase(engine: str, work: str, volume_bytes: int, reads: int,
                  threads: int, per_thread: int) -> dict:
    """``python -m seaweedfs_tpu_torch volume -ec.engine <engine>`` in a
    subprocess: its start line, a volume written, encoded and read with
    data shards 2 and 7 gone (by one client, then by ``threads`` at once),
    and a clean exit on SIGTERM."""
    port = free_port()
    log_path = os.path.join(work, "server.log")
    os.makedirs(os.path.join(work, "data"))
    t_start = time.perf_counter()
    proc = start_cli(["volume", "-dir", os.path.join(work, "data"), "-port",
                      str(port), "-mserver", f"127.0.0.1:{free_port()}",
                      "-ec.engine", engine], log_path)
    try:
        line = read_start_line(proc, log_path, "volume server listening")
        if f"ec on {ENGINES[engine]}" not in line:
            raise AssertionError(f"start line {line!r}")
        res = {"start_line": line,
               "start_seconds": time.perf_counter() - t_start}
        conn = Conn(f"127.0.0.1:{port}")
        try:
            status, body, _ = conn.call("GET", "/status")
            res["degraded_binds"] = \
                json.loads(body)["EcPipeline"]["degraded_binds"]
            if status != 200 or res["degraded_binds"]:
                raise AssertionError(f"/status {status}: {body[:300]!r}")
            conn.admin("/admin/assign_volume", {"volume_id": 1})
            seed = SEED + 3
            needles = [http_needle(seed, i, nid, cookie, size)
                       for i, (nid, cookie, size)
                       in enumerate(needle_specs(seed, volume_bytes))]
            for n in needles:
                if conn.call("PUT", n["path"] + n["query"], n["body"],
                             n["headers"])[0] != 201:
                    raise AssertionError(f"PUT {n['path']}")
            for path, body in (("/admin/readonly", {}),
                               ("/admin/ec/generate", {"engine": "tpu"}),
                               ("/admin/ec/mount", {}),
                               ("/admin/delete_volume", {}),
                               ("/admin/ec/delete", {"shard_ids": [2, 7]})):
                conn.admin(path, {"volume_id": 1, **body})
            rng = np.random.default_rng(seed)
            res["latency_s"] = [check_get(conn, needles[int(i)]) for i in
                                rng.choice(len(needles), size=reads)]
        finally:
            conn.close()
        # the same eight readers as the in-process phase, here in another
        # process than the server's interpreter
        res["latency_8_clients_s"] = concurrent_gets(
            f"127.0.0.1:{port}", needles, threads, per_thread, seed)
        t0 = time.perf_counter()
        res["launches"] = stop_volume_server(proc)["launches"]
        res["stop_seconds"] = time.perf_counter() - t0
        return res
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


STOP_LINE = re.compile(r"volume server stopped, ec kernel launches (\d+), "
                       r"remote shard reads (\d+), "
                       r"reconstructed intervals (\d+)")


def stop_volume_server(proc: subprocess.Popen) -> dict:
    """SIGTERM a CLI volume server; it must exit 0 within 10 s.  Returns
    the counts of its stop line, counted in its own process from 0."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=10)
    stop_line = proc.stdout.read().strip().splitlines()
    m = STOP_LINE.fullmatch(stop_line[-1]) if stop_line else None
    if rc != 0 or m is None:
        raise AssertionError(f"volume server exited {rc}: {stop_line!r}")
    return {"launches": int(m.group(1)), "remote": int(m.group(2)),
            "reconstructed": int(m.group(3))}


# --- the cluster phase --------------------------------------------------

def cluster_needle(seed: int, i: int, nid: int, size: int) -> dict:
    """Needle ``nid`` of the spec as WeedClient uploads it: every tenth
    carries, in turn, a gzip body (bytes that compress, gzipped by the
    client), a name or a mime type.  ``data`` is what a GET gives back."""
    kind = (i // 10) % 3 if i % 10 == 0 else None
    if kind == 0:
        data = np.random.default_rng([seed, nid]).integers(
            0, 4, size, dtype=np.uint8).tobytes()
        return {"data": data, "upload": {"compress": True}}
    upload = ({"name": f"needle-{nid}.bin"} if kind == 1 else
              {"mime": "image/jpeg"} if kind == 2 else {})
    return {"data": needle_data(seed, nid, size), "upload": upload}


def run_threads(target, count: int, timeout: float) -> None:
    """``target(t)`` on ``count`` threads at once; re-raises the first
    error, and fails if a thread outlives ``timeout``."""
    errors: list[BaseException] = []

    def run(t: int) -> None:
        try:
            target(t)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    workers = [threading.Thread(target=run, args=(t,)) for t in range(count)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=timeout)
    if errors:
        raise errors[0]
    if any(w.is_alive() for w in workers):
        raise AssertionError("a worker thread did not finish")


def run_shell(master: str, commands: str, cwd: str = ROOT,
              check: bool = True) -> tuple[str, float]:
    """``python -m seaweedfs_tpu_torch shell -c`` in ``cwd``; -> (output,
    wall s).  With ``check`` a failed command fails the run."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
                        "-master", master, "-c", commands], cwd=cwd,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or (check and "FAILED" in r.stdout):
        raise AssertionError(f"shell {commands!r}: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    return r.stdout.strip(), wall


def master_status(master: str) -> dict:
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return http_json("GET", f"http://{master}/dir/status")["Topology"]


def data_nodes(topology: dict) -> list[dict]:
    return [n for dc in topology["DataCenters"] for rack in dc["Racks"]
            for n in rack["DataNodes"]]


def node_urls(topology: dict) -> set[str]:
    return {n["Url"] for n in data_nodes(topology)}


def wait_for(what: str, ok, timeout: float) -> float:
    """Poll ``ok()`` until it holds; -> seconds waited."""
    t0 = time.perf_counter()
    while not ok():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def shard_holders(master: str, vid: int) -> dict[int, list[str]]:
    from seaweedfs_tpu_torch.utils.httpd import http_json

    doc = http_json("GET", f"http://{master}/dir/lookup_ec?volumeId={vid}")
    return {int(s): urls for s, urls in doc["shards"].items() if urls}


def needle_shards(base: str, vid: int, keys: list[int]) -> list[list[int]]:
    """The shard of each interval of each needle, from a holder's `.ecx`
    and shard geometry: what a GET of it must read."""
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume

    ev = EcVolume(base, vid)
    try:
        return [[iv.to_shard_id_and_offset(ev.large_block_size,
                                           ev.small_block_size,
                                           ev.data_shards)[0]
                 for iv in ev.locate_ec_shard_needle(key)[2]]
                for key in keys]
    finally:
        ev.close()


def needle_widths(base: str, vid: int, keys: list[int]) -> list[list[int]]:
    """The bytes of each interval of each needle, from a holder's `.ecx`
    and shard geometry: the width a reconstruction of it launches at."""
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume

    ev = EcVolume(base, vid)
    try:
        return [[iv.size for iv in ev.locate_ec_shard_needle(key)[2]]
                for key in keys]
    finally:
        ev.close()


def timed_gets(master: str, picks, needles: list[dict], fids: list[str],
               seed: int) -> list[tuple[str, int, float]]:
    """GET each picked needle through one WeedClient, byte-checked;
    -> [(server that answered, needle index, seconds)]."""
    from seaweedfs_tpu_torch.client.operation import WeedClient

    client = WeedClient(master)
    client.rng.seed(seed)
    out = []
    for i in picks:
        t0 = time.perf_counter()
        body = client.download(fids[i])
        lat = time.perf_counter() - t0
        if body != needles[i]["data"]:
            raise AssertionError(f"GET {fids[i]}: {len(body)} bytes, wrong")
        out.append((client.last_read_from, int(i), lat))
    return out


def traced_gets(master: str, picks, needles: list[dict], fids: list[str],
                seed: int, rate: float = 1.0
                ) -> list[tuple[str, int, float, str]]:
    """timed_gets with each GET under a trace context of its own: sampled
    (a fresh trace id sent as the Traceparent of every call it makes) for
    a seeded ``rate`` share of them, decided unsampled for the rest (a
    Traceparent that tells each server not to record, as a front that
    samples at ``rate`` sends on); -> [(server that answered, needle
    index, seconds, trace id or "")]."""
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.observability import context

    client = WeedClient(master)
    client.rng.seed(seed)
    coin = np.random.default_rng([seed, 1])
    out = []
    for i in picks:
        ctx = context.TraceContext(context.new_trace_id()) \
            if rate >= 1.0 or coin.random() < rate else context.NOT_SAMPLED
        prev = context.activate(ctx)
        try:
            t0 = time.perf_counter()
            body = client.download(fids[i])
            lat = time.perf_counter() - t0
        finally:
            context.activate(prev)
        if body != needles[i]["data"]:
            raise AssertionError(f"GET {fids[i]}: {len(body)} bytes, wrong")
        out.append((client.last_read_from, int(i), lat,
                    getattr(ctx, "trace_id", "")))
    return out


def process_cpu(pids: dict) -> dict:
    """CPU seconds each process has used so far, user + system and the
    system part alone, from /proc/<pid>/stat."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for name, pid in pids.items():
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        out[name] = {"cpu_s": (int(fields[11]) + int(fields[12])) / tick,
                     "sys_s": int(fields[12]) / tick}
    return out


def set_tracing(urls, flag: str) -> dict[str, int]:
    """/debug/traces?<flag> on each server: enable=1 turns its tracer on
    live, clear=1 empties its ring, disable=1&clear=1 both turns it off
    and empties it.  -> the spans each ring held (and dropped) before."""
    from seaweedfs_tpu_torch.utils.httpd import http_bytes

    spans = {}
    for u in urls:
        status, body, _ = http_bytes("GET", f"http://{u}/debug/traces?{flag}")
        if status != 200:
            raise AssertionError(f"{u}/debug/traces?{flag}: {status} {body}")
        doc = json.loads(body)
        spans[u] = sum(e.get("ph") == "X" for e in doc["traceEvents"]) \
            + doc["spansDropped"]
    return spans


def stitched(doc: dict, root: str, server: str) -> bool:
    """True once a trace is whole: ``server``'s ``root`` span is in, and
    so is the far side of every ``rpc.client`` hop (each server ships its
    own spans, so the pieces arrive in any order)."""
    spans = doc["spans"]
    parents = {sp.get("parent") for sp in spans}
    return any(sp["name"] == root and sp.get("server") == server
               for sp in spans) and all(
        sp["id"] in parents for sp in spans if sp["name"] == "rpc.client")


def collect_traces(master: str, gets, timeout: float = 60.0) -> dict:
    """Each GET's stitched trace from the master's collector, once it is
    whole; -> trace id -> document."""
    from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json

    docs: dict = {}
    t0 = time.perf_counter()
    for asked, _, _, tid in gets:
        while True:
            try:
                doc = http_json("GET", f"http://{master}/cluster/traces/{tid}")
                if stitched(doc, "http.volume.read_object", asked):
                    docs[tid] = doc
                    break
            except HttpError as e:
                if e.status != 404:
                    raise
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"trace {tid} of a GET on {asked} was "
                                     "not collected")
            time.sleep(0.05)
    return docs


# hops of a degraded GET, by span: the answering server's request, its
# rpc.client calls (the master's lookup_ec, a holder's shard_read), and
# the codec's reconstruction
HOPS = {"front": lambda sp: sp["name"] == "http.volume.read_object",
        "lookup_ec": lambda sp: sp["name"] == "rpc.client"
        and sp["attrs"].get("path") == "/dir/lookup_ec",
        "remote_shard_read": lambda sp: sp["name"] == "rpc.client"
        and sp["attrs"].get("path") == "/admin/ec/shard_read",
        "reconstruct": lambda sp: sp["name"] == "ec.reconstruct"}


def check_traced_gets(gets, docs: dict, classify, holders: dict,
                      launches: dict) -> dict:
    """Every traced GET's stitched trace against its class: (b) holds an
    ``ec.reconstruct`` span on the server that answered, (a) the holder's
    /admin/ec/shard_read hop and no reconstruction, a local read neither.
    ``launches``: each server's kernel launches over the traced GETs, or
    None on the plain versions; on the card they must equal its
    ``ec.reconstruct`` spans, one kernel each.  -> per-hop p50/p99 and
    the bounding hop of the five slowest traces."""
    hop_s: dict[str, list[float]] = {k: [] for k in HOPS}
    # the client's wait outside the front's request span: its connect,
    # the request's and the answer's transfer, the client's own work
    hop_s["outside_front"] = []
    recon_on: dict[str, int] = {}
    slow = []
    for asked, i, lat, tid in gets:
        cls, remote = classify(asked, i)
        spans = docs[tid]["spans"]
        for hop, match in HOPS.items():
            hop_s[hop] += [sp["t1"] - sp["t0"] for sp in spans if match(sp)]
        front = max(sp["t1"] - sp["t0"] for sp in spans
                    if HOPS["front"](sp) and sp.get("server") == asked)
        hop_s["outside_front"].append(max(0.0, lat - front))
        recon = [sp for sp in spans if sp["name"] == "ec.reconstruct"]
        reads = [sp for sp in spans
                 if sp["name"] == "http.volume.ec_shard_read"]
        for sp in recon:
            recon_on[sp["server"]] = recon_on.get(sp["server"], 0) + 1
        if cls == "b" and not any(sp["server"] == asked for sp in recon):
            raise AssertionError(f"class (b) GET {tid}: no ec.reconstruct "
                                 f"on {asked}")
        if cls != "b" and recon:
            raise AssertionError(f"class ({cls}) GET {tid} reconstructed")
        if cls == "a" and not any(
                sp["server"] in {u for s in remote for u in holders[s]}
                and sp["attrs"].get("path") == "/admin/ec/shard_read"
                for sp in reads):
            raise AssertionError(f"class (a) GET {tid}: no shard_read hop "
                                 f"on a holder of {remote}")
        slow.append((lat, tid, cls, asked, front))
    if launches is not None and any(
            launches.get(u, 0) != recon_on.get(u, 0)
            for u in set(launches) | set(recon_on)):
        raise AssertionError(f"kernel launches {launches} != ec.reconstruct "
                             f"spans {recon_on}")
    slow.sort(reverse=True)
    return {
        "traces": len(gets),
        "hops_ms": {hop: percentiles(v) if v else {"n": 0}
                    for hop, v in hop_s.items()},
        "reconstruct_spans": recon_on,
        "slowest": [{"trace": tid, "class": cls, "server": asked,
                     "ms": 1e3 * lat, "front_ms": 1e3 * front,
                     "bounding_hop": docs[tid]["analysis"]["bounding_hop"]}
                    for lat, tid, cls, asked, front in slow[:5]]}


def coordinator_status(master: str) -> dict:
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return http_json("GET", f"http://{master}/cluster/coordinator")


def kernel_launches(urls) -> dict[str, int]:
    """The GF(2^8) kernels each volume server's process has launched so
    far (its /status ``EcKernelLaunches``)."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return {u: http_json("GET", f"http://{u}/status")["EcKernelLaunches"]
            for u in urls}


def kernel_widths(urls) -> dict[str, int]:
    """Kernel 1's launches by width class, summed over the volume servers'
    /status ``EcKernelWidths``."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    out: dict[str, int] = {}
    for u in urls:
        for c, n in http_json("GET", f"http://{u}/status")[
                "EcKernelWidths"].items():
            out[c] = out.get(c, 0) + n
    return out


def cluster_health(master: str) -> dict:
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return http_json("GET", f"http://{master}/cluster/health")


def wait_healed(master: str, vid: int, dead: tuple, shard_path, hashes: dict,
                done_before: int, t0: float, timeout: float
                ) -> tuple[float, float]:
    """Poll until the coordinator has finished a repair since
    ``done_before``, its queue is empty and every shard has a holder
    outside ``dead``; then every such holder's copy must equal its sha256
    from before any loss.  -> (seconds from ``t0`` until the registry
    showed the heal that the check then confirmed, seconds the sha256
    check took)."""
    from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT

    while True:
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"volume {vid} not healed in {timeout} s: "
                                 f"{coordinator_status(master)}")
        st = coordinator_status(master)
        live = {sid: [u for u in us if u not in dead]
                for sid, us in shard_holders(master, vid).items()}
        if st["repairs"]["done"] > done_before and not st["queue"] and \
                all(live.get(sid) for sid in range(TOTAL_SHARDS_COUNT)):
            seen = time.perf_counter() - t0
            try:
                bad = sorted({sid for sid, us in live.items() for u in us
                              if sha256_file(shard_path(u, sid))
                              != hashes[sid]})
            except FileNotFoundError:
                bad = None  # a move's source dropped its copy before its
                # heartbeat told the master: look again
            if bad:
                raise AssertionError(f"healed shards {bad} of volume {vid} "
                                     f"differ from their sha256")
            if bad == []:
                return seen, time.perf_counter() - t0 - seen
        time.sleep(0.05)


class Watch:
    """Times, on a thread of its own, how long after ``t0`` ``ok()`` first
    holds, so other waits and checks do not sit inside the time."""

    def __init__(self, what: str, ok, t0: float, timeout: float):
        self.what = what
        self.seconds: float | None = None

        def watch() -> None:
            while time.perf_counter() - t0 < timeout:
                try:
                    if ok():
                        self.seconds = time.perf_counter() - t0
                        return
                except Exception:  # noqa: BLE001 - polled until the timeout
                    pass
                time.sleep(0.05)

        self._t = threading.Thread(target=watch, daemon=True)
        self._t.start()

    def wait(self) -> float:
        self._t.join()
        if self.seconds is None:
            raise AssertionError(f"timed out waiting for {self.what}")
        return self.seconds


# the spread of the drill's heal times over earlier runs of this script
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6)
HEAL_SPREAD = {"rot_to_heal_s": (5.64, 7.77), "kill_to_heal_s": (4.41, 7.23)}
# the alerts the coordinator may name for a repair (its
# _cause_alert_locked chooses among the firing ones)
REPAIR_ALERTS = ("scrub_unrepairable", "corrupt_shards_increase",
                 "ec_under_replicated_increase", "peer_down")


def cluster_alerts(master: str, state: str = "") -> dict[str, dict]:
    """The master's /cluster/alerts by alert name (``state`` filters)."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    q = f"?state={state}" if state else ""
    return {a["name"]: a for a in http_json(
        "GET", f"http://{master}/cluster/alerts{q}")["alerts"]}


class FireWatch(Watch):
    """Times, from a fault at ``t0`` (``fault_wall`` on the wall clock),
    until alert ``name`` is firing with a bundle from each of
    ``servers``, and keeps the alert as first seen so."""

    def __init__(self, master: str, name: str, servers: set, t0: float,
                 fault_wall: float):
        self.alert: dict | None = None
        self.fault_wall = fault_wall

        def ok() -> bool:
            a = cluster_alerts(master, "firing").get(name)
            if a is None or not servers <= {
                    b["server"] for b in a.get("bundles") or []
                    if b.get("id")}:
                return False
            self.alert = a
            return True

        super().__init__(f"{name} firing with bundles from "
                         f"{sorted(servers)}", ok, t0, 120)

    def times(self) -> dict:
        """Seconds from the fault to alert_fired, and from alert_fired to
        its bundles showing on /cluster/alerts."""
        seen = self.wait()
        fired = self.alert["fired_at"] - self.fault_wall
        if fired < 0:
            raise AssertionError(f"{self.what} fired {-fired:.3f} s before "
                                 f"its fault: {self.alert}")
        return {"fault_to_fired_s": fired, "fired_to_bundles_s": seen - fired,
                "servers": self.alert["servers"],
                "bundles": self.alert["bundles"]}


# a flight-recorder bundle as the reference's capture writes it
BUNDLE_FORMAT = "seaweedfs-tpu-flightrecorder-v1"
BUNDLE_META = ("alert", "captured_at", "event_count", "id", "reason",
               "server", "span_count", "trace_id")
# the alerts the drill's rot provokes on its host: their bundles must hold
# the evidence
DRILL_ALERTS = ("scrub_unrepairable", "corrupt_shards_increase")


def bundle_problems(doc: dict, alert: str, provoked: bool) -> list[str]:
    """What is wrong with one flight-recorder bundle document of
    ``alert``.  Every bundle must have the reference's shape: its format,
    its meta keys, the alert's name, and span and event counts equal to
    its sections.  The bundle of an alert the drill provoked must also
    hold non-empty trace, profile, metrics and events sections.  Any
    other alert (one the host's load raised, such as loop_lag_increase)
    may come from a process with no spans and an empty journal, and the
    reference's capture of such a process has empty spans and events too
    (tests/test_torch_alerts.py), so it is held to the shape alone."""
    meta = doc.get("meta") or {}
    trace = doc.get("trace")
    problems = []
    if doc.get("format") != BUNDLE_FORMAT:
        problems.append(f"format {doc.get('format')!r}")
    if tuple(sorted(meta)) != BUNDLE_META:
        problems.append(f"meta keys {sorted(meta)}")
    if meta.get("alert") != alert:
        problems.append(f"alert {meta.get('alert')!r}")
    if not isinstance(trace, dict) or \
            meta.get("span_count") != len(trace.get("spans") or []):
        problems.append("span_count is not the trace's spans")
    if not isinstance(doc.get("events"), list) or \
            meta.get("event_count") != len(doc["events"]):
        problems.append("event_count is not the events'")
    if not isinstance(doc.get("profile"), str) or \
            not isinstance(doc.get("metrics"), str):
        problems.append("profile or metrics not text")
    if provoked:
        problems += [f"empty {k}" for k in ("trace", "profile", "metrics",
                                            "events") if not doc.get(k)]
    return problems


def fired_events(master: str) -> list[dict]:
    """The master's journaled alert_fired events, by time."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return http_json("GET", f"http://{master}/cluster/events?"
                            f"type=alert_fired&limit=0")["events"]


def fired_servers(events: list[dict], name: str, alert: dict):
    """The servers named by the alert_fired event of ``alert``'s current
    fire (the first one of ``name`` journaled at or after its
    ``fired_at``), or None while that event is not in ``events``.  The
    master asks these servers for bundles once, at the fire, while the
    alert's own ``servers`` follow each evaluation that keeps it active
    (a journal_event rule's, each event it sees)."""
    t = float(alert.get("fired_at") or 0.0) - 0.001
    for e in events:
        if e["type"] == "alert_fired" and \
                e["details"].get("alert") == name and e["ts"] >= t:
            return list(e["details"].get("servers") or [])
    return None


def bundles_owed(master: str, name: str, alert: dict, events: list[dict],
                 provoked: tuple = DRILL_ALERTS):
    """The servers whose bundle a firing alert must carry: each server its
    alert_fired event names and the master, and, for an alert the drill
    provokes, each server it implicates now as well.  None while its
    alert_fired event is not journaled yet."""
    fired = fired_servers(events, name, alert)
    if fired is None:
        return None
    owed = set(fired) | {master}
    if name in provoked:
        owed |= set(alert["servers"])
    return owed


def bundles_missing(master: str, name: str, alert: dict,
                    events: list[dict], killed: set,
                    provoked: tuple = DRILL_ALERTS) -> list[str]:
    """The servers of ``bundles_owed`` with no bundle on the alert: each
    owes one with an id, except that a server the drill killed may have a
    recorded capture error in its place.  ["alert_fired"] while the
    fire's event is not journaled yet."""
    owed = bundles_owed(master, name, alert, events, provoked)
    if owed is None:
        return ["alert_fired"]
    got = {b["server"]: b for b in alert.get("bundles") or []}
    return [url for url in sorted(owed) if not (
        got.get(url, {}).get("id") or
        (url in killed and got.get(url, {}).get("error")))]


def check_bundles(master: str, firing: dict, killed: set,
                  provoked: tuple = DRILL_ALERTS) -> dict:
    """Each firing alert's bundles: each it owes (``bundles_missing``
    empty), and every one with an id on a live server fetched from its
    /debug/flightrecorder/<id> and held to ``bundle_problems`` (the
    evidence sections non-empty for the ``provoked`` alerts).  -> bytes
    of each bundle document (None for one on a ``killed`` server)."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    sizes = {}
    events = fired_events(master)
    for name, a in firing.items():
        missing = bundles_missing(master, name, a, events, killed,
                                  provoked)
        if missing:
            raise AssertionError(f"alert {name} has no bundle from "
                                 f"{missing}: {a}")
        for b in a.get("bundles") or []:
            if not b.get("id") or b["server"] in killed:
                # a killed server's capture error, or its bundle, which
                # died with it
                sizes[f"{name}@{b['server']}"] = None
                continue
            doc = http_json("GET", f"http://{b['server']}/debug/"
                                   f"flightrecorder/{b['id']}")
            problems = bundle_problems(doc, name, name in provoked)
            if problems:
                raise AssertionError(f"bundle {b['id']} of {name} on "
                                     f"{b['server']}: {problems}; meta "
                                     f"{doc.get('meta')}")
            sizes[f"{name}@{b['server']}"] = len(json.dumps(doc))
    return sizes


def alerts_summary(master: str) -> dict:
    """The firing alerts by name: implicated servers, and each bundle's
    server with its id or its capture error (a failure's evidence)."""
    return {name: {"servers": a["servers"], "detail": a.get("detail"),
                   "bundles": [(b.get("server"), b.get("id") or
                                b.get("error")) for b in
                               a.get("bundles") or []]}
            for name, a in cluster_alerts(master, "firing").items()}


def fired_before(events: list[dict], alert: str, done_id: str) -> bool:
    """True if ``alert``'s alert_fired is journaled before the event
    ``done_id`` (a repair_done)."""
    order = [e["id"] for e in events]
    fired = [e["id"] for e in events if e["type"] == "alert_fired"
             and e["details"].get("alert") == alert]
    return bool(fired) and done_id in order and \
        order.index(fired[0]) < order.index(done_id)


def evaluation_ms(master: str, cycles: int = 20) -> dict:
    """Host ms per evaluation of the default rules over the cluster's own
    /cluster/health and merged /cluster/metrics, fetched once: the rule
    evaluation alone, in this process, without the scrape."""
    from seaweedfs_tpu_torch.observability.alerts import (AlertEngine,
                                                          default_rules)
    from seaweedfs_tpu_torch.observability.events import EventJournal
    from seaweedfs_tpu_torch.stats.aggregate import parse_prometheus_text
    from seaweedfs_tpu_torch.utils.httpd import http_bytes

    health = cluster_health(master)
    _, text, _ = http_bytes("GET", f"http://{master}/cluster/metrics")
    families = parse_prometheus_text(text.decode())
    engine = AlertEngine(default_rules(), lambda: (health, families),
                         journal=EventJournal(), min_interval=0.0)
    ms = []
    for i in range(cycles):
        t0 = time.perf_counter()
        engine.evaluate(now=time.time() + i, force=True)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"cycles": cycles, "mean_ms": sum(ms) / cycles, "max_ms": max(ms),
            "families": len(families), "peers": len(health["peers"])}


def alerts_by_hand(master: str, alive: list) -> dict:
    """One capture per process timed (each POST's wall and its bundle's
    bytes), then the shell: ``alerts.capture`` with no -server returns a
    bundle from the master and every registered server, ``alerts.list
    -firing``, ``cluster.health``'s alerts line and ``fault.list``
    print."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    captures = {}
    for url in [master] + list(alive):
        t0 = time.perf_counter()
        meta = http_json("POST", f"http://{url}/debug/flightrecorder/"
                                 f"capture", {"reason": "smoke"}, timeout=30)
        captures[url] = {"wall_s": time.perf_counter() - t0,
                         "bytes": meta["bytes"],
                         "spans": meta["span_count"],
                         "events": meta["event_count"]}
    out, wall = run_shell(master, "alerts.capture -reason smoke")
    lines = out.splitlines()
    registered = node_urls(master_status(master))
    if len(lines) != 1 + len(registered) or not all(
            ": bundle fr-" in line for line in lines):
        raise AssertionError(f"alerts.capture: {out}")
    listed, _ = run_shell(master, "alerts.list -firing")
    health, _ = run_shell(master, "cluster.health")
    faults, _ = run_shell(master, "fault.list")
    if not listed.startswith("alerts: ") or \
            not re.search(r"^alerts: \d+ firing", health, re.M) or \
            not faults.startswith("fault points: "):
        raise AssertionError(f"alert shell output: {listed!r} {health!r} "
                             f"{faults!r}")
    return {"captures": captures, "alerts.capture_s": wall,
            "alerts.capture_bundles": len(lines),
            "alerts_list_firing": listed.splitlines()[0],
            "health_alerts_line": next(line for line in health.splitlines()
                                       if line.startswith("alerts:")),
            "fault_points": faults.splitlines()[0]}


REPAIR_LINE = re.compile(r"coordinator: repaired volume (\d+) on (\S+): "
                         r".* legs (\{.*\})$")


def repair_legs(master_log: str) -> list[dict]:
    """Each coordinator repair's copy / rebuild / spread seconds, from the
    master's log lines."""
    import ast

    with open(master_log) as f:
        return [{"host": m.group(2), **ast.literal_eval(m.group(3))}
                for m in map(REPAIR_LINE.search, f) if m]


def coordinator_drill(master: str, vid: int, host: str, vs: dict,
                      alive: list, shard_path, hashes: dict,
                      rebuild_launches: int) -> dict:
    """The coordinator heals alone: coordinator.resume, then no shell
    command between a fault and its check.  (1) Rot: a byte of one of
    ``host``'s shards flipped, ``ec.scrub -all`` must call it
    unrepairable and quarantine it; the coordinator rebuilds it on the
    card and re-scrubs, until every shard's holders match their sha256
    and /cluster/health counts no unrepairable verdict.  (2) Loss:
    ``host`` SIGKILLed; the coordinator rebuilds its shards, until every
    shard has a live holder matching its sha256 and /cluster/health
    reads ``degraded: false`` (the killed host was the only server whose
    counters had seen rot).  (3) /cluster/coordinator: at least two
    repairs done, none failed, no error, an empty queue.  The live launch
    counts of the ``alive`` servers, read before the resume, after the
    rot's heal and after the loss's, must show each repair's host
    launching at least ``rebuild_launches`` kernels (a typed ec.rebuild's
    count) for each repair it ran in that window: nothing else launches
    there, since a clean scrub pass verifies checksums only."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    res: dict = {"seconds": {}, "repair_launches": {}}

    def check_launches(window: str, before: dict, after: dict,
                       since_wall: float) -> None:
        ran: dict[str, int] = {}
        for r in coordinator_status(master)["recent"]:
            if r["action"] == "repair_done" and r["at"] >= since_wall:
                ran[r["host"]] = ran.get(r["host"], 0) + 1
        res["repair_launches"][window] = {
            h: {"repairs": n, "launches": after[h] - before[h]}
            for h, n in ran.items()}
        if not ran or any(after[h] - before[h] < rebuild_launches * n
                          for h, n in ran.items()):
            raise AssertionError(
                f"the {window} repair hosts launched fewer kernels than "
                f"{rebuild_launches} a repair: {res['repair_launches']}")

    pre = kernel_launches(alive)
    pre_wall = time.time()
    out, _ = run_shell(master, "coordinator.resume")
    if not out.startswith("coordinator:"):
        raise AssertionError(f"coordinator.resume: {out}")
    held = sorted(s for s, us in shard_holders(master, vid).items()
                  if host in us)
    if not 2 <= len(held) <= 4:
        raise AssertionError(f"{host} holds shards {held}: the drill needs "
                             f"2-4, so it can lose one and then die")
    # 1. rot
    rot_shard = held[0]
    path = shard_path(host, rot_shard)
    rot_wall = time.time()
    flip_byte(path, os.path.getsize(path) // 3)
    done = coordinator_status(master)["repairs"]["done"]
    # ec.scrub -all adds one pass on the host, its re-scrub another
    passes = http_json("GET", f"http://{host}/ec/scrub/status")["passes"] + 1
    out, res["seconds"]["ec.scrub"] = run_shell(master,
                                                "ec.scrub -all -rate 0")
    if f"  volume {vid}: unrepairable corrupt_shards=[{rot_shard}]" \
            not in out.splitlines() or not os.path.exists(path + ".bad"):
        raise AssertionError(f"ec.scrub -all of the drill's rot: {out}")
    t0, t0_wall = time.perf_counter(), time.time()

    # the servers the drill killed before this rot (their bundles may be
    # capture errors)
    killed = set(vs) - set(alive)
    # the alert plane: scrub_unrepairable naming the host and
    # corrupt_shards_increase (the rot moved that counter) fire, and every
    # firing alert carries its bundles; either still firing since the
    # first rot of this host or fired anew
    paged: dict = {}

    def rot_paged() -> bool:
        firing = cluster_alerts(master, "firing")
        s = firing.get("scrub_unrepairable")
        if s is None or host not in s["servers"] or \
                "corrupt_shards_increase" not in firing:
            return False
        events = fired_events(master)
        if any(bundles_missing(master, name, a, events, killed)
               for name, a in firing.items()):
            return False
        paged.update(firing)
        return True

    try:
        res["alerts"] = {"rot_paged_s": wait_for(
            "the rot's alerts with their bundles", rot_paged, 60)}
    except AssertionError as e:
        raise AssertionError(f"{e}: firing {alerts_summary(master)}") \
            from None
    res["alerts"]["rot_firing"] = sorted(paged)
    res["alerts"]["rot_bundle_bytes"] = check_bundles(master, paged,
                                                      killed)

    def verdict_cleared() -> bool:
        # a scrape from after the host's re-scrub pass: one from before the
        # scrub's verdict reached the aggregator would read clean too
        doc = cluster_health(master)
        scrub = doc["peers"].get(host, {}).get("scrub") or {}
        t = doc["totals"]
        return scrub.get("passes", 0) > passes and not scrub["running"] \
            and t["scrub_unrepairable"] == 0 \
            and t["ec_under_replicated"] == 0 \
            and t["coordinator_repair_failures"] == 0

    # the verdict clears (re-scrub) only after the repair: wait for it
    # first, so the sha256 check below is not inside either time
    res["seconds"]["rot_to_health_clear"] = wait_for(
        "/cluster/health to count no unrepairable verdict",
        verdict_cleared, 300)
    res["seconds"]["rot_to_sha256_equal"], res["seconds"]["rot_verify"] = \
        wait_healed(master, vid, (), shard_path, hashes, done, t0, 300)
    res["rot_to_heal_s"] = max(res["seconds"]["rot_to_health_clear"],
                               res["seconds"]["rot_to_sha256_equal"])
    health = cluster_health(master)
    # the counters of detection (corrupt_shards, scrub_repairs) never fall:
    # the host that saw the rot keeps `degraded` true while it is a peer
    res["health_after_rot"] = {
        "degraded": health["degraded"],
        "nonzero": {k: v for k, v in health["totals"].items() if v}}
    st = coordinator_status(master)
    rot_repair = next(r for r in st["recent"]
                      if r["action"] == "repair_done")
    res["rot_repair"] = {k: rot_repair[k] for k in
                         ("host", "rebuilt", "spread", "rescrubbed",
                          "cause_event", "cause_trace", "alert")}
    # the journal: the rotted server's detection and verdict, then the
    # master's plan and repair, and the repair names one of the two
    want = [("shard_corrupt", host), ("scrub_unrepairable", host),
            ("repair_planned", master), ("repair_done", master)]

    def rot_journal() -> list[dict]:
        return [e for e in journal(master, rot_wall) if e["type"] in (
            "shard_corrupt", "scrub_unrepairable", "repair_planned",
            "repair_done")]

    # the master's own events reach its journal at the next flush
    wait_for("the rot's events in /cluster/events",
             lambda: len(rot_journal()) >= len(want), 30)
    rot_events = rot_journal()
    if [(e["type"], e.get("server")) for e in rot_events[:4]] != want:
        raise AssertionError(f"/cluster/events after the rot: {rot_events}")
    if rot_repair["cause_event"] not in (rot_events[0]["id"],
                                         rot_events[1]["id"]):
        raise AssertionError(f"the rot repair's cause {rot_repair} is not "
                             f"its scrub's event: {rot_events[:2]}")
    res["journal"] = {"rot": [(e["type"], e.get("server"))
                              for e in rot_events],
                      "rot_cause": next(e["type"] for e in rot_events
                                        if e["id"] ==
                                        rot_repair["cause_event"])}
    res["seconds"]["rot_scrub_end_to_repair_done"] = \
        rot_repair["at"] - t0_wall
    # the repair names a firing alert, in its record, in coordinator.status
    # and after that alert's alert_fired in the journal
    everything = journal(master, 0.0)
    rot_done = next(e["id"] for e in rot_events if e["type"] == "repair_done")
    out, _ = run_shell(master, "coordinator.status")
    if rot_repair["alert"] not in paged or \
            f"alert={rot_repair['alert']}" not in out or \
            not fired_before(everything, rot_repair["alert"], rot_done):
        raise AssertionError(f"the rot repair's alert {rot_repair['alert']!r}"
                             f": firing {sorted(paged)}, {out}")
    res["alerts"]["rot_repair_alert"] = rot_repair["alert"]

    mid = kernel_launches(alive)
    check_launches("rot", pre, mid, pre_wall)

    # 2. loss: the host that saw both rots
    done = st["repairs"]["done"]
    left = sorted(s for s, us in shard_holders(master, vid).items()
                  if any(u != host for u in us))
    if len(left) < 10:
        raise AssertionError(f"killing {host} would leave shards {left}")
    t0, t0_wall = time.perf_counter(), time.time()
    vs[host]["proc"].kill()
    vs[host]["proc"].wait()
    drop = Watch("the master to drop the killed server",
                 lambda: host not in node_urls(master_status(master)),
                 t0, 120)
    clean = Watch("/cluster/health to read degraded: false",
                  lambda: cluster_health(master)["degraded"] is False,
                  t0, 300)
    res["seconds"]["kill_to_sha256_equal"], res["seconds"]["loss_verify"] = \
        wait_healed(master, vid, (host,), shard_path, hashes, done, t0, 300)
    res["kill_to_heal_s"] = res["seconds"]["kill_to_sha256_equal"]
    # the master journaled the lost peer before it planned the repair
    wait_for("the loss's events in /cluster/events", lambda: {
        "peer_stale", "repair_planned", "repair_done"} <= {
            e["type"] for e in journal(master, t0_wall)}, 30)
    loss_events = journal(master, t0_wall)
    stale = [e for e in loss_events if e["type"] == "peer_stale"
             and e["details"].get("peer") == host]
    planned = [e for e in loss_events if e["type"] == "repair_planned"]
    if not stale or not planned or \
            _journal_seq(stale[0])[0] != _journal_seq(planned[0])[0] or \
            _journal_seq(stale[0]) > _journal_seq(planned[0]):
        raise AssertionError(f"/cluster/events after the kill: "
                             f"{loss_events}")
    res["journal"]["loss"] = [(e["type"], e.get("server"))
                              for e in loss_events]
    # peer_down fires (anew, or still firing since the first kill) and the
    # loss repair names it or the rot's alert, after its alert_fired
    st = coordinator_status(master)
    loss_repair = next(r for r in st["recent"]
                       if r["action"] == "repair_done")
    pd = cluster_alerts(master)["peer_down"]
    loss_done = next(e["id"] for e in loss_events
                     if e["type"] == "repair_done")
    if pd["state"] != "firing" or \
            loss_repair["alert"] not in REPAIR_ALERTS or \
            not fired_before(journal(master, 0.0), loss_repair["alert"],
                             loss_done):
        raise AssertionError(f"the loss: peer_down {pd}, repair "
                             f"{loss_repair}")
    res["alerts"]["loss_repair_alert"] = loss_repair["alert"]
    res["alerts"]["loss_peer_down"] = {
        "fires": pd["fires"], "fault_to_fired_s": pd["fired_at"] - t0_wall
        if pd["fired_at"] >= t0_wall else None}
    out, _ = run_shell(master, "events.tail -n 200")
    for t in ("shard_corrupt", "scrub_unrepairable", "repair_planned",
              "repair_done", "peer_stale"):
        if f" {t} " not in out:
            raise AssertionError(f"events.tail shows no {t}: {out}")
    res["journal"]["events_tail_lines"] = len(out.splitlines())
    res["seconds"]["drop"] = drop.wait()
    res["seconds"]["kill_to_health_clean"] = clean.wait()

    # 3. the coordinator's own account
    st = coordinator_status(master)
    if st["repairs"]["done"] < 2 or st["repairs"]["failed"] or \
            st["last_error"] or st["queue"]:
        raise AssertionError(f"/cluster/coordinator after the drill: {st}")
    check_launches("loss", mid, kernel_launches(
        [u for u in alive if u != host]), t0_wall)
    loss = [r for r in st["replicated"]["log"] if r["at"] >= t0_wall]
    planned = next(r["at"] for r in loss if r["op"] == "planned")
    done_at = next(r["at"] for r in loss if r["op"] == "done")
    loss_repair = next(r for r in st["recent"]
                       if r["action"] == "repair_done")
    res["loss_repair"] = {k: loss_repair[k] for k in
                          ("host", "rebuilt", "spread", "rescrubbed")}
    res["seconds"]["kill_to_repair_planned"] = planned - t0_wall
    res["seconds"]["loss_repair"] = done_at - planned
    res["repair_hosts"] = sorted({r["host"] for r in st["recent"]
                                  if r["action"] == "repair_done"})
    res["coordinator"] = {"cycles": st["cycles"], "repairs": st["repairs"],
                          "moves": st["moves"],
                          "recent": [r["action"] for r in st["recent"]]}
    return res


def journal(master: str, since_wall: float) -> list[dict]:
    """The master's cluster journal from ``since_wall`` on, by time."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return http_json("GET", f"http://{master}/cluster/events?limit=0&"
                            f"since={since_wall}")["events"]


def _journal_seq(e: dict) -> tuple[str, int]:
    """(journal namespace, sequence) of an event id ``<ns>.<hex seq>``:
    one journal's events in the order it took them."""
    ns, _, seq = e["id"].rpartition(".")
    return ns, int(seq, 16)


def pause_coordinator(master: str) -> None:
    """coordinator.pause, then wait until no cycle is running: one that
    began before the pause finishes its repairs and moves."""
    out, _ = run_shell(master, "coordinator.pause")
    if not out.startswith("coordinator: paused"):
        raise AssertionError(f"coordinator.pause: {out}")

    def settled() -> bool:
        cycles = coordinator_status(master)["cycles"]
        time.sleep(1.5)  # longer than the loop's one-second interval
        return coordinator_status(master)["cycles"] == cycles

    wait_for("the paused coordinator to finish its cycle", settled, 120)


def run_drain_leg(master: str, collection: str, vid: int, vs: dict,
                  alive: list, shard_path, hashes: dict, shards_of: list,
                  needles: list[dict], fids: list[str], expect: dict,
                  seed: int, engine: str, reads: int,
                  deleted_reads: int) -> dict:
    """Drain a server that holds shards of the EC volume, with the
    coordinator paused: ``volume.server.evacuate`` (each of its shards
    copied to another live server, mounted there and deleted here) and
    ``volume.server.leave``, until the master drops it; every moved
    shard's sha256 on its new holder, under the collection's file name,
    equal to the one recorded at the encode; the drained server SIGTERMed
    (its stop line counts exactly what its GETs needed, exit 0); ``reads``
    GETs of needles with an interval on a moved shard, with no kernel
    launched anywhere (no reconstruction); then one moved data shard
    deleted on its new holder and ``deleted_reads`` GETs from that holder
    of needles with an interval on it, reconstructed there (its kernel
    launches rise; bytes and CRC right); last, ``ec.rebuild`` restores the
    shard to its sha256.  ``expect`` gains what each GET needed and the
    drained server leaves ``alive``."""
    from seaweedfs_tpu_torch.storage.crc import crc32c
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json

    res: dict = {"seconds": {}}
    secs = res["seconds"]
    pause_coordinator(master)
    holders = shard_holders(master, vid)
    held = {u: sorted(s for s, us in holders.items() if u in us)
            for u in alive}
    node = min((u for u in alive if any(s < 10 for s in held[u])),
               key=lambda u: (-len(held[u]), u))
    out, secs["evacuate"] = run_shell(
        master, f"volume.server.evacuate -node {node}")
    moves: dict[int, str] = {}
    for line in out.splitlines():
        m = re.fullmatch(rf"ec {vid}\.(\d+) -> (\S+)", line)
        if not m:
            raise AssertionError(f"volume.server.evacuate: {out}")
        moves[int(m.group(1))] = m.group(2)
    if sorted(moves) != held[node]:
        raise AssertionError(f"evacuated {sorted(moves)}, {node} held "
                             f"{held[node]}: {out}")
    out, secs["leave"] = run_shell(master,
                                   f"volume.server.leave -node {node}")
    if out != f"{node} left the cluster (process still running; " \
              "data intact)":
        raise AssertionError(f"volume.server.leave: {out}")
    secs["leave_to_drop"] = wait_for(
        "the master to drop the server that left",
        lambda: node not in node_urls(master_status(master)), 120)
    holders = shard_holders(master, vid)
    for sid, dst in moves.items():
        if holders.get(sid) != [dst] or \
                sha256_file(shard_path(dst, sid)) != hashes[sid]:
            raise AssertionError(f"moved shard {sid} on {dst} differs, or "
                                 f"the master shows {holders.get(sid)}")
    base = volume_file_prefix(vs[node]["dir"], collection, vid)
    if [n for n in os.listdir(vs[node]["dir"])
            if n.startswith(os.path.basename(base) + ".")]:
        raise AssertionError(f"{node} kept files of volume {vid}")
    t0 = time.perf_counter()
    counts = stop_volume_server(vs[node]["proc"])
    secs["stop"] = time.perf_counter() - t0
    if {k: counts[k] for k in expect[node]} != expect[node]:
        raise AssertionError(f"{node} counted {counts}, its GETs needed "
                             f"{expect[node]}")
    alive.remove(node)
    res["drained"] = {"url": node, "shards": held[node], "moves": moves,
                      **counts}

    # GETs of needles with an interval on a moved shard: remote shard
    # reads and local ones, no reconstruction (no kernel anywhere)
    rng = np.random.default_rng([seed, 9])
    touched = [i for i, sids in enumerate(shards_of) if set(sids) & set(moves)]
    before = kernel_launches(alive)
    done = timed_gets(master, rng.choice(touched, size=min(reads, len(
        touched)), replace=False), needles, fids, seed + 9)
    if kernel_launches(alive) != before:
        raise AssertionError("a GET of a moved shard was reconstructed")
    for asked, i, _ in done:
        for sid in shards_of[i]:
            if asked not in holders[sid]:
                expect[asked]["remote"] += 1
    res["moved_gets"] = len(done)
    res["moved_gets_ms"] = percentiles([lat for _, _, lat in done])

    # a moved data shard lost on its new holder: its GETs there are
    # reconstructed on that server's card
    sid = min(s for s in moves if s < 10)
    host = moves[sid]
    http_json("POST", f"http://{host}/admin/ec/delete",
              {"volume_id": vid, "collection": collection,
               "shard_ids": [sid]})
    # the holder's remount of its other shards can reach the master as a
    # delta that drops them all for a pulse: wait for every other shard
    wait_for(f"the master to drop shard {sid} of {host} alone", lambda: (
        sorted(shard_holders(master, vid))
        == [s for s in range(14) if s != sid]), 60)
    holders = shard_holders(master, vid)
    plain = [i for i, sids in enumerate(shards_of) if sid in sids
             and not needles[i]["upload"].get("compress")]
    picks = rng.choice(plain, size=min(deleted_reads, len(plain)),
                       replace=False).tolist()
    before = kernel_launches([host])[host]
    lats = []
    rebuilt = 0
    for i in picks:
        t0 = time.perf_counter()
        status, body, headers = http_bytes("GET", f"http://{host}/{fids[i]}")
        lats.append(time.perf_counter() - t0)
        etag = {k.lower(): v for k, v in headers.items()}.get("etag")
        if status != 200 or body != needles[i]["data"] or \
                etag != '"%08x"' % crc32c(body):
            raise AssertionError(f"GET {fids[i]} from {host}: {status}, "
                                 f"{len(body)} bytes, ETag {etag}")
        for s in shards_of[i]:
            if s == sid:
                expect[host]["reconstructed"] += 1
                rebuilt += 1
            elif host not in holders[s]:
                expect[host]["remote"] += 1
    launches = kernel_launches([host])[host] - before
    if engine == "tpu" and launches <= 0:
        raise AssertionError(f"{host} reconstructed shard {sid} with no "
                             "kernel launch")
    res["deleted_shard"] = {"sid": sid, "host": host, "gets": len(picks),
                            "reconstructed_intervals": rebuilt,
                            "ms": percentiles(lats), "launches": launches}
    before = kernel_launches(alive)
    out, secs["ec.rebuild"] = run_shell(master, f"ec.rebuild -volumeId {vid}")
    m = re.search(rf"rebuilt shards \[{sid}\] on (\S+?)[;\s]", out)
    if not m:
        raise AssertionError(f"ec.rebuild of shard {sid}: {out}")
    res["deleted_shard"]["rebuild_launches"] = \
        kernel_launches([m.group(1)])[m.group(1)] - before[m.group(1)]
    holders = shard_holders(master, vid)
    if not holders.get(sid) or any(sha256_file(shard_path(u, sid))
                                   != hashes[sid] for u in holders[sid]):
        raise AssertionError(f"rebuilt shard {sid} differs")
    res["deleted_shard"]["rebuilt_on"] = m.group(1)
    return res


# --- the vacuum leg of the cluster phase ---------------------------------

def plain_compaction(dat_path: str, idx_path: str) -> dict:
    """Vacuum's plain version, independent of the port's Volume: replay
    the `.idx` (the last put of a key wins, a tombstone or zero offset
    drops it), then the live records in the order of their offsets after
    the superblock, its compaction revision one on.  -> the sha256 and
    size of that `.dat`, and {key: needle size} of what it holds."""
    with open(idx_path, "rb") as f:
        raw = f.read()
    entries = np.frombuffer(raw[:len(raw) - len(raw) % 16], dtype=[
        ("key", ">u8"), ("offset", ">u4"), ("size", ">i4")])
    live: dict[int, tuple[int, int]] = {}
    for key, off, size in entries.tolist():
        if off and size > 0:
            live[key] = (off * 8, size)
        else:
            live.pop(key, None)
    with open(dat_path, "rb") as f:
        sb = bytearray(f.read(8))
        if sb[6:8] != b"\x00\x00":
            raise AssertionError(f"{dat_path}: superblock with extra bytes")
        rev = int.from_bytes(sb[4:6], "big")
        sb[4:6] = ((rev + 1) & 0xFFFF).to_bytes(2, "big")
        h = hashlib.sha256(sb)
        total = len(sb)
        for off, size in sorted(live.values()):
            used = 16 + size + 4 + 8  # header, data, crc, append_at_ns
            n = used + 8 - used % 8  # padding of 1-8 bytes
            f.seek(off)
            blob = f.read(n)
            if len(blob) != n:
                raise AssertionError(f"{dat_path}: record at {off} cut")
            h.update(blob)
            total += n
    return {"sha256": h.hexdigest(), "size": total,
            "live": {k: s for k, (_, s) in live.items()}}


def idx_records(idx_path: str) -> list[tuple[int, int, int]]:
    """(key, offset, size) of every entry of a compacted `.idx` (one put
    per live needle), in file order."""
    with open(idx_path, "rb") as f:
        raw = f.read()
    entries = np.frombuffer(raw, dtype=[("key", ">u8"), ("offset", ">u4"),
                                        ("size", ">i4")])
    return [(int(k), int(o) * 8, int(s)) for k, o, s in entries]


def idx_live(idx_path: str) -> dict[int, int]:
    """{key: size} of a compacted `.idx`."""
    return {k: s for k, _, s in idx_records(idx_path)}


class LoopReader:
    """One thread GETting surviving needles through one WeedClient, in a
    seeded order, until ``stop()``; each body must be the bytes written.
    Keeps (start, seconds) of every GET and every error."""

    def __init__(self, master: str, needles: list[dict], fids: list[str],
                 picks: list[int], seed: int):
        from seaweedfs_tpu_torch.client.operation import WeedClient

        self.gets: list[tuple[float, float]] = []
        self.errors: list[str] = []
        self._stop = threading.Event()
        client = WeedClient(master)
        client.rng.seed(seed)
        order = np.random.default_rng(seed).permutation(picks).tolist()

        def run() -> None:
            k = 0
            while not self._stop.is_set():
                i = order[k % len(order)]
                k += 1
                t0 = time.perf_counter()
                try:
                    body = client.download(fids[i])
                except Exception as e:  # noqa: BLE001 - counted as a fault
                    self.errors.append(f"GET {fids[i]}: {e}")
                    continue
                self.gets.append((t0, time.perf_counter() - t0))
                if body != needles[i]["data"]:
                    self.errors.append(f"GET {fids[i]}: wrong bytes")

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=120)
        if self._t.is_alive():
            raise AssertionError("the reader thread did not stop")


def vac_layouts(master: str, collection: str, vid: int) -> dict:
    """{replication: (vid in volumes, vid in writables)} of the
    collection's layouts on the master."""
    return {lay["replication"]: (vid in lay["volumes"],
                                 vid in lay["writables"])
            for lay in master_status(master)["Layouts"]
            if lay["collection"] == collection}


def volume_infos(master: str, vid: int) -> dict[str, dict]:
    """url -> the master's VolumeInfo of ``vid`` on that server."""
    return {n["Url"]: v for n in data_nodes(master_status(master))
            for v in n["VolumeInfos"] if v["id"] == vid}


def run_volume_ops(master: str, vs: dict, collection: str, vid: int,
                   needles: list[dict], fids: list[str], live: list[int],
                   seed: int) -> dict:
    """The volume shell on a 001 volume's two replicas, through
    ``shell -c``: volume.fsck and volume.check.disk (OK, in sync), one
    byte flipped in a live needle of one replica (fsck: CORRUPT on that
    replica only; check.disk: CORRUPT), volume.delete -node of that
    replica, volume.fix.replication (the copy's `.dat` and `.idx` equal
    the healthy replica's by sha256), volume.move of one replica to a
    server holding none while a reader GETs survivors (no error allowed),
    volume.configure.replication 000 and back to 001 (byte 1 of each
    replica's `.dat`, and the master's layouts), volume.mark -readonly
    and -writable (the master's VolumeInfos and writable set).  Returns
    the walls and the reader's numbers."""
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_json

    res: dict = {"seconds": {}}
    secs = res["seconds"]

    def base(url: str) -> str:
        return volume_file_prefix(vs[url]["dir"], collection, vid)

    def replicas() -> list[str]:
        return sorted(WeedClient(master).master.lookup_uncached(vid))

    held = replicas()
    res["dat_bytes"] = os.path.getsize(base(held[0]) + ".dat")
    fsck_line = re.compile(rf"volume {vid} @ (\S+): indexed=(\d+) "
                           rf"live=(\d+) crc_errors=(\d+) (OK|CORRUPT)")

    def fsck() -> dict[str, tuple]:
        out, wall = run_shell(master, f"volume.fsck -volumeId {vid}")
        found = {m.group(1): (int(m.group(2)), int(m.group(3)),
                              int(m.group(4)), m.group(5))
                 for m in map(fsck_line.fullmatch, out.splitlines()) if m}
        if sorted(found) != held or len(out.splitlines()) != len(held):
            raise AssertionError(f"volume.fsck: {out}")
        secs.setdefault("fsck", []).append(wall)
        return found

    def check_disk(state: str) -> None:
        out, wall = run_shell(master, f"volume.check.disk -volumeId {vid}")
        if not (out.startswith(f"volume {vid}: ")
                and out.endswith(f"[{state}]")):
            raise AssertionError(f"volume.check.disk, not {state}: {out}")
        secs.setdefault("check_disk", []).append(wall)

    # 1. both replicas clean; the scan's own rate, route by route
    n_live = len(live)
    if set(fsck().values()) != {(n_live, n_live, 0, "OK")}:
        raise AssertionError("volume.fsck of the clean replicas")
    check_disk("in sync")
    secs["scan"] = {}
    for u in held:
        t0 = time.perf_counter()
        r = http_json("POST", f"http://{u}/admin/volume_check",
                      {"volume_id": vid}, timeout=600)
        secs["scan"][u] = time.perf_counter() - t0
        if r != {"indexed": n_live, "scanned_live": n_live,
                 "crc_errors": 0}:
            raise AssertionError(f"/admin/volume_check on {u}: {r}")

    # 2. one byte of a live needle's data flipped on one replica
    bad, good = held
    key, offset, size = idx_records(base(bad) + ".idx")[n_live // 2]
    flip_byte(base(bad) + ".dat", offset + 20)  # header 16, data size 4
    want = {bad: (n_live, n_live, 1, "CORRUPT"),
            good: (n_live, n_live, 0, "OK")}
    if fsck() != want:
        raise AssertionError(f"volume.fsck after the flip, not {want}")
    check_disk("CORRUPT")
    res["corrupt"] = {"replica": bad, "needle": key, "offset": offset + 20}

    # 3. the rotted replica dropped and re-replicated
    out, secs["delete"] = run_shell(master,
                                    f"volume.delete -volumeId {vid} "
                                    f"-node {bad}")
    if out != f"deleted volume {vid} on ['{bad}']" or \
            os.path.exists(base(bad) + ".dat") or replicas() != [good]:
        raise AssertionError(f"volume.delete -node: {out}")
    out, secs["fix_replication"] = run_shell(master,
                                             "volume.fix.replication")
    m = re.fullmatch(rf"replicated {vid} -> (\S+)", out)
    if not m or sorted([good, m.group(1)]) != replicas():
        raise AssertionError(f"volume.fix.replication: {out}")
    copy = m.group(1)
    for ext in (".dat", ".idx"):
        if sha256_file(base(copy) + ext) != sha256_file(base(good) + ext):
            raise AssertionError(f"the copy's {ext} on {copy} differs from "
                                 f"the healthy replica's")
    res["fix_replication"] = {"source": good, "target": copy,
                              "sha256_equal": True}

    # 4. a replica moved to a server that held none, under a reader
    held = replicas()
    src = good
    dst = min(u for u in vs if u not in held
              and vs[u]["proc"].poll() is None)
    reader = LoopReader(master, needles, fids, live, seed)
    try:
        t0 = time.perf_counter()
        out, secs["move"] = run_shell(master,
                                      f"volume.move -volumeId {vid} "
                                      f"-source {src} -target {dst}")
        t1 = time.perf_counter()
    finally:
        reader.stop()
    if out != f"moved volume {vid} from {src} to {dst}":
        raise AssertionError(f"volume.move: {out}")
    if reader.errors:
        raise AssertionError(f"the reader saw {len(reader.errors)} errors "
                             f"during the move: {reader.errors[:3]}")
    during = [lat for start, lat in reader.gets if t0 <= start <= t1]
    if not during:
        raise AssertionError("the reader made no GET during the move")
    held = replicas()
    if held != sorted([copy, dst]) or os.path.exists(base(src) + ".dat") \
            or sha256_file(base(dst) + ".dat") != \
            sha256_file(base(copy) + ".dat"):
        raise AssertionError(f"after volume.move: replicas {held}")
    res["move"] = {"source": src, "target": dst,
                   "reader": {"gets": len(reader.gets),
                              "gets_during_move": len(during),
                              "ms": percentiles([lat for _, lat
                                                 in reader.gets]),
                              "ms_during_move": percentiles(during)}}

    # 5. the placement rewritten in both superblocks, and back
    for rp in ("000", "001"):
        out, secs[f"configure_{rp}"] = run_shell(
            master, f"volume.configure.replication -volumeId {vid} "
                    f"-replication {rp}")
        m = re.fullmatch(rf"volume {vid} replication set to {rp} on "
                         rf"(\S+), (\S+)", out)
        if not m or sorted(m.groups()) != held:
            raise AssertionError(f"volume.configure.replication: {out}")
        for u in held:
            with open(base(u) + ".dat", "rb") as f:
                if f.read(2)[1] != int(rp):
                    raise AssertionError(f"{u}: superblock not {rp}")
        wait_for(f"the master's {rp} layout to hold volume {vid}",
                 lambda: vac_layouts(master, collection, vid).get(
                     rp, (False,))[0], 30)
    # the master keeps the volume in its 000 layout too (the reference's
    # heartbeat registers a new placement without leaving the old one)
    res["layouts"] = vac_layouts(master, collection, vid)
    if res["layouts"].get("001") != (True, True):
        raise AssertionError(f"layouts after 001: {res['layouts']}")

    # 6. both replicas marked read-only, then writable again
    for flag, ro in (("-readonly", True), ("-writable", False)):
        out, secs[f"mark{flag}"] = run_shell(master, "; ".join(
            f"volume.mark -volumeId {vid} -node {u} {flag}" for u in held))
        if out.splitlines() != [f"marked {flag[1:]}"] * 2:
            raise AssertionError(f"volume.mark {flag}: {out}")
        wait_for(f"/dir/status to show volume {vid} {flag[1:]}", lambda: (
            sorted(volume_infos(master, vid)) == held
            and all(v["read_only"] is ro
                    for v in volume_infos(master, vid).values())
            and vac_layouts(master, collection, vid)["001"][1] is not ro),
            30)
    res["replicas"] = held
    return res


def run_vacuum_leg(master: str, vs: dict, engine: str, vac_bytes: int,
                   threads: int, work: str) -> dict:
    """Vacuum a replicated volume, then EC-encode it: a 001 volume of
    collection "vac" grown on two servers, ``vac_bytes`` of needles
    uploaded from ``threads`` threads, deletes in a seeded order until
    40% of the bytes are gone, ``volume.vacuum -garbageThreshold 0.3``
    through the shell while one reader GETs survivors, checks of both
    replicas' files (each against the plain compaction of its own
    pre-vacuum files), of /dir/status and of every GET, then ``ec.encode``
    of the compacted volume: parity against the host table, every shard
    against its `.eci`, GETs through EC, and the encode host's kernel
    launches against the dispatches the encoder's rule gives for the
    compacted size.  Between the vacuum's checks and the encode, the
    volume shell's leg (``run_volume_ops``).  Last, ``ec.decode`` and
    ``collection.delete`` drop the collection and leave the master's
    view as before the leg.  Returns the numbers and each server's
    remote shard reads from its EC GETs."""
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.ops.gf_matmul import ROWS_PER_LAUNCH
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json

    collection = "vac"
    seed = SEED + 8
    res: dict = {"seconds": {}}
    vid = http_json("GET", f"http://{master}/vol/grow?collection={collection}"
                           f"&replication=001&count=1")["volumeIds"][0]
    replicas = WeedClient(master).master.lookup(vid)
    if len(replicas) != 2:
        raise AssertionError(f"volume {vid} of 001 on {replicas}")
    bases = {u: volume_file_prefix(vs[u]["dir"], collection, vid)
             for u in replicas}
    needles = [cluster_needle(seed, i, nid, size) for i, (nid, _, size)
               in enumerate(needle_specs(seed, vac_bytes))]
    fids: list[str] = [""] * len(needles)

    def upload(t: int) -> None:
        client = WeedClient(master)
        for i in range(t, len(needles), threads):
            fids[i] = client.upload(needles[i]["data"], collection=collection,
                                    replication="001", **needles[i]["upload"])

    t0 = time.perf_counter()
    run_threads(upload, threads, 1800)
    res["seconds"]["upload"] = time.perf_counter() - t0
    if {FileId.parse(f).volume_id for f in fids} != {vid}:
        raise AssertionError("needles landed outside the vacuum's volume")
    written = sum(len(n["data"]) for n in needles)
    order = np.random.default_rng(seed).permutation(len(needles)).tolist()
    gone: list[int] = []
    deleted = 0
    client = WeedClient(master)
    t0 = time.perf_counter()
    for i in order:
        if deleted >= 0.4 * written:
            break
        client.delete(fids[i])
        gone.append(i)
        deleted += len(needles[i]["data"])
    res["seconds"]["delete"] = time.perf_counter() - t0
    gone_set = set(gone)
    live = [i for i in range(len(needles)) if i not in gone_set]
    res.update(needles=len(needles), written_bytes=written,
               deleted_needles=len(gone), deleted_bytes=deleted)
    res["garbage_ratio"] = {u: http_json(
        "POST", f"http://{u}/admin/vacuum_check",
        {"volume_id": vid})["garbage_ratio"] for u in replicas}
    print(json.dumps({"vacuum_check": res["garbage_ratio"]}), flush=True)
    if min(res["garbage_ratio"].values()) < 0.3:
        raise AssertionError(f"garbage below the threshold: {res}")

    # the files as the vacuum finds them, kept by hard links: the swap
    # renames new files over these names, the links keep the old ones
    snap = os.path.join(work, "vac_snapshot")
    os.makedirs(snap)
    plain = {}
    for k, (u, base) in enumerate(bases.items()):
        for ext in (".dat", ".idx"):
            os.link(base + ext, os.path.join(snap, f"{k}{ext}"))
        plain[u] = plain_compaction(os.path.join(snap, f"{k}.dat"),
                                    os.path.join(snap, f"{k}.idx"))
    res["bytes_before"] = {u: os.path.getsize(b + ".dat")
                           for u, b in bases.items()}

    reader = LoopReader(master, needles, fids, live, seed)
    try:
        t0 = time.perf_counter()
        out, wall = run_shell(master, "volume.vacuum -garbageThreshold 0.3")
        t1 = time.perf_counter()
    finally:
        reader.stop()
    res["seconds"]["vacuum"] = wall
    if not re.fullmatch(r"compacted volumes: \[[\d, ]*\]", out) or \
            vid not in [int(x) for x in re.findall(r"\d+", out)]:
        raise AssertionError(f"volume.vacuum: {out}")
    if reader.errors:
        raise AssertionError(f"the reader saw {len(reader.errors)} errors: "
                             f"{reader.errors[:3]}")
    during = [lat for start, lat in reader.gets if t0 <= start <= t1]
    if not during:
        raise AssertionError("the reader made no GET during the vacuum")
    res["reader"] = {"gets": len(reader.gets), "gets_during_vacuum":
                     len(during), "ms": percentiles(
                         [lat for _, lat in reader.gets]),
                     "ms_during_vacuum": percentiles(during)}

    # both replicas: the plain compaction of their own files, the live
    # needles and nothing else, compaction revision 1
    want_keys = {FileId.parse(fids[i]).key for i in live}
    res["bytes_after"] = {}
    res["sha256"] = {}
    for u, base in bases.items():
        got = sha256_file(base + ".dat")
        size = os.path.getsize(base + ".dat")
        keys = idx_live(base + ".idx")
        if got != plain[u]["sha256"] or size != plain[u]["size"]:
            raise AssertionError(f"{u}: compacted .dat differs from the "
                                 f"plain compaction of its files")
        if set(keys) != want_keys or keys != plain[u]["live"] or \
                keys != idx_live(bases[replicas[0]] + ".idx"):
            raise AssertionError(f"{u}: compacted .idx holds other needles")
        record = sum(16 + s + 12 + 8 - (16 + s + 12) % 8
                     for s in keys.values())
        if size != 8 + record:
            raise AssertionError(f"{u}: {size} bytes, not the superblock "
                                 f"and {record} bytes of live records")
        with open(base + ".dat", "rb") as f:
            if int.from_bytes(f.read(8)[4:6], "big") != 1:
                raise AssertionError(f"{u}: compaction revision not 1")
        res["bytes_after"][u] = size
        res["sha256"][u] = got
    if len(set(res["bytes_after"].values())) != 1:
        raise AssertionError(f"the replicas differ: {res['bytes_after']}")
    # replicas append in the order requests reach them and stamp their own
    # append times, so their .dat files match in size and needles; the
    # bytes match only if both saw one order
    res["replica_dat_sha256_equal"] = len(set(res["sha256"].values())) == 1

    def shown() -> bool:
        infos = {n["Url"]: v for n in data_nodes(master_status(master))
                 for v in n["VolumeInfos"] if v["id"] == vid}
        return set(infos) == set(replicas) and all(
            v["size"] == res["bytes_after"][u] and not v["read_only"]
            and not v["delete_count"] for u, v in infos.items())

    res["seconds"]["dir_status"] = wait_for(
        "/dir/status to show the compacted size", shown, 60)
    run_threads(lambda t: timed_gets(master, live[t::threads], needles,
                                     fids, seed + t), threads, 600)
    for i in gone:
        for u in replicas:
            status, _, _ = http_bytes("GET", f"http://{u}/{fids[i]}")
            if status != 404:
                raise AssertionError(f"deleted {fids[i]} on {u}: {status}")

    t0 = time.perf_counter()
    res["volume_ops"] = run_volume_ops(master, vs, collection, vid, needles,
                                       fids, live, seed)
    res["seconds"]["volume_ops"] = time.perf_counter() - t0

    # the compacted volume on the card
    source = WeedClient(master).master.lookup(vid)[0]
    dat_size = os.path.getsize(volume_file_prefix(
        vs[source]["dir"], collection, vid) + ".dat")
    rows = 4  # parity rows a dispatch computes
    want = (StreamingEncoder(device="cpu").dispatches_for(dat_size)
            * -(-rows // ROWS_PER_LAUNCH)) if engine == "tpu" else 0
    before = kernel_launches([source])[source]
    out, res["seconds"]["ec.encode"] = run_shell(
        master, f"ec.encode -collection {collection} -volumeId {vid}")
    m = re.search(r"generate ([\d.]+) s, spread ([\d.]+) s", out)
    if f"ec encoded volume {vid} via tpu engine" not in out or not m:
        raise AssertionError(f"ec.encode of the compacted volume: {out}")
    res["seconds"]["encode_generate"] = float(m.group(1))
    res["launches"] = kernel_launches([source])[source] - before
    res["launches_expected"] = want
    res["encode_host"] = source
    if res["launches"] != want:
        raise AssertionError(f"{source} launched {res['launches']} kernels "
                             f"encoding {dat_size} bytes, not {want}")
    holders = shard_holders(master, vid)
    if sorted(holders) != list(range(14)):
        raise AssertionError(f"after ec.encode: {holders}")

    def shard_path(sid: int) -> str:
        return volume_file_prefix(vs[holders[sid][0]]["dir"], collection,
                                  vid) + to_ext(sid)

    holder_base = volume_file_prefix(vs[holders[0][0]]["dir"], collection, vid)
    check_shards(holder_base, PARITY_STRIPES, seed, shard_path)
    shards_of = dict(zip(live, needle_shards(
        holder_base, vid, [FileId.parse(fids[i]).key for i in live])))
    done: list = []
    run_threads(lambda t: done.extend(timed_gets(
        master, live[t::threads], needles, fids, seed + t)), threads, 600)
    remote: dict[str, int] = {}
    for asked, i, _ in done:
        for sid in shards_of[i]:
            if asked not in holders[sid]:
                remote[asked] = remote.get(asked, 0) + 1
    res["ec_remote_reads"] = remote
    urls = sorted({u for us in holders.values() for u in us})
    for k, i in enumerate(gone):
        status, _, _ = http_bytes("GET", f"http://{urls[k % len(urls)]}/"
                                         f"{fids[i]}")
        if status != 404:
            raise AssertionError(f"deleted {fids[i]} through EC: {status}")

    # the later legs find the cluster as they would without this one.
    # collection.delete drops a collection's volumes, not its EC shards
    # (the reference's too): the volume is decoded first
    out, res["seconds"]["ec.decode"] = run_shell(
        master, f"ec.decode -volumeId {vid}")
    if f"decoded ec volume {vid}" not in out:
        raise AssertionError(f"ec.decode of the vacuum's volume: {out}")
    out, res["seconds"]["collection.delete"] = run_shell(
        master, f"collection.delete -collection {collection}")
    if not re.fullmatch(rf"deleted collection {collection}: volumes "
                        rf"\[{vid}(, {vid})*\]", out):
        raise AssertionError(f"collection.delete: {out}")
    res["seconds"]["drop"] = wait_for(
        "the master to forget the vacuum's volume", lambda: all(
            n["Volumes"] == 0 and n["EcShards"] == 0
            for n in data_nodes(master_status(master))), 60)
    return res


def run_cluster_phase(engine: str, work: str, volume_bytes: int,
                      reads: int, threads: int, per_thread: int,
                      decoded_reads: int, vac_bytes: int, servers: int = 5,
                      pulse_seconds: float = 0.5,
                      coordinator_seconds: float = 1.0) -> dict:
    """A whole EC cluster through the port's CLI: a master
    (``-coordinatorSeconds`` and ``-metricsAggregationSeconds``
    ``coordinator_seconds``, its coordinator paused at once with the
    shell's coordinator.pause) and ``servers`` volume servers
    (``-ec.engine <engine>``), each its own process.  First the vacuum
    leg (``run_vacuum_leg``, ``vac_bytes`` on a 001 volume of its own,
    dropped at its end).  Then one volume of
    collection "ec" is uploaded through WeedClient from ``threads``
    threads, then the shell's ec.encode; the server holding the most
    shards (not the encode's source) is SIGKILLed and dropped by the
    master; ``reads`` single-client and ``threads`` x ``per_thread``
    concurrent degraded GETs; ec.rebuild (rebuilt shards equal to their
    sha256 before the loss); a rotted shard that ec.scrub -all quarantines
    and ec.rebuild heals.  Then the drill (``coordinator_drill``):
    coordinator.resume, and the coordinator alone heals a second rotted
    shard and a second SIGKILLed server.  Then the drain
    (``run_drain_leg``) of one more server.  Last, ec.decode and
    ``decoded_reads`` GETs of the decoded volume.  Each GET is classed by
    the server that answered it: (a) a shard alive on another server,
    (b) a lost shard, or local.  Every server's stop line (the second
    killed one has none) must count exactly the remote shard reads and
    reconstructions its GETs needed, the vacuum leg's EC GETs
    included."""
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT, to_ext
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json

    collection = "ec"
    seed = SEED + 4
    res: dict = {"seconds": {}}
    procs: list[subprocess.Popen] = []
    mport = free_port()
    master = f"127.0.0.1:{mport}"
    try:
        log = os.path.join(work, "master.log")
        procs.append(start_cli(
            ["master", "-port", str(mport), "-volumeSizeLimitMB",
             str((volume_bytes >> 20) + 64), "-pulseSeconds",
             str(pulse_seconds), "-coordinatorSeconds",
             str(coordinator_seconds), "-metricsAggregationSeconds",
             str(coordinator_seconds)], log))
        read_start_line(procs[0], log, "master listening")
        # the lost shards of the first kill must stay lost for the class
        # (b) GETs: the coordinator waits until the drill
        out, _ = run_shell(master, "coordinator.pause")
        if not out.startswith("coordinator: paused"):
            raise AssertionError(f"coordinator.pause: {out}")
        t0 = time.perf_counter()
        vs: dict[str, dict] = {}
        for k in range(servers):
            port = free_port()
            d = os.path.join(work, f"vs{k}")
            os.makedirs(d)
            log = os.path.join(work, f"vs{k}.log")
            p = start_cli(["volume", "-dir", d, "-port", str(port),
                           "-mserver", master, "-pulseSeconds",
                           str(pulse_seconds), "-ec.engine", engine], log)
            procs.append(p)
            vs[f"127.0.0.1:{port}"] = {"proc": p, "dir": d, "log": log}
        for info in vs.values():  # they start side by side
            line = read_start_line(info["proc"], info["log"],
                                   "volume server listening")
            if f"ec on {ENGINES[engine]}" not in line:
                raise AssertionError(f"start line {line!r}")
        wait_for("every volume server to register",
                 lambda: node_urls(master_status(master)) == set(vs), 60)
        res["seconds"]["start"] = time.perf_counter() - t0
        res["degraded_binds"] = degraded_binds(master)
        res["vacuum"] = run_vacuum_leg(master, vs, engine, vac_bytes, threads,
                                       work)

        vid = http_json("GET", f"http://{master}/vol/grow?collection="
                               f"{collection}&count=1")["volumeIds"][0]
        source = WeedClient(master).master.lookup(vid)[0]
        needles = [cluster_needle(seed, i, nid, size) for i, (nid, _, size)
                   in enumerate(needle_specs(seed, volume_bytes))]
        fids: list[str] = [""] * len(needles)

        def upload(t: int) -> None:
            client = WeedClient(master)
            for i in range(t, len(needles), threads):
                fids[i] = client.upload(needles[i]["data"],
                                        collection=collection,
                                        **needles[i]["upload"])

        t0 = time.perf_counter()
        run_threads(upload, threads, 1800)
        res["seconds"]["upload"] = time.perf_counter() - t0
        if {FileId.parse(f).volume_id for f in fids} != {vid}:
            raise AssertionError("needles landed outside the grown volume")
        res["needles"] = len(needles)
        res["upload_bytes"] = sum(len(n["data"]) for n in needles)
        res["dat_bytes"] = os.path.getsize(volume_file_prefix(
            vs[source]["dir"], collection, vid) + ".dat")

        out, res["seconds"]["ec.encode"] = run_shell(
            master, f"ec.encode -volumeId {vid} -collection {collection}")
        m = re.search(r"generate ([\d.]+) s, spread ([\d.]+) s", out)
        if f"ec encoded volume {vid} via tpu engine" not in out or not m:
            raise AssertionError(f"ec.encode: {out}")
        res["seconds"]["encode_generate"] = float(m.group(1))
        res["seconds"]["encode_spread"] = float(m.group(2))
        holders = shard_holders(master, vid)
        if sorted(holders) != list(range(TOTAL_SHARDS_COUNT)):
            raise AssertionError(f"after ec.encode: {holders}")

        def shard_path(url: str, sid: int) -> str:
            return volume_file_prefix(vs[url]["dir"], collection,
                                      vid) + to_ext(sid)

        hashes = {sid: sha256_file(shard_path(urls[0], sid))
                  for sid, urls in holders.items()}
        held = {url: sorted(s for s, us in holders.items() if url in us)
                for url in vs}
        # the most shards, not the source; ties to the lowest shard id
        victim = min((u for u in vs if u != source),
                     key=lambda u: (-len(held[u]), held[u]))
        lost = held[victim]
        kill_watch = FireWatch(master, "peer_down", {master},
                               time.perf_counter(), time.time())
        vs[victim]["proc"].kill()
        vs[victim]["proc"].wait()
        res["seconds"]["drop"] = wait_for(
            "the master to drop the killed server",
            lambda: victim not in node_urls(master_status(master)), 120)
        alive = [u for u in vs if u != victim]
        holders = shard_holders(master, vid)
        shards_of = needle_shards(
            volume_file_prefix(vs[source]["dir"], collection, vid), vid,
            [FileId.parse(f).key for f in fids])

        rng = np.random.default_rng(seed)
        picks = rng.choice(len(needles), size=min(reads, len(needles)),
                           replace=False)

        def thread_picks(t: int):
            return np.random.default_rng([seed, t]).choice(
                len(needles), size=per_thread)

        # each GET pass's wall and the CPU seconds each process spent in it
        pids = {"master": procs[0].pid,
                **{u: vs[u]["proc"].pid for u in alive}}
        passes: dict = {}

        def run_pass(name: str, gets_fn, one: bool) -> list:
            c0, t0 = process_cpu(pids), time.perf_counter()
            if one:
                done = gets_fn(master, picks, needles, fids, seed)
            else:
                done = []
                run_threads(lambda t: done.extend(gets_fn(
                    master, thread_picks(t), needles, fids, seed + t)),
                    threads, 600)
            wall = time.perf_counter() - t0
            c1 = process_cpu(pids)
            passes[name] = {"wall_s": wall, "gets": len(done), **{
                key: {k: c1[k][key] - c0[k][key] for k in pids}
                for key in ("cpu_s", "sys_s")}}
            return done

        eight = f"{threads}_clients"
        gets = {"1_client": run_pass("1_client", timed_gets, True),
                eight: run_pass(eight, timed_gets, False)}

        def classify(asked: str, i: int) -> tuple[str, list[int]]:
            """(b) a lost shard, else (a) a shard on another server, else
            local; and the remote shards it reads."""
            remote = [s for s in shards_of[i]
                      if s not in lost and asked not in holders[s]]
            if any(s in lost for s in shards_of[i]):
                return "b", remote
            return ("a" if remote else "local"), remote

        # each server's first class (b) GET of the 1-client pass (with no
        # queueing) against its later ones: what first touch costs
        first_b: dict[str, list[float]] = {}
        for asked, i, lat in gets["1_client"]:
            if classify(asked, i)[0] == "b":
                first_b.setdefault(asked, []).append(1e3 * lat)
        res["first_b_ms"] = {
            u: {"first": v[0], "rest": percentiles([x / 1e3 for x in v[1:]])
                if len(v) > 1 else None,
                "rest_max": max(v[1:], default=None)}
            for u, v in sorted(first_b.items())}

        # the same GETs again with tracing on live on the master and every
        # live server, each GET under a sampled trace context of its own;
        # each batch's traces are collected right after it, before the
        # collector's 512-trace ring could evict them
        set_tracing([master] + alive, "enable=1")
        try:
            before = kernel_launches(alive)
            t0 = time.perf_counter()
            traced = run_pass("1_client_traced", traced_gets, True)
            docs = collect_traces(master, traced)
            traced_8 = run_pass(f"{eight}_traced", traced_gets, False)
            docs.update(collect_traces(master, traced_8))
            after = kernel_launches(alive)
            res["seconds"]["traced_gets"] = time.perf_counter() - t0
        finally:
            spans = {"traced": set_tracing([master] + alive,
                                           "disable=1&clear=1")}
        res["traced_gets"] = check_traced_gets(
            traced + traced_8, docs, classify, holders,
            {u: after[u] - before[u] for u in alive
             if after[u] != before[u]} if engine == "tpu" else None)
        gets["1_client_traced"] = [g[:3] for g in traced]
        gets[f"{eight}_traced"] = [g[:3] for g in traced_8]
        # and once more untraced: a pass after the traced ones tells the
        # tracer's cost from the order of the passes
        gets[f"{eight}_after"] = run_pass(f"{eight}_after", timed_gets,
                                          False)
        # the tracer's cost apart from the host's drift, pass by pass:
        # GETs sampled at 5% at their root (heartbeats and scrapes still
        # at rate 1), all at rate 1 again, and untraced again; each
        # traced pass's spans counted from every ring
        set_tracing([master] + alive, "enable=1")
        try:
            gets[f"{eight}_sampled_5pct"] = [g[:3] for g in run_pass(
                f"{eight}_sampled_5pct",
                lambda *a: traced_gets(*a, rate=0.05), False)]
            spans["sampled_5pct"] = set_tracing([master] + alive,
                                                "clear=1")
            gets[f"{eight}_traced_again"] = [g[:3] for g in run_pass(
                f"{eight}_traced_again", traced_gets, False)]
        finally:
            spans["traced_again"] = set_tracing([master] + alive,
                                                "disable=1&clear=1")
        gets[f"{eight}_after_again"] = run_pass(f"{eight}_after_again",
                                                timed_gets, False)
        res["traced_spans"] = {k: sum(v.values()) for k, v in spans.items()}
        # the profile leg: one more pass untraced and one at rate 1, the
        # server that reconstructed most and the master sampled at once
        # through each (never inside a pass whose walls are reported above)
        # each pass PROFILE_ROUNDS times as long as the others, so the
        # sampler sees enough of it; the window twice the untraced
        # passes' wall at that length, so a slower traced pass fits too
        recon = res["traced_gets"]["reconstruct_spans"]
        hot = max(sorted(recon), key=lambda u: recon[u]) if recon \
            else alive[0]
        window = min(60.0, max(1.0, round(
            2 * PROFILE_ROUNDS * passes[f"{eight}_after_again"]["wall_s"],
            1)))
        profiles: dict = {}
        for mode, name in (("untraced", f"{eight}_profiled"),
                           ("traced", f"{eight}_traced_profiled")):
            if mode == "traced":
                set_tracing([master] + alive, "enable=1")
            gets_fn = timed_gets if mode == "untraced" else traced_gets
            try:
                with Profiling([hot, master], window, PROFILE_HZ) as prof:
                    done = run_pass(name, lambda m, p, *a: gets_fn(
                        m, np.tile(p, PROFILE_ROUNDS), *a), False)
            finally:
                if mode == "traced":
                    set_tracing([master] + alive, "disable=1&clear=1")
            gets[name] = [g[:3] for g in done]
            profiles[mode] = {"server": profile_summary(prof.texts[hot]),
                              "master": profile_summary(prof.texts[master])}
        status, dump, _ = http_bytes("GET",
                                     f"http://{hot}/debug/pprof/goroutine")
        if status != 200:
            raise AssertionError(f"{hot}/debug/pprof/goroutine: {status}")
        census = thread_census(dump.decode())
        health = cluster_health(master)["totals"]
        # no server runs admission control and nothing here sets a
        # deadline: the request plane must read clean
        if health["requests_shed"] or health["deadline_exceeded"]:
            raise AssertionError(f"/cluster/health request plane: {health}")
        # what one sample takes from the GIL in a process like the
        # server's: its threads a tick at their mean depth
        busiest = profiles["untraced"]["server"]
        sample_cost = sample_cost_us(
            max(1, round(busiest["stack_samples"]
                         / max(busiest["ticks"], 1))),
            round(busiest["mean_depth"]))
        res["profile"] = {
            "server": hot, "seconds": window, "hz": PROFILE_HZ,
            "rounds": PROFILE_ROUNDS,
            "profiles": profiles,
            "traced_minus_untraced": {
                role: {key: {k: v - profiles["untraced"][role][key][k]
                             for k, v in profiles["traced"][role][key].items()}
                       for key in ("self_share", "under_share")}
                for role in ("server", "master")},
            "thread_census": census,
            "sample_cost_us": sample_cost,
            "health": {k: health[k] for k in (
                "requests_shed", "deadline_exceeded",
                "retry_budget_exhausted")}}
        res["get_passes"] = passes
        vac_remote = res["vacuum"]["ec_remote_reads"]
        expect = {u: {"remote": vac_remote.get(u, 0), "reconstructed": 0}
                  for u in alive}
        classes: dict = {}
        for run, done in gets.items():
            for asked, i, lat in done:
                cls, _ = classify(asked, i)
                for sid in shards_of[i]:
                    if sid in lost:
                        expect[asked]["reconstructed"] += 1
                    elif asked not in holders[sid]:
                        expect[asked]["remote"] += 1
                classes.setdefault(f"{cls}_{run}", []).append(lat)
        if not classes.get(f"a_{threads}_clients") or \
                not classes.get(f"b_{threads}_clients") or \
                not classes.get("a_1_client") or not classes.get("b_1_client"):
            raise AssertionError(f"a GET class is empty: "
                                 f"{ {k: len(v) for k, v in classes.items()} }")
        res["gets_ms"] = {k: percentiles(v) for k, v in sorted(classes.items())}

        before = kernel_launches(alive)
        out, res["seconds"]["ec.rebuild"] = run_shell(
            master, f"ec.rebuild -volumeId {vid}")
        m = re.search(r"rebuilt shards \[([\d, ]*)\] on (\S+?)[;\s]", out)
        t = re.search(r"copy ([\d.]+) s, rebuild ([\d.]+) s, "
                      r"spread ([\d.]+) s", out)
        if not m or not t or \
                [int(x) for x in m.group(1).split(",")] != lost:
            raise AssertionError(f"ec.rebuild: {out}")
        rebuild_host = m.group(2)
        # a rebuild launches one kernel a dispatch, whatever its row count
        rebuild_launches = [kernel_launches([rebuild_host])[rebuild_host]
                            - before[rebuild_host]]
        for leg, g in (("copy", 1), ("rebuild", 2), ("spread", 3)):
            res["seconds"][f"rebuild_{leg}"] = float(t.group(g))
        holders = shard_holders(master, vid)
        for sid in lost:
            if not holders.get(sid) or any(
                    sha256_file(shard_path(u, sid)) != hashes[sid]
                    for u in holders[sid]):
                raise AssertionError(f"rebuilt shard {sid} differs")

        # bit rot on one server that holds fewer than 10 shards: its
        # scrubber can only quarantine, and ec.rebuild heals the set.  Not
        # the encode or rebuild host: the drill kills it later, and their
        # stop lines must count their launches
        holders = shard_holders(master, vid)
        held_now = {u: sorted(s for s, us in holders.items() if u in us)
                    for u in alive}
        rot_host = min((u for u in alive if len(held_now[u]) >= 2
                        and u not in (source, rebuild_host)),
                       key=lambda u: (-len(held_now[u]), u))
        rot_shard = held_now[rot_host][-1]
        rot_path = shard_path(rot_host, rot_shard)
        rot_watches = {name: FireWatch(master, name, {rot_host, master},
                                       time.perf_counter(), time.time())
                       for name in ("scrub_unrepairable",
                                    "corrupt_shards_increase")}
        flip_byte(rot_path, os.path.getsize(rot_path) // 2)
        out, res["seconds"]["ec.scrub"] = run_shell(
            master, "ec.scrub -all -rate 0")
        want = (f"  volume {vid}: unrepairable "
                f"corrupt_shards=[{rot_shard}]")
        if not out.startswith("cluster scrub: DEGRADED") or \
                want not in out.splitlines() or \
                not os.path.exists(rot_path + ".bad"):
            raise AssertionError(f"ec.scrub -all: {out}")
        wait_for("the master to drop the quarantined shard",
                 lambda: rot_host not in shard_holders(master, vid).get(
                     rot_shard, []), 60)
        before = kernel_launches(alive)
        out, res["seconds"]["ec.rebuild_after_scrub"] = run_shell(
            master, f"ec.rebuild -volumeId {vid}")
        m = re.search(rf"rebuilt shards \[{rot_shard}\] on (\S+?)[;\s]", out)
        if not m:
            raise AssertionError(f"ec.rebuild after the scrub: {out}")
        rebuild_launches.append(kernel_launches([m.group(1)])[m.group(1)]
                                - before[m.group(1)])
        res["rebuild_launches"] = rebuild_launches
        if engine == "tpu" and min(rebuild_launches) <= 0:
            raise AssertionError(f"a typed ec.rebuild launched no kernel: "
                                 f"{rebuild_launches}")
        holders = shard_holders(master, vid)
        if not holders.get(rot_shard) or any(
                sha256_file(shard_path(u, rot_shard)) != hashes[rot_shard]
                for u in holders[rot_shard]):
            raise AssertionError(f"healed shard {rot_shard} differs")
        out, res["seconds"]["ec.scrub_again"] = run_shell(
            master, "ec.scrub -all -rate 0")
        if not re.search(r"unrepairable=0$", out.splitlines()[0]):
            raise AssertionError(f"ec.scrub -all after the heal: {out}")
        res["scrub"] = {"host": rot_host, "shard": rot_shard,
                        "healed_on": holders[rot_shard]}

        # the first fires: peer_down at the first kill, the rot's two at
        # this host's first rot
        first_fires = {"peer_down": kill_watch.times(),
                       **{n: w.times() for n, w in rot_watches.items()}}
        res["drill"] = coordinator_drill(master, vid, rot_host, vs, alive,
                                         shard_path, hashes,
                                         min(rebuild_launches))
        res["drill"]["repair_legs"] = repair_legs(
            os.path.join(work, "master.log"))
        alive.remove(rot_host)
        res["alerts"] = {"first_fires": first_fires,
                         **res["drill"].pop("alerts"),
                         "by_hand": alerts_by_hand(master, alive),
                         "evaluation": evaluation_ms(master)}
        for k, (lo, hi) in HEAL_SPREAD.items():
            v = res["drill"][k]
            res["alerts"][k] = {"s": v, "earlier_runs": [lo, hi],
                                "moved": "within" if lo <= v <= hi else
                                ("above" if v > hi else "below")}
        res["drain"] = run_drain_leg(
            master, collection, vid, vs, alive, shard_path, hashes,
            shards_of, needles, fids, expect, seed, engine, DRAIN_READS,
            DRAIN_DELETED_READS)
        drained = res["drain"]["drained"]["url"]
        # alerts that resolved so far (peer_down resolves 60 s, its
        # keep_firing_s, after a killed server leaves the registry)
        res["alerts"]["resolved"] = [
            (e["details"]["alert"], e["details"]["active_s"])
            for e in journal(master, 0.0) if e["type"] == "alert_resolved"]

        out, res["seconds"]["ec.decode"] = run_shell(
            master, f"ec.decode -volumeId {vid}")
        if f"decoded ec volume {vid}" not in out:
            raise AssertionError(f"ec.decode: {out}")
        timed_gets(master, rng.choice(len(needles), size=min(
            decoded_reads, len(needles)), replace=False), needles, fids,
            seed)
        # the heap route starts tracemalloc, which slows every allocation
        # of its process from then on: once, after the timed legs
        status, body, _ = http_bytes("GET",
                                     f"http://{alive[0]}/debug/pprof/heap")
        if status != 200 or not body.startswith(b"tracemalloc just enabled"):
            raise AssertionError(f"/debug/pprof/heap: {status} {body[:80]!r}")
        res["profile"]["heap"] = body.decode().strip()

        def roles(url: str) -> list[str]:
            return [r for r, u in (("encode", source),
                                   ("rebuild", rebuild_host)) if u == url]

        res["servers"] = {}
        for url in alive:
            counts = stop_volume_server(vs[url]["proc"])
            if {k: counts[k] for k in expect[url]} != expect[url]:
                raise AssertionError(f"{url} counted {counts}, its GETs "
                                     f"needed {expect[url]}")
            res["servers"][url] = {"shards": held[url], "roles": roles(url),
                                   **counts}
        counts = {k: res["drain"]["drained"][k]
                  for k in ("launches", "remote", "reconstructed")}
        res["servers"][drained] = {"shards": held[drained],
                                   "roles": roles(drained) + ["drained"],
                                   **counts}
        res["servers"][victim] = {"shards": lost, "roles": ["killed"]}
        res["servers"][rot_host] = {"shards": held[rot_host],
                                    "roles": ["rotted", "killed"]}
        repair_hosts = sorted({h for h in res["drill"]["repair_hosts"]
                               if h != rot_host})
        for url in repair_hosts:
            res["servers"][url]["roles"].append("coordinator_repair")
        # each coordinator repair's launches were held in the drill
        if engine == "tpu" and not all(
                res["servers"][u]["launches"] > 0
                for u in (source, rebuild_host)):
            raise AssertionError(f"the encode or rebuild host launched no "
                                 f"kernel: {res['servers']}")
        procs[0].send_signal(signal.SIGTERM)
        if procs[0].wait(timeout=10) != 0:
            raise AssertionError("the master did not exit 0")
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()


# --- the failover phase ---------------------------------------------------

# the reference's budgets for a leader killed mid-repair
# (seaweedfs_tpu/scenarios/spec.py master_failover)
FAILOVER_BUDGETS = {"election_time_s": 8.0, "assign_after_kill_s": 5.0,
                    "journal_loss_count": 0, "repair_replan_s": 45.0}
MASTER_STOP_LINE = re.compile(r"master stopped(?:, faults injected (.*))?")


def raft_status(master: str) -> dict:
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return http_json("GET", f"http://{master}/cluster/status", timeout=5.0)


def agreed_leader(masters: list[str]) -> str | None:
    """The leader every master in ``masters`` names, when that master is
    one of them and says it leads; else None."""
    try:
        views = {m: raft_status(m) for m in masters}
    except Exception:  # noqa: BLE001 - one is not answering yet
        return None
    named = {v["Leader"] for v in views.values()}
    if len(named) != 1:
        return None
    leader = named.pop()
    return leader if leader in views and views[leader]["IsLeader"] else None


def event_ids(master: str, query: str = "") -> dict[str, dict]:
    """A master's own copy of the cluster journal (``?local=1``), by id."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    doc = http_json("GET", f"http://{master}/cluster/events?local=1"
                           f"&limit=0{query}", timeout=10.0)
    return {e["id"]: e for e in doc["events"]}


def stop_master(proc: subprocess.Popen) -> dict:
    """SIGTERM a CLI master; it must exit 0 within 60 s.  Returns the
    fault hits its stop line counts."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=60)
    lines = proc.stdout.read().strip().splitlines()
    m = MASTER_STOP_LINE.fullmatch(lines[-1]) if lines else None
    if rc != 0 or m is None:
        raise AssertionError(f"master exited {rc}: {lines!r}")
    return json.loads(m.group(1)) if m.group(1) else {}


def run_failover_phase(engine: str, work: str, volume_bytes: int,
                       threads: int, servers: int = 4,
                       pulse_seconds: float = 0.5,
                       coordinator_seconds: float = 1.0,
                       delay_s: float = 1.0) -> dict:
    """Master HA through the port's CLI, after the reference's drill
    (seaweedfs_tpu/scenarios/failover.py).  Three masters (``-peers``,
    ``-mdir`` each, ``WEED_FAULTS`` slowing every leg of a repair by
    ``delay_s``) and ``servers`` volume servers (``-ec.engine <engine>``,
    ``-mserver`` naming all three, ``-trace.sample 0`` so a scrub pass is
    a trace root).  One volume is uploaded through WeedClient and
    ec.encoded by the shell started at a follower; one shard is rotted
    and its holder's scrub quarantines it; once ``scrub_unrepairable``
    fires the coordinator is resumed, and once a follower's own
    /cluster/coordinator holds the repair's planned record (and its
    journal is snapshotted) the leader is SIGKILLed.  Measured against
    the reference's budgets: the election (both survivors name one
    leader), the first /dir/assign the new leader serves, the pre-kill
    events missing from its journal, and its repair_done for the volume,
    whose alert, cause event and cause trace must be the planned
    record's; the rebuilt shard must have its pre-rot sha256 on every
    holder, and the rebuilding server launch the kernels the dispatch
    rule gives."""
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.ec.layout import TOTAL_SHARDS_COUNT, to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.ops.gf_matmul import ROWS_PER_LAUNCH
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json

    collection = "failover"
    seed = SEED + 5
    t_phase = time.perf_counter()
    res: dict = {"seconds": {}, "injected_delay_s": delay_s}
    masters = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    mprocs: dict[str, subprocess.Popen] = {}
    vs: dict[str, dict] = {}
    try:
        t0 = time.perf_counter()
        for i, url in enumerate(masters):
            mdir = os.path.join(work, f"m{i}")
            os.makedirs(mdir)
            mprocs[url] = start_cli(
                ["master", "-port", url.rsplit(":", 1)[1], "-peers",
                 ",".join(m for m in masters if m != url), "-mdir", mdir,
                 "-volumeSizeLimitMB", str((volume_bytes >> 20) + 64),
                 "-pulseSeconds", str(pulse_seconds),
                 "-coordinatorSeconds", str(coordinator_seconds),
                 "-metricsAggregationSeconds", str(coordinator_seconds)],
                os.path.join(work, f"m{i}.log"),
                env={"WEED_FAULTS": f"coord.exec:delay={delay_s}"})
        for i, url in enumerate(masters):
            read_start_line(mprocs[url], os.path.join(work, f"m{i}.log"),
                            "master listening")
        for k in range(servers):
            port = free_port()
            d = os.path.join(work, f"vs{k}")
            os.makedirs(d)
            log_path = os.path.join(work, f"vs{k}.log")
            p = start_cli(["volume", "-dir", d, "-port", str(port),
                           "-mserver", ",".join(masters), "-pulseSeconds",
                           str(pulse_seconds), "-ec.engine", engine,
                           "-trace.sample", "0"], log_path)
            vs[f"127.0.0.1:{port}"] = {"proc": p, "dir": d, "log": log_path}
        leader = None

        def elected() -> bool:
            nonlocal leader
            leader = agreed_leader(masters)
            return leader is not None

        res["seconds"]["first_election"] = wait_for("a first leader",
                                                    elected, 60)
        follower = next(m for m in masters if m != leader)
        for info in vs.values():
            line = read_start_line(info["proc"], info["log"],
                                   "volume server listening")
            if f"ec on {ENGINES[engine]}" not in line:
                raise AssertionError(f"start line {line!r}")
        # the shell at a follower: its lease and its GETs reach the leader
        out, _ = run_shell(follower, "coordinator.pause")
        if not out.startswith("coordinator: paused"):
            raise AssertionError(f"coordinator.pause: {out}")
        wait_for("every volume server to register",
                 lambda: node_urls(master_status(follower)) == set(vs), 60)
        res["seconds"]["start"] = time.perf_counter() - t0
        res["degraded_binds"] = {
            **degraded_binds(leader),
            "masters": {m: metric_value(
                m, "SeaweedFS_server_degraded_binds_total", "master-tcp")
                for m in masters}}
        if any(res["degraded_binds"]["masters"].values()):
            raise AssertionError(f"a master's framed front came up "
                                 f"degraded: {res['degraded_binds']}")

        vid = http_json("GET", f"http://{follower}/vol/grow?collection="
                               f"{collection}&count=1")["volumeIds"][0]
        needles = [cluster_needle(seed, i, nid, size) for i, (nid, _, size)
                   in enumerate(needle_specs(seed, volume_bytes))]
        fids: list[str] = [""] * len(needles)

        def upload(t: int) -> None:
            client = WeedClient(leader)
            for i in range(t, len(needles), threads):
                fids[i] = client.upload(needles[i]["data"],
                                        collection=collection,
                                        **needles[i]["upload"])

        t0 = time.perf_counter()
        run_threads(upload, threads, 1800)
        res["seconds"]["upload"] = time.perf_counter() - t0
        if {FileId.parse(f).volume_id for f in fids} != {vid}:
            raise AssertionError("needles landed outside the grown volume")
        res["needles"] = len(needles)
        res["upload_bytes"] = sum(len(n["data"]) for n in needles)
        out, res["seconds"]["ec.encode"] = run_shell(
            follower, f"ec.encode -volumeId {vid} -collection {collection}")
        if f"ec encoded volume {vid} via tpu engine" not in out:
            raise AssertionError(f"ec.encode: {out}")
        holders = shard_holders(follower, vid)
        if sorted(holders) != list(range(TOTAL_SHARDS_COUNT)):
            raise AssertionError(f"after ec.encode: {holders}")

        def shard_path(url: str, sid: int) -> str:
            return volume_file_prefix(vs[url]["dir"], collection,
                                      vid) + to_ext(sid)

        hashes = {sid: sha256_file(shard_path(urls[0], sid))
                  for sid, urls in holders.items()}
        shard_bytes = os.path.getsize(shard_path(holders[0][0], 0))
        held = {u: sorted(s for s, us in holders.items() if u in us)
                for u in vs}
        rot_host = min(vs, key=lambda u: (-len(held[u]), u))
        rot_shard = held[rot_host][0]
        if not 0 < len(held[rot_host]) < 10:
            raise AssertionError(f"{rot_host} holds {held[rot_host]}")

        # the rot: the holder's scrub can only quarantine it
        path = shard_path(rot_host, rot_shard)
        flip_byte(path, os.path.getsize(path) // 3)
        t0 = time.perf_counter()
        http_json("POST", f"http://{rot_host}/ec/scrub/start",
                  {"rate_mb_s": 0, "interval_s": 0})
        wait_for("the rot's quarantine", lambda: not http_json(
            "GET", f"http://{rot_host}/ec/scrub/status")["running"]
            and os.path.exists(path + ".bad"), 120)
        res["seconds"]["scrub"] = time.perf_counter() - t0
        res["seconds"]["rot_to_alert"] = wait_for(
            "scrub_unrepairable to fire", lambda: "scrub_unrepairable"
            in cluster_alerts(follower, "firing"), 60)
        out, _ = run_shell(follower, "coordinator.resume")
        if not out.startswith("coordinator:"):
            raise AssertionError(f"coordinator.resume: {out}")
        t0 = time.perf_counter()
        planned: dict = {}

        def follower_holds_the_plan() -> bool:
            pending = http_json(
                "GET", f"http://{follower}/cluster/coordinator?local=1"
            )["replicated"]["pending"].get(str(vid))
            if pending and pending["op"] == "planned":
                planned.update(pending)
                return True
            return False

        res["seconds"]["resume_to_follower_plan"] = wait_for(
            "a follower to hold the planned record",
            follower_holds_the_plan, 120)
        # what the follower holds from the leader (its own process's
        # events, labelled with its own url, never reached the leader)
        pre_ids = {i for i, e in event_ids(follower).items()
                   if e.get("via") != follower}
        launches_before = kernel_launches(vs)

        # the kill
        t_kill = time.perf_counter()
        mprocs[leader].kill()
        mprocs[leader].wait()
        survivors = [m for m in masters if m != leader]
        new_leader = None

        def re_elected() -> bool:
            nonlocal new_leader
            new_leader = agreed_leader(survivors)
            return new_leader is not None

        wait_for("a new leader", re_elected, 60)
        res["election_time_s"] = time.perf_counter() - t_kill
        t_elected = time.perf_counter()
        while True:
            try:
                http_json("GET", f"http://{new_leader}/dir/assign?count=1",
                          timeout=3.0)
                break
            except (HttpError, OSError):
                if time.perf_counter() - t_elected > 60:
                    raise
                time.sleep(0.1)
        res["assign_after_kill_s"] = time.perf_counter() - t_elected
        res["assign_from_kill_s"] = time.perf_counter() - t_kill

        def missing() -> set:
            return pre_ids - set(event_ids(new_leader))

        try:
            wait_for("the pre-kill events on the new leader",
                     lambda: not missing(), 20)
        except AssertionError:
            pass  # counted below
        res["pre_kill_events"] = len(pre_ids)
        res["journal_loss_count"] = len(missing())
        done: dict = {}

        def repaired() -> bool:
            for e in event_ids(new_leader, "&type=repair_done").values():
                if (e.get("details") or {}).get("vid") == vid and \
                        e.get("server") == new_leader:
                    done.update(e)
                    return True
            return False

        wait_for("the new leader's repair_done", repaired, 120)
        res["repair_replan_s"] = time.perf_counter() - t_kill
        det = done["details"]
        keys = ("alert", "cause_event", "cause_trace")
        res["attribution"] = {
            "planned": {k: planned[k] for k in keys},
            "repair_done": {k: det.get(k, "") for k in keys},
            "equal": all(det.get(k) == planned[k] for k in keys)}
        res["repair"] = {"host": det["host"], "rebuilt": det["rebuilt"],
                         "moves": det.get("moves"),
                         "killed_leader": leader, "new_leader": new_leader}

        def healed() -> list | None:
            urls = shard_holders(new_leader, vid).get(rot_shard) or []
            try:
                if urls and all(sha256_file(shard_path(u, rot_shard))
                                == hashes[rot_shard] for u in urls):
                    return urls
            except FileNotFoundError:
                pass  # a spread's source dropped its copy: look again
            return None

        wait_for("every holder of the rebuilt shard to hold its sha256",
                 lambda: healed() is not None, 60)
        res["rebuilt_shard"] = {"shard": rot_shard, "holders": healed(),
                                "sha256_equal": True}
        host = det["host"]
        dispatches = -(-shard_bytes // StreamingEncoder(
            device="cpu").dispatch_b)
        rows = len(det["rebuilt"])
        res["launches"] = {
            "host": host,
            "launches": kernel_launches([host])[host] - launches_before[host],
            "dispatch_rule": dispatches * -(-rows // ROWS_PER_LAUNCH),
            "dispatches": dispatches, "rebuilt_rows": rows}
        out, _ = run_shell(new_leader, "cluster.raft")
        res["cluster_raft"] = out.splitlines()
        res["cluster_status"] = {m: raft_status(m) for m in survivors}

        # the stop lines: each survivor's injected delays, each server's
        # kernel launches
        res["faults_injected"] = {m: stop_master(mprocs[m])
                                  for m in survivors}
        hits = res["faults_injected"][new_leader].get("coord.exec", 0)
        res["new_leader_injected_delay_s"] = hits * delay_s
        res["repair_replan_less_delay_s"] = \
            res["repair_replan_s"] - hits * delay_s
        res["servers"] = {u: stop_volume_server(info["proc"])
                          for u, info in vs.items()}
        res["seconds"]["phase"] = time.perf_counter() - t_phase
    finally:
        for p in [*mprocs.values(), *(i["proc"] for i in vs.values())]:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    res["checks"] = {name: (res[name] <= bound) for name, bound
                     in FAILOVER_BUDGETS.items()}
    res["checks"]["attribution"] = res["attribution"]["equal"]
    if engine == "tpu":
        ln = res["launches"]
        res["checks"]["launches"] = ln["launches"] == ln["dispatch_rule"] > 0
    failed = sorted(k for k, ok in res["checks"].items() if not ok)
    if failed:
        raise AssertionError(f"failover phase missed {failed}: "
                             f"{json.dumps(res, default=str)[:4000]}")
    return res


# --- the dataplane phase ----------------------------------------------------

def run_benchmark(master: str, args: list[str], timeout: float
                  ) -> dict[str, dict]:
    """``python -m seaweedfs_tpu_torch benchmark -json`` in a subprocess;
    -> its JSON pass lines by pass name, each with the reference's own
    text line beside it."""
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "benchmark", "-master", master, "-json", *args],
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"benchmark {args}: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    passes: dict[str, dict] = {}
    text: list[str] = []
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            doc = json.loads(line)
            doc["line"] = text[-1] if text else ""
            passes[doc["pass"]] = doc
        else:
            text.append(line)
    for doc in passes.values():
        if doc["mismatches"]:
            raise AssertionError(f"benchmark {doc['pass']}: "
                                 f"{doc['mismatches']} wrong answers")
    return passes


def dataplane_counts(urls) -> dict[str, int]:
    """Summed over the servers' /status: needle-cache hits and misses,
    inline and pooled dispatches, aborted connections, kernel launches."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    out = dict.fromkeys(("hits", "misses", "fast_dispatches",
                         "pool_dispatches", "conn_aborts", "launches"), 0)
    for u in urls:
        st = http_json("GET", f"http://{u}/status")
        out["hits"] += st["NeedleCache"]["hits"]
        out["misses"] += st["NeedleCache"]["misses"]
        out["fast_dispatches"] += st["Dataplane"]["fast_dispatches"]
        out["pool_dispatches"] += st["Dataplane"]["pool_dispatches"]
        out["conn_aborts"] += st["Dataplane"]["dataplane_conn_aborts"]
        out["launches"] += st["EcKernelLaunches"]
    return out


def counts_delta(before: dict, after: dict) -> dict:
    d = {k: after[k] - before[k] for k in before}
    looked = d["hits"] + d["misses"]
    d["hit_ratio"] = d["hits"] / looked if looked else 0.0
    return d


def start_volume_servers(vs: dict, master: str, engine: str,
                         pulse_seconds: float, front: str,
                         dataplane: str = "python",
                         extra: tuple | list = ()) -> None:
    """Start a CLI volume server for each of ``vs`` (url -> dir, log) on
    its port and directory, on ``front`` (reactor, or threaded through
    WEED_DATAPLANE) with ``-dataplane`` and the flags ``extra``; each
    start line must name the engine and front, and a native plane's its
    framed port."""
    from seaweedfs_tpu_torch.utils.framing import tcp_port_for

    env = {"WEED_DATAPLANE": "threaded"} if front == "threaded" else {}
    for url, info in vs.items():
        info["proc"] = start_cli(
            ["volume", "-dir", info["dir"], "-port", url.split(":")[1],
             "-mserver", master, "-pulseSeconds", str(pulse_seconds),
             "-ec.engine", engine, "-dataplane", dataplane, *extra],
            info["log"], env)
    for url, info in vs.items():
        line = read_start_line(info["proc"], info["log"],
                               "volume server listening")
        plane = f", native plane on {tcp_port_for(int(url.split(':')[1]))}"
        if f"ec on {ENGINES[engine]}" not in line or \
                not line.endswith(f"front {front}") or \
                (plane in line) != (dataplane == "native"):
            raise AssertionError(f"start line {line!r}")
    wait_for("every volume server to register",
             lambda: set(vs) <= node_urls(master_status(master)), 60)


def http_assigns(master: str) -> float:
    """The master's HTTP /dir/assign requests so far (its /metrics)."""
    return metric_value(master, "SeaweedFS_master_request_total", "assign")


def framed_assign(master: str, collection: str) -> dict:
    """One ``A`` frame to the master's framed-TCP front: its assignment
    (an error frame raises)."""
    from seaweedfs_tpu_torch.utils.framing import FramedClient, tcp_address

    a = json.loads(FramedClient().request(
        tcp_address(master), b"A", "",
        json.dumps({"collection": collection}).encode()))
    if not a.get("fid") or not a.get("url"):
        raise AssertionError(f"framed assign: {a}")
    return a


def degraded_binds(master: str) -> dict[str, float]:
    """Framed planes that failed to bind: the volume servers' summed by
    the master's /cluster/health, the master's own from its /metrics.
    Every port pick of this script keeps both at 0."""
    out = {"volume_servers": cluster_health(master)["totals"][
               "degraded_binds"],
           "master": metric_value(master,
                                  "SeaweedFS_server_degraded_binds_total",
                                  "master-tcp")}
    if any(out.values()):
        raise AssertionError(f"a framed plane came up degraded: {out}")
    return out


def cpu_split(pids: dict, run):
    """``run()``'s result and the CPU seconds it took: the client (this
    process's children that ended meanwhile) and the servers ``pids``."""
    before, client = process_cpu(pids), children_cpu_s()
    out = run()
    client = children_cpu_s() - client
    after = process_cpu(pids)
    servers = sum(after[u]["cpu_s"] - before[u]["cpu_s"] for u in pids)
    return out, {"client": client, "servers": servers,
                 "client_share": client / (client + servers)
                 if client + servers else 0.0,
                 "per_server": {u: after[u]["cpu_s"] - before[u]["cpu_s"]
                                for u in pids}}


def tcp_passes(master: str, n: int, size: int, clients: int, zipf: int,
               collection: str, seed: int, fids_path: str,
               pids: dict) -> dict:
    """``benchmark -useTcp``: ``n`` writes, every fid read back shuffled,
    ``zipf`` reads drawn Zipf, each answer held to its needle's bytes, the
    client's and the servers' (``pids``) CPU seconds per call.  A direct
    ``A`` frame first shows the master's framed front answering; the
    write pass must then leave the master's HTTP /dir/assign count where
    it was (every assign went over the framed front)."""
    res = {"framed_assign": framed_assign(master, collection), "cpu_s": {}}
    before = http_assigns(master)
    w, res["cpu_s"]["write"] = cpu_split(pids, lambda: run_benchmark(
        master, [
            "-useTcp", "-n", str(n), "-size", str(size), "-c", str(clients),
            "-collection", collection, "-phase", "write", "-seed",
            str(seed), "-fidsFile", fids_path], 1800))
    res["write"] = w["write"]
    res["http_assigns_during_write"] = http_assigns(master) - before
    if res["http_assigns_during_write"]:
        raise AssertionError(f"{res['http_assigns_during_write']} assigns "
                             f"fell back to HTTP")
    r, res["cpu_s"]["read"] = cpu_split(pids, lambda: run_benchmark(
        master, [
            "-useTcp", "-size", str(size), "-c", str(clients), "-phase",
            "read", "-fidsFile", fids_path, "-zipf", str(zipf)], 1800))
    if r["read"]["n"] != n or r["zipf"]["n"] != zipf:
        raise AssertionError(f"framed reads: {r}")
    res["read"], res["zipf"] = r["read"], r["zipf"]
    res["mismatches"] = sum(res[k]["mismatches"]
                            for k in ("write", "read", "zipf"))
    res["degraded_binds"] = degraded_binds(master)
    return res


def _parse_batch_answer(payload: bytes) -> list:
    """A /batch/read body -> each fid's bytes, or None where it failed."""
    from seaweedfs_tpu_torch.utils.framing import U32

    out, i = [], 0
    while i < len(payload):
        n = U32.unpack_from(payload, i + 1)[0]
        out.append(payload[i + 5:i + 5 + n] if payload[i] == 0 else None)
        i += 5 + n
    return out


def batch_leg(master: str, fids: list[tuple], size: int, needles: int,
              batch: int, collection: str, seed: int) -> dict:
    """The batched planes on ``needles`` of a pass's fids, ``batch`` a
    request, each batch one volume's: framed ``B`` (TcpVolumeClient
    .batch_read) and ``POST /batch/read``, every answer the needle's own
    bytes; then as many fresh fids written with framed ``P``
    (``batch_write``) and read back both ways, equal; then one torn
    ``/batch/write`` body, which must answer 400 with nothing written."""
    from seaweedfs_tpu_torch.__main__ import bench_payload, expected_payload
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.volume_server.tcp import (TcpVolumeClient,
                                                       pack_fid_frames,
                                                       tcp_address)

    tcp = TcpVolumeClient()
    res: dict = {"needles": needles, "batch": batch}
    by_vid: dict[int, list[tuple]] = {}
    for fid, pid in fids[:needles]:
        by_vid.setdefault(FileId.parse(fid).volume_id, []).append((fid, pid))
    holder = {vid: http_json("GET", f"http://{master}/dir/lookup?volumeId="
                                    f"{vid}")["locations"][0]["url"]
              for vid in by_vid}
    batches = [(holder[vid], group[i:i + batch])
               for vid, group in sorted(by_vid.items())
               for i in range(0, len(group), batch)]

    def read_both(url: str, group: list[tuple[str, bytes]], leg: str
                  ) -> None:
        fids_only = [f for f, _ in group]
        t0 = time.perf_counter()
        got = tcp.batch_read(tcp_address(url), fids_only)
        t1 = time.perf_counter()
        status, body, _ = http_bytes(
            "POST", f"http://{url}/batch/read",
            json.dumps({"fids": fids_only}).encode())
        t2 = time.perf_counter()
        want = [d for _, d in group]
        if status != 200 or got != want or _parse_batch_answer(body) != want:
            raise AssertionError(f"{leg} batch of {len(group)} at {url}: "
                                 f"status {status}, answers differ")
        walls[f"{leg}_tcp"] += t1 - t0
        walls[f"{leg}_http"] += t2 - t1

    walls = dict.fromkeys(("read_tcp", "read_http", "written_tcp",
                           "written_http", "write_tcp"), 0.0)
    for url, group in batches:
        read_both(url, [(f, expected_payload(pid, size)) for f, pid in group],
                  "read")
    written = 0
    for b in range(-(-needles // batch)):
        a = http_json("GET", f"http://{master}/dir/assign?count={batch}"
                             f"&collection={collection}")
        base = FileId.parse(a["fid"])
        items = [(str(FileId(base.volume_id, base.key + i, base.cookie)),
                  bench_payload((seed << 32) | (b * batch + i), size))
                 for i in range(batch)]
        t0 = time.perf_counter()
        ok = tcp.batch_write(tcp_address(a["url"]), items)
        walls["write_tcp"] += time.perf_counter() - t0
        if ok != [True] * batch:
            raise AssertionError(f"batch_write at {a['url']}: {ok}")
        read_both(a["url"], items, "written")
        written += batch
    a = http_json("GET", f"http://{master}/dir/assign?count={batch}"
                         f"&collection={collection}")
    base = FileId.parse(a["fid"])
    items = [(str(FileId(base.volume_id, base.key + i, base.cookie)),
              bench_payload(((seed + 1) << 32) | i, size))
             for i in range(batch)]
    status, body, _ = http_bytes("POST", f"http://{a['url']}/batch/write",
                                 pack_fid_frames(items, True)[:-1])
    after = tcp.batch_read(tcp_address(a["url"]), [f for f, _ in items])
    if status != 400 or any(x is not None for x in after):
        raise AssertionError(f"torn /batch/write: {status} {body[:200]!r}, "
                             f"{sum(x is not None for x in after)} written")
    res.update(batches_read=len(batches), written=written,
               torn_write={"status": status, "written": 0,
                           "answer": body.decode(errors="replace")[:200]},
               seconds=walls, bytes_equal=True,
               needles_per_s={k: (needles if k.startswith("read")
                                  else written) / v
                              for k, v in walls.items() if v})
    return res


def bench_gets(master: str, fids: list[tuple[str, int]], picks, size: int,
               seed: int) -> list[tuple[str, int, float]]:
    """GET each picked (fid, payload id) through one WeedClient; every body
    must be the bytes benchmark wrote for that needle; -> [(server that
    answered, index, seconds)]."""
    from seaweedfs_tpu_torch.__main__ import bench_payload
    from seaweedfs_tpu_torch.client.operation import WeedClient

    client = WeedClient(master)
    client.rng.seed(seed)
    out = []
    for i in picks:
        fid, pid = fids[i]
        t0 = time.perf_counter()
        body = client.download(fid)
        lat = time.perf_counter() - t0
        if body != bench_payload(pid, size):
            raise AssertionError(f"GET {fid}: {len(body)} bytes, not the "
                                 f"needle written as payload {pid}")
        out.append((client.last_read_from, int(i), lat))
    return out


def run_dataplane_phase(engine: str, work: str, n: int, size: int,
                        clients: int, zipf: int, degraded: int,
                        threaded_writes: int, volumes: int = 7,
                        servers: int = 5, pulse_seconds: float = 0.5,
                        batch_needles: int = 1000, batch: int = 100
                        ) -> dict:
    """The serving front under upstream ``weed benchmark``'s load, on each
    front in turn.  A CLI master and ``servers`` CLI volume servers,
    ``volumes`` volumes of collection "benchmark" grown up front (the
    master grows one at a time; upstream's grows 7 for replication 000).
    On the reactor: ``benchmark -n n -size size -c clients`` writes, every
    fid read back shuffled, then ``zipf`` reads drawn Zipf (theta 0.99).
    The servers restart on the same directories with
    WEED_DATAPLANE=threaded: ``threaded_writes`` more writes, the same read
    and Zipf passes.  On the reactor and on the threaded
    front, ``benchmark -useTcp`` (``tcp_passes``) writes ``n`` more needles
    over the framed planes, its assigns over the master's framed front,
    and reads them back shuffled and Zipf; after the reactor's, the batch
    leg (``batch_leg``: ``batch_needles`` of them, ``batch`` a request).
    No framed plane may come up degraded (``degraded_binds``, read after
    every start).  Then ``ec.encode -collection benchmark`` of
    every volume; the server holding the most data shards of the largest
    volume stops (two data shards or more gone), and ``degraded`` GETs of
    that volume's fids run from one client, then from ``clients`` at once,
    classed (a) remote shard read, (b) reconstruction on the card, or
    local, on the reactor.  Each server process's first class (b) GET (its
    first reconstruction) is reported apart.  Every answer must be the
    bytes written for its needle (each needle's differ); each degraded
    pass's kernel launches must equal its GETs' lost intervals (one
    launch each)."""
    from seaweedfs_tpu_torch.__main__ import read_fids_file
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_json

    collection = "benchmark"
    res: dict = {"seconds": {}, "fronts": {"reactor": {}, "threaded": {}},
                 "tcp": {}, "degraded_binds": {}}
    mport = free_port()
    master = f"127.0.0.1:{mport}"
    mlog = os.path.join(work, "master.log")
    mproc = start_cli(["master", "-port", str(mport), "-pulseSeconds",
                       str(pulse_seconds)], mlog)
    vs: dict[str, dict] = {}
    try:
        read_start_line(mproc, mlog, "master listening")
        for k in range(servers):
            d = os.path.join(work, f"vs{k}")
            os.makedirs(d)
            vs[f"127.0.0.1:{free_port()}"] = {
                "dir": d, "log": os.path.join(work, f"vs{k}.log")}
        urls = list(vs)
        launches_stopped = 0

        def stop_all(which) -> None:
            nonlocal launches_stopped
            for u in which:
                launches_stopped += stop_volume_server(
                    vs[u]["proc"])["launches"]
                vs[u]["proc"].stdout.close()

        fids_file = os.path.join(work, "fids")
        for step, front in enumerate(("reactor", "threaded")):
            if step:
                stop_all(urls)
            t0 = time.perf_counter()
            start_volume_servers(vs, master, engine, pulse_seconds, front)
            res["seconds"][f"start_{step}_{front}"] = \
                time.perf_counter() - t0
            res["degraded_binds"][f"start_{step}_{front}"] = \
                degraded_binds(master)
            fr = res["fronts"][front]
            if step == 0:
                res["volumes"] = http_json(
                    "GET", f"http://{master}/vol/grow?collection="
                           f"{collection}&count={volumes}")["volumeIds"]
                fr["write"] = run_benchmark(master, [
                    "-n", str(n), "-size", str(size), "-c", str(clients),
                    "-collection", collection, "-phase", "write",
                    "-seed", str(SEED), "-fidsFile", fids_file],
                    1800)["write"]
            elif step == 1:
                fr["write"] = run_benchmark(master, [
                    "-n", str(threaded_writes), "-size", str(size),
                    "-c", str(clients), "-collection", collection,
                    "-phase", "write", "-seed", str(SEED + 1),
                    "-fidsFile", fids_file + ".t"], 1800)["write"]
            before = dataplane_counts(urls)
            r = run_benchmark(master, [
                "-size", str(size), "-c", str(clients), "-phase", "read",
                "-fidsFile", fids_file, "-zipf", str(zipf)], 1800)
            after = dataplane_counts(urls)
            if r["read"]["n"] != n or r["zipf"]["n"] != zipf:
                raise AssertionError(f"{front} reads: {r}")
            fr["read"], fr["zipf"] = r["read"], r["zipf"]
            fr["read_zipf_counts"] = counts_delta(before, after)
            t0 = time.perf_counter()
            res["tcp"][front] = tcp_passes(
                master, n, size, clients, zipf, collection,
                SEED + 10 + step, f"{fids_file}.tcp_{front}",
                {u: vs[u]["proc"].pid for u in urls})
            res["seconds"][f"tcp_{front}"] = time.perf_counter() - t0
            if step == 0:
                t0 = time.perf_counter()
                res["batch"] = batch_leg(
                    master, read_fids_file(f"{fids_file}.tcp_{front}"),
                    size, batch_needles, batch, collection, SEED + 20)
                res["seconds"]["batch"] = time.perf_counter() - t0
        # (fid, payload id): the write runs' seeds differ, so every
        # needle's bytes do
        fids = [f for suffix in ("", ".t", ".tcp_reactor", ".tcp_threaded")
                for f in read_fids_file(fids_file + suffix)]
        by_vid: dict[int, list[tuple[str, int]]] = {}
        for fid, pid in fids:
            by_vid.setdefault(FileId.parse(fid).volume_id, []).append(
                (fid, pid))
        res["needles_by_volume"] = {v: len(f) for v, f in by_vid.items()}

        out, res["seconds"]["ec.encode"] = run_shell(
            master, f"ec.encode -collection {collection} -fullPercent 0 "
                    f"-quietFor 0")
        encoded = sorted(int(v) for v in re.findall(
            r"ec encoded volume (\d+) via tpu engine", out))
        if encoded != sorted(by_vid):
            raise AssertionError(f"ec.encode: {out}")
        vid = max(by_vid, key=lambda v: (len(by_vid[v]), -v))
        vfids = by_vid[vid]
        holders = shard_holders(master, vid)
        data_held = {u: [s for s in range(10) if u in holders.get(s, [])]
                     for u in urls}
        held = {u: [s for s, us in holders.items() if u in us] for u in urls}
        victim = max(urls, key=lambda u: (len(data_held[u]),
                                          -len(held[u]), u))
        lost = held[victim]
        if len(data_held[victim]) < 2 or len(lost) > 4:
            raise AssertionError(f"no server to take down: {held}")
        stop_all([victim])
        alive = [u for u in urls if u != victim]
        res["seconds"]["drop"] = wait_for(
            "the master to drop the stopped server",
            lambda: victim not in node_urls(master_status(master)), 120)
        holder = next(u for u in alive if held[u])
        shards_of = needle_shards(
            volume_file_prefix(vs[holder]["dir"], collection, vid), vid,
            [FileId.parse(f).key for f, _ in vfids])
        rng = np.random.default_rng(SEED + 7)
        picks = rng.choice(len(vfids), size=min(degraded, len(vfids)),
                           replace=False)
        per = max(1, len(picks) // clients)

        def lost_intervals(done) -> int:
            return sum(sum(1 for s in shards_of[i] if s in lost)
                       for _, i, _ in done)

        def classify(asked: str, i: int) -> str:
            if any(s in lost for s in shards_of[i]):
                return "b"
            return "a" if any(asked not in holders[s]
                              for s in shards_of[i]) else "local"

        def degraded_passes(front: str) -> None:
            fr = res["fronts"][front]
            first_b: dict[str, float] = {}
            for name, many in (("1_client", False),
                               (f"{clients}_clients", True)):
                widths0 = kernel_widths(alive)
                before = kernel_launches(alive)
                t0 = time.perf_counter()
                if many:
                    done: list = []
                    run_threads(lambda t: done.extend(bench_gets(
                        master, vfids, picks[t * per:(t + 1) * per],
                        size, SEED + t)), clients, 900)
                else:
                    done = bench_gets(master, vfids, picks, size, SEED)
                wall = time.perf_counter() - t0
                after = kernel_launches(alive)
                widths = kernel_widths(alive)
                got = sum(after[u] - before[u] for u in alive)
                rule = lost_intervals(done)
                if engine == "tpu" and got != rule:
                    raise AssertionError(
                        f"{front} {name}: {got} launches, the rule "
                        f"gives {rule}")
                by_class: dict[str, list[float]] = {}
                for asked, i, lat in done:
                    c = classify(asked, i)
                    if c == "b" and asked not in first_b:
                        # the process's first reconstruction
                        first_b[asked] = 1e3 * lat
                        continue
                    by_class.setdefault(c, []).append(lat)
                fr[f"degraded_{name}"] = {
                    "gets": len(done), "wall_s": wall,
                    "ops_per_s": len(done) / wall,
                    "ms": {c: percentiles(v) for c, v in
                           sorted(by_class.items())},
                    "launches": got, "launches_rule": rule,
                    "launch_widths": {c: n - widths0[c]
                                      for c, n in widths.items()},
                    "bytes_equal": True}
            fr["first_b_ms"] = first_b

        degraded_passes("reactor")
        stop_all(alive)
        res.update(vid=vid, victim=victim, lost_shards=lost,
                   lost_data_shards=data_held[victim],
                   volume_fids=len(vfids), launches=launches_stopped,
                   encode_out=out.splitlines()[-1])
        return res
    finally:
        for info in vs.values():
            p = info.get("proc")
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        mproc.send_signal(signal.SIGTERM)
        try:
            mproc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            mproc.kill()
            mproc.wait()
        mproc.stdout.close()


# needles a payload block holds: payloads are drawn a block at a time
PAYLOAD_GROUP = 4096


@functools.lru_cache(maxsize=8)
def _payload_block(seed: int, group: int, size: int) -> bytes:
    return np.random.default_rng([seed, group]).bytes(PAYLOAD_GROUP * size)


def store_payload(seed: int, nid: int, size: int) -> bytes:
    """Needle ``nid``'s bytes: its own slice of the block drawn from
    [seed, nid // PAYLOAD_GROUP], so a million payloads are drawn in bulk
    and any one is drawn again in a block's time."""
    group, i = divmod(nid, PAYLOAD_GROUP)
    return _payload_block(seed, group, size)[i * size:(i + 1) * size]


def store_cookie(seed: int, nid: int) -> int:
    return ((nid * 0x9E3779B1) ^ seed) & 0xFFFFFFFF or 1


def bulk_fill(prefix: str, first: int, last: int, size: int, seed: int,
              base_ns: int) -> None:
    """Append needles ``first``..``last`` - 1 of ``size`` bytes (payload
    ``store_payload``, cookie ``store_cookie``, no flags, append time
    ``base_ns`` + id) to the closed volume at ``prefix``: the records and
    index entries ``Volume.write_needle`` writes for the same needles and
    append times, encoded a payload block at a time in numpy."""
    from seaweedfs_tpu_torch.storage.crc import crc32c, masked_value
    from seaweedfs_tpu_torch.storage.idx import IDX_DTYPE
    from seaweedfs_tpu_torch.storage.needle import padding_length
    from seaweedfs_tpu_torch.storage.types import (NEEDLE_PADDING_SIZE,
                                                   Version)

    body = 4 + size + 1  # data size, data, flags
    pad = padding_length(body, Version.V3)
    rec = np.dtype([("cookie", ">u4"), ("id", ">u8"), ("size", ">u4"),
                    ("data_size", ">u4"), ("data", "u1", size),
                    ("flags", "u1"), ("crc", ">u4"), ("ns", ">u8"),
                    ("pad", "u1", pad)])
    # the padding repeats the header's size bytes, then zeros
    pad_bytes = np.frombuffer((body.to_bytes(4, "big") + bytes(8))[:pad],
                              np.uint8)
    with open(prefix + ".dat", "ab") as dat, open(prefix + ".idx",
                                                  "ab") as idx:
        offset = dat.tell()
        nid = first
        while nid < last:
            group, i = divmod(nid, PAYLOAD_GROUP)
            count = min(PAYLOAD_GROUP - i, last - nid)
            block = _payload_block(seed, group, size)
            ids = np.arange(nid, nid + count, dtype=np.uint64)
            r = np.zeros(count, dtype=rec)
            r["cookie"] = [store_cookie(seed, x) for x in range(nid,
                                                                nid + count)]
            r["id"] = ids
            r["size"] = body
            r["data_size"] = size
            r["data"] = np.frombuffer(block, np.uint8)[
                i * size:(i + count) * size].reshape(count, size)
            r["crc"] = [masked_value(crc32c(block[j * size:(j + 1) * size]))
                        for j in range(i, i + count)]
            r["ns"] = base_ns + ids
            r["pad"] = pad_bytes
            e = np.zeros(count, dtype=IDX_DTYPE)
            e["key"] = ids
            e["offset"] = (offset + np.arange(count, dtype=np.int64)
                           * rec.itemsize) // NEEDLE_PADDING_SIZE
            e["size"] = body
            dat.write(r.tobytes())
            idx.write(e.tobytes())
            offset += count * rec.itemsize
            nid += count


# run in a fresh interpreter: one open of a volume with a needle-map kind,
# and the resident bytes it added (statm's resident pages), the heap the
# imports freed handed back first so that the open's count alone
OPEN_PROBE = r"""
import gc, json, os, sys, time
from seaweedfs_tpu_torch.storage.needle_map_compact import _return_freed_heap
from seaweedfs_tpu_torch.storage.volume import Volume

def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

d, vid, kind = sys.argv[1], int(sys.argv[2]), sys.argv[3]
gc.collect()
_return_freed_heap()
before = rss()
t0 = time.perf_counter()
v = Volume(d, "", vid, needle_map_kind=kind)
open_s = time.perf_counter() - t0
gc.collect()
after = rss()
nm = v.nm
live = len(nm)
print(json.dumps({"kind": kind, "open_s": open_s, "rss_before": before,
                  "rss_after": after, "live": live, "counters": [
                      nm.file_counter, nm.file_byte_counter,
                      nm.deletion_counter, nm.deletion_byte_counter,
                      nm.max_file_key]}))
v.close()
"""


def open_probe(directory: str, vid: int, kind: str) -> dict:
    r = subprocess.run([sys.executable, "-c", OPEN_PROBE, directory,
                        str(vid), kind], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"open probe {kind}: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_cli(args: list[str], timeout: float = 900) -> tuple[str, float]:
    """``python -m seaweedfs_tpu_torch <args>`` to its end; -> (standard
    output, wall s)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{args[0]}: exit {r.returncode}\n"
                             f"{r.stderr[-2000:]}")
    return r.stdout, time.perf_counter() - t0


def live_map(idx_path: str):
    """(keys, offset units, sizes) of the live needles an `.idx` loads to
    (the compact map's vectorized replay), and its counters."""
    from seaweedfs_tpu_torch.storage.idx import parse_entries
    from seaweedfs_tpu_torch.storage.needle_map_compact import _replay_arrays

    with open(idx_path, "rb") as f:
        counters, k, o, s = _replay_arrays(parse_entries(f.read()))
    return k, o, s, counters


def seed_follower(base: str, follower: str, needles: int) -> int:
    """A follower volume that already holds the first ``needles`` index
    entries of ``base`` and the `.dat` up to the record the next one
    names, copied as files; returns the `.dat` bytes copied."""
    from seaweedfs_tpu_torch.storage.idx import parse_entries
    from seaweedfs_tpu_torch.storage.types import (NEEDLE_MAP_ENTRY_SIZE,
                                                   NEEDLE_PADDING_SIZE)

    if not needles:
        return 0
    os.makedirs(follower)
    with open(base + ".idx", "rb") as f:
        idx = f.read((needles + 1) * NEEDLE_MAP_ENTRY_SIZE)
    end = int(parse_entries(idx)["offset"][needles]) * NEEDLE_PADDING_SIZE
    name = os.path.basename(base)
    with open(os.path.join(follower, name + ".idx"), "wb") as f:
        f.write(idx[:needles * NEEDLE_MAP_ENTRY_SIZE])
    with open(base + ".dat", "rb") as src, \
            open(os.path.join(follower, name + ".dat"), "wb") as dst:
        left = end
        while left:
            chunk = src.read(min(left, 64 << 20))
            dst.write(chunk)
            left -= len(chunk)
    return end


def plain_sorted_index(idx_path: str) -> bytes:
    """What WriteSortedFileFromIdx must write for an `.idx`, in numpy: the
    last entry of each key, kept unless it is a tombstone or never
    written, ascending by key."""
    from seaweedfs_tpu_torch.storage.idx import IDX_DTYPE

    e = np.fromfile(idx_path, dtype=IDX_DTYPE)
    keys = e["key"].astype(np.uint64)
    order = np.argsort(keys, kind="stable")
    e, keys = e[order], keys[order]
    last = np.ones(len(e), dtype=bool)
    last[:-1] = keys[:-1] != keys[1:]
    e = e[last]
    return e[(e["offset"] != 0) & (e["size"] != -1)].tobytes()


def run_volume_store_phase(device: str, work: str, n: int, size: int,
                           batch_deletes: int, missing: int,
                           gc_threads: int, gc_per_thread: int, more: int,
                           more_deletes: int, degraded: int,
                           follower_seed: int = 0,
                           seed: int = SEED + 17) -> dict:
    """The volume store's remainders on one volume of ``n`` needles of
    ``size`` bytes.  A CLI master and an in-process VolumeServer on
    ``device``, pointed at it.  Fill: volume 1 written here, its first
    sixteenth through ``Volume.write_needle`` and the rest by
    ``bulk_fill`` (for the phase's budget), then opened in a fresh interpreter with
    the compact and with the memory needle map (open seconds, resident
    bytes per needle, live count and counters equal).  Batch delete:
    volume 1 mounted, ``batch_deletes`` seeded fids and ``missing`` that
    do not exist to /admin/batch_delete, every answer the reference's
    rule, the deleted fids' GETs 404, the deletion counter up by
    ``batch_deletes``; /stats/*.  Group commit: volume 2, ``gc_threads`` x
    ``gc_per_thread`` PUTs of ``size`` bytes with ?fsync=true, then as
    many without, ops/s, p50/p99 and the worker's counts (fsyncs fewer
    than writes), every needle read back.  The CLI: ``backup`` of volume
    1 into a follower (which starts from a file copy of the first
    ``follower_seed`` needles' records, ``seed_follower``), ``more``
    needles written and ``more_deletes`` deleted, ``backup`` again (only
    those records applied, the follower's `.dat` the source's byte for
    byte); ``fix`` of the follower (its `.idx` loads to the source's live
    map) and at once ``export`` (one line a live needle); ``upload`` and
    ``download`` of a seeded file.  The seal:
    /admin/ec/generate of volume 1 (the encoder's dispatch rule's
    launches; the `.ecx` the plain sorted index), the parity against the
    host table and the kernel against the plain version on the shards'
    bytes, data shards 2 and 7 deleted and ``degraded`` GETs, each the
    needle's bytes, one launch a lost interval, a batch-deleted needle
    404.  Returns the phase's numbers; ``launches`` counts the main
    path's launches only (the encode and the degraded GETs)."""
    import torch

    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.ec.gf256 import build_encoding_matrix
    from seaweedfs_tpu_torch.ops.gf_matmul import (ROWS_PER_LAUNCH, gf_matmul,
                                                   gf_matmul_plain)
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    from seaweedfs_tpu_torch.utils.httpd import http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def fid(vid: int, nid: int) -> str:
        return str(FileId(vid, nid, store_cookie(seed, nid)))

    res: dict = {"seconds": {}, "launches": 0}
    t_phase = time.perf_counter()
    mport = free_port()
    master = f"127.0.0.1:{mport}"
    mlog = os.path.join(work, "master.log")
    mproc = start_cli(["master", "-port", str(mport), "-pulseSeconds",
                       "0.5"], mlog)
    vs_dir = os.path.join(work, "vs")
    os.makedirs(vs_dir)
    vs = None
    conn = None
    try:
        read_start_line(mproc, mlog, "master listening")
        vs = VolumeServer([vs_dir], master, port=free_port(), device=device,
                          pulse_seconds=0.5).start()
        conn = Conn(vs.url)

        # 1. fill: the first needles through Volume.write_needle, the rest
        # as the same records encoded in bulk; then one open per
        # needle-map kind in a fresh process
        v = Volume(vs_dir, "", 1)
        direct = n // 16
        t0 = time.perf_counter()
        for nid in range(1, direct + 1):
            v.write_needle(Needle(cookie=store_cookie(seed, nid), id=nid,
                                  data=store_payload(seed, nid, size)))
        res["seconds"]["fill_write_needle"] = time.perf_counter() - t0
        res["fill_write_needle_per_s"] = direct / max(
            res["seconds"]["fill_write_needle"], 1e-9)
        v.close()
        t0 = time.perf_counter()
        bulk_fill(os.path.join(vs_dir, "1"), direct + 1, n + 1, size, seed,
                  time.time_ns())
        res["seconds"]["fill_bulk"] = time.perf_counter() - t0
        res["dat_bytes"] = os.path.getsize(os.path.join(vs_dir, "1.dat"))
        res["idx_bytes"] = os.path.getsize(os.path.join(vs_dir, "1.idx"))
        # one fresh interpreter a kind, both at once
        kinds = ("compact", "memory")
        opens: dict = {}
        run_threads(lambda t: opens.__setitem__(
            kinds[t], open_probe(vs_dir, 1, kinds[t])), 2, 900)
        for kind, doc in opens.items():
            doc["rss_bytes_per_needle"] = \
                (doc["rss_after"] - doc["rss_before"]) / n
            if doc["live"] != n:
                raise AssertionError(f"{kind}: {doc['live']} live of {n}")
        if opens["compact"]["counters"] != opens["memory"]["counters"]:
            raise AssertionError(f"counters differ: {opens}")
        res["open"] = opens

        # 2. batch delete on the mounted volume
        conn.admin("/admin/mount", {"volume_id": 1})

        def volume_info(vid: int) -> dict:
            return next(x for x in http_json(
                "GET", f"http://{vs.url}/status")["Volumes"]
                if x["id"] == vid)

        before = volume_info(1)
        rng = np.random.default_rng(seed)
        gone = sorted(int(x) + 1 for x in rng.choice(
            n, size=batch_deletes, replace=False))
        fids = [fid(1, nid) for nid in gone]
        absent = [fid(1, n + 1 + k) for k in range(missing // 2)] + \
            [fid(9999, k + 1) for k in range(missing - missing // 2)]
        t0 = time.perf_counter()
        answer = conn.admin("/admin/batch_delete", {"fids": fids + absent})
        res["seconds"]["batch_delete"] = time.perf_counter() - t0
        body_size = 4 + size + 1  # data size, data, flags
        want = [{"fid": f, "status": 202, "size": body_size} for f in fids]
        want += [{"fid": f, "status": 202, "size": 0}
                 for f in absent[:missing // 2]]
        want += [{"fid": f, "status": 404, "error": "9999"}
                 for f in absent[missing // 2:]]
        if answer["results"] != want:
            bad = [(a, b) for a, b in zip(answer["results"], want) if a != b]
            raise AssertionError(f"batch_delete answers: {bad[:3]}")
        for f in fids:
            status, _, _ = conn.call("GET", f"/{f}")
            if status != 404:
                raise AssertionError(f"GET {f} after its delete: {status}")
        after = volume_info(1)
        res["batch_delete"] = {
            "deleted": len(fids), "absent": len(absent),
            "delete_count": [before["delete_count"], after["delete_count"]],
            "deleted_byte_count": [before["deleted_byte_count"],
                                   after["deleted_byte_count"]],
            "gets_404": len(fids)}
        if after["delete_count"] - before["delete_count"] != batch_deletes:
            raise AssertionError(f"delete_count {before} -> {after}")
        res["stats"] = {path: http_json("GET", f"http://{vs.url}{path}")
                        for path in ("/stats/counter", "/stats/memory",
                                     "/stats/disk")}

        # 3. group commit on a second volume, fsync pass then plain pass
        conn.admin("/admin/assign_volume", {"volume_id": 2})
        res["group_commit"] = {}
        for name, query, base_id in (("fsync", "?fsync=true", 1),
                                     ("plain", "", 1 + gc_threads
                                      * gc_per_thread)):
            lat: list[float] = []
            lock = threading.Lock()

            def writer(t: int) -> None:
                c = Conn(vs.url)
                mine = []
                try:
                    for i in range(gc_per_thread):
                        nid = base_id + t * gc_per_thread + i
                        t1 = time.perf_counter()
                        status, body, _ = c.call(
                            "PUT", f"/{fid(2, nid)}{query}",
                            store_payload(seed + 2, nid, size))
                        mine.append(time.perf_counter() - t1)
                        if status != 201:
                            raise AssertionError(f"PUT {status} {body!r}")
                finally:
                    c.close()
                with lock:
                    lat.extend(mine)

            t0 = time.perf_counter()
            run_threads(writer, gc_threads, 600)
            wall = time.perf_counter() - t0
            res["group_commit"][name] = {
                "writes": len(lat), "wall_s": wall,
                "ops_per_s": len(lat) / wall, "ms": percentiles(lat)}
            if name == "fsync":
                w = vs.store.get_volume(2)._group_commit
                counts = {"request_count": w.request_count,
                          "batch_count": w.batch_count,
                          "fsync_count": w.fsync_count,
                          "rollback_count": w.rollback_count}
                if counts["request_count"] != len(lat) or \
                        not counts["fsync_count"] < len(lat):
                    raise AssertionError(f"group commit: {counts}")
                res["group_commit"]["worker"] = counts
                res["group_commit"]["fsyncs_per_write"] = \
                    counts["fsync_count"] / len(lat)
        for nid in range(1, 1 + 2 * gc_threads * gc_per_thread):
            status, body, _ = conn.call("GET", f"/{fid(2, nid)}")
            if status != 200 or body != store_payload(seed + 2, nid, size):
                raise AssertionError(f"read back {fid(2, nid)}: {status}")

        # 4. backup, more writes and deletes, backup again; fix, export
        wait_for("the master to locate volume 1",
                 lambda: http_json("GET", f"http://{master}/dir/lookup"
                                   "?volumeId=1").get("locations"), 60)
        follower = os.path.join(work, "follower")
        backup = ["backup", "-master", master, "-volumeId", "1", "-dir",
                  follower]
        applied = []
        base = vs.store.get_volume(1).file_prefix
        seeded_bytes = seed_follower(base, follower, follower_seed)
        out, res["seconds"]["backup_1"] = run_cli(backup)
        applied.append(int(re.search(r"applied (\d+) records", out)
                           .group(1)))
        live = sorted(set(range(1, n + 1)) - set(gone))
        t0 = time.perf_counter()
        for nid in range(n + 100, n + 100 + more):
            status, body, _ = conn.call("PUT", f"/{fid(1, nid)}",
                                        store_payload(seed, nid, size))
            if status != 201:
                raise AssertionError(f"PUT more: {status} {body!r}")
        dropped = [live[int(i)] for i in rng.choice(
            len(live), size=more_deletes, replace=False)]
        for nid in dropped:
            status, _, _ = conn.call("DELETE", f"/{fid(1, nid)}")
            if status != 200:
                raise AssertionError(f"DELETE {nid}: {status}")
        res["seconds"]["more"] = time.perf_counter() - t0
        out, res["seconds"]["backup_2"] = run_cli(backup)
        applied.append(int(re.search(r"applied (\d+) records", out)
                           .group(1)))
        if applied != [n - follower_seed + batch_deletes,
                       more + more_deletes]:
            raise AssertionError(f"backup applied {applied}")
        t0 = time.perf_counter()
        src_sha = sha256_file(base + ".dat")
        if sha256_file(os.path.join(follower, "1.dat")) != src_sha:
            raise AssertionError("the follower's .dat differs")
        res["seconds"]["dat_compare"] = time.perf_counter() - t0
        res["backup"] = {
            "applied": applied, "dat_bytes": os.path.getsize(base + ".dat"),
            "dat_sha256_equal": True, "follower_seed_needles": follower_seed,
            "MBps": [(res["dat_bytes"] - seeded_bytes)
                     / res["seconds"]["backup_1"] / 1e6,
                     (more * (size + 40)) / res["seconds"]["backup_2"]
                     / 1e6]}
        idx_before_fix = open(os.path.join(follower, "1.idx"), "rb").read()
        # fix and export at once: export opens the follower's index before
        # or after fix renames the rebuilt one in, and the two are equal
        # (checked below); each is timed from its own start to its end
        t0 = time.perf_counter()
        runs: dict = {}
        run_threads(lambda t: runs.__setitem__(t, run_cli(
            [("fix", "export")[t], "-dir", follower, "-volumeId", "1"])),
            2, 900)
        (out, res["seconds"]["fix"]), (listing, res["seconds"]["export"]) = \
            runs[0], runs[1]
        res["seconds"]["fix_and_export"] = time.perf_counter() - t0
        fixed = live_map(os.path.join(follower, "1.idx"))
        source = live_map(base + ".idx")
        if not all(np.array_equal(a, b) for a, b in
                   zip(fixed[:3], source[:3])):
            raise AssertionError("fix's .idx loads to another live map")
        live_count = len(source[0])
        res["fix"] = {"line": out.strip().replace(follower, "<follower>"),
                      "live": len(fixed[0]),
                      "idx_bytes_equal_to_backup": open(os.path.join(
                          follower, "1.idx"), "rb").read() == idx_before_fix}
        del idx_before_fix
        listed = sum(1 for line in listing.splitlines()
                     if line.startswith("id "))
        if listed != live_count or live_count != n - batch_deletes \
                + more - more_deletes:
            raise AssertionError(f"export listed {listed}, live {live_count}")
        res["export"] = {"listed": listed, "live": live_count}
        del listing
        up = os.path.join(work, "upload.bin")
        with open(up, "wb") as f:
            f.write(store_payload(seed + 3, 1, 100 << 10))
        out, res["seconds"]["upload"] = run_cli(
            ["upload", "-master", master, "-collection", "tools", up])
        up_fid = json.loads(out.strip().splitlines()[-1])["fid"]
        got = os.path.join(work, "download.bin")
        _, res["seconds"]["download"] = run_cli(
            ["download", "-master", master, "-o", got, up_fid])
        if open(got, "rb").read() != store_payload(seed + 3, 1, 100 << 10):
            raise AssertionError("download differs from the upload")
        res["upload"] = {"fid": up_fid, "bytes": 100 << 10,
                         "bytes_equal": True}

        # 5. the seal on the card, then degraded GETs
        plain_ecx = plain_sorted_index(base + ".idx")
        dat_size = os.path.getsize(base + ".dat")
        before = gf_matmul.launches
        t0 = time.perf_counter()
        conn.admin("/admin/ec/generate", {"volume_id": 1})
        sync()
        res["seconds"]["ec_generate"] = time.perf_counter() - t0
        encode_launches = gf_matmul.launches - before
        encode_rule = (StreamingEncoder(device="cpu").dispatches_for(
            dat_size) * -(-4 // ROWS_PER_LAUNCH)) if device == "cuda" else 0
        if encode_launches != encode_rule:
            raise AssertionError(f"generate: {encode_launches} launches, "
                                 f"the rule gives {encode_rule}")
        with open(base + ".ecx", "rb") as f:
            if f.read() != plain_ecx:
                raise AssertionError("the .ecx is not the plain sorted index")
        conn.admin("/admin/ec/mount", {"volume_id": 1})
        conn.admin("/admin/delete_volume", {"volume_id": 1})
        check_shards(base, 8, seed)
        # the kernel against the plain version on the shards' own bytes
        # (launches outside the main path's count)
        width = min(1 << 20, os.path.getsize(base + to_ext(0)))
        fds = [os.open(base + to_ext(i), os.O_RDONLY) for i in range(14)]
        try:
            rows = np.stack([np.frombuffer(os.pread(fd, width, 0), np.uint8)
                             for fd in fds])
        finally:
            for fd in fds:
                os.close(fd)
        mt = torch.from_numpy(build_encoding_matrix(10, 14)[10:].copy()).to(
            vs.store.device)
        data = torch.from_numpy(rows[:10].copy()).to(vs.store.device)
        got_parity = gf_matmul(mt, data)
        err = int((got_parity.int() - gf_matmul_plain(mt, data).int())
                  .abs().max())
        if err or not np.array_equal(got_parity.cpu().numpy(), rows[10:]):
            raise AssertionError(f"kernel vs plain on the shards: {err}")
        lost = [2, 7]
        conn.admin("/admin/ec/delete", {"volume_id": 1, "shard_ids": lost})
        alive = sorted(set(live) - set(dropped))
        picks = [alive[int(i)] for i in rng.choice(
            len(alive), size=min(degraded, len(alive)), replace=False)]
        shards_of = needle_shards(base, 1, picks)
        rule = sum(s in lost for sh in shards_of for s in sh) \
            if device == "cuda" else 0
        before = gf_matmul.launches
        lat = []
        for nid in picks:
            t1 = time.perf_counter()
            status, body, _ = conn.call("GET", f"/{fid(1, nid)}")
            lat.append(time.perf_counter() - t1)
            if status != 200 or body != store_payload(seed, nid, size):
                raise AssertionError(f"degraded GET {nid}: {status}")
        sync()
        get_launches = gf_matmul.launches - before
        if get_launches != rule:
            raise AssertionError(f"degraded GETs: {get_launches} launches, "
                                 f"the rule gives {rule}")
        status, _, _ = conn.call("GET", f"/{fid(1, gone[0])}")
        if status != 404:
            raise AssertionError(f"batch-deleted needle via EC: {status}")
        res["seal"] = {
            "dat_bytes": dat_size, "encode_launches": encode_launches,
            "encode_launches_rule": encode_rule,
            "ecx_equal_to_plain": True, "kernel_max_abs_err": err,
            "lost_shards": lost, "gets": len(lat),
            "get_ms": percentiles(lat), "get_launches": get_launches,
            "get_launches_rule": rule,
            "lost_intervals": sum(s in lost for sh in shards_of for s in sh),
            "deleted_needle_404": True}
        res["launches"] = encode_launches + get_launches
        res["kernel_max_abs_err"] = err
        res["seconds"]["phase"] = time.perf_counter() - t_phase
    finally:
        if conn is not None:
            conn.close()
        if vs is not None:
            vs.stop()
        mproc.send_signal(signal.SIGTERM)
        try:
            mproc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            mproc.kill()
            mproc.wait()
        mproc.stdout.close()
    return res


# --- the secured, tiered cluster ------------------------------------------------

def make_certs(directory: str) -> dict | None:
    """A CA and one node certificate it signed, made by the ``openssl``
    command line (as tests/test_torch_tls.py makes them); None where the
    host has no ``openssl``."""
    if shutil.which("openssl") is None:
        return None
    os.makedirs(directory)
    p = {k: os.path.join(directory, k) for k in (
        "ca.key", "ca.crt", "node.key", "node.csr", "node.crt")}
    for argv in (
            ["req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
             p["ca.key"], "-out", p["ca.crt"], "-days", "2", "-subj",
             "/CN=secure-tier-ca"],
            ["req", "-newkey", "rsa:2048", "-nodes", "-keyout",
             p["node.key"], "-out", p["node.csr"], "-subj", "/CN=node"],
            ["x509", "-req", "-in", p["node.csr"], "-CA", p["ca.crt"],
             "-CAkey", p["ca.key"], "-CAcreateserial", "-out", p["node.crt"],
             "-days", "2"]):
        subprocess.run(["openssl", *argv], check=True, capture_output=True,
                       timeout=120)
    return {"ca": p["ca.crt"], "cert": p["node.crt"], "key": p["node.key"]}


def security_toml(keys: dict, certs: dict | None) -> str:
    """A security.toml: write and read keys, a whitelist of 127.0.0.1 and,
    with ``certs``, cluster mTLS."""
    text = (f'[jwt.signing]\nkey = "{keys["write"]}"\n\n'
            f'[jwt.signing.read]\nkey = "{keys["read"]}"\n\n'
            '[guard]\nwhite_list = ["127.0.0.1"]\n')
    if certs is not None:
        text += (f'\n[tls]\nca = "{certs["ca"]}"\ncert = "{certs["cert"]}"\n'
                 f'key = "{certs["key"]}"\n')
    return text


SECURE_COLLECTION = "securetier"


def run_secure_tier_phase(engine: str, work: str, total_bytes: int,
                          threads: int, tier_gets: int, degraded: int,
                          seed: int = SEED + 29) -> dict:
    """A secured, tiered cluster through the CLI: a master and four
    ``volume -ec.engine <engine> -tier.backends cold=<work>/cold``
    servers, the first with ``-mmap``, all started in a directory whose
    security.toml holds a write key, a read key, a whitelist of 127.0.0.1
    and (where ``openssl`` made the certificates) mTLS; this process takes
    the client side of the same TLS.  Volume 1 of collection
    ``securetier`` on the mmap server takes ``total_bytes`` of seeded
    needles (log-uniform 1 KiB - 4 MiB) from ``threads`` WeedClient
    threads, replication 000, each write carrying its assign's token.  An
    unsigned PUT, a DELETE and a GET without a read token must each answer
    401.  ``tier_gets`` seeded GETs read locally, then ``volume.tier.upload
    -dest cold`` and the same GETs from the tier, each its needle's bytes;
    ``ec.encode`` of the tiered volume must print the reference's failure
    (the encoder opens the local `.dat`); ``volume.tier.download`` must
    give back the `.dat` by sha256; ``ec.encode`` then runs on the card,
    its host's launches the encoder's dispatch rule; data shards 2 and 7
    are deleted and ``degraded`` GETs with read tokens must each return
    its needle's bytes, the servers' launches one per lost interval (read
    after each GET, so each server's first launching GET is kept apart).
    Returns the phase's numbers; ``launches`` counts the encode's and the
    degraded GETs' launches, from the servers' own counts."""
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.ops.gf_matmul import ROWS_PER_LAUNCH
    from seaweedfs_tpu_torch.security import tls as tls_mod
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils import httpd
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json

    res: dict = {"seconds": {}}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    keys = {"write": rng.bytes(16).hex(), "read": rng.bytes(16).hex()}
    t0 = time.perf_counter()
    certs = make_certs(os.path.join(work, "certs"))
    res["seconds"]["certs"] = time.perf_counter() - t0
    res["tls"] = "mtls" if certs else "not run: no openssl"
    conf = os.path.join(work, "conf")
    os.makedirs(conf)
    with open(os.path.join(conf, "security.toml"), "w") as f:
        f.write(security_toml(keys, certs))
    cold = os.path.join(work, "cold")
    mport = free_port()
    master = f"127.0.0.1:{mport}"
    mlog = os.path.join(work, "master.log")
    vs: dict = {}
    for i in range(4):
        url = f"127.0.0.1:{free_port()}"
        vs[url] = {"dir": os.path.join(work, f"vs{i}"),
                   "log": os.path.join(work, f"vs{i}.log"),
                   "mmap": i == 0}
        os.makedirs(vs[url]["dir"])
    mmap_url = next(iter(vs))
    procs: list = []
    if certs:
        httpd.set_client_tls(tls_mod.client_context(tls_mod.TlsConfig(
            ca_file=certs["ca"], cert_file=certs["cert"],
            key_file=certs["key"])))
    try:
        mproc = start_cli(["master", "-port", str(mport), "-pulseSeconds",
                           "0.5"], mlog, cwd=conf)
        procs.append(mproc)
        read_start_line(mproc, mlog, "master listening")
        for url, info in vs.items():
            info["proc"] = start_cli(
                ["volume", "-dir", info["dir"], "-port", url.split(":")[1],
                 "-mserver", master, "-pulseSeconds", "0.5", "-ec.engine",
                 engine, "-tier.backends", f"cold={cold}"]
                + (["-mmap"] if info["mmap"] else []), info["log"], cwd=conf)
            procs.append(info["proc"])
        for info in vs.values():
            line = read_start_line(info["proc"], info["log"],
                                   "volume server listening")
            if f"ec on {ENGINES[engine]}" not in line:
                raise AssertionError(f"start line {line!r}")
            info["start_line"] = line
        wait_for("every volume server to register",
                 lambda: set(vs) <= node_urls(master_status(master)), 60)
        res["start_lines"] = [vs[u]["start_line"] for u in vs]

        # 1. the volume, on the mmap server, and its needles
        http_json("POST", f"http://{mmap_url}/admin/assign_volume",
                  {"volume_id": 1, "collection": SECURE_COLLECTION,
                   "replication": "000"})
        http_json("POST", f"http://{mmap_url}/admin/heartbeat_now", {})
        specs = needle_specs(seed, total_bytes)
        fids: list = [None] * len(specs)

        def writer(t: int) -> None:
            client = WeedClient(master)
            for i in range(t, len(specs), threads):
                nid, _, size = specs[i]
                fids[i] = client.upload(needle_data(seed, nid, size),
                                        collection=SECURE_COLLECTION)

        t0 = time.perf_counter()
        run_threads(writer, threads, 1800)
        res["seconds"]["upload"] = time.perf_counter() - t0
        if {FileId.parse(f).volume_id for f in fids} != {1}:
            raise AssertionError("a write left volume 1")
        base = os.path.join(vs[mmap_url]["dir"], f"{SECURE_COLLECTION}_1")
        dat_bytes = os.path.getsize(base + ".dat")
        res["needles"] = len(specs)
        res["upload_bytes"] = sum(size for _, _, size in specs)
        res["dat_bytes"] = dat_bytes
        res["write_MBps"] = res["upload_bytes"] / res["seconds"]["upload"] \
            / 1e6

        # 2. the guard: an unsigned PUT, a DELETE and a GET, 401 each
        a = http_json("GET", f"http://{master}/dir/assign?collection="
                             f"{SECURE_COLLECTION}")
        if not a.get("auth"):
            raise AssertionError(f"assign without a token: {a}")
        refused = {}
        for name, method, fid_str, body in (
                ("unsigned_put", "PUT", a["fid"], b"no token"),
                ("unsigned_delete", "DELETE", fids[0], None),
                ("get_without_read_token", "GET", fids[0], None)):
            status, answer, _ = http_bytes(
                method, f"http://{a['url'] if method == 'PUT' else mmap_url}"
                        f"/{fid_str}", body)
            if status != 401:
                raise AssertionError(f"{name}: {status} {answer[:200]!r}")
            refused[name] = {"status": status,
                             "body": json.loads(answer)["error"]}
        res["refused"] = refused

        # 3. local reads, the upload to the tier, the same reads from it
        picks = [int(i) for i in rng.choice(len(specs), size=min(
            tier_gets, len(specs)), replace=False)]

        def timed_reads(which: list[int], after_each=None) -> list[float]:
            """Each GET's seconds; ``after_each()`` runs after each GET,
            outside its time."""
            client = WeedClient(master)
            client.rng.seed(seed)
            lat = []
            for i in which:
                nid, _, size = specs[i]
                t1 = time.perf_counter()
                body = client.download(fids[i])
                lat.append(time.perf_counter() - t1)
                if body != needle_data(seed, nid, size):
                    raise AssertionError(f"GET {fids[i]}: wrong bytes")
                if after_each is not None:
                    after_each()
            return lat

        local_lat = timed_reads(picks)
        t0 = time.perf_counter()
        dat_sha = sha256_file(base + ".dat")
        res["seconds"]["dat_sha256"] = time.perf_counter() - t0
        out, res["seconds"]["tier_upload"] = run_shell(
            master, "volume.tier.upload -volumeId 1 -dest cold", cwd=conf)
        if f"{mmap_url}: " not in out or "'backend_id': 'cold'" not in out \
                or os.path.exists(base + ".dat") \
                or not os.path.exists(base + ".vif"):
            raise AssertionError(f"tier upload: {out!r}")
        res["tier_upload_line"] = out.replace(mmap_url, "<server>")
        tier_lat = timed_reads(picks)

        # 4. ec.encode of the tiered volume: the reference's failure
        out, res["seconds"]["encode_tiered"] = run_shell(
            master, f"ec.encode -volumeId 1 -collection {SECURE_COLLECTION}",
            cwd=conf, check=False)
        want = ("ec.encode volume 1 FAILED: FileNotFoundError: [Errno 2] No "
                f"such file or directory: '{base}.dat'")
        if out != want or any(os.path.exists(base + to_ext(i))
                              for i in range(14)):
            raise AssertionError(f"ec.encode of the tiered volume: {out!r}")
        res["encode_tiered"] = out.replace(work, "<work>")

        # 5. the recall
        out, res["seconds"]["tier_download"] = run_shell(
            master, "volume.tier.download -volumeId 1", cwd=conf)
        if out != f"volume 1 downloaded on {mmap_url}" or \
                os.path.exists(base + ".vif") or os.listdir(cold):
            raise AssertionError(f"tier download: {out!r}")
        if sha256_file(base + ".dat") != dat_sha:
            raise AssertionError("the recalled .dat differs")

        # 6. ec.encode on the card
        before = kernel_launches(vs)
        t0 = time.perf_counter()
        run_shell(master, f"ec.encode -volumeId 1 -collection "
                          f"{SECURE_COLLECTION}", cwd=conf)
        res["seconds"]["ec_encode"] = time.perf_counter() - t0
        after = kernel_launches(vs)
        encode_launches = {u: after[u] - before[u] for u in vs}
        encode_rule = (StreamingEncoder(device="cpu").dispatches_for(
            dat_bytes) * -(-4 // ROWS_PER_LAUNCH)) if engine == "tpu" else 0
        if encode_launches[mmap_url] != encode_rule or \
                sum(encode_launches.values()) != encode_rule:
            raise AssertionError(f"ec.encode launches {encode_launches}, "
                                 f"the rule gives {encode_rule}")

        # 7. data shards 2 and 7 gone, degraded GETs with read tokens
        lost = [2, 7]
        holders = shard_holders(master, 1)
        for sid in lost:
            for url in holders.get(sid, []):
                http_json("POST", f"http://{url}/admin/ec/delete",
                          {"volume_id": 1, "collection": SECURE_COLLECTION,
                           "shard_ids": [sid]})
        for url in vs:
            http_json("POST", f"http://{url}/admin/heartbeat_now", {})
        wait_for("the lost shards to leave the master's map",
                 lambda: not set(lost) & set(shard_holders(master, 1)), 30)
        ecx_base = next(os.path.join(info["dir"], f"{SECURE_COLLECTION}_1")
                        for info in vs.values() if os.path.exists(
                            os.path.join(info["dir"],
                                         f"{SECURE_COLLECTION}_1.ecx")))
        dpicks = [int(i) for i in rng.choice(len(specs), size=min(
            degraded, len(specs)), replace=False)]
        shards_of = needle_shards(ecx_base, 1, [
            FileId.parse(fids[i]).key for i in dpicks])
        lost_intervals = sum(s in lost for sh in shards_of for s in sh)
        rule = lost_intervals if engine == "tpu" else 0
        # the servers' counts after every GET: which server reconstructed
        marks = [kernel_launches(vs)]
        degraded_lat = timed_reads(
            dpicks, lambda: marks.append(kernel_launches(vs)))
        get_launches = sum(marks[-1][u] - marks[0][u] for u in vs)
        if get_launches != rule:
            raise AssertionError(f"degraded GETs: {get_launches} launches, "
                                 f"the rule gives {rule}")
        res["launches"] = encode_rule + get_launches
        res["seal"] = {
            "encode_launches": encode_launches[mmap_url],
            "encode_launches_rule": encode_rule, "lost_shards": lost,
            "gets": len(degraded_lat), "lost_intervals": lost_intervals,
            "get_launches": get_launches, "get_launches_rule": rule}
        res["dat_sha256_equal_after_recall"] = True
        res["tier_upload_MBps"] = dat_bytes / res["seconds"]["tier_upload"] \
            / 1e6
        res["tier_download_MBps"] = dat_bytes \
            / res["seconds"]["tier_download"] / 1e6
        res["get_ms"] = {"local": percentiles(local_lat),
                         "tier": percentiles(tier_lat),
                         "degraded": percentiles(degraded_lat)}
        res["degraded_split_ms"] = split_first_launches(degraded_lat, marks)
        # each server's own count, from its stop line, covers every launch
        stops = {u: stop_volume_server(info["proc"])
                 for u, info in vs.items()}
        if sum(s["launches"] for s in stops.values()) != res["launches"] \
                or sum(s["reconstructed"] for s in stops.values()) \
                != lost_intervals:
            raise AssertionError(f"stop lines {stops}: launches "
                                 f"{res['launches']}, lost intervals "
                                 f"{lost_intervals}")
        res["servers"] = {u: {"mmap": vs[u]["mmap"], **stops[u]}
                          for u in vs}
        res["seconds"]["phase"] = time.perf_counter() - t_phase
        return res
    finally:
        httpd.set_client_tls(None)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()


# --- the native_plane phase -----------------------------------------------

def zlib_header() -> bool:
    """Does the host's C++ compiler find zlib.h?  The native plane links
    zlib; without it its build fails."""
    r = subprocess.run(["c++", "-fsyntax-only", "-x", "c++", "-"],
                       input="#include <zlib.h>\n", capture_output=True,
                       text=True, timeout=60)
    return r.returncode == 0


def plane_counts(urls) -> dict[str, int]:
    """Summed over the servers' /status: the W, R and D frames their
    native planes served, the needles the planes hold live, and the
    reactor's pooled and inline dispatches (its HTTP work; each /status
    read is one pooled dispatch itself)."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    out = dict.fromkeys(("W", "R", "D", "live", "pool_dispatches",
                         "fast_dispatches"), 0)
    for u in urls:
        st = http_json("GET", f"http://{u}/status")
        plane = st["NativeDataPlane"]
        for op in "WRD":
            out[op] += plane["frames"][op]
        out["live"] += sum(v["file_count"] for v in plane["volumes"].values())
        out["pool_dispatches"] += st["Dataplane"]["pool_dispatches"]
        out["fast_dispatches"] += st["Dataplane"]["fast_dispatches"]
    return out


def children_cpu_s() -> float:
    """CPU seconds of this process's finished, waited-for children."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


def run_native_plane_phase(engine: str, work: str, n: int, size: int,
                           clients: int, zipf: int, degraded: int,
                           five_byte: int, volumes: int = 7,
                           servers: int = 5, pulse_seconds: float = 0.5
                           ) -> dict:
    """The C++ data plane under upstream ``weed benchmark``'s load, as
    the dataplane phase runs the Python planes.  A CLI master and
    ``servers`` CLI ``volume -dataplane native`` servers, ``volumes``
    volumes of collection "benchmark" grown up front.  ``benchmark
    -useTcp`` writes ``n`` needles over the planes' framed ports (its
    assigns over the master's framed front, no HTTP /dir/assign), reads
    them back shuffled, then ``zipf`` reads drawn Zipf; then the same
    passes over HTTP, which the servers funnel through their planes.
    Each pass: ops/s and p50/p99, the W/R/D frames the planes served (the
    framed writes and reads exactly, the HTTP ones none), the planes' live
    needles, the reactor's pooled dispatches (flat in the framed passes
    but for the /status reads themselves: no frame reaches Python), and
    the CPU seconds of the client and of each server.  Then ``ec.encode``
    of the largest volume on the card (its planes quiesced around the
    generate): the launches the dispatch rule gives, the data shards
    decoding back to the `.dat` the plane wrote (a hard link kept before
    the encode) and the parity equal to the host table's product; data
    shards 2 and 7 deleted and ``degraded`` GETs, each its needle's bytes,
    one launch per lost interval.  The 5-byte leg: ``/admin/assign_volume
    offset_5`` on one server, ``five_byte`` needles written and read back
    over HTTP, its `.idx` 17 bytes an entry, no plane gauge for it, and
    ``ec.encode`` of it failing with the reference's error and no shard
    written."""
    from seaweedfs_tpu_torch.__main__ import bench_payload, read_fids_file
    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.ec import encoder as ec_encoder
    from seaweedfs_tpu_torch.ec.layout import to_ext
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.ops.gf_matmul import ROWS_PER_LAUNCH
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json

    collection = "benchmark"
    t_phase = time.perf_counter()
    res: dict = {"seconds": {}, "passes": {}, "counts": {}, "cpu_s": {},
                 "zlib_h": zlib_header()}
    mport = free_port()
    master = f"127.0.0.1:{mport}"
    mlog = os.path.join(work, "master.log")
    mproc = start_cli(["master", "-port", str(mport), "-pulseSeconds",
                       str(pulse_seconds)], mlog)
    vs: dict[str, dict] = {}
    try:
        read_start_line(mproc, mlog, "master listening")
        for k in range(servers):
            d = os.path.join(work, f"vs{k}")
            os.makedirs(d)
            vs[f"127.0.0.1:{free_port()}"] = {
                "dir": d, "log": os.path.join(work, f"vs{k}.log")}
        urls = list(vs)
        t0 = time.perf_counter()
        start_volume_servers(vs, master, engine, pulse_seconds, "reactor",
                             dataplane="native")
        res["seconds"]["start"] = time.perf_counter() - t0
        res["degraded_binds"] = degraded_binds(master)
        res["volumes"] = http_json(
            "GET", f"http://{master}/vol/grow?collection={collection}"
                   f"&count={volumes}")["volumeIds"]
        pids = {u: vs[u]["proc"].pid for u in urls}
        fids_file = os.path.join(work, "fids")

        def measured(name: str, args: list[str]) -> dict:
            before = plane_counts(urls)
            t0 = time.perf_counter()
            passes, res["cpu_s"][name] = cpu_split(
                pids, lambda: run_benchmark(master, args, 1800))
            res["seconds"][name] = time.perf_counter() - t0
            after = plane_counts(urls)
            res["counts"][name] = {k: after[k] - before[k] for k in before}
            for k, doc in passes.items():
                res["passes"][f"{name.split('_')[0]}_{k}"] = doc
            return res["counts"][name]

        # 1. framed passes: every frame served by the C++ threads
        res["framed_assign"] = framed_assign(master, collection)
        assigns = http_assigns(master)
        c = measured("tcp_write", [
            "-useTcp", "-n", str(n), "-size", str(size), "-c", str(clients),
            "-collection", collection, "-phase", "write", "-seed",
            str(SEED + 40), "-fidsFile", fids_file + ".tcp"])
        res["http_assigns_during_write"] = http_assigns(master) - assigns
        polls = len(urls)  # the after-reading's own /status requests
        if res["http_assigns_during_write"] or c["W"] != n or c["R"] or \
                c["live"] != n or c["pool_dispatches"] > polls:
            raise AssertionError(f"framed writes: {c}, "
                                 f"{res['http_assigns_during_write']} "
                                 f"HTTP assigns")
        c = measured("tcp_read", [
            "-useTcp", "-size", str(size), "-c", str(clients), "-phase",
            "read", "-fidsFile", fids_file + ".tcp", "-zipf", str(zipf)])
        if c["R"] != n + zipf or c["W"] or c["pool_dispatches"] > polls:
            raise AssertionError(f"framed reads: {c}")
        # 2. the same passes over HTTP, funnelled into the planes
        c = measured("http_write", [
            "-n", str(n), "-size", str(size), "-c", str(clients),
            "-collection", collection, "-phase", "write", "-seed",
            str(SEED + 41), "-fidsFile", fids_file + ".http"])
        if c["W"] or c["live"] != n:
            raise AssertionError(f"HTTP writes: {c}")
        c = measured("http_read", [
            "-size", str(size), "-c", str(clients), "-phase", "read",
            "-fidsFile", fids_file + ".http", "-zipf", str(zipf)])
        if c["R"] or c["fast_dispatches"]:
            raise AssertionError(f"HTTP reads: {c}")
        for name, doc in res["passes"].items():
            if doc["mismatches"]:
                raise AssertionError(f"{name}: {doc['mismatches']} wrong")
        res["mismatches"] = 0

        # 3. the largest volume on the card, its plane quiesced around it
        fids = [f for suffix in (".tcp", ".http")
                for f in read_fids_file(fids_file + suffix)]
        by_vid: dict[int, list[tuple[str, int]]] = {}
        for fid, pid in fids:
            by_vid.setdefault(FileId.parse(fid).volume_id, []).append(
                (fid, pid))
        res["needles_by_volume"] = {v: len(f) for v, f in by_vid.items()}
        vid = max(by_vid, key=lambda v: (len(by_vid[v]), -v))
        vfids = by_vid[vid]
        source = WeedClient(master).master.lookup(vid)[0]
        prefix = volume_file_prefix(vs[source]["dir"], collection, vid)
        kept = os.path.join(work, "plane_written.dat")
        os.link(prefix + ".dat", kept)
        dat_size = os.path.getsize(kept)
        rule = (StreamingEncoder(device="cpu").dispatches_for(dat_size)
                * -(-4 // ROWS_PER_LAUNCH)) if engine == "tpu" else 0
        before = kernel_launches(urls)
        out, res["seconds"]["ec.encode"] = run_shell(
            master, f"ec.encode -collection {collection} -volumeId {vid}")
        after = kernel_launches(urls)
        encode_launches = sum(after[u] - before[u] for u in urls)
        if f"ec encoded volume {vid} via tpu engine" not in out or \
                encode_launches != rule or \
                after[source] - before[source] != rule:
            raise AssertionError(f"ec.encode: {encode_launches} launches, "
                                 f"the rule gives {rule}: {out}")
        holders = shard_holders(master, vid)
        if sorted(holders) != list(range(14)):
            raise AssertionError(f"after ec.encode: {holders}")

        def shard_path(sid: int) -> str:
            return volume_file_prefix(vs[holders[sid][0]]["dir"], collection,
                                      vid) + to_ext(sid)

        decoded = os.path.join(work, "decoded")
        os.makedirs(decoded)
        for sid in range(10):
            os.symlink(shard_path(sid),
                       os.path.join(decoded, f"{vid}{to_ext(sid)}"))
        ec_encoder.write_dat_file(os.path.join(decoded, str(vid)), dat_size)
        if sha256_file(os.path.join(decoded, f"{vid}.dat")) != \
                sha256_file(kept):
            raise AssertionError("the data shards differ from the .dat "
                                 "the plane wrote")
        holder_base = volume_file_prefix(vs[holders[0][0]]["dir"],
                                         collection, vid)
        check_shards(holder_base, 8, SEED + 42, shard_path)
        res.update(vid=vid, volume_fids=len(vfids), dat_bytes=dat_size,
                   encode_launches=encode_launches, encode_rule=rule,
                   encode_out=out.splitlines()[-1],
                   data_shards_equal_dat=True, parity_equal_plain=True)

        lost = [2, 7]
        for sid in lost:
            for u in holders.get(sid, []):
                http_json("POST", f"http://{u}/admin/ec/delete",
                          {"volume_id": vid, "collection": collection,
                           "shard_ids": [sid]})
        for u in urls:
            http_json("POST", f"http://{u}/admin/heartbeat_now", {})
        wait_for("the lost shards to leave the master's map",
                 lambda: not set(lost) & set(shard_holders(master, vid)), 30)
        ecx_holder = next(u for u in urls if os.path.exists(
            volume_file_prefix(vs[u]["dir"], collection, vid) + ".ecx"))
        rng = np.random.default_rng(SEED + 43)
        picks = [int(i) for i in rng.choice(
            len(vfids), size=min(degraded, len(vfids)), replace=False)]
        shards_of = needle_shards(
            volume_file_prefix(vs[ecx_holder]["dir"], collection, vid), vid,
            [FileId.parse(vfids[i][0]).key for i in picks])
        intervals = sum(s in lost for sh in shards_of for s in sh)
        want = intervals if engine == "tpu" else 0
        before = kernel_launches(urls)
        t0 = time.perf_counter()
        done = bench_gets(master, vfids, picks, size, SEED + 44)
        wall = time.perf_counter() - t0
        after = kernel_launches(urls)
        got = sum(after[u] - before[u] for u in urls)
        if got != want:
            raise AssertionError(f"degraded GETs: {got} launches, "
                                 f"{intervals} lost intervals")
        res["degraded"] = {"gets": len(done), "wall_s": wall,
                           "ops_per_s": len(done) / wall,
                           "ms": percentiles([x[2] for x in done]),
                           "launches": got, "lost_intervals": intervals,
                           "bytes_equal": True}

        # 4. the 5-byte leg: a volume the plane never takes
        five_url = urls[0]
        five_vid = max(int(v) for v in res["volumes"]) + 100
        five_coll = "offset5"
        http_json("POST", f"http://{five_url}/admin/assign_volume",
                  {"volume_id": five_vid, "collection": five_coll,
                   "offset_5": True})
        t0 = time.perf_counter()
        five_fids = [str(FileId(five_vid, i + 1, 0x5B000000 + i))
                     for i in range(five_byte)]
        for i, fid in enumerate(five_fids):
            status, _, _ = http_bytes(
                "POST", f"http://{five_url}/{fid}",
                bench_payload((SEED << 8) | i, size))
            if status != 201:
                raise AssertionError(f"5-byte write {fid}: {status}")
        for i, fid in enumerate(five_fids):
            status, body, _ = http_bytes("GET", f"http://{five_url}/{fid}")
            if (status, body) != (200, bench_payload((SEED << 8) | i, size)):
                raise AssertionError(f"5-byte read {fid}: {status}")
        res["seconds"]["five_byte_io"] = time.perf_counter() - t0
        five_prefix = volume_file_prefix(vs[five_url]["dir"], five_coll,
                                         five_vid)
        idx_bytes = os.path.getsize(five_prefix + ".idx")
        st = http_json("GET", f"http://{five_url}/status")
        _, metrics, _ = http_bytes("GET", f"http://{five_url}/metrics")
        gauge = [x for x in metrics.decode().splitlines()
                 if x.startswith("SeaweedFS_volumeServer_native_plane{"
                                 f'volume="{five_vid}"')]
        if idx_bytes != 17 * five_byte or \
                str(five_vid) in st["NativeDataPlane"]["volumes"] or gauge:
            raise AssertionError(f"5-byte volume: .idx {idx_bytes} bytes, "
                                 f"plane {st['NativeDataPlane']}, {gauge}")
        http_json("POST", f"http://{five_url}/admin/heartbeat_now", {})
        out, _ = run_shell(master, f"ec.encode -collection {five_coll} "
                                   f"-volumeId {five_vid}", check=False)
        want_line = (f"ec.encode volume {five_vid} FAILED: ValueError: "
                     f"volume {five_vid} uses 5-byte offsets; EC encoding "
                     "supports 4-byte-offset volumes only")
        shards = [p for p in os.listdir(vs[five_url]["dir"])
                  if p.startswith(f"{five_coll}_{five_vid}.ec")]
        if want_line not in out or shards:
            raise AssertionError(f"ec.encode of the 5-byte volume: {out!r}, "
                                 f"shards {shards}")
        res["five_byte"] = {"vid": five_vid, "needles": five_byte,
                            "idx_bytes": idx_bytes,
                            "idx_entry_bytes": idx_bytes // five_byte,
                            "plane_gauge_lines": len(gauge),
                            "encode_line": out, "shards_written": 0}

        launches = 0
        for u in urls:
            launches += stop_volume_server(vs[u]["proc"])["launches"]
            vs[u]["proc"].stdout.close()
        res["launches"] = launches
        res["seconds"]["phase"] = time.perf_counter() - t_phase
        return res
    finally:
        for info in vs.values():
            p = info.get("proc")
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        mproc.send_signal(signal.SIGTERM)
        try:
            mproc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            mproc.kill()
            mproc.wait()
        mproc.stdout.close()


# --- the telemetry phase --------------------------------------------------

def telemetry_gets(master: str, fids: list[tuple[str, int]], picks,
                   size: int, clients: int, seed: int
                   ) -> tuple[list[tuple[str, int, float]], float]:
    """The picked GETs split over ``clients`` threads at once, each body
    held to its needle's bytes (``bench_gets``); -> (done, wall s)."""
    per = -(-len(picks) // clients)
    done: list = []
    lock = threading.Lock()

    def one(t: int) -> None:
        got = bench_gets(master, fids, picks[t * per:(t + 1) * per], size,
                         seed + t)
        with lock:
            done.extend(got)

    t0 = time.perf_counter()
    run_threads(one, clients, 900)
    return done, time.perf_counter() - t0


def get_pass(done: list, wall: float) -> dict:
    lat = [s for _, _, s in done]
    return {"gets": len(done), "wall_s": wall, "ops_per_s": len(done) / wall,
            "ms": percentiles(lat)}


def exact_widths(urls) -> dict[int, int]:
    """Kernel 1's launches by exact width, summed over the volume servers'
    /debug/ec/kernel."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    out: dict[int, int] = {}
    for u in urls:
        for w, n in http_json("GET", f"http://{u}/debug/ec/kernel")[
                "widths"].items():
            out[int(w)] = out.get(int(w), 0) + n
    return out


def widths_added(before: dict, after: dict) -> dict:
    """The launches added between two width counts, by width or class."""
    return {w: n - before.get(w, 0) for w, n in after.items()
            if n != before.get(w, 0)}


def heat_shipments(urls) -> dict[str, int]:
    """Each volume server's heat shipments so far (/debug/heat)."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    return {u: http_json("GET", f"http://{u}/debug/heat?top=0")[
        "shipper"]["shipped"] for u in urls}


def read_masses(urls) -> dict[str, dict]:
    """Each volume server's decayed http_read masses (/debug/ledger): CPU
    seconds, requests (from the rate: mass = rate * h / ln 2), its clock
    and half-life."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    out = {}
    for u in urls:
        doc = http_json("GET", f"http://{u}/debug/ledger")
        row = doc["routes"].get("http_read") or {}
        h = doc["half_life_s"]
        out[u] = {"ts": doc["ts"], "h": h,
                  "cpu": float(row.get("cpu_mass") or 0.0),
                  "req": float(row.get("req_rate") or 0.0) * h / np.log(2)}
    return out


def added_per_request(before: dict, after: dict) -> float | None:
    """CPU seconds per http_read settled between two ``read_masses``: the
    masses added, the earlier decayed to the later's clock."""
    cpu = req = 0.0
    for u, b in before.items():
        a = after[u]
        f = 2.0 ** (-(a["ts"] - b["ts"]) / b["h"])
        cpu += a["cpu"] - b["cpu"] * f
        req += a["req"] - b["req"] * f
    return cpu / req if req > 0.5 else None


def locked_json(out: str) -> dict:
    """The JSON document a ``lock; <command> -json; unlock`` shell line
    printed between its two lock lines."""
    lines = out.splitlines()
    if lines[:1] != ["locked"] or lines[-1:] != ["unlocked"]:
        raise AssertionError(f"a locked shell line: {out[-2000:]}")
    return json.loads("\n".join(lines[1:-1]))


def check_scenarios_leg(recording: dict, gets: Counter, profile: dict,
                        replay: dict, probe: dict, parked: dict,
                        health: str, step_s: float) -> dict:
    """The scenarios leg's checks, each against what the phase itself
    did; raises AssertionError at the first that fails; -> the leg's
    numbers.  ``gets``: the phase's GETs by fid (``/<fid>``); ``step_s``:
    the probe's step, which with a step's rate gives its requests.

    - workload.profile: ``records`` is the recording's workload records,
      ``read_fraction`` their share of GETs, ``top_keys[0]``'s count that
      fid's GETs, and the heat plane's cross-check is there;
    - workload.replay -against: verdict ``pass``, every check and every
      fidelity check ok;
    - capacity.probe: each default route with ``capacity_rps`` > 0 and no
      ``error``; /cluster/capacity equal to the posted document;
      cluster.health's ``capacity:`` line naming every route."""
    from seaweedfs_tpu_torch.scenarios.replay import (READ_ROUTES,
                                                      WORKLOAD_ROUTES)

    work = [r for r in recording["records"] if r["route"] in WORKLOAD_ROUTES]
    reads = sum(1 for r in work if r["route"] in READ_ROUTES)
    top, top_count = profile["top_keys"][0]
    prof = {"records": profile["records"], "workload_records": len(work),
            "read_fraction": profile["read_fraction"],
            "gets_share": round(reads / len(work), 4) if work else None,
            "top_key": top, "top_key_count": top_count,
            "top_key_gets": gets.get(top, 0), "zipf_s": profile["zipf_s"],
            "heat_zipf": profile.get("heat_zipf"),
            "observed_rps": profile["observed_rps"],
            "window_s": profile["window_s"]}
    if not work or prof["records"] != len(work) or \
            prof["read_fraction"] != prof["gets_share"] or \
            top_count != prof["top_key_gets"] or not prof["heat_zipf"]:
        raise AssertionError(f"workload.profile: {prof}")
    failed = [c for c in replay["checks"] + replay["fidelity"]
              if not c["ok"]]
    if replay["verdict"] != "pass" or failed or not replay["fidelity"]:
        raise AssertionError(f"workload.replay: {replay['verdict']}, "
                             f"failed {failed}")
    read = replay["routes"].get("read") or {}
    rep = {"verdict": replay["verdict"], "total_ops": replay["total_ops"],
           "wall_s": replay["wall_s"],
           "target_rps": replay["spec"]["target_rps"],
           "hot_set": replay["spec"]["hot_set"],
           "ops_per_s": read.get("rps"), "p50_ms": read.get("p50_ms"),
           "p99_ms": read.get("p99_ms"),
           "checks": {c["check"]: c["value"] for c in replay["checks"]},
           "fidelity": {c["check"]: [c["value"], c["bound"]]
                        for c in replay["fidelity"]}}
    routes = probe["routes"]
    bad = {r: routes.get(r) for r in SCENARIOS_ROUTES
           if not routes.get(r) or "error" in routes[r]
           or not routes[r].get("capacity_rps", 0) > 0}
    if bad or set(routes) != set(SCENARIOS_ROUTES):
        raise AssertionError(f"capacity.probe: {bad or sorted(routes)}")
    if {k: v for k, v in parked.items() if k != "posted_at"} != probe:
        raise AssertionError("/cluster/capacity is not the posted document")
    line = [ln for ln in health.splitlines() if ln.startswith("capacity:")]
    if len(line) != 1 or not all(f"{r}~" in line[0]
                                 for r in SCENARIOS_ROUTES):
        raise AssertionError(f"cluster.health's capacity line: {line}")

    def step_requests(target):
        """A probe step's requests at ``target`` rps (measure_rate runs
        every slot it schedules): at 100 or fewer, its nearest-rank p99 is
        its slowest request, so the step reads one stall, not a rate."""
        return None if target is None else max(int(step_s * target), 1)

    cap = {}
    for r, v in sorted(routes.items()):
        ops = {"capacity_step_requests":
               step_requests(v["capacity_target_rps"]),
               "knee_step_requests": step_requests(v["knee_rps"])}
        cap[r] = {"capacity_rps": v["capacity_rps"],
                  "capacity_target_rps": v["capacity_target_rps"],
                  "capacity_p99_ms": v["capacity_p99_ms"],
                  "knee_rps": v["knee_rps"],
                  **ops,
                  "p99_is_slowest": {k: n is not None and n <= 100
                                     for k, n in ops.items()},
                  "knee": (v["knee"] or {}).get("reason"),
                  "bound": (v.get("bounding") or {}).get("resource"),
                  "bound_detail": (v.get("bounding") or {}).get("detail", ""),
                  "bounding_hop": (v.get("bounding") or {}).get(
                      "bounding_hop", "")}
    return {"profile": prof, "replay": rep, "capacity": cap,
            "slo": probe["slo"], "parked_equal": True,
            "health_line": line[0]}


def write_split(master: str, n: int, p99_ms: float,
                gap_s: float = 0.02) -> dict:
    """``n`` writes from one client, ``gap_s`` apart, each the capacity
    probe's http_write op (an assign, then a POST of 1 KiB): each hop's
    and the whole write's p50/p90/p99 ms (nearest rank, as the probe's)
    and the writes slower than ``p99_ms``.  Which hop holds a write past
    the SLO, where the probe's ``bounding`` is "unknown"."""
    from seaweedfs_tpu_torch.scenarios.workload import percentile
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json

    payload = b"\x5a" * 1024
    hops: dict[str, list[float]] = {"assign": [], "post": [], "write": []}
    for _ in range(n):
        t0 = time.perf_counter()
        r = http_json("GET", f"http://{master}/dir/assign?count=1",
                      timeout=10.0)
        t1 = time.perf_counter()
        st, _, _ = http_bytes("POST", f"http://{r['url']}/{r['fid']}",
                              payload, timeout=10.0)
        t2 = time.perf_counter()
        if st != 201:
            raise AssertionError(f"a write of the split answered {st}")
        hops["assign"].append((t1 - t0) * 1e3)
        hops["post"].append((t2 - t1) * 1e3)
        hops["write"].append((t2 - t0) * 1e3)
        time.sleep(gap_s)
    out = {}
    for hop, ms in hops.items():
        ms.sort()
        out[hop] = {f"p{q}": round(percentile(ms, q / 100), 3)
                    for q in (50, 90, 99)}
        out[hop]["over_slo"] = sum(1 for x in ms if x > p99_ms)
    return dict(out, n=n, slo_ms=p99_ms)


def run_scenarios_leg(master: str, urls: list[str], recording_path: str,
                      gets: Counter, replay_s: float, clients: int,
                      step_s: float, p99_ms: float, max_rps: float) -> dict:
    """The scenario harness on a live cluster, through the shell:
    ``workload.profile`` of the recording, ``workload.replay -against``
    the master for ``replay_s`` with ``clients`` clients, then
    ``capacity.probe`` of the default routes (``-step step_s``, SLO p99 <
    ``p99_ms``), /cluster/capacity and cluster.health
    (``check_scenarios_leg``), with ``write_split``'s hops logged beside
    them and named in a failure.  The leg reads only objects it writes,
    so no server may launch a kernel across it."""
    from seaweedfs_tpu_torch.utils.httpd import http_json

    t_leg = time.perf_counter()
    seconds: dict = {}
    launches0 = kernel_launches(urls)
    with open(recording_path) as f:
        recording = json.load(f)
    out, seconds["profile"] = run_shell(
        master, f"workload.profile -file {recording_path} -json")
    profile = json.loads(out)
    out, seconds["replay"] = run_shell(
        master, f"lock; workload.replay -file {recording_path} -against "
                f"{master} -duration {replay_s:g} -clients {clients} "
                "-json; unlock")
    replay = locked_json(out)
    ceiling = "" if max_rps == SCENARIOS_MAX_RPS else f" -max {max_rps:g}"
    out, seconds["capacity.probe"] = run_shell(
        master, f"lock; capacity.probe -step {step_s:g} -p99 {p99_ms:g}"
                f"{ceiling} -json; unlock")
    probe = locked_json(out)
    parked = http_json("GET", f"http://{master}/cluster/capacity")
    health, _ = run_shell(master, "cluster.health")
    t0 = time.perf_counter()
    split = write_split(master, SCENARIOS_SPLIT_WRITES, p99_ms)
    seconds["write_split"] = time.perf_counter() - t0
    launches1 = kernel_launches(urls)
    added = {u: launches1[u] - launches0[u] for u in urls}
    if any(added.values()):
        raise AssertionError(f"the scenarios leg launched kernels: {added}")
    try:
        res = check_scenarios_leg(recording, gets, profile, replay, probe,
                                  parked, health, step_s)
    except AssertionError as e:
        raise AssertionError(f"{e}; one client's writes: {split}") from e
    seconds["leg"] = time.perf_counter() - t_leg
    res.update(launches=added, seconds=seconds, write_split=split)
    return res


def run_telemetry_phase(engine: str, work: str, n: int, size: int,
                        clients: int, gets_a: int, gets_b: int,
                        volumes: int = 7, servers: int = 3,
                        pulse_seconds: float = 0.5,
                        halflife_s: float = 5.0,
                        event_timeout: float = 30.0,
                        gets_overhead: int | None = None,
                        replay_s: float = SCENARIOS_REPLAY_S,
                        probe_step_s: float = SCENARIOS_STEP_S,
                        probe_p99_ms: float = SCENARIOS_P99_MS,
                        probe_max_rps: float = SCENARIOS_MAX_RPS) -> dict:
    """Heat, the ledger and the request log on a live cluster, under a
    flash crowd onto a cold EC volume.  A CLI master
    (``-metricsAggregationSeconds 1``: its alert loop) and ``servers`` CLI
    volume servers (``-heat.halflife halflife_s``; heat and the ledger on
    by default); ``volumes`` volumes of collection "benchmark", filled by
    ``benchmark -n n -size size -c clients``.  The shell's
    ``workload.record -sample 1.0``, then ``ec.encode`` of the volume with
    the most needles, whose data shards that hold needles (0 and 1: its
    bytes fill the first 1 MB small blocks) are deleted on their holders,
    so that every GET of it reconstructs, one launch each.

    Pass A: ``gets_a`` GETs drawn Zipf (YCSB's theta 0.99) over the other
    volumes' needles, from ``clients`` threads.  Pass B, the flash crowd:
    ``gets_b`` GETs drawn Zipf the same way over the EC volume's needles
    (those wholly in one data shard).  Checks: a ``flash_crowd`` or
    ``heat_shift`` event naming the EC volume within ``event_timeout`` of
    pass B's start, and a page on it: an alert_fired of either rule
    journaled after pass B began, or either rule firing, whose detail
    names the EC volume (``paged_by`` says which); /cluster/heat ranking
    the EC volume
    first; the merged needle sketch holding pass A's ten most-read fids;
    /cluster/ledger's http_read route with CPU, every server's loop-lag
    block, and the servers' settled requests at or above the GETs issued;
    ``heat.top``, ``heat.volumes`` and ``cluster.top`` naming the volume or
    the route; ``workload.stop`` and ``workload.export``: one 200
    ``http_read`` record per GET, pass B's equal to the holders' kernel
    launches, and those launches by exact width (/debug/ec/kernel) equal
    to the widths of the picked needles' intervals.  Then the
    overhead record: the first ``gets_overhead`` of pass B's GETs (all of
    them by default) three times more, each on freshly restarted servers
    with recording off, with accounting on, off (``-heat.off
    -ledger.off``) and on, each pass's launches one a GET.  Last, on the
    servers of the last pass, the scenarios leg (``run_scenarios_leg``):
    the recording profiled and replayed ``-against`` the master
    (``replay_s``), and the capacity probe
    (``probe_step_s``, ``probe_p99_ms``, ``probe_max_rps``), with no
    kernel launched."""
    from collections import Counter

    from seaweedfs_tpu_torch.__main__ import (ZIPF_THETA, read_fids_file,
                                              zipf_indices)
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_json

    collection = "benchmark"
    t_phase = time.perf_counter()
    res: dict = {"seconds": {}, "checks": {}}
    mport = free_port()
    master = f"127.0.0.1:{mport}"
    mlog = os.path.join(work, "master.log")
    mproc = start_cli(["master", "-port", str(mport), "-pulseSeconds",
                       str(pulse_seconds), "-metricsAggregationSeconds",
                       "1"], mlog)
    vs: dict[str, dict] = {}
    accounting = ["-heat.halflife", str(halflife_s)]
    try:
        read_start_line(mproc, mlog, "master listening")
        for k in range(servers):
            d = os.path.join(work, f"vs{k}")
            os.makedirs(d)
            vs[f"127.0.0.1:{free_port()}"] = {
                "dir": d, "log": os.path.join(work, f"vs{k}.log")}
        urls = list(vs)
        launches_stopped = 0

        def stop_all() -> None:
            nonlocal launches_stopped
            for u in urls:
                launches_stopped += stop_volume_server(
                    vs[u]["proc"])["launches"]
                vs[u]["proc"].stdout.close()

        def api(path: str, url: str = master) -> dict:
            return http_json("GET", f"http://{url}{path}")

        t0 = time.perf_counter()
        start_volume_servers(vs, master, engine, pulse_seconds, "reactor",
                             extra=accounting)
        res["seconds"]["start"] = time.perf_counter() - t0
        res["degraded_binds"] = degraded_binds(master)
        res["volumes"] = api(f"/vol/grow?collection={collection}"
                             f"&count={volumes}")["volumeIds"]
        fids_file = os.path.join(work, "fids")
        res["write"] = run_benchmark(master, [
            "-n", str(n), "-size", str(size), "-c", str(clients),
            "-collection", collection, "-phase", "write",
            "-seed", str(SEED + 30), "-fidsFile", fids_file], 1800)["write"]
        by_vid: dict[int, list[tuple[str, int]]] = {}
        for fid, pid in read_fids_file(fids_file):
            by_vid.setdefault(FileId.parse(fid).volume_id, []).append(
                (fid, pid))
        vid = max(by_vid, key=lambda v: (len(by_vid[v]), -v))
        vfids = by_vid[vid]
        hot = [f for v in sorted(by_vid) if v != vid for f in by_vid[v]]
        res["needles_by_volume"] = {v: len(f) for v, f in by_vid.items()}

        out, _ = run_shell(master, "workload.record -sample 1.0")
        if len(re.findall(r": recording sample=1 ", out)) != servers + 1:
            raise AssertionError(f"workload.record: {out}")
        res["record"] = out.splitlines()
        out, res["seconds"]["ec.encode"] = run_shell(
            master, f"ec.encode -volumeId {vid} -collection {collection}")
        if f"ec encoded volume {vid} via tpu engine" not in out:
            raise AssertionError(f"ec.encode: {out}")
        holders = shard_holders(master, vid)
        holder = next(u for u in urls if any(u in us for us in
                                             holders.values()))
        base = volume_file_prefix(vs[holder]["dir"], collection, vid)
        vkeys = [FileId.parse(f).key for f, _ in vfids]
        shards_of = needle_shards(base, vid, vkeys)
        widths_of = needle_widths(base, vid, vkeys)
        lost = sorted({s for ss in shards_of for s in ss})
        if max(lost) >= 10 or len(lost) > 4:
            raise AssertionError(f"volume {vid}'s needles span data shards "
                                 f"{lost}: more than a lost set")
        for s in lost:
            for u in holders.get(s, []):
                http_json("POST", f"http://{u}/admin/ec/delete",
                          {"volume_id": vid, "shard_ids": [s],
                           "collection": collection})
        survivors = {s: us for s, us in holders.items() if s not in lost}
        wait_for("the master to see the lost shards gone",
                 lambda: shard_holders(master, vid) == survivors, 60)
        res["ec_volume"] = {"vid": vid, "needles": len(vfids),
                            "lost_data_shards": lost,
                            "holders": {s: us for s, us in
                                        sorted(holders.items())}}

        # pass A: a read-heavy Zipf mix over the volumes left replicated
        order = np.random.default_rng(SEED + 32).permutation(len(hot))
        ranks = zipf_indices(len(hot), gets_a, ZIPF_THETA,
                             random.Random(SEED + 31))
        picks_a = [int(order[r]) for r in ranks]
        ships = heat_shipments(urls)
        done_a, wall_a = telemetry_gets(master, hot, picks_a, size, clients,
                                        SEED + 40)
        res["pass_a"] = get_pass(done_a, wall_a)
        wait_for("two heat shipments from every server after pass A",
                 lambda: all(v >= ships[u] + 2 for u, v in
                             heat_shipments(urls).items()), 30)
        heat_a = api("/cluster/heat?top=256")
        top10 = [hot[i][0] for i, _ in Counter(picks_a).most_common(10)]
        sketch = {r["fid"] for r in heat_a["zipf"]["top"]}
        missing = [f for f in top10 if f not in sketch]
        res["checks"]["pass_a_head_in_sketch"] = {
            "top10": top10, "missing": missing,
            "sketch_keys": len(sketch)}
        if missing:
            raise AssertionError(f"pass A's head {missing} is not in the "
                                 f"merged needle sketch")
        res["zipf"] = {"fitted_s": heat_a["zipf"]["s"],
                       "theta_drawn": ZIPF_THETA,
                       "distinct": heat_a["zipf"]["distinct"]}

        # pass B: the flash crowd onto the cold EC volume
        whole = [whole_i for whole_i, ss in enumerate(shards_of)
                 if len(ss) == 1]
        order_b = np.random.default_rng(SEED + 34).permutation(len(whole))
        picks_b = [whole[int(order_b[r])] for r in zipf_indices(
            len(whole), gets_b, ZIPF_THETA, random.Random(SEED + 33))]
        # each pass B GET reconstructs its one interval: a launch at its
        # width
        want_widths = dict(Counter(widths_of[i][0] for i in picks_b))
        picks_o = picks_b[:gets_overhead]
        want_o = dict(Counter(widths_of[i][0] for i in picks_o))
        widths0, launches0 = kernel_widths(urls), kernel_launches(urls)
        exact0 = exact_widths(urls)
        masses0 = read_masses(urls)
        paged_before = {a: cluster_alerts(master).get(a, {}).get("state")
                        for a in ("heat_shift", "flash_crowd")}
        t_b = time.time()
        done_b, wall_b = telemetry_gets(master, vfids, picks_b, size,
                                        clients, SEED + 50)
        widths1, launches1 = kernel_widths(urls), kernel_launches(urls)
        exact1 = exact_widths(urls)
        masses1 = read_masses(urls)
        got = sum(launches1[u] - launches0[u] for u in urls)
        if engine == "tpu" and got != len(picks_b):
            raise AssertionError(f"pass B: {got} launches for "
                                 f"{len(picks_b)} degraded GETs")
        res["pass_b"] = {**get_pass(done_b, wall_b), "launches": got,
                         "launch_widths": {c: widths1[c] - widths0[c]
                                           for c in widths1},
                         "exact_widths": widths_added(exact0, exact1),
                         "ledger_cpu_ms_per_get": (lambda x: None if x is
                                                   None else 1e3 * x)(
                             added_per_request(masses0, masses1))}

        def shift_event():
            for etype in ("flash_crowd", "heat_shift"):
                for e in api(f"/cluster/events?type={etype}&limit=200")[
                        "events"]:
                    if e["details"].get("volume") == vid and \
                            e["ts"] >= t_b - 1.0:
                        return e
            return None

        found: list = []

        def shifted() -> bool:
            e = shift_event()
            if e is not None:
                found.append(e)
            return e is not None

        wait_for("a heat_shift or flash_crowd event naming the EC volume",
                 shifted, max(1.0, t_b + event_timeout - time.time()))
        ev = found[0]
        # the page: the crowd's own, either an alert_fired journaled
        # after pass B began whose detail names the EC volume, or the
        # rule (firing since pass A's shift) now firing on the EC
        # volume's event (its detail is the latest event it saw)
        named = re.compile(rf"\bvolume={vid}\b")
        page: dict = {}

        def paged() -> bool:
            for e in api("/cluster/events?type=alert_fired&limit=200")[
                    "events"]:
                d = e["details"]
                if d.get("alert") in ("heat_shift", "flash_crowd") and \
                        e["ts"] >= t_b and named.search(
                            str(d.get("detail") or "")):
                    page.update(by="alert_fired_after_pass_b",
                                alert=d["alert"], detail=d["detail"],
                                fired_s_from_pass_b=e["ts"] - t_b)
                    return True
            for name in ("heat_shift", "flash_crowd"):
                a = cluster_alerts(master).get(name, {})
                if a.get("state") == "firing" and named.search(
                        a.get("detail") or ""):
                    page.update(by="alert_fired_after_pass_b"
                                if a["fired_at"] >= t_b else
                                "firing_alert_detail", alert=name,
                                detail=a["detail"],
                                fired_s_from_pass_b=a["fired_at"] - t_b)
                    return True
            return False

        wait_for(f"an alert paging on volume {vid}", paged,
                 max(1.0, t_b + event_timeout - time.time()))
        alert = cluster_alerts(master)[page["alert"]]
        res["checks"]["flash_crowd"] = {
            "type": ev["type"], "seconds_from_pass_b": ev["ts"] - t_b,
            "details": ev["details"], "paged_by": page["by"],
            "alert": page["alert"], "alert_state": alert["state"],
            "alert_state_before_pass_b": paged_before[page["alert"]],
            "alert_fires": alert["fires"], "alert_detail": page["detail"],
            "alert_fired_s_from_pass_b": page["fired_s_from_pass_b"]}
        heat_b: dict = {}

        def ec_first() -> bool:
            heat_b.update(api("/cluster/heat?top=20"))
            return bool(heat_b["volumes"]) and \
                heat_b["volumes"][0]["volume"] == vid

        wait_for("/cluster/heat to rank the EC volume first", ec_first, 30)
        res["checks"]["heat_rank"] = [
            {k: row[k] for k in ("volume", "heat", "share", "read_rate",
                                 "servers")}
            for row in heat_b["volumes"][:4]]

        ledger = api("/cluster/ledger?top=50")
        reads = next((r for r in ledger["routes"]
                      if r["route"] == "http_read"), None)
        issued = len(done_a) + len(done_b)
        settled = sum(p["noted"] for u, p in ledger["peers"].items()
                      if u in vs)
        loops = {u: ledger["peers"].get(u, {}).get("loop") or {}
                 for u in urls}
        if reads is None or reads["cpu_rate"] <= 0 or \
                settled < issued or not all(
                    "lag_p99_ms" in lp for lp in loops.values()):
            raise AssertionError(f"/cluster/ledger: http_read {reads}, "
                                 f"{settled} settled for {issued} GETs, "
                                 f"loops {loops}")
        res["checks"]["ledger"] = {
            "http_read": {k: reads[k] for k in (
                "req_rate", "cpu_rate", "cpu_share", "queue_wait_rate",
                "bytes_out_rate")},
            "settled_requests": settled, "gets_issued": issued,
            "loop": loops, "totals": ledger["totals"]}

        out, _ = run_shell(master, "heat.volumes -top 10; heat.top -top 20;"
                                   " cluster.top -top 10")
        lines = out.splitlines()
        named = {"heat.volumes": any(re.match(rf"^\*?\s*{vid} ", ln)
                                     for ln in lines),
                 "heat.top": any(ln.startswith(f"{vid},") for ln in lines),
                 "cluster.top": any(ln.startswith("http_read ")
                                    for ln in lines)}
        res["checks"]["shell"] = named
        if not all(named.values()):
            raise AssertionError(f"the shell's heat/ledger views: {named}\n"
                                 f"{out}")
        res["shell_lines"] = [ln for ln in lines
                              if ln.startswith((f"{vid},", "http_read"))
                              or re.match(rf"^\*?\s*{vid} ", ln)]

        export = os.path.join(work, "recording.json")
        out, _ = run_shell(master, f"workload.stop; workload.export -out "
                                   f"{export}")
        res["export_lines"] = out.splitlines()
        with open(export) as f:
            doc = json.load(f)
        gets = [r for r in doc["records"] if r["route"] == "http_read"]
        b_recs = [r for r in gets if r["path"].startswith(f"/{vid},")]
        at_width = sum(res["pass_b"]["exact_widths"].get(w, 0)
                       for w in want_widths)
        res["checks"]["recording"] = {
            "records": len(doc["records"]), "http_read": len(gets),
            "gets_issued": issued, "pass_b_records": len(b_recs),
            "pass_b_launches_at_their_widths": at_width,
            "pass_b_widths": {"launched": res["pass_b"]["exact_widths"],
                              "their_intervals": want_widths},
            "statuses": dict(Counter(r["status"] for r in gets)),
            "dropped": doc["dropped"],
            "routes": {k: v["ops"] for k, v in
                       doc["summary"]["routes"].items()}}
        if len(gets) != issued or any(r["status"] != 200 for r in gets) \
                or len(b_recs) != len(done_b) or (
                    engine == "tpu" and (
                        len(b_recs) != at_width or
                        res["pass_b"]["exact_widths"] != want_widths)):
            raise AssertionError(f"the recording: "
                                 f"{res['checks']['recording']}")

        # the overhead record: pass B again on freshly restarted servers,
        # recording off, with heat and the ledger on, off, on
        res["overhead"] = []
        for flag in ("on", "off", "on"):
            stop_all()
            t0 = time.perf_counter()
            start_volume_servers(
                vs, master, engine, pulse_seconds, "reactor",
                extra=accounting + (["-heat.off", "-ledger.off"]
                                    if flag == "off" else []))
            wait_for("the master to see the survivors again",
                     lambda: shard_holders(master, vid) == survivors, 60)
            res["seconds"][f"restart_{len(res['overhead'])}_{flag}"] = \
                time.perf_counter() - t0
            st = api("/status", urls[0])
            if ("Ledger" in st) != (flag == "on") or \
                    st["Heat"]["enabled"] != (flag == "on"):
                raise AssertionError(f"accounting {flag}: {st['Heat']}")
            l0, w0 = kernel_launches(urls), exact_widths(urls)
            done, wall = telemetry_gets(master, vfids, picks_o, size,
                                        clients, SEED + 60)
            l1, w1 = kernel_launches(urls), exact_widths(urls)
            n_l = sum(l1[u] - l0[u] for u in urls)
            if engine == "tpu" and (n_l != len(picks_o) or
                                    widths_added(w0, w1) != want_o):
                raise AssertionError(f"pass B, accounting {flag}: {n_l} "
                                     f"launches at {widths_added(w0, w1)} "
                                     f"for {len(picks_o)} GETs at "
                                     f"{want_o}")
            res["overhead"].append({"accounting": flag,
                                    **get_pass(done, wall),
                                    "launches": n_l,
                                    "exact_widths": widths_added(w0,
                                                                 w1)})
        picked = Counter(f"/{hot[i][0]}" for i in picks_a)
        picked.update(f"/{vfids[i][0]}" for i in picks_b)
        res["scenarios"] = run_scenarios_leg(
            master, urls, export, picked, replay_s, SCENARIOS_CLIENTS,
            probe_step_s, probe_p99_ms, probe_max_rps)
        res["seconds"]["scenarios"] = res["scenarios"]["seconds"]["leg"]
        stop_all()
        res["launches"] = launches_stopped
        res["seconds"]["phase"] = time.perf_counter() - t_phase
        return res
    finally:
        for info in vs.values():
            p = info.get("proc")
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        mproc.send_signal(signal.SIGTERM)
        try:
            mproc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            mproc.kill()
            mproc.wait()
        mproc.stdout.close()



def split_first_launches(lat: list[float], marks: list[dict]) -> dict:
    """GET times split by launches: ``marks[j]`` holds each server's
    kernel count before GET j and ``marks[j + 1]`` after it.  Each
    server's first GET that launched (its first reconstruction, ms) is
    kept apart from the later ones that launched and from those that
    launched nothing (percentiles, None where there is none)."""
    first: dict[str, float] = {}
    later, none = [], []
    for j, s in enumerate(lat):
        who = [u for u in marks[j] if marks[j + 1][u] > marks[j][u]]
        new = [u for u in who if u not in first]
        for u in new:
            first[u] = 1e3 * s
        if not who:
            none.append(s)
        elif not new:
            later.append(s)
    return {"first_launch": first,
            "later_launches": percentiles(later) if later else None,
            "no_launch": percentiles(none) if none else None}


def percentiles(seconds: list[float]) -> dict:
    ms = np.array(seconds) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "n": len(ms)}


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(prof) -> dict:
    """Card-side time by name (kernels, copies) from a torch.profiler run;
    host-side rows are left out, so nothing is counted twice."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(e.device_type).endswith("CUDA"):
            out[e.key] = us / 1e3
    return out


GRAPH_LAUNCHES = 50
GRAPH_REPLAYS = 5


def graph_ms(launch, count: int) -> float:
    """Card milliseconds per launch with no host in between: ``count``
    calls of ``launch(i)`` captured in one CUDA graph, replayed between
    CUDA events (the median of GRAPH_REPLAYS replays).  ``launch(0)`` runs
    once on the capture stream first, so the library, its device
    constants and any per-matrix table exist before the capture."""
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        launch(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        for i in range(count):
            launch(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    del graph
    return float(np.median(times))


def host_ms_per_call(fn, count: int) -> float:
    """Host milliseconds per call of ``fn``: a host clock over ``count``
    calls, ending in a synchronize (the wrapper's own cost where it
    exceeds the kernel's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / count


def launch_floor_ms() -> dict:
    """An empty kernel (csrc/gf_matmul.cu ``gf_noop_launch``) launched as
    kernel_numbers launches kernel 1: milliseconds per launch in a CUDA
    graph, and a host clock per ctypes call."""
    import torch

    from seaweedfs_tpu_torch.ops import _build

    lib = _build.load("gf_matmul")

    def noop(_i=0):
        err = lib.gf_noop_launch(torch.cuda.current_stream().cuda_stream,
                                 torch.cuda.current_device())
        if err:
            raise RuntimeError(f"gf_noop_launch: CUDA error {err}")

    return {"ms": graph_ms(noop, GRAPH_LAUNCHES),
            "host_ms": host_ms_per_call(noop, GRAPH_LAUNCHES)}


def kernel_numbers(leg: str, m: np.ndarray, width: int) -> dict:
    """Kernel 1's times for ``m`` [r, k] at [k, width] -> [r, width]:
    kernel-only ms, warm (the same buffers every launch) and cold (each
    launch on the next column block of inputs and outputs that together
    hold over four times the card's 50 MB L2), each from a CUDA graph of
    launches (``graph_ms``); the wrapper's host ms per call; the plain
    version's ms; and the card's bound for the same work, (k+r)*width
    bytes read and written once over HBM bandwidth.  The kernel does two
    table lookups per input byte on CUDA cores, far under any compute
    peak, so the bytes bound it."""
    import torch

    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul, gf_matmul_plain

    r, k = m.shape
    mt = torch.from_numpy(m.copy()).cuda()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    data = torch.randint(0, 256, (k, width), generator=gen,
                         dtype=torch.uint8).cuda()
    out = torch.empty((r, width), dtype=torch.uint8, device="cuda")
    warm_ms = graph_ms(lambda _i: gf_matmul(mt, data, out), GRAPH_LAUNCHES)
    host_ms = host_ms_per_call(lambda: gf_matmul(mt, data, out),
                               GRAPH_LAUNCHES)
    plain_ms = time_cuda(lambda: gf_matmul_plain(mt, data), 3)
    gf_matmul(mt, data, out)
    err = int((out.int() - gf_matmul_plain(mt, data).int()).abs().max())
    # cold: launch i on column block i % sets of one wide pair of buffers,
    # each block at a 256-byte pitch so every launch sees aligned rows
    pitch = -(-width // 256) * 256
    sets = max(2, -(-4 * L2_BYTES // ((k + r) * width)))
    count = max(GRAPH_LAUNCHES, sets)
    ins = torch.randint(0, 256, (k, sets * pitch), generator=gen,
                        dtype=torch.uint8).cuda()
    outs = torch.empty((r, sets * pitch), dtype=torch.uint8, device="cuda")

    def cold(i):
        c0 = (i % sets) * pitch
        gf_matmul(mt, ins[:, c0:c0 + width], outs[:, c0:c0 + width])

    cold_ms = graph_ms(cold, count)
    c0 = (count - 1) % sets * pitch
    cold_err = int((outs[:, c0:c0 + width].int() - gf_matmul_plain(
        mt, ins[:, c0:c0 + width]).int()).abs().max())
    del ins, outs
    return {"leg": leg, "shape": f"[{k},{width}]->[{r},{width}]",
            "ms": warm_ms, "cold_ms": cold_ms, "cold_sets": sets,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * (k + r) * width / HBM_BYTES_PER_S,
            "bound_by": "bytes", "max_abs_err": max(err, cold_err)}


def table_numbers(m: np.ndarray) -> dict:
    """The table build's times for ``m`` [r, k]: kernel-only ms from a
    CUDA graph, the plain version's (gf_table_plain on the host) ms, and
    the card's bound, the r*k matrix bytes read and the tables' words
    written once over HBM bandwidth."""
    import torch

    from seaweedfs_tpu_torch.ops.gf_matmul import (gf_table_build,
                                                   gf_table_plain)

    mt = torch.from_numpy(m.copy()).cuda()
    ms = graph_ms(lambda _i: gf_table_build(mt), GRAPH_LAUNCHES)
    t0 = time.perf_counter()
    want = gf_table_plain(m)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got = gf_table_build(mt).cpu().numpy().view(np.uint32)
    err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
    return {"shape": f"[{m.shape[0]},{m.shape[1]}]", "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": 1e3 * (m.size + want.nbytes) / HBM_BYTES_PER_S,
            "bound_by": "bytes", "max_abs_err": err}


def zero_counts() -> None:
    """Every kernel count of this process to 0: kernel 1's launches and
    launch widths, and the table builds."""
    from collections import Counter

    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul, gf_table_build

    gf_matmul.launches = 0
    gf_matmul.widths = Counter()
    gf_table_build.launches = 0


def read_counts() -> dict:
    """This process's kernel counts since ``zero_counts``: launches of
    each kernel, kernel 1's launches by width class and its five most
    common widths."""
    from seaweedfs_tpu_torch.ops.gf_matmul import (gf_matmul, gf_table_build,
                                                   width_classes)

    return {"gf_matmul": gf_matmul.launches,
            "gf_table_build": gf_table_build.launches,
            "widths": width_classes(gf_matmul.widths),
            "common_widths": gf_matmul.widths.most_common(5)}


def profile_encode(dat_path: str, out_base: str) -> dict:
    """One more encode of the main volume under torch.profiler: the card's
    time by kernel and copy, against the call's wall clock.  The card-side
    times are summed, so copy/compute overlap makes the busy figure an
    upper bound and the idle share a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder

    enc = StreamingEncoder(device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc.encode_file(dat_path, out_base)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = device_ms(prof)
    busy_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "device_ms": by_name, "stats": enc.stats}


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "seaweedfs_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card", file=sys.stderr)
        return 2
    from collections import Counter

    from seaweedfs_tpu_torch.ops import _build
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul, width_classes
    from seaweedfs_tpu_torch.stats import degraded_bind_metrics

    t_all = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log({"phase": "environment", "nvidia_smi": card, "device": kind,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0], "zlib_h": zlib_header()})
    t0 = time.perf_counter()
    _build.build(["crc32c", "gf_matmul", "dataplane"])
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "libraries": {n: round(i["seconds"], 3)
                       for n, i in _build.BUILD_INFO.items()}})
    log(_build.BUILD_INFO["gf_matmul"]["log"].strip())

    t0 = time.perf_counter()
    worst = check_kernel("cuda", [1, 7, 15, 17, 1064, 4096, 4097, 65537,
                                  1 << 20, 8 << 20])
    torch.cuda.synchronize()
    log({"phase": "kernel_vs_plain", "max_abs_err": worst,
         "cases": len(kernel_cases()), "seconds": time.perf_counter() - t0})

    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=_build.BUILD_DIR)
    try:
        log({"phase": "main_path", "reduced": {
            "volume_bytes": VOLUME_BYTES,
            "from": "30,000 MB default volume size limit (weed master "
                    "-volumeSizeLimitMB)",
            "why": "run time limit"}})
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = run_main_path("cuda", work, VOLUME_BYTES,
                            LARGE_ROW_VOLUME_BYTES, LARGE_ROW_BLOCK,
                            DEGRADED_READS, PARITY_STRIPES)
        counts = {"main_path": read_counts()}
        launches = gf_matmul.launches
        prof = profile_encode(os.path.join(work, "1.dat"),
                              os.path.join(work, "profiled"))
        zero_counts()
        resume = run_resume_phase("cuda", work, res["hashes"])
        counts["resume"] = read_counts()
        resume_launches = gf_matmul.launches
        zero_counts()
        trace_ab = run_trace_ab("cuda", work, res["hashes"])
        counts["trace_ab"] = read_counts()
        trace_ab_launches = gf_matmul.launches
        mesh_sets = mesh_lane_sets("cuda")
        log({"phase": "mesh", "lanes": [[str(d) for d in s]
                                        for s in mesh_sets],
             "cards": torch.cuda.device_count(),
             "reduced": {"volume_bytes": VOLUME_BYTES,
                         "from": "30,000 MB default volume size limit",
                         "why": "the main path's volume, re-encoded"}})
        zero_counts()
        mesh = run_mesh_phase("cuda", work, res["hashes"], res["specs"],
                              mesh_sets, MESH_PROGRAM_WIDTH)
        counts["mesh"] = read_counts()
        mesh_counted = gf_matmul.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if trace_ab_launches <= 0:
        raise AssertionError("the trace A/B encodes launched no kernel")
    for leg, n in res["launches"].items():
        if n <= 0:
            raise AssertionError(f"leg {leg} launched no kernel")
    if counts["main_path"]["gf_table_build"] <= 0:
        raise AssertionError("the main path built no GF table")
    lat = np.array(res["read_latency_s"]) * 1e3
    log({"phase": "main_path_done", "dat_bytes": res["dat_bytes"],
         "needles": res["needles"], "shard_bytes": res["shard_bytes"],
         "launches": res["launches"], "seconds": res["seconds"],
         "encode_GBps": res["dat_bytes"] / res["seconds"]["encode"] / 1e9,
         "rebuild_GBps": 10 * res["shard_bytes"]
         / res["seconds"]["rebuild"] / 1e9,
         "degraded_read_ms": {"p50": float(np.percentile(lat, 50)),
                              "p99": float(np.percentile(lat, 99)),
                              "n": len(lat)},
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "sha256": {**res["hashes"], ".ecx": res["ecx_sha256"]},
         "nvidia_smi": card})
    log({"phase": "pipeline_stats", **res["stats"]})
    log({"phase": "profiled_encode", **prof})
    if resume_launches <= 0:
        raise AssertionError("the resumed encode launched no kernel")
    log({"phase": "resume", "dispatches": resume["dispatches"],
         "failed_dispatch": resume["failed_dispatch"],
         "launches": resume_launches,
         "launch_bound": resume["launch_bound"],
         "resume_byte": resume["resume_byte"], "seconds": resume["seconds"],
         "sha256_equal_to_clean": True, "stats": resume["stats"],
         "nvidia_smi": card})
    mesh_launches = mesh["path_launches"] + mesh["cli"]["launches"]
    if mesh["path_launches"] <= 0 or mesh["cli"]["launches"] <= 0:
        raise AssertionError("the mesh phase's paths launched no kernel")
    log({"phase": "mesh_programs", "width": MESH_PROGRAM_WIDTH,
         "programs": mesh["programs"], "nvidia_smi": card})
    log({"phase": "mesh_store", "runs": mesh["store"], "split": mesh["split"],
         "degraded_gets": mesh["degraded_gets"],
         "tpu_encode_s": res["seconds"]["encode"],
         "tpu_rebuild_s": res["seconds"]["rebuild"], "nvidia_smi": card})
    log({"phase": "mesh_done", "cli": mesh["cli"],
         "launches": mesh_launches,
         "program_and_compare_launches": mesh_counted - mesh["path_launches"],
         "sha256_equal_to_main_path": True, "seconds": mesh["seconds"],
         "budget_s": MESH_BUDGET_S,
         "within_budget": mesh["seconds"] <= MESH_BUDGET_S,
         "copies_between_cards": ("not run: one card" if
                                  torch.cuda.device_count() == 1 else "run"),
         "nvidia_smi": card})
    ab = trace_ab["runs"]
    walls = {m: [r["wall_s"] for r in ab if r["mode"] == m]
             for m in ("off", "on")}
    log({"phase": "trace_ab", "dispatches": trace_ab["dispatches"],
         "order": [r["mode"] for r in ab],
         "launches": [r["launches"] for r in ab], "wall_s": walls,
         "traced_over_untraced": sum(walls["on"]) / sum(walls["off"]),
         "sha256_equal_to_clean": True, "spans": trace_ab["spans"],
         "spans_dropped": trace_ab["dropped"],
         "span_names": trace_ab["span_names"],
         "attribution": trace_ab["attribution"],
         "span_cost_us": trace_ab["span_cost_us"],
         "stats": [{k: r["stats"][k] for k in (
             "wall_s", "setup_s", "fill_s", "dispatch_s", "write_s",
             "drain_wait_s", "drain_s", "close_s")} for r in ab],
         "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-http-", dir=_build.BUILD_DIR)
    try:
        log({"phase": "http_path", "reduced": {
            "volume_bytes": VOLUME_BYTES,
            "from": "30,000 MB default volume size limit (weed master "
                    "-volumeSizeLimitMB)",
            "why": "run time limit"}})
        zero_counts()
        http = run_http_path("cuda", work, VOLUME_BYTES, DEGRADED_READS,
                             HTTP_THREADS, HTTP_READS_PER_THREAD,
                             DECODED_READS, PARITY_STRIPES, OVERLOAD_THREADS,
                             OVERLOAD_READS_PER_THREAD,
                             OVERLOAD_MAX_INFLIGHT)
        counts["http_path"] = read_counts()
        http_launches = gf_matmul.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for leg, n in http["launches"].items():
        if n <= 0:
            raise AssertionError(f"http leg {leg} launched no kernel")
    # the phase's in-process servers share this process's counter
    http_binds = degraded_bind_metrics().totals()["degraded_binds"]
    if http_binds:
        raise AssertionError(f"{http_binds} framed planes came up degraded")
    log({"phase": "http_path_done", "degraded_binds": http_binds,
         "dat_bytes": http["dat_bytes"],
         "needles": http["needles"], "shard_bytes": http["shard_bytes"],
         "launches": http["launches"], "seconds": http["seconds"],
         "encode_GBps": http["dat_bytes"] / http["seconds"]["encode"] / 1e9,
         "rebuild_GBps": 10 * http["shard_bytes"]
         / http["seconds"]["rebuild"] / 1e9,
         "degraded_get_ms_1_client": percentiles(
             http["latency_1_client_s"]),
         "degraded_get_ms_8_clients": percentiles(
             http["latency_8_clients_s"]),
         "scrub": http["scrub"],
         "http_over_store": {
             "encode_s": http["seconds"]["encode"]
             - res["seconds"]["encode"],
             "rebuild_s": http["seconds"]["rebuild"]
             - res["seconds"]["rebuild"],
             "degraded_p50_ms": percentiles(http["latency_1_client_s"])["p50"]
             - float(np.percentile(lat, 50))},
         "nvidia_smi": card})
    log({"phase": "overload", **http["overload"],
         "degraded_get_ms_8_clients_no_admission": percentiles(
             http["latency_8_clients_s"]), "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-cli-", dir=_build.BUILD_DIR)
    try:
        cli = run_cli_phase("tpu", work, CLI_VOLUME_BYTES, CLI_READS,
                            HTTP_THREADS, HTTP_READS_PER_THREAD)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if cli["launches"] <= 0:
        raise AssertionError("the CLI's server launched no kernel")
    log({"phase": "cli", "start_line": cli["start_line"],
         "degraded_binds": cli["degraded_binds"],
         "reduced": {"volume_bytes": CLI_VOLUME_BYTES,
                     "from": "30,000 MB default volume size limit",
                     "why": "run time limit; the cluster phase covers "
                            "the CLI at 2 GiB"},
         "launches": cli["launches"],
         "start_seconds": cli["start_seconds"],
         "stop_seconds": cli["stop_seconds"],
         "degraded_get_ms": percentiles(cli["latency_s"]),
         "degraded_get_ms_8_clients": percentiles(
             cli["latency_8_clients_s"])})

    work = tempfile.mkdtemp(prefix="chip_smoke-cluster-",
                            dir=_build.BUILD_DIR)
    try:
        log({"phase": "cluster", "reduced": [
            {"volume_bytes": VOLUME_BYTES,
             "from": "30,000 MB default volume size limit (weed master "
                     "-volumeSizeLimitMB)",
             "why": "run time limit"},
            {"pulse_seconds": 0.5,
             "from": "5 s default heartbeat pulse (weed master/volume "
                     "-pulseSeconds)",
             "why": "the master drops a killed server after ten pulses: "
                    "5 s in place of 50 s"},
            {"coordinator_seconds": 1.0,
             "from": "weed master -coordinatorSeconds 0 (off) by default; "
                     "the loop's interval falls back to 15 s",
             "why": "the drill needs the coordinator on; one cycle a "
                    "second in place of 15 s"},
            {"metrics_aggregation_seconds": 1.0,
             "from": "weed master -metricsAggregationSeconds 0 (scrape "
                     "on demand) by default",
             "why": "a scrape a second lets the coordinator count a "
                    "killed server as down before the master drops it"}]})
        cluster = run_cluster_phase("tpu", work, VOLUME_BYTES,
                                    DEGRADED_READS, HTTP_THREADS,
                                    HTTP_READS_PER_THREAD, DECODED_READS,
                                    VAC_BYTES)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cluster_launches = sum(s.get("launches", 0)
                           for s in cluster["servers"].values())
    vac = cluster["vacuum"]
    log({"phase": "vacuum_done", "reduced": {
        "volume_bytes": VAC_BYTES,
        "from": "30,000 MB default volume size limit (weed master "
                "-volumeSizeLimitMB)",
        "why": "run time limit"},
        "needles": vac["needles"], "written_bytes": vac["written_bytes"],
        "deleted_needles": vac["deleted_needles"],
        "deleted_bytes": vac["deleted_bytes"],
        "garbage_ratio": vac["garbage_ratio"],
        "bytes_before": vac["bytes_before"],
        "bytes_after": vac["bytes_after"],
        "replica_dat_sha256_equal": vac["replica_dat_sha256_equal"],
        "vacuum_s": vac["seconds"]["vacuum"], "reader": vac["reader"],
        "encode_s": vac["seconds"]["ec.encode"],
        "encode_generate_s": vac["seconds"]["encode_generate"],
        "encode_host": vac["encode_host"], "launches": vac["launches"],
        "launches_expected": vac["launches_expected"],
        "seconds": vac["seconds"], "nvidia_smi": card})
    ops = vac["volume_ops"]
    log({"phase": "volume_ops_done", "reduced": {
        "volume_bytes": ops["dat_bytes"],
        "from": "30,000 MB default volume size limit (weed master "
                "-volumeSizeLimitMB)",
        "why": "run time limit: the vacuum leg's compacted 001 volume"},
        "seconds": ops["seconds"], "dat_bytes": ops["dat_bytes"],
        "scan_GBps": {u: ops["dat_bytes"] / t / 1e9
                      for u, t in ops["seconds"]["scan"].items()},
        "fix_replication_GBps": ops["dat_bytes"]
        / ops["seconds"]["fix_replication"] / 1e9,
        "corrupt": ops["corrupt"], "fix_replication": ops["fix_replication"],
        "move": ops["move"], "layouts": ops["layouts"],
        "replicas": ops["replicas"], "nvidia_smi": card})
    log({"phase": "traced_gets", **cluster["traced_gets"],
         "seconds": cluster["seconds"]["traced_gets"],
         "get_passes": cluster["get_passes"],
         "spans": cluster["traced_spans"],
         "gets_ms": {k: v for k, v in cluster["gets_ms"].items()},
         "nvidia_smi": card})
    eight = f"{HTTP_THREADS}_clients"
    log({"phase": "profile", **cluster["profile"], "get_passes": {
        k: cluster["get_passes"][k] for k in (
            f"{eight}_after_again", f"{eight}_profiled",
            f"{eight}_traced_again", f"{eight}_traced_profiled")},
        "nvidia_smi": card})
    log({"phase": "journal", **cluster["drill"]["journal"],
         "rot_repair": cluster["drill"]["rot_repair"], "nvidia_smi": card})
    log({"phase": "alerts", **cluster["alerts"], "nvidia_smi": card})
    drain = cluster["drain"]
    log({"phase": "evacuate_done", "reduced": {
        "volume_bytes": VOLUME_BYTES,
        "from": "30,000 MB default volume size limit (weed master "
                "-volumeSizeLimitMB)",
        "why": "run time limit"},
        "seconds": drain["seconds"], "drained": drain["drained"],
        "moved_shards": len(drain["drained"]["moves"]),
        "moved_gets": drain["moved_gets"],
        "moved_gets_ms": drain["moved_gets_ms"],
        "deleted_shard": drain["deleted_shard"], "nvidia_smi": card})
    s = cluster["seconds"]
    log({"phase": "cluster_done", "needles": cluster["needles"],
         "degraded_binds": cluster["degraded_binds"],
         "upload_bytes": cluster["upload_bytes"],
         "dat_bytes": cluster["dat_bytes"],
         "upload_MBps": cluster["upload_bytes"] / s["upload"] / 1e6,
         "encode_GBps": cluster["dat_bytes"] / s["encode_generate"] / 1e9,
         "seconds": s, "gets_ms": cluster["gets_ms"],
         "scrub": cluster["scrub"],
         "rot_to_heal_s": cluster["drill"]["rot_to_heal_s"],
         "kill_to_heal_s": cluster["drill"]["kill_to_heal_s"],
         "drill": cluster["drill"],
         "rebuild_launches": cluster["rebuild_launches"],
         "servers": cluster["servers"], "launches": cluster_launches,
         "first_b_ms": cluster["first_b_ms"], "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-failover-",
                            dir=_build.BUILD_DIR)
    try:
        fo = run_failover_phase("tpu", work, FAILOVER_BYTES, HTTP_THREADS,
                                delay_s=FAILOVER_DELAY_S)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failover_launches = sum(s["launches"] for s in fo["servers"].values())
    log({"phase": "failover", "degraded_binds": fo["degraded_binds"],
         "reduced": [
        {"volume_bytes": FAILOVER_BYTES,
         "from": "30,000 MB default volume size limit (weed master "
                 "-volumeSizeLimitMB)",
         "why": "run time limit"},
        {"pulse_seconds": 0.5, "coordinator_seconds": 1.0,
         "metrics_aggregation_seconds": 1.0,
         "from": "weed master/volume -pulseSeconds 5, -coordinatorSeconds "
                 "and -metricsAggregationSeconds 0 (off)",
         "why": "as the cluster phase: the drill needs the coordinator "
                "and the alert loop on"}],
        "budgets": FAILOVER_BUDGETS, "checks": fo["checks"],
        "election_time_s": fo["election_time_s"],
        "assign_after_kill_s": fo["assign_after_kill_s"],
        "assign_from_kill_s": fo["assign_from_kill_s"],
        "journal_loss_count": fo["journal_loss_count"],
        "pre_kill_events": fo["pre_kill_events"],
        "repair_replan_s": fo["repair_replan_s"],
        "injected_delay_s": fo["injected_delay_s"],
        "new_leader_injected_delay_s": fo["new_leader_injected_delay_s"],
        "repair_replan_less_delay_s": fo["repair_replan_less_delay_s"],
        "attribution": fo["attribution"], "repair": fo["repair"],
        "rebuilt_shard": fo["rebuilt_shard"], "launches": fo["launches"],
        "faults_injected": fo["faults_injected"],
        "seconds": fo["seconds"], "needles": fo["needles"],
        "upload_bytes": fo["upload_bytes"], "servers": fo["servers"],
        "nvidia_smi": card})
    log({"phase": "failover_raft", "cluster_raft": fo["cluster_raft"],
         "cluster_status": fo["cluster_status"], "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-dataplane-",
                            dir=_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        dp = run_dataplane_phase("tpu", work, BENCH_N, BENCH_SIZE,
                                 BENCH_CLIENTS, BENCH_ZIPF, BENCH_DEGRADED,
                                 BENCH_THREADED_WRITES,
                                 batch_needles=BATCH_NEEDLES,
                                 batch=BATCH_SIZE)
        dp["seconds"]["phase"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dataplane_launches = dp["launches"]
    if dataplane_launches <= 0:
        raise AssertionError("the dataplane phase launched no kernel")
    log({"phase": "dataplane", "reduced": [
        {"n": BENCH_N, "from": "weed benchmark -n 1048576 (upstream "
                               "weed/command/benchmark.go); 100,000 "
                               "before the framed passes came",
         "why": "run time limit: the script aims at half of its 1200 s "
                "with the framed-TCP passes in"},
        {"zipf_reads": BENCH_ZIPF, "threaded_writes": BENCH_THREADED_WRITES,
         "from": "50,000 and 10,000 (n / 2 and n / 10) before",
         "why": "cut with n"},
        {"fill_through_write_needle": STORE_NEEDLES // 16,
         "from": STORE_NEEDLES,
         "why": "the phase's 240 s budget: the other needles' records and "
                "index entries are encoded in bulk (bulk_fill), the bytes "
                "write_needle writes"},
        {"pulse_seconds": 0.5, "from": "5 s default heartbeat pulse",
         "why": "the master drops the stopped server after ten pulses"},
        {"fronts": ["reactor", "threaded"],
         "from": "reactor, threaded, reactor again (the second reactor "
                 "step's restart of five servers, read pass and Zipf pass)",
         "why": "run time limit: the scenarios leg on the telemetry "
                "phase's cluster came in, and the script stood at its "
                "1200 s limit"},
        {"degraded_fronts": ["reactor"],
         "from": "the degraded passes on the reactor, then again on the "
                 "threaded front (a restart of the four survivors)",
         "why": "run time limit: with the leg in and only the first cut, "
                "the script ran past 1000 s on an H100 at 700 W (1145 s "
                "when its last phase stopped; its dataplane 192 s, the "
                "threaded re-run 23 s of it)"}],
        "shapes": {"size": BENCH_SIZE, "c": BENCH_CLIENTS,
                   "replication": "000", "collection": "benchmark",
                   "zipf": {"reads": BENCH_ZIPF, "theta": 0.99},
                   "degraded_gets": BENCH_DEGRADED,
                   "threaded_writes": BENCH_THREADED_WRITES,
                   "batch": {"needles": BATCH_NEEDLES,
                             "per_request": BATCH_SIZE}},
        "degraded_binds": dp["degraded_binds"],
        "volumes": dp["volumes"], "needles_by_volume": dp["needles_by_volume"],
        "largest_volume": dp["vid"], "volume_fids": dp["volume_fids"],
        "stopped_server": dp["victim"], "lost_shards": dp["lost_shards"],
        "lost_data_shards": dp["lost_data_shards"],
        "seconds": dp["seconds"], "nvidia_smi": card})
    for front, fr in dp["fronts"].items():
        log({"phase": f"dataplane_{front}", "front": front,
             **{k: v for k, v in fr.items()
                if not k.startswith("degraded_")},
             "degraded": {k[len("degraded_"):]: v for k, v in fr.items()
                          if k.startswith("degraded_")},
             "nvidia_smi": card})
    for front, tcp in dp["tcp"].items():
        log({"phase": f"dataplane_tcp_{front}", "front": front, **tcp,
             "seconds": dp["seconds"][f"tcp_{front}"], "nvidia_smi": card})
    log({"phase": "dataplane_batch", "front": "reactor", **dp["batch"],
         "wall_s": dp["seconds"]["batch"], "nvidia_smi": card})
    log({"phase": "dataplane_done", "launches": dataplane_launches,
         "launches_rule": sum(fr[k]["launches_rule"]
                              for fr in dp["fronts"].values()
                              for k in fr if k.startswith("degraded_")),
         "kernel_max_abs_err": worst, "bytes_equal": True,
         "encode": dp["encode_out"], "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-store-",
                            dir=_build.BUILD_DIR)
    try:
        zero_counts()
        store = run_volume_store_phase(
            "cuda", work, STORE_NEEDLES, STORE_SIZE, STORE_BATCH_DELETES,
            STORE_MISSING, STORE_GC_THREADS, STORE_GC_PER_THREAD, STORE_MORE,
            STORE_MORE_DELETES, STORE_DEGRADED,
            follower_seed=STORE_FOLLOWER_SEED)
        counts["volume_store"] = read_counts()
        store_counted = gf_matmul.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    store_launches = store["launches"]
    if store_launches <= 0:
        raise AssertionError("the volume_store phase launched no kernel")
    log({"phase": "volume_store", "reduced": [
        {"needles": STORE_NEEDLES, "needle_bytes": STORE_SIZE,
         "dat_bytes": store["dat_bytes"],
         "from": "30,000 MB default volume size limit (weed master "
                 "-volumeSizeLimitMB); weed benchmark -n 1048576 -size "
                 "1024 (upstream weed/command/benchmark.go)",
         "why": "one volume as a writer fills it, at benchmark's default "
                "count: the run's time limit"},
        {"backup_first_pass_needles": STORE_NEEDLES - STORE_FOLLOWER_SEED,
         "from": STORE_NEEDLES,
         "why": "the phase's 240 s budget: the follower starts from a "
                "file copy of the first three quarters, so the first "
                "backup pass applies the last quarter and the batch "
                "deletes"},
        {"fill_through_write_needle": STORE_NEEDLES // 16,
         "from": STORE_NEEDLES,
         "why": "the phase's 240 s budget: the other needles' records and "
                "index entries are encoded in bulk (bulk_fill), the bytes "
                "write_needle writes"},
        {"pulse_seconds": 0.5, "from": "5 s default heartbeat pulse",
         "why": "the master locates the mounted volume within a second"}],
        "seconds": store["seconds"],
        "budget_s": STORE_BUDGET_S,
        "within_budget": store["seconds"]["phase"] <= STORE_BUDGET_S,
        "dat_bytes": store["dat_bytes"], "idx_bytes": store["idx_bytes"],
        "fill_write_needle_per_s": store["fill_write_needle_per_s"],
        "open": {k: {x: d[x] for x in ("open_s", "rss_bytes_per_needle",
                                       "live", "counters")}
                 for k, d in store["open"].items()},
        "nvidia_smi": card})
    log({"phase": "volume_store_admin", "batch_delete": store["batch_delete"],
         "stats": store["stats"], "group_commit": store["group_commit"],
         "nvidia_smi": card})
    log({"phase": "volume_store_tools", "backup": store["backup"],
         "fix": store["fix"], "export": store["export"],
         "upload": store["upload"], "nvidia_smi": card})
    log({"phase": "volume_store_done", "seal": store["seal"],
         "launches": store_launches,
         "compare_launches": store_counted - store_launches,
         "kernel_max_abs_err": store["kernel_max_abs_err"],
         "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-secure-",
                            dir=_build.BUILD_DIR)
    try:
        sec = run_secure_tier_phase("tpu", work, SECURE_BYTES,
                                    SECURE_THREADS, SECURE_TIER_GETS,
                                    SECURE_DEGRADED)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secure_launches = sec["launches"]
    if secure_launches <= 0:
        raise AssertionError("the secure_tier phase launched no kernel")
    log({"tls": sec["tls"]})
    log({"phase": "secure_tier", "reduced": [
        {"volume_bytes": SECURE_BYTES,
         "from": "30,000 MB default volume size limit (weed master "
                 "-volumeSizeLimitMB)",
         "why": "run time limit: the phase aims near 120 s"},
        {"pulse_seconds": 0.5, "from": "5 s default heartbeat pulse",
         "why": "the master sees the new volume and the shard moves within "
                "a second"}],
        "tls": sec["tls"], "refused": sec["refused"],
        "needles": sec["needles"], "dat_bytes": sec["dat_bytes"],
        "write_MBps": sec["write_MBps"],
        "tier_upload_MBps": sec["tier_upload_MBps"],
        "tier_download_MBps": sec["tier_download_MBps"],
        "get_ms": sec["get_ms"],
        "degraded_split_ms": sec["degraded_split_ms"],
        "ec_encode_s": sec["seconds"]["ec_encode"],
        "encode_tiered": sec["encode_tiered"],
        "tier_upload_line": sec["tier_upload_line"],
        "dat_sha256_equal_after_recall": sec["dat_sha256_equal_after_recall"],
        "seal": sec["seal"], "launches": secure_launches,
        "servers": sec["servers"], "seconds": sec["seconds"],
        "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-native-",
                            dir=_build.BUILD_DIR)
    try:
        nat = run_native_plane_phase("tpu", work, BENCH_N, BENCH_SIZE,
                                     BENCH_CLIENTS, BENCH_ZIPF,
                                     NATIVE_DEGRADED,
                                     NATIVE_FIVE_BYTE_NEEDLES)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    native_launches = nat["launches"]
    if native_launches <= 0:
        raise AssertionError("the native_plane phase launched no kernel")
    log({"phase": "native_plane", "reduced": [
        {"n": BENCH_N, "from": "weed benchmark -n 1048576 (upstream "
                               "weed/command/benchmark.go)",
         "why": "run time limit: the dataplane phase's cut, so the two "
                "compare within one run"},
        {"zipf_reads": BENCH_ZIPF, "from": "n / 2, as the dataplane phase",
         "why": "cut with n"},
        {"pulse_seconds": 0.5, "from": "5 s default heartbeat pulse",
         "why": "the master sees the shard moves within a second"}],
        "shapes": {"size": BENCH_SIZE, "c": BENCH_CLIENTS,
                   "replication": "000", "collection": "benchmark",
                   "zipf": {"reads": BENCH_ZIPF, "theta": 0.99},
                   "degraded_gets": NATIVE_DEGRADED,
                   "five_byte_needles": NATIVE_FIVE_BYTE_NEEDLES},
        "zlib_h": nat["zlib_h"], "degraded_binds": nat["degraded_binds"],
        "budget_s": NATIVE_BUDGET_S,
        "within_budget": nat["seconds"]["phase"] <= NATIVE_BUDGET_S,
        "seconds": nat["seconds"], "volumes": nat["volumes"],
        "needles_by_volume": nat["needles_by_volume"],
        "http_assigns_during_write": nat["http_assigns_during_write"],
        "counts": nat["counts"], "cpu_s": nat["cpu_s"], "nvidia_smi": card})
    reactor_tcp = dp["tcp"]["reactor"]
    log({"phase": "native_plane_passes", "passes": {
        k: {x: v[x] for x in ("n", "ops_per_s", "p50_ms", "p99_ms",
                              "mismatches")}
        for k, v in nat["passes"].items()},
        "tcp_over_dataplane_tcp_reactor": {
            k: nat["passes"][f"tcp_{k}"]["ops_per_s"]
            / reactor_tcp[k]["ops_per_s"] for k in ("write", "read", "zipf")},
        "nvidia_smi": card})
    log({"phase": "native_plane_done", "vid": nat["vid"],
         "volume_fids": nat["volume_fids"], "dat_bytes": nat["dat_bytes"],
         "encode_launches": nat["encode_launches"],
         "encode_rule": nat["encode_rule"], "encode": nat["encode_out"],
         "data_shards_equal_dat": nat["data_shards_equal_dat"],
         "parity_equal_plain": nat["parity_equal_plain"],
         "degraded": nat["degraded"], "five_byte": nat["five_byte"],
         "launches": native_launches, "bytes_equal": True,
         "nvidia_smi": card})

    work = tempfile.mkdtemp(prefix="chip_smoke-telemetry-",
                            dir=_build.BUILD_DIR)
    try:
        tel = run_telemetry_phase(
            "tpu", work, BENCH_N, BENCH_SIZE, BENCH_CLIENTS, TELEMETRY_A,
            TELEMETRY_B, halflife_s=TELEMETRY_HALFLIFE_S,
            event_timeout=TELEMETRY_EVENT_S,
            gets_overhead=TELEMETRY_OVERHEAD)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    telemetry_launches = tel["launches"]
    if telemetry_launches <= 0:
        raise AssertionError("the telemetry phase launched no kernel")
    log({"phase": "telemetry", "reduced": [
        {"n": BENCH_N, "from": "weed benchmark -n 1048576 (upstream "
                               "weed/command/benchmark.go)",
         "why": "run time limit: the dataplane phase's cut"},
        {"heat_halflife_s": TELEMETRY_HALFLIFE_S,
         "from": "weed volume -heat.halflife 30 (the default)",
         "why": "the flash crowd shows within seconds, not minutes"},
        {"pulse_seconds": 0.5, "metrics_aggregation_seconds": 1.0,
         "from": "5 s default heartbeat pulse; -metricsAggregationSeconds "
                 "0 (evaluate on demand)",
         "why": "the alert loop evaluates each second, as a paged cluster "
                "would"}],
        "shapes": {"size": BENCH_SIZE, "c": BENCH_CLIENTS,
                   "replication": "000", "collection": "benchmark",
                   "pass_a": {"gets": TELEMETRY_A, "zipf_theta": 0.99},
                   "pass_b": {"gets": TELEMETRY_B, "degraded": True},
                   "overhead": {"gets": TELEMETRY_OVERHEAD,
                                "accounting": ["on", "off", "on"]},
                   "sample": 1.0},
        "budget_s": TELEMETRY_BUDGET_S,
        "within_budget": tel["seconds"]["phase"]
        - tel["seconds"]["scenarios"] <= TELEMETRY_BUDGET_S,
        "seconds": tel["seconds"], "degraded_binds": tel["degraded_binds"],
        "needles_by_volume": tel["needles_by_volume"],
        "ec_volume": tel["ec_volume"], "checks": tel["checks"],
        "zipf": tel["zipf"], "nvidia_smi": card})
    log({"phase": "telemetry_passes", "write": {
        k: tel["write"][k] for k in ("ops_per_s", "p50_ms", "p99_ms")},
        "pass_a": tel["pass_a"], "pass_b": tel["pass_b"],
        "overhead": tel["overhead"], "nvidia_smi": card})
    log({"phase": "telemetry_done", "launches": telemetry_launches,
         "record": tel["record"], "export_lines": tel["export_lines"],
         "shell_lines": tel["shell_lines"], "kernel_max_abs_err": worst,
         "nvidia_smi": card})
    scn = tel["scenarios"]
    log({"phase": "scenarios", "on": "the telemetry phase's cluster, after "
                                    "its overhead passes",
         "reduced": [
             {"replay_s": SCENARIOS_REPLAY_S, "clients": SCENARIOS_CLIENTS,
              "from": "the recording's own window at speed 1",
              "why": "run time limit"},
             {"probe_step_s": SCENARIOS_STEP_S,
              "from": "capacity.probe -step 2 (the default)",
              "why": "run time limit"}],
         "seconds": scn["seconds"]["leg"], "walls": scn["seconds"],
         "budget_s": SCENARIOS_BUDGET_S,
         "within_budget": scn["seconds"]["leg"] <= SCENARIOS_BUDGET_S,
         "profile": scn["profile"], "replay": scn["replay"],
         "slo": scn["slo"], "capacity": scn["capacity"],
         "parked_equal": scn["parked_equal"],
         "health_line": scn["health_line"],
         "write_split": scn["write_split"], "launches": scn["launches"],
         "nvidia_smi": card})

    dp_widths: dict[str, int] = {}
    for fr in dp["fronts"].values():
        for k, v in fr.items():
            if k.startswith("degraded_"):
                for c, n in v["launch_widths"].items():
                    dp_widths[c] = dp_widths.get(c, 0) + n
    counts["dataplane_degraded_gets"] = {"widths": dp_widths}
    tel_exact: Counter = Counter()
    for run in [tel["pass_b"], *tel["overhead"]]:
        tel_exact.update(run["exact_widths"])
    counts["telemetry_degraded_gets"] = {
        "widths": width_classes(tel_exact), "exact": dict(tel_exact)}
    log({"phase": "launch_widths", "counts": counts, "nvidia_smi": card})
    # the width most degraded GETs launch at: the volume_store phase's
    # 1 KiB needles, read in this process, its most common narrow width
    read_width = next((w for w, _ in counts["volume_store"]["common_widths"]
                       if w <= 64 << 10), None)
    if read_width is None:
        raise AssertionError("the volume_store phase launched no narrow "
                             f"kernel: {counts['volume_store']}")
    cases = dict(kernel_cases())
    floor = launch_floor_ms()
    shapes = [
        kernel_numbers("encode", cases["parity-10.4-vandermonde"], 8 << 20),
        kernel_numbers("rebuild", cases["decode-4-vandermonde"], 8 << 20),
        kernel_numbers("degraded_read", cases["decode-4-vandermonde"],
                       1 << 20),
        kernel_numbers("degraded_read", cases["decode-4-vandermonde"],
                       64 << 10),
        kernel_numbers("degraded_get", cases["decode-4-vandermonde"],
                       read_width)]
    table = table_numbers(cases["parity-10.4-vandermonde"])
    log({"phase": "kernel_shapes", "shapes": shapes, "launch_floor": floor,
         "table_build": table, "degraded_get_width": read_width,
         "launch_widths": {k: v["widths"] for k, v in counts.items()},
         "nvidia_smi": card})
    main_shape = shapes[0]
    in_process = ("main_path", "resume", "trace_ab", "mesh", "http_path",
                  "volume_store")
    log({"kernels": [{
        "name": "gf_matmul", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/gf_matmul.py:85",
        "launches": launches + resume_launches + trace_ab_launches
        + http_launches + cli["launches"] + cluster_launches
        + failover_launches + dataplane_launches + store_launches
        + secure_launches + native_launches + mesh_launches
        + telemetry_launches,
        "max_abs_err": max(worst, store["kernel_max_abs_err"],
                           *(s["max_abs_err"] for s in shapes)),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None}, {
        # the tables kernel 1 reads; the builds of this process's paths
        # (the CLI's servers build theirs in their own processes)
        "name": "gf_table_build", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/gf_matmul.py:85",
        "launches": sum(counts[k]["gf_table_build"] for k in in_process),
        "max_abs_err": max(worst, table["max_abs_err"]),
        "ms": table["ms"], "plain_ms": table["plain_ms"],
        "bound_ms": table["bound_ms"], "bound_by": table["bound_by"],
        "library_ms": None}]})
    log({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
