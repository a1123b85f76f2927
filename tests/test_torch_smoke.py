"""Rehearse chip_smoke.py on the CPU at a tiny size: the same phases and
checks as the run on the card, through the plain versions.  The card run
itself (``python3 chip_smoke.py``) has no CPU mode."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's float matmul would take every core; the suite
    runs several workers side by side, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kernel_phase_on_cpu():
    assert chip_smoke.check_kernel("cpu", [1, 7, 4096]) == 0


def test_kernel_counts_on_cpu():
    """The script's per-phase counts: zeroed, then read after a path; CPU
    tensors count no launch, no table build and no width."""
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul

    chip_smoke.zero_counts()
    m = torch.from_numpy(chip_smoke.kernel_cases()[0][1].copy())
    gf_matmul(m, torch.zeros((10, 1064), dtype=torch.uint8))
    assert chip_smoke.read_counts() == {
        "gf_matmul": 0, "gf_table_build": 0, "common_widths": [],
        "widths": {"<=4KiB": 0, "<=64KiB": 0, "<=1MiB": 0, ">1MiB": 0}}


def test_main_path_on_cpu(tmp_path):
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul

    before = gf_matmul.launches
    res = chip_smoke.run_main_path("cpu", str(tmp_path), 3 << 20, 1 << 20,
                                   64 << 10, reads=12, stripes=4)
    assert res["dat_bytes"] >= 3 << 20
    assert set(res["launches"]) == {"encode", "encode_large_rows", "rebuild",
                                    "degraded_read",
                                    "degraded_read_large_rows"}
    # CPU tensors run the plain version: no kernel launch is counted
    assert gf_matmul.launches == before
    assert len(res["read_latency_s"]) == min(12, res["needles"])
    assert res["stats"]["encode"]["dispatches"] >= 1
    assert res["stats"]["encode"]["drain_pool"] >= 1  # the drain threads
    assert set(res["hashes"]) == {f".ec{i:02d}" for i in range(14)} | {".eci"}
    # the resume phase on the same volume, at a dispatch narrow enough
    # for a checkpoint before the middle dispatch
    resume = chip_smoke.run_resume_phase("cpu", str(tmp_path), res["hashes"],
                                         dispatch_b=16 << 10)
    assert resume["dispatches"] >= 16
    assert resume["stats"]["retries"] == 1 and resume["resume_byte"] > 0
    assert resume["stats"]["dispatches"] < resume["dispatches"]
    assert gf_matmul.launches == before
    # the trace A/B on the same volume: both encodes to the clean bytes
    # (checked inside), the traced one read by the analyzer
    ab = chip_smoke.run_trace_ab("cpu", str(tmp_path), res["hashes"])
    assert [r["mode"] for r in ab["runs"]] == ["off", "on", "on", "off"]
    assert [r["launches"] for r in ab["runs"]] == [0, 0, 0, 0]
    assert ab["span_names"]["pipeline.encode_file"] == 1
    assert ab["span_names"]["pipeline.dispatch"] == ab["dispatches"]
    assert ab["dropped"] == 0 and ab["spans"] > 4 * ab["dispatches"]
    assert set(ab["attribution"]["stage_s"]) >= {"setup", "fill", "dispatch",
                                                 "write", "close"}
    assert ab["attribution"]["degraded"] is False
    assert set(ab["span_cost_us"]) == {"disabled", "enabled", "sampled"}
    from seaweedfs_tpu_torch.observability import get_tracer

    assert get_tracer().enabled is False and not get_tracer().snapshot()


def test_trace_ab_reads_only_its_own_encode(tmp_path):
    """Rot counted earlier in the process (another test's scrub) must not
    mark the trace A/B's clean encodes degraded: analyze() gets the
    integrity counters' change over the traced encode."""
    from seaweedfs_tpu_torch.stats import ec_integrity_metrics

    res = chip_smoke.run_main_path("cpu", str(tmp_path), 3 << 20, 1 << 20,
                                   64 << 10, reads=2, stripes=4)
    ec_integrity_metrics().corrupt_shards.inc("scrub")
    ec_integrity_metrics().repairs.inc("repaired")
    ab = chip_smoke.run_trace_ab("cpu", str(tmp_path), res["hashes"])
    assert ab["attribution"]["degraded"] is False


def test_http_path_on_cpu(tmp_path):
    from seaweedfs_tpu_torch.ops.gf_matmul import gf_matmul

    before = gf_matmul.launches
    res = chip_smoke.run_http_path("cpu", str(tmp_path), 2 << 20, reads=12,
                                   threads=3, per_thread=4, decoded_reads=5,
                                   stripes=3, overload_threads=8,
                                   overload_per_thread=8,
                                   overload_max_inflight=2)
    assert res["dat_bytes"] >= 2 << 20
    assert set(res["launches"]) == {"encode", "rebuild", "degraded_get",
                                    "overload", "scrub_repair"}
    # the overload leg: 503s, the shed counter and shed_total agreed and
    # the admitted GETs' reconstructions were counted (checked inside)
    over = res["overload"]
    assert over["gets"] == 64 and over["admitted"] + over["shed"] == 64
    assert over["admitted"] > 0 and over["shed"] > 0
    assert over["reconstructed"] > 0 and over["launches"] == 0
    assert 1 <= over["load_shed_events"] <= int(over["storm_s"]) + 1
    assert over["monitor_polls"] > 0 and over["deadline_504"]
    assert set(over["over_1s"]) == {"admitted", "shed"}
    # the storm paged: requests_shed_increase fired with the 503s seen,
    # and the shortened copy resolved (checked inside)
    assert over["shed_alert"]["state"] == "firing"
    assert over["shed_alert"]["value"] == over["shed"]
    assert over["brief_rule_resolved"]
    assert not os.path.exists(tmp_path / "overload")
    scrub = res["scrub"]
    assert scrub["verdict"]["status"] == "repaired"
    assert scrub["verdict"]["corrupt_shards"] == [3, 12]
    assert scrub["blocks"] > 0 and scrub["gets_during_repair"] > 0
    assert gf_matmul.launches == before  # the plain version launches nothing
    assert len(res["latency_1_client_s"]) == min(12, res["needles"])
    assert len(res["latency_8_clients_s"]) == 12
    # the decoded volume is back on disk; the shards stay until deleted
    assert os.path.exists(tmp_path / "1.dat") and os.path.exists(
        tmp_path / "1.ec13")


def test_cli_phase_on_cpu(tmp_path):
    res = chip_smoke.run_cli_phase("cpu", str(tmp_path), 1 << 20, reads=4,
                                   threads=2, per_thread=3)
    assert "ec on cpu" in res["start_line"]
    assert len(res["latency_s"]) == 4 and res["stop_seconds"] < 10
    assert len(res["latency_8_clients_s"]) == 6
    assert res["launches"] == 0  # the plain version launches nothing


def test_cluster_phase_on_cpu(tmp_path):
    """The master, five volume servers and the shell through the CLI, on
    the plain versions: the vacuum leg with the volume shell's leg, then
    upload, ec.encode, a SIGKILLed holder, degraded GETs of both classes,
    the location watch's leg (master.follower, a keep-connected client),
    ec.rebuild, a rotted shard that ec.scrub -all quarantines and
    ec.rebuild heals, the coordinator's drill (a second rot and a second
    SIGKILLed server healed with no shell command), the drain of a third
    server (evacuate, leave, GETs, a deleted moved shard), ec.decode."""
    res = chip_smoke.run_cluster_phase(
        "cpu", str(tmp_path), 12 << 20, reads=16, threads=3, per_thread=5,
        decoded_reads=6, vac_bytes=6 << 20, pulse_seconds=0.3)
    assert res["dat_bytes"] >= 12 << 20
    # the vacuum leg: both replicas shrank, the reader crossed the
    # vacuum, the plain versions launched nothing on the encode host
    vac = res["vacuum"]
    assert min(vac["garbage_ratio"].values()) >= 0.3
    assert len(vac["bytes_after"]) == 2
    assert all(vac["bytes_after"][u] < vac["bytes_before"][u]
               for u in vac["bytes_after"])
    assert vac["reader"]["gets_during_vacuum"] > 0
    assert vac["launches"] == vac["launches_expected"] == 0
    assert sum(vac["ec_remote_reads"].values()) > 0
    # the volume shell on the compacted volume (its checks are inside)
    ops = vac["volume_ops"]
    assert ops["fix_replication"]["sha256_equal"]
    assert ops["move"]["reader"]["gets_during_move"] > 0
    assert ops["layouts"] == {"001": (True, True), "000": (True, True)}
    for leg in ("fsck", "check_disk", "delete", "fix_replication", "move",
                "configure_000", "configure_001", "mark-readonly",
                "mark-writable"):
        assert ops["seconds"][leg], leg
    for leg in ("volume_ops", "ec.decode", "collection.delete"):
        assert vac["seconds"][leg] > 0, leg
    # the drain: every shard of the drained server moved and kept its
    # bytes, GETs of a moved shard deleted on its new holder rebuilt there
    drain = res["drain"]
    assert sorted(drain["drained"]["moves"]) == drain["drained"]["shards"]
    assert drain["moved_gets"] > 0
    assert drain["deleted_shard"]["gets"] > 0
    assert drain["deleted_shard"]["launches"] == 0  # the plain versions
    for leg in ("evacuate", "leave", "leave_to_drop", "stop", "ec.rebuild"):
        assert drain["seconds"][leg] >= 0, leg
    assert {"a_1_client", "b_1_client", "a_3_clients",
            "b_3_clients"} <= set(res["gets_ms"])
    # the location watch: the follower's lookups were the master's, and
    # the keep-connected client's degraded GETs asked the master once
    fol = res["follower"]
    assert fol["start_line"].startswith("master.follower on")
    assert fol["gets"] > 0 and fol["lost_intervals"] >= fol["gets"]
    assert fol["master_lookups_during_gets"] <= 1
    assert fol["launches"] == {}  # the plain versions
    assert str(fol["plain"]["vid"]) in fol["lookups"]
    for leg in ("upload", "ec.encode", "encode_generate", "encode_spread",
                "drop", "ec.rebuild", "rebuild_copy", "rebuild_rebuild",
                "rebuild_spread", "ec.scrub", "ec.rebuild_after_scrub",
                "ec.scrub_again", "ec.decode"):
        assert res["seconds"][leg] >= 0, leg
    roles = [r for s in res["servers"].values() for r in s["roles"]]
    assert sorted(r for r in roles if r != "coordinator_repair") == [
        "drained", "encode", "killed", "killed", "rebuild", "rotted"]
    assert "coordinator_repair" in roles  # a repair host that lived on
    drill = res["drill"]
    assert drill["rot_to_heal_s"] > 0 and drill["kill_to_heal_s"] > 0
    assert drill["coordinator"]["repairs"]["done"] >= 2
    assert drill["coordinator"]["repairs"]["failed"] == 0
    assert drill["rot_repair"]["rescrubbed"]
    # each heal's repairs, by host, with the launches read live around it
    # (the plain versions launch none, as the typed rebuilds did)
    assert res["rebuild_launches"] == [0, 0]
    for window in ("rot", "loss"):
        ran = drill["repair_launches"][window]
        assert sum(h["repairs"] for h in ran.values()) >= 1, window
        assert all(h["launches"] == 0 for h in ran.values()), window
    # the master's log line of each repair carries its legs
    assert [set(r) for r in drill["repair_legs"]] == \
        [{"host", "copy", "rebuild", "spread"}] * 2
    # the host that saw the rot keeps the detection counters, so health
    # stays degraded until it is gone
    assert drill["health_after_rot"]["degraded"] is True
    assert set(drill["health_after_rot"]["nonzero"]) <= {"corrupt_shards",
                                                         "scrub_repairs"}
    for leg in ("ec.scrub", "rot_to_sha256_equal", "kill_to_sha256_equal",
                "drop", "kill_to_health_clean", "kill_to_repair_planned",
                "loss_repair"):
        assert drill["seconds"][leg] >= 0, leg
    # every server counted exactly the remote reads and reconstructions
    # its GETs needed (checked inside); some of each happened
    alive = [s for s in res["servers"].values() if "killed" not in s["roles"]]
    assert sum(s["remote"] for s in alive) > 0
    assert sum(s["reconstructed"] for s in alive) > 0
    assert all(s["launches"] == 0 for s in alive)  # the plain versions
    assert res["scrub"]["host"] in res["servers"]
    assert res["scrub"]["healed_on"]
    # the traced GETs: every trace stitched and checked by class inside;
    # both classes' hops timed, and the untraced GETs' classes again
    traced = res["traced_gets"]
    assert traced["traces"] == 16 + 3 * 5
    assert traced["hops_ms"]["front"]["n"] == traced["traces"]
    for hop in ("lookup_ec", "remote_shard_read", "reconstruct"):
        assert traced["hops_ms"][hop]["n"] > 0, hop
    assert traced["hops_ms"]["outside_front"]["n"] == traced["traces"]
    assert all(s["ms"] >= s["front_ms"] for s in traced["slowest"])
    assert len(traced["slowest"]) == 5
    assert all(s["bounding_hop"] for s in traced["slowest"])
    assert {"a_1_client_traced", "b_1_client_traced", "a_3_clients_traced",
            "b_3_clients_traced", "a_3_clients_after"} <= set(res["gets_ms"])
    passes = res["get_passes"]
    assert list(passes) == ["1_client", "3_clients", "1_client_traced",
                            "3_clients_traced", "3_clients_after",
                            "3_clients_sampled_5pct",
                            "3_clients_traced_again",
                            "3_clients_after_again", "3_clients_profiled",
                            "3_clients_traced_profiled"]
    # the profiled passes are PROFILE_ROUNDS times as long
    rounds = chip_smoke.PROFILE_ROUNDS
    assert all(p["gets"] in ((16, 15) if "profiled" not in name
                             else (15 * rounds,))
               and p["cpu_s"]["master"] >= 0
               and 0 <= p["sys_s"]["master"] <= p["cpu_s"]["master"]
               for name, p in passes.items())
    # every traced period recorded spans; 5% of 15 GETs sample at most a
    # few, so that period holds mostly heartbeats and scrapes
    spans = res["traced_spans"]
    assert set(spans) == {"traced", "sampled_5pct", "traced_again"}
    assert spans["traced"] > spans["traced_again"] > 0
    assert spans["sampled_5pct"] > 0
    # each server's first class (b) GET against its later ones
    assert res["first_b_ms"] and all(v["first"] > 0
                                     for v in res["first_b_ms"].values())
    # the profile leg: the reconstructing server and the master sampled
    # through one untraced and one traced pass, the request plane clean
    prof = res["profile"]
    assert prof["server"] in res["servers"] and prof["hz"] == 100
    layers = set(chip_smoke.PROFILE_LAYERS)
    for mode in ("untraced", "traced"):
        for role in ("server", "master"):
            p = prof["profiles"][mode][role]
            assert p["stack_samples"] > 0 and p["top_leaves"], (mode, role)
            assert p["ticks"] > 0 and p["mean_depth"] > 1
            assert set(p["self_share"]) == layers | {"other"}
            assert set(p["under_share"]) == layers
            assert abs(sum(p["self_share"].values()) - 1) < 1e-9 or \
                p["busy_samples"] == 0
            assert 0 <= p["idle_share"] + p["socket_read_share"] <= 1
        # the server's request threads reconstructed and answered
        busy = prof["profiles"][mode]["server"]
        assert busy["under_share"]["httpd"] > 0
        assert busy["under_share"]["ec"] > 0
    assert set(prof["traced_minus_untraced"]) == {"server", "master"}
    assert set(prof["traced_minus_untraced"]["server"]["self_share"]) == \
        layers | {"other"}
    assert sum(prof["thread_census"].values()) > 3
    assert prof["sample_cost_us"] > 0
    assert prof["health"]["requests_shed"] == 0
    assert prof["health"]["deadline_exceeded"] == 0
    assert prof["heap"].startswith("tracemalloc just enabled")
    # the journal of the drill, checked in order inside
    journal = drill["journal"]
    assert [t for t, _ in journal["rot"][:4]] == [
        "shard_corrupt", "scrub_unrepairable", "repair_planned",
        "repair_done"]
    assert journal["rot_cause"] in ("shard_corrupt", "scrub_unrepairable")
    assert drill["rot_repair"]["cause_event"]
    assert "peer_stale" in [t for t, _ in journal["loss"]]
    assert journal["events_tail_lines"] >= 5
    # the alert plane (checked inside): the first fires timed, the rot's
    # alerts and bundles, the repairs' alerts, the captures by hand
    alerts = res["alerts"]
    first = alerts["first_fires"]
    assert set(first) == {"peer_down", "scrub_unrepairable",
                          "corrupt_shards_increase"}
    assert all(f["fault_to_fired_s"] >= 0 and f["fired_to_bundles_s"] >= 0
               for f in first.values())
    assert first["scrub_unrepairable"]["servers"] == [res["scrub"]["host"]]
    assert {"scrub_unrepairable", "corrupt_shards_increase"} <= \
        set(alerts["rot_firing"])
    assert alerts["rot_bundle_bytes"]
    assert alerts["rot_repair_alert"] == drill["rot_repair"]["alert"]
    assert alerts["rot_repair_alert"] in chip_smoke.REPAIR_ALERTS
    assert alerts["loss_repair_alert"] in chip_smoke.REPAIR_ALERTS
    hand = alerts["by_hand"]
    assert len(hand["captures"]) >= 3  # the master and the live servers
    assert all(c["bytes"] > 0 and c["wall_s"] > 0
               for c in hand["captures"].values())
    assert hand["alerts.capture_bundles"] == len(hand["captures"])
    assert hand["fault_points"].startswith("fault points: 16 registered")
    assert alerts["evaluation"]["mean_ms"] > 0
    assert alerts["evaluation"]["peers"] >= 3
    for k in ("rot_to_heal_s", "kill_to_heal_s"):
        assert alerts[k]["moved"] in ("within", "above", "below")
    assert isinstance(alerts["resolved"], list)


def test_secure_tier_phase_on_cpu(tmp_path):
    """The secure_tier phase at 24 MiB with ``-ec.engine cpu``: mTLS from
    openssl's certificates, the 401s, the tier round trip by sha256, the
    reference's failure for ec.encode of the tiered volume, the same
    round trip through the master's autoscaler (``volume.tier``), and one
    reconstruction per lost interval (the plain versions launch
    nothing)."""
    res = chip_smoke.run_secure_tier_phase("cpu", str(tmp_path), 24 << 20,
                                           threads=4, tier_gets=30,
                                           degraded=30)
    assert res["tls"] == "mtls"
    assert res["refused"] == {k: {"status": 401, "body": "missing jwt"}
                              for k in ("unsigned_put", "unsigned_delete",
                                        "get_without_read_token")}
    assert res["dat_sha256_equal_after_recall"]
    assert res["encode_tiered"] == (
        "ec.encode volume 1 FAILED: FileNotFoundError: [Errno 2] No such "
        "file or directory: '<work>/vs0/securetier_1.dat'")
    assert res["get_ms"]["tier"]["n"] == res["get_ms"]["local"]["n"] == 30
    seal = res["seal"]
    assert seal["gets"] == 30 and seal["lost_intervals"] > 0
    assert res["launches"] == seal["get_launches"] == 0
    # the plain versions launch nothing: every GET falls in no_launch
    assert res["degraded_split_ms"]["first_launch"] == {}
    assert res["degraded_split_ms"]["later_launches"] is None
    assert res["degraded_split_ms"]["no_launch"]["n"] == 30
    assert sum(s["reconstructed"] for s in res["servers"].values()) == \
        seal["lost_intervals"]
    assert [s["mmap"] for s in res["servers"].values()].count(True) == 1
    assert all("front threaded" in line for line in res["start_lines"])
    # the same volume tiered and recalled through the master's autoscaler
    tier = res["autoscale_tier"]
    assert [r["op"] for r in tier["records"]] == ["tier_pending", "tier_done"]
    assert tier["records"][0]["backend"] == "cold"
    assert tier["tier_line"].startswith("volume 1 tiered -> cold:")
    assert tier["reads"]["gets"] == res["needles"]
    assert tier["dat_sha256_equal_after_recall"]
    assert tier["totals"] == {"tiers": 1, "recalls": 1, "failures": 0}


def test_a_start_line_is_read_past_descriptor_1023(tmp_path):
    """A long-lived process (a test worker after many in-process
    clusters) holds descriptors past 1023, which select() refuses."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < 1200:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(hard, 4096), hard))
    held = [os.open(os.devnull, os.O_RDONLY) for _ in range(1100)]
    proc = subprocess.Popen(
        [sys.executable, "-c", "print('volume server listening on x')"],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.fileno() > 1023
        assert chip_smoke.read_start_line(
            proc, os.devnull, "volume server listening", 30) == \
            "volume server listening on x"
    finally:
        proc.wait()
        proc.stdout.close()
        for fd in held:
            os.close(fd)
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


def test_refuses_without_a_card_or_a_checkout(tmp_path):
    # no card here: exits non-zero, prints no result
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # alone in a directory, without the package beside it
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    r = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_split_first_launches_keeps_each_server_s_first_apart():
    """Three GETs on two servers: a's first launch, b's first with a's
    second, one GET that launched nothing."""
    marks = [{"a": 0, "b": 0}, {"a": 2, "b": 0}, {"a": 3, "b": 1},
             {"a": 3, "b": 1}]
    split = chip_smoke.split_first_launches([0.5, 0.25, 0.002], marks)
    assert split["first_launch"] == {"a": 500.0, "b": 250.0}
    assert split["later_launches"] is None
    assert split["no_launch"]["n"] == 1
    marks.append({"a": 4, "b": 1})
    split = chip_smoke.split_first_launches([0.5, 0.25, 0.002, 0.01], marks)
    assert split["later_launches"]["n"] == 1
    assert split["later_launches"]["p50"] == pytest.approx(10.0)


def _scenarios_inputs() -> dict:
    """A passing set of the scenarios leg's inputs, as the shell prints
    them: a recording of 4 GETs, the profile, replay and probe documents,
    the parked document and cluster.health's text."""
    recording = {"records": [
        {"route": "http_read", "path": p} for p in
        ("/3,01", "/3,01", "/3,01", "/4,02")] + [
        {"route": "lookup", "path": "/dir/lookup"}]}
    profile = {"records": 4, "read_fraction": 1.0, "zipf_s": 1.5,
               "top_keys": [["/3,01", 3], ["/4,02", 1]],
               "observed_rps": 40.0, "window_s": 0.1,
               "heat_zipf": {"s": 1.1, "distinct": 9}}
    check = {"check": "error_ratio", "ok": True, "value": 0.0,
             "bound": 0.02}
    replay = {"verdict": "pass", "total_ops": 320, "wall_s": 8.0,
              "spec": {"target_rps": 40.0, "hot_set": 8},
              "routes": {"read": {"rps": 40.0, "p50_ms": 1.0,
                                  "p99_ms": 2.0}},
              "checks": [check],
              "fidelity": [dict(check, check="fidelity_op_mix")]}
    probe = {"slo": {"max_p99_ms": 5.0, "max_error_ratio": 0.001},
             "probed_at": 1.0, "master": "m:1",
             "routes": {r: {"capacity_rps": 100.0 + i,
                            "capacity_target_rps": 100.0,
                            "capacity_p99_ms": 1.0, "knee_rps": 200.0,
                            "knee": {"reason": "p99 9.0ms > 5ms"},
                            "bounding": {"resource": "server"}}
                        for i, r in enumerate(chip_smoke.SCENARIOS_ROUTES)}}
    return {"recording": recording,
            "gets": Counter({"/3,01": 3, "/4,02": 1}),
            "profile": profile, "replay": replay, "probe": probe,
            "parked": dict(copy.deepcopy(probe), posted_at=2.0),
            "health": "peers: 3\ncapacity: http_read~100rps "
                      "native_read~101rps http_write~102rps (SLO p99<5ms, "
                      "probed 1s ago)\n", "step_s": 0.5}


def _break(inputs: dict, what: str) -> dict:
    bad = copy.deepcopy(inputs)
    if what == "records":
        bad["profile"]["records"] = 5
    elif what == "read_fraction":
        bad["profile"]["read_fraction"] = 0.75
    elif what == "top_key":
        bad["gets"]["/3,01"] = 2
    elif what == "heat":
        del bad["profile"]["heat_zipf"]
    elif what == "verdict":
        bad["replay"]["verdict"] = "degraded"
    elif what == "fidelity":
        bad["replay"]["fidelity"][0]["ok"] = False
    elif what == "no_fidelity":
        bad["replay"]["fidelity"] = []
    elif what == "capacity":
        bad["probe"]["routes"]["http_write"]["capacity_rps"] = 0.0
        bad["parked"] = dict(copy.deepcopy(bad["probe"]), posted_at=2.0)
    elif what == "route_error":
        bad["probe"]["routes"]["native_read"] = {"error": "unknown route"}
        bad["parked"] = dict(copy.deepcopy(bad["probe"]), posted_at=2.0)
    elif what == "parked":
        bad["parked"]["routes"]["http_read"]["capacity_rps"] = 1.0
    elif what == "health":
        bad["health"] = bad["health"].replace("native_read~101rps ", "")
    return bad


@pytest.mark.parametrize("what", [
    "records", "read_fraction", "top_key", "heat", "verdict", "fidelity",
    "no_fidelity", "capacity", "route_error", "parked", "health"])
def test_scenarios_leg_checks_fail_on_each_fault(what):
    """The scenarios leg's checks (chip_smoke.check_scenarios_leg): the
    passing set passes with its numbers, and each broken piece fails the
    leg."""
    good = _scenarios_inputs()
    res = chip_smoke.check_scenarios_leg(**good)
    assert res["profile"]["top_key_gets"] == 3
    assert res["replay"]["fidelity"] == {"fidelity_op_mix": [0.0, 0.02]}
    assert res["capacity"]["native_read"]["capacity_rps"] == 101.0
    assert res["capacity"]["http_read"]["knee"] == "p99 9.0ms > 5ms"
    # each step's requests (rate x 0.5 s): 100 or fewer make its p99 its
    # slowest one
    assert res["capacity"]["http_read"]["capacity_step_requests"] == 50
    assert res["capacity"]["http_read"]["knee_step_requests"] == 100
    assert res["capacity"]["http_read"]["p99_is_slowest"] == {
        "capacity_step_requests": True, "knee_step_requests": True}
    with pytest.raises(AssertionError):
        chip_smoke.check_scenarios_leg(**_break(good, what))


def test_locked_json_reads_the_document_between_the_lock_lines():
    doc = {"a": [1, 2], "b": {"c": "d"}}
    text = "locked\n" + json.dumps(doc, indent=2) + "\nunlocked"
    assert chip_smoke.locked_json(text) == doc
    with pytest.raises(AssertionError):
        chip_smoke.locked_json(json.dumps(doc))
