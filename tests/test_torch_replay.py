"""Trace-driven replay in the port (scenarios/replay.py, the shell's
workload.profile and workload.replay) against seaweedfs_tpu, on the CPU.

At tolerance 0, on the same seeded recordings (built as
tests/test_reqlog.py::TestFit builds them, and one export of the port's
own ``WorkloadJournal``): ``workload_records``, ``fit_size_mix``,
``recording_profile``, ``spec_from_recording`` and ``replay_fidelity``
(with and without a replay's result), and the two shell commands' text
and JSON.  Live: a port cluster on the CPU records a mixed workload,
exports it, and ``workload.replay -against`` its master passes with
every fidelity check ok; without the admin lock it is refused.
"""

from __future__ import annotations

import json
import random
import time

import pytest

from seaweedfs_tpu.scenarios import replay as ref_replay
from seaweedfs_tpu.shell import workload_commands as ref_wc
from seaweedfs_tpu_torch.observability import reqlog as port_reqlog
from seaweedfs_tpu_torch.scenarios import replay as port_replay
from seaweedfs_tpu_torch.shell import workload_commands as port_wc
from tests.conftest import free_port
from tests.test_torch_reqlog import reset_recorder

PACKAGES = {"ref": ref_replay, "port": port_replay}


def recording(n_reads=120, n_writes=30, n_deletes=10, zipf_s=1.2, keys=24,
              seed=5) -> dict:
    """tests/test_reqlog.py::TestFit's recording, seeded."""
    from seaweedfs_tpu_torch.scenarios import ZipfSampler

    rng = random.Random(seed)
    z = ZipfSampler(keys, zipf_s)
    records = []
    ts = 1000.0
    seq = 0
    for _ in range(n_reads):
        seq += 1
        ts += 0.01
        records.append({"id": f"s.{seq:x}", "seq": seq, "ts": ts,
                        "route": "http_read", "method": "GET",
                        "path": f"/1,{z.sample(rng):04x}",
                        "status": 200, "in": 0, "out": 4096,
                        "ms": 1.0, "ddl_s": 2.0})
    for i in range(n_writes):
        seq += 1
        ts += 0.01
        records.append({"id": f"s.{seq:x}", "seq": seq, "ts": ts,
                        "route": "http_write", "method": "POST",
                        "path": f"/2,{i:04x}", "status": 201,
                        "in": 4096 if i % 5 else 65536, "out": 30,
                        "ms": 2.0, "ddl_s": 2.0,
                        "handler": "submit" if i % 2 else "upload"})
    for i in range(n_deletes):
        seq += 1
        ts += 0.01
        records.append({"id": f"s.{seq:x}", "seq": seq, "ts": ts,
                        "route": "http_delete", "method": "DELETE",
                        "path": f"/2,{i:04x}", "status": 200,
                        "in": 0, "out": 10, "ms": 0.5})
    records.append({"id": "s.ops", "seq": seq + 1, "ts": ts,
                    "route": "ops", "method": "GET",
                    "path": "/metrics", "status": 200, "in": 0,
                    "out": 9000, "ms": 1.0})
    return {"format": "seaweedfs-tpu-workload-recording-v1",
            "records": records}


def sampled(rec: dict) -> dict:
    """The same stream recorded at 10%."""
    out = json.loads(json.dumps(rec))
    out["records"] = [dict(r, sample=0.1)
                      for i, r in enumerate(out["records"]) if i % 10 == 0]
    return out


def journal_export() -> dict:
    """One export of the port's own WorkloadJournal: two servers' Zipf
    reads over HTTP and the framed plane, writes (some through the
    master's /submit), deletes, and ops noise."""
    rng = random.Random(17)
    rec = port_reqlog.ReqlogRecorder(capacity=4096, sample=1.0,
                                     namespace="replay", seed=3)
    rec.start()
    ranks = [int(rng.paretovariate(1.1)) for _ in range(300)]
    for i, r in enumerate(ranks):
        route = "native_read" if i % 4 == 0 else "http_read"
        rec.record(route, "GET", f"/3,{min(r, 40):04x}", 200,
                   bytes_out=1024 * (1 + r % 3), duration_ms=0.5,
                   deadline_s=1.5 if i % 3 else None)
    for i in range(60):
        rec.record("http_write", "POST", f"/4,{i:04x}", 201,
                   bytes_in=(8192 if i % 7 else 300000), duration_ms=1.0,
                   handler="submit" if i % 3 == 0 else "upload")
    for i in range(12):
        rec.record("native_delete", "DELETE", f"/4,{i:04x}", 200)
    rec.record("http_read", "GET", "/3,0001", 404)
    rec.record("lookup", "GET", "/dir/lookup?volumeId=3", 200)
    rec.stop()
    journal = port_reqlog.WorkloadJournal()
    records = rec.query(limit=0)
    journal.ingest("127.0.0.1:8080", records[::2])
    journal.ingest("127.0.0.1:8081", records[1::2])
    return journal.export()


RECORDINGS = {
    "fit": recording,
    "skewed": lambda: recording(n_reads=300, n_writes=0, n_deletes=0,
                                zipf_s=1.6, keys=64, seed=9),
    "sampled": lambda: sampled(recording()),
    "journal": journal_export,
}


def _fit(mod, rec: dict) -> dict:
    spec = mod.spec_from_recording(rec, duration_s=5, clients=3,
                                   n_volume_servers=2)
    fast = mod.spec_from_recording(rec, name="fast", speed=4.0)
    slow = mod.spec_from_recording(rec, speed=0.001, duration_s=900)
    wrong = mod.spec_from_recording(rec, duration_s=5)
    wrong.read_fraction = 1.0
    wrong.hot_set = 4096

    def result(frac: float) -> dict:
        return {"wall_s": spec.duration_s,
                "routes": {"read": {"ops": int(
                    spec.target_rps * spec.duration_s * frac)},
                    "write": {"ops": 7}}}

    return {
        "records": mod.workload_records(rec),
        "profile": mod.recording_profile(rec),
        "specs": [s.to_dict() for s in (spec, fast, slow)],
        "fidelity": mod.replay_fidelity(rec, spec),
        "fidelity_wrong": mod.replay_fidelity(rec, wrong),
        "fidelity_run": mod.replay_fidelity(rec, spec, result=result(1.0)),
        "fidelity_slow_run": mod.replay_fidelity(rec, spec,
                                                 result=result(0.4)),
        "fidelity_tight": mod.replay_fidelity(rec, spec, op_tol=0.0,
                                              size_tol=0.01,
                                              head_tol=0.0),
        "op_mix": mod._spec_op_mix(spec, samples=500, seed=3),
    }


@pytest.mark.parametrize("name", sorted(RECORDINGS))
def test_the_fit_equals_the_reference_s(name):
    rec = RECORDINGS[name]()
    got = {k: _fit(mod, rec) for k, mod in PACKAGES.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["profile"]["records"] > 0


def test_the_faithful_fit_passes_and_a_wrong_one_fails():
    rec = recording()
    spec = port_replay.spec_from_recording(rec, duration_s=5)
    checks = port_replay.replay_fidelity(rec, spec)
    assert checks and all(c["ok"] for c in checks), checks
    spec.read_fraction = 1.0
    checks = port_replay.replay_fidelity(rec, spec)
    assert any(c["check"] == "fidelity_op_mix" and not c["ok"]
               for c in checks)


@pytest.mark.parametrize("sizes", [
    [4096] * 90 + [65536] * 8 + [1 << 20] * 2,
    [], [0, -3], [1, 2, 3, 4, 5, 6, 7, 8, 9, 1 << 30],
    [random.Random(4).randrange(1, 1 << 22) for _ in range(500)]])
def test_fit_size_mix_equals_the_reference_s(sizes):
    for buckets in (1, 2, 4, 8):
        assert port_replay.fit_size_mix(list(sizes), buckets) == \
            ref_replay.fit_size_mix(list(sizes), buckets)


def test_an_empty_recording_is_refused_alike():
    for rec in ({"records": []},
                {"records": [{"id": "x", "route": "ops", "ts": 1.0}]}):
        errors = []
        for mod in PACKAGES.values():
            with pytest.raises(ValueError) as ei:
                mod.spec_from_recording(rec)
            errors.append(str(ei.value))
        assert errors[0] == errors[1]


class DocEnv:
    """A shell env whose master answers a recording and a heat view."""

    def __init__(self, rec: dict, heat: dict | None):
        self.master_url = "127.0.0.1:1"
        self.rec, self.heat = rec, heat
        self.paths: list[str] = []

    def master_get(self, path: str, timeout=None) -> dict:
        self.paths.append(path)
        if path.startswith("/cluster/workload/export"):
            return self.rec
        if path.startswith("/cluster/heat") and self.heat is not None:
            return self.heat
        raise OSError(f"no {path}")

    def confirm_is_locked(self) -> None:
        pass


@pytest.mark.parametrize("heat", [None, {"zipf": {"s": 1.13, "distinct": 9,
                                                  "top": []}},
                                  {"zipf": {"s": 0.5, "distinct": 2}}])
def test_workload_profile_prints_as_the_reference(heat, tmp_path):
    rec = journal_export()
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))
    for flags in ({}, {"json": "true"}, {"route": "http_read"},
                  {"file": str(path)}, {"file": str(path), "json": "true"}):
        got = {}
        for name, mod in (("ref", ref_wc), ("port", port_wc)):
            env = DocEnv(rec, heat)
            got[name] = (mod.cmd_workload_profile(env, dict(flags)),
                         env.paths)
        assert got["port"] == got["ref"], flags


def test_workload_replay_prints_as_the_reference(tmp_path, monkeypatch):
    import seaweedfs_tpu.scenarios as ref_scn
    import seaweedfs_tpu_torch.scenarios as port_scn

    rec = recording()
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))

    def fake_run(spec, against):
        return {"name": spec.name, "against": against, "wall_s": 5.0,
                "total_ops": 400, "verdict": "pass",
                "routes": {"read": {"ops": 300}, "write": {"ops": 100}},
                "checks": [{"check": "error_ratio", "ok": True,
                            "value": 0.0, "bound": 0.02}]}

    monkeypatch.setattr(ref_scn, "run_against", fake_run)
    monkeypatch.setattr(port_scn, "run_against", fake_run)
    for flags in ({"against": "m:1"}, {"against": "m:1", "json": "true"},
                  {"against": "m:1", "speed": "2", "clients": "3",
                   "duration": "7"}):
        got = {}
        for name, mod in (("ref", ref_wc), ("port", port_wc)):
            got[name] = mod.cmd_workload_replay(
                DocEnv(rec, None), dict(flags, file=str(path)))
        assert got["port"] == got["ref"], flags
    for mod in (ref_wc, port_wc):
        with pytest.raises(ValueError, match="bad -speed"):
            mod.cmd_workload_replay(DocEnv(rec, None),
                                    {"file": str(path), "speed": "x",
                                     "against": "m:1"})


def test_replay_against_a_live_cluster_needs_the_lock(tmp_path):
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    path = tmp_path / "rec.json"
    path.write_text(json.dumps(recording()))
    env = CommandEnv("127.0.0.1:1")  # never contacted
    with pytest.raises(RuntimeError, match="lock is needed"):
        run_command(env, f"workload.replay -file {path} -against "
                         "127.0.0.1:1")


def test_record_then_replay_against_the_live_cluster(tmp_path):
    """A port cluster on the CPU records a mixed workload over HTTP and the
    framed plane, exports it, and the recording replays against its
    master: verdict pass, every fidelity check ok."""
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.utils.framing import tcp_address
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer
    from seaweedfs_tpu_torch.volume_server.tcp import TcpVolumeClient

    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path)], m.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not m.topo.all_nodes():
            time.sleep(0.05)
        env = CommandEnv(m.url)
        assert "recording" in run_command(env,
                                          "workload.record -sample 1.0")
        rng = random.Random(3)
        fids = []
        for i in range(24):
            r = http_json("GET", f"http://{m.url}/dir/assign?count=1",
                          timeout=10.0)
            st, _b, _h = http_bytes("POST", f"http://{r['url']}/{r['fid']}",
                                    b"x" * (4096 if i % 6 else 65536),
                                    timeout=10.0)
            assert st in (200, 201)
            fids.append((r["fid"], r["url"]))
        tcp = TcpVolumeClient()
        for i in range(240):
            fid, url = fids[min(int(rng.paretovariate(1.1)) - 1,
                                len(fids) - 1)]
            if i % 8 == 0 and vs._tcp_server is not None:
                assert tcp.read(tcp_address(url), fid)
            else:
                st, _b, _h = http_bytes("GET", f"http://{url}/{fid}",
                                        timeout=10.0)
                assert st == 200
        assert "stopped" in run_command(env, "workload.stop")
        # the shippers flush every half second; a loaded box is slower
        deadline = time.time() + 30
        while time.time() < deadline:
            doc = http_json("GET", f"http://{m.url}/cluster/workload/export",
                            timeout=10.0)
            if len(port_replay.workload_records(doc)) >= 264:
                break
            time.sleep(0.2)
        out = str(tmp_path / "recording.json")
        run_command(env, f"workload.export -out {out}")
        with open(out, encoding="utf-8") as f:
            saved = json.load(f)
        prof = json.loads(run_command(env,
                                      f"workload.profile -file {out} -json"))
        prof.pop("heat_zipf", None)
        assert prof == json.loads(json.dumps(
            port_replay.recording_profile(saved)))
        assert prof["records"] == 264
        run_command(env, "lock")
        try:
            res = json.loads(run_command(
                env, f"workload.replay -file {out} -against {m.url} "
                     "-duration 3 -clients 4 -speed 0.5 -json"))
        finally:
            run_command(env, "unlock")
        assert res["against"] == m.url
        assert res["verdict"] == "pass", res["checks"]
        assert res["fidelity"] and all(c["ok"] for c in res["fidelity"]), \
            res["fidelity"]
        assert {c["check"] for c in res["fidelity"]} >= {
            "fidelity_op_mix", "fidelity_size_mix", "fidelity_hot_head",
            "fidelity_replayed_op_mix", "fidelity_pacing"}
    finally:
        reset_recorder(port_reqlog)
        vs.stop()
        m.stop()
