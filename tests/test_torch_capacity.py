"""The SLO capacity probe in the port (scenarios/capacity.py, the shell's
capacity.probe, the master's /cluster/capacity and cluster.health's
capacity line) against seaweedfs_tpu, on the CPU.

At tolerance 0:
- ``render_capacity`` of one document per shape (a knee, no knee, a
  route's error, the ledger citation), ``CapacitySLO`` and
  ``_sustainable``;
- ``find_capacity``'s whole document (the ramp, the halving below a
  breaching start, the binary search, the knee and its reason) against a
  stub service of fixed rate, with ``measure_rate`` replaced by the same
  deterministic model in both packages;
- ``/cluster/capacity``'s 404, 400 and 201 answers and the parked
  document; cluster.health's ``capacity:`` line with the clock pinned;
- capacity.probe's refusal without the admin lock.

Port only: a search's steps run on one set of long-lived client threads
(each warmed by one unmeasured op), where the reference starts new ones
each step.

Live on the CPU: one open-loop step delivers its schedule, and
``capacity.probe`` against a port cluster finds every route's capacity,
parks the document on the master and puts the line in cluster.health.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

import seaweedfs_tpu.scenarios.capacity as ref_cap
import seaweedfs_tpu_torch.scenarios.capacity as port_cap
from seaweedfs_tpu.shell import trace_commands as ref_trace_commands
from seaweedfs_tpu_torch.shell import coordinator_commands as port_coord
from tests.conftest import free_port

PACKAGES = {"ref": ref_cap, "port": port_cap}

DOCS = [
    {"slo": {"max_p99_ms": 5.0, "max_error_ratio": 0.001},
     "routes": {
         "http_read": {"capacity_rps": 4200.0, "capacity_p99_ms": 3.1,
                       "knee_rps": 4800.0,
                       "knee": {"reason": "p99 7.0ms > 5ms"},
                       "bounding": {"resource": "server",
                                    "bounding_hop": "volume 127.0.0.1",
                                    "ledger": {"route": "http_read",
                                               "cpu_rate_s_per_s": 0.0123,
                                               "cpu_share": 0.456,
                                               "queue_wait_s_per_s": 0.002,
                                               "req_rate": 812.5}}},
         "native_read": {"capacity_rps": 21000.0, "capacity_p99_ms": 1.0,
                         "knee_rps": None, "knee": None,
                         "bounding": {"resource": "unknown"}},
         "http_write": {"capacity_rps": 0.0, "capacity_p99_ms": 0.0,
                        "knee_rps": 0.78125,
                        "knee": {"reason": "throughput (schedule could "
                                           "not be kept)"}},
         "broken": {"error": "unknown route"}}},
    {"slo": {"max_p99_ms": 2.5, "max_error_ratio": 0.0123},
     "routes": {}},
    {"routes": {"http_read": {"capacity_rps": 99.5}}},
]


@pytest.mark.parametrize("doc", DOCS)
def test_render_capacity_equals_the_reference_s(doc):
    assert port_cap.render_capacity(json.loads(json.dumps(doc))) == \
        ref_cap.render_capacity(json.loads(json.dumps(doc)))


STEPS = [
    {"target_rps": 100.0, "achieved_rps": 99.0, "error_ratio": 0.0,
     "p99_ms": 1.0},
    {"target_rps": 100.0, "achieved_rps": 91.9, "error_ratio": 0.0,
     "p99_ms": 1.0},
    {"target_rps": 100.0, "achieved_rps": 100.0, "error_ratio": 0.0011,
     "p99_ms": 1.0},
    {"target_rps": 100.0, "achieved_rps": 100.0, "error_ratio": 0.0,
     "p99_ms": 5.01},
    {"target_rps": 100.0, "achieved_rps": 100.0, "error_ratio": 0.001,
     "p99_ms": 5.0},
]


@pytest.mark.parametrize("step", STEPS)
def test_sustainable_and_the_slo_as_the_reference(step):
    for slo_args in ({}, {"max_p99_ms": 20.0, "max_error_ratio": 0.0}):
        got = [mod._sustainable(dict(step), mod.CapacitySLO(**slo_args))
               for mod in PACKAGES.values()]
        assert got[0] == got[1]
    assert port_cap.CapacitySLO().to_dict() == \
        ref_cap.CapacitySLO().to_dict() == {"max_p99_ms": 5.0,
                                            "max_error_ratio": 0.001}


def model_step(capacity: float, fail_above: float = float("inf")):
    """measure_rate's stand-in: a service of fixed rate ``capacity``,
    whose p99 grows with the offered load and which errs past
    ``fail_above`` rps; no clock, so both packages see the same steps."""
    def measure(op, rps, duration_s, workers=0):
        rps = max(float(rps), 0.1)
        done = max(int(duration_s * rps), 1)
        achieved = min(rps, capacity)
        errors = done // 10 if rps > fail_above else 0
        util = rps / capacity
        return {"target_rps": round(rps, 1),
                "achieved_rps": round(achieved, 1), "ops": done,
                "errors": errors,
                "error_ratio": round(errors / done, 5),
                "p50_ms": round(0.5 + util, 3),
                "p99_ms": round(1.0 + 6.0 * util * util, 3),
                "max_lag_ms": round(max(0.0, util - 1.0) * 1e3, 1),
                "workers": 4}
    return measure


@pytest.mark.parametrize("capacity,fail_above,kwargs", [
    (400.0, float("inf"), {"start_rps": 50, "max_rps": 4000}),
    (40.0, float("inf"), {"start_rps": 200, "max_rps": 800}),
    (1e9, float("inf"), {"start_rps": 100, "max_rps": 400}),
    (0.4, float("inf"), {"start_rps": 50, "max_rps": 400}),
    (1e9, 400.0, {"start_rps": 100, "max_rps": 3200, "search_steps": 2}),
    (5000.0, float("inf"), {"start_rps": 100, "max_rps": 50000,
                            "search_steps": 0}),
])
def test_find_capacity_equals_the_reference_s(capacity, fail_above, kwargs,
                                              monkeypatch):
    got = {}
    for name, mod in PACKAGES.items():
        monkeypatch.setattr(mod, "measure_rate",
                            model_step(capacity, fail_above))
        got[name] = mod.find_capacity(lambda: True, mod.CapacitySLO(),
                                      step_s=1.0, **kwargs)
    assert got["port"] == got["ref"]
    res = got["port"]
    if capacity < 1e9 and capacity > 1.0:
        assert 0 < res["capacity_rps"] <= capacity
        assert res["knee"]["reason"]
    if fail_above < float("inf"):
        assert "error_ratio" in res["knee"]["reason"]


def test_an_open_loop_step_keeps_its_schedule():
    step = port_cap.measure_rate(lambda: True, rps=400, duration_s=1.0)
    assert step["ops"] == 400 and step["errors"] == 0
    assert step["error_ratio"] == 0.0
    calls = [0]

    def flaky() -> bool:
        calls[0] += 1
        if calls[0] % 2:
            raise OSError("wire gone")
        return True

    step = port_cap.measure_rate(flaky, rps=200, duration_s=0.5)
    assert step["errors"] == 50 and step["error_ratio"] == 0.5


def test_a_search_s_steps_run_on_the_same_warm_client_threads():
    """Given ``clients``, every step runs on the same long-lived threads:
    each thread's first call of the op is an unmeasured warm-up made
    before the step's clock starts, and a later step at a lower rate
    reuses the threads (and so their pooled connections).  A step given
    none runs on threads of its own, warmed the same way."""
    calls: list[str] = []

    def op() -> bool:
        calls.append(threading.current_thread().name)
        return True

    with port_cap._Clients() as clients:
        first = port_cap.measure_rate(op, rps=40, duration_s=0.5,
                                      clients=clients)
        names = set(calls)
        assert first["ops"] == 20 and first["workers"] == 4
        assert len(calls) == 20 + 4 and len(names) == 4
        assert all(n.startswith("cap-client-") for n in names)
        second = port_cap.measure_rate(op, rps=4, duration_s=0.5,
                                       clients=clients)
        assert second["ops"] == 2 and len(calls) == 24 + 2
        assert set(calls[24:]) <= names
    assert not [t for t in threading.enumerate()
                if t.name.startswith("cap-client-")]
    # without clients a step warms and closes threads of its own
    calls.clear()
    step = port_cap.measure_rate(op, rps=8, duration_s=0.5)
    assert step["ops"] == 4 and len(calls) == 4 + 4
    assert not [t for t in threading.enumerate()
                if t.name.startswith("cap-client-")]


def test_find_capacity_hands_its_clients_to_every_step(monkeypatch):
    seen = []
    model = model_step(400.0)

    def measure(op, rps, duration_s, workers=0, clients=None):
        seen.append(clients)
        return model(op, rps, duration_s, workers)

    monkeypatch.setattr(port_cap, "measure_rate", measure)
    marker = object()
    with_clients = port_cap.find_capacity(lambda: True, start_rps=50,
                                          max_rps=4000, step_s=1.0,
                                          clients=marker)
    assert seen and all(c is marker for c in seen)
    seen.clear()
    assert port_cap.find_capacity(lambda: True, start_rps=50, max_rps=4000,
                                  step_s=1.0) == with_clients
    assert seen and all(c is None for c in seen)


def test_the_commands_are_registered_and_the_probe_needs_the_lock():
    from seaweedfs_tpu.shell import CommandEnv as RefEnv
    from seaweedfs_tpu.shell import run_command as ref_run
    from seaweedfs_tpu_torch.shell import COMMANDS, CommandEnv, run_command

    for name in ("workload.profile", "workload.replay", "capacity.probe",
                 "workload.record", "workload.stop", "workload.export"):
        assert name in COMMANDS, name
    errors = []
    for env_cls, run in ((RefEnv, ref_run), (CommandEnv, run_command)):
        with pytest.raises(RuntimeError, match="lock is needed") as ei:
            run(env_cls("127.0.0.1:1"), "capacity.probe")  # never contacted
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    env = CommandEnv("127.0.0.1:1")
    env.confirm_is_locked = lambda: None
    with pytest.raises(ValueError, match="unknown route"):
        run_command(env, "capacity.probe -routes http_read,udp_read")


def _answers(url: str) -> list:
    from seaweedfs_tpu.utils.httpd import http_bytes

    doc = {"slo": {"max_p99_ms": 5.0, "max_error_ratio": 0.001},
           "probed_at": 1760000000.0,
           "routes": {"http_read": {"capacity_rps": 4200.0}}}
    out = []
    for method, body in (("GET", None), ("POST", b"{}"), ("POST", b"[1]"),
                         ("POST", json.dumps(doc).encode()),
                         ("GET", None),
                         ("POST", json.dumps(dict(
                             doc, posted_at=1.5)).encode()),
                         ("GET", None)):
        st, data, _ = http_bytes(method, f"http://{url}/cluster/capacity",
                                 body, timeout=10.0)
        got = json.loads(data) if data else None
        if isinstance(got, dict) and "posted_at" in got and \
                got["posted_at"] != 1.5:
            got["posted_at"] = "stamped"
        out.append((st, got))
    return out


def test_cluster_capacity_answers_as_the_reference():
    from seaweedfs_tpu.master.server import MasterServer as RefMaster
    from seaweedfs_tpu_torch.master.server import MasterServer

    got = {}
    for name, cls in (("ref", RefMaster), ("port", MasterServer)):
        m = cls(port=free_port(), pulse_seconds=0.3).start()
        try:
            got[name] = _answers(m.url)
        finally:
            m.stop()
    assert got["port"] == got["ref"]
    statuses = [st for st, _ in got["port"]]
    assert statuses == [404, 400, 400, 201, 200, 201, 200]
    assert got["port"][3][1] == {"stored": True}
    assert got["port"][4][1]["posted_at"] == "stamped"
    assert got["port"][6][1]["posted_at"] == 1.5


class _Clock:
    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now


class HealthEnv:
    """A shell env whose master answers /cluster/health and
    /cluster/capacity, and nothing else."""

    def __init__(self, capacity):
        self.master_url = "127.0.0.1:1"
        self.docs = {"/cluster/health": {
            "peer_count": 0, "degraded": False, "stale_peers": [],
            "peers": {}, "totals": {"worker_restarts": 0,
                                    "engine_fallbacks": 0,
                                    "degraded_binds": 0}}}
        if capacity is not None:
            self.docs["/cluster/capacity"] = capacity

    def master_get(self, path: str, timeout=None) -> dict:
        if path not in self.docs:
            raise OSError(f"no {path}")
        return self.docs[path]


@pytest.mark.parametrize("capacity", [
    None,
    dict(DOCS[0], posted_at=1_760_000_000.0),
    dict(DOCS[0], probed_at=1_759_999_000.5),
    {"routes": {"http_read": {"capacity_rps": 12.25}}},
    {"slo": {"max_p99_ms": 5.0}, "routes": {"x": {"error": "e"}},
     "posted_at": 1.0},
])
def test_cluster_health_capacity_line_as_the_reference(capacity,
                                                       monkeypatch):
    clock = _Clock(1_760_000_321.7)
    monkeypatch.setattr(ref_trace_commands, "time", clock)
    monkeypatch.setattr(port_coord, "time", clock)
    lines = {}
    for name, fn in (("ref", ref_trace_commands.cmd_cluster_health),
                     ("port", port_coord.cmd_cluster_health)):
        text = fn(HealthEnv(capacity), {})
        lines[name] = [ln for ln in text.splitlines()
                       if ln.startswith("capacity:")]
    assert lines["port"] == lines["ref"]
    want = 1 if capacity is not None and any(
        r.get("capacity_rps") for r in capacity["routes"].values()) else 0
    assert len(lines["port"]) == want


def test_capacity_probe_against_a_live_cluster(tmp_path):
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.utils.httpd import http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path)], m.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not m.topo.all_nodes():
            time.sleep(0.05)
        env = CommandEnv(m.url)
        run_command(env, "lock")
        try:
            doc = json.loads(run_command(
                env, "capacity.probe -start 20 -max 80 -step 0.3 "
                     "-p99 250 -json"))
        finally:
            run_command(env, "unlock")
        assert sorted(doc["routes"]) == ["http_read", "http_write",
                                         "native_read"]
        for route, res in doc["routes"].items():
            assert "error" not in res, (route, res)
            assert res["capacity_rps"] > 0, (route, res)
            assert "samples" not in res
            assert res["bounding"]["resource"] in ("server", "network",
                                                   "unknown")
        parked = http_json("GET", f"http://{m.url}/cluster/capacity",
                           timeout=10.0)
        posted_at = parked.pop("posted_at")
        assert parked == doc and posted_at >= doc["probed_at"]
        health = run_command(env, "cluster.health")
        line = [ln for ln in health.splitlines()
                if ln.startswith("capacity:")]
        assert len(line) == 1
        for route in doc["routes"]:
            assert f"{route}~" in line[0]
    finally:
        vs.stop()
        m.stop()
