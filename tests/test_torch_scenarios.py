"""The port's scenario harness (seaweedfs_tpu_torch/scenarios/) against
seaweedfs_tpu.scenarios, on the CPU.

At tolerance 0:
- the samplers' draws from one ``random.Random(seed)``, ``pick_op``,
  ``percentile`` and ``payload_for``;
- every named spec's ``to_dict()``, and ``from_dict`` round trips each
  way;
- ``__all__``, name for name;
- the engine's route stats, phase stats and expectation checks on one
  seeded list of client operations.

Live, on in-process servers with ``device="cpu"``:
- the reference's mini read scenario and its ``failure_under_load`` mini
  drill (tests/test_scenarios.py): the partition's errors show in the
  fault phase and recover after the clear;
- ``run_failover(master_failover())`` passes, and its document has the
  reference's keys and checks;
- a spec with ``autoscale=True`` is refused before any server starts (the
  port's master has no autoscaler yet), and the default device needs a
  card.
"""

from __future__ import annotations

import json
import random

import pytest
import torch

import seaweedfs_tpu.scenarios as ref_scn
import seaweedfs_tpu_torch.scenarios as port_scn
from seaweedfs_tpu.scenarios import engine as ref_engine
from seaweedfs_tpu.scenarios import workload as ref_workload
from seaweedfs_tpu.utils import faultinject as ref_fi
from seaweedfs_tpu_torch.scenarios import engine as port_engine
from seaweedfs_tpu_torch.scenarios import workload as port_workload
from seaweedfs_tpu_torch.utils import faultinject as fi

SPECS = ("read_storm", "write_churn", "failure_under_load", "flash_crowd",
         "flash_crowd_autoscale", "master_failover")


@pytest.fixture(autouse=True)
def _clean_faults():
    fi.clear()
    ref_fi.clear()
    yield
    fi.clear()
    ref_fi.clear()


def _draws(mod, seed: int) -> dict:
    rng = random.Random(seed)
    z = mod.ZipfSampler(97, 1.17)
    one = mod.ZipfSampler(1, 0.9)
    sizes = mod.SizeSampler(((4096, 0.9), (65536, 0.08), (1 << 20, 0.02)))
    empty = mod.SizeSampler(())
    return {
        "zipf": [z.sample(rng) for _ in range(3000)],
        "pmf": [z.pmf(r) for r in range(97)],
        "one": [one.sample(rng) for _ in range(10)],
        "sizes": [sizes.sample(rng) for _ in range(3000)],
        "empty": [empty.sample(rng) for _ in range(5)],
        "ops": [mod.pick_op(rng, 0.7, 0.25) for _ in range(3000)],
        "after": rng.random(),
    }


@pytest.mark.parametrize("seed", [0, 7, 0xBEE5])
def test_samplers_draw_as_the_reference(seed):
    assert _draws(port_workload, seed) == _draws(ref_workload, seed)


def test_percentile_and_payload_as_the_reference():
    vals = sorted(random.Random(3).random() for _ in range(101))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for xs in (vals, vals[:1], []):
            assert port_workload.percentile(xs, q) == \
                ref_workload.percentile(xs, q)
    for size, seed_byte in ((0, 1), (16, 2), (4096, 300), (7, -1)):
        assert port_workload.payload_for(size, seed_byte) == \
            ref_workload.payload_for(size, seed_byte)


@pytest.mark.parametrize("name", SPECS)
def test_named_specs_equal_the_reference_s(name):
    port, ref = getattr(port_scn, name)(), getattr(ref_scn, name)()
    assert port.to_dict() == ref.to_dict()
    assert port_scn.ScenarioSpec.from_dict(ref.to_dict()) == port
    assert ref_scn.ScenarioSpec.from_dict(port.to_dict()) == ref
    short = getattr(port_scn, name)(duration_s=3.5)
    assert short.to_dict() == getattr(ref_scn, name)(3.5).to_dict()


def test_default_scenarios_and_all_as_the_reference():
    assert [s.to_dict() for s in port_scn.default_scenarios()] == \
        [s.to_dict() for s in ref_scn.default_scenarios()]
    assert port_scn.__all__ == ref_scn.__all__
    fault = port_scn.FaultSpec(point="net.delay", delay=0.2, peer="vs2")
    assert fault.to_dict() == ref_scn.FaultSpec(
        point="net.delay", delay=0.2, peer="vs2").to_dict()


def _ops(mod, seed: int) -> list:
    rng = random.Random(seed)
    ops = []
    for i in range(600):
        route = rng.choice(("read", "read", "read", "write", "delete"))
        status = rng.choice((200, 200, 200, 201, 503, 504, 0, 404))
        ops.append(mod._Op(route, i * 0.02, rng.random() * 2.5, status))
    return ops


@pytest.mark.parametrize("seed", [1, 2])
def test_route_phase_stats_and_checks_as_the_reference(seed):
    phases = {"healthy": (0.0, 4.0), "fault": (4.0, 8.0),
              "recovery": (8.0, 12.0 + 1e9)}
    spec = {"expectations": {
        "max_error_ratio": 0.02, "deadline_overrun_max_ms": 250.0,
        "fault_rps_ratio_min": 0.6, "fault_p99_factor_max": 5.0,
        "alert_fired_any": ["scenario_error_burn", "peer_down"],
        "alert_resolved": True, "heat_alert_within_s": 5.0,
        "autoscale_grow_within_s": 8.0, "autoscale_max_cycles": 1}}
    got = {}
    for name, mod, pkg in (("ref", ref_engine, ref_scn),
                           ("port", port_engine, port_scn)):
        ops = _ops(mod, seed)
        result = {"routes": mod._route_stats(ops, 12.0),
                  "phases": mod._phase_stats(ops, phases, 12.0),
                  "deadline": {"max_overrun_ms": 120.0, "violations": 0},
                  "heat": {"alert_latency_s": 2.5, "named_volume": "3"}}
        watch = mod._AlertWatch(None, 0.0)
        watch.fired_at = {"peer_down": 5.0}
        watch._last = {"peer_down": "resolved"}
        s = pkg.ScenarioSpec(name="x", **spec)
        result["checks"] = mod._evaluate(s, result, watch, (4.0, 8.0))
        got[name] = result
    assert got["port"] == got["ref"]


def test_autoscale_spec_is_refused_before_any_server_starts(tmp_path,
                                                            monkeypatch):
    import seaweedfs_tpu_torch.master.server as port_master

    def no_master(*_a, **_k):
        raise AssertionError("a server started")

    monkeypatch.setattr(port_master, "MasterServer", no_master)
    with pytest.raises(NotImplementedError, match="heat autoscaler"):
        port_scn.run_scenario(port_scn.flash_crowd_autoscale(),
                              base_dir=str(tmp_path), device="cpu")
    assert not list(tmp_path.iterdir())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_default_device_needs_a_card(tmp_path):
    spec = port_scn.ScenarioSpec(name="no_card", duration_s=2.0,
                                 clients=1, hot_set=4)
    with pytest.raises(Exception, match="(?i)cuda"):
        port_scn.run_scenario(spec, base_dir=str(tmp_path))
    assert not fi._points
    with pytest.raises(Exception, match="(?i)cuda"):
        port_scn.run_failover(base_dir=str(tmp_path))
    # the shell's in-process replay starts its servers on the card too
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from tests.test_torch_replay import recording

    path = tmp_path / "rec.json"
    path.write_text(json.dumps(recording()))
    with pytest.raises(Exception, match="(?i)cuda"):
        run_command(CommandEnv("127.0.0.1:1"),
                    f"workload.replay -file {path} -duration 2")


def test_read_scenario_result_document(tmp_path):
    spec = port_scn.ScenarioSpec(
        name="mini_read", duration_s=2.5, clients=4, hot_set=16,
        zipf_s=1.1, deadline_s=2.0,
        expectations={"max_error_ratio": 0.02,
                      "deadline_overrun_max_ms": 250.0})
    res = port_scn.run_scenario(spec, base_dir=str(tmp_path), device="cpu")
    assert res["verdict"] == "pass", res["checks"]
    r = res["routes"]["read"]
    assert r["ops"] > 50 and r["error_ratio"] <= 0.02
    assert r["p99_ms"] > 0
    assert res["deadline"]["violations"] == 0
    assert res["phases"]["healthy"]["ok_rps"] > 0
    assert set(res["counters"]) == {"requests_shed", "deadline_exceeded",
                                    "retry_budget_exhausted"}
    assert res["spec"] == spec.to_dict()
    assert [c["check"] for c in res["checks"]] == [
        "error_ratio", "deadline_overrun_ms", "deadline_violations"]
    assert res["trace"]["span_count"] > 0


def test_failure_under_load_mini_drill(tmp_path):
    """3 servers, the middle third partitioned: the partitioned fraction
    fails fast (errors, not stalls), the healthy fraction keeps serving,
    nothing outlives its deadline, and the errors recover after the
    clear."""
    spec = port_scn.ScenarioSpec(
        name="mini_fail", duration_s=7.5, clients=4,
        n_volume_servers=3, read_fraction=0.85,
        submit_fraction=0.5, hot_set=36, zipf_s=1.0,
        deadline_s=2.0, max_inflight=64,
        faults=(port_scn.FaultSpec(point="net.partition", at_frac=1 / 3,
                                   clear_frac=2 / 3, peer="vs0"),),
        expectations={"deadline_overrun_max_ms": 250.0})
    res = port_scn.run_scenario(spec, base_dir=str(tmp_path), device="cpu")
    assert [f["action"] for f in res["faults"]] == ["arm", "clear"]
    assert res["faults"][0]["point"] == "net.partition"
    ph = res["phases"]
    assert set(ph) == {"healthy", "fault", "recovery"}
    # the master grows nine volumes at random over the three servers, so
    # vs0 holds none about one run in forty, as in the reference's drill
    assert ph["fault"]["error_ratio"] > 0.02, (res["faults"], ph,
                                               res["routes"])
    assert ph["fault"]["ok_rps"] > 0.3 * ph["healthy"]["ok_rps"]
    assert ph["recovery"]["error_ratio"] < ph["fault"]["error_ratio"]
    assert res["deadline"]["violations"] == 0
    assert res["verdict"] == "pass", res["checks"]
    assert "timeline" in res["alerts"]
    assert not fi._points  # the engine disarms what it armed


def _doc_shape(doc: dict) -> dict:
    """The failover document's keys, nested where the reference's are
    fixed, and its check names."""
    return {"top": sorted(doc),
            "routes": {r: sorted(v) for r, v in doc["routes"].items()},
            "repair_attribution": sorted(doc["repair_attribution"]),
            "alerts": sorted(doc["alerts"]),
            "raft": sorted(doc["raft"]),
            "checks": [c["check"] for c in doc["checks"]],
            "spec": doc["spec"]}


def test_failover_drill_passes_with_the_reference_s_document(tmp_path):
    port = port_scn.run_failover(port_scn.master_failover(),
                                 base_dir=str(tmp_path), device="cpu")
    assert port["verdict"] == "pass", port["checks"]
    assert port["journal_loss_count"] == 0
    assert port["repair_attribution"]["alert"] in \
        port["repair_attribution"]["fired_pre_kill"]
    assert port["killed_leader"] != port["new_leader"]
    ref = ref_scn.run_failover(ref_scn.master_failover(),
                               base_dir=str(tmp_path))
    assert _doc_shape(port) == _doc_shape(ref)
