"""Production-shaped scenario harness: the port's copy of
seaweedfs_tpu/scenarios/.

It drives a cluster with the shapes production has (Zipfian object
popularity over a hot set, a mixed size distribution, delete churn, and
mid-load fault injection from the FAULT_POINTS registry) with the
graceful-degradation plane (deadlines, retry budgets, admission control)
and the alert engine live, and emits per-route RED measurements,
per-phase p99s, shed/retry/deadline counters, the alert timeline, a
sampled stitched trace, and a degraded verdict against the spec's
expectations.

    from seaweedfs_tpu_torch.scenarios import read_storm, run_scenario
    result = run_scenario(read_storm(), device="cuda")

``run_scenario`` and ``run_failover`` start in-process servers whose EC
work runs on ``device`` ("cuda" by default; "cpu" only when asked).
Two more entry points close the loop with the observability stack:

  - replay.spec_from_recording fits a workload recording
    (observability/reqlog.py, the shell's ``workload.export``) into a
    replayable spec, open-loop paced at the recorded (or -speed scaled)
    rate, with replay_fidelity machine-checking the reproduction;
    ``run_against`` drives it at a live cluster's master;
  - capacity.find_capacity / probe_cluster binary-search the max
    sustainable rps per route class under a declared SLO (the shell's
    ``capacity.probe``, parked at the master's /cluster/capacity).
"""

from .capacity import CapacitySLO, find_capacity, measure_rate
from .engine import run_against, run_scenario
from .failover import run_failover
from .replay import (recording_profile, replay_fidelity,
                     spec_from_recording)
from .spec import (FaultSpec, ScenarioSpec, default_scenarios,
                   failure_under_load, flash_crowd,
                   flash_crowd_autoscale, master_failover,
                   read_storm, write_churn)
from .workload import SizeSampler, ZipfSampler

__all__ = [
    "FaultSpec", "ScenarioSpec", "default_scenarios", "run_scenario",
    "run_against", "run_failover",
    "read_storm", "write_churn", "failure_under_load", "flash_crowd",
    "flash_crowd_autoscale", "master_failover",
    "ZipfSampler", "SizeSampler",
    "spec_from_recording", "recording_profile", "replay_fidelity",
    "CapacitySLO", "find_capacity", "measure_rate",
]
