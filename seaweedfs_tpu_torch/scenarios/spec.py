"""Declarative scenario specs: the workload is DATA, the engine runs it.

The port's copy of seaweedfs_tpu/scenarios/spec.py: every named spec's
``to_dict()`` equals the reference's.

A ScenarioSpec says what the traffic looks like (Zipfian popularity
over a hot set, size mix, read/write/churn split), what breaks and
when (FaultSpec entries over the W701-checked FAULT_POINTS registry),
what budget every request carries (deadline_s), how the servers defend
themselves (max_inflight admission), and what the run must prove
(expectations -> the degraded verdict).  Specs serialize to/from plain
dicts so a result document can echo exactly what ran.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class FaultSpec:
    """One timed fault: arm `point` at at_frac of the run, clear it at
    clear_frac.  `peer` scopes net.* points to one server; the engine
    resolves the placeholder "vs<N>" to the N-th volume server's
    address at run time (a spec cannot know ephemeral ports)."""
    point: str
    at_frac: float = 0.33
    clear_frac: float = 0.66
    error_rate: float = 1.0
    delay: float = 0.0
    peer: str = "vs0"

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class ScenarioSpec:
    name: str
    duration_s: float = 12.0
    clients: int = 8
    n_volume_servers: int = 1
    n_masters: int = 1                # >1: HA quorum (failover drills)
    read_fraction: float = 1.0        # remainder is writes (incl. churn)
    churn_fraction: float = 0.0       # fraction of WRITE ops that delete
    submit_fraction: float = 0.0      # fraction of writes via master /submit
    zipf_s: float = 1.1               # popularity skew exponent
    hot_set: int = 128                # distinct objects in the hot set
    # (size_bytes, weight) mix; 4KB needles dominate, with a heavy tail
    sizes: tuple = ((4096, 0.90), (65536, 0.08), (1 << 20, 0.02))
    deadline_s: float = 2.0           # per-request client budget
    # open-loop pacing: > 0 schedules ops at this aggregate rate on a
    # fixed clock (replayed recordings arrive at recorded speed; a slow
    # server gets catch-up bursts, not a slower workload).  0 = closed
    # loop: every client hammers as fast as responses return.
    target_rps: float = 0.0
    max_inflight: int = 0             # server admission bound (0 = off)
    vacuum_every_s: float = 0.0       # >0: periodic /vol/vacuum churn
    # mid-run popularity shift: at this fraction of the run the Zipf
    # head jumps to the cold half of the rank list (the flash-crowd
    # shape the heat plane's shift detector exists to catch); 0 = off
    head_shift_frac: float = 0.0
    # keep the hot set where the master placed it instead of round-
    # robin interleaving ranks across servers — a shift drill needs
    # the head's move to change WHICH VOLUME is hot
    preload_locality: bool = False
    # run the master's heat autoscaler (ops/autoscaler.py) at drill
    # scale: grows answer the Zipf head live, clients re-discover
    # replica locations mid-run, and the result carries an `autoscale`
    # block (grow latency, SLO recovery, thrash count)
    autoscale: bool = False
    faults: tuple = ()                # FaultSpec entries
    fast_alerts: bool = True          # shrink SLO windows to drill scale
    # verdict bounds; absent keys are not checked
    expectations: dict = field(default_factory=dict)
    seed: int = 0xBEE5

    def to_dict(self) -> dict:
        d = asdict(self)
        d["faults"] = [f.to_dict() if isinstance(f, FaultSpec) else dict(f)
                       for f in self.faults]
        d["sizes"] = [list(s) for s in self.sizes]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        d["faults"] = tuple(FaultSpec(**f) for f in d.get("faults", ()))
        d["sizes"] = tuple((int(b), float(w))
                           for b, w in d.get("sizes", ()))
        return cls(**d)


def read_storm(duration_s: float = 10.0) -> ScenarioSpec:
    """Zipfian hot-set read storm: the 'millions of users fetching the
    same front page' shape.  Pure reads, heavy skew, every request on a
    budget — proves p99 under popularity concentration."""
    return ScenarioSpec(
        name="read_storm", duration_s=duration_s, clients=8,
        n_volume_servers=1, read_fraction=1.0, zipf_s=1.2, hot_set=256,
        deadline_s=2.0,
        expectations={"max_error_ratio": 0.01,
                      "deadline_overrun_max_ms": 250.0})


def write_churn(duration_s: float = 10.0) -> ScenarioSpec:
    """Mixed-size write + delete churn + vacuum: the ingest side.
    Exercises assign/grow under sustained writes of 4KB..1MB objects
    while deletes accumulate garbage and vacuum reclaims it mid-load."""
    return ScenarioSpec(
        name="write_churn", duration_s=duration_s, clients=6,
        n_volume_servers=1, read_fraction=0.30, churn_fraction=0.25,
        zipf_s=1.0, hot_set=96, vacuum_every_s=3.0, deadline_s=3.0,
        expectations={"max_error_ratio": 0.02,
                      "deadline_overrun_max_ms": 250.0})


def failure_under_load(duration_s: float = 21.0) -> ScenarioSpec:
    """The degradation-under-fault proof: Zipfian read-mostly load over
    three servers, one of which is network-partitioned for the middle
    third of the run while part of the write path proxies through the
    master (so the partition surfaces as server-side 5xx and burns the
    SLO).  The verdict demands the healthy fraction keeps serving, the
    accepted requests stay fast, nobody outlives their deadline, and
    the burn-rate alert both fires during the fault and resolves after
    — graceful degradation, machine-checked."""
    return ScenarioSpec(
        name="failure_under_load", duration_s=duration_s, clients=8,
        n_volume_servers=3, read_fraction=0.80, submit_fraction=0.50,
        zipf_s=1.0, hot_set=240, deadline_s=2.0, max_inflight=64,
        faults=(FaultSpec(point="net.partition", at_frac=1 / 3,
                          clear_frac=2 / 3, error_rate=1.0, peer="vs0"),),
        expectations={"fault_rps_ratio_min": 0.60,
                      "fault_p99_factor_max": 5.0,
                      "deadline_overrun_max_ms": 250.0,
                      "alert_fired_any": ["scenario_error_burn",
                                          "peer_down",
                                          "requests_shed_increase",
                                          "deadline_exceeded_increase"],
                      "alert_resolved": True})


def flash_crowd(duration_s: float = 14.0) -> ScenarioSpec:
    """The heat-telemetry proof (observability/heat.py): Zipfian reads
    over two volume servers with locality-preserving preload, then
    mid-run the Zipf head jumps to the cold half of the rank list.
    The master's heat journal must notice — the head-set shift
    detector fires heat_shift/flash_crowd naming the newly hot volume
    within seconds, carrying an exemplar trace id — while the serving
    plane itself stays healthy."""
    return ScenarioSpec(
        name="flash_crowd", duration_s=duration_s, clients=8,
        n_volume_servers=2, read_fraction=1.0, zipf_s=1.3, hot_set=128,
        deadline_s=2.0, preload_locality=True, head_shift_frac=0.45,
        expectations={"max_error_ratio": 0.02,
                      "deadline_overrun_max_ms": 250.0,
                      "alert_fired_any": ["heat_shift", "flash_crowd"],
                      "heat_alert_within_s": 5.0})


def flash_crowd_autoscale(duration_s: float = 18.0) -> ScenarioSpec:
    """The closed-loop acceptance drill (ops/autoscaler.py): the
    flash_crowd shape — Zipf head jumps onto one volume mid-run — but
    with the heat autoscaler ON over three rack-diverse servers.  The
    verdict demands the loop actually closes: a replica-add lands
    within seconds of the shift, the journaled replica_grow carries
    the causing heat alert id and an exemplar trace, the hot set's
    p99 is back inside the SLO within the recovery budget, and the
    thrash guard held (at most one grow/shrink cycle per volume)."""
    return ScenarioSpec(
        name="flash_crowd_autoscale", duration_s=duration_s, clients=8,
        n_volume_servers=3, read_fraction=1.0, zipf_s=1.3, hot_set=128,
        deadline_s=2.0, preload_locality=True, head_shift_frac=0.40,
        autoscale=True,
        expectations={"max_error_ratio": 0.02,
                      "deadline_overrun_max_ms": 500.0,
                      "alert_fired_any": ["heat_shift", "flash_crowd"],
                      "heat_alert_within_s": 5.0,
                      "autoscale_grow_within_s": 8.0,
                      "autoscale_attribution": True,
                      "autoscale_slo_p99_ms": 250.0,
                      "autoscale_recover_within_s": 10.0,
                      "autoscale_max_cycles": 1})


def master_failover(duration_s: float = 16.0) -> ScenarioSpec:
    """The control-plane HA proof (master/consensus.py raft log +
    scenarios/failover.py runner): a 3-master quorum under a write
    storm loses its leader mid EC repair.  The verdict demands a new
    leader within the election budget, /dir/assign serving again
    inside one client deadline, ZERO loss of pre-kill journaled events
    (the raft-replicated journal contract), and the orphaned repair
    re-planned by the new leader with its original alert/trace cause
    attribution intact."""
    return ScenarioSpec(
        name="master_failover", duration_s=duration_s, clients=6,
        n_masters=3, n_volume_servers=4, read_fraction=0.0,
        zipf_s=1.0, hot_set=48, deadline_s=3.0,
        expectations={"election_max_s": 8.0,
                      "journal_loss_max": 0,
                      "assign_after_kill_max_s": 5.0,
                      "repair_replan_max_s": 45.0})


def default_scenarios() -> list[ScenarioSpec]:
    """The three canonical scenarios, in run order."""
    return [read_storm(), write_churn(), failure_under_load()]
