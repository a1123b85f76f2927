"""Trace-driven replay: fit a workload recording into a ScenarioSpec.

The port's copy of seaweedfs_tpu/scenarios/replay.py; the Zipf fit
(``estimate_zipf_s``) is the heat plane's own (observability/heat.py).

The workload flight recorder (observability/reqlog.py) turns live
traffic into a recording document; this module turns that recording
into a *repeatable* scenario the existing engine can drive — five
minutes of production traffic becomes a spec you can replay against a
candidate build, at recorded speed or a ``speed`` multiplier, with the
alert plane live.

``spec_from_recording`` estimates:

  - the read/write/delete op mix straight from the recorded route
    classes (native_* and http_* fold into the same logical ops);
  - the master-proxied write share (``submit_fraction``) from the
    /submit handler records;
  - the size mix by bucketing observed write sizes (falling back to
    read response sizes for read-only recordings) into at most four
    weighted buckets — the ScenarioSpec ``sizes`` shape;
  - Zipf skew from observed key popularity: a log-log least-squares
    fit of frequency against rank (P(r) ~ 1/r^s means
    log f_r = c - s log r), clamped to the sane [0.0, 3.0] band;
  - open-loop pacing: ``target_rps`` is the recorded arrival rate
    times ``speed`` (the engine schedules ops on a fixed clock and
    catches up after a slow op instead of slowing down — closed-loop
    replay would let a degraded build hide by back-pressuring its own
    load);
  - the per-request deadline from the recorded budget median.

``replay_fidelity`` is the machine check that the fit (and optionally
a finished replay run) reproduces the recording: op mix, size mix, and
the hot-set head's probability mass, each within an explicit
tolerance.  Eyeballing is not a verdict.
"""

from __future__ import annotations

from collections import Counter
from random import Random
from typing import Optional

from ..observability.heat import estimate_zipf_s
from .spec import ScenarioSpec
from .workload import SizeSampler, ZipfSampler, pick_op

# recorded route class -> logical replay op
READ_ROUTES = ("http_read", "native_read")
WRITE_ROUTES = ("http_write", "native_write")
DELETE_ROUTES = ("http_delete", "native_delete")
WORKLOAD_ROUTES = READ_ROUTES + WRITE_ROUTES + DELETE_ROUTES


def workload_records(recording: dict) -> list[dict]:
    """The replayable subset: object-plane records, time-ordered.
    Telemetry/ops records (shipper POSTs, scrapes) never replay."""
    records = [r for r in (recording.get("records") or [])
               if r.get("route") in WORKLOAD_ROUTES]
    records.sort(key=lambda r: float(r.get("ts") or 0.0))
    return records


def fit_size_mix(sizes: list[int], max_buckets: int = 4) -> tuple:
    """Observed byte sizes -> the ScenarioSpec ``sizes`` shape:
    ((bytes, weight), ...) with at most max_buckets buckets.  Sizes
    bucket by power of two (the workload-relevant resolution — 4KB vs
    64KB vs 1MB matters, 4000 vs 4096 does not); each bucket is
    represented by its observed median so replayed bytes stay honest.
    Ties keep the heaviest buckets."""
    sizes = [s for s in sizes if s > 0]
    if not sizes:
        return ((4096, 1.0),)
    buckets: dict[int, list[int]] = {}
    for s in sizes:
        buckets.setdefault(max(s, 1).bit_length(), []).append(s)
    ranked = sorted(buckets.values(), key=len, reverse=True)[:max_buckets]
    total = sum(len(b) for b in ranked)
    out = []
    for b in ranked:
        b.sort()
        out.append((int(b[len(b) // 2]), round(len(b) / total, 4)))
    out.sort()
    return tuple(out)


def recording_profile(recording: dict) -> dict:
    """The measured shape of a recording — what spec_from_recording
    fits from and what replay_fidelity compares against."""
    records = workload_records(recording)
    reads = [r for r in records if r["route"] in READ_ROUTES]
    writes = [r for r in records if r["route"] in WRITE_ROUTES]
    deletes = [r for r in records if r["route"] in DELETE_ROUTES]
    n = len(records)
    key_counts = Counter(
        str(r.get("path") or "").partition("?")[0] for r in reads)
    write_sizes = [int(r.get("in") or 0) for r in writes]
    read_sizes = [int(r.get("out") or 0) for r in reads]
    ts = [float(r.get("ts") or 0.0) for r in records if r.get("ts")]
    window_s = max(ts) - min(ts) if len(ts) >= 2 else 0.0
    submit_writes = sum(1 for r in writes
                        if (r.get("handler") or "") == "submit")
    budgets = sorted(float(r["ddl_s"]) for r in records
                     if r.get("ddl_s"))
    # sample-rate correction: each record carries the recorder's
    # sampling rate at capture time and stands for ~1/sample real
    # requests — a -sample 0.1 recording must replay at PRODUCTION
    # arrival rate, not a tenth of it.  (Mix fractions are invariant
    # under a uniform rate; the rate only scales arrivals.)
    effective = sum(
        1.0 / min(max(float(r.get("sample") or 1.0), 1e-3), 1.0)
        for r in records)
    return {
        "records": n,
        "window_s": round(window_s, 3),
        "observed_rps": round(effective / window_s, 2)
        if window_s > 0 else 0.0,
        "read_fraction": round(len(reads) / n, 4) if n else 0.0,
        "churn_fraction": round(
            len(deletes) / (len(writes) + len(deletes)), 4)
        if (writes or deletes) else 0.0,
        "submit_fraction": round(submit_writes / len(writes), 4)
        if writes else 0.0,
        "distinct_keys": len(key_counts),
        "top_keys": key_counts.most_common(16),
        "zipf_s": round(estimate_zipf_s(list(key_counts.values())), 3),
        "sizes": fit_size_mix(write_sizes or read_sizes),
        "deadline_p50_s": round(budgets[len(budgets) // 2], 3)
        if budgets else 0.0,
    }


def spec_from_recording(recording: dict, name: str = "replay",
                        speed: float = 1.0,
                        duration_s: Optional[float] = None,
                        clients: int = 8,
                        n_volume_servers: int = 1,
                        seed: int = 0xBEE5) -> ScenarioSpec:
    """Fit a recording document (the /cluster/workload/export shape)
    into a replayable ScenarioSpec.  Raises ValueError on a recording
    with no workload records — an empty spec would "pass" replaying
    nothing."""
    prof = recording_profile(recording)
    if not prof["records"]:
        raise ValueError("recording has no workload records to replay "
                        "(only ops/telemetry traffic was captured)")
    speed = max(float(speed), 0.01)
    if duration_s is None:
        duration_s = prof["window_s"] / speed if prof["window_s"] > 0 \
            else 10.0
    duration_s = max(min(float(duration_s), 300.0), 2.0)
    target_rps = round(prof["observed_rps"] * speed, 2) \
        if prof["observed_rps"] > 0 else 0.0
    hot_set = max(min(prof["distinct_keys"], 4096), 8)
    deadline_s = prof["deadline_p50_s"] or 2.0
    spec = ScenarioSpec(
        name=name,
        duration_s=duration_s,
        clients=max(int(clients), 1),
        n_volume_servers=max(int(n_volume_servers), 1),
        read_fraction=prof["read_fraction"],
        churn_fraction=prof["churn_fraction"],
        submit_fraction=prof["submit_fraction"],
        zipf_s=prof["zipf_s"],
        hot_set=hot_set,
        sizes=prof["sizes"],
        deadline_s=deadline_s,
        target_rps=target_rps,
        seed=seed,
        expectations={"max_error_ratio": 0.02,
                      "deadline_overrun_max_ms": 250.0})
    return spec


# --- fidelity ---------------------------------------------------------------

def _spec_op_mix(spec: ScenarioSpec, samples: int = 4000,
                 seed: int = 17) -> dict:
    """What the spec's samplers will actually produce, measured by
    sampling them — the same code path the engine's client loops run,
    so a fit bug cannot hide behind the formula that produced it."""
    rng = Random(seed)
    ops = Counter(pick_op(rng, spec.read_fraction, spec.churn_fraction)
                  for _ in range(samples))
    sizes = SizeSampler(spec.sizes)
    drawn = [sizes.sample(rng) for _ in range(samples)]
    return {"read_fraction": ops["read"] / samples,
            "mean_size": sum(drawn) / samples,
            "delete_fraction": ops["delete"] / samples}


def replay_fidelity(recording: dict, spec: ScenarioSpec,
                    result: Optional[dict] = None,
                    op_tol: float = 0.10, size_tol: float = 0.5,
                    head_tol: float = 0.25,
                    pacing_tol: float = 0.8) -> list[dict]:
    """Machine-check that the fitted spec (and optionally a finished
    replay run's result document) reproduces the recording.  Returns
    the same ``checks`` shape the scenario engine emits: every entry
    carries ok/value/bound, and a replay whose fidelity list has a
    failing entry must not be presented as a faithful reproduction.

      op_mix    — spec-sampled read fraction within op_tol of recorded;
      size_mix  — spec-sampled mean size within (1 ± size_tol)x;
      hot_head  — the recorded top-10 keys' probability mass vs the
                  fitted Zipf head's mass, within head_tol;
      (+ with ``result``) replayed_op_mix — the replay run's measured
      read fraction within 1.5*op_tol of recorded (live runs add
      sampling noise on top of the fit);
      (+ with ``result``) fidelity_pacing — the replay actually
      delivered >= pacing_tol of the spec's open-loop target_rps
      (an under-delivered replay proves nothing about the recorded
      load).
    """
    prof = recording_profile(recording)
    checks: list[dict] = []

    def check(name, ok, value, bound):
        checks.append({"check": name, "ok": bool(ok),
                       "value": value, "bound": bound})

    mix = _spec_op_mix(spec)
    dv = round(abs(mix["read_fraction"] - prof["read_fraction"]), 4)
    check("fidelity_op_mix", dv <= op_tol, dv, op_tol)

    rec_sizes = prof["sizes"]
    rec_mean = sum(b * w for b, w in rec_sizes) / \
        max(sum(w for _b, w in rec_sizes), 1e-9)
    ratio = round(mix["mean_size"] / max(rec_mean, 1.0), 3)
    check("fidelity_size_mix",
          1.0 - size_tol <= ratio <= 1.0 + size_tol, ratio,
          [round(1.0 - size_tol, 2), round(1.0 + size_tol, 2)])

    total_reads = sum(c for _k, c in prof["top_keys"]) if prof[
        "top_keys"] else 0
    all_read_count = max(
        sum(1 for r in workload_records(recording)
            if r["route"] in READ_ROUTES), 1)
    if prof["distinct_keys"] >= 2 and total_reads:
        head_n = min(10, prof["distinct_keys"])
        rec_head = sum(c for _k, c in prof["top_keys"][:head_n]) \
            / all_read_count
        zipf = ZipfSampler(spec.hot_set, spec.zipf_s)
        fit_head = sum(zipf.pmf(r) for r in range(head_n))
        dh = round(abs(fit_head - rec_head), 4)
        check("fidelity_hot_head", dh <= head_tol, dh, head_tol)

    if result is not None:
        routes = result.get("routes") or {}
        total = sum(r["ops"] for r in routes.values())
        reads = (routes.get("read") or {}).get("ops", 0)
        if total:
            dv = round(abs(reads / total - prof["read_fraction"]), 4)
            check("fidelity_replayed_op_mix", dv <= 1.5 * op_tol, dv,
                  round(1.5 * op_tol, 3))
        # open-loop pacing actually delivered: an under-delivered
        # replay (client pool could not keep the recorded schedule
        # against a slow build) must not be presented as "faced
        # recorded arrivals" — the same honesty rule the capacity
        # probe enforces with its achieved >= 92% gate (replay gets
        # more slack: short drills quantize per-client schedules)
        if spec.target_rps > 0 and total:
            wall = float(result.get("wall_s") or spec.duration_s) or 1.0
            achieved = round(total / wall / spec.target_rps, 3)
            check("fidelity_pacing", achieved >= pacing_tol, achieved,
                  pacing_tol)
    return checks
