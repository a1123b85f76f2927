"""Rehearse chip_smoke.py's failover phase on the CPU at a tiny size:
three CLI masters (``-peers``, ``-mdir``, ``WEED_FAULTS`` slowing the
coordinator's legs), four ``-ec.engine cpu`` volume servers, the leader
SIGKILLed mid-repair, and the reference's budgets held."""

from __future__ import annotations

import chip_smoke


def test_failover_phase_on_cpu(tmp_path):
    res = chip_smoke.run_failover_phase("cpu", str(tmp_path), 6 << 20,
                                        threads=4, pulse_seconds=0.3,
                                        coordinator_seconds=0.5,
                                        delay_s=0.5)
    assert all(res["checks"].values()), res["checks"]
    assert set(res["checks"]) == set(chip_smoke.FAILOVER_BUDGETS) | \
        {"attribution"}
    assert res["journal_loss_count"] == 0 and res["pre_kill_events"] > 0
    att = res["attribution"]
    assert att["equal"] and att["planned"]["alert"] and \
        att["planned"]["cause_event"] and att["planned"]["cause_trace"]
    rep = res["repair"]
    assert rep["new_leader"] != rep["killed_leader"]
    assert rep["host"] in res["servers"]
    assert res["rebuilt_shard"]["sha256_equal"]
    assert res["cluster_raft"][0].startswith(
        f"masters: 3 (leader {rep['new_leader']}, term ")
    assert any("unreachable" in line for line in res["cluster_raft"])
    assert sum(v["IsLeader"] for v in res["cluster_status"].values()) == 1
    # the new leader's repair legs were slowed, and the stop line says so
    hits = res["faults_injected"][rep["new_leader"]].get("coord.exec", 0)
    assert hits > 0 and res["new_leader_injected_delay_s"] == hits * 0.5
    # the dispatch rule is computed even where no kernel is counted
    assert res["launches"]["dispatch_rule"] >= 1
