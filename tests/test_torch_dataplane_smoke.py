"""Rehearse chip_smoke.py's ``dataplane`` phase on the CPU at a tiny size:
the master, five volume servers, ``benchmark`` (over HTTP and, with
``-useTcp``, over the framed planes), the batch leg and the shell through
the CLI on the plain versions, the same checks as on the card."""

from __future__ import annotations

import chip_smoke


def test_dataplane_phase_on_cpu(tmp_path):
    # 16 KiB needles: the one volume passes 10 MiB, so every data shard
    # holds some (1 MiB blocks), and the stopped server's are read
    res = chip_smoke.run_dataplane_phase(
        "cpu", str(tmp_path), n=800, size=16 << 10, clients=4, zipf=300,
        degraded=80, threaded_writes=40, volumes=1, pulse_seconds=0.3,
        batch_needles=120, batch=50)
    assert sorted(res["needles_by_volume"]) == sorted(res["volumes"])
    # the HTTP writes, then each front's framed writes
    assert sum(res["needles_by_volume"].values()) == 840 + 2 * 800
    for front in ("reactor", "threaded"):
        tcp = res["tcp"][front]
        assert (tcp["write"]["n"], tcp["read"]["n"], tcp["zipf"]["n"]) == \
            (800, 800, 300)
        assert tcp["mismatches"] == 0
        # every assign of the write pass went over the framed front
        assert tcp["http_assigns_during_write"] == 0
        assert tcp["framed_assign"]["fid"]
        assert tcp["degraded_binds"] == {"volume_servers": 0, "master": 0}
    assert set(res["degraded_binds"]) == {
        "start_0_reactor", "start_1_threaded", "start_2_reactor",
        "restart_threaded"}
    batch = res["batch"]
    # 120 needles of the one volume, 50 a request; as many written fresh
    assert batch["batches_read"] == 3 and batch["written"] == 150
    assert batch["bytes_equal"] and batch["torn_write"]["status"] == 400
    for front in ("reactor", "threaded"):
        fr = res["fronts"][front]
        assert fr["read"]["n"] == 800 and fr["zipf"]["n"] == 300
        if front == "reactor":  # reactor, threaded, reactor again
            assert fr["read_again"]["n"] == 800
        assert fr["read"]["mismatches"] == fr["zipf"]["mismatches"] == 0
        counts = fr["read_zipf_counts"]
        # the Zipf head is read again and again: the cache serves it
        assert counts["hits"] > 0 and counts["conn_aborts"] == 0
        if front == "reactor":
            assert counts["fast_dispatches"] > 0
        else:
            assert counts["fast_dispatches"] == 0
        for name in ("1_client", "4_clients"):
            d = fr[f"degraded_{name}"]
            assert d["gets"] == 80 and d["bytes_equal"]
            # the plain versions launch nothing on the CPU
            assert d["launches"] == 0 and d["launches_rule"] > 0
            assert "b" in d["ms"]
    assert len(res["lost_data_shards"]) >= 2


def test_profile_layers_tell_the_pooled_client_by_line():
    """httpd.py's server and client share method names (``__init__``,
    ``close``, ``request``): a sample's layer follows the frame's line, so
    a request parse on the server is ``httpd`` and a pooled call's read is
    ``http_client``."""
    import inspect

    from seaweedfs_tpu_torch.utils import httpd

    def label(obj) -> str:
        return f"{obj.__name__} (httpd.py:{inspect.getsourcelines(obj)[1] + 1})"

    server = f"{label(httpd.Request.__init__)};parse_qs (parse.py:700)"
    client = (f"{label(httpd.http_json)};{label(httpd._RawConn.request)};"
              f"{label(httpd._RawConn.__init__)}")
    summary = chip_smoke.profile_summary(
        f"worker-1;{server} 3\nworker-2;{client} 1\n")
    assert summary["busy_samples"] == 4
    assert summary["self_share"]["httpd"] == 0.75
    assert summary["self_share"]["http_client"] == 0.25
    assert summary["under_share"]["http_client"] == 0.25
