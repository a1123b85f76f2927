"""Rehearse chip_smoke.py's ``volume_store`` phase on the CPU at a tiny
size: the fill, both needle-map kinds opened in fresh interpreters, the
batch delete, /stats/*, group commit, backup twice, fix, export, upload,
download, the seal and the degraded GETs, with the card's checks."""

from __future__ import annotations

import os
import subprocess
import sys

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_volume_store_phase_on_cpu(tmp_path):
    n = 3000
    res = chip_smoke.run_volume_store_phase(
        "cpu", str(tmp_path), n=n, size=1024, batch_deletes=100, missing=10,
        gc_threads=4, gc_per_thread=25, more=60, more_deletes=12,
        degraded=40, follower_seed=n // 2)
    opens = res["open"]
    assert opens["compact"]["live"] == opens["memory"]["live"] == n
    assert opens["compact"]["counters"] == opens["memory"]["counters"]
    assert res["batch_delete"]["delete_count"][1] - \
        res["batch_delete"]["delete_count"][0] == 100
    assert set(res["stats"]) == {"/stats/counter", "/stats/memory",
                                 "/stats/disk"}
    assert res["stats"]["/stats/memory"]["Memory"]["MaxRssKb"] > 0
    gc = res["group_commit"]
    assert gc["fsync"]["writes"] == gc["plain"]["writes"] == 100
    assert gc["worker"]["request_count"] == 100
    assert gc["worker"]["fsync_count"] < 100
    # the follower starts from a copy of the first half
    assert res["backup"]["applied"] == [n - n // 2 + 100, 72]
    assert res["fix"]["live"] == res["export"]["listed"] == n - 100 + 60 - 12
    assert res["upload"]["bytes_equal"]
    seal = res["seal"]
    assert seal["gets"] == 40 and seal["ecx_equal_to_plain"]
    assert seal["lost_intervals"] > 0 and seal["kernel_max_abs_err"] == 0
    # the plain versions launch nothing on the CPU
    assert res["launches"] == seal["get_launches"] == 0


def test_bulk_fill_writes_what_write_needle_writes(tmp_path):
    """The fill's bulk records and index entries equal write_needle's for
    the same needles and append times, across a payload block's edge."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    seed, size, base_ns = 7, 1024, 1_700_000_000_000_000_000
    first, last = 3, chip_smoke.PAYLOAD_GROUP + 40
    for side in ("direct", "bulk"):
        v = Volume(str(tmp_path / side), "", 1)
        for nid in range(1, first):
            n = Needle(cookie=chip_smoke.store_cookie(seed, nid), id=nid,
                       data=chip_smoke.store_payload(seed, nid, size))
            n.append_at_ns = base_ns + nid
            v.write_needle(n)
        if side == "direct":
            for nid in range(first, last):
                n = Needle(cookie=chip_smoke.store_cookie(seed, nid), id=nid,
                           data=chip_smoke.store_payload(seed, nid, size))
                n.append_at_ns = base_ns + nid
                v.write_needle(n)
            v.close()
        else:
            v.close()
            chip_smoke.bulk_fill(str(tmp_path / side / "1"), first, last,
                                 size, seed, base_ns)
    for ext in (".dat", ".idx"):
        assert (tmp_path / "bulk" / f"1{ext}").read_bytes() == \
            (tmp_path / "direct" / f"1{ext}").read_bytes()
    v = Volume(str(tmp_path / "bulk"), "", 1)
    try:
        assert v.read_needle(last - 1).data == \
            chip_smoke.store_payload(seed, last - 1, size)
    finally:
        v.close()


def test_chip_phase_runs_nothing_without_a_card():
    for args in (["volume_store"], ["dataplane", "parent"], ["nothing"], []):
        r = subprocess.run([sys.executable, "chip_phase.py", *args],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 2 and not r.stdout, args
