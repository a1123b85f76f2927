"""A port cluster under overload, on the CPU: admission control seen from
the master.

Two port volume servers run as their own processes (``python -m
seaweedfs_tpu_torch volume -ec.engine cpu``), so each has its own metrics
registry, one of them with ``-maxInflight 2``; the master runs in this
process, the port's or the reference's.  An EC volume with data shards 2
and 7 gone lives on the gated server, and twelve readers at once GET its
needles there: every answer is the written bytes or the shed's 503, and
the master's ``/cluster/health`` must count exactly the 503s seen under
``requests_shed``, for that server and in its totals, the other server
reading 0.  Then a GET whose ``X-Weed-Deadline`` is spent: one more
``deadline_exceeded``.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

import chip_smoke
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.utils.httpd import HttpError, http_json
from tests.conftest import free_port

MASTERS = {"port": MasterServer, "reference_master": RefMasterServer}
NEEDLES = 60
READERS, PER_READER = 12, 8


def _wait(what: str, ok, timeout: float = 30.0):
    t0 = time.monotonic()
    while True:
        try:
            got = ok()
        except HttpError:
            got = None
        if got:
            return got
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _needles() -> list[dict]:
    rng = np.random.default_rng(12)
    return [chip_smoke.http_needle(12, i, i + 1, 0x5eed, int(size))
            for i, size in enumerate(rng.integers(50_000, 300_000,
                                                  NEEDLES))]


@pytest.mark.parametrize("kind", list(MASTERS))
def test_cluster_health_counts_every_shed(kind, tmp_path):
    master = MASTERS[kind](port=free_port(), pulse_seconds=0.3)
    master.start()
    procs = []
    try:
        urls = []
        for name, extra in (("gated", ["-maxInflight", "2"]), ("plain", [])):
            port = free_port()
            d = tmp_path / name
            d.mkdir()
            log = str(tmp_path / f"{name}.log")
            procs.append((chip_smoke.start_cli(
                ["volume", "-dir", str(d), "-port", str(port), "-mserver",
                 master.url, "-pulseSeconds", "0.3", "-ec.engine", "cpu",
                 *extra], log), log))
            urls.append(f"127.0.0.1:{port}")
        for proc, log in procs:
            chip_smoke.read_start_line(proc, log, "volume server listening")
        gated, plain = urls
        conn = chip_smoke.Conn(gated)
        try:
            conn.admin("/admin/assign_volume", {"volume_id": 1})
            needles = _needles()
            for n in needles:
                status, _b, _r = conn.call("PUT", n["path"] + n["query"],
                                           n["body"], n["headers"])
                assert status == 201
            for path, body in (
                    ("/admin/readonly", {"volume_id": 1}),
                    ("/admin/ec/generate", {"volume_id": 1}),
                    ("/admin/ec/mount", {"volume_id": 1}),
                    ("/admin/delete_volume", {"volume_id": 1}),
                    ("/admin/ec/delete", {"volume_id": 1,
                                          "shard_ids": [2, 7]})):
                conn.admin(path, body)
        finally:
            conn.close()
        # a lost shard's lookup finds the volume and no other holder
        _wait("the master to list the gated server's shards",
              lambda: len(http_json("GET", f"http://{master.url}/dir/"
                                    f"lookup_ec?volumeId=1")["shards"]) == 12)

        seen: list[int] = []
        errors: list[BaseException] = []

        def reader(t: int) -> None:
            c = chip_smoke.Conn(gated)
            try:
                for i in np.random.default_rng([12, t]).choice(
                        NEEDLES, size=PER_READER):
                    n = needles[int(i)]
                    status, body, r = c.call("GET", n["path"])
                    if status == 200:
                        assert body == n["data"]
                    else:
                        assert status == 503, (status, body[:200])
                        assert r.getheader("Retry-After") == "1"
                        assert json.loads(body) == {
                            "error": "overloaded: request shed"}
                    seen.append(status)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
            finally:
                c.close()

        workers = [threading.Thread(target=reader, args=(t,))
                   for t in range(READERS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(120)
        assert not errors, errors[:1]
        shed = seen.count(503)
        assert len(seen) == READERS * PER_READER and 0 < shed < len(seen)

        def health(want_shed: int, want_ddl: int):
            doc = http_json("GET", f"http://{master.url}/cluster/health")
            peers = {u: doc["peers"][u]["pipeline_health"] for u in urls}
            got = (doc["totals"]["requests_shed"],
                   doc["totals"]["deadline_exceeded"],
                   peers[gated]["requests_shed"],
                   peers[plain]["requests_shed"])
            return doc if got == (want_shed, want_ddl, want_shed, 0) \
                else None

        doc = _wait("/cluster/health to count the sheds",
                    lambda: health(shed, 0))
        assert doc["degraded"] is True  # a shedding cluster pages
        # a GET whose caller gave up: 504, counted, nothing shed
        c = chip_smoke.Conn(gated)
        try:
            status, _b, _r = c.call("GET", needles[0]["path"],
                                    headers={"X-Weed-Deadline": "0"})
        finally:
            c.close()
        assert status == 504
        _wait("/cluster/health to count the 504", lambda: health(shed, 1))
        events = http_json("GET", f"http://{gated}/debug/events?"
                                  f"type=load_shed")["events"]
        assert events and all(e["details"] == {
            "role": "volume", "inflight": 2, "max_inflight": 2}
            for e in events)
        # the admitted GETs rebuilt their lost intervals on the server
        counts = chip_smoke.stop_volume_server(procs[0][0])
        assert counts["reconstructed"] > 0 and counts["remote"] == 0
        assert counts["launches"] == 0  # the plain versions
        assert not os.path.exists(tmp_path / "gated" / "1.dat")
    finally:
        master.stop()
        for proc, _log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
