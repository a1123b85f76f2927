"""Tailing a volume by append time: the port's volume_backup.py and
``/admin/tail`` against the reference's.

One source volume the reference wrote (its needles stamped with seeded
append times) is copied for the port.  ``records_since`` must give the
reference's blobs and last times from every starting point and size cap;
an incremental backup with deletes and a resume must leave a follower
equal to the reference's follower (and to the source) byte for byte; and
a reference server's ``/admin/tail`` must feed the port's backup, and the
port's the reference's.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import volume_backup as ref_backup
from seaweedfs_tpu.storage.needle import FLAG_HAS_NAME as REF_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.storage import volume_backup as backup
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

T0 = 1_700_000_000_000_000_000


def write_history(v, needle_cls, has_name: int, seed: int, first: int,
                  count: int, t0: int, deletes=()):
    """``count`` seeded needles from id ``first``, each stamped t0 + its
    index in microseconds, then tombstones for ``deletes``."""
    rng = np.random.default_rng(seed)
    for i in range(count):
        nid = first + i
        n = needle_cls(cookie=0x5000 + nid, id=nid,
                       data=rng.bytes(int(rng.integers(1, 4000))))
        if nid % 3 == 0:
            n.name = b"n%d.bin" % nid
            n.set_flag(has_name)
        n.append_at_ns = t0 + 1000 * i
        v.write_needle(n)
    for j, nid in enumerate(deletes):
        t = needle_cls(cookie=0x5000 + nid, id=nid)
        t.append_at_ns = t0 + 1000 * (count + j)
        v.delete_needle(t)


@pytest.fixture
def sources(tmp_path):
    ref = RefVolume(str(tmp_path / "ref"), "", 4)
    write_history(ref, RefNeedle, REF_HAS_NAME, 1, 1, 120, T0,
                  deletes=(3, 50, 51))
    ref.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref = RefVolume(str(tmp_path / "ref"), "", 4)
    port = Volume(str(tmp_path / "port"), "", 4)
    yield ref, port
    ref.close()
    port.close()


def test_records_since_equals_the_reference(sources):
    ref, port = sources
    stamps = [0, T0 - 1, T0, T0 + 1, T0 + 1000 * 57 + 3, T0 + 1000 * 119,
              T0 + 1000 * 122, T0 + 10 ** 12]
    for since in stamps:
        for cap in (64 << 20, 10_000, 1):
            want = ref_backup.records_since(ref, since, max_bytes=cap)
            got = backup.records_since(port, since, max_bytes=cap)
            assert got == want, (since, cap)
        assert backup.binary_search_by_append_at_ns(port, since) == \
            ref_backup.binary_search_by_append_at_ns(ref, since)
    assert backup.last_appended_ns(port) == ref_backup.last_appended_ns(ref)
    blob, last = backup.records_since(port, 0)
    assert len(list(backup.iter_records(blob, port.version))) == 123
    assert last == T0 + 1000 * 122


def _follow(follower, source, mod, cap: int = 64 << 20) -> int:
    return mod.incremental_backup(
        follower, lambda since: mod.records_since(source, since,
                                                  max_bytes=cap))


def test_incremental_backup_with_deletes_and_a_resume(tmp_path, sources):
    ref, port = sources
    fr = RefVolume(str(tmp_path / "fr"), "", 4)
    fp = Volume(str(tmp_path / "fp"), "", 4)
    assert _follow(fr, ref, ref_backup, cap=50_000) == \
        _follow(fp, port, backup, cap=50_000) == 123
    fr.close()
    fp.close()
    # more writes and deletes at the sources; the followers reopen and
    # resume from their own last record
    write_history(ref, RefNeedle, REF_HAS_NAME, 2, 500, 40, T0 + 10 ** 9,
                  deletes=(7, 505, 120))
    write_history(port, Needle, FLAG_HAS_NAME, 2, 500, 40, T0 + 10 ** 9,
                  deletes=(7, 505, 120))
    fr = RefVolume(str(tmp_path / "fr"), "", 4)
    fp = Volume(str(tmp_path / "fp"), "", 4)
    try:
        assert _follow(fp, port, backup) == _follow(fr, ref, ref_backup) == 43
        assert _follow(fp, port, backup) == 0
        with pytest.raises(KeyError):
            fp.read_needle(505)
        assert fp.read_needle(8).data == port.read_needle(8).data
    finally:
        fr.close()
        fp.close()
    for ext in (".dat", ".idx"):
        follower = (tmp_path / "fp" / f"4{ext}").read_bytes()
        assert follower == (tmp_path / "fr" / f"4{ext}").read_bytes(), ext
    assert (tmp_path / "fp" / "4.dat").read_bytes() == \
        (tmp_path / "port" / "4.dat").read_bytes()


def _tail_fetch(url: str, vid: int, cap: int):
    def fetch(since: int):
        status, body, headers = http_bytes(
            "GET", f"http://{url}/admin/tail?volume_id={vid}"
            f"&since_ns={since}&max_bytes={cap}")
        assert status == 200, body
        return body, int(headers["X-Last-Append-At-Ns"])
    return fetch


def test_tail_route_feeds_the_other_package(tmp_path, sources):
    ref, port = sources
    src_dir = os.path.dirname(port.dat_path)
    ref.close()
    port.close()
    master = f"127.0.0.1:{free_port()}"
    ref_srv = RefVolumeServer([str(tmp_path / "ref")], master,
                              port=free_port(), pulse_seconds=30,
                              ec_engine="cpu", tcp=False, heat=False,
                              ledger=False, needle_cache_mb=0).start()
    port_srv = VolumeServer([src_dir], master, port=free_port(),
                            pulse_seconds=30, device="cpu").start()
    try:
        for since in (0, T0 + 1000 * 60, T0 + 10 ** 12):
            answers = [http_bytes(
                "GET", f"http://{s.url}/admin/tail?volume_id=4"
                f"&since_ns={since}&max_bytes=30000")
                for s in (ref_srv, port_srv)]
            assert answers[1][:2] == answers[0][:2], since
            for h in ("X-Last-Append-At-Ns", "X-Volume-Version"):
                assert answers[1][2][h] == answers[0][2][h], (since, h)
        for s in (ref_srv, port_srv):
            status, body, _ = http_bytes(
                "GET", f"http://{s.url}/admin/tail?volume_id=99")
            assert status == 404 and b"volume 99 not found" in body
        # the port's follower from the reference's server, and back
        fp = Volume(str(tmp_path / "fp"), "", 4)
        fr = RefVolume(str(tmp_path / "fr"), "", 4)
        try:
            assert backup.incremental_backup(
                fp, _tail_fetch(ref_srv.url, 4, 30000)) == 123
            assert ref_backup.incremental_backup(
                fr, _tail_fetch(port_srv.url, 4, 30000)) == 123
        finally:
            fp.close()
            fr.close()
        for d in ("fp", "fr"):
            assert (tmp_path / d / "4.dat").read_bytes() == \
                (tmp_path / "ref" / "4.dat").read_bytes(), d
        assert http_json("GET", f"http://{port_srv.url}/status")[
            "Volumes"][0]["file_count"] == 120
    finally:
        port_srv.stop()
        ref_srv.stop()
