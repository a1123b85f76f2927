"""Group commit in the port against the reference's (volume_write.py).

The reference's tests/test_volume_write.py cases, run on the port's
Volume; where the files are compared, one writer feeds both packages the
same needles, so the `.dat` and `.idx` must be equal byte for byte.
"""

from __future__ import annotations

import os
import threading
import time

import pytest

from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.utils import faultinject as ref_fi
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map_compact import (
    CheckpointedNeedleMap)
from seaweedfs_tpu_torch.storage.volume import CookieMismatchError, Volume
from seaweedfs_tpu_torch.storage.volume_write import GroupCommitWorker
from seaweedfs_tpu_torch.utils import faultinject as fi
from seaweedfs_tpu_torch.volume_server.store import Store


@pytest.fixture
def vol(tmp_path):
    v = Volume(str(tmp_path), "", 1)
    yield v
    v.close()


def dat_of(v):
    return v._live[1]


def slow_sync(dat, seconds: float):
    real = dat.sync

    def sync():
        time.sleep(seconds)
        real()

    dat.sync = sync


def stamped(cls, cookie: int, nid: int, data: bytes = b"", ns: int = 0):
    n = cls(cookie=cookie, id=nid, data=data)
    n.append_at_ns = ns or 1_700_000_000_000_000_000 + nid
    return n


def test_fsync_write_roundtrip(vol):
    _, size, unchanged = vol.write_needle2(
        Needle(cookie=0x11, id=1, data=b"alpha"), fsync=True)
    assert size == 4 + 5 + 1 and not unchanged
    assert vol.read_needle(1).data == b"alpha"
    assert vol._group_commit.fsync_count == 1


def test_concurrent_writers_batch_into_few_fsyncs(vol):
    """With a slow fsync the queue backs up behind a batch, so the next
    batch takes many requests."""
    vol.write_needle2(Needle(cookie=1, id=1000, data=b"w"), fsync=True)
    slow_sync(dat_of(vol), 0.02)
    n_writers = 48
    errors = []

    def write(i):
        try:
            vol.write_needle2(Needle(cookie=i, id=i + 1, data=b"d%d" % i),
                              fsync=True)
        except Exception as e:  # pragma: no cover - the assert shows it
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i,))
               for i in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    w = vol._group_commit
    assert w.request_count == n_writers + 1
    assert w.fsync_count < n_writers, "no batching happened"
    assert w.fsync_count == w.batch_count
    for i in range(n_writers):
        assert vol.read_needle(i + 1).data == b"d%d" % i


def test_delete_through_worker(vol):
    vol.write_needle2(Needle(cookie=7, id=42, data=b"gone"), fsync=True)
    assert vol.delete_needle2(Needle(cookie=7, id=42), fsync=True) == 4 + 4 + 1
    with pytest.raises(KeyError):
        vol.read_needle(42)
    assert vol.delete_needle2(Needle(cookie=7, id=42), fsync=True) == 0


def test_logical_error_fails_only_that_request(vol):
    vol.write_needle2(Needle(cookie=1, id=5, data=b"orig"), fsync=True)
    w = vol.group_commit_worker()
    good = w.submit_write(Needle(cookie=2, id=6, data=b"ok"))
    bad = w.submit_write(Needle(cookie=999, id=5, data=b"clobber"))
    good.wait(5)
    with pytest.raises(CookieMismatchError):
        bad.wait(5)
    assert vol.read_needle(5).data == b"orig"
    assert vol.read_needle(6).data == b"ok"


def test_fsync_failure_rolls_the_batch_back_as_the_reference(tmp_path):
    """A batch whose fsync fails: every request fails, the `.dat` and the
    `.idx` are cut back to where the batch began, the map is reloaded,
    and the files equal the reference's after the same sequence."""
    results = {}
    for side, vol_cls, needle_cls, faults in (
            ("r", RefVolume, RefNeedle, ref_fi), ("p", Volume, Needle, fi)):
        v = vol_cls(str(tmp_path / side), "", 1)
        try:
            v.write_needle2(stamped(needle_cls, 1, 1, b"keep"), fsync=True)
            before = (v.data_size, os.path.getsize(v.idx_path))
            w = v.group_commit_worker()
            faults.enable("disk.sync", error_rate=1.0, max_hits=1)
            reqs = [w.submit_write(stamped(needle_cls, i, 100 + i,
                                           b"x" * 64)) for i in range(5)]
            for r in reqs:
                with pytest.raises(OSError):
                    r.wait(5)
            faults.clear()
            assert w.rollback_count == 1
            assert (v.data_size, os.path.getsize(v.idx_path)) == before
            for i in range(5):
                with pytest.raises(KeyError):
                    v.read_needle(100 + i)
            v.write_needle2(stamped(needle_cls, 9, 200, b"after"),
                            fsync=True)
            assert v.read_needle(200).data == b"after"
            assert v.read_needle(1).data == b"keep"
            results[side] = (v.data_size, os.path.getsize(v.idx_path))
        finally:
            faults.clear()
            v.close()
    assert results["p"] == results["r"]
    for ext in (".dat", ".idx"):
        assert (tmp_path / "p" / f"1{ext}").read_bytes() == \
            (tmp_path / "r" / f"1{ext}").read_bytes()


def test_rollback_preserves_needle_map_kind(tmp_path):
    v = Volume(str(tmp_path), "", 11, needle_map_kind="ldb")
    try:
        v.write_needle2(Needle(cookie=1, id=1, data=b"ok"), fsync=True)
        fi.enable("disk.sync", error_rate=1.0, max_hits=1)
        with pytest.raises(OSError):
            v.write_needle2(Needle(cookie=2, id=2, data=b"fails"),
                            fsync=True)
        assert isinstance(v.nm, CheckpointedNeedleMap), type(v.nm)
        assert v.read_needle(1).data == b"ok"
        with pytest.raises(KeyError):
            v.read_needle(2)
    finally:
        fi.clear()
        v.close()


def test_torn_write_crash_recovery_after_batch(tmp_path):
    """A crash that tore the last record off the `.dat` after its index
    entry was written: the reopen drops the entry and the torn bytes."""
    v = Volume(str(tmp_path), "", 2)
    for i in range(4):
        v.write_needle2(Needle(cookie=i, id=i + 1, data=b"data-%d" % i),
                        fsync=True)
    nv_last = v.nm.get(4)
    v._group_commit.stop()
    v._group_commit = None
    nm, dat = v._live
    os.ftruncate(dat.fd, nv_last.offset + 10)
    dat.close()
    nm.close()
    v._live = None

    v2 = Volume(str(tmp_path), "", 2)
    try:
        for i in range(3):
            assert v2.read_needle(i + 1).data == b"data-%d" % i
        with pytest.raises(KeyError):
            v2.read_needle(4)
        assert v2.data_size == nv_last.offset
    finally:
        v2.close()


def test_worker_stop_drains_queue(tmp_path):
    v = Volume(str(tmp_path), "", 3)
    w = v.group_commit_worker()
    reqs = [w.submit_write(Needle(cookie=i, id=i + 1, data=b"z%d" % i))
            for i in range(20)]
    v.close()  # the stop commits what was queued
    for r in reqs:
        r.wait(5)
    late = w.submit_write(Needle(cookie=1, id=99, data=b"late"))
    with pytest.raises(RuntimeError):
        late.wait(5)
    v2 = Volume(str(tmp_path), "", 3)
    try:
        for i in range(20):
            assert v2.read_needle(i + 1).data == b"z%d" % i
    finally:
        v2.close()


def test_worker_respects_batch_limits(tmp_path):
    v = Volume(str(tmp_path), "", 4)
    try:
        w = GroupCommitWorker(v, max_batch_bytes=1024, max_batch_requests=4)
        v._group_commit = w
        slow_sync(dat_of(v), 0.05)
        reqs = [w.submit_write(Needle(cookie=i, id=i + 1, data=b"y" * 100))
                for i in range(16)]
        for r in reqs:
            r.wait(5)
        assert w.batch_count >= 4  # 16 requests fit no fewer batches
        assert w.request_count == 16
    finally:
        v.close()


def test_parked_worker_falls_back_to_direct_durable_write(tmp_path):
    """While a commit has the worker parked, an fsync write makes no new
    worker (its thread would block on the held write lock): it appends
    and fsyncs itself."""
    v = Volume(str(tmp_path), "", 5)
    try:
        v.write_needle2(Needle(cookie=1, id=1, data=b"a"), fsync=True)
        assert v._group_commit is not None
        v._park_worker()
        assert v.group_commit_worker() is None
        _, size, _ = v.write_needle2(Needle(cookie=2, id=2, data=b"bb"),
                                     fsync=True)
        assert v._group_commit is None
        assert v.read_needle(2).data == b"bb"
        assert v.delete_needle2(Needle(cookie=2, id=2), fsync=True) == size
        v._unpark_worker()
        assert v.group_commit_worker() is not None
        assert v.read_needle(1).data == b"a"
    finally:
        v.close()


def test_commit_compact_unparks_worker(tmp_path):
    v = Volume(str(tmp_path), "", 6)
    try:
        v.write_needle2(Needle(cookie=100, id=100, data=b"w"), fsync=True)
        old = v._group_commit
        for i in range(5):
            v.write_needle(Needle(cookie=i, id=i + 1, data=b"d%d" % i))
        v.delete_needle(Needle(cookie=0, id=1))
        v.compact()
        t0 = time.monotonic()
        v.commit_compact()
        assert time.monotonic() - t0 < 5  # no wait on a worker's join
        assert v._worker_parked is False and v._group_commit is None
        assert not old._thread.is_alive()
        v.write_needle2(Needle(cookie=9, id=9, data=b"post"), fsync=True)
        assert v._group_commit is not None
        assert v.read_needle(9).data == b"post"
    finally:
        v.close()


def test_fsync_writes_under_a_commit_neither_hang_nor_get_lost(tmp_path):
    """Fsync writers keep going while compactions commit: each commit
    parks the worker, its writers fall back or queue on the new one, and
    every acknowledged write reads back."""
    v = Volume(str(tmp_path), "", 7)
    done: list[int] = []
    errors: list[BaseException] = []
    stop = threading.Event()

    def writer(base: int) -> None:
        i = 0
        while not stop.is_set() and i < 300:
            nid = base + i
            try:
                v.write_needle2(Needle(cookie=1, id=nid, data=b"%d" % nid),
                                fsync=True)
                done.append(nid)
            except Exception as e:  # pragma: no cover - asserted below
                errors.append(e)
            i += 1

    threads = [threading.Thread(target=writer, args=(k * 10_000,))
               for k in range(1, 5)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            time.sleep(0.05)
            v.compact()
            v.commit_compact()
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    try:
        assert not errors, errors[:3]
        for nid in done:
            assert v.read_needle(nid).data == b"%d" % nid
    finally:
        v.close()


def test_store_fsync_writes_share_fsyncs(tmp_path):
    """16 threads of fsync writes through Store.write_needle: the volume
    lock is not held while they wait, so they batch into fewer fsyncs
    than writes; each is durable and readable on return."""
    store = Store([str(tmp_path)], device="cpu", needle_cache_mb=0)
    try:
        store.add_volume(1)
        v = store.get_volume(1)
        v.write_needle2(Needle(cookie=1, id=1, data=b"first"), fsync=True)
        slow_sync(dat_of(v), 0.005)
        errors = []

        def writer(t: int) -> None:
            for i in range(25):
                nid = 1000 * (t + 1) + i
                try:
                    store.write_needle(1, Needle(cookie=t, id=nid,
                                                 data=b"%d" % nid),
                                       fsync=True)
                except Exception as e:  # pragma: no cover - asserted
                    errors.append(e)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        w = v._group_commit
        assert w.request_count == 16 * 25 + 1
        assert w.fsync_count < w.request_count
        for t in range(16):
            for i in range(25):
                nid = 1000 * (t + 1) + i
                assert store.read_needle(1, nid).data == b"%d" % nid
        assert store.delete_needle(1, Needle(cookie=0, id=1001),
                                   fsync=True) > 0
        assert w.request_count == 16 * 25 + 2
    finally:
        store.close()


def _record_fsyncs(monkeypatch) -> list:
    """Patch os.fsync to note (file name, its size) at each call."""
    seen = []
    real = os.fsync

    def fsync(fd):
        path = os.readlink(f"/proc/self/fd/{fd}")
        seen.append((os.path.basename(path), os.fstat(fd).st_size))
        real(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    return seen


@pytest.mark.parametrize("parked", [False, True],
                         ids=["worker", "parked"])
@pytest.mark.parametrize("kind", ["compact", "memory"])
def test_fsync_write_makes_dat_and_idx_durable_before_it_answers(
        tmp_path, monkeypatch, kind, parked):
    """A write or delete with fsync is answered only once the `.dat` and
    the `.idx` are both fsynced past its record and its index entry: the
    crash check cuts the `.dat` back to what the `.idx` names, so an
    `.idx` entry lost to a power cut would take the record with it."""
    v = Volume(str(tmp_path), "", 1, needle_map_kind=kind)
    try:
        v.write_needle2(Needle(cookie=1, id=1, data=b"warm"), fsync=True)
        if parked:
            v._park_worker()
        for op in ("write", "delete"):
            seen = _record_fsyncs(monkeypatch)
            if op == "write":
                v.write_needle2(Needle(cookie=2, id=2, data=b"durable"),
                                fsync=True)
            else:
                assert v.delete_needle2(Needle(cookie=2, id=2),
                                        fsync=True) > 0
            dat_size = os.path.getsize(v.dat_path)
            idx_size = os.path.getsize(v.idx_path)
            assert ("1.dat", dat_size) in seen, (op, seen)
            assert ("1.idx", idx_size) in seen, (op, seen)
            monkeypatch.undo()
    finally:
        v.close()


def test_failed_idx_fsync_rolls_the_batch_back(tmp_path):
    """An `.idx` fsync that fails is treated as a `.dat` one: every request
    of the batch fails, both files are cut back, and the worker goes on."""
    v = Volume(str(tmp_path), "", 1)
    try:
        v.write_needle2(Needle(cookie=1, id=1, data=b"keep"), fsync=True)
        before = (v.data_size, os.path.getsize(v.idx_path))
        w = v.group_commit_worker()
        nm = v.nm

        def fail():
            raise OSError("idx fsync failed")

        nm.sync = fail
        reqs = [w.submit_write(Needle(cookie=i, id=100 + i, data=b"x" * 64))
                for i in range(5)]
        for r in reqs:
            with pytest.raises(OSError, match="idx fsync"):
                r.wait(5)
        assert w.rollback_count == 1
        assert (v.data_size, os.path.getsize(v.idx_path)) == before
        assert v.nm is not nm
        for i in range(5):
            with pytest.raises(KeyError):
                v.read_needle(100 + i)
        v.write_needle2(Needle(cookie=9, id=200, data=b"after"), fsync=True)
        assert v.read_needle(200).data == b"after"
        assert v.read_needle(1).data == b"keep"
    finally:
        v.close()
