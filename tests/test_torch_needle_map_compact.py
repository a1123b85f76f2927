"""The port's needle-map kinds against the reference's, at tolerance 0.

The same seeded sequence of puts and deletes goes to the reference's
CompactNeedleMap, the port's CompactNeedleMap and the port's
MemoryNeedleMap: lookups, counters, iteration order and `.idx` bytes must
be equal.  The `.ldb` snapshot and the `.sdx` sorted file must equal the
reference's byte for byte, and a Volume of each kind must write the
reference's `.dat` and `.idx`.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle_map_compact as ref_nmc
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.storage import needle_map_compact as nmc
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map import MemDb, MemoryNeedleMap
from seaweedfs_tpu_torch.storage.needle_map_compact import (
    CheckpointedNeedleMap, CompactNeedleMap, SortedFileNeedleMap)
from seaweedfs_tpu_torch.storage.volume import Volume

KINDS = ("compact", "memory", "ldb", "sorted")


def random_ops(seed: int, n: int = 3000, keyspace: int = 700) -> list:
    """Puts (mostly in ascending key order, some not) and deletes."""
    rng = np.random.default_rng(seed)
    ops, next_key = [], 1
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            ops.append(("del", int(rng.integers(1, keyspace)), 0, 0))
            continue
        if r < 0.6 and next_key < keyspace:
            key = next_key  # an ascending append: the tail
            next_key += int(rng.integers(1, 3))
        else:
            key = int(rng.integers(1, keyspace))
        ops.append(("put", key, int(rng.integers(1, 1 << 20)) * 8,
                    int(rng.integers(1, 5000))))
    return ops


def apply(m, ops) -> None:
    for op, key, off, size in ops:
        if op == "put":
            m.put(key, off, size)
        else:
            m.delete(key, off or 8)


def counters(m) -> tuple:
    return (m.file_counter, m.file_byte_counter, m.deletion_counter,
            m.deletion_byte_counter, m.max_file_key)


def entries(m) -> list[tuple]:
    return [(nv.key, nv.offset, nv.size) for nv in m]


@pytest.fixture
def small_sections(monkeypatch):
    """Sections, tail flushes and overflow merges every few dozen
    entries, in both packages, so a short sequence crosses each."""
    for mod in (nmc, ref_nmc):
        monkeypatch.setattr(mod, "_SECTION", 64)
        monkeypatch.setattr(mod, "_TAIL_FLUSH", 32)
        monkeypatch.setattr(mod, "_OVERFLOW_MERGE", 50)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compact_map_equals_reference_and_memory_map(tmp_path, seed,
                                                     small_sections):
    ops = random_ops(seed)
    ref = ref_nmc.CompactNeedleMap(str(tmp_path / "ref.idx"))
    port = CompactNeedleMap(str(tmp_path / "port.idx"))
    mem = MemoryNeedleMap(str(tmp_path / "mem.idx"))
    flushes = merges = 0
    for step in range(0, len(ops), 100):
        chunk = ops[step:step + 100]
        before = (len(port._sections), len(port._over))
        for m in (ref, port, mem):
            apply(m, chunk)
        flushes += len(port._sections) > before[0]
        merges += len(port._over) < before[1]
        assert counters(port) == counters(ref) == counters(mem)
    assert flushes and merges
    for key in range(0, 702):
        p, r = port.get(key), ref.get(key)
        assert p == mem.get(key), key
        assert (p and (p.key, p.offset, p.size)) == \
            (r and (r.key, r.offset, r.size)), key
    assert entries(port) == entries(ref) == entries(mem)
    visited = []
    port.ascending_visit(lambda nv: visited.append((nv.key, nv.offset,
                                                    nv.size)))
    assert visited == entries(port) and len(port) == len(visited)
    for m in (ref, port, mem):
        m.close()
    blobs = {name: (tmp_path / f"{name}.idx").read_bytes()
             for name in ("ref", "port", "mem")}
    assert blobs["port"] == blobs["ref"] == blobs["mem"]


@pytest.mark.parametrize("seed", [4, 5])
def test_vectorized_replay_equals_scalar_replay(tmp_path, seed):
    path = str(tmp_path / "r.idx")
    m = MemoryNeedleMap(path)
    apply(m, random_ops(seed, n=2000, keyspace=300))
    m.close()
    scalar = MemoryNeedleMap.load(path)
    vector = CompactNeedleMap.load(path)
    ref = ref_nmc.CompactNeedleMap.load(path)
    assert counters(vector) == counters(scalar) == counters(ref)
    assert entries(vector) == entries(scalar) == entries(ref)
    for key in range(300):
        assert vector.get(key) == scalar.get(key)
    for x in (scalar, vector, ref):
        x.close()


def test_replay_counts_a_delete_of_a_key_never_live(tmp_path):
    """Live, a delete of an absent key counts nothing; replayed, it counts
    one deletion (doLoading), in both packages and both kinds."""
    path = str(tmp_path / "d.idx")
    m = CompactNeedleMap(path)
    m.put(1, 8, 10)
    m.delete(2, 16)
    assert m.deletion_counter == 0
    m.close()
    for cls in (CompactNeedleMap, MemoryNeedleMap, ref_nmc.CompactNeedleMap):
        r = cls.load(path)
        assert r.deletion_counter == 1, cls
        r.close()


def _ldb_history(cls, path: str, truncate_to: int = 0) -> None:
    m = cls(path)
    for k in range(1, 500):
        m.put(k, k * 8, 100 + k)
    m.put(40, 4000 * 8, 7)       # over a live put
    m.delete(77, 8)
    m.checkpoint()
    for k in range(900, 500, -7):  # out of order: the overflow
        m.put(k, k * 8, 20)
    m.delete(5, 8)
    m.close()  # a second checkpoint
    if truncate_to:
        with open(path, "r+b") as f:
            f.truncate(truncate_to)


@pytest.mark.parametrize("truncate_to", [0, 16 * 10])
def test_ldb_snapshot_bytes_equal_the_reference(tmp_path, truncate_to):
    """The `.ldb` written at checkpoints and at close is the reference's;
    after a cut `.idx` both throw the snapshot away and replay it all, and
    the checkpoint at their close writes equal snapshots again."""
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    rpath, ppath = str(tmp_path / "r" / "v.idx"), str(tmp_path / "p" / "v.idx")
    _ldb_history(ref_nmc.CheckpointedNeedleMap, rpath, truncate_to)
    _ldb_history(CheckpointedNeedleMap, ppath, truncate_to)
    rldb, pldb = (tmp_path / "r" / "v.ldb"), (tmp_path / "p" / "v.ldb")
    assert pldb.read_bytes() == rldb.read_bytes()
    ref = ref_nmc.CheckpointedNeedleMap.load(rpath)
    port = CheckpointedNeedleMap.load(ppath)
    full = MemoryNeedleMap.load(ppath)
    assert port._loaded_from_snapshot == ref._loaded_from_snapshot \
        == (not truncate_to)
    assert counters(port) == counters(ref) == counters(full)
    assert entries(port) == entries(ref) == entries(full)
    port.put(2000, 16000, 3)
    ref.put(2000, 16000, 3)
    port.close()
    ref.close()
    assert pldb.read_bytes() == rldb.read_bytes()


def test_ldb_tail_past_the_snapshot_after_a_crash(tmp_path):
    path = str(tmp_path / "t.idx")
    m = CheckpointedNeedleMap(path)
    for k in range(1, 100):
        m.put(k, k * 8, 10)
    m.checkpoint()
    for k in range(100, 130):
        m.put(k, k * 8, 20)
    m.delete(5, 8)
    m._index_file.close()  # a crash: no checkpoint at close
    m._index_file = None
    port = CheckpointedNeedleMap.load(path)
    ref = ref_nmc.CheckpointedNeedleMap.load(path)
    full = MemoryNeedleMap.load(path)
    assert port._loaded_from_snapshot
    assert counters(port) == counters(ref) == counters(full)
    assert entries(port) == entries(ref) == entries(full)
    port.close()
    ref.close()


def test_sdx_bytes_equal_the_reference(tmp_path):
    for side in ("r", "p"):
        (tmp_path / side).mkdir()
        mem = MemoryNeedleMap(str(tmp_path / side / "s.idx"))
        for k in (3, 1, 9, 4, 200):
            mem.put(k, k * 8, k * 10)
        mem.delete(4, 8)
        mem.close()
    ref = ref_nmc.SortedFileNeedleMap.load(str(tmp_path / "r" / "s.idx"))
    port = SortedFileNeedleMap.load(str(tmp_path / "p" / "s.idx"))
    sdx = lambda side: (tmp_path / side / "s.sdx").read_bytes()  # noqa: E731
    assert sdx("p") == sdx("r")
    assert port.get(9).size == 90 and port.get(4) is None
    assert port.get(77) is None
    with pytest.raises(PermissionError):
        port.put(5, 40, 1)
    for m in (ref, port):
        m.delete(9, 8)
        m.delete(77, 16)
    assert counters(port) == counters(ref)
    assert entries(port) == [(nv.key, nv.offset, nv.size) for nv in ref]
    ref.close()
    port.close()
    assert sdx("p") == sdx("r")
    for name in ("s.idx",):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes()
    again = SortedFileNeedleMap.load(str(tmp_path / "p" / "s.idx"))
    assert again.get(9) is None and again.get(200).size == 2000
    again.close()


def test_size_zero_needles_stay_live(tmp_path):
    for cls in (MemoryNeedleMap, CompactNeedleMap, CheckpointedNeedleMap):
        m = cls(str(tmp_path / f"{cls.__name__}.idx"))
        m.put(5, 80, 0)
        nv = m.get(5)
        assert nv is not None and nv.size == 0, cls
        assert [v.key for v in m] == [5], cls
        m.delete(5, 8)
        assert m.get(5) is None, cls
        m.close()


def test_readers_see_every_live_key_while_a_writer_restructures(
        tmp_path, small_sections):
    """Readers that take no lock of the volume keep finding every key
    written before they started while a writer's tail flushes and
    overflow merges replace the map's lists and sections."""
    m = CompactNeedleMap(str(tmp_path / "c.idx"))
    live = list(range(2, 4000, 2))
    for k in live[:300]:
        m.put(k, k * 8, 10)
    stop = threading.Event()
    misses: list[int] = []
    start = len(m._sections)

    def reader(seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            k = live[int(rng.integers(0, 300))]
            nv = m.get(k)
            if nv is None or nv.offset != k * 8:
                misses.append(k)

    threads = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        for k in live[300:]:
            m.put(k, k * 8, 10)       # ascending: tail flushes
            m.put(k - 1, k * 8, 11)   # below the tail: the overflow
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert len(m._sections) > start + 10
    assert not misses, misses[:10]
    m.close()


def _needles(cls, count: int = 40):
    out = []
    for i in range(1, count + 1):
        n = cls(cookie=0x1000 + i, id=i * 3, data=bytes([i % 251]) * (i * 7))
        n.append_at_ns = 1_700_000_000_000_000_000 + i
        out.append(n)
    return out


def _write_volume(vol_cls, needle_cls, d: str, kind: str):
    """Writes as the memory kind for 'sorted' (its map is read-only),
    then reopens with the kind and deletes through it."""
    v = vol_cls(d, "c", 9, needle_map_kind="memory" if kind == "sorted"
                else kind)
    for n in _needles(needle_cls):
        v.write_needle(n)
    if kind != "sorted":
        for i in (4, 17):
            t = needle_cls(cookie=0x1000 + i, id=i * 3)
            t.append_at_ns = 1_800_000_000_000_000_000 + i
            v.delete_needle(t)
    v.close()
    v = vol_cls(d, "c", 9, needle_map_kind=kind)
    t = needle_cls(cookie=0x1000 + 9, id=27)
    t.append_at_ns = 1_900_000_000_000_000_000
    v.delete_needle(t)
    return v


@pytest.mark.parametrize("kind", KINDS)
def test_volume_of_each_kind_writes_the_reference_files(tmp_path, kind):
    ref = _write_volume(RefVolume, RefNeedle, str(tmp_path / "r"), kind)
    port = _write_volume(Volume, Needle, str(tmp_path / "p"), kind)
    try:
        assert type(port.nm).__name__ == type(ref.nm).__name__
        assert counters(port.nm) == counters(ref.nm)
        assert port.to_volume_information()["file_count"] == \
            ref.nm.file_counter
        for i in range(1, 41):
            want = ref.nm.get(i * 3)
            got = port.nm.get(i * 3)
            assert (want is None) == (got is None), i
            if got is not None:
                assert port.read_needle(i * 3).data == \
                    ref.read_needle(i * 3).data
        if kind == "sorted":
            with pytest.raises(PermissionError):
                port.write_needle(Needle(cookie=1, id=999, data=b"x"))
    finally:
        port.close()
        ref.close()
    for ext in (".dat", ".idx", ".ldb", ".sdx"):
        r, p = tmp_path / "r" / f"c_9{ext}", tmp_path / "p" / f"c_9{ext}"
        assert p.exists() == r.exists(), ext
        if r.exists():
            assert p.read_bytes() == r.read_bytes(), ext


@pytest.mark.parametrize("kind", ("compact", "memory", "ldb"))
def test_commit_keeps_the_kind_and_drops_the_old_snapshot(tmp_path, kind):
    v = Volume(str(tmp_path), "", 3, needle_map_kind=kind)
    try:
        for i in range(1, 30):
            v.write_needle(Needle(cookie=i, id=i, data=b"x" * i))
        v.delete_needle(Needle(cookie=7, id=7))
        v.close()
        if kind == "ldb":
            assert (tmp_path / "3.ldb").exists()
        v = Volume(str(tmp_path), "", 3, needle_map_kind=kind)
        v.compact()
        v.commit_compact()
        assert type(v.nm) is nmc.NEEDLE_MAP_KINDS[kind]
        assert v.read_needle(20).data == b"x" * 20
        with pytest.raises(KeyError):
            v.read_needle(7)
        assert counters(v.nm) == counters(MemoryNeedleMap.load(v.idx_path))
    finally:
        v.close()
    again = Volume(str(tmp_path), "", 3, needle_map_kind=kind)
    assert again.read_needle(29).data == b"x" * 29
    again.close()


def test_a_volume_opens_with_the_compact_map_unless_asked(tmp_path):
    v = Volume(str(tmp_path), "", 1)
    assert v.needle_map_kind == "compact"
    assert isinstance(v.nm, CompactNeedleMap)
    v.close()
    with pytest.raises(ValueError):
        Volume(str(tmp_path), "", 2, needle_map_kind="btree")
    assert not os.path.exists(tmp_path / "2.dat")


def test_commit_of_a_sorted_volume_sorts_the_compacted_index(tmp_path):
    """A sorted-kind volume's commit drops the `.sdx` of the old index, so
    the reopened map names the compacted offsets (the reference's commit
    keeps the old `.sdx`; ROADMAP Queue 3)."""
    v = Volume(str(tmp_path), "", 5, needle_map_kind="memory")
    for i in range(1, 21):
        v.write_needle(Needle(cookie=i, id=i, data=b"y" * (40 * i)))
    for i in (2, 3, 11):
        v.delete_needle(Needle(cookie=i, id=i))
    v.close()
    v = Volume(str(tmp_path), "", 5, needle_map_kind="sorted")
    try:
        before = v.data_size
        v.compact()
        v.commit_compact()
        assert v.data_size < before
        assert isinstance(v.nm, SortedFileNeedleMap)
        for i in range(1, 21):
            if i in (2, 3, 11):
                with pytest.raises(KeyError):
                    v.read_needle(i)
            else:
                assert v.read_needle(i).data == b"y" * (40 * i)
    finally:
        v.close()
    sorted_now = tmp_path / "5.sdx"
    fresh = tmp_path / "fresh.sdx"
    MemDb.from_idx_file(str(tmp_path / "5.idx")).write_sorted_file(str(fresh))
    assert sorted_now.read_bytes() == fresh.read_bytes()
