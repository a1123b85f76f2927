"""5-byte offsets (17-byte `.idx` entries, volumes past 32 GB): the port
against the reference, at tolerance 0.

The same seeded keys, offsets (past 32 GiB) and sizes go to both
packages' index codecs and to every needle-map kind; the `.idx`, `.sdx`
and `.ldb` files must be equal byte for byte.  A 5-byte volume written by
both packages with frozen append times must give equal `.dat` and `.idx`
files (superblock included), reopen as 5-byte without the flag, compact
and commit alike, cut a torn tail alike, and back up to an equal
follower.  4-byte volumes keep 16-byte entries and u32 offset units.  The
EC encode of a 5-byte volume fails with the reference's error and writes
nothing; ``/admin/assign_volume`` with ``offset_5`` answers as the
reference's; the CLI's ``fix`` and ``see_idx`` read and write the
volume's own width.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import needle_map as ref_nm
from seaweedfs_tpu.storage import needle_map_compact as ref_nmc
from seaweedfs_tpu.storage import volume_backup as ref_backup
from seaweedfs_tpu.storage.needle import FLAG_HAS_NAME as REF_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch.storage import idx
from seaweedfs_tpu_torch.storage import needle_map_compact as nmc
from seaweedfs_tpu_torch.storage import volume_backup as backup
from seaweedfs_tpu_torch.storage.backend import configure_backends
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.needle_map import MemoryNeedleMap
from seaweedfs_tpu_torch.storage.types import MAX_POSSIBLE_VOLUME_SIZE
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.volume_server.store import Store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 1 << 30
T0 = 1_700_000_000_000_000_000
KINDS = ("memory", "compact", "ldb", "sorted")


def seeded_entries(seed: int, n: int, offset_size: int) -> list[tuple]:
    """(key, byte offset, size): offsets 8-aligned, past 32 GiB on a
    5-byte width, tombstones among them."""
    rng = np.random.default_rng(seed)
    top = (1 << 40) if offset_size == 5 else (32 * GIB)
    keys = rng.integers(1, 1 << 62, size=n, dtype=np.int64)
    offs = rng.integers(0, top // 8, size=n, dtype=np.int64) * 8
    sizes = rng.integers(1, 1 << 20, size=n, dtype=np.int64)
    sizes[rng.random(n) < 0.2] = -1
    return [(int(k), int(o), int(s)) for k, o, s in zip(keys, offs, sizes)]


@pytest.mark.parametrize("offset_size", [4, 5])
def test_entries_equal_the_reference(tmp_path, offset_size):
    rows = seeded_entries(offset_size, 500, offset_size)
    if offset_size == 5:
        rows += [(7, 32 * GIB, 9), (8, 40 * GIB + 8, 10),
                 (9, (1 << 40) - 8, 11)]
    blob = b"".join(idx.pack_entry(k, o, s, offset_size) for k, o, s in rows)
    assert blob == b"".join(ref_idx.pack_entry(k, o, s, offset_size)
                            for k, o, s in rows)
    assert idx.entry_size(offset_size) == ref_idx.entry_size(offset_size) \
        == 8 + offset_size + 4
    assert len(blob) == len(rows) * idx.entry_size(offset_size)
    # a torn tail entry is ignored alike
    got = idx.parse_entries(blob + b"\x01" * 7, offset_size)
    want = ref_idx.parse_entries(blob + b"\x01" * 7, offset_size)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    path = tmp_path / "x.idx"
    path.write_bytes(blob)
    assert list(idx.iter_index_file(str(path), offset_size)) == \
        list(ref_idx.iter_index_file(str(path), offset_size)) == rows


def test_five_byte_layout_puts_the_high_byte_after_the_low_word():
    e = idx.pack_entry(0x0102030405060708, (0x7F << 32 | 0xA1B2C3D4) * 8,
                       0x11223344, 5)
    assert e == bytes.fromhex("0102030405060708" "a1b2c3d4" "7f" "11223344")


def map_ops(seed: int, n: int = 1500, keyspace: int = 400) -> list:
    """Puts (ascending appends and scattered keys) at offsets of 40-50 GiB,
    and deletes."""
    rng = np.random.default_rng(seed)
    ops, next_key = [], 1
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            ops.append(("del", int(rng.integers(1, keyspace)),
                        40 * GIB + 8 * int(rng.integers(1, 1 << 20)), 0))
            continue
        if r < 0.6 and next_key < keyspace:
            key = next_key
            next_key += int(rng.integers(1, 3))
        else:
            key = int(rng.integers(1, keyspace))
        off = 40 * GIB + 8 * int(rng.integers(0, (10 * GIB) // 8))
        ops.append(("put", key, off, int(rng.integers(1, 5000))))
    return ops


def apply(m, ops) -> None:
    for op, key, off, size in ops:
        if op == "put":
            m.put(key, off, size)
        else:
            m.delete(key, off)


def counters(m) -> tuple:
    return (m.file_counter, m.file_byte_counter, m.deletion_counter,
            m.deletion_byte_counter, m.max_file_key)


def entries(m) -> list[tuple]:
    return [(nv.key, nv.offset, nv.size) for nv in m]


@pytest.fixture
def small_sections(monkeypatch):
    """Sections, tail flushes and overflow merges every few dozen entries
    in both packages, so a short history crosses each."""
    for mod in (nmc, ref_nmc):
        monkeypatch.setattr(mod, "_SECTION", 64)
        monkeypatch.setattr(mod, "_TAIL_FLUSH", 32)
        monkeypatch.setattr(mod, "_OVERFLOW_MERGE", 50)


def _kind(pkg, kind: str):
    if kind == "memory":
        return MemoryNeedleMap if pkg == "port" else ref_nm.MemoryNeedleMap
    mod = nmc if pkg == "port" else ref_nmc
    return {"compact": mod.CompactNeedleMap,
            "ldb": mod.CheckpointedNeedleMap,
            "sorted": mod.SortedFileNeedleMap}[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_map_kinds_round_trip_offsets_past_32_gib(tmp_path, kind,
                                                  small_sections):
    """Each kind, written (the sorted kind: made from a memory map's
    `.idx`), closed and reopened in both packages: equal lookups,
    counters and iteration, offsets of 40-50 GiB intact, and equal
    `.idx`, `.sdx` and `.ldb` bytes."""
    ops = map_ops(11)
    maps = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        d.mkdir()
        path = str(d / "v.idx")
        writer = _kind(pkg, "memory" if kind == "sorted" else kind)
        m = writer(path, offset_size=5) if kind != "ldb" else \
            writer(path, replay=False, offset_size=5)
        apply(m, ops)
        m.close()
        maps[pkg] = _kind(pkg, kind).load(path, offset_size=5)
    ref, port = maps["ref"], maps["port"]
    truth = MemoryNeedleMap.load(str(tmp_path / "port" / "v.idx"),
                                 offset_size=5)
    assert counters(port) == counters(ref)
    assert entries(port) == entries(ref)
    assert sorted(k for k, _, s in entries(port) if s >= 0) == \
        sorted(nv.key for nv in truth)
    for key in range(1, 400):
        want, got = truth.get(key), port.get(key)
        assert (got is None) == (want is None), key
        if got is not None:
            assert (got.offset, got.size) == (want.offset, want.size)
            assert got.offset >= 40 * GIB
    if kind in ("compact", "ldb"):
        assert all(sec.offs.dtype == np.uint64 for sec in port._sections)
    # a few more ops after the reopen reach the files alike
    more = [("put", 9999, 48 * GIB, 7), ("del", 1, 49 * GIB, 0)]
    if kind == "sorted":
        more = [("del", k, 49 * GIB, 0) for k in (1, 2, 3)]
    for m in (ref, port):
        apply(m, more)
        m.close()
    for name in ("v.idx", "v.sdx", "v.ldb"):
        r, p = tmp_path / "ref" / name, tmp_path / "port" / name
        assert p.exists() == r.exists(), name
        if r.exists():
            assert p.read_bytes() == r.read_bytes(), name
    assert os.path.getsize(tmp_path / "port" / "v.idx") % 17 == 0


def test_four_byte_maps_keep_16_byte_entries_and_u32_units(tmp_path,
                                                           small_sections):
    ops = [(op, k, off % (32 * GIB), s) for op, k, off, s in map_ops(3)]
    m = nmc.CompactNeedleMap(str(tmp_path / "v.idx"))
    apply(m, ops)
    m._rebuild()
    assert m._sections and all(sec.offs.dtype == np.uint32
                               for sec in m._sections)
    m.close()
    assert os.path.getsize(tmp_path / "v.idx") == 16 * len(ops)
    again = nmc.CompactNeedleMap.load(str(tmp_path / "v.idx"))
    assert all(sec.offs.dtype == np.uint32 for sec in again._sections)
    assert entries(again) == entries(ref_nmc.CompactNeedleMap.load(
        str(tmp_path / "v.idx")))
    again.close()


def _needles(needle_cls, has_name: int, seed: int, count: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = needle_cls(cookie=0x7000 + i, id=i + 1,
                       data=rng.bytes(int(rng.integers(1, 3000))))
        if i % 3 == 0:
            n.name = b"f%d.bin" % i
            n.set_flag(has_name)
        n.append_at_ns = T0 + 1000 * i
        out.append(n)
    return out


def write_five_byte(vol_cls, needle_cls, has_name: int, d: str,
                    kind: str = "compact", **kw):
    v = vol_cls(d, "c", 5, needle_map_kind=kind, offset_5=True, **kw)
    for n in _needles(needle_cls, has_name, 4, 60):
        v.write_needle(n)
    for j, nid in enumerate((2, 17, 33)):
        t = needle_cls(cookie=0x7000 + nid - 1, id=nid)
        t.append_at_ns = T0 + 10**9 + j
        v.delete_needle(t)
    return v


def same_files(a: str, b: str, exts=(".dat", ".idx")) -> None:
    for ext in exts:
        pa, pb = os.path.join(a, f"c_5{ext}"), os.path.join(b, f"c_5{ext}")
        assert os.path.exists(pa) == os.path.exists(pb), ext
        if os.path.exists(pa):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fb.read() == fa.read(), ext


@pytest.mark.parametrize("kind", ("compact", "memory", "ldb"))
def test_five_byte_volume_equals_the_reference(tmp_path, kind):
    r = write_five_byte(RefVolume, RefNeedle, REF_HAS_NAME,
                        str(tmp_path / "r"), kind)
    p = write_five_byte(Volume, Needle, FLAG_HAS_NAME, str(tmp_path / "p"),
                        kind)
    assert p.offset_size == r.offset_size == 5
    r.close()
    p.close()
    same_files(str(tmp_path / "r"), str(tmp_path / "p"),
               (".dat", ".idx", ".ldb"))
    dat = (tmp_path / "p" / "c_5.dat").read_bytes()
    assert dat[6:8] == b"\x00\x08" and dat[8:16] == b"\x01" + b"\x00" * 7
    assert (tmp_path / "p" / "c_5.idx").stat().st_size == 63 * 17
    # reopened without the flag: the superblock says 5
    r = RefVolume(str(tmp_path / "r"), "c", 5, needle_map_kind=kind)
    p = Volume(str(tmp_path / "p"), "c", 5, needle_map_kind=kind)
    try:
        assert p.offset_size == 5
        for n in _needles(Needle, FLAG_HAS_NAME, 4, 60):
            if n.id in (2, 17, 33):
                with pytest.raises(KeyError):
                    p.read_needle(n.id)
            else:
                assert p.read_needle(n.id).data == \
                    r.read_needle(n.id).data == n.data
        assert counters(p.nm) == counters(r.nm)
        for v in (r, p):
            v.compact()
            v.commit_compact()
        assert p.offset_size == 5 and p.super_block.compaction_revision == 1
        assert p.read_needle(60).data == r.read_needle(60).data
    finally:
        r.close()
        p.close()
    same_files(str(tmp_path / "r"), str(tmp_path / "p"))
    assert (tmp_path / "p" / "c_5.idx").stat().st_size == 57 * 17


def test_five_byte_crash_check_cuts_as_the_reference(tmp_path):
    """A torn 17-byte entry and a dangling record, cut alike."""
    v = write_five_byte(RefVolume, RefNeedle, REF_HAS_NAME,
                        str(tmp_path / "r"))
    v.close()
    with open(tmp_path / "r" / "c_5.idx", "rb") as f:
        tail_entry = f.read()[-17:]
    with open(tmp_path / "r" / "c_5.idx", "ab") as f:
        # an entry naming a record past the .dat's end, then a torn one
        f.write(idx.pack_entry(999, 64 * GIB, 100, 5) + tail_entry[:9])
    with open(tmp_path / "r" / "c_5.dat", "ab") as f:
        f.write(b"\xee" * 100)
    shutil.copytree(tmp_path / "r", tmp_path / "p")
    r = RefVolume(str(tmp_path / "r"), "c", 5)
    p = Volume(str(tmp_path / "p"), "c", 5)
    try:
        assert p.read_needle(60).data == r.read_needle(60).data
    finally:
        r.close()
        p.close()
    same_files(str(tmp_path / "r"), str(tmp_path / "p"))
    assert (tmp_path / "p" / "c_5.idx").stat().st_size == 63 * 17


def test_five_byte_backup_equals_the_reference(tmp_path):
    """records_since over 17-byte entries, then an incremental backup to
    a 5-byte follower in each package: the followers equal each other and
    the source."""
    src = write_five_byte(RefVolume, RefNeedle, REF_HAS_NAME,
                          str(tmp_path / "src_r"))
    src.close()
    shutil.copytree(tmp_path / "src_r", tmp_path / "src_p")
    rsrc = RefVolume(str(tmp_path / "src_r"), "c", 5)
    psrc = Volume(str(tmp_path / "src_p"), "c", 5)
    try:
        for since in (0, T0 + 5000, T0 + 10**9):
            for cap in (1, 4096, 64 << 20):
                assert backup.records_since(psrc, since, cap) == \
                    ref_backup.records_since(rsrc, since, cap)
        rf = RefVolume(str(tmp_path / "f_r"), "c", 5, offset_5=True)
        pf = Volume(str(tmp_path / "f_p"), "c", 5, offset_5=True)
        assert ref_backup.incremental_backup(
            rf, lambda s: ref_backup.records_since(rsrc, s, 8192)) == \
            backup.incremental_backup(
                pf, lambda s: backup.records_since(psrc, s, 8192)) == 63
        assert backup.last_appended_ns(pf) == T0 + 10**9 + 2
        rf.close()
        pf.close()
    finally:
        rsrc.close()
        psrc.close()
    same_files(str(tmp_path / "f_r"), str(tmp_path / "f_p"))
    same_files(str(tmp_path / "src_p"), str(tmp_path / "f_p"))


def test_size_limit_is_256_times_the_four_byte_one(tmp_path):
    for offset_5, fits in ((False, False), (True, True)):
        v = Volume(str(tmp_path / str(offset_5)), "", 1, offset_5=offset_5)
        try:
            v.nm.file_byte_counter = MAX_POSSIBLE_VOLUME_SIZE
            n = Needle(cookie=1, id=1, data=b"x")
            if fits:
                v.write_needle(n)
                assert v.read_needle(1).data == b"x"
            else:
                with pytest.raises(OSError, match="size limit"):
                    v.write_needle(n)
        finally:
            v.close()


def test_mmap_and_tier_on_a_five_byte_volume(tmp_path):
    """The `.dat` mapped, then moved to a dir backend and back: every
    needle reads the same through each, and the reference reads the
    recalled files."""
    configure_backends({"cold5": {"type": "dir",
                                  "root": str(tmp_path / "cold")}})
    d = str(tmp_path / "v")
    v = write_five_byte(Volume, Needle, FLAG_HAS_NAME, d, use_mmap=True)
    want = {n.id: n.data for n in _needles(Needle, FLAG_HAS_NAME, 4, 60)
            if n.id not in (2, 17, 33)}
    try:
        assert {k: v.read_needle(k).data for k in want} == want
        v.tier_upload("cold5")
        assert v.tiered and v.offset_size == 5
        assert not os.path.exists(v.dat_path)
        assert {k: v.read_needle(k).data for k in want} == want
        v.tier_download()
        assert not v.tiered and v.offset_size == 5
        assert {k: v.read_needle(k).data for k in want} == want
    finally:
        v.close()
    r = RefVolume(d, "c", 5)
    try:
        assert r.offset_size == 5
        assert {k: r.read_needle(k).data for k in want} == want
    finally:
        r.close()


def test_ec_encode_of_a_five_byte_volume_fails_as_the_reference(tmp_path):
    rs = RefStore([str(tmp_path / "r")])
    ps = Store([str(tmp_path / "p")], device="cpu")
    try:
        for store in (rs, ps):
            store.add_volume(3, "c", offset_5=True)
        errors = []
        for store in (rs, ps):
            with pytest.raises(ValueError) as e:
                store.ec_generate(3)
            errors.append(str(e.value))
        assert errors[1] == errors[0] == (
            "volume 3 uses 5-byte offsets; EC encoding supports "
            "4-byte-offset volumes only")
        assert not ps.get_volume(3).read_only
        assert sorted(os.listdir(tmp_path / "p")) == ["c_3.dat", "c_3.idx"]
    finally:
        rs.close()
        ps.close()


def run_cli(side: str, *argv: str) -> subprocess.CompletedProcess:
    cmd = ([sys.executable, os.path.join(ROOT, "weed.py")] if side == "ref"
           else [sys.executable, "-m", "seaweedfs_tpu_torch"])
    return subprocess.run(cmd + list(argv), capture_output=True, text=True,
                          timeout=120, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT,
                               "JAX_PLATFORMS": "cpu"})


def test_fix_and_see_idx_read_the_volumes_width(tmp_path):
    """``fix`` rebuilds a 17-byte `.idx` as weed.py's does; ``see_idx``
    prints what the reference's prints, sniffing the width from the
    `.dat` or forced with -offset5."""
    v = write_five_byte(RefVolume, RefNeedle, REF_HAS_NAME,
                        str(tmp_path / "ref"))
    v.close()
    original = (tmp_path / "ref" / "c_5.idx").read_bytes()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    outs = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        (tmp_path / side / "c_5.idx").write_bytes(b"garbage!")
        r = run_cli(side, "fix", "-dir", d, "-collection", "c",
                    "-volumeId", "5")
        assert r.returncode == 0, r.stderr
        outs[side] = r.stdout.replace(d, "<dir>")
        assert (tmp_path / side / "c_5.idx").read_bytes() == original
    assert outs["port"] == outs["ref"]
    from seaweedfs_tpu.tools import see_idx as ref_see
    from seaweedfs_tpu_torch.tools import see_idx

    shutil.copy(tmp_path / "ref" / "c_5.idx", tmp_path / "orphan.idx")
    for argv in ([str(tmp_path / "port" / "c_5.idx")],
                 [str(tmp_path / "orphan.idx"), "-offset5"],
                 [str(tmp_path / "orphan.idx")]):
        printed = []
        for mod in (ref_see, see_idx):
            r = subprocess.run(
                [sys.executable, "-m", mod.__name__, *argv],
                capture_output=True, text=True, timeout=60, cwd=ROOT,
                env={**os.environ, "PYTHONPATH": ROOT,
                     "JAX_PLATFORMS": "cpu"})
            assert r.returncode == 0, r.stderr
            printed.append(r.stdout)
        assert printed[1] == printed[0]
    assert printed[1].endswith("(4-byte offsets)\n")
