"""The store layer under the port's volume server, against seaweedfs_tpu on
the CPU: volume deletes and heartbeat info, replica placement and TTL in
the superblock, EC needle deletes, decode back to a volume, the remote
branch of degraded reads, and the codec objects shared by request threads.
Seeded inputs, byte-exact comparisons."""

from __future__ import annotations

import os
import shutil
import sys
import threading
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.codec import CpuEngine
from seaweedfs_tpu.ec.codec import ReedSolomon as RefRS
from seaweedfs_tpu.ec.ec_volume import EcVolume as RefEcVolume
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.ttl import TTL as RefTTL
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch.ec import encoder
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.gf256 import MUL_TABLE
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.ops import gf_matmul as gfm
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.volume_server import store as store_mod
from seaweedfs_tpu_torch.volume_server.store import Store

EC_EXTS = [to_ext(i) for i in range(14)] + [".ecx", ".eci"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's float matmul would take every core; the suite
    runs several workers side by side, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(seed: int, count: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"id": i + 1, "cookie": int(rng.integers(1, 1 << 32)),
             "data": rng.bytes(int(rng.integers(1, 40_000))),
             "append_at_ns": 1_700_000_000_000_000_000 + i,
             "last_modified": 1_700_000_000 + i}
            for i in range(count)]


def _needle(cls, spec, data=None):
    n = cls(cookie=spec["cookie"], id=spec["id"],
            data=spec["data"] if data is None else data)
    n.append_at_ns = spec["append_at_ns"]
    n.last_modified = spec["last_modified"]
    n.flags = 0x08  # FLAG_HAS_LAST_MODIFIED
    return n


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_both(tmp_path, specs, deletes=()):
    """The same needles (and tombstones) through both packages' Volume;
    returns (port volume, reference volume)."""
    port = Volume(str(tmp_path / "port"), "", 1)
    ref = RefVolume(str(tmp_path / "ref"), "", 1)
    for spec in specs:
        port.write_needle(_needle(Needle, spec))
        ref.write_needle(_needle(RefNeedle, spec))
    for i, nid in enumerate(deletes):
        tomb = {"id": nid, "cookie": 0, "data": b"",
                "append_at_ns": 1_800_000_000_000_000_000 + i,
                "last_modified": 0}
        assert port.delete_needle(_needle(Needle, tomb)) == \
            ref.delete_needle(_needle(RefNeedle, tomb))
    return port, ref


def test_volume_delete_and_heartbeat_info_match_the_reference(tmp_path):
    specs = _specs(1, 30)
    port, ref = _write_both(tmp_path, specs, deletes=(3, 7, 7, 99, 12))
    try:
        assert port.to_volume_information() == ref.to_volume_information()
        for spec in specs:
            if spec["id"] in (3, 7, 12):
                with pytest.raises(KeyError):
                    port.read_needle(spec["id"])
            else:
                assert port.read_needle(spec["id"]).data == spec["data"]
        port.read_only = True
        with pytest.raises(PermissionError):
            port.delete_needle(Needle(id=1))
    finally:
        port.close()
        ref.close()
    for ext in (".dat", ".idx"):
        assert _read(str(tmp_path / "port" / "1") + ext) == \
            _read(str(tmp_path / "ref" / "1") + ext), ext


@pytest.mark.parametrize("text", ["", "5", "3d", "12h", "1w", "2M", "1y",
                                  "255m", "3x", "d", "h5"])
def test_ttl_parse(text):
    def run(cls):
        try:
            t = cls.parse(text)
        except (ValueError, KeyError) as e:
            return type(e).__name__
        return (t.to_bytes(), t.to_u32(), t.minutes, str(t))

    assert run(TTL) == run(RefTTL)


@pytest.mark.parametrize("replication,ttl", [("001", "3d"), ("010", ""),
                                             ("200", "12h"), ("000", "5")])
def test_add_volume_superblock_matches_the_reference(tmp_path, replication,
                                                     ttl):
    port = Store([str(tmp_path / "port")], device="cpu")
    ref = RefStore([str(tmp_path / "ref")], ec_engine="cpu")
    try:
        v = port.add_volume(4, "pics", replication, ttl)
        rv = ref.add_volume(4, "pics", replication, ttl)
        assert v.to_volume_information() == rv.to_volume_information()
    finally:
        port.close()
        ref.close()
    assert _read(str(tmp_path / "port" / "pics_4.dat")) == \
        _read(str(tmp_path / "ref" / "pics_4.dat"))
    # and the placement and TTL survive a restart
    again = Store([str(tmp_path / "port")], device="cpu")
    try:
        info = again.get_volume(4).to_volume_information()
        assert (info["replica_placement"], info["ttl"]) == \
            (rv.super_block.replica_placement.to_byte(),
             rv.super_block.ttl.to_u32())
    finally:
        again.close()


def test_bad_replication_is_refused(tmp_path):
    store = Store([str(tmp_path)], device="cpu")
    try:
        with pytest.raises(ValueError):
            store.add_volume(1, "", "300")
        assert not os.listdir(tmp_path)
    finally:
        store.close()


@pytest.fixture
def ec_pair(tmp_path):
    """One volume's .dat/.idx, EC-encoded by both packages, each mounted."""
    specs = _specs(2, 40)
    port, ref = _write_both(tmp_path, specs, deletes=(5,))
    port.close()
    ref.close()
    pbase = str(tmp_path / "port" / "1")
    rbase = str(tmp_path / "ref" / "1")
    shutil.copy(pbase + ".dat", rbase + ".dat")
    shutil.copy(pbase + ".idx", rbase + ".idx")
    encoder.write_ec_files(pbase, store_mod.ReedSolomon(10, 4, device="cpu"))
    encoder.write_sorted_file_from_idx(pbase)
    ref_encoder.write_ec_files(rbase, RefRS(10, 4, engine=CpuEngine()))
    ref_encoder.write_sorted_file_from_idx(rbase)
    for ext in EC_EXTS:
        assert _read(pbase + ext) == _read(rbase + ext), ext
    ev, rev = EcVolume(pbase, 1), RefEcVolume(rbase, 1)
    yield specs, pbase, rbase, ev, rev
    ev.close()
    rev.close()


def test_ec_delete_needle_matches_the_reference(ec_pair):
    specs, pbase, rbase, ev, rev = ec_pair
    for nid in (2, 9, 9, 1000, 40):
        ev.delete_needle(nid)
        rev.delete_needle(nid)
    for ext in (".ecx", ".ecj"):
        assert _read(pbase + ext) == _read(rbase + ext), ext
    rs = store_mod.ReedSolomon(10, 4, device="cpu")
    assert _read(pbase + ".ecj") == b"".join(
        n.to_bytes(8, "big") for n in (2, 9, 9, 40))
    from seaweedfs_tpu_torch.ec.ec_volume import NeedleNotFoundError
    with pytest.raises(NeedleNotFoundError):
        ev.read_needle(9, rs)
    assert ev.read_needle(3, rs) == rev.read_needle(3)


def test_decode_to_volume_matches_the_reference(ec_pair):
    specs, pbase, rbase, ev, rev = ec_pair
    for nid in (2, 17):
        ev.delete_needle(nid)
        rev.delete_needle(nid)
    assert encoder.find_dat_file_size(pbase) == \
        ref_encoder.find_dat_file_size(rbase, rbase)
    for base, mod in ((pbase, encoder), (rbase, ref_encoder)):
        os.remove(base + ".dat")
        os.remove(base + ".idx")
    encoder.write_dat_file(pbase, encoder.find_dat_file_size(pbase))
    encoder.write_idx_file_from_ec_index(pbase)
    ref_encoder.write_dat_file(rbase, ref_encoder.find_dat_file_size(rbase,
                                                                     rbase))
    ref_encoder.write_idx_file_from_ec_index(rbase)
    for ext in (".dat", ".idx"):
        assert _read(pbase + ext) == _read(rbase + ext), ext
    v = Volume(os.path.dirname(pbase), "", 1)
    try:
        for spec in specs:
            if spec["id"] in (2, 5, 17):
                with pytest.raises(KeyError):
                    v.read_needle(spec["id"])
            else:
                assert v.read_needle(spec["id"]).data == spec["data"]
    finally:
        v.close()


def test_read_interval_local_then_remote_then_reconstruct(ec_pair):
    specs, pbase, _, ev, _ = ec_pair
    rs = store_mod.ReedSolomon(10, 4, device="cpu")
    nid = 11
    want = ev.read_needle(nid, rs)
    _, _, intervals = ev.locate_ec_shard_needle(nid)
    shards = {iv.to_shard_id_and_offset(ev.large_block_size,
                                        ev.small_block_size, 10)[0]
              for iv in intervals}
    ev.close()
    for sid in shards:
        os.remove(pbase + to_ext(sid))
    ev2 = EcVolume(pbase, 1)
    calls, rebuilt = [], []
    original = ev2.reconstruct_interval

    def spy(*args):
        rebuilt.append(args[0])
        return original(*args)

    ev2.reconstruct_interval = spy
    full = {sid: _read(pbase.replace("port", "ref") + to_ext(sid))
            for sid in shards}

    def remote(vid, sid, off, size):
        calls.append((vid, sid, off, size))
        return full[sid][off:off + size]

    def dead(vid, sid, off, size):
        calls.append((vid, sid, off, size))
        raise ConnectionError("holder gone")

    try:
        # local shard gone: the remote holder answers, nothing rebuilds
        got = b"".join(ev2.read_interval(iv, rs, remote) for iv in intervals)
        assert got == want and len(calls) == len(intervals) and not rebuilt
        # the remote holder fails: its exception counts as an absent shard
        calls.clear()
        got = b"".join(ev2.read_interval(iv, rs, dead) for iv in intervals)
        assert got == want and len(calls) == len(rebuilt) == len(intervals)
        # a local shard is read locally and never asks the remote
        calls.clear()
        ev3 = EcVolume(pbase.replace("port", "ref"), 1)
        try:
            assert b"".join(ev3.read_interval(iv, rs, dead)
                            for iv in intervals) == want
        finally:
            ev3.close()
        assert not calls
    finally:
        ev2.close()


def test_store_read_ec_needle_passes_fetch_remote(tmp_path):
    store = Store([str(tmp_path)], device="cpu")
    try:
        specs = _specs(3, 12)
        store.add_volume(1)
        for spec in specs:
            store.write_needle(1, _needle(Needle, spec))
        store.ec_generate(1)
        store.ec_mount(1)
        base = str(tmp_path / "1")
        gone = {sid: _read(base + to_ext(sid)) for sid in range(5)}
        store.ec_delete_shards(1, list(gone))  # 9 left: reads need help
        seen = []

        def remote(vid, sid, off, size):
            seen.append(sid)
            return gone[sid][off:off + size]

        def dead(vid, sid, off, size):
            raise OSError("unreachable")

        record, size = store.read_ec_needle(1, specs[0]["id"], remote)
        assert Needle.from_bytes(record, size).data == specs[0]["data"]
        assert seen
        with pytest.raises(KeyError):  # too few local survivors to rebuild
            store.read_ec_needle(1, specs[0]["id"], dead)
    finally:
        store.close()


# --- codec objects shared by request threads ------------------------------

def _lut(m: np.ndarray, data: np.ndarray) -> np.ndarray:
    out = np.zeros((m.shape[0], data.shape[1]), dtype=np.uint8)
    for r in range(m.shape[0]):
        for k in range(m.shape[1]):
            out[r] ^= np.take(MUL_TABLE[m[r, k]], data[k])
    return out


def _run_threads(fn, n: int) -> list:
    errors: list = []

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_engine_matrix_cache_is_thread_safe(monkeypatch):
    monkeypatch.setattr(gfm.TorchEngine, "_CACHE_MAX", 2)
    rng = np.random.default_rng(5)
    mats = [rng.integers(0, 256, (4, 10), dtype=np.uint8) for _ in range(12)]
    data = rng.integers(0, 256, (10, 48), dtype=np.uint8)
    want = [_lut(m, data) for m in mats]
    engine = gfm.TorchEngine("cpu")

    class YieldingDict(OrderedDict):
        """Gives up the interpreter between a lookup and what the caller
        does next, which is where an unlocked LRU loses its entries."""

        def get(self, key, default=None):
            value = super().get(key, default)
            time.sleep(0.0005)
            return value

    engine._matrices = YieldingDict()
    wrong: list = []

    def work(t):
        for i in range(50):
            j = (t * 5 + i) % len(mats)
            if not np.array_equal(engine.matmul(mats[j], data), want[j]):
                wrong.append((t, i))

    assert _run_threads(work, 8) == []
    assert not wrong
    assert len(engine._matrices) <= 2


def test_store_makes_its_codec_and_encoder_once(tmp_path, monkeypatch):
    made = {"rs": 0, "enc": 0}

    class SlowRS(store_mod.ReedSolomon):
        def __init__(self, *a, **kw):
            made["rs"] += 1
            time.sleep(0.05)
            super().__init__(*a, **kw)

    class SlowEncoder(store_mod.StreamingEncoder):
        def __init__(self, *a, **kw):
            made["enc"] += 1
            time.sleep(0.05)
            super().__init__(*a, **kw)

    monkeypatch.setattr(store_mod, "ReedSolomon", SlowRS)
    monkeypatch.setattr(store_mod, "StreamingEncoder", SlowEncoder)
    store = Store([str(tmp_path / "port")], device="cpu")
    specs = {vid: _specs(10 + vid, 25) for vid in (1, 2)}
    try:
        for vid, sp in specs.items():
            store.add_volume(vid)
            for spec in sp:
                store.write_needle(vid, _needle(Needle, spec))
        assert _run_threads(lambda i: store.ec_generate(i + 1), 2) == []
        rss = []
        assert _run_threads(lambda i: rss.append(store.rs()), 4) == []
        assert made == {"rs": 1, "enc": 1}
        assert all(rs is rss[0] for rs in rss)
    finally:
        store.close()
    for vid in (1, 2):
        base = str(tmp_path / "port" / str(vid))
        rbase = str(tmp_path / "ref" / str(vid))
        os.makedirs(os.path.dirname(rbase), exist_ok=True)
        shutil.copy(base + ".dat", rbase + ".dat")
        ref_encoder.write_ec_files(rbase, RefRS(10, 4, engine=CpuEngine()))
        for ext in EC_EXTS[:-2] + [".eci"]:
            assert _read(base + ext) == _read(rbase + ext), (vid, ext)
