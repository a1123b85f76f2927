"""The crash check every volume load runs, against seaweedfs_tpu on the CPU.

One seeded volume (needles of 0 B to 20 KB, deletes, an overwrite) is
written once, copied to two directories and damaged the same way in both
as a crash would leave it; then seaweedfs_tpu's Volume opens one copy and
the port's Volume the other.  The files after the load, their counters
and the read of every needle must be the same, byte for byte.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.volume_server.store import Store

COUNT = 40
DELETED = (4, 9, 17, 30)


def _specs() -> list[dict]:
    rng = np.random.default_rng(77)
    out = []
    for i in range(COUNT):
        size = 0 if i % 13 == 5 else int(rng.integers(1, 20_000))
        out.append({"id": i + 1, "cookie": int(rng.integers(1, 1 << 32)),
                    "data": rng.bytes(size)})
    return out


def _write(directory: str) -> list[dict]:
    """The seeded volume through the port's Volume; returns the specs as
    the last write left them."""
    specs = _specs()
    v = Volume(directory, "", 1)
    ns = 1_700_000_000_000_000_000
    for k, s in enumerate(specs):
        n = Needle(cookie=s["cookie"], id=s["id"], data=s["data"])
        n.append_at_ns = ns + k
        v.write_needle(n)
    over = Needle(cookie=specs[2]["cookie"], id=3, data=b"overwritten" * 50)
    over.append_at_ns = ns + 500
    v.write_needle(over)
    specs[2] = {**specs[2], "data": over.data}
    for k, nid in enumerate(DELETED):
        n = Needle(cookie=specs[nid - 1]["cookie"], id=nid)
        n.append_at_ns = ns + 1000 + k
        v.delete_needle(n)
    v.close()
    return specs


def _idx_entries(base: str) -> np.ndarray:
    with open(base + ".idx", "rb") as f:
        return idx_mod.parse_entries(f.read())


def _truncate(path: str, size: int) -> None:
    with open(path, "r+b") as f:
        f.truncate(size)


def _append(path: str, data: bytes) -> None:
    with open(path, "ab") as f:
        f.write(data)


def _last_record_offset(base: str) -> int:
    return int(_idx_entries(base)["offset"][-1]) * 8


# each case damages the files at ``base`` as a crash could
def _torn_idx_entry(base: str) -> None:
    _append(base + ".idx", b"\x00" * 7)


def _dat_cut_mid_needle(base: str) -> None:
    # the last put's record loses its second half; tombstones follow it
    e = _idx_entries(base)
    puts = [i for i in range(len(e)) if int(e["size"][i]) > 0]
    off, size = int(e["offset"][puts[-1]]) * 8, int(e["size"][puts[-1]])
    _truncate(base + ".dat", off + 16 + size // 2)


def _idx_names_another_needle(base: str) -> None:
    # an index entry for needle 1000 that points at needle 1's record
    e = _idx_entries(base)
    first = int(e["offset"][0]) * 8
    _append(base + ".idx", idx_mod.pack_entry(1000, first,
                                              int(e["size"][0])))
    _append(base + ".dat", b"\xab" * 24)


def _all_torn(base: str) -> None:
    # a .dat that lost every record: no index entry is healthy
    _truncate(base + ".dat", 8 + 5)


def _dat_tail_garbage(base: str) -> None:
    _append(base + ".dat", b"\x01" * 100)


def _idx_past_dat(base: str) -> None:
    # the .idx append outlived the .dat's: the last entries point at EOF
    e = _idx_entries(base)
    _truncate(base + ".dat", int(e["offset"][-3]) * 8)


def _clean(base: str) -> None:
    pass


CASES = {f.__name__.lstrip("_"): f for f in (
    _clean, _torn_idx_entry, _dat_cut_mid_needle, _idx_names_another_needle,
    _all_torn, _dat_tail_garbage, _idx_past_dat)}


def _read_all(v, specs) -> list:
    out = []
    for s in specs:
        try:
            out.append(("ok", v.read_needle(s["id"], s["cookie"]).data))
        except (KeyError, ValueError) as e:
            out.append(type(e).__name__)
    return out


def _files(base: str) -> dict:
    out = {}
    for ext in (".dat", ".idx"):
        with open(base + ext, "rb") as f:
            out[ext] = f.read()
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("written"))
    return d, _write(d)


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_after_a_crash_equals_the_reference(case, written, tmp_path):
    src, specs = written
    bases = {}
    for name in ("port", "ref"):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        bases[name] = os.path.join(d, "1")
        CASES[case](bases[name])
    damaged = _files(bases["port"])
    port = Volume(str(tmp_path / "port"), "", 1)
    ref = RefVolume(str(tmp_path / "ref"), "", 1, needle_map_kind="compact")
    try:
        assert port.data_size == ref.data_size
        assert port.to_volume_information()["file_count"] == \
            ref.nm.file_counter
        assert port.nm.deletion_counter == ref.nm.deletion_counter
        assert port.garbage_ratio() == ref.garbage_ratio()
        assert _read_all(port, specs) == _read_all(ref, specs)
    finally:
        port.close()
        ref.close()
    got = _files(bases["port"])
    assert got == _files(bases["ref"])
    if case == "clean":
        assert got == damaged
    if case == "all_torn":
        # nothing healthy: the index goes, the .dat stays as it was
        assert got[".idx"] == b"" and got[".dat"] == damaged[".dat"]


def test_a_repaired_volume_takes_new_writes(written, tmp_path):
    """After the check cut a torn tail, the next append lands where the
    last healthy record ends, in both packages alike."""
    src, specs = written
    for name in ("port", "ref"):
        shutil.copytree(src, str(tmp_path / name))
        _dat_cut_mid_needle(str(tmp_path / name / "1"))
    port = Volume(str(tmp_path / "port"), "", 1)
    ref = RefVolume(str(tmp_path / "ref"), "", 1)
    try:
        for v, cls in ((port, Needle), (ref, RefNeedle)):
            n = cls(cookie=7, id=5000, data=b"after the crash")
            n.append_at_ns = 1_900_000_000_000_000_000
            v.write_needle(n)
        assert port.read_needle(5000).data == b"after the crash"
    finally:
        port.close()
        ref.close()
    assert _files(str(tmp_path / "port" / "1")) == \
        _files(str(tmp_path / "ref" / "1"))


def test_a_decoded_volume_keeps_every_needle(tmp_path):
    """ec.decode writes an `.idx` sorted by key, whose tail entry need not
    name the last record.  The port's check truncates past the furthest
    record the index names and keeps every needle; the reference's cuts
    past the tail entry's record and loses the needles after it (ROADMAP
    Queue 3).  The bytes both keep are the same."""
    keys = [5, 3, 9, 1, 7, 2]  # appended in this order: key 7 is not last
    stores = {"port": Store([str(tmp_path / "port")], device="cpu"),
              "ref": RefStore([str(tmp_path / "ref")], ec_engine="cpu")}
    rng = np.random.default_rng(5)
    data = {k: rng.bytes(3000 + k) for k in keys}
    reads = {}
    try:
        for name, s in stores.items():
            ncls = Needle if name == "port" else RefNeedle
            s.add_volume(1)
            for k in keys:
                n = ncls(cookie=k, id=k, data=data[k])
                n.append_at_ns = 1_700_000_000_000_000_000 + k
                s.write_needle(1, n)
            s.delete_needle(1, ncls(cookie=9, id=9))
            s.ec_generate(1)
            s.ec_mount(1)
            s.ec_to_volume(1)
            got = {}
            for k in keys:
                try:
                    got[k] = s.read_needle(1, k).data
                except Exception as e:  # noqa: BLE001 - the cut record's
                    got[k] = type(e).__name__  # read fails in the reference
            reads[name] = got
    finally:
        for s in stores.values():
            s.close()
    assert reads["port"] == {k: ("NotFoundError" if k == 9 else data[k])
                             for k in keys}
    assert reads["ref"][2] != data[2]  # cut off by the reference's check
    port, ref = (_files(str(tmp_path / name / "1")) for name in ("port", "ref"))
    assert port[".idx"] == ref[".idx"]
    assert len(port[".dat"]) > len(ref[".dat"])
    assert port[".dat"][:len(ref[".dat"])] == ref[".dat"]
