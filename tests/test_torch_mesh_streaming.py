"""The port's multi-card streaming encode against seaweedfs_tpu's.

``StreamingEncoder(engine="mesh")`` sends whole dispatches round-robin
over its lanes (CPU lanes here, each running the plain version), and the
device engine splits each dispatch over more than one lane.  Both must
write `.ec00`-`.ec13` and `.eci` byte for byte as the reference's
``engine="mesh"`` encode on its eight virtual CPU devices does, and
rebuild lost shards to the same bytes (tolerance 0).  A host fault in a
mesh encode resumes from its checkpoint; ``Store(ec_engine="mesh")``,
the volume server and the CLI select the plane as the reference's do.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax  # noqa: F401 - the reference encoder runs on its CPU devices
import numpy as np
import pytest
import torch

import seaweedfs_tpu_torch.ec.streaming as streaming
from seaweedfs_tpu.ec.streaming import StreamingEncoder as RefEncoder
from seaweedfs_tpu.volume_server.store import Store as RefStore
from seaweedfs_tpu_torch.__main__ import parse_args
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
from seaweedfs_tpu_torch.observability import (analyze, disable_tracing,
                                               enable_tracing, get_tracer)
from seaweedfs_tpu_torch.parallel.mesh import parse_device_spec
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.utils import faultinject as fi
from seaweedfs_tpu_torch.utils.httpd import HttpError
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from seaweedfs_tpu_torch.volume_server.store import Store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
EXTS = [to_ext(i) for i in range(14)] + [".eci"]
SIZES = {"2MiB": (2 << 20) + 4567, "25MiB": (25 << 20) + 977}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_armed_points():
    fi.clear()
    yield
    fi.clear()


def _files(base: str, exts=EXTS) -> dict[str, bytes]:
    return {ext: open(base + ext, "rb").read() for ext in exts
            if os.path.exists(base + ext)}


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Each size's seeded .dat and the reference's engine="mesh" encode of
    it over its eight virtual devices."""
    out = {}
    for name, size in SIZES.items():
        d = tmp_path_factory.mktemp(name)
        raw = np.random.default_rng(size % 1000).integers(
            0, 256, size, dtype=np.uint8).tobytes()
        (d / "v.dat").write_bytes(raw)
        ref = RefEncoder(10, 4, engine="mesh", devices="8", dispatch_mb=1)
        ref.encode_file(str(d / "v.dat"), str(d / "ref"))
        assert ref.stats["devices"] == 8
        out[name] = (str(d / "v.dat"), _files(str(d / "ref")))
    return out


def _encode_and_rebuild(enc: StreamingEncoder, dat: str, want: dict,
                        base: str) -> None:
    enc.encode_file(dat, base)
    assert _files(base) == want
    for i in (2, 11):
        os.remove(base + to_ext(i))
    assert enc.rebuild_files(base) == [2, 11]
    assert _files(base) == want


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("lanes", [1, 3, 4])
def test_mesh_encode_matches_the_reference(volumes, tmp_path, size, lanes):
    dat, want = volumes[size]
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", engine="mesh",
                           devices=[CPU] * lanes)
    assert enc.engine == "mesh" and enc.mesh is None
    enc.encode_file(dat, str(tmp_path / "m"))
    assert _files(str(tmp_path / "m")) == want
    st = enc.stats
    assert st["devices"] == lanes and st["drain_pool"] == lanes
    assert st["dispatches"] == enc.dispatches_for(os.path.getsize(dat))
    per = st["per_device"]
    assert sorted(per) == [str(i) for i in range(lanes)]
    # round-robin: lane i takes dispatches i, i + lanes, ...
    assert [per[str(i)]["dispatches"] for i in range(lanes)] == [
        len(range(i, st["dispatches"], lanes)) for i in range(lanes)]
    assert st["retries"] == 0
    for i in (2, 11):
        os.remove(str(tmp_path / "m") + to_ext(i))
    assert enc.rebuild_files(str(tmp_path / "m")) == [2, 11]
    assert enc.stats["devices"] == 1
    assert _files(str(tmp_path / "m")) == want


def test_mesh_encode_takes_an_index_spec(volumes, tmp_path):
    """'2,1' over three visible lanes picks those two, in that order, as
    the reference's '5,2' picks devices 5 and 2."""
    dat, want = volumes["2MiB"]
    lanes = [CPU, CPU, torch.device("cpu", 0)]
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", engine="mesh",
                           devices=lanes)
    assert enc.lanes == lanes
    picked = parse_device_spec("2,1", lanes)
    assert picked == [torch.device("cpu", 0), CPU]
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", engine="mesh",
                           devices=picked)
    enc.encode_file(dat, str(tmp_path / "m"))
    assert _files(str(tmp_path / "m")) == want
    assert enc.stats["devices"] == 2
    # a spec string is over the visible lanes: the CPU alone here
    assert StreamingEncoder(device="cpu", engine="mesh",
                            devices="all").lanes == [CPU]
    for bad in ("2", "1,1", "x", "0"):
        with pytest.raises(ValueError):
            StreamingEncoder(device="cpu", engine="mesh", devices=bad)
    with pytest.raises(ValueError, match="engine must be"):
        StreamingEncoder(device="cpu", engine="host")


@pytest.mark.parametrize("size", list(SIZES))
def test_device_engine_splits_over_more_than_one_lane(volumes, tmp_path,
                                                      size):
    dat, want = volumes[size]
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", devices=[CPU] * 8)
    assert enc.mesh is not None and enc.mesh.shape == (2, 2, 2)
    assert enc.launches_per_dispatch() == 8
    assert enc.dispatch_b % (2 * 2 * 64) == 0
    _encode_and_rebuild(enc, dat, want, str(tmp_path / "s"))
    assert enc.stats["devices"] == 8


def test_device_engine_keeps_one_lane_when_there_is_one(volumes, tmp_path):
    dat, want = volumes["2MiB"]
    one = StreamingEncoder(dispatch_mb=1, device="cpu")
    assert one.mesh is None and one.lanes == [CPU]
    assert one.launches_per_dispatch() == 1
    assert one.launches_per_dispatch(rows=5) == 2
    off = StreamingEncoder(dispatch_mb=1, device="cpu", devices=[CPU] * 8,
                           mesh=False)
    assert off.mesh is None and off.lanes == [CPU]
    forced = StreamingEncoder(dispatch_mb=1, device="cpu", devices=[CPU],
                              mesh=True)
    assert forced.mesh is not None and forced.mesh.shape == (1, 1, 1)
    for i, enc in enumerate((one, off, forced)):
        _encode_and_rebuild(enc, dat, want, str(tmp_path / f"e{i}"))


def test_mesh_encode_resumes_from_its_checkpoint(volumes, tmp_path,
                                                 monkeypatch):
    """The reference's drill (two ec.drain faults, one ec.dispatch): the
    port resumes every failed attempt from its checkpoint, with every
    parity product a lane's launch and no fallback, to the same bytes."""
    dat, want = volumes["25MiB"]
    calls = {"n": 0}
    real = streaming.gf_matmul

    def counting(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(streaming, "gf_matmul", counting)
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", engine="mesh",
                           devices=[CPU] * 4)
    # two drain faults may land in one attempt or in two
    enc.max_encode_retries = 3
    fi.enable("ec.drain", error_rate=1.0, max_hits=2)
    fi.enable("ec.dispatch", error_rate=1.0, max_hits=1)
    tracer = get_tracer()
    tracer.clear()
    enable_tracing()
    try:
        enc.encode_file(dat, str(tmp_path / "m"))
        spans = tracer.snapshot()
    finally:
        disable_tracing()
        tracer.clear()
    assert fi.fired("ec.drain") == 2 and fi.fired("ec.dispatch") == 1
    assert _files(str(tmp_path / "m")) == want
    assert 2 <= enc.stats["retries"] <= 3
    names = [sp.name for sp in spans]
    assert names.count("pipeline.retry") == enc.stats["retries"]
    assert "pipeline.fallback" not in names
    assert calls["n"] == names.count("pipeline.dispatch")
    assert names.count("pipeline.encode_file") == enc.stats["retries"] + 1


def test_mesh_encode_that_fails_for_good_leaves_nothing(volumes, tmp_path):
    dat, _ = volumes["2MiB"]
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", engine="mesh",
                           devices=[CPU] * 2)
    fi.enable("ec.drain", error_rate=1.0)
    with pytest.raises(OSError, match="ec.drain"):
        enc.encode_file(dat, str(tmp_path / "m"))
    assert enc.stats["retries"] == 2
    assert os.listdir(tmp_path) == []


def test_traced_mesh_encode_reads_per_lane(volumes, tmp_path):
    dat, want = volumes["25MiB"]
    enc = StreamingEncoder(dispatch_mb=1, device="cpu", engine="mesh",
                           devices=[CPU] * 3)
    tracer = get_tracer()
    tracer.clear()
    enable_tracing()
    try:
        enc.encode_file(dat, str(tmp_path / "m"))
        report = analyze(tracer)
    finally:
        disable_tracing()
        tracer.clear()
    assert _files(str(tmp_path / "m")) == want
    (run,) = report["runs"]
    assert run["mode"] == "mesh" and run["engine"] == "mesh"
    per = run["drain_profile"]["per_device"]
    assert sorted(per) == ["0", "1", "2"]
    assert sum(row["dispatches"] for row in per.values()) == \
        enc.stats["dispatches"]
    assert all(row["drain_spans"] == row["dispatches"] and
               row["fetch_s"] >= 0 for row in per.values())


# --- the store, the server and the CLI --------------------------------------

def _fill(store, vid: int, write) -> None:
    store.add_volume(vid)
    for i in range(1, 40):
        write(vid, i, bytes([i]) * (997 * i + 4096 * (i % 7)))


@pytest.mark.parametrize("lanes", [8, 2])
def test_store_mesh_engine_matches_the_reference(tmp_path, lanes):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    store = Store([str(port_dir)], device="cpu", ec_engine="mesh",
                  ec_mesh_devices=[CPU] * lanes)
    try:
        assert store.mesh_lanes == [CPU] * lanes
        _fill(store, 1, lambda v, i, data: store.write_needle(
            v, Needle(cookie=i, id=i, data=data)))
        base = store.get_volume(1).file_prefix
        os.makedirs(ref_dir)
        for ext in (".dat", ".idx"):
            shutil.copy(base + ext, str(ref_dir / ("1" + ext)))
        ref = RefStore([str(ref_dir)], ec_engine="mesh")
        try:
            ref.ec_generate(1)
            store.ec_generate(1)
            enc = store.streaming_encoder()
            assert enc.engine == "mesh" and enc.stats["devices"] == lanes
            assert store.rs().engine.name == "mesh"
            exts = EXTS + [".ecx"]
            want = _files(str(ref_dir / "1"), exts)
            assert len(want) == 16 and _files(base, exts) == want
            for i in (2, 11):
                os.remove(base + to_ext(i))
                os.remove(str(ref_dir / "1") + to_ext(i))
            assert store.ec_rebuild(1) == ref.ec_rebuild(1) == [2, 11]
            assert _files(base, exts) == _files(str(ref_dir / "1"), exts)
            # a request may name the device engine on a mesh store
            assert store.streaming_encoder("tpu").engine == "device"
        finally:
            ref.close()
    finally:
        store.close()


def test_store_bad_mesh_spec_fails_at_init(tmp_path):
    for bad in ("99", "1,1", "x", ","):
        with pytest.raises(ValueError):
            RefStore([str(tmp_path / "r")], ec_engine="mesh",
                     ec_mesh_devices=bad)
        with pytest.raises(ValueError):
            Store([str(tmp_path / "p")], device="cpu", ec_engine="mesh",
                  ec_mesh_devices=bad)
    with pytest.raises(ValueError, match="ec_engine"):
        Store([str(tmp_path / "p")], device="cpu", ec_engine="gpu")
    store = Store([str(tmp_path / "p")], device="cpu", ec_engine="mesh")
    try:
        assert store.mesh_lanes == [CPU] and store.ec_engine == "mesh"
    finally:
        store.close()
    store = Store([str(tmp_path / "p")], device="cpu")
    try:
        assert store.ec_engine == "cpu" and store.mesh_lanes is None
    finally:
        store.close()


def test_server_serves_mesh_only_where_it_runs_it(tmp_path):
    cpu = VolumeServer([str(tmp_path / "a")], "127.0.0.1:1", device="cpu")
    mesh = VolumeServer([str(tmp_path / "b")], "127.0.0.1:1", device="cpu",
                        ec_engine="mesh", ec_mesh_devices=[CPU] * 2)
    try:
        assert cpu.engine == "cpu" and mesh.engine == "mesh"
        assert cpu._check_engine({}) is None
        assert cpu._check_engine({"engine": "cpu"}) == "cpu"
        assert cpu._check_engine({"engine": "tpu"}) == "tpu"
        with pytest.raises(HttpError) as e:
            cpu._check_engine({"engine": "mesh"})
        assert e.value.status == 400 and "-ec.engine cpu" in str(e.value)
        assert mesh._check_engine({"engine": "mesh"}) == "mesh"
        with pytest.raises(HttpError):
            mesh._check_engine({"engine": "gpu"})
    finally:
        cpu.store.close()
        mesh.store.close()


def _cli(args: list[str]) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                           "volume", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_takes_the_mesh_flags():
    a = parse_args(["volume", "-ec.engine", "mesh", "-ec.mesh.devices",
                    "0,2"])
    assert a.ec_engine == "mesh" and a.ec_mesh_devices == "0,2"
    assert parse_args(["volume"]).ec_mesh_devices == ""


@pytest.mark.parametrize("spec", ["", "1,1"])
def test_cli_mesh_needs_a_card(tmp_path, spec):
    if torch.cuda.is_available():
        pytest.skip("a machine with a card starts the server")
    res = _cli(["-dir", str(tmp_path), "-ec.engine", "mesh",
                "-ec.mesh.devices", spec])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "listening" not in res.stdout


def test_mesh_phase_on_cpu(tmp_path):
    """chip_smoke.py's mesh phase rehearsed tiny through the plain
    versions: every check inside it runs (the shards' sha256 against the
    main path's, the programs against kernel 1 alone and the plain
    version); the CLI leg runs ``-ec.engine cpu``, as mesh needs a card."""
    import chip_smoke

    res = chip_smoke.run_main_path("cpu", str(tmp_path), 3 << 20, 1 << 20,
                                   64 << 10, reads=4, stripes=2)
    sets = chip_smoke.mesh_lane_sets("cpu")
    assert sets == [[CPU], [CPU] * 4]
    mesh = chip_smoke.run_mesh_phase("cpu", str(tmp_path), res["hashes"],
                                     res["specs"], sets, 64 << 10,
                                     cli_engine="cpu", dispatch_b=128 << 10,
                                     threads=4, per_thread=2)
    assert [p["lanes"] for p in mesh["programs"]] == [["cpu"], ["cpu"] * 4]
    assert set(mesh["programs"][1]) == {
        "lanes", "kernel_alone_ms", "sharded_encode", "mesh_engine",
        "training_step", "ring_rebuild_2", "ring_rebuild_5"}
    dispatches = [r["dispatches"] for r in mesh["store"]]
    assert dispatches[0] == dispatches[1] >= 3
    assert set(mesh["store"][1]["per_lane_fetch_s"]) == {"0", "1", "2", "3"}
    assert {"setup_s", "fill_s", "write_s", "sidecar_s", "close_s",
            "wall_s"} <= set(mesh["store"][0]["stats"])
    assert "wall_s" in mesh["split"]["stats"]
    gets = mesh["degraded_gets"]
    assert gets["lanes"] == ["cpu"] * 4 and 1 <= gets["gets"] <= 8
    assert gets["threads"] == 4 and gets["launches"] == gets["rule"] == 0
    assert not os.path.exists(str(tmp_path / "mesh_get"))
    assert mesh["cli"]["rule"] == 1
    assert mesh["split"]["mesh"] == [1, 2, 2]
    assert mesh["cli"]["start_line"].startswith("volume server listening")
    assert mesh["path_launches"] == 0  # CPU lanes launch no kernel
    assert not os.path.exists(str(tmp_path / "mesh_cli"))
    assert not os.path.exists(str(tmp_path / "split.ec00"))
