"""The port on a CUDA card: kernel against plain version, the card's
pipeline against the CPU one, byte for byte, and a two-server cluster.

Marked ``gpu``; each test skips when no card is present.  This file
imports no jax, so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ec import gf256
from seaweedfs_tpu_torch.ec.codec import ReedSolomon
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
from seaweedfs_tpu_torch.ops.gf_matmul import (MAX_K, gf_matmul,
                                               gf_matmul_plain,
                                               gf_table_build, gf_table_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("r,k", [(4, 10), (1, 10), (2, 10), (5, 10),
                                 (3, 6), (6, 12), (4, 7), (9, 200),
                                 (4, 226), (2, 230)])
@pytest.mark.parametrize("width", [1, 7, 15, 17, 4096, 4097, 65537,
                                   1 << 20, (8 << 20) + 5])
def test_kernel_matches_plain(cuda, r, k, width):
    m = _rand((r, k), seed=r * k)
    data = _rand((k, width), seed=width).to(cuda)
    before = gf_matmul.launches
    got = gf_matmul(m.to(cuda), data)
    assert gf_matmul.launches - before == -(-r // 4)
    assert torch.equal(got, gf_matmul_plain(m.to(cuda), data))


@pytest.mark.parametrize("r,k", [(1, 10), (4, 10), (5, 10), (3, 6),
                                 (4, 12), (9, 200), (2, MAX_K)])
def test_built_table_equals_its_twin(cuda, r, k):
    m = _rand((r, k), seed=7 * r + k)
    before = gf_table_build.launches
    got = gf_table_build(m.to(cuda))
    assert gf_table_build.launches - before == 1
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          gf_table_plain(m.numpy()))


def test_table_is_built_once_per_matrix_and_after_a_change(cuda):
    m = torch.from_numpy(gf256.build_encoding_matrix(10, 14)[10:].copy()
                         ).to(cuda)
    data = _rand((10, 4097), seed=9).to(cuda)
    before = gf_table_build.launches
    first = gf_matmul(m, data)
    second = gf_matmul(m, data)
    assert gf_table_build.launches - before == 1
    assert torch.equal(first, second)
    m[0, 0] ^= 1  # in place: the matrix's version moves, its tables follow
    third = gf_matmul(m, data)
    assert gf_table_build.launches - before == 2
    assert torch.equal(third, gf_matmul_plain(m, data))


def test_a_table_built_on_one_stream_serves_another(cuda):
    m = torch.from_numpy(gf256.build_encoding_matrix(10, 14)[10:].copy()
                         ).to(cuda)
    data = _rand((10, 1 << 20), seed=10).to(cuda)
    want = gf_matmul_plain(m, data)
    torch.cuda.synchronize()
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(a):
        torch.cuda._sleep(50_000_000)  # the build queues behind this
        gf_matmul(m, data[:, :16])
    with torch.cuda.stream(b):
        got = gf_matmul(m, data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_launches_replay_in_a_cuda_graph(cuda):
    """chip_smoke.py times the kernel alone by replaying captured
    launches: a replay computes what a launch does."""
    m = torch.from_numpy(gf256.build_encoding_matrix(10, 14)[10:].copy()
                         ).to(cuda)
    data = _rand((10, 65536), seed=11).to(cuda)
    out = torch.zeros((4, 65536), dtype=torch.uint8, device=cuda)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        gf_matmul(m, data, out)
    torch.cuda.synchronize()
    out.zero_()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        gf_matmul(m, data, out)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gf_matmul_plain(m, data))


def test_kernel_refuses_a_table_over_shared_memory(cuda):
    with pytest.raises(ValueError):
        gf_matmul(_rand((2, MAX_K + 1), 1).to(cuda),
                  _rand((MAX_K + 1, 64), 2).to(cuda))


def test_unaligned_and_strided_views(cuda):
    m = torch.from_numpy(gf256.build_encoding_matrix(10, 14)[10:].copy())
    slot = _rand((10, 5000), seed=3).to(cuda)
    out = torch.zeros((4, 5003), dtype=torch.uint8, device=cuda)
    gf_matmul(m.to(cuda), slot[:, 3:4003], out=out[:, 1:4001])
    assert torch.equal(out[:, 1:4001], gf_matmul_plain(m, slot[:, 3:4003]
                                                       .cpu()).to(cuda))
    assert int(out[:, 0].sum()) == 0 and int(out[:, 4001:].sum()) == 0


def test_codec_on_the_card(cuda):
    rs_gpu, rs_cpu = ReedSolomon(10, 4), ReedSolomon(10, 4, device="cpu")
    data = _rand((10, 3000), seed=4).numpy()
    parity = rs_gpu.encode(data)
    assert np.array_equal(parity, rs_cpu.encode(data))
    shards = list(data) + list(parity)
    damaged = [None if i in (2, 7, 11) else s for i, s in enumerate(shards)]
    rs_gpu.reconstruct(damaged)
    assert all(np.array_equal(a, b) for a, b in zip(damaged, shards))


def test_streaming_card_equals_cpu(cuda, tmp_path):
    size = 23 * 1024 * 1024 + 12345
    dat = tmp_path / "v.dat"
    dat.write_bytes(_rand(size, seed=5).numpy().tobytes())
    bases = {}
    for dev in ("cuda", "cpu"):
        base = str(tmp_path / dev)
        os.link(dat, base + ".dat")
        StreamingEncoder(dispatch_mb=1, device=dev).encode_file(
            base + ".dat", base, large_block_size=1536 * 1024,
            small_block_size=64 * 1024)
        bases[dev] = base
    exts = [to_ext(i) for i in range(14)] + [".eci"]
    for ext in exts:
        assert open(bases["cuda"] + ext, "rb").read() == \
            open(bases["cpu"] + ext, "rb").read(), ext
    want = {i: open(bases["cuda"] + to_ext(i), "rb").read() for i in range(14)}
    for i in (1, 5, 10, 12):
        os.remove(bases["cuda"] + to_ext(i))
    enc = StreamingEncoder(dispatch_mb=1, device="cuda")
    assert enc.rebuild_files(bases["cuda"]) == [1, 5, 10, 12]
    for i in (1, 5, 10, 12):
        assert open(bases["cuda"] + to_ext(i), "rb").read() == want[i]
    assert enc.stats["dispatches"] >= 2


def test_traced_work_on_the_card(cuda, tmp_path):
    """Spans on the card's paths change neither bytes nor launches: the
    codec's ``ec.reconstruct`` and a streaming encode under a process
    tracer of their own, against the same work untraced."""
    from seaweedfs_tpu_torch.observability import analyze, tracer

    rs = ReedSolomon(10, 4)
    data = _rand((10, 1 << 20), seed=6).numpy()
    shards = list(data) + list(rs.encode(data))
    got = {}
    for traced in (False, True):
        tr = tracer.Tracer(enabled=traced, namespace="pgpu")
        saved, tracer._GLOBAL = tracer._GLOBAL, tr
        try:
            damaged = [None if i in (0, 13) else s
                       for i, s in enumerate(shards)]
            before = gf_matmul.launches
            rs.reconstruct(damaged)
            got[traced] = (gf_matmul.launches - before,
                           [bytes(s) for s in damaged],
                           [sp.name for sp in tr.snapshot()])
        finally:
            tracer._GLOBAL = saved
    assert got[True][:2] == got[False][:2] and got[True][0] == 1
    assert got[True][2] == ["ec.reconstruct"] and got[False][2] == []

    dat = tmp_path / "v.dat"
    dat.write_bytes(_rand(9 * 1024 * 1024, seed=7).numpy().tobytes())
    out = {}
    for traced in (False, True):
        base = str(tmp_path / f"t{int(traced)}")
        enc = StreamingEncoder(dispatch_mb=1, device="cuda")
        tr = tracer.Tracer(enabled=traced, namespace="pgpu")
        saved, tracer._GLOBAL = tracer._GLOBAL, tr
        try:
            before = gf_matmul.launches
            enc.encode_file(str(dat), base)
        finally:
            tracer._GLOBAL = saved
        out[traced] = (gf_matmul.launches - before,
                       [open(base + to_ext(i), "rb").read()
                        for i in range(14)])
        if traced:
            report = analyze(tr)
    assert out[True] == out[False]
    assert out[True][0] == enc.dispatches_for(9 * 1024 * 1024)
    assert report["runs"][0]["dispatches"] == out[True][0]


def test_volume_server_on_the_card(cuda, tmp_path):
    """VolumeServer(device="cuda"): an encode over HTTP, eight threads of
    degraded GETs with data shards 2 and 7 gone, and a request for the
    CPU engine refused with 400."""
    import json
    import socket
    import threading

    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{free_port()}",
                      port=free_port()).start()
    url = f"http://{vs.url}"
    rng = np.random.default_rng(7)
    blobs = {str(FileId(1, i + 1, 0x5EED0000 + i)):
             rng.bytes(int(rng.integers(1, 3 << 20))) for i in range(40)}
    try:
        http_json("POST", url + "/admin/assign_volume", {"volume_id": 1})
        for fid, data in blobs.items():
            assert http_bytes("PUT", f"{url}/{fid}", data)[0] == 201
        status, body, _ = http_bytes(
            "POST", url + "/admin/ec/generate",
            json.dumps({"volume_id": 1, "engine": "cpu"}).encode())
        assert status == 400 and "-ec.engine tpu" in body.decode()
        assert not os.path.exists(tmp_path / "1.ec00")
        before = gf_matmul.launches
        for path in ("/admin/readonly", "/admin/ec/generate",
                     "/admin/ec/mount", "/admin/delete_volume"):
            http_json("POST", url + path, {"volume_id": 1})
        http_json("POST", url + "/admin/ec/delete",
                  {"volume_id": 1, "shard_ids": [2, 7]})
        bad = []

        def reader(t):
            for fid in list(blobs)[t::8]:
                status, body, _ = http_bytes("GET", f"{url}/{fid}")
                if (status, body) != (200, blobs[fid]):
                    bad.append(fid)

        threads = [threading.Thread(target=reader, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not bad
        assert gf_matmul.launches > before
    finally:
        vs.stop()


def test_two_server_cluster_on_the_card(cuda, tmp_path):
    """The port's master, two card servers and the shell: upload through
    WeedClient, ec.encode, two shards deleted, GETs from both servers
    (each fetches what the other holds and reconstructs what is gone),
    ec.rebuild, ec.decode."""
    import socket
    import time

    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    master = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    servers = []
    try:
        for i in range(2):
            d = tmp_path / f"vs{i}"
            d.mkdir()
            servers.append(VolumeServer([str(d)], master.url,
                                        port=free_port(),
                                        pulse_seconds=0.3).start())
        deadline = time.monotonic() + 30
        while len(master.topo.all_nodes()) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        client = WeedClient(master.url)
        rng = np.random.default_rng(11)
        blobs = [rng.bytes(int(rng.integers(1, 1 << 20))) for _ in range(30)]
        fids = [client.upload(b, collection="ec") for b in blobs]
        vid = int(fids[0].split(",")[0])
        env = CommandEnv(master.url)
        env.lock()
        before = gf_matmul.launches
        assert "via tpu engine" in run_command(
            env, f"ec.encode -volumeId {vid} -collection ec")
        assert gf_matmul.launches > before
        holder = next(vs for vs in servers
                      if 0 in vs.store.ec_volumes[vid].shards)
        http_json("POST", f"http://{holder.url}/admin/ec/delete",
                  {"volume_id": vid, "collection": "ec", "shard_ids": [0, 2]})
        for vs in servers:
            vs.heartbeat_now()
        before = gf_matmul.launches
        for vs in servers:
            for fid, blob in zip(fids, blobs):
                assert http_bytes("GET", f"http://{vs.url}/{fid}")[1] == blob
        assert gf_matmul.launches > before
        assert all(vs.ec_reads["remote"] > 0 for vs in servers)
        assert "rebuilt shards [0, 2]" in run_command(
            env, f"ec.rebuild -volumeId {vid}")
        assert "decoded ec volume" in run_command(
            env, f"ec.decode -volumeId {vid}")
        env.unlock()
        for fid, blob in zip(fids, blobs):
            assert client.download(fid) == blob
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def test_coordinator_repair_on_the_card(cuda, tmp_path):
    """The master's coordinator heals a stopped card server's shards with
    no shell command: its rebuild runs on the card (engine "tpu"), the
    rebuilt shards equal their bytes from before the loss, nothing
    fails."""
    import hashlib
    import socket
    import time

    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def sha(vs, vid, sid):
        path = volume_file_prefix(vs.store.directories[0], "ec", vid) + \
            to_ext(sid)
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    master = MasterServer(port=free_port(), pulse_seconds=0.3,
                          coordinator_seconds=0.3,
                          metrics_aggregation_seconds=0.3).start()
    master.coordinator.pause("setup")
    servers = {}
    stopped = None
    try:
        for i in range(3):
            d = tmp_path / f"vs{i}"
            d.mkdir()
            vs = VolumeServer([str(d)], master.url, port=free_port(),
                              pulse_seconds=0.3).start()
            servers[vs.url] = vs
        deadline = time.monotonic() + 30
        while len(master.topo.all_nodes()) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        client = WeedClient(master.url)
        rng = np.random.default_rng(12)
        blobs = [rng.bytes(int(rng.integers(1, 1 << 20))) for _ in range(30)]
        fids = [client.upload(b, collection="ec") for b in blobs]
        vid = int(fids[0].split(",")[0])
        env = CommandEnv(master.url)
        env.lock()
        assert "via tpu engine" in run_command(
            env, f"ec.encode -volumeId {vid} -collection ec")
        env.unlock()
        holders = {s: us for s, us in http_json(
            "GET", f"http://{master.url}/dir/lookup_ec?volumeId={vid}"
        )["shards"].items()}
        hashes = {int(s): sha(servers[us[0]], vid, int(s))
                  for s, us in holders.items()}
        # the server holding the fewest shards, so at least ten are left
        stopped = min(servers, key=lambda u: (
            sum(u in us for us in holders.values()), u))
        servers[stopped].stop()
        before = gf_matmul.launches
        master.coordinator.resume()
        deadline = time.monotonic() + 120
        while True:
            st = master.coordinator.status()
            shards = {int(s): [u for u in us if u != stopped]
                      for s, us in http_json(
                          "GET", f"http://{master.url}/dir/lookup_ec"
                                 f"?volumeId={vid}")["shards"].items()}
            if st["repairs"]["done"] and not st["queue"] and all(
                    shards.get(s) for s in range(14)):
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.1)
        assert st["repairs"]["failed"] == 0 and not st["last_error"]
        assert gf_matmul.launches > before  # the rebuild ran on the card
        for s, us in shards.items():
            for u in us:
                assert sha(servers[u], vid, s) == hashes[s]
        for fid, blob in zip(fids, blobs):
            assert client.download(fid) == blob
    finally:
        for url, vs in servers.items():
            if url != stopped:
                vs.stop()
        master.stop()


def test_alert_drill_on_the_card(cuda, tmp_path):
    """A rotted shard on a card server: the master's telemetry loop fires
    scrub_unrepairable, the flight recorder attaches bundles from that
    server and the master, and the coordinator's repair, rebuilt on the
    card, names the alert."""
    import socket
    import time

    from seaweedfs_tpu_torch.client.operation import WeedClient
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.volume import volume_file_prefix
    from seaweedfs_tpu_torch.utils.httpd import http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def until(what, ok, timeout=120):
        deadline = time.monotonic() + timeout
        while True:
            got = ok()
            if got:
                return got
            assert time.monotonic() < deadline, what
            time.sleep(0.1)

    master = MasterServer(port=free_port(), pulse_seconds=0.3,
                          coordinator_seconds=0.3,
                          metrics_aggregation_seconds=0.3).start()
    master.coordinator.pause("setup")
    servers = {}
    try:
        for i in range(3):
            d = tmp_path / f"vs{i}"
            d.mkdir()
            vs = VolumeServer([str(d)], master.url, port=free_port(),
                              pulse_seconds=0.3).start()
            servers[vs.url] = vs
        until("registration", lambda: len(master.topo.all_nodes()) == 3)
        client = WeedClient(master.url)
        rng = np.random.default_rng(14)
        blobs = [rng.bytes(int(rng.integers(1, 1 << 20))) for _ in range(20)]
        fids = [client.upload(b, collection="ec") for b in blobs]
        vid = int(fids[0].split(",")[0])
        env = CommandEnv(master.url)
        env.lock()
        assert "via tpu engine" in run_command(
            env, f"ec.encode -volumeId {vid} -collection ec")
        holders = http_json("GET", f"http://{master.url}/dir/lookup_ec"
                                   f"?volumeId={vid}")["shards"]
        host = sorted(holders["0"])[0]
        path = volume_file_prefix(servers[host].store.directories[0], "ec",
                                  vid) + to_ext(0)
        base = master.alert_engine.evaluations
        until("a baseline", lambda: master.alert_engine.evaluations > base + 1)
        with open(path, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0x04]))
        out = run_command(env, "ec.scrub -all -rate 0")
        env.unlock()
        assert f"volume {vid}: unrepairable corrupt_shards=[0]" in out, out

        def firing():
            a = {x["name"]: x for x in http_json(
                "GET", f"http://{master.url}/cluster/alerts?state=firing"
            )["alerts"]}
            s = a.get("scrub_unrepairable")
            return s if s and len(s.get("bundles") or []) == 2 else None

        alert = until("scrub_unrepairable with bundles", firing)
        assert alert["servers"] == [host]
        for bnd in alert["bundles"]:
            doc = http_json("GET", f"http://{bnd['server']}/debug/"
                                   f"flightrecorder/{bnd['id']}")
            assert doc["meta"]["alert"] == "scrub_unrepairable"
            assert doc["metrics"] and doc["events"]
        before = gf_matmul.launches
        master.coordinator.resume()
        st = until("the repair", lambda: (lambda s: s if s["repairs"][
            "done"] and not s["queue"] else None)(master.coordinator.status()))
        repair = next(r for r in st["recent"] if r["action"] == "repair_done")
        assert repair["alert"] in ("scrub_unrepairable",
                                   "corrupt_shards_increase")
        assert gf_matmul.launches > before  # the rebuild ran on the card
        for fid, blob in zip(fids, blobs):
            assert client.download(fid) == blob
    finally:
        for vs in servers.values():
            vs.stop()
        master.stop()


def test_resumed_encode_on_the_card(cuda, tmp_path):
    """ec.dispatch fails once mid-encode on the card: the encode resumes
    from its checkpoint (fewer launches than a restart from byte 0) to
    the CPU encode's bytes, `.eci` included."""
    from seaweedfs_tpu_torch.utils import faultinject

    size = 40 * 1024 * 1024 + 777
    base = str(tmp_path / "v")
    with open(base + ".dat", "wb") as f:
        f.write(_rand(size, seed=8).numpy().tobytes())
    exts = [to_ext(i) for i in range(14)] + [".eci"]
    StreamingEncoder(dispatch_mb=1, device="cpu").encode_file(
        base + ".dat", str(tmp_path / "cpu"))
    enc = StreamingEncoder(dispatch_mb=1, device="cuda")
    faultinject.enable("ec.dispatch", error_rate=1.0, max_hits=1, after=2)
    try:
        before = gf_matmul.launches
        enc.encode_file(base + ".dat", str(tmp_path / "cuda"))
        launches = gf_matmul.launches - before
    finally:
        faultinject.clear()
    assert enc.stats["retries"] == 1 and enc.stats["resume_byte"] > 0
    # 1 MiB small rows: one 1 MiB dispatch per 10 MiB of the file
    dispatches = -(-size // (10 << 20))
    assert 0 < launches <= dispatches + enc.depth + 1
    for ext in exts:
        assert open(str(tmp_path / "cuda") + ext, "rb").read() == \
            open(str(tmp_path / "cpu") + ext, "rb").read(), ext


def test_scrub_repairs_on_the_card(cuda, tmp_path):
    """The scrubber over Store(device="cuda"): rot in shards 3 and 12 is
    quarantined and rebuilt by the kernel to the original bytes."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.volume_server.scrubber import EcScrubber
    from seaweedfs_tpu_torch.volume_server.store import Store

    store = Store([str(tmp_path)])
    try:
        store.add_volume(1)
        rng = np.random.default_rng(9)
        for i in range(1, 40):
            store.write_needle(1, Needle(cookie=i, id=i, data=rng.bytes(
                int(rng.integers(1, 1 << 20)))))
        store.ec_generate(1)
        store.ec_mount(1)
        base = store.ec_volumes[1].base_file_name
        orig = {s: open(base + to_ext(s), "rb").read() for s in (3, 12)}
        for s in (3, 12):
            with open(base + to_ext(s), "r+b") as f:
                f.seek(1000)
                c = f.read(1)
                f.seek(1000)
                f.write(bytes([c[0] ^ 1]))
        before = gf_matmul.launches
        st = EcScrubber(store, rate_mb_s=0).run_pass()
        assert gf_matmul.launches > before
        assert st["verdicts"]["1"]["status"] == "repaired"
        assert st["verdicts"]["1"]["corrupt_shards"] == [3, 12]
        for s in (3, 12):
            assert open(base + to_ext(s), "rb").read() == orig[s]
            assert os.path.exists(base + to_ext(s) + ".bad")
    finally:
        store.close()


def test_trio_failover_on_the_card(cuda, tmp_path):
    """Master HA over card servers: three CLI masters, four ``volume
    -ec.engine tpu`` processes; the leader SIGKILLed mid-repair, and the
    promoted leader's rebuild launches the kernel on the card under the
    original cause, inside the reference's budgets (chip_smoke.py's
    failover phase at 64 MiB)."""
    import chip_smoke

    res = chip_smoke.run_failover_phase("tpu", str(tmp_path), 64 << 20,
                                        threads=4, pulse_seconds=0.3,
                                        coordinator_seconds=0.5,
                                        delay_s=0.5)
    assert all(res["checks"].values()), res["checks"]
    assert res["checks"]["launches"]
    assert res["launches"]["launches"] == res["launches"]["dispatch_rule"]
    assert res["attribution"]["equal"]
    assert res["journal_loss_count"] == 0
    assert sum(s["launches"] for s in res["servers"].values()) > \
        res["launches"]["launches"]  # the encode launched too


def test_native_plane_volume_encoded_on_the_card(cuda, tmp_path):
    """``VolumeServer(dataplane="native")`` on the card: needles written
    through the C++ plane's framed port, ``/admin/ec/generate`` with the
    plane quiesced around it launching the kernel, every shard equal to
    the plain encode of a copy of the `.dat` the plane wrote, and the
    plane serving the frozen volume's reads again."""
    import shutil
    import socket

    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils.framing import tcp_port_for
    from seaweedfs_tpu_torch.utils.httpd import http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer
    from seaweedfs_tpu_torch.volume_server.tcp import (TcpVolumeClient,
                                                       tcp_address)

    def free_port():
        while True:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", tcp_port_for(port)))
                    return port
                except OSError:
                    continue

    vs = VolumeServer([str(tmp_path / "vs")], f"127.0.0.1:{free_port()}",
                      port=free_port(), dataplane="native").start()
    rng = np.random.default_rng(11)
    blobs = {str(FileId(1, i + 1, 0x7A0000 + i)):
             rng.bytes(int(rng.integers(1, 256 << 10))) for i in range(120)}
    try:
        http_json("POST", f"http://{vs.url}/admin/assign_volume",
                  {"volume_id": 1})
        tcp, addr = TcpVolumeClient(), tcp_address(vs.url)
        for fid, data in blobs.items():
            tcp.write(addr, fid, data)
        cpu_dir = tmp_path / "cpu"
        cpu_dir.mkdir()
        shutil.copy(tmp_path / "vs" / "1.dat", cpu_dir / "1.dat")
        before = gf_matmul.launches
        http_json("POST", f"http://{vs.url}/admin/readonly",
                  {"volume_id": 1})
        http_json("POST", f"http://{vs.url}/admin/ec/generate",
                  {"volume_id": 1})
        assert gf_matmul.launches > before
        StreamingEncoder(device="cpu").encode_file(str(cpu_dir / "1.dat"),
                                                   str(cpu_dir / "1"))
        for i in range(14):
            assert (tmp_path / "vs" / f"1{to_ext(i)}").read_bytes() == \
                (cpu_dir / f"1{to_ext(i)}").read_bytes(), i
        assert vs.store.native_plane.has(1)
        for fid, data in blobs.items():
            assert tcp.read(addr, fid) == data
    finally:
        vs.stop()


def _mesh_lanes() -> list:
    """Every visible card, or four lanes of card 0 on a one-card box."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 4)


def test_mesh_programs_on_the_card(cuda):
    """The sharded encode, MeshEngine, the training step and the ring
    rebuild equal kernel 1 alone and the plain version, each with its
    launch rule (chip_smoke.py checks the same at [10, 8 MiB])."""
    import chip_smoke

    got = chip_smoke.check_mesh_programs("cuda", _mesh_lanes(), 1 << 20)
    assert got["ring_rebuild_5"]["launches"] == 5
    assert got["training_step"]["launches"] == 2 * len(_mesh_lanes())


def test_mesh_streaming_on_the_card(cuda, tmp_path):
    """engine="mesh" over the lanes and the device engine's split over
    them write the one-card encode's bytes and rebuild them, with a
    launch a dispatch on the queue plane and one per lane and dispatch
    on the split."""
    raw = np.random.default_rng(21).integers(0, 256, (25 << 20) + 977,
                                             dtype=np.uint8).tobytes()
    dat = tmp_path / "v.dat"
    dat.write_bytes(raw)
    StreamingEncoder(dispatch_mb=1).encode_file(str(dat), str(tmp_path / "one"))
    exts = [to_ext(i) for i in range(14)] + [".eci"]
    want = {e: (tmp_path / f"one{e}").read_bytes() for e in exts}
    lanes = _mesh_lanes()
    for name, enc, per in (
            ("mesh", StreamingEncoder(dispatch_mb=1, engine="mesh",
                                      devices=lanes), 1),
            ("split", StreamingEncoder(dispatch_mb=1, devices=lanes,
                                       mesh=True), len(lanes))):
        base = str(tmp_path / name)
        before = gf_matmul.launches
        enc.encode_file(str(dat), base)
        assert gf_matmul.launches - before == per * enc.dispatches_for(
            len(raw))
        assert {e: open(base + e, "rb").read() for e in exts} == want, name
        for i in (2, 11):
            os.remove(base + to_ext(i))
        assert enc.rebuild_files(base) == [2, 11]
        for i in (2, 11):
            assert open(base + to_ext(i), "rb").read() == want[to_ext(i)]


def test_mesh_engine_serves_threads_at_once_on_the_card(cuda):
    """A mesh store's degraded reads call its MeshEngine from several
    request threads at once: over four lanes each call's product still
    equals kernel 1 alone, while the calls' buffers come and go."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch.ec.codec import MeshEngine

    rng = np.random.default_rng(31)
    lanes = [torch.device("cuda", 0)] * 4
    engine = MeshEngine(devices=lanes)
    cases = []
    for i in range(48):
        m = rng.integers(0, 256, (1 + i % 4, 10), dtype=np.uint8)
        data = rng.integers(0, 256, (10, (1 << 20) + 4099 * i),
                            dtype=np.uint8)
        want = gf_matmul(torch.from_numpy(m).cuda(),
                         torch.from_numpy(data).cuda()).cpu().numpy()
        cases.append((m, data, want))

    def call(i: int) -> bool:
        m, data, want = cases[i]
        return all(np.array_equal(engine.matmul(m, data), want)
                   for _ in range(3))

    with ThreadPoolExecutor(8) as pool:
        assert all(pool.map(call, range(len(cases))))


def test_failover_drill_on_the_card(cuda, tmp_path, monkeypatch):
    """scenarios.run_failover on card servers: a three-master quorum loses
    its leader mid-repair and the drill passes the reference's budgets;
    the encode's and each repair's kernel launches equal the dispatch
    rule (one launch a dispatch of four rows or fewer)."""
    from seaweedfs_tpu_torch.scenarios import (failover, master_failover,
                                               run_failover)
    from seaweedfs_tpu_torch.volume_server.store import Store

    calls: list[dict] = []
    make, rebuild = failover._make_ec_volume, Store.ec_rebuild

    def counted_make(vs, vid, needles=30):
        before = gf_matmul.launches
        make(vs, vid, needles)
        enc = vs.store.streaming_encoder()
        dat = vs.store._ec_base(vid) + ".dat"
        calls.append({"leg": "encode", "launches": gf_matmul.launches - before,
                      "rule": enc.dispatches_for(os.path.getsize(dat))
                      * enc.launches_per_dispatch()})

    def counted_rebuild(self, vid, collection="", engine=None):
        before = gf_matmul.launches
        rebuilt = rebuild(self, vid, collection, engine)
        enc = self.streaming_encoder(engine)
        shard = self._ec_base(vid, collection) + to_ext(rebuilt[0]) \
            if rebuilt else None
        dispatches = -(-os.path.getsize(shard) // enc.dispatch_b) \
            if shard else 0
        calls.append({"leg": "rebuild", "launches":
                      gf_matmul.launches - before,
                      "rule": dispatches * -(-len(rebuilt) // 4)})
        return rebuilt

    monkeypatch.setattr(failover, "_make_ec_volume", counted_make)
    monkeypatch.setattr(Store, "ec_rebuild", counted_rebuild)
    res = run_failover(master_failover(), base_dir=str(tmp_path),
                       device="cuda")
    assert res["verdict"] == "pass", res["checks"]
    assert calls[0]["leg"] == "encode" and calls[0]["rule"] > 0
    assert any(c["leg"] == "rebuild" and c["rule"] > 0 for c in calls)
    for c in calls:
        assert c["launches"] == c["rule"], calls
