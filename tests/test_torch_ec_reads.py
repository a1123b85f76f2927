"""A degraded read with no master: the local rebuild is counted.

A port volume server (``device="cpu"``) holds an EC volume with shard 0
gone, and its master does not answer.  A GET of a needle on shard 0
cannot ask ``/dir/lookup_ec`` for a holder, so the server rebuilds the
interval from its own survivors.  That rebuild counts in
``ec_reads["reconstructed"]`` (the CLI's stop line), exactly once per
launch of the GF(2^8) product (here its plain version, on the CPU).
"""

from __future__ import annotations

import numpy as np

from seaweedfs_tpu_torch.ops import gf_matmul as gm
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils.httpd import http_bytes
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port


def test_a_rebuild_without_lookup_is_counted(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    data = {i: rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
            for i in range(1, 60)}
    v = Volume(str(tmp_path), "", 1)
    for i, d in data.items():
        v.write_needle(Needle(cookie=i, id=i, data=d))
    v.close()
    dead_master = f"127.0.0.1:{free_port()}"  # nothing listens there
    vs = VolumeServer([str(tmp_path)], dead_master, port=free_port(),
                      pulse_seconds=0.2, device="cpu").start()
    try:
        vs.store.ec_generate(1)
        vs.store.unmount_volume(1)
        vs.store.ec_mount(1)
        vs.store.ec_delete_shards(1, [0])
        assert 0 not in vs.store.ec_volumes[1].shards
        plain_calls = []
        plain = gm.gf_matmul_plain
        monkeypatch.setattr(gm, "gf_matmul_plain", lambda m, d: (
            plain_calls.append(1), plain(m, d))[1])
        before = dict(vs.ec_reads)
        # needle 1 starts the .dat, so it lies on data shard 0
        status, body, _ = http_bytes(
            "GET", f"http://{vs.url}/1,{format_needle_id_cookie(1, 1)}")
        assert status == 200 and body == data[1]
        assert vs.ec_reads["reconstructed"] - before["reconstructed"] == 1
        assert vs.ec_reads["remote"] == before["remote"]
        assert len(plain_calls) == 1
    finally:
        vs.stop()
