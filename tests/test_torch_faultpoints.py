"""The scenario harness's fault points in the port, against seaweedfs_tpu.

- ``FAULT_POINTS`` holds the reference's points less ``ec.shm`` and
  ``ec.worker.ack`` (the CPU codec's worker processes, not ported), and
  the points the scenarios arm keep the reference's descriptions; the
  shell's ``fault.list`` prints them;
- ``hit_peer`` and ``peer_delay`` over a table of armed peer params give
  the reference's outcomes and counts, ``scoped`` arms for a block;
- a ``net.partition`` on a peer fails ``_pooled_request``,
  ``http_download`` and the framed client's sends to it with the
  reference's exception type, before anything is sent, and spares other
  peers; ``net.delay`` is slept deadline-aware as the reference's;
- ``shard.read`` fails an EC shard's pread, and ``loop.block`` stalls the
  reactor's inline fast path of a live port volume server.
"""

from __future__ import annotations

import os
import time

import pytest

from seaweedfs_tpu.utils import deadline as ref_deadline
from seaweedfs_tpu.utils import faultinject as ref_fi
from seaweedfs_tpu.utils import framing as ref_framing
from seaweedfs_tpu.utils import httpd as ref_httpd
from seaweedfs_tpu_torch.utils import deadline as port_deadline
from seaweedfs_tpu_torch.utils import faultinject as fi
from seaweedfs_tpu_torch.utils import framing as port_framing
from seaweedfs_tpu_torch.utils import httpd as port_httpd
from tests.conftest import free_port

PACKAGES = {"ref": (ref_fi, ref_httpd, ref_framing, ref_deadline),
            "port": (fi, port_httpd, port_framing, port_deadline)}
SCENARIO_POINTS = ("shard.read", "net.request", "net.delay", "net.drop",
                   "net.partition", "loop.block")


@pytest.fixture(autouse=True)
def _disarmed():
    for mods in PACKAGES.values():
        mods[0].clear()
    yield
    for mods in PACKAGES.values():
        mods[0].clear()


def test_the_registry_is_the_reference_s_less_the_cpu_codec_workers():
    assert set(fi.FAULT_POINTS) == \
        set(ref_fi.FAULT_POINTS) - {"ec.shm", "ec.worker.ack"}
    for name in SCENARIO_POINTS:
        assert fi.FAULT_POINTS[name] == ref_fi.FAULT_POINTS[name], name


def test_fault_list_prints_the_scenario_points():
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    out = run_command(CommandEnv("127.0.0.1:1"), "fault.list")
    lines = out.splitlines()
    assert lines[0].startswith(f"fault points: {len(fi.FAULT_POINTS)} ")
    for name in SCENARIO_POINTS:
        assert any(ln.split()[0] == name for ln in lines[1:]), name


# (enable's keywords, the peer a send goes to, how many sends)
PEER_CASES = [
    ({"error_rate": 1.0, "params": {"peer": "a:1"}}, "a:1", 2),
    ({"error_rate": 1.0, "params": {"peer": "a:1"}}, "b:2", 2),
    ({"error_rate": 1.0}, "b:2", 1),
    ({"error_rate": 1.0, "params": {"other": 1}}, "c:3", 1),
    ({"error_rate": 1.0, "params": {"peer": None}}, "c:3", 1),
    ({"error_rate": 1.0, "max_hits": 2, "params": {"peer": "a:1"}},
     "a:1", 4),
    ({"delay": 0.01, "params": {"peer": "a:1"}}, "a:1", 2),
    ({"delay": 0.01, "params": {"peer": "a:1"}}, "b:2", 2),
    ({"delay": 0.01, "max_hits": 1}, "z:9", 3),
    ({"delay": 0.0, "params": {"peer": "a:1"}}, "a:1", 1),
    ({}, "a:1", 1),
]


def _peer_outcomes(mod, kwargs: dict, peer: str, sends: int) -> tuple:
    mod.clear()
    out = []
    mod.enable("net.partition", **kwargs)
    mod.enable("net.delay", **kwargs)
    for _ in range(sends):
        try:
            mod.hit_peer("net.partition", peer)
            out.append("pass")
        except OSError as e:
            out.append(type(e).__name__)
        out.append(mod.peer_delay("net.delay", peer))
    out.append((mod.fired("net.partition"), mod.fired("net.delay")))
    mod.clear()
    out.append((mod.peer_delay("net.delay", peer),
                mod.hit_peer("net.partition", peer)))
    return tuple(out)


@pytest.mark.parametrize("kwargs,peer,sends", PEER_CASES)
def test_hit_peer_and_peer_delay_as_the_reference(kwargs, peer, sends):
    got = {name: _peer_outcomes(mods[0], kwargs, peer, sends)
           for name, mods in PACKAGES.items()}
    assert got["port"] == got["ref"]


def test_scoped_arms_for_the_block_alone():
    for name, (mod, *_rest) in PACKAGES.items():
        with mod.scoped("net.drop", error_rate=1.0,
                        params={"peer": "a:1"}):
            with pytest.raises(OSError):
                mod.hit_peer("net.drop", "a:1")
            assert mod._points, name
        assert not mod._points, name
        mod.hit_peer("net.drop", "a:1")


def _partitioned_calls(httpd, framing, peer: str, tmp_path) -> dict:
    """Each egress's outcome on a send to ``peer``: the exception type
    raised, or the value returned."""
    calls = {
        "_pooled_request": lambda: httpd._pooled_request(
            "GET", f"http://{peer}/1,01", None, None, 5.0),
        "http_download": lambda: httpd.http_download(
            "GET", f"http://{peer}/1,01", str(tmp_path / "dl"), 5.0),
        "framed": lambda: framing.FramedClient().request(peer, b"R",
                                                         "1,01"),
    }
    out = {}
    for name, call in calls.items():
        try:
            out[name] = ("returned", call())
        except Exception as e:  # noqa: BLE001 - the type is the result
            out[name] = ("raised", type(e).__name__,
                         isinstance(e, OSError))
    return out


def test_a_partition_fails_each_egress_with_the_reference_s_type(tmp_path):
    cut = f"127.0.0.1:{free_port()}"
    got = {}
    for name, (mod, httpd, framing, _ddl) in PACKAGES.items():
        mod.enable("net.partition", error_rate=1.0, params={"peer": cut})
        t0 = time.monotonic()
        got[name] = _partitioned_calls(httpd, framing, cut, tmp_path)
        assert time.monotonic() - t0 < 1.0  # fails at once, no wait
        assert mod.fired("net.partition") == 3
        mod.clear()
    assert got["port"] == got["ref"]
    assert all(v[0] == "raised" and v[2] for v in got["port"].values())
    assert not os.path.exists(tmp_path / "dl")


def test_a_partition_spares_other_peers(tmp_path):
    from seaweedfs_tpu_torch.master.server import MasterServer

    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    try:
        fi.enable("net.partition", error_rate=1.0,
                  params={"peer": f"127.0.0.1:{free_port()}"})
        st, body, _ = port_httpd.http_bytes(
            "GET", f"http://{m.url}/cluster/status", timeout=10.0)
        assert st == 200 and body
        assert fi.fired("net.partition") == 0
        # every peer: the master's own answer fails too
        fi.enable("net.partition", error_rate=1.0)
        st, _, _ = port_httpd.http_bytes(
            "GET", f"http://{m.url}/cluster/status", timeout=10.0)
        assert st == 0 and fi.fired("net.partition") == 1
    finally:
        fi.clear()
        m.stop()


def test_net_delay_is_slept_within_the_deadline(tmp_path):
    peer = f"127.0.0.1:{free_port()}"
    got = {}
    for name, (mod, httpd, framing, ddl) in PACKAGES.items():
        mod.enable("net.delay", delay=1.0, params={"peer": peer})
        t0 = time.monotonic()
        with ddl.scope(0.2):
            try:
                httpd._pooled_request("GET", f"http://{peer}/x", None,
                                      None, 5.0)
                got[name] = "returned"
            except Exception as e:  # noqa: BLE001 - the type is the result
                got[name] = type(e).__name__
        waited = time.monotonic() - t0
        assert 0.15 <= waited < 0.8, (name, waited)
        mod.clear()
    assert got["port"] == got["ref"] == "DeadlineExceeded"


def test_shard_read_fails_an_ec_shard_pread(tmp_path):
    from seaweedfs_tpu.ec.ec_volume import EcVolumeShard as RefShard
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolumeShard

    base = str(tmp_path / "7")
    with open(base + ".ec03", "wb") as f:
        f.write(bytes(range(256)) * 4)
    got = {}
    for name, cls in (("ref", RefShard), ("port", EcVolumeShard)):
        mod = PACKAGES[name][0]
        shard = cls(base, 3)
        try:
            assert shard.read_at(4, 8) == bytes([8, 9, 10, 11])
            mod.enable("shard.read", error_rate=1.0, max_hits=1)
            try:
                shard.read_at(4, 8)
                got[name] = "returned"
            except Exception as e:  # noqa: BLE001 - the type is the result
                got[name] = type(e).__name__
            assert shard.read_at(4, 8) == bytes([8, 9, 10, 11])
            assert mod.fired("shard.read") == 1
        finally:
            shard.close()
            mod.clear()
    assert got["port"] == got["ref"] == "OSError"


def test_loop_block_stalls_the_inline_fast_path(tmp_path):
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    vs = VolumeServer([str(tmp_path)], m.url, port=free_port(),
                      pulse_seconds=0.3, device="cpu").start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not m.topo.all_nodes():
            time.sleep(0.05)
        r = port_httpd.http_json("GET", f"http://{m.url}/dir/assign",
                                 timeout=10.0)
        url = f"http://{r['url']}/{r['fid']}"
        st, _, _ = port_httpd.http_bytes("POST", url, b"hot" * 100,
                                         timeout=10.0)
        assert st == 201
        for _ in range(3):  # the needle cache admits it
            assert port_httpd.http_bytes("GET", url, timeout=10.0)[0] == 200
        fi.enable("loop.block", delay=0.3)
        t0 = time.monotonic()
        st, body, _ = port_httpd.http_bytes("GET", url, timeout=10.0)
        assert st == 200 and body == b"hot" * 100
        assert fi.fired("loop.block") >= 1
        assert time.monotonic() - t0 >= 0.3
    finally:
        fi.clear()
        vs.stop()
        m.stop()
