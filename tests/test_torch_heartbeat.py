"""A volume server whose first master is silent, against the reference.

A "master" that accepts connections and never answers is first in
``-mserver``, a live master second, and the journal takes an event every
few milliseconds, so the server's event shipper always has a batch for
the silent master.  The reference's heartbeat loop waits one heartbeat
timeout (``max(3, 2 * pulse)``) for the silent master, rotates, and
registers with the live one a pulse later.  The port's loop first ships
its pending events; that flush and the heartbeat share one deadline, and
a batch still on its way to the silent master is not waited for, so the
port registers no later than the reference does.
"""

from __future__ import annotations

import socket
import threading
import time

from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu.observability import events as ref_events
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.observability import events as port_events
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

PULSE = 0.5
TIMEOUT = max(3.0, 2 * PULSE)  # both loops' heartbeat timeout
SLACK = 1.0


class SilentMaster:
    """Accepts every connection, reads nothing, answers nothing."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(64)
        self.url = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.conns: list[socket.socket] = []
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.conns.append(conn)

    def close(self) -> None:
        self._stop.set()
        self.sock.close()
        for c in self.conns:
            c.close()


def seconds_to_register(tmp_path, master_cls, vs_cls, emit, kw) -> float:
    silent = SilentMaster()
    master = master_cls(port=free_port(), pulse_seconds=PULSE).start()
    stop = threading.Event()

    def emitter() -> None:
        while not stop.is_set():
            emit("load_shed", role="volume")
            time.sleep(0.005)

    threading.Thread(target=emitter, daemon=True).start()
    vs = None
    try:
        time.sleep(0.2)
        t0 = time.monotonic()
        vs = vs_cls([str(tmp_path)], f"{silent.url},{master.url}",
                    port=free_port(), pulse_seconds=PULSE, **kw).start()
        while not master.topo.all_nodes():
            assert time.monotonic() - t0 < 30, "never registered"
            time.sleep(0.02)
        return time.monotonic() - t0
    finally:
        stop.set()
        if vs is not None:
            vs.stop()
        master.stop()
        silent.close()


def test_a_silent_first_master_costs_one_timeout(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = seconds_to_register(tmp_path / "ref", RefMasterServer,
                              RefVolumeServer, ref_events.emit,
                              {"needle_cache_mb": 0})
    port = seconds_to_register(tmp_path / "port", MasterServer,
                               VolumeServer, port_events.emit,
                               {"device": "cpu"})
    assert ref < TIMEOUT + PULSE + SLACK, ref
    assert port < TIMEOUT + PULSE + SLACK, (port, ref)
    assert port <= ref + SLACK, (port, ref)
