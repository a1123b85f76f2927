"""``python -m seaweedfs_tpu_torch master|volume|shell``: the port's
servers and shell as an operator starts them, in subprocesses."""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import time

import pytest
import torch

from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from tests.conftest import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(args: list[str], command: str = "volume") -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                             command, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _first_line(proc: subprocess.Popen, timeout: float) -> str:
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline() if ready else ""


def test_volume_cli_serves_on_the_cpu_and_stops_on_sigterm(tmp_path):
    port = free_port()
    proc = _start(["-dir", str(tmp_path), "-port", str(port), "-mserver",
                   f"127.0.0.1:{free_port()}", "-ec.engine", "cpu"])
    try:
        line = _first_line(proc, 120)
        assert line.startswith(f"volume server listening on 127.0.0.1:{port}")
        assert "ec on cpu" in line, line
        url = f"http://127.0.0.1:{port}"
        status = http_json("GET", url + "/status")
        assert status["Volumes"] == [] and status["EcVolumes"] == []
        http_json("POST", url + "/admin/assign_volume", {"volume_id": 3})
        st, body, _ = http_bytes("PUT", url + "/3,01cafef00d", b"cli bytes")
        assert st == 201 and json.loads(body)["size"] == 9
        assert http_bytes("GET", url + "/3,01cafef00d")[:2] == \
            (200, b"cli bytes")
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert time.monotonic() - t0 < 10
        assert proc.stdout.read().strip() == (
            "volume server stopped, ec kernel launches 0, "
            "remote shard reads 0, reconstructed intervals 0")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    # the volume it wrote is on disk for the next start
    assert os.path.exists(tmp_path / "3.dat")


def test_volume_cli_stops_on_sigterm_after_leave(tmp_path):
    """/admin/leave stops the heartbeat only: the server still serves,
    its scrubber still starts, and SIGTERM still stops it with its stop
    line and exit 0."""
    port = free_port()
    proc = _start(["-dir", str(tmp_path), "-port", str(port), "-mserver",
                   f"127.0.0.1:{free_port()}", "-ec.engine", "cpu"])
    try:
        assert _first_line(proc, 120).startswith("volume server listening")
        url = f"http://127.0.0.1:{port}"
        http_json("POST", url + "/admin/assign_volume", {"volume_id": 3})
        assert http_json("POST", url + "/admin/leave", {}) == {"left": True}
        assert http_bytes("PUT", url + "/3,01cafef00d", b"after leave")[0] \
            == 201
        assert http_json("POST", url + "/ec/scrub/start",
                         {"interval_s": 60})["started"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert proc.stdout.read().strip() == (
            "volume server stopped, ec kernel launches 0, "
            "remote shard reads 0, reconstructed intervals 0")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


# a helper thread waits until the server's handlers are in and its port
# answers, then sends SIGTERM to itself: the signal lands on a thread other
# than the main one
_SIGTERM_FROM_A_THREAD = """\
import signal, socket, sys, threading, time
from seaweedfs_tpu_torch.__main__ import main
def hit(port):
    deadline = time.monotonic() + 100
    while time.monotonic() < deadline:
        if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                pass
        time.sleep(0.05)
    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)
port = {port}
threading.Thread(target=hit, args=(port,), daemon=True).start()
sys.exit(main({argv!r}))
"""


def _run_sigterm_from_a_thread(argv: list[str], port: int):
    code = _SIGTERM_FROM_A_THREAD.format(port=port, argv=argv)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)


def test_volume_cli_stops_on_sigterm_taken_by_another_thread(tmp_path):
    """A process-directed SIGTERM may be handed to any thread; the server
    stops all the same."""
    port = free_port()
    proc = _run_sigterm_from_a_thread(
        ["volume", "-dir", str(tmp_path), "-port", str(port), "-mserver",
         f"127.0.0.1:{free_port()}", "-ec.engine", "cpu"], port)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == (
        "volume server stopped, ec kernel launches 0, "
        "remote shard reads 0, reconstructed intervals 0")


def test_master_cli_stops_on_sigterm_taken_by_another_thread():
    port = free_port()
    proc = _run_sigterm_from_a_thread(["master", "-port", str(port)], port)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines() == [
        f"master listening on 127.0.0.1:{port}", "master stopped"]


def test_a_signal_during_start_up_stops_the_server_once_up(tmp_path):
    """SIGTERM before the server listens: it comes up, stops and exits 0,
    and the caller's own handlers are back afterwards."""
    code = ("import os, signal, sys\n"
            "from seaweedfs_tpu_torch import __main__ as cli\n"
            "from seaweedfs_tpu_torch.master.server import MasterServer\n"
            "start = MasterServer.start\n"
            "def early(self):\n"
            "    os.kill(os.getpid(), signal.SIGTERM)\n"
            "    return start(self)\n"
            "MasterServer.start = early\n"
            f"rc = cli.main(['master', '-port', '{free_port()}'])\n"
            "assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == "master stopped"


def test_master_and_shell_cli(tmp_path):
    """A master and a CPU volume server through the CLI; ``shell -c``
    grows a volume, lists it and releases the lock it took."""
    mport, vport = free_port(), free_port()
    master = _start(["-port", str(mport), "-pulseSeconds", "0.3"], "master")
    volume = None
    try:
        assert _first_line(master, 60).strip() == \
            f"master listening on 127.0.0.1:{mport}"
        volume = _start(["-dir", str(tmp_path), "-port", str(vport),
                         "-mserver", f"127.0.0.1:{mport}", "-pulseSeconds",
                         "0.3", "-ec.engine", "cpu"])
        assert "ec on cpu" in _first_line(volume, 120)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not http_json(
                "GET", f"http://127.0.0.1:{mport}/dir/status")[
                "Topology"]["DataCenters"]:
            time.sleep(0.1)
        shell = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master",
             f"127.0.0.1:{mport}", "-c",
             "volume.grow -collection c; volume.list; collection.list"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=120)
        assert shell.returncode == 0, shell.stderr[-2000:]
        assert shell.stdout.splitlines()[0] == "grew volumes: [1]"
        assert f"DataNode 127.0.0.1:{vport} volumes=[1]" in shell.stdout
        assert shell.stdout.splitlines()[-1] == "c"
        assert os.path.exists(tmp_path / "c_1.dat")
        # the lock was released: a second shell takes it at once
        http_json("POST", f"http://127.0.0.1:{mport}/admin/lease",
                  {"client_name": "test"})
        for proc in (volume, master):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0
        assert master.stdout.read().strip() == "master stopped"
    finally:
        for proc in (volume, master):
            if proc is None:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            proc.stderr.close()


def test_volume_cli_without_an_engine_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default engine is usable")
    port = free_port()
    proc = _start(["-dir", str(tmp_path), "-port", str(port), "-mserver",
                   f"127.0.0.1:{free_port()}"])
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert "no CUDA device" in err
    assert "listening" not in out
    assert http_bytes("GET", f"http://127.0.0.1:{port}/status")[0] == 0


def test_volume_cli_refuses_an_unknown_engine(tmp_path):
    proc = _start(["-dir", str(tmp_path), "-ec.engine", "gpu"])
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 2 and "invalid choice" in err
