"""``python -m seaweedfs_tpu_torch volume``: the port's volume server as an
operator starts it, in a subprocess."""

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


def _start(args: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                             "volume", *args], cwd=ROOT, env=env,
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
        assert proc.stdout.read().strip() == \
            "volume server stopped, ec kernel launches 0"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    # the volume it wrote is on disk for the next start
    assert os.path.exists(tmp_path / "3.dat")


def test_volume_cli_stops_on_sigterm_taken_by_another_thread(tmp_path):
    """A process-directed SIGTERM may be handed to any thread; the server
    stops all the same.  A helper thread sends it to itself."""
    code = (
        "import signal, sys, threading, time\n"
        "from seaweedfs_tpu_torch.__main__ import main\n"
        "def hit():\n"
        "    time.sleep(3)\n"
        "    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)\n"
        "threading.Thread(target=hit, daemon=True).start()\n"
        f"sys.exit(main(['volume', '-dir', {str(tmp_path)!r}, '-port', "
        f"'{free_port()}', '-mserver', '127.0.0.1:{free_port()}', "
        "'-ec.engine', 'cpu']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == \
        "volume server stopped, ec kernel launches 0"


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
    proc = _start(["-dir", str(tmp_path), "-ec.engine", "mesh"])
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 2 and "invalid choice" in err
