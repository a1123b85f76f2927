"""The port's framed-TCP plumbing (seaweedfs_tpu_torch/utils/framing.py and
the reactor's framed listener) against the reference's
(seaweedfs_tpu/utils/framing.py).

The port rule, the batch record stream and every truncation of it, and
answer frames byte for byte (tolerance 0) from each package's
``FramedServer`` on each front, clients cross-wired; then the ingress
hygiene (trace decision and deadline slot), the reactor's stop and the
client's one resend.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.utils import framing as ref
from seaweedfs_tpu_torch.observability import context as port_context
from seaweedfs_tpu_torch.observability import tracer as port_tracer
from seaweedfs_tpu_torch.utils import deadline as port_deadline
from seaweedfs_tpu_torch.utils import framing as port
from tests.conftest import free_port

MODS = {"ref": ref, "port": port}


@pytest.mark.parametrize("http_port", [1, 8080, 9333, 45535, 45536, 50000,
                                       60999, 65535])
def test_the_port_rule_is_the_references(http_port):
    assert port.tcp_port_for(http_port) == ref.tcp_port_for(http_port)
    url = f"10.0.0.7:{http_port}"
    assert port.tcp_address(url) == ref.tcp_address(url)
    assert port.TCP_PORT_OFFSET == ref.TCP_PORT_OFFSET == 20000


def _batch(seed: int, with_data: bool) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(0, 40))):
        fid = f"{int(rng.integers(1, 1000))},{int(rng.integers(1, 1 << 40)):x}"
        if i % 7 == 3:
            fid = "ü" * int(rng.integers(0, 5))  # non-ASCII, empty
        data = rng.bytes(int(rng.integers(0, 3000)))
        out.append((fid, data) if with_data else fid)
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("with_data", [False, True])
def test_batch_encoding_equals_the_references(seed, with_data):
    items = _batch(seed, with_data)
    packed = port.pack_fid_frames(items, with_data)
    assert packed == ref.pack_fid_frames(items, with_data)
    assert port.unpack_fid_frames(packed, with_data) == \
        ref.unpack_fid_frames(packed, with_data) == items


@pytest.mark.parametrize("with_data", [False, True])
def test_every_truncation_of_a_batch_raises_in_both(with_data):
    items = [("3,01637037d6", b"abc"), ("", b""), ("12,ff", b"\x00" * 9)]
    if not with_data:
        items = [f for f, _ in items]
    packed = port.pack_fid_frames(items, with_data)
    # where a record ends, the prefix is a whole batch of fewer records
    ends, i = {0}, 0
    for item in items:
        fid = item[0] if with_data else item
        i += 2 + len(fid.encode())
        if with_data:
            i += 4 + len(item[1])
        ends.add(i)
    for cut in range(len(packed)):
        if cut in ends:
            assert port.unpack_fid_frames(packed[:cut], with_data) == \
                ref.unpack_fid_frames(packed[:cut], with_data)
            continue
        for mod in (ref, port):
            with pytest.raises(ValueError, match="truncated batch frame"):
                mod.unpack_fid_frames(packed[:cut], with_data)


def _handler(op: bytes, key: str, body: bytes) -> bytes:
    if op == b"E":
        return key.encode() + b"|" + body
    if op == b"K":
        raise KeyError(f"volume {key} not found")
    if op == b"Z":
        return b""
    if op == b"L":
        return body * 3
    raise ValueError(f"unknown op {op!r}")


def _frame(op: bytes, key: str, body: bytes = b"") -> bytes:
    k = key.encode()
    return op + struct.pack(">H", len(k)) + k + \
        struct.pack(">I", len(body)) + body


FRAMES = [(b"E", "3,01ab", b"hello"), (b"K", "77", b""), (b"Z", "", b""),
          (b"Q", "x", b"body"), (b"E", "", b""),
          (b"L", "big", bytes(range(256)) * 600), (b"E", "ü", b"\x00\x01")]


def _read_answer(rfile) -> bytes:
    head = rfile.read(5)
    return head + rfile.read(struct.unpack(">I", head[1:])[0])


def _answers(addr: tuple, frames, pipelined: bool) -> list[bytes]:
    with socket.create_connection(addr, timeout=10) as s:
        rfile = s.makefile("rb")
        if pipelined:
            s.sendall(b"".join(_frame(*f) for f in frames))
            return [_read_answer(rfile) for _ in frames]
        out = []
        for f in frames:
            s.sendall(_frame(*f))
            out.append(_read_answer(rfile))
        return out


def _start(mod, front: str, monkeypatch):
    if front == "threaded":
        monkeypatch.setenv("WEED_DATAPLANE", "threaded")
    else:
        monkeypatch.delenv("WEED_DATAPLANE", raising=False)
    srv = mod.FramedServer(_handler, "127.0.0.1", free_port(),
                           name="t").start()
    monkeypatch.delenv("WEED_DATAPLANE", raising=False)
    assert srv.alive
    return srv


@pytest.mark.parametrize("front", ["reactor", "threaded"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_answer_frames_equal_the_references(front, pipelined, monkeypatch):
    got = {}
    for name, mod in MODS.items():
        srv = _start(mod, front, monkeypatch)
        try:
            got[name] = _answers(("127.0.0.1", srv.port), FRAMES, pipelined)
        finally:
            srv.stop()
    assert got["port"] == got["ref"]
    assert got["port"][1] == b"\x01" + struct.pack(">I", 31) + \
        b"KeyError: 'volume 77 not found'"
    assert got["port"][3].startswith(b"\x01") and \
        got["port"][3].endswith(b"ValueError: unknown op b'Q'")


def test_the_fronts_answer_alike(monkeypatch):
    got = {}
    for front in ("reactor", "threaded"):
        srv = _start(port, front, monkeypatch)
        try:
            got[front] = _answers(("127.0.0.1", srv.port), FRAMES * 3, True)
        finally:
            srv.stop()
    assert got["reactor"] == got["threaded"]


@pytest.mark.parametrize("client,server", [("ref", "port"), ("port", "ref")])
def test_clients_cross_wired(client, server, monkeypatch):
    srv = _start(MODS[server], "reactor", monkeypatch)
    try:
        c = MODS[client].FramedClient()
        addr = f"127.0.0.1:{srv.port}"
        for op, key, body in FRAMES:
            want = _handler if op not in (b"K", b"Q") else None
            if want is None:
                with pytest.raises(OSError) as ei:
                    c.request(addr, op, key, body)
                assert str(ei.value).startswith(("KeyError", "ValueError"))
            else:
                assert c.request(addr, op, key, body) == \
                    _handler(op, key, body)
        # the error frames left the pooled connection serving
        assert len(c._conns) == 1
    finally:
        srv.stop()


def test_a_frame_runs_with_no_deadline_and_the_slot_is_restored():
    seen = []

    def handler(op, key, body):
        seen.append(port_deadline.current())
        return b""

    outer = port_deadline.Deadline.after(30.0)
    prev = port_deadline.activate(outer)
    try:
        frame = port.serve_frame(handler, "t", b"E", "k", b"")
        assert port_deadline.current() is outer
    finally:
        port_deadline.activate(prev)
    assert seen == [None] and frame == b"\x00\x00\x00\x00\x00"


def test_a_frame_is_a_sampling_decision_of_its_own(monkeypatch):
    tracer = port_tracer.get_tracer()
    monkeypatch.setattr(tracer, "enabled", True)
    rate = port_context.sample_rate()
    tracer.clear()
    ctxs = []

    def handler(op, key, body):
        ctxs.append(port_context.current_sampled())
        return b"ok"

    try:
        port_context.set_sample_rate(0.0)
        port.serve_frame(handler, "vol", b"R", "3,01", b"")
        port_context.set_sample_rate(1.0)
        port.serve_frame(handler, "vol", b"R", "3,02", b"")
        port.serve_frame(handler, "vol", b"R", "3,03", b"")
    finally:
        port_context.set_sample_rate(rate)
    spans = [s for s in tracer.snapshot(clear=True)
             if s.name == "tcp.vol"]
    assert ctxs[0] is None and None not in ctxs[1:]
    # a fresh trace per frame, and a span only for the sampled ones
    assert ctxs[1].trace_id != ctxs[2].trace_id
    assert [s.attrs["key"] for s in spans] == ["3,02", "3,03"]
    assert port_context.current() is None


def test_the_reactor_stop_aborts_framed_connections(monkeypatch):
    srv = _start(port, "reactor", monkeypatch)
    p = srv.port
    s = socket.create_connection(("127.0.0.1", p), timeout=5)
    s.sendall(_frame(b"E", "k", b"v"))
    assert _read_answer(s.makefile("rb")) == b"\x00" + \
        struct.pack(">I", 3) + b"k|v"
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 1.5
    assert s.recv(16) == b""  # the loop closed the connection
    s.close()
    # and released the port at once
    again = port.FramedServer(_handler, "127.0.0.1", p, name="t").start()
    try:
        assert again.alive
    finally:
        again.stop()


def test_a_stale_pooled_connection_is_resent_once(monkeypatch):
    """The reactor's stop closes the pooled connection under the client;
    its next op goes out once more on a new one, to the restarted
    server."""
    srv = _start(port, "reactor", monkeypatch)
    p = srv.port
    c = port.FramedClient()
    addr = f"127.0.0.1:{p}"
    try:
        assert c.request(addr, b"E", "a", b"1") == b"a|1"
        stale = c._conns[addr]
        srv.stop()
        srv = port.FramedServer(_handler, "127.0.0.1", p, name="t").start()
        assert c.request(addr, b"E", "b", b"2") == b"b|2"
        assert c._conns[addr] is not stale
    finally:
        srv.stop()
    # a connection that was never reused is not resent
    with pytest.raises(OSError):
        port.FramedClient().request(addr, b"E", "c", b"3")


def test_a_spent_deadline_sends_nothing(monkeypatch):
    srv = _start(port, "reactor", monkeypatch)
    got = []
    try:
        with port_deadline.scope(0.0):
            with pytest.raises(port_deadline.DeadlineExceeded):
                port.FramedClient().request(f"127.0.0.1:{srv.port}",
                                            b"E", "k")
        got.append(port.FramedClient().request(f"127.0.0.1:{srv.port}",
                                               b"E", "k"))
    finally:
        srv.stop()
    assert got == [b"k|"]


def test_a_failed_bind_leaves_the_server_down_in_both():
    with socket.socket() as hold:
        hold.bind(("127.0.0.1", 0))
        hold.listen(1)
        p = hold.getsockname()[1]
        for mod in (ref, port):
            srv = mod.FramedServer(_handler, "127.0.0.1", p).start()
            assert not srv.alive
            srv.stop()


def test_many_connections_on_the_reactor(monkeypatch):
    srv = _start(port, "reactor", monkeypatch)
    errors = []

    def worker(t: int) -> None:
        c = port.FramedClient()
        try:
            for i in range(50):
                body = f"{t}-{i}".encode()
                if c.request(f"127.0.0.1:{srv.port}", b"E", "k",
                             body) != b"k|" + body:
                    errors.append((t, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        srv.stop()
    assert errors == []
