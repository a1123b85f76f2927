"""The port's sampling profiler (observability/profiler.py) and its routes
(utils/debug.py) against the reference's.

Both packages' ``SamplingProfiler`` sample the same parked threads, so
their stacks are the same: ``collapsed()``, ``hotspots()`` and
``report_text()`` must be equal, the ``max_stacks`` and ``max_depth`` caps
and the naming of a thread ``threading`` does not know included.  Live, a
port volume server's ``/debug/profile``, ``/debug/pprof/profile``,
``/goroutine`` and ``/heap`` answer what a reference router's do, up to
sample counts, thread sets and allocation sizes.
"""

from __future__ import annotations

import _thread
import re
import sys
import threading
import time
import tracemalloc

import pytest

import seaweedfs_tpu.observability.profiler as ref_profiler
import seaweedfs_tpu.utils.debug as ref_debug
import seaweedfs_tpu.utils.httpd as ref_httpd
import seaweedfs_tpu_torch.observability.profiler as port_profiler
from seaweedfs_tpu_torch.observability import (SamplingProfiler,
                                               profile_collapsed)
from tests.conftest import free_port

PROFILERS = {"port": port_profiler, "reference": ref_profiler}


class _Parked:
    """Threads parked on one Event at known depths (one started by
    ``_thread``, which ``threading`` does not name), until released."""

    def __init__(self, depths: list[int], raw_thread: bool = False):
        self.release = threading.Event()
        self.idents: set[int] = set()
        self._ready = threading.Semaphore(0)
        self._threads = []
        for i, d in enumerate(depths):
            t = threading.Thread(target=self._park, args=(d,),
                                 name=f"parked;{i}")
            t.start()
            self._threads.append(t)
        self._raw_done = threading.Event()
        self._raw_thread = raw_thread
        if raw_thread:
            _thread.start_new_thread(self._raw, ())
        for _ in range(len(depths) + raw_thread):
            self._ready.acquire()

    def _park(self, depth: int) -> None:
        if depth > 0:
            return self._park(depth - 1)
        self.idents.add(threading.get_ident())
        self._ready.release()
        self.release.wait(30)

    def _raw(self) -> None:
        try:
            self._park(3)
        finally:
            self._raw_done.set()

    def skip(self) -> set[int]:
        """Every other thread of the process."""
        return set(sys._current_frames()) - self.idents

    def close(self) -> None:
        self.release.set()
        for t in self._threads:
            t.join(10)
        if self._raw_thread:
            self._raw_done.wait(10)


def _sampled(depths, raw_thread=False, samples=3, **kw) -> dict:
    """The same parked threads sampled by each package's profiler."""
    parked = _Parked(depths, raw_thread)
    try:
        out = {}
        for name, mod in PROFILERS.items():
            prof = mod.SamplingProfiler(hz=50, **kw)
            for _ in range(samples):
                prof._sample_once(parked.skip())
            prof.elapsed = 1.25
            out[name] = prof
        return out
    finally:
        parked.close()


def _reports(prof) -> tuple:
    return (prof.samples, prof.dropped, prof.collapsed(), prof.hotspots(),
            prof.report_text())


def test_collapsed_and_reports_equal_the_reference():
    profs = _sampled([0, 2, 5], raw_thread=True)
    assert _reports(profs["port"]) == _reports(profs["reference"])
    col = profs["port"].collapsed()
    lines = col.splitlines()
    assert len(lines) == 4 and all(ln.endswith(" 3") for ln in lines)
    # ';' separates frames: a thread name's own ';' is replaced
    assert sum(ln.startswith("parked:") for ln in lines) == 3
    # the thread threading never named
    assert sum(ln.startswith("thread-") for ln in lines) == 1
    rep = profs["port"].report_text()
    assert rep.startswith("sampling profile: 3 samples over 1.2s (20ms "
                          "interval), all threads")
    assert "-- self time (leaf frames) --" in rep and \
        "-- cumulative (anywhere on stack) --" in rep


@pytest.mark.parametrize("max_stacks,max_depth", [(1, 96), (2, 96),
                                                  (10, 4), (2, 1)])
def test_caps_equal_the_reference(max_stacks, max_depth):
    profs = _sampled([0, 7, 30, 60], samples=2, max_stacks=max_stacks,
                     max_depth=max_depth)
    assert _reports(profs["port"]) == _reports(profs["reference"])
    prof = profs["port"]
    # bounded: the cap plus one overflow bucket, each stack cut
    assert len(prof._counts) <= max_stacks + 1
    assert all(len(stack) <= max_depth for (_t, stack) in prof._counts)
    if max_stacks < 4:
        assert prof.dropped > 0 and "(overflow)" in prof.collapsed()


def test_a_busy_thread_shows_and_the_caller_does_not():
    stop = threading.Event()

    def busy_loop_marker():
        while not stop.is_set():
            sum(i * i for i in range(500))

    th = threading.Thread(target=busy_loop_marker, name="busy-marker")
    th.start()
    prof = SamplingProfiler(hz=250)
    try:
        for _ in range(4):  # a loaded box stretches each sample
            prof.run_for(0.4)
            if prof.samples > 10:
                break
    finally:
        stop.set()
        th.join()
    assert prof.samples > 10 and prof.elapsed >= 0.4
    col = prof.collapsed()
    assert "busy-marker" in col and "busy_loop_marker" in col
    me = threading.current_thread().name
    for line in col.splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack and count.isdigit()
        assert not line.startswith(me + ";") and "run_for" not in line
    with pytest.raises(RuntimeError):
        prof.start().start()
    prof.stop()
    text = profile_collapsed(0.05, hz=100)
    assert text == "" or text.endswith("\n")


# --- the routes ---------------------------------------------------------

def _get(port_no: int, path: str) -> tuple[int, str, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def _skeleton(path: str, body: str) -> list:
    """What a route's answer must share with the reference's: its line
    grammar, counts, names and sizes masked."""
    if path.startswith("/debug/profile"):
        assert all(re.fullmatch(r"[^;]+(;[^;]+)* \d+", ln)
                   for ln in body.splitlines()), body[:300]
        # the capture's own request thread sleeps out the window unseen
        return ["run_for" in body, body.endswith("\n") or body == ""]
    if path.startswith("/debug/pprof/profile"):
        head, *rest = body.splitlines()
        return [re.sub(r"\d+(\.\d+)?", "N", head),
                [ln for ln in rest if ln.startswith("--")]]
    if path.startswith("/debug/pprof/goroutine"):
        heads = [ln for ln in body.splitlines() if ln.startswith("--- ")]
        # a thread threading does not know has no name and no flag
        assert heads and all(re.fullmatch(
            r"--- (.+ daemon=(True|False)|thread-\d+) ---", h) for h in heads)
        # the request's own thread dumps itself
        return ["_thread_dump" in body]
    first, *_ = body.splitlines()
    return [re.sub(r"\d+", "N", first)]


def test_routes_answer_what_the_reference_answers(tmp_path):
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    vs = VolumeServer([str(tmp_path)], "127.0.0.1:1", port=free_port(),
                      pulse_seconds=60, device="cpu").start()
    router = ref_httpd.Router("volume")
    ref_debug.register_debug_routes(router)
    ref_port = free_port()
    ref_server = ref_httpd.serve(router, "127.0.0.1", ref_port)
    ports = {"port": vs.store.port, "reference": ref_port}
    was_tracing = tracemalloc.is_tracing()
    try:
        for path in ("/debug/profile?seconds=0.3&hz=200",
                     "/debug/pprof/profile?seconds=0.2",
                     "/debug/pprof/goroutine"):
            got = {}
            for name, p in ports.items():
                status, ctype, body = _get(p, path)
                got[name] = (status, ctype, _skeleton(path, body))
            assert got["port"] == got["reference"], path
            assert got["port"][0] == 200
        # the heap: the first call turns tracemalloc on, the next reads it
        if was_tracing:
            tracemalloc.stop()
        for name, p in ports.items():
            first = _get(p, "/debug/pprof/heap")
            assert tracemalloc.is_tracing()
            time.sleep(0.01)
            second = _get(p, "/debug/pprof/heap")
            tracemalloc.stop()
            got[name] = (first, second[:2],
                         _skeleton("/debug/pprof/heap", second[2]))
        assert got["port"] == got["reference"]
        assert got["port"][0][2].startswith("tracemalloc just enabled")
        assert got["port"][2] == ["heap: N traced blocks"]
    finally:
        if was_tracing and not tracemalloc.is_tracing():
            tracemalloc.start()
        elif not was_tracing and tracemalloc.is_tracing():
            tracemalloc.stop()
        ref_httpd.stop_server(ref_server)
        vs.stop()
