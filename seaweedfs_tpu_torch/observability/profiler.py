"""A wall-clock sampling profiler over every thread (collapsed stacks).

The port's copy of ``SamplingProfiler`` and ``profile_collapsed`` from
seaweedfs_tpu/observability/profiler.py.  The span tracer names the stage
a run is bound by; it cannot see the time between spans: the interpreter's
own overhead, the GIL handed between threads, a slow encoder on a status
route.  This sampler shows it with nothing installed globally: a daemon
thread reads ``sys._current_frames()`` every ``1/hz`` seconds and counts
whole stacks.  The card never appears on a Python stack: the time a
kernel holds shows as the host thread waiting in the wrapper's
synchronising call (``ops/gf_matmul.py``).

  - No cost unless running: no settrace or setprofile (they bias what
    they measure); ``start()`` and ``stop()`` own the only thread.
  - Bounded memory: at most ``max_stacks`` distinct stacks (the rest fold
    into one overflow bucket), each cut to ``max_depth`` frames.
  - ``collapsed()`` may run while sampling goes on.

``collapsed()`` is the format flamegraph.pl, speedscope and other
flamegraph viewers read: one line per distinct stack,
``thread;root_frame;...;leaf_frame <count>``, heaviest first;
``report_text()`` is the self and cumulative hit tables that
``/debug/pprof/profile`` serves.

``WindowedProfiler`` keeps the sampler on at a low rate (7 Hz) and
rotates its counts into bounded windows: ``top()`` is the last window's
heaviest stacks, ``diff()`` the stacks rising between the last two.  Its
one user is the resource ledger (ledger.py), whose snapshots carry
``summary()`` to the master.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Optional

_MAX_SECONDS = 3600.0


class SamplingProfiler:
    """Wall-clock sampler over every thread but its own."""

    def __init__(self, hz: float = 100.0, max_stacks: int = 10000,
                 max_depth: int = 96):
        self.interval = 1.0 / max(min(hz, 1000.0), 0.1)
        self.max_stacks = max_stacks
        self.max_depth = max_depth
        self.samples = 0
        self.dropped = 0  # samples folded into the overflow bucket
        self._counts: dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self.elapsed = 0.0
        # threads the capture must not observe (the HTTP handler thread
        # that sleeps out a run_for window)
        self._exclude: set[int] = set()

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            raise RuntimeError("profiler already running")
        self._stop.clear()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sampling-profiler")
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        if self._thread is None:
            return self
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self.elapsed = time.perf_counter() - self._t0
        return self

    def run_for(self, seconds: float) -> "SamplingProfiler":
        """Blocking capture: sample for ``seconds``, then stop."""
        seconds = max(0.0, min(seconds, _MAX_SECONDS))
        self._exclude.add(threading.get_ident())
        self.start()
        try:
            time.sleep(seconds)
        finally:
            self.stop()
        return self

    # --- sampling ---------------------------------------------------------
    def _loop(self) -> None:
        skip = {threading.get_ident()} | self._exclude
        while not self._stop.wait(self.interval):
            self._sample_once(skip)

    def _sample_once(self, skip: set) -> None:
        # names are read at each sample: threads come and go
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        stacks: list[tuple] = []
        for ident, frame in frames.items():
            if ident in skip:
                continue
            stack: list[tuple] = []
            while frame is not None and len(stack) < self.max_depth:
                code = frame.f_code
                stack.append((code.co_filename, frame.f_lineno,
                              code.co_name))
                frame = frame.f_back
            stack.reverse()  # root first, the collapsed order
            stacks.append((names.get(ident, f"thread-{ident}"),
                           tuple(stack)))
        with self._lock:
            self.samples += 1
            for key in stacks:
                if key not in self._counts and \
                        len(self._counts) >= self.max_stacks:
                    key = ("(overflow)", ())
                    self.dropped += 1
                self._counts[key] = self._counts.get(key, 0) + 1

    def drain_counts(self) -> tuple[dict[tuple, int], int]:
        """-> (counts, samples) since the last drain, and reset both: the
        windowed profiler's rotation.  Sampling goes on across it."""
        with self._lock:
            counts, self._counts = self._counts, {}
            samples, self.samples = self.samples, 0
            return counts, samples

    # --- reports ----------------------------------------------------------
    def _snapshot(self) -> dict[tuple, int]:
        with self._lock:
            return dict(self._counts)

    @staticmethod
    def _frame_label(fr: tuple) -> str:
        fname, lineno, func = fr
        return f"{func} ({os.path.basename(fname)}:{lineno})"

    def collapsed(self) -> str:
        """flamegraph.pl input: ``thread;frame;...;frame count`` lines,
        heaviest stacks first."""
        lines = []
        for (thread, stack), n in sorted(self._snapshot().items(),
                                         key=lambda kv: -kv[1]):
            # ';' separates frames in the format: none inside a label
            parts = [thread.replace(";", ":")]
            parts.extend(self._frame_label(fr).replace(";", ":")
                         for fr in stack)
            lines.append(";".join(parts) + f" {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def hotspots(self, limit: int = 40) -> tuple[list, list]:
        """(self hits, cumulative hits) for the text report: self keyed
        (file, line, function) on leaf frames, cumulative keyed (file,
        function) once per stack, so recursion counts once."""
        self_hits: dict[tuple, int] = {}
        cum_hits: dict[tuple, int] = {}
        for (_thread, stack), n in self._snapshot().items():
            if not stack:
                continue
            leaf = stack[-1]
            self_hits[leaf] = self_hits.get(leaf, 0) + n
            seen = set()
            for fname, _lineno, func in stack:
                ckey = (fname, func)
                if ckey not in seen:
                    cum_hits[ckey] = cum_hits.get(ckey, 0) + n
                    seen.add(ckey)
        top_self = sorted(self_hits.items(), key=lambda kv: -kv[1])[:limit]
        top_cum = sorted(cum_hits.items(), key=lambda kv: -kv[1])[:limit]
        return top_self, top_cum

    def report_text(self) -> str:
        """The /debug/pprof/profile view: self and cumulative hit tables."""
        samples = max(self.samples, 1)
        lines = [f"sampling profile: {self.samples} samples over "
                 f"{self.elapsed:.1f}s "
                 f"({self.interval * 1e3:.0f}ms interval), all threads",
                 "", "-- self time (leaf frames) --"]
        top_self, top_cum = self.hotspots()
        for (fname, lineno, func), n in top_self:
            lines.append(f"{n:>6} {100 * n / samples:5.1f}% "
                         f"{func} ({fname}:{lineno})")
        lines += ["", "-- cumulative (anywhere on stack) --"]
        for (fname, func), n in top_cum:
            lines.append(f"{n:>6} {100 * n / samples:5.1f}% "
                         f"{func} ({fname})")
        if self.dropped:
            lines += ["", f"(overflow: {self.dropped} samples past the "
                          f"{self.max_stacks}-stack bound)"]
        return "\n".join(lines) + "\n"


def profile_collapsed(seconds: float, hz: float = 100.0) -> str:
    """One capture of ``seconds`` at ``hz`` -> collapsed-stack text (what
    ``GET /debug/profile`` answers)."""
    prof = SamplingProfiler(hz=hz)
    prof.run_for(seconds)
    return prof.collapsed()


class WindowedProfiler:
    """Continuous profiling: the sampling profiler always on at a low
    rate, rotated into bounded windows of collapsed-stack counts
    (``window_s`` each, ``max_windows`` kept).  The one-shot profiler
    answers where time goes now; ``diff()`` answers what changed: the
    stacks whose share rose between the last two windows."""

    def __init__(self, hz: float = 7.0, window_s: float = 10.0,
                 max_windows: int = 12, top_k: int = 10):
        self.hz = hz
        self.window_s = max(window_s, 1.0)
        self.top_k = top_k
        self._prof = SamplingProfiler(hz=hz)
        self._windows: deque = deque(maxlen=max_windows)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rotations = 0  # guarded-by: _lock

    def start(self) -> "WindowedProfiler":
        if self._thread is not None:
            return self
        self._prof.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="windowed-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            self._prof.stop()
        except Exception:  # noqa: BLE001 - a sampler never started
            pass
        self._rotate()  # the partial last window

    def _loop(self) -> None:
        while not self._stop.wait(self.window_s):
            self._rotate()

    def _rotate(self) -> None:
        counts, samples = self._prof.drain_counts()
        if not samples:
            return
        with self._lock:
            self._windows.append({"ts": time.time(),
                                  "samples": samples,
                                  "counts": counts})
            self.rotations += 1

    @staticmethod
    def _label(key: tuple) -> str:
        thread, stack = key
        parts = [thread.replace(";", ":")]
        parts.extend(
            SamplingProfiler._frame_label(fr).replace(";", ":")
            for fr in stack)
        return ";".join(parts)

    def top(self, k: Optional[int] = None) -> list[dict]:
        """The last window's heaviest stacks, as shares of its samples:
        [{stack, hits, share}]."""
        with self._lock:
            win = self._windows[-1] if self._windows else None
        if win is None:
            return []
        total = max(win["samples"], 1)
        rows = sorted(win["counts"].items(), key=lambda kv: -kv[1])
        return [{"stack": self._label(key), "hits": n,
                 "share": round(n / total, 4)}
                for key, n in rows[:k or self.top_k]]

    def diff(self, k: Optional[int] = None) -> list[dict]:
        """Stacks whose share rose between the last two windows, the
        largest rise first (shares, so a rate hiccup is no regression):
        [{stack, delta, share, prev_share}]."""
        with self._lock:
            if len(self._windows) < 2:
                return []
            prev, cur = self._windows[-2], self._windows[-1]
        pt, ct = max(prev["samples"], 1), max(cur["samples"], 1)
        deltas: list[tuple] = []
        for key, n in cur["counts"].items():
            share = n / ct
            prev_share = prev["counts"].get(key, 0) / pt
            if share > prev_share:
                deltas.append((share - prev_share, share, prev_share,
                               key))
        deltas.sort(key=lambda row: -row[0])
        return [{"stack": self._label(key),
                 "delta": round(d, 4), "share": round(s, 4),
                 "prev_share": round(ps, 4)}
                for d, s, ps, key in deltas[:k or self.top_k]]

    def summary(self) -> dict:
        """A ledger snapshot's ``profile`` block."""
        with self._lock:
            windows = len(self._windows)
        return {"hz": self.hz, "window_s": self.window_s,
                "windows": windows, "top": self.top(),
                "rising": self.diff()}
