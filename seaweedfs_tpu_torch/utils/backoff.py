"""Jittered exponential backoff and per-destination retry budgets.

The port's copy of seaweedfs_tpu/utils/backoff.py.  ``jittered_backoff``
is the retry-delay policy; ``RetryBudget`` bounds how many RETRIES (never
first attempts) a process sends at one destination: a token bucket per
destination, so a healthy peer absorbs occasional retries while a down
peer drains its bucket once and every further retry is denied.  The
coordinator draws from it before re-attempting a failed repair
(``retry_allowed(f"repair:{vid}", "coordinator")``).

Every denial is counted on ``SeaweedFS_retry_budget_exhausted_total{kind}``
and journaled as a ``retry_budget_exhausted`` event, the event at most
once per destination per ``_EVENT_MIN_INTERVAL_S``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from ..observability import events as _events


def jittered_backoff(base: float, cap: float, attempt: int) -> float:
    """Delay for the attempt-th retry (attempt counts from 0): base*2^attempt
    bounded by cap, with 50-100% jitter applied inside the cap, so the
    delay never exceeds cap and a fleet never retries in lockstep."""
    return random.uniform(0.5, 1.0) * min(cap, base * (2 ** attempt))


class RetryBudget:
    """Per-destination token bucket over RETRIES: ``burst`` tokens refilled
    at ``rate`` tokens/second; ``allow(dest)`` takes one token and an empty
    bucket denies."""

    def __init__(self, rate: float = 0.5, burst: float = 10.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self._lock = threading.Lock()
        # dest -> [tokens, monotonic of the last refill]
        self._buckets: dict[str, list] = {}  # guarded-by: _lock

    def allow(self, dest: str) -> bool:
        """Take one retry token for ``dest``; False = budget exhausted
        (degrade to a single attempt, do not retry)."""
        now = time.monotonic()
        with self._lock:
            b = self._buckets.get(dest)
            if b is None:
                b = self._buckets[dest] = [self.burst, now]
            b[0] = min(self.burst, b[0] + (now - b[1]) * self.rate)
            b[1] = now
            if b[0] >= 1.0:
                b[0] -= 1.0
                return True
            return False

    def remaining(self, dest: str) -> float:
        """Current token count, refilled to now."""
        now = time.monotonic()
        with self._lock:
            b = self._buckets.get(dest)
            if b is None:
                return self.burst
            return min(self.burst, b[0] + (now - b[1]) * self.rate)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            dests = list(self._buckets)
        return {d: round(self.remaining(d), 2) for d in dests}

    def prune(self, max_destinations: int = 1024) -> None:
        """Drop the oldest buckets beyond the cap."""
        with self._lock:
            while len(self._buckets) > max_destinations:
                self._buckets.pop(next(iter(self._buckets)))

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()


# one budget per process: every retry site draws from the same buckets, so
# a peer hammered by one subsystem denies retries to all of them
_GLOBAL: Optional[RetryBudget] = None
_global_lock = threading.Lock()
# at most one journal event per destination per window
_EVENT_MIN_INTERVAL_S = 5.0
_last_event: dict[str, float] = {}  # guarded-by: _global_lock


def get_retry_budget() -> RetryBudget:
    global _GLOBAL
    with _global_lock:
        if _GLOBAL is None:
            _GLOBAL = RetryBudget()
        return _GLOBAL


def retry_allowed(dest: str, kind: str = "http") -> bool:
    """The call every retry site makes before re-attempting: draw from the
    process-wide budget; on denial count it (by subsystem ``kind``),
    journal the destination (rate-limited) and return False, and the
    caller keeps what it already did."""
    if get_retry_budget().allow(dest):
        return True
    from ..stats import request_plane_metrics

    request_plane_metrics().retry_budget_exhausted.inc(kind)
    now = time.monotonic()
    with _global_lock:
        emit = now - _last_event.get(dest, 0.0) >= _EVENT_MIN_INTERVAL_S
        if emit:
            _last_event[dest] = now
    if emit:
        _events.emit("retry_budget_exhausted", dest=dest, kind=kind)
    return False
