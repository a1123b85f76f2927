"""Admission control: shed excess load early instead of timing out late.

The port's copy of seaweedfs_tpu/utils/admission.py.  A thread-per-
connection server that accepts everything queues every request behind
every other, and under more load than it can serve every caller times out
late.  ``AdmissionController`` bounds the requests in flight on one
server: a request over the bound is answered 503 with ``Retry-After`` at
once, without running its handler, the shed is counted
(``SeaweedFS_requests_shed_total{role}``) and journaled (``load_shed``, at
most one event a second per server), and the admitted requests keep their
latency.

Operator and control-plane routes are exempt by prefix
(``DEFAULT_EXEMPT_PREFIXES``): an operator must be able to look at an
overloaded server, and shedding heartbeats would make a busy volume server
look dead to the master.  On a volume server that leaves the object
routes ``/<vid>,<fid>``: a degraded GET's fetches from remote holders
(``/admin/ec/shard_read``) are never shed.

The gate sits at ``Router.dispatch`` (utils/httpd.py), before the
handler: a shed request does no work, on the card neither.  Servers turn
it on with ``max_inflight > 0`` (``-maxInflight N``); off, it costs one
attribute check per request.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# never shed: operator visibility and control-plane liveness
DEFAULT_EXEMPT_PREFIXES = (
    "/metrics", "/debug", "/cluster", "/ec/scrub", "/admin",
    "/heartbeat", "/dir/status", "/status", "/stats",
)

# at most one load_shed event per server per window; the counter counts
# every shed (the journal is a bounded ring a shed storm must not flush)
_EVENT_MIN_INTERVAL_S = 1.0


class AdmissionController:
    """Bounded-inflight gate for one server's router."""

    def __init__(self, max_inflight: int, role: str):
        self.max_inflight = max(1, int(max_inflight))
        self.role = role
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock
        self.shed_total = 0  # guarded-by: _lock
        self._last_event = 0.0  # guarded-by: _lock

    def exempt(self, path: str) -> bool:
        return path.startswith(DEFAULT_EXEMPT_PREFIXES)

    def try_acquire(self) -> bool:
        """Admit (True) or shed (False) one request.  A shed is counted
        and journaled (rate-limited) here; the caller answers 503 without
        running the handler."""
        with self._lock:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                return True
            self.shed_total += 1
            inflight = self._inflight
            now = time.monotonic()
            emit = now - self._last_event >= _EVENT_MIN_INTERVAL_S
            if emit:
                self._last_event = now
        from ..stats import request_plane_metrics

        request_plane_metrics().shed.inc(self.role)
        if emit:
            from ..observability import events as _events

            _events.emit("load_shed", role=self.role, inflight=inflight,
                         max_inflight=self.max_inflight)
        return False

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)


def maybe_controller(max_inflight: int,
                     role: str) -> Optional[AdmissionController]:
    """What servers call: 0 or negative turns admission off (None), the
    ``-maxInflight`` default."""
    if max_inflight and int(max_inflight) > 0:
        return AdmissionController(int(max_inflight), role=role)
    return None
