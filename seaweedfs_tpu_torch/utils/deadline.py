"""Cluster-wide request deadlines: the ``X-Weed-Deadline`` header.

The port's copy of seaweedfs_tpu/utils/deadline.py.  A deadline travels
with the request as the REMAINING budget in seconds:

    X-Weed-Deadline: <remaining seconds, decimal>

a duration, never a wall time, since hosts do not share a clock; the
receiver re-anchors it to its own monotonic clock and loses only the wire
time.

  - Ingress (``utils/httpd.py`` ``Router.dispatch``): a valid header
    installs a thread-local deadline for the request; a budget already
    spent is answered 504 before the handler runs.  Malformed headers are
    ignored.  The thread-local is restored afterwards, since a handler
    thread serves every request of its keep-alive connection.
  - Egress (``http_json``, ``http_bytes``, ``http_download``): the
    per-call timeout is clamped to the remaining budget and the header
    re-sent with what is left.  A spent budget raises ``DeadlineExceeded``
    without sending anything.

The coordinator runs each repair under one ``scope``, so a wedged peer
fails the repair at its budget instead of pinning it for the sum of every
leg's timeout.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

DEADLINE_HEADER = "X-Weed-Deadline"

# budgets below this are treated as already expired: a sub-millisecond
# remainder cannot survive even a loopback round trip
MIN_BUDGET_S = 0.001

_tls = threading.local()


class DeadlineExceeded(Exception):
    """The request's deadline budget is spent.  Not an OSError: the HTTP
    helpers' transport-error handling must not swallow it (a spent budget
    is the caller's signal, not a peer failure), and ``Router.dispatch``
    answers it with 504."""


class Deadline:
    """An absolute point on THIS process's monotonic clock by which the
    request must be answered."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() < MIN_BUDGET_S

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


def parse_deadline(value) -> Optional[Deadline]:
    """Header value -> Deadline re-anchored to the local monotonic clock,
    or None for absent or malformed input (a bad client must not 500 a
    server).  A non-positive budget parses to an already expired
    deadline: the caller decided, and the ingress answers 504."""
    if not value:
        return None
    try:
        budget = float(str(value).strip())
    except (TypeError, ValueError):
        return None
    if budget != budget or budget in (float("inf"), float("-inf")):
        return None
    return Deadline.after(budget)


def current() -> Optional[Deadline]:
    """The thread's active deadline, or None."""
    return getattr(_tls, "deadline", None)


def activate(deadline: Optional[Deadline]):
    """Install ``deadline`` on this thread; returns the previous value for
    a symmetric restore."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = deadline
    return prev


def begin_request(headers):
    """Ingress: parse and activate in one step.  ``headers`` is anything
    with ``.get()``, or None, which clears the slot.  Returns
    (deadline or None, previous); pass ``previous`` to ``end_request``
    in a finally block."""
    prev = getattr(_tls, "deadline", None)
    ddl = parse_deadline(headers.get(DEADLINE_HEADER)) \
        if headers is not None else None
    _tls.deadline = ddl
    return ddl, prev


def end_request(prev) -> None:
    _tls.deadline = prev


class scope:
    """``with scope(seconds_or_deadline):`` runs a block under a deadline.
    Takes seconds, an existing Deadline (a caller's budget carried onto
    another thread) or None (explicitly no deadline)."""

    __slots__ = ("deadline", "prev")

    def __init__(self, seconds_or_deadline):
        if seconds_or_deadline is None or \
                isinstance(seconds_or_deadline, Deadline):
            self.deadline = seconds_or_deadline
        else:
            self.deadline = Deadline.after(float(seconds_or_deadline))

    def __enter__(self) -> Optional[Deadline]:
        self.prev = activate(self.deadline)
        return self.deadline

    def __exit__(self, *exc) -> bool:
        _tls.deadline = self.prev
        return False


def clamp(timeout: Optional[float]) -> Optional[float]:
    """The timeout for one outbound call: min(timeout, remaining budget),
    where a ``timeout`` of None waits without end.  Raises
    DeadlineExceeded when the budget is already spent; with no active
    deadline ``timeout`` passes through untouched."""
    ddl = getattr(_tls, "deadline", None)
    if ddl is None:
        return timeout
    rem = ddl.remaining()
    if rem < MIN_BUDGET_S:
        raise DeadlineExceeded(
            f"deadline exceeded before send ({rem:.3f}s remaining)")
    return rem if timeout is None else min(float(timeout), rem)


def inject_deadline_headers(headers: dict) -> dict:
    """Stamp the remaining budget onto an outbound request's headers; with
    no active deadline they are left untouched."""
    ddl = getattr(_tls, "deadline", None)
    if ddl is not None:
        headers.setdefault(DEADLINE_HEADER,
                           f"{max(ddl.remaining(), 0.0):.3f}")
    return headers


def sleep_within(seconds: float) -> None:
    """Sleep up to ``seconds``, clipped by the active deadline; raises
    DeadlineExceeded when the budget runs out first."""
    ddl = getattr(_tls, "deadline", None)
    if ddl is None:
        time.sleep(seconds)
        return
    rem = ddl.remaining()
    if rem < MIN_BUDGET_S:
        raise DeadlineExceeded("deadline exceeded before network delay")
    if seconds >= rem:
        time.sleep(max(rem, 0.0))
        raise DeadlineExceeded(
            f"deadline expired during {seconds:.3f}s network delay")
    time.sleep(seconds)
