"""LeaderFollowingTransport: one leader-follow policy for every
master-ward client.

The port's copy of seaweedfs_tpu/utils/leader.py.  The shippers (traces,
events) parse the comma-separated master candidate list, POST to one and
rotate to the next on failure.  That converges eventually (any reachable
master proxies ingests to the raft leader), but after a failover every
batch would pay a follower's proxy hop until blind rotation happened to
land on the new leader.

So the transport also LEARNS: every master ingest response carries
``{"leader": "host:port"}`` and every follower redirect carries a
Location header; the transport caches that hint and sends the next
request straight to the leader.  On any failure the hint is dropped and
rotation resumes over the configured candidates, so a stale hint can
never wedge a shipper.

The contract the shippers keep: one attempt per call, exceptions
propagate (the caller counts the batch lost; shipping never
back-pressures), no internal retries.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .httpd import http_json


class LeaderFollowingTransport:
    """Candidate rotation + learned-leader short-circuit over a
    comma-separated master list (``master_url_fn`` re-reads it every
    call, so heartbeat-driven re-targeting flows through)."""

    def __init__(self, master_url_fn: Optional[Callable[[], str]] = None,
                 name: str = ""):
        self.master_url_fn = master_url_fn
        self.name = name
        self._lock = threading.Lock()
        self._i = 0  # guarded-by: _lock
        self._leader = ""  # guarded-by: _lock — learned hint
        self.sent = 0  # guarded-by: _lock
        self.failed = 0  # guarded-by: _lock
        self.leader_hits = 0  # guarded-by: _lock

    def candidates(self) -> list[str]:
        raw = self.master_url_fn() if self.master_url_fn else ""
        return [u.strip() for u in (raw or "").split(",") if u.strip()]

    @property
    def leader(self) -> str:
        with self._lock:
            return self._leader

    def target(self) -> str:
        """The address the next request goes to: the learned leader if
        we have one, else the current rotation candidate.  Raises
        ConnectionError with no candidates at all."""
        urls = self.candidates()
        with self._lock:
            if self._leader:
                return self._leader
            if not urls:
                raise ConnectionError("no master url configured")
            return urls[self._i % len(urls)]

    def learn(self, leader: str) -> None:
        """Cache a leader hint (from a response body or a redirect
        Location); unknown/empty values clear nothing."""
        leader = (leader or "").strip()
        if not leader:
            return
        with self._lock:
            self._leader = leader

    def note_failure(self) -> None:
        """One failed attempt: drop the learned hint and rotate the
        candidate cursor so the next call tries somewhere else."""
        with self._lock:
            self._leader = ""
            self._i += 1
            self.failed += 1

    def post(self, path: str, payload: dict,
             timeout: float = 5.0) -> dict:
        """POST one document to the current target; learn the leader
        from the response; on ANY failure rotate and re-raise (the
        caller's loss accounting is the retry policy)."""
        target = self.target()
        try:
            r = http_json("POST", f"http://{target}{path}", payload,
                          timeout=timeout)
        except Exception:
            self.note_failure()
            raise
        with self._lock:
            self.sent += 1
            if self._leader and target == self._leader:
                self.leader_hits += 1
        self.learn(str(r.get("leader") or "")
                   if isinstance(r, dict) else "")
        return r

    def get(self, path: str, timeout: float = 5.0) -> dict:
        """GET from the current target (wdclient lookups); same learn/
        rotate contract as post()."""
        target = self.target()
        try:
            r = http_json("GET", f"http://{target}{path}",
                          timeout=timeout)
        except Exception:
            self.note_failure()
            raise
        with self._lock:
            self.sent += 1
        self.learn(str(r.get("leader") or "")
                   if isinstance(r, dict) else "")
        return r

    def status(self) -> dict:
        with self._lock:
            return {"leader_hint": self._leader, "sent": self.sent,
                    "failed": self.failed,
                    "leader_hits": self.leader_hits}
