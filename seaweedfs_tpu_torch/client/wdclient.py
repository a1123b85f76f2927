"""wdclient: a push-updated vid -> locations map, same data center first.

The port's copy of seaweedfs_tpu/client/wdclient.py (weed/wdclient/
masterclient.go:29-200 KeepConnected, vid_map.go:44-160).  A thread
long-polls the master's ``/cluster/watch`` and applies its snapshot and
events to a VidMap, so a lookup costs no request; a vid the map lacks is
asked of ``/dir/lookup``.  When the master is lost the thread backs off
(jittered, under the retry budget) and resyncs from a fresh snapshot.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from ..utils.backoff import jittered_backoff, retry_allowed
from ..utils.httpd import http_json, http_json_retry
from ..utils.leader import LeaderFollowingTransport


@dataclass(frozen=True)
class Location:
    url: str
    public_url: str
    data_center: str = ""


class VidMap:
    """vid -> [Location] (+ EC volumes), same-DC results first
    (vid_map.go GetLocations / sameDcLocations)."""

    def __init__(self, data_center: str = ""):
        self.data_center = data_center
        self._lock = threading.Lock()
        self._vols: dict[int, list[Location]] = {}
        self._ecs: dict[int, list[Location]] = {}

    def apply_snapshot(self, snap: dict) -> None:
        def parse(m: dict) -> dict[int, list[Location]]:
            return {int(vid): [Location(l["url"], l.get("public_url", l["url"]),
                                        l.get("data_center", ""))
                               for l in locs] for vid, locs in m.items()}

        with self._lock:
            self._vols = parse(snap.get("volumes", {}))
            self._ecs = parse(snap.get("ec_volumes", {}))

    def apply_event(self, e: dict) -> None:
        loc = Location(e["url"], e.get("public_url", e["url"]),
                       e.get("data_center", ""))
        table = self._ecs if e.get("kind") == "ec" else self._vols
        with self._lock:
            locs = table.setdefault(e["vid"], [])
            if e["op"] == "add":
                if loc not in locs:
                    locs.append(loc)
            else:
                table[e["vid"]] = [l for l in locs if l.url != loc.url]
                if not table[e["vid"]]:
                    del table[e["vid"]]

    def lookup(self, vid: int) -> list[Location]:
        with self._lock:
            locs = list(self._vols.get(vid) or self._ecs.get(vid) or [])
        random.shuffle(locs)
        if self.data_center:
            locs.sort(key=lambda l: l.data_center != self.data_center)
        return locs

    def lookup_file_id(self, fid: str) -> list[str]:
        return [l.url for l in self.lookup(int(fid.split(",")[0]))]

    def has(self, vid: int) -> bool:
        with self._lock:
            return vid in self._vols or vid in self._ecs


class WdClient:
    """A live VidMap kept by the master's watch long-poll, and
    /dir/lookup for vids not (yet) in it.

    ``master_url`` may be a comma-separated list of masters (an HA
    quorum): the LeaderFollowingTransport rotates through them on failure
    and goes straight to the leader each watch answer names, so an
    election costs one failed poll and a rotation."""

    def __init__(self, master_url: str, data_center: str = "",
                 poll_timeout: float = 14.0):
        self.master_url = master_url
        self.vid_map = VidMap(data_center)
        self.poll_timeout = poll_timeout
        self.transport = LeaderFollowingTransport(lambda: self.master_url,
                                                  name="wdclient")
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "WdClient":
        self._thread = threading.Thread(
            target=self._keep_connected, daemon=True, name="wdclient")
        self._thread.start()
        return self

    def stop(self, wait: bool = False) -> None:
        """Signal the poll loop to exit; the daemon thread unparks at the
        latest when the current long-poll returns (<= poll_timeout).
        wait=True blocks until it has actually exited."""
        self._stop.set()
        self._synced.clear()
        if wait and self._thread is not None:
            self._thread.join(self.poll_timeout + 11)

    def wait_synced(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    # reconnect backoff: start fast (a restarting master is usually back
    # within a second), cap around 15s so a long outage isn't hammered —
    # and jitter every sleep so a fleet of clients that all lost the same
    # master doesn't reconnect in lockstep and thundering-herd it back
    # down (masterclient.go KeepConnected's sleepy backoff)
    RECONNECT_BASE = 0.5
    RECONNECT_CAP = 15.0

    def _keep_connected(self) -> None:
        # the watch cursor lives on this thread's stack: nothing else
        # ever needs it, so there is no shared field to race on
        seq = 0
        failures = 0
        while not self._stop.is_set():
            target = ""
            try:
                target = self.transport.target()
                r = http_json(
                    "GET", f"http://{target}/cluster/watch?"
                    f"since_seq={seq}&timeout={self.poll_timeout}",
                    timeout=self.poll_timeout + 10)
                # the body is stamped by the leader even when a follower
                # 307-redirected us there: poll it directly next time
                self.transport.learn(str(r.get("leader") or ""))
                if "volumes" in r:
                    self.vid_map.apply_snapshot(r)
                for e in r.get("events", []):
                    self.vid_map.apply_event(e)
                seq = r.get("seq", seq)
                self._synced.set()
                failures = 0
            except Exception:
                self.transport.note_failure()
                # ANY failure (transport, malformed body, bad event) must
                # not kill the loop with _synced set — that would freeze
                # the map and serve stale locations forever
                self._synced.clear()
                seq = 0  # resync from snapshot on reconnect
                # each reconnect is a RETRY against the master: it draws
                # from the per-destination retry budget
                # (utils/backoff.py), so a fleet of clients that all
                # lost the same master degrades to one probe per
                # budget-refill instead of an exponential-backoff storm
                # — a drained bucket holds the full cap and the denial
                # is counted + journaled (retry_budget_exhausted)
                if retry_allowed(target or self.master_url, "wdclient"):
                    delay = jittered_backoff(self.RECONNECT_BASE,
                                             self.RECONNECT_CAP,
                                             failures)
                else:
                    delay = self.RECONNECT_CAP
                failures = min(failures + 1, 10)  # cap the exponent
                self._stop.wait(delay)

    # --- lookups ----------------------------------------------------------
    def lookup(self, vid: int) -> list[str]:
        urls = [l.url for l in self.vid_map.lookup(vid)]
        if urls:
            return urls
        # miss: the volume may predate our snapshot or be EC-only.
        # An idempotent GET against a possibly-restarting master:
        # bounded retries through the per-destination retry budget
        # (a down master denies them and the lookup degrades to one
        # attempt instead of joining the reconnect storm).  The target
        # comes from the shared transport (learned leader, else
        # rotation); a failure rotates so the NEXT lookup/poll tries a
        # different master.
        target = self.transport.target()
        try:
            r = http_json_retry(
                "GET", f"http://{target}/dir/lookup?"
                f"volumeId={vid}", timeout=30.0, attempts=3,
                budget_kind="wdclient")
        except Exception:
            self.transport.note_failure()
            raise
        return [loc["url"] for loc in r.get("locations", [])]

    def lookup_file_id(self, fid: str) -> list[str]:
        return self.lookup(int(fid.split(",")[0]))
