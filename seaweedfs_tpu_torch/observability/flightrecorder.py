"""Flight recorder: auto-captured diagnostic bundles that outlive rings.

The port's copy of seaweedfs_tpu/observability/flightrecorder.py.  The
trace ring, the event journal and /metrics answer "what is happening
NOW"; by the time an operator reads a page, the spans that would have
explained it have rotated out of the bounded ring.  The flight recorder
freezes the evidence when a rule fires: the master's alert engine asks
the implicated servers (POST /debug/flightrecorder/capture) to snapshot a
bounded bundle of

    trace    the process tracer's whole-ring to_dict() dump,
    profile  a short collapsed-stack sampling profile,
    metrics  the full Prometheus exposition,
    events   the recent event journal tail,

persisted to a size-capped on-disk spool (oldest-bundle eviction) and
listed and fetched at GET /debug/flightrecorder[/<id>] and by the shell's
alerts.capture.  Bundle ids land on the alert itself (/cluster/alerts
``bundles``), so the page links to the evidence.

One recorder per process (like the tracer and the journal): co-located
servers in one process share a spool, and every capture stamps the
requesting server's identity.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from typing import Optional

from . import context as _trace_context
from . import events as _events

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class FlightRecorder:  # weedlint: concurrent-class
    """Size-capped on-disk spool of diagnostic bundles.  Reached
    concurrently: alert-engine capture fan-outs and HTTP threads serving
    /debug/flightrecorder."""

    def __init__(self, spool_dir: Optional[str] = None,
                 max_bytes: int = 64 << 20, max_bundles: int = 32):
        self.spool_dir = spool_dir  # guarded-by: _lock
        self.max_bytes = max_bytes  # guarded-by: _lock
        self.max_bundles = max_bundles  # guarded-by: _lock
        # RLock: _evict -> _scan -> _dir re-enters while holding it
        self._lock = threading.RLock()
        self._seq = 0  # guarded-by: _lock
        self.captures = 0  # guarded-by: _lock
        self.evicted = 0  # guarded-by: _lock

    def configure(self, spool_dir: Optional[str] = None,
                  max_bytes: Optional[int] = None,
                  max_bundles: Optional[int] = None) -> "FlightRecorder":
        """Servers point the shared recorder at their data directory at
        start; the last configure wins (co-located servers share one
        spool, as they share one tracer)."""
        with self._lock:
            if spool_dir:
                self.spool_dir = spool_dir
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)
            if max_bundles is not None:
                self.max_bundles = int(max_bundles)
        return self

    def _dir(self) -> str:
        with self._lock:  # two first captures must agree on the spool
            d = self.spool_dir
            if not d:
                # unconfigured (bare tools, tests): a per-process
                # tempdir spool, bounded and disposable
                d = self.spool_dir = os.path.join(
                    tempfile.gettempdir(),
                    f"weed-flightrecorder-{os.getpid()}")
        os.makedirs(d, exist_ok=True)
        return d

    # --- capture ----------------------------------------------------------
    def capture(self, reason: str = "manual",
                alert: Optional[str] = None,
                server: Optional[str] = None,
                trace_id: Optional[str] = None,
                profile_s: float = 0.25, hz: float = 100.0,
                max_events: int = 256,
                events: Optional[list] = None) -> dict:
        """Snapshot this process into one bundle; returns its meta (id,
        sizes, ...).  Bounded by construction: the trace ring and journal
        are capped, the profile window is clamped, and the spool evicts
        oldest-first after the write."""
        from ..stats import REGISTRY
        from .profiler import profile_collapsed
        from .tracer import get_tracer

        if server is None:
            server = _trace_context.current_server()
        with self._lock:
            self._seq += 1
            seq = self._seq
        bundle_id = "fr-%s-%d-%s" % (
            time.strftime("%Y%m%d%H%M%S", time.gmtime()), seq,
            re.sub(r"[^A-Za-z0-9_-]", "_", alert or reason)[:40])
        captured_at = time.time()
        trace_doc = get_tracer().to_dict()
        profile = ""
        if profile_s > 0:
            try:
                # the profile is never the reason a capture fails, and
                # never blocks the fan-out for long
                profile = profile_collapsed(min(profile_s, 5.0),
                                            hz=min(hz, 250.0))
            except Exception as e:  # noqa: BLE001 - recorded in the bundle
                profile = f"# profile failed: {type(e).__name__}: {e}\n"
        try:
            metrics = REGISTRY.expose()
        except Exception as e:  # noqa: BLE001 - recorded in the bundle
            metrics = f"# metrics failed: {type(e).__name__}: {e}\n"
        if events is None:
            events = _events.get_journal().query(limit=max_events)
        else:
            events = list(events)[-max_events:]
        doc = {
            "format": "seaweedfs-tpu-flightrecorder-v1",
            "meta": {
                "id": bundle_id,
                "reason": reason,
                "alert": alert or "",
                "server": server or "",
                "trace_id": trace_id or "",
                "captured_at": round(captured_at, 3),
                "span_count": len(trace_doc.get("spans") or []),
                "event_count": len(events),
            },
            "trace": trace_doc,
            "profile": profile,
            "metrics": metrics,
            "events": events,
        }
        path = os.path.join(self._dir(), bundle_id + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        with self._lock:  # capture fan-outs race on the counter
            self.captures += 1
        meta = dict(doc["meta"])
        meta["bytes"] = os.path.getsize(path)
        self._evict()
        _events.emit("flight_capture", server=server, id=bundle_id,
                     reason=reason, alert=alert or "",
                     bytes=meta["bytes"])
        return meta

    def _evict(self) -> None:
        """Oldest-bundle eviction past either cap: the spool can sit on a
        small disk for good."""
        with self._lock:
            try:
                entries = self._scan()
            except OSError:
                return
            total = sum(e["bytes"] for e in entries)
            # entries is newest first: trim from the tail
            while entries and (len(entries) > self.max_bundles
                               or total > self.max_bytes):
                victim = entries.pop()
                try:
                    os.remove(victim["path"])
                except OSError:
                    pass
                total -= victim["bytes"]
                self.evicted += 1

    def _scan(self) -> list[dict]:
        """Spool inventory, newest first (by mtime, from the files alone,
        so a restarted process serves bundles an earlier one captured)."""
        d = self._dir()
        out = []
        for name in os.listdir(d):
            if not name.endswith(".json"):
                continue
            path = os.path.join(d, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append({"id": name[:-5], "bytes": st.st_size,
                        "mtime": st.st_mtime, "path": path})
        out.sort(key=lambda e: e["mtime"], reverse=True)
        return out

    # --- inspection -------------------------------------------------------
    def list(self) -> list[dict]:
        """Bundle index (id, size, age), newest first: the body of
        GET /debug/flightrecorder."""
        now = time.time()
        return [{"id": e["id"], "bytes": e["bytes"],
                 "age_s": round(now - e["mtime"], 1)}
                for e in self._scan()]

    def get(self, bundle_id: str) -> Optional[dict]:
        """One full bundle document, or None for a bad or unknown id (the
        id's charset check also keeps paths out of the spool)."""
        if not _ID_RE.match(bundle_id or ""):
            return None
        path = os.path.join(self._dir(), bundle_id + ".json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self._scan())


_GLOBAL = FlightRecorder()


def get_flightrecorder() -> FlightRecorder:
    return _GLOBAL
