"""Background EC shard scrubber: paced bit-rot scans that repair.

The port's copy of seaweedfs_tpu/volume_server/scrubber.py.  The scrubber
walks every mounted EC volume's shards against its `.eci` sidecar and acts
on rot it finds:

  - QUARANTINE: the corrupt `.ecNN` is renamed to `.ecNN.bad` (kept as
    evidence, never mounted again);
  - REPAIR: with >= data_shards clean shards left, the store's own
    ec_rebuild regenerates the quarantined shards byte-identical through
    the GF kernel on the store's device (the rebuild re-verifies its
    survivors, so a second rotted shard found mid-repair is demoted too);
  - REPORT: a verdict per volume (clean / repaired / unrepairable /
    repair_failed / no_sidecar / stale_sidecar) through status(), and the
    SeaweedFS_ec_scrub_blocks_total, SeaweedFS_ec_corrupt_shards_total and
    SeaweedFS_ec_scrub_repairs_total counters.

Block reads are rate-limited (rate_mb_s token bucket), the scan pauses
while the server is busy (busy_fn), and the cursor resumes: stop() mid-scan
and the next start() continues from the same (volume, shard).

The unmount, rename and remount of a quarantine happen inside the store's
``ec_swap()``, so later reads find the volume remounted degraded, never
absent; reads in flight finish on the files they opened.

Each pass is a force-sampled trace root while the tracer is on
(``ec.scrub.pass`` over ``ec.scrub.volume`` and ``ec.scrub.repair``), its
spans and events stamped with this server's url; a targeted pass adopts
the trace context of the request that started it, so a coordinator's
re-scrub journals under the repair.  Each corrupt shard is a
``shard_corrupt`` event and each volume's outcome a ``scrub_repair``,
``scrub_unrepairable`` or ``scrub_repair_failed`` event.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..ec.integrity import (EciSidecar, backfill_sidecar, note_corruption,
                            sidecar_is_stale, verify_shard_file)
from ..ec.layout import to_ext
from ..observability import context as _trace_context
from ..observability import events as _events
from ..observability import get_tracer
from ..stats import ec_integrity_metrics

_log = logging.getLogger(__name__)


class EcScrubber:
    def __init__(self, store, rate_mb_s: float = 64.0,
                 interval_s: float = 0.0, backfill: bool = False,
                 busy_fn: Optional[Callable[[], bool]] = None,
                 pause_s: float = 0.5):
        """rate_mb_s caps scan IO (0 = unthrottled); interval_s > 0 loops
        with that much idle between passes, 0 runs one pass and stops;
        backfill computes sidecars for volumes that predate them
        (recording the CURRENT bytes as the baseline); busy_fn returning
        True pauses the scan in pause_s steps until the server quiets."""
        self.store = store
        self.busy_fn = busy_fn
        self.pause_s = pause_s
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # everything below is written by the scan thread and read by
        # status() on request threads: all access holds _lock
        self.rate_mb_s = rate_mb_s
        self.interval_s = interval_s
        self.backfill = backfill
        # the next (volume id, shard id) to verify
        self.cursor: tuple[int, int] = (0, 0)
        self.verdicts: dict[int, dict] = {}
        # a targeted one-pass scan of one volume (start(volume_id=)), and
        # the trace context it adopts
        self.only_vid: Optional[int] = None
        self._ctx = None
        self.passes = 0
        self.running = False
        self.paused = False
        self._debt = 0.0  # seconds of IO time owed to the rate limit
        self._t0: Optional[float] = None

    # --- lifecycle --------------------------------------------------------
    def start(self, rate_mb_s: Optional[float] = None,
              interval_s: Optional[float] = None,
              backfill: Optional[bool] = None,
              volume_id: Optional[int] = None, ctx=None) -> bool:
        """Launch the scan thread; False when one is already running (the
        knobs still apply to the live scan).  volume_id asks for a
        targeted one-pass scan of that volume, under the trace context
        ``ctx``."""
        with self._lock:
            if rate_mb_s is not None:
                self.rate_mb_s = float(rate_mb_s)
            if interval_s is not None:
                self.interval_s = float(interval_s)
            if backfill is not None:
                self.backfill = bool(backfill)
            if self._thread is not None and self._thread.is_alive():
                return False
            if volume_id is not None:
                self.only_vid = int(volume_id)
                self._ctx = ctx
                # a cursor left mid-volume by an interrupted full scan
                # must not skip the target's first shards
                self.cursor = (int(volume_id), 0)
            else:
                self.only_vid = None
                self._ctx = None
            self._stop.clear()
            self._debt, self._t0 = 0.0, None
            # running from here: a status poll right after start() must
            # not read the last pass's verdicts as this one's
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ec-scrub")
            self._thread.start()
            return True

    def stop(self, join_timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(join_timeout)

    def status(self) -> dict:
        with self._lock:
            return {
                "running": self.running,
                "paused": self.paused,
                "passes": self.passes,
                "cursor": list(self.cursor),
                "rate_mb_s": self.rate_mb_s,
                "interval_s": self.interval_s,
                "backfill": self.backfill,
                "verdicts": {str(vid): dict(v)
                             for vid, v in sorted(self.verdicts.items())},
                "totals": ec_integrity_metrics().totals(),
            }

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self.run_pass()
                with self._lock:
                    if not self._stop.is_set():
                        self.passes += 1  # one-shot passes count too
                    interval = self.interval_s
                    targeted = self.only_vid is not None
                    self.only_vid = None
                    self._ctx = None
                if targeted or self._stop.is_set() or not interval:
                    break  # targeted scans are always one pass
                if self._stop.wait(interval):
                    break
        except Exception:  # noqa: BLE001 - the thread must report, not die
            _log.exception("ec scrub pass failed")
        finally:
            with self._lock:
                self.running = False
                self.paused = False

    # --- scanning ---------------------------------------------------------
    def run_pass(self) -> dict:
        """One scan over every mounted EC volume, resuming from the
        cursor.  Synchronous: the tests and the scan thread call it.
        With the tracer on, the pass is a force-sampled trace root (or
        adopts a targeted scan's context), so its spans ship and its
        events carry the pass's trace id."""
        tr = get_tracer()
        with self._lock:
            inherit = self._ctx
        ctx = prev = None
        if inherit is not None and _trace_context.current() is None:
            ctx = inherit
            prev = _trace_context.activate(ctx)
        elif tr.enabled and _trace_context.current() is None:
            ctx = _trace_context.TraceContext(_trace_context.new_trace_id())
            prev = _trace_context.activate(ctx)
        # spans and events of the scan thread belong to this server, even
        # with several servers in one process
        ip = getattr(self.store, "ip", None)
        port = getattr(self.store, "port", None)
        prev_srv = _trace_context.swap_server(
            f"{ip}:{port}" if ip and port else None)
        try:
            return self._run_pass_inner(tr)
        finally:
            _trace_context.swap_server(prev_srv)
            if ctx is not None:
                _trace_context.activate(prev)

    def _run_pass_inner(self, tr) -> dict:
        with self._lock:
            cv = self.cursor[0]
            only = self.only_vid
        with tr.span("ec.scrub.pass", cursor_vid=cv,
                     targeted=-1 if only is None else only):
            vids = sorted(self.store.ec_volumes)
            if only is not None:
                vids = [v for v in vids if v == only]
            else:
                # rotate so the pass resumes at the cursor, then wraps
                vids = [v for v in vids if v >= cv] + \
                    [v for v in vids if v < cv]
            for vid in vids:
                if self._stop.is_set():
                    return self.status()
                self._scrub_volume(vid)
            if not self._stop.is_set() and only is None:
                # clean wrap: the next pass starts fresh (a stop mid-scan
                # keeps the mid-volume cursor _scrub_volume left)
                with self._lock:
                    self.cursor = (0, 0)
        return self.status()

    def _pace(self, nbytes: int) -> None:
        """Token-bucket rate limit and busy pause, before each block
        read.  The waits run on locals, never holding _lock."""
        while self.busy_fn is not None and not self._stop.is_set():
            try:
                busy = bool(self.busy_fn())
            except Exception:  # noqa: BLE001 - a broken gate never blocks
                busy = False
            if not busy:
                break
            with self._lock:
                self.paused = True
            self._stop.wait(self.pause_s)
        with self._lock:
            self.paused = False
            rate = self.rate_mb_s
            if rate and rate > 0:
                if self._t0 is None:
                    self._t0 = time.perf_counter()
                self._debt += nbytes / (rate * 1e6)
                debt, t0 = self._debt, self._t0
        if rate and rate > 0:
            # sleep off the debt in short slices so stop() stays prompt
            while not self._stop.is_set():
                ahead = debt - (time.perf_counter() - t0)
                if ahead <= 0.002:
                    break
                self._stop.wait(min(ahead, 0.25))

    def _scrub_volume(self, vid: int) -> None:
        ev = self.store.ec_volumes.get(vid)
        if ev is None:  # raced an unmount
            return
        base = ev.base_file_name
        collection = self.store.ec_collections.get(vid, "")
        m = ec_integrity_metrics()
        tr = get_tracer()
        sc = ev.sidecar or EciSidecar.load(base)
        present = sorted(ev.shards)
        sizes = []
        for sid in present:
            try:
                sizes.append(os.path.getsize(base + to_ext(sid)))
            except OSError:
                sizes.append(-1)
        stale = sidecar_is_stale(sc, sizes)
        if stale:
            # quarantining healthy shards on a stale table's say-so would
            # destroy the volume; a shard that disagrees with size-agreeing
            # peers flows through the verify below as truncation rot
            sc = None
            ev.sidecar = None
        with self._lock:
            backfill = self.backfill
        if sc is None and backfill:
            try:
                sc = backfill_sidecar(base)
            except (OSError, ValueError):
                # ValueError: unequal shard sizes (a truncated shard in a
                # pre-sidecar set); an unverifiable volume must not kill
                # the scrub thread
                sc = None
            ev.sidecar = sc
        if sc is None:
            with self._lock:
                self.verdicts[vid] = {
                    "status": "stale_sidecar" if stale else "no_sidecar",
                    "at": round(time.time(), 3)}
                self.cursor = (vid + 1, 0)
            return
        with self._lock:
            start_shard = self.cursor[1] if vid == self.cursor[0] else 0
        corrupt: dict[int, list[int]] = {}
        blocks = 0
        interrupted = False
        with tr.span("ec.scrub.volume", vid=vid, shards=len(present)):
            for sid in present:
                if sid < start_shard:
                    continue
                if self._stop.is_set():
                    # resume HERE next start; corruption already found in
                    # the scanned prefix is acted on below, not dropped
                    with self._lock:
                        self.cursor = (vid, sid)
                    interrupted = True
                    break
                with self._lock:
                    self.cursor = (vid, sid)
                counted = [0]

                def on_block(ok, _c=counted):
                    _c[0] += 1
                    m.scrub_blocks.inc("ok" if ok else "corrupt")

                try:
                    bad = verify_shard_file(sc, base + to_ext(sid), sid,
                                            pace=self._pace,
                                            on_block=on_block)
                except OSError:
                    bad = []  # unreadable file: the rebuild's problem
                blocks += counted[0]
                if bad:
                    corrupt[sid] = bad
        if not interrupted:
            with self._lock:
                self.cursor = (vid + 1, 0)
        if not corrupt:
            if not interrupted:  # a partial scan is not a clean verdict
                with self._lock:
                    self.verdicts[vid] = {"status": "clean",
                                          "blocks": blocks,
                                          "at": round(time.time(), 3)}
            return
        for sid, blks in corrupt.items():
            note_corruption("scrub", sid, base, block=blks[0])
            tr.event("ec.scrub.quarantine", vid=vid, shard=sid,
                     blocks=len(blks))
        self._quarantine_and_repair(vid, collection, base, present,
                                    list(corrupt), blocks)

    def _quarantine_and_repair(self, vid: int, collection: str, base: str,
                               present: list[int], corrupt: list[int],
                               blocks: int) -> None:
        """`.ecNN` -> `.ecNN.bad`, then regenerate through the store's
        rebuild when >= data_shards clean shards remain.  The volume is
        remounted degraded at once, so reads reconstruct while the
        rebuild runs, and remounted again afterwards to pick up the
        regenerated shards."""
        m = ec_integrity_metrics()
        ev = self.store.ec_volumes.get(vid)
        k = ev.data_shards if ev is not None else 10
        clean_left = len(present) - len(corrupt)
        repaired = False
        error = ""
        try:
            with self.store.ec_swap():
                self.store.ec_unmount(vid)
                for sid in corrupt:
                    p = base + to_ext(sid)
                    try:
                        os.replace(p, p + ".bad")
                    except OSError:
                        pass
                try:
                    self.store.ec_mount(vid, collection)
                except Exception as e:  # noqa: BLE001 - verdict carries it
                    error = f"remount: {type(e).__name__}: {e}"
            if clean_left >= k:
                with get_tracer().span("ec.scrub.repair", vid=vid,
                                       shards=len(corrupt)):
                    try:
                        self.store.ec_rebuild(vid, collection)
                        repaired = True
                        m.repairs.inc("repaired", amount=len(corrupt))
                    except Exception as e:  # noqa: BLE001 - in the verdict
                        error = f"{type(e).__name__}: {e}"
                        m.repairs.inc("failed")
            else:
                m.repairs.inc("unrepairable")
        finally:
            try:
                # refresh so the mount picks up the rebuilt shards
                self.store.ec_mount(vid, collection)
            except Exception as e:  # noqa: BLE001 - mount-back best effort
                error = error or f"remount: {type(e).__name__}: {e}"
        verdict = {"status": "repaired" if repaired else (
                       "unrepairable" if clean_left < k else "repair_failed"),
                   "blocks": blocks,
                   "corrupt_shards": sorted(corrupt),
                   "quarantined": [to_ext(s) + ".bad" for s in corrupt],
                   "at": round(time.time(), 3)}
        if error:
            verdict["error"] = error[:300]
        with self._lock:
            self.verdicts[vid] = verdict
        _events.emit(
            {"repaired": "scrub_repair",
             "unrepairable": "scrub_unrepairable",
             "repair_failed": "scrub_repair_failed"}[verdict["status"]],
            vid=vid, shards=sorted(corrupt), blocks=blocks,
            error=error[:200] if error else "")
