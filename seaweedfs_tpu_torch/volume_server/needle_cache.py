"""The needle cache: the volume server's hot needles kept in memory.

The port's copy of seaweedfs_tpu/volume_server/needle_cache.py.  Read
traffic concentrates on a small hot set (the Haystack observation); this
cache keeps those needles resident, so a hot read costs a dict lookup
instead of a pread and a CRC pass, and the reactor (utils/eventloop.py)
can answer a cached GET on its loop.

  - Admission by observed frequency, not first touch: a needle enters on
    its ``admit_after``-th read (default 2) within the sketch's horizon,
    so one-shot scans cannot wash the hot set out.
  - Bounded in bytes with LRU eviction (each entry charged
    ENTRY_OVERHEAD on top of its data); every eviction is counted.
  - Invalidated per key on write and delete, per volume on unmount,
    delete and a vacuum's commit, and fenced by a per-volume write epoch:
    an ``offer`` of a needle read before the volume's last invalidation
    is refused, so a read racing a write cannot repopulate stale bytes.
  - TTL'd needles are never cached (expiry is judged at read time), nor
    any needle over 1/8 of the bound.

Counters ride stats.needle_cache_metrics(); ``status()`` is /status's
``NeedleCache``.

Callbacks, called outside the lock with their exceptions swallowed (set
once by the volume server, observability/heat.py and ledger.py):
``on_hit(vid, key, nbytes)`` and ``on_miss(vid, key)`` at each lookup,
``on_admit(vid, key)`` at each admission.  The server composes heat's hit
hook with the ledger's (one slot, both fed).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from ..storage.needle import FLAG_HAS_TTL, Needle

# charged per entry on top of its data bytes, so a million tiny needles
# cannot blow the bound
ENTRY_OVERHEAD = 256


def _metrics():
    from ..stats import needle_cache_metrics

    return needle_cache_metrics()


class NeedleCache:
    """Bounded, frequency-admitted, write-invalidated needle cache, safe
    from request threads, the reactor loop and maintenance paths at once."""

    def __init__(self, max_bytes: int = 64 << 20, admit_after: int = 2,
                 sketch_cap: int = 65536):
        self.max_bytes = int(max_bytes)
        self.admit_after = max(1, int(admit_after))
        self.sketch_cap = max(1024, int(sketch_cap))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Needle]" = OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._freq: dict[tuple, int] = {}  # guarded-by: _lock
        self._vols: dict[int, set] = {}  # vid -> cached keys  # guarded-by: _lock
        self._epochs: dict[int, int] = {}  # guarded-by: _lock
        # accounting hooks, set once at the server's construction
        self.on_hit = None       # fn(vid, key, nbytes): heat, the ledger
        self.on_admit = None     # fn(vid, key): heat
        self.on_miss = None      # fn(vid, key): the ledger

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    # --- reads ----------------------------------------------------------------
    def contains(self, vid: int, key: int) -> bool:
        """Membership alone (no LRU touch, no counters): the reactor's
        question before it answers a GET on the loop."""
        with self._lock:
            return (vid, key) in self._entries

    def get(self, vid: int, key: int) -> Optional[Needle]:
        with self._lock:
            n = self._entries.get((vid, key))
            if n is not None:
                self._entries.move_to_end((vid, key))
        m = _metrics()
        if n is not None:
            m.hits.inc()
            m.volume_hits.inc(str(vid))
            hook = self.on_hit
            if hook is not None:
                try:
                    hook(vid, key, len(n.data or b""))
                except Exception:  # noqa: BLE001 - accounting never breaks a read
                    pass
        else:
            m.misses.inc()
            m.volume_misses.inc(str(vid))
            hook = self.on_miss
            if hook is not None:
                try:
                    hook(vid, key)
                except Exception:  # noqa: BLE001 - accounting never breaks a read
                    pass
        return n

    def epoch(self, vid: int) -> int:
        """The volume's write epoch, taken before a disk read and handed
        back to ``offer``."""
        with self._lock:
            return self._epochs.get(vid, 0)

    def offer(self, vid: int, key: int, n: Needle,
              epoch: Optional[int] = None) -> bool:
        """Offer a needle just read; it is admitted once its key's read
        count clears the bar.  Returns whether it was admitted."""
        if not self.enabled:
            return False
        size = len(n.data or b"") + ENTRY_OVERHEAD
        if size > self.max_bytes // 8 or n.has(FLAG_HAS_TTL):
            _metrics().rejections.inc()
            return False
        evicted = 0
        with self._lock:
            if epoch is not None and self._epochs.get(vid, 0) != epoch:
                return False  # invalidated since the read began
            k = (vid, key)
            if k in self._entries:
                return True
            freq = self._freq.get(k, 0) + 1
            if len(self._freq) >= self.sketch_cap and k not in self._freq:
                # a full sketch ages by halving rather than refusing keys
                self._freq = {fk: c // 2 for fk, c in self._freq.items()
                              if c // 2 > 0}
            self._freq[k] = freq
            if freq < self.admit_after:
                admitted = False
            else:
                while self._bytes + size > self.max_bytes and self._entries:
                    old_k, old_n = self._entries.popitem(last=False)
                    self._bytes -= len(old_n.data or b"") + ENTRY_OVERHEAD
                    self._vols.get(old_k[0], set()).discard(old_k[1])
                    evicted += 1
                self._entries[k] = n
                self._bytes += size
                self._vols.setdefault(vid, set()).add(key)
                admitted = True
            resident = self._bytes
        m = _metrics()
        if evicted:
            m.evictions.inc(amount=evicted)
        if admitted:
            m.admissions.inc()
            m.bytes.set(resident)
            hook = self.on_admit
            if hook is not None:
                try:
                    hook(vid, key)
                except Exception:  # noqa: BLE001 - accounting never breaks a read
                    pass
        else:
            m.rejections.inc()
        return admitted

    # --- invalidation -----------------------------------------------------------
    def invalidate(self, vid: int, key: int, reason: str = "write") -> None:
        with self._lock:
            self._epochs[vid] = self._epochs.get(vid, 0) + 1
            n = self._entries.pop((vid, key), None)
            if n is not None:
                self._bytes -= len(n.data or b"") + ENTRY_OVERHEAD
                self._vols.get(vid, set()).discard(key)
            self._freq.pop((vid, key), None)
            resident = self._bytes
        if n is not None:
            m = _metrics()
            m.invalidations.inc(reason)
            m.bytes.set(resident)

    def invalidate_volume(self, vid: int, reason: str = "vacuum") -> None:
        """Drop every entry of the volume: a vacuum may have dropped
        needles the per-key hooks never saw."""
        dropped = 0
        with self._lock:
            self._epochs[vid] = self._epochs.get(vid, 0) + 1
            keys = self._vols.pop(vid, set())
            for key in keys:
                n = self._entries.pop((vid, key), None)
                if n is not None:
                    self._bytes -= len(n.data or b"") + ENTRY_OVERHEAD
                    dropped += 1
            if keys:
                self._freq = {k: c for k, c in self._freq.items()
                              if k[0] != vid}
            resident = self._bytes
        if dropped:
            m = _metrics()
            m.invalidations.inc(reason, amount=dropped)
            m.bytes.set(resident)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._vols.clear()
            self._freq.clear()
            self._bytes = 0
        _metrics().bytes.set(0)

    # --- status -----------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            entries = len(self._entries)
            resident = self._bytes
        return {"enabled": self.enabled, "entries": entries,
                "bytes": resident, "max_bytes": self.max_bytes,
                "admit_after": self.admit_after, **_metrics().totals()}
