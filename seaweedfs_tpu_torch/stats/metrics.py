"""Counters of shard integrity.

The port's copy of the part of seaweedfs_tpu/stats/metrics.py that the EC
path counts into: ``Counter`` (metrics.py:38), the ``ECIntegrityMetrics``
family (:470-503) and its process-wide accessor (:783-786), which is the
port's registry until it has a ``/metrics`` exposition to walk one.
Family names, labels and the keys of ``totals()`` are the reference's, so
the volume server's ``/status`` and its scrub routes carry the same
numbers under the same names.

Not ported: gauges, histograms, the other families (among them
``ECPipelineMetrics``, whose parity-worker restarts and CPU fallbacks the
port cannot have), the ``Registry`` and the ``/metrics`` text exposition.
"""

from __future__ import annotations

import threading


class Counter:
    def __init__(self, name: str, help_: str = "", labels: tuple = ()):
        self.name, self.help = name, help_
        self.label_names = tuple(labels)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, *label_values, amount: float = 1.0) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, *label_values) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def snapshot(self) -> dict[tuple, float]:
        """Point-in-time copy, safe against concurrent inc()."""
        with self._lock:
            return dict(self._values)


def _total(c: Counter) -> int:
    return int(sum(c.snapshot().values()))


class ECIntegrityMetrics:
    """Shard bit-rot counters: blocks the scrubber verified (by verdict),
    corrupt shards detected (by where: scrub, rebuild, read, wire) and the
    scrubber's quarantine-and-rebuild outcomes."""

    def __init__(self):
        self.scrub_blocks = Counter(
            "SeaweedFS_ec_scrub_blocks_total",
            "EC shard blocks verified against .eci sidecars.",
            labels=("verdict",))
        self.corrupt_shards = Counter(
            "SeaweedFS_ec_corrupt_shards_total",
            "Corrupt EC shards detected (sidecar block crc mismatch).",
            labels=("source",))
        self.repairs = Counter(
            "SeaweedFS_ec_scrub_repairs_total",
            "Corrupt EC shards quarantined and rebuilt by the scrubber.",
            labels=("outcome",))

    def totals(self) -> dict[str, int]:
        return {"scrub_blocks": _total(self.scrub_blocks),
                "corrupt_shards": _total(self.corrupt_shards),
                "scrub_repairs": _total(self.repairs)}


_singletons: dict[str, object] = {}
_singleton_lock = threading.Lock()


def _singleton(name: str, cls):
    with _singleton_lock:
        if name not in _singletons:
            _singletons[name] = cls()
        return _singletons[name]


def ec_integrity_metrics() -> ECIntegrityMetrics:
    return _singleton("ec_integrity", ECIntegrityMetrics)
